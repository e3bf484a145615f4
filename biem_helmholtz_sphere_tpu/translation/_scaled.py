r"""Scale-compensated (S|R) translation: mantissa + per-entry exponent.

Why.  The (S|R) entries scale like |h^{(1)}_{l+l'}(k t)|, which grows
super-exponentially in l+l' beyond the oscillatory regime: at k t = 4
the float32 matrix overflows from n_end ~ 22 (h_42(4) > 3.4e38) and NaNs
the whole solve; float64 dies the same way at the reference's extreme
sweep corner (n_end ~ 3000 at small k t needs exponents ~ e^20000).  The
reference sidesteps this by running float64 and letting infeasible rows
fail (cli.py:269-271).  This package was first built for hardware with
no float64, where float32 had to reach the same n_end; the float32 path
keeps that reach on any backend.

What.  These providers return the translation operator as
(mant, S): SR = mant * exp(S), with |mant| ~ O(1) and S[h', h] =
log|h_{l+l'}(kt)| the per-entry log-scale.  Assembly (_core._assemble)
folds S against the log-scales of the regular/boundary radial rows —
whose product with SR is the physically bounded system-matrix entry —
so no intermediate ever overflows, in any dtype.

How.  Scaled radial tables come from special.spherical_jh_scaled.
 *  2D (Graf closed form): entries ARE gathered radial values — gather
    (mantissa, exponent) instead.
 *  d >= 3, 'b'-rooted trees (rotation + coaxial): the coaxial band
    contraction sum_n coef_n U_n runs per GROUP of _GROUP consecutive
    bands, each group normalized to its own max exponent (band-to-band
    log-steps are bounded, so group mantissas stay representable), and
    groups are combined with per-entry factors exp(sig_g - S) <= 1
    (the Gaunt mask guarantees n <= l+l' inside every surviving entry).
    The rotation sandwich D . D^H is degree-block-diagonal and S is
    constant on degree blocks, so it applies to the mantissa unchanged.
 *  General trees (d >= 3, any root — e.g. 'c'-rooted "caa"/hopf): the
    masked band scan of _ops._sr_banded with per-band exponent
    compensation: band n'' contributes its MANTISSA times
    exp(he[n''] - S) <= 1 on every surviving entry (the Gaunt mask
    guarantees n'' <= l + l' there and |h_n| is increasing in n past the
    oscillatory regime), so the accumulation never sees a raw h value
    (sr_banded_scaled).
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from ..harmonics._index import basis
from ..ops import cplx
from ..ops.cplx import C
from ..special._family import spherical_jh_scaled
from ._ops import _a_const, _a_node_m
from ._rotation import _coax_tables, _root_axis

# Bands per scale group.  The within-group exponent spread is
# (G-1) * ln(2N/(e k t)); G = 8 keeps it under the float32 exp range for
# any k t > ~1e-4 * N while halving the group-combination passes.
_GROUP = 8


def graf_2d_scaled(c, t_sph, n_out, k, kind="SR"):
    """(mant, S) for the 2D Graf closed form (see _ops._graf_2d)."""
    if kind != "SR":
        raise ValueError("scaled translation is (S|R)-only (RR is bounded)")
    mo = _a_node_m(c, n_out)
    mu_max = 2 * int(np.abs(mo).max())  # scaled path is square (mi == mo)
    r_t = t_sph["r"]
    theta = t_sph[c.root.nid]
    z = C.of(k) * r_t if isinstance(k, C) else jnp.asarray(k) * r_t
    (jm, je), _, (hm, he), _ = spherical_jh_scaled(2, mu_max + 1, z)
    mant_tab, e_tab = (hm, he) if kind == "SR" else (jm, je)
    mant_tab = mant_tab * np.sqrt(2.0 / np.pi)
    rdt = jnp.result_type(theta.dtype, jnp.float32)
    # [H, H] tables on device from a barriered [H] order vector: host
    # numpy versions lower as O(H^2) HLO literals, blowing the remote
    # compiler's request-size limit at n_end >= ~2.4k (see _ops._graf_2d)
    mo_d = jax.lax.optimization_barrier(jnp.asarray(mo, jnp.int32))
    mu = mo_d[None, :] - mo_d[:, None]
    idx = jnp.abs(mu)
    gathered = cplx.take(mant_tab, idx, axis=-1)
    s_mat = jnp.take(e_tab, idx, axis=-1)
    ipow = cplx.ipow_device(
        jnp.abs(mo_d)[:, None] - jnp.abs(mo_d)[None, :] + idx, rdt
    )
    phase = cplx.expi(theta[..., None, None] * mu.astype(rdt))
    return gathered * ipow * phase, s_mat


def coaxial_scaled(c, r, n_end, k, kind="SR"):
    """(mant, S) coaxial factor along the root axis (see _rotation.coaxial_sr).

    (S|R) only: the scale normalization S = log|h_{l+l'}| relies on the
    top Gaunt band dominating, which holds for the growing h_n but not
    for the decaying j_n of (R|R) — and (R|R) is bounded anyway.
    """
    if kind != "SR":
        raise ValueError("scaled translation is (S|R)-only (RR is bounded)")
    _root_axis(c)
    d = c.c_ndim
    zf, w, tz, t_cols, ell, cs = _coax_tables(
        c, n_end, jax.config.jax_enable_x64
    )
    rdt = jnp.result_type(
        r.dtype if not isinstance(r, C) else r.re.dtype, jnp.float32
    )
    zf = zf.astype(rdt)
    w = w.astype(rdt)
    # barrier: build every O(H^2) object on device so the compile-time
    # constant folder never sees [NB, H, H]-sized expressions
    tz, t_cols, ell, cs = jax.lax.optimization_barrier(
        (tz.astype(rdt), t_cols.astype(rdt), ell, cs)
    )
    lsum = ell[:, None] + ell[None, :]
    mask = cs[:, None] == cs[None, :]

    n_bands = 2 * n_end - 1
    z = k * r
    (jm, je), _, (hm, he), _ = spherical_jh_scaled(d, n_bands, z)
    radm, rade = (hm, he) if kind == "SR" else (jm, je)
    radm = radm.astype(rdt)
    rade = rade.astype(rdt)
    # pad bands to a multiple of the group size (zero coefficients)
    ng = -(-n_bands // _GROUP)
    pad = ng * _GROUP - n_bands
    coefm = cplx.ipow(np.arange(n_bands)).astype(rdt) * (_a_const(d) * zf) * radm
    if pad:
        zpad = C.zeros(coefm.shape[:-1] + (pad,), dtype=rdt)
        coefm = cplx.concatenate([coefm, zpad], axis=-1)
        rade = jnp.concatenate(
            [rade, jnp.broadcast_to(rade[..., -1:], rade.shape[:-1] + (pad,))],
            axis=-1,
        )
    gshape = coefm.shape[:-1] + (ng, _GROUP)
    rade_g = rade.reshape(rade.shape[:-1] + (ng, _GROUP))
    sig_g = rade_g.max(axis=-1)  # [..., NG]
    coefm_g = coefm.reshape(gshape) * jnp.exp(rade_g - sig_g[..., None])

    u = jnp.einsum("qn,qa,qb->nab", tz * w[:, None], t_cols, t_cols)
    u = jnp.where(lsum[None] >= jnp.arange(n_bands)[:, None, None], u, 0.0)
    if pad:
        u = jnp.concatenate(
            [u, jnp.zeros((pad,) + u.shape[1:], dtype=u.dtype)], axis=0
        )
    u_g = u.reshape(ng, _GROUP, *u.shape[1:])  # [NG, G, H, H]
    h_num = u.shape[-1]
    batch = jnp.broadcast_shapes(coefm.shape[:-1], z.re.shape if isinstance(z, C) else z.shape)
    acc = C.zeros(batch + (h_num, h_num), dtype=rdt)

    # Group-combination factor exp(sig_g - S): S = rade[lsum] is constant
    # on (degree-row x degree-col) BLOCKS, so per group it is the
    # [n_end, n_end] DEGREE-level matrix exp(sig_g - rade[l + l'])
    # expanded to [H, H] through the 0/1 degree-membership matrix
    # E[h, l] = (ell_h == l).  Exponentiate the tiny [.., NG, L, L]
    # table (thousands of exps) and expand with E . exp_small . E^T —
    # matmuls — instead of exponentiating [.., H, H] per group (~3e8
    # transcendentals per bench block; a per-entry GATHER of the table
    # was slower still on the first accelerator, not re-measured on the
    # H100).
    # Groups fully above an entry's Gaunt cutoff have t_g == 0 there but
    # sig_g - S hugely positive: the clamp keeps 0 * exp as 0.
    n_l = n_end  # root degrees run 0..n_end-1 on 'b'-rooted trees
    l_ar = jnp.arange(n_l, dtype=jnp.int32)
    lsum_small = l_ar[:, None] + l_ar[None, :]  # [L, L], values < n_bands
    rade_ll = jnp.take(rade, lsum_small, axis=-1)  # [..., L, L]
    exp_small = jnp.exp(
        jnp.minimum(sig_g[..., None, None] - rade_ll[..., None, :, :], 80.0)
    )  # [..., NG, L, L]
    e_mem = (ell[:, None] == l_ar[None, :]).astype(rdt)  # [H, L] one-hot
    # the returned per-entry log-scale S = rade[lsum] expands the same
    # way (exactly — E picks the degree value) instead of a
    # [KB-batch, H, H] gather, which was the slower form
    s_mat = jnp.einsum("al,...lm,bm->...ab", e_mem, rade_ll, e_mem)
    # static python unroll (NG ~ 8): one fused DAG instead of a scan
    # that materializes the [..., H, H] carry every step
    for g in range(ng):
        cm = coefm_g[..., g, :]
        t_g = C(
            jnp.einsum("...n,nab->...ab", cm.re, u_g[g]),
            jnp.einsum("...n,nab->...ab", cm.im, u_g[g]),
        )
        scale_g = jnp.einsum(
            "al,...lm,bm->...ab", e_mem, exp_small[..., g, :, :], e_mem
        )
        acc = acc + t_g * scale_g
    # i^{l'-l} phase is rank-1 separable: i^{l'} (row) x conj(i^{l}) (col)
    p = cplx.ipow_device(ell, rdt)
    mant = cplx.where(mask, (acc * p[:, None]) * p.conj()[None, :], C.of(0.0))
    return mant, s_mat


def sr_banded_scaled(c, t_sph, n_end, k, kind="SR"):
    """(mant, S) via the general masked band scan (_ops._sr_banded) with
    per-band exponent compensation — works for ANY coordinate tree,
    including 'c'-rooted ones where rotation + coaxial does not apply.

    S[h', h] = he[n_{h'} + n_h] (the log-scale of the top Gaunt band,
    which dominates the entry); band n'' accumulates mantissa *
    exp(he[n''] - S), <= O(1) wherever the Gaunt mask keeps the entry.
    """
    if kind != "SR":
        raise ValueError("scaled translation is (S|R)-only (RR is bounded)")
    from ..coords import to_cartesian as _to_cart
    from ._ops import _diag_contract, _quad_tables, _surface_area

    d = c.c_ndim
    w, yoc, yi, s_cart, n_o, n_i = _quad_tables(c, n_end, n_end)
    r_t = t_sph["r"]
    rdt = jnp.result_type(
        r_t.dtype if not isinstance(r_t, C) else r_t.re.dtype, jnp.float32
    )
    w = w.astype(rdt)
    yoc = yoc.astype(rdt)
    yi = yi.astype(rdt)
    n_o_d, n_i_d = jax.lax.optimization_barrier(
        (jnp.asarray(n_o), jnp.asarray(n_i))
    )
    p_o = cplx.ipow_device(n_o_d, rdt)
    p_i_conj = cplx.ipow_device(n_i_d, rdt).conj()
    t_hat = _to_cart(c, {**t_sph, "r": jnp.ones_like(r_t)})
    x = jnp.tensordot(
        jnp.moveaxis(t_hat, 0, -1).astype(rdt), s_cart.astype(rdt), axes=(-1, 0)
    )

    n_bands = 2 * (n_end - 1) + 1
    z = C.of(k) * r_t if isinstance(k, C) else jnp.asarray(k) * r_t
    _, _, (hm, he), _ = spherical_jh_scaled(d, n_bands, z)
    hm = hm.astype(rdt)
    he = he.astype(rdt)

    nu = 0.5 * (d - 2.0)
    a_d = _a_const(d)
    omega = _surface_area(d)
    nsum = n_o_d[:, None] + n_i_d[None, :]  # [Ho, Hi]
    s_mat = jnp.take(he, nsum, axis=-1)  # [..., Ho, Hi]

    ho, hi = yoc.shape[-1], yi.shape[-1]
    batch = jnp.broadcast_shapes(x.shape[:-1], hm.shape[:-1])
    m0 = C.zeros(batch + (ho, hi), dtype=rdt)

    def step(carry, n2):
        c_prev, c_cur, m = carry
        zonal = (2.0 * n2 + d - 2.0) / (d - 2.0) / omega * c_cur
        mant_n2 = cplx.take(hm, n2.astype(jnp.int32), axis=-1)
        e_n2 = jnp.take(he, n2.astype(jnp.int32), axis=-1)
        band = (
            cplx.expi((np.pi / 2.0) * n2) * a_d * mant_n2[..., None] * (zonal * w)
        )
        t_mat = _diag_contract(band, yoc, yi)
        # surviving entries have n'' <= l + l' so e_n2 - S <= 0; the
        # clamp keeps masked-out 0 * exp(huge) as 0
        scale = jnp.exp(
            jnp.minimum(e_n2[..., None, None] - s_mat, 80.0)
        )
        m = m + cplx.where(nsum >= n2, t_mat * scale, C.of(0.0))
        c_next = (
            2.0 * (n2 + nu) * x * c_cur - (n2 + 2.0 * nu - 1.0) * c_prev
        ) / (n2 + 1.0)
        return (c_cur, c_next, m), None

    c0 = jnp.ones_like(x)
    cm1 = jnp.zeros_like(x)
    ns = jnp.arange(n_bands, dtype=x.dtype)
    (_, _, m), _ = jax.lax.scan(step, (cm1, c0, m0), ns)
    mant = (m * p_o[:, None]) * p_i_conj[None, :]
    return mant, s_mat


def sr_scaled(c, t_sph, n_end, k, kind="SR", t_cart=None, method=None):
    """(mant, S) full translation operator; overflow-free in any dtype.

    Dispatches like translation_matrix's stable paths: closed-form Graf
    in 2D, rotation + group-scaled coaxial for 'b'-rooted trees.  Raises
    NotImplementedError for trees the scaled path does not cover yet
    (general band scan) — callers fall back to the unscaled operator.
    """
    if c.c_ndim == 2:
        return graf_2d_scaled(c, t_sph, n_end, k, kind=kind)
    if c.root.kind not in ("b", "bp"):
        # general trees ('c'-rooted etc.): exponent-compensated band scan
        return sr_banded_scaled(c, t_sph, n_end, k, kind=kind)
    if t_cart is not None:
        t_vec = jnp.moveaxis(jnp.asarray(t_cart), 0, -1)
        r_t = jnp.linalg.norm(t_vec, axis=-1)
        t_hat = t_vec / jnp.where(r_t > 0, r_t, 1.0)[..., None]
    else:
        from ..coords import to_cartesian

        r_t = t_sph["r"]
        t_cart_ = to_cartesian(c, {**t_sph, "r": jnp.ones_like(r_t)})
        t_hat = jnp.moveaxis(t_cart_, 0, -1)
    from ._rotation import _dedup_radii

    uniq_r, inv = _dedup_radii(r_t, k)
    if uniq_r is not None:
        mant, s_mat = coaxial_scaled(c, uniq_r, n_end, k, kind=kind)
        mant = mant[..., inv, :, :]
        s_mat = s_mat[..., inv, :, :]
    else:
        mant, s_mat = coaxial_scaled(c, r_t, n_end, k, kind=kind)
    from ._rotation import _sandwich

    # S is constant on (degree-row x degree-col) blocks and the rotation
    # is degree-block-diagonal: the sandwich applies to the mantissa
    # (degree-group block products, see rotation_blocks)
    return _sandwich(c, n_end, mant, t_hat), s_mat
