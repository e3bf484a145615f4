r"""Addition-theorem translation operators (S|R) and (R|R).

Rebuild of `ultrasphere_harmonics.harmonics_translation_coef` (reference:
_biem.py:697-706; methods documented at _biem.py:569-574) and of the
`gumerov-expansion-coefficients` numba kernels (SURVEY.md section 2.3).

Math.  With R_h(x) = j_{n_h}(k|x|) Y_h(x^) and S_h(x) = h^{(1)}_{n_h}(k|x|)
Y_h(x^), the operators are defined by

    R_h(y + t) = sum_{h'} (R|R)[h', h](t) R_{h'}(y)          (all y)
    S_h(y + t) = sum_{h'} (S|R)[h', h](t) R_{h'}(y)          (|y| < |t|)

From the d-dimensional plane-wave expansion
e^{i k x.s^} = A_d sum_h i^{n_h} j_{n_h}(k|x|) Y_h(x^) conj(Y_h(s^)),
A_d = 2^{(d+1)/2} pi^{(d-1)/2}:

    (R|R)[h',h](t) = i^{n'-n} sum_q w_q e^{i k t.s_q} conj(Y_{h'}(s_q)) Y_h(s_q)

(bounded kernel: numerically benign).  The singular analogue replaces the
plane wave with the band sum F_t(s) = sum_{n''} A_d i^{n''}
h^{(1)}_{n''}(k|t|) Z_{n''}(t^.s) (Z_n the degree-n zonal kernel).  The
bands must NOT be summed before quadrature: |h_{n''}(kt)| grows
super-exponentially in n'' while the entry (h', h) only has Gaunt support
for n'' <= n + n', so premixed kernels destroy low modes by roundoff
~ eps * |h_{2n}(kt)| (and overflow float32 outright).  Stable paths:

  *  d = 2: Graf's addition theorem in closed form (exact, O(H^2)):
         M[m',m] = i^{|m'|-|m|+|m-m'|} C_{|m-m'|}(k|t|) e^{i(m-m') theta_t}
  *  d >= 3: masked band accumulation -- scan over n'', each step one
     batched [H,Q]x[Q,H] contraction with the single-band kernel
     (zonal values by a Gegenbauer three-term recurrence carried through
     the scan), accumulated only into entries with n + n' >= n''.  Each
     entry only ever meets bands at or below its own magnitude scale.

All arithmetic is over the real-pair complex type (ops/cplx.py): the
contractions are Karatsuba 3x-real-einsum matmuls.  Method names keep
API parity with the reference ("triplet"/"gumerov"/"plane_wave"/None;
"plane_wave" rejected for (S|R) exactly as in the reference).
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from ..coords import from_cartesian, to_cartesian
from ..harmonics._eval import harmonics
from ..harmonics._index import basis
from ..harmonics._quad import sphere_quadrature
from ..ops import cplx
from ..ops.cplx import C
from ..special._family import spherical_jh_all


def _a_const(d):
    return 2.0 ** ((d + 1) / 2.0) * np.pi ** ((d - 1) / 2.0)


def _surface_area(d):
    from scipy.special import gamma

    return float(2.0 * np.pi ** (d / 2.0) / gamma(d / 2.0))


def _quad_tables(c, n_out, n_in):
    """Static quadrature tables (dtype follows the active x64 mode)."""
    return _quad_tables_impl(c, n_out, n_in, jax.config.jax_enable_x64)


@lru_cache(maxsize=32)
def _quad_tables_impl(c, n_out, n_in, _x64):
    """(w [Q], Yo_conj C [Q,Ho], Yi C [Q,Hi], s_cart [d,Q], phase C [Ho,Hi],
    n_o [Ho], n_i [Hi])."""
    deg = 2 * ((n_out - 1) + (n_in - 1))
    with jax.ensure_compile_time_eval():
        sph, w = sphere_quadrature(c, deg)
        sph_j = {key: jnp.asarray(v) for key, v in sph.items()}
        yo = harmonics(c, sph_j, n_out)
        yi = yo if n_in == n_out else harmonics(c, sph_j, n_in)
        s_cart = to_cartesian(c, sph_j, include_r=False)
        bo = basis(c, n_out)
        bi = basis(c, n_in)
        # the i^{n_o - n_i} phase is applied separably (row x col) by the
        # consumers from these [H] degree vectors — an [Ho, Hi] phase
        # constant costs O(H^2) compile memory/folding time.
        # Host numpy leaves: jit traces embed them as HLO literals
        # instead of capturing device buffers (_rotation._coax_tables).
        yoc = yo.conj()
        out = (
            np.asarray(w),
            C(np.asarray(yoc.re), np.asarray(yoc.im)),
            C(np.asarray(yi.re), np.asarray(yi.im)),
            np.asarray(s_cart),
            np.asarray(bo.n_root, dtype=np.int32),
            np.asarray(bi.n_root, dtype=np.int32),
        )
    return out


@lru_cache(maxsize=32)
def _a_node_m(c, n_end):
    """2D helper: signed azimuthal order m per flat harmonic."""
    b = basis(c, n_end)
    nid = c.root.nid
    jobs = b.node_jobs[nid]
    ms = np.array([p[0] for p in jobs], dtype=np.int64)
    return ms[b.node_job_index[nid]]


def _real_dtype_of(*xs):
    parts = []
    for x in xs:
        parts.append(x.re if isinstance(x, C) else x)
    return jnp.result_type(*parts, jnp.float32)


def _graf_2d(c, t_sph, n_out, n_in, k, kind):
    """Closed-form 2D translation via Graf's addition theorem.

    In our basis (Y_m = e^{i m phi}/sqrt(2 pi), degree |m|) the triplet
    formula collapses (Gaunt = delta_{m'' = m - m'} / sqrt(2 pi)) to
    M[m', m] = i^{|m'|-|m|+|m-m'|} C_{|m-m'|}(k|t|) e^{i(m-m') theta_t}
    with C = H^{(1)} for (S|R), J for (R|R).
    """
    mo = _a_node_m(c, n_out)
    mi = _a_node_m(c, n_in)
    mu_max = int(np.abs(mi).max() + np.abs(mo).max())
    r_t = t_sph["r"]
    theta = t_sph[c.root.nid]
    z = C.of(k) * r_t if isinstance(k, C) else jnp.asarray(k) * r_t
    jf, _, hf, _ = spherical_jh_all(2, mu_max + 1, z)
    tab = hf if kind == "SR" else jf  # sqrt(pi/2) * (H or J)
    tab = tab * np.sqrt(2.0 / np.pi)  # back to standard cylinder functions
    rdt = _real_dtype_of(theta, tab)
    # [Ho, Hi] tables built ON DEVICE from barriered [H] order vectors:
    # host-numpy versions lower as O(H^2) HLO literals, which at
    # n_end >= ~2.4k (H ~ 4.9k: >90 MB per table) blow past the remote
    # compiler's request-size limit (HTTP 413) and the constant folder.
    mo_d, mi_d = jax.lax.optimization_barrier(
        (jnp.asarray(mo, jnp.int32), jnp.asarray(mi, jnp.int32))
    )
    mu = mi_d[None, :] - mo_d[:, None]  # [Ho, Hi], in - out
    mu_abs = jnp.abs(mu)
    ipow = cplx.ipow_device(
        jnp.abs(mo_d)[:, None] - jnp.abs(mi_d)[None, :] + mu_abs, rdt
    )
    gathered = cplx.take(tab, mu_abs, axis=-1)  # [..., Ho, Hi]
    phase = cplx.expi(theta[..., None, None] * mu.astype(rdt))
    return gathered * ipow * phase


def _diag_contract(band, yoc, yi):
    """einsum('...q,qa,qb->...ab', band, conj(Yo), Yi) for C operands:
    scale conj(Yo) columns by the kernel, then one Karatsuba contraction."""
    scaled = yoc[None, ...] * band[..., None]  # C [..., Q, Ho]
    return cplx.einsum("...qa,qb->...ab", scaled, yi)


def _sr_banded(c, t_sph, n_out, n_in, k, kind):
    """Masked band-accumulation (S|R) (or (R|R)) for d >= 3."""
    d = c.c_ndim
    w, yoc, yi, s_cart, n_o, n_i = _quad_tables(c, n_out, n_in)
    r_t = t_sph["r"]
    rdt = _real_dtype_of(k, r_t)
    w = w.astype(rdt)
    yoc = yoc.astype(rdt)
    yi = yi.astype(rdt)
    # separable i^{n_o - n_i} phase + Gaunt cutoff, built on device from
    # the barriered [H] degree vectors (keeps the constant folder away
    # from [Ho, Hi]-sized expressions)
    n_o_d, n_i_d = jax.lax.optimization_barrier((n_o, n_i))
    p_o = cplx.ipow_device(n_o_d, rdt)
    p_i_conj = cplx.ipow_device(n_i_d, rdt).conj()

    def apply_phase(mat):
        return (mat * p_o[:, None]) * p_i_conj[None, :]
    t_hat = to_cartesian(c, {**t_sph, "r": jnp.ones_like(r_t)})
    # cos(gamma) between t^ and each quadrature direction: [..., Q]
    x = jnp.tensordot(
        jnp.moveaxis(t_hat, 0, -1).astype(rdt), s_cart.astype(rdt), axes=(-1, 0)
    )

    n_bands = (n_out - 1) + (n_in - 1) + 1
    z = C.of(k) * r_t if isinstance(k, C) else jnp.asarray(k) * r_t
    jf, _, hf, _ = spherical_jh_all(d, n_bands, z)
    rad = hf if kind == "SR" else jf  # C [..., n_bands]

    nu = 0.5 * (d - 2.0)
    a_d = _a_const(d)
    omega = _surface_area(d)
    nsum = n_o_d[:, None] + n_i_d[None, :]  # [Ho, Hi]

    ho, hi = yoc.shape[-1], yi.shape[-1]
    batch = jnp.broadcast_shapes(x.shape[:-1], rad.shape[:-1])
    m0 = C.zeros(batch + (ho, hi), dtype=rdt)

    def step(carry, n2):
        c_prev, c_cur, m = carry
        # zonal kernel Z_{n''} = (2n''+d-2)/(d-2) * C^{nu}_{n''}(x) / omega
        zonal = (2.0 * n2 + d - 2.0) / (d - 2.0) / omega * c_cur
        rad_n2 = cplx.take(rad, n2.astype(jnp.int32), axis=-1)  # C [...]
        band = cplx.expi((np.pi / 2.0) * n2) * a_d * rad_n2[..., None] * (zonal * w)
        t_mat = _diag_contract(band, yoc, yi)
        m = m + cplx.where(nsum >= n2, t_mat, C.of(0.0))
        # Gegenbauer recurrence: (n+1) C_{n+1} = 2(n+nu) x C_n - (n+2nu-1) C_{n-1}
        c_next = (2.0 * (n2 + nu) * x * c_cur - (n2 + 2.0 * nu - 1.0) * c_prev) / (
            n2 + 1.0
        )
        return (c_cur, c_next, m), None

    c0 = jnp.ones_like(x)
    cm1 = jnp.zeros_like(x)
    ns = jnp.arange(n_bands, dtype=x.dtype)
    (_, _, m), _ = jax.lax.scan(step, (cm1, c0, m0), ns)
    return apply_phase(m)


def translation_matrix(
    c, t, n_end, k, kind="SR", n_end_add=None, method=None
):
    """Translation operator matrix C [..., H_out, H_in] for offsets t.

    Parameters
    ----------
    c : SphericalCoordinates
    t : cartesian offsets [d, ...] or a spherical mapping (from_cartesian)
    n_end : output (re-expansion) degree cutoff -> H_out harmonics
    k : wavenumber (real array or C), broadcastable to t's batch shape
    kind : "SR" (singular-around-regular; the BIEM inter-sphere coupling)
        or "RR"
    n_end_add : input degree cutoff (default n_end) -> H_in harmonics
    method : None | "triplet" | "plane_wave" | "gumerov" | "rotation" (API
        parity with reference _biem.py:569-574; all exact here).
        "plane_wave" is only valid for kind="RR"; "gumerov" selects the
        Gumerov-Duraiswami recurrence ladders (_gumerov.py) and, as in
        the reference, is only available for the 3D "ba" tree.

    Convention: S_h(y + t) = sum_{h'} M[..., h', h] R_{h'}(y).
    """
    n_in = n_end if n_end_add is None else n_end_add
    if method not in (None, "triplet", "plane_wave", "gumerov", "rotation"):
        raise ValueError(f"unknown translation method {method!r}")
    if kind == "SR" and method == "plane_wave":
        raise ValueError(
            'method="plane_wave" is only available for same-type (R|R) '
            "translation (reference: _biem.py:573-574)"
        )
    if kind not in ("SR", "RR"):
        raise ValueError(f"kind must be 'SR' or 'RR', got {kind!r}")

    if isinstance(t, dict):
        t_sph = t
        t_cart = None
    else:
        t_cart = jnp.asarray(t)
        t_sph = from_cartesian(c, t_cart)
    if not isinstance(k, C):
        k = jnp.asarray(k)

    if method == "gumerov":
        from ._gumerov import _require_gumerov_tree, sr_gumerov

        _require_gumerov_tree(c)
        if n_in != n_end:
            raise ValueError(
                'method="gumerov" requires n_end_add == n_end'
            )
        return sr_gumerov(c, t_sph, n_end, k, kind=kind, t_cart=t_cart)

    if c.c_ndim == 2:
        return _graf_2d(c, t_sph, n_end, n_in, k, kind)

    # fast path: rotation + coaxial decomposition (O(H^2) per offset) for
    # 'b'-rooted trees; auto-selected, or forced with method="rotation"
    use_rotation = method == "rotation" or (
        method is None
        and c.root.kind in ("b", "bp")
        and n_in == n_end
    )
    if use_rotation:
        from ._rotation import sr_rotation

        return sr_rotation(c, t_sph, n_end, k, kind=kind, t_cart=t_cart)

    if kind == "RR":
        # bounded plane-wave kernel: single dense contraction, exact
        w, yoc, yi, s_cart, n_o, n_i = _quad_tables(c, n_end, n_in)
        if t_cart is None:
            t_cart = to_cartesian(c, t_sph)
        rdt = _real_dtype_of(k, t_cart)
        ts = jnp.tensordot(
            jnp.moveaxis(t_cart, 0, -1).astype(rdt), s_cart.astype(rdt), axes=(-1, 0)
        )
        kk = k if isinstance(k, C) else C.of(k)
        f = cplx.exp(kk[..., None] * ts * 1j) * w.astype(rdt)
        m = _diag_contract(f, yoc.astype(rdt), yi.astype(rdt))
        n_o_d, n_i_d = jax.lax.optimization_barrier((n_o, n_i))
        p_o = cplx.ipow_device(n_o_d, rdt)
        p_i_conj = cplx.ipow_device(n_i_d, rdt).conj()
        return (m * p_o[:, None]) * p_i_conj[None, :]

    return _sr_banded(c, t_sph, n_end, n_in, k, kind)
