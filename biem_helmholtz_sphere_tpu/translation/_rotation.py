r"""Rotation + coaxial (S|R) translation: the fast path for 'b'-rooted trees.

Decomposition (any dimension, tree rooted at a 'b'/'bp' node whose
distinguished cartesian axis is e):

    SR(t) = D(R)^H  SR_e(|t|)  D(R),        R e = t^

*  `SR_e(r)` — translation along the root axis — is block-diagonal over
   the child states (orthonormality of the child harmonics kills all
   cross terms) and its zonal kernel depends on the polar angle only, so
   it reduces to a 1-D Gauss integral per radius:

       SR_e[(l',c),(l,c)](r) = i^{l'-l} sum_q w_q F(theta_q)
                               T[q,(n_c,l')] T[q,(n_c,l)]
       F(theta) = sum_{n''} A_d i^{n''} h_{n''}(k r)
                  Yz_{n''} rootfac_{(0,n'')}(theta) / sqrt(omega_child)

   with T the (real) root-node factor table and the same masked band
   accumulation as the general scan for stability (each (l', l) entry
   only meets bands n'' <= l + l').

*  `D(R)` — the harmonic representation of the rotation R — preserves
   degree (block-diagonal over degrees), is unitary, and is computed
   exactly by quadrature: D[h',h] = sum_q w_q conj(Y_{h'}(s_q))
   Y_h(R^{-1} s_q), with a rule exact to degree 2(n_end-1).  Because D
   is degree-block-diagonal, the sandwich never mixes magnitude scales
   of SR_e: the route is as stable as the banded scan.

Cost per pair: one [H,Q_rot] x [Q_rot,H] quadrature contraction for D
plus two [H,H] x [H,H] matmuls — ~100x fewer FLOPs than the band scan at
n_end = 32 (no Q ~ 8 n^2 factor, no 2n band sweep per pair); the
coaxial factor is shared across pairs with equal |t|.
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from ..coords import from_cartesian, to_cartesian
from ..harmonics._eval import _node_table, harmonics
from ..harmonics._index import basis
from ..harmonics._quad import _node_rule, sphere_quadrature
from ..ops import cplx
from ..ops.cplx import C
from ..special._family import spherical_jh_all
from ._ops import _a_const, _surface_area


def _root_axis(c):
    if c.root.kind not in ("b", "bp"):
        raise ValueError(
            "rotation translation requires a 'b'/'bp'-rooted tree "
            f"(got {c.root.kind!r})"
        )
    return c.root.axis


@lru_cache(maxsize=32)
def _coax_tables(c, n_end, _x64):
    """Static tables for the coaxial factor.

    Returns (zf [NB] real zonal prefactors, U [NB, H, H] real
    radius-independent band matrices exactly masked to the Gaunt support
    and the child-state delta, phase C [H, H] = i^{l'-l}).
    """
    with jax.ensure_compile_time_eval():
        b = basis(c, n_end)
        root = c.root
        nid = root.nid
        jobs = b.node_jobs[nid]
        th, w = _node_rule(root, 4 * (n_end - 1) + 2)
        th_j = jnp.asarray(th)
        t_tab = _node_table(root, jobs, {nid: th_j})  # [q, J] real
        # child-state id: tuple of all non-root jobs
        nids = [n.nid for n in c.nodes if n.nid != nid]
        keys = {}
        cs = np.empty(b.num, dtype=np.int32)
        for h in range(b.num):
            key = tuple(int(b.node_job_index[i][h]) for i in nids)
            cs[h] = keys.setdefault(key, len(keys))
        ell = np.array([jobs[j][1] for j in b.node_job_index[nid]], dtype=np.int32)
        ncs = np.array([jobs[j][0] for j in b.node_job_index[nid]], dtype=np.int32)

        # zonal bands: root jobs (0, n'') for n'' < 2 n_end - 1
        n2_end = 2 * n_end - 1
        b2 = basis(c, n2_end)
        jobs2 = b2.node_jobs[nid]
        zsel = [(i, p[1]) for i, p in enumerate(jobs2) if p[0] == 0]
        zidx = np.array([i for i, _ in sorted(zsel, key=lambda t: t[1])])
        t2 = _node_table(root, jobs2, {nid: th_j})  # [q, J2]
        tz = t2[:, jnp.asarray(zidx)]  # [q, NB] rootfac_{(0,n'')}(theta)
        tz0 = _node_table(root, jobs2, {nid: jnp.zeros((1,), th_j.dtype)})[
            0, jnp.asarray(zidx)
        ]  # rootfac at the pole
        # Y_{(n'',0)}(z^) and conj(Y_{(n'',0)}(s^)) each carry 1/sqrt(omega_child)
        omega_child = _surface_area(root.children[0].sdim + 1)
        zf = tz0 / omega_child
        t_cols = t_tab[:, jnp.asarray(b.node_job_index[nid])]  # [q, H]
        # NOTE: everything O(H^2) — the U[n''] band matrices, the Gaunt
        # band mask lsum >= n'', the child-state mask and the i^{l'-l}
        # phase — is built ON DEVICE by the consumers from these O(H)
        # vectors, behind an optimization_barrier.  Baking H^2 tables in
        # as constants overflowed the AOT compile payload, and even the
        # [H, H] int/compare constants sent XLA's compile-time constant
        # folder through [NB, H, H]-sized evaluations (gigabytes of
        # single-threaded host work per compile at n_end = 64).
        #
        # Returned as HOST numpy arrays so downstream jit traces embed
        # them as HLO literals (concrete at trace time) instead of
        # capturing device buffers.
        out = (
            np.asarray(zf),
            np.asarray(w),
            np.asarray(tz),
            np.asarray(t_cols),
            np.asarray(ell, dtype=np.int32),
            np.asarray(cs, dtype=np.int32),
        )
    return out


def coaxial_sr(c, r, n_end, k, kind="SR"):
    """SR along the root axis for radii r [...]: C [..., H, H].

    The radius-independent band matrices U[n''] = int tz_{n''} T_{l'} T_l
    (exactly masked to the Gaunt support l + l' >= n'' and the child-state
    delta) are built on-device from the small static tables, then
    contracted with the radius-dependent complex band coefficients.
    """
    _root_axis(c)  # validate tree shape before touching tables
    d = c.c_ndim
    zf, w, tz, t_cols, ell, cs = _coax_tables(
        c, n_end, jax.config.jax_enable_x64
    )
    rdt = jnp.result_type(
        r.dtype if not isinstance(r, C) else r.re.dtype, jnp.float32
    )
    zf = zf.astype(rdt)
    w = w.astype(rdt)
    # barrier: keep XLA's constant folder away from the O(H^2) / [NB,H,H]
    # expressions built from these small constants (see _coax_tables)
    tz, t_cols, ell, cs = jax.lax.optimization_barrier(
        (tz.astype(rdt), t_cols.astype(rdt), ell, cs)
    )

    n_bands = 2 * n_end - 1
    z = k * r
    jf, _, hf, _ = spherical_jh_all(d, n_bands, z)
    rad = hf if kind == "SR" else jf  # C [..., NB]
    coef = cplx.ipow(np.arange(n_bands)) * (_a_const(d) * zf) * rad  # C [..., NB]

    u = jnp.einsum("qn,qa,qb->nab", tz * w[:, None], t_cols, t_cols)
    lsum = ell[:, None] + ell[None, :]
    u = jnp.where(lsum[None] >= jnp.arange(n_bands)[:, None, None], u, 0.0)
    m = C(
        jnp.einsum("...n,nab->...ab", coef.re, u),
        jnp.einsum("...n,nab->...ab", coef.im, u),
    )
    # i^{l'-l} phase is rank-1 separable: i^{l'} (row) x conj(i^{l}) (col)
    p = cplx.ipow_device(ell, rdt)
    m = (m * p[:, None]) * p.conj()[None, :]
    mask = cs[:, None] == cs[None, :]
    return cplx.where(mask, m, C.of(0.0))


@lru_cache(maxsize=256)
def _degree_groups(c, n_end, target=128):
    """Contiguous [start, stop) row groups aligned to root-degree-block
    boundaries, each <= target rows where block sizes allow (a single
    block larger than target becomes its own group).

    The rotation D is exactly degree-block-diagonal and the basis
    layout is degree-CONTIGUOUS (verified for every branching grammar),
    so D-matmuls restricted to these groups do H * sum(g^2) work
    instead of H^3 — ~9x fewer flops at n_end=32 with target=128,
    which is what makes the (S|R) build sandwich cheap.
    """
    n_root = np.asarray(basis(c, n_end).n_root)
    bounds = [0] + [
        i for i in range(1, len(n_root)) if n_root[i] != n_root[i - 1]
    ] + [len(n_root)]
    groups = []
    start = 0
    for bi in range(1, len(bounds) - 1):
        if bounds[bi + 1] - start > target and bounds[bi] > start:
            groups.append((start, bounds[bi]))
            start = bounds[bi]
    groups.append((start, bounds[-1]))
    return tuple(groups)


@lru_cache(maxsize=32)
def _rot_tables(c, n_end, _x64):
    """Quadrature rule + conj(Y) table + degree-block mask for rotations.

    Host numpy leaves (see _coax_tables NOTE: jit traces embed them as
    HLO literals instead of capturing device buffers)."""
    with jax.ensure_compile_time_eval():
        deg = 2 * (n_end - 1)
        sph, w = sphere_quadrature(c, deg)
        sph_j = {key: jnp.asarray(v) for key, v in sph.items()}
        y = harmonics(c, sph_j, n_end)
        s_cart = to_cartesian(c, sph_j, include_r=False)  # [d, Q]
        yc = y.conj()
        out = (
            np.asarray(w),
            C(np.asarray(yc.re), np.asarray(yc.im)),
            np.asarray(s_cart),
            np.asarray(basis(c, n_end).n_root, dtype=np.int32),
        )
    return out


def _rotation_to_axis(t_hat, axis, d):
    """R with R e_axis = t_hat, as a [..., d, d] matrix (Rodrigues in the
    plane span(e_axis, t_hat); safe at t_hat = +-e_axis)."""
    e = jnp.zeros((d,), t_hat.dtype).at[axis].set(1.0)
    ct = t_hat[..., axis]  # cos(angle)
    v = t_hat - ct[..., None] * e  # component orthogonal to e
    s = jnp.linalg.norm(v, axis=-1)
    safe = s > 1e-7
    v_hat = jnp.where(safe[..., None], v / jnp.where(safe, s, 1.0)[..., None], 0.0)
    eye = jnp.eye(d, dtype=t_hat.dtype)
    uu = e[:, None] * e[None, :]
    vv = v_hat[..., :, None] * v_hat[..., None, :]
    vu = v_hat[..., :, None] * e[None, :]
    uv = e[:, None] * v_hat[..., None, :]
    r = (
        eye
        + (ct[..., None, None] - 1.0) * (uu + vv)
        + s[..., None, None] * (vu - uv)
    )
    # t_hat ~ -e: rotate by pi in the (e, e_other) plane
    anti = (~safe) & (ct < 0)
    other = (axis + 1) % d
    flip = jnp.eye(d, dtype=t_hat.dtype)
    flip = flip.at[axis, axis].set(-1.0).at[other, other].set(-1.0)
    r = jnp.where(anti[..., None, None], flip, r)
    # t_hat ~ +e: identity
    r = jnp.where(((~safe) & (ct >= 0))[..., None, None], eye, r)
    return r


def rotation_blocks(c, t_hat, n_end):
    """D(R) as degree-group diagonal blocks: (groups, [C [..., g, g]]).

    D is exactly degree-block-diagonal, so only the _degree_groups
    diagonal tiles are ever nonzero; computing the quadrature
    contraction per tile does Q * sum(g^2) work instead of Q * H^2
    (~9x fewer MACs at n_end=32), and consumers (the rotation+coaxial
    sandwich) multiply by the tiles directly without touching the H^2
    zero sea.  The quadrature leaves ~eps off-block residue which,
    sandwiched against coax blocks of magnitude |h_{n+n'}(kr)|, would
    leak huge-scale roundoff into low-degree entries (0.23 rel error in
    float32 at n_end=10); masking within each group restores the band
    scan's per-entry scale discipline.
    """
    d = c.c_ndim
    axis = _root_axis(c)
    w, yc, s_cart, n_root = _rot_tables(c, n_end, jax.config.jax_enable_x64)
    rdt = jnp.result_type(t_hat.dtype, jnp.float32)
    w = w.astype(rdt)
    yc = yc.astype(rdt)
    s_cart = s_cart.astype(rdt)
    r = _rotation_to_axis(t_hat.astype(rdt), axis, d)  # [..., d, d]
    # R^{-1} s = R^T s
    s_rot = jnp.einsum("...ij,iq->...jq", r, s_cart)  # [..., d, Q]
    sph_rot = from_cartesian(c, jnp.moveaxis(s_rot, -2, 0))
    y_rot = harmonics(c, sph_rot, n_end)  # C [..., Q, H]
    ycw = yc * w[:, None]
    groups = _degree_groups(c, n_end)
    n_root_np = np.asarray(n_root)
    blocks = []
    for s, e in groups:
        dmat_g = cplx.einsum(
            "qa,...qb->...ab", ycw[:, s:e], y_rot[..., s:e]
        )
        nr_g = n_root_np[s:e]
        if (nr_g[0] != nr_g[-1]):  # group spans several degree blocks
            mask = jax.lax.optimization_barrier(
                jnp.asarray(nr_g)
            )
            dmat_g = cplx.where(
                mask[:, None] == mask[None, :], dmat_g, C.of(0.0)
            )
        blocks.append(dmat_g)
    return groups, blocks


def rotation_matrix(c, t_hat, n_end):
    """D(R)[..., h', h] with R e_root = t_hat: the unitary, degree-block-
    diagonal harmonic representation of the rotation, by quadrature
    (assembled from rotation_blocks; exact zeros off the degree
    groups)."""
    groups, blocks = rotation_blocks(c, t_hat, n_end)
    h_num = groups[-1][1]
    batch = blocks[0].shape[:-2]
    rdt = blocks[0].re.dtype
    out = C.zeros(batch + (h_num, h_num), dtype=rdt)
    for (s, e), blk in zip(groups, blocks):
        out = out.at_set((..., slice(s, e), slice(s, e)), blk)
    return out


def _dedup_radii(r_t, k):
    """(uniq_r, inv) when r_t is a concrete 1-D batch with repeats, else
    (None, None).  Structured geometries (lattices) repeat |t| across
    many offset directions; the coaxial factor only depends on |t|, so
    computing it once per distinct radius and gathering saves ~60% of
    the coaxial work on a 4x4 lattice (24 offsets, 9 distinct radii).
    Requires k's trailing axis to be broadcast (size 1 / absent): a k
    batched PER OFFSET cannot ride a deduplicated offset axis."""
    import jax as _jax

    k_shape = k.shape if not isinstance(k, C) else k.re.shape
    if len(k_shape) > 0 and k_shape[-1] != 1:
        return None, None
    if isinstance(r_t, _jax.core.Tracer) or jnp.ndim(r_t) != 1:
        return None, None
    r_np = np.round(np.asarray(r_t), 10)
    uniq, inv = np.unique(r_np, return_inverse=True)
    if len(uniq) >= len(r_np):
        return None, None
    return jnp.asarray(uniq, dtype=jnp.asarray(r_t).dtype), inv


def sr_rotation(c, t_sph, n_end, k, kind="SR", t_cart=None):
    """(S|R) via rotation + coaxial: C [..., H, H].

    t described by its spherical mapping (with "r"); batch axes allowed.
    When the cartesian offsets are available, pass them as `t_cart`
    [d, ...]: r and t_hat are then derived by plain norm/divide instead
    of the angle roundtrip to_cartesian(from_cartesian(t)): fewer
    operations, and no trig chain whose rounding can drift.
    """
    _root_axis(c)
    if t_cart is not None:
        t_vec = jnp.moveaxis(jnp.asarray(t_cart), 0, -1)  # [..., d]
        r_t = jnp.linalg.norm(t_vec, axis=-1)
        t_hat = t_vec / jnp.where(r_t > 0, r_t, 1.0)[..., None]
    else:
        r_t = t_sph["r"]
        t_cart_ = to_cartesian(c, {**t_sph, "r": jnp.ones_like(r_t)})
        t_hat = jnp.moveaxis(t_cart_, 0, -1)  # [..., d]
    uniq_r, inv = _dedup_radii(r_t, k)
    if uniq_r is not None:
        coax = coaxial_sr(c, uniq_r, n_end, k, kind=kind)[..., inv, :, :]
    else:
        coax = coaxial_sr(c, r_t, n_end, k, kind=kind)  # [..., H, H]
    # SR(t) = D Coax D^H  (validated against the band scan to ~1e-12),
    # multiplied per degree group: D is block-diagonal, so each product
    # only touches the [*, g] / [g, *] stripes (see rotation_blocks)
    return _sandwich(c, n_end, coax, t_hat)


def _sandwich(c, n_end, coax, t_hat):
    """D(t_hat) @ coax @ D(t_hat)^H with D assembled from its degree
    blocks.

    The products deliberately run as FULL [H, H] matmuls: on the first
    accelerator this package ran on, a degree-group-restricted product —
    despite ~9x fewer MACs — ran SLOWER (slices at unaligned degree
    boundaries force relayout copies and small matmuls underuse the
    matrix units).  Not re-measured on the H100.  The grouped path only
    pays off for the D QUADRATURE build (rotation_blocks), which is
    kept.
    """
    rot = rotation_matrix(c, t_hat, n_end)
    tmp = cplx.einsum("...ij,...kj->...ik", coax, rot.conj())
    return cplx.einsum("...ij,...jk->...ik", rot, tmp)
