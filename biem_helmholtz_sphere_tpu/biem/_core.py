r"""BIEM assembly and solve (the reference's layer 4 core, _biem.py:453-819).

Combined-field indirect formulation: expand the unknown density on each
sphere b in hyperspherical harmonics; the scattered field ansatz is
u_scat = sum_b (D - i eta S)[phi_b].  On-sphere traces are diagonal per
harmonic (layer coefficients, _layer.py); inter-sphere coupling is the
(S|R) translation operator (translation/_ops.py).  The resulting dense
block system

  A[b,h;b',h'] = blc_{n'}(rho_b') * ( b == b' :
        delta_{hh'} (alpha_b h_n(k rho_b) + beta_b k h_n'(k rho_b))
      : (S|R)[h,h'](c_b - c_b') (alpha_b j_n(k rho_b) + beta_b k j_n'(k rho_b)) )

  f[b,h] = int_S [-alpha_b u_in - beta_b grad u_in . n](c_b + rho_b y)
           conj(Y_h(y)) dy

is solved with XLA's batched LU through the real block embedding
(ops/cplx.solve; replaces `batch-tensorsolve`, reference _biem.py:797).
All leading batch axes (k sweeps, BC grids, geometry ensembles)
broadcast through, exactly as in the reference (_biem.py:77-101,
288-307); under jit everything fuses into one XLA program.  All complex
quantities are real-pair C values (ops/cplx.py), a layer kept from the
package's first, complex-free accelerator design.
"""

import warnings
from dataclasses import dataclass
from typing import Any, Literal

import jax
import jax.numpy as jnp
import numpy as np

from ..harmonics._expand import _quad_harmonics
from ..harmonics._index import basis
from ..ops import cplx
from ..ops.cplx import C
from ..special._family import spherical_jh_all, spherical_jh_scaled
from ..translation._ops import translation_matrix
from ._layer import blc
from ._memory import max_memory, max_n_end  # noqa: F401  (re-exported)

# pairs of spheres processed per translation chunk (bounds the
# [chunk, Q, H] intermediate of the banded contraction)
_PAIR_CHUNK = 16

# Auto-policy limits per platform: (lu_limit, dense_limit) = the largest
# system (rows of B*H) still solved by direct LU, and the largest dense
# matrix in bytes before the matrix-free route takes over.  The "gpu"
# values are carried over unchanged from the first accelerator this
# package ran on and are not measured on the H100; re-deriving them is
# an open ROADMAP.md item.
_POLICY_LIMITS = {"cpu": (12288, 40e9), "gpu": (6144, 6e9)}


def policy_limits(platform):
    """(lu_limit, dense_limit) of the auto solver policy on `platform`."""
    try:
        return _POLICY_LIMITS[platform]
    except KeyError:
        raise ValueError(
            f"no auto-policy limits for platform {platform!r}; known: "
            f"{sorted(_POLICY_LIMITS)}"
        ) from None


def _is_concrete(*arrays):
    leaves = jax.tree_util.tree_leaves(arrays)
    return not any(isinstance(a, jax.core.Tracer) for a in leaves)


def _to_np(x):
    return x.to_numpy() if isinstance(x, C) else np.asarray(x)


def _norm_input(x):
    """Normalize an input array WITHOUT staging host constants as
    tracers: numpy arrays / python scalars stay numpy, jax arrays and
    tracers pass through.  JAX 0.9 stages `jnp.asarray(np_constant)`
    inside a trace as a DynamicJaxprTracer, which would blind every
    trace-time concrete-geometry optimization (offset dedup, the
    block-gather assembly, matrix-free pair routing) when callers close
    over host geometry."""
    if isinstance(x, (jax.core.Tracer, jax.Array, C)):
        return x
    return np.asarray(x)


def _c_norm(x):
    """C-coerce like C.of but keeping host (numpy) leaves host."""
    if isinstance(x, C):
        return x
    x = _norm_input(x)
    if isinstance(x, np.ndarray):
        if np.issubdtype(x.dtype, np.complexfloating):
            return C(np.ascontiguousarray(x.real), np.ascontiguousarray(x.imag))
        return C(x, np.zeros_like(x))
    return C.of(x)


def _check_biem_inputs(c, centers, radii, k, eta, alpha, beta):
    """Validate/normalize inputs (reference: _biem.py:240-326).

    alpha/beta are promoted to real-pair complex C; k stays real unless
    complex-valued input was given (then C).  Host (numpy) inputs stay
    numpy so trace-time geometry optimizations see concrete values.
    """
    centers = _norm_input(centers)
    radii = _norm_input(radii)
    if not isinstance(k, C):
        k = _norm_input(k)
        if jnp.issubdtype(k.dtype, jnp.complexfloating):
            k = _c_norm(k)
    if eta is None:
        eta = np.ones((1,) * k.ndim)
    else:
        eta = _norm_input(eta)
        if jnp.issubdtype(eta.dtype, jnp.complexfloating):
            raise ValueError("The decoupling parameter eta must be real.")
    alpha = _c_norm(alpha)
    if alpha.ndim == 0:
        alpha = alpha.reshape((1,) * (k.ndim + 1))
    beta = _c_norm(beta)
    if beta.ndim == 0:
        beta = beta.reshape((1,) * (k.ndim + 1))

    if _is_concrete(eta, k):
        # host-side physics sanity checks on concrete values
        eta_np = np.asarray(eta)
        k_np = _to_np(k)
        if bool(np.any(eta_np == 0)):
            warnings.warn(
                "The solution may be incorrect if k is an eigenvalue of the "
                "interior Neumann Laplacian (eta = 0; reference: "
                "_biem.py:269-277).",
                UserWarning,
                stacklevel=3,
            )
        if bool(np.any((np.imag(k_np) < 0) | (eta_np * np.real(k_np) < 0))):
            warnings.warn(
                "The solution may be incorrect if not (Im k >= 0 and "
                "eta Re k >= 0) (reference: _biem.py:278-285).",
                UserWarning,
                stacklevel=3,
            )

    if len({k.ndim, eta.ndim, centers.ndim - 2, radii.ndim - 1}) != 1:
        raise ValueError(
            f"k.ndim={k.ndim}, eta.ndim={eta.ndim}, centers.ndim-2="
            f"{centers.ndim - 2}, radii.ndim-1={radii.ndim - 1} are not the same."
        )
    try:
        jnp.broadcast_shapes(
            k.shape,
            eta.shape,
            centers.shape[:-2],
            radii.shape[:-1],
            alpha.shape[:-1],
            beta.shape[:-1],
        )
    except Exception as e:
        raise ValueError(
            "Shapes of k, eta, centers[:-2], radii[:-1], alpha[:-1], "
            f"beta[:-1] are not broadcastable: {tuple(k.shape)}, "
            f"{tuple(eta.shape)}, {tuple(centers.shape)}, {tuple(radii.shape)}, "
            f"{tuple(alpha.shape)}, {tuple(beta.shape)}"
        ) from e
    try:
        jnp.broadcast_shapes(centers.shape[:-1], radii.shape, alpha.shape, beta.shape)
    except Exception as e:
        raise ValueError(
            "centers.shape[:-1], radii.shape, alpha.shape, beta.shape are "
            f"not broadcastable: {tuple(centers.shape)}, {tuple(radii.shape)}, "
            f"{tuple(alpha.shape)}, {tuple(beta.shape)}"
        ) from e
    if centers.shape[-1] != c.c_ndim:
        raise ValueError(
            f"The last dimension of centers must be c_ndim={c.c_ndim}, "
            f"but got {centers.shape[-1]}"
        )
    return centers, radii, k, eta, alpha, beta


@dataclass(frozen=True)
class BIEMResultCalculator:
    """Solved BIEM state; `uscat` evaluates the scattered field.

    Registered as a JAX pytree: array leaves (including real-pair C
    values) flow through jit/vmap; the coordinate tree / n_end / kind /
    uin are static metadata (reference analogue: _biem.py:196-237).
    """

    centers: Any
    radii: Any
    k: Any
    eta: Any
    density: Any
    matrix: Any
    c: Any = None
    uin: Any = None
    n_end: int = 0
    kind: str = "outer"
    #: final preconditioned relative-residual estimate of the iterative
    #: solve per batch system (None for direct/LU and single-sphere
    #: solves, which are exact to rounding) — lets sweeps and users
    #: distinguish converged from stagnated GMRES solves (round 4).
    relres: Any = None
    #: Krylov steps until convergence PER batch system (int32, batch
    #: shape; batched systems iterate together so the cost paid is
    #: max(iters)); None for direct solves.
    iters: Any = None

    def uscat(self, x, /, far_field=False, per_ball=False, expand_x=True):
        from ._eval import biem_u

        return biem_u(
            self, x, far_field=far_field, per_ball=per_ball, expand_x=expand_x
        )


jax.tree_util.register_dataclass(
    BIEMResultCalculator,
    data_fields=[
        "centers", "radii", "k", "eta", "density", "matrix", "relres",
        "iters",
    ],
    meta_fields=["c", "uin", "n_end", "kind"],
)


def _rhs_expansion(c, n_end, centers, radii, alpha, beta, uin, uin_grad, ndim_first):
    """Boundary-data expansion f: C [..., B, H] (reference: _biem.py:611-639)."""
    deg = 2 * (n_end - 1) + 1
    sph_np, wy = _quad_harmonics(c, n_end, deg)
    sph_j = {key: jnp.asarray(v) for key, v in sph_np.items()}
    from ..coords import to_cartesian

    xhat = to_cartesian(c, sph_j, include_r=False)  # [d, Q]
    d = c.c_ndim
    q = xhat.shape[1]
    # x[dim, q, b, ...first] = radii[b, ...] * xhat[dim, q] + centers[dim, b, ...]
    radii_t = jnp.moveaxis(radii, -1, 0)  # [B, ...first]
    centers_t = jnp.moveaxis(jnp.moveaxis(centers, -1, 0), -1, 1)  # [d, B, ...first]
    xhat_e = xhat.reshape((d, q, 1) + (1,) * ndim_first)
    x = radii_t[None, None] * xhat_e + centers_t[:, None]
    alpha_t = cplx.moveaxis(alpha, -1, 0)  # C [B, ...a]
    beta_t = cplx.moveaxis(beta, -1, 0)
    vals = C.of(0.0)
    if uin is not None:
        vals = vals - alpha_t * C.of(uin(x))
    if uin_grad is not None:
        vals = vals - beta_t * (C.of(uin_grad(x)) * xhat_e).sum(axis=0)
    # vals: [Q, B, ...first] -> project -> [B, ...first, H]
    f = cplx.einsum("q...,qh->...h", vals, wy)
    return cplx.moveaxis(f, 0, -2)  # [...first, B, H]


def _rhs_plane_wave(c, n_end, centers, radii, alpha, beta, kw, direction,
                    has_uin, has_grad):
    r"""Closed-form boundary-data expansion for a plane wave: C [..., B, H].

    From the d-dimensional plane-wave expansion (translation/_ops.py)
    e^{i k x.d^} = A_d sum_h i^{n_h} j_{n_h}(k|x|) Y_h(x^) conj(Y_h(d^)),
    the projection of u_in(c_b + rho_b y^) = e^{i k d^.c_b} e^{i k rho_b
    y^.d^} onto conj(Y_h) is analytic:

      f_h(b) = -A_d i^{n_h} e^{i k d^.c_b} conj(Y_h(d^))
               (alpha_b j_{n_h}(k rho_b) + beta_b k j'_{n_h}(k rho_b))

    replacing the S^{d-1} quadrature of `_rhs_expansion` (reference path:
    _biem.py:611-639) with one harmonics evaluation at the single
    direction d^ — exact (no quadrature aliasing) and ~0 cost; at the
    n_end=32, B=16 bench the quadrature RHS was 29% of the per-k-point
    wall time.  `kw`/`direction` are the wave's own (normalized) values
    from the `plane_wave` factory tag; alpha/beta terms are included
    exactly when the corresponding callable was passed, matching the
    quadrature path's semantics.
    """
    from ..coords import from_cartesian
    from ..harmonics._eval import harmonics
    from ..translation._ops import _a_const

    d = c.c_ndim
    b_ = basis(c, n_end)
    n_idx = jnp.asarray(b_.n_root)
    j, jp, _, _ = spherical_jh_all(d, n_end, _k_mul(kw[..., None], radii))
    jH = cplx.take(j, n_idx, axis=-1)
    jpH = cplx.take(jp, n_idx, axis=-1)
    term = C.of(0.0)
    if has_uin:
        term = term + alpha[..., None] * jH
    if has_grad:
        term = term + beta[..., None] * (jpH * kw[..., None, None])

    sph = from_cartesian(c, direction)  # direction: [d, ...kw]
    y_dir = harmonics(c, sph, n_end)  # C [...kw, H]
    rdt = y_dir.re.dtype
    n4 = np.asarray(b_.n_root) % 4
    i_pow = C(
        jnp.asarray(np.array([1.0, 0.0, -1.0, 0.0])[n4], rdt),
        jnp.asarray(np.array([0.0, 1.0, 0.0, -1.0])[n4], rdt),
    )
    cy = y_dir.conj() * i_pow * (-_a_const(d))  # C [...kw, H]

    centers_t = jnp.moveaxis(centers, -1, 0)  # [d, ..., B]
    ip = (centers_t * direction[..., None]).sum(axis=0)  # [..., B]
    if isinstance(kw, C):
        phase = cplx.exp(kw[..., None] * ip * 1j)
    else:
        phase = cplx.expi(kw[..., None] * ip)
    return (phase[..., None] * term) * cy[..., None, :]


def _rhs_dispatch(c, n_end, centers, radii, alpha, beta, uin, uin_grad, ndim_first):
    """RHS expansion with the analytic plane-wave fast path.

    When both callables carry the SAME `_analytic` tag (i.e. both came
    from one `plane_wave(...)` call), use the closed-form expansion;
    otherwise fall back to the S^{d-1} quadrature projection.  Every
    caller that builds the boundary-data RHS (biem() and the sharded
    solver) must go through here so all paths agree bit-for-bit.
    """
    tag_u = getattr(uin, "_analytic", None)
    tag_g = getattr(uin_grad, "_analytic", None)
    tags = [t for f, t in ((uin, tag_u), (uin_grad, tag_g)) if f is not None]
    if tags and all(t is tags[0] for t in tags) and tags[0] is not None:
        _, kw, direction = tags[0]
        return _rhs_plane_wave(
            c, n_end, centers, radii, alpha, beta, kw, direction,
            has_uin=uin is not None, has_grad=uin_grad is not None,
        )
    return _rhs_expansion(
        c, n_end, centers, radii, alpha, beta, uin, uin_grad, ndim_first
    )


def _k_mul(k, x):
    return k * x  # works for real jnp k and C k alike


def _radial_rows(c, n_end, radii, k, eta, alpha, beta):
    """Per-sphere radial factors shared by dense assembly and the
    matrix-free operator: (sing_row, reg_row, blc_col), each C [..., B, H]."""
    d = c.c_ndim
    b_ = basis(c, n_end)
    n_idx = jnp.asarray(b_.n_root)
    j, jp, h, hp = spherical_jh_all(d, n_end, _k_mul(k[..., None], radii))
    jH = cplx.take(j, n_idx, axis=-1)
    jpH = cplx.take(jp, n_idx, axis=-1)
    hH = cplx.take(h, n_idx, axis=-1)
    hpH = cplx.take(hp, n_idx, axis=-1)
    k_b = k[..., None, None]  # [..., 1(B), 1(H)]
    sing_row = alpha[..., None] * hH + beta[..., None] * (hpH * k_b)
    reg_row = alpha[..., None] * jH + beta[..., None] * (jpH * k_b)
    blc_col = blc(c, n_end, k[..., None], radii, eta[..., None])
    return sing_row, reg_row, blc_col


def _radial_rows_scaled(c, n_end, radii, k, eta, alpha, beta):
    """Scale-compensated radial rows: three (mantissa C, exponent) pairs.

    sing = alpha h_n + beta k h_n', reg = alpha j_n + beta k j_n',
    blc = i k^{d-2} rho^{d-1} (k j_n' - i eta j_n) — each returned as
    mant * exp(e) with |mant| representable at any (n, k rho): the plain
    _radial_rows overflows h (and underflows j) in float32 from
    n ~ k rho + 20.  Exponents of the two terms in each sum are folded
    at their maximum so every factor entering the sum is <= 1.
    """
    d = c.c_ndim
    b_ = basis(c, n_end)
    n_idx = jnp.asarray(b_.n_root)
    z = _k_mul(k[..., None], radii)
    (jm, je), (jpm, jpe), (hm, he), (hpm, hpe) = spherical_jh_scaled(d, n_end, z)

    def gat(t):
        return cplx.take(t, n_idx, axis=-1)

    def gat_r(t):
        return jnp.take(t, n_idx, axis=-1)

    jmH, jpmH, hmH, hpmH = gat(jm), gat(jpm), gat(hm), gat(hpm)
    jeH, jpeH, heH, hpeH = gat_r(je), gat_r(jpe), gat_r(he), gat_r(hpe)
    k_b = k[..., None, None]  # [..., 1(B), 1(H)]

    e_sing = jnp.maximum(heH, hpeH)
    sing_m = alpha[..., None] * (hmH * jnp.exp(heH - e_sing)) + beta[
        ..., None
    ] * ((hpmH * jnp.exp(hpeH - e_sing)) * k_b)

    e_reg = jnp.maximum(jeH, jpeH)
    reg_m = alpha[..., None] * (jmH * jnp.exp(jeH - e_reg)) + beta[
        ..., None
    ] * ((jpmH * jnp.exp(jpeH - e_reg)) * k_b)

    kk = k if isinstance(k, C) else C.of(k)
    pref = (kk[..., None] ** (d - 2) * radii ** (d - 1) * 1j)[..., None]
    e_blc = jnp.maximum(jeH, jpeH)
    blc_m = pref * (
        kk[..., None, None] * (jpmH * jnp.exp(jpeH - e_blc))
        - (jmH * jnp.exp(jeH - e_blc)) * eta[..., None, None] * 1j
    )
    # python-complex scalars (1j factors) promote to f64 under an x64
    # session even for f32 inputs; pin everything to the input dtype
    rdt = jnp.result_type(
        radii.dtype, (k.re if isinstance(k, C) else k).dtype, jnp.float32
    )
    return (
        (sing_m.astype(rdt), e_sing.astype(rdt)),
        (reg_m.astype(rdt), e_reg.astype(rdt)),
        (blc_m.astype(rdt), e_blc.astype(rdt)),
    )


def _pair_routing(centers_np, radius_slots=False):
    """Host-side pair routing tables for the matrix-free matvec.

    Deduplicates the b<b' offset vectors and lays the pairs out in flat
    lanes i = o*2P + p: the first P lanes of each offset hold its b<b'
    pairs, the next P their mirrors.  Returns (uniq, gth, sct, p_max)
    where uniq is the [NO, d] distinct-offset table, gth [2*NO*P, 2B]
    routes the stacked [z; z*pm] rows into lanes (invalid lanes all
    zero), and sct [B, 2*NO*P] accumulates lane results into their
    destination balls.  Routing as 0/1 one-hot matmuls instead of
    gather + duplicate-index scatter-add keeps the work in matrix units with
    exact products and no serialization on colliding scatter indices.

    radius_slots=True (the factored matvec, round 5): offsets are
    ordered by |t| and padded so each distinct radius owns exactly
    G_max offset SLOTS (dummy slots route nothing); returns
    (uniq_slots, gth, sct, p_max, uniq_r, g_max) where
    uniq_slots[r * g_max + g] is the slot's offset vector (a unit dummy
    for padding) — the coaxial factor then applies per contiguous
    radius group without any per-offset gather.
    """
    n_balls = centers_np.shape[0]
    bu, bv = np.triu_indices(n_balls, k=1)
    t_np = np.round(centers_np[bu] - centers_np[bv], 12)
    uniq, inv = np.unique(t_np, axis=0, return_inverse=True)
    no = len(uniq)
    # group triu pairs by offset id; pad each group to the max count
    groups = [np.nonzero(inv == o)[0] for o in range(no)]
    if radius_slots:
        r_np = np.round(np.linalg.norm(uniq, axis=1), 10)
        uniq_r, r_inv = np.unique(r_np, return_inverse=True)
        nr = len(uniq_r)
        g_max = int(np.max(np.bincount(r_inv)))
        slot_uniq = np.zeros((nr * g_max, uniq.shape[1]))
        # dummy direction: the radius along the first axis (any finite
        # direction works — dummy slots route zero lanes)
        slot_uniq[:, 0] = np.repeat(uniq_r, g_max)
        slot_groups = [np.zeros((0,), np.int64)] * (nr * g_max)
        fill = np.zeros(nr, np.int64)
        for o in range(no):
            r = r_inv[o]
            s = r * g_max + fill[r]
            fill[r] += 1
            slot_uniq[s] = uniq[o]
            slot_groups[s] = groups[o]
        uniq, groups, no = slot_uniq, slot_groups, nr * g_max
    p_max = max(len(g) for g in groups)
    up_src = np.zeros((no, p_max), np.int32)  # b' (gather z)
    up_dst = np.zeros((no, p_max), np.int32)  # b  (scatter y)
    valid = np.zeros((no, p_max), bool)
    for o, g in enumerate(groups):
        up_src[o, : len(g)] = bv[g]
        up_dst[o, : len(g)] = bu[g]
        valid[o, : len(g)] = True
    dn_src, dn_dst = up_dst, up_src  # mirror pairs swap roles
    src = np.concatenate([up_src, dn_src + n_balls], axis=1).ravel()
    dst_flat = np.concatenate([up_dst, dn_dst], axis=1).ravel()
    valid_flat = np.concatenate([valid, valid], axis=1).ravel()
    n_lanes = 2 * no * p_max
    gth = np.zeros((n_lanes, 2 * n_balls), np.float64)
    gth[np.arange(n_lanes), src] = valid_flat
    sct = np.zeros((n_balls, n_lanes), np.float64)
    sct[dst_flat, np.arange(n_lanes)] = valid_flat
    if radius_slots:
        return uniq, gth, sct, p_max, uniq_r, g_max
    return uniq, gth, sct, p_max


def _matfree_operator(
    c, n_end, centers_np, radii, k, eta, alpha, beta, method, sr_map=None,
    stable=False,
):
    """Matrix-free system operator for concrete geometry: (mv, diag).

    The dense block matrix (see _assemble) is never formed.  Pairs are
    grouped by their deduplicated offset vector; each distinct offset's
    (S|R) acts on all its gathered pair vectors as ONE [P, H] x [H, H]
    matmul, and mirror blocks ride the rank-1 parity
    SR(-t) = pm pm^T .* SR(t), pm_h = (-1)^{n_h}.  Per-matvec HBM
    traffic is NO/B^2 of the dense matrix read (5x less for a 4x4
    lattice), and peak memory drops from B^2 H^2 to NO H^2 — which is
    what lets n_end=32 lattices with B >> 16 fit one chip.

    mv maps C [..., B*H] -> C [..., B*H]; diag is C [..., B*H].

    sr_map: optional hook applied to the per-offset (S|R) tables
    C [..., NO, H, H] after they are built — used by
    parallel.sharded_solve to pin a device sharding over the offset axis
    so each mesh device holds (and matmuls) only its own offsets.

    stable=True uses the scale-compensated factors (mantissa x exponent,
    translation/_scaled.py) so f32 solves stay finite past the
    h_n(k t_min) overflow wall.  The radial exponents e_r[b,h] /
    e_b[b',h'] are separable per pair, so their BALL-MAXIMA fold into
    the [NO, H, H] offset blocks (keeping offset dedup) while each
    ball's deficit exp(e - max_b e) <= 1 rides the cheap per-ball
    row/column factors.  The folded table entry equals the true system
    entry of the maximizing ball pair — physically bounded — so it is
    representable wherever the stable dense assembly is; with uniform
    radii the deficits are all one and this reduces to the exact
    ball-independent folding of _assemble's uniform_r branch.  (Before
    round 4, non-uniform radii silently dropped the compensation.)
    """
    b_ = basis(c, n_end)
    h_num = b_.num
    n_balls = centers_np.shape[0]
    if stable:
        (sing_m, e_s), (reg_m, e_r), (blc_m, e_b) = _radial_rows_scaled(
            c, n_end, radii, k, eta, alpha, beta
        )
        # the diagonal entry is physically bounded; its factors are not
        diag = (sing_m * blc_m) * jnp.exp(e_s + e_b)
        e_r_max = jnp.max(e_r, axis=-2)  # [..., H]
        e_b_max = jnp.max(e_b, axis=-2)
        reg_row = reg_m * jnp.exp(e_r - e_r_max[..., None, :])
        blc_col = blc_m * jnp.exp(e_b - e_b_max[..., None, :])
    else:
        sing_row, reg_row, blc_col = _radial_rows(
            c, n_end, radii, k, eta, alpha, beta
        )
        diag = sing_row * blc_col  # C [..., B, H]

    rdt = blc_col.dtype
    pm_np = (-1.0) ** (b_.n_root.astype(np.int64) % 2)
    # Factored route (round 5): for scale-compensated 'b'-rooted trees,
    # NEVER materialize the per-k [.., NO, H, H] SR tables.  With
    # SR(t) = D(t^) X(|t|) D(t^)^H and the ball-max fold factor F
    # constant on degree TILES while D is degree-block-diagonal,
    # F .* (D X D^H) = D (F .* X) D^H — so the fold rides on the
    # RADIUS-level coax mantissa (NR distinct radii, e.g. 9 for a 4x4
    # lattice) and the matvec applies D^H, folded-X, D in factored form.
    # D is k-INDEPENDENT ([NO, H, H] built once per program, shared by
    # every k in a block), so the k-dependent build shrinks from the
    # full sandwich + per-offset fold (~85 ms/block at the bench
    # config) to the coax group combination alone (~15 ms), and the
    # per-iteration HBM read drops from the [KB, NO, H, H] SR tables to
    # coax [KB, NR, H, H] + the shared D.
    factored = (
        stable
        and sr_map is None
        and c.c_ndim >= 3
        and c.root.kind in ("b", "bp")
    )
    if factored:
        from ..translation._rotation import rotation_matrix
        from ..translation._scaled import coaxial_scaled

        uniq, gth_np, sct_np, p_max, uniq_r, g_max = _pair_routing(
            centers_np, radius_slots=True
        )
        no = len(uniq)  # NR * g_max slots (dummy slots route nothing)
        n_rad = len(uniq_r)
        t_vec = jnp.asarray(uniq)  # [NO, d]
        r_t = jnp.linalg.norm(t_vec, axis=-1)
        t_hat = (t_vec / r_t[..., None]).astype(rdt)
        mant, s_mat = coaxial_scaled(
            c, jnp.asarray(uniq_r), n_end, k[..., None], kind="SR"
        )  # [..., NR, H, H]
        # degree-level fold (all exponents are root-degree-block
        # constant on these trees: radial orders ARE the root degree and
        # s_mat = rade[l + l'] by construction)
        nr_np = np.asarray(b_.n_root)
        starts = jnp.asarray(
            np.concatenate([[0], np.nonzero(nr_np[1:] != nr_np[:-1])[0] + 1]),
            jnp.int32,
        )
        n_l = len(np.unique(nr_np))
        e_r_s = jnp.take(e_r_max, starts, axis=-1)  # [..., L]
        e_b_s = jnp.take(e_b_max, starts, axis=-1)
        s_small = jnp.take(
            jnp.take(s_mat, starts, axis=-2), starts, axis=-1
        )  # [..., NR, L, L]
        e_mem = (
            jax.lax.optimization_barrier(jnp.asarray(nr_np, jnp.int32))[
                :, None
            ]
            == jnp.arange(n_l, dtype=jnp.int32)[None, :]
        ).astype(rdt)  # [H, L]
        factor = jnp.einsum(
            "al,...lm,bm->...ab",
            e_mem,
            jnp.exp(
                e_r_s[..., None, :, None]
                + s_small
                + e_b_s[..., None, None, :]
            ).astype(rdt),
            e_mem,
        )
        xf = mant.astype(rdt) * factor  # folded coax [..., NR, H, H]
        d_rot = rotation_matrix(c, t_hat, n_end).astype(rdt)  # [NO, H, H]
        xf, d_rot, blc_s, reg_s, diag = jax.lax.optimization_barrier(
            (xf, d_rot, blc_col, reg_row, diag)
        )
        sr = None
    else:
        uniq, gth_np, sct_np, p_max = _pair_routing(centers_np)
        no = len(uniq)
        t_cart = jnp.moveaxis(jnp.asarray(uniq), -1, 0)  # [d, NO]
        if stable:
            from ..coords import from_cartesian
            from ..translation._scaled import sr_scaled

            sr_m, sr_e = sr_scaled(
                c, from_cartesian(c, t_cart), n_end, k[..., None],
                kind="SR", t_cart=t_cart, method=method,
            )
            # fold the ball-maximum row/col exponents [..., H] per offset
            sr = sr_m.astype(rdt) * jnp.exp(
                e_r_max[..., None, :, None]
                + sr_e
                + e_b_max[..., None, None, :]
            ).astype(rdt)
        else:
            sr = translation_matrix(
                c, t_cart, n_end, k[..., None], kind="SR", method=method,
            )  # C [..., NO, H, H]
            sr = sr.astype(rdt)
        if sr_map is not None:
            sr = sr_map(sr)
        # Materialization fence: pin the tables before the GMRES loop
        # consumes them so the per-offset (S|R) build (3 batched
        # [NO,H,H] matmuls via the rotation path) cannot be
        # rematerialized per iteration.
        sr, blc_s, reg_s, diag = jax.lax.optimization_barrier(
            (sr, blc_col, reg_row, diag)
        )
    pm = jnp.asarray(pm_np, dtype=rdt)
    n_lanes = 2 * no * p_max
    gth = jnp.asarray(gth_np.astype(rdt))
    sct = jnp.asarray(sct_np.astype(rdt))
    batch = jnp.broadcast_shapes(
        k.shape, eta.shape, radii.shape[:-1], diag.shape[:-2]
    )

    def mv(x_flat):
        x = x_flat.reshape(x_flat.shape[:-1] + (n_balls, h_num))
        z = blc_s * x  # C [..., B, H]
        zs = cplx.concatenate([z, z * pm], axis=-2)  # [..., 2B, H]
        w = cplx.einsum("pq,...qh->...ph", gth, zs)  # [..., 2*NO*P, H]
        w = w.reshape(w.shape[:-2] + (no, 2 * p_max, h_num))
        if sr is not None:
            y = cplx.einsum("...ohg,...opg->...oph", sr, w)
        else:
            # factored SR apply: D^H, folded radius-level coax, D
            w2 = cplx.einsum("ogh,...opg->...oph", d_rot.conj(), w)
            wr = w2.reshape(
                w2.shape[:-3] + (n_rad, g_max * 2 * p_max, h_num)
            )
            v = cplx.einsum("...rhg,...rpg->...rph", xf, wr)
            v = v.reshape(v.shape[:-3] + (no, 2 * p_max, h_num))
            y = cplx.einsum("ohg,...opg->...oph", d_rot, v)
        # mirror half: the row parity factor pm_h
        y_up = y[..., :, :p_max, :]
        y_dn = y[..., :, p_max:, :] * pm
        y_all = cplx.concatenate([y_up, y_dn], axis=-2)
        y_flat = y_all.reshape(y_all.shape[:-3] + (n_lanes, h_num))
        cpl = cplx.einsum("bp,...ph->...bh", sct, y_flat)
        out = diag * x + reg_s * cpl
        out = cplx.broadcast_to(out, batch + (n_balls, h_num))
        return out.reshape(out.shape[:-2] + (n_balls * h_num,))

    diag_flat = cplx.broadcast_to(diag, batch + (n_balls, h_num)).reshape(
        batch + (n_balls * h_num,)
    )
    return mv, diag_flat


def _assemble(
    c, n_end, centers, radii, k, eta, alpha, beta, method, stable=False,
    pair_major=False,
):
    """Dense block matrix C [..., B, H, B', H'] (reference: _biem.py:694-792).

    pair_major=True returns [..., B, B', H, H'] instead — the layout the
    block-gather NATURALLY emits.  The [B, H, B', H'] form fuses a
    transpose into the producer, and XLA then inserts a matrix-sized
    layout-normalizing copy per real half before any consumer dot (three
    live matrix-sized halves at the KB=4 k-blocked bench); the GMRES
    solver contracts the pair-major
    form directly (ops/cplx.py::gmres_solve_pairs) so the matrix lives
    once.

    The (S|R) coupling is computed only for ordered pairs b < b' (the
    mirror block follows from the exact parity relation
    SR(-t)[h',h] = (-1)^{n_h+n_h'} SR(t)[h',h]), in chunks of _PAIR_CHUNK
    pairs to bound the [chunk, Q, H] contraction intermediates; radial
    row/column factors are fused in before the full tensor is formed.

    stable=True uses the scale-compensated path (translation/_scaled.py
    + _radial_rows_scaled): every factor is carried as mantissa x
    exponent and only the physically bounded PRODUCTS are exponentiated,
    so assembly stays finite at any (n_end, k) in float32 — where the
    plain path NaNs out from n_end ~ k t_min + 20 (h_n overflow).
    """
    b_ = basis(c, n_end)
    n_balls = radii.shape[-1]
    h_num = b_.num

    if stable:
        (sing_row, e_sing), (reg_row, e_reg), (blc_col, e_blc) = (
            _radial_rows_scaled(c, n_end, radii, k, eta, alpha, beta)
        )
    else:
        # per-sphere radial tables: C [..., B, H] each
        sing_row, reg_row, blc_col = _radial_rows(
            c, n_end, radii, k, eta, alpha, beta
        )

    batch = jnp.broadcast_shapes(
        centers.shape[:-2], k.shape, eta.shape, sing_row.shape[:-2]
    )
    rdt = blc_col.dtype

    if stable:
        diag_v = (sing_row * blc_col) * jnp.exp(e_sing + e_blc)
    else:
        diag_v = sing_row * blc_col

    def _diag_scatter():
        # diagonal blocks: delta_{hh'} blc_col[b,h'] sing_row[b,h] —
        # written as a per-entry scatter to the (b, h, b, h) positions
        # (an explicit eye_h would embed/fold an O(H^2) constant per
        # compile); used by the single-sphere and tracer-geometry paths
        a = C.zeros(batch + (n_balls, h_num, n_balls, h_num), dtype=rdt)
        b2 = np.arange(n_balls)[:, None]  # [B, 1]
        h2 = np.arange(h_num)[None, :]  # [1, H]
        # contiguous advanced indices broadcast to [B, H] in place
        return a.at_set(
            (Ellipsis, b2, h2, b2, h2),
            cplx.broadcast_to(diag_v, batch + (n_balls, h_num)),
        )

    if n_balls == 1:
        return _diag_scatter()

    # ordered pairs b < b'
    bu, bv = np.triu_indices(n_balls, k=1)

    # Lattice/structured geometries repeat offsets: when centers are
    # concrete (constants at trace time), compute (S|R) only for the
    # distinct offset vectors and gather per pair.  (The offsets are
    # built in numpy: jnp ops on constants inside a trace yield tracers.)
    gather_pairs = None
    c_np = None
    if _is_concrete(centers):
        if centers.ndim == 2:
            c_np = np.asarray(centers)
        else:
            # batched sweeps (leading k axes) usually replicate ONE
            # geometry; collapse to 2-D when every batch slice agrees so
            # the distinct-offset dedup still fires (the off-diagonal
            # blocks then broadcast over the batch downstream).
            c_all = np.asarray(centers).reshape((-1,) + centers.shape[-2:])
            if (c_all == c_all[0]).all():
                c_np = c_all[0]
    if c_np is not None:
        t_np = np.round(c_np[bu] - c_np[bv], 12)
        uniq, inv = np.unique(t_np, axis=0, return_inverse=True)
        if len(uniq) < len(bu):
            t = jnp.asarray(uniq)
            gather_pairs = np.asarray(inv)
        else:
            t = jnp.asarray(t_np)
    else:
        t = centers[..., bu, :] - centers[..., bv, :]  # [..., NP, d]
    t_cart = jnp.moveaxis(t, -1, 0)
    n_pairs = t_cart.shape[-1]

    # chunking bounds the [chunk, Q, H] intermediates of the BANDED scan;
    # the rotation/Graf paths have no such blowup AND their coaxial
    # |t|-dedup only fires on concrete (unchunked) offsets, so give
    # 'b'-rooted/2D trees a much larger chunk.
    pair_chunk = (
        64 if (c.c_ndim == 2 or c.root.kind in ("b", "bp")) else _PAIR_CHUNK
    )

    if stable:
        from ..translation._scaled import sr_scaled

        def tr(t_c):
            from ..coords import from_cartesian

            return sr_scaled(
                c, from_cartesian(c, t_c), n_end, k[..., None],
                kind="SR", t_cart=t_c, method=method,
            )
    else:
        def tr(t_c):
            return translation_matrix(
                c, t_c, n_end, k[..., None], kind="SR", method=method
            )

    if n_pairs <= pair_chunk:
        sr_up = tr(t_cart)  # C [..., NP, H(row), H'(col)] (+ exponents)
    else:
        # chunk the pair axis to bound translation intermediates
        n_chunks = -(-n_pairs // pair_chunk)
        pad = n_chunks * pair_chunk - n_pairs
        t_pad = jnp.concatenate(
            [t_cart, jnp.repeat(t_cart[..., :1], pad, axis=-1)], axis=-1
        )
        t_chunks = jnp.moveaxis(
            t_pad.reshape(t_pad.shape[:-1] + (n_chunks, pair_chunk)), -2, 0
        )  # [n_chunks, d, ..., PC]

        sr_chunks = jax.lax.map(tr, t_chunks)  # C [n_chunks, ..., PC, H, H]

        def unchunk(x, mv):
            x = mv(x, 0, -4)
            return x.reshape(
                x.shape[:-4] + (n_chunks * pair_chunk,) + x.shape[-2:]
            )[..., :n_pairs, :, :]

        if stable:
            sr_up = (
                unchunk(sr_chunks[0], cplx.moveaxis),
                unchunk(sr_chunks[1], jnp.moveaxis),
            )
        else:
            sr_up = unchunk(sr_chunks, cplx.moveaxis)

    if stable:
        sr_up, sr_e = sr_up

    # mirror-block parity (-1)^(n_h + n_h') is rank-1: s_h s_h' with
    # s = (-1)^n — fold it into the row/column factors instead of
    # multiplying by an [H, H] table (whose embedding + constant folding
    # costs O(H^2) compile memory/time)
    sgn = jnp.asarray(1.0 - 2.0 * (b_.n_root % 2), dtype=rdt)

    if c_np is not None:
        # ---- block-gather construction (concrete geometry) ----
        # Emit the [..., B, H, B', H'] matrix in ONE fused pass: a [B, B']
        # pair-id map gathers each off-diagonal block from the
        # unique-offset (S|R) stack, row/column radial factors and the
        # mirror parity are rank-1 scalings fused into the gather
        # consumer, and the diagonal rides an iota mask.  The legacy path
        # below (tracer geometry) materialized per-PAIR [NP, H, H]
        # up/down tensors + exponentials (10x the unique-offset work on a
        # 4x4 lattice) and scattered them block-by-block.
        ids = (
            gather_pairs
            if gather_pairs is not None
            else np.arange(len(bu), dtype=np.int64)
        )
        pid = np.zeros((n_balls, n_balls), np.int32)
        pid[bu, bv] = ids
        pid[bv, bu] = ids
        lower = np.tril(np.ones((n_balls, n_balls), dtype=bool), k=-1)
        offdiag = ~np.eye(n_balls, dtype=bool)

        # row/col factors [..., B, B', H]: mirror (b > b') blocks carry
        # the parity sign on both row and column; the diagonal is zeroed
        # via the row factor and added separately below.
        sgn_or_1 = jnp.where(jnp.asarray(lower)[..., None], sgn, 1.0)
        rowm = (reg_row[..., :, None, :] * sgn_or_1) * jnp.asarray(
            offdiag, dtype=rdt
        )[..., None]
        colm = blc_col[..., None, :, :] * sgn_or_1

        if stable:
            # exponents depend on radii only (not alpha/beta): with
            # uniform radii they are ball-independent and the whole
            # exponential folds at the UNIQUE-OFFSET level — [NO, H, H]
            # exps instead of [B, B', H, H].
            uniform_r = _is_concrete(radii) and bool(
                (np.asarray(radii) == np.asarray(radii)[..., :1]).all()
            )
            if uniform_r:
                e_r0 = e_reg[..., 0, :]  # [..., H]
                e_b0 = e_blc[..., 0, :]
                folded = sr_up * jnp.exp(
                    e_r0[..., None, :, None] + sr_e + e_b0[..., None, None, :]
                )
                a_off = (
                    (rowm[..., None] * cplx.take(folded, pid, axis=-3))
                    * colm[..., None, :]
                )
            else:
                ex = jnp.exp(
                    e_reg[..., :, None, :, None]
                    + jnp.take(sr_e, pid, axis=-3)
                    + e_blc[..., None, :, None, :]
                )
                a_off = (
                    (rowm[..., None] * cplx.take(sr_up, pid, axis=-3))
                    * colm[..., None, :]
                ) * ex
        else:
            a_off = (
                (rowm[..., None] * cplx.take(sr_up, pid, axis=-3))
                * colm[..., None, :]
            )

        # [..., B, B', H, H'] (+ optional -> [..., B, H, B', H']) +
        # diagonal via barriered iota masks (literal [H, H] eye constants
        # would be folded/embedded at compile time)
        a_off = cplx.broadcast_to(
            a_off, batch + (n_balls, n_balls, h_num, h_num)
        )
        ib = jax.lax.optimization_barrier(jnp.arange(n_balls, dtype=jnp.int32))
        ih = jax.lax.optimization_barrier(jnp.arange(h_num, dtype=jnp.int32))
        if pair_major:
            mask = (ib[:, None, None, None] == ib[None, :, None, None]) & (
                ih[None, None, :, None] == ih[None, None, None, :]
            )
            dv = diag_v[..., :, None, :, None]
            return a_off + cplx.where(
                mask, cplx.broadcast_to(dv, a_off.shape), C.of(0.0)
            )
        a_t = cplx.moveaxis(a_off, -2, -3)
        mask = (ib[:, None, None, None] == ib[None, None, :, None]) & (
            ih[None, :, None, None] == ih[None, None, None, :]
        )
        dv = diag_v[..., :, :, None, None]
        return a_t + cplx.where(mask, cplx.broadcast_to(dv, a_t.shape), C.of(0.0))

    a = _diag_scatter()
    if gather_pairs is not None:
        sr_up = sr_up[..., gather_pairs, :, :]
        if stable:
            sr_e = sr_e[..., gather_pairs, :, :]

    # A[b, h, b', h'] = blc_col[b', h'] * SR(c_b - c_b')[h, h'] * reg_row[b, h]
    if stable:
        # fold all exponents before exponentiating: the triple product is
        # the physically bounded system entry, its factors are not
        ex_up = jnp.exp(
            e_reg[..., bu, :, None] + sr_e + e_blc[..., bv, None, :]
        )
        ex_dn = jnp.exp(
            e_reg[..., bv, :, None] + sr_e + e_blc[..., bu, None, :]
        )
        up = (reg_row[..., bu, :, None] * sr_up * blc_col[..., bv, None, :]) * ex_up
        down = (
            (reg_row[..., bv, :, None] * sgn[:, None])
            * sr_up
            * (blc_col[..., bu, None, :] * sgn[None, :])
        ) * ex_dn
    else:
        up = reg_row[..., bu, :, None] * sr_up * blc_col[..., bv, None, :]
        down = (
            (reg_row[..., bv, :, None] * sgn[:, None])
            * sr_up
            * (blc_col[..., bu, None, :] * sgn[None, :])
        )
    up = cplx.broadcast_to(up, batch + up.shape[-3:])
    down = cplx.broadcast_to(down, batch + down.shape[-3:])
    a = a.at_set(
        (Ellipsis, bu, slice(None), bv, slice(None)), cplx.moveaxis(up, -3, 0)
    )
    a = a.at_set(
        (Ellipsis, bv, slice(None), bu, slice(None)), cplx.moveaxis(down, -3, 0)
    )
    if pair_major:
        return cplx.moveaxis(a, -3, -2)  # legacy path: correctness only
    return a  # C [..., B, H, B', H']


def biem(
    c,
    /,
    *,
    centers,
    radii,
    k,
    n_end,
    alpha=1.0,
    beta=0.0,
    uin=None,
    uin_grad=None,
    eta=None,
    kind: Literal["inner", "outer"] = "outer",
    force_matrix=False,
    translational_coefficients_method=None,
    solver="auto",
    stable=None,
    density0=None,
):
    """Solve the Helmholtz BIEM for non-overlapping hyperspheres.

    API parity with the reference `biem()` (_biem.py:453-581): same
    parameter names, shapes ([..., B, d] centers, [..., B] radii, [...] k,
    [...(,B)] alpha/beta, [...] eta) and result object.  Complex values
    (alpha/beta/k inputs, density/matrix outputs, uscat results) are
    real-pair C (ops/cplx.py); use .to_numpy() for numpy complex.  Fully
    jittable for fixed (c, n_end, B); leading batch axes broadcast.

    solver: "direct" (batched LU via the real block embedding),
    "gmres" (Jacobi-preconditioned Krylov on the assembled matrix — the
    second-kind structure of the combined-field system makes this
    converge in tens of matvecs; the auto policy takes it beyond the
    platform's LU limit, policy_limits), "matfree" (GMRES whose matvec
    routes per-offset (S|R) blocks with one-hot matmuls — the B^2 H^2
    matrix is never formed AND each Krylov step reads only NO/B^2 of
    the dense matrix's bytes: MEASURED 0.067 s vs dense-GMRES 0.125 s
    full asm+rhs+solve at the B=16 n_end=32 bench config, and the only
    way B >> 64 fits one chip; lattices of >= 64 spheres use the FFT
    block-convolution form), or "auto" (direct up to B*H = 6144;
    generic matfree for dedup-rich 8 <= B < 64 geometries; lattice-FFT
    matfree from B = 64; dense-GMRES while the matrix fits ~6 GB, then
    matfree regardless).

    density0: optional warm-start density [..., B, H] for the iterative
    solvers (extension over the reference API).  In a k-sweep the
    previous k-point's density cuts GMRES iterations several-fold; the
    result still satisfies the solver tolerance measured against the
    CURRENT right-hand side (ops/cplx.py::_gmres_cgs2).  Ignored by the
    direct (LU) and single-sphere paths.

    stable: scale-compensated assembly (mantissa x exponent radial and
    translation factors; translation/_scaled.py).  Keeps the matrix
    finite at ANY (n_end, k) — the plain float32 path NaNs out from
    n_end ~ k t_min + 20 where h_n overflows, and even float64 dies at
    the reference's extreme sweep corners.  None (default) enables it
    automatically in float32; True forces it (float64 too); False
    disables.  The scaled path uses its own exact translation
    algorithms (Graf / rotation + coaxial) regardless of
    translational_coefficients_method.  ALL solver routes honor it:
    dense assembly folds per-pair exponents, and both matrix-free
    operators (unique-offset and lattice-FFT) fold the ball-maximum
    row/column exponents into their per-offset tables with the per-ball
    deficits riding the row/column factors (exact for uniform radii,
    finite-by-construction for non-uniform).

    The reference README example (README.md:116-125 there; golden value
    pinned by its doctest harness) — two sound-soft unit spheres at
    (0, +-2, 0), k=1, plane wave along x0:

    >>> import numpy as np
    >>> from biem_helmholtz_sphere_tpu import biem, plane_wave
    >>> from biem_helmholtz_sphere_tpu.coords import (
    ...     create_from_branching_types)
    >>> c = create_from_branching_types("ba")
    >>> uin, _ = plane_wave(k=np.asarray(1.0),
    ...                     direction=np.asarray([1.0, 0.0, 0.0]))
    >>> calc = biem(c, centers=np.array([[0., 2., 0.], [0., -2., 0.]]),
    ...             radii=np.ones(2), k=np.asarray(1.0), n_end=6, uin=uin)
    >>> u0 = complex(calc.uscat(np.zeros((3, 1))).to_numpy().ravel()[0])
    >>> print(f"{u0:.5f}")
    -0.74133-0.66966j
    """
    if solver not in ("auto", "direct", "gmres", "matfree"):
        raise ValueError(f"unknown solver {solver!r}")
    centers, radii, k, eta, alpha, beta = _check_biem_inputs(
        c, centers, radii, k, eta, alpha, beta
    )
    ndim_first = k.ndim
    n_balls = radii.shape[-1]

    # every tree is scale-compensable since round 3: 2D Graf gather,
    # 'b'-rooted rotation+coaxial, and the exponent-compensated general
    # band scan for everything else (translation/_scaled.py)
    if stable is None:
        rdt = jnp.result_type(
            radii.dtype, (k.re if isinstance(k, C) else k).dtype, jnp.float32
        )
        stable = jnp.finfo(rdt).bits == 32

    if uin is None and uin_grad is None:
        f_exp = None
    else:
        if (
            _is_concrete(alpha)
            and not bool(np.all(alpha.to_numpy() == 0))
            and uin is None
        ):
            raise ValueError(
                "alpha is not zero, but uin is None. uin must be provided to "
                "compute the boundary condition."
            )
        if (
            _is_concrete(beta)
            and not bool(np.all(beta.to_numpy() == 0))
            and uin_grad is None
        ):
            raise ValueError(
                "beta is not zero, but uin_grad is None. uin_grad must be "
                "provided to compute the boundary condition."
            )
        f_exp = _rhs_dispatch(
            c, n_end, centers, radii, alpha, beta, uin, uin_grad, ndim_first
        )

    use_matrix = f_exp is None or n_balls > 1 or force_matrix
    relres = iters = None  # set by the iterative (GMRES) routes only

    if not use_matrix:
        # single sphere: the system is diagonal (reference: _biem.py:643-691)
        if stable:
            (sing_m, e_s), _, (blc_m, e_b) = _radial_rows_scaled(
                c, n_end, radii, k, eta, alpha, beta
            )
            density = f_exp / ((sing_m * blc_m) * jnp.exp(e_s + e_b))
        else:
            d = c.c_ndim
            b_ = basis(c, n_end)
            n_idx = jnp.asarray(b_.n_root)
            _, _, h, hp = spherical_jh_all(d, n_end, _k_mul(k[..., None], radii))
            hH = cplx.take(h, n_idx, axis=-1)
            hpH = cplx.take(hp, n_idx, axis=-1)
            sing = alpha[..., None] * hH + beta[..., None] * (
                hpH * k[..., None, None]
            )
            sd = blc(c, n_end, k[..., None], radii, eta[..., None]) * sing
            density = f_exp / sd
        matrix = None
    else:
        h_num = basis(c, n_end).num
        n_sys = n_balls * h_num
        # auto policy, platform-aware.  On the CPU, LU is preferred much
        # longer: it is exact where restarted GMRES at f64 tolerances can
        # stagnate (the 256-sphere lattice row: LU matches the reference
        # to 10 digits where GMRES(64) returned 1e-4 error), and a
        # 12k-row f64 LU is minutes on a host core.  Matrix-free GMRES
        # for dedup-rich mid-size geometries (each Krylov step reads
        # NO/B^2 of the dense matrix's bytes) and beyond the dense
        # memory limit; dense-matrix GMRES for the dedup-poor middle
        # ground.
        lu_limit, dense_limit = policy_limits(jax.default_backend())
        rdtb = jnp.result_type(
            radii.dtype, (k.re if isinstance(k, C) else k).dtype, jnp.float32
        )
        dense_bytes = (2 * jnp.finfo(rdtb).bits // 8) * n_sys * n_sys
        use_matfree = solver == "matfree" or (
            solver == "auto" and dense_bytes > dense_limit
        )
        # the matfree matvec additionally needs concrete single-instance
        # geometry and an rhs (nothing forcing the dense matrix to
        # exist).  Geometry broadcast over leading batch axes (k-blocked
        # sweeps broadcast centers to [KB, B, d] for the batch-rank
        # rule) collapses back to the shared [B, d] instance.
        c2_np = None
        if _is_concrete(centers):
            c2_np = np.asarray(centers)
            if c2_np.ndim > 2:
                flat = c2_np.reshape((-1,) + c2_np.shape[-2:])
                c2_np = flat[0] if bool((flat == flat[:1]).all()) else None
        matfree_ok = (
            f_exp is not None
            and not force_matrix
            and n_balls > 1
            and c2_np is not None
        )
        # lattice geometries (the reference CLI's n_balls sweeps) get
        # the FFT block-convolution matvec: nothing of size B^2 is ever
        # formed, so 1024-4096-sphere lattices fit one chip.  For B >=
        # 64 the O(B log B) matvec + O(B) kernel build also beat dense
        # assembly outright, so auto prefers it well before dense_limit.
        op = None
        if matfree_ok and n_balls >= 64 and (use_matfree or solver == "auto"):
            # below 64 balls the generic unique-offset matvec beat the
            # FFT form at the 16-ball bench config on the first
            # accelerator (not re-measured on the H100), so the lattice
            # kernel only takes over at scale
            from ._lattice import lattice_operator

            op = lattice_operator(
                c,
                n_end,
                c2_np,
                radii,
                k,
                eta,
                alpha,
                beta,
                translational_coefficients_method,
                stable=stable,
            )
        if (
            op is None
            and matfree_ok
            and not use_matfree
            and solver == "auto"
            and 8 <= n_balls < 64
            and n_sys > lu_limit
        ):
            # dedup-rich mid-size geometry BEYOND the direct-LU tier: the
            # unique-offset matvec reads NO/B^2 of the dense matrix per
            # Krylov step and skips the B^2 H^2 matrix write entirely.
            # Systems within lu_limit keep the exact direct solve (and
            # expose calc.matrix), per the documented accuracy
            # preference.
            t_np = np.round(
                c2_np[np.triu_indices(n_balls, k=1)[0]]
                - c2_np[np.triu_indices(n_balls, k=1)[1]],
                12,
            )
            n_uniq = len(np.unique(t_np, axis=0))
            n_pairs = n_balls * (n_balls - 1) // 2
            if n_uniq * 2 <= n_pairs:
                use_matfree = True
        matfree = matfree_ok and (use_matfree or op is not None)
        use_gmres = (
            matfree
            or use_matfree
            or solver == "gmres"
            or (solver == "auto" and n_sys > lu_limit)
        )
        if matfree:
            if op is not None:
                mv, diag, pre = op
            else:
                mv, diag = _matfree_operator(
                    c,
                    n_end,
                    c2_np,
                    radii,
                    k,
                    eta,
                    alpha,
                    beta,
                    translational_coefficients_method,
                    stable=stable,
                )
                pre = None
            batch = diag.shape[:-1]
            f2 = cplx.broadcast_to(f_exp, batch + f_exp.shape[-2:]).reshape(
                batch + (n_sys,)
            )
            x0 = (
                None
                if density0 is None
                else cplx.broadcast_to(
                    C.of(density0), batch + (n_balls, h_num)
                ).reshape(batch + (n_sys,))
            )
            density, relres, iters = cplx.gmres_solve_op(
                mv, diag, f2, x0=x0, with_info=True, precond=pre
            )
            density = density.reshape(batch + (n_balls, h_num))
            matrix = None
        else:
            matrix_p = _assemble(
                c,
                n_end,
                centers,
                radii,
                k,
                eta,
                alpha,
                beta,
                translational_coefficients_method,
                stable=stable,
                pair_major=True,
            )
            # the exposed matrix keeps the reference's [B, H, B', H']
            # convention; under jit it is DCE'd whenever the caller never
            # reads calc.matrix (the solver below consumes the pair-major
            # form directly — the reorder costs two matrix-sized layout
            # copies per half)
            matrix = cplx.moveaxis(matrix_p, -2, -3)
            if f_exp is None:
                density = None
            else:
                batch = jnp.broadcast_shapes(
                    matrix_p.shape[:-4], f_exp.shape[:-2]
                )
                f2 = cplx.broadcast_to(f_exp, batch + f_exp.shape[-2:]).reshape(
                    batch + (n_sys,)
                )
                if use_gmres:
                    m5 = cplx.broadcast_to(matrix_p, batch + matrix_p.shape[-4:])
                    x0 = (
                        None
                        if density0 is None
                        else cplx.broadcast_to(
                            C.of(density0), batch + (n_balls, h_num)
                        ).reshape(batch + (n_sys,))
                    )
                    density, relres, iters = cplx.gmres_solve_pairs(
                        m5, f2, x0=x0, with_info=True
                    )
                    density = density.reshape(batch + (n_balls, h_num))
                else:
                    m2 = cplx.broadcast_to(
                        matrix, batch + matrix.shape[-4:]
                    ).reshape(batch + (n_sys, n_sys))
                    density = cplx.solve(m2, f2).reshape(batch + (n_balls, h_num))

    if uin is None:
        uin_wrapped = None
    else:

        def uin_wrapped(x, /, *, expand_x=True):
            if expand_x:
                x = jnp.asarray(x)[(...,) + (None,) * ndim_first]
            return uin(x)

    return BIEMResultCalculator(
        c=c,
        centers=centers,
        radii=radii,
        k=k,
        eta=eta,
        density=density,
        matrix=matrix,
        uin=uin_wrapped,
        n_end=n_end,
        kind=kind,
        relres=relres,
        iters=iters,
    )
