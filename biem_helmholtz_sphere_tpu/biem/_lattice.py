r"""Lattice-structured matrix-free operator: block convolution via FFT.

The reference CLI's ``accuracy --mode n_balls`` geometry (reference
cli.py:170-185,214) is a uniform square lattice of spheres.  On such a
lattice the inter-sphere coupling of the BIEM system (reference
_biem.py:694-792) is TRANSLATION INVARIANT: the off-diagonal block for
the pair (b, b') depends only on the cell offset n - m,

    coupling[n] = sum_{m != n} SR((n - m) * s) (blc * x)[m],

i.e. a 2D block convolution of the per-cell density with the kernel
K[di, dj] = SR((di sx, dj sy)).  The accelerator-friendly evaluation is the
convolution theorem: pad the L x L cell grid to 2L x 2L, FFT the H-vector
field over the cell axes, multiply by the kernel's FFT per frequency
([H, H] @ [H]), inverse FFT.  Per-matvec cost drops from
O(B^2 H^2) reads (dense) / O(NO P H^2) (generic matfree lanes) to
O(F H^2) with F = 4 B frequency cells — and, critically, NOTHING of size
B^2 is ever formed, so lattices of 1024-4096 spheres (the reference
CLI's full sweep range, beyond its committed 256-ball artifacts) solve
on one chip.

Kernel build cost is one batched translation_matrix call over the
(2Lx-1)(2Ly-1)-1 distinct offsets — halved by the exact parity mirror
SR(-t) = pm pm^T .* SR(t), pm_h = (-1)^{n_h} (same identity the generic
matfree path uses).  FFTs run in native complex (XLA FFT); the
per-frequency matvec stays in the real-pair representation using the
one-pass stacked-RHS trick of ops.cplx.matvec.
"""

import jax
import jax.numpy as jnp
import numpy as np

from ..harmonics._index import basis
from ..ops import cplx
from ..ops.cplx import C
from ..translation import translation_matrix
from ._core import _radial_rows, _radial_rows_scaled


def lattice_routing(centers_np):
    """Detect a uniform (1- or 2-axis) lattice in concrete centers.

    Returns None, or (axes, spacings, shape, cell2ball, ball2cell) with
    ``centers[cell2ball[i*Ly+j]]`` the sphere at integer cell (i, j).
    """
    centers_np = np.asarray(centers_np)
    if centers_np.ndim != 2:
        return None
    n_balls, d = centers_np.shape
    if n_balls < 4:
        return None  # generic routing is already optimal for tiny systems
    spans = centers_np.max(axis=0) - centers_np.min(axis=0)
    scale = max(1.0, float(np.abs(centers_np).max()))
    tol = 1e-9 * scale
    axes = [a for a in range(d) if spans[a] > tol]
    if not 1 <= len(axes) <= 2:
        return None
    idx = []
    shape = []
    spacings = []
    for a in axes:
        vals = centers_np[:, a]
        v = np.unique(np.round(vals / tol) * tol)
        st = np.diff(v)
        if not np.all(np.abs(st - st[0]) <= 1e-6 * abs(st[0])):
            return None
        # exact spacing from the full span (averages out the tol
        # quantization of v, which would otherwise shift the kernel
        # offsets by ~1e-9 relative vs the dense path's exact
        # center differences)
        s_a = (vals.max() - vals.min()) / (len(v) - 1)
        v0 = vals.min()
        ii = np.round((vals - v0) / s_a)
        if not np.all(np.abs(vals - (v0 + ii * s_a)) <= 1e3 * tol):
            return None
        idx.append(ii.astype(np.int64))
        shape.append(len(v))
        spacings.append(float(s_a))
    if len(axes) == 1:  # embed a line as an L x 1 grid
        idx.append(np.zeros(n_balls, np.int64))
        shape.append(1)
        spacings.append(1.0)
        axes = [axes[0], axes[0]]
    if n_balls != shape[0] * shape[1]:
        return None
    flat = idx[0] * shape[1] + idx[1]  # ball -> cell
    if len(np.unique(flat)) != n_balls:
        return None
    cell2ball = np.empty(n_balls, np.int64)
    cell2ball[flat] = np.arange(n_balls)
    return axes, spacings, tuple(shape), cell2ball, flat


def _build_kernel_fft(
    c, n_end, routing, k, method, rdt, row_col_exps=None, part=None
):
    """FFT of the block-convolution kernel: C [..., Fx, Fy, H, H].

    row_col_exps=(e_r0, e_b0) ([..., H] each) switches to the
    scale-compensated build: mantissa (S|R) blocks from sr_scaled with
    the ball-independent row/column radial exponents folded in, so the
    kernel is finite in f32 past the h_n(k t_min) overflow wall (same
    folding as _core._matfree_operator / stable dense assembly).

    part: optional dict of sharding-constraint hooks (multi-chip;
    parallel.sharded_solve lattice=True): 'off' pins the per-offset
    (S|R) table's offset axis, 'fx'/'fy' pin the frequency-grid axes.
    The table and the kernel are the SAME order of bytes (4L^2 offsets
    vs 4L^2 frequencies), so per-device memory only drops if the BUILD
    is partitioned too; the FFT then runs as a pencil decomposition
    (fft over Fy while sharded on Fx, reshard, fft over Fx while
    sharded on Fy) with one table-sized all-to-all each — one-time
    build cost, not per iteration.
    """
    axes, (sx, sy), (lx, ly), _, _ = routing
    d = c.c_ndim
    b_ = basis(c, n_end)
    fx, fy = 2 * lx, 2 * ly
    # half the nonzero offsets (lexicographically positive); the mirror
    # half follows from parity.
    dis, djs = np.meshgrid(
        np.arange(-(lx - 1), lx), np.arange(-(ly - 1), ly), indexing="ij"
    )
    dis, djs = dis.ravel(), djs.ravel()
    pos_half = (dis > 0) | ((dis == 0) & (djs > 0))
    dis_h, djs_h = dis[pos_half], djs[pos_half]
    noh = len(dis_h)
    t = np.zeros((d, noh))
    t[axes[0]] += dis_h * sx
    t[axes[1]] += djs_h * sy
    # t stays host numpy: concrete at trace time, so the coaxial build
    # dedups equal |t|
    if row_col_exps is not None:
        from ..coords import from_cartesian
        from ..translation._scaled import sr_scaled

        e_r0, e_b0 = row_col_exps
        sr_m, sr_e = sr_scaled(
            c, from_cartesian(c, t), n_end, k[..., None],
            kind="SR", t_cart=t, method=method,
        )
        sr_half = (
            sr_m * jnp.exp(
                e_r0[..., None, :, None] + sr_e + e_b0[..., None, None, :]
            )
        ).astype(rdt)  # C [..., NOh, H, H], compensation folded
    else:
        sr_half = translation_matrix(
            c, t, n_end, k[..., None], kind="SR", method=method
        ).astype(rdt)  # C [..., NOh, H, H]
    if part is not None:
        sr_half = part["off"](sr_half)
    pm = jnp.asarray(
        (-1.0) ** (b_.n_root.astype(np.int64) % 2), dtype=rdt
    )
    sr_mirror = sr_half * (pm[:, None] * pm[None, :])
    # route each padded-grid cell to its offset slot (zero slot = 2*noh
    # covers the excluded (0,0) self-offset and the padding gap cells)
    gmap = np.full(fx * fy, 2 * noh, np.int64)
    cell_h = (dis_h % fx) * fy + (djs_h % fy)
    cell_m = ((-dis_h) % fx) * fy + ((-djs_h) % fy)
    gmap[cell_h] = np.arange(noh)
    gmap[cell_m] = noh + np.arange(noh)
    h_num = b_.num
    zero = C.zeros(sr_half.shape[:-3] + (1, h_num, h_num), dtype=rdt)
    cat = cplx.concatenate([sr_half, sr_mirror, zero], axis=-3)
    kc = cplx.take(cat, jnp.asarray(gmap), axis=-3)  # [..., Fx*Fy, H, H]
    kc = kc.reshape(kc.shape[:-3] + (fx, fy, h_num, h_num))
    if part is None:
        khat = jnp.fft.fftn(jax.lax.complex(kc.re, kc.im), axes=(-4, -3))
        return C(khat.real, khat.imag)
    # Sharded build: explicit DFT matmuls with pencil resharding —
    # einsum + sharding constraints only (XLA's SPMD partitioner
    # hard-aborts on FFT ops with sharded operands, observed on the CPU
    # backend round 4).  Each stage contracts a LOCALLY-unsharded cell
    # axis; the two all-to-alls move table-sized data once at build.
    def dft(npts):
        jk = np.arange(npts)
        w = np.exp(-2j * np.pi * np.outer(jk, jk) / npts)
        return C(jnp.asarray(w.real, rdt), jnp.asarray(w.imag, rdt))

    kc = part["fx"](kc)  # sharded on the Fx cell axis
    k1 = cplx.einsum("yb,...abhg->...ayhg", dft(fy), kc)  # local (b axis)
    k1 = part["fy"](k1)  # all-to-all: now sharded on the Fy axis
    khat = cplx.einsum("xa,...ayhg->...xyhg", dft(fx), k1)  # local (a axis)
    return part["fy"](khat)


def lattice_operator(
    c, n_end, centers_np, radii, k, eta, alpha, beta, method, stable=False,
    part=None,
):
    """(mv, diag, pre) for a lattice geometry, or None if not a lattice.

    mv maps C [..., B*H] -> C [..., B*H] applying the full system
    matrix (same contract as _core._matfree_operator); diag is its
    diagonal.
    stable=True builds the convolution kernel scale-compensated with the
    ball-maximum row/column exponents folded in (per-ball deficits ride
    the row/column factors — same folding as _core._matfree_operator,
    exact for uniform radii) — see _build_kernel_fft.
    part: optional sharding-hook dict (see _build_kernel_fft) — the
    multi-chip path (parallel.sharded_solve lattice=True) partitions
    the per-offset table build, the kernel FFT (pencil decomposition),
    and the stored kernel over the mesh; the per-frequency matvec
    contraction then runs on local kernel shards with only the small
    [.., Fx, Fy, H] vector field crossing devices.
    pre is always None today: a block-circulant (Strang) preconditioner
    was built and MEASURED COUNTERPRODUCTIVE in round 4 — 2D lattice,
    k=1, f64 tol 1e-13: 64 balls 150 vs 136 Jacobi iterations, 256
    balls 2459 vs 454 — because the Hankel kernel decays too slowly
    (~r^-1/2) for circulant aliasing to be benign: wrapped offsets add
    neighbor-strength spurious couplings (per-frequency symbols were
    measured well-conditioned, smin >= 0.13, so it is approximation
    error, not resonance; tools/precond_probe.py).
    What DOES work at scale is long-basis (non-restarted) GMRES +
    warm-start continuation (tools/nballs_family4.py).  The precond
    hook (ops.cplx.gmres_solve_op) stays for future preconditioners.
    """
    routing = lattice_routing(centers_np)
    if routing is None:
        return None
    _, _, (lx, ly), cell2ball, ball2cell = routing
    fx, fy = 2 * lx, 2 * ly
    b_ = basis(c, n_end)
    h_num = b_.num
    n_balls = centers_np.shape[0]
    if stable:
        (sing_m, e_s), (reg_m, e_r), (blc_m, e_b) = _radial_rows_scaled(
            c, n_end, radii, k, eta, alpha, beta
        )
        diag = (sing_m * blc_m) * jnp.exp(e_s + e_b)
        e_r_max = jnp.max(e_r, axis=-2)  # [..., H]
        e_b_max = jnp.max(e_b, axis=-2)
        reg_row = reg_m * jnp.exp(e_r - e_r_max[..., None, :])
        blc_col = blc_m * jnp.exp(e_b - e_b_max[..., None, :])
        row_col_exps = (e_r_max, e_b_max)
    else:
        sing_row, reg_row, blc_col = _radial_rows(
            c, n_end, radii, k, eta, alpha, beta
        )
        diag = sing_row * blc_col  # C [..., B, H]
        row_col_exps = None
    rdt = blc_col.dtype
    khat = _build_kernel_fft(
        c, n_end, routing, k, method, rdt, row_col_exps=row_col_exps,
        part=part,
    )
    khat, blc_s, reg_s, diag = jax.lax.optimization_barrier(
        (khat, blc_col, reg_row, diag)
    )
    c2b = jnp.asarray(cell2ball)
    b2c = jnp.asarray(ball2cell)
    batch = jnp.broadcast_shapes(
        k.shape, eta.shape, radii.shape[:-1], diag.shape[:-2]
    )

    def mv(x_flat):
        x = x_flat.reshape(x_flat.shape[:-1] + (n_balls, h_num))
        z = blc_s * x  # C [..., B, H]
        zl = cplx.take(z, c2b, axis=-2)  # cell-ordered [..., Lx*Ly, H]
        zl = zl.reshape(zl.shape[:-2] + (lx, ly, h_num))
        pad = [(0, 0)] * (zl.ndim - 3) + [(0, fx - lx), (0, fy - ly), (0, 0)]
        zp = C(jnp.pad(zl.re, pad), jnp.pad(zl.im, pad))
        zhat = jnp.fft.fftn(jax.lax.complex(zp.re, zp.im), axes=(-3, -2))
        if part is not None:
            # pin the forward-transformed vector field replicated so the
            # kernel's frequency sharding cannot propagate BACKWARD into
            # the fftn (the SPMD FFT handler check-fails on sharded
            # operands); the einsum below then partitions by khat alone
            zhat = part["repl"](zhat)
        # per-frequency [H, H] @ [H] with one streaming pass over each
        # real half of khat (stacked-RHS trick, see ops.cplx.matvec)
        zs = jnp.stack(
            jnp.broadcast_arrays(zhat.real, zhat.imag), axis=-1
        )  # [..., Fx, Fy, H, 2]
        p = jnp.einsum("...hg,...gc->...hc", khat.re, zs)
        q = jnp.einsum("...hg,...gc->...hc", khat.im, zs)
        yhat = jax.lax.complex(p[..., 0] - q[..., 1], p[..., 1] + q[..., 0])
        if part is not None:
            # multi-chip: yhat inherits the kernel's frequency sharding;
            # gather the SMALL [.., Fx, Fy, H] vector field back to
            # replicated before the cell-axis inverse FFT (the SPMD
            # partitioner cannot handle FFTs over sharded operands)
            yhat = part["repl"](yhat)
        y = jnp.fft.ifftn(yhat, axes=(-3, -2))[..., :lx, :ly, :]
        yl = C(y.real.astype(rdt), y.imag.astype(rdt))
        yl = yl.reshape(yl.shape[:-3] + (lx * ly, h_num))
        cpl = cplx.take(yl, b2c, axis=-2)  # back to ball order [..., B, H]
        out = diag * x + reg_s * cpl
        out = cplx.broadcast_to(out, batch + (n_balls, h_num))
        return out.reshape(out.shape[:-2] + (n_balls * h_num,))

    diag_flat = cplx.broadcast_to(diag, batch + (n_balls, h_num)).reshape(
        batch + (n_balls * h_num,)
    )

    return mv, diag_flat, None
