"""Multi-device parallelism for sweeps and field evaluation.

The reference has no distributed runtime (SURVEY.md section 2.5): its
scaling axes are leading batch dims (k sweeps, BC grids, geometry
ensembles) and HPC array jobs.  The JAX equivalents here:

  *  `make_mesh`     — a jax.sharding.Mesh over the available devices
  *  `sharded_sweep` — solve a k-sweep with the sweep axis sharded over
     the mesh (data-parallel; no collectives needed beyond the result
     gather)
  *  `sharded_uscat` — evaluate the scattered field with the POINTS axis
     sharded and the solved density replicated (the sequence-parallel
     analogue for large near-field grids)
  *  `sharded_solve` — ONE large BIEM system with the dense [B·H, B·H]
     matrix row-sharded across the mesh: assembly, the GMRES matvecs,
     and the Krylov inner products are all partitioned by XLA (matvec
     partials stay on-shard; the reductions are all-reduces).  This is
     the scaling path for n_end/B beyond one device's memory (SURVEY.md
     sections 2.5 and 5 "long-context" analogue).

Shardings are expressed with NamedSharding + jit; XLA inserts any
required collectives (NCCL on GPUs).  The mesh follows the algorithm
alone: a flat axis over the devices, which on one host are joined all
to all by NVLink.
"""

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..biem import biem, plane_wave

__all__ = ["make_mesh", "sharded_solve", "sharded_sweep", "sharded_uscat"]


def make_mesh(n_devices=None, axis_names=("sweep",), shape=None):
    """A mesh over the first n_devices devices.

    shape: optional tuple matching axis_names (default: all devices on
    the first axis).
    """
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    if shape is None:
        shape = (len(devs),) + (1,) * (len(axis_names) - 1)
    arr = np.array(devs).reshape(shape)
    return Mesh(arr, axis_names)


def sharded_sweep(
    c,
    *,
    centers,
    radii,
    ks,
    n_end,
    direction,
    alpha=1.0,
    beta=0.0,
    eta=None,
    x=None,
    mesh=None,
    axis_name="sweep",
):
    """Solve the BIEM for every k in `ks` with the sweep axis sharded.

    centers [B, d], radii [B] (shared geometry); ks [NK]; direction [d].
    Returns uscat at x (default: the origin) of shape [NK].  NK must be
    divisible by the mesh axis size.  The geometry is closed over as
    host numpy, so biem() sees it concrete and keeps its trace-time
    routes (offset dedup, the matrix-free solvers) on every device.
    """
    if mesh is None:
        mesh = make_mesh(axis_names=(axis_name,))
    d = c.c_ndim
    nk = ks.shape[0]
    b = np.shape(radii)[-1]
    centers_b = np.broadcast_to(np.asarray(centers), (nk, b, d))
    radii_b = np.broadcast_to(np.asarray(radii), (nk, b))
    dir_b = jnp.broadcast_to(jnp.asarray(direction)[:, None], (d, nk))
    eta_b = jnp.ones((nk,)) if eta is None else jnp.broadcast_to(jnp.asarray(eta), (nk,))
    if x is None:
        # numpy (not device) constant: `x` is captured by step's closure
        x = np.zeros((d, 1))

    spec_k = NamedSharding(mesh, P(axis_name))
    spec_dk = NamedSharding(mesh, P(None, axis_name))

    def step(ks_, eta_, dir_):
        uin, uin_grad = plane_wave(k=ks_, direction=dir_)
        calc = biem(
            c,
            centers=centers_b,
            radii=radii_b,
            k=ks_,
            n_end=n_end,
            alpha=alpha,
            beta=beta,
            uin=uin,
            uin_grad=uin_grad if np.any(np.asarray(beta) != 0) else None,
            eta=eta_,
        )
        return calc.uscat(x)[0]

    fn = jax.jit(
        step,
        in_shardings=(spec_k, spec_k, spec_dk),
        out_shardings=spec_k,
    )
    return fn(jnp.asarray(ks), eta_b, dir_b)


def sharded_solve(
    c,
    *,
    centers,
    radii,
    k,
    n_end,
    direction,
    alpha=1.0,
    beta=0.0,
    eta=None,
    mesh=None,
    axis_name="rows",
    tol=None,
    matfree=False,
    lattice=False,
    _return_fn=False,
):
    """Solve ONE BIEM system with the dense matrix row-sharded.

    The [B·H, B·H] system matrix is annotated with a row sharding via
    `with_sharding_constraint`; XLA then partitions the assembly output,
    streams each shard's rows from its own device memory during the
    GMRES matvecs, and inserts collectives for the Krylov inner
    products.  Peak per-device matrix memory drops by the mesh size,
    which is what makes n_end/B configurations beyond one device's
    memory feasible (the memory model `max_memory` is per device).  Verified by compiled memory
    analysis in tests/test_parallel.py::test_sharded_solve_memory.

    matfree=True never forms the dense matrix at all: the per-offset
    (S|R) tables C [NO, H, H] of the matrix-free operator
    (biem._core._matfree_operator) are sharded over the offset axis, so
    each device stores and applies only its own offsets' translation
    blocks; the pair-scatter reduction is an all-reduce inserted by
    XLA.  This is the beyond-memory path when even one row-shard of the
    dense matrix is too large (memory then scales as NO·H²/n_devices,
    not B²H²/n_devices).  Requires concrete (host) geometry.

    lattice=True (implies matfree) uses the lattice-FFT operator
    (biem._lattice) with BOTH the per-offset (S|R) table build (offset
    axis) and the stored [Fx, Fy, H, H] kernel FFT (frequency axis)
    sharded over the mesh — the two are the same order of bytes, so
    sharding only the kernel would leave a replicated build-sized peak.
    The kernel FFT runs as a pencil decomposition (each stage
    transforms a locally-unsharded axis; one table-sized all-to-all per
    stage, one-time build cost).  Per iteration the per-frequency
    [H, H] @ [H] contraction runs on local kernel shards; only the
    small [.., Fx, Fy, H] vector field crosses devices (cell-axis
    FFTs).  Per-device kernel memory is F·H²/n_devices.  This is the
    multi-device form of the B >= 64 lattice solver.  Geometry must be a uniform lattice (lattice_routing), as
    in the reference CLI's n_balls sweeps.

    Returns the solved density [B, H] (replicated).
    """
    from jax.lax import with_sharding_constraint

    from ..biem._core import (
        _assemble,
        _check_biem_inputs,
        _matfree_operator,
        _rhs_dispatch,
    )
    from ..ops import cplx
    from ..ops.cplx import C

    if mesh is None:
        mesh = make_mesh(axis_names=(axis_name,))
    rows = NamedSharding(mesh, P(axis_name, None))
    repl = NamedSharding(mesh, P())
    d = c.c_ndim
    # geometry stays HOST numpy: the matfree pair routing needs concrete
    # centers, and trace-time geometry dedup needs concreteness anyway
    centers_np = np.asarray(centers)
    radii_np = np.asarray(radii)
    k = jnp.asarray(k)
    direction = jnp.asarray(direction)
    # numpy (not device): eta_in is captured by step's closure below
    eta_in = None if eta is None else np.asarray(eta)

    offs = NamedSharding(mesh, P(axis_name, None, None))

    def step(k_, dir_):
        uin, uin_grad = plane_wave(k=k_, direction=dir_)
        centers_c, radii_c, k_c, eta_c, alpha_c, beta_c = _check_biem_inputs(
            c, centers_np, radii_np, k_, eta_in, alpha, beta
        )
        f = _rhs_dispatch(
            c,
            n_end,
            centers_c,
            radii_c,
            alpha_c,
            beta_c,
            uin,
            uin_grad if np.any(np.asarray(beta) != 0) else None,
            0,
        )
        b_, h_ = f.shape[-2:]
        n = b_ * h_
        if lattice:
            from ..biem._lattice import lattice_operator

            def pin(axis_from_end):
                def f(z):
                    nd = z.re.ndim
                    names = [None] * nd
                    names[nd - axis_from_end] = axis_name
                    spec = NamedSharding(mesh, P(*names))
                    return C(
                        with_sharding_constraint(z.re, spec),
                        with_sharding_constraint(z.im, spec),
                    )

                return f

            # 'off': [.., NOh, H, H] offset axis; 'fx'/'fy': the
            # [.., Fx, Fy, H, H] frequency-grid axes (pencil DFT);
            # 'repl': gather a native complex array to replicated
            part = {
                "off": pin(3),
                "fx": pin(4),
                "fy": pin(3),
                "repl": lambda a: with_sharding_constraint(
                    a, NamedSharding(mesh, P())
                ),
            }
            op = lattice_operator(
                c, n_end, centers_np, radii_c, k_c, eta_c, alpha_c,
                beta_c, None, part=part,
            )
            if op is None:
                raise ValueError(
                    "lattice=True requires a uniform-lattice geometry"
                )
            mv, diag, _ = op
            x = cplx.gmres_solve_op(mv, diag, f.reshape((n,)), tol=tol)
        elif matfree:
            def sr_map(sr):
                return C(
                    with_sharding_constraint(sr.re, offs),
                    with_sharding_constraint(sr.im, offs),
                )

            # scale-compensate in f32 with the SAME dtype rule as
            # biem()'s auto policy: result_type(radii, k, float32)
            # (radii dtype alone diverged for f32 radii with f64 k)
            from ..ops.cplx import C as _C

            k_dt = (k_c.re if isinstance(k_c, _C) else k_c).dtype
            stable = (
                jnp.finfo(
                    jnp.result_type(radii_c.dtype, k_dt, jnp.float32)
                ).bits
                == 32
            )
            mv, diag = _matfree_operator(
                c, n_end, centers_np, radii_c, k_c, eta_c, alpha_c,
                beta_c, None, sr_map=sr_map, stable=stable,
            )
            x = cplx.gmres_solve_op(mv, diag, f.reshape((n,)), tol=tol)
        else:
            m = _assemble(
                c, n_end, centers_c, radii_c, k_c, eta_c, alpha_c, beta_c, None
            )
            m2 = m.reshape((n, n))
            m2 = C(
                with_sharding_constraint(m2.re, rows),
                with_sharding_constraint(m2.im, rows),
            )
            x = cplx.gmres_solve(m2, f.reshape((n,)), tol=tol)
        return x.reshape((b_, h_))

    fn = jax.jit(step, in_shardings=(repl, repl), out_shardings=repl)
    if _return_fn:  # for compiled-memory-analysis tests
        return fn, (k, direction)
    return fn(k, direction)


def sharded_uscat(calc, x, mesh=None, axis_name="points", **kw):
    """Evaluate calc.uscat with the points axis sharded over the mesh.

    x: [d, N] with N divisible by the mesh axis size; the solved state
    (density etc.) is replicated on every device.
    """
    if mesh is None:
        mesh = make_mesh(axis_names=(axis_name,))
    spec_x = NamedSharding(mesh, P(None, axis_name))
    repl = NamedSharding(mesh, P())
    calc_r = jax.device_put(calc, repl)

    def ev(calc_, x_):
        return calc_.uscat(x_, **kw)

    fn = jax.jit(ev, in_shardings=(repl, spec_x))
    return fn(calc_r, jnp.asarray(x))
