"""4096-sphere f64 depth family (round 4).

Strategy: NON-restarted long-basis GMRES + an n_end LADDER.

Measured facts driving the design (16x16 lattice, f64 tol 1e-13,
tools/precond_probe.py + this script's calibration runs):
  * restarted GMRES(192) stagnates at 4096 balls (round 3); a long
    basis converges (256 balls: 454 iters, no stagnation);
  * COLD iteration counts grow ~L^1.7 with lattice side (64 balls:
    136, 256: 445) and are set by the lattice physics, NOT n_end;
  * warm starts from a lattice-SIZE continuation or from a partial
    low-tol solve of the same system do NOT help (445 vs 454; 657
    two-stage vs 445 cold — a restart discards the Krylov space);
  * warm starts across n_end DO help enormously (27 vs 445 iters):
    the new tail harmonics are evanescent at k rho = 1 (l >~ 6), so
    the previous row is the exact solution of a nearly-identical
    operator and the remaining error lives in easy near-diagonal
    modes.

So: pay the unavoidable cold iterations at a SMALL n_end where each
iteration is cheap (n = B (2 n_end - 1) unknowns), then ladder n_end
upward with the previous density (a PREFIX in the degree-major 2D
flat layout) as x0.  Every ladder row is appended to
accuracy/accuracy.csv (schema incl. solve_relres/solve_iters); the
artifact depths are n_end 19/22/26/32.

Usage:
    python tools/nballs_family4.py [n_side] [ladder] [cold_restart] [warm_restart]
    e.g.  python tools/nballs_family4.py 64 2,4,6,9,13,16,19,22,26,32 4608 768
"""
import os, sys, time

import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import numpy as np
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from biem_helmholtz_sphere_tpu.biem import plane_wave
from biem_helmholtz_sphere_tpu.biem._core import (
    BIEMResultCalculator, _check_biem_inputs, _rhs_dispatch,
)
from biem_helmholtz_sphere_tpu.biem._lattice import lattice_operator
from biem_helmholtz_sphere_tpu.cli._accuracy import (
    _open_sweep_csv, lattice_centers, provenance,
)
from biem_helmholtz_sphere_tpu.coords import create_from_branching_types
from biem_helmholtz_sphere_tpu.ops import cplx
from biem_helmholtz_sphere_tpu.ops.cplx import C

n_side = int(sys.argv[1]) if len(sys.argv) > 1 else 64
ladder = (
    [int(v) for v in sys.argv[2].split(",")] if len(sys.argv) > 2
    else [2, 4, 6, 9, 13, 16, 19, 22, 26, 32]
)
cold_restart = int(sys.argv[3]) if len(sys.argv) > 3 else 4608
warm_restart = int(sys.argv[4]) if len(sys.argv) > 4 else 768
K = 1.0

c = create_from_branching_types("a")
out_dir = os.environ.get(
    "BHS_FAM4_OUT",
    os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "accuracy"
    ),
)
os.makedirs(out_dir, exist_ok=True)
path = os.path.join(out_dir, "accuracy.csv")


def solve_row(n_side, n_end, x0, restart, wr, fh):
    nb = n_side * n_side
    centers = lattice_centers(n_side, 2)
    t0 = time.perf_counter()
    cen, rad, kc, eta, al, be = _check_biem_inputs(
        c, centers, np.ones(nb), jnp.asarray(K), None, 1.0, 0.0
    )
    uin, _ = plane_wave(k=jnp.asarray(K), direction=np.array([1.0, 0.0]))
    f = _rhs_dispatch(c, n_end, cen, rad, al, be, uin, None, 0)
    h = 2 * n_end - 1
    n = nb * h
    mv, diag, pre = lattice_operator(
        c, n_end, centers, rad, kc, eta, al, be, None, stable=False
    )
    x, rr, it = cplx.gmres_solve_op(
        mv, diag, f.reshape((n,)), tol=1e-13, restart=restart, maxiter=3,
        x0=None if x0 is None else x0.reshape((n,)),
        with_info=True, precond=pre,
    )
    x.block_until_ready()
    dens = x.reshape((nb, h))
    calc = BIEMResultCalculator(
        c=c, centers=cen, radii=rad, k=kc, eta=eta, density=dens,
        matrix=None, uin=None, n_end=n_end, kind="outer",
    )
    u0c = calc.uscat(jnp.zeros((2, 1)))
    u0 = complex(u0c.to_numpy().reshape(-1)[0])
    dt = time.perf_counter() - t0
    rrf = float(np.max(np.asarray(rr)))
    ok = np.isfinite(u0.real) and np.isfinite(u0.imag) and rrf < 1e-9
    if ok:
        prov = provenance(dens, u0c)
        wr.writerow([
            "a", "n_balls", nb, K, n_end, u0.real, u0.imag,
            round(dt, 4), "cpu:0", "float64", *prov,
            f"{rrf:.3e}", int(it),
        ])
        fh.flush()
    print(
        f"B={nb} n_end={n_end}: u0={u0.real:.12f}{u0.imag:+.12f}j "
        f"iters={int(it)} relres={rrf:.2e} wall={dt:.0f}s"
        + ("" if ok else "  [ROW SKIPPED: not converged/finite]"),
        flush=True,
    )
    return dens


fh, wr = _open_sweep_csv(path)
with fh:
    nb = n_side * n_side
    dens = None
    for i, n_end in enumerate(ladder):
        if dens is None:
            restart = min(cold_restart, nb * (2 * n_end - 1))
            x0 = None
        else:
            restart = warm_restart
            h, h0 = 2 * n_end - 1, dens.shape[-1]
            x0 = C.zeros((nb, h), dtype=jnp.float64)
            x0 = x0.at_set((slice(None), slice(0, h0)), dens)
        dens = solve_row(n_side, n_end, x0, restart, wr, fh)
print("FAMILY4_DONE")
