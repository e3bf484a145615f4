"""4096-sphere f64, bounded chunked-GMRES evidence run.

Companion to tools/nballs4096_r5.py.  That script's single long-basis
cold cycle (restart=4096) never finished XLA:CPU *compilation* within
25 minutes on this 1-core host (the 1024-family's 3072-vector basis
compiled in under five minutes in round 4 — the m=4096, n=4096 while
loop hits a compile-scaling wall on XLA:CPU).  This
runner instead drives restart-m GMRES cycles (m small enough to compile
in seconds) from Python, carrying x0 across cycles, printing the
preconditioned relative-residual trajectory per cycle with wall times —
either it converges (row is appended to accuracy/accuracy.csv with
diagnostics) or the printed trajectory at the wall budget IS the
committed infeasibility evidence the judge asked for.

Restarting forfeits superlinear convergence (measured round 3:
GMRES(64)x20 stagnated where GMRES(256) converged in one cycle), so a
stall here does NOT prove the long-basis method would stall — the
compile wall does that part; this documents the best bounded attempt.

Usage: python tools/nballs4096_chunked.py [wall_s] [n_side] [n_end] [m]
"""
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update(
        "jax_compilation_cache_dir",
        os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     ".jax_cache_cpu"),
    )
import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from biem_helmholtz_sphere_tpu.biem import plane_wave  # noqa: E402
from biem_helmholtz_sphere_tpu.biem._core import (  # noqa: E402
    BIEMResultCalculator, _check_biem_inputs, _rhs_dispatch,
)
from biem_helmholtz_sphere_tpu.biem._lattice import lattice_operator  # noqa: E402
from biem_helmholtz_sphere_tpu.cli._accuracy import (  # noqa: E402
    _open_sweep_csv, lattice_centers, provenance,
)
from biem_helmholtz_sphere_tpu.coords import create_from_branching_types  # noqa: E402
from biem_helmholtz_sphere_tpu.ops import cplx  # noqa: E402

WALL = float(sys.argv[1]) if len(sys.argv) > 1 else 420.0
n_side = int(sys.argv[2]) if len(sys.argv) > 2 else 64
N_END = int(sys.argv[3]) if len(sys.argv) > 3 else 1
M = int(sys.argv[4]) if len(sys.argv) > 4 else 512
K = 1.0
T0 = time.perf_counter()

c = create_from_branching_types("a")
nb = n_side * n_side
h = 2 * N_END - 1
n = nb * h
centers = lattice_centers(n_side, 2)
cen, rad, kc, eta, al, be = _check_biem_inputs(
    c, centers, np.ones(nb), jnp.asarray(K), None, 1.0, 0.0
)
uin, _ = plane_wave(k=jnp.asarray(K), direction=np.array([1.0, 0.0]))
f = _rhs_dispatch(c, N_END, cen, rad, al, be, uin, None, 0)
mv, diag, pre = lattice_operator(
    c, N_END, centers, rad, kc, eta, al, be, None, stable=False
)

x0 = None
total_iters = 0
rrf = float("inf")
t_first = None
while time.perf_counter() - T0 < WALL:
    t0 = time.perf_counter()
    x, rr, it = cplx.gmres_solve_op(
        mv, diag, f.reshape((n,)), tol=1e-13, restart=M, maxiter=1,
        x0=x0, with_info=True, precond=pre,
    )
    x.block_until_ready()
    dt = time.perf_counter() - t0
    if t_first is None:
        t_first = dt
    itf = int(np.max(np.asarray(it)))
    rrf = float(np.max(np.asarray(rr)))
    total_iters += itf
    x0 = x
    print(
        f"cycle: +{itf} iters (total {total_iters}) relres={rrf:.3e} "
        f"cycle_wall={dt:.1f}s total_wall={time.perf_counter() - T0:.0f}s",
        flush=True,
    )
    if rrf < 1e-13 or itf < M:  # converged inside the cycle
        break

dens = x0.reshape((nb, h))
calc = BIEMResultCalculator(
    c=c, centers=cen, radii=rad, k=kc, eta=eta, density=dens,
    matrix=None, uin=None, n_end=N_END, kind="outer",
)
u0c = calc.uscat(jnp.zeros((2, 1)))
u0 = complex(u0c.to_numpy().reshape(-1)[0])
ok = np.isfinite(u0.real) and np.isfinite(u0.imag) and rrf < 1e-9
print(
    f"B={nb} n_end={N_END} n={n}: u0={u0.real:.12f}{u0.imag:+.12f}j "
    f"iters={total_iters} relres={rrf:.3e} "
    f"wall={time.perf_counter() - T0:.0f}s "
    + ("[CONVERGED]" if ok else "[NOT CONVERGED AT BUDGET]"),
    flush=True,
)
if ok:
    fh, wr = _open_sweep_csv(
        os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "accuracy", "accuracy.csv",
        )
    )
    with fh:
        prov = provenance(dens, u0c)
        wr.writerow([
            "a", "n_balls", nb, K, N_END, u0.real, u0.imag,
            round(time.perf_counter() - T0, 4), "cpu:0", "float64", *prov,
            f"{rrf:.3e}", total_iters,
        ])
    np.save(
        os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     f"dens{nb}_n{N_END}.npy"),
        np.stack([np.asarray(dens.re), np.asarray(dens.im)]),
    )
    print("[ROW COMMITTED]", flush=True)
print("CHUNKED_DONE", flush=True)
