"""4096-sphere f64 family, round-5 attempt.

Round-4 calibration (tools/nballs_family4.py) established that COLD
long-basis GMRES iterations on the 2D lattice grow ~L^1.7 with lattice
side and are set by the lattice physics, NOT by n_end — the 32x32
lattice needed 1142 cold iterations at n_end=2 and the extrapolation to
64x64 is ~3.7k.  At ~0.26 s/iteration (n_end=2, 1-core host) that cold
stage alone is ~a quarter-hour-per-thousand-iterations, and the ladder's
warm rows (restart-768 forfeits superlinear convergence; 1536 iterations
at n_end=4/6 on the 32x32 lattice) multiply from there.

Round-5 twist: pay the cold iterations at n_end=1 (h = 2*n_end-1 = 1,
so n = B unknowns, a ~3x cheaper matvec and ~9x cheaper CGS2 pass than
n_end=2), then ladder upward, sizing each Krylov basis to the remaining
wall budget.  The script first runs a short calibration cycle to measure
s/iteration in situ, prints a projected cost table for the full ladder
(the committed infeasibility evidence if the budget runs out), and
appends every CONVERGED row (relres < 1e-9 self-consistency gate, same
as the 1024 family) to accuracy/accuracy.csv with solve diagnostics.

Usage:
    python tools/nballs4096_r5.py [wall_budget_s] [n_side]
    (defaults: 1500 s, 64)

Evidence log: tee stdout to tools/nballs4096_r5.log and commit it.
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
from biem_helmholtz_sphere_tpu.ops.cplx import C  # noqa: E402

WALL = float(sys.argv[1]) if len(sys.argv) > 1 else 1500.0
n_side = int(sys.argv[2]) if len(sys.argv) > 2 else 64
K = 1.0
LADDER = [1, 2, 4, 6, 9, 13, 16, 19, 22, 26, 32]
T0 = time.perf_counter()

c = create_from_branching_types("a")
nb = n_side * n_side
centers = lattice_centers(n_side, 2)
cen, rad, kc, eta, al, be = _check_biem_inputs(
    c, centers, np.ones(nb), jnp.asarray(K), None, 1.0, 0.0
)
uin, _ = plane_wave(k=jnp.asarray(K), direction=np.array([1.0, 0.0]))

fh, wr = _open_sweep_csv(
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "accuracy", "accuracy.csv")
)


def left(budget=WALL):
    return budget - (time.perf_counter() - T0)


def run_stage(n_end, x0, restart, label):
    """One GMRES call (single cycle, long basis) at degree cutoff n_end."""
    h = 2 * n_end - 1
    n = nb * h
    t0 = time.perf_counter()
    f = _rhs_dispatch(c, n_end, cen, rad, al, be, uin, None, 0)
    mv, diag, pre = lattice_operator(
        c, n_end, centers, rad, kc, eta, al, be, None, stable=False
    )
    x, rr, it = cplx.gmres_solve_op(
        mv, diag, f.reshape((n,)), tol=1e-13, restart=restart, maxiter=1,
        x0=None if x0 is None else x0.reshape((n,)),
        with_info=True, precond=pre,
    )
    x.block_until_ready()
    dt = time.perf_counter() - t0
    rrf = float(np.max(np.asarray(rr)))
    itf = int(np.max(np.asarray(it)))
    print(
        f"[{label}] B={nb} n_end={n_end} n={n} restart={restart}: "
        f"iters={itf} relres={rrf:.3e} wall={dt:.1f}s "
        f"({dt / max(itf, 1):.3f} s/iter)",
        flush=True,
    )
    return x.reshape((nb, h)), rrf, itf, dt


def commit_row(n_end, dens, rrf, itf, dt):
    calc = BIEMResultCalculator(
        c=c, centers=cen, radii=rad, k=kc, eta=eta, density=dens,
        matrix=None, uin=None, n_end=n_end, kind="outer",
    )
    u0c = calc.uscat(jnp.zeros((2, 1)))
    u0 = complex(u0c.to_numpy().reshape(-1)[0])
    ok = np.isfinite(u0.real) and np.isfinite(u0.imag) and rrf < 1e-9
    if ok:
        prov = provenance(dens, u0c)
        wr.writerow([
            "a", "n_balls", nb, K, n_end, u0.real, u0.imag,
            round(dt, 4), "cpu:0", "float64", *prov,
            f"{rrf:.3e}", itf,
        ])
        fh.flush()
    print(
        f"  u0={u0.real:.12f}{u0.imag:+.12f}j"
        + ("  [ROW COMMITTED]" if ok else "  [ROW SKIPPED: not converged]"),
        flush=True,
    )
    return ok


with fh:
    # ---- calibration: short cold cycle at n_end=1 (also pays compile).
    _, rr_cal, it_cal, dt_cal = run_stage(1, None, 64, "calibrate")
    # First call includes jit compile; estimate per-iter from a second,
    # compile-free short cycle continued from zero again (same cache).
    _, rr_cal2, it_cal2, dt_cal2 = run_stage(1, None, 64, "calibrate2")
    sec_per_iter = dt_cal2 / max(it_cal2, 1)
    need_cold = int(1142 * (n_side / 32) ** 1.7)  # round-4 L^1.7 law
    print(
        f"calibration: {sec_per_iter:.3f} s/iter at n_end=1; projected "
        f"cold solve ~{need_cold} iters ~{need_cold * sec_per_iter:.0f}s; "
        f"budget {WALL:.0f}s ({left():.0f}s left)",
        flush=True,
    )

    # ---- cold stage at n_end=1, full Krylov space allowed (the space
    # dimension caps at n = nb, so the cycle terminates by construction).
    dens, rrf, itf, dt = run_stage(1, None, nb, "cold")
    ok = commit_row(1, dens, rrf, itf, dt)
    np.save(
        os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     f"dens{nb}_n1.npy"),
        np.stack([np.asarray(dens.re), np.asarray(dens.im)]),
    )
    spi = dt / max(itf, 1)

    # ---- ladder upward while budget remains.  Each rung's basis is
    # sized from the MEASURED s/iter of the previous rung scaled by the
    # (h/h_prev)^2 matvec-cost ratio, and hard-capped so one call can
    # never blow the wall budget: low-degree hops re-excite the
    # propagating lattice modes (round-4 finding: cold-like iteration
    # counts below n_end ~ k*rho + 6), so a non-converging rung must
    # terminate with bounded, committed evidence instead of converging
    # at any cost.
    prev_h = 1
    for n_end in LADDER[1:]:
        h = 2 * n_end - 1
        spi = spi * (h / prev_h) ** 2
        budget_iters = int(0.85 * left() / spi)
        restart = min(nb * h, budget_iters, 1536)
        if restart < 192:
            print(
                f"[stop] wall budget exhausted before n_end={n_end} "
                f"(would afford {budget_iters} iters at ~{spi:.2f} s/iter); "
                f"{left():.0f}s left of {WALL:.0f}s",
                flush=True,
            )
            break
        x0 = C.zeros((nb, h), dtype=jnp.float64)
        x0 = x0.at_set((slice(None), slice(0, prev_h)), dens)
        dens, rrf, itf, dt = run_stage(n_end, x0, restart, "warm")
        spi = dt / max(itf, 1)
        if not commit_row(n_end, dens, rrf, itf, dt):
            print(
                f"[stop] n_end={n_end} did not converge within its "
                f"{restart}-vector basis (relres {rrf:.1e}); this is the "
                "committed infeasibility evidence for deeper rungs",
                flush=True,
            )
            break
        np.save(
            os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         f"dens{nb}_n{n_end}.npy"),
            np.stack([np.asarray(dens.re), np.asarray(dens.im)]),
        )
        prev_h = h

print(f"R5_4096_DONE wall={time.perf_counter() - T0:.0f}s", flush=True)
