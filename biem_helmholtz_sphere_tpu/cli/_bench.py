"""`bench` subcommand: assembly+solve+eval wall-time on the local device
(block_until_ready timing; the jax.profiler hook recommended by
SURVEY.md section 5)."""

import logging
import time

import numpy as np

log = logging.getLogger(__name__)


def run_bench(n_end=16, n_side=2, k=4.0, profile=None):
    import jax
    import jax.numpy as jnp

    from ..biem import biem, plane_wave
    from ..coords import create_from_branching_types
    from ._accuracy import lattice_centers

    c = create_from_branching_types("ba")
    # HOST numpy closures: the geometry is concrete at trace time, which
    # the offset dedup and matrix-free routes need.
    centers = lattice_centers(n_side, 3).astype(np.float32)
    radii = np.ones(n_side * n_side, np.float32)
    direction = np.array([1.0, 0.0, 0.0], np.float32)

    def step(kk):
        uin, _ = plane_wave(k=kk, direction=direction)
        calc = biem(c, centers=centers, radii=radii, k=kk, n_end=n_end, uin=uin)
        return calc.density

    f = jax.jit(step)
    t0 = time.perf_counter()
    f(jnp.float32(k)).block_until_ready()
    compile_s = time.perf_counter() - t0
    if profile:
        jax.profiler.start_trace(profile)
    t0 = time.perf_counter()
    reps = 3
    for i in range(reps):
        f(jnp.float32(k + 0.01 * (i + 1))).block_until_ready()
    per_solve = (time.perf_counter() - t0) / reps
    if profile:
        jax.profiler.stop_trace()
        log.info("wrote jax.profiler trace to %s", profile)
    dev = jax.devices()[0]
    print(
        f"device={dev.platform} B={n_side**2} n_end={n_end} k={k}: "
        f"compile {compile_s:.1f}s, assembly+solve {per_solve:.4f}s per k-point"
    )
    return per_solve
