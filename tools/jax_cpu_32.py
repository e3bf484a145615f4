"""Same-code CPU baseline for the north-star config.

Runs the EXACT bench.py solve step (16-ball 3D lattice, n_end=32,
float32, GMRES) through JAX's CPU backend on this host and writes the
per-k-point wall time to tools/jax_cpu_32.log, which bench.py picks up
as the `vs_jax_cpu` (hardware-only) ratio — the `vs_baseline` NumPy
number also includes the algorithmic gap (banded vs rotation+coaxial
translation).

Usage: python tools/jax_cpu_32.py [n_timed_kpoints]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax

jax.config.update("jax_platforms", "cpu")
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update(
        "jax_compilation_cache_dir",
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                     ".jax_cache_cpu"),
    )
jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)

import jax.numpy as jnp

from biem_helmholtz_sphere_tpu import biem, plane_wave
from biem_helmholtz_sphere_tpu.coords import create_from_branching_types
from bench import K0, N_END, N_SIDE, SPACING, lattice_centers


def main():
    n_k = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    c = create_from_branching_types("ba")
    centers = lattice_centers(N_SIDE, SPACING).astype(np.float32)
    radii = np.ones(N_SIDE * N_SIDE, dtype=np.float32)
    direction = np.array([1.0, 0.0, 0.0], dtype=np.float32)

    def solve_step(k):
        uin, _ = plane_wave(k=k, direction=direction)
        calc = biem(c, centers=centers, radii=radii, k=k, n_end=N_END, uin=uin)
        return calc.density

    solve_jit = jax.jit(solve_step)
    t0 = time.perf_counter()
    solve_jit(jnp.float32(K0)).block_until_ready()
    compile_s = time.perf_counter() - t0

    ks = np.linspace(K0 - 0.25, K0 + 0.25, n_k).astype(np.float32)
    t0 = time.perf_counter()
    for kk in ks:
        solve_jit(jnp.float32(kk)).block_until_ready()
    per_k = (time.perf_counter() - t0) / n_k

    line = (
        f"jax-cpu same-code n_end={N_END} B={N_SIDE * N_SIDE}: per-k {per_k:.2f}s "
        f"(n_k={n_k}, compile+first {compile_s:.1f}s, f32 GMRES, host "
        f"{os.cpu_count()} cpu)"
    )
    print(line)
    log = os.path.join(os.path.dirname(os.path.abspath(__file__)), "jax_cpu_32.log")
    with open(log, "w") as fh:
        fh.write(line + "\n")


if __name__ == "__main__":
    main()
