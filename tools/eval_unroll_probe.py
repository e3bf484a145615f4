"""A/B the fused-eval scan unroll factor on the real chip.

Times the bench.py eval harness (B=16, n_end=32, 2^17 points, chunked
lax.map) for several unroll factors of the Jacobi-recurrence scan in
biem/_eval_fused.py, plus chunk-size variations, to pick the shipped
setting from measurement rather than theory.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np

from biem_helmholtz_sphere_tpu.biem import _eval_fused
from biem_helmholtz_sphere_tpu.biem import biem, plane_wave
from biem_helmholtz_sphere_tpu.cli._accuracy import lattice_centers
from biem_helmholtz_sphere_tpu.coords import create_from_branching_types
from biem_helmholtz_sphere_tpu.utils import setup_runtime

setup_runtime()
EVAL_POINTS = 1 << 17

c = create_from_branching_types("ba")
centers = np.concatenate(
    [lattice_centers(4, 2), np.zeros((16, 1))], axis=1
)  # 16 balls in z=0 plane, spacing 4
radii = jnp.ones(16)
k = jnp.float32(8.0)
uin, _ = plane_wave(k=k, direction=jnp.asarray([1.0, 0.0, 0.0]))
calc = biem(c, centers=centers, radii=radii, k=k, n_end=32, uin=uin)

rng = np.random.default_rng(0)
x = jnp.asarray(rng.normal(size=(3, EVAL_POINTS)).astype(np.float32) * 20.0)

# a NaN solve would time as fast: check it first
if not np.isfinite(float(np.asarray(calc.density.re[0, 0]))):
    raise RuntimeError("solve non-finite")  # plain raise: -O strips asserts

import itertools
import os

cases = [
    (int(a), int(b))
    for a, b in itertools.product(
        os.environ.get("PROBE_CHUNKS", "2048,16384").split(","),
        os.environ.get("PROBE_UNROLLS", "1,8,32").split(","),
    )
]
for chunk, unroll in cases:
    if True:
        _eval_fused._UNROLL_OVERRIDE = unroll

        def eval_chunked(calc_, xx):
            xs = xx.reshape(3, -1, chunk)
            xs = jnp.moveaxis(xs, 1, 0)
            return jax.lax.map(lambda xc: calc_.uscat(xc), xs)

        ej = jax.jit(eval_chunked)
        ej(calc, x).block_until_ready()
        dt = np.inf  # best of 5
        for _ in range(5):
            t0 = time.perf_counter()
            ej(calc, x).block_until_ready()
            dt = min(dt, time.perf_counter() - t0)
        print(
            f"chunk={chunk:6d} unroll={unroll:3d}: "
            f"{EVAL_POINTS / dt:.3e} pts/s ({dt * 1e3:.1f} ms)",
            flush=True,
        )
