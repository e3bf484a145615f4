"""Per-phase timing of the bench config (n_end=32, B=16) on the live backend.

Times separately: dense assembly, RHS expansion, GMRES solve on a fixed
matrix, and the full fused solve_step — to localize perf regressions.
Run on an idle host: timeout 1500 python tools/phase_probe.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import jax

from biem_helmholtz_sphere_tpu.utils import setup_runtime

setup_runtime()

import jax.numpy as jnp

from biem_helmholtz_sphere_tpu import biem, plane_wave
from biem_helmholtz_sphere_tpu.biem._core import (
    _assemble,
    _check_biem_inputs,
    _rhs_dispatch,
)
from biem_helmholtz_sphere_tpu.coords import create_from_branching_types
from biem_helmholtz_sphere_tpu.ops import cplx

N_END = 32
N_SIDE = 4
SPACING = 4.0
K0 = 8.0


def lattice_centers(n_side, spacing, d=3):
    g = (np.arange(n_side) - (n_side - 1) / 2) * spacing
    xx, yy = np.meshgrid(g, g)
    centers = np.zeros((n_side * n_side, d))
    centers[:, 0] = xx.ravel()
    centers[:, 1] = yy.ravel()
    return centers


def timeit(f, *a, n=5):
    jax.block_until_ready(f(*a))  # compile
    t0 = time.perf_counter()
    for _ in range(n):
        jax.block_until_ready(f(*a))
    return (time.perf_counter() - t0) / n


def main():
    c = create_from_branching_types("ba")
    centers = lattice_centers(N_SIDE, SPACING).astype(np.float32)
    radii = np.ones(N_SIDE * N_SIDE, dtype=np.float32)
    direction = np.array([1.0, 0.0, 0.0], dtype=np.float32)

    print("devices:", jax.devices(), flush=True)

    def asm_step(k):
        cc, rr, kk, eta, al, be = _check_biem_inputs(
            c, centers, radii, k, None, 1.0, 0.0
        )
        m = _assemble(c, N_END, cc, rr, kk, eta, al, be, None, stable=True)
        return m.re.sum() + m.im.sum()

    def rhs_step(k):
        cc, rr, kk, eta, al, be = _check_biem_inputs(
            c, centers, radii, k, None, 1.0, 0.0
        )
        uin, _ = plane_wave(k=kk, direction=direction)
        f = _rhs_dispatch(c, N_END, cc, rr, al, be, uin, None, kk.ndim)
        return f.re.sum() + f.im.sum()

    def full_step(k):
        uin, _ = plane_wave(k=k, direction=direction)
        calc = biem(
            c, centers=centers, radii=radii, k=k, n_end=N_END, uin=uin
        )
        return calc.density

    def asm_mat(k):
        cc, rr, kk, eta, al, be = _check_biem_inputs(
            c, centers, radii, k, None, 1.0, 0.0
        )
        return _assemble(c, N_END, cc, rr, kk, eta, al, be, None, stable=True)

    k0 = jnp.float32(K0)
    t_asm = timeit(jax.jit(asm_step), k0)
    print(f"assemble (sum-reduced):  {t_asm:.4f} s", flush=True)
    t_rhs = timeit(jax.jit(rhs_step), k0)
    print(f"rhs:                     {t_rhs:.4f} s", flush=True)

    # solve on a fixed assembled matrix
    m = jax.jit(asm_mat)(k0)
    jax.block_until_ready(m)
    nsys = m.shape[-4] * m.shape[-3]
    m2 = m.reshape((nsys, nsys))
    rng = np.random.default_rng(0)
    from biem_helmholtz_sphere_tpu.ops.cplx import C

    f2 = C(
        jnp.asarray(rng.normal(size=nsys).astype(np.float32)),
        jnp.asarray(rng.normal(size=nsys).astype(np.float32)),
    )
    t_solve = timeit(jax.jit(cplx.gmres_solve), m2, f2)
    print(f"gmres (fixed matrix):    {t_solve:.4f} s", flush=True)

    t_full = timeit(jax.jit(full_step), k0)
    print(f"full asm+rhs+solve:      {t_full:.4f} s", flush=True)


if __name__ == "__main__":
    main()
