"""Multi-chip sharding tests on the virtual 8-device CPU mesh.

Covers the promises made by parallel/__init__.py docstrings:
  * sharded_solve (dense) matches the unsharded solver;
  * matfree sharded_solve (offset-sharded (S|R) tables, never forming
    the dense matrix) matches too;
  * the per-device memory claims are verified with XLA's compiled
    memory analysis, not just asserted in prose.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from biem_helmholtz_sphere_tpu import biem, plane_wave
from biem_helmholtz_sphere_tpu.coords import create_from_branching_types
from biem_helmholtz_sphere_tpu.ops.cplx import to_numpy
from biem_helmholtz_sphere_tpu.parallel import make_mesh, sharded_solve


def _lattice(n_side, d, spacing=4.0):
    g = (np.arange(n_side) - (n_side - 1) / 2) * spacing
    xx, yy = np.meshgrid(g, g)
    centers = np.zeros((n_side * n_side, d))
    centers[:, 0] = xx.ravel()
    centers[:, 1] = yy.ravel()
    return centers


def _dense_reference(c, centers, n_end, k=1.0):
    d = c.c_ndim
    direction = np.zeros(d)
    direction[0] = 1.0
    uin, _ = plane_wave(k=np.asarray(k), direction=jnp.asarray(direction))
    calc = biem(
        c,
        centers=centers,
        radii=np.ones(len(centers)),
        k=np.asarray(k),
        n_end=n_end,
        uin=uin,
    )
    return to_numpy(calc.density)


def test_sharded_solve_matfree_matches_dense():
    c = create_from_branching_types("a")
    centers = _lattice(2, 2)
    mesh = make_mesh(n_devices=8, axis_names=("rows",))
    d_ref = _dense_reference(c, centers, n_end=8)
    dens = sharded_solve(
        c,
        centers=centers,
        radii=np.ones(4),
        k=jnp.asarray(1.0),
        n_end=8,
        direction=np.array([1.0, 0.0]),
        mesh=mesh,
        matfree=True,
    )
    got = to_numpy(dens)
    assert got.shape == d_ref.shape
    np.testing.assert_allclose(got, d_ref, rtol=1e-8, atol=1e-10)


@pytest.mark.slow
def test_sharded_solve_memory():
    """The dense row-sharded solve must actually partition the matrix:
    per-device temp+argument bytes on the 8-device mesh stay well under
    the full [n, n] complex matrix footprint (docstring claim of
    parallel.sharded_solve, flagged unverified in round 1)."""
    c = create_from_branching_types("a")
    n_side, n_end = 4, 64
    centers = _lattice(n_side, 2)
    nb = n_side * n_side
    h = 2 * n_end - 1
    n = nb * h
    dense_bytes = 2 * 8 * n * n  # re+im f64 pair

    fn, args = sharded_solve(
        c,
        centers=centers,
        radii=np.ones(nb),
        k=jnp.asarray(1.0),
        n_end=n_end,
        direction=np.array([1.0, 0.0]),
        mesh=make_mesh(n_devices=8, axis_names=("rows",)),
        _return_fn=True,
    )
    ma = fn.lower(*args).compile().memory_analysis()
    per_dev = ma.temp_size_in_bytes + ma.argument_size_in_bytes
    # one device must hold ~1/8 of the matrix (+ GMRES basis and
    # assembly workspace); anything close to the full matrix means XLA
    # materialized it unsharded
    assert per_dev < 0.45 * dense_bytes, (per_dev, dense_bytes)
    # and it must be at least the size of its own row shard
    assert per_dev > dense_bytes / 8 / 4, (per_dev, dense_bytes)


@pytest.mark.slow
def test_sharded_matfree_memory_beyond_one_device():
    """The offset-sharded matrix-free path must compile with a
    per-device footprint FAR below the dense matrix — the beyond-HBM
    regime: a [n, n] system whose dense matrix could not fit a device
    that comfortably holds the matfree working set."""
    c = create_from_branching_types("a")
    n_side, n_end = 8, 64  # 64 balls, H=127 -> n=8128
    centers = _lattice(n_side, 2)
    nb = n_side * n_side
    h = 2 * n_end - 1
    n = nb * h
    dense_bytes = 2 * 8 * n * n  # 1.06 GB

    fn, args = sharded_solve(
        c,
        centers=centers,
        radii=np.ones(nb),
        k=jnp.asarray(1.0),
        n_end=n_end,
        direction=np.array([1.0, 0.0]),
        mesh=make_mesh(n_devices=8, axis_names=("rows",)),
        matfree=True,
        _return_fn=True,
    )
    ma = fn.lower(*args).compile().memory_analysis()
    per_dev = ma.temp_size_in_bytes + ma.argument_size_in_bytes
    # the whole point of matfree+sharded: per-device memory is a small
    # fraction of the dense matrix (offset tables + Krylov basis only)
    assert per_dev < dense_bytes / 8, (per_dev, dense_bytes)


def test_sharded_lattice_kernel_memory_and_value():
    """The lattice=True sharded solve (round 4): the stored kernel FFT
    and its offset-table build are frequency/offset-sharded over the
    mesh, so the per-device footprint on 8 devices is well below the
    single-device compile of the SAME step (measured r4: 104.7 MB vs
    151.8 MB at this config; the gap to kernel/8 is the one-time
    gather of the offset table into grid cells, which SPMD all-gathers
    — documented residual, not per-iteration).  The solved density
    matches the single-device matfree solve."""
    from biem_helmholtz_sphere_tpu import biem, plane_wave

    c = create_from_branching_types("a")
    n_side, n_end = 4, 96  # largest f64-stable-off depth (112+ overflows)
    centers = _lattice(n_side, 2)
    nb = n_side * n_side
    h = 2 * n_end - 1
    fx = 2 * n_side
    kernel_bytes = 2 * 8 * fx * fx * h * h  # re+im f64 pair
    fn, args = sharded_solve(
        c,
        centers=centers,
        radii=np.ones(nb),
        k=jnp.asarray(1.0),
        n_end=n_end,
        direction=np.array([1.0, 0.0]),
        mesh=make_mesh(n_devices=8, axis_names=("rows",)),
        lattice=True,
        _return_fn=True,
    )
    ma = fn.lower(*args).compile().memory_analysis()
    per_dev = ma.temp_size_in_bytes + ma.argument_size_in_bytes
    fn1, args1 = sharded_solve(
        c,
        centers=centers,
        radii=np.ones(nb),
        k=jnp.asarray(1.0),
        n_end=n_end,
        direction=np.array([1.0, 0.0]),
        mesh=make_mesh(n_devices=1, axis_names=("rows",)),
        lattice=True,
        _return_fn=True,
    )
    ma1 = fn1.lower(*args1).compile().memory_analysis()
    one_dev = ma1.temp_size_in_bytes + ma1.argument_size_in_bytes
    # the kernel itself must be partitioned: the 8-device footprint
    # must drop by at least ~0.8x the full kernel's bytes
    assert per_dev < one_dev - 0.55 * kernel_bytes, (
        per_dev, one_dev, kernel_bytes,
    )
    dens = fn(*args)
    uin, _ = plane_wave(k=jnp.asarray(1.0), direction=np.array([1.0, 0.0]))
    ref = biem(
        c, centers=centers, radii=np.ones(nb), k=jnp.asarray(1.0),
        n_end=n_end, uin=uin, solver="matfree",
    ).density
    import numpy as _np
    d1 = dens.to_numpy()
    d2 = ref.to_numpy()
    assert _np.abs(d1 - d2).max() / _np.abs(d2).max() < 1e-8
