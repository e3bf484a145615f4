"""Smoke run of the solver's main path on one NVIDIA GPU.

Usage, from the root of a checkout:

    python chip_smoke.py           # phases A-E on one card
    python chip_smoke.py --multi   # phase F only, on four cards

Phases:

  A  device: the first JAX device must be a GPU; no CPU fallback.
  B  golden: the README problem (two unit spheres, "ba" tree, k=1,
     n_end=6) in complex128 and in float32 at the pinned matmul precision.
  C  library main path at the bench deployment's full size: 16-sphere 3D
     lattice (spacing 4), n_end=32 (16,384 complex unknowns), float32
     through biem()'s auto policy, a warm-started k-sweep in k-blocks
     around k=8; gated on finiteness, GMRES relres, the sound-soft
     boundary residual and agreement with the same problem in complex128.
  D  CLI main path: `accuracy --mode n_balls` in float64 on the 16- and
     64-sphere lattices, checked against the committed CPU float64 rows
     of accuracy/accuracy.csv.
  E  field evaluation of 131,072 points with the chunked fused uscat on
     the phase-C solution, checked against the general evaluation path
     on the complex128 solution.
  F  (--multi) parallel.sharded_sweep / sharded_uscat / sharded_solve
     (matfree and lattice) on four cards, each against the same call on
     one card.

The parent process never imports JAX.  Phases run in child processes,
one at a time, so exactly one process holds the card(s).  Any failed
gate exits non-zero.  The last line of standard output is
{"ok": true, "device": {...}} and is printed only when every phase
passed.  Times and rates are informational; each is printed beside the
card's name and power limit.
"""

import argparse
import csv
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# The bench deployment (bench.py): 4x4 lattice of unit spheres in the
# z=0 plane, spacing 4, plane wave along x0.
N_SIDE = 4
SPACING = 4.0
N_END = 32
K0 = 8.0
KB = 4  # k-points per batched solve (bench.py)
N_BLOCKS = 8  # k-blocks in the phase-C sweep
EVAL_POINTS = 1 << 17
EVAL_CHUNK = 16384
N_GENERAL = 512  # phase-E points checked against the general eval path
BC_BALLS = (0, 5, 10, 15)  # spheres sampled for the boundary residual
BC_PER_BALL = 64

# README doctest: uscat(0) of the two-sphere problem at n_end=6.
GOLDEN_CENTERS = ((0.0, 2.0, 0.0), (0.0, -2.0, 0.0))
GOLDEN_N_END = 6
GOLDEN = -0.741333 - 0.669657j

# Gates.  |u_in| = 1, so absolute and relative field errors coincide.
TOL_GOLDEN_C128 = 1e-6  # the reference value's 6 decimals
TOL_GOLDEN_F32 = 1e-4  # float32 at the pinned precision
TOL_BC = 2e-4  # max |u_in + u_scat| on the surface, float32
TOL_C128 = 1e-4  # float32 uscat(0) against complex128
TOL_EVAL = 1e-4  # float32 fused eval against complex128 general eval
# phase D: the committed rows were solved with LU (16 spheres) and with
# GMRES at tol 1e-13 (64 spheres); the CLI default here is 1e-11.
ACCURACY_ROWS = {16: 1e-9, 64: 1e-8}
# phase F: four cards against one, same call
TOL_MULTI_F32 = 1e-4
TOL_MULTI_F64 = 1e-8

ACCURACY_ARGS = [
    "accuracy", "--mode", "n_balls", "--branching-types", "ba",
    "--dtype", "float64", "--n-balls-min-log4", "1",
    "--n-balls-max-log4", "2", "--n-end-min-log2", "4",
    "--n-end-max-log2", "4",
]

LIB_TIMEOUT_S = 900
CLI_TIMEOUT_S = 420
MULTI_TIMEOUT_S = 1000


class GateError(RuntimeError):
    """A smoke gate failed."""


def gate(name, value, tol):
    """Print `name: value <= tol` and raise GateError unless it holds
    (NaN fails)."""
    ok = bool(value <= tol)
    print(f"  gate {name}: {value:.3e} <= {tol:.1e} {'pass' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise GateError(f"{name}: {value!r} > {tol!r}")


def card_info():
    """nvidia-smi's `name, power.limit` line(s), or None without a card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out or None


def lattice(n_side, dtype, spacing=SPACING):
    from biem_helmholtz_sphere_tpu.cli._accuracy import lattice_centers

    return lattice_centers(n_side, 3, spacing).astype(dtype)


# ---------------------------------------------------------------- library


def solve(centers, k, n_end, dtype):
    """biem() on the sound-soft plane-wave problem, jitted; returns the
    result calculator.  complex128 needs an enclosing jax.enable_x64."""
    import jax
    import jax.numpy as jnp

    from biem_helmholtz_sphere_tpu import biem, plane_wave
    from biem_helmholtz_sphere_tpu.coords import create_from_branching_types

    c = create_from_branching_types("ba")
    centers = np.asarray(centers, dtype)  # host numpy: concrete geometry
    radii = np.ones(len(centers), dtype)
    direction = np.array([1.0, 0.0, 0.0], dtype)

    def f(kk):
        uin, _ = plane_wave(k=kk, direction=direction)
        return biem(c, centers=centers, radii=radii, k=kk, n_end=n_end, uin=uin)

    calc = jax.jit(f)(jnp.asarray(k, dtype))
    jax.block_until_ready(calc.density)
    return calc


def uscat(calc, x):
    """calc.uscat(x) jitted, as a numpy complex array."""
    import jax

    from biem_helmholtz_sphere_tpu.ops.cplx import to_numpy

    return to_numpy(jax.jit(lambda cl, xx: cl.uscat(xx))(calc, x))


def uscat_origin(calc, dtype):
    return complex(uscat(calc, np.zeros((3, 1), dtype)).ravel()[0])


def surface_points(centers, balls, n_per_ball, seed=7, r=1.0000005):
    """Random points just outside the unit spheres `balls`: [3, N]."""
    rng = np.random.default_rng(seed)
    pts = []
    for b in balls:
        v = rng.normal(size=(3, n_per_ball))
        v /= np.linalg.norm(v, axis=0)
        pts.append(np.asarray(centers[b], np.float64)[:, None] + r * v)
    return np.concatenate(pts, axis=1)


def bc_residual(calc, centers, k, balls, n_per_ball, dtype):
    """max |u_in + u_scat| at surface points (sound-soft: u = 0 there)
    for the unit plane wave along x0."""
    x = surface_points(centers, balls, n_per_ball).astype(dtype)
    u_sc = uscat(calc, x).ravel()
    u_in = np.exp(1j * float(k) * x[0].astype(np.float64))
    return float(np.max(np.abs(u_in + u_sc)))


def field_points(centers, n, seed=0, scale=20.0, margin=1e-3):
    """n random points ([3, n]) outside every unit sphere."""
    rng = np.random.default_rng(seed)
    centers = np.asarray(centers, np.float64)
    x = rng.normal(size=(3, n)) * scale
    while True:
        dist = np.linalg.norm(x[:, :, None] - centers.T[:, None, :], axis=0)
        bad = dist.min(axis=1) < 1.0 + margin
        if not bad.any():
            return x
        x[:, bad] = rng.normal(size=(3, int(bad.sum()))) * scale


def k_sweep(centers, n_end, k0, kb, n_blocks, dtype=np.float32):
    """Warm-started k-sweep in k-blocks of kb (bench.py's blocked sweep).

    Each block is one jitted biem() call with a leading k axis; the
    previous block's last density seeds GMRES.  Returns a dict with the
    per-k uscat(0), relres and iterations, the per-block max iterations,
    the compile time and the per-k wall time of the timed pass.
    """
    import jax
    import jax.numpy as jnp

    from biem_helmholtz_sphere_tpu import biem, plane_wave
    from biem_helmholtz_sphere_tpu.coords import create_from_branching_types
    from biem_helmholtz_sphere_tpu.harmonics._index import basis
    from biem_helmholtz_sphere_tpu.ops.cplx import C, to_numpy

    c = create_from_branching_types("ba")
    centers = np.asarray(centers, dtype)
    nb = len(centers)
    # batched geometry stays host numpy (concrete), as in bench.py
    centers_b = np.broadcast_to(centers, (kb, nb, 3))
    radii_b = np.ones((kb, nb), dtype)
    dir_b = np.broadcast_to(np.array([1.0, 0.0, 0.0], dtype)[:, None], (3, kb))

    def block_step(k, dens0):
        uin, _ = plane_wave(k=k, direction=dir_b)
        calc = biem(c, centers=centers_b, radii=radii_b, k=k, n_end=n_end,
                    uin=uin, density0=dens0)
        u0 = calc.uscat(jnp.zeros((3, 1), k.dtype))
        return u0, calc.density, calc.relres, calc.iters

    step = jax.jit(block_step)
    ks = np.linspace(k0 - 1.0, k0 + 1.0, kb * n_blocks).astype(dtype)
    dens0 = C.zeros((nb, basis(c, n_end).num), dtype)

    t0 = time.perf_counter()
    jax.block_until_ready(step(jnp.asarray(ks[:kb]), dens0))
    compile_s = time.perf_counter() - t0

    outs = []
    dens = dens0
    t0 = time.perf_counter()
    for i0 in range(0, len(ks), kb):
        u0, dens_b, rr, it = step(jnp.asarray(ks[i0:i0 + kb]), dens)
        dens = dens_b[kb - 1]  # device-side warm-start chain
        outs.append((u0, dens_b, rr, it))
    jax.block_until_ready(outs)
    per_k = (time.perf_counter() - t0) / len(ks)

    finite = all(
        np.isfinite(to_numpy(d)).all() and np.isfinite(to_numpy(u)).all()
        for u, d, _, _ in outs
    )
    out = {
        "ks": ks,
        "u0": np.concatenate([to_numpy(o[0]).reshape(kb) for o in outs]),
        "relres": None,  # direct (LU) solves carry no relres
        "block_iters": None,
        "finite": finite,
        "compile_s": compile_s,
        "per_k_s": per_k,
    }
    if outs[0][2] is not None:
        out["relres"] = np.concatenate(
            [np.asarray(o[2]).reshape(kb) for o in outs]
        )
        out["block_iters"] = np.array([int(np.max(o[3])) for o in outs])
    return out


def eval_chunked(calc, x, chunk):
    """uscat of [3, N] points in chunks of `chunk` (jitted lax.map), as
    (numpy values, best-of-3 seconds after compilation)."""
    import jax
    import jax.numpy as jnp

    from biem_helmholtz_sphere_tpu.ops.cplx import to_numpy

    def ev(calc_, xx):
        xs = jnp.moveaxis(xx.reshape(3, -1, chunk), 1, 0)  # [nchunk, 3, chunk]
        return jax.lax.map(lambda xc: calc_.uscat(xc), xs)

    f = jax.jit(ev)
    xd = jax.device_put(x)
    jax.block_until_ready(f(calc, xd))
    best = np.inf
    for _ in range(3):
        t0 = time.perf_counter()
        out = jax.block_until_ready(f(calc, xd))
        best = min(best, time.perf_counter() - t0)
    return to_numpy(out).reshape(-1), best


def uscat_general(calc, x):
    """uscat through the general materialized-harmonics path of
    biem/_eval.py (the reference for the fused 3D contraction)."""
    from unittest import mock

    from biem_helmholtz_sphere_tpu.biem import _eval

    with mock.patch.object(_eval, "is_ba_tree", lambda c: False):
        return uscat(calc, x)


def phase_a(n_devices=1):
    """Device check; returns the device description for the last line."""
    import jax

    from biem_helmholtz_sphere_tpu.utils import setup_runtime

    cache = setup_runtime()
    devs = jax.devices()
    dev = devs[0]
    print(f"A device: platform={dev.platform} kind={dev.device_kind} "
          f"count={len(devs)} jax={jax.__version__}", flush=True)
    if dev.platform != "gpu":
        raise GateError(f"platform is {dev.platform!r}, not 'gpu'")
    if len(devs) < n_devices:
        raise GateError(f"{len(devs)} devices, need {n_devices}")
    print(f"  card: {card_info()}", flush=True)
    print(f"  compile cache: {cache}", flush=True)
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(devs)}


def phase_b():
    import jax

    from biem_helmholtz_sphere_tpu.utils import F32_MATMUL_PRECISION

    print("B golden: README problem, ba, k=1, n_end=6", flush=True)
    with jax.enable_x64(True):
        u128 = uscat_origin(
            solve(GOLDEN_CENTERS, 1.0, GOLDEN_N_END, np.float64), np.float64
        )
    print(f"  complex128 uscat(0) = {u128:.7f}", flush=True)
    gate("golden complex128", abs(u128 - GOLDEN), TOL_GOLDEN_C128)
    u32 = uscat_origin(
        solve(GOLDEN_CENTERS, 1.0, GOLDEN_N_END, np.float32), np.float32
    )
    print(f"  float32 uscat(0) = {u32:.7f} "
          f"(matmul precision {F32_MATMUL_PRECISION})", flush=True)
    gate("golden float32", abs(u32 - GOLDEN), TOL_GOLDEN_F32)


def phase_c(card, n_side=N_SIDE, n_end=N_END, k0=K0, kb=KB,
            n_blocks=N_BLOCKS, bc_balls=BC_BALLS):
    """Returns (float32 calc, complex128 calc) at k0 for phase E."""
    import jax

    from biem_helmholtz_sphere_tpu.ops.cplx import GMRES_TOL_F32

    nb = n_side * n_side
    print(f"C library: {nb} spheres, n_end={n_end}, float32 auto policy, "
          f"{n_blocks} k-blocks of {kb} around k={k0}", flush=True)
    centers = lattice(n_side, np.float32)
    sw = k_sweep(centers, n_end, k0, kb, n_blocks)
    print(f"  compile {sw['compile_s']:.1f} s; {sw['per_k_s'] * 1e3:.2f} ms "
          f"per k over {kb * n_blocks} k-points [{card}]", flush=True)
    if not sw["finite"]:
        raise GateError("k-sweep produced non-finite values")
    calc32 = solve(centers, k0, n_end, np.float32)
    if sw["relres"] is None or calc32.relres is None:
        print("  direct solve (LU): no GMRES diagnostics", flush=True)
    else:
        print(f"  GMRES iterations per block (max over k): "
              f"{sw['block_iters'].tolist()}", flush=True)
        gate("sweep relres (max over k)", float(np.max(sw["relres"])),
             GMRES_TOL_F32)
        gate(f"relres at k={k0}", float(np.max(np.asarray(calc32.relres))),
             GMRES_TOL_F32)
    bc = bc_residual(calc32, centers, k0, bc_balls, BC_PER_BALL, np.float32)
    gate("sound-soft boundary residual", bc, TOL_BC)
    u32 = uscat_origin(calc32, np.float32)
    with jax.enable_x64(True):
        calc128 = solve(centers.astype(np.float64), k0, n_end, np.float64)
        u128 = uscat_origin(calc128, np.float64)
    print(f"  uscat(0) at k={k0}: float32 {u32:.7f}, complex128 {u128:.7f}",
          flush=True)
    gate("float32 vs complex128 uscat(0)", abs(u32 - u128), TOL_C128)
    return calc32, calc128


def phase_e(card, calc32, calc128, n_side=N_SIDE, n_points=EVAL_POINTS,
            chunk=EVAL_CHUNK, n_general=N_GENERAL):
    import jax

    print(f"E field evaluation: {n_points} points, chunks of {chunk}",
          flush=True)
    centers = lattice(n_side, np.float64)
    x = field_points(centers, n_points)
    u, dt = eval_chunked(calc32, x.astype(np.float32), chunk)
    print(f"  {n_points / dt:.4e} points/s ({dt * 1e3:.2f} ms) [{card}]",
          flush=True)
    n_bad = int(np.sum(~np.isfinite(u)))
    gate("non-finite field values", n_bad, 0)
    idx = np.random.default_rng(1).choice(n_points, n_general, replace=False)
    with jax.enable_x64(True):
        ug = uscat_general(calc128, x[:, idx]).ravel()
    gate(f"fused float32 vs general complex128 ({n_general} points)",
         float(np.max(np.abs(u[idx] - ug))), TOL_EVAL)


def phase_lib(card):
    device = phase_a()
    phase_b()
    calc32, calc128 = phase_c(card)
    phase_e(card, calc32, calc128)
    return device


# ---------------------------------------------------------------- CLI


def committed_rows(path, btype="ba", mode="n_balls"):
    """{(n_balls, k, n_end): uscat} of the cpu:0 float64 rows in `path`
    (the last row wins where a key repeats)."""
    rows = {}
    with open(path, newline="") as fh:
        for r in csv.DictReader(fh):
            if (r["branching_types"], r["mode"], r["device"], r["dtype"]) == (
                btype, mode, "cpu:0", "float64"
            ):
                key = (int(r["n_balls"]), float(r["k"]), int(r["n_end"]))
                rows[key] = complex(float(r["uscat_real"]),
                                    float(r["uscat_imag"]))
    return rows


def check_accuracy_csv(path, committed, tols, device="gpu:0"):
    """Gate the CLI's accuracy CSV: exactly one row per n_balls in
    `tols`, written on `device`, within tols[n_balls] of the committed
    CPU float64 row of the same (n_balls, k, n_end)."""
    with open(path, newline="") as fh:
        rows = list(csv.DictReader(fh))
    got = sorted(int(r["n_balls"]) for r in rows)
    if got != sorted(tols):
        raise GateError(f"accuracy rows for n_balls {got}, expected "
                        f"{sorted(tols)} (a failed row is logged, not written)")
    for r in rows:
        nb = int(r["n_balls"])
        if r["device"] != device:
            raise GateError(f"n_balls={nb} row ran on {r['device']!r}, "
                            f"expected {device!r}")
        key = (nb, float(r["k"]), int(r["n_end"]))
        if key not in committed:
            raise GateError(f"no committed cpu:0 float64 row for {key}")
        u = complex(float(r["uscat_real"]), float(r["uscat_imag"]))
        print(f"  n_balls={nb} n_end={key[2]}: uscat(0) = {u:.12f}, "
              f"relres {r['solve_relres']}, iters {r['solve_iters']}, "
              f"{r['seconds']} s", flush=True)
        gate(f"n_balls={nb} vs committed CPU float64", abs(u - committed[key]),
             tols[nb])


def phase_d(card):
    print("D CLI: accuracy --mode n_balls, ba, float64, 16 and 64 spheres, "
          "n_end=16", flush=True)
    committed = committed_rows(os.path.join(ROOT, "accuracy", "accuracy.csv"))
    with tempfile.TemporaryDirectory() as out:
        cmd = [sys.executable, "-m", "biem_helmholtz_sphere_tpu",
               *ACCURACY_ARGS, "--out-dir", out]
        t0 = time.perf_counter()
        subprocess.run(cmd, cwd=ROOT, check=True, timeout=CLI_TIMEOUT_S)
        print(f"  CLI wall time {time.perf_counter() - t0:.1f} s "
              f"(compilation included) [{card}]", flush=True)
        check_accuracy_csv(os.path.join(out, "accuracy.csv"), committed,
                           ACCURACY_ROWS)


# ---------------------------------------------------------------- multi


def multi_checks(card, n_dev=4, n_side=N_SIDE, n_end=N_END, k0=K0, n_k=16,
                 n_points=32768, lattice_side=8, lattice_n_end=16):
    """Phase F: each sharded path on n_dev devices against the same call
    on one device."""
    import jax

    from biem_helmholtz_sphere_tpu.coords import create_from_branching_types
    from biem_helmholtz_sphere_tpu.ops.cplx import to_numpy
    from biem_helmholtz_sphere_tpu.parallel import (
        make_mesh,
        sharded_solve,
        sharded_sweep,
        sharded_uscat,
    )

    c = create_from_branching_types("ba")
    centers = lattice(n_side, np.float32)
    radii = np.ones(len(centers), np.float32)
    direction = np.array([1.0, 0.0, 0.0], np.float32)

    def timed(f):
        t0 = time.perf_counter()
        out = to_numpy(jax.block_until_ready(f()))
        return out, time.perf_counter() - t0

    def compare(name, mesh_fn, ref_fn, tol):
        got, t_n = timed(mesh_fn)
        ref, t_1 = timed(ref_fn)
        if not (np.isfinite(got).all() and np.isfinite(ref).all()):
            raise GateError(f"{name}: non-finite values")
        print(f"  {name}: {n_dev} devices {t_n:.1f} s, one device {t_1:.1f} s "
              f"(first calls, compilation included) [{card}]", flush=True)
        gate(f"{name}, {n_dev} devices vs one",
             float(np.max(np.abs(got - ref)) / np.max(np.abs(ref))), tol)

    print(f"F multi: {n_dev} devices", flush=True)
    ks = np.linspace(k0 - 1.0, k0 + 1.0, n_k).astype(np.float32)
    kw = dict(centers=centers, radii=radii, n_end=n_end, direction=direction)
    per_dev = n_k // n_dev
    compare(
        f"sharded_sweep, {n_k} k-points",
        lambda: sharded_sweep(c, ks=ks, mesh=make_mesh(n_dev), **kw),
        lambda: np.concatenate([
            to_numpy(sharded_sweep(c, ks=ks[i:i + per_dev], mesh=make_mesh(1),
                                   **kw))
            for i in range(0, n_k, per_dev)
        ]),
        TOL_MULTI_F32,
    )

    calc = solve(centers, k0, n_end, np.float32)
    x = field_points(centers.astype(np.float64), n_points).astype(np.float32)
    compare(
        f"sharded_uscat, {n_points} points",
        lambda: sharded_uscat(calc, x, mesh=make_mesh(n_dev, ("points",))),
        lambda: sharded_uscat(calc, x, mesh=make_mesh(1, ("points",))),
        TOL_MULTI_F32,
    )

    k32 = np.float32(k0)
    compare(
        "sharded_solve(matfree=True)",
        lambda: sharded_solve(c, k=k32, mesh=make_mesh(n_dev, ("rows",)),
                              matfree=True, **kw),
        lambda: sharded_solve(c, k=k32, mesh=make_mesh(1, ("rows",)),
                              matfree=True, **kw),
        TOL_MULTI_F32,
    )

    with jax.enable_x64(True):
        nb = lattice_side * lattice_side
        kw64 = dict(centers=lattice(lattice_side, np.float64),
                    radii=np.ones(nb), n_end=lattice_n_end,
                    direction=np.array([1.0, 0.0, 0.0]), k=np.float64(1.0),
                    lattice=True)
        compare(
            f"sharded_solve(lattice=True), {nb} spheres, float64",
            lambda: sharded_solve(c, mesh=make_mesh(n_dev, ("rows",)), **kw64),
            lambda: sharded_solve(c, mesh=make_mesh(1, ("rows",)), **kw64),
            TOL_MULTI_F64,
        )


def phase_multi(card):
    device = phase_a(n_devices=4)
    multi_checks(card)
    return device


# ---------------------------------------------------------------- driver


def run_child(phase, timeout):
    """Run `chip_smoke.py --phase <phase>` and echo its output; return
    the device dict from its RESULT line.  Raises on failure."""
    cmd = [sys.executable, os.path.abspath(__file__), "--phase", phase]
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, text=True)
    timer = threading.Timer(timeout, proc.kill)
    timer.start()
    result = None
    try:
        for line in proc.stdout:
            if line.startswith("RESULT "):
                result = json.loads(line[len("RESULT "):])
            else:
                print(line, end="", flush=True)
        rc = proc.wait()
    finally:
        timer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if rc != 0 or result is None:
        raise GateError(f"phase process {phase!r} failed (exit code {rc})")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card phase F")
    ap.add_argument("--phase", choices=["lib", "multi"],
                    help=argparse.SUPPRESS)  # child-process entry
    args = ap.parse_args(argv)
    card = card_info() or "no nvidia-smi"

    if args.phase is not None:
        device = (phase_lib if args.phase == "lib" else phase_multi)(card)
        print("RESULT " + json.dumps(device), flush=True)
        return 0

    t0 = time.perf_counter()
    try:
        if args.multi:
            device = run_child("multi", MULTI_TIMEOUT_S)
        else:
            device = run_child("lib", LIB_TIMEOUT_S)
            phase_d(card)
    except (GateError, subprocess.SubprocessError) as e:
        print(f"chip_smoke failed: {e}", file=sys.stderr, flush=True)
        return 1
    if card_info() is None:
        print("chip_smoke failed: nvidia-smi gives no card", file=sys.stderr)
        return 1
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
