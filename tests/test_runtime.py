"""Runtime setup and the GPU smoke script's own logic, on the CPU.

Covers the helpers every entry point shares (compile cache, float32
matmul precision), the platform-keyed auto-policy limits, the
benchmark's peak table, the CLI's device/dtype handling, and
chip_smoke.py: that it refuses a CPU-only process and that its gate
functions compute the right thing at a tiny size.
"""

import csv
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import bench  # noqa: E402
import chip_smoke as cs  # noqa: E402
from biem_helmholtz_sphere_tpu.biem._core import policy_limits  # noqa: E402
from biem_helmholtz_sphere_tpu.utils import _runtime  # noqa: E402


def _run(code_or_args, env_extra=None, env_drop=(), timeout=240, cwd=ROOT):
    env = {k: v for k, v in os.environ.items() if k not in env_drop}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = ROOT
    env.update(env_extra or {})
    args = code_or_args
    if isinstance(args, str):
        args = ["-c", args]
    return subprocess.run(
        [sys.executable, *args], capture_output=True, text=True,
        timeout=timeout, env=env, cwd=cwd,
    )


# ------------------------------------------------------------ compile cache


def test_compile_cache_respects_env(tmp_path):
    code = (
        "import jax\n"
        "from biem_helmholtz_sphere_tpu.utils import setup_compile_cache\n"
        "print(setup_compile_cache())\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
    )
    r = _run(code, env_extra={"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    assert r.returncode == 0, r.stderr
    returned, configured = r.stdout.split()
    # JAX reads the variable itself; the helper sets no other directory
    assert returned == str(tmp_path)
    assert configured == str(tmp_path)


def test_compile_cache_fallback_is_fixed_in_checkout():
    code = (
        "import jax\n"
        "from biem_helmholtz_sphere_tpu.utils import setup_compile_cache\n"
        "print(setup_compile_cache())\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
    )
    r = _run(code, env_drop=("JAX_COMPILATION_CACHE_DIR",))
    assert r.returncode == 0, r.stderr
    returned, configured = r.stdout.split()
    expected = os.path.join(ROOT, ".jax_cache")
    assert returned == configured == expected
    # gitignored, so the cache never enters a commit
    assert ".jax_cache/" in open(os.path.join(ROOT, ".gitignore")).read()


# ------------------------------------------------------- matmul precision


def test_set_matmul_precision_pins_the_helper_value():
    old = jax.config.jax_default_matmul_precision
    try:
        _runtime.set_matmul_precision()
        assert (
            jax.config.jax_default_matmul_precision
            == _runtime.F32_MATMUL_PRECISION
        )
    finally:
        jax.config.update("jax_default_matmul_precision", old)


def test_matmul_precision_is_set_in_one_place():
    hits = []
    for top in ("biem_helmholtz_sphere_tpu", "tools", "."):
        for dirpath, dirnames, files in os.walk(os.path.join(ROOT, top)):
            if top == ".":
                dirnames[:] = []  # root files only
            for f in files:
                if f.endswith(".py"):
                    p = os.path.join(dirpath, f)
                    if "jax_default_matmul_precision\"," in open(p).read():
                        hits.append(os.path.relpath(p, ROOT))
    assert hits == [os.path.join("biem_helmholtz_sphere_tpu", "utils",
                                 "_runtime.py")]


# ------------------------------------------------------------ peak table


@pytest.mark.parametrize("precision", sorted(bench._H100_SXM["flops"]))
def test_peaks_resolve_for_h100(precision):
    flops, bw = bench.peaks("NVIDIA H100 80GB HBM3", precision)
    assert flops > 1e13 and bw == 3.35e12


def test_peaks_cover_the_pinned_precision():
    flops, _ = bench.peaks("NVIDIA H100 80GB HBM3", _runtime.F32_MATMUL_PRECISION)
    assert flops > 0


@pytest.mark.parametrize(
    "kind,precision",
    [("cpu", "highest"), ("TPU v5 lite", "high"),
     ("NVIDIA H100 80GB HBM3", "bfloat16")],
)
def test_peaks_unknown_device_or_precision_raises(kind, precision):
    with pytest.raises(ValueError):
        bench.peaks(kind, precision)


# ------------------------------------------------------ auto-policy limits


def test_policy_limits_cpu_unchanged_and_gpu_carried_over():
    assert policy_limits("cpu") == (12288, 40e9)
    assert policy_limits("gpu") == (6144, 6e9)


@pytest.mark.parametrize("platform", ["tpu", "rocm", "METAL"])
def test_policy_limits_unknown_platform_raises(platform):
    with pytest.raises(ValueError, match="auto-policy"):
        policy_limits(platform)


# --------------------------------------------------------------------- CLI


def test_cli_device_choices_are_cpu_and_gpu():
    from biem_helmholtz_sphere_tpu.cli import main

    with pytest.raises(SystemExit):
        main(["accuracy", "--device", "tpu"])
    r = _run(["-m", "biem_helmholtz_sphere_tpu", "accuracy", "--help"])
    assert r.returncode == 0
    assert "{cpu,gpu}" in r.stdout.replace("None,", "")


def test_cli_float64_enables_x64_without_downgrade():
    code = (
        "import argparse, jax\n"
        "from biem_helmholtz_sphere_tpu.cli import _platform_setup\n"
        "_platform_setup(argparse.Namespace(device='cpu', dtype='float64'))\n"
        "import jax.numpy as jnp\n"
        "print(jax.config.jax_enable_x64, jnp.zeros(1).dtype,"
        " jax.devices()[0].platform)\n"
    )
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["True", "float64", "cpu"]


def test_cli_device_gpu_never_falls_back_to_cpu():
    code = (
        "import argparse, jax\n"
        "from biem_helmholtz_sphere_tpu.cli import _platform_setup\n"
        "_platform_setup(argparse.Namespace(device='gpu', dtype='float32'))\n"
        "print(jax.devices()[0].platform)\n"
    )
    r = _run(code)
    assert r.returncode != 0
    assert "cpu" not in r.stdout


# ------------------------------------------------ no device, no result


def test_chip_smoke_fails_on_cpu_only_process():
    r = _run([os.path.join(ROOT, "chip_smoke.py")])
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "not 'gpu'" in r.stderr


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {"PYTHONPATH": str(tmp_path)}
    r = _run([str(tmp_path / "chip_smoke.py")], env_extra=env, cwd=tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_bench_fails_on_cpu_only_process():
    r = _run([os.path.join(ROOT, "bench.py")])
    assert r.returncode != 0
    assert "needs a GPU" in r.stderr


# ------------------------------------------------------------ smoke gates


def test_gate_passes_and_fails():
    cs.gate("ok", 1e-5, 1e-4)
    with pytest.raises(cs.GateError):
        cs.gate("too large", 2e-4, 1e-4)
    with pytest.raises(cs.GateError):
        cs.gate("nan", float("nan"), 1.0)


def test_golden_gate_at_tiny_size():
    u = cs.uscat_origin(
        cs.solve(cs.GOLDEN_CENTERS, 1.0, cs.GOLDEN_N_END, np.float64),
        np.float64,
    )
    cs.gate("golden", abs(u - cs.GOLDEN), cs.TOL_GOLDEN_C128)


def test_bc_residual_small_for_solution_and_large_for_wrong_k():
    centers = np.array(cs.GOLDEN_CENTERS)
    calc = cs.solve(centers, 1.0, 8, np.float64)
    bc = cs.bc_residual(calc, centers, 1.0, (0, 1), 32, np.float64)
    assert bc < 1e-4
    # the same field checked against another incident wave must fail
    assert cs.bc_residual(calc, centers, 1.5, (0, 1), 32, np.float64) > 1e-2


def test_field_points_avoid_spheres():
    centers = cs.lattice(2, np.float64)
    x = cs.field_points(centers, 4096, scale=3.0)
    d = np.linalg.norm(x[:, :, None] - centers.T[:, None, :], axis=0)
    assert x.shape == (3, 4096) and d.min() >= 1.0


def _write_rows(path, rows):
    header = ["branching_types", "mode", "n_balls", "k", "n_end",
              "uscat_real", "uscat_imag", "seconds", "device", "dtype",
              "solve_relres", "solve_iters"]
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(header)
        for nb, u, dev in rows:
            w.writerow(["ba", "n_balls", nb, 1.0, 16, u.real, u.imag, 1.0,
                        dev, "float64", "exact", "exact"])


def test_committed_rows_are_the_cpu_float64_anchors():
    rows = cs.committed_rows(os.path.join(ROOT, "accuracy", "accuracy.csv"))
    assert rows[(16, 1.0, 16)] == -0.5250702704995105 - 0.043278119794107395j
    assert rows[(64, 1.0, 16)] == -0.6473720232086728 + 0.018550258564752092j


@pytest.mark.parametrize(
    "case", ["pass", "missing_row", "wrong_device", "off_by_1e-6"]
)
def test_accuracy_csv_check(tmp_path, case):
    committed = cs.committed_rows(os.path.join(ROOT, "accuracy", "accuracy.csv"))
    u16, u64 = committed[(16, 1.0, 16)], committed[(64, 1.0, 16)]
    rows = {
        "pass": [(16, u16, "gpu:0"), (64, u64 + 1e-9, "gpu:0")],
        "missing_row": [(16, u16, "gpu:0")],
        "wrong_device": [(16, u16, "cpu:0"), (64, u64, "cpu:0")],
        "off_by_1e-6": [(16, u16 + 1e-6, "gpu:0"), (64, u64, "gpu:0")],
    }[case]
    path = tmp_path / "accuracy.csv"
    _write_rows(path, rows)
    if case == "pass":
        cs.check_accuracy_csv(path, committed, cs.ACCURACY_ROWS)
    else:
        with pytest.raises(cs.GateError):
            cs.check_accuracy_csv(path, committed, cs.ACCURACY_ROWS)


def test_k_sweep_at_tiny_size_matches_single_solves():
    centers = cs.lattice(2, np.float64)
    sw = cs.k_sweep(centers, 6, 2.0, 2, 2, dtype=np.float64)
    assert sw["finite"] and sw["u0"].shape == (4,)
    u1 = cs.uscat_origin(cs.solve(centers, sw["ks"][1], 6, np.float64),
                         np.float64)
    assert abs(sw["u0"][1] - u1) < 1e-10


# ------------------------------------------------------------------ on card


@pytest.mark.gpu
def test_golden_on_gpu(gpu_device):
    cs.phase_b()


# ------------------------------------------------------------------ GUI cap


def test_gui_n_end_cap_follows_device_memory():
    from types import SimpleNamespace

    from biem_helmholtz_sphere_tpu.gui import _n_end_cap

    def gpu(nbytes):
        return SimpleNamespace(
            platform="gpu", memory_stats=lambda: {"bytes_limit": nbytes}
        )

    small, large = _n_end_cap(3, 16, gpu(2**30)), _n_end_cap(3, 16, gpu(2**36))
    assert 1 <= small < large
    assert _n_end_cap(3, 16) >= 1  # the CPU branch: host memory
