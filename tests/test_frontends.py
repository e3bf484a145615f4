"""Frontend tests: CLI subcommands, plots, GUI handler, parallel sharding."""

import csv
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cli_help():
    out = subprocess.run(
        [sys.executable, "-m", "biem_helmholtz_sphere_tpu", "--help"],
        capture_output=True,
        text=True,
        cwd=REPO,
    )
    assert out.returncode == 0
    for cmd in ["serve", "jascome", "accuracy", "plot-accuracy", "bench"]:
        assert cmd in out.stdout


def test_reference_cell_coverage():
    """Every (k|n_balls, n_end) cell of the reference's committed sweep
    artifacts is present in this repo's committed artifacts (a
    cell-coverage audit as a test, data parity only — no solve).

    accuracy/reference_cells.json is the distinct-cell manifest distilled
    from the reference's accuracy_k_a.csv (748 cells), accuracy_k_ba.csv
    (390 cells, 781 rows over two sweep passes) and
    accuracy_n_balls_a.csv (81 cells).
    """
    import csv
    import glob
    import json

    with open(os.path.join(REPO, "accuracy", "reference_cells.json")) as f:
        ref = {k: {(float(a), int(b)) for a, b in v} for k, v in json.load(f).items()}

    ours = {"k_a": set(), "k_ba": set(), "n_balls_a": set()}
    for path in glob.glob(os.path.join(REPO, "accuracy", "accuracy*.csv")):
        with open(path, newline="") as f:
            for r in csv.DictReader(f):
                bt = r.get("branching_types")
                mode = r.get("mode", "k")
                try:
                    n_end = int(r["n_end"])
                    if mode == "k" and bt in ("a", "ba"):
                        ours[f"k_{bt}"].add((float(r["k"]), n_end))
                    elif mode == "n_balls" and bt == "a":
                        ours["n_balls_a"].add((float(r["n_balls"]), n_end))
                except (KeyError, ValueError):
                    continue

    for fam, cells in ref.items():
        missing = cells - ours[fam]
        assert not missing, (
            f"{fam}: {len(missing)} reference cells missing from committed "
            f"artifacts, e.g. {sorted(missing)[:8]}"
        )


def test_jascome_bempp_mfs_ladder(tmp_path):
    """`jascome-bempp` runs the built-in MFS independent oracle (the
    reference ran bempp-cl here, cli.py:118-142); the ladder must
    converge toward the README spectral golden -0.74133-0.66966j."""
    out = subprocess.run(
        [
            sys.executable,
            "-m",
            "biem_helmholtz_sphere_tpu",
            "jascome-bempp",
            "--out-dir",
            str(tmp_path),
            "--n-src-max",
            "100",
        ],
        capture_output=True,
        text=True,
        cwd=REPO,
    )
    assert out.returncode == 0, out.stderr
    with open(tmp_path / "jascome_mfs_output.csv") as fh:
        rows = list(csv.DictReader(fh))
    assert [int(r["n_src"]) for r in rows] == [50, 100]
    last = complex(rows[-1]["uscat"].strip("()"))
    assert abs(last - (-0.74133 - 0.66966j)) < 2e-5
    assert float(rows[-1]["bc_residual"]) < 1e-3


def test_accuracy_sweep_and_heatmap(tmp_path):
    from biem_helmholtz_sphere_tpu.cli._accuracy import plot_accuracy, run_accuracy

    path = run_accuracy(
        str(tmp_path),
        branching_types=["a"],
        mode="k",
        k_max_log2=1.0,
        n_end_max_log2=2.0,
    )
    import pandas as pd

    df = pd.read_csv(path)
    assert len(df) >= 6
    assert (df["branching_types"] == "a").all()
    out = plot_accuracy(str(tmp_path))
    assert all(os.path.exists(p) for p in out)


def test_accuracy_sweep_k_block_matches_scalar(tmp_path):
    # k_block > 1 solves k-points through one batched call; rows must
    # match the scalar sweep to solver precision
    from biem_helmholtz_sphere_tpu.cli._accuracy import run_accuracy

    import pandas as pd

    p1 = run_accuracy(
        str(tmp_path / "scalar"),
        branching_types=["a"],
        mode="k",
        k_max_log2=1.0,
        n_end_max_log2=1.0,
    )
    p2 = run_accuracy(
        str(tmp_path / "blocked"),
        branching_types=["a"],
        mode="k",
        k_max_log2=1.0,
        n_end_max_log2=1.0,
        k_block=2,
    )
    d1 = pd.read_csv(p1).sort_values(["n_end", "k"]).reset_index(drop=True)
    d2 = pd.read_csv(p2).sort_values(["n_end", "k"]).reset_index(drop=True)
    assert len(d1) == len(d2)
    np.testing.assert_allclose(
        d2["uscat_real"], d1["uscat_real"], rtol=0, atol=1e-8
    )
    np.testing.assert_allclose(
        d2["uscat_imag"], d1["uscat_imag"], rtol=0, atol=1e-8
    )


def test_jascome_and_clean(tmp_path):
    from biem_helmholtz_sphere_tpu.cli._jascome import clean_jascome, run_jascome

    run_jascome(str(tmp_path), n_end_max=3, btypes=["a"])
    files = clean_jascome(str(tmp_path))
    import pandas as pd

    df = pd.read_csv(files[0])
    assert "a" in df.columns and len(df) == 3


def test_plots(tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    from biem_helmholtz_sphere_tpu import biem, plane_wave
    from biem_helmholtz_sphere_tpu.coords import create_from_branching_types
    from biem_helmholtz_sphere_tpu.plot import plot_biem, plot_biem_far

    c = create_from_branching_types("ba")
    uin, _ = plane_wave(k=np.asarray(1.0), direction=jnp.asarray([1.0, 0.0, 0.0]))
    calc = biem(
        c,
        centers=jnp.asarray([[0.0, 2.0, 0.0], [0.0, -2.0, 0.0]]),
        radii=jnp.ones(2),
        k=np.asarray(1.0),
        n_end=4,
        uin=uin,
    )
    ax = plot_biem(calc, n_points=24)
    ax.figure.savefig(tmp_path / "near.png")
    ax2 = plot_biem_far(calc, n_points=36)
    ax2.figure.savefig(tmp_path / "far.png")
    assert (tmp_path / "near.png").stat().st_size > 1000
    assert (tmp_path / "far.png").stat().st_size > 1000

    from biem_helmholtz_sphere_tpu.plot import animate_biem

    gif = animate_biem(calc, str(tmp_path / "anim.gif"), n_frames=3, n_points=16)
    assert (tmp_path / "anim.gif").stat().st_size > 1000, gif


def test_gui_solver_handler():
    from biem_helmholtz_sphere_tpu.gui import _solve_and_plot

    status, images = _solve_and_plot(
        {
            "ctype": "custom",
            "btype": "ba",
            "dim": "3",
            "k": "1",
            "eta": "1",
            "n_end": "3",
            "kind": "outer",
            "spheres": "1+0j, 0+0j, 1.0, 0 2 0\n1+0j, 0+0j, 1.0, 0 -2 0",
            "axes": "0 1",
            "lim": "6",
            "fmt": "png",
        }
    )
    assert "uscat(0)" in status
    assert "base64" in images


def test_gui_http_roundtrip():
    import threading
    import urllib.parse
    import urllib.request
    from http.server import ThreadingHTTPServer

    from biem_helmholtz_sphere_tpu.gui import _Handler

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
    port = httpd.server_address[1]
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        page = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/", timeout=30
        ).read()
        assert b"biem-helmholtz-sphere-tpu" in page
        # widget parity with reference gui.py:30-254: device/dtype
        # enumeration, force_matrix, add/remove sphere rows, animation
        # and time controls, progress indicator
        for needle in (
            b'name="device"',
            b'name="dtype"',
            b'name="force_matrix"',
            b'name="sphere"',
            b"addRow",
            b'name="animate"',
            b'name="t"',
            b'id="progress"',
            # reactive recompute (reference gui.py:256-338): the change
            # listener fetch()es the /compute fragment endpoint and
            # swaps the result panes in place; checkbox defaults ON
            b'id="reactive" name="reactive" checked',
            b"form.addEventListener('change'",
            b"fetch('/compute'",
            b'id="result"',
        ):
            assert needle in page, needle
        # device options come from the live JAX backend
        assert b"cpu:0" in page

        # POST a 3-sphere problem through the multi-row sphere widgets
        # on an explicit device/dtype (one ball Robin to cover alpha/beta
        # parsing), checking the recompute + provenance line
        data = urllib.parse.urlencode(
            [
                ("ctype", "custom"),
                ("btype", "ba"),
                ("dim", "3"),
                ("device", "cpu:0"),
                ("dtype", "float32"),
                ("k", "1"),
                ("eta", "1"),
                ("n_end", "2"),
                ("kind", "outer"),
                ("sphere", "1+0j, 0+0j, 1.0, 0 2 0"),
                ("sphere", "1+0j, 0+0j, 1.0, 0 -2 0"),
                ("sphere", "1+0j, 1+0j, 0.5, 3 0 0"),
                ("axes", "0 1"),
                ("lim", "4"),
                ("t", "0.25"),
                ("fmt", "png"),
            ]
        ).encode()
        resp = urllib.request.urlopen(
            urllib.request.Request(f"http://127.0.0.1:{port}/", data=data),
            timeout=300,
        ).read()
        assert b"uscat(0)" in resp, resp[-2000:]
        assert b"device: cpu:0" in resp
        assert b"base64" in resp
        # the three posted sphere rows round-trip into the form (+1 for
        # the addRow JS template literal)
        assert resp.count(b'name="sphere"') == 3 + 1

        # the reactive-push endpoint returns ONLY the result fragment
        # (no <form>), ready for in-place swapping
        frag = urllib.request.urlopen(
            urllib.request.Request(f"http://127.0.0.1:{port}/compute", data=data),
            timeout=300,
        ).read()
        assert b"uscat(0)" in frag and b"base64" in frag
        assert b"<form" not in frag and b"<html" not in frag
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_gui_compute_serialized(monkeypatch):
    """Concurrent /compute POSTs are serialized through the module lock
    and stale queued requests are dropped server-side (the reference
    serializes naturally through panel's event loop, gui.py:410-412;
    here ThreadingHTTPServer threads share one device)."""
    import threading
    import time
    import urllib.parse
    import urllib.request
    from http.server import ThreadingHTTPServer

    from biem_helmholtz_sphere_tpu import gui

    calls = {"active": 0, "max_active": 0, "n": 0, "seqs": []}
    guard = threading.Lock()

    def fake_solve(form):
        with guard:
            calls["active"] += 1
            calls["max_active"] = max(calls["max_active"], calls["active"])
            calls["n"] += 1
            calls["seqs"].append(form.get("__seq"))
        time.sleep(0.3)
        with guard:
            calls["active"] -= 1
        return "<p>uscat(0) = fake</p>", ""

    monkeypatch.setattr(gui, "_solve_and_plot", fake_solve)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), gui._Handler)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        statuses = {}

        def post(seq):
            data = urllib.parse.urlencode(
                {"__seq": str(seq), "__cid": "testcid", "n_end": "2"}
            ).encode()
            req = urllib.request.Request(f"http://127.0.0.1:{port}/compute", data=data)
            with urllib.request.urlopen(req, timeout=30) as resp:
                statuses[seq] = resp.status

        threads = []
        for seq in (1, 2, 3):
            t = threading.Thread(target=post, args=(seq,))
            t.start()
            threads.append(t)
            time.sleep(0.08)  # 1 starts solving; 2 and 3 queue behind the lock
        for t in threads:
            t.join()
        # never two solves at once
        assert calls["max_active"] == 1
        # at least one queued stale request was dropped without device work
        assert calls["n"] < 3
        assert statuses[3] == 200  # the newest request always computes
        assert 204 in statuses.values()  # a superseded one answered 204
        assert "3" in calls["seqs"]
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_sharded_sweep_and_uscat():
    from biem_helmholtz_sphere_tpu import biem, plane_wave
    from biem_helmholtz_sphere_tpu.coords import create_from_branching_types
    from biem_helmholtz_sphere_tpu.ops.cplx import to_numpy
    from biem_helmholtz_sphere_tpu.parallel import (
        make_mesh,
        sharded_sweep,
        sharded_uscat,
    )

    n_dev = len(jax.devices())
    assert n_dev >= 8, "conftest must provide 8 virtual devices"
    mesh = make_mesh(n_devices=8, axis_names=("sweep",))
    c = create_from_branching_types("ba")
    centers = jnp.asarray([[0.0, 2.0, 0.0], [0.0, -2.0, 0.0]])
    ks = jnp.asarray(np.linspace(0.8, 1.2, 16))
    u = sharded_sweep(
        c,
        centers=centers,
        radii=jnp.ones(2),
        ks=ks,
        n_end=4,
        direction=np.array([1.0, 0.0, 0.0]),
        mesh=mesh,
    )
    u_np = to_numpy(u)
    assert u_np.shape == (16,)
    # spot-check one sweep point against an unsharded solve
    uin, _ = plane_wave(
        k=ks[3], direction=jnp.asarray(np.array([1.0, 0.0, 0.0]))
    )
    calc = biem(c, centers=centers, radii=jnp.ones(2), k=ks[3], n_end=4, uin=uin)
    u3 = complex(to_numpy(calc.uscat(jnp.zeros((3, 1)))).reshape(-1)[0])
    np.testing.assert_allclose(u_np[3], u3, rtol=1e-9)

    x = np.zeros((3, 16))
    x[0] = np.linspace(3.0, 6.0, 16)
    u2 = sharded_uscat(
        calc, x, mesh=make_mesh(n_devices=8, axis_names=("points",))
    )
    ref = to_numpy(calc.uscat(jnp.asarray(x)))
    np.testing.assert_allclose(to_numpy(u2), ref, rtol=1e-9)


def test_sharded_solve_matches_unsharded():
    # Row-sharded dense system (SURVEY.md section 2.5 "shard the
    # [B*harm]^2 matrix over ICI"): same density as the single-device
    # GMRES path, with the matrix partitioned over the 8 virtual devices.
    from biem_helmholtz_sphere_tpu import biem, plane_wave
    from biem_helmholtz_sphere_tpu.coords import create_from_branching_types
    from biem_helmholtz_sphere_tpu.ops.cplx import to_numpy
    from biem_helmholtz_sphere_tpu.parallel import make_mesh, sharded_solve

    c = create_from_branching_types("ba")
    centers = jnp.asarray([[0.0, 2.0, 0.0], [0.0, -2.0, 0.0]])
    radii = jnp.ones(2)
    k = jnp.asarray(1.0)
    n_end = 4  # B*H = 2*16 = 32 rows -> 4 per device
    mesh = make_mesh(n_devices=8, axis_names=("rows",))
    dens = sharded_solve(
        c,
        centers=centers,
        radii=radii,
        k=k,
        n_end=n_end,
        direction=np.array([1.0, 0.0, 0.0]),
        mesh=mesh,
    )
    uin, _ = plane_wave(k=k, direction=jnp.asarray(np.array([1.0, 0.0, 0.0])))
    calc = biem(
        c, centers=centers, radii=radii, k=k, n_end=n_end, uin=uin,
        solver="gmres",
    )
    ref = to_numpy(calc.density)
    got = to_numpy(dens)
    np.testing.assert_allclose(got, ref, rtol=0, atol=np.abs(ref).max() * 1e-8)


def test_gmres_matches_direct():
    from biem_helmholtz_sphere_tpu import biem, plane_wave
    from biem_helmholtz_sphere_tpu.coords import create_from_branching_types
    from biem_helmholtz_sphere_tpu.ops.cplx import to_numpy

    c = create_from_branching_types("ba")
    uin, _ = plane_wave(k=np.asarray(1.0), direction=jnp.asarray([1.0, 0.0, 0.0]))
    kw = dict(
        centers=jnp.asarray([[0.0, 2.0, 0.0], [0.0, -2.0, 0.0]]),
        radii=jnp.ones(2),
        k=np.asarray(1.0),
        n_end=6,
        uin=uin,
    )
    d1 = to_numpy(biem(c, **kw, solver="direct").density)
    d2 = to_numpy(biem(c, **kw, solver="gmres").density)
    np.testing.assert_allclose(d1, d2, rtol=1e-7, atol=1e-12)
    with pytest.raises(ValueError):
        biem(c, **kw, solver="bogus")
