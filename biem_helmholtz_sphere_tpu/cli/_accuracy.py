"""Convergence sweeps and error heatmaps (reference: cli.py:188-333).

Two sweep modes, covering both CSV families the reference committed
(SURVEY.md section 2.1, accuracy/):
  mode="k":       2 unit spheres at (0, +-2, 0, ...), k in 2^{0..K step 0.5}
  mode="n_balls": 2D lattice of (2 2^m)^2 spheres (reference cli._center),
                  k = 1

In mode="k" the incident plane wave is built at FIXED wavenumber
uin_k=1.0 while the solver's k is swept: the reference's accuracy
command hardcodes `plane_wave(k=xp.asarray(1.0), ...)` (reference
cli.py:238-243) and its committed accuracy_k_*.csv artifacts were
generated that way — verified by reproducing the reference's converged
k=16 value (1.0035487245+0.0910450191j) to 13 digits with uin_k=1 on
the f64 CPU path (a sweep-k incident wave instead converges to
-0.6392909+0.2608587j).  Physically this means the boundary data is a
k=1 plane wave while the scattered field propagates at the swept k;
reproducing the artifact requires matching the quirk.
with n_end in unique(int(2^{0..N step 0.25})), NaN guards that raise, a
CSV row appended per iteration (incremental checkpointing, SURVEY.md
section 5), and per-iteration try/except-log-continue so OOM/overflow at
extreme parameters does not kill the sweep (reference cli.py:269-271).
"""

import csv
import logging
import os
import time

import numpy as np

log = logging.getLogger(__name__)


def lattice_centers(n_side, d, spacing=4.0):
    """2D square lattice in the (x0, x1) plane (reference cli.py:170-185)."""
    g = (np.arange(n_side) - (n_side - 1) / 2) * spacing
    xx, yy = np.meshgrid(g, g)
    centers = np.zeros((n_side * n_side, d))
    centers[:, 0] = xx.ravel()
    centers[:, 1] = yy.ravel()
    return centers


def pair_centers(d):
    centers = np.zeros((2, d))
    centers[0, 1] = 2.0
    centers[1, 1] = -2.0
    return centers


def _cplx_name(real_dtype):
    return {"float32": "complex64", "float64": "complex128"}.get(
        str(real_dtype), str(real_dtype)
    )


def _dev_name(arr):
    """Provenance device string for a JAX array, e.g. 'cpu:0' / 'gpu:0'."""
    try:
        d = next(iter(arr.devices()))
        return f"{d.platform}:{d.id}"
    except Exception:
        return "unknown"


def provenance(density_c, uscat_c):
    """(density_dtype, density_device, uscat_dtype, uscat_device) columns
    matching the reference sweep CSVs (reference cli.py:57-59,208-211)."""
    return (
        _cplx_name(density_c.re.dtype),
        _dev_name(density_c.re),
        _cplx_name(uscat_c.re.dtype),
        _dev_name(uscat_c.re),
    )


_HEADER = [
    "branching_types",
    "mode",
    "n_balls",
    "k",
    "n_end",
    "uscat_real",
    "uscat_imag",
    "seconds",
    "device",
    "dtype",
    "density_dtype",
    "density_device",
    "uscat_dtype",
    "uscat_device",
    # iterative-solver convergence diagnostics (round 4): per-system
    # relres / Krylov-steps-to-convergence.  Direct/LU rows (exact to
    # rounding) carry the explicit marker "exact"; rows written before
    # round 5 used an empty cell for the same meaning.
    "solve_relres",
    "solve_iters",
]


def _open_sweep_csv(path):
    """Open the sweep CSV for append, migrating any pre-provenance file
    out of the way (rows must align with the current header).  A file
    whose header is a strict PREFIX of the current one (columns were
    appended since) is upgraded in place: old rows get empty cells for
    the new columns, so committed artifact rows survive schema growth."""
    if os.path.exists(path):
        with open(path, newline="") as fh:
            first = fh.readline().strip()
        if first != ",".join(_HEADER) and first.split(",") == _HEADER[
            : len(first.split(","))
        ]:
            pad = len(_HEADER) - len(first.split(","))
            with open(path, newline="") as fh:
                rows = list(csv.reader(fh))
            with open(path, "w", newline="") as fh:
                w = csv.writer(fh)
                w.writerow(_HEADER)
                for r in rows[1:]:
                    w.writerow(r + [""] * pad)
            log.info("upgraded %s schema in place (+%d columns)", path, pad)
            first = ",".join(_HEADER)
        if first != ",".join(_HEADER):
            base, ext = os.path.splitext(path)
            n = 0
            while os.path.exists(f"{base}_legacy{n}{ext}"):
                n += 1
            os.rename(path, f"{base}_legacy{n}{ext}")
            log.info("migrated old-schema %s to %s_legacy%d%s", path, base, n, ext)
    new = not os.path.exists(path)
    fh = open(path, "a", newline="")
    wr = csv.writer(fh)
    if new:
        wr.writerow(_HEADER)
    return fh, wr


def _n_end_grid(n_end_max_log2, n_end_min_log2=0.0):
    vals = sorted(
        {
            int(2.0**e)
            for e in np.arange(
                max(n_end_min_log2, 0.0), n_end_max_log2 + 1e-9, 0.25
            )
        }
    )
    return [v for v in vals if v >= 1]


def run_accuracy(
    out_dir,
    branching_types=("a", "ba"),
    mode="k",
    k_max_log2=6.0,
    n_end_max_log2=7.0,
    n_balls_max_log4=3,
    k_block=1,
    k_min_log2=0.0,
    n_end_min_log2=0.0,
    n_balls_min_log4=0,
    n_end_linear=0,
):
    import jax.numpy as jnp

    from ..biem import biem, plane_wave
    from ..coords import create_from_branching_types
    from ..ops.cplx import to_numpy

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "accuracy.csv")
    fh, wr = _open_sweep_csv(path)
    with fh:
        import jax

        in_dtype = "float64" if jax.config.jax_enable_x64 else "float32"
        host_dev = f"{jax.devices()[0].platform}:{jax.devices()[0].id}"

        def make_step(c, centers, n_end, direction, uin_k=None):
            """One jitted k -> (density, uscat(0)) program per shape.

            The k sweep reuses ONE compiled program for every k value at
            a given (geometry, n_end) — eager per-op dispatch made each
            row cost tens of seconds regardless of problem size.
            """
            d = c.c_ndim
            # HOST numpy closures: the geometry is concrete at trace
            # time, which the offset dedup and matrix-free routes need.
            centers_j = np.asarray(centers)
            radii_j = np.ones(len(centers))
            dir_j = np.asarray(direction)

            def fn(k):
                # batch-rank agreement: centers/radii/direction carry the
                # k batch.  Broadcast with NUMPY (k.shape is static at
                # trace time) — jnp.broadcast_to would make the geometry
                # a tracer and kill the trace-time concreteness
                # optimizations (offset dedup, block-gather assembly).
                nb = len(centers_j)
                dir_b = np.broadcast_to(
                    dir_j.reshape((d,) + (1,) * k.ndim), (d,) + k.shape
                )
                # mode="k" passes uin_k=1.0: the reference's sweep builds
                # the incident wave at k=1 regardless of the solver's k
                # (reference cli.py:238-243; see module docstring).
                uin, _ = plane_wave(
                    k=k if uin_k is None else jnp.full(k.shape, uin_k, k.dtype),
                    direction=dir_b,
                )
                calc = biem(
                    c,
                    centers=np.broadcast_to(centers_j, k.shape + (nb, d)),
                    radii=np.broadcast_to(radii_j, k.shape + (nb,)),
                    k=k,
                    n_end=n_end,
                    uin=uin,
                )
                return (
                    calc.density,
                    calc.uscat(jnp.zeros((d, 1))),
                    calc.relres,
                    calc.iters,
                )

            return jax.jit(fn)

        def run_block(btype, mode_, step, ks, n_balls, n_end):
            """Solve a block of k values in ONE batched call (leading k
            axis broadcasts through assembly/solve/eval; the batched
            GMRES iterates each system independently) and write one CSV
            row per k.  Per-row wall time is the block time / block size.
            """
            t0 = time.perf_counter()
            try:
                if len(ks) == 1:
                    dens_c, u0c, rr_c, it_c = step(jnp.asarray(float(ks[0])))
                else:
                    dens_c, u0c, rr_c, it_c = step(
                        jnp.asarray(np.asarray(ks, np.float64))
                    )
                prov = provenance(dens_c, u0c)
                rr = (
                    None
                    if rr_c is None
                    else np.broadcast_to(np.asarray(rr_c), (len(ks),))
                )
                it_n = (
                    None
                    if it_c is None
                    else np.broadcast_to(np.asarray(it_c), (len(ks),))
                )
                dens = to_numpy(dens_c)
                u0s = to_numpy(u0c).reshape(len(ks), -1)[:, 0] if len(
                    ks
                ) > 1 else to_numpy(u0c).reshape(1, -1)[:, 0]
                per_k = round((time.perf_counter() - t0) / len(ks), 4)
            except Exception as e:
                # log and continue: one failed block must not end the sweep
                for k in ks:
                    log.warning(
                        "accuracy %s B=%d k=%g n_end=%d failed: %s",
                        btype,
                        n_balls,
                        k,
                        n_end,
                        e,
                    )
                return
            dens = dens.reshape(len(ks), -1)
            for i, k in enumerate(ks):
                try:
                    if np.any(np.isnan(dens[i])):
                        raise ValueError("density contains NaN")
                    u0 = complex(u0s[i])
                    if np.isnan(u0.real) or np.isnan(u0.imag):
                        raise ValueError("uscat contains NaN")
                    wr.writerow(
                        [
                            btype,
                            mode_,
                            n_balls,
                            k,
                            n_end,
                            u0.real,
                            u0.imag,
                            per_k,
                            host_dev,
                            in_dtype,
                            *prov,
                            "exact" if rr is None else f"{float(rr[i]):.3e}",
                            "exact" if it_n is None else int(it_n[i]),
                        ]
                    )
                    fh.flush()
                    log.debug(
                        "%s B=%d k=%g n_end=%d -> %s", btype, n_balls, k, n_end, u0
                    )
                except Exception as e:
                    log.warning(
                        "accuracy %s B=%d k=%g n_end=%d failed: %s",
                        btype,
                        n_balls,
                        k,
                        n_end,
                        e,
                    )

        try:
            from tqdm import tqdm
        except Exception:  # pragma: no cover
            tqdm = lambda it, **kw: it  # noqa: E731

        for btype in branching_types:
            c = create_from_branching_types(btype)
            d = c.c_ndim
            direction = np.zeros(d)
            direction[0] = 1.0
            if mode == "k":
                centers = pair_centers(d)
                kvals = [
                    2.0**e
                    for e in np.arange(k_min_log2, k_max_log2 + 1e-9, 0.5)
                ]
                # the reference's ba artifact sweeps n_end densely
                # (accuracy_k_ba.csv: 1..39 step 1); its a artifact uses
                # the log2 grid (accuracy_k_a.csv)
                n_end_vals = (
                    list(range(1, n_end_linear + 1))
                    if n_end_linear
                    else _n_end_grid(n_end_max_log2, n_end_min_log2)
                )
                for n_end in tqdm(n_end_vals, desc=f"{btype} k-sweep"):
                    try:
                        step = make_step(c, centers, n_end, direction, uin_k=1.0)
                    except Exception as e:  # pragma: no cover
                        log.warning("compile n_end=%d failed: %s", n_end, e)
                        continue
                    blk = max(1, int(k_block))
                    for i0 in range(0, len(kvals), blk):
                        run_block(
                            btype, mode, step, kvals[i0 : i0 + blk], 2, n_end
                        )
            else:
                lattices = [
                    lattice_centers(2 * 2**m, d)
                    for m in range(n_balls_min_log4, n_balls_max_log4 + 1)
                ]
                for centers in tqdm(lattices, desc=f"{btype} n_balls-sweep"):
                    for n_end in _n_end_grid(n_end_max_log2, n_end_min_log2):
                        try:
                            step = make_step(c, centers, n_end, direction)
                        except Exception as e:  # pragma: no cover
                            log.warning("compile failed: %s", e)
                            continue
                        run_block(btype, mode, step, [1.0], len(centers), n_end)
    log.info("appended to %s", path)
    return path


def plot_accuracy(out_dir):
    """Error heatmaps: ground truth per sweep key = highest-n_end non-NaN
    row (reference cli.py:306-309); |uscat - truth| heatmap per branching
    type -> accuracy_heatmap_{mode}_{btype}.jpg."""
    import glob

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import pandas as pd
    from matplotlib.colors import LogNorm

    frames = [
        pd.read_csv(f) for f in glob.glob(os.path.join(out_dir, "accuracy*.csv"))
    ]
    if not frames:
        raise FileNotFoundError(f"no accuracy CSVs in {out_dir}")
    df = pd.concat(frames, ignore_index=True)
    df["uscat"] = df["uscat_real"] + 1j * df["uscat_imag"]
    # where the same sweep point exists at several precisions (a float32
    # bulk sweep overlaps the CPU float64 extreme-corner rows), keep the
    # highest-precision row
    if "dtype" in df.columns:
        rank = df["dtype"].map({"float64": 0, "float32": 1}).fillna(2)
        df = (
            df.assign(_rank=rank)
            # descending rank + stable sort puts the highest-precision
            # rows last in file/row order, so keep="last" selects the
            # LATEST highest-precision row deterministically — a re-run
            # sweep row supersedes older rows of the same precision
            # (the default quicksort made the survivor arbitrary)
            .sort_values("_rank", ascending=False, kind="stable")
            .drop_duplicates(
                subset=["branching_types", "mode", "n_balls", "k", "n_end"],
                keep="last",
            )
            .drop(columns="_rank")
        )
    out = []
    for (btype, mode), grp in df.groupby(["branching_types", "mode"]):
        key = "k" if mode == "k" else "n_balls"
        rows = []
        for kv, sub in grp.groupby(key):
            sub = sub.dropna(subset=["uscat_real"])
            truth = sub.loc[sub["n_end"].idxmax(), "uscat"]
            for _, r in sub.iterrows():
                rows.append((kv, r["n_end"], abs(r["uscat"] - truth)))
        piv = (
            pd.DataFrame(rows, columns=[key, "n_end", "err"])
            .pivot_table(index="n_end", columns=key, values="err")
            .sort_index(ascending=False)
        )
        fig, ax = plt.subplots(figsize=(6, 4.5))
        vals = piv.values
        vmin = max(np.nanmin(vals[vals > 0]) if (vals > 0).any() else 1e-16, 1e-16)
        im = ax.imshow(
            np.maximum(vals, vmin / 10),
            aspect="auto",
            norm=LogNorm(vmin=vmin, vmax=max(np.nanmax(vals), vmin * 10)),
            cmap="viridis",
        )
        ax.set_xticks(range(len(piv.columns)))
        ax.set_xticklabels([f"{v:g}" for v in piv.columns], rotation=90, fontsize=6)
        ax.set_yticks(range(len(piv.index)))
        ax.set_yticklabels([f"{v:g}" for v in piv.index], fontsize=6)
        ax.set_xlabel(key)
        ax.set_ylabel("n_end")
        ax.set_title(f"|uscat - truth|  ({btype}, {mode}-sweep)")
        fig.colorbar(im, ax=ax)
        path = os.path.join(out_dir, f"accuracy_heatmap_{mode}_{btype}.jpg")
        fig.savefig(path, dpi=160, bbox_inches="tight")
        plt.close(fig)
        out.append(path)
        log.info("wrote %s", path)
    return out
