"""Reproduce the reference's extreme 2D k-sweep corner on CPU float64.

The reference's accuracy_k_a.csv reaches n_end=3444 at k=2896.3 (its
largest system).  This driver solves exactly the
(k, n_end) pairs the reference committed with n_end >= 2048, on this
host's CPU in complex128 with the incident plane wave at fixed k=1
(the reference sweep quirk, see cli/_accuracy.py docstring), and
appends rows in the provenance schema to accuracy/accuracy_corner_f64.csv.

Cheapest rows first so an interrupted run still leaves artifacts.
Solver: auto policy (LU up to 12288 system rows, dense GMRES at
n_end=3444 / 13774 rows).
"""

import csv
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from biem_helmholtz_sphere_tpu import biem, plane_wave  # noqa: E402
from biem_helmholtz_sphere_tpu.cli._accuracy import (  # noqa: E402
    _HEADER,
    pair_centers,
    provenance,
)
from biem_helmholtz_sphere_tpu.coords import (  # noqa: E402
    create_from_branching_types,
)
from biem_helmholtz_sphere_tpu.ops.cplx import to_numpy  # noqa: E402

# The reference's committed corner rows (accuracy_k_a.csv, n_end >= 2048),
# ordered by system size (n_end) then k; plus the n_end=1448 band at
# k >= 724 (the last six cells the bulk float32 sweep did not cover —
# round-3 cell-coverage audit, tests/test_frontends.py).
PAIRS = [
    (724.0773439350247, 1448),
    (1024.0, 1448),
    (1448.1546878700494, 1448),
    (2048.0, 1448),
    (2896.309375740099, 1448),
    (4096.0, 1448),
    (1448.1546878700494, 2048),
    (2048.0, 2048),
    (2896.309375740099, 2048),
    (2048.0, 2435),
    (2896.309375740099, 2435),
    (2048.0, 2896),
    (2896.309375740099, 2896),
    (2896.309375740099, 3444),
]


def main():
    c = create_from_branching_types("a")
    d = c.c_ndim
    centers = pair_centers(d)
    direction = np.zeros(d)
    direction[0] = 1.0

    out_dir = os.path.join(os.path.dirname(__file__), "..", "accuracy")
    path = os.path.join(out_dir, "accuracy_corner_f64.csv")
    done = set()
    # A zero-byte file left by a crashed prior run must be treated as new,
    # or rows get appended with no header.
    new = not os.path.exists(path) or os.path.getsize(path) == 0
    if not new:
        with open(path, newline="") as f:
            rd = csv.DictReader(f)
            if rd.fieldnames != _HEADER:
                raise SystemExit(
                    f"{path} has a different schema than _HEADER; "
                    "move it aside before appending"
                )
            for row in list(rd):
                done.add((float(row["k"]), int(row["n_end"])))
    with open(path, "a", newline="") as fh:
        wr = csv.writer(fh)
        if new:
            wr.writerow(_HEADER)
        uin, _ = plane_wave(
            k=jnp.asarray(1.0), direction=jnp.asarray(direction)
        )
        for k, n_end in PAIRS:
            if (k, n_end) in done:
                print(f"skip k={k} n_end={n_end} (done)", flush=True)
                continue
            t0 = time.perf_counter()
            calc = biem(
                c,
                centers=jnp.asarray(centers),
                radii=jnp.ones(2),
                k=jnp.asarray(k),
                n_end=n_end,
                uin=uin,
            )
            u0c = calc.uscat(jnp.zeros((d, 1)))
            u0c.re.block_until_ready()
            dt = time.perf_counter() - t0
            prov = provenance(calc.density, u0c)
            u0 = complex(to_numpy(u0c).reshape(-1)[0])
            assert np.isfinite(u0.real) and np.isfinite(u0.imag), (k, n_end)
            wr.writerow(
                ["a", "k", 2, k, n_end, u0.real, u0.imag, round(dt, 4),
                 "cpu:0", "float64", *prov]
            )
            fh.flush()
            print(f"k={k} n_end={n_end} -> {u0}  ({dt:.1f}s)", flush=True)


if __name__ == "__main__":
    main()
