"""North-star benchmark (BASELINE.json): BIE assembly+solve per k-point at
n_balls=16, n_end=32 (3D), plus uscat field-evaluation throughput, on one
GPU in complex64 (real-pair representation).  The auto solver policy
routes this config to the scale-compensated unique-offset matrix-free
GMRES (each Krylov step reads the [NO, H, H] offset blocks, NO/B^2 of
the dense matrix's bytes, and the B^2 H^2 matrix is never written).

Headline number: per-k-point wall time over a 100-point k sweep solved in
k-blocks of KB (one compiled program, leading batch axis), which is how
sweeps actually run (`accuracy --k-block`).  Also reported: per-k with
one dispatch per k, sweep bit-reproducibility (north star:
"bitwise-stable across a 100-point k sweep"), and two baselines:

  * vs_baseline — same-algorithm NumPy/SciPy on a host CPU
    (tools/baseline_numpy.py; measured in tools/baseline_32.log).  NOTE:
    the NumPy translation stage uses the banded method, asymptotically
    worse than the rotation+coaxial path here — this ratio mixes
    algorithm and hardware gains.
  * vs_jax_cpu — the SAME code on a host CPU via JAX (measured in
    tools/jax_cpu_32.log), the hardware-only ratio.

Fails unless the first JAX device is a GPU whose device_kind is in
PEAKS.  Prints the device and the card's power limit, then ONE JSON
line: {"metric", "value", "unit", "vs_baseline", ...}.
"""

import json
import os
import re
import subprocess
import time

import numpy as np

N_END = 32
N_SIDE = 4  # 4x4 lattice -> 16 balls
SPACING = 4.0
K0 = 8.0
N_K = 3  # timed k-points for the single-dispatch comparison number
SWEEP_N = 100  # k-points in the blocked sweep (the headline)
# k-block size.  The auto policy routes this config to the unique-offset
# matfree GMRES: no [KB,16384,16384] dense temporaries exist.  KB=4 was
# sized for a 16 GB device and is not re-tuned for the H100 yet.
KB = int(os.environ.get("BENCH_KB", "4"))
EVAL_POINTS = 1 << 17
# larger chunks mean fewer lax.map trips
EVAL_CHUNK = 16384

# Conservative extrapolation of the measured NumPy baseline to n_end=32:
# translation 632.7 s x (32/20)^3.45 + solve 47 s x (32/20)^6 +
# assembly ~ 2 s x (32/20)^4.
BASELINE_SECONDS_PER_K_FALLBACK = 3995.0

# Published peaks of one card, keyed by JAX's device_kind (NVIDIA H100
# SXM data sheet, dense rates without sparsity, at the full 700 W power
# limit).  "flops" is the matmul rate for float32 operands under each
# matmul-precision setting the runtime can pin: TF32 tensor cores for
# "high"/"tensorfloat32", three bf16 passes for "BF16_BF16_F32_X3" (a
# third of the bf16 rate), plain float32 for "highest".  An unknown
# device or precision is an error, not a default.
_H100_SXM = {
    "flops": {
        "high": 495e12,
        "tensorfloat32": 495e12,
        "BF16_BF16_F32_X3": 989e12 / 3,
        "highest": 67e12,
        "float32": 67e12,
    },
    "bytes_per_s": 3.35e12,
}
PEAKS = {"NVIDIA H100 80GB HBM3": _H100_SXM}


def peaks(device_kind, precision):
    """(peak matmul FLOP/s at `precision`, peak bytes/s) of one card."""
    if device_kind not in PEAKS:
        raise ValueError(
            f"no published peaks for device {device_kind!r}; known: "
            f"{sorted(PEAKS)}"
        )
    table = PEAKS[device_kind]
    if precision not in table["flops"]:
        raise ValueError(
            f"no peak for matmul precision {precision!r} on {device_kind!r}"
        )
    return table["flops"][precision], table["bytes_per_s"]


def power_limit():
    """nvidia-smi's `name, power.limit` line(s)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def _log_seconds(name, pattern, fallback=None):
    log = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools", name)
    try:
        m = re.search(pattern, open(log).read())
        if m:
            return float(m.group(1)), "measured"
    except OSError:
        pass
    return fallback, "extrapolated" if fallback else "missing"


def lattice_centers(n_side, spacing, d=3):
    g = (np.arange(n_side) - (n_side - 1) / 2) * spacing
    xx, yy = np.meshgrid(g, g)
    centers = np.zeros((n_side * n_side, d))
    centers[:, 0] = xx.ravel()
    centers[:, 1] = yy.ravel()
    return centers


def main():
    import jax

    from biem_helmholtz_sphere_tpu.utils import (
        F32_MATMUL_PRECISION,
        setup_runtime,
    )

    setup_runtime()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {dev.platform!r}")
    peak_flops, peak_bw = peaks(dev.device_kind, F32_MATMUL_PRECISION)
    print(
        f"device: platform={dev.platform} kind={dev.device_kind} "
        f"count={len(jax.devices())}; card: {power_limit()}",
        flush=True,
    )

    import jax.numpy as jnp

    from biem_helmholtz_sphere_tpu import biem, plane_wave
    from biem_helmholtz_sphere_tpu.coords import create_from_branching_types

    c = create_from_branching_types("ba")
    # Closed-over geometry as HOST numpy: concrete at trace time, so the
    # offset dedup and the matrix-free routes apply.
    centers = lattice_centers(N_SIDE, SPACING).astype(np.float32)
    radii = np.ones(N_SIDE * N_SIDE, dtype=np.float32)
    direction = np.array([1.0, 0.0, 0.0], dtype=np.float32)
    nb = len(centers)

    def solve_step(k):
        uin, _ = plane_wave(k=k, direction=direction)
        calc = biem(c, centers=centers, radii=radii, k=k, n_end=N_END, uin=uin)
        return calc.density

    solve_jit = jax.jit(solve_step)

    # Batched geometry must stay HOST numpy: jnp.broadcast_to would turn
    # centers into a tracer under jit and silently disable every
    # trace-time concreteness optimization (offset dedup, block-gather),
    # tripling the assembly cost.
    centers_b = np.broadcast_to(centers, (KB, nb, 3))
    radii_b = np.broadcast_to(radii, (KB, nb))
    dir_b = np.broadcast_to(direction[:, None], (3, KB))

    def block_step(k, dens0):
        # k: [KB] leading batch axis broadcast through assembly/solve/eval.
        # dens0: [B, H] warm start — the previous block's last density
        # cuts GMRES iterations several-fold across a smooth k sweep
        # (zeros = cold start for the first block; the solver tolerance
        # is measured against the CURRENT rhs either way).
        uin, _ = plane_wave(k=k, direction=dir_b)
        calc = biem(
            c,
            centers=centers_b,
            radii=radii_b,
            k=k,
            n_end=N_END,
            uin=uin,
            density0=dens0,
        )
        u0 = calc.uscat(jnp.zeros((3, 1)))
        return (
            u0.re.reshape(KB), u0.im.reshape(KB), calc.density[KB - 1],
            calc.iters,
        )

    block_jit = jax.jit(block_step)

    from biem_helmholtz_sphere_tpu.harmonics._index import basis
    from biem_helmholtz_sphere_tpu.ops.cplx import C

    h_num = basis(c, N_END).num
    dens_zero = C.zeros((nb, h_num), dtype=np.float32)

    # compile (excluded from timing; persistent-cached across runs).  A
    # NaN solve exits GMRES early and looks fast, so check it.
    warm = solve_jit(jnp.float32(K0))
    if not np.all(np.isfinite(np.asarray(warm.re))):
        raise RuntimeError("warmup solve produced non-finite density")
    kwarm = np.linspace(K0 - 0.5, K0 - 0.4, KB).astype(np.float32)
    block_jit(jnp.asarray(kwarm), dens_zero)[0].block_until_ready()

    # (a) single dispatch per k (round-1 methodology, kept for comparison)
    ks = np.linspace(K0 - 0.25, K0 + 0.25, N_K).astype(np.float32)
    t0 = time.perf_counter()
    for kk in ks:
        solve_jit(jnp.float32(kk)).block_until_ready()
    per_k_single = (time.perf_counter() - t0) / N_K

    # (b) 100-point k sweep in KB-blocks: the headline.  Enqueue all
    # blocks, then block on each output.
    def run_sweep():
        ksweep = np.linspace(K0 - 1.0, K0 + 1.0, SWEEP_N).astype(np.float32)
        outs = []
        iters_l = []
        dens = dens_zero
        t0 = time.perf_counter()
        for i0 in range(0, SWEEP_N, KB):
            # the warm-start chain is a device-to-device dependency:
            # blocks still ENQUEUE without host sync, so dispatch stays
            # pipelined; only the final block_until_ready fetches.
            re_, im_, dens, its = block_jit(
                jnp.asarray(ksweep[i0 : i0 + KB]), dens
            )
            outs.append((re_, im_))
            iters_l.append(its)
        for re_, im_ in outs:
            re_.block_until_ready()
            im_.block_until_ready()
        dt = time.perf_counter() - t0
        vals = np.concatenate(
            [np.asarray(re_) + 1j * np.asarray(im_) for re_, im_ in outs]
        )
        # iters is PER-SYSTEM (cplx.gmres_solve_op): the matvec cost a
        # k-block pays is its max (systems iterate together); the
        # mean-of-maxes is the cost model's iteration count.
        iters_mean = float(np.mean([np.max(np.asarray(i)) for i in iters_l]))
        return dt / SWEEP_N, vals, iters_mean

    per_k_sweep, vals1, iters_mean = run_sweep()
    _, vals2, _ = run_sweep()
    bitwise_stable = bool(
        np.array_equal(vals1.view(np.float32), vals2.view(np.float32))
    )
    if not np.all(np.isfinite(vals1)):
        raise RuntimeError("sweep produced non-finite uscat")

    # field-evaluation throughput (chunked to bound [chunk, B, H] memory)
    uin, _ = plane_wave(k=jnp.float32(K0), direction=direction)
    calc = biem(
        c, centers=centers, radii=radii, k=jnp.float32(K0), n_end=N_END, uin=uin
    )

    def eval_chunked(calc_, x):
        xs = x.reshape(3, -1, EVAL_CHUNK)
        xs = jnp.moveaxis(xs, 1, 0)  # [nchunk, 3, chunk]
        return jax.lax.map(lambda xc: calc_.uscat(xc), xs)

    eval_jit = jax.jit(eval_chunked)
    rng = np.random.default_rng(0)
    # upload the point cloud once, outside the timed region
    x = jnp.asarray(rng.normal(size=(3, EVAL_POINTS)).astype(np.float32) * 20.0)
    eval_jit(calc, x).block_until_ready()  # compile
    dt_best = np.inf
    for _ in range(5):
        t0 = time.perf_counter()
        eval_jit(calc, x).block_until_ready()
        dt_best = min(dt_best, time.perf_counter() - t0)
    pts_per_s = EVAL_POINTS / dt_best

    # ---- stage-resolved solve timings: block_until_ready wall time of
    # each stage of the blocked solve step, so the utilization model
    # below can say WHERE the per-k time goes.
    #   rhs      — analytic plane-wave boundary-data expansion
    #   build    — (S|R) table construction (rotation+coaxial sandwich)
    #   matvec   — one application of the unique-offset lane operator,
    #              isolated as the slope of an N-application chain
    #              (T(9) - T(1)) / 8, which cancels build+overhead
    #   ortho    — per-Krylov-step CGS2+rotation cost, measured by
    #              running the same GMRES kernel on a cheap diagonal
    #              operator for a full 48-step cycle
    # Totals are per k-point (block time / KB); the unattributed
    # remainder (dispatch, warm-start plumbing, uscat(0), convergence
    # checks) is reported as stage_other_s.
    from biem_helmholtz_sphere_tpu.biem._core import (
        _check_biem_inputs,
        _matfree_operator,
        _rhs_dispatch,
    )
    from biem_helmholtz_sphere_tpu.ops import cplx

    def rhs_step(k):
        cen, rad, kc, eta_c, al, be = _check_biem_inputs(
            c, centers_b, radii_b, k, None, 1.0, 0.0
        )
        uin_b, _ = plane_wave(k=k, direction=dir_b)
        f = _rhs_dispatch(c, N_END, cen, rad, al, be, uin_b, None, 1)
        return f.re

    def make_mv_chain(n_apply):
        def f(k, x):
            cen, rad, kc, eta_c, al, be = _check_biem_inputs(
                c, centers_b, radii_b, k, None, 1.0, 0.0
            )
            mv, diag = _matfree_operator(
                c, N_END, centers, rad, kc, eta_c, al, be, None, stable=True
            )

            def body(i, xc):
                y = mv(xc)
                # renormalize so a 9-deep chain cannot overflow f32
                s = 1.0 / jnp.sqrt(y.abs2().mean(-1, keepdims=True) + 1e-30)
                return y * s

            return jax.lax.fori_loop(0, n_apply, body, x).re

        return f

    def cheap_gmres(b):
        ones = C.of(jnp.ones((nb * h_num,), jnp.float32))

        def mv(x):
            return x * 0.5

        # tol unreachable -> all 48 steps of one cycle run; the cheap
        # matvec is negligible, so this times CGS2+Givens per step
        return cplx.gmres_solve_op(
            mv, ones, b, tol=1e-30, restart=48, maxiter=1
        ).re

    def _time_jit(fn, *args, reps=3):
        out = fn(*args)
        jax.block_until_ready(out)
        best = np.inf
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*args))
            best = min(best, time.perf_counter() - t0)
        return best

    kb_k = jnp.asarray(np.linspace(K0 - 0.1, K0 + 0.1, KB).astype(np.float32))
    x_probe = C.of(
        jnp.asarray(
            rng.normal(size=(KB, nb * h_num)).astype(np.float32)
        )
    )
    b_probe = C.of(
        jnp.asarray(
            rng.normal(size=(KB, nb * h_num)).astype(np.float32)
        )
    )
    t_rhs = _time_jit(jax.jit(rhs_step), kb_k)
    t_mv1 = _time_jit(jax.jit(make_mv_chain(1)), kb_k, x_probe)
    t_mv9 = _time_jit(jax.jit(make_mv_chain(9)), kb_k, x_probe)
    t_gm48 = _time_jit(jax.jit(cheap_gmres), b_probe)
    t_rhs_c = t_rhs
    stage_matvec_1 = max((t_mv9 - t_mv1) / 8.0, 0.0)
    stage_build = max(t_mv1 - stage_matvec_1, 0.0)
    stage_ortho_1 = t_gm48 / 48.0

    # ---- utilization model: analytic FLOPs/bytes of the measured work
    # against the card's published peaks (PEAKS, at the pinned float32
    # matmul precision), so the speedup ratios below can be
    # sanity-checked against hardware limits.  Convention: 1 complex
    # MAC = 8 real flops (algorithmic count — the Karatsuba 3-mult split
    # changes the mult/add mix, not the model).
    from biem_helmholtz_sphere_tpu.biem._core import _pair_routing

    uniq_s, _, _, p_max, uniq_r, g_max = _pair_routing(
        centers.astype(np.float64), radius_slots=True
    )
    no_slots = len(uniq_s)
    n_rad = len(uniq_r)
    h = h_num  # 1024 at n_end=32, d=3
    n_sys = nb * h
    # per-k-point solve flops (FACTORED operator, round 5 — SR is never
    # materialized: SR = D X D^H with D k-independent):
    #   build (k-dep): the coax group combination — NG passes of the
    #     [.., G] x [G, H, H] band contraction at NR distinct radii —
    #     plus the degree-level fold expansion E exp(.) E^T
    #   build (k-indep, amortized over the KB block): the D quadrature,
    #     degree-grouped (H * sum(g^2) MACs per slot direction)
    #   matvec x iters: three lane contractions per offset slot —
    #     D^H [NO', H, H] x lanes, folded-coax [NR, H, H] x regrouped
    #     lanes, D x lanes — + routing one-hots + CGS2 ortho
    from biem_helmholtz_sphere_tpu.translation._rotation import (
        _degree_groups,
    )

    sg2 = sum((e - s) ** 2 for s, e in _degree_groups(c, N_END))
    n_bands = 2 * N_END - 1
    q_rot = 2 * N_END * (2 * N_END - 1)  # rotation quadrature points
    build_flops = (
        n_rad * n_bands * 8 * h * h  # coax band contraction
        + n_rad * 8 * (N_END**2 * h + h * h * N_END)  # fold E-expansion
        + no_slots * 8 * q_rot * sg2 / KB  # D quadrature, per-k share
    )
    matvec_flops = (
        8 * (2 * no_slots + n_rad * g_max) * 2 * p_max * h * h
        + 2 * 8 * (2 * no_slots * p_max) * 2 * nb * h
    )
    ortho_flops = 4 * 8 * 49 * n_sys  # 2 CGS2 passes x (dot + axpy), m = 48
    solve_flops = build_flops + iters_mean * (matvec_flops + ortho_flops)
    # per-k-point solve bytes: every iteration re-reads the folded coax
    # [NR, H, H] per k plus the k-SHARED rotation tables [NO', H, H]
    # (2 real f32 halves each)
    table_bytes = 2 * 4 * n_rad * h * h + 2 * 4 * no_slots * h * h / KB
    solve_bytes = (1 + iters_mean) * table_bytes
    solve_mfu = solve_flops / per_k_sweep / peak_flops
    solve_hbm = solve_bytes / per_k_sweep / peak_bw
    # eval: per point, per ball — M = 2n-1 order slots x n degree steps
    # of the fused Jacobi recurrence (~14 flops: 3-term update + C
    # contribution accumulate), the radial h_l(kr) upward recurrence
    # (~12 flops/degree), and the M-slot epilogue (azimuthal phase +
    # sin^|m| + reduce, ~10); bytes = the [B, n] C radial table written
    # + re-read once (the recurrence carries are assumed to stay
    # on chip).
    m_slots = 2 * N_END - 1
    eval_flops_pt = nb * (m_slots * N_END * 14 + N_END * 12 + m_slots * 10)
    eval_bytes_pt = 2 * nb * N_END * 8
    eval_mfu = eval_flops_pt * pts_per_s / peak_flops
    eval_hbm = eval_bytes_pt * pts_per_s / peak_bw

    baseline, kind = _log_seconds(
        "baseline_32.log",
        r"n_end=32 B=16: total ([0-9.]+)s",
        BASELINE_SECONDS_PER_K_FALLBACK,
    )
    jax_cpu, jax_cpu_kind = _log_seconds(
        "jax_cpu_32.log", r"per-k ([0-9.]+)s"
    )
    out = {
        "metric": (
            "BIE assembly+solve+uscat(0) per k-point over a 100-point "
            f"k sweep (k-block={KB}), 16 balls, n_end=32, 3D, complex64 "
            f"on one {dev.device_kind} (uscat eval {pts_per_s:.3e} pts/s; "
            "vs_baseline: same-algorithm NumPy/SciPy on host CPU, "
            "banded translation — mixes algorithm+hardware gains; "
            "vs_jax_cpu: same code via JAX on host CPU)"
        ),
        "value": round(per_k_sweep, 4),
        "unit": "s",
        "vs_baseline": round(baseline / per_k_sweep, 1),
        "per_k_single_dispatch": round(per_k_single, 4),
        "sweep_bitwise_stable": bitwise_stable,
        "baseline_kind": kind,
        "eval_pts_per_s": round(pts_per_s, 1),
        # utilization (modeled flops/bytes vs PEAKS; see comments)
        "mfu": round(solve_mfu, 4),
        "hbm_util": round(solve_hbm, 4),
        "gmres_iters_per_k": round(iters_mean, 1),
        "eval_mfu": round(eval_mfu, 4),
        "eval_hbm_util": round(eval_hbm, 4),
        # measured per-k stage split (see stage probe comments above);
        # stage_other_s = headline minus attributed stages (dispatch,
        # warm-start plumbing, uscat(0), convergence checks)
        "stage_rhs_s": round(t_rhs_c / KB, 5),
        "stage_build_s": round(stage_build / KB, 5),
        "stage_matvec_s": round(iters_mean * stage_matvec_1 / KB, 5),
        "stage_ortho_s": round(iters_mean * stage_ortho_1 / KB, 5),
        "stage_other_s": round(
            per_k_sweep
            - (
                t_rhs_c
                + stage_build
                + iters_mean * (stage_matvec_1 + stage_ortho_1)
            )
            / KB,
            5,
        ),
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
        "matmul_precision": F32_MATMUL_PRECISION,
    }
    if jax_cpu is not None:
        out["vs_jax_cpu"] = round(jax_cpu / per_k_sweep, 1)
        out["jax_cpu_kind"] = jax_cpu_kind
    print(json.dumps(out))


if __name__ == "__main__":
    main()
