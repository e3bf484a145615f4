"""Float32 matmul-precision study at the bench deployment (chip_smoke.py
phase C): 16-sphere lattice, n_end=32, float32 auto policy.

For each precision setting: the per-k wall time of the warm-started
k-sweep (KB=4 blocks around k=8), the mean GMRES iterations per block,
the max relres, the sound-soft boundary residual at k=8 and the
|uscat(0)| difference from the same problem solved in complex128.
Settings are compared within one process on one device.

Usage: python tools/precision_probe.py [precision ...]
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

DEFAULT = ["high", "BF16_BF16_F32_X3", "highest"]


def main(precisions):
    import jax

    from biem_helmholtz_sphere_tpu.utils import setup_compile_cache

    setup_compile_cache()
    dev = jax.devices()[0]
    card = cs.card_info()
    print(f"device {dev.platform} {dev.device_kind}; card {card}", flush=True)
    centers = cs.lattice(cs.N_SIDE, np.float32)
    with jax.enable_x64(True):
        calc128 = cs.solve(centers.astype(np.float64), cs.K0, cs.N_END,
                           np.float64)
        u128 = cs.uscat_origin(calc128, np.float64)
    print(f"complex128 uscat(0) at k={cs.K0}: {u128:.9f}", flush=True)
    print("| precision | per-k ms | GMRES iters/block | max relres | "
          "BC residual | vs complex128 |")
    print("|---|---|---|---|---|---|")
    for p in precisions:
        with jax.default_matmul_precision(p):
            sw = cs.k_sweep(centers, cs.N_END, cs.K0, cs.KB, cs.N_BLOCKS)
            calc = cs.solve(centers, cs.K0, cs.N_END, np.float32)
            bc = cs.bc_residual(calc, centers, cs.K0, cs.BC_BALLS,
                                cs.BC_PER_BALL, np.float32)
            du = abs(cs.uscat_origin(calc, np.float32) - u128)
        print(f"| {p} | {sw['per_k_s'] * 1e3:.3f} | "
              f"{np.mean(sw['block_iters']):.2f} | {np.max(sw['relres']):.2e} "
              f"| {bc:.3e} | {du:.3e} |", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or DEFAULT)
