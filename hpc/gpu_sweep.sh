#!/bin/sh
# Single-host GPU sweep job (the analogue of the reference's
# hpc/miyabi.sh / hpc/tsubame.sh PBS/UGE single-node scripts: each job is
# an independent parameter sweep; multi-host sweeps are embarrassingly
# parallel across jobs).
#
# One process per card: the three sweeps below are spread over the cards
# named in GPUS (default: 0), each pinned with CUDA_VISIBLE_DEVICES, and a
# card takes its next sweep only when the previous one has ended.  Each
# sweep writes its own CSV directory under OUT (default: accuracy/sweeps).
# The compile cache is JAX_COMPILATION_CACHE_DIR if set, else .jax_cache/.
set -eu
cd "$(dirname "$0")/.."
GPUS="${GPUS:-0}"
OUT="${OUT:-accuracy/sweeps}"
export JAX_COMPILATION_CACHE_DIR="${JAX_COMPILATION_CACHE_DIR:-$PWD/.jax_cache}"

sweep() {  # name, accuracy arguments...
    name=$1
    shift
    python -m biem_helmholtz_sphere_tpu -v accuracy --out-dir "$OUT/$name" "$@"
    python -m biem_helmholtz_sphere_tpu plot-accuracy --out-dir "$OUT/$name"
}

set -- \
    "k_a|--mode k --branching-types a --k-max-log2 ${K_MAX_LOG2:-6} --n-end-max-log2 ${N_END_MAX_LOG2:-7}" \
    "k_ba|--mode k --branching-types ba --k-max-log2 ${K_MAX_LOG2:-6} --n-end-max-log2 ${N_END_MAX_LOG2:-7}" \
    "n_balls_a|--mode n_balls --branching-types a --n-balls-max-log4 ${N_BALLS_MAX_LOG4:-3}"
while [ $# -gt 0 ]; do
    for gpu in $GPUS; do
        [ $# -gt 0 ] || break
        name=${1%%|*}
        args=${1#*|}
        # shellcheck disable=SC2086  # args is a word list
        CUDA_VISIBLE_DEVICES=$gpu sweep "$name" $args &
        shift
    done
    wait
done
