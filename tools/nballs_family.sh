#!/bin/sh
# Regenerate the reference's accuracy_n_balls_a.csv family at full depth:
# n_balls {4,16,64} to n_end=90 (2^6.5) and 256 to n_end=53 (2^5.75),
# CPU float64, GMRES tol 1e-13 for the >=64-ball FFT-matfree rows
# (~10-digit parity; forward error is kappa*resid).  Appends to
# accuracy/accuracy.csv.
set -x
cd "$(dirname "$0")/.." || exit 1
export PYTHONPATH="$PWD"
export BHS_GMRES_TOL=1e-13
python -m biem_helmholtz_sphere_tpu accuracy --device cpu --dtype float64 \
  --mode n_balls --branching-types a \
  --n-balls-min-log4 0 --n-balls-max-log4 2 --n-end-max-log2 6.5
python -m biem_helmholtz_sphere_tpu accuracy --device cpu --dtype float64 \
  --mode n_balls --branching-types a \
  --n-balls-min-log4 3 --n-balls-max-log4 3 --n-end-max-log2 5.75
echo "NBALLS_FAMILY_DONE"
