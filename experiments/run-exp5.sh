#!/usr/bin/env bash
# End-to-end vmult sweep (experiments-skx/run-exp5.sh + cuda/run.sh analog):
# degrees 1..6, refinement sweep, both geometries, on the GPU.
set -e
cd "$(dirname "$0")/.."
for degree in 1 2 3 4 5 6; do
  python benchmarks/benchmark_03.py quadrant "$degree" 4 7 | tee "results_exp5_quadrant_${degree}"
  python benchmarks/benchmark_03.py annulus  "$degree" 5 7 | tee "results_exp5_annulus_${degree}"
done
