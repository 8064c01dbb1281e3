#!/usr/bin/env bash
# Vectorization-type comparison (experiments/run-exp3*.sh analog): all four
# HN runners — index (compact), sorted (categorize), group (masked-all),
# and the composite-matmul "matrix" runner — head-to-head per degree.
set -e
cd "$(dirname "$0")/.."
python experiments/variant_matrix.py quadrant 5 1 6 | tee results_variant_matrix
