#!/usr/bin/env bash
# Hardware-counter experiment (experiments/run-exp2.sh analog): the LIKWID
# groups MEM/FLOPS_DP/BRANCH/CACHES map to XLA cost analysis + profiler traces.
set -e
cd "$(dirname "$0")/.."
python benchmarks/benchmark_01_counters.py quadrant 4 4 --trace
python benchmarks/benchmark_00.py 4 4096 --trace
