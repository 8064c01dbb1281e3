"""Head-to-head t-matrix of the four HN runner variants (VERDICT r2 item 8).

The reference benches its three vectorization variants via run-exp3-b.sh:1-3
(HN_TYPE patch, README.md:27-57) across degrees (benchmark_01.cc:126-158).
Here all four runners — index/sorted/group (reference analogs) plus the
composite-matmul "matrix" runner — run in ONE process on the same
meshes, so per-variant t0..t7/eta are directly comparable.

  python experiments/variant_matrix.py [geometry] [nref] [p_min] [p_max]

Env: BENCH_REPS (default 30), BENCH_VARIANTS (comma list).
"""

import os
import sys

try:
    import dealii_matrixfree_hanging_nodes  # noqa: F401
except ModuleNotFoundError:  # checkout use without `pip install -e .`
    sys.path.insert(0, __file__.rsplit("/", 2)[0])

from benchmarks.benchmark_01 import run_benchmark
from dealii_matrixfree_hanging_nodes.utils.params import (
    BenchmarkParameters,
)
from dealii_matrixfree_hanging_nodes.utils.table import ConvergenceTable


def main(geometry="quadrant", nref=5, p_min=1, p_max=6):
    variants = os.environ.get(
        "BENCH_VARIANTS", "index,sorted,group,matrix"
    ).split(",")
    n_reps = int(os.environ.get("BENCH_REPS", "30"))
    table = ConvergenceTable()
    for p in range(p_min, p_max + 1):
        params = [
            BenchmarkParameters(
                geometry_type=geometry,
                n_refinements=nref,
                degree=p,
                # the slow-path pair (t6/t7) is variant-independent; run it
                # only for the first variant of each degree
                setup_only_fast_algorithm=(i > 0),
                vectorization_type=v,
            )
            for i, v in enumerate(variants)
        ]
        run_benchmark(params, n_reps=n_reps, table=table)
    print("FINAL-VARIANT-MATRIX")
    print(table.write_text())


if __name__ == "__main__":
    main(
        sys.argv[1] if len(sys.argv) > 1 else "quadrant",
        int(sys.argv[2]) if len(sys.argv) > 2 else 5,
        int(sys.argv[3]) if len(sys.argv) > 3 else 1,
        int(sys.argv[4]) if len(sys.argv) > 4 else 6,
    )
