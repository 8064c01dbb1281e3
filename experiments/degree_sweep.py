"""Brick-engine degree sweep at >=10 MDoF per degree (VERDICT r2 item 2).

The reference times p=1..6 end-to-end at large refinements
(benchmark_03.h:551-617, cuda/run.sh:1-13). Here each degree gets the
refinement that puts it in the 17-58 MDoF class, one benchmark_03 brick row
per degree (same ±constraints pair, window protocol, GDoF/s).

  python experiments/degree_sweep.py [geometry] [p_min] [p_max]

Optionally BRICK_SIZE_P1/P2 override the auto brick size for low degrees.
"""

import sys

try:
    import dealii_matrixfree_hanging_nodes  # noqa: F401
except ModuleNotFoundError:  # checkout use without `pip install -e .`
    sys.path.insert(0, __file__.rsplit("/", 2)[0])

from benchmarks.benchmark_03 import run
from dealii_matrixfree_hanging_nodes.utils.table import ConvergenceTable

# (degree, n_ref): smallest refinement with >= ~10 MDoF on quadrant
# (n_dofs ~ n_cells * p^3; quadrant cells: r7 270k, r8 2.13M, r9 17.1M)
PAIRS = {1: 9, 2: 8, 3: 8, 4: 7, 5: 7, 6: 7}


def main(geometry="quadrant", p_min=1, p_max=6):
    table = ConvergenceTable()
    for p in range(p_min, p_max + 1):
        nref = PAIRS[p]
        run(geometry, p, nref, nref, engine="bricks", table=table,
            n_windows=5)
    print(table.write_text())


if __name__ == "__main__":
    main(
        sys.argv[1] if len(sys.argv) > 1 else "quadrant",
        int(sys.argv[2]) if len(sys.argv) > 2 else 1,
        int(sys.argv[3]) if len(sys.argv) > 3 else 6,
    )
