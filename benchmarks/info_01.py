"""info_01 — constraint-storage memory census (reference: info_01.cc).

For annulus and quadrant at refinements [min_ref, max_ref], degree p:
- mem_sp: bytes of the compressed per-cell constraint masks
  (info_01.cc:52-58), plus the hanging/regular cell counts per lane
  (info_01.cc:60-92);
- mem_matrix / mem_gp: bytes of the legacy row representation (slave/col/
  weight arrays) and the count of distinct pooled weight-row groups — the
  AffineConstraints + constraint-pool census (info_01.cc:95-141).

  python benchmarks/info_01.py [degree] [min_ref] [max_ref]
"""

from __future__ import annotations

import sys

import numpy as np

try:
    import dealii_matrixfree_hanging_nodes  # noqa: F401
except ModuleNotFoundError:  # checkout use without `pip install -e .`
    sys.path.insert(0, __file__.rsplit("/", 2)[0])

import dealii_matrixfree_hanging_nodes as mfhn
from dealii_matrixfree_hanging_nodes.constraints import build_constraints
from dealii_matrixfree_hanging_nodes.dof_handler import DoFHandler
from dealii_matrixfree_hanging_nodes.utils.table import ConvergenceTable


def weight_pool_groups(ci) -> int:
    """Distinct weight rows (the reference's pooled 'groups_gp')."""
    rows = []
    ptr = ci.row_ptr
    for i in range(len(ci.slave_dofs)):
        rows.append(tuple(np.round(ci.weight[ptr[i] : ptr[i + 1]], 12)))
    return len(set(rows))


def run(degree: int = 4, min_ref: int = 5, max_ref: int = 7, dim: int = 3):
    table = ConvergenceTable()
    for geometry in ("annulus", "quadrant"):
        for n_ref in range(min_ref, max_ref + 1):
            tria = mfhn.create_geometry(geometry, dim, n_ref)
            dh = DoFHandler(tria, degree)
            ci = build_constraints(dh)
            constrained = ci.is_constrained_cell()
            table.add_value("geometry", geometry)
            table.add_value("n_ref", n_ref)
            table.add_value("n_cells", tria.n_active_cells)
            table.add_value("n_cells_n", int((~constrained).sum()))
            table.add_value("n_cells_hn", int(constrained.sum()))
            table.add_value("n_dofs", dh.n_dofs)
            table.add_value("mem_sp", ci.memory_consumption_masks())
            table.add_value("mem_matrix", ci.memory_consumption_matrix())
            table.add_value("groups_gp", weight_pool_groups(ci))
            print(table.write_text())
    return table


def main(argv=None):
    from dealii_matrixfree_hanging_nodes.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    argv = sys.argv[1:] if argv is None else argv
    degree = int(argv[0]) if len(argv) > 0 else 4
    min_ref = int(argv[1]) if len(argv) > 1 else 5
    max_ref = int(argv[2]) if len(argv) > 2 else 6
    run(degree, min_ref, max_ref)


if __name__ == "__main__":
    main()
