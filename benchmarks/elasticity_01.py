"""Vector-valued elasticity vmult benchmark (SURVEY §7 stretch item;
BASELINE configs). Times the 3-component elasticity operator's ±constraints
pair on the AMR quadrant geometry with the same interleaved window protocol
as benchmark_03, reporting component-DoF throughput.

  python benchmarks/elasticity_01.py [nref] [degree] [n_windows]
"""

from __future__ import annotations

import sys

import numpy as np
import jax.numpy as jnp

try:
    import dealii_matrixfree_hanging_nodes  # noqa: F401
except ModuleNotFoundError:  # checkout use without `pip install -e .`
    sys.path.insert(0, __file__.rsplit("/", 2)[0])

import dealii_matrixfree_hanging_nodes as mfhn
from dealii_matrixfree_hanging_nodes.matrix_free import MatrixFree
from dealii_matrixfree_hanging_nodes.models.elasticity import ElasticityOperator
from dealii_matrixfree_hanging_nodes.utils.table import ConvergenceTable
from dealii_matrixfree_hanging_nodes.utils.timing import repeat_timed_paired


def run(nref=5, degree=2, n_windows=3, n_reps=50, dtype=np.float32,
        engine="index"):
    tria = mfhn.create_quadrant(3, nref)
    mf = MatrixFree(tria, degree, dtype=dtype)
    rng = np.random.default_rng(0)
    scale = jnp.asarray(1e-3, dtype)
    if engine == "bricks":
        from dealii_matrixfree_hanging_nodes.models.elasticity_bricks import (
            BrickElasticity,
        )

        op = BrickElasticity(mf, mu=1.0, lam=1.0)
        src_b = op.from_dof_vector(
            rng.standard_normal((mf.n_dofs, 3)).astype(dtype)
        )
        res_c, res_p = repeat_timed_paired(
            [lambda x: op.vmult(x * scale),
             lambda x: op.vmult_plain(x * scale)],
            [src_b, src_b], n_reps=n_reps, n_trials=n_windows,
        )
    else:
        op_c = ElasticityOperator(mf, mu=1.0, lam=1.0, constraints=True)
        op_p = ElasticityOperator(mf, mu=1.0, lam=1.0, constraints=False)
        src = jnp.asarray(
            rng.standard_normal((mf.n_dofs, 3)).astype(dtype)
        )
        res_c, res_p = repeat_timed_paired(
            [lambda x: op_c.vmult(x * scale),
             lambda x: op_p.vmult(x * scale)],
            [src, src], n_reps=n_reps, n_trials=n_windows,
        )
    table = ConvergenceTable()
    table.add_value("operator", f"elasticity3-{engine}")
    table.add_value("n_ref", nref)
    table.add_value("degree", degree)
    table.add_value("n_cells", mf.n_cells)
    table.add_value("n_cells_hn", mf.constraints.n_constrained_cells)
    table.add_value("n_dofs_total", 3 * mf.n_dofs)
    table.add_value("time_min", res_c.min)
    table.set_scientific("time_min", True)
    table.add_value("time_min_plain", res_p.min)
    table.set_scientific("time_min_plain", True)
    table.add_value("GDoFs_per_s", 3 * mf.n_dofs / res_c.min / 1e9)
    win = [
        100.0 * (tc / tp - 1.0) for tc, tp in zip(res_c.times, res_p.times)
    ]
    table.add_value("overhead_windows", "/".join(f"{w:.1f}" for w in win))
    table.add_value("overhead_median", round(float(np.median(win)), 2))
    print(table.write_text())
    print("DONE-ALL")
    return table


def main(argv=None):
    from dealii_matrixfree_hanging_nodes.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    argv = sys.argv[1:] if argv is None else argv
    args = [a for a in argv if a != "--bricks"]
    run(
        int(args[0]) if len(args) > 0 else 5,
        int(args[1]) if len(args) > 1 else 2,
        int(args[2]) if len(args) > 2 else 3,
        engine="bricks" if "--bricks" in argv else "index",
    )


if __name__ == "__main__":
    main()
