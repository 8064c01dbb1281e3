"""benchmark_02 — load balancing of hanging-node cells (reference:
benchmark_02.cc).

Sweeps the hanging-node cell weight w in [1.0, 10.0] (step 0.1 by default),
repartitions the Morton SFC with the weighted policy
(hanging_nodes_weighting, benchmark_02.cc:17-34), and times the full
distributed cell_loop vmult on the device mesh. Per-weight, dumps the
per-rank ghost/import index counts and min/max/avg cell counts to CSV
(benchmark_02.cc:136-165). Options mirror the reference: --no-comm elides
the collectives (benchmark_02.cc:204-209), --slow uses the legacy constraint
algorithm path.

  python benchmarks/benchmark_02.py [geometry] [n_ref] [degree] [csv_prefix]
        [--bricks] [--no-comm] [--coarse] [--halo] [--slow-ok]

--bricks runs the sweep on the distributed BRICK engine (the flagship path):
bricks repartition along the weighted Morton curve; the measured exchange is
the neighbor-wise halo (--halo: pairwise boundary-pool partials + chain need
sets) or the replicated mode (default, like the index engine's allgather:
psum'd boundary pools + all_gathered chain rows).
"""

from __future__ import annotations

import sys

import numpy as np
import jax

try:
    import dealii_matrixfree_hanging_nodes  # noqa: F401
except ModuleNotFoundError:  # checkout use without `pip install -e .`
    sys.path.insert(0, __file__.rsplit("/", 2)[0])

import dealii_matrixfree_hanging_nodes as mfhn
from dealii_matrixfree_hanging_nodes.matrix_free import MatrixFree
from dealii_matrixfree_hanging_nodes.parallel.distributed import DistributedLaplace
from dealii_matrixfree_hanging_nodes.parallel.partition import (
    hanging_nodes_weighting,
)
from dealii_matrixfree_hanging_nodes.utils.table import ConvergenceTable
from dealii_matrixfree_hanging_nodes.utils.timing import repeat_timed


def run(
    geometry: str = "quadrant",
    n_refinements: int = 4,
    degree: int = 2,
    weights=None,
    n_reps: int = 100,
    perform_communication: bool = True,
    csv_prefix: str | None = None,
    dim: int = 3,
    dtype=np.float32,
    exchange: str = "allgather",
    engine: str = "index",
):
    weights = weights if weights is not None else np.arange(1.0, 10.05, 0.1)
    tria = mfhn.create_geometry(geometry, dim, n_refinements)
    mf = MatrixFree(tria, degree, dtype=dtype)
    constrained = mf.constraints.is_constrained_cell()
    table = ConvergenceTable()
    rng = np.random.default_rng(0)
    src0 = rng.standard_normal(mf.n_dofs).astype(dtype)

    csv = open(f"{csv_prefix}.csv", "w") if csv_prefix else None
    if csv:
        csv.write("weight,rank,n_cells,n_ghost,n_import,t_min,t_avg,t_max\n")

    import jax as _jax
    if _jax.devices()[0].platform == "cpu" and len(_jax.devices()) > 1:
        print(
            "# NOTE: N virtual devices on one host CPU — the t_min/t_avg"
            " columns are correctness/ballast only, NOT performance data"
            " (cells/ghost/import columns are exact)."
        )

    for w in weights:
        cw = hanging_nodes_weighting(constrained, float(w))
        if engine == "bricks":
            from dealii_matrixfree_hanging_nodes.parallel.bricks_distributed import (
                DistributedBrickLaplace,
            )

            # map the index engine's exchange names onto the brick engine's
            # ("allgather" = the replicated boundary-pool/chain mode)
            dop = DistributedBrickLaplace(
                mf, weights=cw, perform_communication=perform_communication,
                exchange="halo" if exchange == "halo" else "replicated",
            )
            x0 = dop.from_dof_vector(src0)
            counts_of = lambda d: np.bincount(
                d.rank_of_cell, minlength=d.n_ranks
            )
        else:
            dop = DistributedLaplace(
                mf, weights=cw, perform_communication=perform_communication,
                exchange=exchange,
            )
            x0 = dop.scatter_vector(src0)
        res = repeat_timed(
            lambda x: dop.vmult(x * np.asarray(1e-3, dtype)),
            x0,
            n_reps=n_reps,
            n_trials=1,
            # per-rep fence (reference: MPI_Barrier each rep,
            # benchmark_01.h:538); also required on the virtual CPU mesh —
            # async-chaining collective programs deadlocks the rendezvous
            sync_each=jax.devices()[0].platform == "cpu",
        )
        counts = np.bincount(dop.rank_of_cell, minlength=dop.n_ranks)
        table.add_value("engine", engine)
        table.add_value("p", degree)
        table.add_value("n_ref", n_refinements)
        table.add_value("weight", round(float(w), 2))
        table.add_value("t_min", res.min)
        table.set_scientific("t_min", True)
        table.add_value("t_avg", res.avg)
        table.set_scientific("t_avg", True)
        table.add_value("max_cells", int(counts.max()))
        table.add_value("min_cells", int(counts.min()))
        table.add_value("sum_ghost", int(dop.n_ghost.sum()))
        table.add_value("sum_import", int(dop.n_import.sum()))
        if csv:
            for r in range(dop.n_ranks):
                csv.write(
                    f"{w:.2f},{r},{counts[r]},{dop.n_ghost[r]},"
                    f"{dop.n_import[r]},{res.min},{res.avg},{res.max}\n"
                )
        print(table.write_text())
    if csv:
        csv.close()
    return table


def main(argv=None):
    from dealii_matrixfree_hanging_nodes.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    import os

    argv = sys.argv[1:] if argv is None else argv
    args = [a for a in argv if not a.startswith("--")]
    geometry = args[0] if len(args) > 0 else "quadrant"
    n_ref = int(args[1]) if len(args) > 1 else 4
    degree = int(args[2]) if len(args) > 2 else 2
    prefix = args[3] if len(args) > 3 else None
    run(
        geometry,
        n_ref,
        degree,
        csv_prefix=prefix,
        perform_communication="--no-comm" not in argv,
        n_reps=int(os.environ.get("BENCH_REPS", "100")),
        weights=np.arange(1.0, 10.05, 0.5) if "--coarse" in argv else None,
        exchange="halo" if "--halo" in argv else "allgather",
        engine="bricks" if "--bricks" in argv else "index",
    )


if __name__ == "__main__":
    main()
