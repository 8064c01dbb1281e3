"""benchmark_01 — the paper's core experiment (reference: benchmark_01.cc/.h).

Decomposes the cost of hanging-node constraint application inside a Laplace
vmult into the reference's 8-configuration matrix:

  t0/t1: DG cell-local storage, gather+scatter only,      -/+ HN constraints
  t2/t3: DG cell-local storage, + quadrature cell kernel, -/+ HN constraints
  t4/t5: CG global vector,      + quadrature cell kernel, -/+ HN constraints
  t6/t7: CG global vector, legacy slow constraint path    (fast=False)

and the per-HN-cell relative cost
  eta = max((t_hn / (t_n / (n_n + n_hn)) - n_n) / n_hn, 1)
(benchmark_01.cc:179-187). Also reproduces get_info's compressed-mask census
(benchmark_01.h:296-481): cell/batch counts, the 512-kind mask histogram and
the reduced (n_constrained_edges, n_constrained_faces) classification.

Usage (mirrors benchmark_01.cc:251-302):
  python benchmarks/benchmark_01.py quadrant 4 5 1 4        # geometry minref maxref pmin pmax
  python benchmarks/benchmark_01.py json cfg1.json cfg2.json
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

import numpy as np
import jax
import jax.numpy as jnp

try:
    import dealii_matrixfree_hanging_nodes  # noqa: F401
except ModuleNotFoundError:  # checkout use without `pip install -e .`
    sys.path.insert(0, __file__.rsplit("/", 2)[0])

import dealii_matrixfree_hanging_nodes as mfhn
from dealii_matrixfree_hanging_nodes.constraints import decompress_mask
from dealii_matrixfree_hanging_nodes.matrix_free import MatrixFree
from dealii_matrixfree_hanging_nodes.models.laplace import laplace_cell_kernel
from dealii_matrixfree_hanging_nodes.utils.params import BenchmarkParameters
from dealii_matrixfree_hanging_nodes.utils.table import ConvergenceTable
from dealii_matrixfree_hanging_nodes.utils.timing import repeat_timed

BATCH_WIDTH = 8  # sublane-tile analog of the reference's SIMD cell batch


@dataclass
class Info:
    n_levels: int = 0
    n_dofs: int = 0
    n_cells: int = 0
    n_cells_n: int = 0
    n_cells_hn: int = 0
    n_macro_cells: int = 0
    n_macro_cells_n: int = 0
    n_macro_cells_hn: int = 0
    mask_histogram: dict = field(default_factory=dict)
    reduced_histogram: dict = field(default_factory=dict)
    lanes_per_batch_histogram: dict = field(default_factory=dict)


class Test:
    """Owns mesh + MatrixFree and runs one timing configuration
    (benchmark_01.h:144-678 analog)."""

    def __init__(
        self,
        degree: int,
        geometry_type: str,
        n_refinements: int,
        setup_only_fast_algorithm: bool = True,
        test_high_order_mapping: bool = False,
        categorize: bool = False,
        hn_mode: str = "compact",
        dim: int = 3,
        dtype=np.float32,
        n_reps: int = 100,
    ):
        self.tria = mfhn.create_geometry(geometry_type, dim, n_refinements)
        self.mf = MatrixFree(
            self.tria,
            degree,
            dtype=dtype,
            hn_mode=hn_mode,
            categorize=categorize,
            high_order_mapping=test_high_order_mapping,
        )
        self.setup_only_fast_algorithm = setup_only_fast_algorithm
        self.n_reps = n_reps
        self._kernel = laplace_cell_kernel(self.mf)

    # -------------------------------------------------------------- info
    def get_info(self, print_details: bool = False) -> Info:
        mf = self.mf
        masks = np.asarray(mf.masks)
        constrained = masks != 0
        info = Info(
            n_levels=self.tria.n_global_levels,
            n_dofs=mf.n_dofs,
            n_cells=mf.n_cells,
            n_cells_hn=int(constrained.sum()),
            n_cells_n=int((~constrained).sum()),
        )
        # batch census: groups of BATCH_WIDTH cells in storage order
        n_batches = (mf.n_cells + BATCH_WIDTH - 1) // BATCH_WIDTH
        info.n_macro_cells = n_batches
        padded = np.zeros(n_batches * BATCH_WIDTH, dtype=bool)
        padded[: mf.n_cells] = constrained
        per_batch = padded.reshape(n_batches, BATCH_WIDTH).sum(axis=1)
        info.n_macro_cells_hn = int((per_batch > 0).sum())
        info.n_macro_cells_n = n_batches - info.n_macro_cells_hn
        vals, counts = np.unique(per_batch[per_batch > 0], return_counts=True)
        info.lanes_per_batch_histogram = dict(zip(vals.tolist(), counts.tolist()))
        # 512-kind histogram (benchmark_01.h:310) + reduced classification
        vals, counts = np.unique(masks[constrained], return_counts=True)
        info.mask_histogram = dict(zip(vals.tolist(), counts.tolist()))
        sub, face, edge = decompress_mask(masks[constrained], mf.dim)
        popcount = np.vectorize(lambda x: bin(int(x)).count("1"))
        if len(face):
            keys = list(zip(popcount(edge).tolist(), popcount(face).tolist()))
            red = {}
            for k in keys:
                red[k] = red.get(k, 0) + 1
            info.reduced_histogram = red
        # self-check invariants (benchmark_01.h:407-411)
        assert info.n_cells_n + info.n_cells_hn == info.n_cells
        assert info.n_macro_cells_n + info.n_macro_cells_hn == info.n_macro_cells
        if print_details:
            print(f"  mask histogram ({len(info.mask_histogram)} kinds):",
                  info.mask_histogram)
            print("  (n_edges, n_faces) histogram:", info.reduced_histogram)
            print("  constrained lanes per batch:", info.lanes_per_batch_histogram)
        return info

    # --------------------------------------------------------------- run
    def build_step(
        self,
        do_cg: bool,
        do_constraints: bool,
        do_quad: bool,
        fast_algorithm: bool = True,
    ):
        """(step_fn(x, arrays), x0) for one t0..t7 configuration — shared by
        the timing loop and the counter driver (benchmark_01_counters.py)."""
        mf = self.mf
        kernel = self._kernel

        if do_cg:

            def step_fn(src, a):
                return mf.cell_loop(
                    kernel if do_quad else (lambda u, aa: u),
                    src,
                    constraints=do_constraints,
                    slow=not fast_algorithm,
                    arrays=a,
                )

            x0 = jnp.asarray(
                np.random.default_rng(0).standard_normal(mf.n_dofs), mf.dtype
            )
        else:
            # DG mode: cell-local storage, no global vector
            # (benchmark_01.h:150-151,498-524)
            def step_fn(u, a):
                if do_constraints:
                    u = mf.apply_hanging_node_constraints(u, False, a)
                if do_quad:
                    u = kernel(u, a)
                if do_constraints:
                    u = mf.apply_hanging_node_constraints(u, True, a)
                return u

            x0 = jnp.asarray(
                np.random.default_rng(0).standard_normal(
                    (mf.n_cells, mf.shape.n_dofs_per_cell(mf.dim))
                ),
                mf.dtype,
            )
        return step_fn, x0

    def run(
        self,
        do_cg: bool,
        do_constraints: bool,
        do_quad: bool,
        fast_algorithm: bool = True,
    ) -> float:
        """Average seconds per vmult over n_reps (benchmark_01.h:483-576)."""
        mf = self.mf
        arrays = mf.arrays
        scale = jnp.asarray(1e-3, mf.dtype)
        step_fn, x0 = self.build_step(
            do_cg, do_constraints, do_quad, fast_algorithm
        )
        jit_step = jax.jit(step_fn)
        res = repeat_timed(
            lambda x: jit_step(x * scale, arrays), x0, n_reps=self.n_reps, n_trials=1
        )
        return res.avg


def compute_cost(t_n: float, t_hn: float, info: Info) -> float:
    """eta (benchmark_01.cc:179-187)."""
    if info.n_cells_hn == 0:
        return 1.0
    return max(
        (t_hn / (t_n / (info.n_cells_n + info.n_cells_hn)) - info.n_cells_n)
        / info.n_cells_hn,
        1.0,
    )


def run_benchmark(parameters_vector, dim=3, n_reps=100, table=None):
    table = table if table is not None else ConvergenceTable()
    for param in parameters_vector:
        # runtime verification that the requested vectorization type maps to
        # an available runner (the analog of the compiled-variant assertions
        # at benchmark_01.cc:126-158)
        # "matrix" is the 4th runner (composite per-mask matmuls,
        # no reference analog — the reference's three are README.md:27-57)
        expected = {
            "index": "compact",
            "sorted": "sorted",
            "group": "all",
            "matrix": "matrix",
        }
        if param.vectorization_type not in expected:
            raise ValueError(
                f"unknown VectorizationType {param.vectorization_type!r}"
            )
        assert param.hn_mode == expected[param.vectorization_type]
        test = Test(
            param.degree,
            param.geometry_type,
            param.n_refinements,
            param.setup_only_fast_algorithm,
            param.test_high_order_mapping,
            param.categorize,
            hn_mode=param.hn_mode,
            dim=dim,
            n_reps=n_reps,
        )
        info = test.get_info(param.print_details)
        for k in (
            "n_levels n_dofs n_cells n_cells_n n_cells_hn "
            "n_macro_cells n_macro_cells_n n_macro_cells_hn"
        ).split():
            table.add_value(k, getattr(info, k))
        table.add_value("degree", param.degree)
        table.add_value("vect", param.vectorization_type)

        t0 = test.run(False, False, False)
        t1 = test.run(False, True, False)
        t2 = test.run(False, False, True)
        t3 = test.run(False, True, True)
        t4 = test.run(True, False, True)
        t5 = test.run(True, True, True)
        for name, t in (("t0", t0), ("t1", t1), ("t2", t2), ("t3", t3),
                        ("t4", t4), ("t5", t5)):
            table.add_value(name, t)
            table.set_scientific(name, True)
        for name, tn, thn in (("eta1", t0, t1), ("eta3", t2, t3), ("eta5", t4, t5)):
            table.add_value(name, compute_cost(tn, thn, info))
            table.set_scientific(name, True)

        if not param.setup_only_fast_algorithm:
            t6 = test.run(True, False, True, fast_algorithm=False)
            t7 = test.run(True, True, True, fast_algorithm=False)
            table.add_value("t6", t6)
            table.set_scientific("t6", True)
            table.add_value("t7", t7)
            table.set_scientific("t7", True)
            table.add_value("eta7", compute_cost(t4, t7, info))
            table.set_scientific("eta7", True)

        if param.print_details:
            print(table.write_text())
    print(table.write_text())
    return table


def main(argv=None):
    from dealii_matrixfree_hanging_nodes.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    import os

    argv = sys.argv if argv is None else argv
    geometry_type = argv[1] if len(argv) > 1 else "quadrant"
    n_reps = int(os.environ.get("BENCH_REPS", "100"))
    params = []
    if geometry_type == "json":
        for path in argv[2:]:
            params.append(BenchmarkParameters.from_json(path))
    else:
        min_ref = int(argv[2]) if len(argv) > 2 else 6
        max_ref = int(argv[3]) if len(argv) > 3 else 6
        deg_min = int(argv[4]) if len(argv) > 4 else 1
        deg_max = int(argv[5]) if len(argv) > 5 else deg_min
        homap = bool(int(argv[6])) if len(argv) > 6 else False
        categorize = bool(int(argv[7])) if len(argv) > 7 else False
        vtype = argv[8] if len(argv) > 8 else "index"
        for r in range(min_ref, max_ref + 1):
            for p in range(deg_min, deg_max + 1):
                params.append(
                    BenchmarkParameters(
                        geometry_type=geometry_type,
                        n_refinements=r,
                        degree=p,
                        setup_only_fast_algorithm=False,
                        test_high_order_mapping=homap,
                        categorize=categorize,
                        vectorization_type=vtype,
                    )
                )
    run_benchmark(params, n_reps=n_reps)


if __name__ == "__main__":
    main(sys.argv)
