"""benchmark_00 — the hanging-node kernel in isolation (reference:
benchmark_00_likwid.cc).

Meshless: builds one synthetic compressed mask
  mask = subcell(1) | faces(0b111) << 3 | edges(0) << 6
(benchmark_00_likwid.cc:41-48) and applies the standalone interpolation
kernel 100x to a batch of cell-local value arrays, proving the kernel is a
pure function of (1D shape data, 9-bit mask, cell values). Profiler traces
(utils.timing.trace) replace the LIKWID markers.

  python benchmarks/benchmark_00.py [degree] [n_cells] [n_components] [--trace]

n_components > 1 exercises the vector-valued factory signature
(benchmark_00_likwid.cc:56-59): component blocks share the per-cell mask.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import jax
import jax.numpy as jnp

try:
    import dealii_matrixfree_hanging_nodes  # noqa: F401
except ModuleNotFoundError:  # checkout use without `pip install -e .`
    sys.path.insert(0, __file__.rsplit("/", 2)[0])

from dealii_matrixfree_hanging_nodes.elements import shape_info
from dealii_matrixfree_hanging_nodes.ops.hanging_nodes import (
    apply_hanging_node_constraints,
)
from dealii_matrixfree_hanging_nodes.utils.timing import repeat_timed, trace


def run(degree: int = 4, n_cells: int = 4096, dim: int = 3,
        do_trace: bool = False, n_components: int = 1):
    si = shape_info(degree)
    mask = 1 | (0b111 << dim)  # subcell=1, all faces constrained, no edges
    masks = jnp.full((n_cells,), mask, dtype=jnp.int32)
    P = jnp.asarray(si.P, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    data = jnp.asarray(
        rng.standard_normal(
            (n_cells, n_components * (degree + 1) ** dim)
        ), jnp.float32
    )

    fn = jax.jit(
        lambda v, m, p: apply_hanging_node_constraints(
            v, m, p, dim, False, n_components=n_components
        )
    )
    res = repeat_timed(lambda v: fn(v, masks, P), data, n_reps=100, n_trials=3)
    if do_trace:
        with trace("traces/benchmark_00") as d:
            fn(data, masks, P).block_until_ready()
        print(f"profiler trace written to {d}", file=sys.stderr)
    cells_per_s = n_cells / res.min
    print(
        json.dumps(
            {
                "degree": degree,
                "n_cells": n_cells,
                "n_components": n_components,
                "mask": mask,
                "t_min": res.min,
                "t_avg": res.avg,
                "cells_per_s": cells_per_s,
            }
        )
    )
    return res


def main(argv=None):
    from dealii_matrixfree_hanging_nodes.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    argv = sys.argv[1:] if argv is None else argv
    args = [a for a in argv if a != "--trace"]
    degree = int(args[0]) if len(args) > 0 else 4
    n_cells = int(args[1]) if len(args) > 1 else 4096
    n_comp = int(args[2]) if len(args) > 2 else 1
    run(degree, n_cells, do_trace="--trace" in argv,
        n_components=n_comp)


if __name__ == "__main__":
    main()
