"""benchmark_01_counters — per-variant hardware-counter analog (reference:
benchmark_01_likwid.cc + experiments/run-exp2.sh's MEM / FLOPS_DP / BRANCH /
CACHES sweep).

LIKWID reads CPU counters around the kernel; the XLA equivalent is (a)
XLA's compiled cost model per program — flops, bytes accessed, peak
memory — and (b) the XPlane profiler trace for measured utilization. This
driver reports (a) for every benchmark_01 variant (t0..t7: DG/CG x
±constraints x ±quad-kernel x fast/slow), plus arithmetic intensity, the
quantity the reference's MEM vs FLOPS_DP groups are combined to estimate.
Pass --trace to also record one XPlane trace per variant
(utils.timing.trace; load with TensorBoard).

  python benchmarks/benchmark_01_counters.py [geometry] [nref] [degree]
        [--trace]
"""

from __future__ import annotations

import sys

import numpy as np
import jax
import jax.numpy as jnp

try:
    import dealii_matrixfree_hanging_nodes  # noqa: F401
except ModuleNotFoundError:  # checkout use without `pip install -e .`
    sys.path.insert(0, __file__.rsplit("/", 2)[0])

from benchmarks.benchmark_01 import Test  # noqa: E402
from dealii_matrixfree_hanging_nodes.utils.table import (  # noqa: E402
    ConvergenceTable,
)

VARIANTS = [
    # name, do_cg, do_constraints, do_quad, fast
    ("t0_dg_plain", False, False, False, True),
    ("t1_dg_hn", False, True, False, True),
    ("t2_dg_plain_quad", False, False, True, True),
    ("t3_dg_hn_quad", False, True, True, True),
    ("t4_cg_plain_quad", True, False, True, True),
    ("t5_cg_hn_quad", True, True, True, True),
    ("t6_cg_plain_slow", True, False, True, False),
    ("t7_cg_hn_slow", True, True, True, False),
]


def run(geometry="quadrant", nref=4, degree=4, trace=False, table=None):
    test = Test(degree, geometry, nref, setup_only_fast_algorithm=False)
    mf = test.mf
    table = table if table is not None else ConvergenceTable()
    scale = jnp.asarray(1e-3, mf.dtype)

    for name, do_cg, do_constraints, do_quad, fast in VARIANTS:
        step, x0 = test.build_step(do_cg, do_constraints, do_quad, fast)
        jit_step = jax.jit(lambda x, a: step(x * scale, a))
        compiled = jit_step.lower(x0, mf.arrays).compile()
        ca = compiled.cost_analysis() or {}
        flops = float(ca.get("flops", float("nan")))
        byts = float(ca.get("bytes accessed", float("nan")))
        table.add_value("variant", name)
        table.add_value("flops", f"{flops:.3e}")
        table.add_value("bytes", f"{byts:.3e}")
        table.add_value("flops_per_byte", round(flops / byts, 3) if byts else 0)
        table.add_value(
            "flops_per_dof", round(flops / mf.n_dofs, 1) if mf.n_dofs else 0
        )
        if trace:
            from dealii_matrixfree_hanging_nodes.utils.timing import trace as tr

            with tr(f"traces/counters-{name}"):
                jit_step(x0, mf.arrays).block_until_ready()
        print(table.write_text())
    return table


def main(argv=None):
    from dealii_matrixfree_hanging_nodes.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    argv = sys.argv[1:] if argv is None else argv
    args = [a for a in argv if not a.startswith("--")]
    geometry = args[0] if len(args) > 0 else "quadrant"
    nref = int(args[1]) if len(args) > 1 else 4
    degree = int(args[2]) if len(args) > 2 else 4
    run(geometry, nref, degree, trace="--trace" in argv)


if __name__ == "__main__":
    main()
