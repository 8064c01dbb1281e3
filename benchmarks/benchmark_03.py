"""benchmark_03 — end-to-end Laplace vmult sweep (reference: benchmark_03.h).

For each refinement level in [min_ref, max_ref]: build the geometry, census
hanging-node cells (the Helper analog via the compressed masks), interpolate
src = sum_d sin(x_d) at the DoF support points (benchmark_03.h:362-378), and
time n_reps vmults with and without constraint application, reporting
min/avg/max like the rank reductions at benchmark_03.h:471-507. The CUDA
MemorySpace::CUDA path of the reference corresponds to running this on the
GPU (the default); MemorySpace::Host corresponds to JAX_PLATFORMS=cpu.

  python benchmarks/benchmark_03.py [geometry] [degree] [min_ref] [max_ref]
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

import dealii_matrixfree_hanging_nodes as mfhn
from dealii_matrixfree_hanging_nodes.matrix_free import MatrixFree
from dealii_matrixfree_hanging_nodes.models.laplace import LaplaceOperator
from dealii_matrixfree_hanging_nodes.utils.analytic import interpolate
from dealii_matrixfree_hanging_nodes.utils.table import ConvergenceTable
from dealii_matrixfree_hanging_nodes.utils.timing import repeat_timed


def run(
    geometry: str = "quadrant",
    degree: int = 4,
    min_ref: int = 4,
    max_ref: int = 7,
    n_reps: int = 100,
    dim: int = 3,
    dtype=np.float32,
    table=None,
    engine: str = "index",
    n_windows: int = 3,
):
    """engine="index" is the reference's MemorySpace::Host analog;
    engine="bricks" is the device-native path (the CUDA analog).

    Setup for ALL refinement rows happens before the first device use,
    so the host work is timed apart from the device work.
    """
    table = table if table is not None else ConvergenceTable()
    from dealii_matrixfree_hanging_nodes.constraint_helper import Helper

    rows = []
    for n_ref in range(min_ref, max_ref + 1):
        import time as _time

        t_setup = _time.perf_counter()
        tria = mfhn.create_geometry(geometry, dim, n_ref)
        mf = MatrixFree(tria, degree, dtype=dtype)
        # two-oracle redundancy: the pure-topology Helper census must agree
        # with the compressed-mask census (benchmark_03.h:412-432)
        n_hn_topo, _ = Helper(tria).census()
        assert n_hn_topo == mf.constraints.n_constrained_cells, (
            n_hn_topo, mf.constraints.n_constrained_cells,
        )
        # interpolate BEFORE the brick build: it first-touches ~1 GB at
        # nref=8 and fresh faults slow down as RSS grows (utils/hostmem.py)
        src_np = interpolate(mf.dof_handler)
        brick_op = None
        if engine == "bricks":
            from dealii_matrixfree_hanging_nodes.bricks import BrickLaplaceMM

            brick_op = BrickLaplaceMM(mf)
            # brick-layout conversion is NumPy-heavy: do it pre-device too
            src_np = brick_op.from_dof_vector(
                src_np.astype(mf.dtype), to_device=False
            )
        t_setup = _time.perf_counter() - t_setup
        print(f"# setup n_ref={n_ref}: {t_setup:.1f} s "
              f"({mf.n_dofs} dofs)", flush=True)
        rows.append((n_ref, mf, brick_op, src_np, t_setup))

    for n_ref, mf, brick_op, src_np, t_setup in rows:
        scale = jnp.asarray(1e-3, mf.dtype)
        if brick_op is not None:
            src_b = jnp.asarray(src_np)
        else:
            src = jnp.asarray(src_np, dtype=mf.dtype)

        table.add_value("geometry", geometry)
        table.add_value("n_ref", n_ref)
        table.add_value("degree", degree)
        table.add_value("n_cells", mf.n_cells)
        table.add_value("n_cells_hn", mf.constraints.n_constrained_cells)
        table.add_value("n_dofs", mf.n_dofs)
        table.add_value("setup_s", round(t_setup, 1))

        # apples-to-apples ±constraints pair (reference: benchmark_03.h:
        # 510-532), INTERLEAVED trials so clock or power drift affects
        # both sides of the overhead ratio alike
        if brick_op is not None:
            steps = [
                lambda x: brick_op.vmult(x * scale),
                lambda x: brick_op.vmult_plain(x * scale),
            ]
            x0s = [src_b, src_b]
        else:
            op_c = LaplaceOperator(mf, constraints=True)
            op_p = LaplaceOperator(mf, constraints=False)
            steps = [
                lambda x: op_c.vmult(x * scale),
                lambda x: op_p.vmult(x * scale),
            ]
            x0s = [src, src]
        from dealii_matrixfree_hanging_nodes.utils.timing import (
            repeat_timed_paired,
        )

        res_c, res_p = repeat_timed_paired(
            steps, x0s, n_reps=n_reps, n_trials=n_windows
        )
        t_pair = {True: res_c.min, False: res_p.min}
        # many-window overhead protocol: each interleaved trial is one
        # window; the constrained/plain ratio within a window is drift-free,
        # so the per-window overheads and their median bound the HN
        # overhead (the min/min ratio below can pair times from DIFFERENT
        # windows when n_windows > 1)
        win = [
            100.0 * (tc / tp - 1.0)
            for tc, tp in zip(res_c.times, res_p.times)
        ]
        shown = win if len(win) <= 8 else (
            sorted(win)[:: max(1, len(win) // 8)][:8]
        )
        table.add_value(
            "overhead_windows", "/".join(f"{w:.1f}" for w in shown)
        )
        table.add_value("overhead_median", round(float(np.median(win)), 2))
        if len(win) > 8:
            q25, q75 = np.percentile(win, [25, 75])
            table.add_value(
                "overhead_iqr", f"{q25:.1f}..{q75:.1f}(n={len(win)})"
            )
        for res, tag in ((res_c, ""), (res_p, "_plain")):
            table.add_value("time_min" + tag, res.min)
            table.set_scientific("time_min" + tag, True)
            table.add_value("time_avg" + tag, res.avg)
            table.set_scientific("time_avg" + tag, True)
            table.add_value("time_max" + tag, res.max)
            table.set_scientific("time_max" + tag, True)
        table.add_value("GDoFs_per_s", mf.n_dofs / res_c.min / 1e9)
        # per-HN-cell overhead model (benchmark_01.cc:179-187) and the plain
        # whole-operator overhead ratio used by the <15% BASELINE target
        n_hn = mf.constraints.n_constrained_cells
        n_n = mf.n_cells - n_hn
        if n_hn:
            eta = max(
                (t_pair[True] / (t_pair[False] / mf.n_cells) - n_n) / n_hn, 1.0
            )
            table.add_value("eta", round(eta, 3))
        table.add_value(
            "overhead_pct", round(100 * (t_pair[True] / t_pair[False] - 1), 2)
        )
        print(table.write_text())
        # release this row's device arrays before the next row stages its own
        # (an nref=8 brick row stages ~1.5 GB; rows would otherwise accumulate
        # in HBM across the sweep)
        if brick_op is not None:
            brick_op.arrays = None
    return table


def main(argv=None):
    from dealii_matrixfree_hanging_nodes.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    argv = sys.argv[1:] if argv is None else argv
    args = [a for a in argv if not a.startswith("--")]
    geometry = args[0] if len(args) > 0 else "quadrant"
    degree = int(args[1]) if len(args) > 1 else 4
    min_ref = int(args[2]) if len(args) > 2 else 4
    max_ref = int(args[3]) if len(args) > 3 else 6
    n_windows = int(args[4]) if len(args) > 4 else 3
    engine = "bricks" if "--bricks" in argv else "index"
    run(geometry, degree, min_ref, max_ref, engine=engine,
        n_windows=n_windows)


if __name__ == "__main__":
    main()
