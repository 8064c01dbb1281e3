"""solve_01 — end-to-end Poisson solves on the AMR geometries (BASELINE.md
row 4: CG + Chebyshev-smoothed geometric multigrid on the partitioned mesh).

Two configurations:
1. single-chip: GMG-preconditioned CG on the quadrant mesh, Dirichlet BCs,
   manufactured solution; reports iterations + errors.
2. multi-chip: plain CG with the domain-decomposed DistributedLaplace over
   all visible devices (weighted SFC partition), verifying the distributed
   operator inside a Krylov loop.

  python benchmarks/solve_01.py [nref] [degree] [--bricks [geometry]]
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
from dealii_matrixfree_hanging_nodes.models.multigrid import (
    GMGPreconditioner,
    solve_cg,
)
from dealii_matrixfree_hanging_nodes.parallel.distributed import DistributedLaplace
from dealii_matrixfree_hanging_nodes.parallel.partition import (
    hanging_nodes_weighting,
)
from dealii_matrixfree_hanging_nodes.utils.table import ConvergenceTable


def run(nref: int = 3, degree: int = 2, dtype=np.float64):
    """Tolerances suit f64 (native on the GPU as on the host)."""
    table = ConvergenceTable()
    tol_gmg = 1e-10
    tol_dist = 1e-8

    # ---- single-chip GMG-CG
    gmg = GMGPreconditioner("quadrant", 3, nref, degree, dtype=dtype)
    op, mf = gmg.fine_op, gmg.fine_mf
    rng = np.random.default_rng(0)
    xstar = mf.constraints.distribute(rng.standard_normal(mf.n_dofs))
    xstar = np.asarray(jnp.asarray(xstar).at[op.bdofs].set(0.0))
    b = op.vmult(jnp.asarray(xstar))
    x, it_gmg, res = solve_cg(op, b, M=gmg, tol=tol_gmg, max_iter=100)
    free = ~mf.constraints.constrained_dof_marker()
    err = float(np.abs(np.asarray(x)[free] - xstar[free]).max())
    x2, it_plain, _ = solve_cg(op, b, tol=tol_gmg, max_iter=2000)
    table.add_value("solver", "GMG-CG")
    table.add_value("n_dofs", mf.n_dofs)
    table.add_value("iters", it_gmg)
    table.add_value("iters_unprec", it_plain)
    table.add_value("err", err)
    table.set_scientific("err", True)

    # ---- multi-chip CG (domain decomposition over all devices)
    mf2 = MatrixFree(mfhn.create_quadrant(3, nref), degree, dtype=dtype)
    w = hanging_nodes_weighting(mf2.constraints.is_constrained_cell(), 4.0)
    dop = DistributedLaplace(mf2, weights=w)
    src = rng.standard_normal(mf2.n_dofs)
    bb = dop.vmult(dop.scatter_vector(src))

    class _Op:
        def vmult(self, v):
            return dop.vmult(v)

    xd, it_d, res_d = solve_cg(_Op(), bb, tol=tol_dist, max_iter=2000)
    # distributed solve of A x = A src recovers src on the free dofs up to
    # the constant nullspace component; verify via residual instead
    rb = dop.gather_vector(bb) - dop.gather_vector(dop.vmult(xd))
    table.add_value("dist_devices", dop.n_ranks)
    table.add_value("dist_iters", it_d)
    table.add_value("dist_res", float(np.linalg.norm(rb)))
    table.set_scientific("dist_res", True)

    # ---- multi-chip Chebyshev-GMG-CG (BASELINE row 4): all levels,
    # smoothers, transfers, and the coarse solve run on sharded vectors
    from dealii_matrixfree_hanging_nodes.parallel.multigrid_distributed import (
        DistributedGMGPreconditioner,
    )

    dgmg = DistributedGMGPreconditioner("quadrant", 3, nref, degree, dtype=dtype)
    dfine = dgmg.fine_op
    bgd = dfine.scatter_vector(np.asarray(b))
    xgd, it_dgmg, _ = solve_cg(dfine, bgd, M=dgmg, tol=tol_gmg, max_iter=100)
    err_d = float(
        np.abs(dfine.gather_vector(xgd)[free] - xstar[free]).max()
    )
    table.add_value("dist_gmg_iters", it_dgmg)
    table.add_value("dist_gmg_err", err_d)
    table.set_scientific("dist_gmg_err", True)
    print(table.write_text())
    return table


def run_bricks(nref: int = 6, degree: int = 4, geometry: str = "quadrant",
               dtype=np.float32, host_loop: bool = False):
    """GMG-CG entirely on the brick engine (BASELINE row 4 at benchmark
    scale, VERDICT r2 item 6): every level operator, smoother, transfer,
    and the direct coarse solve run in the flagship brick layout on the
    device. The iteration itself is DEVICE-RESIDENT (one jitted
    lax.while_loop) — host_loop=True keeps the host-stepping debug path.
    Reports iterations, residual reduction, and time-to-solution
    (wall-clock around the CG loop, closed by a host fetch)."""
    import time

    from dealii_matrixfree_hanging_nodes.models.multigrid_bricks import (
        BrickGMGPreconditioner,
    )
    from dealii_matrixfree_hanging_nodes.utils.analytic import interpolate

    table = ConvergenceTable()
    tol = 1e-10 if dtype == np.float64 else 1e-5

    t0 = time.perf_counter()
    gmg = BrickGMGPreconditioner(geometry, 3, nref, degree, dtype=dtype)
    op, mm, mf = gmg.fine_op, gmg.fine_mm, gmg.fine_mf
    # manufactured solution: nodal interpolant of sum-of-sines, zeroed on
    # the boundary (benchmark_03.h:362-378's function, Dirichlet variant)
    xs = interpolate(mf.dof_handler).astype(mf.dtype)
    xs[np.asarray(op._bdofs)] = 0.0
    xstar_b = mm.from_dof_vector(xs)
    t_setup = time.perf_counter() - t0

    b = op.vmult(xstar_b)
    np.asarray(mm.to_dof_vector(b))  # sync: exclude compile from the solve
    t0 = time.perf_counter()
    if host_loop:
        # warm up EVERY program the host-stepping CG dispatches (each
        # level's smoother/transfer/coarse jits compile on first use, which
        # would otherwise land inside the timed loop)
        _x, _it, _ = solve_cg(op, b, M=gmg, tol=tol, max_iter=2, dot=mm.dot)
        float(mm.dot(_x, _x))
        t_warm = time.perf_counter() - t0
        t0 = time.perf_counter()
        x, iters, res = solve_cg(op, b, M=gmg, tol=tol, max_iter=100,
                                 dot=mm.dot)
    else:
        solver = gmg.make_device_solver(tol=tol, max_iter=100)
        _x, _it, _ = solver(b)  # ONE compile: the whole while_loop program
        t_warm = time.perf_counter() - t0
        t0 = time.perf_counter()
        x, iters, res = solver(b)
    r = b - op.vmult(x)
    rnorm = float(jnp.sqrt(mm.dot(r, r)))  # fetch-syncs the chain
    t_solve = time.perf_counter() - t0
    bnorm = float(jnp.sqrt(mm.dot(b, b)))
    free = ~mf.constraints.constrained_dof_marker()
    err = float(
        np.abs((mm.to_dof_vector(x) - np.asarray(xs))[free]).max()
    )
    table.add_value("solver", "brick-GMG-CG")
    table.add_value("geometry", geometry)
    table.add_value("n_ref", nref)
    table.add_value("degree", degree)
    table.add_value("n_dofs", mf.n_dofs)
    table.add_value("iters", iters)
    table.add_value("rel_res", rnorm / bnorm)
    table.set_scientific("rel_res", True)
    table.add_value("err_max", err)
    table.set_scientific("err_max", True)
    table.add_value("setup_s", round(t_setup, 1))
    table.add_value("warmup_s", round(t_warm, 1))
    table.add_value("solve_s", round(t_solve, 3))
    table.add_value("s_per_iter", round(t_solve / max(iters, 1), 4))
    print(table.write_text())
    return table


def main(argv=None):
    from dealii_matrixfree_hanging_nodes.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    argv = sys.argv[1:] if argv is None else argv
    # true f64 (outside pytest, x64 is off by default and the f64 dtype
    # silently degrades to f32, hiding the 1e-10 tolerances)
    jax.config.update("jax_enable_x64", True)
    args = [a for a in argv if not a.startswith("--")]
    nref = int(args[0]) if len(args) > 0 else 3
    degree = int(args[1]) if len(args) > 1 else 2
    if "--bricks" in argv:
        geometry = args[2] if len(args) > 2 else "quadrant"
        run_bricks(nref, degree, geometry, dtype=np.float64,
                   host_loop="--host-loop" in argv)
    else:
        run(nref, degree)


if __name__ == "__main__":
    main()
