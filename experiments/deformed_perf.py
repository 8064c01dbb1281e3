"""Deformed (high-order mapping) brick vmult throughput vs Cartesian
(VERDICT r2 weak item 7; reference exercises TestHighOrderMapping at
benchmark_01.h:227-242). Times both operators on the same mesh in one
window (interleaved pairs) so the deformed/Cartesian ratio is
drift-free.

  python experiments/deformed_perf.py [nref] [degree]
"""

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
from dealii_matrixfree_hanging_nodes.bricks import BrickLaplaceMM
from dealii_matrixfree_hanging_nodes.utils.timing import repeat_timed_paired


def main(nref=6, degree=4):
    t = mfhn.create_quadrant(3, nref)
    mf_c = MatrixFree(t, degree, dtype=np.float32)
    mf_d = MatrixFree(t, degree, dtype=np.float32, high_order_mapping=True)
    op_c = BrickLaplaceMM(mf_c)
    op_d = BrickLaplaceMM(mf_d)
    src = np.random.default_rng(0).standard_normal(
        (op_c.bs.n_bricks, op_c.N3p)).astype(np.float32)
    bv = jnp.asarray(src)
    scale = jnp.float32(1e-3)
    res_c, res_d = repeat_timed_paired(
        [lambda x: op_c.vmult(x * scale), lambda x: op_d.vmult(x * scale)],
        [bv, bv], n_reps=50, n_trials=4,
    )
    g_c = mf_c.n_dofs / res_c.min / 1e9
    g_d = mf_d.n_dofs / res_d.min / 1e9
    print(f"quadrant nref={nref} p={degree}  n_dofs {mf_c.n_dofs}")
    print(f"cartesian min {res_c.min*1e3:9.3f} ms  {g_c:6.3f} GDoF/s")
    print(f"deformed  min {res_d.min*1e3:9.3f} ms  {g_d:6.3f} GDoF/s")
    print(f"deformed/cartesian slowdown x{res_d.min/res_c.min:.2f}")
    print("DONE-ALL")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 6,
         int(sys.argv[2]) if len(sys.argv) > 2 else 4)
