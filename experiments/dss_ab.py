"""On-chip A/B of the two cross-brick DSS formulations.

pool: scatter-add interface classes into per-pool rows, gather back.
pair: gather-only — each interface copy sums its contributor list from
per-slot tables (no XLA scatter in the hot path).

Both vmult (constrained) and vmult_plain are timed interleaved in one
window so the ratio is meaningful (utils.timing.repeat_timed_paired).
Decides the production default (PERF.md queue item: benchmark Mosaic/DSS
alternatives on-chip before adopting).

  python experiments/dss_ab.py [nref] [degree] [geometry]
"""

import sys
import numpy as np
import jax.numpy as jnp

try:
    import dealii_matrixfree_hanging_nodes  # noqa: F401
except ModuleNotFoundError:  # checkout use without `pip install -e .`
    sys.path.insert(0, __file__.rsplit("/", 2)[0])

import dealii_matrixfree_hanging_nodes as mfhn
from dealii_matrixfree_hanging_nodes.matrix_free import MatrixFree
from dealii_matrixfree_hanging_nodes.bricks import BrickLaplaceMM
from dealii_matrixfree_hanging_nodes.utils.timing import repeat_timed_paired


def main(nref=7, degree=4, geometry="quadrant"):
    t = mfhn.create_geometry(geometry, 3, nref)
    mf = MatrixFree(t, degree, dtype=np.float32)
    op_pool = BrickLaplaceMM(mf, dss_mode="pool")
    op_pair = BrickLaplaceMM(mf, dss_mode="pair")
    rng = np.random.default_rng(0)
    src = rng.standard_normal((op_pool.bs.n_bricks, op_pool.N3p)).astype(
        np.float32
    )
    bv0 = jnp.asarray(src)
    scale = jnp.float32(1e-3)

    # exactness cross-check on-device first
    d = np.abs(
        np.asarray(op_pool.vmult(bv0 * scale))
        - np.asarray(op_pair.vmult(bv0 * scale))
    ).max()
    print(f"pool-vs-pair max abs diff: {d:.3e}")

    variants = {
        "plain_pool": lambda x: op_pool.vmult_plain(x * scale),
        "plain_pair": lambda x: op_pair.vmult_plain(x * scale),
        "full_pool": lambda x: op_pool.vmult(x * scale),
        "full_pair": lambda x: op_pair.vmult(x * scale),
    }
    names = list(variants)
    n_dofs = mf.n_dofs
    for trial in range(3):
        results = repeat_timed_paired(
            [variants[n] for n in names], [bv0] * len(names),
            n_reps=60, n_trials=2)
        base = results[0].min
        print(f"-- window {trial}")
        for n, r in zip(names, results):
            print(
                f"{n:<12} min {r.min*1e3:8.3f} ms  avg {r.avg*1e3:8.3f} ms  "
                f"{n_dofs/r.min/1e9:6.3f} GDoF/s  vs plain_pool "
                f"{100*(r.min/base-1):+6.2f}%"
            )
    print("DSS-AB-DONE")


if __name__ == "__main__":
    main(
        int(sys.argv[1]) if len(sys.argv) > 1 else 7,
        int(sys.argv[2]) if len(sys.argv) > 2 else 4,
        sys.argv[3] if len(sys.argv) > 3 else "quadrant",
    )
