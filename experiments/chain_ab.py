"""A/B of the constraint-chain schedules on the brick vmult (round 4).

Compares chain_mode="flat" (staged folds on the full cols array) against
chain_mode="compact" (all chain work in the [n_hn, n_loc] space, sparse
delta assembly) at a given config, in the given fill mode, with the
paired-window protocol. Reports the honest HN overhead (full vs plain)
for each schedule.

  python experiments/chain_ab.py [nref] [degree] [geometry] [fill_mode]
"""

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp

try:
    import dealii_matrixfree_hanging_nodes  # noqa: F401
except ModuleNotFoundError:  # checkout use without `pip install -e .`
    sys.path.insert(0, __file__.rsplit("/", 2)[0])

import dealii_matrixfree_hanging_nodes as mfhn  # noqa: E402
from dealii_matrixfree_hanging_nodes.matrix_free import MatrixFree  # noqa: E402
from dealii_matrixfree_hanging_nodes.bricks import BrickLaplaceMM  # noqa: E402
from dealii_matrixfree_hanging_nodes.utils.timing import (  # noqa: E402
    repeat_timed_paired,
)


def main(nref=7, degree=4, geometry="quadrant", fill_mode="input"):
    t = mfhn.create_geometry(geometry, 3, nref)
    mf = MatrixFree(t, degree, dtype=np.float32)
    modes = os.environ.get("CHAIN_AB_MODES", "flat,compact").split(",")
    ops = {}
    for cm in modes:
        os.environ["BRICK_CHAIN"] = cm
        ops[cm] = BrickLaplaceMM(mf, fill_mode=fill_mode)
    os.environ.pop("BRICK_CHAIN", None)
    rng = np.random.default_rng(0)
    op0 = ops[modes[0]]
    src = rng.standard_normal((op0.bs.n_bricks, op0.N3p)).astype(np.float32)
    bv0 = jnp.asarray(src)
    scale = jnp.float32(1e-3)

    ref = op0.to_dof_vector(op0.vmult(bv0 * scale), zero_hanging=True)
    for n, op in ops.items():
        got = op.to_dof_vector(op.vmult(bv0 * scale), zero_hanging=True)
        d = np.abs(got - ref).max()
        print(f"{n}: max|reduced diff| vs {modes[0]} = {d:.3e}")

    fns, names = [], []
    for n, op in ops.items():
        fns.append(lambda x, o=op: o.vmult(x * scale))
        names.append(f"{n} full")
    fns.append(lambda x, o=op0: o.vmult_plain(x * scale))
    names.append("plain")
    n_dofs = mf.n_dofs
    for trial in range(4):
        results = repeat_timed_paired(fns, [bv0] * len(fns),
                                      n_reps=50, n_trials=1)
        tp = results[-1].min
        print(f"-- window {trial}")
        for nm, r in zip(names, results):
            g = n_dofs / r.min / 1e9
            ov = 100 * (r.min / tp - 1)
            print(f"{nm:<14} {r.min*1e3:8.3f} ms  {g:6.3f} GDoF/s  "
                  f"overhead {ov:+.2f}%")
    print("CHAIN-AB-DONE")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 7,
         int(sys.argv[2]) if len(sys.argv) > 2 else 4,
         sys.argv[3] if len(sys.argv) > 3 else "quadrant",
         sys.argv[4] if len(sys.argv) > 4 else "input")
