"""On-chip A/B of the fill-pass formulations (brick engine HN overhead).

Modes:
  exch   — round-2 exchange-domain fill (EscX/EFX one-hot pair)
  vol    — volume-domain fill: conv-patch extract + separable col2im
  vol1h  — volume fill but one-hot E scatter (isolates the col2im gain)

For each mode, times constrained vmult AND the plain (constraints-off)
vmult interleaved in one window (utils.timing.repeat_timed_paired) and
prints the per-mode HN overhead — the
benchmark_03 ±constraints pair (benchmark_03.h:510-532) this engine is
judged on.

  python experiments/fill_ab.py [nref] [degree] [geometry]
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402

import dealii_matrixfree_hanging_nodes as mfhn  # noqa: E402
from dealii_matrixfree_hanging_nodes.matrix_free import MatrixFree  # noqa: E402
from dealii_matrixfree_hanging_nodes.bricks import BrickLaplaceMM  # noqa: E402
from dealii_matrixfree_hanging_nodes.utils.timing import (  # noqa: E402
    repeat_timed_paired,
)


def main(nref=7, degree=4, geometry="quadrant"):
    t = mfhn.create_geometry(geometry, 3, nref)
    mf = MatrixFree(t, degree, dtype=np.float32)
    combos_env = os.environ.get("FILL_AB_COMBOS", "exch,vol,vol1h")
    all_combos = {
        "exch": dict(fill_mode="exchange", col2im="onehot"),
        "exch_sep": dict(fill_mode="exchange", col2im="sep"),
        "vol": dict(fill_mode="volume", col2im="sep"),
        "vol1h": dict(fill_mode="volume", col2im="onehot"),
        "hyb": dict(fill_mode="hybrid", col2im="onehot"),
        "inp": dict(fill_mode="input", col2im="onehot"),
    }
    combos = [(n, all_combos[n]) for n in combos_env.split(",")]
    ops = {n: BrickLaplaceMM(mf, **kw) for n, kw in combos}
    rng = np.random.default_rng(0)
    op0 = ops[combos[0][0]]
    src = rng.standard_normal((op0.bs.n_bricks, op0.N3p)).astype(np.float32)
    bv0 = jnp.asarray(src)
    scale = jnp.float32(1e-3)

    # compare reduced images (input-fill outputs carry no hanging values)
    ref = op0.to_dof_vector(op0.vmult(bv0 * scale), zero_hanging=True)
    for n, op in ops.items():
        got = op.to_dof_vector(op.vmult(bv0 * scale), zero_hanging=True)
        d = np.abs(got - ref).max()
        print(f"{n}: max|reduced diff| vs {combos[0][0]} = {d:.3e}")

    fns = []
    names = []
    for n, op in ops.items():
        fns.append(lambda x, o=op: o.vmult(x * scale))
        names.append(f"{n} full")
        fns.append(lambda x, o=op: o.vmult_plain(x * scale))
        names.append(f"{n} plain")
    n_dofs = mf.n_dofs
    for trial in range(3):
        results = repeat_timed_paired(fns, [bv0] * len(fns),
                                      n_reps=30, n_trials=2)
        print(f"-- window {trial}")
        for i, (n, _) in enumerate(combos):
            tf = results[2 * i].min
            tp = results[2 * i + 1].min
            print(f"{n:6s} full {tf*1e3:8.3f} ms  plain {tp*1e3:8.3f} ms"
                  f"  {n_dofs/tf/1e9:6.3f} GDoF/s"
                  f"  overhead {100*(tf/tp-1):+6.2f}%")
    print("FILL-AB-DONE")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 7,
         int(sys.argv[2]) if len(sys.argv) > 2 else 4,
         sys.argv[3] if len(sys.argv) > 3 else "quadrant")
