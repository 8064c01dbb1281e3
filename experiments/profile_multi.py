"""Per-op device-time profile of the blocked multi-RHS brick vmult vs the
single-RHS vmult (VERDICT r2 item 7: >=1.5x per-vector at k=8 on the chip).

  python experiments/profile_multi.py [nref] [degree] [k] [reps]

Prints both per-op tables plus a per-vector comparison, then
PROFILE-MULTI-DONE.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from profile_vmult import parse_device_ops, profile_step, report  # noqa: E402


def main():
    nref = int(sys.argv[1]) if len(sys.argv) > 1 else 7
    degree = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    k = int(sys.argv[3]) if len(sys.argv) > 3 else 8
    n_reps = int(sys.argv[4]) if len(sys.argv) > 4 else 20

    import jax.numpy as jnp
    import dealii_matrixfree_hanging_nodes as mfhn
    from dealii_matrixfree_hanging_nodes.matrix_free import MatrixFree
    from dealii_matrixfree_hanging_nodes.bricks import BrickLaplaceMM

    tria = mfhn.create_quadrant(3, nref)
    mf = MatrixFree(tria, degree=degree, dtype=np.float32)
    op = BrickLaplaceMM(mf, matmul_precision=os.environ.get(
        "BENCH_PRECISION", "high"))
    rng = np.random.default_rng(0)
    src = op.from_dof_vector(rng.standard_normal(mf.n_dofs).astype(np.float32))
    srck = jnp.stack([src] * k)
    scale = jnp.float32(1e-3)

    variants = [
        ("single", lambda x: op.vmult(x * scale)),
        ("multi", lambda x: op.vmult_multi(x * scale)),
    ]
    walls, logs, summaries = {}, {}, {}
    for (tag, step), x0 in zip(variants, [src, srck]):
        logs[tag], walls[tag] = profile_step(tag, step, x0, n_reps)
    for tag, _ in variants:
        per_op, total = parse_device_ops(logs[tag])
        summaries[tag] = report(tag, per_op, total, n_reps)
        print(f"{tag}: wall {walls[tag]*1e3:.2f} ms/rep, device "
              f"{total/n_reps/1e3:.2f} ms/rep")
    ts = sum(summaries["single"].values())
    tm = sum(summaries["multi"].values())
    if ts and tm:
        print(f"\nper-vector device: single {ts/1e3:.2f} ms, "
              f"multi/k {tm/k/1e3:.2f} ms, speedup x{ts*k/tm:.2f}")
    print(f"per-vector wall: single {walls['single']*1e3:.2f} ms, "
          f"multi/k {walls['multi']*1e3/k:.2f} ms, "
          f"speedup x{walls['single']*k/walls['multi']:.2f}")
    print("PROFILE-MULTI-DONE")


if __name__ == "__main__":
    main()
