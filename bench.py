"""Headline benchmark: 3D degree-4 Laplace vmult throughput on the quadrant
AMR geometry (the reference's flagship experiment, benchmark_03.h:382-532)
on one GPU.

Prints one JSON line with the throughput, the per-window times and the
device it ran on. Without a GPU it exits non-zero.

Environment: BENCH_NREF (7), BENCH_DEGREE (4), BENCH_ENGINE (bricks|index),
BENCH_DTYPE (f32|f64), BENCH_PRECISION (a jax.default_matmul_precision
name; the operator's default when unset), BENCH_REPS (100 per window),
BENCH_TRIALS (5 windows).
"""

import json
import os
import sys
import time

import numpy as np


def build_operator(engine: str, mf, precision: str | None):
    """(operator, device input) for the named engine. No fallback: a
    failure of the requested engine propagates."""
    import jax.numpy as jnp

    kw = {} if precision is None else {"matmul_precision": precision}
    rng = np.random.default_rng(0)
    src = rng.standard_normal(mf.n_dofs).astype(mf.dtype)
    if engine == "bricks":
        from dealii_matrixfree_hanging_nodes.bricks import BrickLaplaceMM

        op = BrickLaplaceMM(mf, **kw)
        return op, op.from_dof_vector(src)
    if engine == "index":
        from dealii_matrixfree_hanging_nodes.models.laplace import (
            LaplaceOperator,
        )

        return LaplaceOperator(mf, **kw), jnp.asarray(src)
    raise ValueError(f"unknown BENCH_ENGINE {engine!r} (bricks|index)")


def main():
    import jax

    from dealii_matrixfree_hanging_nodes.utils.compile_cache import (
        enable_compile_cache,
    )
    from dealii_matrixfree_hanging_nodes.utils.device import (
        NoGPUError,
        nvidia_smi_line,
        require_gpu,
    )

    enable_compile_cache()
    try:
        device = require_gpu()
    except NoGPUError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2

    nref = int(os.environ.get("BENCH_NREF", "7"))
    degree = int(os.environ.get("BENCH_DEGREE", "4"))
    n_reps = int(os.environ.get("BENCH_REPS", "100"))
    n_trials = int(os.environ.get("BENCH_TRIALS", "5"))
    engine = os.environ.get("BENCH_ENGINE", "bricks")
    dtype_name = os.environ.get("BENCH_DTYPE", "f32")
    if dtype_name not in ("f32", "f64"):
        raise ValueError(f"unknown BENCH_DTYPE {dtype_name!r} (f32|f64)")
    if dtype_name == "f64":
        jax.config.update("jax_enable_x64", True)
    dtype = np.float64 if dtype_name == "f64" else np.float32

    import jax.numpy as jnp
    import dealii_matrixfree_hanging_nodes as mfhn
    from dealii_matrixfree_hanging_nodes.matrix_free import MatrixFree
    from dealii_matrixfree_hanging_nodes.utils.timing import repeat_timed

    mf = MatrixFree(mfhn.create_quadrant(3, nref), degree=degree, dtype=dtype)
    op, src = build_operator(engine, mf, os.environ.get("BENCH_PRECISION"))

    scale = jnp.asarray(1e-3, dtype)
    t0 = time.perf_counter()
    op.vmult(src).block_until_ready()
    first_call_s = time.perf_counter() - t0
    res = repeat_timed(lambda x: op.vmult(x * scale), src, n_reps=n_reps,
                       n_trials=n_trials)
    dt = float(np.median(res.times))
    print(
        json.dumps(
            {
                "metric": f"laplace_vmult_p{degree}_quadrant_throughput"
                + ("_f64" if dtype_name == "f64" else ""),
                "value": mf.n_dofs / dt / 1e9,
                "unit": "GDoF/s",
                "engine": engine,
                "n_dofs": mf.n_dofs,
                "precision": op._matmul_precision,
                "first_call_s": first_call_s,
                "windows_ms": [t * 1e3 for t in res.times],
                "device": device,
                "nvidia_smi": nvidia_smi_line().splitlines(),
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
