#!/usr/bin/env python3
"""Precision / selection-operand / layout A/B for the f32 brick vmult on the
GPU, in one process (compare variants only within one run).

Variants of BrickLaplaceMM at the flagship size (quadrant, p=4), each timed
as the median of 3 windows x 20 reps and compared with the f64 index-engine
reference computed on the card:

- highest:       operator dots "highest", selection dots exact, f32 operands
                 (the default)
- highest_bf16:  as highest, selection operands staged as bf16
- bf16_3x:       operator dots BF16_BF16_F32_X3, selection dots exact
- tf32_3x:       operator dots TF32_TF32_F32_X3, selection dots exact
- high:          operator dots "high" (single-pass TF32), selection exact
- high_lossy:    "high" with selection dots at the operator precision and
                 bf16 selection operands (the pre-GPU configuration)
- auto_layout:   highest, compiled with AUTO operand layouts and the
                 operands re-staged in the executable's preferred formats
- highest (again, for the spread)

    python experiments/precision_ab.py [nref] [degree]
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

try:
    import dealii_matrixfree_hanging_nodes  # noqa: F401
except ModuleNotFoundError:  # checkout use without `pip install -e .`
    sys.path.insert(0, __file__.rsplit("/", 2)[0])

SELECTION = ("E", "Es", "EsI", "EscX", "EFX", "Ssub", "W_col2im")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    nref = int(argv[0]) if argv else 7
    degree = int(argv[1]) if len(argv) > 1 else 4

    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    import dealii_matrixfree_hanging_nodes as mfhn
    from dealii_matrixfree_hanging_nodes import bricks
    from dealii_matrixfree_hanging_nodes.matrix_free import MatrixFree
    from dealii_matrixfree_hanging_nodes.models.laplace import (
        LaplaceOperator,
    )
    from dealii_matrixfree_hanging_nodes.utils.compile_cache import (
        enable_compile_cache,
    )
    from dealii_matrixfree_hanging_nodes.utils.device import (
        nvidia_smi_line,
        require_gpu,
    )
    from dealii_matrixfree_hanging_nodes.utils.timing import repeat_timed

    enable_compile_cache()
    dev = require_gpu()
    print(json.dumps({"device": dev, "nvidia_smi": nvidia_smi_line()}),
          flush=True)

    tria = mfhn.create_quadrant(3, nref)
    mf32 = MatrixFree(tria, degree, dtype=np.float32)
    mf64 = MatrixFree(tria, degree, dtype=np.float64)
    src = np.random.default_rng(0).standard_normal(mf32.n_dofs)
    bl = bricks.BrickLaplaceMM(mf32)
    bv_np = bl.from_dof_vector(src.astype(np.float32), to_device=False)
    hang = mf32.constraints.constrained_dof_marker()

    ref = np.array(LaplaceOperator(mf64).vmult(jnp.asarray(src)))
    ref[hang] = 0.0
    scale_ref = np.abs(ref).max()
    bv = jnp.asarray(bv_np)
    f32_arrays = bl._stage()
    bf16_arrays = {
        k: (v.astype(jnp.bfloat16) if k in SELECTION else v)
        for k, v in f32_arrays.items()
    }
    scale = jnp.asarray(1e-3, jnp.float32)

    def run_variant(name, prec, exact=True, arrays=f32_arrays, plain=False):
        bricks._EXACT = jax.lax.Precision.HIGHEST if exact else None
        impl = bl._vmult_plain_impl if plain else bl._vmult_impl
        jitted = jax.jit(impl)

        def f(x):
            with jax.default_matmul_precision(prec):
                return jitted(x, arrays)

        return measure(name, f)

    def measure(name, f):
        t0 = time.perf_counter()
        try:
            y = f(bv)
            y.block_until_ready()
        except (jax.errors.JaxRuntimeError, ValueError) as e:  # unsupported
            print(json.dumps({"variant": name, "error": str(e)[:300]}),
                  flush=True)
            return None
        first = time.perf_counter() - t0
        got = bl.to_dof_vector(y, zero_hanging=True)
        err = float(np.abs(got - ref).max() / scale_ref)
        res = repeat_timed(lambda x: f(x * scale), bv, n_reps=20, n_trials=3)
        row = {"variant": name, "rel_err_vs_f64": err,
               "first_call_s": first,
               "ms_windows": [t * 1e3 for t in res.times],
               "ms_median": float(np.median(res.times) * 1e3)}
        print(json.dumps(row), flush=True)
        return row

    run_variant("highest", "highest")
    run_variant("highest_bf16", "highest", arrays=bf16_arrays)
    run_variant("bf16_3x", "BF16_BF16_F32_X3")
    run_variant("tf32_3x", "TF32_TF32_F32_X3")
    run_variant("high", "high")
    run_variant("high_lossy", "high", exact=False, arrays=bf16_arrays)
    run_variant("plain_highest", "highest", plain=True)
    run_variant("plain_highest_bf16", "highest", arrays=bf16_arrays,
                plain=True)

    # AUTO operand layouts: compile once, re-stage every operand in the
    # executable's preferred format, time the compiled executable
    from jax.experimental.layout import Format, Layout
    from jax.sharding import SingleDeviceSharding

    bricks._EXACT = jax.lax.Precision.HIGHEST
    fmt_bv = Format(Layout(tuple(range(bv.ndim))),
                    SingleDeviceSharding(jax.devices()[0]))
    auto = jax.tree.map(lambda _: Format(Layout.AUTO), f32_arrays)
    t0 = time.perf_counter()
    with jax.default_matmul_precision("highest"):
        compiled = (jax.jit(bl._vmult_impl, in_shardings=(fmt_bv, auto))
                    .lower(bv, f32_arrays).compile())
    auto_arrays = jax.tree.map(jax.device_put, f32_arrays,
                               compiled.input_formats[0][1])
    print(json.dumps({"auto_layout_compile_s": time.perf_counter() - t0}),
          flush=True)
    measure("auto_layout", lambda x: compiled(x, auto_arrays))

    run_variant("highest_again", "highest")

    idx = LaplaceOperator(mf32)
    src32 = jnp.asarray(src, jnp.float32)
    for prec in ("highest", "high"):
        idx._matmul_precision = prec
        t0 = time.perf_counter()
        y = idx.vmult(src32)
        y.block_until_ready()
        first = time.perf_counter() - t0
        got = np.array(y, dtype=np.float64)
        got[hang] = 0.0
        res = repeat_timed(lambda x: idx.vmult(x * scale), src32,
                           n_reps=20, n_trials=3)
        print(json.dumps({
            "variant": f"index_{prec}",
            "rel_err_vs_f64": float(np.abs(got - ref).max() / scale_ref),
            "first_call_s": first,
            "ms_windows": [t * 1e3 for t in res.times],
            "ms_median": float(np.median(res.times) * 1e3)}), flush=True)


if __name__ == "__main__":
    main()
