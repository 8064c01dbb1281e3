#!/usr/bin/env python3
"""GPU smoke test of the main path: the 3D degree-4 Laplace vmult on the
quadrant AMR mesh through the brick engine, checked against an f64
reference on the card and the host scipy oracle, plus a device-resident
GMG-CG solve.

    python chip_smoke.py           # one GPU: phases device .. solver
    python chip_smoke.py --four    # four GPUs: distributed vmults vs one card

Each phase prints one JSON line. The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
A failed phase raises, so the script exits non-zero and prints no result;
without a GPU it exits non-zero before any work.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time

import numpy as np

F32_TOL = 1e-4  # f32 paths vs an f64 reference (relative to max |ref|)
F64_TOL = 1e-12
DIST_TOL = 1e-5  # distributed f32 vmults vs the one-card f32 vmult

FLAGSHIP = dict(nref=7, degree=4)  # ~17.6 MDoF, bench.py's default size
ORACLE = dict(nref=4, degree=4)
SOLVER = dict(nref=6, degree=4, tol=1e-10, max_iter=100)
REPS, WINDOWS = 20, 3


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def rel_err(got, ref) -> float:
    return float(np.abs(np.asarray(got) - ref).max() / np.abs(ref).max())


def check(name: str, err: float, tol: float) -> None:
    if not err <= tol:  # also catches NaN
        raise AssertionError(f"{name}: relative error {err:.3e} > {tol:.0e}")


def time_ms(step, x, reps: int = REPS, windows: int = WINDOWS) -> float:
    """Median over `windows` windows of ms per call; each window runs
    `reps` calls and closes with block_until_ready."""
    from dealii_matrixfree_hanging_nodes.utils.timing import repeat_timed

    res = repeat_timed(step, x, n_reps=reps, n_trials=windows)
    return float(np.median(res.times) * 1e3)


def first_call_s(fn, x) -> float:
    """Seconds of the first call (compilation + one run)."""
    t0 = time.perf_counter()
    fn(x).block_until_ready()
    return time.perf_counter() - t0


def brick_dofs(op, bv):
    return op.to_dof_vector(bv, zero_hanging=True)


def index_dofs(mf, v):
    out = np.array(v, dtype=np.float64)
    out[mf.constraints.constrained_dof_marker()] = 0.0
    return out


# --------------------------------------------------------------- host setup
def setup_flagship(nref: int, degree: int, seed: int = 0) -> dict:
    """All host work of the flagship phases, done before the first device
    array: meshes, MatrixFree (f32 and f64), both brick engines and the
    brick-layout inputs."""
    import dealii_matrixfree_hanging_nodes as mfhn
    from dealii_matrixfree_hanging_nodes import native
    from dealii_matrixfree_hanging_nodes.bricks import BrickLaplaceMM
    from dealii_matrixfree_hanging_nodes.matrix_free import MatrixFree

    t0 = time.perf_counter()
    tria = mfhn.create_quadrant(3, nref)
    mf32 = MatrixFree(tria, degree, dtype=np.float32)
    mf64 = MatrixFree(tria, degree, dtype=np.float64)
    src = np.random.default_rng(seed).standard_normal(mf32.n_dofs)
    bl32 = BrickLaplaceMM(mf32)
    bl64 = BrickLaplaceMM(mf64)
    s = dict(
        tria=tria, mf32=mf32, mf64=mf64, src=src, bl32=bl32, bl64=bl64,
        bv32=bl32.from_dof_vector(src.astype(np.float32), to_device=False),
        bv64=bl64.from_dof_vector(src, to_device=False),
    )
    s["setup_s"] = time.perf_counter() - t0
    s["native_setup_core"] = native.available()
    return s


# ------------------------------------------------------------------- phases
def phase_flagship_f32(s: dict, reps: int = REPS) -> dict:
    """Brick f32 vmult (default precision) vs the on-card f64 reference of
    the index engine; times brick constrained/plain and index f32."""
    import jax
    import jax.numpy as jnp
    from dealii_matrixfree_hanging_nodes.models.laplace import (
        LaplaceOperator,
    )

    mf32, mf64, bl = s["mf32"], s["mf64"], s["bl32"]
    ref_op = LaplaceOperator(mf64, matmul_precision="highest")
    ref = index_dofs(mf64, ref_op.vmult(jnp.asarray(s["src"])))
    s["ref"] = ref

    bv = jnp.asarray(s["bv32"])
    compile_s = first_call_s(bl.vmult, bv)
    err = rel_err(brick_dofs(bl, bl.vmult(bv)), ref)
    check("brick f32 vs f64 reference", err, F32_TOL)

    scale = jnp.asarray(1e-3, jnp.float32)
    ms = time_ms(lambda x: bl.vmult(x * scale), bv, reps)
    first_call_s(bl.vmult_plain, bv)
    ms_plain = time_ms(lambda x: bl.vmult_plain(x * scale), bv, reps)

    idx = LaplaceOperator(mf32)
    src32 = jnp.asarray(s["src"], jnp.float32)
    idx_compile_s = first_call_s(idx.vmult, src32)
    idx_err = rel_err(index_dofs(mf32, idx.vmult(src32)), ref)
    check("index f32 vs f64 reference", idx_err, F32_TOL)
    idx_ms = time_ms(lambda x: idx.vmult(x * scale), src32, reps)

    with jax.default_matmul_precision(bl._matmul_precision):
        hlo = bl._jit_vmult.lower(bv, bl._stage()).as_text()
    # x64 is on for the f64 phases; the f32 program may hold no f64 array
    # (weakly typed Python scalars enter as f64 scalars and convert)
    if re.search(r"tensor<(\d+x)+f64>", hlo):
        raise AssertionError("the f32 brick vmult program holds f64 arrays")
    # memory_stats() is None on backends without an allocator report
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    out = dict(
        n_dofs=mf32.n_dofs, precision=bl._matmul_precision,
        rel_err_vs_f64=err, tol=F32_TOL, compile_s=compile_s,
        ms_vmult=ms, ms_vmult_plain=ms_plain,
        gdofs_per_s=mf32.n_dofs / ms / 1e6,
        index_rel_err_vs_f64=idx_err, index_compile_s=idx_compile_s,
        index_ms_vmult=idx_ms, f64_ops_in_f32_program=False,
        peak_bytes_in_use=peak,
    )
    emit("flagship_f32", **out)
    return out


def phase_flagship_f64(s: dict, reps: int = REPS) -> dict:
    import jax.numpy as jnp

    bl = s["bl64"]
    bv = jnp.asarray(s["bv64"])
    compile_s = first_call_s(bl.vmult, bv)
    err = rel_err(brick_dofs(bl, bl.vmult(bv)), s["ref"])
    check("brick f64 vs f64 reference", err, F64_TOL)
    scale = jnp.asarray(1e-3, jnp.float64)
    ms = time_ms(lambda x: bl.vmult(x * scale), bv, reps)
    out = dict(n_dofs=s["mf64"].n_dofs, rel_err_vs_f64=err, tol=F64_TOL,
               compile_s=compile_s, ms_vmult=ms)
    emit("flagship_f64", **out)
    return out


def phase_oracle(nref: int, degree: int, seed: int = 1) -> dict:
    """Both brick precisions and the index engine vs the host scipy f64
    oracle (assembled C^T A C)."""
    import jax.numpy as jnp
    import dealii_matrixfree_hanging_nodes as mfhn
    from dealii_matrixfree_hanging_nodes.bricks import BrickLaplaceMM
    from dealii_matrixfree_hanging_nodes.matrix_free import MatrixFree
    from dealii_matrixfree_hanging_nodes.models.laplace import (
        LaplaceOperator,
    )
    from dealii_matrixfree_hanging_nodes.oracle import vmult_oracle

    tria = mfhn.create_quadrant(3, nref)
    out = {}
    for dt, tol in ((np.float32, F32_TOL), (np.float64, F64_TOL)):
        mf = MatrixFree(tria, degree, dtype=dt)
        if not out:
            src = np.random.default_rng(seed).standard_normal(mf.n_dofs)
            ref = vmult_oracle(tria, degree, src)
        bl = BrickLaplaceMM(mf)
        bv = bl.from_dof_vector(src.astype(dt))
        name = np.dtype(dt).name
        out[f"brick_{name}"] = rel_err(brick_dofs(bl, bl.vmult(bv)), ref)
        check(f"brick {name} vs oracle", out[f"brick_{name}"], tol)
        idx = LaplaceOperator(mf).vmult(jnp.asarray(src.astype(dt)))
        out[f"index_{name}"] = rel_err(index_dofs(mf, idx), ref)
        check(f"index {name} vs oracle", out[f"index_{name}"], tol)
    emit("oracle", nref=nref, degree=degree, n_dofs=int(len(src)),
         rel_err=out, tol={"float32": F32_TOL, "float64": F64_TOL})
    return out


def phase_solver(nref: int, degree: int, tol: float, max_iter: int,
                 seed: int = 2) -> dict:
    """Device-resident GMG-preconditioned CG (f64) on the brick engine."""
    import jax.numpy as jnp
    from dealii_matrixfree_hanging_nodes.models.multigrid_bricks import (
        BrickGMGPreconditioner,
    )

    t0 = time.perf_counter()
    gmg = BrickGMGPreconditioner("quadrant", 3, nref, degree)
    op, mm, mf = gmg.fine_op, gmg.fine_mm, gmg.fine_mf
    rhs = np.random.default_rng(seed).standard_normal(mf.n_dofs)
    b = op.project_rhs(mm.from_dof_vector(rhs.astype(mf.dtype)))
    setup_s = time.perf_counter() - t0
    solver = gmg.make_device_solver(tol=tol, max_iter=max_iter)
    t0 = time.perf_counter()
    solver(b)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    x, iters, res = solver(b)
    solve_s = time.perf_counter() - t0
    r = b - op.vmult(x)
    true_rel = float(jnp.sqrt(mm.dot(r, r)) / jnp.sqrt(mm.dot(b, b)))
    bnorm = float(jnp.sqrt(mm.dot(b, b)))
    if not (iters < max_iter and res <= tol * bnorm):
        raise AssertionError(
            f"GMG-CG did not converge: {iters} iterations, residual "
            f"{res:.3e} > {tol:.0e} * |b| = {tol * bnorm:.3e}"
        )
    out = dict(n_dofs=mf.n_dofs, dtype=np.dtype(mf.dtype).name, tol=tol,
               iterations=iters, max_iter=max_iter, rel_residual=res / bnorm,
               true_rel_residual=true_rel, setup_s=setup_s,
               compile_s=compile_s, solve_s=solve_s)
    emit("solver", **out)
    return out


def phase_four(nref: int, degree: int, devices, reps: int = REPS,
               seed: int = 3) -> dict:
    """DistributedBrickLaplace and the halo-exchange DistributedLaplace over
    the given devices vs the one-card BrickLaplaceMM on devices[0]."""
    import jax.numpy as jnp
    import dealii_matrixfree_hanging_nodes as mfhn
    from dealii_matrixfree_hanging_nodes.bricks import BrickLaplaceMM
    from dealii_matrixfree_hanging_nodes.matrix_free import MatrixFree
    from dealii_matrixfree_hanging_nodes.parallel.bricks_distributed import (
        DistributedBrickLaplace,
    )
    from dealii_matrixfree_hanging_nodes.parallel.distributed import (
        DistributedLaplace,
    )
    from dealii_matrixfree_hanging_nodes.parallel.partition import (
        hanging_nodes_weighting,
    )

    t0 = time.perf_counter()
    mf = MatrixFree(mfhn.create_quadrant(3, nref), degree, dtype=np.float32)
    src = np.random.default_rng(seed).standard_normal(mf.n_dofs).astype(
        np.float32)
    w = hanging_nodes_weighting(mf.constraints.is_constrained_cell(), 2.0)
    one = BrickLaplaceMM(mf)
    bv1 = one.from_dof_vector(src, to_device=False)
    dbl = DistributedBrickLaplace(mf, devices=devices, weights=w)
    dop = DistributedLaplace(mf, devices=devices, weights=w, exchange="halo")
    setup_s = time.perf_counter() - t0

    ref = brick_dofs(one, one.vmult(jnp.asarray(bv1)))
    scale = jnp.asarray(1e-3, jnp.float32)
    want = {d.id for d in devices}
    out = dict(n_dofs=mf.n_dofs, n_devices=len(devices), setup_s=setup_s,
               tol=DIST_TOL)
    for name, x, run, to_dofs, n_ghost in (
        ("bricks", dbl.from_dof_vector(src), dbl.vmult,
         lambda y: dbl.to_dof_vector(y, zero_hanging=True), dbl.n_ghost),
        ("index_halo", dop.scatter_vector(src), dop.vmult,
         lambda y: index_dofs(mf, dop.gather_vector(y)), dop.n_ghost),
    ):
        y = run(x)
        held = {sh.device.id for sh in y.addressable_shards}
        if held != want or len(y.addressable_shards) != len(devices):
            raise AssertionError(
                f"{name}: output shards on devices {sorted(held)}, "
                f"expected {sorted(want)}"
            )
        err = rel_err(to_dofs(y), ref)
        check(f"distributed {name} vs one card", err, DIST_TOL)
        out[name] = dict(
            rel_err_vs_one_card=err,
            ms_vmult=time_ms(lambda v: run(v * scale), x, reps),
            n_ghost=int(np.sum(n_ghost)),
            shard_devices=sorted(held),
        )
    out["one_card_ms_vmult"] = time_ms(
        lambda v: one.vmult(v * scale), jnp.asarray(bv1), reps)
    emit("four", **out)
    return out


# --------------------------------------------------------------------- main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU distributed phase")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_enable_x64", True)  # f32 programs stay f32
    from dealii_matrixfree_hanging_nodes.utils.compile_cache import (
        enable_compile_cache,
    )
    from dealii_matrixfree_hanging_nodes.utils.device import (
        NoGPUError,
        nvidia_smi_line,
        require_gpu,
    )

    cache_dir = enable_compile_cache()
    try:
        device = require_gpu()
    except NoGPUError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    need = 4 if args.four else 1
    if device["count"] < need:
        print(f"chip_smoke: needs {need} GPUs, JAX sees {device['count']}",
              file=sys.stderr)
        return 2
    smi = nvidia_smi_line()
    emit("device", **device, nvidia_smi=smi.splitlines(),
         jax_version=jax.__version__, compile_cache_dir=cache_dir)

    if args.four:
        phase_four(FLAGSHIP["nref"], FLAGSHIP["degree"], jax.devices()[:4])
    else:
        s = setup_flagship(**FLAGSHIP)
        emit("setup", n_dofs=s["mf32"].n_dofs, setup_s=s["setup_s"],
             native_setup_core=s["native_setup_core"])
        phase_flagship_f32(s)
        phase_flagship_f64(s)
        del s
        phase_oracle(**ORACLE)
        phase_solver(**SOLVER)

    print(smi)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
