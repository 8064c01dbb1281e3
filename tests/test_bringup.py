"""GPU bring-up rules that the CPU can check: scripts refuse to run without
a GPU, the compile-cache location, no engine fallback in bench.py, the
operator precision defaults, and exact 0/1 selection products."""

import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest

import dealii_matrixfree_hanging_nodes as mfhn
from dealii_matrixfree_hanging_nodes.bricks import BrickLaplaceMM
from dealii_matrixfree_hanging_nodes.matrix_free import MatrixFree
from dealii_matrixfree_hanging_nodes.models.laplace import LaplaceOperator
from dealii_matrixfree_hanging_nodes.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cpu_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return env


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_script_refuses_cpu(script):
    r = subprocess.run(
        [sys.executable, script], cwd=REPO, env=_cpu_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert "no GPU" in r.stderr, r.stderr[-2000:]
    assert '"ok"' not in r.stdout and '"metric"' not in r.stdout


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_env_honoured(monkeypatch, tmp_path, restore_cache_dir):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # JAX reads the env


def test_compile_cache_default_in_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert compile_cache.enable_compile_cache() == path  # fixed, not per-run
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.fixture(scope="module")
def mf32():
    return MatrixFree(mfhn.create_quadrant(3, 3), 2, dtype=np.float32)


def test_bench_has_no_fallback(monkeypatch, mf32):
    sys.path.insert(0, REPO)
    try:
        import bench
    finally:
        sys.path.remove(REPO)
    from dealii_matrixfree_hanging_nodes import bricks

    class Broken(RuntimeError):
        pass

    def broken(*a, **k):
        raise Broken("brick engine failed")

    monkeypatch.setattr(bricks, "BrickLaplaceMM", broken)
    with pytest.raises(Broken):
        bench.build_operator("bricks", mf32, None)
    with pytest.raises(ValueError, match="unknown BENCH_ENGINE"):
        bench.build_operator("xla", mf32, None)
    op, src = bench.build_operator("index", mf32, "high")
    assert isinstance(op, LaplaceOperator) and op._matmul_precision == "high"
    assert src.shape == (mf32.n_dofs,)


def test_precision_defaults(mf32):
    # TF32 ("high") misses the 1e-4 bound on the GPU; full f32 is default
    assert BrickLaplaceMM(mf32)._matmul_precision == "highest"
    assert LaplaceOperator(mf32)._matmul_precision == "highest"


# ---------------------------------------------------- selection exactness
_SELECTION = {"E", "Es", "EsI", "EscX", "EFX", "Ssub", "W_col2im"}
_PASS_THROUGH = {"transpose", "reshape", "convert_element_type", "squeeze",
                 "expand_dims", "broadcast_in_dim", "copy", "slice"}


def _selection_name(path):
    top, last = path[0].key, getattr(path[-1], "key", None)
    if top in _SELECTION or last == "T":  # transfers / transfers_b T stacks
        return top
    if re.fullmatch(r"flat_(fill|corr)_(T\d+|tail\d+_T)", top):
        return top
    return None


def _dots(jaxpr, tags, out):
    """(selection operand name or None, precision) for every dot_general,
    following selection operands through shape-only ops and into nested
    jaxprs (jnp.einsum traces as a pjit)."""
    for eqn in jaxpr.eqns:
        ins = [tags.get(id(v)) for v in eqn.invars]
        name = eqn.primitive.name
        if name == "dot_general":
            sel = [t for t in ins if t]
            out.append((sel[0] if sel else None, eqn.params["precision"]))
        elif name in _PASS_THROUGH and ins and ins[0]:
            tags[id(eqn.outvars[0])] = ins[0]
        for key in ("jaxpr", "call_jaxpr"):
            sub = eqn.params.get(key)
            if sub is None:
                continue
            inner = getattr(sub, "jaxpr", sub)
            _dots(inner, {id(iv): t for iv, t in zip(inner.invars, ins) if t},
                  out)
    return out


@pytest.mark.parametrize("fill_mode", ["input", "exchange"])
@pytest.mark.parametrize("entry", ["vmult", "vmult_plain", "refill"])
def test_selection_dots_are_exact(mf32, fill_mode, entry):
    """Under a TF32 operator precision ("high"), every product with a 0/1
    selection matrix still runs at HIGHEST, and every other product runs
    at the operator's precision."""
    op = BrickLaplaceMM(mf32, matmul_precision="high", fill_mode=fill_mode)
    impl = {"vmult": op._vmult_impl, "vmult_plain": op._vmult_plain_impl,
            "refill": op._refill_impl}[entry]
    a = op._stage()
    bv = op.from_dof_vector(np.ones(mf32.n_dofs, np.float32))
    with jax.default_matmul_precision(op._matmul_precision):
        closed = jax.make_jaxpr(impl)(bv, a)
    leaves = jax.tree_util.tree_flatten_with_path(a)[0]
    tags = {
        id(v): _selection_name(path)
        for v, (path, _) in zip(closed.jaxpr.invars[1:], leaves)
        if _selection_name(path)
    }
    dots = _dots(closed.jaxpr, tags, [])
    hi = jax.lax.Precision.HIGHEST
    sel = [(n, p) for n, p in dots if n]
    other = [p for n, p in dots if not n]
    assert "Es" in {n for n, _ in sel}
    if fill_mode == "exchange" and entry != "vmult_plain":
        assert {"EscX", "EFX"} <= {n for n, _ in sel}
    assert all(p == (hi, hi) for _, p in sel), sel
    high = jax.lax.Precision.HIGH
    assert other and all(p == (high, high) for p in other), other


def test_f32_program_holds_no_f64_arrays(mf32):
    """x64 is on in this suite (as in chip_smoke.py): the f32 vmult program
    must still compute in f32 only."""
    op = BrickLaplaceMM(mf32)
    bv = op.from_dof_vector(np.ones(mf32.n_dofs, np.float32))
    with jax.default_matmul_precision(op._matmul_precision):
        hlo = op._jit_vmult.lower(bv, op._stage()).as_text()
    assert re.search(r"tensor<(\d+x)+f32>", hlo)
    assert not re.search(r"tensor<(\d+x)+f64>", hlo)
