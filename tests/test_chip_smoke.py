"""chip_smoke.py's phases at tiny sizes on the CPU (their checks and JSON
fields), and the full script on a GPU when one is present."""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402

sys.path.remove(REPO)


def test_phase_flagship_cpu(capsys):
    s = cs.setup_flagship(3, 2)
    f32 = cs.phase_flagship_f32(s, reps=2)
    f64 = cs.phase_flagship_f64(s, reps=2)
    assert f32["rel_err_vs_f64"] <= cs.F32_TOL
    assert f32["precision"] == "highest" and not f32["f64_ops_in_f32_program"]
    assert f32["ms_vmult"] > 0 and f32["index_ms_vmult"] > 0
    assert f64["rel_err_vs_f64"] <= cs.F64_TOL
    lines = capsys.readouterr().out.splitlines()
    assert [json.loads(ln)["phase"] for ln in lines] == [
        "flagship_f32", "flagship_f64"]


def test_phase_oracle_cpu():
    err = cs.phase_oracle(3, 2)
    assert set(err) == {"brick_float32", "index_float32", "brick_float64",
                        "index_float64"}
    assert max(err["brick_float64"], err["index_float64"]) <= cs.F64_TOL


def test_phase_solver_cpu():
    out = cs.phase_solver(2, 2, tol=1e-10, max_iter=100)
    assert out["iterations"] < out["max_iter"]
    assert out["true_rel_residual"] < 1e-9


def test_phase_four_cpu():
    out = cs.phase_four(3, 2, jax.devices()[:4], reps=2)
    for name in ("bricks", "index_halo"):
        assert out[name]["shard_devices"] == [d.id for d in jax.devices()[:4]]
        assert out[name]["rel_err_vs_one_card"] <= cs.DIST_TOL
        assert out[name]["n_ghost"] > 0


def test_check_rejects_nan_and_excess():
    cs.check("ok", 1e-6, 1e-4)
    for bad in (2e-4, float("nan")):
        with pytest.raises(AssertionError):
            cs.check("bad", bad, 1e-4)


@pytest.fixture
def gpu_env():
    """Environment for a child process that may use the GPU; skips when
    this host has none. This suite itself is pinned to the CPU."""
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run([smi, "-L"], capture_output=True,
                                     timeout=60).returncode != 0:
        pytest.skip("no GPU on this host (nvidia-smi finds none)")
    env = dict(os.environ)
    for k in ("JAX_PLATFORMS", "JAX_PLATFORM_NAME", "XLA_FLAGS"):
        env.pop(k, None)
    return env


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu_env):
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       env=gpu_env, capture_output=True, text=True,
                       timeout=1200)
    assert r.returncode == 0, r.stderr[-4000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
