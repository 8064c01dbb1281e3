import os

# Force CPU with a virtual 8-device mesh BEFORE jax import: multi-device
# sharding tests run on the host platform (the analog of the reference's
# single-machine `mpirun -np N` testing, benchmark_01.cc:251-272).
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)


def pytest_collection_modifyitems(config, items):
    """Tier the suite: nodeids (or test-name prefixes) listed in
    tests/slow_tests.txt get the `slow` marker, so CI's per-push gate can
    run `pytest -m "not slow"` (<3 min on this 1-vCPU host) and the full
    suite nightly (VERDICT r4 item 7)."""
    import os

    import pytest as _pytest

    path = os.path.join(os.path.dirname(__file__), "slow_tests.txt")
    if not os.path.exists(path):
        return
    prefixes = [
        ln.strip()
        for ln in open(path)
        if ln.strip() and not ln.startswith("#")
    ]
    for item in items:
        nid = item.nodeid
        if any(nid == p or nid.startswith(p + "[") for p in prefixes):
            item.add_marker(_pytest.mark.slow)
