"""Device identification for measurement scripts.

A timing is only meaningful with the card it ran on, so every script that
reports device numbers calls :func:`require_gpu` (no fallback to the CPU)
and prints :func:`nvidia_smi_line` beside its results.
"""

from __future__ import annotations

import subprocess


class NoGPUError(RuntimeError):
    """JAX found no GPU device."""


def require_gpu() -> dict:
    """Return {"platform", "kind", "count"} of the GPU devices JAX sees;
    raise NoGPUError when its default backend is not a GPU."""
    import jax

    devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu":
        raise NoGPUError(
            f"no GPU: JAX's default backend is {platform!r} "
            f"({len(devices)} device(s)); this script measures the GPU only"
        )
    return {
        "platform": platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }


def nvidia_smi_line() -> str:
    """``name, power.limit`` of each card as nvidia-smi prints them, read
    by a child process that does not import JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()
