"""Timing and profiling utilities (SURVEY §5 tracing analog).

The reference fences each repetition with MPI_Barrier and reduces min/avg/max
over ranks (benchmark_01.h:536-575); its hardware-counter path is LIKWID
markers. Here:

- ``repeat_timed`` times chained repetitions of a jitted step; each timed
  window closes with ``block_until_ready`` (JAX dispatch is asynchronous, so
  a window without it measures the enqueue).
- ``trace`` wraps jax.profiler for XPlane traces (the LIKWID-marker analog).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np

__all__ = ["repeat_timed", "repeat_timed_paired", "trace", "TimingResult"]


class TimingResult:
    def __init__(self, times):
        self.times = list(times)

    @property
    def min(self):
        return float(np.min(self.times))

    @property
    def max(self):
        return float(np.max(self.times))

    @property
    def avg(self):
        return float(np.mean(self.times))

    def __repr__(self):
        return f"TimingResult(min={self.min:.4e}, avg={self.avg:.4e}, max={self.max:.4e})"


def repeat_timed(step, x0, n_reps: int = 100, n_trials: int = 3,
                 sync_each: bool = False) -> TimingResult:
    """Time ``x = step(x)`` chains; returns per-rep seconds over trials.

    step must map a device array to a like-shaped device array. The chain is
    re-seeded from x0 each trial; each trial ends with block_until_ready.

    sync_each=True fences every repetition (block_until_ready) — the analog
    of the reference's per-rep MPI_Barrier (benchmark_01.h:538). Required on
    the virtual multi-device CPU mesh: async-dispatching many chained
    programs with collectives floods the single core's thread pool with
    spinning rendezvous threads until the collective deadlocks.
    """
    step(x0).block_until_ready()  # compile
    times = []
    for _trial in range(n_trials):
        x = x0
        t0 = time.perf_counter()
        for _ in range(n_reps):
            x = step(x)
            if sync_each:
                x.block_until_ready()
        x.block_until_ready()
        times.append((time.perf_counter() - t0) / n_reps)
    return TimingResult(times)


def repeat_timed_paired(steps, x0s, n_reps: int = 100, n_trials: int = 3,
                        chunk: int | None = 10):
    """Time several step functions with INTERLEAVED trials (A/B hygiene for
    pairs such as the ±constraints overhead, benchmark_03.h:510-532): trial
    t runs every config back to back, so clock or power drift during the
    run affects both sides of a ratio alike. Returns a list of
    TimingResult, one per step.

    chunk: alternate the configs every ``chunk`` reps inside a trial, each
    chunk closed by block_until_ready, recording one time per chunk.
    chunk=None times whole-trial blocks.
    """
    for step, x0 in zip(steps, x0s):
        step(x0).block_until_ready()  # compile
    times = [[] for _ in steps]
    if chunk is None or chunk >= n_reps:
        for _trial in range(n_trials):
            for i, (step, x0) in enumerate(zip(steps, x0s)):
                x = x0
                t0 = time.perf_counter()
                for _ in range(n_reps):
                    x = step(x)
                x.block_until_ready()
                times[i].append((time.perf_counter() - t0) / n_reps)
        return [TimingResult(t) for t in times]
    n_rounds = max(1, n_reps // chunk)
    for _trial in range(n_trials):
        for _round in range(n_rounds):
            for i, (step, x0) in enumerate(zip(steps, x0s)):
                x = x0
                t0 = time.perf_counter()
                for _ in range(chunk):
                    x = step(x)
                x.block_until_ready()
                times[i].append((time.perf_counter() - t0) / chunk)
    return [TimingResult(t) for t in times]


@contextlib.contextmanager
def trace(log_dir: str):
    """Profiler region (LIKWID_MARKER_START/STOP analog) -> XPlane trace."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
