"""Tracing and step timing: the port's copy of ``controlnet_tpu/utils/profiling.py``.

* ``trace(logdir)``: a context manager around ``torch.profiler.profile``
  that writes a TensorBoard-loadable trace (host ops, and the card's kernels
  when a card is there) into ``logdir`` when it exits.
* ``StepTimer``: steady-state step timing that leaves out the first
  ``skip`` steps (on the card they build the kernels, ``ops/_build.py``) and
  reports mean / p50 / p99.

The JAX module's ``attention_fallback_counts`` has no counterpart: the port
has no fallback to count.  A CUDA tensor launches the kernel or raises, and
only a CPU tensor takes the plain version.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield


class StepTimer:
    """Wall-clock per-step stats, the first ``skip`` steps excluded.  The
    caller ends each step with a synchronise (``torch.cuda.synchronize()``
    on the card), or the clock reads the launch of the step's kernels and
    not their run."""

    def __init__(self, skip: int = 1):
        self.skip = skip
        self.times: list[float] = []
        self._t0: float | None = None
        self._count = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.skip:
            self.times.append(dt)
        return False

    def stats(self) -> dict:
        if not self.times:
            return {"steps": 0}
        arr = np.asarray(self.times)
        return {
            "steps": len(arr),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p99_s": float(np.percentile(arr, 99)),
            "steps_per_sec": float(1.0 / arr.mean()),
        }
