"""Profiling utilities (the tracing subsystem the reference lacks --
SURVEY.md section 5 lists only a wall-clock printout,
``super_resolution.cpp:191-196``).

- :func:`trace` -- context manager around ``torch.profiler`` writing a
  Chrome trace (``chrome://tracing``, Perfetto) of host and CUDA activity.
- :class:`WallClock` -- scoped wall-clock timing (the reference's
  behaviour); it synchronises the CUDA device on entry and exit, once CUDA
  is initialised, so that device work is included.
- :func:`device_time` -- median seconds per call of a callable, each call
  ended by a device synchronise.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch

__all__ = ["trace", "WallClock", "device_time", "synchronize"]


def synchronize() -> None:
    """Wait for the current CUDA device where CUDA is initialised; else nothing."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile the block with ``torch.profiler`` (CPU, and CUDA where there is
    a device) and write ``trace.json`` into ``log_dir`` (default: a
    ``srtpu_trace`` directory under the temporary directory). Yields
    ``log_dir``; the device's kernels are the trace's ``"kernel"`` events."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "srtpu_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        try:
            yield log_dir
        finally:
            synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class WallClock:
    """Scoped wall-clock timer: ``with WallClock("solve") as t: ...``."""

    def __init__(self, label: str = "", verbose: bool = True):
        self.label = label
        self.verbose = verbose
        self.elapsed = 0.0

    def __enter__(self):
        synchronize()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        synchronize()
        self.elapsed = time.perf_counter() - self._t0
        if self.verbose:
            print(f"{self.label or 'elapsed'}: {self.elapsed:.3f} s")
        return False


def device_time(fn, *args, iterations: int = 20, warmup: int = 2) -> float:
    """Median seconds per call of ``fn(*args)``, each call ended by a device synchronise."""
    times = []
    for i in range(warmup + iterations):
        synchronize()
        t0 = time.perf_counter()
        fn(*args)
        synchronize()
        if i >= warmup:
            times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
