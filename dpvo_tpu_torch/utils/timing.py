"""Timing utilities: a section timer, a call benchmark and a profiler
trace.

Counterpart of ``dpvo_tpu/utils/timing.py``.  On the card the timer and
the benchmark wait for the current stream around a host clock, so the
time covers the queued kernels and not only their launch; on the CPU
there is nothing to fence.  The fence is the stream's, not the device's:
a device-wide ``torch.cuda.synchronize`` while the engine's capture
worker holds a CUDA graph capture open (``DPVO``'s cold-bucket guard) is
refused by CUDA and fails that capture.
"""
from __future__ import annotations

import os
import tempfile
import time
from contextlib import ContextDecorator

import torch

all_times = []


def _fence():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.current_stream().synchronize()


class Timer(ContextDecorator):
    """Wall-clock section timer that fences outstanding device work and
    prints ``name ms``."""

    def __init__(self, name, enabled=True):
        self.name = name
        self.enabled = enabled

    def __enter__(self):
        if self.enabled:
            _fence()
            self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.enabled:
            _fence()
            elapsed = (time.perf_counter() - self.start) * 1000.0
            all_times.append(elapsed)
            print(f"{self.name} {elapsed:.03f}")
        return False


def benchmark(fn, *args, warmup=3, iters=10):
    """Median milliseconds of ``fn(*args)`` over ``iters`` fenced calls,
    after ``warmup`` calls."""
    for _ in range(warmup):
        fn(*args)
    _fence()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _fence()
        times.append((time.perf_counter() - t0) * 1000.0)
    times.sort()
    return times[len(times) // 2]


class profile_trace:
    """``torch.profiler`` over the block (host, and the card's kernels where
    there is one), written on leaving as a Chrome trace,
    ``logdir/trace.json`` (view it in Perfetto or ``chrome://tracing``).
    The default ``logdir`` is ``dpvo_tpu_torch_trace`` in the temporary
    directory."""

    def __init__(self, logdir=None):
        self.logdir = logdir or os.path.join(tempfile.gettempdir(),
                                             "dpvo_tpu_torch_trace")
        self.path = os.path.join(self.logdir, "trace.json")

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        os.makedirs(self.logdir, exist_ok=True)
        self.prof.export_chrome_trace(self.path)
        return False
