"""Timing utilities: a section timer and a call benchmark.

Counterpart of ``dpvo_tpu/utils/timing.py``.  On the card both fence the
device with ``torch.cuda.synchronize`` around a host clock, so the time
covers the queued kernels and not only their launch; on the CPU there is
nothing to fence.
"""
from __future__ import annotations

import time
from contextlib import ContextDecorator

import torch

all_times = []


def _fence():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


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
