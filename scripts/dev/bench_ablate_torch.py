#!/usr/bin/env python3
"""Frame rate with one engine stage off at a time, on one GPU.

    python scripts/dev/bench_ablate_torch.py [quick]

The port's counterpart of ``bench_ablate.py``, at its settings: the engine
of ``bench_profile_torch.py`` (480x640, ``BUFFER_SIZE=256``, bf16,
``EDGE_CAPACITY=57344``, the rest default, seeded random weights, motion
probe forced), 34 warm frames (``quick``: 12), then frames until 8 in a
row capture no new update graph, then 20 timed frames ended by a wait on
the stream (``quick``: 5; not a device synchronise, which would fail a
capture the engine's worker may hold), in seven runs:

- full;
- no merge: decisions are made but never applied (edges still retire);
- no update: no update program (no magnitudes, so no merges);
- track only: no edges, no update, no keyframe step;
- no BA: ``update_step_dev`` with ``run_ba=False``;
- plain correlation: K2 swapped for its plain PyTorch version
  (``chip_smoke.plain_correlation``), the counterpart of the JAX script's
  "corr XLA";
- no in-update motion magnitude: no keyframe candidate is queued, and no
  decision applies.

Prints ms/frame, FPS and the K2, K3 and K4 launches of the timed frames of
each run.  Needs a CUDA card.
"""
from __future__ import annotations

import contextlib
import sys
import time
from pathlib import Path

import microbench_torch as mb
from bench_profile_torch import bench_engine, launch_note

QUIET = 8          # warm frames in a row with no new graph before timing
MAX_SETTLE = 64    # at most this many frames past the warm ones


@contextlib.contextmanager
def no_ba():
    """``kernels.update_step_dev`` with ``run_ba=False`` (the engine looks it
    up at call time, and captures its graphs from it)."""
    from dpvo_tpu_torch.engine import kernels
    old = kernels.update_step_dev

    def step(*args, **kw):
        return old(*args, **dict(kw, run_ba=False))

    kernels.update_step_dev = step
    try:
        yield
    finally:
        kernels.update_step_dev = old


def _no_merge(s):
    s._keyframe_apply = lambda m, tcand: None


def _no_update(s):
    s.update = lambda: None


def _track_only(s):
    s.append_factors = lambda *a: None
    s.update = lambda: None
    s.keyframe = lambda: None


def _no_mm(s):
    s._mm_blob = lambda: (None, None)
    s._keyframe_apply = lambda m, tcand: None


def ablations():
    """(label, engine patch or None, context) of the seven runs."""
    from chip_smoke import plain_correlation
    null = contextlib.nullcontext
    return (("full", None, null), ("no merge", _no_merge, null),
            ("no update", _no_update, null), ("track only", _track_only, null),
            ("no BA", None, no_ba), ("plain correlation", None,
                                     plain_correlation),
            ("no in-update motion magnitude", _no_mm, null))


def run(dev, label, patch, ctx, n_warm=34, n_bench=20):
    """One run; -> (ms/frame, launches of the timed frames)."""
    import torch
    from dpvo_tpu_torch.ops import _cuda
    with ctx():
        slam, frame, intr = bench_engine(dev, n_warm, patch)
        # then until QUIET frames in a row capture no new update graph, so
        # the timed frames replay graphs and capture none
        t, quiet = n_warm, 0
        while quiet < QUIET and t < n_warm + MAX_SETTLE:
            n_graphs = len(slam._graphs)
            slam(t, frame(t), intr)
            t += 1
            quiet = quiet + 1 if len(slam._graphs) == n_graphs else 0
        torch.cuda.current_stream().synchronize()
        _cuda.reset_launches()
        t0 = time.perf_counter()
        for t in range(t, t + n_bench):
            slam(t, frame(t), intr)
        torch.cuda.current_stream().synchronize()
        dt = (time.perf_counter() - t0) / n_bench
    counts = dict(_cuda.launches)
    print(f"[bench_ablate] {label}: {1e3 * dt:.3f} ms/frame ({1 / dt:.3f} "
          f"FPS); {launch_note(counts)} over {n_bench} frames", flush=True)
    return 1e3 * dt, counts


def main(argv):
    dev = mb.card("bench_ablate_torch")
    quick = "quick" in argv
    for label, patch, ctx in ablations():
        run(dev, label, patch, ctx, n_warm=12 if quick else 34,
            n_bench=5 if quick else 20)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    sys.exit(main(sys.argv[1:]))
