#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port: monocular VO frames/sec at 480p on
one GPU.

    python bench_torch.py                          # on the card
    DPVO_BENCH_REGIMES=retain python bench_torch.py

The counterpart of ``bench.py``: the full per-frame pipeline (patchify,
recurrent update, local BA) at 480x640, 96 patches per frame, the default
configuration (bf16, lagged keyframe decisions), seeded random weights with
the motion probe forced, on a synthetic frame rolling 4 px per frame, in
two pinned keyframing regimes:

- merge: every keyframe decision merges (``KEYFRAME_THRESH=1e9``,
  ``BUFFER_SIZE=256``), the low-motion regime;
- retain: no decision merges (``KEYFRAME_THRESH=0``, ``BUFFER_SIZE=1024``),
  the high-motion regime, 45312 live edges at the retirement steady state.

Each regime runs 30 warm frames, then 40-frame windows, each ended by a
device synchronise, with ``bench.py``'s adaptive stop (at least 9 windows,
until the 5 best agree within 10% and the best is 3 windows old, at most
24).  Frames are uploaded ahead of use from pinned host buffers.  Prints
``bench.py``'s JSON line (``value`` is the median of the 5 best windows'
frames/sec of the merge regime, ``value_retain`` the retain regime's);
each regime's live-edge count goes to stderr.  With ``DPVO_TIMING=1`` the
engine's phase timers run over the windows (host dispatch time: no device
synchronise at the phases' ends, as ``bench.py`` measures them;
``DPVO_TIMING=block`` fences each phase with one instead), and each
regime logs ``timing_report()`` to stderr after its windows; the JSON line
is the same.  The engine replays its tracking, update and merge programs
as CUDA graphs.  As ``bench.py`` does, each regime calls
``DPVO.precompile`` before its first frame (``max_edges`` 20480 for merge,
46000 for retain) and again after the warm frames (``around`` the live
edge count, 2 ladder steps), and logs to stderr the seconds, keys and
graph pool bytes of each call, then the buckets its updates ran at, each
graph's capture ms, the graph pool's bytes and the captures made inside
the timed windows.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REGIMES = {"merge": dict(BUFFER_SIZE=256, KEYFRAME_THRESH=1e9),
           "retain": dict(BUFFER_SIZE=1024, KEYFRAME_THRESH=0.0)}
# precompile's max_edges before the first frame (bench.py:71-73): the merge
# regime's live edges overshoot to ~20.3k while lagged decisions are in
# flight; the retain regime tops out near 45.3k
PRECOMPILE_EDGES = {"merge": 20480, "retain": 46000}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def regime_config(regime, **overrides):
    """The default configuration pinned to ``regime`` (bench.py:46-54)."""
    from dpvo_tpu_torch.config import VOConfig
    return VOConfig(**{**REGIMES[regime], "MIXED_PRECISION": True,
                       "LOOP_CLOSURE": False, "EDGE_CAPACITY": 57344,
                       **overrides})


class FrameFeed:
    """Frame t of the rolling synthetic sequence on the device: copied into
    one of two pinned host buffers and sent with ``non_blocking``, one frame
    ahead of use.  A buffer is refilled only after its last copy's event."""

    def __init__(self, ht, wd, device, seed=0):
        import torch
        self.wd, self.device = wd, device
        self.base = np.random.default_rng(seed).integers(
            0, 255, size=(ht, wd * 2, 3), dtype=np.uint8)
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.host = [torch.empty((ht, wd, 3), dtype=torch.uint8,
                                     pin_memory=True) for _ in range(2)]
            self.done = [None, None]
        self.next = None

    def frame(self, t):
        return np.ascontiguousarray(np.roll(self.base, -4 * t, axis=1)
                                    [:, :self.wd])

    def _send(self, t):
        if not self.cuda:
            return self.frame(t)
        import torch
        i = t % 2
        if self.done[i] is not None:
            self.done[i].synchronize()
        self.host[i].copy_(torch.from_numpy(self.frame(t)))
        img = self.host[i].to(self.device, non_blocking=True)
        self.done[i] = torch.cuda.Event()
        self.done[i].record()
        return img

    def get(self, t):
        img = self.next if self.next is not None else self._send(t)
        self.next = self._send(t + 1)
        return img


def run_regime(regime, device="cuda", ht=480, wd=640, n_warm=30,
               n_bench=40, min_windows=9, max_windows=24, profile_frames=0,
               seed=0, timing=False, timing_block=False, cuda_graphs=True,
               **overrides):
    """One pinned-regime capture.  -> dict: ``fps`` (median of the 5 best
    windows), ``median_fps``, ``windows`` (frames/sec each), ``edges``
    (live edges at each window's end), ``edges_range`` (least and most
    over the windows' frames), ``keyframes``, ``points`` and
    ``colors`` (the map before terminate()), ``poses`` and ``tstamps``
    (terminate()'s), and with ``profile_frames`` the ``profile`` of that
    many more frames run under torch.profiler: (profiler, wall ms,
    frames).  With ``timing`` the engine's phase timers run over the
    windows (``timing_block``: each phase fenced by a device synchronise;
    off, the host's dispatch time) and ``timing`` holds their
    ``timing_report()``, else None.  ``cuda_graphs`` is the engine's
    (False: the programs run eagerly on the card).  ``DPVO.precompile``
    runs where ``bench.py`` calls it, before the first frame and after the
    warm frames, and ``graphs["precompile"]`` holds both calls' results.
    ``graphs`` also holds the updates
    run at each edge bucket (``buckets``), the capture ms of each graph
    key captured on the engine's thread (``capture_ms``), the graph
    pool's bytes (``pool_bytes``, None without graphs), the graphs captured
    inside the timed windows on the engine's thread (``window_captures``,
    each a stalled frame) and in the guard's worker
    (``window_background``), the updates a cover served per key
    (``cover_served``) and the worker's capture ms per key
    (``background_ms``)."""
    import torch
    from dpvo_tpu_torch.device import resolve_device
    from dpvo_tpu_torch.engine import DPVO

    dev = resolve_device(device)
    cfg = regime_config(regime, **overrides)
    slam = DPVO(cfg, network=None, ht=ht, wd=wd, device=dev, seed=seed,
                cuda_graphs=cuda_graphs)
    # random weights give arbitrary motion probes: force tracking
    slam.motion_probe = lambda: 100.0
    intr = np.array([wd / 2, wd / 2, wd / 2, ht / 2])
    feed = FrameFeed(ht, wd, dev, seed)

    def sync():
        # the engine's stream: a device-wide synchronise would fail a
        # capture the engine's worker may hold open (the cold-bucket guard)
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()

    pre = []

    def ready(**plan):
        pre.append(slam.precompile(**plan))
        log(f"[{regime}] precompile {plan}: {pre[-1]['seconds']:.2f} s, "
            f"keys {list(pre[-1]['ms'])}, pool bytes {pre[-1]['pool_bytes']}")

    ready(max_edges=PRECOMPILE_EDGES[regime])
    for t in range(n_warm):
        tw = time.perf_counter()
        slam(t, feed.get(t), intr)
        log(f"[{regime}] warm frame {t}: "
            f"{(time.perf_counter() - tw) * 1000:.0f}ms "
            f"(edges {slam.hs.e_num})")
    sync()
    ready(around=slam.hs.e_num, steps=2)
    slam.enable_timing = timing
    slam.timing_block = timing_block

    n_captured = len(slam.graph_capture_ms)
    n_background = len(slam.background_capture_ms)
    windows, edges, per_frame = [], [], []
    t = n_warm
    while len(windows) < max_windows:
        t0 = time.perf_counter()
        for _ in range(n_bench):
            slam(t, feed.get(t), intr)
            per_frame.append(slam.hs.e_num)
            t += 1
        sync()
        windows.append(n_bench / (time.perf_counter() - t0))
        edges.append(slam.hs.e_num)
        log(f"[{regime}] window fps: {windows[-1]:.2f} "
            f"(edges {slam.hs.e_num})")
        if len(windows) >= min_windows:
            top = sorted(windows)[-5:]
            since_best = len(windows) - 1 - windows.index(max(windows))
            if top[0] > 0.9 * top[-1] and since_best >= 3:
                break
    window_captures = len(slam.graph_capture_ms) - n_captured
    window_background = len(slam.background_capture_ms) - n_background
    report = None
    if timing:
        slam.enable_timing = False
        report = slam.timing_report()
        for k, (ms, cnt) in report.items():
            log(f"  {k:20s} {ms:8.2f} ms  x{cnt}")

    profile = None
    if profile_frames:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(profile_frames):
                slam(t, feed.get(t), intr)
                t += 1
            sync()
            wall_ms = (time.perf_counter() - t0) * 1e3
        profile = (prof, wall_ms, profile_frames)

    log(f"[{regime}] live edges {slam.hs.e_num}, over the windows' frames "
        f"{min(per_frame)}..{max(per_frame)}, keyframes {slam.n}")
    points = slam.points[:slam.m].cpu().numpy()
    colors = slam.ds.colors[:slam.n].reshape(-1, 3).cpu().numpy()
    keyframes = slam.n
    poses, tstamps = slam.terminate()
    sync()
    graphs = dict(buckets=dict(sorted(slam.buckets_seen.items())),
                  capture_ms=dict(slam.graph_capture_ms),
                  pool_bytes=slam.graph_pool_bytes(), precompile=pre,
                  window_captures=window_captures,
                  window_background=window_background,
                  cover_served=dict(slam.cover_served),
                  background_ms=dict(slam.background_capture_ms))
    top = sorted(windows)[-5:]
    swin = sorted(windows)
    return dict(fps=top[len(top) // 2], median_fps=swin[len(swin) // 2],
                windows=windows, edges=edges,
                edges_range=(min(per_frame), max(per_frame)),
                keyframes=keyframes,
                points=points, colors=colors, poses=poses, tstamps=tstamps,
                profile=profile, timing=report, graphs=graphs)


def bench_line(results):
    """bench.py's JSON object from {regime: run_regime(...)}."""
    out = {"metric": "vo_fps_480p", "unit": "frames/sec"}
    for regime, r in results.items():
        suffix = "" if regime == "merge" else f"_{regime}"
        out["value" + suffix] = round(r["fps"], 2)
        out["vs_baseline" + suffix] = round(r["fps"] / 30.0, 3)
        out["median_fps" + suffix] = round(r["median_fps"], 2)
        out["windows" + suffix] = [round(w, 1) for w in r["windows"]]
    if "value" not in out:   # retain-only invocation
        k = [k for k in out if k.startswith("value")][0]
        out["value"] = out[k]
        out["vs_baseline"] = round(out[k] / 30.0, 3)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the GPU; raises without)")
    args = ap.parse_args(argv)
    regimes = os.environ.get("DPVO_BENCH_REGIMES", "merge,retain")
    timing = os.environ.get("DPVO_TIMING", "")
    results = {}
    for regime in (r.strip() for r in regimes.split(",")):
        r = results[regime] = run_regime(regime, device=args.device,
                                         timing=bool(timing),
                                         timing_block=timing == "block")
        g = r["graphs"]
        log(f"[{regime}] live edges at the windows' ends: {r['edges']}; "
            f"updates per bucket {g['buckets']}; graphs "
            f"{len(g['capture_ms'])}, capture ms "
            f"{[round(v, 1) for v in g['capture_ms'].values()]}, pool bytes "
            f"{g['pool_bytes']}, captures inside the timed windows "
            f"{g['window_captures']} (in the guard's worker "
            f"{g['window_background']}); updates a cover served "
            f"{sum(g['cover_served'].values())}, background capture ms "
            f"{[round(v, 1) for v in g['background_ms'].values()]}")
    print(json.dumps(bench_line(results)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
