#!/usr/bin/env python3
"""Lagged against synchronous keyframe decisions on one GPU.

    python3 scripts/lag_ab.py

Runs ``bench_torch.run_regime`` (480x640, M=96, the default config, two
40-frame windows after 30 warm frames) in the merge and then the retain
regime with ``ASYNC_KEYFRAME`` True and False in turns (lagged, sync, sync,
lagged, lagged, sync), printing ms/frame per window, the live-edge range
and the keyframes of each run and the median per side; then profiles the
host (cProfile, top functions by own time) over 20 steady merge frames of
each.  Needs one CUDA card.
"""
from __future__ import annotations

import cProfile
import io
import pstats
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    import torch
    import bench_torch
    from dpvo_tpu_torch.engine import DPVO
    if not torch.cuda.is_available():
        print("lag_ab: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda:0")
    for regime in ("merge", "retain"):
        res = {True: [], False: []}
        for lag in (True, False, False, True, True, False):
            r = bench_torch.run_regime(regime, device=dev, min_windows=2,
                                       max_windows=2, ASYNC_KEYFRAME=lag)
            ms = [1e3 / w for w in r["windows"]]
            res[lag].append(float(np.mean(ms)))
            print(f"[ab] {regime} lagged={lag}: ms/frame {ms[0]:.2f} "
                  f"{ms[1]:.2f}, edges {r['edges_range']}, keyframes "
                  f"{r['keyframes']}", flush=True)
        for lag in (True, False):
            print(f"[ab] {regime} lagged={lag}: runs "
                  f"{[round(x, 2) for x in res[lag]]} median "
                  f"{np.median(res[lag]):.2f}", flush=True)

    intr = np.array([320.0, 320.0, 320.0, 240.0])
    for lag in (True, False):
        cfg = bench_torch.regime_config("merge", ASYNC_KEYFRAME=lag)
        slam = DPVO(cfg, ht=480, wd=640, device=dev)
        slam.motion_probe = lambda: 100.0
        feed = bench_torch.FrameFeed(480, 640, dev)
        for t in range(40):
            slam(t, feed.get(t), intr)
        torch.cuda.current_stream().synchronize()
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        for t in range(40, 60):
            slam(t, feed.get(t), intr)
        torch.cuda.current_stream().synchronize()
        prof.disable()
        wall = (time.perf_counter() - t0) * 1e3 / 20
        s = io.StringIO()
        pstats.Stats(prof, stream=s).sort_stats("tottime").print_stats(18)
        print(f"[host] lagged={lag}: {wall:.2f} ms/frame under cProfile; "
              "top by own time:", flush=True)
        print("\n".join(s.getvalue().splitlines()[:40]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
