#!/usr/bin/env python3
"""Each engine call on its own at the bench steady state, on one GPU.

    python scripts/dev/bench_profile_torch.py [quick]

The port's counterpart of ``bench_profile.py``: its engine (480x640,
``BUFFER_SIZE=256``, bf16, ``EDGE_CAPACITY=57344``, the rest default,
seeded random weights, motion probe forced) tracks 26 frames of a random
texture rolling 4 px per frame, then each call runs alone on that state,
timed on the host clock around the call and a wait on the stream (median
of 10, ``quick`` 3): ``track_frame_u8`` (the engine's tracking program,
run eagerly on its staged inputs); ``update_step`` with the kernels,
with the plain correlation swapped in (``chip_smoke.plain_correlation``)
and without BA; ``motionmag`` of the keyframe candidate's edges, cold (its
first call) and steady; ``permute_edges`` (identity, the live rows) and
``keyframe_merge`` (the engine's merge program, eagerly).  Each line gives
the K2, K3 and K6 (local BA) launches of its timed calls, per call; the header gives
``n`` and ``e_num``.  Needs a CUDA card.
"""
from __future__ import annotations

import contextlib
import sys
import time
from pathlib import Path

import numpy as np

import microbench_torch as mb

HT, WD = 480, 640
N_STEADY = 26
KERNELS = (("K2", "corr_enc"), ("K3", "segment_softmax_sums"),
           ("K6", "ba_blocks"))


def bench_engine(dev, n_frames=N_STEADY, patch=None, seed=0):
    """``bench_profile.py``'s engine after ``n_frames`` frames (``patch(slam)``
    applied before the first); -> (slam, frame function, intrinsics)."""
    from dpvo_tpu_torch.config import VOConfig
    from dpvo_tpu_torch.engine import DPVO
    cfg = VOConfig(BUFFER_SIZE=256, MIXED_PRECISION=True, LOOP_CLOSURE=False,
                   EDGE_CAPACITY=57344)
    slam = DPVO(cfg, network=None, ht=HT, wd=WD, device=dev, seed=seed)
    slam.motion_probe = lambda: 100.0
    if patch is not None:
        patch(slam)
    base = np.random.default_rng(seed).integers(0, 255, (HT, WD * 2, 3),
                                                dtype=np.uint8)
    intr = np.array([320.0, 320.0, 320.0, 240.0])

    def frame(t):
        return np.ascontiguousarray(np.roll(base, -4 * t, axis=1)[:, :WD])

    for t in range(n_frames):
        slam(t, frame(t), intr)
    return slam, frame, intr


def launch_note(counts, per=1):
    """``launches K2 a K3 b K6 c``: the counts divided by ``per``."""
    return "launches " + " ".join(f"{k} {counts.get(name, 0) / per:g}"
                                  for k, name in KERNELS)


def wall(name, fn, reps):
    """Median wall ms of ``fn()`` with a wait on the stream (not the device:
    that would fail a capture the engine's worker may hold), over ``reps``
    calls after one warm call; prints the line with the K2/K3/K6 launches
    of the timed calls.  -> (ms, launches)."""
    import torch
    from dpvo_tpu_torch.ops import _cuda
    fn()
    torch.cuda.current_stream().synchronize()
    _cuda.reset_launches()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.current_stream().synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    counts = dict(_cuda.launches)
    ms = float(np.median(ts))
    print(f"[bench_profile] {name}: {ms:.3f} ms (median of {reps}, "
          f"synchronised); {launch_note(counts, reps)} per call", flush=True)
    return ms, counts


def profile(dev, reps=10):
    """Time each call; -> {call: (ms, launches)}."""
    import torch
    from chip_smoke import plain_correlation
    from dpvo_tpu_torch.engine import kernels
    slam, frame, intr = bench_engine(dev)
    cfg, ds, hs = slam.cfg, slam.ds, slam.hs
    torch.cuda.current_stream().synchronize()
    print(f"[bench_profile] steady state after {N_STEADY} frames: "
          f"n={slam.n} e_num={hs.e_num}", flush=True)
    t0, t1 = max(slam.n - cfg.OPTIMIZATION_WINDOW, 1), slam.n
    step = dict(M=slam.M, pmem=slam.pmem, mem=slam.mem, n_cap=slam.n_cap,
                k_cap=slam.k_cap, iterations=2)
    out = {}
    with torch.no_grad():
        slam._stage_track(frame(N_STEADY), intr, slam.n, 1.0, True)
        key, program = slam._track_program()
        out["track_frame_u8"] = wall("track_frame_u8 (eager)", program, reps)
        arms = (("update_step kernels", contextlib.nullcontext, True),
                ("update_step plain correlation", plain_correlation, True),
                ("update_step no BA", contextlib.nullcontext, False))
        for name, ctx, run_ba in arms:
            with ctx():
                out[name] = wall(f"{name} (E={hs.e_num})", lambda: (
                    kernels.update_step(ds, slam.update_mod, hs.e_num, t0,
                                        t1, run_ba=run_ba, **step)), reps)
        i = slam.n - cfg.KEYFRAME_INDEX - 1
        j = slam.n - cfg.KEYFRAME_INDEX + 1
        torch.cuda.current_stream().synchronize()
        tc = time.perf_counter()
        m = slam.motionmag(i, j)
        cold = (time.perf_counter() - tc) * 1e3
        print(f"[bench_profile] motionmag({i}, {j}) cold: {cold:.3f} ms "
              f"-> {m:.4f}", flush=True)
        out["motionmag"] = wall(f"motionmag({i}, {j}) steady",
                                lambda: slam.motionmag(i, j), reps)
        perm = torch.arange(hs.e_num, device=dev)
        out["permute_edges"] = wall(
            f"permute_edges (identity, {hs.e_num} rows)",
            lambda: kernels.permute_edges(ds, perm, hs.e_num), reps)
        k = slam.n - cfg.KEYFRAME_INDEX
        slam._copy_in(ds.merge_in, np.array([k, slam.n], np.int32))
        out["keyframe_merge"] = wall(f"keyframe_merge (eager, k={k})",
                                     slam._merge_program()[1], reps)
    out["motionmag_cold"] = (cold, {})
    return out


def main(argv):
    dev = mb.card("bench_profile_torch")
    profile(dev, reps=3 if "quick" in argv else 10)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    sys.exit(main(sys.argv[1:]))
