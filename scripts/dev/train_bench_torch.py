#!/usr/bin/env python3
"""The training step in fp32 and bf16, and samples/s against batch size,
on one GPU.

    python scripts/dev/train_bench_torch.py [quick]

The port's counterpart of ``train_bench.py``, at its shapes: N=15 frames a
sample, 240x320 crops, M=64 patches a frame, 18 rollout iterations, through
``parallel/train_step.make_train_step`` (encoders, the rollout of
``training/rollout.py`` with differentiable BA, the loss, backward, the
clipped AdamW step).  Rows: fp32 at batch 1, bf16 autocast
(``MIXED_PRECISION``'s training form) at batch 1, 2 and 4; TF32 off
(fp32 is fp32, as in the engine's fp32 islands).  Columns: ms
per step (the best of 5 runs of 4 steps; ``quick``: 1 run of 1 step),
samples/s, the first step's seconds (allocation and cuDNN's algorithm
search, in place of XLA's compile seconds) and peak device memory
(``torch.cuda.max_memory_allocated``).  Samples are ``chip_smoke``'s
synthetic clips (a texture rolled 2 px a frame, GT poses and disparities
that induce that flow) through ``train_torch.prepare_batch``; weights from
the flax-like initialisers of a fixed seed.  Ends with bf16's speed-up and
memory ratio over fp32 at batch 1: the reference's published training
claim is AMP ~30% faster with ~40% less memory than fp32 (its README).
Needs a CUDA card.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np

import microbench_torch as mb

N, H, W, M, STEPS = 15, 240, 320, 64, 18
ROWS = (("fp32", False, 1), ("bf16", True, 1), ("bf16", True, 2),
        ("bf16", True, 4))


def make_batch(B, dev, seed=0):
    """B synthetic samples (``chip_smoke.train_clip``, one seed each)
    prepared by ``train_torch.prepare_batch``, on ``dev``."""
    import train_torch
    from chip_smoke import train_clip
    clips = [train_clip(seed + b, N, H, W) for b in range(B)]
    clip = [np.concatenate(parts) for parts in zip(*clips)]
    rng = np.random.default_rng(seed)
    return train_torch.to_device(
        train_torch.prepare_batch(rng, *clip, M, STEPS), dev)


def bench_row(dev, amp, B, reps, steps_per_rep):
    """-> (ms per step, first step s, peak GiB, loss)."""
    import torch
    from chip_smoke import train_state
    from dpvo_tpu_torch.parallel.train_step import make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state = train_state(dev, seed=0)
    batch = make_batch(B, dev)
    step = make_train_step(steps=STEPS, M=M, amp=amp)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, m = step(state, batch)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(steps_per_rep):
            state, m = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / steps_per_rep)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    return min(times) * 1e3, first, peak, float(m["loss"])


def bench(dev, reps=5, steps_per_rep=4):
    """The table's rows: [(precision, B, ms, samples/s, first s, GiB)]."""
    import torch
    rows = []
    for name, amp, B in ROWS:
        try:
            ms, first, peak, loss = bench_row(dev, amp, B, reps,
                                              steps_per_rep)
        except torch.cuda.OutOfMemoryError as e:
            print(f"[train_bench] {name} B={B}: out of memory ({e})",
                  flush=True)
            rows.append((name, B, None, None, None, None))
            torch.cuda.empty_cache()
            continue
        rows.append((name, B, ms, B / (ms / 1e3), first, peak))
        print(f"[train_bench] {name} B={B}: {ms:.1f} ms/step "
              f"({B / (ms / 1e3):.3f} samples/s), first step {first:.2f} s, "
              f"peak {peak:.2f} GiB, loss {loss:.4f}", flush=True)
        torch.cuda.empty_cache()
    return rows


def main(argv):
    quick = "quick" in argv
    dev = mb.card("train_bench_torch")
    rows = bench(dev, reps=1 if quick else 5, steps_per_rep=1 if quick else 4)
    print(f"\n{N} frames, {H}x{W}, M={M}, {STEPS} iterations\n"
          "| precision | batch | ms/step | samples/s | first step s | "
          "peak GiB |\n|---|---|---|---|---|---|")
    for name, B, ms, sps, first, peak in rows:
        if ms is None:
            print(f"| {name} | {B} | out of memory | - | - | - |")
        else:
            print(f"| {name} | {B} | {ms:.1f} | {sps:.3f} | {first:.2f} | "
                  f"{peak:.2f} |")
    f32 = rows[0]
    b16 = rows[1]
    if f32[2] and b16[2]:
        print(f"\nbf16 over fp32 at batch 1: {f32[2] / b16[2]:.3f}x the "
              f"speed, {b16[5] / f32[5]:.3f}x the peak memory", flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    sys.exit(main(sys.argv[1:]))
