#!/usr/bin/env python3
"""Training data plane throughput: augmentation, batch preparation and the
batch's upload to one GPU.

    python benchmarks/benchmark_dataloader_torch.py [quick]

The port's counterpart of ``benchmark_dataloader.py``, measured as it
measures: ``data/augmentation.RGBDAugmentor`` on 15 synthetic 520x696
frames cropped to 480x640 (ms per sample, 20 calls after a warm one), and
``train_torch.prepare_batch`` at B=1, N=15, 480x640, M=80, 18 iterations
(ms per sample with the schedule build, 10 calls after a warm one); both
are host work (numpy, OpenCV).  The port adds the prepared batch's copy to
the card (``train_torch.to_device``, ms with a device synchronise, 10
calls), which the training step waits for.  ``quick``: 3 calls each.
Needs a CUDA card.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np


def per_call_ms(fn, n_iters):
    fn()
    t0 = time.perf_counter()
    for _ in range(n_iters):
        fn()
    return (time.perf_counter() - t0) / n_iters * 1e3


def bench_augmentation(n_iters=20, n_frames=15, hw=(480, 640)):
    from dpvo_tpu_torch.data.augmentation import RGBDAugmentor
    aug = RGBDAugmentor(crop_size=hw)
    H, W = 520, 696
    images = (np.random.rand(n_frames, H, W, 3) * 255).astype(np.float32)
    disps = np.random.rand(n_frames, H, W).astype(np.float32)
    poses = np.zeros((n_frames, 7), np.float32)
    poses[:, 6] = 1
    intr = np.tile(np.array([320.0, 320, 320, 240], np.float32),
                   (n_frames, 1))
    ms = per_call_ms(lambda: aug(images, poses, disps, intr), n_iters)
    print(f"augmentation: {ms:.1f} ms/sample ({n_frames} frames @ {hw})",
          flush=True)
    return ms


def bench_batch_prep(dev, n_iters=10):
    import torch
    import train_torch
    rng = np.random.default_rng(0)
    B, N, H, W, M, S = 1, 15, 480, 640, 80, 18
    images = rng.random((B, N, H, W, 3), np.float32) * 255
    poses = np.zeros((B, N, 7), np.float32)
    poses[..., 6] = 1
    disps = rng.random((B, N, H, W)).astype(np.float32)
    intr = np.tile(np.array([320.0, 320, 320, 240], np.float32), (B, N, 1))
    ms = per_call_ms(lambda: train_torch.prepare_batch(
        rng, images, poses, disps, intr, M, S), n_iters)
    print(f"batch prep (incl. schedule build): {ms:.1f} ms/sample",
          flush=True)
    batch = train_torch.prepare_batch(rng, images, poses, disps, intr, M, S)

    def upload():
        train_torch.to_device(batch, dev)
        torch.cuda.synchronize()

    up = per_call_ms(upload, n_iters)
    nbytes = sum(v.nbytes for k, v in batch.items()
                 if not k.startswith("sch_"))
    print(f"batch upload to the card: {up:.1f} ms/sample "
          f"({nbytes / 2 ** 20:.1f} MiB)", flush=True)
    return ms, up


def main(argv):
    here = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(here), str(here / "scripts" / "dev")]
    import microbench_torch as mb
    dev = mb.card("benchmark_dataloader_torch")
    quick = "quick" in argv
    bench_augmentation(n_iters=3 if quick else 20)
    bench_batch_prep(dev, n_iters=3 if quick else 10)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
