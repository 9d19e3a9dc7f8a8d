#!/usr/bin/env python3
"""Roofline shares of K1 and local BA at the bench operating points, on one
GPU.

    python scripts/dev/roofline_torch.py [edges ...]   # default 14336 45312

The port's counterpart of ``roofline.py``.  For K1 (``corr_fused``, v12
layout, bf16) and ``ba_iterative`` (2 iterations) at each edge count it
counts the operations the algorithm needs and the least device bytes (each
input read once, each output written once), times the call with
``microbench_torch.timed``, and prints TFLOP/s and GB/s as shares of the
published H100 SXM peaks (989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s
fp32, 3.35 TB/s), with the card's name and power limit above them.

- K1's inputs are ``chip_smoke.corr_inputs``' main-path patches (36-frame
  rings at 120x160 and 30x40, the frames and patches the kernels line uses
  at that edge count); its counts are ``chip_smoke.raw_work``'s, the
  kernels line's: the 8x8 window dots of 128 channels at 9 pixels and 2
  levels, and the ring pixels the windows touch, counted once.
- BA's problem is ``roofline.py``'s (64 poses, 4096 patches, n_cap 16,
  k_cap 4096, sorted patch indices) with every edge's frames inside the
  16-pose window.  The algorithm's count per iteration: per edge, the two
  residual rows' 12x12 Hessian blocks, gradient and pose-depth coupling
  (680 operations); per patch touched, the dense Schur update over the
  window's 96 columns; the 96x96 Cholesky factor and solve.  Beside it,
  ``roofline.py``'s count, which is the JAX implementation's own (and the
  port's): the one-hot J_eff products over all 96 columns for every edge,
  and J_eff's bytes.

The TPU script's empirical VPU peak is not copied: the H100 publishes its
fp32 rate.  Needs a CUDA card.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

import microbench_torch as mb

PEAK = {"bf16": 989e12, "fp32": 67e12}
HBM = 3.35e12
BA_N, BA_K, BA_P, N_CAP, K_CAP, T0 = 64, 4096, 3, 16, 4096, 2


def k1_work(g_pre, f1, f2, coords, ff, out):
    """(operations, least bytes) of one K1 call: ``chip_smoke.raw_work``'s
    counts."""
    from chip_smoke import raw_work
    nbytes, ops = raw_work(g_pre, (f1, f2), coords, ff, out)
    return ops, nbytes


def ba_work(E, k_used, iterations=2, n_cap=N_CAP, n_poses=BA_N, K=BA_K,
            P=BA_P, index_bytes=8):
    """BA's counts: {"algorithm": (ops, bytes), "roofline.py": (ops,
    bytes)} for E edges touching ``k_used`` patches.

    Bytes (algorithm): poses and patches read and written, intrinsics,
    targets and weights, ii/jj/kk at ``index_bytes`` each and the valid
    mask read once."""
    D = 6 * n_cap
    ops_iter = 680 * E + 2 * D * D * k_used + D ** 3 // 3 + 2 * D * D
    nbytes = (2 * (n_poses * 7 * 4 + K * 3 * P * P * 4) + 4 * 4
              + E * (2 * 2 * 4 + 3 * index_bytes + 1))
    # roofline.py's ba_point, verbatim in its terms (n6 = 6 n_cap)
    n6 = D
    flops_iter = 2 * n6 * n6 * 2 * E + 2 * E * 2 * n6 * 4
    jax_bytes = (E * (2 + 2 + 4 * 3) * 4 * 2 + K * 3 * P * P * 4 * 2
                 + E * 2 * n6 * 4)
    return {"algorithm": (iterations * ops_iter, nbytes),
            "roofline.py": (2 * flops_iter, jax_bytes)}


def ba_problem(E, dev, seed=1):
    """``roofline.py``'s ba_point problem with the edges' frames inside the
    window: the ``ba_iterative`` arguments."""
    import torch
    rng = np.random.default_rng(seed)
    poses = np.concatenate([rng.standard_normal((BA_N, 3)) * 0.1,
                            np.tile([0, 0, 0, 1.0], (BA_N, 1))], axis=1)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    ii = rng.integers(T0, T0 + N_CAP, E)
    jj = rng.integers(T0, T0 + N_CAP, E)
    kk = np.sort(rng.integers(0, BA_K, E))
    return (t(poses), t(rng.uniform(10, 100, (BA_K, 3, BA_P, BA_P))),
            t([120.0, 120.0, 80.0, 60.0]), t(rng.uniform(0, 150, (E, 2))),
            t(rng.uniform(0, 1, (E, 2))), 1e-4, t(ii, torch.int64),
            t(jj, torch.int64), t(kk, torch.int64),
            torch.ones(E, dtype=torch.bool, device=dev), T0, T0 + N_CAP)


def report(name, ms, ops, nbytes, kind):
    """One line: TFLOP/s and GB/s with their shares of the peaks, and the
    bound (the larger of the two least times) as a share of ``ms``."""
    tfs = ops / (ms * 1e-3) / 1e12
    gbs = nbytes / (ms * 1e-3) / 1e9
    t_ops, t_bytes = ops / PEAK[kind] * 1e3, nbytes / HBM * 1e3
    bound = max(t_ops, t_bytes)
    print(f"  {name}: {ops / 1e9:.4f} GFLOP, {nbytes / 1e6:.4f} MB; "
          f"{tfs:.4f} TFLOP/s ({100 * tfs * 1e12 / PEAK[kind]:.3f}% of "
          f"{kind} peak), {gbs:.2f} GB/s ({100 * gbs * 1e9 / HBM:.3f}% of "
          f"HBM); bound {bound:.5f} ms by "
          f"{'bytes' if t_bytes >= t_ops else 'operations'} "
          f"({100 * bound / ms:.2f}% of the time)", flush=True)


def roofline(dev, edges=(14336, 45312), reps=10, windows=5):
    """Time and count K1 and BA at each edge count."""
    import torch
    from chip_smoke import SHAPES, corr_inputs
    from dpvo_tpu_torch.ops import ba, corr_cuda
    shapes = {E: (f, k) for E, f, k in SHAPES}
    kw = dict(reps=reps, windows=windows)
    for E in edges:
        n_frames, n_patches = shapes.get(E, (16, 16 * 96))
        gen = torch.Generator(device=dev).manual_seed(E)
        g_all, kk, _, f1, f2, coords, ff = corr_inputs(E, n_frames,
                                                       n_patches, dev, gen)
        g_pre = g_all[kk.long()]
        with torch.no_grad():
            out = corr_cuda.corr_fused(g_pre, f1, f2, coords, ff, "v12",
                                       torch.bfloat16)
            t = mb.timed(f"K1 corr_fused v12 E={E}", corr_cuda.corr_fused,
                         g_pre, f1, f2, coords, ff, "v12", torch.bfloat16,
                         **kw)
        ops, nbytes = k1_work(g_pre, f1, f2, coords, ff, out)
        report(f"K1 v12 E={E} ({n_frames} frames, {n_patches} patches)",
               t.ms, ops, nbytes, "bf16")
    for E in edges:
        args = ba_problem(E, dev)
        with torch.no_grad():
            t = mb.timed(f"ba_iterative 2 it E={E}", ba.ba_iterative, *args,
                         N_CAP, K_CAP, 2, **kw)
        k_used = int(torch.unique(args[8]).numel())
        for name, (ops, nbytes) in ba_work(E, k_used).items():
            report(f"ba_iterative E={E}, {name} count", t.ms, ops, nbytes,
                   "fp32")


def main(argv):
    edges = [int(a) for a in argv if a.isdigit()] or [14336, 45312]
    quick = "quick" in argv
    dev = mb.card("roofline_torch")
    roofline(dev, edges, reps=3 if quick else 10, windows=3 if quick else 5)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    sys.exit(main(sys.argv[1:]))
