#!/usr/bin/env python3
"""The port's segment ops against dense numpy references, and their device
times, at DPVO's shapes, on one GPU.

    python benchmarks/compare_scatter_torch.py

The port's counterpart of ``compare_scatter.py``: ``ops.scatter``'s
``scatter_sum``, ``scatter_softmax``, ``scatter_mean`` and ``scatter_max``
on (E, 384) fp32 rows into S segments, at the inference shape (E 1280,
S 1280) and the training shape (E 8192, S 1024), each held against a dense
numpy loop over the segments (max |error| within 1e-5, relative to the
largest reference value for the sums) and timed with
``microbench_torch.timed`` (device ms per call).  Needs a CUDA card.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

DIM = 384
CONFIGS = (("inference", 1280, 80 * 16), ("training", 8192, 1024))
TOL = 1e-5
OPS = ("scatter_sum", "scatter_softmax", "scatter_mean", "scatter_max")


def dense(op, src, idx, S):
    """The dense numpy reference of ``op`` (float64)."""
    src = src.astype(np.float64)
    if op == "scatter_softmax":
        out = np.zeros_like(src)
        for g in np.unique(idx):
            m = idx == g
            e = np.exp(src[m] - src[m].max(axis=0))
            out[m] = e / e.sum(axis=0)
        return out
    out = np.full((S, src.shape[1]), -np.inf if op == "scatter_max" else 0.0)
    for g in range(S):
        rows = src[idx == g]
        if len(rows) == 0:
            continue
        out[g] = {"scatter_sum": rows.sum(0), "scatter_mean": rows.mean(0),
                  "scatter_max": rows.max(0)}[op]
    return out


def inputs(E, S, device, seed=0):
    import torch
    gen = torch.Generator(device="cpu").manual_seed(seed)
    src = torch.randn((E, DIM), generator=gen)
    idx = torch.randint(0, S, (E,), generator=gen)
    return src.to(device), idx.to(device)


def errors(E, S, device, seed=0):
    """{op: max |port - dense| / max(1, max |dense|)} at (E, S)."""
    from dpvo_tpu_torch.ops import scatter
    src, idx = inputs(E, S, device, seed)
    s_np, i_np = src.cpu().numpy(), idx.cpu().numpy()
    out = {}
    for op in OPS:
        got = getattr(scatter, op)(src, idx, S).cpu().numpy().astype(
            np.float64)
        ref = dense(op, s_np, i_np, S)
        fin = np.isfinite(ref)
        if not np.array_equal(fin, np.isfinite(got)):
            out[op] = float("inf")
            continue
        scale = max(1.0, float(np.abs(ref[fin]).max()))
        out[op] = float(np.abs(got[fin] - ref[fin]).max()) / scale
    return out


def main(argv):
    import torch
    here = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(here), str(here / "scripts" / "dev")]
    import microbench_torch as mb
    from dpvo_tpu_torch.ops import scatter
    dev = mb.card("compare_scatter_torch")
    bad = []
    for name, E, S in CONFIGS:
        err = errors(E, S, dev)
        print(f"[compare_scatter] {name} E={E} S={S} max error vs dense "
              + ", ".join(f"{op} {e:.3e}" for op, e in err.items())
              + f" (tol {TOL})", flush=True)
        bad += [f"{name} {op}" for op, e in err.items() if not e <= TOL]
        src, idx = inputs(E, S, dev)
        with torch.no_grad():
            for op in OPS:
                mb.timed(f"{name} E={E} S={S} {op}", getattr(scatter, op),
                         src, idx, S)
    if bad:
        raise SystemExit(f"compare_scatter_torch: {bad} disagree with the "
                         f"dense references")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
