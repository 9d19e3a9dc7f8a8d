#!/usr/bin/env python3
"""Phase probes of the port's two-level correlation kernel on one GPU.

    python scripts/dev/corr_variants_torch.py probe [E]    # E default 16384

The port's counterpart of ``scripts/dev/corr_variants.py probe [E]``: the
five phase probes of K1's window stage (``ops.corr_cuda.corr_probe``,
stopped after load, convert, shift, multiply and the tap dot) and the full
K1 (``corr_fused``, raw layout, bf16), timed with CUDA events on that
script's ``make_inputs`` shapes: E edges in 16-edge tiles, each tile on one
of 20 frames of bf16 rings at 120x160 / 30x40, coordinates uniform over the
frame and 5 px beyond.  Prints one line per probe, in ms per call.  Needs a
CUDA card; a probe that fails to build or launch raises.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

TILE = 16


def make_inputs(E, mem=20, seed=0, device="cuda"):
    """``corr_variants.make_inputs`` as torch tensors on ``device``: g_pre
    (E, 9, 128), fmap1 (mem, 136, 176, 128), fmap2 (mem, 46, 56, 128) bf16
    (random values in the border too), coords (E, 2, 3, 3) fp32, ff_rows
    (E,) int32 (tile i's frame, tiles sorted by frame)."""
    import torch
    from dpvo_tpu_torch.ops.corr_cuda import padded_hw
    H1, W1, H2, W2, C = 120, 160, 30, 40, 128
    Hp1, Wp1 = padded_hw(H1, W1)
    Hp2, Wp2 = padded_hw(H2, W2)
    rng = np.random.default_rng(seed)

    def bf(a):
        return torch.from_numpy(a).to(device=device, dtype=torch.bfloat16)

    g = bf(rng.standard_normal((E, 9, C)))
    f1 = bf(rng.standard_normal((mem, Hp1, Wp1, C)) * 0.3)
    f2 = bf(rng.standard_normal((mem, Hp2, Wp2, C)) * 0.3)
    coords = np.stack([rng.uniform(-5, W1 + 5, (E, 3, 3)),
                       rng.uniform(-5, H1 + 5, (E, 3, 3))], axis=1)
    tf = np.sort(rng.integers(0, mem, (E // TILE,)).astype(np.int32))
    return (g, f1, f2,
            torch.from_numpy(coords.astype(np.float32)).to(device),
            torch.from_numpy(np.repeat(tf, TILE)).to(device))


def time_ms(fn, reps=8, warm=2):
    """Mean device ms per call over ``reps`` calls (CUDA events)."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def probe(E, reps=8, device="cuda"):
    """Time the five probes and the full K1 at E edges on the card; print
    one line each.  -> {probe name or "k1_raw": ms per call}."""
    import torch
    from dpvo_tpu_torch.device import resolve_device
    from dpvo_tpu_torch.ops import corr_cuda
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the probes time CUDA kernels: they need a card")
    g, f1, f2, coords, ff = make_inputs(E, device=dev)
    out = {}
    for name in corr_cuda.PROBES:
        out[name] = time_ms(lambda: corr_cuda.corr_probe(
            g, f1, f2, coords, ff, name), reps)
        print(f"{name} E={E}: {out[name]:.4f} ms", flush=True)
    out["k1_raw"] = time_ms(lambda: corr_cuda.corr_fused(
        g, f1, f2, coords, ff, "raw", torch.bfloat16), reps)
    print(f"k1_raw E={E}: {out['k1_raw']:.4f} ms", flush=True)
    return out


def main(argv):
    if "probe" not in argv:
        print(__doc__.strip().splitlines()[2], file=sys.stderr)
        return 2
    E = int(argv[-1]) if argv[-1].isdigit() else 16384
    probe(E)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    sys.exit(main(sys.argv[1:]))
