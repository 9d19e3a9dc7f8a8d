#!/usr/bin/env python3
"""Run-to-run spread of the port's full-width training step on one GPU.

    python scripts/dev/train_spread_torch.py [REPEATS] [MODES]

``chip_smoke.py``'s full-width step (``configs/tartan_train.yaml``: 480x640,
N=15, M=80, 18 iterations, bf16 autocast, the same seeded weights and
synthetic batches) is run REPEATS times (default 3) from the same initial
state in each mode of MODES (comma-separated, default all):

- ``default``: as ``chip_smoke.py`` runs it;
- ``deterministic``: under ``torch.use_deterministic_algorithms(True,
  warn_only=True)`` (the operations that still have no deterministic CUDA
  implementation are listed);
- ``fp32_sums``: ``ops.scatter.scatter_sum`` accumulates in fp32 and casts
  back (SoftAgg's bf16 ``index_add`` under autocast is then fp32);
- ``fp32``: autocast off.

Each repeat is a structure-only step on batch 0, then a full step on batch
1.  Per step it prints the loss and the global gradient norm; for the full
step also the three leaves with the largest share of the squared gradient
norm and how the gradient
of the loss with respect to the update operator's outputs (``delta`` and
``weight``, per edge and rollout iteration) is spread: the largest edge's
share of the squared total and the share of the 10 largest.  One JSON
record per mode goes to ``chiprun_out/train_spread.json``.  Needs a CUDA
card.
"""
from __future__ import annotations

import os
import sys
import time
import warnings
from pathlib import Path

# deterministic cuBLAS needs its workspace fixed before the first call
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

MODES = ("default", "deterministic", "fp32_sums", "fp32")


def edge_grad_recorder(update_mod):
    """Hooks the update operator's ``delta`` and ``weight`` outputs of every
    rollout iteration; returns the list their per-edge squared gradient
    norms are appended to, and the hook handle."""
    import torch
    rec = []

    def fwd_hook(_mod, _inputs, out):
        if not torch.is_grad_enabled():
            return
        acc = {}

        def grab(name):
            def hook(g):
                acc[name] = (g.float() ** 2).sum(-1)
                if len(acc) == 2:
                    rec.append(acc["delta"] + acc["weight"])
            return hook
        for name, t in (("delta", out[1]), ("weight", out[2])):
            if t.requires_grad:
                t.register_hook(grab(name))
    return rec, update_mod.register_forward_hook(fwd_hook)


def run_mode(mode, repeats, dev):
    import torch
    import chip_smoke as cs
    from dpvo_tpu_torch.ops import scatter
    from dpvo_tpu_torch.parallel import train_step as ts
    cfg = cs.TRAIN_FULL
    batches = cs.train_batches(2, 5, cfg["N"], cfg["H"], cfg["W"], cfg["M"],
                               cfg["iters"], dev)
    amp = mode != "fp32"
    plain_sum = scatter.scatter_sum
    if mode == "fp32_sums":
        def scatter_sum(src, index, num_segments):
            return plain_sum(src.float(), index, num_segments).to(src.dtype)
        scatter.scatter_sum = scatter_sum
    torch.use_deterministic_algorithms(mode == "deterministic",
                                       warn_only=True)
    runs, nondet = [], set()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for r in range(repeats):
                state = cs.train_state(dev, seed=0)
                rec, handle = edge_grad_recorder(state.update)
                steps = []
                for so, batch in zip((True, False), batches):
                    rec.clear()
                    step = ts.make_train_step(steps=cfg["iters"],
                                              M=cfg["M"], structure_only=so,
                                              amp=amp)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    state, m = step(state, batch)
                    torch.cuda.synchronize()
                    ms = (time.perf_counter() - t0) * 1e3
                    # each leaf's share of |g|^2 (the step clipped .grad
                    # in place, which leaves the shares as they were)
                    sq = {f"{pre}.{n}": float((p.grad.float() ** 2).sum())
                          for pre, mod in state.modules().items()
                          for n, p in mod.named_parameters()}
                    total = max(sum(sq.values()), 1e-30)
                    leaves = sorted(((v / total, n) for n, v in sq.items()),
                                    reverse=True)[:3]
                    e2 = (torch.cat(rec) if rec else torch.zeros(1))
                    tot = float(e2.sum())
                    top = torch.topk(e2, min(10, e2.numel())).values
                    steps.append(dict(
                        structure_only=so, ms=ms, loss=float(m["loss"]),
                        gnorm=float(m["gnorm"]),
                        top_leaves=[[n, g] for g, n in leaves],
                        edge_iters=int(e2.numel()),
                        top1_share=float(top[0]) / max(tot, 1e-30),
                        top10_share=float(top.sum()) / max(tot, 1e-30)))
                handle.remove()
                runs.append(steps)
                for s in steps:
                    cs.log(f"[spread] {mode} repeat {r} "
                           f"{'structure-only' if s['structure_only'] else 'full'}"
                           f": {s['ms']:.1f} ms, loss {s['loss']:.6f}, gnorm "
                           f"{s['gnorm']:.6f}; largest leaves' share of "
                           f"|g|^2 "
                           + ", ".join(f"{n} {g:.4f}"
                                       for n, g in s["top_leaves"])
                           + f"; largest edge-iteration share of |dL/d(delta,"
                           f"weight)|^2 {s['top1_share']:.4f}, 10 largest "
                           f"{s['top10_share']:.4f} of {s['edge_iters']}")
                del state
                torch.cuda.empty_cache()
            for w in caught:
                msg = str(w.message)
                if "deterministic" in msg:
                    nondet.add(msg.split("\n")[0][:160])
    finally:
        scatter.scatter_sum = plain_sum
        torch.use_deterministic_algorithms(False)
    spread = {}
    for i, key in enumerate(("structure_only", "full")):
        for k in ("loss", "gnorm"):
            v = [run[i][k] for run in runs]
            spread[f"{key}.{k}"] = dict(min=min(v), max=max(v),
                                        rel=(max(v) - min(v)) / abs(min(v)))
    for k, v in spread.items():
        cs.log(f"[spread] {mode} {k}: min {v['min']:.6f} max {v['max']:.6f} "
               f"(max - min) / min {v['rel']:.3e}")
    for msg in sorted(nondet):
        cs.log(f"[spread] {mode} still nondeterministic: {msg}")
    return dict(mode=mode, runs=runs, spread=spread,
                nondeterministic=sorted(nondet))


def main(argv):
    import json
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("train_spread_torch: no CUDA device", file=sys.stderr)
        return 1
    repeats = int(argv[0]) if argv else 3
    modes = argv[1].split(",") if len(argv) > 1 else MODES
    cs.log(f"[machine] {cs.card_line()}; torch {torch.__version__}")
    dev = torch.device("cuda:0")
    out = [run_mode(mode, repeats, dev) for mode in modes]
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    with open(ROOT / "chiprun_out" / "train_spread.json", "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
