#!/usr/bin/env python3
"""Where the update operator's time goes at retain scale, on one GPU.

    python scripts/dev/update_net_profile_torch.py [rows] [live] [window] [quick]

The port's counterpart of ``update_net_profile.py``, at its defaults (45056
rows, 44640 live edges over a 22-frame window; the state of
``frame_profile_torch.bench_state``: 480x640, M=96, bf16, seeded random
weights).  Device ms per call (``microbench_torch.timed``) of the port's
counterpart of each JAX section:

- the full update with its edge metadata, on the compact path (the
  engine's: K3 in both SoftAggs; the corr features in K2's ``("enc",
  act)`` form);
- the edge metadata alone (the (kk, jj) sort, neighbours, both compact
  group tables);
- one SoftAgg on the compact path (K3);
- the two neighbour gathers of the hidden state (bf16);
- the 12 dense matmuls (the 882->384 corr encoder and 11 384->384 layers,
  bf16);
- a row gather of the (E, 384) fp32 hidden state.

No counterpart: the JAX sorted path's full and blocked cumsums
(``cumsum (E,384)``, ``blocked cumsum``) are how a TPU sums segments
without scatters; the port sums them in K3 (and BA's in K4).  Needs a CUDA
card.
"""
from __future__ import annotations

import sys
from pathlib import Path

import microbench_torch as mb
from frame_profile_torch import (K_CAP, bench_state, edge_meta, live_edges,
                                 update_net)


def profile(dev, rows=45056, live=44640, window=22, reps=10, windows=5):
    """Time each section; -> {section: Timed}."""
    import torch
    from torch import nn
    from dpvo_tpu_torch.models.update import DIM, CorrDense
    _, ds, _, update_mod, _ = bench_state(dev, rows, window)
    ii, jj, kk, valid = live_edges(ds, live)
    gen = torch.Generator(device=dev).manual_seed(2)
    dt = torch.bfloat16
    corr = ("enc", torch.randn((live, DIM), generator=gen, device=dev,
                               dtype=dt))
    corr882 = torch.randn((live, 882), generator=gen, device=dev, dtype=dt)
    x = torch.randn((live, DIM), generator=gen, device=dev, dtype=dt)
    net = ds.net[:live]
    nbrs, cm = edge_meta(ii, jj, kk, valid)
    ix, jx = nbrs
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        enc = CorrDense(882, DIM).to(dev, dt)
        dense = nn.Linear(DIM, DIM).to(dev, dt)

    def gathers():
        h = net.to(dt)
        return h[ix.clamp(min=0)], h[jx.clamp(min=0)]

    def matmuls():
        y = net.to(dt) + enc(corr882)
        for _ in range(11):
            y = dense(y)
        return y

    print(f"[update_net_profile] rows={rows} live={live} window={window}: "
          f"DIM {DIM}, bf16, g_cap {K_CAP + 8}", flush=True)
    kw = dict(reps=reps, windows=windows)
    out = {}
    with torch.no_grad():
        out["update_full"] = mb.timed(
            f"update full, compact path, incl. metadata E={live}",
            update_net, ds, update_mod, corr, ii, jj, kk, valid, **kw)
        out["meta"] = mb.timed(f"edge metadata alone E={live}", edge_meta,
                               ii, jj, kk, valid, **kw)
        out["softagg"] = mb.timed(
            f"one SoftAgg, compact path (K3) E={live}", update_mod.agg_kk, x,
            compact_meta=cm[0], g_cap=K_CAP + 8, **kw)
        out["gathers"] = mb.timed(f"neighbour gathers E={live}", gathers,
                                  **kw)
        out["matmuls"] = mb.timed(f"12 dense matmuls E={live}", matmuls, **kw)
        out["row_gather"] = mb.timed(f"row gather (E, 384) fp32 E={live}",
                                     lambda: net[cm[0][0]], **kw)
    return out


def main(argv):
    quick = "quick" in argv
    ints = [int(a) for a in argv if a.isdigit()]
    rows, live, window = (ints + [45056, 44640, 22][len(ints):])[:3]
    dev = mb.card("update_net_profile_torch")
    profile(dev, rows, live, window, reps=3 if quick else 10,
            windows=3 if quick else 5)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    sys.exit(main(sys.argv[1:]))
