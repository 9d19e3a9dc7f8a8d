#!/usr/bin/env python3
"""Where the reprojection and correlation block's time goes at retain
scale, on one GPU.

    python scripts/dev/corr_block_profile_torch.py [rows] [live] [window] [quick]

The port's counterpart of ``corr_block_profile.py``, at its defaults (45056
rows, 44640 live edges over a 22-frame window; the state of
``frame_profile_torch.bench_state``: 480x640, M=96, 36-frame bf16 rings).
Device ms per call (``microbench_torch.timed``) of:

- the whole block as ``update_step`` runs it (``transform``, then K2, or
  K1 at ``DPVO_CORR_VERSION`` 12);
- ``transform`` (per-edge relative poses);
- the ``g_pre`` gather of the patch rows (K1's input; K2 gathers them
  itself);
- the coordinate permute to (E, 2, 3, 3);
- K2 (``corr_enc``) alone, and K1 (``corr_fused``, v12 layout) alone.

No counterpart: ``corr_grouping`` (frame-pure edge tiles and dead-tile
skipping) is a Mosaic mechanic; the CUDA kernels read each edge's frame
from ``jj``.  Needs a CUDA card.
"""
from __future__ import annotations

import sys
from pathlib import Path

import microbench_torch as mb
from frame_profile_torch import (M, MEM, bench_state, live_edges,
                                 reproject_corr)


def profile(dev, rows=45056, live=44640, window=22, reps=10, windows=5):
    """Time each section; -> {section: Timed}."""
    import torch
    from dpvo_tpu_torch.ops import corr_cuda, projective as pops
    _, ds, _, update_mod, _ = bench_state(dev, rows, window)
    ii, jj, kk, _ = live_edges(ds, live)
    kk_mod, jj_mod = (kk % (M * MEM)).int(), (jj % MEM).int()
    K = ds.gmap.shape[0]
    g_all = ds.gmap.reshape(K, -1, ds.gmap.shape[-1])
    w_raw = update_mod.corr1.raw_kernel().to(ds.gmap.dtype)
    coords = pops.transform(ds.poses, ds.patches, ds.intrinsics, ii, jj, kk)
    c = coords.permute(0, 3, 1, 2).contiguous()
    g_pre = g_all[kk_mod.long()]
    print(f"[corr_block_profile] rows={rows} live={live} window={window}: "
          f"rings {tuple(ds.fmap1.shape)} and {tuple(ds.fmap2.shape)} bf16",
          flush=True)
    kw = dict(reps=reps, windows=windows)
    out = {}
    with torch.no_grad():
        out["block"] = mb.timed(f"transform + correlation (K2) E={live}",
                                reproject_corr, ds, update_mod, ii, jj, kk,
                                **kw)
        out["transform"] = mb.timed(
            f"transform E={live}", pops.transform, ds.poses, ds.patches,
            ds.intrinsics, ii, jj, kk, **kw)
        out["g_pre"] = mb.timed(f"g_pre gather E={live}",
                                lambda: g_all[kk_mod.long()], **kw)
        out["coords_permute"] = mb.timed(
            f"coordinate permute E={live}",
            lambda: coords.permute(0, 3, 1, 2).contiguous(), **kw)
        out["k2"] = mb.timed(f"K2 corr_enc alone E={live}",
                             corr_cuda.corr_enc, g_all, kk_mod, w_raw,
                             ds.fmap1, ds.fmap2, c, jj_mod, **kw)
        out["k1_v12"] = mb.timed(f"K1 corr_fused v12 alone E={live}",
                                 corr_cuda.corr_fused, g_pre, ds.fmap1,
                                 ds.fmap2, c, jj_mod, "v12", torch.bfloat16,
                                 **kw)
    return out


def main(argv):
    quick = "quick" in argv
    ints = [int(a) for a in argv if a.isdigit()]
    rows, live, window = (ints + [45056, 44640, 22][len(ints):])[:3]
    dev = mb.card("corr_block_profile_torch")
    profile(dev, rows, live, window, reps=3 if quick else 10,
            windows=3 if quick else 5)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    sys.exit(main(sys.argv[1:]))
