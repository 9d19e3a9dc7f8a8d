#!/usr/bin/env python3
"""Device ms of each program the port's engine dispatches per frame, at the
bench operating point, on one GPU.

    python scripts/dev/frame_profile_torch.py [rows] [live] [window] [quick]
    python scripts/dev/frame_profile_torch.py 45056 44640 22   # retain

The port's counterpart of ``frame_profile.py``, with its arguments and
defaults: an edge table of ``rows`` rows (16384) of which the first
``live`` (13824, the merge regime's ~13.8k) are live, their patches in the
``window`` frames (12) before frame ``2 * window``, sorted by patch, each
edge's target frame 1-11 frames after its source; 480x640 frames, M=96,
36-frame rings, bf16, seeded random weights, ``EDGE_CAPACITY=57344``.
Where a JAX program ran at ``rows`` (its bucket), the port's runs at the
live count, as its engine does; ``permute_edges`` moves ``rows`` rows.

Timed, each with ``microbench_torch.timed`` (device ms per call and its
timer): ``track_frame_u8`` (on its staged inputs, as the engine replays
it); ``append_edges`` (one frame's 2400 edges); ``permute_edges``;
``keyframe_merge`` (``relative_pose``, ``shift_edge_indices`` and
``compact_frames``, the engine's one merge program); ``ba_iterative`` (2
iterations, K4); the reprojection with the two-level correlation
(``transform`` and K2); the update net with its edge metadata (K3); the
edge metadata alone;
and, as ``frame_profile.py`` times ``update_step_dev``, the whole
``update_step`` with the kernels, without BA and with the plain
correlation swapped in.  The per-frame sum (the merge program once a
frame where ``live`` is the merge regime's) is printed beside the device
busy ms/frame of ``bench_torch.run_regime``'s matching regime over 5
profiled frames (``chip_smoke.py``'s ``[profile]`` reading).  Needs a CUDA
card.
"""
from __future__ import annotations

import contextlib
import sys
from pathlib import Path

import numpy as np

import microbench_torch as mb

HT, WD, M, P, MEM, N = 480, 640, 96, 3, 36, 256
N_CAP, K_CAP = 16, 4096
RETAIN_LIVE = 30000     # more live edges than this: the retain regime


def edge_table(rows, window, seed=0):
    """``frame_profile.py``'s edge table: (ii, jj, kk) int64 numpy, and the
    frame count ``n_now = 2 * window``."""
    rng = np.random.default_rng(seed)
    n_now = window * 2
    kk = np.sort(rng.integers((n_now - window) * M, n_now * M, rows))
    ii = kk // M
    jj = np.minimum(ii + rng.integers(1, 12, rows), n_now)
    return ii, jj, kk, n_now


def bench_state(dev, rows, window, seed=0):
    """A ``DeviceState`` at the bench point with ``edge_table``'s rows in
    its edge table, and seeded random networks.  -> (cfg, ds, patchifier,
    update_mod, n_now).  Patches are 3x3 grids at random feature-map
    positions with inverse depths in [0.2, 1]; pose t is translated by
    -0.01 t along x, so edges see a little flow."""
    import torch
    from dpvo_tpu_torch.config import VOConfig
    from dpvo_tpu_torch.engine.state import allocate
    from dpvo_tpu_torch.models.update import Update
    from dpvo_tpu_torch.models.vonet import Patchifier
    from dpvo_tpu_torch.ops.corr_cuda import PAD
    cfg = VOConfig(BUFFER_SIZE=N, MIXED_PRECISION=True, LOOP_CLOSURE=False,
                   EDGE_CAPACITY=57344)
    dt = torch.bfloat16
    ds = allocate(cfg, HT, WD, P, MEM, MEM, dev, dt)
    gen = torch.Generator(device=dev).manual_seed(seed)
    h, w = HT // 4, WD // 4

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev) * 0.25

    ds.poses[:, 0] = -0.01 * torch.arange(N, device=dev)
    ctr = torch.rand((N * M, 2), generator=gen, device=dev)
    ctr = ctr * torch.tensor([w - 4.0, h - 4.0], device=dev) + 2.0
    grid = torch.arange(3, device=dev, dtype=torch.float32) - 1
    ds.patches[:, 0] = ctr[:, 0, None, None] + grid[None, None, :]
    ds.patches[:, 1] = ctr[:, 1, None, None] + grid[None, :, None]
    ds.patches[:, 2] = (0.2 + 0.8 * torch.rand(
        (N * M,), generator=gen, device=dev))[:, None, None]
    ds.intrinsics[:] = torch.tensor([WD / 8, WD / 8, WD / 8, HT / 8],
                                    device=dev)
    ds.imap.copy_(randn(*ds.imap.shape).to(dt))
    ds.gmap.copy_(randn(*ds.gmap.shape).to(dt))
    ds.fmap1[:, PAD:PAD + h, PAD:PAD + w] = randn(MEM, h, w, 128).to(dt)
    ds.fmap2[:, PAD:PAD + h // 4, PAD:PAD + w // 4] = randn(
        MEM, h // 4, w // 4, 128).to(dt)
    ds.net.copy_(randn(*ds.net.shape))
    ii, jj, kk, n_now = edge_table(rows, window, seed)
    for tab, a in ((ds.eii, ii), (ds.ejj, jj), (ds.ekk, kk)):
        tab[:rows] = torch.as_tensor(a, dtype=torch.int32, device=dev)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        patchifier = Patchifier(P).to(dev, dt).eval()
        update_mod = Update(P).to(dev, dt).eval()
    return cfg, ds, patchifier, update_mod, n_now


def live_edges(ds, live):
    """The first ``live`` rows' (ii, jj, kk) int64 and an all-true valid."""
    import torch
    ii, jj, kk = (t[:live].long() for t in (ds.eii, ds.ejj, ds.ekk))
    return ii, jj, kk, torch.ones(live, dtype=torch.bool, device=ii.device)


def edge_meta(ii, jj, kk, valid):
    """``update_step``'s edge metadata: the (kk, jj) sort, temporal
    neighbours and both compact group tables."""
    from dpvo_tpu_torch.ops import graph, scatter
    order = graph.lexsort_kk_jj(kk, jj)
    nbrs = graph.neighbors_from_order(kk, valid, order)
    cm = (scatter.group_meta_compact(kk, order=order),
          scatter.group_meta_compact(ii * 12345 + jj))
    return nbrs, cm


def reproject_corr(ds, update_mod, ii, jj, kk):
    """``transform`` and the correlation of ``update_step`` (K2 at the
    default ``DPVO_CORR_VERSION``)."""
    from dpvo_tpu_torch.engine import kernels
    from dpvo_tpu_torch.ops import projective as pops
    coords = pops.transform(ds.poses, ds.patches, ds.intrinsics, ii, jj, kk)
    return kernels._corr_act(ds, update_mod, coords, kk % (M * MEM),
                             jj % MEM)


def update_net(ds, update_mod, corr, ii, jj, kk, valid):
    """The update operator with its edge metadata (K3 in its SoftAggs)."""
    nbrs, cm = edge_meta(ii, jj, kk, valid)
    ctx = ds.imap[kk % (M * MEM)].float()
    return update_mod(ds.net[:ii.shape[0]], ctx, corr, ii, jj, kk, valid,
                      nbrs=nbrs, compact_meta=cm, g_cap=K_CAP + 8)


@contextlib.contextmanager
def saved_edges(ds):
    """Restore the edge table (which the merge programs and the permute
    change) on exit."""
    keep = [t.clone() for t in (ds.eii, ds.ejj, ds.ekk)]
    try:
        yield
    finally:
        for t, k in zip((ds.eii, ds.ejj, ds.ekk), keep):
            t.copy_(k)


def device_busy(dev, regime, n_bench):
    """Device busy ms/frame over 5 profiled frames of
    ``bench_torch.run_regime`` (one ``n_bench``-frame window first)."""
    import bench_torch
    r = bench_torch.run_regime(regime, device=dev, min_windows=1,
                               max_windows=1, n_bench=n_bench,
                               profile_frames=5)
    prof, wall_ms, frames = r["profile"]
    busy, n_kern = mb.busy_ms(prof)
    return busy / frames, wall_ms / frames, n_kern / frames


def profile(dev, rows=16384, live=13824, window=12, reps=10, windows=5,
            n_bench=40):
    """Time every per-frame program; -> {program: Timed}."""
    import torch
    from chip_smoke import plain_correlation
    from dpvo_tpu_torch.engine import kernels
    from dpvo_tpu_torch.engine.state import track_inputs
    from dpvo_tpu_torch.ops import ba
    cfg, ds, patchifier, update_mod, n_now = bench_state(dev, rows, window)
    regime = "retain" if live > RETAIN_LIVE else "merge"
    print(f"[frame_profile] rows={rows} live={live} window={window} "
          f"n={n_now} ({regime} regime): {HT}x{WD}, M={M}, bf16, "
          f"k_cap={K_CAP}, n_cap={N_CAP}", flush=True)
    t0, t1 = n_now - 10, n_now
    ii, jj, kk, valid = live_edges(ds, live)
    gen = torch.Generator(device=dev).manual_seed(1)
    img = torch.randint(0, 255, (HT, WD, 3), dtype=torch.uint8, device=dev,
                        generator=gen)
    intr = [WD / 8, WD / 8, WD / 8, HT / 8]
    per_frame = M * (2 * cfg.PATCH_LIFETIME - 1)
    kk_new = torch.arange(per_frame, dtype=torch.int32, device=dev) % (
        M * 3) + (n_now - 3) * M
    jj_new = torch.full_like(kk_new, n_now)
    perm = torch.randperm(rows, device=dev, generator=gen)
    target = torch.rand((live, 2), generator=gen, device=dev) * 150
    weight = torch.rand((live, 2), generator=gen, device=dev)
    k = n_now - 5
    kw = dict(reps=reps, windows=windows)
    out = {}
    with torch.no_grad():
        ds.image_in.copy_(img)
        ds.track_in.copy_(torch.from_numpy(
            track_inputs(M, n_now, 1.0, True, intr)))
        out["track_frame_u8"] = mb.timed(
            "track_frame_u8", kernels.track_frame_u8, ds, patchifier, gen, M,
            MEM, MEM, 0.5, generators=(gen,), **kw)
        out["append_edges"] = mb.timed(
            f"append_edges ({per_frame} edges)", kernels.append_edges, ds,
            kk_new, jj_new, live, M, **kw)
        corr = reproject_corr(ds, update_mod, ii, jj, kk)
        out["reproject_corr"] = mb.timed(
            f"transform + correlation (K2) E={live}", reproject_corr, ds,
            update_mod, ii, jj, kk, **kw)
        out["update_net"] = mb.timed(
            f"update net incl. metadata (K3) E={live}", update_net, ds,
            update_mod, corr, ii, jj, kk, valid, **kw)
        out["edge_meta"] = mb.timed(
            f"edge metadata E={live}", edge_meta, ii, jj, kk, valid, **kw)
        out["ba_iterative"] = mb.timed(
            f"ba_iterative 2 it (K4) E={live}", ba.ba_iterative, ds.poses,
            ds.patches, ds.intrinsics[0], target, weight, 1e-4, ii, jj, kk,
            valid, t0, t1, N_CAP, K_CAP, 2, **kw)
        step = dict(M=M, pmem=MEM, mem=MEM, n_cap=N_CAP, k_cap=K_CAP,
                    iterations=2)
        out["update_step"] = mb.timed(
            f"update_step E={live}", kernels.update_step, ds, update_mod,
            live, t0, t1, run_ba=True, **step, **kw)
        out["update_step_no_ba"] = mb.timed(
            "  without BA", kernels.update_step, ds, update_mod, live, t0,
            t1, run_ba=False, **step, **kw)
        with plain_correlation():
            out["update_step_plain"] = mb.timed(
                "  with the plain correlation", kernels.update_step, ds,
                update_mod, live, t0, t1, run_ba=True, **step, **kw)
        with saved_edges(ds):
            out["permute_edges"] = mb.timed(
                f"permute_edges rows={rows}", kernels.permute_edges, ds,
                perm, live, **kw)
            ds.merge_in.copy_(torch.tensor([k, n_now]))
            out["keyframe_merge"] = mb.timed(
                "keyframe_merge", kernels.keyframe_merge, ds, M, MEM, MEM,
                cfg.kf_shift_cap(), **kw)
    frame = ["track_frame_u8", "append_edges", "permute_edges",
             "reproject_corr", "update_net", "ba_iterative"]
    if regime == "merge":
        frame += ["keyframe_merge"]
    total = sum(out[p].device_ms for p in frame)
    busy, wall, n_kern = device_busy(dev, regime, n_bench)
    print(f"[frame_profile] per-frame sum of device ms "
          f"({' + '.join(frame)}): {total:.4f} ms; bench_torch {regime} "
          f"regime, 5 profiled frames: device busy {busy:.4f} ms/frame, wall "
          f"{wall:.4f} ms/frame, {n_kern:.0f} kernels/frame", flush=True)
    return out


def main(argv):
    quick = "quick" in argv
    ints = [int(a) for a in argv if a.isdigit()]
    rows, live, window = (ints + [16384, 13824, 12][len(ints):])[:3]
    dev = mb.card("frame_profile_torch")
    profile(dev, rows, live, window, reps=3 if quick else 10,
            windows=3 if quick else 5, n_bench=10 if quick else 40)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    sys.exit(main(sys.argv[1:]))
