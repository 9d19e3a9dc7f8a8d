#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dpvo_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero, nothing is caught and passed over):

1. machine: the card's name and power limit, and the kernel build time;
2. kernels: every CUDA kernel against its plain PyTorch version on the
   card, at main-path shapes (480x640 frames, M=96, 36-frame rings,
   k_cap=4096) for the merge (6144 live edges), the JAX engine's lagged
   merge (14336) and the retain (45312) edge counts, with max error,
   tolerance, times and bound: K2 corr_enc, K1 corr_fused (bf16, raw, v10
   and v12 layouts), K5 corr_single (level-1 ring, fp32 out, raw and
   reference order), K3/K4 the segment sums;
3. agreement: the fp32 engine with the kernels on the card against the
   same engine with the plain versions on the CPU, on 16 small frames
   (same seeded weights, scripted centroids, fixed depth), in the
   never-merge and always-merge regimes, at DPVO_CORR_VERSION 13 (K2), 12
   and 9 (K1 in the v12 and raw layouts);
4. engine: the main path at full width — 480x640, M=96, the default
   config with MIXED_PRECISION (bf16), ASYNC_KEYFRAME=False, seeded random
   weights, motion_probe forced — in the merge regime (KEYFRAME_THRESH=1e9)
   for 40 frames, then the retain regime (KEYFRAME_THRESH=0), then the
   retain regime at DPVO_CORR_VERSION 12 (the raw-feature path), with
   per-frame times, live edges, each kernel's launch count (every kernel
   of the drive's path > 0, the other correlation kernel 0) and finite
   poses;
5. the kernels line (one JSON object; ``launches`` from the merge drive,
   for corr_fused from the version-12 drive, for corr_single, which no
   engine path runs, from phase 2), the card line, then the last line
   ``{"ok": true, "device": {...}}``.

Needs one CUDA card; exits non-zero without one.  Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}   # dense tensor bf16 / fp32 FMA

TOL_K2 = 1e-2     # max|kernel - plain| / max|plain|: one bf16 step
TOL_F32 = 1e-4    # max|kernel - plain| of fp32 correlation: summation order
TOL_SEG = (2e-5, 1e-5)                       # rtol, atol for fp32 sums

KERNELS = {
    "corr_enc": dict(source="dpvo_tpu_torch/csrc/corr_enc.cu",
                     replaces="dpvo_tpu/ops/corr_pallas.py:898"),
    "corr_fused": dict(source="dpvo_tpu_torch/csrc/corr_raw.cu",
                       replaces="dpvo_tpu/ops/corr_pallas.py:719"),
    "corr_single": dict(source="dpvo_tpu_torch/csrc/corr_raw.cu",
                        replaces="dpvo_tpu/ops/corr_pallas.py:621"),
    "segment_softmax_sums": dict(
        source="dpvo_tpu_torch/csrc/segment_sums.cu",
        replaces="dpvo_tpu/ops/agg_pallas.py:89"),
    "segment_sums": dict(source="dpvo_tpu_torch/csrc/segment_sums.cu",
                         replaces="dpvo_tpu/ops/agg_pallas.py:161"),
}


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps, warm=2):
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


def bound(nbytes, nops, kind):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = nops / PEAK_OPS[kind]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# --- phase 2: kernels against their plain versions ---------------------------

def corr_inputs(E, n_frames, n_patches, dev, gen):
    """Main-path-shaped K2 inputs: bf16 rings of 36 frames at 120x160 /
    30x40 (480x640 / 4) and a gmap ring of 36*96 patches, of which the
    edges read ``n_frames`` target frames and ``n_patches`` patches;
    coords spread like reprojected 3x3 patches (some off the image
    edge)."""
    import torch
    from dpvo_tpu_torch.ops.corr_cuda import PAD, padded_hw, RAW_DIM
    F, K, h, w, C, DIMo = 36, 36 * 96, 120, 160, 128, 384
    dt = torch.bfloat16
    f1 = torch.zeros((F, *padded_hw(h, w), C), dtype=dt, device=dev)
    f2 = torch.zeros((F, *padded_hw(h // 4, w // 4), C), dtype=dt,
                     device=dev)
    f1[:, PAD:PAD + h, PAD:PAD + w] = (torch.randn(
        (F, h, w, C), generator=gen, device=dev) * 0.25).to(dt)
    f2[:, PAD:PAD + h // 4, PAD:PAD + w // 4] = (torch.randn(
        (F, h // 4, w // 4, C), generator=gen, device=dev) * 0.25).to(dt)
    g_all = (torch.randn((K, 9, C), generator=gen, device=dev)
             * 0.25).to(dt)
    w_raw = (torch.randn((2 * RAW_DIM, DIMo), generator=gen, device=dev)
             / 30.0).to(dt)
    ctr = torch.rand((E, 2), generator=gen, device=dev)
    ctr = ctr * torch.tensor([w + 8.0, h + 8.0], device=dev) - 4.0
    grid = torch.arange(3, device=dev, dtype=torch.float32) - 1
    coords = torch.empty((E, 2, 3, 3), device=dev)
    coords[:, 0] = ctr[:, 0, None, None] + grid[None, None, :]
    coords[:, 1] = ctr[:, 1, None, None] + grid[None, :, None]
    coords += 0.3 * torch.randn(coords.shape, generator=gen, device=dev)
    kk = torch.randint(0, n_patches, (E,), generator=gen, device=dev,
                       dtype=torch.int32)
    ff = torch.randint(0, n_frames, (E,), generator=gen, device=dev,
                       dtype=torch.int32)
    return g_all, kk, w_raw, f1, f2, coords, ff


def window_bytes(fmaps, coords, ff):
    """Bytes of the ring pixels that the 8x8 windows of these coordinates
    touch (level l at coords / 4**l), each counted once."""
    import torch
    from dpvo_tpu_torch.ops.corr_cuda import PAD, R, D, P2
    E = coords.shape[0]
    nbytes = 0
    for level, fm in enumerate(fmaps):
        Fn, Hp, Wp, C = fm.shape
        c = coords * 0.25 ** level
        bx = torch.nan_to_num(torch.floor(c[:, 0]).reshape(E, P2)
                              + (PAD - R), nan=0.0).clamp(0, Wp - D).long()
        by = torch.nan_to_num(torch.floor(c[:, 1]).reshape(E, P2)
                              + (PAD - R), nan=0.0).clamp(0, Hp - D).long()
        mask = torch.zeros(Fn * Hp * Wp, dtype=torch.bool, device=fm.device)
        off = torch.arange(D, device=fm.device)
        for dy in range(D):
            lin = ((ff.long()[:, None, None] * Hp + by[..., None] + dy) * Wp
                   + bx[..., None] + off)
            mask[lin.reshape(-1)] = True
        nbytes += int(mask.sum()) * C * fm.element_size()
    return nbytes


def corr_work(g_all, kk, w_raw, f1, f2, coords, ff):
    """Bytes this call must move (each touched input value once, each
    output once) and its multiply-adds x2, from this call's data."""
    import torch
    from dpvo_tpu_torch.ops.corr_cuda import D, P2
    E = coords.shape[0]
    es = f1.element_size()
    nbytes = window_bytes((f1, f2), coords, ff)
    nbytes += int(torch.unique(kk).numel()) * P2 * g_all.shape[-1] * es
    nbytes += w_raw.numel() * es + coords.numel() * 4 + 2 * E * 4
    nbytes += E * w_raw.shape[1] * es
    nops = E * (2 * P2 * D * D * g_all.shape[-1] * 2
                + w_raw.shape[0] * w_raw.shape[1] * 2)
    return nbytes, nops


def raw_work(g_pre, fmaps, coords, ff, out):
    """corr_work for K1/K5: touched window pixels, the g_pre rows, coords,
    ring slots and the output; E*L*9*64*128*2 operations."""
    from dpvo_tpu_torch.ops.corr_cuda import D, P2
    E = coords.shape[0]
    nbytes = (window_bytes(fmaps, coords, ff)
              + g_pre.numel() * g_pre.element_size() + coords.numel() * 4
              + E * 4 + out.numel() * out.element_size())
    return nbytes, E * len(fmaps) * P2 * D * D * g_pre.shape[-1] * 2


def segment_inputs(E, D, n_groups, dev, gen):
    import torch
    ids = torch.sort(torch.randint(0, n_groups, (E,), generator=gen,
                                   device=dev)).values
    new = torch.ones(E, dtype=torch.bool, device=dev)
    new[1:] = ids[1:] != ids[:-1]
    gid = (torch.cumsum(new.int(), 0) - 1).int()
    a = torch.randn((E, D), generator=gen, device=dev)
    b = torch.randn((E, D), generator=gen, device=dev)
    return a, b, gid


# (live edges, target frames they read, patches they touch) of the engine
# at 480x640, M=96: the merge regime with synchronous keyframing (8
# keyframes, every patch linked to every frame), the merge regime's edge
# count under the JAX engine's keyframe lag, and the retain regime
# (22-frame removal window, 13-frame patch lifetime)
SHAPES = ((6144, 8, 8 * 96), (14336, 16, 16 * 96), (45312, 13, 23 * 96))
E_MAIN = SHAPES[0][0]       # the shape of the merge drive's updates


def phase_kernels(dev):
    """Each kernel against its plain version at the SHAPES above."""
    import torch
    from dpvo_tpu_torch.ops import agg_cuda, corr_cuda
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    k_cap, D_agg, D_ba = 4096, 384, 6 * 16 + 2
    results = {}
    for E, n_frames, n_patches in SHAPES:
        # K2: fused correlation + corr-encoder product (bf16)
        args = corr_inputs(E, n_frames, n_patches, dev, gen)
        got = corr_cuda.corr_enc(*args)
        want = corr_cuda.corr_enc_plain(*args)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        ok = bool(torch.isfinite(got).all()) and err <= TOL_K2 * scale
        ms = time_ms(lambda: corr_cuda.corr_enc(*args), reps=10)
        plain_ms = time_ms(lambda: corr_cuda.corr_enc_plain(*args), reps=3,
                           warm=1)
        nbytes, nops = corr_work(*args)
        b_ms, b_by = bound(nbytes, nops, "bf16")
        log(f"[kernels] corr_enc E={E}: max_abs_err={err:.3e} "
            f"max|plain|={scale:.3e} tol={TOL_K2}*max|plain| "
            f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} "
            f"({b_by}, {nbytes / 1e6:.1f} MB, {nops / 1e9:.2f} GFLOP) "
            f"{'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"corr_enc disagrees with its plain version "
                             f"at E={E}")
        results.setdefault("corr_enc", {})[E] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=None)

        # K1: two-level correlation (bf16) in the raw, v10 and v12 layouts
        # (v10 is the layout of the dev variant D1), and
        # K5: the level-1 correlation (fp32 out), raw and reference order,
        # on the same edges' gathered patch rows
        g_all, kk, _, f1, f2, coords, ff = args
        g_pre = g_all[kk.long()]
        del args, got, want
        for name, layout in (("corr_fused", "raw"), ("corr_fused", "v10"),
                             ("corr_fused", "v12"), ("corr_single", "raw"),
                             ("corr_single", "ref")):
            if name == "corr_fused":
                fmaps = (f1, f2)
                kargs = (g_pre, f1, f2, coords, ff, layout, torch.bfloat16)
                kernel, plain = corr_cuda.corr_fused, corr_cuda.corr_fused_plain
            else:
                fmaps = (f1,)
                kargs = (g_pre, f1, coords, ff, layout == "raw")
                kernel = corr_cuda.corr_single
                plain = corr_cuda.corr_single_plain
            got = kernel(*kargs)
            want = plain(*kargs)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            tol = TOL_K2 * scale if name == "corr_fused" else TOL_F32
            ok = bool(torch.isfinite(got).all()) and err <= tol
            ms = time_ms(lambda: kernel(*kargs), reps=10)
            plain_ms = time_ms(lambda: plain(*kargs), reps=3, warm=1)
            nbytes, nops = raw_work(g_pre, fmaps, coords, ff, got)
            b_ms, b_by = bound(nbytes, nops, "bf16")
            log(f"[kernels] {name} {layout} E={E}: max_abs_err={err:.3e} "
                f"max|plain|={scale:.3e} tol={tol:.3e} ms={ms:.4f} "
                f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} "
                f"({b_by}, {nbytes / 1e6:.1f} MB, {nops / 1e9:.2f} GFLOP) "
                f"library_ms=none (no single call) {'OK' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"{name} ({layout}) disagrees with its plain "
                                 f"version at E={E}")
            results.setdefault(name, {})[E, layout] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)
            del got, want
        del g_all, kk, f1, f2, coords, ff, g_pre

        # K3: SoftAgg softmax sums (f32) over the agg_kk patch groups
        g_cap = k_cap + 8
        gate, val, gid = segment_inputs(E, D_agg, n_patches, dev, gen)
        shift = gate.max(dim=0, keepdim=True).values
        got = agg_cuda.segment_softmax_sums(gate, val, shift, gid, g_cap)
        want = agg_cuda.segment_softmax_sums_plain(gate, val, shift, gid,
                                                   g_cap)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ok = bool(torch.allclose(got, want, rtol=TOL_SEG[0],
                                 atol=TOL_SEG[1]))
        ms = time_ms(lambda: agg_cuda.segment_softmax_sums(
            gate, val, shift, gid, g_cap), reps=20)
        plain_ms = time_ms(lambda: agg_cuda.segment_softmax_sums_plain(
            gate, val, shift, gid, g_cap), reps=10)
        G = agg_cuda.padded_groups(g_cap)
        nbytes = 2 * E * D_agg * 4 + D_agg * 4 + E * 4 + G * 2 * D_agg * 4
        b_ms, b_by = bound(nbytes, 5 * E * D_agg, "f32")
        log(f"[kernels] segment_softmax_sums E={E}: max_abs_err={err:.3e} "
            f"tol=rtol {TOL_SEG[0]} atol {TOL_SEG[1]} ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
            f"{'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("segment_softmax_sums disagrees with its plain "
                             f"version at E={E}")
        results.setdefault("segment_softmax_sums", {})[E] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=None)

        # K4: BA coupling sums (f32), [A | C | u] with n_cap=16
        vals, _, gid = segment_inputs(E, D_ba, n_patches, dev, gen)
        got = agg_cuda.segment_sums(vals, gid, k_cap + 1)
        want = agg_cuda.segment_sums_plain(vals, gid, k_cap + 1)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ok = bool(torch.allclose(got, want, rtol=TOL_SEG[0],
                                 atol=TOL_SEG[1]))
        ms = time_ms(lambda: agg_cuda.segment_sums(vals, gid, k_cap + 1),
                     reps=20)
        plain_ms = time_ms(lambda: agg_cuda.segment_sums_plain(
            vals, gid, k_cap + 1), reps=10)
        G = agg_cuda.padded_groups(k_cap + 1)
        gid_l = gid.long()
        lib_ms = time_ms(lambda: torch.zeros(
            (G, D_ba), device=dev).index_add_(0, gid_l, vals), reps=20)
        nbytes = E * D_ba * 4 + E * 4 + G * D_ba * 4
        b_ms, b_by = bound(nbytes, E * D_ba, "f32")
        log(f"[kernels] segment_sums E={E}: max_abs_err={err:.3e} "
            f"tol=rtol {TOL_SEG[0]} atol {TOL_SEG[1]} ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms(index_add_)={lib_ms:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by}) {'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"segment_sums disagrees with its plain version "
                             f"at E={E}")
        results.setdefault("segment_sums", {})[E] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib_ms)
    return results


# --- phase 3: the engine on the card against the engine on the CPU ---------

SMALL = dict(BUFFER_SIZE=64, PATCHES_PER_FRAME=8, PATCH_LIFETIME=5,
             REMOVAL_WINDOW=7, OPTIMIZATION_WINDOW=5, KEYFRAME_INDEX=4,
             MIXED_PRECISION=False, ASYNC_KEYFRAME=False, EDGE_CAPACITY=512,
             BA_WINDOW_CAP=8)
SMALL_HW = (96, 128)
SMALL_INTR = np.array([64.0, 64.0, 64.0, 48.0], np.float32)
# (KEYFRAME_THRESH, translation atol, 1 - quaternion |dot| bound): the
# envelopes the CPU tests hold the port's engine to against the JAX engine
AGREE = {"never_merge": (0.0, 5e-3, 1e-4), "always_merge": (1e9, 5e-2, 1e-3)}


@contextlib.contextmanager
def corr_version(version):
    """Run the engine at ``DPVO_CORR_VERSION`` ``version`` (the port reads
    ``corr_cuda.FUSED_VERSION`` at call time)."""
    from dpvo_tpu_torch.ops import corr_cuda
    old, corr_cuda.FUSED_VERSION = corr_cuda.FUSED_VERSION, version
    try:
        yield
    finally:
        corr_cuda.FUSED_VERSION = old


def small_frames(n=16):
    ht, wd = SMALL_HW
    base = np.random.default_rng(11).integers(0, 255, (ht, 2 * wd, 3),
                                              dtype=np.uint8)
    return [np.ascontiguousarray(np.roll(base, -3 * t, axis=1)[:, :wd])
            for t in range(n)]


def small_network(seed=0):
    """Seeded random weights with the flow-delta head scaled by 0.02, so a
    random network stays in the smooth regime where two summation orders
    give nearby trajectories."""
    import torch
    from dpvo_tpu_torch.models.update import Update
    from dpvo_tpu_torch.models.vonet import Patchifier
    torch.manual_seed(seed)
    p, u = Patchifier(3), Update(3)
    with torch.no_grad():
        u.d.weight.mul_(0.02)
        u.d.bias.mul_(0.02)
    return p.state_dict(), u.state_dict()


def small_drive(dev, thresh, network):
    import torch
    from dpvo_tpu_torch.config import VOConfig
    from dpvo_tpu_torch.engine import DPVO
    M = SMALL["PATCHES_PER_FRAME"]
    fh, fw = SMALL_HW[0] // 4, SMALL_HW[1] // 4

    def centroids(t):
        k = np.arange(M)
        return np.stack([1 + (7 * k + 3 * t) % (fw - 2),
                         1 + (5 * k + 11 * t) % (fh - 2)], -1)

    slam = DPVO(VOConfig(**SMALL, KEYFRAME_THRESH=thresh), network=network,
                ht=SMALL_HW[0], wd=SMALL_HW[1], device=dev)
    slam.motion_probe = lambda: 100.0
    slam.test_centroids = centroids
    slam.test_fixed_depth = 0.7
    for t, img in enumerate(small_frames()):
        slam(t, img, SMALL_INTR)
    state = (slam.n, slam.hs.e_num, slam.hs.tstamps[:slam.n].tolist(),
             sorted(slam.hs.delta))
    poses, _ = slam.terminate()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return poses, state


def phase_agreement(dev):
    """The fp32 engine with the kernels on the card against the same
    engine with the plain versions on the CPU: same weights, scripted
    centroids, fixed depth, at each correlation version.  Structure must
    match exactly; poses within the envelopes of the CPU parity tests."""
    import torch
    network = small_network()
    for version, (regime, (thresh, atol_t, atol_q)) in (
            (v, r) for v in (13, 12, 9) for r in AGREE.items()):
        with corr_version(version):
            p_gpu, s_gpu = small_drive(dev, thresh, network)
            p_cpu, s_cpu = small_drive(torch.device("cpu"), thresh, network)
        err_t = float(np.abs(p_gpu[:, :3] - p_cpu[:, :3]).max())
        qd = np.abs((p_gpu[:, 3:] * p_cpu[:, 3:]).sum(-1)) / np.maximum(
            np.linalg.norm(p_gpu[:, 3:], axis=-1)
            * np.linalg.norm(p_cpu[:, 3:], axis=-1), 1e-12)
        err_q = float(1.0 - qd.min())
        ok = (s_gpu == s_cpu and np.isfinite(p_gpu).all()
              and err_t <= atol_t and err_q <= atol_q)
        log(f"[agree] {regime} v{version}: n={s_gpu[0]} edges={s_gpu[1]} "
            f"structure {'same' if s_gpu == s_cpu else 'DIFFERENT'}; "
            f"max|dt|={err_t:.3e} (tol {atol_t}) 1-min|q.q'|={err_q:.3e} "
            f"(tol {atol_q}) {'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"engine on the card disagrees with the CPU "
                             f"engine ({regime}, version {version})")


# --- phase 4: the main path at full width --------------------------------

def device_profile(prof, wall_ms, n_frames, top=8):
    """Device busy time (the union of the CUDA kernel intervals the
    profiler saw), idle share of the wall time, and the kernels with the
    most device time, per frame."""
    from torch.autograd import DeviceType
    kern = sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)
    if not kern:
        return "device time not measured (the profiler saw no CUDA kernel)"
    busy, end, by_name = 0.0, float("-inf"), {}
    for e in kern:
        s, t = e.time_range.start, e.time_range.end
        busy += max(0.0, t - max(s, end))
        end = max(end, t)
        by_name[e.name] = by_name.get(e.name, 0.0) + (t - s)
    busy_ms = busy / 1e3 / n_frames
    frame_ms = wall_ms / n_frames
    tops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return (f"{frame_ms:.2f} ms/frame wall, device busy {busy_ms:.2f} "
            f"ms/frame, idle {1 - busy_ms / frame_ms:.1%}, "
            f"{len(kern) / n_frames:.0f} kernels/frame; top: "
            + "; ".join(f"{n[:48]} {v / 1e3 / n_frames:.3f} ms"
                        for n, v in tops))


# the kernels each correlation version's engine path must launch, and the
# correlation kernel it must not
PATH_KERNELS = {13: ({"corr_enc", "segment_softmax_sums", "segment_sums"},
                     {"corr_fused"}),
                12: ({"corr_fused", "segment_softmax_sums", "segment_sums"},
                     {"corr_enc"})}


def drive_engine(dev, regime, n_frames=40, n_warm=20, n_profile=5,
                 ht=480, wd=640, **overrides):
    """The engine as bench.py drives the JAX one: default config (bf16),
    synchronous keyframing, seeded random weights, motion_probe forced,
    a 480x640 frame rolling 4 px per frame, at the current
    DPVO_CORR_VERSION (``corr_version``).  Launch counts are zeroed just
    before the drive and read just after terminate(); every kernel of the
    version's path must have launched, and the other correlation kernel
    not.  Frames n_warm .. n_frames - n_profile - 1 are timed one by one
    (synchronised each frame); the last ``n_profile`` frames run under
    torch.profiler for the device busy time."""
    import torch
    from dpvo_tpu_torch.config import VOConfig
    from dpvo_tpu_torch.engine import DPVO
    from dpvo_tpu_torch.ops import _cuda, corr_cuda
    version = corr_cuda.FUSED_VERSION
    name = regime if version == 13 else f"{regime} v{version}"
    cfg = VOConfig(**{
        "BUFFER_SIZE": 256 if regime == "merge" else 1024,
        "MIXED_PRECISION": True, "LOOP_CLOSURE": False,
        "EDGE_CAPACITY": 57344, "ASYNC_KEYFRAME": False,
        "KEYFRAME_THRESH": 1e9 if regime == "merge" else 0.0, **overrides})
    slam = DPVO(cfg, network=None, ht=ht, wd=wd, device=dev, seed=0)
    slam.motion_probe = lambda: 100.0
    base = np.random.default_rng(0).integers(0, 255, (ht, 2 * wd, 3),
                                             dtype=np.uint8)
    intr = np.array([wd / 2, wd / 2, wd / 2, ht / 2])

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def frame(t):
        return np.ascontiguousarray(np.roll(base, -4 * t, axis=1)[:, :wd])

    sync()
    _cuda.reset_launches()
    ms, edges = [], []
    n_timed = n_frames - n_profile
    for t in range(n_timed):
        img = frame(t)
        t0 = time.perf_counter()
        slam(t, img, intr)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        edges.append(slam.hs.e_num)
    profile = "not profiled"
    if n_profile:
        imgs = [frame(t) for t in range(n_timed, n_frames)]
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for t, img in zip(range(n_timed, n_frames), imgs):
                slam(t, img, intr)
            sync()
            wall_ms = (time.perf_counter() - t0) * 1e3
        edges.append(slam.hs.e_num)
        profile = device_profile(prof, wall_ms, n_profile)
    poses, tstamps = slam.terminate()
    sync()
    launches = dict(_cuda.launches)
    steady = sorted(ms[n_warm:])
    out = dict(regime=name, frames=n_frames, keyframes=slam.n,
               median_ms=steady[len(steady) // 2], max_ms=steady[-1],
               edges_last=edges[-1], edges_max=max(edges),
               launches=launches, poses=poses)
    log(f"[engine] {name} {ht}x{wd} M={cfg.PATCHES_PER_FRAME}: "
        f"{n_frames} frames, median {out['median_ms']:.2f} ms/frame "
        f"(frames {n_warm}..{n_timed - 1}, max {out['max_ms']:.2f}), "
        f"live edges {edges[-1]} (max {max(edges)}), keyframes {slam.n}, "
        f"launches {launches}")
    log(f"[profile] {name} frames {n_timed}..{n_frames - 1}: {profile}")
    expect, absent = PATH_KERNELS[version]
    ok = (poses.shape == (n_frames, 7) and np.isfinite(poses).all()
          and len(tstamps) == n_frames
          and all(launches.get(k, 0) > 0 for k in expect)
          and not any(launches.get(k, 0) for k in absent))
    if not ok:
        raise SystemExit(f"engine drive ({name}) failed: poses "
                         f"{poses.shape} finite={np.isfinite(poses).all()}, "
                         f"launches {launches}")
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from dpvo_tpu_torch.ops import _cuda

    dev = torch.device("cuda:0")
    card = card_line()
    log(f"[machine] {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _cuda.lib()
    log(f"[machine] kernel build+load {time.perf_counter() - t0:.2f}s "
        f"(nvcc {_cuda.build_seconds})")

    _cuda.reset_launches()
    kern = phase_kernels(dev)
    single_launches = _cuda.launches["corr_single"]
    log(f"[kernels] corr_single is on no engine path (its callers are "
        f"corr_grouped and the tests): its launches below are phase 2's "
        f"({single_launches})")
    phase_agreement(dev)
    merge = drive_engine(dev, "merge")
    drive_engine(dev, "retain")
    with corr_version(12):
        raw = drive_engine(dev, "retain")

    launches = {**merge["launches"],
                "corr_fused": raw["launches"]["corr_fused"],
                "corr_single": single_launches}
    # the kernels line holds K1 in the version-12 drive's layout and K5 in
    # corr_grouped's reference order
    picks = {"corr_fused": (E_MAIN, "v12"), "corr_single": (E_MAIN, "ref")}
    line = {"kernels": []}
    for name, meta in KERNELS.items():
        r = kern[name][picks.get(name, E_MAIN)]
        line["kernels"].append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"], launches=launches[name],
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
