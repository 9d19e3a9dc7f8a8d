#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dpvo_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero, nothing is caught and passed over):

1. machine: the card's name and power limit, the kernel build time, and
   the tensor-core (HMMA) instructions of each correlation kernel from
   ``cuobjdump -sass`` where the toolkit has it;
2. kernels: every CUDA kernel against its plain PyTorch version on the
   card, at main-path shapes (480x640 frames, M=96, 36-frame rings,
   k_cap=4096) for the synchronous merge (6144 live edges), the lagged
   merge (14336) and the retain (45312) edge counts, with max error,
   tolerance, times and bound (every kernel's and library call's time is
   device time from a CUDA graph of 10-20 calls, the plain versions' back
   to back): K2 corr_enc, K1 corr_fused (bf16, raw, v10
   and v12 layouts), K5 corr_single (level-1 ring, fp32 out, raw and
   reference order), K3/K4 the segment sums (the back-to-back time of the
   wrapper beside; K4 also exactly equal to the
   row-order reference ``segment_sums_ordered``, and on three edge cases:
   runs across every slice boundary, one group of all rows, no rows;
   ``index_add_`` beside it), and at each shape the five D3 probes
   (corr_probe, fp32 out of bf16 rings) beside K1 raw with each probe's
   box fit share and box bytes per edge; at each shape the share of (edge,
   level) tasks whose 9 windows fit one box (``corr_cuda.window_boxes``)
   and, beside K2, K1 raw followed by the cuBLAS (E, 882) x (882, 384)
   product (``unfused_ms``, a yardstick the port never calls); then K2 and
   K1 (raw, v12) at 6144 edges with every other patch spread 6x beyond one
   box, so the per-window path runs; then the D3 path itself,
   ``scripts/dev/corr_variants_torch.py``'s probe entry point at 6144
   edges (scattered pixels: the per-window path), each probe's time
   beside K1 raw with its fit share, and each probe against its plain
   version on those inputs;
3. agreement: the fp32 engine with the kernels on the card against the
   same engine with the plain versions on the CPU, on 16 small frames
   (same seeded weights, scripted centroids, fixed depth), in the
   never-merge and always-merge regimes, at DPVO_CORR_VERSION 13 (K2), 12
   and 9 (K1 in the v12 and raw layouts), synchronous keyframing; and the
   always-merge drive with lagged keyframing (ASYNC_KEYFRAME_LAG=3,
   BATCH=2); then the bf16 engine (MIXED_PRECISION) on the card with the
   kernels against the same with corr_enc / corr_fused swapped for their
   plain versions, both regimes, versions 13 and 12;
4. engine, synchronous keyframing: the main path at full width — 480x640,
   M=96, the default config with MIXED_PRECISION (bf16) but
   ASYNC_KEYFRAME=False, seeded random weights, motion_probe forced — in
   the merge regime (KEYFRAME_THRESH=1e9) for 40 frames, then the retain
   regime (KEYFRAME_THRESH=0), then the retain regime at
   DPVO_CORR_VERSION 12 (the raw-feature path), with per-frame times, live
   edges, each kernel's launch count (every kernel of the drive's path >
   0, the other correlation kernel 0), the box fit share at one eager
   update on the drive's end state (after ``terminate()``) and finite
   poses;
5. loop closure (``LOOP_CLOSURE=True``, ``configs/default.yaml``'s
   setting): the fp32 engine on the card against the CPU engine on 45
   small frames (``REMOVAL_WINDOW=6``, ``GLOBAL_OPT_FREQ=10``, so global BA
   runs at initialisation, proposals land and ``ba_global`` runs), structure
   exact (with the inactive store and the keyframe counts that ran global
   BA) and poses within the never-merge envelope; then one drive at
   480x640, M=96, bf16, ``configs/default.yaml``'s values with the 1000-frame
   patch rings (``MAX_EDGE_AGE``) in the retain regime, each override
   printed, which must propose loop edges, run ``ba_global``, launch K2, K3
   and K4 and end with finite poses (ms/frame, global BA ms per call and
   calls by solver, peak live and inactive edges, peak device memory, 3
   profiled frames with global BA, K2 at one eager update on the drive's
   end state, on the 96000-row gmap ring, K3 and K4 at the drive's eager
   calls with the most groups, K3 past 4104 live groups, the updates a
   cover served, at a raised patch capacity among them); then one
   ``ba_global`` call at that drive's largest shapes under
   ``torch.cuda.set_sync_debug_mode("error")``;
6. train (``train_torch.py``'s step, which runs no hand-written kernel:
   the phase fails if any launches): card against CPU in fp32 with TF32
   off (N=5, 64x96, M=4, 3 iterations, the same flax-like seeded weights
   and batches): a structure-only step, a full step and an eval step, with
   loss, metrics, gnorm and each parameter's update, and the same on the
   card with TF32 on as the control, which must break a limit; then
   ``configs/tartan_train.yaml``'s step at full width (480x640, N=15, M=80,
   18 iterations, 18000 rollout edges, batch 1, bf16 autocast) on a
   synthetic clip whose GT poses and disparities induce its images' flow:
   one structure-only step and three full steps (ms, loss, gnorm,
   parameter change, peak memory each), one full step under
   ``torch.profiler`` (device busy and idle share, kernels per step, the
   kernels with the most device time), one eval rollout and ``validate``
   on it;
7. eval (``evaluate_tartan_torch.py``'s engine loop and scoring): the
   loop at the small size in fp32 on the card against the CPU (the
   never-merge envelope); then ``configs/default.yaml`` at 480x640
   (LOOP_CLOSURE, bf16, lagged keyframing) with EDGE_CAPACITY_INAC=2^18,
   weights from a ``.pth`` in the reference's layout synthesized from a
   seeded generator (every tensor checked as loaded), 64 frames of a
   rolled texture held in memory with GT poses in TartanAir's NED layout:
   ms/frame, global BA calls, the harness's ATE and AUC, peak memory and
   the launch counts (K2, K3 and K4 must launch; the motion probe is
   forced after 4 natural refusals, and the line says so);
8. classic (the classic loop-closure backend's device work): PGO on a
   drifted 2000-pose loop with one Sim3 loop factor, card against CPU
   (corrected translations after first-pose alignment within 3 times the
   CPU's own spread when the poses move by 1e-6), ms per call; the spawned
   PGO worker's start-up on the card; the structure-only BA of
   ``estimate_3d_keypoints`` (``long_term.triangulate``) at 1024 keypoints
   x 2 edges from synthetic points projected into three poses, card
   against CPU (points within 1e-4), K4 launched and held against its
   plain version; ``lc_callback``'s merge of a Sim3 correction into a card
   engine against a CPU engine (1e-5); and with ``cv2`` present the CPU
   tests' classic drive on the card, which must close a loop (with it
   absent, ``DPVO(..., CLASSIC_LOOP_CLOSURE=True)`` raising an
   ImportError naming ``cv2``);
9. bench: ``bench_torch.run_regime``'s merge and retain regimes at the
   default configuration (lagged keyframing), ``DPVO.precompile`` as
   ``bench.py`` calls it (before the first frame and after the warm
   ones), 30 warm frames and two 40-frame windows each, then 5 profiled
   frames: ms/frame per window, live edges, the device idle share, launch
   counts, the box fit share at one eager update on the drive's end state;
   the merge drive's TUM trajectory and PLY map are written to
   a temporary directory and read back;
9b. graphs (the tracking, update and merge programs replayed as CUDA
   graphs, which every card engine of the other phases does too, one
   graph per static key): (a) one update replay against the eager
   program on the same state at the lagged merge drive's bucket 14336
   and the retain drive's 49152 (TOL_GRAPH, and whether bitwise; each
   timed with a synchronise), and on the merge drive's state one
   tracking replay and one merge replay against their eager programs
   from the same state and generator state (bitwise); (b) warm lagged
   merge frames under ``torch.cuda.set_sync_debug_mode("error")`` until
   one applies a merge, the overdue batch's event wait bracketed on its
   own; (c) the bench merge drive with graphs against the same drive run
   eagerly (``DPVO(cuda_graphs=False)``): structure exact, poses within
   AGREE_BF16; (d) merge and retain with graphs after ``precompile``
   (phase 9's runs, whose phase timers are on) and eagerly (no
   ``precompile``; retain one window): ms/frame, the dispatch ms of
   track_frame, keyframe/apply, update/step and update/meta, device idle,
   buckets visited, capture ms per graph, the graph pool's bytes (largest
   bucket first, against the engines of (a) and (b), which capture at
   first reach), ``precompile``'s seconds, launches, no capture on the
   engine's thread inside the timed windows after ``precompile`` (the
   guard's worker's captures and the updates a cover served beside); and
   K2, K3 and K4 at
   the merge drive's padded bucket (its eager update calls: the warm-ups
   of captures at first reach, one update on its end state) against
   their plain versions;
9c. guard (the JAX engine's cold-bucket guard: an update whose key has no
   graph replays the smallest captured cover while the engine's worker
   thread captures the key): the lagged merge drive at 480x640, M=96,
   bf16, 40 frames after ``precompile(max_edges=1024)``, so that the
   ladder's top (57344) is the only cover of its 14336-24576 buckets: each
   frame call's wall ms to the end of its device work (worst, median),
   captures on the engine's thread after ``precompile`` (must be 0), the
   updates a cover served per key and each background capture's ms (each
   must land), every initialised frame under sync debug mode "error"
   (some served by a cover with a capture in flight); its poses against
   the same drive with every bucket precompiled (AGREE_BF16, structure
   exact); phase 5's loop-closure drive, nothing precompiled (its keys
   captured at first reach on the engine's thread, those at a raised
   patch capacity served by a cover where one exists): median and worst
   frames, with and without global BA; with ``--parent DIR`` both drives
   on that checkout (the parent tree), this script run there in a fresh
   process (``--guard-drive DIR``), for their worst frames; and a failure
   injected into a background capture, which must raise on the engine
   thread;
10. redwood (Redwood fine-tuning, ``configs/redwood_train.yaml``): a
   synthetic 72-frame 480x640 Redwood tree (JPEG images, uint16 mm depth
   PNGs, a column-major PoseGraph JSON, ``intrinsic.npy``) through the
   port's reader; one structure-only and two full steps at the config's
   size (N=15, M=80, 18 iterations, bf16) from a ``save_network`` ``.npz``
   (the config's ``ckpt`` overridden), with ms, peak memory and the cosine
   schedule's learning rate; ``train_torch.train`` end to end for one
   step; a small fp32 step card against CPU on three samples (TOL_TRAIN;
   beside it the card against itself, and the card with TF32 on as the
   control, which must break the limit); no hand-written kernel may
   launch;
11. viz (the viewer): with matplotlib, ``configs/default.yaml`` at
   480x640 driven 40 frames with ``viz=True`` (``latest.png`` a PNG,
   ``map.html`` parsing and embedding the finite points ``terminate()``
   leaves, the snapshots' host ms, ms/frame and hand-written launches
   against the same drive with ``viz=False``, which must launch the
   same); without it, ``DPVO(viz=True)`` raising an ImportError naming
   matplotlib; both: ``export_html`` directly and
   ``backproject_and_filter`` (8 keyframes, 480x640 images, 60x80
   disparities) card against CPU;
12. sharded (multi-device on ``torch.distributed``): the edge-sharded
   update at docs/MULTICHIP.md's retain scale (32768 edge rows, 32000
   live, 22-frame window, M=96, k_cap=4096, 480x640 maps, fp32, so K2 in
   fp32) against the single-device ``update_step`` with K2's plain
   version (which must not launch K2) on one NCCL rank and on two gloo
   ranks sharing the card (tests/test_infer_sharded.py's tolerances, at
   most 0.1% of patches' depths past theirs), K2's launches per rank and
   ms per sharded update; the data-parallel train step, NCCL world 1 and
   two gloo ranks against one process;
13. tools (the measurement layer): ``bench_torch.run_regime``'s merge
   regime for two windows with the engine's phase timers on, once timing
   host dispatch and once fencing each phase with a device synchronise
   (all nine phases present; the phases no other phase holds,
   ``track_frame``, ``append_factors``, ``update/*`` and ``keyframe``,
   summing to no more than the windows' wall time); ``DPVO.motionmag`` on
   the card against the CPU for every frame pair with edges after the
   small never-merge drive, on the CPU engine's state (rtol 1e-4, atol
   1e-5; the drives' own states compared beside it); then each dev bench
   (``scripts/dev/*_torch.py``, ``benchmarks/*_torch.py``) at its quick
   setting through its ``main``, which must return 0 and print only finite
   numbers, with K2, K3 and K4 launched in the kernel arms of
   ``bench_profile_torch`` and ``bench_ablate_torch`` and K2 not in their
   plain-correlation arms;
14. the kernels line (one JSON object; ``launches`` from the bench merge
   drive, for corr_fused from the version-12 drive, for corr_single,
   which no engine path runs, from phase 2, for the probes from the D3
   path), the card line, then the last line
   ``{"ok": true, "device": {...}}``.

``--only PHASE[,PHASE]`` (kernels, agree, agree_bf16, engine, lc, train,
eval, classic, bench, graphs, guard, redwood, viz, sharded, tools)
runs those phases alone and prints no kernels line and no ``ok`` line.
``--parent DIR``: the guard phase also times its drives on the checkout
``DIR`` (``--guard-drive DIR`` runs them alone, with ``DIR``'s engine,
and prints their frame times as one line ``GUARD {...}``).  Engine
drives wait on the current stream between frames (``stream_sync``),
never with a device-wide synchronise.

Needs one CUDA card; exits non-zero without one.  Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}   # dense tensor bf16 / fp32 FMA

KERNEL_WINDOWS = 5   # timed runs per kernel and library call (median)

TOL_K2 = 1e-2     # max|kernel - plain| / max|plain|: one bf16 step
TOL_F32 = 1e-4    # max|kernel - plain| of fp32 correlation: summation order
TOL_SEG = (2e-5, 1e-5)                       # rtol, atol for fp32 sums
TOL_PROBE = 1e-5  # max|kernel - plain| / max|plain|: fp32 sums of exact
                  # bf16 products, summation order only
PROBES = ("p_load", "p_convert", "p_roll", "p_mult_subl", "p_full_dot")

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
    **{f"corr_probe.{p}": dict(source="dpvo_tpu_torch/csrc/corr_raw.cu",
                               replaces="scripts/dev/corr_variants.py:549")
       for p in PROBES},
}


def log(*a):
    print(*a, flush=True)


def stream_sync():
    """Wait for the work queued on the current stream, the engines' own.
    Engine drives wait so, not with a device-wide synchronise: CUDA refuses
    that while the cold-bucket guard's worker holds a capture open, and the
    capture fails with it."""
    import torch
    torch.cuda.current_stream().synchronize()


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def hmma_counts(lib_path):
    """Tensor-core (HMMA) instructions of each correlation kernel in the
    built library, from ``cuobjdump -sass``: {kernel: count}, or None
    where the toolkit has no cuobjdump."""
    tools = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin"
    exe = shutil.which("cuobjdump") or str(tools / "cuobjdump")
    if not os.path.exists(exe):
        return None
    sass = subprocess.run([exe, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, fn = {}, None
    for text in sass.splitlines():
        m = re.search(r"Function : (\S+)", text)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn and "HMMA" in text:
            counts[fn] += 1
    counts = {k: v for k, v in counts.items() if "corr" in k}
    filt = shutil.which("cu++filt") or str(tools / "cu++filt")
    if os.path.exists(filt):
        names = subprocess.run([filt], input="\n".join(counts),
                               capture_output=True, text=True, check=True,
                               timeout=60).stdout.splitlines()
        if len(names) == len(counts):
            counts = dict(zip(names, counts.values()))
    return counts


def time_ms(fn, reps, warm=2, windows=1):
    """ms per call back to back (CUDA events around ``reps`` calls): the
    median over ``windows`` runs, so one disturbed run does not set the
    number.  For the plain versions, which synchronise with the host and
    cannot be captured in a graph."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(windows):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        runs.append(t0.elapsed_time(t1) / reps)
    return sorted(runs)[len(runs) // 2]


def graph_ms(fn, reps=10, windows=KERNEL_WINDOWS):
    """Device ms per call with the host's launch time out of the way:
    ``reps`` calls captured in one CUDA graph, replayed ``windows`` times
    (median).  Every kernel's ``ms`` and every library call's time: for
    kernels shorter than the Python wrapper's own time (K3, K4) back-to-back
    calls would time the wrapper instead, and for the long ones the two
    agree within the launch gaps."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    runs = []
    for _ in range(windows):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        graph.replay()
        t1.record()
        torch.cuda.synchronize()
        runs.append(t0.elapsed_time(t1) / reps)
    return sorted(runs)[len(runs) // 2]


def bound(nbytes, nops, kind):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = nops / PEAK_OPS[kind]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# --- phase 2: kernels against their plain versions ---------------------------

def corr_inputs(E, n_frames, n_patches, dev, gen, spread=False):
    """Main-path-shaped K2 inputs: bf16 rings of 36 frames at 120x160 /
    30x40 (480x640 / 4) and a gmap ring of 36*96 patches, of which the
    edges read ``n_frames`` target frames and ``n_patches`` patches;
    coords spread like reprojected 3x3 patches (some off the image edge),
    or with ``spread`` every other edge's 3x3 grid scaled by 6 (its
    level-1 windows do not fit one box)."""
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
    scale = torch.ones((E, 1, 1), device=dev)
    if spread:
        scale[1::2] = 6.0
    coords[:, 0] = ctr[:, 0, None, None] + grid[None, None, :] * scale
    coords[:, 1] = ctr[:, 1, None, None] + grid[None, :, None] * scale
    coords += 0.3 * torch.randn(coords.shape, generator=gen, device=dev)
    kk = torch.randint(0, n_patches, (E,), generator=gen, device=dev,
                       dtype=torch.int32)
    ff = torch.randint(0, n_frames, (E,), generator=gen, device=dev,
                       dtype=torch.int32)
    return g_all, kk, w_raw, f1, f2, coords, ff


def window_bytes(fmaps, coords, ff, width=8, aligned=False):
    """Bytes of the ring pixels that the windows of these coordinates touch
    (level l at coords / 4**l), each counted once: 8 rows of ``width``
    pixels from the window origin bx, or with ``aligned`` from the 8-aligned
    origin min(8 * (bx // 8), Wp - 16) of the TPU's loads."""
    import torch
    from dpvo_tpu_torch.ops.corr_cuda import PAD, R, D, DW, P2
    E = coords.shape[0]
    nbytes = 0
    for level, fm in enumerate(fmaps):
        Fn, Hp, Wp, C = fm.shape
        c = coords * 0.25 ** level
        bx = torch.nan_to_num(torch.floor(c[:, 0]).reshape(E, P2)
                              + (PAD - R), nan=0.0).clamp(0, Wp - D).long()
        by = torch.nan_to_num(torch.floor(c[:, 1]).reshape(E, P2)
                              + (PAD - R), nan=0.0).clamp(0, Hp - D).long()
        if aligned:
            bx = torch.clamp(torch.div(bx, 8, rounding_mode="floor") * 8,
                             max=Wp - DW)
        mask = torch.zeros(Fn * Hp * Wp, dtype=torch.bool, device=fm.device)
        off = torch.arange(width, device=fm.device)
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


# the pixels per window row each probe reads, from the aligned origin or
# from bx, and its operations per window row and channel (adds for
# p_convert, multiply-adds x2 for the products)
PROBE_READS = {"p_load": (1, True, 0), "p_convert": (16, True, 16),
               "p_roll": (1, False, 0), "p_mult_subl": (8, False, 16),
               "p_full_dot": (8, False, 16)}
# the probes that run their operations on the CUDA cores in fp32; their
# bound still counts the bf16 tensor-core peak, which computes bf16
# products summed in fp32 exactly, and the fp32 CUDA-core figure is
# printed beside it
PROBE_CUDA_CORE = ("p_convert", "p_mult_subl")


def probe_work(g_pre, fmaps, coords, ff, probe, out):
    """Bytes and operations of one D3 probe call: the window pixels it reads
    (``PROBE_READS``), the g_pre rows of the products, coords, ring slots
    and the (16, 2, 9, 8, 128) output, each once."""
    from dpvo_tpu_torch.ops.corr_cuda import D, P2
    width, aligned, ops_row = PROBE_READS[probe]
    E, C = coords.shape[0], g_pre.shape[-1]
    nbytes = (window_bytes(fmaps, coords, ff, width, aligned)
              + coords.numel() * 4 + E * 4 + out.numel() * 4)
    if probe in ("p_mult_subl", "p_full_dot"):
        nbytes += g_pre.numel() * g_pre.element_size()
    return nbytes, E * len(fmaps) * P2 * D * ops_row * C


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


def summed_groups(gid, g_cap, live=None):
    """The live groups a segment-sum call adds up: the dense ranks below
    the table's rows of its first ``live`` rows (all rows without it; a
    padded bucket's masked rows sort last: past K3's table, in K4 a group
    each)."""
    from dpvo_tpu_torch.ops import agg_cuda
    rows = gid if live is None else gid[:int(live)]
    kept = rows[rows < agg_cuda.padded_groups(g_cap)]
    return int(kept.max()) + 1 if len(kept) else 0


def check_segment_sums(vals, gid, g_cap):
    """K4 against its plain version (TOL_SEG) and against the row-order
    reference ``segment_sums_ordered`` (exactly): (max error, max error
    against the reference, both hold)."""
    import torch
    from dpvo_tpu_torch.ops import agg_cuda
    got = agg_cuda.segment_sums(vals, gid, g_cap)
    want = agg_cuda.segment_sums_plain(vals, gid, g_cap)
    ordered = agg_cuda.segment_sums_ordered(vals, gid, g_cap)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    err_ord = (got - ordered).abs().max().item()
    ok = (bool(torch.allclose(got, want, rtol=TOL_SEG[0], atol=TOL_SEG[1]))
          and torch.equal(got, ordered))
    return err, err_ord, ok


def check_softmax_sums(gate, val, shift, gid, g_cap):
    """K3 against its plain version (TOL_SEG): (max error, holds)."""
    import torch
    from dpvo_tpu_torch.ops import agg_cuda
    got = agg_cuda.segment_softmax_sums(gate, val, shift, gid, g_cap)
    want = agg_cuda.segment_softmax_sums_plain(gate, val, shift, gid, g_cap)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    return err, bool(torch.allclose(got, want, rtol=TOL_SEG[0],
                                    atol=TOL_SEG[1]))


def segment_edge_cases(dev, E, D, g_cap):
    """K4 at E rows on its edge cases, each against both references: runs
    of 16 rows whose heads sit 11 and 27 rows into every 32-row slice (so
    every slice boundary lies inside a run), one group holding all E rows
    (values of mean 1: a 14336-row sum that cancels would differ between
    summation orders by more than TOL_SEG of the result), and no rows."""
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    rows = torch.arange(E, device=dev)
    head = (rows % 32 == 11) | (rows % 32 == 27) | (rows == 0)
    cases = {"runs across every slice boundary":
             ((torch.cumsum(head.int(), 0) - 1).int(), 0.0),
             "one group of all rows":
             (torch.zeros(E, dtype=torch.int32, device=dev), 1.0),
             "no rows": (torch.zeros(0, dtype=torch.int32, device=dev), 0.0)}
    for name, (gid, mean) in cases.items():
        vals = torch.randn((len(gid), D), generator=gen, device=dev) + mean
        err, err_ord, ok = check_segment_sums(vals, gid, g_cap)
        log(f"[kernels] segment_sums {name} (E={len(gid)}, "
            f"{int(gid.max()) + 1 if len(gid) else 0} groups): "
            f"max_abs_err={err:.3e}; against the row-order reference "
            f"{err_ord:.3e} (must be 0) {'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"segment_sums fails its edge case: {name}")


# (live edges, target frames they read, patches they touch) of the engine
# at 480x640, M=96: the merge regime with synchronous keyframing (8
# keyframes, every patch linked to every frame), the merge regime's edge
# count under the JAX engine's keyframe lag, and the retain regime
# (22-frame removal window, 13-frame patch lifetime)
SHAPES = ((6144, 8, 8 * 96), (14336, 16, 16 * 96), (45312, 13, 23 * 96))
E_MAIN = SHAPES[0][0]       # the shape of the merge drive's updates
PROBE_SHAPES = tuple(E for E, _, _ in SHAPES)


def phase_probes(results, E, g_pre, f1, f2, coords, ff):
    """Each D3 probe against its plain version at E edges, its time and
    bound beside K1 raw's (same inputs, measured just before)."""
    import torch
    from dpvo_tpu_torch.ops import corr_cuda
    k1 = results["corr_fused"][E, "raw"]
    line = [f"K1 raw {k1['ms']:.4f} ms (bound {k1['bound_ms']:.4f})"]
    for probe in PROBES:
        args = (g_pre, f1, f2, coords, ff, probe)
        got, err, scale, ok = probe_error(args)
        ms = graph_ms(lambda: corr_cuda.corr_probe(*args))
        plain_ms = time_ms(lambda: corr_cuda.corr_probe_plain(*args),
                           reps=3, warm=1)
        nbytes, nops = probe_work(g_pre, (f1, f2), coords, ff, probe, got)
        b_ms, b_by = bound(nbytes, nops, "bf16")
        core = (f" (fp32 CUDA cores: {bound(nbytes, nops, 'f32')[0]:.4f})"
                if probe in PROBE_CUDA_CORE else "")
        log(f"[kernels] corr_probe {probe} E={E}: max_abs_err={err:.3e} "
            f"max|plain|={scale:.3e} tol={TOL_PROBE}*max|plain| "
            f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} "
            f"({b_by}, {nbytes / 1e6:.1f} MB, {nops / 1e9:.2f} GOP){core} "
            f"library_ms=none (no single call); "
            f"{fit_share(coords, f1, f2, probe)} {'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"corr_probe ({probe}) disagrees with its "
                             f"plain version at E={E}")
        results.setdefault(f"corr_probe.{probe}", {})[E] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=None)
        line.append(f"{probe} {ms:.4f} (bound {b_ms:.4f})")
    log(f"[probe] E={E} ms: " + "; ".join(line))


def probe_error(args):
    """One probe call against its plain version: (output, max error,
    max|plain|, within TOL_PROBE)."""
    import torch
    from dpvo_tpu_torch.ops import corr_cuda
    got = corr_cuda.corr_probe(*args)
    want = corr_cuda.corr_probe_plain(*args)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    ok = (bool(torch.isfinite(got).all()) and scale > 0
          and err <= TOL_PROBE * scale)
    return got, err, scale, ok


def check_probes(key, g_pre, f1, f2, coords, ff):
    """Every probe against its plain version on these inputs; fails on a
    disagreement."""
    errs = []
    for probe in PROBES:
        _, err, scale, ok = probe_error((g_pre, f1, f2, coords, ff, probe))
        errs.append(f"{probe} {err:.3e} (max|plain| {scale:.3e})")
        if not ok:
            raise SystemExit(f"corr_probe ({probe}) disagrees with its "
                             f"plain version at {key}")
    log(f"[probe] {key}: max_abs_err " + ", ".join(errs)
        + f" within {TOL_PROBE}*max|plain| OK")


def probe_path(E=E_MAIN):
    """D3's own path: the probe entry point of
    scripts/dev/corr_variants_torch.py at E edges, its launch counts zeroed
    just before and read just after; then, on the same inputs, each probe
    against its plain version and each probe's fit share."""
    from dpvo_tpu_torch.ops import _cuda
    sys.path.insert(0, str(Path(__file__).resolve().parent / "scripts"
                           / "dev"))
    import corr_variants_torch
    _cuda.reset_launches()
    times = corr_variants_torch.probe(E)
    launches = {k: v for k, v in _cuda.launches.items()
                if k.startswith("corr_probe.")}
    log(f"[probe] corr_variants_torch.probe({E}): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items())
        + f"; launches {launches}")
    if sorted(launches) != sorted(f"corr_probe.{p}" for p in PROBES):
        raise SystemExit(f"the probe path did not launch every probe: "
                         f"{launches}")
    g, f1, f2, coords, ff = corr_variants_torch.make_inputs(E)
    check_probes(f"the probe path, E={E}", g, f1, f2, coords, ff)
    for probe in PROBES:
        log(f"[probe] the probe path, E={E}: {probe} {times[probe]:.4f} ms "
            f"beside K1 raw {times['k1_raw']:.4f}; "
            + fit_share(coords, f1, f2, probe))
    log(f"[probe] the probe path, E={E}: K1's plan "
        + fit_share(coords, f1, f2))
    return launches


def fit_share(coords, f1, f2, probe=None):
    """The share of (edge, level) tasks whose 9 windows fit one box, per
    level, the number of windows read from a box of their own, and the
    ring bytes per edge the plan reads (box rows of ncols pixels, 8 rows
    for a window on its own box): ``corr_cuda.window_boxes``, the bf16
    kernels' plan, or with ``probe`` that D3 probe's (``PROBE_PLAN``)."""
    from dpvo_tpu_torch.ops import corr_cuda
    c = coords.detach().cpu()
    fmaps = (f1, f2)
    aligned, own_cols = corr_cuda.PROBE_PLAN.get(probe, (False, None))
    b = corr_cuda.window_boxes(c, tuple(f.shape[1] for f in fmaps),
                               tuple(f.shape[2] for f in fmaps), aligned,
                               1 if probe is None else corr_cuda.PROBE_MIN_FIT)
    share = b["fits"].double().mean(0).tolist()
    own = ~b["window_fits"]
    pixels = (b["nrows"] * b["ncols"] * own.logical_not().any(-1)).sum()
    for level, f in enumerate(fmaps):
        if own_cols is None:        # K1 / K2: from min(bx, Wp - 16)
            bx = b["wx"][:, level]
            cols = bx - bx.clamp(max=f.shape[2] - corr_cuda.DW) + corr_cuda.D
        else:
            cols = own_cols
        pixels += (corr_cuda.D * cols * own[:, level]).sum()
    kb = float(pixels) * f1.shape[-1] * f1.element_size() / len(c) / 1e3
    return (f"fit one box: level 1 {share[0]:.4%}, level 2 {share[1]:.4%}; "
            f"windows on a box of their own {int(own.sum())} of "
            f"{own.numel()}; box rows read {kb:.1f} KB per edge")


def check_enc(results, key, args):
    """K2 against its plain version on ``args``: error, times, bound;
    stored under results["corr_enc"][key]."""
    import torch
    from dpvo_tpu_torch.ops import corr_cuda
    E = args[5].shape[0]
    got = corr_cuda.corr_enc(*args)
    want = corr_cuda.corr_enc_plain(*args)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    ok = bool(torch.isfinite(got).all()) and err <= TOL_K2 * scale
    ms = graph_ms(lambda: corr_cuda.corr_enc(*args))
    plain_ms = time_ms(lambda: corr_cuda.corr_enc_plain(*args), reps=3,
                       warm=1)
    nbytes, nops = corr_work(*args)
    b_ms, b_by = bound(nbytes, nops, "bf16")
    log(f"[kernels] corr_enc {key}: E={E} max_abs_err={err:.3e} "
        f"max|plain|={scale:.3e} tol={TOL_K2}*max|plain| "
        f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} "
        f"({b_by}, {nbytes / 1e6:.1f} MB, {nops / 1e9:.2f} GFLOP) "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"corr_enc disagrees with its plain version at "
                         f"{key}")
    results.setdefault("corr_enc", {})[key] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None)
    return ms


def unfused_line(key, args, enc_ms):
    """The yardstick beside K2: K1 raw on the same edges' gathered patch
    rows, then the cuBLAS product of its (E, 882) features with w_raw."""
    import torch
    from dpvo_tpu_torch.ops import corr_cuda
    g_all, kk, w_raw, f1, f2, coords, ff = args
    E = coords.shape[0]
    g_pre = g_all[kk.long()]
    ms = graph_ms(lambda: corr_cuda.corr_fused(
        g_pre, f1, f2, coords, ff, "raw", torch.bfloat16).reshape(E, -1)
        @ w_raw)
    log(f"[kernels] corr_enc {key}: unfused_ms={ms:.4f} (K1 raw + cuBLAS "
        f"({E}, 882) x (882, {w_raw.shape[1]}); yardstick only) against "
        f"K2 {enc_ms:.4f}")


def check_raw(results, key, name, layout, g_pre, f1, f2, coords, ff):
    """K1 (bf16 out) or K5 (fp32 out) in ``layout`` against its plain
    version; stored under results[name][key, layout]."""
    import torch
    from dpvo_tpu_torch.ops import corr_cuda
    E = coords.shape[0]
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
    ms = graph_ms(lambda: kernel(*kargs))
    plain_ms = time_ms(lambda: plain(*kargs), reps=3, warm=1)
    nbytes, nops = raw_work(g_pre, fmaps, coords, ff, got)
    b_ms, b_by = bound(nbytes, nops, "bf16")
    log(f"[kernels] {name} {layout} {key}: E={E} max_abs_err={err:.3e} "
        f"max|plain|={scale:.3e} tol={tol:.3e} ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} "
        f"({b_by}, {nbytes / 1e6:.1f} MB, {nops / 1e9:.2f} GFLOP) "
        f"library_ms=none (no single call) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{name} ({layout}) disagrees with its plain "
                         f"version at {key}")
    results.setdefault(name, {})[key, layout] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None)


def phase_kernels(dev):
    """Each kernel against its plain version at the SHAPES above, then K2
    and K1 on spread patches."""
    import torch
    from dpvo_tpu_torch.ops import agg_cuda
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    k_cap, D_agg, D_ba = 4096, 384, 6 * 16 + 2
    results = {}
    for E, n_frames, n_patches in SHAPES:
        # K2: fused correlation + corr-encoder product (bf16)
        args = corr_inputs(E, n_frames, n_patches, dev, gen)
        log(f"[kernels] E={E}: " + fit_share(args[5], args[3], args[4]))
        enc_ms = check_enc(results, E, args)
        unfused_line(E, args, enc_ms)

        # K1: two-level correlation (bf16) in the raw, v10 and v12 layouts
        # (v10 is the layout of the dev variant D1), and
        # K5: the level-1 correlation (fp32 out), raw and reference order,
        # on the same edges' gathered patch rows
        g_all, kk, _, f1, f2, coords, ff = args
        g_pre = g_all[kk.long()]
        del args
        for name, layout in (("corr_fused", "raw"), ("corr_fused", "v10"),
                             ("corr_fused", "v12"), ("corr_single", "raw"),
                             ("corr_single", "ref")):
            check_raw(results, E, name, layout, g_pre, f1, f2, coords, ff)
        if E in PROBE_SHAPES:
            phase_probes(results, E, g_pre, f1, f2, coords, ff)
        del g_all, kk, f1, f2, coords, ff, g_pre

        # K3: SoftAgg softmax sums (f32) over the agg_kk patch groups
        g_cap = k_cap + 8
        gate, val, gid = segment_inputs(E, D_agg, n_patches, dev, gen)
        shift = gate.max(dim=0, keepdim=True).values
        err, ok = check_softmax_sums(gate, val, shift, gid, g_cap)
        ms = graph_ms(lambda: agg_cuda.segment_softmax_sums(
            gate, val, shift, gid, g_cap), reps=20)
        b2b_ms = time_ms(lambda: agg_cuda.segment_softmax_sums(
            gate, val, shift, gid, g_cap), reps=20, windows=KERNEL_WINDOWS)
        plain_ms = time_ms(lambda: agg_cuda.segment_softmax_sums_plain(
            gate, val, shift, gid, g_cap), reps=10)
        G = agg_cuda.padded_groups(g_cap)
        nbytes = 2 * E * D_agg * 4 + D_agg * 4 + E * 4 + G * 2 * D_agg * 4
        b_ms, b_by = bound(nbytes, 5 * E * D_agg, "f32")
        log(f"[kernels] segment_softmax_sums E={E}: max_abs_err={err:.3e} "
            f"tol=rtol {TOL_SEG[0]} atol {TOL_SEG[1]} ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by}); "
            f"back to back {b2b_ms:.4f} {'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("segment_softmax_sums disagrees with its plain "
                             f"version at E={E}")
        results.setdefault("segment_softmax_sums", {})[E] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=None)

        # K4: BA coupling sums (f32), [A | C | u] with n_cap=16
        vals, _, gid = segment_inputs(E, D_ba, n_patches, dev, gen)
        err, err_ord, ok = check_segment_sums(vals, gid, k_cap + 1)
        ms = graph_ms(lambda: agg_cuda.segment_sums(vals, gid, k_cap + 1),
                      reps=20)
        b2b_ms = time_ms(lambda: agg_cuda.segment_sums(vals, gid, k_cap + 1),
                         reps=20, windows=KERNEL_WINDOWS)
        plain_ms = time_ms(lambda: agg_cuda.segment_sums_plain(
            vals, gid, k_cap + 1), reps=10)
        G = agg_cuda.padded_groups(k_cap + 1)
        gid_l = gid.long()
        def library():
            return torch.zeros((G, D_ba), device=dev).index_add_(0, gid_l,
                                                                 vals)
        lib_ms = graph_ms(library, reps=20)
        lib_b2b_ms = time_ms(library, reps=20, windows=KERNEL_WINDOWS)
        nbytes = E * D_ba * 4 + E * 4 + G * D_ba * 4
        b_ms, b_by = bound(nbytes, E * D_ba, "f32")
        log(f"[kernels] segment_sums E={E}: max_abs_err={err:.3e} "
            f"tol=rtol {TOL_SEG[0]} atol {TOL_SEG[1]}; against the "
            f"row-order reference {err_ord:.3e} (must be 0) ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms(index_add_)={lib_ms:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by}); back to back {b2b_ms:.4f}, "
            f"index_add_ {lib_b2b_ms:.4f} {'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"segment_sums disagrees with its plain version "
                             f"or the row-order reference at E={E}")
        results.setdefault("segment_sums", {})[E] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib_ms)
    segment_edge_cases(dev, SHAPES[1][0], D_ba, k_cap + 1)

    # K2 and K1 with every other patch spread beyond one box
    E, n_frames, n_patches = SHAPES[0]
    args = corr_inputs(E, n_frames, n_patches, dev, gen, spread=True)
    key = f"{E} spread"
    log(f"[kernels] {key}: " + fit_share(args[5], args[3], args[4]))
    check_enc(results, key, args)
    g_all, kk, _, f1, f2, coords, ff = args
    for layout in ("raw", "v12"):
        check_raw(results, key, "corr_fused", layout, g_all[kk.long()], f1,
                  f2, coords, ff)
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
# the lagged keyframing of the small drive (tests/test_torch_async.py's)
LAGGED = dict(ASYNC_KEYFRAME=True, ASYNC_KEYFRAME_LAG=3,
              ASYNC_KEYFRAME_BATCH=2)


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


def small_seams(slam):
    """The small drives' test seams: motion_probe forced, scripted
    centroids, fixed pre-init depth.  -> slam."""
    M = SMALL["PATCHES_PER_FRAME"]
    fh, fw = SMALL_HW[0] // 4, SMALL_HW[1] // 4

    def centroids(t):
        k = np.arange(M)
        return np.stack([1 + (7 * k + 3 * t) % (fw - 2),
                         1 + (5 * k + 11 * t) % (fh - 2)], -1)

    slam.motion_probe = lambda: 100.0
    slam.test_centroids = centroids
    slam.test_fixed_depth = 0.7
    return slam


def small_drive(dev, thresh, network, n_frames=16, hook=None,
                **overrides):
    """The small drive; ``hook(slam)`` runs before the first frame.  ->
    (poses, structure: keyframes, live edges, keyframe timestamps, delta
    keys, inactive edges and their (ii, jj, kk), the keyframe counts that
    ran global BA)."""
    import torch
    from dpvo_tpu_torch.config import VOConfig
    from dpvo_tpu_torch.engine import DPVO
    slam = small_seams(DPVO(VOConfig(**{**SMALL, "KEYFRAME_THRESH": thresh,
                                        **overrides}),
                            network=network, ht=SMALL_HW[0],
                            wd=SMALL_HW[1], device=dev))
    if hook is not None:
        hook(slam)
    for t, img in enumerate(small_frames(n_frames)):
        slam(t, img, SMALL_INTR)
    hs = slam.hs
    state = (slam.n, hs.e_num, hs.tstamps[:slam.n].tolist(),
             sorted(hs.delta), hs.n_inac,
             [a.tolist() for a in (hs.ii_inac, hs.jj_inac, hs.kk_inac)],
             np.nonzero(slam.ran_global_ba)[0].tolist())
    poses, _ = slam.terminate()
    if dev.type == "cuda":
        stream_sync()
    return poses, state


STRUCTURE = ("keyframes", "live edges", "keyframe timestamps",
             "delta keys", "inactive edges", "inactive (ii, jj, kk)",
             "global BA keyframe counts")


def structure_diff(a, b):
    """Where two ``small_drive`` structures differ: the fields, and for the
    inactive edges the first differing row of each index array."""
    out = []
    for name, x, y in zip(STRUCTURE, a, b):
        if x == y:
            continue
        if name == "inactive (ii, jj, kk)":
            rows = [next((i for i, (u, v) in enumerate(zip(p, q)) if u != v),
                         min(len(p), len(q))) for p, q in zip(x, y)]
            name += f" (first differing rows {rows})"
        out.append(name)
    return ", ".join(out)


def phase_agreement(dev):
    """The fp32 engine with the kernels on the card against the same
    engine with the plain versions on the CPU: same weights, scripted
    centroids, fixed depth, at each correlation version.  Structure must
    match exactly; poses within the envelopes of the CPU parity tests."""
    import torch
    network = small_network()
    runs = [(v, r, {}) for v in (13, 12, 9) for r in AGREE]
    runs.append((13, "always_merge", LAGGED))
    for version, regime, lag in runs:
        thresh, atol_t, atol_q = AGREE[regime]
        if lag:
            regime += " lagged"
        with corr_version(version):
            p_gpu, s_gpu = small_drive(dev, thresh, network, **lag)
            p_cpu, s_cpu = small_drive(torch.device("cpu"), thresh, network,
                                       **lag)
        err_t, err_q = pose_errors(p_gpu, p_cpu)
        ok = (s_gpu == s_cpu and np.isfinite(p_gpu).all()
              and err_t <= atol_t and err_q <= atol_q)
        log(f"[agree] {regime} v{version}: n={s_gpu[0]} edges={s_gpu[1]} "
            f"structure {'same' if s_gpu == s_cpu else 'DIFFERENT'}; "
            f"max|dt|={err_t:.3e} (tol {atol_t}) 1-min|q.q'|={err_q:.3e} "
            f"(tol {atol_q}) {'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"engine on the card disagrees with the CPU "
                             f"engine ({regime}, version {version})")


# the bf16 engine with the kernels against the same with the plain
# versions: the always-merge envelope of the fp32 drives
AGREE_BF16 = AGREE["always_merge"][1:]


@contextlib.contextmanager
def plain_correlation():
    """Swap ``corr_cuda.corr_enc`` / ``corr_fused`` for their plain
    versions (the engine looks them up at call time)."""
    from dpvo_tpu_torch.ops import corr_cuda
    old = corr_cuda.corr_enc, corr_cuda.corr_fused
    corr_cuda.corr_enc = corr_cuda.corr_enc_plain
    corr_cuda.corr_fused = corr_cuda.corr_fused_plain
    try:
        yield
    finally:
        corr_cuda.corr_enc, corr_cuda.corr_fused = old


def pose_errors(p_a, p_b):
    """max |translation difference| and 1 - min |quaternion dot|."""
    err_t = float(np.abs(p_a[:, :3] - p_b[:, :3]).max())
    qd = np.abs((p_a[:, 3:] * p_b[:, 3:]).sum(-1)) / np.maximum(
        np.linalg.norm(p_a[:, 3:], axis=-1)
        * np.linalg.norm(p_b[:, 3:], axis=-1), 1e-12)
    return err_t, float(1.0 - qd.min())


def phase_agreement_bf16(dev):
    """The small drive at MIXED_PRECISION=True on the card, with the
    kernels and with corr_enc / corr_fused swapped for their plain
    versions: structure exact, poses within AGREE_BF16; the kernel drive
    must launch its correlation kernel and the plain drive must not."""
    from dpvo_tpu_torch.ops import _cuda
    network = small_network()
    atol_t, atol_q = AGREE_BF16
    for version, name in ((13, "corr_enc"), (12, "corr_fused")):
        for regime, (thresh, _, _) in AGREE.items():
            with corr_version(version):
                _cuda.reset_launches()
                p_k, s_k = small_drive(dev, thresh, network,
                                       MIXED_PRECISION=True)
                n_kernel = _cuda.launches[name]
                _cuda.reset_launches()
                with plain_correlation():
                    p_p, s_p = small_drive(dev, thresh, network,
                                           MIXED_PRECISION=True)
                n_plain = _cuda.launches[name]
            err_t, err_q = pose_errors(p_k, p_p)
            ok = (s_k == s_p and np.isfinite(p_k).all() and n_kernel > 0
                  and n_plain == 0 and err_t <= atol_t and err_q <= atol_q)
            log(f"[agree] bf16 kernels vs plain, {regime} v{version}: "
                f"n={s_k[0]} edges={s_k[1]} structure "
                f"{'same' if s_k == s_p else 'DIFFERENT'}; "
                f"max|dt|={err_t:.3e} (tol {atol_t}) "
                f"1-min|q.q'|={err_q:.3e} (tol {atol_q}); {name} launches "
                f"{n_kernel} / {n_plain} {'OK' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"the bf16 engine with the kernels "
                                 f"disagrees with the plain versions "
                                 f"({regime}, version {version})")


# --- phase 4: the main path at full width --------------------------------


@contextlib.contextmanager
def last_calls():
    """Keep, passing every call through unchanged: the coords and rings of
    the last corr_enc / corr_fused call the engine makes (``box["coords"]``),
    the arguments of the last corr_enc call (``box["corr_enc"]``), those
    of the segment_softmax_sums and segment_sums calls with the most groups
    (``box[name]``): on a tie K3's first (an update's patch groups come
    before its frame-pair groups) and K4's last, and those of the first K3
    call with the most rows (``box["widest_softmax"]``); ``box["live"]``
    maps each kept K2/K3/K4 argument tuple's ``id`` to the live row count of
    the update program that made the call (a device scalar; None outside
    one: all rows live).  Calls inside a CUDA graph capture are not kept
    (their tensors live in the engine's graph pool, freed with the
    engine), nor calls inside ``DPVO.precompile`` (its warm-ups run on an
    empty bucket), and a replay passes no wrapper: under graphs the box
    holds the update program's eager runs, the warm-up of each capture at
    first reach on the state it is captured from, and
    ``end_state_update``'s run."""
    import torch
    from dpvo_tpu_torch.engine import DPVO, kernels
    from dpvo_tpu_torch.ops import agg_cuda, corr_cuda
    box = dict(coords=None, corr_enc=None, segment_softmax_sums=None,
               segment_sums=None, widest_softmax=None, live={})
    old = (corr_cuda.corr_enc, corr_cuda.corr_fused,
           agg_cuda.segment_softmax_sums, agg_cuda.segment_sums,
           kernels.update_step_dev)
    old_precompile = DPVO.precompile
    running = [None]
    precompiling = [False]

    def eager():
        return not (precompiling[0] or (
            torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing()))

    def precompile(self, *args, **kw):
        precompiling[0] = True
        try:
            return old_precompile(self, *args, **kw)
        finally:
            precompiling[0] = False

    def update_dev(ds, update_mod, bucket, e_num, *rest, **kw):
        if eager():
            running[0] = (e_num.clone() if torch.is_tensor(e_num)
                          else e_num)
        try:
            return old[4](ds, update_mod, bucket, e_num, *rest, **kw)
        finally:
            running[0] = None

    def enc(*args):
        if eager():
            box["coords"] = (args[5], args[3], args[4])
            box["corr_enc"] = args
            box["live"][id(args)] = running[0]
        return old[0](*args)

    def fused(g_pre, f1, f2, coords, *rest):
        if eager():
            box["coords"] = (coords, f1, f2)
        return old[1](g_pre, f1, f2, coords, *rest)

    def most_groups(name, fn, later):
        def call(*args):                 # g_cap is the last argument
            if eager() and (box[name] is None or args[-1] > box[name][-1]
                            or later and args[-1] == box[name][-1]):
                box[name] = args
                box["live"][id(args)] = running[0]
            if name == "segment_softmax_sums" and eager() and (
                    box["widest_softmax"] is None
                    or len(args[3]) > len(box["widest_softmax"][3])):
                box["widest_softmax"] = args
                box["live"][id(args)] = running[0]
            return fn(*args)
        return call

    corr_cuda.corr_enc, corr_cuda.corr_fused = enc, fused
    agg_cuda.segment_softmax_sums = most_groups("segment_softmax_sums",
                                                old[2], later=False)
    agg_cuda.segment_sums = most_groups("segment_sums", old[3], later=True)
    kernels.update_step_dev = update_dev
    DPVO.precompile = precompile
    try:
        yield box
    finally:
        (corr_cuda.corr_enc, corr_cuda.corr_fused,
         agg_cuda.segment_softmax_sums, agg_cuda.segment_sums,
         kernels.update_step_dev) = old
        DPVO.precompile = old_precompile

def device_profile(prof, wall_ms, n_frames, top=8, unit="frame"):
    """Device busy time (the union of the CUDA kernel intervals the
    profiler saw), idle share of the wall time, and the kernels with the
    most device time, per frame (or per ``unit``)."""
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
    return (f"{frame_ms:.2f} ms/{unit} wall, device busy {busy_ms:.2f} "
            f"ms/{unit}, idle {1 - busy_ms / frame_ms:.1%}, "
            f"{len(kern) / n_frames:.0f} kernels/{unit}; top: "
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
            stream_sync()

    def frame(t):
        return np.ascontiguousarray(np.roll(base, -4 * t, axis=1)[:, :wd])

    sync()
    _cuda.reset_launches()
    ms, edges = [], []
    n_timed = n_frames - n_profile
    with last_calls() as last:
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
        end_state_update(slam)
    fits = fit_share(*last["coords"])
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
    log(f"[engine] {name} update at the drive's end (one eager run after "
        f"terminate(), {last['coords'][0].shape[0]} edges): {fits}")
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


def phase_bench(dev, n_windows=2, n_profile=5):
    """bench_torch.py's merge and retain regimes at the default
    configuration (lagged keyframing), through its run_regime, with the
    windows capped; launch counts zeroed before each regime and read after.
    The merge drive's trajectory and map are written as TUM and PLY files
    into a temporary directory and read back.  The phase timers run (host
    dispatch), for the graphs phase.  -> {regime: result}."""
    from dpvo_tpu_torch.utils.plot_utils import (save_ply,
                                                 save_trajectory_tum_format)
    expect, absent = PATH_KERNELS[13]
    out = {}
    for regime in ("merge", "retain"):
        r = graph_run(dev, regime, True, n_windows, n_profile)
        last = r["last"]
        ms = [1e3 / w for w in r["windows"]]
        profile = device_profile(*r["profile"])
        n = len(r["poses"])
        log(f"[bench] {regime} 480x640 M=96 default config (lagged "
            f"keyframing): {n} frames, ms/frame per 40-frame window "
            + ", ".join(f"{m:.2f}" for m in ms)
            + f" (fps {r['fps']:.2f}), live edges at the windows' ends "
            f"{r['edges']} ({r['edges_range'][0]}..{r['edges_range'][1]} "
            f"over their frames), keyframes {r['keyframes']}, launches "
            f"{r['launches']}")
        log(f"[profile] bench {regime} last {n_profile} frames: {profile}")
        log(f"[bench] {regime} one eager update on the drive's end state "
            f"({last['coords'][0].shape[0]} edges): "
            + fit_share(*last["coords"]))
        ok = (np.isfinite(r["poses"]).all() and len(r["tstamps"]) == n
              and all(r["launches"].get(k, 0) > 0 for k in expect)
              and not any(r["launches"].get(k, 0) for k in absent))
        if not ok:
            raise SystemExit(f"bench drive ({regime}) failed: launches "
                             f"{r['launches']}")
        out[regime] = r
    merge = out["merge"]
    with tempfile.TemporaryDirectory() as tmp:
        traj, ply = Path(tmp) / "merge.txt", Path(tmp) / "merge.ply"
        save_trajectory_tum_format(merge["poses"], merge["tstamps"], traj)
        save_ply(ply, merge["points"], merge["colors"])
        back = np.loadtxt(traj)
        header = ply.read_text().split("end_header\n")[0].splitlines()
        n_pts = int(header[2].split()[-1])
        finite = int(np.isfinite(merge["points"]).all(-1).sum())
        ok = (back.shape == (len(merge["poses"]), 8)
              and np.allclose(back[:, 1:], merge["poses"], atol=1e-6)
              and n_pts == finite > 0)
        log(f"[bench] merge exports: TUM {back.shape} read back, PLY "
            f"{n_pts} points of {len(merge['points'])} "
            f"{'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("the merge drive's exports do not read back")
    return out


# --- phase 9b: the update program as CUDA graphs ----------------------------

# replay against eager on one state: the same kernels in the same order, so
# bitwise is expected; the limit (of max|replay - eager| / max(max|eager|,
# 1)) leaves room for a library that picks another algorithm in a capture
TOL_GRAPH = 1e-5
GRAPH_CHECKS = {"merge": 14336, "retain": 49152}   # regime -> bucket
SYNC_WARM = 8      # frames with no new capture before the sync check


def graph_engine(dev, regime, cuda_graphs=True):
    """bench_torch's engine for ``regime`` (default config, lagged
    keyframing, seeded random weights, motion probe forced) with its frame
    feed: -> (slam, feed, intrinsics)."""
    import bench_torch
    from dpvo_tpu_torch.engine import DPVO
    slam = DPVO(bench_torch.regime_config(regime), network=None, ht=480,
                wd=640, device=dev, seed=0, cuda_graphs=cuda_graphs)
    slam.motion_probe = lambda: 100.0
    return slam, bench_torch.FrameFeed(480, 640, dev), np.array(
        [320.0, 320.0, 320.0, 240.0])


UPDATE_WRITES = ("net", "target", "weight", "poses", "patches")


def stage_live_update(slam):
    """Stage a local-BA update of the engine's live state as ``update()``
    stages one (with the candidate's magnitude where decisions lag), and
    save what the update program writes: -> (bucket, has_mm, k_cap,
    restore)."""
    ds, hs, cfg = slam.ds, slam.hs, slam.cfg
    slam._flush_edge_permute()
    blob, _ = slam._mm_blob()
    k_cap = slam._update_k_cap()
    slam._stage_update(hs.e_num, max(slam.n - cfg.OPTIMIZATION_WINDOW, 1),
                       slam.n, blob)
    saved = [getattr(ds, k).clone() for k in UPDATE_WRITES]

    def restore():
        for k, v in zip(UPDATE_WRITES, saved):
            getattr(ds, k).copy_(v)
    return slam._edge_bucket(), blob is not None, k_cap, restore


def end_state_update(slam):
    """One eager run of the update program on the engine's state at the
    drive's end, the state put back after.  Under graphs the drive's own
    updates replay and pass no kernel wrapper, so inside ``last_calls``
    this run is the drive's last update."""
    import torch
    bucket, has_mm, k_cap, restore = stage_live_update(slam)
    slam._update_program(bucket, True, has_mm, k_cap)()
    restore()
    stream_sync()


def replay_against_eager(slam, regime, bucket, reps=5):
    """One graph replay of the update program against the eager program on
    the same state (the engine's live state at ``bucket``, inputs staged as
    ``update()`` stages them), then each timed ``reps`` times with a
    synchronise; the state is put back after."""
    import torch
    ds, hs = slam.ds, slam.hs
    _, _, k_cap, restore = stage_live_update(slam)
    names = UPDATE_WRITES

    key = slam._update_key(bucket, True, True, k_cap)

    def run(graph):
        # the exact key's graph (captured here if need be), never a cover
        if graph:
            return slam._run(key, slam._update_program(*key),
                             slam._update_writes(bucket))
        return slam._update_program(*key)()

    outs = {}
    for graph in (True, False):
        restore()
        mag = run(graph)
        stream_sync()
        outs[graph] = [getattr(ds, k)[:bucket].clone() if k in names[:3]
                       else getattr(ds, k).clone() for k in names] + [
            mag.clone()]
    errs = {}
    for k, a, b in zip(names + ("magnitude",), outs[True], outs[False]):
        scale = max(b.abs().max().item(), 1.0)
        errs[k] = (a - b).abs().max().item() / scale
    bitwise = all(torch.equal(a, b) for a, b in zip(outs[True], outs[False]))
    ms = {}
    for graph in (True, False):
        runs = []
        for _ in range(reps):
            restore()
            stream_sync()
            t0 = time.perf_counter()
            run(graph)
            stream_sync()
            runs.append((time.perf_counter() - t0) * 1e3)
        ms[graph] = sorted(runs)[reps // 2]
    restore()
    stream_sync()
    ok = max(errs.values()) <= TOL_GRAPH and bool(torch.isfinite(
        outs[True][3]).all())
    capture = [v for ms in (slam.graph_capture_ms,
                            slam.background_capture_ms)
               for k, v in ms.items() if k[:4] == (bucket, True, True, k_cap)]
    log(f"[graphs] {regime} replay vs eager at bucket {bucket} "
        f"({hs.e_num} live edges, k_cap {k_cap}): max error / max|eager| "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (tol {TOL_GRAPH}; {'bitwise' if bitwise else 'not bitwise'}); "
        f"update with a synchronise: replay {ms[True]:.2f} ms, eager "
        f"{ms[False]:.2f} ms (median of {reps}); capture (warm-up and "
        f"capture, host) {capture[0] if capture else float('nan'):.1f} ms "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"graphs: replay disagrees with the eager update "
                         f"program ({regime}, bucket {bucket})")
    return dict(errs=errs, bitwise=bitwise, ms=ms)


def drive_to_bucket(slam, feed, intr, bucket, t=0, max_frames=80):
    """Frames until the live edges after a frame fall in ``bucket``: -> the
    next frame index."""
    while t < max_frames:
        slam(t, feed.get(t), intr)
        t += 1
        if slam.is_initialized and slam._edge_bucket() == bucket:
            return t
    raise SystemExit(f"graphs: the drive never reached bucket {bucket} in "
                     f"{max_frames} frames")


@contextlib.contextmanager
def sync_checked(waits):
    """The block under ``torch.cuda.set_sync_debug_mode("error")`` (a host
    synchronisation raises), the overdue batch's event wait, a designed
    wait, bracketed on its own (the mode off for it alone) and counted in
    ``waits[0]``."""
    import torch
    orig = torch.cuda.Event.synchronize

    def bracketed(event):
        torch.cuda.set_sync_debug_mode(0)
        try:
            return orig(event)
        finally:
            waits[0] += 1
            torch.cuda.set_sync_debug_mode("error")

    torch.cuda.Event.synchronize = bracketed
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.Event.synchronize = orig


def check_frame_syncs(slam, feed, intr, t, max_frames=12):
    """Warm frames of the lagged merge drive under
    ``torch.cuda.set_sync_debug_mode("error")`` (a host synchronisation
    raises), until one has applied a merge; the overdue batch's event wait,
    a designed wait, is bracketed on its own (the mode is off for it alone)
    and counted.  First the drive runs until SYNC_WARM frames in a row
    captured no new graph on the engine's thread (``graph_capture_ms``; a
    cover's frame, whose key the guard's worker captures, may be checked).
    -> the next frame index."""
    quiet = 0
    while quiet < SYNC_WARM:
        n_graphs = len(slam.graph_capture_ms)
        slam(t, feed.get(t), intr)
        t += 1
        quiet = quiet + 1 if len(slam.graph_capture_ms) == n_graphs else 0
    waits = [0]
    checked, merged = 0, 0
    while checked < max_frames and not merged:
        img = feed.get(t)          # the feed's own buffer wait stays out
        n_graphs, n_delta = len(slam.graph_capture_ms), len(slam.hs.delta)
        stream_sync()
        with sync_checked(waits):
            slam(t, img, intr)
        stream_sync()
        t += 1
        if len(slam.graph_capture_ms) != n_graphs:
            raise SystemExit("graphs: a checked frame captured a new graph")
        checked += 1
        merged = len(slam.hs.delta) - n_delta
    log(f"[graphs] merge: {checked} warm frame(s) (track_frame, "
        f"append_factors, update, keyframe with its merges; the tracking, "
        f"update and merge programs replayed, no graph captured) under sync "
        f"debug mode \"error\": no host synchronisation; {waits[0]} "
        f"overdue-batch event wait(s) bracketed; {merged} merge(s) applied "
        f"in the last {'OK' if merged else 'FAIL'}")
    if not merged:
        raise SystemExit("graphs: no checked frame applied a merge")
    return t


def check_padded_kernels(last, regime):
    """K2, K3 and K4 at the drive's padded buckets (``last_calls``: the
    eager warm-ups of its captures at first reach and one eager update on
    its end state; bucket rows with the rows past the live count masked:
    in K3 ranked past its table, in K4 a group each), each against its
    plain version and timed on a graph: K2 at the last eager call, K3 at
    the widest, K4 at the call with the most groups.  Each call must hold
    live rows and, for K3 and K4, live groups: a comparison on masked rows
    alone would hold zeros against zeros."""
    import torch

    def live_rows(args, rows):
        live = last["live"][id(args)]
        return rows if live is None else int(live)

    args = last["corr_enc"]
    live2 = live_rows(args, args[5].shape[0])
    res = {}
    check_enc(res, f"at the {regime} drive's padded bucket", args)
    from dpvo_tpu_torch.ops import agg_cuda
    gate, val, shift, gid, g_cap = last["widest_softmax"]
    err3, ok3 = check_softmax_sums(gate, val, shift, gid, g_cap)
    ms3 = graph_ms(lambda: agg_cuda.segment_softmax_sums(gate, val, shift,
                                                         gid, g_cap))
    live3 = live_rows(last["widest_softmax"], len(gid))
    groups3 = summed_groups(gid, g_cap, live3)
    vals, gid4, g_cap4 = last["segment_sums"]
    live4 = live_rows(last["segment_sums"], len(gid4))
    groups4 = summed_groups(gid4, g_cap4, live4)
    err4, err_ord, ok4 = check_segment_sums(vals, gid4, g_cap4)
    ms4 = graph_ms(lambda: agg_cuda.segment_sums(vals, gid4, g_cap4))
    err2 = next(iter(res["corr_enc"].values()))["max_abs_err"]
    live_ok = min(live2, live3, live4, groups3, groups4) > 0
    ok = ok3 and ok4 and live_ok
    log(f"[graphs] {regime} padded kernels (the drive's eager update "
        f"calls: first-reach warm-ups, the end state): K2 "
        f"{args[5].shape[0]} rows ({live2} live) at the last, max_abs_err "
        f"{err2:.3e}; K3 at the widest, E={len(gid)} ({live3} live) "
        f"{groups3} live groups, the masked rows past the table, max_abs_err "
        f"{err3:.3e}, {ms3:.4f} ms; K4 at the most groups, E={len(gid4)} "
        f"({live4} live) {groups4} live groups, the masked rows a group "
        f"each, max_abs_err {err4:.3e}, row-order {err_ord:.3e} (must be "
        f"0), {ms4:.4f} ms {'OK' if ok else 'FAIL'}")
    if not live_ok:
        raise SystemExit(f"graphs: a kernel call checked at the {regime} "
                         f"drive's padded bucket held no live rows or groups")
    if not ok:
        raise SystemExit(f"graphs: K3/K4 disagree with their plain versions "
                         f"at the {regime} drive's padded bucket")
    torch.cuda.synchronize()


def graph_run(dev, regime, cuda_graphs, n_windows=2, n_profile=5):
    """bench_torch.run_regime with the phase timers on (host dispatch),
    launch counts zeroed before and read after.  Just before the engine's
    ``terminate()`` one eager update runs on the drive's end state
    (``end_state_update``, its launches not counted), so ``r["last"]``
    holds an update on the drive's live rows even where ``precompile``
    captured every graph the drive replays."""
    import torch
    import bench_torch
    from dpvo_tpu_torch.engine import DPVO
    from dpvo_tpu_torch.ops import _cuda
    old_terminate = DPVO.terminate

    def terminate(self):
        counted = _cuda.launches.copy()
        end_state_update(self)
        _cuda.launches.clear()
        _cuda.launches.update(counted)
        return old_terminate(self)

    torch.cuda.synchronize()
    _cuda.reset_launches()
    DPVO.terminate = terminate
    try:
        with last_calls() as last:
            r = bench_torch.run_regime(
                regime, device=dev, min_windows=n_windows,
                max_windows=n_windows, profile_frames=n_profile, timing=True,
                cuda_graphs=cuda_graphs)
    finally:
        DPVO.terminate = old_terminate
    r["launches"] = dict(_cuda.launches)
    r["last"] = last
    return r


def key_name(k):
    """A graph key for the logs: the update's (bucket, local BA, magnitude,
    k_cap, correlation version) as "14336 k4096" with " noBA" / " noMM"
    where they are off; the others by their fields."""
    if isinstance(k[0], str):
        return "/".join(str(x) for x in k)
    return (f"{k[0]}{'' if k[1] else ' noBA'}{'' if k[2] else ' noMM'} "
            f"k{k[3]}")


def report_run(regime, r, arm):
    g, timing = r["graphs"], r["timing"]
    ms = [1e3 / w for w in r["windows"]]
    pool = g["pool_bytes"]

    def phase(name):
        v = timing.get(name, (float("nan"), 0))
        return f"{name} {v[0]:.3f} ms x{v[1]}"

    log(f"[graphs] {regime} {arm}: ms/frame per 40-frame window "
        + ", ".join(f"{m:.2f}" for m in ms)
        + f" (fps {r['fps']:.2f}); dispatch "
        + "; ".join(phase(k) for k in ("track_frame", "keyframe/apply",
                                       "update/step", "update/meta"))
        + f"; buckets visited {g['buckets']}; graphs "
        f"{len(g['capture_ms'])}, capture ms " + ", ".join(
            f"{key_name(k)}: {v:.1f}" for k, v in g["capture_ms"].items())
        + f"; pool {'none' if pool is None else f'{pool / 2**20:.1f} MiB'}; "
        f"captures inside the timed windows {g['window_captures']} (in the "
        f"guard's worker {g['window_background']}); updates a cover served "
        + (", ".join(f"{key_name(k)}: {v}" for k, v in
                     g["cover_served"].items()) or "none")
        + "; background capture ms " + (", ".join(
            f"{key_name(k)}: {v:.1f}" for k, v in g["background_ms"].items())
            or "none")
        + f"; launches {r['launches']}")
    for i, pc in enumerate(g["precompile"]):
        after = pc["pool_bytes"]
        log(f"[graphs] {regime} {arm}: precompile call {i + 1}: "
            f"{pc['seconds']:.2f} s, {len(pc['ms'])} keys readied "
            f"({'captured' if after is not None else 'warmed eagerly'}), "
            f"largest first: " + ", ".join(f"{key_name(k)} {v:.1f} ms"
                                           for k, v in pc["ms"].items())
            + "; pool after "
            + ("none" if after is None else f"{after / 2**20:.1f} MiB"))
    if r["profile"] is not None:
        log(f"[profile] graphs {regime} {arm} last 5 frames: "
            + device_profile(*r["profile"]))


def program_replays_against_eager(slam, feed, t):
    """On the engine's live state: one replay of the tracking graph (a
    staged frame of the feed, as the next frame) and one of the merge
    graph (k = n - KEYFRAME_INDEX; captured now if no merge has run yet)
    each against its eager program from the same state and generator
    state (``DPVO._replay_against_eager``); bitwise, the generator left as
    far advanced (and only the tracking program advancing it); the state
    put back after each."""
    import torch
    from dpvo_tpu_torch.engine.dpvo import MERGE_WRITES, TRACK_WRITES
    ds, cfg = slam.ds, slam.cfg
    slam._stage_track(feed.frame(t), np.array([320.0, 320.0, 320.0, 240.0]),
                      slam.n, 1.0, slam.is_initialized)
    k = slam.n - cfg.KEYFRAME_INDEX
    res = {}
    for name, writes, (key, program), draws in (
            ("track", TRACK_WRITES, slam._track_program(), True),
            ("merge", MERGE_WRITES, slam._merge_program(), False)):
        if name == "merge":
            slam._copy_in(ds.merge_in, np.array([k, slam.n], np.int32))
        gen0 = slam.gen.get_state()
        (a, ga), (b, gb) = slam._replay_against_eager(
            key, program, slam._writes(writes), draws)
        stream_sync()
        same = [torch.equal(x, y) for x, y in zip(a, b)]
        advanced = not torch.equal(ga, gen0)
        res[name] = all(same) and torch.equal(ga, gb) and advanced == draws
        bad = [n for n, ok in zip(writes + ("dP",), same) if not ok]
        log(f"[graphs] merge {name} replay against its eager program on the "
            f"drive's state (n {slam.n}" + (f", k {k}" if name == "merge"
                                            else "")
            + f"): {'bitwise' if all(same) else f'differs in {bad}'}; "
            f"generator after replay and eager "
            f"{'equal' if torch.equal(ga, gb) else 'differ'}, "
            f"{'advanced' if advanced else 'untouched'} "
            f"{'OK' if res[name] else 'FAIL'}")
    if not all(res.values()):
        raise SystemExit("graphs: a tracking or merge replay differs from "
                         "its eager program")


def phase_graphs(dev, bench=None):
    """The device programs as CUDA graphs: (a) one update replay against
    the eager program on the same state at the merge and retain buckets,
    and on the merge state one tracking and one merge replay against
    theirs; (b) warm lagged merge frames under sync debug mode "error";
    (c) the bf16 lagged merge drive with graphs against the same drive run
    eagerly (structure exact, poses within AGREE_BF16); (d) merge and
    retain with graphs after precompile (``bench`` reuses phase_bench's
    runs) and eagerly: ms/frame, the phases' dispatch, device idle,
    buckets, capture ms, precompile, pool bytes against the first-reach
    pools of (a) and (b)'s engines, no capture in the timed windows; and
    K2/K3/K4 against their plain versions at the merge drive's padded
    bucket."""
    t_phase = time.perf_counter()
    first = {}
    for regime, bucket in GRAPH_CHECKS.items():
        slam, feed, intr = graph_engine(dev, regime)
        t = drive_to_bucket(slam, feed, intr, bucket)
        replay_against_eager(slam, regime, bucket)
        if regime == "merge":
            program_replays_against_eager(slam, feed, t)
            t = check_frame_syncs(slam, feed, intr, t)
        first[regime] = (slam.graph_pool_bytes(), len(slam._graphs), t)
        slam._wait_captures()     # the device synchronises after this
        del slam, feed
    runs = {}
    for regime in ("merge", "retain"):
        with_g = (bench or {}).get(regime) or graph_run(dev, regime, True)
        # (c) compares the merge drives window for window
        eager = graph_run(dev, regime, False,
                          n_windows=2 if regime == "merge" else 1)
        report_run(regime, with_g, "graphs after precompile")
        report_run(regime, eager, "eager")
        pool, n_graphs, frames = first[regime]
        log(f"[graphs] {regime} graph pool: "
            f"{with_g['graphs']['pool_bytes'] / 2**20:.1f} MiB with "
            f"precompile (largest bucket first, "
            f"{len(with_g['graphs']['capture_ms'])} graphs) against "
            f"{pool / 2**20:.1f} MiB at first reach ({n_graphs} graphs "
            f"after the checks' {frames} frames)")
        if with_g["graphs"]["window_captures"]:
            raise SystemExit(f"graphs: {regime} captured "
                             f"{with_g['graphs']['window_captures']} graphs "
                             f"inside its timed windows after precompile")
        runs[regime] = (with_g, eager)
    check_padded_kernels(runs["merge"][0]["last"], "merge")
    g, e = runs["merge"]
    err_t, err_q = pose_errors(g["poses"], e["poses"])
    atol_t, atol_q = AGREE_BF16
    same = (g["keyframes"], g["edges"]) == (e["keyframes"], e["edges"])
    ok = (same and g["poses"].shape == e["poses"].shape
          and np.isfinite(g["poses"]).all() and err_t <= atol_t
          and err_q <= atol_q)
    log(f"[graphs] bf16 lagged merge drive, graphs against eager: "
        f"{len(g['poses'])} frames, keyframes {g['keyframes']} / "
        f"{e['keyframes']}, live edges at the windows' ends {g['edges']} / "
        f"{e['edges']}; max|dt|={err_t:.3e} (tol {atol_t}) "
        f"1-min|q.q'|={err_q:.3e} (tol {atol_q}) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("graphs: the graphed merge drive disagrees with the "
                         "eager one")
    log(f"[graphs] phase {time.perf_counter() - t_phase:.1f} s")
    return runs


# --- phase 9c: the cold-bucket guard ---------------------------------------

GUARD_FRAMES = 40
GUARD_PLAN = dict(max_edges=1024)     # ladder <= 8192, plus the top, 57344
FULL_PLAN = dict(max_edges=24576)     # every bucket the drive reaches


def guard_drive(dev, regime="merge", plan=None, n_frames=GUARD_FRAMES,
                around=None):
    """A drive whose frame calls the guard phase times, on the engine that
    ``import dpvo_tpu_torch`` finds (this tree's, or a parent checkout's
    in ``--guard-drive``'s process): ``merge``, the lagged merge drive
    (bench_torch's config and frame feed) after ``precompile(**plan)``;
    ``lc``, phase 5's loop-closure drive (``configs/default.yaml`` with
    LC_FULL, a frame rolling 4 px a frame), nothing precompiled.  Each
    frame call's wall ms to the end of its device work (the engine's
    stream waited on before and after: a device-wide synchronise is
    refused while a capture is open in another thread); ``around(slam, t,
    img, intr)`` makes the call if given.  -> dict: slam, pre (precompile's
    result or None), and ``drive_stats``'s keys."""
    import gc
    import torch
    import bench_torch
    from dpvo_tpu_torch.config import VOConfig
    from dpvo_tpu_torch.engine import DPVO
    ht, wd = 480, 640
    if regime == "merge":
        cfg = bench_torch.regime_config("merge")
        feed = bench_torch.FrameFeed(ht, wd, dev)
        intr = np.array([320.0, 320.0, 320.0, 240.0])
        frame = feed.get
    else:
        root = Path(bench_torch.__file__).resolve().parent
        cfg = VOConfig().merge_yaml(
            str(root / "configs" / "default.yaml")).replace(**LC_FULL)
        base = np.random.default_rng(0).integers(0, 255, (ht, 2 * wd, 3),
                                                 dtype=np.uint8)
        intr = np.array([wd / 2, wd / 2, wd / 2, ht / 2])

        def frame(t):
            return np.ascontiguousarray(np.roll(base, -4 * t, axis=1)[:, :wd])
    slam = DPVO(cfg, network=None, ht=ht, wd=wd, device=dev, seed=0)
    slam.motion_probe = lambda: 100.0
    stream = torch.cuda.current_stream(dev)
    pre = slam.precompile(**plan) if plan is not None else None
    pauses, spans, reserved, init, glob = [], [], [], None, []

    def on_gc(phase, info):
        if phase == "start":
            on_gc.t0 = time.perf_counter()
        else:
            pauses.append((on_gc.t0, time.perf_counter()))

    gc.callbacks.append(on_gc)
    try:
        for t in range(n_frames):
            img = frame(t)
            ran = np.count_nonzero(slam.ran_global_ba)
            stream.synchronize()
            t0 = time.perf_counter()
            if around is None:
                slam(t, img, intr)
            else:
                around(slam, t, img, intr)
            stream.synchronize()
            spans.append((t0, time.perf_counter()))
            reserved.append(torch.cuda.memory_reserved(dev))
            if init is None and slam.is_initialized:
                init = t                     # the frame of the 12 updates
            if np.count_nonzero(slam.ran_global_ba) > ran:
                glob.append(t)
    finally:
        gc.callbacks.remove(on_gc)
    ms = [(b - a) * 1e3 for a, b in spans]
    gc_ms = [sum(max(0.0, min(b, e) - max(a, s)) for s, e in pauses) * 1e3
             for a, b in spans]
    grew = [t for t in range(1, n_frames) if reserved[t] > reserved[t - 1]]
    pre_keys = set(pre["ms"]) if pre is not None else set()
    here = [v for k, v in slam.graph_capture_ms.items() if k not in pre_keys]
    served = getattr(slam, "cover_served", {})
    return dict(
        slam=slam, pre=pre, ms=ms, gc_ms=gc_ms, grew=grew, init=init,
        glob=glob, here_ms=here,
        served=sum(served.values()),
        raised=sum(v for k, v in served.items() if k[3] > slam.k_cap),
        background_ms=list(getattr(slam, "background_capture_ms",
                                   {}).values()))


def drive_stats(res):
    """``guard_drive``'s result without its engine: what the log reads,
    and what ``--guard-drive``'s process prints."""
    return {k: v for k, v in res.items() if k not in ("slam", "pre")}


def frame_line(d):
    """median, worst warm frame (its index, its garbage collection time),
    the worst warm frame without global BA where one ran, the init frame;
    captures on the engine thread (after ``precompile``), covers served"""
    ms, gc_ms, warm0 = d["ms"], d["gc_ms"], d["init"] + 1
    w = ms[warm0:]
    i = warm0 + int(np.argmax(w))
    line = (f"median {sorted(ms)[len(ms) // 2]:.2f} ms, worst warm frame "
            f"{max(w):.2f} ms (frame {i}, garbage collection "
            f"{gc_ms[i]:.2f} ms of it)")
    if d["glob"]:
        plain = [m for t, m in enumerate(ms) if t >= warm0
                 and t not in d["glob"]]
        line += (f", global BA in frames {d['glob']}, worst warm frame "
                 f"without it {max(plain):.2f} ms")
    here = d["here_ms"]
    return line + (
        f", initialisation frame {ms[warm0 - 1]:.2f} ms; garbage "
        f"collection in the warm frames {sum(gc_ms[warm0:]):.2f} ms, at "
        f"most {max(gc_ms[warm0:]):.2f} in one; captures on the engine "
        f"thread {len(here)}"
        + (f" ({sum(here):.1f} ms, at most {max(here):.1f})" if here else "")
        + f"; updates a cover served {d['served']} ({d['raised']} at a "
        f"raised patch capacity); background captures "
        f"{[round(m, 1) for m in d['background_ms']]} ms")


def parent_drives(parent):
    """The guard phase's two drives on the checkout ``parent``: this script
    in a fresh process with ``parent`` first on its path, its own kernel
    build (``--guard-drive``).  -> {"merge": drive_stats, "lc": ...}."""
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--guard-drive",
         str(parent)], cwd=parent, capture_output=True, text=True,
        timeout=600)
    if proc.returncode != 0:
        raise SystemExit(f"guard: the drives on {parent} failed:\n"
                         f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    line = [x for x in proc.stdout.splitlines() if x.startswith("GUARD ")]
    return json.loads(line[-1][6:])


def guard_drive_main(parent):
    """``--guard-drive DIR``: the guard phase's merge and loop-closure
    drives on the engine of the checkout DIR, their ``drive_stats`` printed
    as one line ``GUARD {...}``."""
    import torch
    sys.path.insert(0, str(Path(parent).resolve()))
    import dpvo_tpu_torch
    assert Path(dpvo_tpu_torch.__file__).resolve().is_relative_to(
        Path(parent).resolve()), dpvo_tpu_torch.__file__
    dev = torch.device("cuda:0")
    out = {}
    for regime, plan, n in (("merge", GUARD_PLAN, GUARD_FRAMES),
                            ("lc", None, LC_FULL_FRAMES)):
        res = guard_drive(dev, regime, plan, n)
        out[regime] = drive_stats(res)
        res["slam"].terminate()
        del res
    print("GUARD " + json.dumps(out), flush=True)
    return 0


def checked_frame(stats):
    """A frame call for ``guard_drive``: once the engine is initialised,
    ``sync_checked``; records the checked frames a cover served while a
    capture was in flight, and the frame after which each background
    capture had landed."""
    def frame(slam, t, img, intr):
        if not slam.is_initialized:
            slam(t, img, intr)
            return
        served = sum(slam.cover_served.values())
        with sync_checked(stats["waits"]):
            slam(t, img, intr)
        stats["checked"] += 1
        if sum(slam.cover_served.values()) > served and slam._in_flight:
            stats["covered"] += 1
        for key in slam.background_capture_ms:
            stats["landed"].setdefault(key, t)
    return frame


def injected_failure(dev):
    """A background capture made to fail (the update program raises in the
    worker) must raise on the engine thread at its next update: the small
    fp32 engine on a two-step ladder (its updates ask for 1024, 1536
    covers them)."""
    import threading
    from dpvo_tpu_torch.config import VOConfig
    from dpvo_tpu_torch.engine import DPVO
    cfg = VOConfig(**{**SMALL, "EDGE_CAPACITY": 1536, "BUCKET_FLOOR": 1024,
                      "ASYNC_KEYFRAME": True})
    slam = small_seams(DPVO(cfg, network=small_network(), ht=SMALL_HW[0],
                            wd=SMALL_HW[1], device=dev))
    slam.precompile(max_edges=1536)
    del slam._graphs[slam._update_key(1024, True, True, slam.k_cap)]
    real, main = slam._update_program, threading.current_thread()

    def failing(*key):
        run = real(*key)

        def failing_run():
            if threading.current_thread() is not main:
                raise RuntimeError("injected capture failure")
            return run()
        return failing_run
    slam._update_program = failing
    try:
        for t, img in enumerate(small_frames()):
            slam(t, img, SMALL_INTR)
    except RuntimeError as e:
        if "injected capture failure" not in str(e):
            raise
        log(f"[guard] injected failure: a background capture that raised "
            f"in the worker raised on the engine thread at frame {t} "
            f"({type(e).__name__}: {e}) OK")
        slam._worker.shutdown()
        return
    raise SystemExit("guard: a failed background capture raised nothing on "
                     "the engine thread")


def phase_guard(dev, parent=None):
    """The cold-bucket guard on the lagged merge drive at 480x640, M=96,
    bf16, after ``precompile(max_edges=1024)`` (the update keys at 8192
    and at the ladder's top, 57344, the only cover of the drive's
    10240-24576 buckets): each frame call's wall ms (worst, median),
    captures on the engine thread after precompile (must be 0), updates a
    cover served per key and each background capture's ms (each must
    land); every initialised frame under sync debug mode "error"; the
    poses against the same drive with every bucket precompiled
    (AGREE_BF16, structure exact); the loop-closure drive's frames (its
    keys captured at first reach, those at a raised patch capacity
    served by a cover where one was captured); with ``parent`` the
    parent tree's two drives in a fresh process, for their worst frames;
    and an injected failure."""
    import torch
    t_phase = time.perf_counter()
    stats = dict(checked=0, covered=0, waits=[0], landed={})
    res = guard_drive(dev, "merge", GUARD_PLAN, around=checked_frame(stats))
    slam, pre, ms = res["slam"], res["pre"], res["ms"]
    warm0 = res["init"] + 1
    n_pre = len(pre["ms"])
    here = {k: v for k, v in slam.graph_capture_ms.items()
            if k not in pre["ms"]}
    served = dict(slam.cover_served)
    in_flight = list(slam._in_flight)
    poses, _ = slam.terminate()
    torch.cuda.current_stream(dev).synchronize()
    landed = dict(slam.background_capture_ms)
    log(f"[guard] merge 480x640 M=96 bf16, precompile {GUARD_PLAN}: "
        f"{n_pre} keys ({', '.join(key_name(k) for k in pre['ms'])}) in "
        f"{pre['seconds']:.2f} s; {GUARD_FRAMES} frames, frame call to the "
        f"end of its device work: {frame_line(drive_stats(res))}; second "
        f"worst warm frame {sorted(ms[warm0:])[-2]:.2f} ms; per frame "
        f"{[round(m, 2) for m in ms]}; reserved memory grew in frames "
        f"{res['grew']}; buckets asked {slam.buckets_seen}")
    log(f"[guard] captures on the engine thread after precompile: "
        f"{len(here)} {[key_name(k) for k in here]}; updates a cover served "
        + ", ".join(f"{key_name(k)}: {v}" for k, v in served.items())
        + "; background captures (ms, in the worker, in the order they "
        "landed) "
        + ", ".join(f"{key_name(k)}: {v:.1f}" for k, v in landed.items())
        + "; landed after frame " + ", ".join(
            f"{key_name(k)}: {t}" for k, t in stats["landed"].items())
        + f"; in flight at the last frame {len(in_flight)}")
    log(f"[guard] {stats['checked']} initialised frames under sync debug "
        f"mode \"error\": no host synchronisation; {stats['covered']} of "
        f"them served by a cover with a capture in flight; "
        f"{stats['waits'][0]} overdue-batch event wait(s) bracketed")
    ok = (not here and served and set(landed) == set(served)
          and stats["covered"] > 0)
    ref = guard_drive(dev, "merge", FULL_PLAN)
    ref_slam = ref["slam"]
    ref_keyframes, ref_edges = ref_slam.n, ref_slam.hs.e_num
    ref_poses, _ = ref_slam.terminate()
    err_t, err_q = pose_errors(poses, ref_poses)
    atol_t, atol_q = AGREE_BF16
    same = (slam.n, slam.hs.e_num) == (ref_keyframes, ref_edges)
    agree = (same and np.isfinite(poses).all() and err_t <= atol_t
             and err_q <= atol_q)
    log(f"[guard] poses against the drive with every bucket precompiled "
        f"{FULL_PLAN} ({frame_line(drive_stats(ref))}): keyframes "
        f"{slam.n} / {ref_keyframes}, live edges {slam.hs.e_num} / "
        f"{ref_edges}; max|dt|={err_t:.3e} (tol {atol_t}) "
        f"1-min|q.q'|={err_q:.3e} (tol {atol_q}) "
        f"{'OK' if agree else 'FAIL'}")
    del slam, ref, ref_slam, res
    lc = guard_drive(dev, "lc", n_frames=LC_FULL_FRAMES)
    lc_poses, _ = lc["slam"].terminate()
    lc_ok = np.isfinite(lc_poses).all()
    lc = drive_stats(lc)
    log(f"[guard] loop-closure drive (phase 5's, {LC_FULL_FRAMES} frames, "
        f"nothing precompiled): {frame_line(lc)}; poses finite {lc_ok}")
    if parent is not None:
        p = parent_drives(parent)
        log(f"[guard] parent tree {parent}, the same merge drive: "
            f"{frame_line(p['merge'])}; per frame "
            f"{[round(m, 2) for m in p['merge']['ms']]}; reserved memory "
            f"grew in frames {p['merge']['grew']}; this tree's worst warm "
            f"frame {max(ms[warm0:]):.2f} ms")
        log(f"[guard] parent tree {parent}, the same loop-closure drive: "
            f"{frame_line(p['lc'])}; this tree's worst warm frame "
            f"{max(lc['ms'][lc['init'] + 1:]):.2f} ms")
    else:
        log("[guard] parent tree: not given (--parent DIR)")
    injected_failure(dev)
    log(f"[guard] phase {time.perf_counter() - t_phase:.1f} s "
        f"{'OK' if ok and agree and lc_ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"guard: engine-thread captures {len(here)}, "
                         f"served {served}, landed {list(landed)}, checked "
                         f"cover frames {stats['covered']}")
    if not agree:
        raise SystemExit("guard: the guarded drive disagrees with the fully "
                         "precompiled one")
    if not lc_ok:
        raise SystemExit("guard: the loop-closure drive's poses are not "
                         "finite")


# --- phase 5: loop closure ------------------------------------------------

# the small loop-closure drive (tests/test_torch_loop_closure.py's): frame
# 0 is live at initialisation (REMOVAL_WINDOW 6), proposals are looked for
# every 10 keyframes, and the 45 keyframes reach 30 frames apart
LC_SMALL = dict(REMOVAL_WINDOW=6, LOOP_CLOSURE=True, GLOBAL_OPT_FREQ=10,
                BACKEND_THRESH=1e9, MAX_EDGE_AGE=64, EDGE_CAPACITY=2048)
LC_SMALL_FRAMES = 45
# the full-width drive: configs/default.yaml with these overrides.  The
# retain regime keeps every frame, so keyframes reach REMOVAL_WINDOW + 30
# = 52 and proposals land at 35, 50, 65 and 80 (and again at terminate();
# the last rounds' loop edges reach back far enough that an update's
# patch groups pass phase 2's 4104: at 72 frames that rested on one
# terminate() round, and a change of rounding in the update moved the
# proposals enough to miss it); it retires about 2400 edges a
# frame, which the default inactive store (16384 rows) holds for 7 frames.
# The edge table holds the retain regime's 45312 live edges and the loop
# edges.  Random weights give no valid flow test at the default
# BACKEND_THRESH, so any valid pair qualifies.
LC_FULL = dict(KEYFRAME_THRESH=0.0, BUFFER_SIZE=128,
               EDGE_CAPACITY_INAC=1 << 18, EDGE_CAPACITY=1 << 17,
               BACKEND_THRESH=1e9)
LC_FULL_FRAMES = 80
LC_PROFILE = (64, 67)    # frames with global BA (after the proposal at 65)


@contextlib.contextmanager
def lc_counters():
    """Count and time what loop closure does: ``ba_global`` calls (the
    largest call's inputs kept in ``out["ba_global_args"]``), and, in an
    engine passed to ``out["attach"]``, proposal batches (keyframe count,
    pairs) and global BA calls (ms each, synchronised before and after)."""
    import torch
    from dpvo_tpu_torch.ops import ba
    out = dict(proposals=[], global_ms=[], ba_global=0, ba_global_args=None)
    ba_global = ba.ba_global

    def counted(*args, **kw):
        out["ba_global"] += 1
        best = out["ba_global_args"]
        if args[0].is_cuda and (best is None
                                or args[6].shape[0] > best[0][6].shape[0]):
            out["ba_global_args"] = ([a.clone() if torch.is_tensor(a) else a
                                      for a in args], kw)
        return ba_global(*args, **kw)

    def attach(slam):
        edges_loop, run_global = slam.edges_loop, slam._run_global_ba
        sync = (torch.cuda.synchronize if slam.device.type == "cuda"
                else lambda: None)

        def proposals():
            kk, jj = edges_loop()
            if len(kk):
                out["proposals"].append((slam.n, len(kk) // slam.M))
            return kk, jj

        def timed_global():
            sync()
            t0 = time.perf_counter()
            run_global()
            sync()
            out["global_ms"].append((time.perf_counter() - t0) * 1e3)

        slam.edges_loop, slam._run_global_ba = proposals, timed_global

    out["attach"] = attach
    ba.ba_global = counted
    try:
        yield out
    finally:
        ba.ba_global = ba_global


def phase_lc_agreement(dev):
    """The small loop-closure drive on the card against the CPU: structure
    exact, poses within the never-merge envelope; the card drive must run
    global BA at initialisation, propose and call ba_global."""
    import torch
    network = small_network()
    thresh, atol_t, atol_q = AGREE["never_merge"]
    t0 = time.perf_counter()
    with lc_counters() as out:
        p_gpu, s_gpu = small_drive(dev, thresh, network, LC_SMALL_FRAMES,
                                   hook=out["attach"], **LC_SMALL)
    t_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    p_cpu, s_cpu = small_drive(torch.device("cpu"), thresh, network,
                               LC_SMALL_FRAMES, **LC_SMALL)
    t_cpu = time.perf_counter() - t0
    err_t, err_q = pose_errors(p_gpu, p_cpu)
    ok = (s_gpu == s_cpu and np.isfinite(p_gpu).all() and err_t <= atol_t
          and err_q <= atol_q and 8 in s_gpu[6] and out["proposals"]
          and out["ba_global"] > 0)
    log(f"[lc] small drive {LC_SMALL_FRAMES} frames {LC_SMALL}: card "
        f"{t_gpu:.1f} s, CPU {t_cpu:.1f} s; n={s_gpu[0]} edges={s_gpu[1]} "
        f"inactive={s_gpu[4]} global BA at keyframe counts {s_gpu[6]}; "
        f"proposals (n, pairs) {out['proposals']}; global BA calls "
        f"{len(out['global_ms'])} (ba_global {out['ba_global']}); "
        f"structure {'same' if s_gpu == s_cpu else 'DIFFERENT'}"
        + (f" in {structure_diff(s_gpu, s_cpu)}" if s_gpu != s_cpu else "")
        + f"; max|dt|={err_t:.3e} (tol {atol_t}) 1-min|q.q'|={err_q:.3e} "
        f"(tol {atol_q}) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the loop-closure engine on the card disagrees "
                         "with the CPU engine, or did not propose and run "
                         "ba_global")


def drive_lc(dev, n_frames=LC_FULL_FRAMES, ht=480, wd=640):
    """configs/default.yaml (LOOP_CLOSURE on, 1000-frame patch rings) at
    480x640 with LC_FULL's overrides, seeded random weights, motion_probe
    forced, a frame rolling 4 px per frame; launch counts zeroed just
    before and read after terminate().  -> the counters of lc_counters."""
    import torch
    from dpvo_tpu_torch.config import VOConfig
    from dpvo_tpu_torch.engine import DPVO
    from dpvo_tpu_torch.ops import _cuda
    path = Path(__file__).resolve().parent / "configs" / "default.yaml"
    cfg = VOConfig().merge_yaml(str(path)).replace(**LC_FULL)
    slam = DPVO(cfg, network=None, ht=ht, wd=wd, device=dev, seed=0)
    slam.motion_probe = lambda: 100.0
    log(f"[lc] full drive: configs/default.yaml (LOOP_CLOSURE="
        f"{cfg.LOOP_CLOSURE}, MAX_EDGE_AGE={cfg.MAX_EDGE_AGE}, "
        f"GLOBAL_OPT_FREQ={cfg.GLOBAL_OPT_FREQ}, M={cfg.PATCHES_PER_FRAME}, "
        f"MIXED_PRECISION={cfg.MIXED_PRECISION}) with overrides {LC_FULL}; "
        f"{ht}x{wd}, {n_frames} frames, pmem={slam.pmem}, gmap ring "
        f"{tuple(slam.ds.gmap.shape)} {slam.ds.gmap.dtype}")
    base = np.random.default_rng(0).integers(0, 255, (ht, 2 * wd, 3),
                                             dtype=np.uint8)
    intr = np.array([wd / 2, wd / 2, wd / 2, ht / 2])
    stream_sync()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    ms, with_global, peak_e, peak_inac = [], [], 0, 0
    profiled, prof_calls = range(*LC_PROFILE), set()
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    with lc_counters() as out, last_calls() as last:
        out["attach"](slam)
        for t in range(n_frames):
            img = np.ascontiguousarray(np.roll(base, -4 * t, axis=1)[:, :wd])
            if t == profiled[0]:
                prof.start()
                t_prof = time.perf_counter()
            calls = len(out["global_ms"])
            t0 = time.perf_counter()
            slam(t, img, intr)
            stream_sync()
            frame_ms = (time.perf_counter() - t0) * 1e3
            if t in profiled:
                prof_calls.update(range(calls, len(out["global_ms"])))
            elif t >= 20:
                ms.append(frame_ms)
                with_global.append(len(out["global_ms"]) > calls)
            if t == profiled[-1]:
                prof.stop()
                profile = device_profile(
                    prof, (time.perf_counter() - t_prof) * 1e3,
                    len(profiled))
            peak_e = max(peak_e, slam.hs.e_num)
            peak_inac = max(peak_inac, slam.hs.n_inac)
        poses, tstamps = slam.terminate()
        stream_sync()
        launches = dict(_cuda.launches)
        end_state_update(slam)
    mem = torch.cuda.max_memory_allocated() / 2**30
    steady = sorted(ms)
    plain = sorted(m for m, g in zip(ms, with_global) if not g)
    glob = sorted(m for m, g in zip(ms, with_global) if g)
    by_solver = (f"ba_global {out['ba_global']}, ba_iterative "
                 f"{len(out['global_ms']) - out['ba_global']}")
    gms = [m for i, m in enumerate(out["global_ms"]) if i not in prof_calls]

    def median(v):
        return f"{v[len(v) // 2]:.2f}" if v else "none"

    log(f"[lc] full drive: {n_frames} frames, median {median(steady)} "
        f"ms/frame (frames 20..{n_frames - 1} but the profiled "
        f"{profiled[0]}..{profiled[-1]}, max {steady[-1]:.2f}; without "
        f"global BA {len(plain)} frames, median {median(plain)}; with "
        f"global BA {len(glob)} frames, median {median(glob)} ms), keyframes "
        f"{slam.n}, proposals (n, pairs) {out['proposals']}; global BA "
        f"{len(out['global_ms'])} calls ({by_solver}), "
        + (f"{np.median(gms):.2f} ms per call median of the {len(gms)} "
           f"unprofiled (min {min(gms):.2f}, max {max(gms):.2f}) "
           if gms else "")
        + f"at keyframe counts {np.nonzero(slam.ran_global_ba)[0].tolist()};"
        f" peak live edges {peak_e}, peak inactive edges {peak_inac}; "
        f"max_memory_allocated {mem:.2f} GiB; launches {launches}")
    keys = list(slam.graph_capture_ms)
    pool = slam.graph_pool_bytes()
    log(f"[lc] full drive's graphs: {len(keys)} captured: "
        f"{[key_name(k) for k in keys]}; capture ms "
        f"{sum(slam.graph_capture_ms.values()):.1f} in all; pool "
        f"{(pool or 0) / 2**20:.1f} MiB")
    raised = {k: v for k, v in slam.cover_served.items()
              if k[3] > slam.k_cap}
    log(f"[lc] full drive's cold-bucket guard: a cover served "
        f"{sum(slam.cover_served.values())} updates of "
        f"{len(slam.cover_served)} keys, {sum(raised.values())} of them of "
        f"{len(raised)} keys at a raised patch capacity ("
        + (", ".join(f"{key_name(k)}: {v}" for k, v in raised.items())
           or "none") + "); background capture ms "
        + (", ".join(f"{key_name(k)}: {v:.1f}" for k, v in
                     slam.background_capture_ms.items()) or "none"))
    log(f"[profile] lc full drive frames {profiled[0]}..{profiled[-1]} "
        f"(synchronised each frame): {profile}")
    ok = (poses.shape == (n_frames, 7) and np.isfinite(poses).all()
          and len(tstamps) == n_frames and out["proposals"]
          and out["ba_global"] > 0
          and all(launches.get(k, 0) > 0 for k in PATH_KERNELS[13][0]))
    if not ok:
        raise SystemExit(f"the loop-closure drive failed: poses finite "
                         f"{np.isfinite(poses).all()}, proposals "
                         f"{out['proposals']}, ba_global calls "
                         f"{out['ba_global']}, launches {launches}")
    out["launches"] = launches
    check_lc_kernels(last)
    return out


def check_lc_kernels(last):
    """K2 at the full drive's end state (``end_state_update``, its
    1000-frame gmap ring), and K3 and K4 at the drive's eager calls with
    the most groups (``last_calls``: the captures' warm-ups and the end
    state's run), each against its plain version; K3 must see more live
    patch groups than phase 2's 4104."""
    import torch
    args = last["corr_enc"]
    k2 = {}
    check_enc(k2, "at the lc drive's end state", args)
    r = next(iter(k2["corr_enc"].values()))
    log(f"[lc] K2 at the drive's end state (one eager update after "
        f"terminate()): {args[5].shape[0]} edges, "
        f"gmap ring {args[0].shape[0]} rows: max_abs_err "
        f"{r['max_abs_err']:.3e} (tol {TOL_K2}*max|plain|), {r['ms']:.4f} "
        f"ms (bound {r['bound_ms']:.4f}, {r['bound_by']})")
    gate, val, shift, gid, g_cap = last["segment_softmax_sums"]
    groups = summed_groups(gid, g_cap,
                           last["live"][id(last["segment_softmax_sums"])])
    err, ok = check_softmax_sums(gate, val, shift, gid, g_cap)
    ok = ok and groups > 4104
    log(f"[lc] K3 at the drive's eager call with the most groups (the "
        f"captures' warm-ups and the end state's run): E={len(gid)}, "
        f"{groups} live groups, g_cap={g_cap}: max_abs_err={err:.3e} tol=rtol "
        f"{TOL_SEG[0]} atol {TOL_SEG[1]} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("segment_softmax_sums disagrees with its plain "
                         "version on the loop-closure drive, or saw no more "
                         "than 4104 groups")
    vals, gid, g_cap = last["segment_sums"]
    live = last["live"][id(last["segment_sums"])]
    err, err_ord, ok = check_segment_sums(vals, gid, g_cap)
    log(f"[lc] K4 at the drive's last eager call with the most groups: "
        f"E={len(gid)}, {summed_groups(gid, g_cap, live)} live groups, "
        f"g_cap={g_cap}: max_abs_err="
        f"{err:.3e} tol=rtol {TOL_SEG[0]} atol {TOL_SEG[1]}; against the "
        f"row-order reference {err_ord:.3e} (must be 0) "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("segment_sums disagrees with its plain version or "
                         "the row-order reference on the loop-closure drive")
    torch.cuda.synchronize()


def check_ba_global_syncs(out):
    """One ba_global call on the largest inputs of the full drive under
    ``torch.cuda.set_sync_debug_mode("error")``: a host synchronisation
    inside it raises."""
    import torch
    from dpvo_tpu_torch.ops import ba
    args, kw = out["ba_global_args"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        poses, patches = ba.ba_global(*args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    ok = bool(torch.isfinite(poses).all() and torch.isfinite(patches).all())
    log(f"[lc] ba_global under sync debug mode \"error\": {args[6].shape[0]}"
        f" edges ({int(args[9].sum())} valid), n_cap={kw['n_cap']}, "
        f"k_cap={kw['k_cap']}: no host synchronisation, finite "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("ba_global gave non-finite poses or depths")


# --- phase 6: training -------------------------------------------------------

# card against CPU at N=5, 64x96, M=4, 3 iterations, fp32 with TF32 off:
# loss, metrics and gnorm rtol, set from the readings of one codebase on
# two devices (worst 3.5e-5, 1.4e-4 and 4.3e-5 in three runs on an H100
# 80GB HBM3 at 700 W) and below what the same run with TF32 on gives (the
# control, which must break a limit: 1.7e-2 and 5.9e-2 read); per leaf,
# the L2 share by which the two steps' parameter updates may differ (read
# 2.9e-2 to 3.6e-2, 0.28-0.29 with TF32 on: Adam's first updates are
# lr * sign(g) wherever |g| is at the rounding level)
TOL_TRAIN = 1e-3
TOL_TRAIN_UPDATE = 0.1
TRAIN_SMALL = dict(N=5, H=64, W=96, M=4, iters=3)
# configs/tartan_train.yaml's step
TRAIN_FULL = dict(N=15, H=480, W=640, M=80, iters=18)
TRAIN_EDGES = 18000   # its rollout's edge slots: 5120 at iteration 0
TRAIN_FX = 320.0      # TartanAir's focal length at 640x480


def train_clip(seed, N, H, W, roll=2, depth=2.0):
    """One synthetic TartanAir-like clip as the readers return it (BGR
    float images, world-from-camera poses, disparities, intrinsics, with
    the 0.7 * q98 normalisation): a smooth texture rolled ``roll`` px per
    frame, seen at constant depth by a camera moving sideways by
    roll * depth / fx per frame, so the GT poses and disparities induce
    exactly the images' flow."""
    rng = np.random.default_rng(seed)
    tex = rng.uniform(0, 255, (H, W + roll * N + 8, 3))
    for axis in (0, 1):                       # a 5x5 box blur
        tex = sum(np.roll(tex, k, axis=axis) for k in range(-2, 3)) / 5.0
    images = np.stack([tex[:, roll * t:roll * t + W] for t in range(N)])
    poses = np.zeros((N, 7), np.float32)
    poses[:, 6] = 1.0
    poses[:, 0] = np.arange(N) * roll * depth / TRAIN_FX * (W / 640.0)
    disps = np.full((N, H, W), 1.0 / depth, np.float32)
    s = 0.7 * np.quantile(disps, 0.98)
    poses[:, :3] *= s
    intr = np.tile(np.float32([TRAIN_FX * W / 640.0, TRAIN_FX * W / 640.0,
                               W / 2.0, H / 2.0]), (N, 1))
    return (images[None].astype(np.float32), poses[None], (disps / s)[None],
            intr[None])


def train_state(dev, seed, lr=8e-5, total=240000):
    """Modules with the flax-like initialisers drawn on the CPU from
    ``seed`` (so card and CPU share them), AdamW with the one-cycle
    schedule, on ``dev``."""
    import torch
    from dpvo_tpu_torch.models.update import Update
    from dpvo_tpu_torch.models.vonet import Patchifier, init_flax_like
    from dpvo_tpu_torch.parallel import train_step as ts
    gen = torch.Generator().manual_seed(seed)
    p = init_flax_like(Patchifier(3), gen).to(dev)
    u = init_flax_like(Update(3), gen).to(dev)
    opt = ts.make_optimizer(ts.train_params(p, u), lr, total,
                            weight_decay=1e-6, clip=10.0)
    return ts.TrainState(p, u, opt)


def train_batches(n, seed, N, H, W, M, iters, dev):
    """``n`` prepared batches of one clip (``train_torch.prepare_batch``'s
    draws from one numpy seed), on ``dev``."""
    import train_torch
    clip = train_clip(seed, N, H, W)
    rng = np.random.default_rng(seed)
    return [train_torch.to_device(train_torch.prepare_batch(
        rng, *clip, M, iters), dev) for _ in range(n)]


def params_of(state):
    from dpvo_tpu_torch.parallel.train_step import train_params
    return [p.detach().clone() for p in train_params(state.patchifier,
                                                     state.update)]


def train_agreement_run(d, tf32):
    """A structure-only step, a full step and an eval step on ``d`` with
    TF32 on or off (cuBLAS and cuDNN): (metrics per step, parameters
    before, parameters after, parameter names)."""
    import torch
    from dpvo_tpu_torch.parallel import train_step as ts
    cfg = TRAIN_SMALL
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        state = train_state(d, seed=3, lr=1e-4, total=100)
        before = params_of(state)
        batches = train_batches(3, 4, cfg["N"], cfg["H"], cfg["W"],
                                cfg["M"], cfg["iters"], d)
        metrics = []
        for so, batch in zip((True, False), batches):
            step = ts.make_train_step(steps=cfg["iters"], M=cfg["M"],
                                      structure_only=so)
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        _, em = ts.make_eval_step(steps=cfg["iters"], M=cfg["M"])(
            state, batches[2])
        metrics.append({k: float(v) for k, v in em.items()})
        names = [f"{pre}.{n}" for pre, m in state.modules().items()
                 for n, _ in m.named_parameters()]
        return metrics, before, params_of(state), names
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def train_errors(run, ref):
    """The worst metric rel err of ``run`` against ``ref`` (name, step,
    value; a non-finite metric reads inf) and the worst per-leaf parameter
    update rel err (name, value)."""
    (m_a, p0, p_a, names), (m_b, _, p_b, _) = run, ref
    metric = ("", -1, 0.0)
    for i, (a, b) in enumerate(zip(m_a, m_b)):
        for k in b:
            err = (abs(a[k] - b[k]) / max(abs(b[k]), 1e-5 / TOL_TRAIN)
                   if np.isfinite(a[k]) else float("inf"))
            if err > metric[2]:
                metric = (k, i, err)
    lr_sum = 1e-4 / 25 + 1e-4          # the first two one-cycle rates
    upd = ("", 0.0)
    for n, a, b, x0 in zip(names, p_a, p_b, p0):
        if n.startswith("patchify.fnet.") and n.endswith(".bias") and (
                n != "patchify.fnet.conv2.bias"):
            continue          # an instance norm follows: exact gradient 0
        da, db = a.cpu() - x0.cpu(), b - x0.cpu()
        ref_n = max(float(db.norm()), 0.1 * lr_sum * db.numel() ** 0.5)
        rel = float((da - db).norm()) / ref_n
        if rel > upd[1]:
            upd = (n, rel)
    return metric, upd


def train_agreement(dev):
    """fp32, TF32 off: a structure-only step, a full step and an eval step
    on the card against the same on the CPU, from the same weights and
    batches; then the card with TF32 on, the control that must break a
    limit."""
    import torch
    cfg = TRAIN_SMALL
    cpu = train_agreement_run(torch.device("cpu"), False)
    card = train_agreement_run(dev, False)
    (k, i, worst), (n, upd) = train_errors(card, cpu)
    if worst > TOL_TRAIN:
        raise SystemExit(f"train step {i} {k}: card {card[0][i][k]} cpu "
                         f"{cpu[0][i][k]} (rel err {worst:.3e})")
    if upd > TOL_TRAIN_UPDATE:
        raise SystemExit(f"train: parameter {n} moved differently on the "
                         f"card ({upd:.3e} of its update)")
    log(f"[train] agreement card vs CPU (N={cfg['N']}, {cfg['H']}x"
        f"{cfg['W']}, M={cfg['M']}, {cfg['iters']} iterations, fp32, TF32 "
        f"off; structure-only step, full step, eval step): worst metric "
        f"rel err {worst:.3e} ({k}, step {i}; tol {TOL_TRAIN}), worst "
        f"parameter update rel err {upd:.3e} ({n}; tol {TOL_TRAIN_UPDATE}); "
        f"loss card {card[0][1]['loss']:.6f} cpu {cpu[0][1]['loss']:.6f}, "
        f"gnorm card {card[0][1]['gnorm']:.6f} cpu "
        f"{cpu[0][1]['gnorm']:.6f} OK")
    (k, i, worst), (n, upd) = train_errors(
        train_agreement_run(dev, True), cpu)
    log(f"[train] control, the card with TF32 on vs CPU: worst metric rel "
        f"err {worst:.3e} ({k}, step {i}; {worst / TOL_TRAIN:.1f}x tol), "
        f"worst parameter update rel err {upd:.3e} ({n}; "
        f"{upd / TOL_TRAIN_UPDATE:.1f}x tol)")
    if worst <= TOL_TRAIN and upd <= TOL_TRAIN_UPDATE:
        raise SystemExit("train: the limits do not catch TF32 in the fp32 "
                         "rollout (the control stayed within them)")


def train_full_width(dev):
    """configs/tartan_train.yaml's step at full width with bf16 autocast:
    one structure-only step, three full steps, one profiled full step, one
    eval rollout and ``validate`` on it."""
    import torch
    from dpvo_tpu_torch.parallel import train_step as ts
    from dpvo_tpu_torch.training.validate import validate
    cfg = TRAIN_FULL
    state = train_state(dev, seed=0)
    batches = train_batches(6, 5, cfg["N"], cfg["H"], cfg["W"], cfg["M"],
                            cfg["iters"], dev)
    E = len(batches[0]["sch_ii"])
    log(f"[train] full width: {cfg['H']}x{cfg['W']}, N={cfg['N']}, "
        f"M={cfg['M']}, {cfg['iters']} iterations, batch 1, bf16 autocast, "
        f"flax-like seeded weights; rollout edges {E}, live at iteration 0 "
        f"{int(batches[0]['sch_active'][0].sum())}")
    if E != TRAIN_EDGES:
        raise SystemExit(f"train: the full-width rollout has {E} edges, "
                         f"not {TRAIN_EDGES}")
    steps = {so: ts.make_train_step(steps=cfg["iters"], M=cfg["M"],
                                    structure_only=so, amp=True)
             for so in (True, False)}
    times = []
    for i, so in enumerate((True, False, False, False)):
        before = params_of(state)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, m = steps[so](state, batches[i])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        moved = float(torch.sqrt(sum(((a - b).float() ** 2).sum() for a, b in
                                     zip(params_of(state), before))))
        loss, gnorm = float(m["loss"]), float(m["gnorm"])
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        times.append(ms)
        log(f"[train] step {i} ({'structure-only' if so else 'full'}): "
            f"{ms:.1f} ms, loss {loss:.6f}, gnorm {gnorm:.6f}, flow_err "
            f"{float(m['flow_err']):.4f}, tr {float(m['tr']):.5f}, ro "
            f"{float(m['ro']):.5f}, parameter change (L2) {moved:.4e}, peak "
            f"memory {peak:.2f} GiB")
        if not (np.isfinite(loss) and np.isfinite(gnorm) and gnorm > 0
                and moved > 0):
            raise SystemExit(f"train: step {i} gave loss {loss}, gnorm "
                             f"{gnorm}, parameter change {moved}")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = steps[False](state, batches[4])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    log(f"[train] profiled full step (loss {float(m['loss']):.6f}): "
        + device_profile(prof, ms, 1, top=10, unit="step"))
    eval_step = ts.make_eval_step(steps=cfg["iters"], M=cfg["M"], amp=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est, em = eval_step(state, batches[5])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    stats = validate(lambda s: {"poses": est[0].cpu().numpy()},
                     [{"poses": batches[5]["poses"][0].cpu().numpy()}])
    if not (torch.isfinite(est).all() and np.isfinite(stats["val/ate_mean"])):
        raise SystemExit("train: the eval rollout gave non-finite poses")
    log(f"[train] eval rollout {ms:.1f} ms: flow_err "
        f"{float(em['flow_err']):.4f}, tr {float(em['tr']):.5f}; validate: "
        f"{stats}")
    log(f"[train] ms per full-width step: structure-only {times[0]:.1f} "
        f"(first call), full {times[1]:.1f} (first) {times[2]:.1f} "
        f"{times[3]:.1f}")


def phase_train(dev):
    """Training (``train_torch.py``'s step): no hand-written kernel may
    launch, since the training path has none."""
    from dpvo_tpu_torch.ops import _cuda
    t0 = time.perf_counter()
    before = dict(_cuda.launches)
    train_agreement(dev)
    train_full_width(dev)
    if dict(_cuda.launches) != before:
        raise SystemExit(f"train: hand-written kernels launched during the "
                         f"training phase: {before} -> {_cuda.launches}")
    log(f"[train] no hand-written kernel launched; phase "
        f"{time.perf_counter() - t0:.1f} s")


# --- phase 7: the evaluation harness with a reference .pth -------------------

EVAL_OVERRIDES = dict(EDGE_CAPACITY_INAC=1 << 18)
EVAL_FRAMES = 64
EVAL_PROBE_REFUSALS = 4   # natural motion-probe refusals before forcing it


def reference_state_dict(gen):
    """A state dict with the reference VONet's names and shapes (its
    trained ``dpvo.pth`` layout: ``module.`` prefixes, ``update.lmbda``),
    weights uniform in +-1/sqrt(fan_in) drawn from ``gen`` (CPU)."""
    import torch
    sd = {}

    def put(name, *shape, fan_in):
        sd[f"module.{name}"] = (torch.rand(shape, generator=gen) * 2 - 1
                                ) / fan_in ** 0.5

    def conv(name, cin, cout, k):
        put(f"{name}.weight", cout, cin, k, k, fan_in=cin * k * k)
        put(f"{name}.bias", cout, fan_in=cin * k * k)

    def lin(name, cin, cout):
        put(f"{name}.weight", cout, cin, fan_in=cin)
        put(f"{name}.bias", cout, fan_in=cin)

    def ln(name, d):
        sd[f"module.{name}.weight"] = 1 + 0.1 * torch.randn(d, generator=gen)
        put(f"{name}.bias", d, fan_in=d)

    for enc, outd in (("patchify.fnet", 128), ("patchify.inet", 384)):
        conv(f"{enc}.conv1", 3, 32, 7)
        for layer, cin, cout in (("layer1.0", 32, 32), ("layer1.1", 32, 32),
                                 ("layer2.0", 32, 64), ("layer2.1", 64, 64)):
            conv(f"{enc}.{layer}.conv1", cin, cout, 3)
            conv(f"{enc}.{layer}.conv2", cout, cout, 3)
        conv(f"{enc}.layer2.0.downsample.0", 32, 64, 1)
        conv(f"{enc}.conv2", 64, outd, 1)
    lin("update.corr.0", 2 * 49 * 9, 384)
    lin("update.corr.2", 384, 384)
    ln("update.corr.3", 384)
    lin("update.corr.5", 384, 384)
    ln("update.norm", 384)
    for name in ("c1", "c2"):
        lin(f"update.{name}.0", 384, 384)
        lin(f"update.{name}.2", 384, 384)
    for agg in ("agg_kk", "agg_ij"):
        for name in ("f", "g", "h"):
            lin(f"update.{agg}.{name}", 384, 384)
    for gru, norm in (("gru.1", "gru.0"), ("gru.3", "gru.2")):
        ln(f"update.{norm}", 384)
        lin(f"update.{gru}.gate.0", 384, 384)
        lin(f"update.{gru}.res.0", 384, 384)
        lin(f"update.{gru}.res.2", 384, 384)
    lin("update.d.1", 384, 2)
    lin("update.w.1", 384, 2)
    sd["module.update.lmbda"] = torch.ones(1)
    return sd


def check_loaded(slam, sd):
    """The engine's module tensors against the synthesized ones, renamed
    back by hand: -> the number of tensors compared (all must be equal)."""
    import torch
    enc = {f"layer{i}.{b}.": f"layer{i}_{b}." for i in (1, 2)
           for b in (0, 1)}
    upd = {"corr.0.": "corr1.", "corr.2.": "corr2.", "corr.3.": "corr_norm.",
           "corr.5.": "corr3.", "c1.0.": "c1_0.", "c1.2.": "c1_1.",
           "c2.0.": "c2_0.", "c2.2.": "c2_1.", "gru.0.": "gru_norm1.",
           "gru.1.gate.0.": "gru_res1.gate.", "gru.1.res.0.":
           "gru_res1.res1.", "gru.1.res.2.": "gru_res1.res2.",
           "gru.2.": "gru_norm2.", "gru.3.gate.0.": "gru_res2.gate.",
           "gru.3.res.0.": "gru_res2.res1.", "gru.3.res.2.":
           "gru_res2.res2.", "d.1.": "d.", "w.1.": "w."}
    mine = {**{f"patchify.{k}": v for k, v in
               slam.patchifier.state_dict().items()},
            **{f"update.{k}": v for k, v in
               slam.update_mod.state_dict().items()}}
    n = 0
    for key, want in sd.items():
        key = key.removeprefix("module.")
        if key == "update.lmbda":
            continue
        key = key.replace("downsample.0.", "downsample.")
        for a, b in {**enc, **upd}.items():
            key = key.replace(f".{a}", f".{b}", 1)
        got = mine.pop(key)
        if not torch.equal(got.float().cpu(), want.to(got.dtype).float()):
            raise SystemExit(f"the .pth tensor {key} did not load as "
                             f"written")
        n += 1
    if mine:
        raise SystemExit(f"engine tensors the .pth did not set: "
                         f"{sorted(mine)}")
    return n


@contextlib.contextmanager
def eval_engines(adapt):
    """Route the harness's ``DPVO`` through ``adapt(slam)`` and keep every
    engine it builds in the yielded list."""
    from dpvo_tpu_torch.utils import evaluation
    built, make = [], evaluation.DPVO

    def build(*args, **kw):
        built.append(adapt(make(*args, **kw)))
        return built[-1]

    evaluation.DPVO = build
    try:
        yield built
    finally:
        evaluation.DPVO = make


def eval_small_agreement(dev):
    """The harness's engine loop at the small size (fp32, never merging,
    the small drives' seams and weights) on the card against the CPU."""
    import torch
    import evaluate_tartan_torch as ev
    from dpvo_tpu_torch.config import VOConfig
    thresh, atol_t, atol_q = AGREE["never_merge"]
    cfg = VOConfig(**{**SMALL, "KEYFRAME_THRESH": thresh})
    network = small_network()
    runs = []
    for d in (dev, torch.device("cpu")):
        frames = ((t, img, SMALL_INTR) for t, img in enumerate(small_frames()))
        with eval_engines(small_seams):
            runs.append(ev.run_frames(cfg, network, frames, d))
    (p_gpu, t_gpu), (p_cpu, t_cpu) = runs
    err_t, err_q = pose_errors(p_gpu, p_cpu)
    ok = (np.array_equal(t_gpu, t_cpu) and np.isfinite(p_gpu).all()
          and err_t <= atol_t and err_q <= atol_q)
    log(f"[eval] small engine loop ({len(p_gpu)} frames, fp32) card against "
        f"CPU: max|dt|={err_t:.3e} (tol {atol_t}) 1-min|q.q'|={err_q:.3e} "
        f"(tol {atol_q}) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the harness's engine loop on the card disagrees "
                         "with the CPU")


def phase_eval(dev, n_frames=EVAL_FRAMES, ht=480, wd=640):
    """evaluate_tartan_torch's engine loop and scoring at full width:
    configs/default.yaml (LOOP_CLOSURE, bf16, lagged keyframing) with
    EVAL_OVERRIDES, weights from a reference-layout .pth synthesized from a
    seeded generator, a rolled-texture scene held in memory with GT poses
    in TartanAir's NED layout.  The motion probe runs as it is; after
    EVAL_PROBE_REFUSALS refusals (random weights may never pass it) it is
    forced, and the line says so.  Launch counts zeroed just before the
    drive and read just after; K2, K3 and K4 must launch."""
    import torch
    import evaluate_tartan_torch as ev
    from dpvo_tpu_torch.config import VOConfig
    from dpvo_tpu_torch.ops import _cuda
    from dpvo_tpu_torch.utils.evaluation import load_tartan_pose_file
    t_phase = time.perf_counter()
    eval_small_agreement(dev)
    path = Path(__file__).resolve().parent / "configs" / "default.yaml"
    cfg = VOConfig().merge_yaml(str(path)).replace(**EVAL_OVERRIDES)
    sd = reference_state_dict(torch.Generator().manual_seed(0))
    base = np.random.default_rng(0).integers(0, 255, (ht, 2 * wd, 3),
                                             dtype=np.uint8)
    frames = [np.ascontiguousarray(np.roll(base, -4 * t, axis=1)[:, :wd])
              for t in range(n_frames)]
    ned = np.zeros((n_frames, 7))
    ned[:, 1] = 0.05 * np.arange(n_frames)         # east: the world's x
    ned[:, 6] = 1.0
    refused, ticks = [], []

    def adapt(slam):
        probe = slam.motion_probe

        def motion_probe():
            if len(refused) >= EVAL_PROBE_REFUSALS:
                return 100.0
            m = probe()
            if m < 2.0:
                refused.append(m)
            return m

        slam.motion_probe = motion_probe
        counters["attach"](slam)
        return slam

    def timed():
        for t, img in enumerate(frames):
            stream_sync()
            ticks.append(time.perf_counter())
            yield t, img, ev.INTRINSICS
        stream_sync()
        ticks.append(time.perf_counter())

    with tempfile.TemporaryDirectory() as tmp:
        weights = Path(tmp) / "dpvo.pth"
        torch.save(sd, weights)
        np.savetxt(Path(tmp) / "pose_left.txt", ned, delimiter=" ")
        traj_ref = load_tartan_pose_file(str(Path(tmp) / "pose_left.txt"))
        stream_sync()
        torch.cuda.reset_peak_memory_stats()
        _cuda.reset_launches()
        with lc_counters() as counters, eval_engines(adapt) as built:
            poses, tstamps = ev.run_frames(cfg, str(weights), timed(), dev)
        stream_sync()
        launches = dict(_cuda.launches)
    (slam,) = built
    n_loaded = check_loaded(slam, sd)
    mem = torch.cuda.max_memory_allocated() / 2**30
    ate = ev.score(poses, traj_ref)
    auc, avg = ev.summarize({"synthetic": ate})
    ms = sorted(np.diff(ticks)[20:-1] * 1e3)
    probe = ("natural" if len(refused) < EVAL_PROBE_REFUSALS else
             f"forced after {len(refused)} refusals (values "
             + ", ".join(f"{m:.3f}" for m in refused) + ")")
    log(f"[eval] {ht}x{wd} configs/default.yaml (LOOP_CLOSURE="
        f"{cfg.LOOP_CLOSURE}, M={cfg.PATCHES_PER_FRAME}, MIXED_PRECISION="
        f"{cfg.MIXED_PRECISION}, ASYNC_KEYFRAME={cfg.ASYNC_KEYFRAME}) with "
        f"{EVAL_OVERRIDES}; weights from a reference-layout .pth ({len(sd)} "
        f"entries, {n_loaded} tensors loaded as written); motion probe "
        f"{probe}; {n_frames} frames, median {ms[len(ms) // 2]:.2f} ms/frame "
        f"(frames 20..{n_frames - 2}, max {ms[-1]:.2f}), keyframes "
        f"{slam.n}, global BA calls {len(counters['global_ms'])} (ba_global "
        f"{counters['ba_global']}), proposals (n, pairs) "
        f"{counters['proposals']}; ATE {ate:.4f} AUC {auc:.4f} AVG "
        f"{avg:.4f}; max_memory_allocated {mem:.2f} GiB; launches "
        f"{launches}; phase {time.perf_counter() - t_phase:.1f} s")
    expect, absent = PATH_KERNELS[13]
    ok = (poses.shape == (n_frames, 7) and np.isfinite(poses).all()
          and len(tstamps) == n_frames and np.isfinite(ate)
          and all(launches.get(k, 0) > 0 for k in expect)
          and not any(launches.get(k, 0) for k in absent))
    if not ok:
        raise SystemExit(f"the evaluation drive failed: poses finite "
                         f"{np.isfinite(poses).all()}, ATE {ate}, launches "
                         f"{launches}")
    return dict(launches=launches, ms=ms[len(ms) // 2])


# --- phase 8: the classic loop-closure backend -----------------------------

PGO_POSES = 2000
# PGO card against CPU: within PGO_SPREADS times the CPU's own spread when
# the poses move by 1e-6.  The LM result is that sensitive (100 CG steps do
# not converge on a long chain): on the CPU the spread is 1.6e-3 to 6.1e-3
# at 2000 poses, and the JAX package's own 1.6e-4 to 4.9e-4 at 40-300
PGO_SPREADS = 3.0
TRIANGULATE_K = 1024
TOL_POINTS = 1e-4
TOL_MERGE = 1e-5


def drifted_loop(n, seed=2, noise=0.01):
    """A circle of n poses with drifted odometry and one Sim3 loop factor
    between the last and the first pose (tests/test_loop_closure.py's)."""
    import torch
    from dpvo_tpu_torch.ops import lie
    rng = np.random.default_rng(seed)
    ang = np.linspace(0, 2 * np.pi, n)
    gt = torch.zeros((n, 7))
    gt[:, 0] = torch.from_numpy(np.cos(ang))
    gt[:, 1] = torch.from_numpy(np.sin(ang))
    gt[:, 6] = 1.0
    noise = lie.se3_exp(torch.from_numpy(rng.normal(size=(n, 6)) * noise)
                        .float())
    rel = lie.se3_mul(gt[1:], lie.se3_inv(gt[:-1]))
    drift = [gt[0]]
    for i in range(1, n):
        drift.append(lie.se3_mul(lie.se3_mul(noise[i], rel[i - 1]),
                                 drift[-1]))
    C = lie.sim3_mul(lie.sim3_inv(lie.se3_to_sim3(gt[0])),
                     lie.se3_to_sim3(gt[n - 1]))
    return torch.stack(drift).numpy(), C[None].numpy()


def pgo_worker_startup(dev):
    """The classic backend's spawned PGO worker on the card: a fresh pool's
    first run_pgo (process start, imports, CUDA context, the work) and the
    same call again; -> (first, second) seconds."""
    import multiprocessing as mp
    from dpvo_tpu_torch.loop_closure.pgo import run_pgo
    poses, C = drifted_loop(64)
    args = (poses, C, np.array([63]), np.array([0]), 30, str(dev))
    times = []
    with mp.get_context("spawn").Pool(1) as pool:
        for _ in range(2):
            t0 = time.perf_counter()
            out = pool.apply_async(run_pgo, args).get(timeout=300)
            times.append(time.perf_counter() - t0)
            if not np.isfinite(out).all():
                raise SystemExit("run_pgo in the worker gave non-finite poses")
    return times


def phase_classic(dev):
    """The classic backend's device work, card against CPU: PGO at
    PGO_POSES poses, the structure-only BA of estimate_3d_keypoints at
    TRIANGULATE_K keypoints (K4 launched and held against its plain
    version), the merge of a Sim3 correction into an engine; the spawned
    worker's start-up; and the construction rule for cv2."""
    import torch
    from dpvo_tpu_torch.config import VOConfig
    from dpvo_tpu_torch.engine import DPVO
    from dpvo_tpu_torch.loop_closure import long_term, pgo
    from dpvo_tpu_torch.ops import _cuda, lie
    t_phase = time.perf_counter()
    cpu = torch.device("cpu")

    # PGO
    poses, C = drifted_loop(PGO_POSES)
    args = (poses, C, np.array([PGO_POSES - 1]), np.array([0]))
    outs, ms = {}, {}
    for name, d in (("card", dev), ("cpu", cpu), ("card", dev)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = pgo.perform_updates(*args, device=d).cpu()
        torch.cuda.synchronize()
        ms.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        outs[name] = lie.sim3_mul(lie.sim3_inv(o[0])[None], o).numpy()
    err = float(np.abs(outs["card"][:, :3] - outs["cpu"][:, :3]).max())
    jitter = np.random.default_rng(3).normal(size=poses.shape) * 1e-6
    o = pgo.perform_updates(poses + jitter.astype(np.float32), *args[1:],
                            device=cpu)
    o = lie.sim3_mul(lie.sim3_inv(o[0])[None], o).numpy()
    spread = float(np.abs(o[:, :3] - outs["cpu"][:, :3]).max())
    before = lie.se3_to_sim3(torch.from_numpy(poses))
    before = lie.sim3_mul(lie.sim3_inv(before[0])[None], before).numpy()
    moved = float(np.abs(outs["card"][:, :3] - before[:, :3]).max())
    startup = pgo_worker_startup(dev)
    ok = (np.isfinite(outs["card"]).all() and err <= PGO_SPREADS * spread
          and moved > 0.01)
    log(f"[classic] PGO {PGO_POSES} poses + 1 loop factor: card "
        f"{ms['card'][0]:.1f} ms first call, {ms['card'][1]:.1f} ms second; "
        f"CPU {ms['cpu'][0]:.1f} ms; corrected translations card against "
        f"CPU {err:.3e}, the CPU against itself with the poses moved by "
        f"1e-6 {spread:.3e} (tol {PGO_SPREADS} x that), moved up to "
        f"{moved:.3f} by the loop {'OK' if ok else 'FAIL'}; spawned worker "
        f"on the card: first "
        f"run_pgo (64 poses) {startup[0]:.2f} s, second {startup[1]:.2f} s, "
        f"start-up {startup[0] - startup[1]:.2f} s")
    if not ok:
        raise SystemExit("PGO on the card disagrees with the CPU")

    # structure-only BA: synthetic points projected into three poses
    rng = np.random.default_rng(0)
    K = TRIANGULATE_K
    X = np.stack([rng.uniform(-1, 1, K), rng.uniform(-0.75, 0.75, K),
                  rng.uniform(1.5, 3.0, K)], -1).astype(np.float32)
    poses3 = np.zeros((3, 7), np.float32)
    poses3[:, 0] = [0.1, 0.0, -0.1]
    poses3[:, 3:7] = lie.so3_exp(torch.tensor(
        [[0, 0.02, 0], [0, 0, 0], [0.01, -0.02, 0]])).numpy()
    intr = np.array([120.0, 120.0, 80.0, 60.0], np.float32)
    cam = lie.se3_act(torch.from_numpy(poses3)[:, None],
                      torch.from_numpy(X)[None]).numpy()
    uv = intr[:2] * cam[..., :2] / cam[..., 2:] + intr[2:]
    targets = np.stack([uv[0], uv[2]], 1)
    ms_ba = []
    for _ in range(2):        # the first call pays the solver's first use
        _cuda.reset_launches()
        with last_calls() as last:
            t0 = time.perf_counter()
            pts = long_term.triangulate(
                torch.from_numpy(poses3).to(dev),
                torch.from_numpy(intr).to(dev), uv[1], targets)
            torch.cuda.synchronize()
            ms_ba.append((time.perf_counter() - t0) * 1e3)
    k4 = _cuda.launches["segment_sums"]
    vals, gid, g_cap = last["segment_sums"]
    seg_err, seg_ord, seg_ok = check_segment_sums(vals, gid, g_cap)
    want = long_term.triangulate(torch.from_numpy(poses3),
                                 torch.from_numpy(intr), uv[1], targets)
    err = float(np.abs(pts - want).max())
    truth = float(np.abs(pts - X).max())
    ok = err <= TOL_POINTS and k4 == 6 and seg_ok and truth < 1e-2
    log(f"[classic] structure-only BA (triangulate, {K} keypoints x 2 edges, "
        f"6 iterations): card {ms_ba[0]:.1f} ms first call, {ms_ba[1]:.1f} "
        f"ms second (K4 counted in the second), points card against CPU "
        f"{err:.3e} (tol {TOL_POINTS}), from the true points {truth:.3e}; "
        f"K4 launches {k4}, at its last call E={len(gid)} g_cap={g_cap} "
        f"max_abs_err {seg_err:.3e} against the plain version, "
        f"{seg_ord:.3e} against the row-order reference (must be 0) "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the structure-only BA disagrees between the card "
                         "and the CPU, or K4 disagrees with its plain version")

    # lc_callback's merge, on a card engine and a CPU engine
    M, n, m = 8, 24, 20
    gen = np.random.default_rng(1)
    q = gen.normal(size=(n, 4)) * [0.1, 0.1, 0.1, 1.0]
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    state = np.concatenate([gen.normal(size=(n, 3)), q], 1).astype(
        np.float32)
    depths = gen.uniform(0.2, 2.0, (n * M, 3, 3)).astype(np.float32)
    sim = np.concatenate([state[:m] + 0.01 * gen.normal(size=(m, 7)),
                          gen.uniform(0.8, 1.2, (m, 1))], 1).astype(
        np.float32)
    sim[:, 3:7] /= np.linalg.norm(sim[:, 3:7], axis=1, keepdims=True)
    merged = []
    for d in (dev, cpu):
        slam = DPVO(VOConfig(**SMALL), ht=SMALL_HW[0], wd=SMALL_HW[1],
                    device=d)
        slam.ds.poses[:n] = torch.from_numpy(state).to(d)
        slam.ds.patches[:n * M, 2] = torch.from_numpy(depths).to(d)
        slam.n, slam.m = n, n * M
        lc = object.__new__(long_term.LongTermLoopClosure)
        lc.slam, lc.pending = slam, []
        lc.merge(sim)
        merged.append((slam.ds.poses[:n].cpu().numpy(),
                       slam.ds.patches[:n * M, 2].cpu().numpy()))
    (p_gpu, d_gpu), (p_cpu, d_cpu) = merged
    err_p = float(np.abs(p_gpu - p_cpu).max())
    err_d = float(np.abs(d_gpu - d_cpu).max())
    ok = err_p <= TOL_MERGE and err_d <= TOL_MERGE
    log(f"[classic] lc_callback merge of a Sim3 correction ({m} of {n} "
        f"keyframes): poses card against CPU {err_p:.3e}, depths "
        f"{err_d:.3e} (tol {TOL_MERGE}) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the merge on the card disagrees with the CPU")

    # construction: cv2 present -> the small classic drive on the card;
    # absent -> an ImportError naming cv2
    try:
        import cv2  # noqa: F401
    except ImportError:
        try:
            DPVO(VOConfig(**SMALL, CLASSIC_LOOP_CLOSURE=True),
                 ht=SMALL_HW[0], wd=SMALL_HW[1], device=dev)
        except ImportError as e:
            if "cv2" not in str(e):
                raise
            log(f"[classic] no cv2 on this machine: DPVO(..., "
                f"CLASSIC_LOOP_CLOSURE=True, device='cuda') raises "
                f"ImportError({str(e)!r}) OK")
        else:
            raise SystemExit("CLASSIC_LOOP_CLOSURE constructed without cv2")
    else:
        classic_drive(dev)
    log(f"[classic] phase {time.perf_counter() - t_phase:.1f} s")


def classic_drive(dev, ht=96, wd=128, roll=4, period=64, n_frames=60):
    """tests/test_torch_classic_engine.py's drive on the card: a texture
    whose roll repeats every 64 frames; retrieval must find the place
    again and a pose-graph result must be merged."""
    import cv2
    import torch
    from dpvo_tpu_torch.config import VOConfig
    from dpvo_tpu_torch.engine import DPVO
    cfg = VOConfig(**{**SMALL, "BUFFER_SIZE": 128, "KEYFRAME_THRESH": 0.0,
                      "EDGE_CAPACITY": 1024, "CLASSIC_LOOP_CLOSURE": True})
    slam = DPVO(cfg, ht=ht, wd=wd, device=dev)
    with torch.no_grad():
        slam.update_mod.d.weight.mul_(0.02)
        slam.update_mod.d.bias.mul_(0.02)
    slam.motion_probe = lambda: 100.0
    lc, merged = slam.long_term_lc, []
    merge = lc.merge
    lc.merge = lambda c: (merged.append(len(c)), merge(c))
    base = cv2.GaussianBlur(np.random.default_rng(7).integers(
        0, 255, (ht, roll * period, 3), np.uint8), (5, 5), 0)
    intr = np.array([wd / 2, wd / 2, wd / 2, ht / 2])
    for t in range(n_frames):
        slam(t, np.ascontiguousarray(np.roll(base, -roll * t, 1)[:, :wd]),
             intr)
    poses, _ = slam.terminate()
    ok = bool(lc.retrieval.found and merged and np.isfinite(poses).all())
    log(f"[classic] cv2 {cv2.__version__} present: the small classic drive "
        f"on the card, {n_frames} "
        f"frames: loops found {lc.retrieval.found}, merged PGO results of "
        f"{merged} poses, poses finite {np.isfinite(poses).all()} "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the classic drive on the card closed no loop")


# --- phase 9: Redwood fine-tuning (train_torch at configs/redwood_train.yaml)

REDWOOD_FRAMES = 72      # the readers index frames < len - 65
REDWOOD_HW = (480, 640)
REDWOOD_FX = 320.0
REDWOOD_DEPTH_MM = 2000.0
REDWOOD_STEP = 0.15      # m per frame: fx * step / depth = 24 px of flow
TRAIN_REDWOOD_SMALL = dict(n_frames=5, crop=(64, 96), M=4, iters=3)
REDWOOD_SEEDS = (1, 2, 3)   # samples of the card-against-CPU step
# gnorm's limit over the most that summation order alone moved it in the
# run: on these samples the CPU at another thread count, or the card
# twice, moves gnorm by up to ~2.4e-3 (PERF.md section 6), past TOL_TRAIN
REDWOOD_ORDER_FACTOR = 3.0
REDWOOD_THREADS = (8, 4, 2, 1)   # the CPU's runs; the first is the reference


def redwood_tree(root, n=REDWOOD_FRAMES, hw=REDWOOD_HW):
    """A synthetic Redwood tree as tests/test_redwood_data.py writes it, at
    full width: root/train/scene01/{image/*.jpg, depth/*.png (uint16 mm),
    scene01.json (column-major 4x4 node poses)} and root/intrinsic.npy; a
    smooth texture rolled by the flow the poses and depths induce."""
    import cv2
    H, W = hw
    scene = Path(root) / "train" / "scene01"
    (scene / "image").mkdir(parents=True)
    (scene / "depth").mkdir()
    K = np.array([[REDWOOD_FX, 0.0, W / 2], [0.0, REDWOOD_FX, H / 2],
                  [0.0, 0.0, 1.0]])
    np.save(Path(root) / "intrinsic.npy", K)
    roll = int(round(REDWOOD_FX * REDWOOD_STEP * 1000.0 / REDWOOD_DEPTH_MM))
    base = np.random.default_rng(3).integers(
        0, 255, (H, W + roll * n, 3), dtype=np.uint8)
    base = cv2.GaussianBlur(base, (5, 5), 0)
    depth = (np.full((H, W), REDWOOD_DEPTH_MM)
             + 100.0 * np.sin(np.arange(W) / 7.0)[None]).astype(np.uint16)
    nodes = []
    for t in range(n):
        img = np.ascontiguousarray(base[:, roll * t:roll * t + W])
        cv2.imwrite(str(scene / "image" / f"{t:06d}.jpg"), img)
        cv2.imwrite(str(scene / "depth" / f"{t:06d}.png"), depth)
        T = np.eye(4)
        T[0, 3] = REDWOOD_STEP * t
        nodes.append({"pose": T.T.flatten().tolist()})
    with open(scene / "scene01.json", "w") as f:
        json.dump({"nodes": nodes}, f)
    return str(root)


def redwood_config(root, ckpt, **training):
    """configs/redwood_train.yaml with the tree, the checkpoint and the
    loader's workers overridden (each override printed by the caller)."""
    from dpvo_tpu_torch.config import load_train_config
    path = Path(__file__).resolve().parent / "configs" / "redwood_train.yaml"
    cfg = load_train_config(str(path))
    cfg["dataset"]["roots"] = [root]
    cfg["training"].update(ckpt=ckpt, **training)
    cfg["dataloader"].update(num_workers=2, prefetch=2)
    return cfg


def redwood_batches(root, dev, n, n_frames, crop, M, iters, seed):
    """``n`` prepared batches of the Redwood reader's samples (loader order
    and augmentation from ``seed``), as train_torch prepares them."""
    import torch
    import train_torch
    from dpvo_tpu_torch.data.factory import dataset_factory
    from dpvo_tpu_torch.data.loader import make_loader
    np.random.seed(seed)
    torch.manual_seed(seed)
    db = dataset_factory(["redwood"], datapath=root, n_frames=n_frames,
                         crop_size=crop, fmin=8.0, fmax=48.0, aug=True,
                         device=dev)
    rng = np.random.default_rng(seed)
    out = []
    for images, poses, disps, intr in make_loader(db, batch_size=1,
                                                  num_workers=0):
        out.append(train_torch.prepare_batch(rng, images, poses, disps,
                                             intr, M, iters))
        if len(out) == n:
            return out
    raise SystemExit(f"redwood: the reader gave {len(out)} of {n} samples")


def redwood_small_run(batch, d, tf32):
    """One full fp32 step from train_state(seed 3) on ``d`` with TF32 on
    or off (cuBLAS and cuDNN): -> (metrics, each parameter's gradient
    before the clip, as numpy)."""
    import torch
    import train_torch
    from dpvo_tpu_torch.parallel import train_step as ts
    c = TRAIN_REDWOOD_SMALL
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        state = train_state(d, seed=3, lr=1e-4, total=100)
        step = ts.make_train_step(steps=c["iters"], M=c["M"])
        _, m = step(state, train_torch.to_device(batch, d))
        m = {k: float(v) for k, v in m.items()}
        unclip = max(1.0, m["gnorm"] / state.opt.clip)
        return m, [p.grad.cpu().numpy() * unclip for p in state.opt.params]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def redwood_card_runs(rank, world, init_method, batches, device):
    """A spawned process on ``device`` (the card), per batch: two steps with the
    default (atomic, run-to-run varying) algorithms, then two under
    deterministic algorithms and one with TF32 on (the control) under
    them; -> [dict(free=[run, run], det=[run, run], tf32=run)]."""
    deterministic_process()
    import torch
    dev = torch.device(device)
    out = []
    for batch in batches:
        runs = dict(free=[redwood_small_run(batch, dev, False)
                          for _ in range(2)])
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            runs["det"] = [redwood_small_run(batch, dev, False)
                           for _ in range(2)]
            runs["tf32"] = redwood_small_run(batch, dev, True)
        finally:
            torch.use_deterministic_algorithms(False)
        out.append(runs)
    return out


def metric_errors(run, ref, skip=()):
    """[(rel err, metric)] of ``run``'s metrics against ``ref``'s, worst
    first, without the metrics in ``skip``."""
    (a, _), (b, _) = run, ref
    return sorted(((abs(a[k] - b[k]) / max(abs(b[k]), 1e-5 / TOL_TRAIN), k)
                   for k in b if k not in skip), reverse=True)


def gnorm_error(run, ref):
    return abs(run[0]["gnorm"] - ref[0]["gnorm"]) / abs(ref[0]["gnorm"])


def gradient_moves(run, ref, names):
    """Where ``run``'s gradient leaves ``ref``'s: |g - g_ref| / |g_ref|
    overall, and the leaf holding the largest share of the difference
    (name, share, its own relative difference)."""
    diff = [float(np.linalg.norm(a - b)) for a, b in zip(run[1], ref[1])]
    size = [float(np.linalg.norm(b)) for b in ref[1]]
    i = int(np.argmax(diff))
    total = float(np.linalg.norm(diff))
    return (total / max(float(np.linalg.norm(size)), 1e-30), names[i],
            diff[i] ** 2 / max(total ** 2, 1e-60), diff[i] / max(size[i],
                                                                 1e-30))


def cpu_threads_run(batch, threads):
    """redwood_small_run on the CPU with ``threads`` threads (another
    summation order)."""
    import torch
    saved = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        return redwood_small_run(batch, torch.device("cpu"), False)
    finally:
        torch.set_num_threads(saved)


def redwood_small_agreement(root, dev):
    """On Redwood samples of REDWOOD_SEEDS, one full fp32 step from the
    same weights on the CPU and on the card (TF32 off, deterministic
    algorithms; two card runs must be equal).  Every metric but gnorm
    within TOL_TRAIN of the CPU's; gnorm, the one that summation order
    moves by ~1e-3 here, within REDWOOD_ORDER_FACTOR times the most that
    order moved it in this run (the CPU at REDWOOD_THREADS threads, the
    card twice with its default, atomic algorithms), and never less than
    TOL_TRAIN.
    The control, the card with TF32 on, must break a limit.  Printed per
    seed: the spreads and the gradient leaf that moves most."""
    import torch
    from dpvo_tpu_torch.parallel import launch
    c = TRAIN_REDWOOD_SMALL
    cpu_dev = torch.device("cpu")
    batches = [redwood_batches(root, cpu_dev, 1, c["n_frames"], c["crop"],
                               c["M"], c["iters"], seed=seed)[0]
               for seed in REDWOOD_SEEDS]
    with tempfile.TemporaryDirectory() as tmp:
        (cards,) = launch.spawn(redwood_card_runs, 1, (batches, str(dev)),
                                rendezvous_dir=tmp, timeout=600, threads=4)
    state = train_state(cpu_dev, seed=3)
    names = [f"{pre}.{n}" for pre, m in state.modules().items()
             for n, _ in m.named_parameters()]
    rows, order, repeat_ok = [], 0.0, True
    for seed, batch, card in zip(REDWOOD_SEEDS, batches, cards):
        cpus = [cpu_threads_run(batch, t) for t in REDWOOD_THREADS]
        cpu, cpu1 = cpus[0], cpus[-1]
        g_cpus = [r[0]["gnorm"] for r in cpus]
        det = card["det"][0]
        repeat_ok &= det[0] == card["det"][1][0] and all(
            np.array_equal(a, b) for a, b in zip(det[1], card["det"][1][1]))
        spreads = ((max(g_cpus) - min(g_cpus)) / abs(g_cpus[0]),
                   gnorm_error(card["free"][1], card["free"][0]))
        order = max(order, *spreads)
        rows.append((seed, cpu, det, card["tf32"]))
        g_cpu = gradient_moves(cpu1, cpu, names)
        g_det = gradient_moves(det, cpu, names)
        log(f"[redwood] seed {seed}: deterministic card vs CPU, worst "
            f"first: " + ", ".join(f"{k} {e:.3e}" for e, k in
                                   metric_errors(det, cpu)[:4])
            + f"; gnorm moved by order alone: CPU at {REDWOOD_THREADS} "
            f"threads {spreads[0]:.3e}, the card twice with its default "
            f"algorithms "
            f"{spreads[1]:.3e}; the gradient |dg|/|g|: CPU 1 vs 8 threads "
            f"{g_cpu[0]:.3e} (most in {g_cpu[1]}: {g_cpu[2]:.0%} of it, "
            f"{g_cpu[3]:.3e} of the leaf), card vs CPU {g_det[0]:.3e} (most "
            f"in {g_det[1]}: {g_det[2]:.0%}, {g_det[3]:.3e}); gnorm CPU "
            + ", ".join(f"{g:.6f}" for g in g_cpus) + ", card "
            f"{det[0]['gnorm']:.6f}, "
            + ", ".join(f"{r[0]['gnorm']:.6f}" for r in card["free"])
            + f" (default algorithms), TF32 on {card['tf32'][0]['gnorm']:.6f}")
    lim = max(TOL_TRAIN, REDWOOD_ORDER_FACTOR * order)
    worst, worst_g, ctrl = (0.0, ""), (0.0, 0), 0.0
    for seed, cpu, det, tf32 in rows:
        e, k = metric_errors(det, cpu, skip=("gnorm",))[0]
        worst = max(worst, (e, f"{k}, seed {seed}"))
        worst_g = max(worst_g, (gnorm_error(det, cpu), seed))
        ctrl = max(ctrl, metric_errors(tf32, cpu, skip=("gnorm",))[0][0]
                   / TOL_TRAIN, gnorm_error(tf32, cpu) / lim)
    ok = repeat_ok and worst[0] <= TOL_TRAIN and worst_g[0] <= lim < \
        lim * ctrl
    log(f"[redwood] card vs CPU, one full fp32 step on Redwood samples "
        f"(N={c['n_frames']}, {c['crop'][0]}x{c['crop'][1]}, M={c['M']}, "
        f"{c['iters']} iterations, seeds {REDWOOD_SEEDS}, deterministic "
        f"algorithms on the card, two card runs equal {repeat_ok}): worst "
        f"metric but gnorm {worst[0]:.3e} ({worst[1]}; tol {TOL_TRAIN}); "
        f"gnorm {worst_g[0]:.3e} (seed {worst_g[1]}; tol {lim:.3e} = max("
        f"{TOL_TRAIN}, {REDWOOD_ORDER_FACTOR} x {order:.3e}, the most "
        f"summation order moved it)); the control, TF32 on, "
        f"{ctrl:.1f}x its worst limit (must exceed 1) "
        f"{'OK' if ok else 'FAIL'}")
    if not repeat_ok:
        raise SystemExit("redwood: deterministic card runs differ")
    if worst[0] > TOL_TRAIN or worst_g[0] > lim:
        raise SystemExit("redwood: the card's step left the CPU's")
    if ctrl <= 1.0:
        raise SystemExit("redwood: the limits do not catch TF32 in the "
                         "fp32 step (the control stayed within them)")


def phase_redwood(dev):
    """Redwood fine-tuning at configs/redwood_train.yaml's size (480x640,
    N=15, M=80, 18 iterations, bf16, cosine schedule from a checkpoint):
    the reader on a synthetic full-width tree, one structure-only and two
    full steps timed, train_torch.train end to end for one step, and a
    small fp32 step card against CPU with its TF32 control.  No
    hand-written kernel may launch."""
    import torch
    import train_torch
    from dpvo_tpu_torch.models.update import Update
    from dpvo_tpu_torch.models.vonet import Patchifier, init_flax_like
    from dpvo_tpu_torch.ops import _cuda
    from dpvo_tpu_torch.parallel import train_step as ts
    from dpvo_tpu_torch.utils.checkpoint import save_network
    try:
        import cv2  # noqa: F401
    except ImportError:
        raise SystemExit("redwood: the Redwood reader needs OpenCV (cv2), "
                         "which this machine lacks")
    t_phase = time.perf_counter()
    before = dict(_cuda.launches)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        root = redwood_tree(Path(tmp) / "redwood")
        gen = torch.Generator().manual_seed(0)
        ckpt = str(Path(tmp) / "start.npz")
        save_network(ckpt, init_flax_like(Patchifier(3), gen),
                     init_flax_like(Update(3), gen))
        cfg = redwood_config(root, ckpt)
        tcfg, dcfg = cfg["training"], cfg["dataset"]
        log(f"[redwood] configs/redwood_train.yaml: {dcfg['names']}, "
            f"N={dcfg['n_frames']}, M={tcfg['M']}, {tcfg['iters']} "
            f"iterations, amp {tcfg['amp']}, lr {tcfg['lr']}, scheduler "
            f"{cfg['scheduler']['type']}, {tcfg['steps']} steps; overrides: "
            f"roots -> a synthetic {REDWOOD_FRAMES}-frame "
            f"{REDWOOD_HW[0]}x{REDWOOD_HW[1]} tree, ckpt -> a save_network "
            f".npz of flax-like seeded weights, dataloader workers 2")
        t0 = time.perf_counter()
        batches = redwood_batches(root, dev, 3, dcfg["n_frames"],
                                  REDWOOD_HW, tcfg["M"], tcfg["iters"],
                                  seed=0)
        log(f"[redwood] reader: scene_info, graph and 3 samples in "
            f"{time.perf_counter() - t0:.1f} s; rollout edges "
            f"{len(batches[0]['sch_ii'])}")
        state = train_torch.build_state(tcfg, cfg["scheduler"],
                                        tcfg["steps"], dev)
        sched = ts.make_schedule(tcfg["lr"], tcfg["steps"],
                                 cfg["scheduler"]["type"])
        for i, so in enumerate((True, False, False)):
            step = ts.make_train_step(steps=tcfg["iters"], M=tcfg["M"],
                                      structure_only=so, amp=tcfg["amp"])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state, m = step(state, train_torch.to_device(batches[i], dev))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            lr = state.opt.opt.param_groups[0]["lr"]
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            loss, gnorm = float(m["loss"]), float(m["gnorm"])
            log(f"[redwood] step {i} ({'structure-only' if so else 'full'}"
                f"): {ms:.1f} ms, loss {loss:.6f}, gnorm {gnorm:.6f}, lr "
                f"{lr:.6e} (cosine schedule at {i}: {sched(i):.6e}), peak "
                f"memory {peak:.2f} GiB")
            if not (np.isfinite(loss) and np.isfinite(gnorm) and gnorm > 0
                    and lr == sched(i)):
                raise SystemExit(f"redwood: step {i} gave loss {loss}, "
                                 f"gnorm {gnorm}, lr {lr}")
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            done = train_torch.train(redwood_config(
                root, ckpt, steps=1, save_freq=1, name="redwood_smoke"),
                device=dev)
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            os.chdir(cwd)
        saved = sorted(p.name for p in (Path(tmp) / "checkpoints").iterdir())
        log(f"[redwood] train_torch.train(configs/redwood_train.yaml, steps "
            f"1): {ms:.1f} ms end to end (reader from its cache, loader, "
            f"state, one full step, checkpoint), step {done.step}, wrote "
            f"{saved}")
        if done.step != 1 or "redwood_smoke_000001.npz" not in saved:
            raise SystemExit("redwood: train_torch.train did not finish")
        redwood_small_agreement(root, dev)
    if dict(_cuda.launches) != before:
        raise SystemExit(f"redwood: hand-written kernels launched: {before} "
                         f"-> {dict(_cuda.launches)}")
    log(f"[redwood] no hand-written kernel launched; phase "
        f"{time.perf_counter() - t_phase:.1f} s")


# --- phase 10: the viewer --------------------------------------------------

VIZ_FRAMES = 40
VIZ_PERIOD = 0.25        # s between snapshots in the drive (default 2.0)
TOL_VIZ = 1e-5


def viz_drive(dev, viz, n_frames=VIZ_FRAMES, ht=480, wd=640):
    """configs/default.yaml at 480x640 (EVAL_OVERRIDES) with ``viz``,
    motion probe forced, a frame rolling 4 px; -> (slam, ms per frame
    synchronised, hand-written launches, snapshot host ms)."""
    import torch
    from dpvo_tpu_torch.config import VOConfig
    from dpvo_tpu_torch.engine import DPVO
    from dpvo_tpu_torch.ops import _cuda
    path = Path(__file__).resolve().parent / "configs" / "default.yaml"
    cfg = VOConfig().merge_yaml(str(path)).replace(**EVAL_OVERRIDES)
    slam = DPVO(cfg, network=None, ht=ht, wd=wd, viz=viz, device=dev)
    slam.motion_probe = lambda: 100.0
    snap_ms = []
    if viz:
        slam.viewer.period = VIZ_PERIOD
        snapshot = slam.viewer.snapshot

        def timed_snapshot(force=False):
            t0 = time.perf_counter()
            took = snapshot(force)
            if took:
                snap_ms.append((time.perf_counter() - t0) * 1e3)
            return took

        slam.viewer.snapshot = timed_snapshot
    base = np.random.default_rng(0).integers(0, 255, (ht, 2 * wd, 3),
                                             dtype=np.uint8)
    intr = np.array([wd / 2, wd / 2, wd / 2, ht / 2])
    stream_sync()
    _cuda.reset_launches()
    ms = []
    for t in range(n_frames):
        img = np.ascontiguousarray(np.roll(base, -4 * t, axis=1)[:, :wd])
        t0 = time.perf_counter()
        slam(t, img, intr)
        stream_sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = dict(_cuda.launches)
    poses, _ = slam.terminate()
    if not np.isfinite(poses).all():
        raise SystemExit("viz: non-finite poses")
    return slam, ms, launches, snap_ms


def viz_backproject(dev, N=8, H=60, W=80, scale=8):
    """dense.backproject_and_filter at 480x640 images with 1/8 disparities,
    card against CPU: points within TOL_VIZ, colors and keep equal."""
    import torch
    from dpvo_tpu_torch.ops import lie
    from dpvo_tpu_torch.viz.dense import backproject_and_filter
    rng = np.random.default_rng(8)
    xi = (rng.normal(size=(N, 6)) * 0.02).astype(np.float32)
    xi[:, 0] += 0.05 * np.arange(N)
    poses = lie.se3_exp(torch.from_numpy(xi))
    disps = torch.from_numpy((0.25 + 0.002 * rng.normal(size=(N, H, W)))
                             .astype(np.float32))
    intr = torch.tensor([[40.0, 40.0, W / 2, H / 2]] * N)
    images = torch.from_numpy(rng.integers(
        0, 255, (N, H * scale, W * scale, 3), dtype=np.uint8))
    out = {}
    for d in ("cpu", dev):
        args = [x.to(d) for x in (images, poses, disps, intr)]
        if d == dev:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = backproject_and_filter(*args, 3, scale=scale)
        if d == dev:
            torch.cuda.synchronize()
        out[str(d)] = ([r.cpu().numpy() for r in res],
                       (time.perf_counter() - t0) * 1e3)
    (pc, cc, kc), ms_cpu = out["cpu"]
    (pg, cg, kg), ms_card = out[str(dev)]
    err = float(np.abs(pg - pc).max() / max(np.abs(pc).max(), 1.0))
    ok = (err <= TOL_VIZ and np.array_equal(cg, cc) and np.array_equal(kg, kc)
          and 0 < kc.sum() < kc.size)
    log(f"[viz] backproject_and_filter {N} keyframes, {H * scale}x"
        f"{W * scale} images, {H}x{W} disparities: card vs CPU points max "
        f"err {err:.3e} (tol {TOL_VIZ}), colors equal "
        f"{np.array_equal(cg, cc)}, keep equal {np.array_equal(kg, kc)} "
        f"({int(kc.sum())} of {kc.size} kept); {ms_card:.2f} ms on the card "
        f"(first call), CPU {ms_cpu:.2f} ms {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("viz: backproject_and_filter left the CPU's")


def viz_export_html(tmp):
    from dpvo_tpu_torch.viz.html_map import export_html
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(5000, 3)).astype(np.float32)
    pts[:10] = np.nan
    path = export_html(str(Path(tmp) / "direct.html"), pts,
                       rng.integers(0, 255, (5000, 3)).astype(np.uint8),
                       rng.normal(size=(20, 3)), [np.zeros((2, 3))] * 8,
                       image=rng.integers(0, 255, (48, 64, 3), np.uint8))
    npts, _ = html_counts(Path(path).read_text())
    log(f"[viz] export_html directly: {npts} points embedded of 5000 (10 "
        f"NaN) {'OK' if npts == 4990 else 'FAIL'}")
    if npts != 4990:
        raise SystemExit("viz: export_html embedded the wrong points")


def html_counts(html):
    """(points, cameras) that a map.html says it embeds, after checking
    that its embedded arrays parse."""
    m = re.search(r"dpvo_tpu map — (\d+) points, (\d+) cameras", html)
    pts = json.loads(re.search(r"const PTS = (\[.*?\]);", html).group(1))
    if m is None or len(pts) != 6 * int(m.group(1)):
        raise SystemExit("viz: map.html does not parse")
    return int(m.group(1)), int(m.group(2))


def snapshot_cost(dev, slam, frame, reps=5):
    """The viewer's engine-thread work once a period,
    ``viz.viewer.take_snapshot`` (the point cloud of every patch slot and
    pinned copies behind an event), on a driven engine: host ms per call,
    ms until the copies land, and one call profiled."""
    import torch
    from dpvo_tpu_torch.ops import _cuda
    from dpvo_tpu_torch.viz.viewer import take_snapshot
    before = dict(_cuda.launches)
    host, landed = [], []
    for _ in range(reps):
        stream_sync()
        t0 = time.perf_counter()
        snap = take_snapshot(slam, frame)
        host.append((time.perf_counter() - t0) * 1e3)
        snap.host()
        landed.append((time.perf_counter() - t0) * 1e3)
    profile = "not profiled"
    if dev.type == "cuda":
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            take_snapshot(slam, frame).host()
            ms = (time.perf_counter() - t0) * 1e3
        profile = device_profile(prof, ms, 1, top=4, unit="snapshot")
    if dict(_cuda.launches) != before:
        raise SystemExit("viz: a snapshot launched a hand-written kernel")
    log(f"[viz] take_snapshot on the engine ({slam.n} keyframes, {slam.m} "
        f"patches; {reps} calls): host ms " + ", ".join(
            f"{x:.2f}" for x in host) + "; copies landed after ms "
        + ", ".join(f"{x:.2f}" for x in landed) + "; hand-written launches "
        f"0; profiled: {profile}")


def phase_viz(dev):
    """The viewer.  On the card: the engine at configs/default.yaml's
    480x640 for VIZ_FRAMES frames with viz=False, then the viewer's
    snapshot (its engine-thread work) timed on it.  With matplotlib, the
    same drive with viz=True (latest.png a PNG, map.html embedding the
    finite points terminate() leaves, the same hand-written launches as
    without the viewer, ms/frame against the viz=False drive); without it,
    DPVO(viz=True) raising an ImportError naming matplotlib.  Then
    export_html directly and backproject_and_filter card vs CPU."""
    import torch
    from dpvo_tpu_torch.config import VOConfig
    from dpvo_tpu_torch.engine import DPVO
    t_phase = time.perf_counter()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            try:
                import matplotlib
                have = matplotlib.__version__
            except ImportError:
                have = None
            off, ms_off, l_off, _ = viz_drive(dev, False)
            med = lambda v: sorted(v[10:])[len(v[10:]) // 2]  # noqa: E731
            frame = np.random.default_rng(1).integers(0, 255, (480, 640, 3),
                                                      dtype=np.uint8)
            snapshot_cost(dev, off, frame)
            del off
            if have is None:
                log(f"[viz] viz=False drive: {VIZ_FRAMES} frames at 480x640, "
                    f"median {med(ms_off):.2f} ms/frame (frames 10..), "
                    f"hand-written launches {l_off}; the drive with the "
                    f"viewer is not measured: matplotlib is not installed")
                try:
                    DPVO(VOConfig(), ht=96, wd=128, viz=True, device=dev)
                except ImportError as e:
                    ok = "matplotlib" in str(e)
                    log(f"[viz] matplotlib is not installed: DPVO(viz=True) "
                        f"raised ImportError({e}) {'OK' if ok else 'FAIL'}")
                    if not ok:
                        raise SystemExit("viz: the ImportError does not "
                                         "name matplotlib")
                else:
                    raise SystemExit("viz: DPVO(viz=True) constructed "
                                     "without matplotlib")
            else:
                slam, ms_on, l_on, snap_ms = viz_drive(dev, True)
                png = (Path(tmp) / "viewer_out" / "latest.png").read_bytes()
                npts, ncam = html_counts(
                    (Path(tmp) / "viewer_out" / "map.html").read_text())
                pts = slam.points[:slam.m].cpu().numpy()
                finite = int(np.isfinite(pts).all(axis=1).sum())
                ok = (png[:8] == b"\x89PNG\r\n\x1a\n" and npts == finite > 0
                      and ncam == slam.n and l_on == l_off
                      and slam.viewer._counter >= 2)
                log(f"[viz] matplotlib {have}: configs/default.yaml at "
                    f"480x640 with {EVAL_OVERRIDES}, {VIZ_FRAMES} frames, "
                    f"viewer period {VIZ_PERIOD} s: PNG renders "
                    f"{slam.viewer._counter} (latest.png {len(png)} bytes), "
                    f"map.html embeds {npts} points of {finite} finite "
                    f"({slam.m} patches) and {ncam} cameras; snapshots "
                    f"{len(snap_ms)}, host ms each "
                    + ", ".join(f"{x:.2f}" for x in snap_ms)
                    + f"; median ms/frame (frames 10..) viz on "
                    f"{med(ms_on):.2f}, off {med(ms_off):.2f}; hand-written "
                    f"launches on {l_on}, off {l_off} "
                    f"{'OK' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit("viz: the viewer drive failed")
            viz_export_html(tmp)
        finally:
            os.chdir(cwd)
    viz_backproject(dev)
    synchronize(dev)
    log(f"[viz] phase {time.perf_counter() - t_phase:.1f} s")


# --- phase 11: multi-device (edge-sharded inference, data-parallel step) ---

# docs/MULTICHIP.md's retain scale at full width
SH = dict(M=96, P=3, PMEM=36, MEM=36, N_FRAMES=48, WINDOW=22, N_NOW=44,
          N_CAP=16, K_CAP=4096, E_LIVE=32000, E_ROWS=32768, H=120, W=160)
TOL_SH = dict(poses=(1e-4, 2e-4), net=(5e-4, 1e-3), delta=(5e-4, 1e-3),
              weight=(5e-4, 1e-3), target=(5e-3, 1e-3), depth=(2e-3, 5e-4))
SH_DEPTH_SHARE = 1e-3    # patches whose depth may cross a threshold
SH_REPS = 3              # timed sharded updates (after one warm)
TOL_DP_ONE = 1e-6        # NCCL world 1 against one process
TOL_DP_TWO = 1e-4        # two gloo ranks on the card against one process


def sharded_problem(dev, s, seed=0):
    """The update's inputs at the sizes ``s`` (SH's keys): poses, patches,
    intrinsics and the zero-padded rings drawn on ``dev`` from ``seed``
    (every rank draws the same), the edge tables on the host.  The newest
    frame's patches point back, so no patch has only ii == jj edges (whose
    depth update is rounding noise times 1 / lmbda)."""
    import torch
    from dpvo_tpu_torch.models.update import DIM
    from dpvo_tpu_torch.ops.corr_cuda import pad_fmap
    g = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    M, P, NF = s["M"], s["P"], s["N_FRAMES"]
    poses = torch.zeros(NF, 7, device=dev)
    poses[:, 6] = 1.0
    poses[:, 0] = 0.05 * torch.arange(NF, device=dev)
    ctr = torch.rand(NF * M, 2, generator=g, device=dev) \
        * torch.tensor([s["W"] - 8.0, s["H"] - 8.0], device=dev) + 4.0
    off = torch.arange(-1.0, 2.0, device=dev)
    patches = torch.empty(NF * M, 3, P, P, device=dev)
    patches[:, 0] = ctr[:, 0, None, None] + off[None, None, :]
    patches[:, 1] = ctr[:, 1, None, None] + off[None, :, None]
    patches[:, 2] = (0.3 + 1.7 * torch.rand(NF * M, 1, 1, generator=g,
                                            device=dev))
    intr = torch.tensor([[80.0, 80.0, 80.0, 60.0]], device=dev).repeat(NF, 1)

    def normal(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    rings = dict(imap=normal(s["PMEM"] * M, DIM),
                 gmap=normal(s["PMEM"] * M, P, P, 128),
                 fmap1=pad_fmap(normal(s["MEM"], s["H"], s["W"], 128)),
                 fmap2=pad_fmap(normal(s["MEM"], s["H"] // 4, s["W"] // 4,
                                       128)))
    n_now, E = s["N_NOW"], s["E_LIVE"]
    kk = np.sort(rng.integers((n_now - s["WINDOW"]) * M, n_now * M, E))
    ii = kk // M
    step = rng.integers(1, 12, E)
    jj = np.where(ii == n_now - 1, ii - step, np.minimum(ii + step,
                                                         n_now - 1))
    edges = dict(ii=ii.astype(np.int32), jj=jj.astype(np.int32),
                 kk=kk.astype(np.int32),
                 net=(rng.normal(size=(E, DIM)) * 0.1).astype(np.float32),
                 target=rng.uniform(0, s["W"], (E, 2)).astype(np.float32),
                 weight=rng.uniform(0, 1, (E, 2)).astype(np.float32))
    return dict(poses=poses, patches=patches, intrinsics=intr, **rings), \
        edges


def sharded_update_mod(dev):
    """The update operator with flax-like weights drawn on the CPU."""
    import torch
    from dpvo_tpu_torch.models.update import Update
    from dpvo_tpu_torch.models.vonet import init_flax_like
    return init_flax_like(Update(3), torch.Generator().manual_seed(0)).to(
        dev).eval()


def synchronize(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_sharded(group, dev, world, rank, s=SH):
    """This rank's sharded update at the sizes ``s`` (default: the retain
    scale): (outputs as numpy, the partition (perm, valid), launches in
    one update, ms per update)."""
    import torch
    from dpvo_tpu_torch.ops import _cuda
    from dpvo_tpu_torch.parallel.infer_step import (make_sharded_update_step,
                                                    shard_edges_by_patch)
    repl, edges = sharded_problem(dev, s)
    perm, valid = shard_edges_by_patch(
        edges["ii"], edges["jj"], edges["kk"], world,
        e_shard=s["E_ROWS"] // world, k_cap=s["K_CAP"])
    n = len(perm) // world
    rows = slice(rank * n, (rank + 1) * n)

    def shard(a):
        return torch.as_tensor(a[perm][rows]).to(dev)

    step = make_sharded_update_step(
        sharded_update_mod(dev), group, M=s["M"], pmem=s["PMEM"],
        mem=s["MEM"], n_cap=s["N_CAP"], k_cap=s["K_CAP"], span=64)
    args = ([repl[k] for k in ("poses", "patches", "intrinsics", "imap",
                               "gmap", "fmap1", "fmap2")]
            + [shard(edges[k]) for k in ("net", "target", "weight", "ii",
                                         "jj", "kk")]
            + [torch.as_tensor(valid[rows]).to(dev), s["N_NOW"] - 10,
               s["N_NOW"]])
    step(*args)                                   # warm
    synchronize(dev)
    times = []
    for _ in range(SH_REPS):
        _cuda.reset_launches()
        t0 = time.perf_counter()
        out = step(*args)
        synchronize(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    launches = dict(_cuda.launches)
    return ([o.cpu().numpy() for o in out], perm, valid, launches,
            sorted(times)[len(times) // 2])


def single_device_update(dev, s=SH):
    """engine.kernels.update_step on the same inputs, one device, TF32
    off, with K2 swapped for its plain version (plain_correlation): the
    sharded runs launch K2 in fp32 at these shapes, so holding them to
    this run holds that kernel to its plain version.  Raises if K2
    launched here."""
    import torch
    from types import SimpleNamespace
    from dpvo_tpu_torch.engine import kernels
    from dpvo_tpu_torch.ops import _cuda
    repl, edges = sharded_problem(dev, s)
    t = {k: torch.as_tensor(v).to(dev) for k, v in edges.items()}
    ds = SimpleNamespace(**repl, net=t["net"], target=t["target"],
                         weight=t["weight"], eii=t["ii"], ejj=t["jj"],
                         ekk=t["kk"])
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    k2 = _cuda.launches["corr_enc"]
    try:
        with torch.no_grad(), plain_correlation():
            delta = kernels.update_step(
                ds, sharded_update_mod(dev), s["E_LIVE"], s["N_NOW"] - 10,
                s["N_NOW"], s["M"], s["PMEM"], s["MEM"], n_cap=s["N_CAP"],
                k_cap=s["K_CAP"])
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    if _cuda.launches["corr_enc"] != k2:
        raise SystemExit("sharded: the plain reference launched K2")
    return [x.cpu().numpy() for x in (ds.net, ds.target, ds.weight, delta,
                                      ds.poses, ds.patches)]


def sharded_errors(got, perm, valid, ref):
    """Each output of the sharded run against the single-device one, as
    (max |err| - tolerance, ...): -> (ok, summary)."""
    net, target, weight, delta, poses, patches = got
    inv = np.full(len(ref[0]), -1, np.int64)
    live = np.nonzero(valid)[0]
    inv[perm[live]] = live
    if (inv < 0).any():
        raise SystemExit("sharded: an edge is missing from the partition")
    parts, ok = [], True
    for name, g, w in (("net", net, ref[0]), ("target", target, ref[1]),
                       ("weight", weight, ref[2]), ("delta", delta, ref[3]),
                       ("poses", poses, ref[4])):
        g = g if name == "poses" else g[inv]
        atol, rtol = TOL_SH[name]
        viol = np.abs(g - w) - (atol + rtol * np.abs(w))
        ok &= bool((viol <= 0).all())
        parts.append(f"{name} max err {np.abs(g - w).max():.3e}")
    atol, rtol = TOL_SH["depth"]
    d_g, d_w = patches[:, 2], ref[5][:, 2]
    bad = (np.abs(d_g - d_w) > atol + rtol * np.abs(d_w)).any(axis=(1, 2))
    ok &= bool(bad.mean() <= SH_DEPTH_SHARE)
    parts.append(f"depths max err {np.abs(d_g - d_w).max():.3e}, "
                 f"{int(bad.sum())} of {len(bad)} patches past "
                 f"{atol}/{rtol} (allowed {SH_DEPTH_SHARE:.1%})")
    return ok, "; ".join(parts)


def dp_batch(dev):
    """A global batch of 2 small clips (TRAIN_SMALL), prepared from one
    numpy seed."""
    import train_torch
    c = TRAIN_SMALL
    clips = [train_clip(seed, c["N"], c["H"], c["W"]) for seed in (4, 5)]
    stacked = [np.concatenate(parts) for parts in zip(*clips)]
    batch = train_torch.prepare_batch(np.random.default_rng(4), *stacked,
                                      c["M"], c["iters"])
    return train_torch.to_device(batch, dev)


def deterministic_process():
    """Fix cuBLAS's workspace before this (spawned) process's first CUDA
    call, so that run_dp can turn on deterministic algorithms: the step's
    atomics otherwise change its rounding run to run, which the
    ill-conditioned rollout gradient magnifies (PERF.md section 6)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


def run_dp(dev, group):
    """A structure-only and a full fp32 step (TF32 off, autocast off,
    deterministic algorithms) on this rank's rows of dp_batch; ->
    (metrics per step, parameters)."""
    import torch
    from dpvo_tpu_torch.parallel.mesh import replicate, shard_batch
    from dpvo_tpu_torch.parallel import train_step as ts
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = TRAIN_SMALL
    batch = dp_batch(dev)
    state = train_state(dev, seed=3, lr=1e-4, total=100)
    if group is not None:
        replicate(state.patchifier, group)
        replicate(state.update, group)
        batch = dict(batch, **shard_batch(
            {k: v for k, v in batch.items() if not k.startswith("sch_")},
            group))
    metrics = []
    try:
        for so in (True, False):
            step = ts.make_train_step(steps=c["iters"], M=c["M"],
                                      structure_only=so, group=group)
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        torch.use_deterministic_algorithms(False)
    return metrics, [p.cpu().numpy() for p in params_of(state)]


def dp_error(run, ref):
    """Worst relative error of metrics and parameters against ``ref``."""
    (m_a, p_a), (m_b, p_b) = run, ref
    worst = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-6)
                for a, b in zip(m_a, m_b) for k in b)
    for a, b in zip(p_a, p_b):
        worst = max(worst, float(np.abs(a - b).max()
                                 / max(np.abs(b).max(), 1e-6)))
    return worst


def dp_reference(rank, world, init_method, device):
    """One spawned process: the train steps without a group, then on an
    NCCL (on the card) world of 1; -> (one process, world 1)."""
    from dpvo_tpu_torch.parallel.mesh import make_mesh
    deterministic_process()
    import torch
    single = run_dp(torch.device(device), None)
    group, dev = make_mesh(1, device=device, init_method=init_method,
                           rank=0, world_size=1)
    return single, run_dp(dev, group)


def gloo_rank(rank, world, init_method, device):
    """One of two gloo ranks on ``device`` (spawned): the sharded update,
    then the data-parallel train step."""
    from dpvo_tpu_torch.parallel.mesh import make_mesh
    deterministic_process()
    group, dev = make_mesh(world, device=device, backend="gloo",
                           init_method=init_method, rank=rank,
                           world_size=world)
    sharded = run_sharded(group, dev, world, rank)
    return sharded, run_dp(dev, group)


def phase_sharded(dev):
    """Edge-sharded inference at docs/MULTICHIP.md's retain scale and the
    data-parallel train step: (a) one NCCL rank on the card against the
    single-device update_step with K2's plain version (so K2 in fp32 is
    held to it at these shapes); (b) two gloo ranks on the one card (NCCL
    refuses two ranks on one GPU) against it; then the data-parallel step,
    NCCL world 1 and two gloo ranks against one process.  Two ranks on one
    card measure correctness and overhead, not scale-out."""
    import torch
    import torch.distributed as dist
    from dpvo_tpu_torch.parallel import launch
    from dpvo_tpu_torch.parallel.infer_step import ba_reduce_bytes
    from dpvo_tpu_torch.parallel.mesh import make_mesh
    t_phase = time.perf_counter()
    s = SH
    ref = single_device_update(dev)
    log(f"[sharded] retain scale: {s['E_ROWS']} edge rows ({s['E_LIVE']} "
        f"live) over a {s['WINDOW']}-frame window, M={s['M']}, P={s['P']}, "
        f"DIM 384, maps {s['H']}x{s['W']} and {s['H'] // 4}x{s['W'] // 4} "
        f"(480x640 frames), k_cap={s['K_CAP']}, n_cap={s['N_CAP']}, "
        f"PMEM=MEM={s['MEM']}, fp32, TF32 off, t0={s['N_NOW'] - 10}; the "
        f"reference: update_step with K2's plain version; BA's fused "
        f"reduction {ba_reduce_bytes(s['N_CAP'], s['K_CAP'])} bytes per "
        f"iteration")
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        group, d0 = make_mesh(1, device=str(dev),
                              init_method=f"file://{tmp}/nccl_store",
                              rank=0, world_size=1)
        try:
            out, perm, valid, launches, ms = run_sharded(group, d0, 1, 0)
            ok, summary = sharded_errors(out, perm, valid, ref)
            results[1] = (ok, launches, ms)
            log(f"[sharded] one NCCL rank ({dist.get_backend()}) vs plain "
                f"update_step: {summary}; K2 launches per update "
                f"{launches.get('corr_enc', 0)}, {ms:.2f} ms per sharded "
                f"update {'OK' if ok else 'FAIL'}")
        finally:
            dist.destroy_process_group()
        ((single, one),) = launch.spawn(dp_reference, 1, (str(dev),),
                                        rendezvous_dir=tmp, timeout=600,
                                        threads=4)
        err_one = dp_error(one, single)
        t0 = time.perf_counter()
        ranks = launch.spawn(gloo_rank, 2, (str(dev),), rendezvous_dir=tmp,
                             timeout=600, threads=4)
        spawn_s = time.perf_counter() - t0
    parts = [r[0] for r in ranks]
    got = [np.concatenate([p[0][i] for p in parts]) for i in range(4)]
    for p in parts[1:]:
        for i in (4, 5):
            if not np.array_equal(p[0][i], parts[0][0][i]):
                raise SystemExit("sharded: the ranks' poses or patches "
                                 "differ")
    ok2, summary = sharded_errors(got + [parts[0][0][4], parts[0][0][5]],
                                  parts[0][1], parts[0][2], ref)
    k2 = [p[3].get("corr_enc", 0) for p in parts]
    log(f"[sharded] two gloo ranks on {dev} vs plain update_step: {summary}; K2 "
        f"launches per update by rank {k2}, ms per sharded update by rank "
        + ", ".join(f"{p[4]:.2f}" for p in parts)
        + f" (one rank: {results[1][2]:.2f}; two ranks share one card and "
        f"reduce through the host) {'OK' if ok2 else 'FAIL'}")
    dp = [r[1] for r in ranks]
    err_two = max(dp_error(r, single) for r in dp)
    same = all(np.array_equal(a, b) for a, b in zip(dp[0][1], dp[1][1]))
    ok_dp = err_one <= TOL_DP_ONE and err_two <= TOL_DP_TWO and same
    log(f"[sharded] data-parallel train step (N={TRAIN_SMALL['N']}, "
        f"{TRAIN_SMALL['H']}x{TRAIN_SMALL['W']}, M={TRAIN_SMALL['M']}, "
        f"{TRAIN_SMALL['iters']} iterations, global batch 2, fp32, autocast "
        f"and TF32 off, deterministic algorithms; a structure-only and a "
        f"full step, each run in a spawned process): NCCL world 1 vs "
        f"one process worst rel err {err_one:.3e} (tol {TOL_DP_ONE}); two "
        f"gloo ranks vs one process {err_two:.3e} (tol {TOL_DP_TWO}), "
        f"parameters equal across ranks {same}; loss {single[0][1]['loss']:.6f}"
        f", gnorm {single[0][1]['gnorm']:.6f} {'OK' if ok_dp else 'FAIL'}")
    log(f"[sharded] two spawned ranks took {spawn_s:.1f} s (start-up, "
        f"problem, 1 + {SH_REPS} sharded updates, 2 train steps)")
    if not (results[1][0] and ok2 and ok_dp and min(k2) > 0
            and results[1][1].get("corr_enc", 0) > 0):
        raise SystemExit("sharded: a check failed (see the lines above)")
    log(f"[sharded] phase {time.perf_counter() - t_phase:.1f} s")
    return dict(k2_per_rank=k2)


# --- phase 13: the measurement layer ----------------------------------------

TIMED_PHASES = ("append_factors", "keyframe", "keyframe/apply",
                "keyframe/launch", "keyframe/result", "keyframe/retire",
                "track_frame", "update/meta", "update/step")
# the phases no other phase holds (keyframe holds keyframe/*)
DISJOINT_PHASES = ("track_frame", "append_factors", "update/meta",
                   "update/step", "keyframe")
TOL_MOTIONMAG = (1e-4, 1e-5)   # rtol, atol
# each dev bench and its quick setting, in the order of the port's list
TOOLS = (("scripts/dev/frame_profile_torch.py", ["quick"]),
         ("scripts/dev/bench_profile_torch.py", ["quick"]),
         ("scripts/dev/bench_ablate_torch.py", ["quick"]),
         ("scripts/dev/update_net_profile_torch.py", ["quick"]),
         ("scripts/dev/corr_block_profile_torch.py", ["quick"]),
         ("scripts/dev/ba_bench_torch.py", ["cg", "quick"]),
         ("scripts/dev/train_bench_torch.py", ["quick"]),
         ("scripts/dev/roofline_torch.py", ["quick"]),
         ("benchmarks/compare_scatter_torch.py", []),
         ("benchmarks/benchmark_dataloader_torch.py", ["quick"]),
         ("scripts/dev/lc_match_bench_torch.py", []))
# the arms whose K2/K3/K4 launches are checked: (tool, arm) -> kernels arm
TOOL_ARMS = {("bench_profile", "update_step kernels"): True,
             ("bench_profile", "update_step plain correlation"): False,
             ("bench_ablate", "full"): True,
             ("bench_ablate", "plain correlation"): False}


def phase_timing(dev):
    """The merge regime of bench_torch.run_regime for two windows with the
    phase timers on, timing host dispatch and then fencing each phase."""
    import bench_torch
    for block in (False, True):
        r = bench_torch.run_regime("merge", device=dev, min_windows=2,
                                   max_windows=2, timing=True,
                                   timing_block=block)
        report = r["timing"]
        frames = 40 * len(r["windows"])
        wall = sum(40 / w for w in r["windows"]) * 1e3
        disjoint = sum(ms * cnt for k, (ms, cnt) in report.items()
                       if k in DISJOINT_PHASES)
        mode = "fenced" if block else "dispatch"
        log(f"[tools] phase timers, merge, {mode}: {frames} frames, "
            f"{wall / frames:.2f} ms/frame wall (windows "
            + ", ".join(f"{1e3 / w:.2f}" for w in r["windows"])
            + " ms/frame); per phase mean ms x count = ms/frame: "
            + "; ".join(f"{k} {ms:.3f} x{cnt} = {ms * cnt / frames:.3f}"
                        for k, (ms, cnt) in report.items())
            + f"; disjoint phases {disjoint / frames:.2f} ms/frame")
        if tuple(report) != TIMED_PHASES or not disjoint <= wall:
            raise SystemExit(f"tools: the phase report ({mode}) has "
                             f"{tuple(report)}, disjoint phases {disjoint:.1f}"
                             f" ms against {wall:.1f} ms of wall time")


def motionmag_pairs(dev, network):
    """The small never-merge drive on ``dev``, not terminated: (engine,
    its frame pairs with edges)."""
    from dpvo_tpu_torch.config import VOConfig
    from dpvo_tpu_torch.engine import DPVO
    slam = small_seams(DPVO(VOConfig(**SMALL, KEYFRAME_THRESH=0.0),
                            network=network, ht=SMALL_HW[0], wd=SMALL_HW[1],
                            device=dev))
    for t, img in enumerate(small_frames()):
        slam(t, img, SMALL_INTR)
    e = slam.hs.e_num
    return slam, sorted(set(zip(slam.hs.ii[:e].tolist(),
                                slam.hs.jj[:e].tolist())))


def phase_motionmag(dev):
    """DPVO.motionmag on the card against the CPU, every pair with edges."""
    import torch
    network = small_network()
    card, pairs = motionmag_pairs(dev, network)
    cpu, pairs_cpu = motionmag_pairs(torch.device("cpu"), network)
    if pairs != pairs_cpu:
        raise SystemExit("tools: the small drive's edges differ card "
                         "against CPU")
    own = [(card.motionmag(i, j), cpu.motionmag(i, j)) for i, j in pairs]
    for name in ("poses", "patches", "intrinsics"):
        getattr(card.ds, name).copy_(getattr(cpu.ds, name))
    same = [(card.motionmag(i, j), cpu.motionmag(i, j)) for i, j in pairs]
    rtol, atol = TOL_MOTIONMAG

    def worst(vals):
        return max(abs(a - b) / max(abs(b), atol / rtol) for a, b in vals)

    ok = all(abs(a - b) <= atol + rtol * abs(b) for a, b in same)
    log(f"[tools] motionmag, card against CPU, {len(pairs)} frame pairs of "
        f"the small never-merge drive: on the CPU engine's state worst "
        f"relative error {worst(same):.3e} (rtol {rtol}, atol {atol}); on "
        f"each device's own drive {worst(own):.3e}; magnitudes "
        f"{min(b for _, b in same):.4f}..{max(b for _, b in same):.4f} "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("tools: motionmag on the card disagrees with the "
                         "CPU")


def run_tool(path, argv):
    """Load a dev bench by path and run its ``main(argv)`` with its output
    captured (and logged); -> the output.  It must return 0 and print no
    non-finite number."""
    import importlib.util
    import io
    spec = importlib.util.spec_from_file_location(Path(path).stem,
                                                  Path(__file__).parent / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(list(argv))
    out = buf.getvalue()
    for text in out.splitlines():
        log(f"[tools] {Path(path).stem} | {text}")
    bad = re.findall(r"(?<![A-Za-z])(?:nan|inf)(?![A-Za-z])", out, re.I)
    log(f"[tools] {path} {' '.join(argv)}: returned {rc} in "
        f"{time.perf_counter() - t0:.1f} s"
        + (f", non-finite numbers {bad}" if bad else ""))
    if rc != 0 or bad:
        raise SystemExit(f"tools: {path} returned {rc}, non-finite {bad}")
    return out


def check_tool_arms(tool, out):
    """K2, K3 and K4 launched in the kernel arms, K2 not in the plain
    correlation arms."""
    seen = set()
    num = r"(\d+(?:\.\d+)?)"
    for m in re.finditer(r"^\[(\w+)\] ([^:(\n]+?)(?: \(E=\d+\))?: .*launches "
                         rf"K2 {num} K3 {num} K4 {num}", out, re.M):
        arm = (m.group(1), m.group(2))
        if arm not in TOOL_ARMS:
            continue
        k2, k3, k4 = (float(m.group(i)) for i in (3, 4, 5))
        ok = (min(k2, k3, k4) > 0 if TOOL_ARMS[arm]
              else k2 == 0 and min(k3, k4) > 0)
        if not ok:
            raise SystemExit(f"tools: {arm} launched K2 {k2}, K3 {k3}, "
                             f"K4 {k4}")
        seen.add(arm)
    want = {a for a in TOOL_ARMS if a[0] == tool}
    if seen != want:
        raise SystemExit(f"tools: {tool} printed arms {seen}, not {want}")


def phase_tools(dev):
    """The measurement layer: the phase timers, motionmag, the dev
    benches."""
    t_phase = time.perf_counter()
    phase_timing(dev)
    phase_motionmag(dev)
    here = str(Path(__file__).resolve().parent / "scripts" / "dev")
    if here not in sys.path:
        sys.path.insert(0, here)
    for path, argv in TOOLS:
        if path.endswith("lc_match_bench_torch.py"):
            try:
                import cv2  # noqa: F401
            except ImportError:
                log(f"[tools] {path}: not run (OpenCV, cv2, is not "
                    f"installed here)")
                continue
        out = run_tool(path, argv)
        tool = Path(path).stem.removesuffix("_torch")
        if tool in ("bench_profile", "bench_ablate"):
            check_tool_arms(tool, out)
    log(f"[tools] phase {time.perf_counter() - t_phase:.1f} s")


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if "--guard-drive" in argv:
        # before this tree's package is imported: the checkout's is used
        return guard_drive_main(argv[argv.index("--guard-drive") + 1])
    from dpvo_tpu_torch.ops import _cuda
    phases = ("kernels", "agree", "agree_bf16", "engine", "lc", "train",
              "eval", "classic", "bench", "graphs", "guard", "redwood", "viz",
              "sharded", "tools")
    only = None
    if "--only" in argv:
        only = set(argv[argv.index("--only") + 1].split(","))
        if not only <= set(phases):
            print(f"chip_smoke: --only takes {','.join(phases)}",
                  file=sys.stderr)
            return 2
    parent = None
    if "--parent" in argv:
        parent = Path(argv[argv.index("--parent") + 1]).resolve()

    marks = []     # (phase, start) of each phase run, for the time log

    def run(phase):
        on = only is None or phase in only
        if on:
            marks.append((phase, time.perf_counter()))
        return on

    dev = torch.device("cuda:0")
    card = card_line()
    log(f"[machine] {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _cuda.lib()
    log(f"[machine] kernel build+load {time.perf_counter() - t0:.2f}s "
        f"(nvcc {_cuda.build_seconds})")
    hmma = hmma_counts(_cuda.build())
    log("[machine] HMMA instructions per kernel (cuobjdump -sass): "
        + ("not available" if hmma is None else
           "; ".join(f"{k} {v}" for k, v in hmma.items())))

    if run("kernels"):
        _cuda.reset_launches()
        kern = phase_kernels(dev)
        single_launches = _cuda.launches["corr_single"]
        log(f"[kernels] corr_single is on no engine path (its callers are "
            f"corr_grouped and the tests): its launches below are phase "
            f"2's ({single_launches})")
        probe_launches = probe_path()
    if run("agree"):
        phase_agreement(dev)
    if run("agree_bf16"):
        phase_agreement_bf16(dev)
    if run("engine"):
        drive_engine(dev, "merge")
        drive_engine(dev, "retain")
        with corr_version(12):
            raw = drive_engine(dev, "retain")
    if run("lc"):
        t0 = time.perf_counter()
        phase_lc_agreement(dev)
        check_ba_global_syncs(drive_lc(dev))
        log(f"[lc] phase {time.perf_counter() - t0:.1f} s")
    if run("train"):
        phase_train(dev)
    if run("eval"):
        phase_eval(dev)
    if run("classic"):
        phase_classic(dev)
    bench = None
    if run("bench"):
        bench = phase_bench(dev)
    if run("graphs"):
        phase_graphs(dev, bench)
    if run("guard"):
        phase_guard(dev, parent)
    if run("redwood"):
        phase_redwood(dev)
    if run("viz"):
        phase_viz(dev)
    if run("sharded"):
        phase_sharded(dev)
    if run("tools"):
        phase_tools(dev)
    marks.append(("", time.perf_counter()))
    log("[machine] seconds per phase: " + ", ".join(
        f"{name} {end - start:.1f}"
        for (name, start), (_, end) in zip(marks, marks[1:])))
    if only is not None:
        log(f"[machine] ran {','.join(sorted(only))} alone: no kernels line")
        return 0

    launches = {**bench["merge"]["launches"], **probe_launches,
                "corr_fused": raw["launches"]["corr_fused"],
                "corr_single": single_launches}
    # the kernels line holds K2, K3 and K4 at the lagged merge shape of the
    # default configuration, K1 in the version-12 drive's layout, K5 in
    # corr_grouped's reference order and the probes at the D3 path's shape
    picks = {"corr_fused": (E_MAIN, "v12"), "corr_single": (E_MAIN, "ref"),
             **{f"corr_probe.{p}": E_MAIN for p in PROBES}}
    line = {"kernels": []}
    for name, meta in KERNELS.items():
        r = kern[name][picks.get(name, SHAPES[1][0])]
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
    sys.exit(main(sys.argv[1:]))
