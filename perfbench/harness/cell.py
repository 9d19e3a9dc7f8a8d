"""One run of one cell: set-up, the measured window, the check, the
metrics.

Set-up makes the weights and frames from the seed, builds the engine
(``dpvo_tpu_torch.engine.DPVO``, one per stream as users run it), captures
its programs with ``precompile`` as the traffic plans, runs the warm frames
and ``precompile`` again around their edge count.  The window then drives
``DPVO.__call__`` frame by frame for ``seconds``, closed loop (each frame
called when the last returns).  Copies of the engine's state at a group of
frames that begins at a share of the window drawn from the seed, and with
``trace`` a profiled stretch, fall inside the window; one more copy is
taken when it closes.  The engine is then ended (``terminate()``) and
freed, and the reference checks what it produced (``checks``).
"""
from __future__ import annotations

import dataclasses
import gc
import math
import os
import resource
import sys
import time

import numpy as np
import torch

from . import checks, inputs, manifest, state, trace

INIT_FRAMES = 8


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def buffer_size(traffic, seconds):
    """Keyframe slots for the warm frames and a window of ``seconds`` at
    the traffic's ``buffer_fps`` frames a second (every frame a keyframe),
    rounded up to a multiple of 1024."""
    need = traffic["warm_frames"] + math.ceil(seconds * traffic["buffer_fps"])
    return -(-(need + 2) // 1024) * 1024


def engine_config(spec, seconds, overrides=None):
    """The engine's configuration: the configuration file's VOConfig keys,
    the traffic's pinned ones, ``BUFFER_SIZE`` from the window, then
    ``overrides``."""
    from dpvo_tpu_torch.config import VOConfig
    keys = {f.name for f in dataclasses.fields(VOConfig)}
    cfg = {k: v for k, v in spec["config"].items() if k in keys}
    cfg.update({k: v for k, v in spec["traffic"].items() if k in keys})
    cfg["BUFFER_SIZE"] = buffer_size(spec["traffic"], seconds)
    cfg.update(overrides or {})
    return VOConfig(**cfg)


def sync(device):
    """Wait for the engine's stream (a device-wide synchronise would fail
    a capture the engine's worker may hold open)."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def counters(slam):
    return dict(captures=len(slam.graph_capture_ms),
                background=len(slam.background_capture_ms),
                cover=sum(slam.cover_served.values()),
                buckets=dict(slam.buckets_seen))


def newest_slot(slam):
    """The keyframe slot of the last frame called."""
    hs = slam.hs
    return int(np.nonzero(hs.tstamps[:hs.n] == hs.counter - 1)[0][0])


def update_copied(slam, pairs):
    """The engine's update between two copies of its state: before it, and
    after it with the targets and weights its BA read."""
    pre = state.take(slam, net=False)
    type(slam).update(slam)
    pairs.append((pre, state.take(slam, net=False)))


def host_load():
    """This process's CPU seconds and involuntary context switches, and the
    host's load average."""
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime, r.ru_nivcsw, os.getloadavg()[0]


def run(workload, seed, seconds, trace_on, device, t_start, control=False,
        overrides=None):
    """-> (result dict without ``device``, the compared numbers, their
    limits, the control's numbers or None)."""
    from dpvo_tpu_torch.engine import DPVO

    ov = overrides or {}
    spec = manifest.cell(workload)
    spec["config"].update(ov.get("config", {}))
    spec["traffic"].update(ov.get("traffic", {}))
    conf, traf = spec["config"], spec["traffic"]
    if traf["loop"] != "offline":
        raise ValueError(f"loop {traf['loop']!r}: the harness runs the "
                         "offline loop only")
    cfg = engine_config(spec, seconds, ov.get("engine"))
    ht, wd = conf["image_height"], conf["image_width"]
    intr = np.asarray(conf["intrinsics"], np.float64)
    dtype = torch.bfloat16 if cfg.MIXED_PRECISION else torch.float32
    rng = np.random.default_rng(seed)
    share = float(rng.uniform(*traf["check_share"]))
    group = traf["check_group"]

    weights = inputs.make_weights(seed, device, dtype)
    frames = inputs.Frames(seed, ht, wd, traf["roll_px"])
    feed = inputs.FrameFeed(frames, device)
    slam = DPVO(cfg, network=inputs.split_weights(weights), ht=ht, wd=wd,
                device=device, seed=seed)
    start = {}

    def probe():
        # random weights give arbitrary motion: the probe is forced, and the
        # last frame before initialisation is copied here, after its
        # tracking, with the depths it drew
        if slam.n + 1 == INIT_FRAMES:
            start["probe"] = state.take(slam, INIT_FRAMES,
                                        range(INIT_FRAMES))
        return 100.0
    slam.motion_probe = probe
    first_update = slam.update

    def update():
        # the state after the first update of the initialisation
        first_update()
        if "after" not in start:
            start["after"] = state.take(slam)
    slam.update = update

    plan = [slam.precompile(max_edges=traf["precompile_max_edges"])]
    for t in range(traf["warm_frames"]):
        slam(t, feed.get(t), intr)
    del slam.update
    t = traf["warm_frames"]
    sync(device)
    plan.append(slam.precompile(around=slam.hs.e_num,
                                steps=traf["precompile_around_steps"]))
    for p in plan:
        log(f"[setup] precompile: {p['seconds']:.2f} s, {len(p['ms'])} keys, "
            f"graph pool bytes {p['pool_bytes']}")
    tr = dict(p0=traf["trace_offset"], n=traf["trace_frames"])
    if trace_on:
        with trace.profiler():       # the profiler's one-off start-up
            torch.zeros(1, device=device).add_(1)
    before = counters(slam)
    sync(device)
    # what set-up left behind is never collected again in the window
    gc.collect()
    gc.freeze()

    copies, pairs, spans, edges = [], [], [], []
    c0, prof = None, None
    setup_s = time.perf_counter() - t_start
    load0 = host_load()
    t0 = time.perf_counter()
    i = 0
    # a program fast enough to fill the buffer ends the window there
    while (time.perf_counter() - t0 < seconds
           and slam.n + 1 < cfg.BUFFER_SIZE):
        if c0 is None and time.perf_counter() - t0 >= share * seconds:
            c0 = i
        if c0 is not None and i <= c0 + group:
            # before frame i, with the features of frame i - 1 as the rings
            # hold them
            copies.append(state.take(slam, features=(
                () if i == c0 else [newest_slot(slam)])))
        if trace_on and i == tr["p0"]:
            sync(device)
            prof = trace.profiler()
            prof.start()
            tr["t0"] = time.perf_counter()
        in_group = c0 is not None and i < c0 + group
        if in_group:
            slam.update = lambda: update_copied(slam, pairs)
        with trace.span("feed"):
            img = feed.get(t)
        h0 = time.perf_counter()
        with trace.span("call"):
            slam(t, img, intr)
        spans.append((i, time.perf_counter() - h0))
        if in_group:
            del slam.update
        edges.append(slam.hs.e_num)
        if trace_on and i == tr["p0"] + tr["n"] - 1 and prof is not None:
            sync(device)
            tr["t1"] = time.perf_counter()
            prof.stop()
        t += 1
        i += 1
    sync(device)
    window_s = time.perf_counter() - t0
    load1 = host_load()
    frames_in = i
    after = counters(slam)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    last = state.take(slam)
    if window_s < seconds:
        log(f"[window] WARNING: the buffer's {cfg.BUFFER_SIZE} keyframe "
            f"slots filled at window frame {frames_in}, {window_s:.3f} s: the "
            "window ends there")
    call_ms = np.percentile([d for _, d in spans], (50, 90, 99, 100)) * 1e3
    log(f"[host] in the window: process CPU {load1[0] - load0[0]:.3f} s, "
        f"involuntary context switches {load1[1] - load0[1]}, load average "
        f"{load0[2]:.2f} -> {load1[2]:.2f}; call ms p50/p90/p99/max "
        + "/".join(f"{x:.3f}" for x in call_ms)
        + f"; card after the window: {card_info()}")
    log(f"[window] {frames_in} frames in {window_s:.3f} s; live edges "
        f"{min(edges, default=0)}..{max(edges, default=0)}; updates by "
        f"bucket {_diff(after['buckets'], before['buckets'])}; graphs "
        f"captured on the engine thread {after['captures'] - before['captures']}"
        f", in the worker {after['background'] - before['background']}; "
        f"updates a cover served {after['cover'] - before['cover']}")
    if after["captures"] > before["captures"]:
        log("[window] WARNING: a graph was captured on the engine's thread "
            "inside the window (a stalled frame)")
    poses, _ = slam.terminate()
    win = poses[traf["warm_frames"]:traf["warm_frames"] + frames_in]
    failed = int((~np.isfinite(win).all(axis=1)).sum())
    red = trace.reduce(prof) if prof is not None else None
    del prof, slam
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # --- the check -------------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ck = checks.Checker(dict(
        cfg=dataclasses.asdict(cfg), weights=weights, frames=frames,
        device=device, M=cfg.PATCHES_PER_FRAME,
        intr=torch.as_tensor(intr / 4, dtype=torch.float32, device=device),
        fmap_hw=(ht // 4, wd // 4)))
    t_ref = time.perf_counter()
    s0 = ck.start(start["probe"], start["after"], control)
    c0 = frames_in if c0 is None else c0
    s1 = ck.steps(copies, traf["warm_frames"] + c0,
                  traf["warm_frames"] + frames_in, last, control)
    for g in [s0[1]] + [g for g in s1[1] if g is not None]:
        log("[check-detail] " + " ".join(
            f"{w}:" + ",".join(f"{k}={v:.3g}" for k, v in (g[w] or {}).items())
            for w in g))
    ba_prog = ck.ba_alone(pairs)
    ba_ctl = ck.ba_alone(pairs, tf32=True) if control else None
    for g in ba_prog:
        log("[check-detail] ba alone: " + ", ".join(
            f"{k}={v:.3g}" for k, v in g.items()))
    nums = checks.numbers(s0, s1, ba_prog)
    ctl = checks.numbers(s0, s1, ba_ctl, "fp8") if control else None
    log(f"[check] reference {time.perf_counter() - t_ref:.2f} s, group at "
        f"window frame {c0} (share {share:.3f}); " + ", ".join(f"{k} {v:.4g}"
                                           for k, v in nums.items()))

    # --- metrics: each read by its own reader, ``metrics/<name>.py`` --------
    ctx = dict(loop=traf["loop"], setup_s=setup_s, frames=frames_in,
               window_s=window_s, spans=spans, trace=red,
               stretch=tr, work=manifest.work(conf),
               updates=s1[3].update_edges, steps=s1[2],
               first=traf["warm_frames"], ht=ht, wd=wd,
               in_stretch=lambda k: (tr["p0"] <= k < tr["p0"] + tr["n"]
                                     and "t1" in tr))
    out = dict(correct=None, attempted=frames_in, failed=failed, metrics={})
    for m in spec["per_layer"] if trace_on else spec["end_to_end"]:
        v = manifest.reader(m["name"]).read(ctx)
        if v is not None:
            out["metrics"][m["name"]] = dict(value=v, unit=m["unit"])
    if red is not None:
        out["breakdown"] = dict(device_ops=red["device_ops"],
                                idle_gaps=red["idle_gaps"])
        out["busy_s"] = red["busy_s"]
        out["window_s"] = tr["t1"] - tr["t0"]
    out["memory_peak_bytes"] = peak
    return out, nums, spec["limits"], ctl


def card_info(fields="clocks.sm,power.draw,temperature.gpu"):
    """nvidia-smi's readings of ``fields``, or what failed."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def _diff(a, b):
    return {k: v - b.get(k, 0) for k, v in sorted(a.items())
            if v - b.get(k, 0)}
