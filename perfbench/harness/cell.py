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
freed, and the configuration's check (``perfbench/check/<name>.py``)
judges what it produced against the reference.  Under loop closure the
copies carry the inactive edge store, the loop proposals are recorded by
frame as the program made them, and the store's device rows are kept for
the check.
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

from ..reference.engine import Structure
from . import inputs, manifest, state, trace

INIT_FRAMES = 8


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def buffer_size(traffic, seconds):
    """Keyframe slots for the warm frames and a window of ``seconds`` at
    the traffic's ``buffer_fps`` frames a second (every frame a keyframe),
    rounded up to a multiple of 1024."""
    need = traffic["warm_frames"] + math.ceil(seconds * traffic["buffer_fps"])
    return -(-(need + 2) // 1024) * 1024


def inactive_capacity(cfg):
    """Rows of the inactive edge store for ``cfg.BUFFER_SIZE`` keyframes
    under loop closure: each keyframe retires its M x (2 x PATCH_LIFETIME -
    1) edges, and a loop round every ``GLOBAL_OPT_FREQ`` keyframes at most
    M edges for each of ``reduce_edges``' 1000 frame pairs."""
    M = cfg.PATCHES_PER_FRAME
    return cfg.BUFFER_SIZE * (M * (2 * cfg.PATCH_LIFETIME - 1)
                              + -(-1000 * M // cfg.GLOBAL_OPT_FREQ))


def engine_config(spec, seconds, overrides=None):
    """The engine's configuration: the configuration file's VOConfig keys,
    the traffic's pinned ones, ``BUFFER_SIZE`` from the window, then
    ``overrides``; under loop closure ``EDGE_CAPACITY_INAC`` from the
    buffer (``inactive_capacity``) where none of them pins it."""
    from dpvo_tpu_torch.config import VOConfig
    keys = {f.name for f in dataclasses.fields(VOConfig)}
    cfg = {k: v for k, v in spec["config"].items() if k in keys}
    cfg.update({k: v for k, v in spec["traffic"].items() if k in keys})
    cfg["BUFFER_SIZE"] = buffer_size(spec["traffic"], seconds)
    cfg.update(overrides or {})
    out = VOConfig(**cfg)
    if out.LOOP_CLOSURE and "EDGE_CAPACITY_INAC" not in cfg:
        out = dataclasses.replace(out,
                                  EDGE_CAPACITY_INAC=inactive_capacity(out))
    return out


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


def update_copied(slam, pairs, take):
    """The engine's update between two copies of its state: before it, and
    after it with the targets and weights its BA read."""
    pre = take(slam, net=False)
    type(slam).update(slam)
    pairs.append((pre, take(slam, net=False)))


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
    # what the check or the reference's bookkeeping cannot follow fails here
    manifest.admit(spec, cfg)
    Structure(dataclasses.asdict(cfg))
    lc = cfg.LOOP_CLOSURE
    take = state.take_lc if lc else state.take
    if lc:
        log(f"[setup] inactive edge store: {cfg.EDGE_CAPACITY_INAC} rows, "
            f"{cfg.EDGE_CAPACITY_INAC * 16} bytes")
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
    start, proposals = {}, {}

    def probe():
        # random weights give arbitrary motion: the probe is forced, and the
        # last frame before initialisation is copied here, after its
        # tracking, with the depths it drew
        if slam.n + 1 == INIT_FRAMES:
            start["probe"] = take(slam, INIT_FRAMES, range(INIT_FRAMES))
        return 100.0
    slam.motion_probe = probe
    first_update = slam.update

    def update():
        # the state after the first update of the initialisation
        first_update()
        if "after" not in start:
            start["after"] = take(slam)
    slam.update = update
    if lc:
        propose = slam.edges_loop

        def edges_loop():
            # the program's proposals, by the frame that asked (the last
            # frame's key also gets terminate()'s)
            kk, jj = propose()
            proposals.setdefault(slam.hs.counter - 1, []).append(
                (kk.copy(), jj.copy()))
            return kk, jj
        slam.edges_loop = edges_loop

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
    if lc:
        lc0 = lc_counters(slam, proposals)
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
            copies.append(take(slam, features=(
                () if i == c0 else [newest_slot(slam)])))
        if trace_on and i == tr["p0"]:
            sync(device)
            prof = trace.profiler()
            prof.start()
            tr["t0"] = time.perf_counter()
        in_group = c0 is not None and i < c0 + group
        if in_group:
            slam.update = lambda: update_copied(slam, pairs, take)
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
    last = take(slam)
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
    store = None
    if lc:
        lc1 = lc_counters(slam, proposals)
        log(f"[window] loop closure: loop rounds {lc1[0] - lc0[0]}, loop "
            f"edges {lc1[1] - lc0[1]}, global BAs {lc1[2] - lc0[2]}, "
            f"inactive rows {lc0[3]} -> {lc1[3]}")
        # append-only: the check slices each copy's rows from it
        store = (slam.ds.target_inac, slam.ds.weight_inac)
    t_end = time.perf_counter()
    poses, _ = slam.terminate()
    log(f"[close] terminate() {time.perf_counter() - t_end:.3f} s")
    win = poses[traf["warm_frames"]:traf["warm_frames"] + frames_in]
    failed = int((~np.isfinite(win).all(axis=1)).sum())
    red = trace.reduce(prof) if prof is not None else None
    del prof, slam
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # --- the check: the configuration's own -------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c0 = frames_in if c0 is None else c0
    run_data = dict(
        cfg=dataclasses.asdict(cfg), weights=weights, frames=frames,
        device=device, M=cfg.PATCHES_PER_FRAME,
        intr=torch.as_tensor(intr / 4, dtype=torch.float32, device=device),
        fmap_hw=(ht // 4, wd // 4), start=start, copies=copies,
        c0=traf["warm_frames"] + c0, end=traf["warm_frames"] + frames_in,
        last=last, pairs=pairs, control=control, proposals=proposals,
        store=store)
    t_ref = time.perf_counter()
    nums, ctl, work, updates = spec["check"].compare(run_data)
    log(f"[check] reference {time.perf_counter() - t_ref:.2f} s, group at "
        f"window frame {c0} (share {share:.3f}); " + ", ".join(f"{k} {v:.4g}"
                                           for k, v in nums.items()))

    # --- metrics: each read by its own reader, ``metrics/<name>.py`` --------
    ctx = dict(loop=traf["loop"], setup_s=setup_s, frames=frames_in,
               window_s=window_s, spans=spans, trace=red,
               stretch=tr, work=manifest.work(conf),
               updates=updates, steps=work,
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


def lc_counters(slam, proposals):
    """Under loop closure: (loop rounds with edges, their edges, global BAs
    run, inactive rows) so far."""
    rounds = [len(calls[0][0]) for calls in proposals.values()
              if len(calls[0][0])]
    return (len(rounds), sum(rounds),
            int(np.count_nonzero(slam.ran_global_ba)), slam.hs.n_inac)


def _diff(a, b):
    return {k: v - b.get(k, 0) for k, v in sorted(a.items())
            if v - b.get(k, 0)}
