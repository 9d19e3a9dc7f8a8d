"""The engine's phase timers and ``motionmag`` against the JAX engine's, on
CPU.

Both engines track tests/test_torch_engine.py's 16 frames (tiny config,
the same weights, scripted centroids, fixed pre-init depth, motion probe
forced, fp32) with their phase timers on from the first frame, once with
synchronous keyframe decisions (always merge) and once lagged
(tests/test_torch_async.py's ``ASYNC_KEYFRAME_LAG=3``, ``BATCH=2``, with the
JAX engine's fetch pool stubbed so its batches apply exactly when overdue,
as the port's do).  ``timing_report()`` must name the same phases and count
each the same number of times.  The one designed difference in where a
phase is counted: the port's ``update()`` returns at once when there are
no edges, before ``update/meta`` and ``update/step``; the JAX engine times
both.  Every JAX update is recorded with its edge count, and the expected
port counts are JAX's less its updates with no edges (none in these
drives; a direct test shows the port's early return).

``motionmag(i, j)`` is held against the JAX engine's for every frame pair
with edges at the end of the never-merge drive (rtol 1e-4, atol 1e-5), and
is 0.0 for a pair with none.  The two drives' poses agree only within the
never-merge envelope (translation 5e-3), which moves a magnitude by up to
~2e-4 of itself, so the port's engine first takes the JAX engine's poses,
patches and intrinsics (the edge tables are equal).  With timing off
nothing is recorded and no span, ``record_function``, eager stamp or
fence is reached, and ``bench_torch.run_regime(..., timing=True)`` returns
all nine phases.

The engine's tracing (``utils.timing``) on a port drive alone: the spans'
names, nesting, frames and threads; tracing turned on by a running
``torch.profiler`` alone, its spans among the profiler's events as
``dpvo.*``; the CPU's stamp rows reduced per frame (segments summing to
their program) and the benchmark's six readers of them finding nothing on
the CPU; the stamp kernels' plain versions.
"""
import importlib.util
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from dpvo_tpu.config import VOConfig as JaxConfig
from dpvo_tpu.engine import DPVO as JaxDPVO
from dpvo_tpu_torch.config import VOConfig
from dpvo_tpu_torch.engine import DPVO
from dpvo_tpu_torch.utils import timing
from dpvo_tpu_torch.utils.checkpoint import params_from_jax
from test_torch_async import LAGGED, _LatePool
from test_torch_engine import (DEPTH0, HT, INTR, TINY, WD, centroid_grid,
                               make_frames)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PHASES = ("append_factors", "keyframe", "keyframe/apply", "keyframe/launch",
          "keyframe/result", "keyframe/retire", "track_frame", "update/meta",
          "update/step")
SYNC_PHASES = ("append_factors", "keyframe", "keyframe/retire",
               "track_frame", "update/meta", "update/step")
DRIVES = {"sync": {**TINY, "KEYFRAME_THRESH": 1e9},
          "lagged": LAGGED,
          "never_merge": {**TINY, "KEYFRAME_THRESH": 0.0}}


def seams(slam):
    slam.motion_probe = lambda: 100.0
    slam.test_centroids = centroid_grid
    slam.test_fixed_depth = DEPTH0
    return slam


def timed_drive(slam):
    """The 16 frames with the timers on; -> the engine (not terminated)."""
    slam.enable_timing = True
    for t, img in enumerate(make_frames()):
        slam(t, img, INTR)
    return slam


@pytest.fixture(scope="module")
def drives():
    """drive name -> (JAX engine, its updates' edge counts, port engine),
    both driven, neither terminated."""
    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    out = {}
    try:
        init = JaxDPVO(JaxConfig(**TINY, CORR_BACKEND="xla"), network=None,
                       ht=HT, wd=WD)
        p = jax.tree.map(np.asarray, init.params_patchify)
        u = jax.tree.map(np.asarray, init.params_update)
        for k in ("kernel", "bias"):
            u["params"]["d"][k] = u["params"]["d"][k] * 0.02
        for name, cfg in DRIVES.items():
            ref = seams(JaxDPVO(JaxConfig(**cfg, CORR_BACKEND="xla"),
                                network=(p, u), ht=HT, wd=WD))
            if cfg["ASYNC_KEYFRAME"]:
                ref._mag_pool.shutdown(wait=False)
                ref._mag_pool = _LatePool()
            edges = []
            jax_update = ref.update

            def update(ref=ref, jax_update=jax_update, edges=edges):
                edges.append(ref.hs.e_num)
                jax_update()

            ref.update = update
            timed_drive(ref)
            port = timed_drive(seams(DPVO(VOConfig(**cfg),
                                          network=params_from_jax(p, u),
                                          ht=HT, wd=WD, device="cpu")))
            out[name] = (ref, edges, port)
    finally:
        jax.config.update("jax_default_matmul_precision", old)
    return out


@pytest.mark.parametrize("name", ["sync", "lagged"])
def test_phase_names_and_counts_match_jax(drives, name):
    ref, edges, port = drives[name]
    assert port.n == ref.n and port.hs.e_num == ref.hs.e_num
    got = port.timing_report()
    want = ref.timing_report()
    assert tuple(got) == tuple(want)
    assert tuple(got) == (PHASES if name == "lagged" else SYNC_PHASES)
    # the designed difference: JAX times update/meta and update/step of an
    # update with no edges; the port returns before them
    empty = sum(e == 0 for e in edges)
    expect = {k: c - (empty if k.startswith("update/") else 0)
              for k, (_, c) in want.items()}
    assert {k: c for k, (_, c) in got.items()} == expect
    assert all(ms >= 0 for ms, _ in got.values())
    assert got["track_frame"][1] == 16
    if name == "lagged":
        assert got["keyframe/apply"][1] == got["keyframe/result"][1] > 0


def test_update_with_no_edges_records_no_phase():
    """The port's early return: an update with no edges times nothing."""
    slam = DPVO(VOConfig(**TINY), ht=HT, wd=WD, device="cpu")
    slam.enable_timing = True
    assert slam.hs.e_num == 0
    slam.update()
    assert slam.timing_report() == {}


def test_motionmag_matches_jax(drives):
    ref, _, port = drives["never_merge"]
    hs = port.hs
    e = hs.e_num
    np.testing.assert_array_equal(hs.ii[:e], ref.hs.ii[:e])
    np.testing.assert_array_equal(hs.jj[:e], ref.hs.jj[:e])
    np.testing.assert_array_equal(hs.kk[:e], ref.hs.kk[:e])
    for name in ("poses", "patches", "intrinsics"):
        getattr(port.ds, name).copy_(torch.from_numpy(
            np.array(getattr(ref.ds, name))))
    pairs = sorted(set(zip(hs.ii[:e].tolist(), hs.jj[:e].tolist())))
    assert len(pairs) > 20
    for i, j in pairs:
        got, want = port.motionmag(i, j), ref.motionmag(i, j)
        assert isinstance(got, float)
        # an edge into its own frame has no flow
        assert got > 0 or i == j, (i, j)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                   err_msg=str((i, j)))
    none = next((i, j) for i in range(port.n) for j in range(port.n)
                if (i, j) not in pairs)
    assert port.motionmag(*none) == 0.0 == ref.motionmag(*none)


def test_timing_off_never_fences(monkeypatch):
    """With timing off (the default) no span or stamp row is recorded, and
    neither a span, a ``record_function``, an eager stamp, the stamps'
    copy nor a fence or device synchronise is reached; on the CPU, timing
    on records the phases without a device synchronise."""
    def boom(*a, **k):
        raise AssertionError("traced or fenced with timing off")

    for obj, name in ((torch.cuda, "synchronize"),
                      (torch.cuda.Stream, "synchronize"),
                      (torch.cuda.Event, "synchronize"),
                      (torch.autograd.profiler, "record_function"),
                      (torch._C._profiler, "_RecordFunctionFast"),
                      (timing, "stamp_set"), (timing, "stamp_graph"),
                      (timing, "stamp_set_ref"), (timing, "stamp_graph_ref"),
                      (timing, "_fence"), (timing.Tracer, "begin"),
                      (timing.Tracer, "begin_call"),
                      (timing.Tracer, "replay"),
                      (timing.Tracer, "_copy_rows")):
        monkeypatch.setattr(obj, name, boom)
    spans, replays = len(timing.SPANS), len(timing.REPLAYS)
    slam = seams(DPVO(VOConfig(**LAGGED), ht=HT, wd=WD, device="cpu"))
    assert not slam.enable_timing
    for t, img in enumerate(make_frames()):
        slam(t, img, INTR)
    assert slam.timing_report() == {}
    assert slam.timing_report("device") == {}
    assert (len(timing.SPANS), len(timing.REPLAYS)) == (spans, replays)
    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    slam = timed_drive(seams(DPVO(VOConfig(**LAGGED), ht=HT, wd=WD,
                                  device="cpu")))
    assert tuple(slam.timing_report()) == PHASES


def test_bench_run_regime_returns_the_phases():
    spec = importlib.util.spec_from_file_location(
        "bench_torch", ROOT / "bench_torch.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    r = bench.run_regime("merge", device="cpu", ht=96, wd=128, n_warm=10,
                         n_bench=3, min_windows=1, max_windows=1,
                         timing=True, PATCHES_PER_FRAME=8,
                         EDGE_CAPACITY=4096, MIXED_PRECISION=False)
    assert tuple(r["timing"]) == PHASES
    assert r["timing"]["track_frame"][1] == 3
    off = bench.run_regime("merge", device="cpu", ht=96, wd=128, n_warm=10,
                           n_bench=3, min_windows=1, max_windows=1,
                           PATCHES_PER_FRAME=8, EDGE_CAPACITY=4096,
                           MIXED_PRECISION=False)
    assert off["timing"] is None


# --- the engine's tracing on a port drive -----------------------------------

SPAN_NAMES = set(timing.PHASES) | set(timing.PROGRAMS) | {
    "call", "update", "stage", "capture", "ba_global", "wait"}
# each span's parent: the phases' as the JAX engine nests them, each
# program run under the phase that runs it
PARENTS = {"track_frame": {"call"}, "append_factors": {"call"},
           "update": {"call"}, "update/meta": {"update"},
           "update/step": {"update"}, "keyframe": {"call"},
           "keyframe/launch": {"keyframe"}, "keyframe/result": {"keyframe"},
           "keyframe/apply": {"keyframe"}, "keyframe/retire": {"keyframe"},
           "track_frame_u8": {"track_frame"},
           "update_step_dev": {"update/step"},
           "keyframe_merge": {"keyframe/apply"},
           "stage": {"track_frame", "update/meta", "keyframe/apply"}}
READERS = ("track_program_ms", "update_program_ms", "update_net_ms",
           "local_ba_ms", "launch_idle_ms", "engine_idle_ms")


@pytest.fixture(scope="module")
def traced():
    """The lagged drive with tracing on from the first frame, terminated:
    (engine, its spans, its replays, the drive's host-clock span)."""
    slam = seams(DPVO(VOConfig(**LAGGED), ht=HT, wd=WD, device="cpu"))
    slam.enable_timing = True
    t0 = timing.time.perf_counter()
    for t, img in enumerate(make_frames()):
        slam(t, img, INTR)
    t1 = timing.time.perf_counter()
    slam.terminate()
    eng = slam.tracer.engine
    timing.drain()
    return (slam, [s for s in timing.SPANS if s.engine == eng],
            [r for r in timing.REPLAYS if r.engine == eng], (t0, t1))


def test_spans_nest_by_frame_and_thread(traced):
    slam, spans, replays, _ = traced
    by_id = {s.id: s for s in spans}
    calls = [s for s in spans if s.name == "call"]
    assert [c.frame for c in sorted(calls, key=lambda c: c.t0)] == list(
        range(len(make_frames())))
    assert {s.name for s in spans} <= SPAN_NAMES
    assert {s.thread for s in spans} == {threading.get_ident()}
    for s in spans:
        assert s.t0 <= s.t1
        if s.name == "call":
            assert s.parent is None
            continue
        parent = by_id[s.parent]
        assert s.frame == parent.frame
        assert parent.t0 <= s.t0 and s.t1 <= parent.t1
        if s.name in PARENTS:
            assert parent.name in PARENTS[s.name], (s.name, parent.name)
    # the JAX engine's phases: timing_report reads the same spans
    report = slam.timing_report()
    assert tuple(report) == PHASES
    assert {k: c for k, (_, c) in report.items()} == {
        k: sum(s.name == k for s in spans) for k in PHASES}
    # one replay record per program run, under its span
    runs = [s for s in spans if s.name in timing.PROGRAMS]
    assert sorted(r.span for r in replays) == sorted(s.id for s in runs)
    for r in replays:
        assert by_id[r.span].name == r.program
        assert by_id[r.span].frame == r.frame


def test_cpu_stamps_reduce_per_frame(traced):
    """The CPU's stamp rows (the host clock in the card's place): no row
    lost, each update's segments summing to its program, launch and idle
    waits non-negative; the device report holds the phases that ran a
    program, none of them longer in all on the device than on the host
    clock."""
    slam, _, replays, (t0, t1) = traced
    frames = timing.frames(t0, t1, device="cpu", engine=slam.tracer.engine)
    assert len(frames) == len(make_frames())
    assert sum(f["replays"] for f in frames) == len(replays)
    for f in frames:
        assert f["lost"] == 0 and f["track_frame_u8"] > 0
        parts = f["corr"] + f["net"] + f["ba"] + f["rest"]
        assert parts == pytest.approx(f["update_step_dev"], abs=1e-9)
        assert min(f["corr"], f["net"], f["ba"], f["launch"],
                   f["idle"]) >= 0
    device = slam.timing_report("device")
    assert tuple(device) == ("keyframe", "keyframe/apply", "track_frame",
                             "update/step")
    host = slam.timing_report()
    for k, (ms, count) in device.items():
        assert 0 < ms * count <= host[k][0] * host[k][1]


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing_on_the_cpu(traced, name):
    """The benchmark's readers of the stamps read the card's alone: on the
    CPU's records they return None, with or without a traced stretch."""
    _, _, _, (t0, t1) = traced
    spec = importlib.util.spec_from_file_location(
        "reader_" + name, ROOT / "perfbench" / "metrics" / f"{name}.py")
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    assert reader.LAYER in ("device programs", "networks", "local BA",
                            "device-program graphs", "host engine")
    assert (reader.UNIT, reader.MOVES) == ("ms", "fps")
    assert reader.read(dict(stretch=dict(t0=t0, t1=t1))) is None
    assert reader.read(dict(stretch=dict(p0=0, n=4))) is None


def test_a_running_profiler_turns_tracing_on():
    """With the switch off, a recording ``torch.profiler`` traces each call
    it sees: the spans are recorded and are among its events as
    ``dpvo.<name>``; the call after it stops records nothing."""
    slam = seams(DPVO(VOConfig(**LAGGED), ht=HT, wd=WD, device="cpu"))
    frames = make_frames()
    for t in range(10):
        slam(t, frames[t], INTR)
    eng = slam.tracer.engine
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        slam(10, frames[10], INTR)
    slam(11, frames[11], INTR)
    spans = [s for s in timing.SPANS if s.engine == eng]
    assert {s.frame for s in spans} == {10}
    names = {e.name for e in prof.events() if e.name.startswith("dpvo.")}
    assert names == {"dpvo." + s.name for s in spans}
    assert {"dpvo.call", "dpvo.track_frame_u8", "dpvo.update_step_dev",
            "dpvo.update/step"} <= names


def test_stamp_plain_versions():
    """The stamp kernels' plain versions: a set stamp writes its slot's
    row and moves the slot cell, a graph stamp writes the cell's slot,
    slot -1 parks to the discard row, rows wrap at the ring's length."""
    ring = torch.zeros((4 + 1, len(timing.BOUNDARIES), 2), dtype=torch.int64)
    cur = torch.full((1,), -1, dtype=torch.int64)
    timing.stamp_graph(ring, cur, 2)               # parked: discard row
    assert ring[4, 2, 1] == -1 and ring[4, 2, 0] > 0
    timing.stamp_set(ring, cur, 6, 0)
    timing.stamp_graph(ring, cur, 5)
    assert int(cur[0]) == 6
    assert ring[2, 0, 1] == 6 and ring[2, 5, 1] == 6
    assert 0 < ring[2, 0, 0] <= ring[2, 5, 0]
    timing.stamp_set(ring, cur, -1)
    assert int(cur[0]) == -1 and ring[:4, :, 1].count_nonzero() == 2
    with pytest.raises(ValueError):
        timing.stamp_set(ring.int(), cur, 0, 0)
