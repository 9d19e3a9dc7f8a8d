"""The JAX engine's cold-bucket guard in the port (``DPVO._call_update_step``,
``_cover``, the capture worker) and the JAX package's last public names, on
the CPU.

(a) The cover rule: on random captured sets, the bucket the JAX engine
    dispatches at (``JaxDPVO._call_update_step`` on a stub, its
    ``update_step_dev`` recorded) equals the one the port replays, and each
    schedules the exact key exactly where the other does; the port's
    patch-capacity and correlation-version terms on their own.
(b) Results at a cover: on test_torch_update_dev.py's state (its fixtures,
    one JAX compile), the port's update at the exact bucket against each
    larger ladder bucket and a larger patch capacity, on edge tables padded
    with zero rows as a larger ``EDGE_CAPACITY`` holds them, within
    ATOL_COVER (1e-6: the live rows' net, target and weight come out
    bitwise, poses and depths move by fp32 summation order in BA, 1.2e-8
    on the CPU path); the port at a cover against JAX at the exact bucket
    at that file's tolerances; and whole CPU drives (the lagged merge drive, 16
    frames, and the loop-closure drive, 36 frames with global BA) in which
    every update replays a cover (a larger bucket at a larger patch
    capacity), against the same drives at exact buckets: structure equal,
    poses within ATOL_COVER.  A stand-in graph (``StubGraph``) replays by
    running the program eagerly, so the CPU runs the engine's graph
    dispatch as is.
(c) The guard's dispatch with a stand-in capturer: a cold key with a cover
    replays it and is captured once, in the worker; with no cover it is
    captured on the calling thread; a failed background capture raises at
    the next ``update()``, ``precompile()`` or ``terminate()`` with the
    worker's traceback; ``precompile`` and ``terminate`` wait for a capture
    in flight; the worker takes the queued key asked for last first; a
    capture on the calling thread waits for the worker's open capture only,
    dropping the queued keys; many keys under a short thread switch
    interval are each captured once; launch counts inside a capture are
    per thread.
(d) ``BasicEncoder`` (instance and no norm), ``VONet`` and ``corr_stack``
    against the JAX functions with the parameters carried across (the
    models' atol 2e-4; corr_stack's fp32 sums at 1e-5), ``neighbors_host``
    equal to JAX's, ``pgo.se3_to_sim3_log_inv`` within 1e-5 (fp32 Lie
    ops), ``profile_trace`` writing a trace, and each port package's
    ``__all__`` covering the JAX one's.
"""
import collections
import importlib
import json
import sys
import threading
import time
import traceback
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpvo_tpu.config import VOConfig as JaxConfig
from dpvo_tpu.engine import DPVO as JaxDPVO
from dpvo_tpu.engine import kernels as jk
from dpvo_tpu_torch.config import VOConfig
from dpvo_tpu_torch.engine import DPVO
from dpvo_tpu_torch.engine import kernels as tk
from dpvo_tpu_torch.engine.state import DeviceState, MM_CAP
from dpvo_tpu_torch.ops import _cuda, corr_cuda
from dpvo_tpu_torch.utils.checkpoint import flax_to_state_dict
from test_torch_update_dev import (ATOL_DEPTH, ATOL_NET, ATOL_POSE, BUCKET,
                                   CFG, drive, updates)  # noqa: F401

torch.set_num_threads(1)

ATOL_COVER = 1e-6      # a cover against the exact bucket: fp32 sum order
ATOL_MODEL = 2e-4      # the update operator (tests/test_torch_models.py)
ATOL_CORR = 1e-5       # fp32 bilinear sums, summation order
KEY = jax.random.PRNGKey(3)
VERSION = corr_cuda.FUSED_VERSION


class StubGraph:
    """A CUDA graph's stand-in on the CPU: a replay runs the program and
    writes its output where the capture's output lives."""

    def __init__(self, program):
        self.program = program
        self.out = torch.empty(0)

    def replay(self):
        res = self.program()
        if res is not None:
            self.out.resize_(res.shape).copy_(res)


def stub_record(program, draws=False):
    graph = StubGraph(program)
    return graph, graph.out, collections.Counter()


def graphed(slam):
    """``slam`` (a CPU engine) dispatching through its graph code with
    stand-in graphs and no worker set-up."""
    slam.cuda_graphs = True
    slam._record = stub_record
    slam._capture_thread_init = lambda *args: None
    return slam


# --- (a) the cover rule against the JAX engine's ---------------------------

def jax_dispatch(monkeypatch, warm, key):
    """The bucket the JAX engine's ``_call_update_step`` dispatches ``key``
    = (bucket, run_ba, has_mm) at with ``warm`` compiled, and whether it
    schedules a background compile."""
    seen, spawned = [], []
    monkeypatch.setattr(jk, "update_step_dev",
                        lambda *a, **kw: seen.append(kw["bucket"]))
    ds = types.SimpleNamespace(**{k: None for k in (
        "poses", "patches", "intrinsics", "imap", "gmap", "fmap1", "fmap2",
        "net", "target", "weight", "eii", "ejj", "ekk")})
    stub = types.SimpleNamespace(
        _warm_update=set(warm), _spawn_update_compile=spawned.append,
        params_update=None, hs=types.SimpleNamespace(e_num=5),
        update_mod=None, M=8, pmem=36, mem=36, n_cap=8, k_cap=256,
        use_pallas=False)
    bucket, run_ba, has_mm = key
    JaxDPVO._call_update_step(stub, ds, bucket, np.int32(1), np.int32(2),
                              run_ba, np.zeros(8) if has_mm else None)
    return seen[0], spawned == [key]


def port_dispatch(graphs, key):
    """The key the port's ``_call_update_step`` replays or runs for
    ``key`` = (bucket, run_ba, has_mm, k_cap) with ``graphs`` captured, and
    whether it schedules a background capture."""
    ran, later = [], []
    stub = types.SimpleNamespace(
        cuda_graphs=True, buckets_seen={}, cover_served={},
        _graphs=dict.fromkeys(graphs), _graph_lock=threading.Lock())
    stub._update_key = lambda *k: DPVO._update_key(stub, *k)
    stub._cover = lambda k: DPVO._cover(stub, k)
    stub._capture_later = later.append
    stub._replay = ran.append
    stub._update_program = lambda *k: None
    stub._update_writes = lambda b: ()
    stub._run = lambda k, program, written: ran.append(k)
    DPVO._call_update_step(stub, *key)
    return ran[0], later == [DPVO._update_key(stub, *key)]


def test_cover_choice_matches_jax(monkeypatch):
    cfg = VOConfig(EDGE_CAPACITY=57344)
    ladder_of = types.SimpleNamespace(cfg=cfg, E_cap=cfg.edge_capacity())
    ladder_of._bucket_for = lambda e: DPVO._bucket_for(ladder_of, e)
    ladder = DPVO._bucket_ladder(ladder_of)
    rng = np.random.default_rng(0)
    k_cap = 4096
    covered = 0
    for _ in range(300):
        warm = {(int(rng.choice(ladder)), bool(rng.integers(2)),
                 bool(rng.integers(2)))
                for _ in range(rng.integers(0, 6))}
        key = (int(rng.choice(ladder)), bool(rng.integers(2)),
               bool(rng.integers(2)))
        want_bucket, want_later = jax_dispatch(monkeypatch, warm, key)
        graphs = [(b, rb, hm, k_cap, VERSION) for b, rb, hm in warm]
        got, later = port_dispatch(graphs, (*key, k_cap))
        assert (got[0], later) == (want_bucket, want_later), (warm, key)
        assert got[1:] == (*key[1:], k_cap, VERSION)
        covered += want_later
    assert covered > 20                  # the rule acted, not only misses


def test_cover_patch_capacity_and_version():
    """A cover needs a patch capacity at least the key's and the same
    correlation version; the smallest bucket wins, then the smallest
    capacity."""
    key = (14336, True, True, 4096)
    graphs = [(16384, True, True, 2048, VERSION),        # capacity short
              (57344, True, True, 4096, 12),             # other version
              (24576, True, True, 8192, VERSION),
              (20480, True, True, 16384, VERSION),
              (20480, True, True, 8192, VERSION)]
    assert port_dispatch(graphs, key) == ((20480, True, True, 8192,
                                           VERSION), True)
    assert port_dispatch(graphs[:2], key) == ((*key, VERSION), False)


# --- (b) results at a cover -------------------------------------------------

def padded_state(ds, rows):
    """``ds`` with its edge tables grown to ``rows`` by zero rows, as an
    engine with that ``EDGE_CAPACITY`` holds them past the live count."""
    def grow(t):
        return torch.cat([t, t.new_zeros((rows - t.shape[0],
                                          *t.shape[1:]))])
    return DeviceState(**{
        k: grow(v) if k in ("net", "target", "weight", "eii", "ejj", "ekk")
        else v.clone() for k, v in vars(ds).items()})


def run_at(slam, bucket, k_cap, rows=2048):
    hs = slam.hs
    blob, _ = slam._mm_blob()
    ds = padded_state(slam.ds, rows)
    n = slam.n
    with torch.no_grad():
        _, mag = tk.update_step_dev(
            ds, slam.update_mod, bucket, torch.tensor(hs.e_num),
            torch.tensor(n - CFG["OPTIMIZATION_WINDOW"]), torch.tensor(n),
            torch.from_numpy(blob), M=slam.M, pmem=slam.pmem, mem=slam.mem,
            n_cap=slam.n_cap, k_cap=k_cap, iterations=2, has_mm=True,
            mm_cap=MM_CAP)
    return ds, mag


@pytest.fixture(scope="module")
def at_covers(drive):  # noqa: F811
    _, _, slam = drive
    exact = run_at(slam, BUCKET, slam.k_cap)
    covers = {(b, k): run_at(slam, b, k) for b, k in (
        (1024, slam.k_cap), (1536, slam.k_cap), (2048, slam.k_cap),
        (2048, 4 * slam.k_cap))}
    return slam.hs.e_num, exact, covers


def test_update_at_a_cover_equals_the_exact_bucket(at_covers):
    e, (ref, ref_mag), covers = at_covers
    for (bucket, k_cap), (got, mag) in covers.items():
        for name in ("net", "target", "weight"):
            np.testing.assert_allclose(
                getattr(got, name)[:e].numpy(), getattr(ref, name)[:e].numpy(),
                rtol=0, atol=ATOL_COVER, err_msg=f"{name} at {bucket}")
            # the rows past the live count stay zero, as the tables hold them
            assert not getattr(got, name)[e:].any()
        for name in ("poses", "patches"):
            np.testing.assert_allclose(
                getattr(got, name).numpy(), getattr(ref, name).numpy(),
                rtol=0, atol=ATOL_COVER, err_msg=f"{name} at {bucket}")
        assert abs(float(mag) - float(ref_mag)) <= ATOL_COVER


def test_update_at_a_cover_matches_jax_at_the_exact_bucket(
        at_covers, updates):  # noqa: F811
    e, _, covers = at_covers
    want = updates["want"]
    got, _ = covers[max(covers)]       # the top bucket, 4 times the k_cap
    for name in ("net", "target", "weight"):
        np.testing.assert_allclose(getattr(got, name)[:e].numpy(),
                                   want[name][:e], atol=ATOL_NET,
                                   err_msg=name)
    np.testing.assert_allclose(got.poses.numpy(), want["poses"],
                               atol=ATOL_POSE)
    np.testing.assert_allclose(got.patches.numpy(), want["patches"],
                               atol=ATOL_DEPTH)


# recipe 4 of the verify notes with a two-step ladder: the drives' live
# edges (under 1024) ask for bucket 1024, the covers are 1536 (and 2048)
SMALL = dict(BUFFER_SIZE=64, PATCHES_PER_FRAME=8, REMOVAL_WINDOW=7,
             OPTIMIZATION_WINDOW=5, PATCH_LIFETIME=5, KEYFRAME_INDEX=4,
             KEYFRAME_THRESH=1e9, MIXED_PRECISION=False, EDGE_CAPACITY=1536,
             BUCKET_FLOOR=1024, BA_WINDOW_CAP=8)
LC = dict(SMALL, REMOVAL_WINDOW=6, KEYFRAME_THRESH=0.0, LOOP_CLOSURE=True,
          GLOBAL_OPT_FREQ=10, BACKEND_THRESH=1e9, MAX_EDGE_AGE=64,
          EDGE_CAPACITY=2048)
DRIVES = {"merge": (SMALL, 16), "lc": (LC, 36)}   # LC: global BA at 35


def small_drive(cfg, n_frames, covered):
    """The lagged merge drive (or its loop-closure form); with ``covered``
    every update replays a captured cover of the ladder above 1024 at a
    patch capacity past any the drive asks for, its own capture never
    landing.  -> (engine, poses)."""
    slam = DPVO(VOConfig(**cfg), network=None, ht=96, wd=128, device="cpu")
    slam.motion_probe = lambda: 100.0
    asked = []
    if covered:
        graphed(slam)
        slam._capture_later = asked.append
        cap = 1 << (slam.N * slam.M + 8).bit_length()
        for bucket in slam._bucket_ladder()[1:]:
            for run_ba in (True, False):
                key = slam._update_key(bucket, run_ba, True, cap)
                slam._graphs[key] = stub_record(slam._update_program(*key))
    base = np.random.default_rng(0).integers(0, 255, (96, 256, 3), np.uint8)
    for t in range(n_frames):
        slam(t, np.ascontiguousarray(np.roll(base, -3 * t, axis=1)[:, :128]),
             np.array([64.0, 64.0, 64.0, 48.0]))
    poses, _ = slam.terminate()
    if covered:
        updates_run = sum(slam.buckets_seen.values())
        assert sum(slam.cover_served.values()) == updates_run > 12
        assert set(asked) == set(slam.cover_served)
        assert set(slam.buckets_seen) == {1024}
    return slam, poses


@pytest.mark.parametrize("name", sorted(DRIVES))
def test_drive_at_covers_equals_the_drive_at_exact_buckets(name):
    cfg, n_frames = DRIVES[name]
    ref, want = small_drive(cfg, n_frames, covered=False)
    got_slam, got = small_drive(cfg, n_frames, covered=True)
    assert got_slam.buckets_seen == ref.buckets_seen
    for a, b in ((got_slam.hs, ref.hs),):
        assert (a.n, a.e_num, a.n_inac) == (b.n, b.e_num, b.n_inac)
        for k in ("ii", "jj", "kk"):
            assert np.array_equal(getattr(a, k)[:a.e_num],
                                  getattr(b, k)[:b.e_num])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_COVER)
    if name == "merge":
        assert got_slam.hs.delta                 # merges applied
    else:
        assert ref.ran_global_ba[35]             # after the loop proposals
        # the updates without local BA (global BA's) ran at their cover too
        assert any(not k[1] for k in got_slam.cover_served)


# --- (c) the guard's dispatch with a stand-in capturer ----------------------

def stub_engine():
    """A small CPU engine after 3 frames (live edges, not initialised),
    dispatching through the graph code with stand-in graphs, its update
    program a no-op."""
    slam = DPVO(VOConfig(**SMALL), network=None, ht=96, wd=128, device="cpu")
    slam.motion_probe = lambda: 100.0
    base = np.random.default_rng(0).integers(0, 255, (96, 128, 3), np.uint8)
    for t in range(3):
        slam(t, base, np.array([64.0, 64.0, 64.0, 48.0]))
    assert slam.hs.e_num > 0
    graphed(slam)
    slam._update_program = keyed_noop
    return slam


def keyed_noop(*key):
    """A no-op update program that knows its key."""
    def program():
        return None
    program.key = key
    return program


def cover_and_exact(slam):
    """The ladder's top (1536) captured, the update at 1024 cold."""
    cover = slam._update_key(1536, True, True, slam.k_cap)
    slam._graphs[cover] = stub_record(lambda: None)
    return cover, slam._update_key(1024, True, True, slam.k_cap)


def gated_record(gate=None, fail=None):
    """A stand-in ``_record`` whose captures off the calling thread (the
    worker's) wait for ``gate`` or raise ``fail``; -> (record, the calls:
    (thread, off the calling thread, the program's key or None))."""
    calls, main = [], threading.get_ident()

    def record(program, draws=False):
        background = threading.get_ident() != main
        calls.append((threading.get_ident(), background,
                      getattr(program, "key", None)))
        if background and gate is not None:
            assert gate.wait(10)
        if background and fail is not None:
            raise fail
        return stub_record(program)
    return record, calls


def test_cold_key_with_a_cover_replays_it_and_is_captured_once():
    slam = stub_engine()
    cover, exact = cover_and_exact(slam)
    gate = threading.Event()
    slam._record, calls = gated_record(gate)
    replayed = []
    replay = slam._replay
    slam._replay = lambda key: (replayed.append(key), replay(key))[1]
    for _ in range(3):
        slam._call_update_step(1024, True, True, slam.k_cap)
    assert replayed == [cover] * 3
    assert slam.cover_served == {exact: 3}
    assert slam.buckets_seen == {1024: 3}          # the bucket asked for
    assert list(slam._in_flight) == [exact] and exact not in slam._graphs
    gate.set()
    slam._wait_captures()
    assert not slam._in_flight and exact in slam._graphs
    assert exact in slam.background_capture_ms and not slam.graph_capture_ms
    assert [(b, k) for _, b, k in calls] == [(True, exact)]
    assert calls[0][0] != threading.get_ident()   # off the caller's thread
    slam._call_update_step(1024, True, True, slam.k_cap)
    assert replayed[-1] == exact and slam.cover_served == {exact: 3}
    slam.terminate()
    assert slam._worker is None


def test_a_traced_ask_parents_the_workers_capture():
    """In a traced call, the worker's capture of a cold key is a ``capture``
    span on the worker's thread, in the asking call's frame, under the
    span that asked (here ``update/step``); the cover's replay is a span
    named after the program under the same span."""
    from dpvo_tpu_torch.utils import timing
    slam = stub_engine()
    cover, exact = cover_and_exact(slam)
    gate = threading.Event()
    slam._record, _ = gated_record(gate)
    tr = slam._tr = slam.tracer.begin_call(slam.hs.counter)
    step = tr.begin("update/step")
    slam._call_update_step(1024, True, True, slam.k_cap)
    step.end()
    slam._tr = None
    tr.end_call()
    gate.set()
    slam._wait_captures()
    spans = [x for x in timing.SPANS if x.engine == slam.tracer.engine]
    (cap,) = [x for x in spans if x.name == "capture"]
    (run,) = [x for x in spans if x.name == "update_step_dev"]
    assert cap.parent == run.parent == step.id
    assert cap.frame == run.frame == slam.hs.counter
    assert cap.thread != threading.get_ident() == run.thread
    assert exact in slam._graphs
    slam.terminate()


@pytest.mark.parametrize("graphs", ["none", "smaller", "capacity", "version",
                                    "local_ba"])
def test_cold_key_without_a_cover_is_captured_here(graphs):
    slam = stub_engine()
    k = slam.k_cap
    other = {"none": None, "smaller": (1024, True, True, k, VERSION),
             "capacity": (1536, True, True, k // 2, VERSION),
             "version": (1536, True, True, k, VERSION + 1),
             "local_ba": (1536, False, True, k, VERSION)}[graphs]
    if other is not None:
        slam._graphs[other] = stub_record(lambda: None)
    slam._record, calls = gated_record()
    slam._call_update_step(1536, True, True, k)
    key = slam._update_key(1536, True, True, k)
    assert key in slam._graphs and key in slam.graph_capture_ms
    assert calls == [(threading.get_ident(), False, key)]
    assert not slam._in_flight and not slam.cover_served
    assert slam._worker is None


@pytest.mark.parametrize("entry", ["update", "precompile", "terminate"])
def test_failed_background_capture_raises_on_the_engine_thread(entry):
    slam = stub_engine()
    cover_and_exact(slam)
    slam._record, _ = gated_record(fail=RuntimeError("capture refused"))
    slam._call_update_step(1024, True, True, slam.k_cap)
    fut = next(iter(slam._in_flight.values()))
    assert isinstance(fut.exception(timeout=10), RuntimeError)
    with pytest.raises(RuntimeError, match="capture refused") as info:
        getattr(slam, entry)()
    # the worker's traceback comes with it
    frames = [f.name for f in traceback.extract_tb(info.value.__traceback__)]
    assert "record" in frames and "_capture_off_thread" in frames
    slam._worker.shutdown()


@pytest.mark.parametrize("entry", ["precompile", "terminate"])
def test_precompile_and_terminate_wait_for_a_capture_in_flight(entry):
    slam = stub_engine()
    cover, exact = cover_and_exact(slam)
    gate = threading.Event()
    slam._record, _ = gated_record(gate)
    slam._call_update_step(1024, True, True, slam.k_cap)
    assert list(slam._in_flight) == [exact]
    t0 = time.perf_counter()
    threading.Timer(0.3, gate.set).start()
    out = (slam.precompile(max_edges=1000) if entry == "precompile"
           else slam.terminate())
    assert time.perf_counter() - t0 >= 0.25
    assert exact in slam.background_capture_ms
    assert not slam._in_flight
    if entry == "precompile":
        # the plan's 1024 and 1536 update keys: the worker's and the cover
        assert exact not in out["ms"] and cover not in out["ms"]
        assert exact in slam._graphs and len(out["ms"]) == 2   # track, merge
        slam.terminate()
    assert slam._worker is None


def running_capture(slam, calls, first):
    """Ask ``first`` (bucket 1024 and a patch capacity a cover serves) and
    wait until the worker's capture of it is open."""
    slam._call_update_step(1024, True, True, first)
    t0 = time.perf_counter()
    while not calls and time.perf_counter() - t0 < 10:
        time.sleep(0.001)
    assert len(calls) == 1 and calls[0][1]


def test_worker_takes_the_key_asked_last_first():
    """While one capture is open, keys queue; the worker then takes the key
    a cover served last first, and each key once."""
    slam = stub_engine()
    cover_and_exact(slam)
    gate = threading.Event()
    slam._record, calls = gated_record(gate)
    a, b, c, d = (slam.k_cap >> i for i in range(4))
    running_capture(slam, calls, a)
    for k_cap in (b, c, d, b):
        slam._call_update_step(1024, True, True, k_cap)
    gate.set()
    slam._wait_captures()
    order = [k[3] for _, _, k in calls]
    assert order == [a, b, d, c], order
    assert not slam._in_flight and slam.cover_served[
        slam._update_key(1024, True, True, b)] == 2
    slam.terminate()


def test_a_capture_here_waits_for_the_running_capture_only():
    """A cold key with no cover, asked while the worker holds one capture
    open and two more keys queue: the call waits for the open capture, the
    queued keys are dropped, not captured, and the key is captured here;
    a dropped key asked again is scheduled again and lands."""
    slam = stub_engine()
    cover_and_exact(slam)
    gate = threading.Event()
    slam._record, calls = gated_record(gate)
    a, b, c = (slam.k_cap >> i for i in range(3))
    running_capture(slam, calls, a)
    for k_cap in (b, c):
        slam._call_update_step(1024, True, True, k_cap)
    assert len(slam._in_flight) == 3
    t0 = time.perf_counter()
    threading.Timer(0.3, gate.set).start()
    slam._call_update_step(1536, False, True, slam.k_cap)   # no cover
    assert time.perf_counter() - t0 >= 0.25
    here = slam._update_key(1536, False, True, slam.k_cap)
    assert [(bg, k) for _, bg, k in calls] == [
        (True, slam._update_key(1024, True, True, a)), (False, here)]
    assert not slam._in_flight and here in slam.graph_capture_ms
    dropped = [slam._update_key(1024, True, True, k) for k in (b, c)]
    assert not set(dropped) & set(slam._graphs)
    slam._call_update_step(1024, True, True, b)
    slam._wait_captures()
    assert dropped[0] in slam._graphs and dropped[1] not in slam._graphs
    assert [k for _, _, k in calls[2:]] == [dropped[0]]
    slam.terminate()


def test_captures_under_a_short_switch_interval():
    """300 updates over 15 cold keys a cover serves while the worker
    captures them, the interpreter switching threads every microsecond:
    each key is captured once and lands, and every update replays the
    cover, a published key that covers it, or its own graph."""
    slam = stub_engine()
    cover, _ = cover_and_exact(slam)
    recorded, main = collections.Counter(), threading.get_ident()

    def record(program, draws=False):
        recorded[threading.get_ident() != main] += 1
        time.sleep(0.001)
        return stub_record(program)
    slam._record = record
    replayed = collections.Counter()
    replay = slam._replay
    slam._replay = lambda key: (replayed.update([key]), replay(key))[1]
    asked = [(b, slam.k_cap >> i) for b in (1024, 1536) for i in range(8)
             if (b, i) != (1536, 0)]
    rng = np.random.default_rng(1)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for j in rng.integers(0, len(asked), 300):
            slam._call_update_step(asked[j][0], True, True, asked[j][1])
        slam._wait_captures()
    finally:
        sys.setswitchinterval(old)
    keys = {slam._update_key(b, True, True, k) for b, k in asked}
    assert recorded == {True: len(keys)}
    assert keys <= set(slam._graphs) and not slam._in_flight
    # a published key covers smaller ones too, as JAX's warm buckets do
    assert sum(replayed.values()) == 300
    assert set(replayed) <= keys | {cover}
    assert 0 < replayed[cover] <= sum(slam.cover_served.values()) < 300
    slam.terminate()


def test_capture_counts_are_per_thread():
    saved = collections.Counter(_cuda.launches)
    inside, done, result = threading.Event(), threading.Event(), []

    def capture():
        with _cuda.captured_launches() as captured:
            _cuda.count("corr_enc")
            inside.set()
            assert done.wait(10)
            with _cuda.captured_launches() as nested:
                _cuda.count("segment_sums")
            _cuda.count("segment_sums")
        _cuda.count("corr_enc")               # after the capture: global
        result.append((captured, nested))

    try:
        _cuda.reset_launches()
        worker = threading.Thread(target=capture)
        worker.start()
        assert inside.wait(10)
        _cuda.count("corr_enc")               # the engine thread meanwhile
        _cuda.count("segment_softmax_sums")
        done.set()
        worker.join()
        captured, nested = result[0]
        assert dict(captured) == {"corr_enc": 1, "segment_sums": 1}
        assert dict(nested) == {"segment_sums": 1}
        assert dict(_cuda.launches) == {"corr_enc": 2,
                                        "segment_softmax_sums": 1}
    finally:
        _cuda.reset_launches()
        _cuda.launches.update(saved)


# --- (d) the JAX package's last public names -------------------------------

def t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("norm_fn", ["instance", "none"])
def test_basic_encoder_matches_jax(norm_fn):
    from dpvo_tpu.models import encoder as jenc
    from dpvo_tpu_torch.models import BasicEncoder
    x = np.random.default_rng(0).normal(size=(1, 32, 48, 3)).astype(
        np.float32)
    jm = jenc.BasicEncoder(output_dim=64, norm_fn=norm_fn)
    params = jm.init(KEY, jnp.asarray(x))
    want = jm.apply(params, jnp.asarray(x))
    tm = BasicEncoder(output_dim=64, norm_fn=norm_fn)
    tm.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = tm.eval()(t(x))
    assert got.shape == want.shape == (1, 4, 6, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_MODEL)


def test_vonet_matches_jax():
    from dpvo_tpu.models import vonet as jvonet
    from dpvo_tpu_torch.models import DIM, VONet
    rng = np.random.default_rng(1)
    E = 24
    img = (2.0 * rng.uniform(size=(1, 32, 48, 3)) - 0.5).astype(np.float32)
    coords = rng.uniform(1, 11, (1, 6, 2)).astype(np.float32)
    ii = rng.integers(0, 4, E).astype(np.int32)
    jj = (ii + rng.integers(1, 3, E)).astype(np.int32)
    kk = (ii * 6 + rng.integers(0, 6, E)).astype(np.int32)
    net = rng.normal(size=(E, DIM)).astype(np.float32)
    inp = rng.normal(size=(E, DIM)).astype(np.float32)
    corr = rng.normal(size=(E, 2 * 49 * 9)).astype(np.float32)
    valid = np.arange(E) < E - 3
    args = (img, coords, net, inp, corr, ii, jj, kk, valid)
    jm = jvonet.VONet()
    params = jm.init(KEY, *map(jnp.asarray, args))
    want = jm.apply(params, *map(jnp.asarray, args))
    tm = VONet()
    tm.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = tm.eval()(*map(t, args))
    got_flat = [*got[0], *got[1]]
    want_flat = [*want[0], *want[1]]
    assert len(got_flat) == len(want_flat) == 9
    for a, b in zip(got_flat, want_flat):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL_MODEL)


def test_corr_stack_matches_jax():
    from dpvo_tpu.ops import corr as jcorr
    from dpvo_tpu_torch.ops import corr as tcorr
    rng = np.random.default_rng(2)
    K, F, E, C = 10, 3, 40, 16
    gmap = rng.normal(size=(K, 3, 3, C)).astype(np.float32)
    f1 = rng.normal(size=(F, 16, 20, C)).astype(np.float32)
    f2 = rng.normal(size=(F, 4, 5, C)).astype(np.float32)
    coords = rng.uniform(-2, 22, (E, 2, 3, 3)).astype(np.float32)
    kidx = rng.integers(0, K, E).astype(np.int32)
    fidx = rng.integers(0, F, E).astype(np.int32)
    want = jcorr.corr_stack(jnp.asarray(gmap), [(1, jnp.asarray(f1)),
                                                (4, jnp.asarray(f2))],
                            *map(jnp.asarray, (coords, kidx, fidx)))
    got = tcorr.corr_stack(t(gmap), [(1, t(f1)), (4, t(f2))],
                           *map(t, (coords, kidx, fidx)))
    assert got.shape == want.shape == (E, 2 * 49 * 9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_CORR)


@pytest.mark.parametrize("e_num", [0, 57, 80])
def test_neighbors_host_equals_jax(e_num):
    from dpvo_tpu.ops import graph as jgraph
    from dpvo_tpu_torch.ops import graph as tgraph
    rng = np.random.default_rng(e_num)
    kk = rng.integers(0, 12, 80).astype(np.int32)
    jj = rng.integers(0, 9, 80).astype(np.int32)
    want = jgraph.neighbors_host(kk, jj, e_num)
    got = tgraph.neighbors_host(kk, jj, e_num)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # the same as the device form on the valid rows
    ix, jx = tgraph.neighbors(t(kk), t(jj), t(np.arange(80) < e_num))
    assert np.array_equal(got[0], ix.numpy()) and np.array_equal(
        got[1], jx.numpy())


def test_se3_to_sim3_log_inv_matches_jax():
    from dpvo_tpu.loop_closure import pgo as jpgo
    from dpvo_tpu_torch.loop_closure import pgo as tpgo
    rng = np.random.default_rng(4)
    q = rng.normal(size=(16, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    poses = np.concatenate([rng.normal(size=(16, 3)), q], 1).astype(
        np.float32)
    want = jpgo.se3_to_sim3_log_inv(jnp.asarray(poses))
    got = tpgo.se3_to_sim3_log_inv(t(poses))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_profile_trace_writes_a_trace(tmp_path):
    from dpvo_tpu_torch.utils.timing import profile_trace
    with profile_trace(tmp_path / "trace") as tr:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tr.path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


@pytest.mark.parametrize("package", ["models", "ops", "engine", "parallel"])
def test_package_exports_cover_jax(package):
    want = importlib.import_module(f"dpvo_tpu.{package}").__all__
    port = importlib.import_module(f"dpvo_tpu_torch.{package}")
    assert set(want) <= set(port.__all__)
    for name in port.__all__:
        assert getattr(port, name) is not None
