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
patches and intrinsics (the edge tables are equal).  With timing off the
fence is never reached, and ``bench_torch.run_regime(..., timing=True)``
returns all nine phases.
"""
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from dpvo_tpu.config import VOConfig as JaxConfig
from dpvo_tpu.engine import DPVO as JaxDPVO
from dpvo_tpu_torch.config import VOConfig
from dpvo_tpu_torch.engine import DPVO
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
    assert slam.timings == {}


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
    """With timing off (the default) no phase is recorded and neither the
    fence nor a device synchronise is reached; on the CPU, timing on
    records the phases without a device synchronise."""
    def boom(*a, **k):
        raise AssertionError("fenced with timing off")

    monkeypatch.setattr(DPVO, "_fence", boom)
    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    slam = seams(DPVO(VOConfig(**LAGGED), ht=HT, wd=WD, device="cpu"))
    assert not slam.enable_timing and slam.timing_block
    for t, img in enumerate(make_frames()):
        slam(t, img, INTR)
    assert slam.timings == {} and slam.timing_report() == {}
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
