"""The port's engine with the classic loop-closure backend
(``CLASSIC_LOOP_CLOSURE=True``) on the CPU.

- construction: it builds where ``cv2`` imports, and raises an
  ``ImportError`` naming ``cv2``, before any worker process starts, where
  it does not;
- the engine hooks against the JAX engine's: a recorder in the backend's
  place sees the same calls in the same order (each frame with its
  keyframe index, each merge's removed index as the lagged decision
  applies, the attempt and merge after every tracked frame, ``terminate``)
  on tests/test_torch_async.py's lagged always-merge drive;
- one drive of the real backend on a revisit sequence (a texture whose
  roll repeats every 64 frames, 60 frames so that the BoW vocabulary
  trains at 50): retrieval finds the place again, a closure is merged and
  every pose is finite.  The JAX package's retrieval runs in a child
  process whose timing decides the hits, so this drive is not held to
  the JAX engine; tests/test_torch_classic_lc.py holds the pieces.
"""
import multiprocessing as mp
import sys

import cv2
import jax
import numpy as np
import pytest
import torch

from dpvo_tpu.config import VOConfig as JaxConfig
from dpvo_tpu.engine import DPVO as JaxDPVO
from dpvo_tpu_torch.config import VOConfig
from dpvo_tpu_torch.engine import DPVO
from dpvo_tpu_torch.loop_closure.long_term import LongTermLoopClosure
from dpvo_tpu_torch.utils.checkpoint import params_from_jax
from test_torch_async import LAGGED, _LatePool
from test_torch_engine import HT, WD, drive, make_frames

torch.set_num_threads(1)

SMALL = dict(BUFFER_SIZE=128, PATCHES_PER_FRAME=8, REMOVAL_WINDOW=7,
             OPTIMIZATION_WINDOW=5, PATCH_LIFETIME=5, KEYFRAME_INDEX=4,
             KEYFRAME_THRESH=0.0, MIXED_PRECISION=False, EDGE_CAPACITY=1024,
             BA_WINDOW_CAP=8, ASYNC_KEYFRAME=False)


def test_classic_constructs_and_raises_without_cv2(monkeypatch):
    slam = DPVO(VOConfig(**SMALL, CLASSIC_LOOP_CLOSURE=True), ht=HT, wd=WD,
                device="cpu")
    assert isinstance(slam.long_term_lc, LongTermLoopClosure)
    slam.long_term_lc.terminate(slam.n)
    assert not mp.active_children()

    monkeypatch.setitem(sys.modules, "cv2", None)     # import cv2 fails
    for lc in (False, True):
        with pytest.raises(ImportError, match="cv2"):
            DPVO(VOConfig(**SMALL, CLASSIC_LOOP_CLOSURE=True,
                          LOOP_CLOSURE=lc), ht=HT, wd=WD, device="cpu")
        assert not mp.active_children()


class Recorder:
    """Stands in for the backend and records every call the engine
    makes."""

    def __init__(self):
        self.calls = []

    def __call__(self, image, n):
        image = np.asarray(image)
        self.calls.append(("frame", n, image.shape, str(image.dtype),
                           int(image.sum())))

    def keyframe(self, k):
        self.calls.append(("keyframe", k))

    def attempt_loop_closure(self, n):
        self.calls.append(("attempt", n))

    def lc_callback(self):
        self.calls.append(("callback",))

    def terminate(self, n):
        self.calls.append(("terminate", n))


def test_hooks_follow_lagged_merges_like_jax():
    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    try:
        jcfg = JaxConfig(**LAGGED, CORR_BACKEND="xla")
        init = JaxDPVO(jcfg, network=None, ht=HT, wd=WD)
        p = jax.tree.map(np.asarray, init.params_patchify)
        u = jax.tree.map(np.asarray, init.params_update)
        for k in ("kernel", "bias"):
            u["params"]["d"][k] = u["params"]["d"][k] * 0.02
        jslam = JaxDPVO(jcfg, network=(p, u), ht=HT, wd=WD)
        jslam._mag_pool.shutdown(wait=False)
        jslam._mag_pool = _LatePool()
        jslam.long_term_lc = ref = Recorder()
        drive(jslam, make_frames())
    finally:
        jax.config.update("jax_default_matmul_precision", old)
    slam = DPVO(VOConfig(**LAGGED), network=params_from_jax(p, u), ht=HT,
                wd=WD, device="cpu")
    slam.long_term_lc = mine = Recorder()
    drive(slam, make_frames())
    assert mine.calls == ref.calls
    kinds = [c[0] for c in mine.calls]
    assert kinds.count("keyframe") > 0 and kinds[-1] == "terminate"
    assert kinds.count("frame") == len(make_frames())


def test_classic_drive_closes_a_loop():
    ht, wd, roll, period, n_frames = 96, 128, 4, 64, 60
    slam = DPVO(VOConfig(**SMALL, CLASSIC_LOOP_CLOSURE=True), ht=ht, wd=wd,
                device="cpu")
    with torch.no_grad():          # stay in the smooth regime
        slam.update_mod.d.weight.mul_(0.02)
        slam.update_mod.d.bias.mul_(0.02)
    slam.motion_probe = lambda: 100.0
    lc = slam.long_term_lc
    merged = []
    merge = lc.merge

    def record(corrected):
        merged.append((slam.n, len(corrected)))
        merge(corrected)

    lc.merge = record
    rng = np.random.default_rng(7)
    base = cv2.GaussianBlur(rng.integers(0, 255, (ht, roll * period, 3),
                                         np.uint8), (5, 5), 0)
    intr = np.array([wd / 2, wd / 2, wd / 2, ht / 2])
    for t in range(n_frames):
        slam(t, np.ascontiguousarray(np.roll(base, -roll * t, 1)[:, :wd]),
             intr)
    poses, tstamps = slam.terminate()
    assert lc.retrieval.found, "retrieval found no loop"
    assert merged, "no pose-graph result was merged"
    assert all(0 < m <= n for n, m in merged)
    assert poses.shape == (n_frames, 7) and np.isfinite(poses).all()
    assert not mp.active_children()
