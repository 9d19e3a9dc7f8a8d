"""The port's engine with lagged keyframe decisions (``ASYNC_KEYFRAME=True``,
the default) against the JAX engine on CPU.

The drive is tests/test_torch_engine.py's always-merge one (16 synthetic
96x128 frames, tiny config, the same weights, scripted centroids, fixed
pre-init depth, motion_probe forced, fp32) with a small lag,
``ASYNC_KEYFRAME_LAG=3`` and ``ASYNC_KEYFRAME_BATCH=2``, so batches apply
within the 16 frames.

The JAX engine applies a batch as soon as its background fetch has landed,
and at the latest when it is overdue.  Here its fetch pool is swapped, in
this test alone, for a stub whose futures report ``done()`` False until
``result()`` is called, so every batch applies exactly when overdue: the
port's deterministic schedule.  Structure is asserted exactly (keyframe
count, live edges, keyframe timestamps, delta keys); the trajectory within
the always-merge envelope of tests/test_engine_parity.py, translation 5e-2
and quaternion dot > 1-1e-3.  The lagged structure must differ from the
synchronous one, so the test sees the lag.
"""
import numpy as np
import jax
import pytest
import torch

from dpvo_tpu.config import VOConfig as JaxConfig
from dpvo_tpu.engine import DPVO as JaxDPVO
from dpvo_tpu_torch.config import VOConfig
from dpvo_tpu_torch.engine import DPVO
from dpvo_tpu_torch.utils.checkpoint import params_from_jax
from test_torch_engine import HT, N_FRAMES, TINY, WD, drive, make_frames

torch.set_num_threads(1)

LAGGED = {**TINY, "ASYNC_KEYFRAME": True, "ASYNC_KEYFRAME_LAG": 3,
          "ASYNC_KEYFRAME_BATCH": 2, "KEYFRAME_THRESH": 1e9}
ATOL_T, ATOL_Q = 5e-2, 1e-3


class _LateFuture:
    """Reports not done until its result is asked for."""

    def __init__(self, fn, args):
        self._fn, self._args = fn, args

    def done(self):
        return False

    def result(self):
        return self._fn(*self._args)


class _LatePool:
    def submit(self, fn, *args):
        return _LateFuture(fn, args)

    def shutdown(self, **_):
        pass


@pytest.fixture(scope="module")
def lagged():
    """(JAX drive, port drive, port drive with synchronous decisions)."""
    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    try:
        jcfg = JaxConfig(**LAGGED, CORR_BACKEND="xla")
        init = JaxDPVO(jcfg, network=None, ht=HT, wd=WD)
        p = jax.tree.map(np.asarray, init.params_patchify)
        u = jax.tree.map(np.asarray, init.params_update)
        for k in ("kernel", "bias"):
            u["params"]["d"][k] = u["params"]["d"][k] * 0.02
        slam = JaxDPVO(jcfg, network=(p, u), ht=HT, wd=WD)
        slam._mag_pool.shutdown(wait=False)
        slam._mag_pool = _LatePool()
        ref = drive(slam, make_frames())
    finally:
        jax.config.update("jax_default_matmul_precision", old)
    network = params_from_jax(p, u)
    port = drive(DPVO(VOConfig(**LAGGED), network=network, ht=HT, wd=WD,
                      device="cpu"), make_frames())
    sync = drive(DPVO(VOConfig(**{**LAGGED, "ASYNC_KEYFRAME": False}),
                      network=network, ht=HT, wd=WD, device="cpu"),
                 make_frames())
    return ref, port, sync


def test_lagged_structure_matches_jax(lagged):
    (_, t_ref, s_ref), (_, t_my, s_my), _ = lagged
    assert s_my[0] == s_ref[0], (s_my, s_ref)
    assert s_my[1] == s_ref[1], (s_my, s_ref)
    np.testing.assert_array_equal(s_my[2], s_ref[2])
    assert s_my[3] == s_ref[3]
    np.testing.assert_array_equal(t_my, t_ref)
    assert s_my[0] < N_FRAMES and len(s_my[3]) > 0


def test_lagged_trajectory_matches_jax(lagged):
    (p_ref, _, _), (p_my, _, _), _ = lagged
    assert p_my.shape == p_ref.shape == (N_FRAMES, 7)
    assert np.isfinite(p_my).all()
    np.testing.assert_allclose(p_my[:, :3], p_ref[:, :3], atol=ATOL_T)
    qd = np.abs(np.sum(p_my[:, 3:] * p_ref[:, 3:], axis=-1))
    qn = (np.linalg.norm(p_my[:, 3:], axis=-1)
          * np.linalg.norm(p_ref[:, 3:], axis=-1))
    assert np.all(qd / np.maximum(qn, 1e-12) > 1 - ATOL_Q)


def test_lagged_structure_differs_from_synchronous(lagged):
    """The lag keeps frames waiting for their decision alive longer."""
    _, (_, _, s_lag), (_, _, s_sync) = lagged
    assert s_lag[0] > s_sync[0]
    assert s_lag[1] != s_sync[1]
    assert s_lag[3] != s_sync[3]


def test_lagged_batches_apply_when_overdue():
    """Each batch applies at the first keyframe() where it is overdue,
    never earlier, and terminate() drops what is pending."""
    slam = DPVO(VOConfig(**LAGGED), ht=HT, wd=WD, device="cpu", seed=3)
    slam.motion_probe = lambda: 100.0
    applied = []
    apply = slam._keyframe_apply

    def record(m, tcand):
        applied.append((slam._kf_clock, tcand))
        apply(m, tcand)

    slam._keyframe_apply = record
    for t, img in enumerate(make_frames()[:12]):
        queued = [(b[3], len(b[2])) for b in slam._kf_queue]
        slam(t, img, np.array([64.0, 64.0, 64.0, 48.0]))
        lag, b_eff = LAGGED["ASYNC_KEYFRAME_LAG"], slam._b_eff
        for *_, clock in slam._kf_queue:
            assert slam._kf_clock - clock + b_eff - 1 < lag
        for clock, n in queued:
            if slam._kf_clock - clock + b_eff - 1 >= lag:
                assert sum(c == slam._kf_clock for c, _ in applied) >= n
    # the 12 initial updates share one candidate; it is decided first
    assert applied and applied[0][0] == 2 and len(
        [1 for _, tc in applied if tc == applied[0][1]]) == 12
    assert slam._mag_pending or slam._kf_queue
    slam.terminate()
    assert not slam._mag_pending and not slam._kf_queue
