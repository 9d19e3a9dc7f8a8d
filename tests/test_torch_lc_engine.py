"""The port's loop-closure engine against one JAX engine drive on CPU.

tests/test_torch_engine.py's 16-frame drive (96x128 frames, the same
weights carried across with ``params_from_jax``, flow-delta head scaled by
0.02, scripted centroids, fixed pre-init depth, motion_probe forced, fp32)
at ``TINY`` with ``REMOVAL_WINDOW=6``, ``LOOP_CLOSURE=True`` and
``BACKEND_THRESH=1e9``, in the never-merge regime: retired edges fill the
inactive store, global BA runs at initialisation (frame 0 is still live
when n = 8) and at n = 9, each time after ``normalize``.  It runs with
synchronous decisions and with lagged ones (LAG 3, BATCH 2; on the JAX side
tests/test_torch_async.py's stubbed fetch pool, so each batch applies
exactly when overdue, as the port's do).

Structure is asserted exactly: keyframes, live and inactive edges, the
inactive index arrays, the keyframe counts that ran global BA, the delta
keys.  Poses within the never-merge envelope of tests/test_engine_parity.py
(translation 5e-3, quaternion dot > 1-1e-4).  Under lagged decisions the
magnitudes each update queues while tracking must equal JAX's within 1e-3
px: in a global-branch update both take them before global BA, and after
it they would differ by 4e-3 to 1.2e-2 px on this drive.  (Thresholds 0 and
1e9 make every decision the same either way, so the structure cannot show
it.)  One JAX drive per timing.
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
from test_torch_async import _LatePool
from test_torch_engine import (DEPTH0, HT, INTR, TINY, WD, centroid_grid,
                               make_frames)

torch.set_num_threads(1)

ATOL_T, ATOL_Q = 5e-3, 1e-4          # the never-merge envelope
ATOL_MAG = 1e-3                      # px
LC = {**TINY, "REMOVAL_WINDOW": 6, "LOOP_CLOSURE": True,
      "BACKEND_THRESH": 1e9, "KEYFRAME_THRESH": 0.0}
LAG = {"ASYNC_KEYFRAME": True, "ASYNC_KEYFRAME_LAG": 3,
       "ASYNC_KEYFRAME_BATCH": 2}


def _record_mags(slam):
    """Wrap ``slam.update`` to record, per update that queues a keyframe
    magnitude: (n, global branch taken, candidate timestamp, magnitude)."""
    log = []
    update = slam.update

    def wrapped():
        n, before = slam.n, len(slam._mag_pending)
        ran = bool(slam.ran_global_ba[n])
        update()
        if len(slam._mag_pending) > before:
            mag, tcand = slam._mag_pending[-1]
            log.append((n, not ran and bool(slam.ran_global_ba[n]), tcand,
                        float(mag)))

    slam.update = wrapped
    return log


def _drive(slam):
    slam.motion_probe = lambda: 100.0
    slam.test_centroids = centroid_grid
    slam.test_fixed_depth = DEPTH0
    mags = _record_mags(slam)
    for i, img in enumerate(make_frames()):
        slam(i, img, INTR)
    hs = slam.hs
    state = dict(n=slam.n, e_num=hs.e_num, n_inac=hs.n_inac,
                 ii_inac=np.asarray(hs.ii_inac).tolist(),
                 jj_inac=np.asarray(hs.jj_inac).tolist(),
                 kk_inac=np.asarray(hs.kk_inac).tolist(),
                 global_ba=np.nonzero(slam.ran_global_ba)[0].tolist(),
                 delta=sorted(hs.delta))
    tracked = list(mags)
    poses, _ = slam.terminate()
    return poses, state, tracked


@pytest.fixture(scope="module", params=["sync", "lagged"])
def lc_drives(request):
    cfg = {**LC, **(LAG if request.param == "lagged" else {})}
    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    try:
        jcfg = JaxConfig(**cfg, CORR_BACKEND="xla")
        init = JaxDPVO(jcfg, network=None, ht=HT, wd=WD)
        p = jax.tree.map(np.asarray, init.params_patchify)
        u = jax.tree.map(np.asarray, init.params_update)
        for k in ("kernel", "bias"):
            u["params"]["d"][k] = u["params"]["d"][k] * 0.02
        slam = JaxDPVO(jcfg, network=(p, u), ht=HT, wd=WD)
        slam._mag_pool.shutdown(wait=False)
        slam._mag_pool = _LatePool()
        ref = _drive(slam)
    finally:
        jax.config.update("jax_default_matmul_precision", old)
    port = _drive(DPVO(VOConfig(**cfg), network=params_from_jax(p, u),
                       ht=HT, wd=WD, device="cpu"))
    return request.param, ref, port


def test_lc_engine_structure_matches_jax(lc_drives):
    _, (_, s_ref, _), (_, s_my, _) = lc_drives
    assert s_my == s_ref
    assert s_my["n_inac"] > 0 and s_my["global_ba"] == [8, 9]


def test_lc_engine_trajectory_matches_jax(lc_drives):
    _, (p_ref, _, _), (p_my, _, _) = lc_drives
    assert p_my.shape == p_ref.shape == (len(make_frames()), 7)
    assert np.isfinite(p_my).all()
    np.testing.assert_allclose(p_my[:, :3], p_ref[:, :3], atol=ATOL_T)
    qd = np.abs(np.sum(p_my[:, 3:] * p_ref[:, 3:], axis=-1))
    qn = (np.linalg.norm(p_my[:, 3:], axis=-1)
          * np.linalg.norm(p_ref[:, 3:], axis=-1))
    assert np.all(qd / np.maximum(qn, 1e-12) > 1 - ATOL_Q)


def test_lc_engine_queued_magnitudes_match_jax(lc_drives):
    """The same updates queue magnitudes, for the same candidates, of the
    same values; the two global-branch updates among them."""
    mode, (_, _, m_ref), (_, _, m_my) = lc_drives
    if mode == "sync":
        assert not m_my and not m_ref
        return
    assert [m[:3] for m in m_my] == [m[:3] for m in m_ref]
    assert [m[0] for m in m_my if m[1]] == [8, 9]
    np.testing.assert_allclose([m[3] for m in m_my], [m[3] for m in m_ref],
                               atol=ATOL_MAG)
