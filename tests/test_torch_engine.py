"""The port's engine against the JAX engine on CPU (the whole slice).

Both engines track the same 16 synthetic 96x128 frames at a tiny config
with the same weights (the flax params carried across with
``params_from_jax``, flow-delta head scaled by 0.02 to stay in the smooth
regime, as tests/test_engine_parity.py does), the same scripted centroids
and fixed pre-init depth, motion_probe forced, fp32, synchronous keyframe
decisions.  On CPU the JAX engine runs its XLA path (generic SoftAgg,
cumsum-difference BA coupling), so this also holds the port's compact /
kernel formulation against the generic one.  The JAX engine runs once per
regime; the port runs against it at ``DPVO_CORR_VERSION`` 13, 12 and 9
(``corr_cuda.FUSED_VERSION``, set per drive).

Structure is asserted exactly (keyframe count, live edges, keyframe
timestamps, delta keys); trajectories within the envelopes
tests/test_engine_parity.py argues for: never-merge translation 5e-3 and
quaternion dot > 1-1e-4, always-merge 5e-2 and 1-1e-3.
"""
import dataclasses
from pathlib import Path

import numpy as np
import jax
import pytest
import torch

from dpvo_tpu.config import VOConfig as JaxConfig
from dpvo_tpu.engine import DPVO as JaxDPVO
from dpvo_tpu_torch.config import VOConfig
from dpvo_tpu_torch.engine import DPVO
from dpvo_tpu_torch.ops import corr_cuda
from dpvo_tpu_torch.utils.checkpoint import params_from_jax

torch.set_num_threads(1)

HT, WD = 96, 128
FH, FW = HT // 4, WD // 4
M = 8
N_FRAMES = 16
DEPTH0 = 0.7
INTR = np.array([64.0, 64.0, 64.0, 48.0], np.float32)
TINY = dict(BUFFER_SIZE=64, PATCHES_PER_FRAME=M, PATCH_LIFETIME=5,
            REMOVAL_WINDOW=7, OPTIMIZATION_WINDOW=5, KEYFRAME_INDEX=4,
            MIXED_PRECISION=False, ASYNC_KEYFRAME=False, EDGE_CAPACITY=512,
            BA_WINDOW_CAP=8)
REGIMES = {"never_merge": (0.0, 5e-3, 1e-4),
           "always_merge": (1e9, 5e-2, 1e-3)}


def centroid_grid(t):
    k = np.arange(M)
    x = 1 + (7 * k + 3 * t) % (FW - 2)
    y = 1 + (5 * k + 11 * t) % (FH - 2)
    return np.stack([x, y], axis=-1).astype(np.float32)


def make_frames():
    rng = np.random.default_rng(11)
    base = rng.integers(0, 255, size=(HT, WD * 2, 3), dtype=np.uint8)
    return [np.ascontiguousarray(np.roll(base, -3 * t, axis=1)[:, :WD])
            for t in range(N_FRAMES)]


def drive(slam, frames):
    slam.motion_probe = lambda: 100.0
    slam.test_centroids = centroid_grid
    slam.test_fixed_depth = DEPTH0
    for t, img in enumerate(frames):
        slam(t, img, INTR)
    state = (slam.n, slam.hs.e_num, np.array(slam.hs.tstamps[:slam.n]),
             sorted(slam.hs.delta.keys()))
    poses, tstamps = slam.terminate()
    return poses, tstamps, state


@pytest.fixture(scope="module")
def jax_refs():
    """regime -> (flax params, JAX engine drive), each drive run once."""
    cache = {}

    def get(regime):
        if regime not in cache:
            cache[regime] = _jax_reference(REGIMES[regime][0])
        return cache[regime]

    return get


def _jax_reference(thresh):
    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    try:
        jcfg = JaxConfig(**TINY, KEYFRAME_THRESH=thresh, CORR_BACKEND="xla")
        init = JaxDPVO(jcfg, network=None, ht=HT, wd=WD)
        p = jax.tree.map(np.asarray, init.params_patchify)
        u = jax.tree.map(np.asarray, init.params_update)
        for k in ("kernel", "bias"):
            u["params"]["d"][k] = u["params"]["d"][k] * 0.02
        ref = drive(JaxDPVO(jcfg, network=(p, u), ht=HT, wd=WD),
                    make_frames())
    finally:
        jax.config.update("jax_default_matmul_precision", old)
    return (p, u), ref


# the port at DPVO_CORR_VERSION 13 (the fused correlation + corr-encoder
# kernel) and at 12 and 9 (the two-level correlation kernel in the v12 and
# raw layouts, then CorrDense's row-mapped product), against one JAX drive
RUNS = [(regime, v) for regime in sorted(REGIMES) for v in (13, 12, 9)]


@pytest.fixture(scope="module", params=RUNS,
                ids=[r if v == 13 else f"{r}-v{v}" for r, v in RUNS])
def runs(request, jax_refs):
    regime, version = request.param
    thresh, atol_t, atol_q = REGIMES[regime]
    (p, u), ref = jax_refs(regime)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(corr_cuda, "FUSED_VERSION", version)
        port = drive(DPVO(VOConfig(**TINY, KEYFRAME_THRESH=thresh),
                          network=params_from_jax(p, u), ht=HT, wd=WD,
                          device="cpu"), make_frames())
    return regime, ref, port, atol_t, atol_q


def test_engine_structure_matches(runs):
    regime, (_, t_ref, s_ref), (_, t_my, s_my), _, _ = runs
    assert s_my[0] == s_ref[0], (regime, s_my, s_ref)
    assert s_my[1] == s_ref[1], (regime, s_my, s_ref)
    np.testing.assert_array_equal(s_my[2], s_ref[2])
    assert s_my[3] == s_ref[3]
    np.testing.assert_array_equal(t_my, t_ref)
    if regime == "always_merge":
        assert s_my[0] < N_FRAMES and len(s_my[3]) > 0
    else:
        assert s_my[0] == N_FRAMES and not s_my[3]


def test_engine_trajectory_matches(runs):
    _, (p_ref, _, _), (p_my, _, _), atol_t, atol_q = runs
    assert p_my.shape == p_ref.shape == (N_FRAMES, 7)
    assert np.isfinite(p_my).all()
    np.testing.assert_allclose(p_my[:, :3], p_ref[:, :3], atol=atol_t)
    qd = np.abs(np.sum(p_my[:, 3:] * p_ref[:, 3:], axis=-1))
    qn = (np.linalg.norm(p_my[:, 3:], axis=-1)
          * np.linalg.norm(p_ref[:, 3:], axis=-1))
    assert np.all(qd / np.maximum(qn, 1e-12) > 1 - atol_q)


@pytest.mark.parametrize("source", ["default", "configs/default.yaml",
                                    "configs/fast.yaml", "opts"])
def test_config_matches_jax(source):
    """VOConfig field for field, with the YAML and --opts merges."""
    mine, ref = VOConfig(), JaxConfig()
    if source.endswith(".yaml"):
        path = str(Path(__file__).resolve().parent.parent / source)
        mine, ref = mine.merge_yaml(path), ref.merge_yaml(path)
    elif source == "opts":
        opts = ["BUFFER_SIZE", "8192", "ASYNC_KEYFRAME", "false",
                "KEYFRAME_THRESH", "7.5", "CENTROID_SEL_STRAT",
                "GRADIENT_BIAS"]
        mine, ref = mine.merge_opts(opts), ref.merge_opts(opts)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.edge_capacity() == ref.edge_capacity()
    assert mine.kf_shift_cap() == ref.kf_shift_cap()


def test_engine_entry_point_rules():
    """Synchronous keyframing only; the GPU unless the CPU is asked for."""
    with pytest.raises(NotImplementedError, match="ASYNC_KEYFRAME"):
        DPVO(VOConfig(**{**TINY, "ASYNC_KEYFRAME": True}), ht=HT, wd=WD,
             device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            DPVO(VOConfig(**TINY), ht=HT, wd=WD)


def test_engine_random_weights_track_and_merge():
    """Seeded random weights, random centroids, uint8 path: runs, merges
    and returns finite poses of every frame."""
    slam = DPVO(VOConfig(**TINY, KEYFRAME_THRESH=1e9), ht=HT, wd=WD,
                device="cpu", seed=3)
    slam.motion_probe = lambda: 100.0
    for t, img in enumerate(make_frames()[:12]):
        slam(t, img, INTR)
    assert slam.n < 12 and slam.hs.delta
    e = slam.hs.e_num
    np.testing.assert_array_equal(slam.ds.eii[:e].numpy(), slam.hs.ii[:e])
    np.testing.assert_array_equal(slam.ds.ejj[:e].numpy(), slam.hs.jj[:e])
    np.testing.assert_array_equal(slam.ds.ekk[:e].numpy(), slam.hs.kk[:e])
    poses, tstamps = slam.terminate()
    assert poses.shape == (12, 7) and np.isfinite(poses).all()
