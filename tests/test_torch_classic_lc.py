"""The pieces of the port's classic loop-closure backend
(``CLASSIC_LOOP_CLOSURE=True``) against the JAX package's, on the CPU.

- ``optim_utils.ransac_umeyama`` and ``make_sim3``: bitwise (the same
  numpy with ``default_rng(0)``);
- ``BinaryBoW`` add/query (the same ``cpp/libretrieval.so``) and
  ``RetrievalDBOW.detect_loop`` on a fed result queue with keyframe
  remaps between: the same hits;
- PGO: residuals at atol 1e-5; each edge's 7x7 Jacobians at atol 1e-5
  wherever the JAX package's fp32 Jacobian is within 2e-6 of float64, and
  everywhere within twice its error from float64 (the Sim3 log's small
  angle and scale terms cancel in fp32: both packages reach 1e-4 to 1e-1
  from float64 on some edges); ``perform_updates`` on
  tests/test_loop_closure.py's drifted 40-pose loop and on a 300-pose one
  at 1e-3 after both are aligned at their first pose.  Not 1e-4: the JAX
  package's own result moves by more than 1e-4 when its inputs move by
  1e-6 (a test below measures it; 1.6e-4 to 4.9e-4 here), since after a
  first unconverged CG step the LM loop rejects and stops; and
  ``run_pgo`` when the loop's newer end is the newest pose (``safe_i``
  one past the end: both gauge-fix on the last pose);
- ``estimate_3d_keypoints`` on the same cached frames (a textured plane
  seen from three translated cameras) and engine poses: the same keypoints
  and descriptors, points at atol 1e-4;
- ``lc_callback``'s merge of a Sim3 correction: poses and patch depths at
  atol 1e-5.
"""
import queue
import types

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpvo_tpu.engine import DPVO as JaxDPVO
from dpvo_tpu.loop_closure import long_term as jlt, optim_utils as jopt
from dpvo_tpu.loop_closure import pgo as jpgo
from dpvo_tpu.loop_closure.retrieval import dbow as jdbow
from dpvo_tpu.loop_closure.retrieval import retrieval_dbow as jret
from dpvo_tpu.ops import lie as jlie
from dpvo_tpu_torch.config import VOConfig
from dpvo_tpu_torch.engine import DPVO
from dpvo_tpu_torch.loop_closure import long_term, optim_utils, pgo
from dpvo_tpu_torch.loop_closure.retrieval import dbow, retrieval_dbow
from dpvo_tpu_torch.ops import lie

torch.set_num_threads(1)


def t(a):
    return torch.from_numpy(np.array(a))


# --- RANSAC-Umeyama, the BoW database and the retrieval's hit logic ---------

def test_ransac_umeyama_and_make_sim3_bitwise():
    from scipy.spatial.transform import Rotation
    rng = np.random.default_rng(1)
    src = rng.normal(size=(120, 3)).astype(np.float32)
    R = Rotation.from_euler("xyz", [0.1, 0.2, -0.3]).as_matrix()
    dst = (0.8 * src @ R.T + [0.5, 0.0, -1.0]).astype(np.float32)
    dst[:40] += rng.normal(size=(40, 3)).astype(np.float32) * 5.0
    for args in ((src, dst, 400, 0.1), (src[:30], dst[:30], 50, 0.05),
                 (src[:2], dst[:2], 10, 0.1)):
        got = optim_utils.ransac_umeyama(*args)
        want = jopt.ransac_umeyama(*args)
        assert got[3] == want[3]
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(a, b)
    R, tr, s, inl = optim_utils.ransac_umeyama(src, dst)
    assert inl >= 80
    np.testing.assert_array_equal(optim_utils.make_sim3(R, tr, s),
                                  jopt.make_sim3(R, tr, s))


def test_binary_bow_matches_jax():
    rng = np.random.default_rng(3)
    places = rng.integers(0, 256, (6, 80, 32), dtype=np.uint8)

    def noisy(d):
        flips = rng.integers(0, 256, d.shape, dtype=np.uint8)
        return np.where(rng.random(d.shape) < 0.03, d ^ flips, d)

    views = [noisy(places[i % 6]) for i in range(30)]
    mine, ref = dbow.BinaryBoW(train_after=12), jdbow.BinaryBoW(
        train_after=12)
    assert ref._lib is not None
    hits = []
    for i, d in enumerate(views):
        for bow in (mine, ref):
            bow.add(i, d)
        assert mine.trained == ref.trained
        q = (mine.query(d, i + 40, 20), ref.query(d, i + 40, 20))
        assert q[0] == q[1]
        hits.append(q[0][0])
    assert mine.trained and max(hits) >= 0


def _retrieval(module):
    """A RetrievalDBOW whose child process is never started: its result
    queue is fed by the test."""
    r = object.__new__(module.RetrievalDBOW)
    r.min_gap, r.thresh, r.num_repeat = 20, 0.04, 3
    r.out_queue = queue.Queue()
    r.found, r.hits, r.remap = [], [], list(range(120))
    return r


def test_detect_loop_matches_jax():
    """The same (query, match, score) stream, keyframe removals between
    drains: the same detections, remapped alike."""
    rng = np.random.default_rng(4)
    mine, ref = _retrieval(retrieval_dbow), _retrieval(jret)
    found = []
    for q in range(30, 110):
        match = 5 + (q % 7) if q % 9 else -1
        score = float(rng.uniform(0.0, 0.12))
        for r in (mine, ref):
            r.out_queue.put((q, match, score))
        if q % 4 == 0:
            got, want = mine.detect_loop(), ref.detect_loop()
            assert got == want
            found.append(got)
        if q % 11 == 0:
            for r in (mine, ref):
                r.keyframe(int(q // 3))
    assert mine.found == ref.found and mine.remap == ref.remap
    assert any(f is not None for f in found)


# --- PGO ---------------------------------------------------------------------

def drifted_loop(n, seed=2, noise=0.01):
    """tests/test_loop_closure.py's drifted circle with its loop
    constraint between the last and the first pose."""
    rng = np.random.default_rng(seed)
    ang = np.linspace(0, 2 * np.pi, n)
    gt = np.zeros((n, 7), np.float32)
    gt[:, 0], gt[:, 1], gt[:, 6] = np.cos(ang), np.sin(ang), 1.0
    g = jnp.asarray(gt)
    drift = [np.asarray(g[0])]
    for i in range(1, n):
        rel = jlie.se3_mul(g[i], jlie.se3_inv(g[i - 1]))
        nz = jlie.se3_exp(jnp.asarray(rng.normal(size=6) * noise,
                                      jnp.float32))
        drift.append(np.asarray(jlie.se3_mul(jlie.se3_mul(nz, rel),
                                             jnp.asarray(drift[-1]))))
    Ti = jlie.sim3_inv(jlie.se3_to_sim3(g[n - 1]))
    Tj = jlie.sim3_inv(jlie.se3_to_sim3(g[0]))
    C = np.asarray(jlie.sim3_mul(Tj, jlie.sim3_inv(Ti)))[None]
    return np.stack(drift), C


def aligned(out):
    """Sim3 poses moved so that the first is the identity."""
    out = t(out)
    return lie.sim3_mul(lie.sim3_inv(out[0])[None], out).numpy()


@pytest.fixture(scope="module", params=[40, 300])
def loop(request):
    n = request.param
    poses, C = drifted_loop(n)
    args = (poses, C, np.array([n - 1]), np.array([0]))
    return n, args, np.asarray(jpgo.perform_updates(*args, iters=20))


def check_jacobians(ginv, cons, ii, jj):
    """Both packages' residuals and Jacobians against the port's in
    float64.  The Sim3 log's terms lose digits to cancellation in fp32
    ((1 - cos t) / t^2, (t - sin t) / t^3, (e^s - 1) / s at small angles
    and scales), so both fp32 Jacobians can sit far from float64 on some
    edges, in different directions.  On every edge where the JAX package's
    is within 2e-6 of float64 the port's is within 1e-5 of it; everywhere
    the port's error is within twice the JAX package's."""
    want = jpgo._residuals_and_jac(jnp.asarray(ginv), jnp.asarray(cons),
                                   jnp.asarray(ii), jnp.asarray(jj))
    got = pgo.residuals_and_jac(t(ginv), t(cons), t(ii).long(),
                                t(jj).long())
    exact = pgo._edge_jacobians(t(cons).double(), t(ginv).double()[ii],
                                t(ginv).double()[jj])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-5)
    accurate = 0
    for a, b, c in zip(got[1:], want[1:], exact):
        a, b, c = a.numpy(), np.asarray(b), c.numpy()
        err_port = np.abs(a - c).max((1, 2))
        err_jax = np.abs(b - c).max((1, 2))
        assert np.all(err_port <= 2 * err_jax + 1e-6), (
            err_port.max(), err_jax.max())
        good = err_jax <= 2e-6
        np.testing.assert_allclose(a[good], b[good], atol=1e-5)
        accurate += int(good.sum())
    return accurate


@pytest.mark.parametrize("seed", [5, 10])
def test_pgo_jacobians_match_jax(seed):
    """Edges between poses with rotations of about a radian and random
    Sim3 constants."""
    rng = np.random.default_rng(seed)
    E, n = 64, 20

    def tangents(k):
        return np.concatenate([0.5 * rng.normal(size=(k, 3)),
                               0.8 * rng.normal(size=(k, 3)),
                               0.2 * rng.normal(size=(k, 1))], 1).astype(
            np.float32)

    ginv = tangents(n)
    cons = np.asarray(jlie.sim3_exp(jnp.asarray(tangents(E))))
    ii, jj = rng.integers(0, n, E), rng.integers(0, n, E)
    assert check_jacobians(ginv, cons, ii, jj) > 0


def test_pgo_jacobians_on_the_loop_edges(loop):
    """The loop's own edges: odometry constants, small relative angles."""
    n, (poses, C, ii_loop, jj_loop), _ = loop
    pred_inv = jlie.sim3_inv(jlie.se3_to_sim3(jnp.asarray(poses)))
    kk = np.arange(1, n)
    cons = np.concatenate([np.asarray(jlie.sim3_mul(
        pred_inv[kk - 1], jlie.sim3_inv(pred_inv[kk]))), C])
    check_jacobians(np.asarray(jpgo.se3_to_sim3_log_inv(jnp.asarray(poses))),
                    cons, np.append(kk, ii_loop), np.append(kk - 1, jj_loop))


def test_pgo_perform_updates_matches_jax(loop):
    n, args, want = loop
    got = pgo.perform_updates(*args, iters=20).numpy()
    assert got.shape == want.shape == (n, 8)
    np.testing.assert_allclose(aligned(got), aligned(want), atol=1e-3)
    # and the loop closed: the last pose moved towards the first
    assert np.abs(aligned(got)[-1, :3]).max() < np.abs(
        aligned(np.concatenate([args[0], np.ones((n, 1), np.float32)],
                               1))[-1, :3]).max()


def test_pgo_is_ill_conditioned_below_1e_4(loop):
    """The JAX package's own result moves by more than 1e-4 when its
    inputs move by 1e-6: the reason for the 1e-3 gate above."""
    n, (poses, *rest), want = loop
    rng = np.random.default_rng(6)
    moved = poses + (rng.normal(size=poses.shape) * 1e-6).astype(np.float32)
    again = np.asarray(jpgo.perform_updates(moved, *rest, iters=20))
    assert np.abs(aligned(again) - aligned(want)).max() > 1e-4


def test_run_pgo_clamps_safe_i_like_jax():
    """The loop's newer end is the newest pose: safe_i is one past the
    end, JAX's gather clamps it to the last pose and so does the port; all
    n poses come back, gauge-fixed on the last."""
    n = 40
    poses, C = drifted_loop(n)
    args = (poses, C, np.array([n - 1]), np.array([0]))
    got, want = pgo.run_pgo(*args), np.asarray(jpgo.run_pgo(*args))
    assert got.shape == want.shape == (n, 8)
    np.testing.assert_allclose(got, want, atol=1e-3)
    np.testing.assert_allclose(got[-1, :7], poses[-1], atol=1e-5)
    np.testing.assert_allclose(got[-1, 7], 1.0, atol=1e-5)
    # a loop ending inside: gauge-fixed on the pose after it, which is not
    # returned
    args = (poses, C, np.array([n - 5]), np.array([0]))
    got, want = pgo.run_pgo(*args), np.asarray(jpgo.run_pgo(*args))
    assert got.shape == want.shape == (n - 4, 8)
    np.testing.assert_allclose(got, want, atol=1e-3)


# --- triangulation and the merge ---------------------------------------------

HT, WD, RES = 192, 256, 4
FX = 128.0                     # full resolution
SHIFT = 8                      # pixels a frame: depth 2, baseline 0.125


def triplet_frames():
    rng = np.random.default_rng(7)
    base = cv2.GaussianBlur(rng.integers(0, 255, (HT, WD + 4 * SHIFT, 3),
                                         np.uint8), (3, 3), 0)
    return [np.ascontiguousarray(base[:, SHIFT * k:SHIFT * k + WD])
            for k in range(3)]


def triplet_state(n=6, i=3):
    """Engine poses (cam from world) of cameras moving +x by
    SHIFT * 2 / FX a frame, and feature-resolution intrinsics."""
    poses = np.zeros((n, 7), np.float32)
    poses[:, 0] = -np.arange(n) * SHIFT * 2.0 / FX
    poses[:, 6] = 1.0
    poses[i - 1:i + 2, 1] += [0.002, -0.001, 0.003]   # not exactly on it
    intr = np.tile(np.array([FX, FX, WD / 2, HT / 2], np.float32) / RES,
                   (n, 1))
    return poses, intr


def _lc_stub(module, slam):
    frames = triplet_frames()
    lc = object.__new__(module.LongTermLoopClosure)
    lc.slam = slam
    lc._detect = module._sift_descriptors
    lc.imcache = types.SimpleNamespace(original_index=lambda j: j,
                                       load_frames=lambda idx: frames)
    return lc


def test_estimate_3d_keypoints_matches_jax():
    poses, intr = triplet_state()
    i = 3
    jslam = types.SimpleNamespace(n=6, RES=RES, P=3, ds=types.SimpleNamespace(
        poses=jnp.asarray(poses), intrinsics=jnp.asarray(intr)))
    tslam = types.SimpleNamespace(n=6, RES=RES, P=3, ds=types.SimpleNamespace(
        poses=t(poses), intrinsics=t(intr)))
    want = _lc_stub(jlt, jslam).estimate_3d_keypoints(i)
    got = _lc_stub(long_term, tslam).estimate_3d_keypoints(i)
    assert want is not None and got is not None
    np.testing.assert_array_equal(got[1], want[1])       # descriptors
    assert len(got[0]) >= 50
    np.testing.assert_allclose(got[0], want[0], atol=1e-4)
    # the triangulated plane is near the true depth 2
    depth = got[0][:, 2]
    assert abs(np.median(depth) - 2.0) < 0.2, np.median(depth)


class _Done:
    def __init__(self, value):
        self.value = value

    def ready(self):
        return True

    def get(self):
        return self.value


def test_lc_callback_merge_matches_jax():
    """A Sim3 correction of the first m < n keyframes merged into a port
    engine and into the JAX package's merge on the same state."""
    rng = np.random.default_rng(8)
    M, n, m = 4, 9, 7
    cfg = VOConfig(BUFFER_SIZE=16, PATCHES_PER_FRAME=M,
                   MIXED_PRECISION=False, EDGE_CAPACITY=256)
    slam = DPVO(cfg, ht=64, wd=96, device="cpu")
    q = rng.normal(size=(n, 4)) * [0.1, 0.1, 0.1, 1.0]
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    poses = np.concatenate([rng.normal(size=(n, 3)), q], 1).astype(
        np.float32)
    patches = slam.ds.patches.numpy().copy()
    patches[:n * M] = rng.uniform(0.2, 2.0, patches[:n * M].shape)
    slam.ds.poses[:n] = t(poses)
    slam.ds.patches.copy_(t(patches))
    slam.n, slam.m = n, n * M
    sim = np.concatenate([poses[:m] + rng.normal(size=(m, 7)).astype(
        np.float32) * 0.01, rng.uniform(0.8, 1.2, (m, 1))], 1).astype(
        np.float32)
    sim[:, 3:7] /= np.linalg.norm(sim[:, 3:7], axis=1, keepdims=True)

    lc = object.__new__(long_term.LongTermLoopClosure)
    lc.slam, lc.pending = slam, [_Done(sim)]
    lc.lc_callback()
    assert not lc.pending

    jposes = np.asarray(slam.ds.poses).copy()
    jposes[:n] = poses
    # numpy state: np.asarray of a jax.Array is a read-only view, so the
    # JAX package's merge cannot write into its own device state
    stub = types.SimpleNamespace(
        n=n, M=M, ds=types.SimpleNamespace(poses=jposes,
                                           patches=patches.copy()),
        hs=types.SimpleNamespace(delta={}))
    stub.normalize = types.MethodType(JaxDPVO.normalize, stub)
    jlc = object.__new__(jlt.LongTermLoopClosure)
    jlc.slam, jlc.result_queue, jlc.pending = stub, queue.Queue(), 1
    jlc.result_queue.put(sim)
    jlc.lc_callback()

    np.testing.assert_allclose(slam.ds.poses[:n].numpy(),
                               np.asarray(stub.ds.poses)[:n], atol=1e-5)
    np.testing.assert_allclose(slam.ds.patches[:n * M, 2].numpy(),
                               np.asarray(stub.ds.patches)[:n * M, 2],
                               atol=1e-5)
    # the merge moved the scene: scales divided into the depths
    assert not np.allclose(slam.ds.patches[:n * M, 2].numpy(),
                           patches[:n * M, 2], atol=1e-3)
