"""Classic long-term loop closure: place recognition + Sim3 PGO.

Counterpart of ``dpvo_tpu/loop_closure/long_term.py``: every frame feeds
the BoW retrieval process and the JPEG cache; on a confirmed retrieval
hit, 3D keypoints are triangulated for both loop ends from cached frame
triplets (SIFT or ORB keypoints matched with a ratio-test ``BFMatcher``,
then structure-only bundle adjustment against the engine's poses on its
device), a relative Sim3 is estimated with RANSAC-Umeyama, and a Sim3
pose-graph optimisation runs in a spawned worker process on the engine's
device; ``lc_callback`` merges each finished result into the engine.

OpenCV (``cv2``) is imported inside the functions that use it; the engine
checks for it once, at construction.  The worker is handed numpy arrays
and returns numpy arrays, and the result comes back through the pool's
own result: the JAX package hands the worker a ``multiprocessing.Queue``
through ``apply_async``, which cannot be pickled there, so its PGO never
runs and no closure is ever merged.
"""
from __future__ import annotations

import multiprocessing as mp

import numpy as np
import torch

from ..ops import ba, lie, projective as pops
from .optim_utils import make_sim3, ransac_umeyama
from .pgo import run_pgo
from .retrieval.image_cache import ImageCache
from .retrieval.retrieval_dbow import RetrievalDBOW, _orb_descriptors

PGO_WAIT_S = 600.0   # terminate() waits this long for a PGO result


def _sift_descriptors(image, n_features=1024):
    """SIFT keypoints + float descriptors (the high-recall default)."""
    import cv2
    gray = cv2.cvtColor(image, cv2.COLOR_BGR2GRAY) \
        if image.ndim == 3 else image
    sift = cv2.SIFT_create(nfeatures=n_features)
    kps, descs = sift.detectAndCompute(gray, None)
    if descs is None:
        descs = np.zeros((0, 128), np.float32)
    pts = np.array([k.pt for k in kps], np.float32).reshape(-1, 2)
    return pts, descs


def _match(d1, d2, ratio=0.8):
    """BFMatcher with ratio test -> index pairs (m, 2).  Norm follows
    the descriptor dtype: Hamming for binary (ORB), L2 for float
    (SIFT)."""
    import cv2
    if len(d1) == 0 or len(d2) == 0:
        return np.zeros((0, 2), np.int32)
    norm = cv2.NORM_HAMMING if d1.dtype == np.uint8 else cv2.NORM_L2
    bf = cv2.BFMatcher(norm)
    knn = bf.knnMatch(d1, d2, k=2)
    out = []
    for m in knn:
        if len(m) == 2 and m[0].distance < ratio * m[1].distance:
            out.append((m[0].queryIdx, m[0].trainIdx))
        elif len(m) == 1:
            out.append((m[0].queryIdx, m[0].trainIdx))
    return np.array(out, np.int32).reshape(-1, 2)


def triangulate(poses3, intrinsics, pts_c, targets, P=3, iterations=6):
    """World points of keypoints seen in a frame triplet, by
    structure-only BA (``ops.ba.ba_iterative`` with ``t0 == t1``) against
    fixed poses, on the poses' device.

    poses3 (3, 7) the triplet's poses; intrinsics (4,) of the middle frame
    at feature resolution; pts_c (K, 2) the keypoints in the middle frame,
    targets (K, 2, 2) where each lands in frames 0 and 2 (feature
    resolution, numpy).  Each keypoint is a constant-depth patch of the
    middle frame with one edge to each neighbour.  -> (K, 3) numpy."""
    dev = poses3.device
    K = len(pts_c)
    patches = torch.ones((K, 3, P, P), dtype=torch.float32, device=dev)
    ctr = torch.as_tensor(np.asarray(pts_c, np.float32), device=dev)
    patches[:, :2] = ctr[:, :, None, None]
    kk = torch.arange(K, device=dev).repeat_interleave(2)
    jj = torch.tensor([0, 2], device=dev).repeat(K)
    E = 2 * K
    k_cap = 1 << max(K - 1, 15).bit_length()
    _, patches = ba.ba_iterative(
        poses3, patches, intrinsics,
        torch.as_tensor(np.asarray(targets, np.float32).reshape(E, 2),
                        device=dev),
        torch.ones((E, 2), device=dev), 1e-4, torch.ones_like(kk), jj, kk,
        torch.ones(E, dtype=torch.bool, device=dev), 3, 3, n_cap=4,
        k_cap=k_cap, iterations=iterations)
    X = pops.point_cloud(poses3, patches, intrinsics[None].expand(3, 4),
                         torch.ones(K, dtype=torch.long, device=dev))
    ctr = X[:, P // 2, P // 2].cpu().numpy()
    return ctr[:, :3] / np.maximum(ctr[:, 3:], 1e-8)


class LongTermLoopClosure:
    def __init__(self, cfg, slam):
        self.cfg = cfg
        self.slam = slam
        self.retrieval = RetrievalDBOW(thresh=cfg.LOOP_RETR_THRESH,
                                       vocab_path=cfg.LOOP_VOCAB_PATH or None)
        self.imcache = ImageCache()
        self._detect = (_sift_descriptors if cfg.LOOP_MATCHER == "sift"
                        else _orb_descriptors)
        self.pool = mp.get_context("spawn").Pool(1)
        self.pending = []      # run_pgo's AsyncResults, oldest first

    # --- per-frame feeds ---------------------------------------------------

    def __call__(self, image, n):
        self.retrieval(image, n)
        self.imcache(image, n)

    def keyframe(self, k):
        self.retrieval.keyframe(k)
        self.imcache.keyframe(k)

    # --- keypoint triangulation -------------------------------------------

    def estimate_3d_keypoints(self, i):
        """World points and descriptors of keyframe i's keypoints that both
        neighbours see, triangulated against the engine's current poses;
        None when frames are missing or fewer than 8 keypoints match."""
        slam = self.slam
        fids = [max(i - 1, 0), i, min(i + 1, slam.n - 1)]
        frames = self.imcache.load_frames(
            [self.imcache.original_index(j) for j in fids])
        if any(f is None for f in frames):
            return None

        kps, descs = zip(*(self._detect(f, n_features=1024) for f in frames))
        m01 = _match(descs[1], descs[0])
        m12 = _match(descs[1], descs[2])
        # keypoints of frame i seen in both neighbours
        common = np.intersect1d(m01[:, 0], m12[:, 0])
        if len(common) < 8:
            return None
        sel01 = dict(m01.tolist())
        sel12 = dict(m12.tolist())
        targets = np.stack([np.stack([kps[0][sel01[c]], kps[2][sel12[c]]])
                            for c in common.tolist()]) / slam.RES
        pts3d = triangulate(slam.ds.poses[fids], slam.ds.intrinsics[i],
                            kps[1][common] / slam.RES, targets, slam.P)
        return pts3d, descs[1][common]

    # --- the loop-closure event -------------------------------------------

    def close_loop(self, i, j):
        """Estimate the Sim3 between the two loop ends' points and start a
        PGO over the engine's poses in the worker; False when too few
        keypoints or inliers support it."""
        res_i = self.estimate_3d_keypoints(i)
        res_j = self.estimate_3d_keypoints(j)
        if res_i is None or res_j is None:
            return False
        pts_i, d_i = res_i
        pts_j, d_j = res_j

        m = _match(d_i, d_j)
        if len(m) < 8:
            return False
        R, t, s, inliers = ransac_umeyama(pts_i[m[:, 0]], pts_j[m[:, 1]],
                                          iterations=400, threshold=0.1)
        if R is None or inliers < 8:
            return False

        slam = self.slam
        poses = slam.ds.poses[:slam.n].cpu().numpy()
        self.pending.append(self.pool.apply_async(run_pgo, (
            poses, make_sim3(R, t, s)[None], np.array([max(i, j)]),
            np.array([min(i, j)]), 30, str(slam.device))))
        return True

    def attempt_loop_closure(self, n):
        hit = self.retrieval.detect_loop()
        if hit is not None:
            i, j = hit
            if 0 <= j < self.slam.n and 0 <= i < self.slam.n and i != j:
                self.close_loop(i, j)

    def lc_callback(self):
        """Merge the finished PGO results, oldest first: rewrite the
        corrected poses, divide each frame's patch depths by its scale,
        renormalise the scene.  A worker's exception is raised here."""
        while self.pending and self.pending[0].ready():
            self.merge(self.pending.pop(0).get())

    def merge(self, corrected):
        """Apply corrected Sim3 poses (m, 8) to the engine's first m
        keyframes, on its device."""
        slam = self.slam
        m = min(len(corrected), slam.n)
        sim = torch.as_tensor(np.asarray(corrected[:m], np.float32),
                              device=slam.device)
        # the device edge rows follow the host's before the scene moves
        slam._flush_edge_permute()
        slam.ds.poses[:m] = lie.sim3_to_se3(sim)
        scale = sim[:, 7].clamp(min=1e-8).repeat_interleave(slam.M)
        slam.ds.patches[:m * slam.M, 2] /= scale[:, None, None]
        slam.normalize()

    def terminate(self, n):
        """A last retrieval check, then wait for and merge every PGO
        started; the worker processes end here."""
        try:
            self.attempt_loop_closure(n)
            for r in self.pending:
                r.wait(PGO_WAIT_S)
            self.lc_callback()
            if self.pending:
                raise TimeoutError(f"{len(self.pending)} pose-graph "
                                   f"optimisations still running after "
                                   f"{PGO_WAIT_S} s")
        finally:
            self.retrieval.close()
            self.imcache.close()
            self.pool.close()
            self.pool.join()
