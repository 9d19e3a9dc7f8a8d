"""Loop-closure geometry utilities: Umeyama alignment + RANSAC Sim3.

Copy of ``dpvo_tpu/loop_closure/optim_utils.py`` (numpy; this package
imports nothing of ``dpvo_tpu``): these run once per loop-closure event,
not per frame.  ``reduce_edges`` lives in ``loop_closure.proximity``.
"""
from __future__ import annotations

import numpy as np


def umeyama_alignment(x, y):
    """Least-squares Sim(3) between point sets x, y (m, n)
    (ref optim_utils.py:65-115; Umeyama 1991).  Returns (R, t, c) or
    (None, None, None) when degenerate."""
    m, n = x.shape
    mean_x = x.mean(axis=1)
    mean_y = y.mean(axis=1)
    sigma_x = ((x - mean_x[:, None]) ** 2).sum() / n
    cov = (y - mean_y[:, None]) @ (x - mean_x[:, None]).T / n
    u, d, v = np.linalg.svd(cov)
    if np.count_nonzero(d > np.finfo(d.dtype).eps) < m - 1:
        return None, None, None
    s = np.eye(m)
    if np.linalg.det(u) * np.linalg.det(v) < 0.0:
        s[m - 1, m - 1] = -1
    r = u @ s @ v
    c = np.trace(np.diag(d) @ s) / sigma_x
    t = mean_y - c * (r @ mean_x)
    return r, t, c


def ransac_umeyama(src_points, dst_points, iterations=400, threshold=0.1):
    """3-point RANSAC Sim3 (ref optim_utils.py:117-150).

    Returns (R, t, s, num_inliers)."""
    rng = np.random.default_rng(0)
    n = src_points.shape[0]
    best = (None, None, None, 0)
    if n < 3:
        return best
    for _ in range(iterations):
        idx = rng.choice(n, 3, replace=False)
        R, t, s = umeyama_alignment(src_points[idx].T, dst_points[idx].T)
        if t is None:
            continue
        transformed = src_points @ (R * s).T + t
        dist = np.sqrt(((transformed - dst_points) ** 2).sum(axis=1))
        inliers = dist < threshold
        cnt = int(inliers.sum())
        if cnt > best[3] and cnt >= 3:
            Rb, tb, sb = umeyama_alignment(src_points[inliers].T,
                                           dst_points[inliers].T)
            if tb is not None:
                best = (Rb, tb, sb, cnt)
        if cnt > 100:
            break
    return best


def rotation_to_quat(R):
    """3x3 -> [qx qy qz qw]."""
    from scipy.spatial.transform import Rotation
    return Rotation.from_matrix(R).as_quat()


def make_sim3(R, t, s):
    """(R, t, s) -> Sim3 8-vector [t, q, s] matching ops.lie layout."""
    q = rotation_to_quat(R)
    return np.concatenate([np.asarray(t).reshape(3), q,
                           np.array([s], np.float64)]).astype(np.float32)
