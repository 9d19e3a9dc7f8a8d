"""Trajectory evaluation: Sim3-aligned ATE RMSE (numpy).

Copy of ``dpvo_tpu/utils/evaluation.py`` (this package imports nothing of
``dpvo_tpu``): evo's APE on the translation part with Sim3 alignment
(``align=True, correct_scale=True``).
"""
from __future__ import annotations

import numpy as np


def umeyama_alignment(x, y, with_scale=True):
    """Least-squares similarity transform y ~= s R x + t.

    x, y: (3, N).  Returns (R, t, s).  (Umeyama 1991; same algorithm evo
    uses.)"""
    mx = x.mean(axis=1, keepdims=True)
    my = y.mean(axis=1, keepdims=True)
    xc, yc = x - mx, y - my
    n = x.shape[1]
    sigma_x = (xc ** 2).sum() / n
    cov = yc @ xc.T / n
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    # degenerate (near-static) estimate: zero variance makes the scale
    # term 0/0 — fall back to scale 1 so the ATE stays finite
    if with_scale and sigma_x > 1e-12:
        s = np.trace(np.diag(D) @ S) / sigma_x
    else:
        s = 1.0
    t = my - s * R @ mx
    return R, t, s


def ate_rmse(traj_est, traj_ref, correct_scale=True):
    """Absolute trajectory error RMSE after Sim3 (or SE3) alignment.

    traj_est/traj_ref: (N, >=3) arrays whose first 3 columns are xyz.
    """
    x = np.asarray(traj_est)[:, :3].T
    y = np.asarray(traj_ref)[:, :3].T
    R, t, s = umeyama_alignment(x, y, with_scale=correct_scale)
    x_aligned = s * R @ x + t
    err = np.linalg.norm(x_aligned - y, axis=0)
    return float(np.sqrt((err ** 2).mean()))


def associate_trajectories(tstamps_est, tstamps_ref, max_diff=0.01):
    """Index pairs of closest-in-time samples (evo sync equivalent)."""
    ii, jj = [], []
    j = 0
    for i, t in enumerate(tstamps_est):
        j = int(np.argmin(np.abs(np.asarray(tstamps_ref) - t)))
        if abs(tstamps_ref[j] - t) <= max_diff:
            ii.append(i)
            jj.append(j)
    return np.array(ii), np.array(jj)


def load_tum_trajectory(path):
    """-> (tstamps (N,), poses (N, 7) [xyz qxyzw])."""
    data = np.loadtxt(path)
    return data[:, 0], data[:, 1:8]


def load_tartan_pose_file(path):
    """TartanAir pose_left.txt in NED -> XYZ (ref tartan.py:82)."""
    poses = np.loadtxt(path, delimiter=" ")
    return poses[:, [1, 2, 0, 4, 5, 3, 6]]
