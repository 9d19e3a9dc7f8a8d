"""Trajectory evaluation: Sim3-aligned ATE RMSE (numpy), and what the
``evaluate_*_torch.py`` harnesses share.

The scoring is a copy of ``dpvo_tpu/utils/evaluation.py`` (this package
imports nothing of ``dpvo_tpu``): evo's APE on the translation part with
Sim3 alignment (``align=True, correct_scale=True``).  ``run_frames`` is the
harnesses' engine loop over any iterable of frames; ``eval_parser`` and
``eval_config`` their common command line.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..config import VOConfig
from ..engine import DPVO


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


@torch.no_grad()
def run_frames(cfg, network, frames, device="cuda"):
    """Track every ``(t, image, intrinsics)`` of ``frames`` (image (H, W, 3)
    uint8 BGR, intrinsics at full resolution) with one ``DPVO`` built at
    the first frame's size; -> ``terminate()``'s (poses, tstamps)."""
    slam = None
    for t, image, intrinsics in frames:
        if slam is None:
            slam = DPVO(cfg, network, ht=image.shape[0], wd=image.shape[1],
                        device=device)
        slam(t, image, intrinsics)
    if slam is None:
        raise FileNotFoundError("no frames to evaluate")
    return slam.terminate()


EVAL_EPILOG = (
    "configs/default.yaml keeps EDGE_CAPACITY_INAC=16384, the JAX "
    "package's default: with loop closure on, edges retired from the "
    "window go to that store, about 2400 a keyframe at 96 patches when "
    "few frames merge, and the engine raises once it is full.  For long "
    "sequences pass --opts EDGE_CAPACITY_INAC 262144.")


def eval_parser(description, datapath, stride):
    """The arguments every harness takes (the JAX scripts', plus
    ``--device``)."""
    parser = argparse.ArgumentParser(description=description,
                                     epilog=EVAL_EPILOG)
    parser.add_argument("--network", default=None,
                        help="weights: the reference's .pth or the JAX "
                        "package's .npz (default: seeded random)")
    parser.add_argument("--datapath", default=datapath)
    parser.add_argument("--stride", type=int, default=stride)
    parser.add_argument("--config", default="configs/default.yaml")
    parser.add_argument("--opts", nargs="+", default=[])
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: the GPU)")
    return parser


def eval_config(args):
    """VOConfig from ``--config`` (when the file exists) and ``--opts``."""
    cfg = VOConfig()
    if os.path.exists(args.config):
        cfg = cfg.merge_yaml(args.config)
    return cfg.merge_opts(args.opts)
