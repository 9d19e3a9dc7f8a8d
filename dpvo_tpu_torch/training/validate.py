"""Training-time validation: full rollouts on held-out samples, Sim3-aligned
ATE statistics and optional trajectory figures.

Counterpart of ``dpvo_tpu/training/validate.py``; the poses are inverted
with the port's Lie ops.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..ops import lie
from ..utils.evaluation import ate_rmse, umeyama_alignment


def _camera_poses(inv_poses):
    """Inverse (world-from-camera) poses (N, 7), numpy or tensor -> numpy
    camera poses."""
    g = torch.as_tensor(np.asarray(inv_poses, np.float32))
    return lie.se3_inv(g).numpy()


def validate(run_rollout, val_samples, logger=None, step=0,
             make_figures=False, fig_dir="runs/val_figs"):
    """run_rollout(sample) -> dict with 'poses' (S, N, 7) estimated inverse
    poses for one sample; val_samples: iterable of dicts with 'poses' (N,
    7) GT inverse poses.  Returns (and logs) val/ate_{mean, median, min,
    max}; {} without samples."""
    ates = []
    for i, sample in enumerate(val_samples):
        out = run_rollout(sample)
        est = _camera_poses(out["poses"][-1])
        gt = _camera_poses(sample["poses"])
        n = min(len(est), len(gt))
        ates.append(ate_rmse(est[:n], gt[:n], correct_scale=True))
        if make_figures:
            _trajectory_figure(est[:n], gt[:n],
                               f"{fig_dir}/val_{step}_{i}.png")
    if not ates:
        return {}
    stats = {"val/ate_mean": float(np.mean(ates)),
             "val/ate_median": float(np.median(ates)),
             "val/ate_min": float(np.min(ates)),
             "val/ate_max": float(np.max(ates))}
    if logger is not None:
        logger.write_dict(stats)
    return stats


def _trajectory_figure(est, gt, path):
    """2D and 3D comparison figures of the Sim3-aligned estimate; skipped
    without matplotlib."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    os.makedirs(os.path.dirname(path), exist_ok=True)
    R, t, s = umeyama_alignment(est[:, :3].T, gt[:, :3].T)
    aligned = (s * R @ est[:, :3].T + t).T
    fig = plt.figure(figsize=(10, 5))
    ax = fig.add_subplot(121)
    ax.plot(gt[:, 0], gt[:, 2], "k-", label="GT")
    ax.plot(aligned[:, 0], aligned[:, 2], "b--", label="est")
    ax.legend()
    ax.axis("equal")
    ax3 = fig.add_subplot(122, projection="3d")
    ax3.plot(gt[:, 0], gt[:, 1], gt[:, 2], "k-")
    ax3.plot(aligned[:, 0], aligned[:, 1], aligned[:, 2], "b--")
    fig.savefig(path, dpi=80)
    plt.close(fig)
