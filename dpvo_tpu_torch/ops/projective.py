"""Patch-based projective geometry (plain PyTorch, float32).

Counterpart of ``dpvo_tpu/ops/projective.py`` (the patch ops of the VO
path).  Conventions:

- poses       (N, 7)  SE3 world-from-camera (inverse poses)
- patches     (K, 3, P, P)   channels = (x, y, inv_depth) at feature res
- intrinsics  (N, 4)  [fx, fy, cx, cy] at feature resolution
- ii, jj, kk  (E,) int  source frame / target frame / patch index
- returned coords  (E, P, P, 2)
"""
from __future__ import annotations

import torch

from . import lie


def iproj(patches, intrinsics):
    """patches (E, 3, P, P), intrinsics (E, 4) -> (E, P, P, 4) =
    [xn, yn, 1, d]."""
    patches, intrinsics = patches.float(), intrinsics.float()
    x, y, d = patches[:, 0], patches[:, 1], patches[:, 2]
    fx, fy, cx, cy = [intrinsics[:, i, None, None] for i in range(4)]
    xn = (x - cx) / fx
    yn = (y - cy) / fy
    return torch.stack([xn, yn, torch.ones_like(d), d], dim=-1)


def proj(X, intrinsics, depth=False):
    """Pinhole projection (E, P, P, 4) -> (E, P, P, 2); Z clamped at 0.1."""
    X, intrinsics = X.float(), intrinsics.float()
    fx, fy, cx, cy = [intrinsics[:, i, None, None] for i in range(4)]
    d = 1.0 / X[..., 2].clamp(min=0.1)
    x = fx * (d * X[..., 0]) + cx
    y = fy * (d * X[..., 1]) + cy
    if depth:
        return torch.stack([x, y, d], dim=-1)
    return torch.stack([x, y], dim=-1)


def transform(poses, patches, intrinsics, ii, jj, kk, depth=False,
              valid=False, tonly=False, Gij=None):
    """Reproject patch kk from frame ii into frame jj -> coords (E, P, P, 2)
    (and (coords, valid) with ``valid``).

    Gij (E, 7) optional precomputed relative poses (the engine gathers a
    per-frame-pair table to edges)."""
    poses, patches, intrinsics = (poses.float(), patches.float(),
                                  intrinsics.float())
    X0 = iproj(patches[kk], intrinsics[ii])
    if Gij is None:
        Gij = lie.se3_mul(poses[jj], lie.se3_inv(poses[ii]))
    else:
        Gij = Gij.float()
    if tonly:
        unit = torch.tensor([0.0, 0.0, 0.0, 1.0], device=Gij.device)
        Gij = torch.cat([Gij[..., :3], unit.expand(Gij.shape[:-1] + (4,))],
                        dim=-1)
    X1 = lie.se3_act4(Gij[:, None, None], X0)
    x1 = proj(X1, intrinsics[jj], depth=depth)
    if valid:
        return x1, (X1[..., 2] > 0.2).float()
    return x1


def point_cloud(poses, patches, intrinsics, ix):
    """Lift patches to world-frame homogeneous points: patches (K, 3, P,
    P), ix (K,) source frame of each -> (K, P, P, 4)."""
    poses, patches, intrinsics = (poses.float(), patches.float(),
                                  intrinsics.float())
    X0 = iproj(patches, intrinsics[ix])
    Ginv = lie.se3_inv(poses[ix])
    return lie.se3_act4(Ginv[:, None, None], X0)


def flow_mag(poses, patches, intrinsics, ii, jj, kk, beta=0.3):
    """Blend of full and translation-only flow magnitude ->
    (flow (E, P, P), valid (E, P, P) bool)."""
    coords0 = transform(poses, patches, intrinsics, ii, ii, kk)
    coords1, val = transform(poses, patches, intrinsics, ii, jj, kk,
                             valid=True)
    coords2 = transform(poses, patches, intrinsics, ii, jj, kk, tonly=True)
    flow1 = torch.linalg.norm(coords1 - coords0, dim=-1)
    flow2 = torch.linalg.norm(coords2 - coords0, dim=-1)
    return beta * flow1 + (1 - beta) * flow2, val > 0.5
