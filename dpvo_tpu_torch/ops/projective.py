"""Patch-based projective geometry (plain PyTorch, float32).

Counterpart of ``dpvo_tpu/ops/projective.py``: the patch ops of the VO and
training paths (``transform`` with the centre-pixel Jacobians of the
differentiable BA), and the DROID-style dense-disparity ops that build the
training datasets' co-visibility graphs.  Conventions:

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
              valid=False, jacobian=False, tonly=False, Gij=None):
    """Reproject patch kk from frame ii into frame jj -> coords (E, P, P, 2);
    with ``valid`` (coords, valid (E, P, P)); with ``jacobian`` (coords,
    valid (E,) of the centre pixel (Z > 0.2), (Ji, Jj, Jz)): the centre
    pixel's Jacobians wrt poses i and j (E, 2, 6) (tangent order [tau,
    phi]) and wrt the patch inverse depth (E, 2, 1).

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
    if jacobian:
        c = X1.shape[1] // 2
        X, Y, Z, H = X1[:, c, c].unbind(-1)
        o = torch.zeros_like(H)
        fx, fy = intrinsics[jj, 0], intrinsics[jj, 1]
        d = torch.where(Z.abs() > 0.2, 1.0 / Z, 0.0)
        # d(X1)/d(xi_j) of the se3 action (E, 4, 6), and the projection's
        # Jacobian (E, 2, 4)
        Ja = torch.stack([H, o, o, o, Z, -Y,
                          o, H, o, -Z, o, X,
                          o, o, H, Y, -X, o,
                          o, o, o, o, o, o], dim=-1).reshape(-1, 4, 6)
        Jp = torch.stack([fx * d, o, -fx * X * d * d, o,
                          o, fy * d, -fy * Y * d * d, o],
                         dim=-1).reshape(-1, 2, 4)
        Jj = Jp @ Ja
        Ji = -lie.se3_adjT(Gij[:, None], Jj)
        Jz = Jp @ lie.se3_matrix(Gij)[..., :, 3:]
        return x1, (Z > 0.2).float(), (Ji, Jj, Jz)
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


# ---------------------------------------------------------------------------
# DROID-style dense-disparity ops (frame graphs of the training datasets)
# ---------------------------------------------------------------------------

MIN_DEPTH = 0.2


def _pixel_grid(ht, wd, device):
    y, x = torch.meshgrid(torch.arange(ht, dtype=torch.float32, device=device),
                          torch.arange(wd, dtype=torch.float32, device=device),
                          indexing="ij")
    return x, y


def iproj_droid(disps, intrinsics):
    """Dense inverse projection: disps (E, H, W), intrinsics (E, 4) ->
    (E, H, W, 4)."""
    disps, intrinsics = disps.float(), intrinsics.float()
    x, y = _pixel_grid(*disps.shape[-2:], disps.device)
    fx, fy, cx, cy = [intrinsics[:, i, None, None] for i in range(4)]
    return torch.stack([(x[None] - cx) / fx, (y[None] - cy) / fy,
                        torch.ones_like(disps), disps], dim=-1)


def proj_droid(Xs, intrinsics, return_depth=False):
    """Dense pinhole projection; Z below MIN_DEPTH / 2 is taken as 1."""
    Xs, intrinsics = Xs.float(), intrinsics.float()
    fx, fy, cx, cy = [intrinsics[:, i, None, None] for i in range(4)]
    X, Y, Z, D = Xs.unbind(-1)
    Z = torch.where(Z < 0.5 * MIN_DEPTH, 1.0, Z)
    d = 1.0 / Z
    x = fx * (X * d) + cx
    y = fy * (Y * d) + cy
    if return_depth:
        return torch.stack([x, y, D * d], dim=-1)
    return torch.stack([x, y], dim=-1)


def projective_transform(poses, disps, intrinsics, ii, jj):
    """Dense map of the pixels of frame ii into frame jj: poses (N, 7),
    disps (N, H, W), intrinsics (N, 4) -> coords (E, H, W, 2), valid (E, H,
    W, 1).  Self-pairs get a fixed probe motion."""
    poses, disps, intrinsics = poses.float(), disps.float(), intrinsics.float()
    X0 = iproj_droid(disps[ii], intrinsics[ii])
    Gij = lie.se3_mul(poses[jj], lie.se3_inv(poses[ii]))
    probe = torch.tensor([-0.1, 0, 0, 0, 0, 0, 1.0], device=poses.device)
    Gij = torch.where((ii == jj)[:, None], probe, Gij)
    X1 = lie.se3_act4(Gij[:, None, None], X0)
    x1 = proj_droid(X1, intrinsics[jj])
    valid = (X1[..., 2] > MIN_DEPTH) & (X0[..., 2] > MIN_DEPTH)
    return x1, valid[..., None].float()


def induced_flow(poses, disps, intrinsics, ii, jj):
    """Optical flow induced by the camera motion ii -> jj: (flow (E, H, W,
    2), valid (E, H, W, 1))."""
    x, y = _pixel_grid(*disps.shape[-2:], disps.device)
    coords1, valid = projective_transform(poses, disps, intrinsics, ii, jj)
    return coords1 - torch.stack([x, y], dim=-1), valid
