"""Dense depth-filtered backprojection for the viewer.

Counterpart of ``dpvo_tpu/viz/dense.py`` in plain PyTorch on the inputs'
device (the JAX package computes it outside any Pallas kernel): backproject
every pixel of one keyframe's dense inverse-depth map, reject
depth-discontinuity pixels (disparity gradient > 0.01), and keep only the
points whose depth agrees when reprojected into at least ``min_count``
other keyframes (``100 * (max(z1/z2, z2/z1) - 1) < thresh`` votes).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops import lie


def backproject_and_filter(images, poses, disps, intrinsics, index,
                           thresh=2.0, scale=8, min_count=2):
    """Dense consistency-filtered point cloud of one keyframe.

    images     (N, H*scale, W*scale, 3) uint8 (full resolution, for colors)
    poses      (N, 7) world-to-camera (the engine's convention)
    disps      (N, H, W) dense inverse depth at 1/scale resolution
    intrinsics (N, 4) at 1/scale resolution (``scale`` only picks the
               color pixels)
    index      int, the keyframe to backproject
    -> (points (H*W, 3) world coordinates, colors (H*W, 3) uint8 RGB,
        keep (H*W,) bool)
    """
    N, H, W = disps.shape
    dev = disps.device
    index = int(index)
    poses = poses.float()
    disps = disps.float()
    intrinsics = intrinsics.float()
    fx, fy, cx, cy = intrinsics[index].unbind()

    i, j = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                          torch.arange(W, dtype=torch.float32, device=dev),
                          indexing="ij")
    d = disps[index]

    # depth-discontinuity rejection
    dxs = F.pad(d[:, 1:] - d[:, :-1], (0, 1))
    dys = F.pad(d[1:, :] - d[:-1, :], (0, 0, 0, 1))
    smooth = torch.sqrt(dxs ** 2 + dys ** 2) <= 0.01
    interior = (i < H - 1) & (j < W - 1)

    X0 = torch.stack([(j - cx) / fx, (i - cy) / fy, torch.ones_like(d), d],
                     dim=-1).reshape(-1, 4)
    Xw = lie.se3_act4(lie.se3_inv(poses[index])[None], X0)
    points = Xw[:, :3] / Xw[:, 3:4].clamp(min=1e-8)

    # colors from the full-resolution image, BGR -> RGB
    ii = (i * scale).long()
    jj = (j * scale).long()
    colors = images[index][ii, jj].flip(-1).reshape(-1, 3)

    # multi-view depth-consistency votes, every frame at once
    Xc = lie.se3_act4(poses[:, None], Xw[None])                  # (N, HW, 4)
    z = Xc[..., 2].clamp(min=1e-8)
    z2 = Xc[..., 3] / z
    x1 = intrinsics[:, 0, None] * (Xc[..., 0] / z) + intrinsics[:, 2, None]
    y1 = intrinsics[:, 1, None] * (Xc[..., 1] / z) + intrinsics[:, 3, None]
    # round half to even like jnp.round; clamped to one past the bounds
    # before the integer cast so no value overflows
    i1 = torch.round(y1).clamp(-1, H).long()
    j1 = torch.round(x1).clamp(-1, W).long()
    ok = ((i1 >= 0) & (i1 < H) & (j1 >= 0) & (j1 < W)
          & (d.reshape(-1) > 0.1) & (Xc[..., 2] > 1e-8))
    frame = torch.arange(N, device=dev)[:, None]
    z1 = disps[frame, i1.clamp(0, H - 1), j1.clamp(0, W - 1)]
    ratio = torch.maximum(z1 / z2.clamp(min=1e-8), z2 / z1.clamp(min=1e-8))
    votes = ok & (100.0 * (ratio - 1.0) < thresh)
    not_self = torch.arange(N, device=dev) != index
    count = (votes & not_self[:, None]).sum(0)

    keep = (smooth & interior).reshape(-1) & (count >= min_count)
    return points, colors, keep
