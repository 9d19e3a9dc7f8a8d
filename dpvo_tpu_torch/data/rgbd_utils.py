"""RGB-D dataset utilities: TUM loading, pose distances, flow-based
co-visibility.

Counterpart of ``dpvo_tpu/data/rgbd_utils.py``: the TUM readers are numpy
copies; the pose distances and the pairwise induced flow run on ``device``
through the port's Lie ops and ``ops.projective.induced_flow``, in batches
of frame pairs.
"""
from __future__ import annotations

import os.path as osp

import numpy as np
import torch

from ..ops import lie, projective as pops


def parse_list(filepath, skiprows=0):
    return np.loadtxt(filepath, delimiter=" ", dtype=str,
                      skiprows=skiprows)


def associate_frames(tstamp_image, tstamp_depth, tstamp_pose,
                     max_dt=1.0):
    """Timestamp association (ref rgbd_utils.py:17-33)."""
    associations = []
    for i, t in enumerate(tstamp_image):
        if tstamp_pose is None:
            j = np.argmin(np.abs(tstamp_depth - t))
            if np.abs(tstamp_depth[j] - t) < max_dt:
                associations.append((i, j))
        else:
            j = np.argmin(np.abs(tstamp_depth - t))
            k = np.argmin(np.abs(tstamp_pose - t))
            if (np.abs(tstamp_depth[j] - t) < max_dt) and \
                    (np.abs(tstamp_pose[k] - t) < max_dt):
                associations.append((i, j, k))
    return associations


def loadtum(datapath, frame_rate=-1):
    """Load a TUM-format RGB-D sequence (ref rgbd_utils.py:36-89)."""
    if osp.isfile(osp.join(datapath, 'groundtruth.txt')):
        pose_list = osp.join(datapath, 'groundtruth.txt')
    elif osp.isfile(osp.join(datapath, 'pose.txt')):
        pose_list = osp.join(datapath, 'pose.txt')
    else:
        return None, None, None, None

    image_list = osp.join(datapath, 'rgb.txt')
    depth_list = osp.join(datapath, 'depth.txt')

    image_data = parse_list(image_list, skiprows=1)
    depth_data = parse_list(depth_list, skiprows=1)
    pose_data = parse_list(pose_list, skiprows=1)
    pose_vecs = pose_data[:, 1:].astype(np.float64)

    tstamp_image = image_data[:, 0].astype(np.float64)
    tstamp_depth = depth_data[:, 0].astype(np.float64)
    tstamp_pose = pose_data[:, 0].astype(np.float64)
    associations = associate_frames(tstamp_image, tstamp_depth, tstamp_pose)

    # reduce to target frame rate
    indices = [0]
    for i in range(1, len(associations)):
        t0 = tstamp_image[associations[indices[-1]][0]]
        t1 = tstamp_image[associations[i][0]]
        if frame_rate < 0 or t1 - t0 > 1.0 / frame_rate:
            indices.append(i)

    images, poses, depths, tstamps = [], [], [], []
    for ix in indices:
        (i, j, k) = associations[ix]
        images.append(osp.join(datapath, image_data[i, 1]))
        depths.append(osp.join(datapath, depth_data[j, 1]))
        poses.append(pose_vecs[k])
        tstamps.append(tstamp_image[i])
    return images, depths, poses, tstamps


def all_pairs_distance_matrix(poses, beta=2.5, device="cuda"):
    """Approximate pose distance between all pairs: |t| + beta * |phi| of
    the relative poses, (N, N) numpy."""
    g = torch.tensor(np.asarray(poses, np.float32), device=device)
    N = g.shape[0]
    rel = lie.se3_mul(lie.se3_inv(g[:, None]).expand(N, N, 7),
                      g[None, :].expand(N, N, 7))
    t = torch.linalg.norm(rel[..., :3], dim=-1)
    phi = torch.linalg.norm(lie.se3_log(rel)[..., 3:], dim=-1)
    return (t + beta * phi).cpu().numpy()


@torch.no_grad()
def compute_distance_matrix_flow(poses, disps, intrinsics,
                                 batch_pairs=2048, device="cuda"):
    """Mean induced flow between all frame pairs, (N, N) numpy.

    poses (N, 7), disps (N, h, w) subsampled, intrinsics (4,) or (N, 4).
    Pairs with <70% valid pixels get infinite distance; the matrix is
    symmetrised with the larger of both directions.
    """
    N = poses.shape[0]
    poses_t = torch.tensor(np.asarray(poses, np.float32), device=device)
    disps_t = torch.tensor(np.asarray(disps, np.float32), device=device)
    intr = np.asarray(intrinsics, np.float32)
    if intr.ndim == 1:
        intr = np.tile(intr[None], (N, 1))
    intr_t = torch.as_tensor(intr, device=device)

    ii, jj = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
    ii = torch.as_tensor(ii.reshape(-1), device=device)
    jj = torch.as_tensor(jj.reshape(-1), device=device)
    out = []
    for s in range(0, N * N, batch_pairs):
        flow, val = pops.induced_flow(poses_t, disps_t, intr_t,
                                      ii[s:s + batch_pairs],
                                      jj[s:s + batch_pairs])
        mag = torch.linalg.norm(flow, dim=-1)          # (B, h, w)
        val = val[..., 0]
        frac = val.mean(dim=(1, 2))
        mean_mag = ((mag * val).sum(dim=(1, 2))
                    / val.sum(dim=(1, 2)).clamp(min=1.0))
        out.append(torch.where(frac > 0.7, mean_mag, float("inf")))
    d = torch.cat(out).reshape(N, N).cpu().numpy()
    return np.maximum(d, d.T)
