"""Proximity loop closure: flow-magnitude edge proposals and a greedy NMS.

Counterpart of ``dpvo_tpu/loop_closure/proximity.py`` (the reference's
``PatchGraph.edges_loop`` and ``reduce_edges``).  The flow screening of
every candidate edge runs on the device in one call; its two vectors come
back to the host in one copy, where the per-frame-pair aggregation and the
greedy NMS (``reduce_edges``, a verbatim numpy copy) run.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import projective as pops


def _flow_mag_center(poses, patches, intrinsics, ii, jj, kk):
    """Center-pixel flow magnitude (beta 0.5) and validity of the
    candidate edges."""
    flow, val = pops.flow_mag(poses, patches, intrinsics, ii, jj, kk,
                              beta=0.5)
    c = flow.shape[-1] // 2
    return flow[:, c, c], val[:, c, c]


def reduce_edges(flow_mag, ii, jj, max_num_edges=1000, nms=1):
    """Greedy lowest-flow-first edge selection with (i, j) NMS suppression:
    suppress neighbors within ``nms`` in both endpoints; skip |j - i| < 30."""
    es = []
    order = np.argsort(flow_mag)
    suppressed = set()
    for idx in order:
        if len(es) >= max_num_edges:
            break
        i, j = int(ii[idx]), int(jj[idx])
        if (i, j) in suppressed:
            continue
        if abs(j - i) < 30:
            continue
        es.append((i, j))
        for di in range(-nms, nms + 1):
            for dj in range(-nms, nms + 1):
                suppressed.add((i + di, j + dj))
    return np.array(es, dtype=np.int64).reshape(-1, 2)


def propose_loop_edges(slam):
    """Edges from old patches into recent frames.

    Candidates link every patch of the frames in ``[max(l - MAX_EDGE_AGE,
    0), l)``, ``l = n - REMOVAL_WINDOW``, to every frame in ``[n -
    GLOBAL_OPT_FREQ, n - KEYFRAME_INDEX)``.  A (source, target) frame pair
    whose patches are valid for more than 3/4 of M scores the mean flow of
    its valid patches; pairs under ``BACKEND_THRESH`` go through
    ``reduce_edges``, and each chosen pair links all M patches of its
    source frame.  Returns (kk, jj) int32 numpy arrays (possibly empty)."""
    cfg = slam.cfg
    M = slam.M
    n = slam.n
    empty = (np.zeros(0, np.int32), np.zeros(0, np.int32))
    l = n - cfg.REMOVAL_WINDOW  # upper bound for "old" patches
    if l <= 0:
        return empty
    j0 = max(n - cfg.GLOBAL_OPT_FREQ, 0)
    j1 = n - cfg.KEYFRAME_INDEX
    if j1 <= j0:
        return empty
    k0 = max(l - cfg.MAX_EDGE_AGE, 0) * M
    k1 = l * M

    jr = np.arange(j0, j1, dtype=np.int32)
    kr = np.arange(k0, k1, dtype=np.int32)
    jj = np.repeat(jr, len(kr))
    kk = np.tile(kr, len(jr))
    ii = kk // M

    ds = slam.ds
    flow, val = _flow_mag_center(
        ds.poses, ds.patches, ds.intrinsics,
        *(torch.from_numpy(a.astype(np.int64)).to(ds.poses.device)
          for a in (ii, jj, kk)))
    fv = torch.stack([flow, val.float()]).cpu().numpy()
    fl = fv[0].astype(np.float64).reshape(len(jr), -1, M)
    vl = fv[1].astype(bool).reshape(len(jr), -1, M)

    # per (target frame, source frame) aggregation over the M patches
    num_val = np.maximum(vl.sum(-1), 1)
    fsum = (fl * vl).sum(-1)
    fmag = np.where(vl.sum(-1) > (M * 0.75), fsum / num_val, np.inf)

    mask = fmag < cfg.BACKEND_THRESH
    if not mask.any():
        return empty
    ii_f = (np.arange(k0 // M, l)[None, :] * np.ones((len(jr), 1),
                                                    np.int64))[mask]
    jj_f = (jr[:, None] * np.ones((1, l - k0 // M), np.int64))[mask]
    es = reduce_edges(fmag[mask], ii_f, jj_f, max_num_edges=1000, nms=1)
    if len(es) == 0:
        return empty

    # expand each (i, j) pair to all M patches of frame i
    kk_out = (es[:, 0:1] * M + np.arange(M)[None, :]).reshape(-1)
    jj_out = np.repeat(es[:, 1], M)
    return kk_out.astype(np.int32), jj_out.astype(np.int32)
