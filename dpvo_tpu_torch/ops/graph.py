"""Edge-graph utilities for the patch graph (plain PyTorch).

Counterpart of ``dpvo_tpu/ops/graph.py``: for every edge, the previous /
next edge sharing its patch ``kk``, ordered by target frame ``jj``;
``neighbors_host`` computes the same in numpy for edge tables on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from .scatter import INT_MAX


def lexsort_kk_jj(kk_m, jj):
    """Stable sort order by (kk_m, jj): two stable sorts, minor key first
    (``jnp.lexsort((jj, kk_m))``; tie order is free for every consumer)."""
    o1 = torch.sort(jj, stable=True).indices
    o2 = torch.sort(kk_m[o1], stable=True).indices
    return o1[o2]


def neighbors(kk, jj, valid=None):
    """(ix, jx) (E,) int64: index of the prev/next edge with the same
    ``kk`` sorted by ``jj``; -1 where none exists.  Invalid edges neither
    give nor receive neighbors."""
    if valid is None:
        valid = torch.ones_like(kk, dtype=torch.bool)
    kk_m = torch.where(valid, kk.long(), INT_MAX)
    return neighbors_from_order(kk_m, valid, lexsort_kk_jj(kk_m, jj.long()))


def neighbors_from_order(kk_m, valid, order):
    """``neighbors`` for a precomputed (kk, jj) sort ``order`` over
    sentinel-masked keys ``kk_m``."""
    E = kk_m.shape[0]
    kk_sorted = kk_m[order]
    valid_sorted = valid[order]
    same = kk_sorted[1:] == kk_sorted[:-1]
    no = torch.zeros(1, dtype=torch.bool, device=kk_m.device)
    same_prev = torch.cat([no, same]) & valid_sorted
    same_next = torch.cat([same, no]) & valid_sorted
    minus1 = torch.full_like(order, -1)
    prev_idx = torch.where(same_prev, torch.roll(order, 1), minus1)
    next_idx = torch.where(same_next, torch.roll(order, -1), minus1)
    ix = torch.empty(E, dtype=torch.int64, device=kk_m.device)
    jx = torch.empty(E, dtype=torch.int64, device=kk_m.device)
    ix[order] = prev_idx.long()
    jx[order] = next_idx.long()
    return ix, jx


def neighbors_host(kk, jj, e_num):
    """``neighbors`` in numpy, for edge tables kept on the host: rows at or
    past ``e_num`` are invalid.  -> (ix, jx) (E,) int32, -1 where none."""
    E = len(kk)
    kk_m = np.asarray(kk, np.int64).copy()
    kk_m[e_num:] = np.iinfo(np.int64).max
    order = np.lexsort((np.asarray(jj), kk_m))
    kk_sorted = kk_m[order]
    valid_sorted = order < e_num
    same = kk_sorted[1:] == kk_sorted[:-1]
    same_prev = np.concatenate([[False], same]) & valid_sorted
    same_next = np.concatenate([same, [False]]) & valid_sorted
    ix = np.full(E, -1, np.int32)
    jx = np.full(E, -1, np.int32)
    ix[order] = np.where(same_prev, np.roll(order, 1), -1)
    jx[order] = np.where(same_next, np.roll(order, -1), -1)
    return ix, jx


def flatmeshgrid(a, b):
    """Cartesian product of two index arrays, flattened."""
    aa, bb = torch.meshgrid(a, b, indexing="ij")
    return aa.reshape(-1), bb.reshape(-1)
