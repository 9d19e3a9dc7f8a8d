"""Segment ops, group metadata for the compact segment path, and
``compactify`` (plain PyTorch).

Counterpart of ``dpvo_tpu/ops/scatter.py``: the differentiable segment
reductions of the training path (``scatter_sum``, ``scatter_mean``,
``scatter_max``, ``scatter_softmax``; ``index_add`` and ``scatter_reduce``),
``group_meta_compact_device`` and ``compactify``.  All run at static shapes
with no host synchronisation (no ``torch.unique``, ``torch.nonzero`` or
boolean-mask indexing).  The reductions take ``src`` (E, ...) and ``index``
(E,) int in [0, num_segments) and return (num_segments, ...).
"""
from __future__ import annotations

import torch

INT_MAX = torch.iinfo(torch.int32).max


def scatter_sum(src, index, num_segments):
    """Sum the rows of ``src`` into segments."""
    out = src.new_zeros((num_segments,) + src.shape[1:])
    return out.index_add(0, index, src)


def scatter_mean(src, index, num_segments):
    """Mean of each segment's rows (0 for an empty segment)."""
    s = scatter_sum(src, index, num_segments)
    cnt = scatter_sum(torch.ones(index.shape, dtype=src.dtype,
                                 device=src.device), index, num_segments)
    return s / cnt.clamp(min=1).reshape((-1,) + (1,) * (src.dim() - 1))


def scatter_max(src, index, num_segments):
    """Max of each segment's rows (-inf for an empty segment)."""
    out = src.new_full((num_segments,) + src.shape[1:], float("-inf"))
    idx = index.reshape((-1,) + (1,) * (src.dim() - 1)).expand(src.shape)
    return out.scatter_reduce(0, idx, src, "amax", include_self=False)


def scatter_softmax(src, index, num_segments):
    """Softmax within segments, broadcast back to the rows; the segment max
    is subtracted for stability, and an empty segment shifts by 0."""
    seg_max = scatter_max(src, index, num_segments)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    e = torch.exp(src - seg_max[index])
    denom = scatter_sum(e, index, num_segments).clamp(min=1e-12)
    return e / denom[index]


def group_meta_compact(ids, order=None):
    """Dense group ranks of ``ids`` (E,) for ``ops.agg_cuda``.

    Equal values form a group; callers mask invalid rows to ``INT_MAX`` so
    they sort to the tail as one trash group.  ``order`` is an optional
    precomputed stable sort of ``ids`` (any tie order), shared between
    consumers.  Returns (perm (E,) int64 sorting rows by group, gid_sorted
    (E,) int32 nondecreasing dense ranks with step <= 1, gid_orig (E,) int64
    the rank of each ORIGINAL row)."""
    E = ids.shape[0]
    perm = (torch.sort(ids, stable=True).indices if order is None
            else order.long())
    s = ids[perm]
    new_grp = torch.ones(E, dtype=torch.bool, device=ids.device)
    new_grp[1:] = s[1:] != s[:-1]
    gid_sorted = torch.cumsum(new_grp, 0, dtype=torch.int32) - 1
    gid_orig = torch.empty(E, dtype=torch.int64, device=ids.device)
    gid_orig[perm] = gid_sorted.long()
    return perm, gid_sorted, gid_orig


def compactify(ix, size, fill=INT_MAX, order=None):
    """Static-shape counterpart of ``torch.unique(ix, return_inverse=True)``.

    Returns (kx, ku): ``kx`` (size,) the sorted unique values of ``ix``
    (E,), padded with ``fill``; ``ku`` (E,) int64 the slot of each element
    in ``kx``.  Uniques past ``size`` are dropped and their elements get
    slot ``size`` (one past the end), as a search of ``kx`` would give.
    One sort (or ``order``, a precomputed sort of ``ix`` in any tie order),
    the run heads and a scatter into ``size + 1`` slots, the last of which
    takes the writes of non-head and dropped elements."""
    E = ix.shape[0]
    if order is None:
        s, perm = torch.sort(ix)
    else:
        perm = order.long()
        s = ix[perm]
    head = torch.ones(E, dtype=torch.bool, device=ix.device)
    head[1:] = s[1:] != s[:-1]
    rank = (torch.cumsum(head, 0) - 1).clamp(max=size)
    slot = torch.where(head, rank, size)
    kx = torch.full((size + 1,), fill, dtype=ix.dtype, device=ix.device)
    kx.scatter_(0, slot, s)
    ku = torch.empty(E, dtype=torch.int64, device=ix.device)
    ku[perm] = rank
    return kx[:size], ku
