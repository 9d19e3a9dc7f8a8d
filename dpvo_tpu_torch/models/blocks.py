"""Network building blocks (PyTorch).

Counterpart of ``dpvo_tpu/models/blocks.py``: ``GatedResidual``,
``LayerNorm1D``, ``SoftAgg`` (the compact form on group-sorted rows, the
scatter form with a trash group and the cross-rank form of edge-sharded
inference) and the gradient-surgery ops ``grad_clip``,
``grad_zero`` and ``grad_mag`` as ``torch.autograd.Function``s.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ..ops import agg_cuda, scatter

GRAD_CLIP = 0.1


class _GradClip(torch.autograd.Function):
    """Identity forward; backward: NaN -> 0, then clamp to +-0.01."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return torch.where(torch.isnan(g), 0.0, g).clamp(-0.01, 0.01)


class _GradZero(torch.autograd.Function):
    """Identity forward; backward: NaN -> 0 and |g| > GRAD_CLIP -> 0."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = torch.where(torch.isnan(g), 0.0, g)
        return torch.where(g.abs() > GRAD_CLIP, 0.0, g)


class _GradMag(torch.autograd.Function):
    """Identity forward; backward prints the mean |grad| (a debug probe:
    wrap a tensor to see the gradient magnitude arriving at it)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        print(f"grad_mag: {g.abs().mean().item()}")
        return g


def grad_clip(x):
    return _GradClip.apply(x)


def grad_zero(x):
    return _GradZero.apply(x)


def grad_mag(x):
    return _GradMag.apply(x)


class GatedResidual(nn.Module):
    """x + sigmoid(W_g x) * MLP(x)."""

    def __init__(self, dim):
        super().__init__()
        self.gate = nn.Linear(dim, dim)
        self.res1 = nn.Linear(dim, dim)
        self.res2 = nn.Linear(dim, dim)

    def forward(self, x):
        return x + torch.sigmoid(self.gate(x)) * self.res2(
            F.relu(self.res1(x)))


class LayerNorm1D(nn.LayerNorm):
    """LayerNorm with eps=1e-4."""

    def __init__(self, dim):
        super().__init__(dim, eps=1e-4)


class SoftAgg(nn.Module):
    """Softmax attention pooling over groups, broadcast back to the rows.

    Compact form (``compact_meta`` = (perm, gid_sorted, gid_orig) from
    ``ops.scatter.group_meta_compact``, ranks below ``g_cap``; the engine's):
    rows are sorted by group, the softmax sums land on one row per GROUP
    (``ops.agg_cuda.segment_softmax_sums``, which has no backward), the
    output projection ``h`` runs at group granularity, and one row gather
    broadcasts back.

    Scatter form (``jx`` group ids in [0, num_groups), ``valid`` mask;
    training's): invalid rows go to a trash group ``num_groups``, the softmax
    weights are computed in fp32, and everything is differentiable.

    Cross-rank form (``group``, a ``torch.distributed`` process group; the
    edge-sharded step's, ``parallel.infer_step``): groups may span ranks, so
    ``jx`` must be dense ids in [0, num_groups) that agree across the ranks.
    The segment softmax takes three collectives: ``all_reduce(MAX)`` of the
    per-group maxima, then ``all_reduce(SUM)`` of the (num_groups + 1, dim)
    exp sums and of the exp-weighted value sums (the JAX package's
    ``shard_axis`` path: pmax, psum, psum).
    """

    def __init__(self, dim):
        super().__init__()
        self.dim = dim
        self.f = nn.Linear(dim, dim)
        self.g = nn.Linear(dim, dim)
        self.h = nn.Linear(dim, dim)

    def forward(self, x, jx=None, num_groups=None, valid=None,
                compact_meta=None, g_cap=None, group=None):
        if group is not None:
            return self._cross_rank(x, jx, num_groups, valid, group)
        if compact_meta is None:
            if valid is not None:
                jx = torch.where(valid, jx, num_groups)
            S = num_groups + 1
            f = self.f(x)
            w = scatter.scatter_softmax(self.g(x).float(), jx, S)
            y = scatter.scatter_sum(f * w.to(f.dtype), jx, S)
            return self.h(y)[jx]
        perm, gid_sorted, gid_orig = compact_meta
        x_s = x[perm]
        f = self.f(x_s)
        g32 = self.g(x_s).float()
        # a global per-column shift is constant within every group, so the
        # softmax is invariant to it
        shift = g32.max(dim=0, keepdim=True).values
        T = agg_cuda.segment_softmax_sums(
            g32.contiguous(), f.float().contiguous(), shift,
            gid_sorted.contiguous(), g_cap)        # (G_pad, 2*dim) fp32
        Y = T[:, self.dim:] / T[:, :self.dim].clamp(min=1e-12)
        h = self.h(Y.to(self.h.weight.dtype))
        return h[gid_orig]

    def _cross_rank(self, x, jx, num_groups, valid, group):
        S = num_groups + 1
        if valid is not None:
            jx = torch.where(valid, jx, num_groups)
        jx = jx.long()
        f = self.f(x)
        g32 = self.g(x).float()
        idx = jx[:, None].expand_as(g32)
        m = torch.full((S, self.dim), float("-inf"), device=x.device)
        m = m.scatter_reduce(0, idx, g32, "amax")
        dist.all_reduce(m, dist.ReduceOp.MAX, group=group)
        # an empty group's max is -inf on every rank
        m = torch.where(torch.isfinite(m), m, 0.0)
        e = torch.exp(g32 - m[jx])
        denom = torch.zeros((S, self.dim), device=x.device).index_add_(
            0, jx, e)
        dist.all_reduce(denom, group=group)
        w = e / denom.clamp(min=1e-12)[jx]
        y = torch.zeros((S, self.dim), device=x.device).index_add_(
            0, jx, f.float() * w)
        dist.all_reduce(y, group=group)
        return self.h(y.to(self.h.weight.dtype))[jx]
