"""Recurrent update operator (PyTorch).

Counterpart of ``dpvo_tpu/models/update.py``: the corr encoder, temporal
neighbor message passing (c1/c2), SoftAgg over patch groups (kk) and
frame-pair groups (ii*12345+jj), the 2-layer gated-residual "GRU", and the
flow-delta / confidence heads computed in the compute dtype.  Submodule
names follow the flax module so a reader can find each counterpart.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import corr_cuda, graph, scatter
from .blocks import GatedResidual, SoftAgg, grad_clip

DIM = 384


class CorrDense(nn.Module):
    """The corr encoder's first Linear layer.

    ``weight`` is checkpoint-shaped (DIM, 2*49*p*p) over the reference's
    interleaved (dx, dy, py, px, level) feature order.  ``forward`` takes
    either interleaved features (E, 882); or ``("raw", feat)`` with kernel
    layout features of width 882 (raw), 1152 (v10) or 2304 (v12) from
    ``ops.corr_cuda.corr_fused``, multiplied by the weight rows mapped to
    that layout (``raw_kernel``); or ``("enc", act)`` where ``act`` holds
    the pre-bias activations that ``ops.corr_cuda.corr_enc`` already
    computed in-kernel with ``raw_kernel()``, so only the bias remains.
    """

    def __init__(self, in_dim, features):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_dim))
        self.bias = nn.Parameter(torch.empty(features))
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)
        nn.init.uniform_(self.bias, -in_dim ** -0.5, in_dim ** -0.5)

    def raw_kernel(self, in_dim=2 * corr_cuda.RAW_DIM):
        """(in_dim, DIM) kernel with rows in the kernel feature layout of
        that width (default the raw order)."""
        return corr_cuda.raw_enc_kernel(self.weight.t(), in_dim)

    def forward(self, corr):
        if isinstance(corr, tuple):
            form, feat = corr
            if form == "enc":
                return feat.to(self.bias.dtype) + self.bias
            if form == "raw":
                return (feat.to(self.weight.dtype)
                        @ self.raw_kernel(feat.shape[-1]) + self.bias)
            raise ValueError(f"unknown corr form {form!r}")
        return F.linear(corr.to(self.weight.dtype), self.weight, self.bias)


def compact_meta_for(ii, jj, kk, valid):
    """(cm_kk, cm_ij) compact group metadata for the two SoftAggs, with
    invalid rows masked to the INT_MAX trash group."""
    imax = scatter.INT_MAX
    kk_g = torch.where(valid, kk.long(), imax)
    pair = torch.where(valid, ii.long() * 12345 + jj.long(), imax)
    return (scatter.group_meta_compact(kk_g),
            scatter.group_meta_compact(pair))


class Update(nn.Module):
    def __init__(self, p=3):
        super().__init__()
        self.corr1 = CorrDense(2 * 49 * p * p, DIM)
        self.corr2 = nn.Linear(DIM, DIM)
        self.corr_norm = nn.LayerNorm(DIM, eps=1e-3)
        self.corr3 = nn.Linear(DIM, DIM)
        self.norm = nn.LayerNorm(DIM, eps=1e-3)
        self.c1_0 = nn.Linear(DIM, DIM)
        self.c1_1 = nn.Linear(DIM, DIM)
        self.c2_0 = nn.Linear(DIM, DIM)
        self.c2_1 = nn.Linear(DIM, DIM)
        self.agg_kk = SoftAgg(DIM)
        self.agg_ij = SoftAgg(DIM)
        self.gru_norm1 = nn.LayerNorm(DIM, eps=1e-3)
        self.gru_res1 = GatedResidual(DIM)
        self.gru_norm2 = nn.LayerNorm(DIM, eps=1e-3)
        self.gru_res2 = GatedResidual(DIM)
        self.d = nn.Linear(DIM, 2)
        self.w = nn.Linear(DIM, 2)

    def forward(self, net, inp, corr, ii, jj, kk, valid=None, nbrs=None,
                compact_meta=None, g_cap=None, shard_ctx=None):
        """One recurrent update.

        net, inp (E, DIM); corr (E, 882) interleaved, ("raw", feat) or
        ("enc", act) (see CorrDense);
        ii, jj, kk (E,) int; valid (E,) bool.  ``nbrs`` (ix, jx) is computed
        here when not given (the engine shares one sort between it, the
        metadata and BA).  With ``compact_meta`` (cm_kk, cm_ij) and
        ``g_cap`` the SoftAggs take the compact path (the engine's; the CUDA
        kernel on the card, no backward); without, the differentiable
        scatter path over ``compactify`` group ids (training's).  With
        ``shard_ctx`` (group, gid_ij, g_cap), the edge-sharded step's
        (``parallel.infer_step``): agg_kk stays rank-local (the partition
        never splits a patch group) on the scatter path, and agg_ij reduces
        across the process group over the dense pair ids ``gid_ij`` in
        [0, g_cap) that agree across the ranks.  The ``d``
        and ``w`` heads' gradients pass through ``grad_clip``.
        -> (net', delta (E, 2) fp32, weight (E, 2) fp32), invalid rows 0.
        """
        E = net.shape[0]
        if valid is None:
            valid = torch.ones(E, dtype=torch.bool, device=net.device)
        dt = self.corr2.weight.dtype

        net = net.to(dt)
        c = F.relu(self.corr1(corr))
        c = self.corr2(c)
        c = F.relu(self.corr_norm(c))
        c = self.corr3(c)

        net = self.norm(net + inp.to(dt) + c)

        ix, jx = nbrs if nbrs is not None else graph.neighbors(kk, jj, valid)
        mask_ix = (ix >= 0)[:, None].to(dt)
        mask_jx = (jx >= 0)[:, None].to(dt)
        # sequential like the reference: the jx gather sees the state
        # after the c1 residual
        net_ix = net[ix.clamp(min=0)] * mask_ix
        net = net + self.c1_1(F.relu(self.c1_0(net_ix)))
        net_jx = net[jx.clamp(min=0)] * mask_jx
        net = net + self.c2_1(F.relu(self.c2_0(net_jx)))

        if compact_meta is not None:
            cm_kk, cm_ij = compact_meta
            net = net + self.agg_kk(net, compact_meta=cm_kk, g_cap=g_cap)
            net = net + self.agg_ij(net, compact_meta=cm_ij, g_cap=g_cap)
        else:
            imax = scatter.INT_MAX
            _, ku = scatter.compactify(torch.where(valid, kk.long(), imax), E)
            net = net + self.agg_kk(net, ku, E, valid)
            if shard_ctx is not None:
                group, gid_ij, g_cap = shard_ctx
                net = net + self.agg_ij(net, gid_ij, g_cap, valid,
                                        group=group)
            else:
                pair = torch.where(valid, ii.long() * 12345 + jj.long(), imax)
                _, pu = scatter.compactify(pair, E)
                net = net + self.agg_ij(net, pu, E, valid)

        net = self.gru_res1(self.gru_norm1(net))
        net = self.gru_res2(self.gru_norm2(net))

        hd = F.relu(net)
        delta = grad_clip(self.d(hd).float())
        w = torch.sigmoid(grad_clip(self.w(hd).float()))

        vm = valid[:, None]
        zero = torch.zeros((), device=net.device)
        return (torch.where(vm, net, zero.to(dt)),
                torch.where(vm, delta, zero),
                torch.where(vm, w, zero))
