"""Patch extraction and local correlation (plain PyTorch).

Counterpart of ``dpvo_tpu/ops/corr.py``.  Layout is channels-last (NHWC)
like the JAX package, so feature rings and patch tables keep the same
shapes on both sides.

- ``patchify``: gather (2R+2)^2 windows at float coords + 4-tap bilinear
  blend, computed in the feature map's dtype.
- ``corr``: patch-centric local correlation, the training rollout's (the
  engine runs the CUDA kernels of ``ops.corr_cuda``, and the tests hold
  their plain versions to it).  A loop over the window's rows of offsets,
  as the JAX package scans them, with a backward of its own: its fp32
  transient is one row, E * P^2 * (2R+2) * C, where a gather of the whole
  window holds 2R+2 times that (at the rollout's 18000 edges, 5.3 GB per
  level).
"""
from __future__ import annotations

import torch


def _bilinear_blend(vals, dx, dy):
    """4-tap blend over the two trailing window axes (size D -> D-1)."""
    v00 = vals[..., :-1, :-1]
    v01 = vals[..., :-1, 1:]
    v10 = vals[..., 1:, :-1]
    v11 = vals[..., 1:, 1:]
    return ((1 - dy) * (1 - dx) * v00 + (1 - dy) * dx * v01
            + dy * (1 - dx) * v10 + dy * dx * v11)


def patchify(net, coords, radius):
    """net (N, H, W, C), coords (N, M, 2) float [x, y], radius R
    -> (N, M, 2R+1, 2R+1, C) in the dtype of ``net``."""
    N, H, W, C = net.shape
    M = coords.shape[1]
    R = radius
    D = 2 * R + 2
    coords = coords.float()
    base_f = torch.floor(coords)
    base = base_f.long()                                   # (N, M, 2)
    off = coords - base_f

    dgrid = torch.arange(D, device=net.device) - R
    iy = base[..., 1, None] + dgrid                        # (N, M, D)
    ix = base[..., 0, None] + dgrid
    valid = ((iy[..., :, None] >= 0) & (iy[..., :, None] < H)
             & (ix[..., None, :] >= 0) & (ix[..., None, :] < W))
    flat = (iy.clamp(0, H - 1)[..., :, None] * W
            + ix.clamp(0, W - 1)[..., None, :])            # (N, M, D, D)
    n_idx = torch.arange(N, device=net.device)[:, None]
    out = net.reshape(N, H * W, C)[n_idx, flat.reshape(N, -1)]
    out = out.reshape(N, M, D, D, C) * valid[..., None].to(net.dtype)

    dx = off[..., 0][:, :, None, None, None].to(net.dtype)
    dy = off[..., 1][:, :, None, None, None].to(net.dtype)
    blended = _bilinear_blend(out.permute(0, 1, 4, 2, 3), dx, dy)
    return blended.permute(0, 1, 3, 4, 2)


def _window_rows(by, bx, fidx, Hp, Wp, pad, oy, R):
    """Flat map rows (E, P, P, 2R+2) of window row ``oy`` (x offsets -R..R+1)
    and, on an unpadded map, their in-bounds mask (None with ``pad``: taps
    clamp into the zero border)."""
    iy = by + (oy - R)
    ix = bx[..., None] + (torch.arange(2 * R + 2, device=bx.device) - R)
    ok = None
    if pad == 0:
        ok = ((iy >= 0) & (iy < Hp))[..., None] & (ix >= 0) & (ix < Wp)
    lin = (fidx[:, None, None, None] * (Hp * Wp)
           + (iy + pad).clamp(0, Hp - 1)[..., None] * Wp
           + (ix + pad).clamp(0, Wp - 1))
    return lin, ok


class _CorrWindows(torch.autograd.Function):
    """The (E, P, P, Dy, Dx) tap volume g . fmap[window] in fp32, one window
    row at a time in both directions; the backward adds each row's fmap
    gradient with ``index_add_``."""

    @staticmethod
    def forward(ctx, g, fmap, by, bx, fidx, R, pad):
        F_, Hp, Wp, C = fmap.shape
        fmap_lin = fmap.reshape(F_ * Hp * Wp, C)
        rows = []
        for oy in range(2 * R + 2):
            lin, ok = _window_rows(by, bx, fidx, Hp, Wp, pad, oy, R)
            f = fmap_lin[lin].float()                       # (E, P, P, D, C)
            s = torch.einsum("epqc,epqxc->epqx", g, f)
            rows.append(s if ok is None else torch.where(ok, s, 0.0))
        ctx.save_for_backward(g, fmap, by, bx, fidx)
        ctx.R, ctx.pad = R, pad
        return torch.stack(rows, dim=-2)                    # (E,P,P,Dy,Dx)

    @staticmethod
    def backward(ctx, gvol):
        g, fmap, by, bx, fidx = ctx.saved_tensors
        R, pad = ctx.R, ctx.pad
        F_, Hp, Wp, C = fmap.shape
        fmap_lin = fmap.reshape(F_ * Hp * Wp, C)
        need_g, need_f = ctx.needs_input_grad[:2]
        grad_g = torch.zeros_like(g) if need_g else None
        grad_f = (torch.zeros((F_ * Hp * Wp, C), dtype=torch.float32,
                              device=fmap.device) if need_f else None)
        for oy in range(2 * R + 2):
            lin, ok = _window_rows(by, bx, fidx, Hp, Wp, pad, oy, R)
            gv = gvol[..., oy, :]                           # (E, P, P, D)
            if ok is not None:
                gv = torch.where(ok, gv, 0.0)
            if need_g:
                f = fmap_lin[lin].float()
                grad_g += torch.einsum("epqx,epqxc->epqc", gv, f)
            if need_f:
                contrib = gv[..., None] * g[..., None, :]   # (E,P,P,D,C)
                grad_f.index_add_(0, lin.reshape(-1),
                                  contrib.reshape(-1, C))
        if need_f:
            grad_f = grad_f.reshape(fmap.shape).to(fmap.dtype)
        return grad_g, grad_f, None, None, None, None, None


def corr(gmap, fmap, coords, kidx, fidx, radius=3, pad=0):
    """Local correlation volume, differentiable in ``gmap``, ``fmap`` and
    ``coords``.

    gmap   (K, P, P, C) patch features
    fmap   (F, Hp, Wp, C) target feature maps (any float dtype; products
           in fp32), stored with a zero border of ``pad`` pixels (taps
           clamp into it, reading zeros; with ``pad`` 0 taps outside the
           map read 0)
    coords (E, 2, P, P) float coords [x, y] in UNPADDED map pixels
    kidx, fidx (E,) int patch / frame indices
    -> (E, 2R+1, 2R+1, P, P) fp32 ordered [x_off, y_off, py, px].
    """
    coords = coords.float()
    cx, cy = coords[:, 0], coords[:, 1]                    # (E, P, P)
    bx_f, by_f = torch.floor(cx), torch.floor(cy)
    dx = (cx - bx_f)[..., None, None]                      # (E, P, P, 1, 1)
    dy = (cy - by_f)[..., None, None]
    g = gmap[kidx.long()].float()                          # (E, P, P, C)
    with torch.autocast(coords.device.type, enabled=False):
        vol = _CorrWindows.apply(g, fmap, by_f.long(), bx_f.long(),
                                 fidx.long(), radius, pad)
    out = _bilinear_blend(vol, dx, dy)                     # (E,P,P,7,7)
    return out.permute(0, 4, 3, 1, 2)


def corr_stack(gmap, pyramid, coords, kidx, fidx, radius=3):
    """Two-level correlation flattened for the update operator: each
    ``(lvl, fmap)`` of ``pyramid`` correlates at ``coords / lvl`` and the
    levels stack on the last axis before flattening -> (E,
    L*(2R+1)^2*P*P) fp32."""
    outs = [corr(gmap, fmap, coords / lvl, kidx, fidx, radius)
            for lvl, fmap in pyramid]
    return torch.stack(outs, dim=-1).reshape(coords.shape[0], -1)


def avg_pool2d(x, k):
    """Average pooling with stride = kernel, NHWC."""
    if k == 1:
        return x
    *lead, H, W, C = x.shape
    xr = x.reshape(*lead, H // k, k, W // k, k, C)
    return xr.mean(dim=(-4, -2))
