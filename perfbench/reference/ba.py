"""Local bundle adjustment in plain PyTorch, float32 unless asked for
another precision: Gauss-Newton over the free keyframe poses (6 dof each)
and the inverse depths of the patches the edges touch, with the depths
eliminated by a Schur complement.

DPVO's local BA: residuals at each patch's centre pixel, the robust mask
(residual under 128 px, depth in front past 0.2, the projection within 64
px of the frame), damping ``S + diag(1e-4 diag(S) + 1)`` and ``1e-4`` on
the depths, an update skipped where the Cholesky factorisation fails, and
the depth reset (above 20 -> 1, floor 1e-4), which a skipped step
applies too.
"""
from __future__ import annotations

import torch

from . import lie

NEAR_RESET = 15.0   # depths from here on are within reach of the reset at 20


def _terms(poses, ctr, depth, intr, target, ii, jj, kk):
    fx, fy, cx, cy = intr
    Gij = lie.mul(poses[jj], lie.inv(poses[ii]))
    t = Gij[:, :3]
    c = ctr[kk]
    Xi = torch.stack([(c[:, 0] - cx) / fx, (c[:, 1] - cy) / fy,
                      torch.ones_like(c[:, 0]), depth[kk]], dim=-1)
    X, Y, Z, W = lie.act4(Gij, Xi).unbind(-1)
    front = Z >= 0.2
    d = torch.where(front, 1.0 / torch.where(front, Z, 1.0), 0.0)
    d2 = d * d
    Zs = torch.where(Z.abs() > 1e-6, Z, 1e-6)
    x1, y1 = fx * X / Zs + cx, fy * Y / Zs + cy
    r = target - torch.stack([x1, y1], dim=-1)
    mask = ((r.norm(dim=-1) < 128) & (Z > 0.2) & (x1 > -64) & (y1 > -64)
            & (x1 < 2 * cx + 64) & (y1 < 2 * cy + 64)).to(r.dtype)
    o = torch.zeros_like(d)
    Jj = torch.stack([
        torch.stack([fx * W * d, o, -fx * X * W * d2, -fx * X * Y * d2,
                     fx * (1 + X * X * d2), -fx * Y * d], -1),
        torch.stack([o, fy * W * d, -fy * Y * W * d2, -fy * (1 + Y * Y * d2),
                     fy * X * Y * d2, fy * X * d], -1)], dim=1)  # (E, 2, 6)
    Ji = lie.adjT(Gij[:, None], Jj)
    Jz = torch.stack([fx * (t[:, 0] * d - t[:, 2] * X * d2),
                      fy * (t[:, 1] * d - t[:, 2] * Y * d2)], dim=-1)
    return r, mask, Ji, Jj, Jz


def local_ba(poses, ctr, depth, intr, target, weight, ii, jj, kk, t0, t1,
             iterations=2, lmbda=1e-4, dtype=torch.float32):
    """poses (n, 7), ctr (K, 2) patch centres, depth (K,), intr (4,),
    target/weight (E, 2); poses t0 <= i < t1 are free.  -> (poses, depth,
    loose), new tensors; ``loose`` (K,) marks the patches whose step
    rounding can set: those the edges all but leave free (their
    information at the first iteration, the depth block of the normal
    equations, under a thousandth of the median touched patch's), whose
    step the damping alone bounds, and those whose depth before the reset
    reached NEAR_RESET at any iteration, which rounding can carry either
    side of it.  ``dtype``: every tensor and operation in it (the poses'
    products, the edges' terms, their sums), but the Cholesky solve, which
    is in float32 at least."""
    poses, ctr, depth, intr, target, weight = (
        x.to(dtype) for x in (poses, ctr, depth, intr, target, weight))
    poses, depth = poses.clone(), depth.clone()
    solve = torch.promote_types(dtype, torch.float32)
    nf = t1 - t0
    D = 6 * nf
    uk, slot = torch.unique(kk, return_inverse=True)
    Ku = uk.shape[0]
    dev = poses.device
    loose = torch.zeros(depth.shape[0], dtype=torch.bool, device=dev)
    for it in range(iterations):
        r, mask, Ji, Jj, Jz = _terms(poses, ctr, depth, intr, target,
                                     ii, jj, kk)
        w = weight * mask[:, None]                            # (E, 2)
        li, lj = ii - t0, jj - t0
        J = torch.zeros((ii.shape[0], 2, nf + 1, 6), dtype=dtype,
                        device=dev)
        fi = torch.where((li >= 0) & (li < nf), li, nf)
        fj = torch.where((lj >= 0) & (lj < nf), lj, nf)
        ar = torch.arange(ii.shape[0], device=dev)
        J[ar, :, fi] -= Ji
        J[ar, :, fj] += Jj
        J = J[:, :, :nf].reshape(-1, 2, D)                    # (E, 2, D)
        wJ = w[..., None] * J
        B = wJ.reshape(-1, D).t() @ J.reshape(-1, D)
        v = torch.einsum("era,er->a", wJ, r)
        Em = torch.zeros((Ku, D), dtype=dtype, device=dev).index_add_(
            0, slot, torch.einsum("er,era->ea", w * Jz, J)).t()
        C = torch.zeros(Ku, dtype=dtype, device=dev).index_add_(0, slot,
                                                   (w * Jz * Jz).sum(1))
        u = torch.zeros(Ku, dtype=dtype, device=dev).index_add_(0, slot,
                                                   (w * r * Jz).sum(1))
        if it == 0:
            loose[uk] = C < 1e-3 * C.median()
        Q = 1.0 / (C + lmbda)
        EQ = Em * Q
        S = B - EQ @ Em.t()
        S = S + torch.diag(1e-4 * torch.diagonal(S) + 1.0)
        y = v - EQ @ u
        L, info = torch.linalg.cholesky_ex(S.to(solve))
        dX = torch.cholesky_solve(y.to(solve)[:, None], L)[:, 0].to(dtype)
        dZ = Q * (u - Em.t() @ dX)
        if int(info) != 0 or not bool(torch.isfinite(dX).all()):
            dX, dZ = torch.zeros_like(dX), torch.zeros_like(dZ)
        poses[t0:t1] = lie.retr(poses[t0:t1], dX.reshape(nf, 6))
        dn = depth[uk] + dZ
        loose[uk] |= dn >= NEAR_RESET
        dn = torch.where(dn > 20.0, torch.ones_like(dn), dn).clamp(min=1e-4)
        depth[uk] = dn
    return poses, depth, loose
