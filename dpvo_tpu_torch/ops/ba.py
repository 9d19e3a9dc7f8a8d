"""Bundle adjustment: Gauss-Newton with a Schur complement over keyframe
poses (6-dof) and per-patch inverse depths (1-dof).

Counterpart of ``dpvo_tpu/ops/ba.py``'s ``ba_iterative`` (the dense window
solve of local BA), ``ba_global`` (the matrix-free Schur solve with
block-Jacobi PCG of global BA) and ``ba_differentiable`` (training's GN
step, differentiable through the Cholesky solve).  ``ba_iterative``: the reference's
robust masks (residual < 128 px, Z > 0.2, +-64 px in bounds), damping
``S += diag(1e-4 * S + 1)``, a finite-guarded Cholesky solve that skips the
update when it fails, and the depth reset (d > 20 -> 1, floor 1e-4).
Everything is fp32; callers keep TF32 off.  The pose-depth coupling
columns reduce over kk-sorted runs through ``ops.agg_cuda.segment_sums``
(the CUDA kernel on the card, its plain twin on the CPU).
"""
from __future__ import annotations

import torch

from . import agg_cuda, lie, projective as pops
from .scatter import INT_MAX, compactify


def _edge_terms_center(poses, ctr, fx, fy, cx, cy, target, ii, jj, kk,
                       Gij=None):
    """Per-edge residuals and Jacobians at the central patch pixel.
    ctr (K, 3) holds each patch's center [x, y, depth].
    Returns r (E, 2), mask (E,), Ji (E, 2, 6), Jj (E, 2, 6), Jz (E, 2)."""
    if Gij is None:
        Gij = lie.se3_mul(poses[jj], lie.se3_inv(poses[ii]))
    tij = Gij[:, :3]

    ce = ctr[kk]
    Xi = torch.stack([(ce[:, 0] - cx) / fx, (ce[:, 1] - cy) / fy,
                      torch.ones_like(ce[:, 2]), ce[:, 2]], dim=-1)
    X, Y, Z, W = lie.se3_act4(Gij, Xi).unbind(-1)

    front = Z >= 0.2
    d = torch.where(front, 1.0 / torch.where(front, Z, torch.ones_like(Z)),
                    torch.zeros_like(Z))
    d2 = d * d
    Zsafe = torch.where(Z.abs() > 1e-6, Z, torch.full_like(Z, 1e-6))
    x1 = fx * (X / Zsafe) + cx
    y1 = fy * (Y / Zsafe) + cy

    rx = target[:, 0] - x1
    ry = target[:, 1] - y1
    r = torch.stack([rx, ry], dim=-1)
    in_bounds = ((torch.sqrt(rx * rx + ry * ry) < 128) & (Z > 0.2)
                 & (x1 > -64) & (y1 > -64)
                 & (x1 < 2 * cx + 64) & (y1 < 2 * cy + 64))
    mask = in_bounds.float()

    o = torch.zeros_like(d)
    Jz_x = fx * (tij[:, 0] * d - tij[:, 2] * (X * d2))
    Jj_x = torch.stack([fx * W * d, o, fx * -X * W * d2,
                        fx * -X * Y * d2, fx * (1 + X * X * d2),
                        fx * -Y * d], dim=-1)
    Jz_y = fy * (tij[:, 1] * d - tij[:, 2] * (Y * d2))
    Jj_y = torch.stack([o, fy * W * d, fy * -Y * W * d2,
                        fy * (-1 - Y * Y * d2), fy * (X * Y * d2),
                        fy * X * d], dim=-1)

    Jj_rows = torch.stack([Jj_x, Jj_y], dim=1)              # (E, 2, 6)
    Ji_rows = lie.se3_adjT(Gij[:, None], Jj_rows)           # (E, 2, 6)
    Jz_rows = torch.stack([Jz_x, Jz_y], dim=1)              # (E, 2)
    return r, mask, Ji_rows, Jj_rows, Jz_rows


def ba_iterative(poses, patches, intrinsics, target, weight, lmbda,
                 ii, jj, kk, valid, t0, t1, n_cap, k_cap, iterations=2,
                 eperm=None, pair_gid=None, pair_cap=None, pair_rep=None):
    """Inference BA; returns (poses', patches') without touching the inputs.

    poses (Np, 7); patches (Kp, 3, P, P); intrinsics (4,) shared
    [fx, fy, cx, cy]; target, weight (E, 2); lmbda float; ii, jj, kk (E,)
    int; valid (E,) bool; poses in [t0, t1) are free (host ints);
    n_cap >= t1 - t0 pose-block capacity; k_cap unique-patch capacity.
    eperm      optional stable sort of the valid-masked kk (any tie order)
    pair_gid   optional (E,) dense frame-pair ranks (< pair_cap) in input
               order: relative poses per PAIR instead of per edge
    pair_rep   optional (pair_cap,) representative input-order edge per
               pair rank
    """
    poses = poses.float()
    patches = patches.float().clone()
    target = target.float()
    weight = weight.float()
    fx, fy, cx, cy = intrinsics.float().unbind()
    dev = poses.device
    E = ii.shape[0]
    K = patches.shape[0]
    P = patches.shape[-1]

    kk_m = torch.where(valid, kk.long(), INT_MAX)
    if eperm is None:
        eperm = torch.sort(kk_m, stable=True).indices
    ii_o, jj_o = ii.long(), jj.long()
    ii, jj, kk = ii_o[eperm], jj_o[eperm], kk.long()[eperm]
    valid = valid[eperm]
    target = target[eperm]
    weight = weight[eperm]
    kk_m = kk_m[eperm]                                      # sorted

    pg = rep_ii = rep_jj = None
    if pair_gid is not None:
        pg = pair_gid.long()[eperm]
        if pair_rep is not None:
            rep_ii, rep_jj = ii_o[pair_rep], jj_o[pair_rep]
        else:
            rep = torch.full((pair_cap,), E - 1, dtype=torch.int64,
                             device=dev)
            rep.scatter_reduce_(0, pg, torch.arange(E, device=dev), "amin")
            rep_ii, rep_jj = ii[rep], jj[rep]

    # compact slot (dense rank) of every sorted edge's patch
    new_run = torch.ones(E, dtype=torch.bool, device=dev)
    new_run[1:] = kk_m[1:] != kk_m[:-1]
    gid = torch.cumsum(new_run, 0, dtype=torch.int32) - 1
    first = torch.nonzero(new_run).squeeze(1)
    g_first = gid[first].long()
    keep = g_first < k_cap
    kx = torch.full((k_cap,), INT_MAX, dtype=torch.int64, device=dev)
    kx[g_first[keep]] = kk_m[first[keep]]                   # sorted uniques
    slot = torch.arange(k_cap, device=dev)
    hit = kx < K
    slot_of_k = torch.zeros(K, dtype=torch.int64, device=dev)
    slot_of_k[kx[hit]] = slot[hit]
    hit_k = torch.zeros(K, dtype=torch.bool, device=dev)
    hit_k[kx[hit]] = True
    kx_c = kx.clamp(0, K - 1)

    ctr = patches[:, :, P // 2, P // 2].clone()              # (K, 3)
    D = 6 * n_cap
    cols = torch.arange(n_cap, device=dev)
    pose_slot = torch.arange(poses.shape[0], device=dev)
    lp = pose_slot - t0
    free = ((lp >= 0) & (pose_slot < t1))[:, None]
    lp_c = lp.clamp(0, n_cap - 1)

    for _ in range(iterations):
        Gij_e = None
        if pg is not None:
            Gij_e = lie.se3_mul(poses[rep_jj], lie.se3_inv(poses[rep_ii]))[pg]
        r, mask, Ji, Jj, Jz = _edge_terms_center(
            poses, ctr, fx, fy, cx, cy, target, ii, jj, kk, Gij=Gij_e)
        w = mask[:, None] * weight * valid[:, None]          # (E, 2)

        # effective pose Jacobian over the n_cap window: -Ji at block
        # li, +Jj at block lj (fixed poses masked out)
        li, lj = ii - t0, jj - t0
        vi = (li >= 0) & (li < n_cap) & valid
        vj = (lj >= 0) & (lj < n_cap) & valid
        oh_i = ((li.clamp(0, n_cap - 1)[:, None] == cols)
                & vi[:, None]).float()
        oh_j = ((lj.clamp(0, n_cap - 1)[:, None] == cols)
                & vj[:, None]).float()
        Jeff = (-oh_i[:, None, :, None] * Ji[:, :, None, :]
                + oh_j[:, None, :, None] * Jj[:, :, None, :]
                ).reshape(E, 2, D)
        wJeff = w[:, :, None] * Jeff

        B = wJeff.reshape(-1, D).t() @ Jeff.reshape(-1, D)
        vvec = torch.einsum("era,er->a", wJeff, r)
        A = torch.einsum("er,era->ea", w * Jz, Jeff)         # (E, D)
        Cu_rows = torch.stack([(w * Jz * Jz).sum(1), (w * r * Jz).sum(1)],
                              dim=-1)
        S = agg_cuda.segment_sums(torch.cat([A, Cu_rows], dim=1), gid,
                                  k_cap + 1)[:k_cap]
        Emat = S[:, :D].t()                                  # (D, k_cap)
        C, u = S[:, D], S[:, D + 1]

        Q = 1.0 / (C + lmbda)
        EQ = Emat * Q[None, :]
        S = B - EQ @ Emat.t()
        y = vvec - EQ @ u
        S = S + torch.diag(1e-4 * torch.diagonal(S) + 1.0)

        # on a failed factorisation skip the update (never raise)
        L, info = torch.linalg.cholesky_ex(S)
        dX = torch.cholesky_solve(y[:, None], L)[:, 0]
        ok = (info == 0) & torch.isfinite(dX).all()
        dX = torch.where(ok, dX, torch.zeros_like(dX))
        dZ = Q * (u - Emat.t() @ dX)
        dZ = torch.where(ok, dZ, torch.zeros_like(dZ))

        dxi = torch.where(free, dX.reshape(n_cap, 6)[lp_c],
                          torch.zeros((), device=dev))
        poses = torch.where(free, lie.se3_retr(poses, dxi), poses)

        d_new = patches[kx_c, 2, 0, 0] + dZ
        d_new = torch.where(d_new > 20.0, torch.ones_like(d_new), d_new)
        d_new = d_new.clamp(min=1e-4)
        d_k = d_new[slot_of_k]
        patches[:, 2] = torch.where(hit_k[:, None, None], d_k[:, None, None],
                                    patches[:, 2])
        ctr[:, 2] = torch.where(hit_k, d_k, ctr[:, 2])
    return poses, patches


# ---------------------------------------------------------------------------
# Scalable global BA
# ---------------------------------------------------------------------------

def _seg_sum(data, ids, n):
    """Per-segment sums of the rows of ``data`` by ``ids`` in [0, n]; id n
    is a trash segment, dropped (``jax.ops.segment_sum`` drops ids out of
    range)."""
    out = data.new_zeros((n + 1,) + data.shape[1:])
    return out.index_add_(0, ids, data)[:n]


def _rows_dot(a, J):
    """(E, 2) x (E, 2, 6) -> (E, 6): sum_r a[e, r] J[e, r, :]."""
    return (a[:, :, None] * J).sum(1)


def ba_global(poses, patches, intrinsics, target, weight, lmbda,
              ii, jj, kk, valid, t0, t1, n_cap, k_cap, iterations=2,
              cg_iters=48):
    """Global BA over active + inactive edges: the masks, damping and
    retractions of ``ba_iterative``, with nothing densified over the pose
    window.  The pose-depth coupling stays a per-patch block ``Ei (k_cap,
    6)`` (all edges of a patch share its host frame) plus a per-edge block
    ``Ej (E, 6)``; the damped Schur system is solved by ``cg_iters``
    iterations of block-Jacobi preconditioned conjugate gradients, with
    ``S @ x`` evaluated from per-edge products and segment sums.

    Same arguments as ``ba_iterative`` (t0, t1 host ints); returns
    (poses', patches') without touching the inputs.  Runs with no host
    synchronisation: the step sizes and the finiteness guard are
    ``torch.where``s, the 6x6 inverses ``torch.linalg.inv_ex``."""
    poses = poses.float()
    patches = patches.float().clone()
    target = target.float()
    weight = weight.float()
    fx, fy, cx, cy = intrinsics.float().unbind()
    dev = poses.device
    K = patches.shape[0]
    P = patches.shape[-1]
    ii, jj, kk = ii.long(), jj.long(), kk.long()

    kx, ku = compactify(torch.where(valid, kk, INT_MAX), k_cap)
    k_real = kx != INT_MAX
    # gathers by ku clamp ku == k_cap (an element past the uniques), as
    # JAX's gathers do; the sums drop it into the trash segment
    kuc = ku.clamp(max=k_cap - 1)
    kx_c = kx.long().clamp(0, K - 1)
    # the patches the depth retraction writes; the rest go to slot K
    dst = torch.where(k_real, kx_c, K)
    hit_k = torch.zeros(K + 1, dtype=torch.bool, device=dev).index_fill_(
        0, dst, True)[:K]
    ctr = patches[:, :, P // 2, P // 2].clone()             # (K, 3)

    li, lj = ii - t0, jj - t0
    vi = (li >= 0) & (li < n_cap) & valid
    vj = (lj >= 0) & (lj < n_cap) & valid
    lic, ljc = li.clamp(0, n_cap - 1), lj.clamp(0, n_cap - 1)
    # host-frame pose block of each unique patch (every edge of a patch
    # shares ii = kk // M); an empty segment reads 0, as JAX's clipped
    # segment_max does
    li_k = torch.zeros(k_cap + 1, dtype=torch.int64, device=dev)
    li_k.scatter_reduce_(0, ku, torch.where(valid, lic, 0), "amax",
                         include_self=False)
    li_k = li_k[:k_cap].clamp(0, n_cap - 1)

    pose_slot = torch.arange(poses.shape[0], device=dev)
    lp = pose_slot - t0
    free = ((lp >= 0) & (pose_slot < t1))[:, None]
    lp_c = lp.clamp(0, n_cap - 1)
    eye6 = torch.eye(6, device=dev)

    for _ in range(iterations):
        r, mask, Ji, Jj, Jz = _edge_terms_center(
            poses, ctr, fx, fy, cx, cy, target, ii, jj, kk)
        w = mask[:, None] * weight * valid[:, None]          # (E, 2)
        # signed, visibility-masked pose Jacobians (-Ji at the source)
        Jim = -Ji * vi[:, None, None]
        Jjm = Jj * vj[:, None, None]
        z = w * Jz

        # depth diagonal and rhs per unique patch
        C = _seg_sum((z * Jz).sum(1), ku, k_cap)
        u = _seg_sum((z * r).sum(1), ku, k_cap)
        Q = 1.0 / (C + lmbda)
        # compressed coupling blocks
        Ei = _seg_sum(_rows_dot(z, Jim), ku, k_cap)
        Ej = _rows_dot(z, Jjm)                               # (E, 6)

        # pose rhs and the 6x6 diagonal blocks of S
        wr = w * r
        v_b = (_seg_sum(_rows_dot(wr, Jim), lic, n_cap)
               + _seg_sum(_rows_dot(wr, Jjm), ljc, n_cap))
        bb = (_seg_sum((w[:, :, None, None] * Jim[:, :, :, None]
                        * Jim[:, :, None, :]).sum(1), lic, n_cap)
              + _seg_sum((w[:, :, None, None] * Jjm[:, :, :, None]
                          * Jjm[:, :, None, :]).sum(1), ljc, n_cap))
        ee = (_seg_sum(Q[:, None, None] * Ei[:, :, None] * Ei[:, None, :],
                       li_k, n_cap)
              + _seg_sum(Q[kuc][:, None, None] * Ej[:, :, None]
                         * Ej[:, None, :], ljc, n_cap))
        Sblk = bb - ee
        damp = 1e-4 * torch.diagonal(Sblk, dim1=1, dim2=2) + 1.0
        Minv = torch.linalg.inv_ex(Sblk + torch.diag_embed(damp)
                                   + 1e-8 * eye6)[0]

        def Sx(x):
            """(n_cap, 6) -> (S + damp I) x, matrix-free."""
            xj = x[ljc]
            u1 = ((Jim * x[lic][:, None, :]).sum(-1)
                  + (Jjm * xj[:, None, :]).sum(-1))          # (E, 2)
            wu = w * u1
            bx = (_seg_sum(_rows_dot(wu, Jim), lic, n_cap)
                  + _seg_sum(_rows_dot(wu, Jjm), ljc, n_cap))
            tk = ((Ei * x[li_k]).sum(-1)
                  + _seg_sum((Ej * xj).sum(-1), ku, k_cap))
            yk = Q * tk
            cx_ = (_seg_sum(Ei * yk[:, None], li_k, n_cap)
                   + _seg_sum(Ej * yk[kuc][:, None], ljc, n_cap))
            return bx - cx_ + damp * x

        def precond(v):
            return (Minv * v[:, None, :]).sum(-1)

        # rhs y = v - E Q u, then preconditioned CG from 0
        tu = Q * u
        rr = v_b - (_seg_sum(Ei * tu[:, None], li_k, n_cap)
                    + _seg_sum(Ej * tu[kuc][:, None], ljc, n_cap))
        x = torch.zeros_like(rr)
        zz = precond(rr)
        p = zz
        for _ in range(cg_iters):
            Ap = Sx(p)
            rz = (rr * zz).sum()
            denom = (p * Ap).sum()
            alpha = torch.where(denom.abs() > 1e-12, rz / denom, 0.0)
            x = x + alpha * p
            rr = rr - alpha * Ap
            z2 = precond(rr)
            beta = torch.where(rz.abs() > 1e-12, (rr * z2).sum() / rz, 0.0)
            p = z2 + beta * p
            zz = z2
        ok = torch.isfinite(x).all()
        dX = torch.where(ok, x, 0.0)

        # depth back-substitution dZ = Q (u - E^T dX)
        tk = ((Ei * dX[li_k]).sum(-1)
              + _seg_sum((Ej * dX[ljc]).sum(-1), ku, k_cap))
        dZ = torch.where(ok, Q * (u - tk), 0.0)

        # retractions (as in ba_iterative)
        dxi = torch.where(free, dX[lp_c], 0.0)
        poses = torch.where(free, lie.se3_retr(poses, dxi), poses)
        d_old = patches[kx_c, 2, 0, 0]
        d_new = d_old + dZ
        d_new = torch.where(d_new > 20.0, 1.0, d_new).clamp(min=1e-4)
        d_k = patches.new_zeros(K + 1)
        d_k[dst] = torch.where(k_real, d_new, d_old)
        patches[:, 2] = torch.where(hit_k[:, None, None], d_k[:K, None, None],
                                    patches[:, 2])
        ctr[:, 2] = torch.where(hit_k, d_k[:K], ctr[:, 2])
    return poses, patches


# ---------------------------------------------------------------------------
# Differentiable training BA
# ---------------------------------------------------------------------------

def _seg_sum(vals, seg, n):
    """Row sums of ``vals`` by segment ``seg`` in [0, n]; slot ``n`` (rows
    that do not count) is dropped.  ``index_add``: differentiable."""
    out = vals.new_zeros((n + 1,) + vals.shape[1:]).index_add(0, seg, vals)
    return out[:n]


def ba_differentiable(poses, patches, intrinsics, targets, weights, lmbda,
                      ii, jj, kk, valid, bounds, ep=10.0, fixedp=1,
                      structure_only=False, k_cap=None):
    """One damped GN step with a Schur complement, differentiable in every
    float input: bounds-based masks, damping ``S += diag(ep + 1e-4 S)``, a
    Cholesky solve whose failure (a non-finite ``dX``) zeroes the pose and
    depth updates (``cholesky_ex`` and ``torch.where``: no host sync), and
    the [1e-3, 10] depth clamp.

    poses (N, 7), patches (K, 3, P, P), intrinsics (N, 4) per frame;
    targets, weights (E, 2); ii, jj, kk (E,) int; valid (E,) bool; bounds
    [x0, y0, x1, y1].  The first ``fixedp`` poses stay fixed; ``k_cap``
    bounds the unique patches (default E).  -> (poses', patches').
    """
    N = poses.shape[0]
    E = ii.shape[0]
    k_cap = E if k_cap is None else k_cap
    poses, patches = poses.float(), patches.float()
    targets, weights = targets.float(), weights.float()
    ii, jj, kk = ii.long(), jj.long(), kk.long()
    dev = poses.device

    coords, v, (Ji, Jj, Jz) = pops.transform(
        poses, patches, intrinsics, ii, jj, kk, jacobian=True)
    c = coords.shape[1] // 2
    ctr = coords[:, c, c]
    r = targets - ctr
    in_bounds = ((ctr[:, 0] > bounds[0]) & (ctr[:, 1] > bounds[1])
                 & (ctr[:, 0] < bounds[2]) & (ctr[:, 1] < bounds[3]))
    v = v * ((torch.linalg.norm(r, dim=-1) < 250) & in_bounds & valid)
    r = v[:, None] * r
    w = v[:, None] * weights

    n = N - fixedp
    kx, ku = compactify(torch.where(valid, kk, INT_MAX), k_cap)
    k_real = kx != INT_MAX
    # depth segments of the edges that count; the rest sum into slot k_cap
    seg = torch.where(v > 0, ku, k_cap)
    Jz2 = Jz[:, :, 0]                                        # (E, 2)
    C = _seg_sum((w * Jz2 * Jz2).sum(1), seg, k_cap)
    u = _seg_sum((w * r * Jz2).sum(1), seg, k_cap)
    Q = 1.0 / (C + lmbda)

    if structure_only or n == 0:
        dZ = Q * u
        dX = None
    else:
        # J_eff: Ji at block ii - fixedp, Jj at block jj - fixedp (Ji
        # carries the adjoint's sign), fixed poses masked out
        cols = torch.arange(n, device=dev)
        li, lj = ii - fixedp, jj - fixedp
        oh_i = ((li.clamp(0, n - 1)[:, None] == cols)
                & ((li >= 0) & (li < n))[:, None]).float()
        oh_j = ((lj.clamp(0, n - 1)[:, None] == cols)
                & ((lj >= 0) & (lj < n))[:, None]).float()
        Jeff = (oh_i[:, None, :, None] * Ji[:, :, None, :]
                + oh_j[:, None, :, None] * Jj[:, :, None, :]
                ).reshape(E, 2, 6 * n)
        wJeff = w[:, :, None] * Jeff
        Bm = wJeff.reshape(-1, 6 * n).t() @ Jeff.reshape(-1, 6 * n)
        vv = torch.einsum("era,er->a", wJeff, r)
        A = torch.einsum("er,era->ea", w * Jz2, Jeff)        # (E, 6n)
        Ef = _seg_sum(A, seg, k_cap).t()                     # (6n, k_cap)

        EQ = Ef * Q[None, :]
        S = Bm - EQ @ Ef.t()
        y = vv - EQ @ u
        S = S + torch.diag(ep + 1e-4 * torch.diagonal(S))
        L, info = torch.linalg.cholesky_ex(S)
        dX = torch.cholesky_solve(y[:, None], L)[:, 0]
        ok = (info == 0) & torch.isfinite(dX).all()
        dX = torch.where(ok, dX, 0.0)
        dZ = torch.where(ok, Q * (u - Ef.t() @ dX), 0.0)

    K = patches.shape[0]
    dZ_full = torch.zeros(K, device=dev).index_add(
        0, kx.clamp(0, K - 1), torch.where(k_real, dZ, 0.0))
    disps = (patches[:, 2] + dZ_full[:, None, None]).clamp(1e-3, 10.0)
    patches = torch.stack([patches[:, 0], patches[:, 1], disps], dim=1)

    if dX is not None:
        dxi = torch.cat([torch.zeros((fixedp, 6), device=dev),
                         dX.reshape(n, 6)])
        poses = lie.se3_retr(poses, dxi)
    return poses, patches
