"""Sim3 pose-graph optimisation (the classic loop-closure backend).

Counterpart of ``dpvo_tpu/loop_closure/pgo.py``.  Variables are per-pose
Sim3 tangent vectors of the inverse poses; constraints are the
consecutive-pose odometry factors plus Sim3 loop factors.  Each edge's 7x7
Jacobians come from one ``torch.func.vmap(jacfwd(...))`` over the residual
``log(C * exp(gi) * exp(gj)^-1)``; the damped normal equations are solved
matrix-free by conjugate gradients with a block-Jacobi preconditioner,
stopped as ``jax.scipy.sparse.linalg.cg`` stops (a mask, no host
synchronisation); the Levenberg-Marquardt accept/reject loop runs on the
host.  The pose count is padded to a power of two (at least 64) with
identity poses, as the JAX package pads it: the padding adds a chain with
zero residuals, which changes nothing in exact arithmetic, but 100 CG
steps do not converge on a long chain, so the step they give depends on
the system's size (0.02 on a 300-pose loop without the padding, 4.6e-4
with it, against the JAX package's own 2.5e-4 spread when its inputs move
by 1e-6).
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ..device import resolve_device
from ..ops import lie

CG_ITERS = 100
CG_TOL = 1e-8


def _solve3(W, t):
    """W^-1 t for (..., 3, 3) W by Cramer's rule: ``torch.linalg.solve``'s
    forward-mode derivative is wrong under ``vmap`` (it mixes up the
    batched and unbatched operands), so the residual's log solves with
    products and sums alone."""
    c0, c1, c2 = W.unbind(-1)
    det = (c0 * torch.linalg.cross(c1, c2)).sum(-1, keepdim=True)
    return torch.stack([(t * torch.linalg.cross(c1, c2)).sum(-1),
                        (c0 * torch.linalg.cross(t, c2)).sum(-1),
                        (c0 * torch.linalg.cross(c1, t)).sum(-1)],
                       -1) / det


def _sim3_log(g):
    """``lie.sim3_log`` with the 3x3 solve by ``_solve3``."""
    phi = lie.so3_log(g[..., 3:7])
    sigma = torch.log(g[..., 7:8].clamp(min=lie._EPS))
    tau = _solve3(lie._sim3_calcW(phi, sigma), g[..., :3])
    return torch.cat([tau, phi, sigma], dim=-1)


def _edge_residual(C, gi, gj):
    """r = log(C * exp(gi) * exp(gj)^-1), for one edge or broadcast."""
    return _sim3_log(
        lie.sim3_mul(C, lie.sim3_mul(lie.sim3_exp(gi),
                                     lie.sim3_inv(lie.sim3_exp(gj)))))


_edge_jacobians = vmap(jacfwd(_edge_residual, argnums=(1, 2)))


def residuals(Ginv, constants, iii, jjj):
    """(r, 7) residuals of every edge."""
    return _edge_residual(constants, Ginv[iii], Ginv[jjj])


def residuals_and_jac(Ginv, constants, iii, jjj):
    """Residuals (r, 7) and their Jacobians (r, 7, 7) by gi and by gj."""
    gi, gj = Ginv[iii], Ginv[jjj]
    Ji, Jj = _edge_jacobians(constants, gi, gj)
    return _edge_residual(constants, gi, gj), Ji, Jj


def _vdot(a, b):
    return (a * b).sum()


def gn_step(r, Ji, Jj, iii, jjj, n, damp, cg_iters=CG_ITERS, tol=CG_TOL):
    """Solve (J^T J + damp I) dx = -J^T r matrix-free by block-Jacobi
    preconditioned CG -> dx (n, 7).  CG stops, per ``jax.scipy``'s rule,
    once |residual|^2 <= tol^2 |b|^2 or after ``cg_iters`` steps; a step
    after the stop leaves the state as it was."""
    def seg(x, idx):
        return torch.zeros((n,) + x.shape[1:], dtype=x.dtype,
                           device=x.device).index_add_(0, idx, x)

    def A(x):
        y = (torch.einsum("eab,eb->ea", Ji, x[iii])
             + torch.einsum("eab,eb->ea", Jj, x[jjj]))
        return (seg(torch.einsum("eab,ea->eb", Ji, y), iii)
                + seg(torch.einsum("eab,ea->eb", Jj, y), jjj) + damp * x)

    b = -(seg(torch.einsum("eab,ea->eb", Ji, r), iii)
          + seg(torch.einsum("eab,ea->eb", Jj, r), jjj))
    eye = torch.eye(7, dtype=r.dtype, device=r.device)
    D = (seg(torch.einsum("eab,eac->ebc", Ji, Ji), iii)
         + seg(torch.einsum("eab,eac->ebc", Jj, Jj), jjj) + damp * eye)
    Dinv = torch.linalg.inv(D + 1e-8 * eye)

    def M(x):
        return torch.einsum("nab,nb->na", Dinv, x)

    atol2 = tol * tol * _vdot(b, b)
    x = torch.zeros_like(b)
    res = b                                     # b - A(0)
    z = M(res)
    p, gamma = z, _vdot(res, z)
    for _ in range(cg_iters):
        go = _vdot(res, res) > atol2
        Ap = A(p)
        alpha = gamma / _vdot(p, Ap)
        x_new = x + alpha * p
        res_new = res - alpha * Ap
        z = M(res_new)
        gamma_new = _vdot(res_new, z)
        p_new = z + (gamma_new / gamma) * p
        x = torch.where(go, x_new, x)
        res = torch.where(go, res_new, res)
        p = torch.where(go, p_new, p)
        gamma = torch.where(go, gamma_new, gamma)
    return x


def perform_updates(poses_se3, dSloop, ii_loop, jj_loop, iters=30, ep=0.0,
                    lmbda=1e-6, device="cuda"):
    """Levenberg-Marquardt over the pose graph on ``device`` (the card
    unless the caller names the CPU).

    poses_se3 (n, 7); dSloop (L, 8) Sim3 loop constraints; ii_loop,
    jj_loop (L,).  Returns the corrected Sim3 poses (n, 8) on ``device``
    (exp(Ginv)^-1)."""
    dev = resolve_device(device)
    poses = np.asarray(poses_se3, np.float32)
    n_real = len(poses)
    pad = np.zeros(((1 << max(n_real - 1, 63).bit_length()) - n_real, 7),
                   np.float32)
    pad[:, 6] = 1.0
    poses = torch.as_tensor(np.concatenate([poses, pad]), device=dev)
    n = poses.shape[0]
    pred_inv = lie.sim3_inv(lie.se3_to_sim3(poses))
    Ginv = lie.sim3_log(pred_inv)

    # odometry constants: dSij = Tj * Ti^-1 for consecutive (k, k-1)
    kk = torch.arange(1, n, device=dev)
    ll = kk - 1
    dSij = lie.sim3_mul(pred_inv[ll], lie.sim3_inv(pred_inv[kk]))
    constants = torch.cat([dSij, torch.tensor(
        np.asarray(dSloop, np.float32), device=dev)])
    iii = torch.cat([kk, torch.as_tensor(np.asarray(ii_loop, np.int64),
                                         device=dev)])
    jjj = torch.cat([ll, torch.as_tensor(np.asarray(jj_loop, np.int64),
                                         device=dev)])

    history = []
    for itr in range(iters):
        r, Ji, Jj = residuals_and_jac(Ginv, constants, iii, jjj)
        history.append(float((r ** 2).mean()))
        damp = float(np.float32(lmbda) + np.float32(ep))
        Ginv_tmp = Ginv + gn_step(r, Ji, Jj, iii, jjj, n, damp)
        new_r = residuals(Ginv_tmp, constants, iii, jjj)
        if float((new_r ** 2).mean()) < history[-1]:
            Ginv = Ginv_tmp
            lmbda /= 2
        else:
            lmbda *= 2
        if (history[-1] < 1e-5 and itr >= 4
                and history[-5] / max(history[-1], 1e-12) < 1.5):
            break
    return lie.sim3_inv(lie.sim3_exp(Ginv))[:n_real]


def run_pgo(pred_poses, dSloop, loop_ii, loop_jj, iters=30, device="cuda"):
    """Optimise, gauge-fix to the first pose after the loop region, and
    return the Sim3 poses (safe_i, 8) up to it as numpy (the process
    pool's task: numpy in, numpy out)."""
    final = perform_updates(pred_poses, dSloop, loop_ii, loop_jj, iters,
                            device=device)
    safe_i = int(np.max(loop_ii)) + 1
    # when the loop's newer end is the newest pose there is no pose after
    # it: the JAX package's gather clamps final[safe_i] to the last row,
    # and so does this, explicitly
    g = min(safe_i, final.shape[0] - 1)
    orig = lie.se3_to_sim3(torch.as_tensor(
        np.asarray(pred_poses, np.float32), device=final.device))
    fix = lie.sim3_mul(orig[g], lie.sim3_inv(final[g]))
    final = lie.sim3_mul(fix[None], final)
    return final[:safe_i].cpu().numpy()
