"""Training rollout: the VONet recurrent unroll (PyTorch).

Counterpart of ``dpvo_tpu/training/rollout.py``: ``steps`` iterations of
[reproject -> correlate -> update -> 2x differentiable BA], with frames
introduced one per step from step 8 on and random frame-edge dropout
(p=0.1).  The edge schedule is precomputed on the host (``build_schedule``,
the same numpy draws as the JAX package), with every edge in a fixed slot
for the whole rollout: per-step ``active``/``fresh`` masks replace edge-list
growth.  Each step is a ``torch.utils.checkpoint`` region (the JAX
package's ``jax.checkpoint`` per scan step), so the backward keeps one
step's activations at a time.  Poses and patches are detached at the start
of every step; the hidden state carries gradients through all of them.
The geometry (``transform``, the correlation, BA, the losses) runs in fp32
outside autocast; with ``amp`` the update operator runs under bf16
autocast.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.utils import checkpoint as torch_checkpoint

from ..models.update import DIM
from ..ops import ba, corr as corr_ops, lie, projective as pops


class Schedule(NamedTuple):
    """Host-precomputed rollout schedule (fixed edge slots)."""
    ii: np.ndarray        # (E,) source frame
    jj: np.ndarray        # (E,) target frame
    kk: np.ndarray        # (E,) patch index
    active: np.ndarray    # (S, E) bool
    fresh: np.ndarray     # (S, E) bool: hidden state reset at this step
    intro: np.ndarray     # (S,) int: frame introduced at the step, or -1


def build_schedule(n_frames, M, steps, rng: np.random.Generator,
                   dropout_p=0.1):
    """The reference's edge growth, step by step, as fixed slots."""
    edges = []    # (ii, jj, kk, birth_step)
    dead = {}     # slot -> death step

    def add(kk_arr, jj_arr, step):
        for kkv, jjv in zip(kk_arr, jj_arr):
            edges.append((kkv // M, jjv, kkv, step))

    # initial: patches of frames < 8 into frames 0..7, clamped for short
    # clips
    init = min(8, n_frames)
    kk0 = np.arange(init * M)
    add(np.repeat(kk0, init), np.tile(np.arange(init), init * M), 0)

    n = init
    for s in range(steps):
        if s >= 8 and n < n_frames:
            kk1 = np.arange(n * M)                      # patches < n -> n
            add(kk1, np.full(n * M, n), s)
            kk2 = np.arange(n * M, (n + 1) * M)         # patches of n -> 0..n
            add(np.repeat(kk2, n + 1), np.tile(np.arange(n + 1), M), s)
            if rng.random() < dropout_p:
                f = n - 4
                for slot, (ei, ej, ek, b) in enumerate(edges):
                    if (ei == f or ej == f) and slot not in dead and b <= s:
                        dead[slot] = s
            n += 1

    E = len(edges)
    ii = np.array([e[0] for e in edges], np.int32)
    jj = np.array([e[1] for e in edges], np.int32)
    kk = np.array([e[2] for e in edges], np.int32)
    birth = np.array([e[3] for e in edges], np.int32)

    active = np.zeros((steps, E), bool)
    fresh = np.zeros((steps, E), bool)
    intro = np.full((steps,), -1, np.int32)
    nn = init
    for s in range(steps):
        if s >= 8 and nn < n_frames:
            intro[s] = nn
            nn += 1
        alive = birth <= s
        for slot, dstep in dead.items():
            if s >= dstep:
                alive[slot] = False
        active[s] = alive
        fresh[s] = birth == s
    return Schedule(ii, jj, kk, active, fresh, intro)


def pad_schedule(sch: Schedule, e_cap: int) -> Schedule:
    """Pad to ``e_cap`` edge slots that are never active: the static edge
    count the JAX package's compiled step needs.  The port's eager step
    takes a schedule as built, so nothing in the port calls this; it reads
    a batch that ``train.py`` padded."""
    E = len(sch.ii)
    if E > e_cap:
        raise ValueError(f"schedule has {E} edges, more than e_cap {e_cap}")
    pad = e_cap - E
    zi = np.zeros(pad, np.int32)
    zm = np.zeros((sch.active.shape[0], pad), bool)
    return Schedule(np.concatenate([sch.ii, zi]),
                    np.concatenate([sch.jj, zi]),
                    np.concatenate([sch.kk, zi]),
                    np.concatenate([sch.active, zm], axis=1),
                    np.concatenate([sch.fresh, zm], axis=1), sch.intro)


def vonet_rollout(update_mod, imap, gmap, fmap_pyr1, fmap_pyr4,
                  patches_init, patches_gt, poses_gt, intrinsics,
                  sch_ii, sch_jj, sch_kk, sch_active, sch_fresh, sch_intro,
                  structure_only, steps, M, amp=False):
    """The unrolled training forward.

    update_mod  the ``Update`` module
    imap (K, DIM); gmap (K, P, P, 128)
    fmap_pyr1/4 (N, h, w, 128) / (N, h/4, w/4, 128)
    patches_init (K, 3, P, P), random depth already set
    patches_gt   (K, 3, P, P); poses_gt (N, 7) inverse (world-from-cam)
    intrinsics   (N, 4) at feature resolution
    sch_*        the schedule's arrays (numpy or tensors); ``sch_intro`` is
                 read on the host
    Returns a dict: flow_err (S,), px1 (S,), poses (S, N, 7).
    """
    dev = poses_gt.device
    ii, jj, kk = (torch.as_tensor(a, device=dev).long()
                  for a in (sch_ii, sch_jj, sch_kk))
    active = torch.as_tensor(sch_active, device=dev)
    fresh = torch.as_tensor(sch_fresh, device=dev)
    intro = (sch_intro.cpu().numpy() if torch.is_tensor(sch_intro)
             else np.asarray(sch_intro))
    N = poses_gt.shape[0]
    K = patches_init.shape[0]
    E = ii.shape[0]
    P = patches_init.shape[-1]
    c = P // 2
    h, w = fmap_pyr1.shape[1:3]
    bounds = (-64.0, -64.0, w + 64.0, h + 64.0)
    dij = (ii - jj).abs()

    # GT coords and centre validity, fixed across steps
    coords_gt, valid_gt, _ = pops.transform(
        poses_gt, patches_gt, intrinsics, ii, jj, kk, jacobian=True)
    vg = valid_gt > 0.5

    def step(Gs, patches, net, s):
        Gs, patches = Gs.detach(), patches.detach()
        fr = int(intro[s])
        if fr >= 0:                  # frame introduction
            if not structure_only:
                Gs = torch.cat([Gs[:fr], Gs[max(fr - 1, 0)][None],
                                Gs[fr + 1:]])
            # median depth of the two previous frames' patches (NaN-free:
            # linear interpolation, the mean of the two middle values)
            src = patches[max(fr - 2, 0) * M:fr * M, 2].reshape(-1)
            dmed = (torch.nan_to_num(torch.nanquantile(src, 0.5), nan=1.0)
                    if src.numel() else torch.ones((), device=dev))
            d = patches[:, 2].clone()
            d[fr * M:(fr + 1) * M] = dmed
            patches = torch.stack([patches[:, 0], patches[:, 1], d], dim=1)

        net = torch.where(fresh[s][:, None], 0.0, net)
        coords = pops.transform(Gs, patches, intrinsics, ii, jj, kk)
        coords2 = coords.permute(0, 3, 1, 2)
        c1 = corr_ops.corr(gmap, fmap_pyr1, coords2, kk, jj, 3)
        c2 = corr_ops.corr(gmap, fmap_pyr4, coords2 / 4.0, kk, jj, 3)
        corr_feat = torch.stack([c1, c2], dim=-1).reshape(E, -1)
        ctx = imap[kk].float()
        with torch.autocast(dev.type, dtype=torch.bfloat16, enabled=amp):
            net, delta, weight = update_mod(net, ctx, corr_feat, ii, jj, kk,
                                            active[s])
        net = net.float()
        target = coords[:, c, c] + delta
        for _ in range(2):
            Gs, patches = ba.ba_differentiable(
                Gs, patches, intrinsics, target, weight, 1e-4, ii, jj, kk,
                active[s], bounds, ep=10.0, fixedp=1,
                structure_only=structure_only, k_cap=K)

        # per-step loss pieces: the min over each edge's patch pixels of
        # the reprojection error, over edges 1-2 frames apart whose GT
        # centre is valid; eps-safe norm (exact zeros of self-pair edges
        # would give NaN gradients)
        diff = pops.transform(Gs, patches, intrinsics, ii, jj, kk) - coords_gt
        e_min = torch.sqrt((diff * diff).sum(-1) + 1e-12).reshape(
            E, P * P).min(dim=-1).values
        row = active[s] & (dij > 0) & (dij <= 2) & vg
        cnt = row.sum().clamp(min=1)
        flow_err = torch.where(row, e_min, 0.0).sum() / cnt
        px1 = torch.where(row & (e_min < 0.25), 1.0, 0.0).sum() / cnt
        return Gs, patches, net, flow_err, px1

    Gs = (poses_gt.float() if structure_only
          else lie.se3_identity(N, device=dev))
    patches = patches_init.float()
    net = torch.zeros((E, DIM), device=dev)
    flow_err, px1, poses = [], [], []
    for s in range(steps):
        if torch.is_grad_enabled():
            out = torch_checkpoint.checkpoint(step, Gs, patches, net, s,
                                              use_reentrant=False)
        else:
            out = step(Gs, patches, net, s)
        Gs, patches, net = out[:3]
        flow_err.append(out[3])
        px1.append(out[4])
        poses.append(Gs)
    return {"flow_err": torch.stack(flow_err), "px1": torch.stack(px1),
            "poses": torch.stack(poses)}


def pose_loss_terms(poses_steps, poses_gt):
    """Umeyama-scaled relative pose errors per step.

    poses_steps (S, N, 7) estimated inverse poses; poses_gt (N, 7).
    Returns (tr (S,), ro (S,), fracs): fracs holds the threshold metrics
    r1/r2/t1/t2 per step (the fraction of pose pairs with rotation error
    below 1e-3 / 1e-2 and translation error below 1e-3 / 1e-2).
    """
    S, N = poses_steps.shape[:2]
    dev = poses_steps.device
    ii, jj = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
    k = (ii != jj).reshape(-1)
    ii = torch.as_tensor(ii.reshape(-1)[k], device=dev)
    jj = torch.as_tensor(jj.reshape(-1)[k], device=dev)

    P2 = lie.se3_inv(poses_gt)          # camera-from-world ("true" poses)
    P1 = lie.se3_inv(poses_steps)       # (S, N, 7)
    with torch.no_grad():
        s = torch.stack([kabsch_umeyama(P2[:, :3], P1[i, :, :3])
                         for i in range(S)]).clamp(max=10.0)
    P1s = lie.se3_scale(P1, s[:, None].expand(S, N))
    dP = lie.se3_mul(lie.se3_inv(P1s[:, ii]), P1s[:, jj])
    dG = lie.se3_mul(lie.se3_inv(P2[ii]), P2[jj]).expand(dP.shape)
    e1 = lie.se3_log(lie.se3_mul(dP, lie.se3_inv(dG)))
    # eps-safe norms (exact zeros at identical poses NaN the backward)
    trp = torch.sqrt((e1[..., 0:3] ** 2).sum(-1) + 1e-12)
    rop = torch.sqrt((e1[..., 3:6] ** 2).sum(-1) + 1e-12)
    fr = {"r1": (rop < 1e-3).float().mean(-1),
          "r2": (rop < 1e-2).float().mean(-1),
          "t1": (trp < 1e-3).float().mean(-1),
          "t2": (trp < 1e-2).float().mean(-1)}
    return trp.mean(-1), rop.mean(-1), fr


def kabsch_umeyama(A, B):
    """Scale-only trajectory alignment of B onto A (N, 3), fp32."""
    A, B = A.float(), B.float()
    n = A.shape[0]
    Ac, Bc = A - A.mean(0), B - B.mean(0)
    var_a = (Ac ** 2).sum(-1).mean()
    H = Ac.t() @ Bc / n
    D = torch.linalg.svdvals(H)
    return var_a / D.sum().clamp(min=1e-8)
