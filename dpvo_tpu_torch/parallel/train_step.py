"""The training step (PyTorch), on one device or data-parallel.

Counterpart of ``dpvo_tpu/parallel/train_step.py``: encoders, patch
extraction, the recurrent rollout with differentiable BA, the loss, its
gradient and the optimizer update, for a batch whose samples run one after
another (the JAX package's ``vmap``: the loss is the mean of the per-sample
losses; each sample's backward accumulates into the gradients).

Data-parallel (``group``, a ``torch.distributed`` process group, one rank
per device; the JAX package's mesh with the batch sharded over ``dp``):
each rank runs its rows of the global batch, each sample's backward adds
``grad / B_global``, one ``all_reduce(SUM)`` of the flattened gradients
then gives every rank the global mean, which the global-norm clip and the
AdamW update read, so every rank applies the same update.  The metrics are
reduced to their global means the same way.  No DDP wrapper: one explicit
reduction after the per-sample backwards.

The optimizer is ``optax.chain(clip_by_global_norm(clip), adamw(schedule,
weight_decay))`` with optax's defaults (``ClippedAdamW``): the clip scales
by ``clip / |g|`` only when ``|g| >= clip`` (not ``clip_grad_norm_``'s
``|g| + 1e-6``), then ``torch.optim.AdamW``, whose decoupled step
``p (1 - lr wd) - lr m_hat / (sqrt(v_hat) + eps)`` is optax's update, runs
at the schedule's value for the update's index (0 for the first).  The schedules are explicit functions of the step
with optax's values.  ``amp`` runs the encoders and the update operator
under bf16 autocast over fp32 weights (flax's ``dtype=bf16`` with fp32
params); the geometry stays fp32.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..models.update import Update
from ..models.vonet import Patchifier
from ..ops import corr as corr_ops
from ..training import rollout as R


# --- schedules ---------------------------------------------------------------

def onecycle_schedule(steps, peak, pct_start=0.01, pct_final=1.0,
                      div_factor=25.0, final_div_factor=1e4):
    """``optax.linear_onecycle_schedule``: linear from peak / div_factor up
    to the peak at ``int(pct_start * steps)``, down to peak / div_factor at
    ``int(pct_final * steps)``, then to the final value at ``steps`` (with
    ``pct_final`` 1.0 the later boundary replaces the middle one, so the
    ramp runs from the peak straight to peak / div / final_div)."""
    scales = {int(pct_start * steps): div_factor,
              int(pct_final * steps): 1.0 / div_factor,
              steps: 1.0 / final_div_factor}
    bounds, mult = zip(*sorted(scales.items()))
    bounds = np.array((0,) + bounds, np.float64)
    values = np.cumprod((peak / div_factor,) + mult)

    def schedule(count):
        if count >= bounds[-1]:
            return float(values[-1])
        i = int(np.searchsorted(bounds, count, side="right")) - 1
        pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
        return float(values[i] + pct * (values[i + 1] - values[i]))

    return schedule


def cosine_schedule(steps, init, alpha):
    """``optax.cosine_decay_schedule``."""
    def schedule(count):
        c = min(count, steps)
        return init * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / steps))
                       + alpha)
    return schedule


def step_schedule(init, boundaries_and_scales):
    """``optax.piecewise_constant_schedule``: the value is multiplied by
    each boundary's scale from that step on."""
    items = sorted(boundaries_and_scales.items())

    def schedule(count):
        v = init
        for b, s in items:
            if count >= b:
                v *= s
        return v

    return schedule


def make_schedule(lr, steps, scheduler="onecycle", pct_start=0.01):
    if scheduler == "onecycle":
        return onecycle_schedule(steps, lr, pct_start=pct_start)
    if scheduler == "cosine":
        return cosine_schedule(steps, lr, alpha=1e-7 / lr)
    if scheduler == "step":
        return step_schedule(lr, {steps // 3: 0.1, 2 * steps // 3: 0.1})
    if scheduler == "constant":
        return lambda count: lr
    raise ValueError(f"Unknown scheduler type: {scheduler}")


# --- optimizer ---------------------------------------------------------------

class ClippedAdamW:
    """Global-norm clip, then ``torch.optim.AdamW`` (fused) at the
    schedule's rate for the update's index, over a fixed list of
    parameters; no step reads a value back to the host.  A parameter with
    no gradient steps on a zero one, as optax's would (its moments decay
    and the weight decay applies)."""

    def __init__(self, params, schedule, weight_decay=1e-6, clip=10.0):
        self.params = list(params)
        self.schedule = schedule
        self.clip = clip
        self.opt = torch.optim.AdamW(self.params, lr=schedule(0),
                                     betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=weight_decay, fused=True)
        self.count = 0

    def zero_grad(self):
        self.opt.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self):
        """One update from the parameters' ``.grad``; returns the
        gradients' global norm before the clip (a tensor)."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        gnorm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g.float()) for g in grads]))
        scale = torch.where(gnorm < self.clip, 1.0, self.clip / gnorm)
        for g in grads:
            g.mul_(scale)
        self.opt.param_groups[0]["lr"] = self.schedule(self.count)
        self.opt.step()
        self.count += 1
        return gnorm

    def state_dict(self):
        """The moments in parameter order and the update count."""
        st = [self.opt.state.get(p, {}) for p in self.params]
        return {"mu": [s.get("exp_avg", torch.zeros_like(p))
                       for s, p in zip(st, self.params)],
                "nu": [s.get("exp_avg_sq", torch.zeros_like(p))
                       for s, p in zip(st, self.params)],
                "count": self.count}

    def load_state_dict(self, sd):
        self.count = int(sd["count"])
        group = dict(self.opt.param_groups[0],
                     params=list(range(len(self.params))))
        self.opt.load_state_dict({"param_groups": [group], "state": {
            i: {"step": torch.tensor(float(self.count)), "exp_avg": mu,
                "exp_avg_sq": nu}
            for i, (mu, nu) in enumerate(zip(sd["mu"], sd["nu"]))}})


def make_optimizer(params, lr, steps, weight_decay=1e-6, clip=10.0,
                   scheduler="onecycle", pct_start=0.01):
    """AdamW + scheduler + global-norm clip over ``params``."""
    return ClippedAdamW(params, make_schedule(lr, steps, scheduler,
                                              pct_start),
                        weight_decay=weight_decay, clip=clip)


@dataclass
class TrainState:
    patchifier: Patchifier
    update: Update
    opt: ClippedAdamW
    step: int = 0

    def modules(self):
        return {"patchify": self.patchifier, "update": self.update}


def train_params(patchifier, update_mod):
    """The trained parameters in a fixed order: the patchifier's, then the
    update operator's."""
    return list(patchifier.parameters()) + list(update_mod.parameters())


# --- the step ----------------------------------------------------------------

def _rollout_schedule(batch, dev):
    """The batch's ``sch_*`` arrays by name, on the device but for
    ``intro``, which the rollout reads on the host."""
    return {k[4:]: (v if k == "sch_intro" else torch.as_tensor(v, device=dev))
            for k, v in batch.items() if k.startswith("sch_")}


def _sample_rollout(patchifier, update_mod, batch, b, sch, steps, M,
                    structure_only, amp):
    """One sample's encoders and rollout (``sample_loss`` of the JAX
    package up to the loss)."""
    dev = batch["images"].device
    with torch.autocast(dev.type, dtype=torch.bfloat16, enabled=amp):
        fmap, gmap, imap, patches_gt, _, _ = patchifier(
            batch["images"][b], batch["coords"][b], disps=batch["disps"][b])
    fmap4 = corr_ops.avg_pool2d(fmap, 4)
    n, m, c, P = patches_gt.shape[:4]
    K = n * m
    patches_gt = patches_gt.reshape(K, c, P, P)
    gmap = gmap.reshape(K, P, P, -1)
    imap = imap.reshape(K, -1)
    depth = batch["depth_init"][b][:, None, None].expand(K, P, P)
    patches_init = torch.stack([patches_gt[:, 0], patches_gt[:, 1], depth],
                               dim=1)
    poses = batch["poses"][b]
    out = R.vonet_rollout(
        update_mod, imap, gmap, fmap, fmap4, patches_init, patches_gt, poses,
        batch["intrinsics"][b], sch["ii"], sch["jj"], sch["kk"],
        sch["active"], sch["fresh"], sch["intro"],
        structure_only=structure_only, steps=steps, M=M, amp=amp)
    tr, ro, fr = R.pose_loss_terms(out["poses"], poses)
    return out, tr, ro, fr


def _all_reduce_grads(params, group):
    """Sum the parameters' gradients over the ranks in one flattened
    buffer (a parameter without a gradient contributes zeros)."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    for p, g in zip(params, flat.split([g.numel() for g in grads])):
        p.grad = g.view_as(p)


def make_train_step(steps=18, M=80, structure_only=False, flow_weight=0.1,
                    pose_weight=10.0, amp=False, group=None):
    """Returns train_step(state, batch) -> (state, metrics), which trains
    the state's modules.

    batch: tensors on the training device with a leading batch axis,
      images (B, N, H, W, 3) normalised, poses (B, N, 7) inverse GT poses,
      disps (B, N, h, w), intrinsics (B, N, 4) at feature resolution,
      coords (B, N, M, 2), depth_init (B, N*M); and the schedule shared by
      the batch, sch_ii/jj/kk (E,), sch_active/fresh (S, E), sch_intro (S,)
      (numpy or tensors; ``sch_intro`` is read on the host).
    The state's modules and optimizer are updated in place; metrics are
    0-d tensors on the device: the batch means of flow_err, px1, tr, ro,
    r1, r2, t1, t2 and kl at the last rollout step, the loss, and gnorm
    (the global gradient norm before the clip).  With ``group`` the batch
    holds this rank's rows of the global batch (``mesh.shard_batch``),
    every rank holds the same state, and the gradients and metrics are the
    global batch's.
    """
    world = 1 if group is None else dist.get_world_size(group)

    def train_step(state: TrainState, batch):
        dev = batch["images"].device
        B_local = batch["images"].shape[0]
        B = B_local * world
        sch = _rollout_schedule(batch, dev)
        state.opt.zero_grad()
        totals = {}
        for b in range(B_local):
            out, tr, ro, fr = _sample_rollout(
                state.patchifier, state.update, batch, b, sch, steps, M,
                structure_only, amp)
            S = out["flow_err"].shape[0]
            loss = flow_weight * out["flow_err"].sum()
            if not structure_only:
                pose_mask = (torch.arange(S, device=dev) >= 2).float()
                loss = loss + pose_weight * ((tr + ro) * pose_mask).sum()
            (loss / B).backward()
            sample = {"flow_err": out["flow_err"][-1], "px1": out["px1"][-1],
                      "tr": tr[-1], "ro": ro[-1],
                      **{k: fr[k][-1] for k in ("r1", "r2", "t1", "t2")},
                      "kl": torch.zeros((), device=dev), "loss": loss}
            for k, v in sample.items():
                totals[k] = totals.get(k, 0.0) + v.detach() / B
        if group is not None:
            _all_reduce_grads(state.opt.params, group)
            keys = list(totals)
            flat = torch.stack([totals[k] for k in keys])
            dist.all_reduce(flat, group=group)
            totals = dict(zip(keys, flat.unbind()))
        gnorm = state.opt.step()
        state.step += 1
        return state, dict(totals, gnorm=gnorm)

    return train_step


def make_eval_step(steps=18, M=80, amp=False):
    """Forward-only validation rollout: encoders, the full rollout and BA,
    no optimizer update.  Returns eval_step(state, batch) -> (est_poses (B,
    S, N, 7) inverse poses per rollout step, metrics: batch means of
    flow_err, px1, tr and ro at the last step)."""
    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        dev = batch["images"].device
        B = batch["images"].shape[0]
        sch = _rollout_schedule(batch, dev)
        est, totals = [], {}
        for b in range(B):
            out, tr, ro, _ = _sample_rollout(state.patchifier, state.update,
                                             batch, b, sch, steps, M, False,
                                             amp)
            est.append(out["poses"])
            sample = {"flow_err": out["flow_err"][-1], "px1": out["px1"][-1],
                      "tr": tr[-1], "ro": ro[-1]}
            for k, v in sample.items():
                totals[k] = totals.get(k, 0.0) + v / B
        return torch.stack(est), totals

    return eval_step
