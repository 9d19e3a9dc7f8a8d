#!/usr/bin/env python3
"""Local-window BA at the retain bucket, its per-iteration phases, and
global BA's conjugate-gradient depth, on one GPU.

    python scripts/dev/ba_bench_torch.py [rows] [live] [cg] [quick]

The port's counterpart of ``ba_bench.py``, at its shapes: ``rows`` edges
(49152) of which ``live`` (rows - 4000) are live, their patches in the 22
frames before frame 44 of a 256-frame, M=96 buffer, sorted by patch, each
edge's target frame 1-11 after its source; targets uniform in [0, 150),
weights in [0, 1); the pose window [34, 44), ``n_cap`` 16, ``k_cap`` 4096.
The port's BA runs at the live count.  Device ms per call
(``microbench_torch.timed``, from a CUDA graph: ``ba_iterative`` runs with
no host synchronisation) of:

- ``ba_iterative``, 2 iterations;
- its phases: once a call the sort, the patch slots and the kernel's plan
  (``_edge_plan``); each iteration the per-edge blocks summed per patch
  and per frame pair (``ba_cuda.ba_blocks``, one launch), their assembly
  into B and v (``ba_cuda.assemble``), the Schur complement and its
  Cholesky solve (96x96), the pose retraction;
- the dense one-hot form those blocks replaced, as the yardstick, per
  iteration: the residuals and Jacobians (``_edge_terms_center``), the
  one-hot effective Jacobian with its Hessian and gradient products, the
  K4 coupling sums;
- with ``cg``, ``ba_global`` (2 iterations; PCG with ``index_add_`` sums)
  at ``cg_iters`` 12, 24 and 48 on the same edges.

The phases follow ``ops/ba.py``'s code: they attribute time, and are not
held to its results.  Needs a CUDA card.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

import microbench_torch as mb

N, M, P = 256, 96, 3
N_NOW, WINDOW = 44, 22
N_CAP, K_CAP = 16, 4096
INTR = (160.0, 160.0, 80.0, 60.0)


def problem(dev, rows, live, seed=0):
    """``ba_bench.py``'s problem on ``dev``: dict of the BA arguments (the
    live rows only)."""
    import torch
    rng = np.random.default_rng(seed)
    kk = np.sort(rng.integers((N_NOW - WINDOW) * M, N_NOW * M, rows))
    ii = kk // M
    jj = np.minimum(ii + rng.integers(1, 12, rows), N_NOW)
    poses = torch.zeros((N, 7), device=dev)
    poses[:, 6] = 1.0

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a)[:live], dtype=dtype,
                               device=dev)

    return dict(
        poses=poses,
        patches=torch.as_tensor(rng.uniform(1, 4, (N * M, 3, P, P)),
                                dtype=torch.float32, device=dev),
        intrinsics=torch.tensor(INTR, device=dev),
        target=t(rng.uniform(0, 150, (rows, 2))),
        weight=t(rng.uniform(0, 1, (rows, 2))),
        ii=t(ii, torch.int64), jj=t(jj, torch.int64), kk=t(kk, torch.int64),
        valid=torch.ones(live, dtype=torch.bool, device=dev))


def args_of(pb):
    return (pb["poses"], pb["patches"], pb["intrinsics"], pb["target"],
            pb["weight"], 1e-4, pb["ii"], pb["jj"], pb["kk"], pb["valid"],
            N_NOW - 10, N_NOW)


def phases(pb):
    """{phase: zero-argument function} of ``ba_iterative``'s set-up and one
    iteration body, then the dense form's per-iteration phases, on
    ``pb``'s edges."""
    import torch
    from dpvo_tpu_torch.ops import agg_cuda, ba_cuda, lie
    from dpvo_tpu_torch.ops.ba import _edge_plan, _edge_terms_center
    poses, patches, target, weight = (pb[k] for k in ("poses", "patches",
                                                      "target", "weight"))
    ii, jj, kk, valid = (pb[k] for k in ("ii", "jj", "kk", "valid"))
    intr = pb["intrinsics"]
    fx, fy, cx, cy = intr.unbind()
    E, dev, t0 = ii.shape[0], ii.device, N_NOW - 10
    D = 6 * N_CAP
    cols = torch.arange(N_CAP, device=dev)
    ctr = patches[:, :, P // 2, P // 2].clone()

    def plan():
        return _edge_plan(ii, jj, kk, valid, target, weight, t0, N_CAP,
                          K_CAP, patches.shape[0])

    pl = plan()[0]

    def blocks():
        return ba_cuda.ba_blocks(poses, ctr, intr, pl)

    ecu, tab = blocks()

    def assemble():
        return ba_cuda.assemble(tab, N_CAP)

    B, vvec = assemble()

    def schur_solve():
        Emat, C, u = ecu[:, :D].t(), ecu[:, D], ecu[:, D + 1]
        Q = 1.0 / (C + 1e-4)
        EQ = Emat * Q[None, :]
        Sm = B - EQ @ Emat.t()
        y = vvec - EQ @ u
        Sm = Sm + torch.diag(1e-4 * torch.diagonal(Sm) + 1.0)
        L, _ = torch.linalg.cholesky_ex(Sm)
        dX = torch.cholesky_solve(y[:, None], L)[:, 0]
        return dX, Q * (u - Emat.t() @ dX)

    dxi = torch.tanh(poses[:, :6]) * 1e-3

    # the dense form, on the plan's kk-sorted rows
    ii_s, jj_s, kk_s = (pl.edges[:, i].long() for i in range(3))
    target_s, weight_s = pl.tw[:, :2], pl.tw[:, 2:]

    def terms():
        return _edge_terms_center(poses, ctr, fx, fy, cx, cy, target_s,
                                  ii_s, jj_s, kk_s)

    r, mask, Ji, Jj, Jz = terms()
    w = mask[:, None] * weight_s

    def jeff():
        li, lj = ii_s - t0, jj_s - t0
        vi = (li >= 0) & (li < N_CAP)
        vj = (lj >= 0) & (lj < N_CAP)
        oh_i = ((li.clamp(0, N_CAP - 1)[:, None] == cols)
                & vi[:, None]).float()
        oh_j = ((lj.clamp(0, N_CAP - 1)[:, None] == cols)
                & vj[:, None]).float()
        return (-oh_i[:, None, :, None] * Ji[:, :, None, :]
                + oh_j[:, None, :, None] * Jj[:, :, None, :]).reshape(E, 2, D)

    Jeff = jeff()

    def hessian():
        Je = jeff()
        wJ = w[:, :, None] * Je
        return (wJ.reshape(-1, D).t() @ Je.reshape(-1, D),
                torch.einsum("era,er->a", wJ, r))

    A = torch.einsum("er,era->ea", w * Jz, Jeff)
    Cu = torch.stack([(w * Jz * Jz).sum(1), (w * r * Jz).sum(1)], dim=-1)
    AC = torch.cat([A, Cu], dim=1)

    def coupling():
        return agg_cuda.segment_sums(AC, pl.gid, K_CAP + 1)

    return {"sort + patch slots + plan (once a call)": plan,
            "per-edge blocks (ba_blocks)": blocks,
            "assemble B, v": assemble,
            "Schur + Cholesky solve (96x96)": schur_solve,
            "pose retraction": lambda: lie.se3_retr(poses, dxi),
            "[dense form] residuals + Jacobians": terms,
            "[dense form] one-hot J_eff + Hessian + gradient": hessian,
            "[dense form] coupling sums (K4)": coupling}


def bench(dev, rows=49152, live=None, cg=False, reps=10, windows=5):
    """Time ``ba_iterative``, its phases and with ``cg`` ``ba_global``;
    -> {name: Timed}."""
    import torch
    from dpvo_tpu_torch.ops import ba
    live = rows - 4000 if live is None else live
    pb = problem(dev, rows, live)
    print(f"[ba_bench] rows={rows} live={live}: poses {N}, patches {N * M}, "
          f"window [{N_NOW - 10}, {N_NOW}), n_cap {N_CAP}, k_cap {K_CAP}",
          flush=True)
    kw = dict(reps=reps, windows=windows)
    out = {}
    with torch.no_grad():
        out["ba_iterative"] = mb.timed(
            f"ba_iterative 2 it E={live}", ba.ba_iterative, *args_of(pb),
            N_CAP, K_CAP, 2, **kw)
        for name, fn in phases(pb).items():
            out[name] = mb.timed(f"  {name}", fn, **kw)
        if cg:
            for it in (12, 24, 48):
                out[f"ba_global cg={it}"] = mb.timed(
                    f"ba_global 2 it cg={it} E={live}", ba.ba_global,
                    *args_of(pb), N_CAP, K_CAP, 2, cg_iters=it,
                    reps=max(1, reps // 3), windows=windows)
    return out


def main(argv):
    quick = "quick" in argv
    ints = [int(a) for a in argv if a.isdigit()]
    rows = ints[0] if ints else 49152
    live = ints[1] if len(ints) > 1 else None
    dev = mb.card("ba_bench_torch")
    bench(dev, rows, live, cg="cg" in argv, reps=3 if quick else 10,
          windows=3 if quick else 5)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    sys.exit(main(sys.argv[1:]))
