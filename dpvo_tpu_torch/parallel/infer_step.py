"""Edge-sharded SLAM inference over ``torch.distributed`` ranks.

Counterpart of ``dpvo_tpu/parallel/infer_step.py``.  The tracking update
(reproject -> correlate -> recurrent update -> BA) is bounded by per-edge
work, so the EDGE dimension is split over the ranks of a process group,
one process per device:

- poses, patches, intrinsics and the feature rings: the same on every rank;
- the edge tables (ii/jj/kk/net/target/weight/valid): each rank holds its
  slice, with edges partitioned by PATCH so that the patch-group attention
  (agg_kk) and the temporal-neighbour pass stay rank-local
  (``shard_edges_by_patch``, a verbatim numpy copy);
- frame-pair attention (agg_ij): dense per-group sums reduced across the
  ranks (SoftAgg's cross-rank form, ``models/blocks.py``);
- bundle adjustment: per-rank normal-equation partials, one fused
  ``all_reduce``, then every rank solves the same small Schur system
  (``ops.ba.ba_iterative_sharded``); no per-edge data crosses ranks;
- correlation: each rank's own edges through the engine's route
  (``engine.kernels._corr_act``: the fused correlation kernel on the card,
  its plain version on the CPU), from the replicated rings.

The single-device engine is untouched; ``chip_smoke.py``'s ``sharded``
phase and ``tests/test_torch_sharded.py`` hold this step against the
single-device ``engine.kernels.update_step`` and against the JAX package's
sharded step.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

from ..engine.kernels import _corr_act
from ..ops import ba, graph, projective as pops
from ..ops.scatter import INT_MAX


def shard_edges_by_patch(ii, jj, kk, n_shards, e_shard=None, k_cap=None):
    """Partition edges into ``n_shards`` equal slices without splitting
    a patch group (host-side, numpy).

    Sorts edges by ``kk`` and cuts the sorted order at patch-group
    boundaries so all edges of one patch land on one shard — the
    invariant that keeps agg_kk and the temporal-neighbor pass
    shard-local.  Returns (perm, valid) where ``perm`` (n_shards *
    e_shard,) indexes into the input edge arrays (padded slots repeat
    edge 0) and ``valid`` marks real rows.

    Raises if any single patch group exceeds ``e_shard`` edges (cannot
    be placed) — patch groups are <= PATCH_LIFETIME * 2 edges in the
    tracking loop, far below any sane shard size.

    Pass ``k_cap`` (the value later given to ``make_sharded_update_step``)
    to validate the live-patch-id span up front: ``ba_iterative_sharded``
    maps patch slots with a GLOBAL dense ``kk - min(kk)`` mapping, so a
    span >= k_cap would silently zero-weight the overflowing edges and
    quietly diverge from the single-device result.
    """
    kk = np.asarray(kk)
    E = len(kk)
    if k_cap is not None and E > 0:
        span_kk = int(kk.max()) - int(kk.min()) + 1
        if span_kk > k_cap:
            raise ValueError(
                f"live patch-id span {span_kk} exceeds k_cap {k_cap}; "
                f"ba_iterative_sharded's dense kk - min(kk) slot mapping "
                f"would drop edges — raise k_cap or retire old edges")
    order = np.argsort(kk, kind="stable")
    ks = kk[order]
    # boundary[i] = True where a new patch group starts at sorted pos i
    new_grp = np.empty(E, bool)
    new_grp[0] = True
    new_grp[1:] = ks[1:] != ks[:-1]
    grp_start = np.nonzero(new_grp)[0]
    grp_end = np.append(grp_start[1:], E)
    grp_size = grp_end - grp_start

    if e_shard is None:
        # slack of one max-size group per shard: the greedy fill wastes
        # fewer than max-group slots per shard boundary, so this always
        # places (rounded up to a multiple of 8 lanes)
        e_shard = int(-(-E // n_shards)) + int(grp_size.max(initial=1))
        e_shard = -(-e_shard // 8) * 8
    if grp_size.max(initial=0) > e_shard:
        raise ValueError(
            f"a patch group of {grp_size.max()} edges exceeds the shard "
            f"capacity {e_shard}")

    shards = [[] for _ in range(n_shards)]
    s = 0
    for g0, g1 in zip(grp_start, grp_end):
        while s < n_shards - 1 and len(shards[s]) + (g1 - g0) > e_shard:
            s += 1
        if len(shards[s]) + (g1 - g0) > e_shard:
            raise ValueError(
                f"cannot place {E} edges into {n_shards} shards of "
                f"{e_shard} (greedy fill overflowed the last shard)")
        shards[s].extend(order[g0:g1].tolist())

    perm = np.zeros(n_shards * e_shard, np.int64)
    valid = np.zeros(n_shards * e_shard, bool)
    for s, rows in enumerate(shards):
        perm[s * e_shard:s * e_shard + len(rows)] = rows
        valid[s * e_shard:s * e_shard + len(rows)] = True
    return perm, valid


def make_sharded_update_step(update_mod, group, *, M, pmem, mem, n_cap,
                             k_cap, span=64, iterations=2):
    """The per-rank edge-sharded update step.

    ``span`` bounds the live frame window: frame-pair group ids are the
    dense slots ``(ii - t_lo) * span + (jj - t_lo)``, ``t_lo`` the smallest
    live frame over all ranks (REMOVAL_WINDOW + PATCH_LIFETIME in the
    tracking loop, far below the default 64).  The step mirrors
    ``engine.kernels.update_step`` on this rank's rows of the edge tables
    (``shard_edges_by_patch``'s partition, this rank's ``e_shard`` rows)::

        f(poses, patches, intrinsics, imap, gmap, fmap1, fmap2,
          net, target, weight, ii, jj, kk, valid, t0, t1)
        -> (net', target', weight', delta, poses', patches')

    poses, patches, intrinsics, imap, gmap and the zero-padded fmap rings
    (the engine's ``DeviceState`` layout) are the same on every rank and
    the poses and patches returned are too; net, target, weight, delta
    are this rank's rows, zero where ``valid`` is false.  The weights are
    ``update_mod``'s (as the engine's, no ``params`` argument).  Collectives
    per call, the same on every rank in the same order: ``all_reduce(MIN)``
    of t_lo, then SoftAgg's MAX and two SUMs, then BA's MIN of k_lo, its
    SUM of the touched slots and one fused SUM per iteration.  TF32 is
    off while the step runs, as the engine keeps it, for the BA partials;
    the caller's setting is restored after.
    """
    g_cap = span * span

    def step(*args):
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            return update(*args)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved

    @torch.no_grad()
    def update(poses, patches, intrinsics, imap, gmap, fmap1, fmap2, net,
               target, weight, ii, jj, kk, valid, t0, t1):
        ii, jj, kk = ii.long(), jj.long(), kk.long()
        ii_s = torch.where(valid, ii, 0)
        jj_s = torch.where(valid, jj, 0)
        kk_s = torch.where(valid, kk, 0)

        coords = pops.transform(poses, patches, intrinsics, ii_s, jj_s,
                                kk_s)                     # (El, P, P, 2)
        kk_mod = kk_s % (M * pmem)
        rings = SimpleNamespace(gmap=gmap, fmap1=fmap1, fmap2=fmap2)
        corr = _corr_act(rings, update_mod, coords, kk_mod, jj_s % mem)
        ctx = imap[kk_mod].float()

        # frame-pair ids that agree across the ranks for agg_ij
        t_lo = torch.full((1,), INT_MAX, dtype=torch.int64,
                          device=ii.device)
        if ii.numel():
            t_lo = torch.minimum(t_lo, torch.where(
                valid, torch.minimum(ii, jj), INT_MAX).min())
        dist.all_reduce(t_lo, dist.ReduceOp.MIN, group=group)
        pi, pj = ii - t_lo, jj - t_lo
        ok = valid & (pi >= 0) & (pi < span) & (pj >= 0) & (pj < span)
        gid = torch.where(ok, pi * span + pj.clamp(0, span - 1), g_cap)

        nbrs = graph.neighbors(kk, jj, valid)     # rank-local by design
        net, delta, w_out = update_mod(
            net, ctx, corr, ii_s, jj_s, kk_s, valid, nbrs=nbrs,
            shard_ctx=(group, gid, g_cap))

        c = coords.shape[1] // 2
        target = coords[:, c, c] + delta
        target = torch.where(valid[:, None], target, 0.0)

        poses, patches = ba.ba_iterative_sharded(
            poses, patches, intrinsics[0], target, w_out, 1e-4, ii_s, jj_s,
            kk_s, valid, t0, t1, n_cap=n_cap, k_cap=k_cap,
            iterations=iterations, group=group)
        return net, target, w_out, delta, poses, patches

    return step


def ba_reduce_bytes(n_cap, k_cap):
    """Bytes of ``ba_iterative_sharded``'s fused reduction per iteration:
    B (D, D), v (D,), E (D, k_cap) and C/u (k_cap, 2) in fp32, D = 6
    n_cap."""
    D = 6 * n_cap
    return 4 * (D * D + D + D * k_cap + 2 * k_cap)
