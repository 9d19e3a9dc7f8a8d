"""Local BA's normal equations from per-edge 6-wide blocks (the CUDA kernel
of ``csrc/ba_blocks.cu`` and its plain twin).

``ops.ba.ba_iterative`` calls ``plan`` once and then, each Gauss-Newton
iteration, ``ba_blocks`` (one launch) and ``assemble``.  The kernel replaces
no TPU kernel: the JAX package forms the effective pose Jacobian over the
window as dense one-hot blocks, (E, 2, 6 n_cap), and sums it with XLA's
einsums (the source's note says why the port does not).  Each edge touches
two pose blocks, ``a`` and ``b`` (its frames ii and jj less ``t0``, or the
index ``n_cap`` for a frame outside the window, whose block is dropped),
and one depth; the kernel sums its terms

- per patch rank into the coupling rows ``ecu`` (k_cap, 6 n_cap + 2):
  ``w Jz^T (-Ji)`` at block ``a``, ``w Jz^T Jj`` at block ``b`` (added one
  after the other: a self-edge sums both), then ``C`` and ``u``;
- per window frame pair ``(a, b)`` into ``blocks`` ((n_cap + 1)^2, 120):
  ``[Hii | gi | Hjj | gj | Hij]`` (``COLS``), the Ji parts zero where ``a``
  is outside the window and the Jj parts where ``b`` is;

and ``assemble`` adds the pair table into ``B`` (D, D) and ``v`` (D,) with
dense reductions.  Masked rows have zero weight and sum nowhere; ranks
past ``k_cap`` fold into the dropped slot.  Everything is fp32, and every
sum runs in a fixed order with no atomics, so two launches on the same
inputs give the same bits.  On a CPU tensor ``ba_blocks`` runs the plain
version; on a CUDA tensor it launches the kernel or raises.  The kernel has
no backward: on the card the wrapper raises in grad mode when an input
requires grad (training runs ``ba_differentiable``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import _cuda

MAX_N_CAP = 32     # the kernel's largest pose window (ba_global takes 64+)
COLS = 120         # a pair row: Hii 36, gi 6, Hjj 36, gj 6, Hij 36


class Plan(NamedTuple):
    """The edges of one BA call in kk order, as the kernel reads them."""
    edges: torch.Tensor    # (E, 4) int32: ii, jj, kk, pair (``unpack``)
    tw: torch.Tensor       # (E, 4) fp32: target x, y, weight x, y
    gid: torch.Tensor      # (E,) int32 dense patch ranks, nondecreasing
    pstart: torch.Tensor   # (k_cap + 1,) int32: rank g's rows
    kperm: torch.Tensor    # (E,) int32: the rows sorted by frame pair
    kstart: torch.Tensor   # ((n_cap + 1)^2 + 1,) int32: each pair's run
    n_cap: int
    k_cap: int


def plan(ii, jj, kk, valid, target, weight, gid, t0, n_cap, k_cap):
    """The kernel's view of one BA call, made once for all its iterations.

    ii, jj, kk (E,) int, valid (E,) bool, target, weight (E, 2): the edges
    sorted by patch (kk); gid (E,) int32 their dense patch ranks, ranks past
    ``k_cap`` folded into it (rows at or past ``pstart[k_cap]`` sum into no
    row); t0 a host int or an integer device scalar.  No host
    synchronisation."""
    if not 1 <= n_cap <= MAX_N_CAP:
        raise ValueError(f"ba_blocks takes a pose window of 1..{MAX_N_CAP} "
                         f"blocks, got n_cap={n_cap} (ba_global takes more)")
    dev = ii.device
    n1 = n_cap + 1
    ij = torch.stack([ii, jj], dim=1).long()
    lij = ij - t0
    ab = torch.where((lij >= 0) & (lij < n_cap), lij, n_cap)
    # the pair a * (n_cap + 1) + b, the masked rows past every pair: a
    # 16-bit sort key (two radix passes)
    pair = torch.where(valid, ab[:, 0] * n1 + ab[:, 1], n1 * n1)
    edges = torch.cat([ij, kk.long()[:, None], pair[:, None]], dim=1).int()
    tw = torch.cat([target, weight], dim=1).float()
    keys, kperm = torch.sort(pair.to(torch.int16), stable=True)
    kstart = torch.searchsorted(
        keys, torch.arange(n1 * n1 + 1, dtype=torch.int16, device=dev))
    gid = gid.int()
    pstart = torch.searchsorted(
        gid, torch.arange(k_cap + 1, dtype=torch.int32, device=dev))
    return Plan(edges, tw, gid, pstart.int(), kperm.int(), kstart.int(),
                n_cap, k_cap)


def unpack(pair, n_cap):
    """A plan's pair column -> (a, b, valid): the window blocks of a row's
    frames (``n_cap`` for a frame outside the window) and whether the row
    is live (masked rows hold ``(n_cap + 1)^2``; ``a = b = n_cap``)."""
    n1 = n_cap + 1
    valid = pair < n1 * n1
    pair = torch.where(valid, pair, n1 * n1 - 1)
    return pair // n1, pair % n1, valid


def ba_blocks(poses, ctr, intrinsics, pl: Plan):
    """poses (Np, 7), ctr (K, 3) patch centres [x, y, depth], intrinsics
    (4,) [fx, fy, cx, cy], fp32; ``pl`` from ``plan``.  Returns (ecu
    (k_cap, 6 n_cap + 2), blocks ((n_cap + 1)^2, COLS)) fp32."""
    if poses.device.type == "cpu":
        return ba_blocks_plain(poses, ctr, intrinsics, pl)
    _cuda.refuse_autograd("ba_blocks", poses, ctr, intrinsics)
    n1, D = pl.n_cap + 1, 6 * pl.n_cap
    E = pl.edges.shape[0]
    _cuda.require(poses, "poses", torch.float32, (None, 7))
    _cuda.require(ctr, "ctr", torch.float32, (None, 3))
    _cuda.require(intrinsics, "intrinsics", torch.float32, (4,))
    _cuda.require(pl.edges, "edges", torch.int32, (E, 4), aligned=True)
    _cuda.require(pl.tw, "tw", torch.float32, (E, 4), aligned=True)
    _cuda.require(pl.pstart, "pstart", torch.int32, (pl.k_cap + 1,))
    _cuda.require(pl.kperm, "kperm", torch.int32, (E,))
    _cuda.require(pl.kstart, "kstart", torch.int32, (n1 * n1 + 1,))
    ecu = torch.empty((pl.k_cap, D + 2), dtype=torch.float32,
                      device=poses.device)
    blocks = torch.empty((n1 * n1, COLS), dtype=torch.float32,
                         device=poses.device)
    code = _cuda.lib().dpvo_ba_blocks(
        poses.data_ptr(), ctr.data_ptr(), intrinsics.data_ptr(),
        pl.edges.data_ptr(), pl.tw.data_ptr(), pl.pstart.data_ptr(),
        pl.kperm.data_ptr(), pl.kstart.data_ptr(), ecu.data_ptr(),
        blocks.data_ptr(), pl.n_cap, pl.k_cap, _cuda.stream_ptr(ecu.device))
    _cuda.check(code, "ba_blocks")
    _cuda.count("ba_blocks")
    return ecu, blocks


def ba_blocks_plain(poses, ctr, intrinsics, pl: Plan):
    """Plain PyTorch version of ``ba_blocks``: the same per-edge terms
    (``ops.ba._edge_terms_center`` with each edge's relative pose) summed
    with ``index_put_``/``index_add_`` by patch rank and by frame pair, in
    the dtype of ``poses`` (fp32 as the kernel; the card tests also run it
    in fp64 as the reference both are held to)."""
    from .ba import _edge_terms_center
    S, k_cap = pl.n_cap, pl.k_cap
    n1, D = S + 1, 6 * S
    dt, dev = poses.dtype, poses.device
    ii, jj, kk, pair = pl.edges.long().unbind(1)
    a, b, valid = unpack(pair, S)
    tw = pl.tw.to(dt)
    fx, fy, cx, cy = intrinsics.to(dt).unbind()
    r, mask, Ji, Jj, Jz = _edge_terms_center(
        poses, ctr.to(dt), fx, fy, cx, cy, tw[:, :2], ii, jj, kk)
    w = mask[:, None] * tw[:, 2:] * valid[:, None]           # (E, 2)
    Ai = torch.where((a < S)[:, None, None], -Ji, 0.0)       # (E, 2, 6)
    Aj = torch.where((b < S)[:, None, None], Jj, 0.0)

    # coupling rows: block S and rank k_cap are dropped
    z = w * Jz
    g = pl.gid.long().clamp(max=k_cap)
    rows = torch.zeros((k_cap + 1, n1, 6), dtype=dt, device=dev)
    rows.index_put_((g, a), (z[:, :, None] * Ai).sum(1), accumulate=True)
    rows.index_put_((g, b), (z[:, :, None] * Jj).sum(1), accumulate=True)
    cu = torch.zeros((k_cap + 1, 2), dtype=dt, device=dev).index_add_(
        0, g, torch.stack([(z * Jz).sum(1), (w * r * Jz).sum(1)], dim=1))
    ecu = torch.cat([rows[:k_cap, :S].reshape(k_cap, D), cu[:k_cap]], dim=1)

    # frame-pair rows: the pair (S, S) and the masked rows are dropped
    key = torch.where((a < S) | (b < S), pair, n1 * n1)
    wa, wb = w[:, :, None] * Ai, w[:, :, None] * Aj

    def outer(x, y):
        return (x[:, :, :, None] * y[:, :, None, :]).sum(1).reshape(-1, 36)

    per_edge = torch.cat([outer(wa, Ai), (wa * r[:, :, None]).sum(1),
                          outer(wb, Aj), (wb * r[:, :, None]).sum(1),
                          outer(wa, Aj)], dim=1)
    blocks = torch.zeros((n1 * n1 + 1, COLS), dtype=dt,
                         device=dev).index_add_(0, key, per_edge)
    return ecu, blocks[:n1 * n1]


def assemble(blocks, n_cap):
    """The pair table of ``ba_blocks`` -> (B (D, D), v (D,)), D = 6 n_cap:
    each window frame's diagonal block sums its Hii over the pairs it
    starts and its Hjj over those it ends, the off-diagonal block (x, y) is
    Hij(x, y) + Hij(y, x)^T (a self-pair adds both into its diagonal).
    Dense reductions over the table: no atomics."""
    n1, D = n_cap + 1, 6 * n_cap
    t = blocks.view(n1, n1, COLS)
    diag = t[:n_cap, :, :42].sum(1) + t[:, :n_cap, 42:84].sum(0)  # (n, 42)
    off = t[:n_cap, :n_cap, 84:].reshape(n_cap, n_cap, 6, 6)
    bb = off + off.permute(1, 0, 3, 2)
    bb.diagonal(0, 0, 1).add_(diag[:, :36].reshape(n_cap, 6, 6)
                              .permute(1, 2, 0))
    return bb.permute(0, 2, 1, 3).reshape(D, D), diag[:, 36:].reshape(D)
