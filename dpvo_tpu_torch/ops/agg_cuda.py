"""Compact segment sums over group-sorted rows (CUDA kernels + plain twins).

Counterpart of ``dpvo_tpu/ops/agg_pallas.py``.  Two functions, two kernels
of ``csrc/segment_sums.cu``:

- ``segment_softmax_sums`` — the SoftAgg reductions (two per update):
  ``T1[g] = sum exp(gate - shift)``, ``T2[g] = sum exp(gate - shift) * val``
  (one block per group);
- ``segment_sums`` — the JAX package's BA pose-depth coupling sums
  (blocks own row slices and sum the runs that start in them).  The port's
  local BA sums its coupling inside ``ba_cuda.ba_blocks``, so no engine
  path launches it.

Both kernels add each group's rows in row order from 0 in fp32, so
``segment_sums`` equals ``segment_sums_ordered`` (the plain version in that
order) bitwise.

Rows arrive sorted by their dense group rank ``gid`` (nondecreasing, step
<= 1).  Outputs have ``padded_groups(g_cap)`` rows with zeros past the
last rank, as on the TPU.  On a CPU tensor the wrappers run the plain
PyTorch version; on a CUDA tensor they launch the kernel or raise.  The
kernels have no backward: on the card, the wrappers raise in grad mode when
an input requires grad.
"""
from __future__ import annotations

import torch

from . import _cuda

BLK = 256          # the TPU kernel's row block (kept for the row padding)
BLK2 = BLK + 8


def padded_groups(g_cap: int) -> int:
    """Output rows for a given group capacity (the TPU kernel's alignment
    + slack pad, kept so both packages return the same table)."""
    return g_cap + BLK2


# A padded edge bucket keys its masked rows to INT_MAX, so they sort to
# the tail as one group of up to thousands of rows, which a kernel adds as
# one run on one block (K3 and K4 read 3-39x their live-row times so).
# Two ways keep that run out, one per kernel's contract (K3's; local BA's
# patch ranks, ``ba_cuda.ba_blocks``, one warp a rank); both leave the
# live groups' sums as they were.

def skip_masked(gid_sorted, live_sorted, g_cap):
    """The dense ranks ``gid_sorted`` (E,) of group-sorted rows with the
    masked rows (``live_sorted`` False) moved past the table of ``g_cap``,
    so ``segment_softmax_sums`` never sums them: its blocks own one group
    each and write zeros for a group with no rows, so the gap this leaves
    is fine there (not in ``segment_sums``)."""
    return torch.where(live_sorted, gid_sorted, padded_groups(g_cap))


def split_masked(gid_sorted, live_sorted):
    """Dense ranks ``gid_sorted`` (E,) of group-sorted rows with the masked
    tail a group per row: its ranks count up by one a row from its own,
    so they stay dense (step <= 1, no gap), as ``segment_sums`` needs (it
    writes no row inside a gap), and the ranks past the table are dropped
    as before: local BA's patch ranks, so that no warp of
    ``ba_cuda.ba_blocks`` walks the whole tail."""
    tail = torch.cumsum(~live_sorted, 0, dtype=gid_sorted.dtype) - 1
    return gid_sorted + torch.where(live_sorted, 0, tail)


def _segment_total(rows, gid, G):
    """Plain per-group sums of sorted rows; ranks >= G are dropped."""
    keep = gid < G
    counts = torch.bincount(gid[keep].long(), minlength=G)
    return torch.segment_reduce(rows[keep], "sum", lengths=counts, axis=0)


def segment_softmax_sums_plain(gate, vals, shift, gid, g_cap):
    e = torch.exp(gate.float() - shift)
    cat = torch.cat([e, e * vals.float()], dim=1)
    return _segment_total(cat, gid, padded_groups(g_cap))


def segment_sums_plain(vals, gid, g_cap):
    return _segment_total(vals.float(), gid, padded_groups(g_cap))


def segment_sums_ordered(vals, gid, g_cap):
    """Plain version of ``segment_sums`` in the kernel's summation order:
    each group's rows added one at a time in row order, from 0, in fp32 (a
    loop over the offsets within the runs, one IEEE add per row), so the
    kernel equals it bitwise.  For the tests and ``chip_smoke.py``; the
    main path uses ``segment_sums``."""
    G = padded_groups(g_cap)
    vals = vals.float()
    out = vals.new_zeros((G, vals.shape[1]))
    if vals.shape[0] == 0:
        return out
    gid = gid.long()
    head = torch.ones_like(gid, dtype=torch.bool)
    head[1:] = gid[1:] != gid[:-1]
    starts = torch.nonzero(head).flatten()
    lengths = torch.diff(starts, append=starts.new_tensor([len(gid)]))
    groups = gid[starts]
    keep = groups < G
    starts, lengths, groups = starts[keep], lengths[keep], groups[keep]
    for k in range(int(lengths.max()) if len(lengths) else 0):
        live = lengths > k
        out[groups[live]] += vals[starts[live] + k]
    return out


def segment_softmax_sums(gate_sorted, vals_sorted, shift, gid_sorted, g_cap):
    """gate_sorted, vals_sorted (E, D) fp32 group-sorted rows; shift (1, D)
    fp32 stability shift; gid_sorted (E,) int dense ranks; g_cap group
    capacity.  Returns (padded_groups(g_cap), 2D) fp32: [:, :D] = sum exp,
    [:, D:] = sum exp * vals."""
    if gate_sorted.device.type == "cpu":
        return segment_softmax_sums_plain(gate_sorted, vals_sorted, shift,
                                          gid_sorted, g_cap)
    _cuda.refuse_autograd("segment_softmax_sums", gate_sorted, vals_sorted,
                          shift)
    E, D = gate_sorted.shape
    G = padded_groups(g_cap)
    _cuda.require(gate_sorted, "gate_sorted", torch.float32, (E, D))
    _cuda.require(vals_sorted, "vals_sorted", torch.float32, (E, D))
    _cuda.require(shift, "shift", torch.float32, (1, D))
    _cuda.require(gid_sorted, "gid_sorted", torch.int32, (E,))
    out = torch.empty((G, 2 * D), dtype=torch.float32,
                      device=gate_sorted.device)
    code = _cuda.lib().dpvo_segment_softmax_sums(
        gate_sorted.data_ptr(), vals_sorted.data_ptr(), shift.data_ptr(),
        gid_sorted.data_ptr(), out.data_ptr(), E, D, G,
        _cuda.stream_ptr(out.device))
    _cuda.check(code, "segment_softmax_sums")
    _cuda.count("segment_softmax_sums")
    return out


def segment_sums(vals_sorted, gid_sorted, g_cap):
    """vals_sorted (E, D) fp32 group-sorted rows; gid_sorted (E,) int dense
    ranks.  Returns (padded_groups(g_cap), D) fp32 per-group totals."""
    if vals_sorted.device.type == "cpu":
        return segment_sums_plain(vals_sorted, gid_sorted, g_cap)
    _cuda.refuse_autograd("segment_sums", vals_sorted)
    E, D = vals_sorted.shape
    G = padded_groups(g_cap)
    _cuda.require(vals_sorted, "vals_sorted", torch.float32, (E, D))
    _cuda.require(gid_sorted, "gid_sorted", torch.int32, (E,))
    out = torch.empty((G, D), dtype=torch.float32, device=vals_sorted.device)
    code = _cuda.lib().dpvo_segment_sums(
        vals_sorted.data_ptr(), gid_sorted.data_ptr(), out.data_ptr(), E, D,
        G, _cuda.stream_ptr(out.device))
    _cuda.check(code, "segment_sums")
    _cuda.count("segment_sums")
    return out
