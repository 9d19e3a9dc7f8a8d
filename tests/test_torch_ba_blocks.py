"""``ops.ba_cuda``'s contract on the CPU: the plain version of the local-BA
kernel (per-edge 6-wide blocks summed per patch and per window frame pair)
with ``assemble`` gives the normal equations of the dense one-hot form it
replaced (kept here as the reference, ``dense_normal_equations``), on
scenes with masked rows that carry weight, self-edges (ii == jj), frames
on both sides of the pose window, patches past ``k_cap`` and no free pose
(every frame outside the window).  Tolerance: fp32 sums in other orders,
and the self-edges' blocks summed as Ji^T Ji + Jj^T Jj - Ji^T Jj - Jj^T Ji
where the dense form squares Jj - Ji: 1e-5 of the largest entry.

``ba_case`` and ``plan_of`` also make the card tests' inputs, and
``excess`` is their measure (``tests/test_torch_cuda.py`` and
``chip_smoke.py``, which import no JAX; neither does this file).
"""
import numpy as np
import pytest
import torch

from dpvo_tpu_torch.ops import ba as tba, ba_cuda, lie

INTR = (120.0, 110.0, 80.0, 60.0)

# name -> ba_case arguments: the pose window's size and start, the frames
# and the patch capacity
CASES = {"n4": dict(n_cap=4, t0=5, n_frames=12),
         "n16": dict(n_cap=16, t0=4, n_frames=24),
         "n32": dict(n_cap=32, t0=3, n_frames=40),
         "past_k_cap": dict(n_cap=16, t0=4, n_frames=24, k_cap=128),
         "no_free_pose": dict(n_cap=4, t0=12, n_frames=12)}


def ba_case(E=3000, n_frames=24, M=32, n_cap=16, t0=4, k_cap=4096,
            masked=64, seed=0, device="cpu"):
    """A local-BA scene: poses moving along a curve with small rotations,
    patches of M a frame at inverse depths 0.3-1.5, E edges from each
    patch's frame to frames within 5 of it (a self-edge where the offset
    is 0), targets the reprojections plus 1 px of noise, weights 0.2-1;
    the last ``masked`` rows masked, with weight.  -> dict of ba_iterative's
    arguments (input order) and ``ctr`` (K, 3)."""
    rng = np.random.default_rng(seed)
    f = np.arange(n_frames)
    poses = np.zeros((n_frames, 7), np.float32)
    poses[:, 0] = 0.06 * f
    poses[:, 1] = 0.02 * np.sin(0.5 * f)
    poses[:, 2] = -0.03 * f
    poses[:, 3:] = lie.so3_exp(torch.as_tensor(
        rng.normal(size=(n_frames, 3)) * 0.03, dtype=torch.float32)).numpy()
    K = n_frames * M
    fx, fy, cx, cy = INTR
    ctr = np.stack([rng.uniform(0, 2 * cx, K), rng.uniform(0, 2 * cy, K),
                    rng.uniform(0.3, 1.5, K)], -1).astype(np.float32)
    kk = rng.integers(0, K, E)
    ii = kk // M
    jj = np.clip(ii + rng.integers(-5, 6, E), 0, n_frames - 1)
    t = {k: torch.as_tensor(v) for k, v in dict(poses=poses, ctr=ctr).items()}
    r, *_ = tba._edge_terms_center(
        t["poses"], t["ctr"], *map(torch.tensor, INTR),
        torch.zeros((E, 2)), torch.as_tensor(ii), torch.as_tensor(jj),
        torch.as_tensor(kk))
    target = (-r.numpy() + rng.normal(size=(E, 2))).astype(np.float32)
    weight = rng.uniform(0.2, 1.0, (E, 2)).astype(np.float32)
    valid = np.arange(E) < E - masked

    def d(a):
        return torch.as_tensor(a).to(device)

    return dict(poses=d(poses), ctr=d(ctr), intrinsics=d(np.float32(INTR)),
                target=d(target), weight=d(weight), ii=d(ii), jj=d(jj),
                kk=d(kk), valid=d(valid), t0=t0, n_cap=n_cap, k_cap=k_cap)


def plan_of(case):
    """``ba_iterative``'s plan of the case's edges."""
    c = case
    return tba._edge_plan(c["ii"], c["jj"], c["kk"], c["valid"], c["target"],
                          c["weight"], c["t0"], c["n_cap"], c["k_cap"],
                          c["ctr"].shape[0])[0]


def dense_normal_equations(poses, ctr, intrinsics, pl, t0):
    """The one-hot form ``ba_iterative`` used before ``ba_cuda``: B (D, D),
    v (D,), and the coupling rows [E | C | u] (k_cap, D + 2) summed by
    patch rank (``index_add_``; on the card ``chip_smoke.py`` times it as
    the kernel's yardstick)."""
    n_cap, k_cap = pl.n_cap, pl.k_cap
    D = 6 * n_cap
    ii, jj, kk, pair = pl.edges.long().unbind(1)
    valid = ba_cuda.unpack(pair, n_cap)[2]
    target, weight = pl.tw[:, :2], pl.tw[:, 2:]
    fx, fy, cx, cy = intrinsics.unbind()
    r, mask, Ji, Jj, Jz = tba._edge_terms_center(poses, ctr, fx, fy, cx, cy,
                                                 target, ii, jj, kk)
    w = mask[:, None] * weight * valid[:, None]
    cols = torch.arange(n_cap, device=poses.device)
    li, lj = ii - t0, jj - t0
    vi = (li >= 0) & (li < n_cap) & valid
    vj = (lj >= 0) & (lj < n_cap) & valid
    oh_i = ((li.clamp(0, n_cap - 1)[:, None] == cols) & vi[:, None]).float()
    oh_j = ((lj.clamp(0, n_cap - 1)[:, None] == cols) & vj[:, None]).float()
    E = ii.shape[0]
    Jeff = (-oh_i[:, None, :, None] * Ji[:, :, None, :]
            + oh_j[:, None, :, None] * Jj[:, :, None, :]).reshape(E, 2, D)
    wJeff = w[:, :, None] * Jeff
    B = wJeff.reshape(-1, D).t() @ Jeff.reshape(-1, D)
    v = torch.einsum("era,er->a", wJeff, r)
    A = torch.einsum("er,era->ea", w * Jz, Jeff)
    Cu = torch.stack([(w * Jz * Jz).sum(1), (w * r * Jz).sum(1)], dim=-1)
    rows = torch.zeros((k_cap + 1, D + 2), device=poses.device)
    rows.index_add_(0, pl.gid.long().clamp(max=k_cap),
                    torch.cat([A, Cu], dim=1))
    return B, v, rows[:k_cap]


def excess(got, plain, ref, n_cap, floor=1e-6):
    """How far the kernel's tables ``got`` lie from ``ref`` (the plain
    version in fp64) against the fp32 plain version's own distance
    ``plain``: per column group of each table, max|got - ref| over
    4 max|plain - ref| + floor max|ref|; -> the largest (1 is the limit).
    A measure of the kernel's rounding against the plain version's, since
    fp32 rounds some sums by far more than their order: a residual is a
    difference of pixel coordinates in the hundreds (~1e-5 px of rounding
    on a one-pixel residual), and a frame pair's gradient sums cancel
    (the fp32 plain version reads up to 2e-4 of a group's largest entry
    against fp64 at 45312 edges, the Jacobian products 1e-6)."""
    D = 6 * n_cap
    groups = ((0, 0, D), (0, D, D + 1), (0, D + 1, D + 2), (1, 0, 36),
              (1, 36, 42), (1, 42, 78), (1, 78, 84), (1, 84, 120))
    worst = 0.0
    for t, lo, hi in groups:
        r = ref[t][:, lo:hi]
        err = (got[t][:, lo:hi].double() - r).abs().max().item()
        own = (plain[t][:, lo:hi].double() - r).abs().max().item()
        limit = 4 * own + floor * r.abs().max().item()
        worst = max(worst, err / limit if limit > 0
                    else (float("inf") if err > 0 else 0.0))
    return worst


def fp64(case):
    """The case's float inputs in fp64, for the plain version's
    reference."""
    return case["poses"].double(), case["ctr"].double(), \
        case["intrinsics"].double()


def close(got, want, rel=1e-5):
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= rel * max(scale, 1e-30), (err, scale)


@pytest.mark.parametrize("name", list(CASES))
def test_ba_blocks_plain_vs_dense_one_hot(name):
    case = ba_case(**CASES[name])
    pl = plan_of(case)
    ecu, blocks = ba_cuda.ba_blocks(case["poses"], case["ctr"],
                                    case["intrinsics"], pl)
    B, v = ba_cuda.assemble(blocks, pl.n_cap)
    B_d, v_d, rows_d = dense_normal_equations(
        case["poses"], case["ctr"], case["intrinsics"], pl, case["t0"])
    assert ecu.shape == rows_d.shape
    assert blocks.shape == ((pl.n_cap + 1) ** 2, ba_cuda.COLS)
    close(ecu, rows_d)
    if name == "no_free_pose":
        assert not B.any() and not v.any() and not blocks.any()
        assert not ecu[:, :-2].any() and ecu[:, -2].any()
        return
    close(B, B_d)
    close(v, v_d)
    # every kind of row counts: self-edges, frames outside the window on
    # either side, masked rows last
    a, b, live = ba_cuda.unpack(pl.edges[:, 3].long(), pl.n_cap)
    S = pl.n_cap
    assert (pl.edges[live, 0] == pl.edges[live, 1]).any()
    assert ((a[live] == S) & (b[live] < S)).any()
    assert ((a[live] < S) & (b[live] == S)).any()
    assert not live[-64:].any() and live[:-64].all()


@pytest.mark.parametrize("name", ["n16", "past_k_cap"])
def test_ba_plan_runs(name):
    """The plan's rows sorted by patch with the masked rows last, each
    edge's window blocks (ii - t0 and jj - t0 inside [0, n_cap), else
    n_cap), each patch rank's run up to ``pstart[k_cap]``, and ``kperm``
    grouping the rows by window frame pair, kk order within a pair, the
    masked rows and the pair outside the window in the last, dropped
    key."""
    case = ba_case(**CASES[name])
    pl = plan_of(case)
    ii, jj, kk, pair = pl.edges.long().unbind(1)
    a, b, valid = ba_cuda.unpack(pair, pl.n_cap)
    S, n1, k_cap = pl.n_cap, pl.n_cap + 1, pl.k_cap
    kk_m = torch.where(valid, kk, tba.INT_MAX)
    assert (torch.diff(kk_m) >= 0).all() and not valid[-64:].any()

    def block(x):
        li = x - case["t0"]
        return torch.where(valid & (li >= 0) & (li < S), li, S)

    assert torch.equal(a, block(ii)) and torch.equal(b, block(jj))
    assert torch.equal(pair, torch.where(valid, a * n1 + b, n1 * n1))
    gid = pl.gid.long()
    g = torch.arange(k_cap)
    lo, hi = pl.pstart[:-1].long(), pl.pstart[1:].long()
    assert torch.equal(lo, torch.searchsorted(gid, g))
    assert torch.equal(hi - lo, torch.bincount(gid[gid < k_cap],
                                               minlength=k_cap))
    key = pair
    perm = pl.kperm.long()
    assert torch.equal(perm, torch.sort(key, stable=True).indices)
    assert torch.equal(pl.kstart.long(), torch.searchsorted(
        key[perm], torch.arange(n1 * n1 + 1)))


def test_ba_blocks_refuses_a_wide_window():
    case = ba_case(**CASES["n4"])
    with pytest.raises(ValueError, match="n_cap=64"):
        tba._edge_plan(case["ii"], case["jj"], case["kk"], case["valid"],
                       case["target"], case["weight"], 0, 64, 256, 384)
