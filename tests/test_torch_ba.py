"""The port's ``ba_iterative`` against ``dpvo_tpu.ops.ba.ba_iterative`` on
CPU, on the synthetic problem of tests/test_ba.py.  The port sums per-edge
6-wide blocks per patch and per window frame pair (``ops.ba_cuda``, its
plain version here), each edge's relative pose formed from its two poses;
the JAX function forms the dense one-hot Jacobian, takes its
cumsum-difference path for the coupling and, where given, per-pair
relative poses, so this also holds the formulations against each other.

Tolerances (fp32): poses atol 1e-4; depths atol 3e-4.  The targets are
exact reprojections, so the depth direction is weakly observable
(Jz^2 ~ lmbda): fp32 rounding moves EACH implementation's depths by about
1e-4 from a float64 evaluation of the same algorithm on this problem, in
different directions, so the two can differ by about twice that.

The sync-free form (``compactify``'s slots over the edge sort, device-scalar
t0/t1) is held bitwise against the slots ``ba_iterative`` built before with
``torch.nonzero`` and boolean-mask writes (kept here as the reference), with
masked rows and with patches past ``k_cap``.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dpvo_tpu.ops import ba as jba, lie as jlie
from dpvo_tpu_torch.ops import ba as tba
from test_ba import KEY, build_problem

torch.set_num_threads(1)
ATOL_POSE = 1e-4
ATOL_DEPTH = 3e-4


def t(a):
    return torch.from_numpy(np.array(a))


def _pair_meta(ii, jj):
    pair = np.asarray(ii) * 12345 + np.asarray(jj)
    uniq, gid = np.unique(pair, return_inverse=True)
    rep = np.array([np.argmax(gid == g) for g in range(len(uniq))] + [0] * 3,
                   np.int32)
    return gid.astype(np.int32), len(uniq) + 3, rep


def _run_both(poses0, patches0, intr, target, weight, ii, jj, kk, valid,
              t0, t1, n_cap, k_cap, iterations, **pair):
    want = jba.ba_iterative(
        poses0, patches0, intr, target, jnp.asarray(weight), 1e-4, ii, jj,
        kk, jnp.asarray(valid), jnp.int32(t0), jnp.int32(t1), n_cap=n_cap,
        k_cap=k_cap, iterations=iterations,
        **{k: (jnp.asarray(v) if k != "pair_cap" else v)
           for k, v in pair.items()})
    got = tba.ba_iterative(
        t(poses0), t(patches0), t(intr), t(target), t(weight), 1e-4, t(ii),
        t(jj), t(kk), t(valid), t0, t1, n_cap=n_cap, k_cap=k_cap,
        iterations=iterations)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=ATOL_POSE)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=ATOL_DEPTH)
    return got


@pytest.mark.parametrize("n_invalid,pair", [(0, False), (7, False),
                                            (0, True), (7, True)])
def test_ba_perturbed_poses(n_invalid, pair):
    poses_gt, patches_gt, intr, _, target, ii, jj, kk = build_problem(KEY)
    n = poses_gt.shape[0]
    noise = jax.random.normal(jax.random.PRNGKey(5), (n, 6)) * 0.02
    poses0 = jlie.se3_retr(poses_gt, noise.at[:2].set(0.0))
    E = ii.shape[0]
    valid = np.arange(E) < E - n_invalid
    weight = np.ones((E, 2), np.float32)
    kw = {}
    if pair:
        gid, cap, rep = _pair_meta(ii, jj)
        kw = dict(pair_gid=gid, pair_cap=cap, pair_rep=rep)
    got = _run_both(poses0, patches_gt, intr, target, weight, ii, jj, kk,
                    valid, 1, n, n_cap=8, k_cap=256, iterations=2, **kw)
    assert np.isfinite(got[0].numpy()).all()


def test_ba_fixed_and_structure_only_windows():
    poses_gt, patches_gt, intr, _, target, ii, jj, kk = build_problem(
        KEY, n_frames=5, patches_per_frame=8)
    E = ii.shape[0]
    noise = jax.random.normal(jax.random.PRNGKey(7), (5, 6)) * 0.03
    poses0 = jlie.se3_retr(poses_gt, noise)
    ones = np.ones((E, 2), np.float32)
    valid = np.ones(E, bool)
    p, _ = _run_both(poses0, patches_gt, intr, target, ones, ii, jj, kk,
                     valid, 2, 5, n_cap=4, k_cap=64, iterations=2)
    np.testing.assert_array_equal(p[:2].numpy(), np.asarray(poses0[:2]))
    # t1 == t0: only depths move
    patches0 = patches_gt.at[:, 2].multiply(1.3)
    p, _ = _run_both(poses_gt, patches0, intr, target, ones, ii, jj, kk,
                     valid, 5, 5, n_cap=4, k_cap=64, iterations=2)
    np.testing.assert_array_equal(p.numpy(), np.asarray(poses_gt))


def test_ba_failed_solve_skips_update():
    """A non-finite system never raises and leaves the state as it was."""
    poses_gt, patches_gt, intr, _, target, ii, jj, kk = build_problem(
        KEY, n_frames=4, patches_per_frame=8)
    E = ii.shape[0]
    weight = np.full((E, 2), np.nan, np.float32)
    p, z = tba.ba_iterative(t(poses_gt), t(patches_gt), t(intr), t(target),
                            t(weight), 1e-4, t(ii), t(jj), t(kk),
                            torch.ones(E, dtype=torch.bool), 1, 4, n_cap=4,
                            k_cap=64, iterations=2)
    np.testing.assert_array_equal(p.numpy(), np.asarray(poses_gt))
    np.testing.assert_array_equal(z.numpy(), np.asarray(patches_gt))


def _nonzero_slots(kk_m, eperm, k_cap, K):
    """The depth slots as ``ba_iterative`` made them before it ran free of
    host synchronisation: ``torch.nonzero`` over the run heads of the
    sorted ids and boolean-mask writes (the old results)."""
    kk_m = kk_m[eperm]
    E = kk_m.shape[0]
    new_run = torch.ones(E, dtype=torch.bool)
    new_run[1:] = kk_m[1:] != kk_m[:-1]
    gid = torch.cumsum(new_run, 0, dtype=torch.int32) - 1
    first = torch.nonzero(new_run).squeeze(1)
    g_first = gid[first].long()
    keep = g_first < k_cap
    kx = torch.full((k_cap,), tba.INT_MAX, dtype=torch.int64)
    kx[g_first[keep]] = kk_m[first[keep]]
    slot = torch.arange(k_cap)
    hit = kx < K
    slot_of_k = torch.zeros(K, dtype=torch.int64)
    slot_of_k[kx[hit]] = slot[hit]
    hit_k = torch.zeros(K, dtype=torch.bool)
    hit_k[kx[hit]] = True
    return gid, kx, slot_of_k, hit_k


@pytest.mark.parametrize("n_invalid,k_cap", [(0, 256), (7, 256), (0, 128),
                                             (7, 128)])
def test_ba_sync_free_matches_the_old_results(monkeypatch, n_invalid,
                                              k_cap):
    """``ba_iterative`` with device-scalar t0/t1 and ``compactify``'s slots
    against itself with host ints and the old ``nonzero`` slots (bitwise),
    and against JAX; masked rows and, at k_cap 128 (144 patches), patches
    past the depth capacity (left out of the solve)."""
    poses_gt, patches_gt, intr, _, target, ii, jj, kk = build_problem(KEY)
    n = poses_gt.shape[0]
    noise = jax.random.normal(jax.random.PRNGKey(5), (n, 6)) * 0.02
    poses0 = jlie.se3_retr(poses_gt, noise.at[:2].set(0.0))
    E = ii.shape[0]
    valid = np.arange(E) < E - n_invalid
    weight = np.ones((E, 2), np.float32)
    args = (t(poses0), t(patches_gt), t(intr), t(target), t(weight), 1e-4,
            t(ii), t(jj), t(kk), t(valid))
    kw = dict(n_cap=8, k_cap=k_cap, iterations=2)
    # the slots themselves: the old ranks folded at k_cap, the rest equal
    kk_m = torch.where(t(valid), t(kk).long(), tba.INT_MAX)
    eperm = torch.sort(kk_m, stable=True).indices
    K = patches_gt.shape[0]
    new = tba._patch_slots(kk_m, eperm, k_cap, K)
    old = _nonzero_slots(kk_m, eperm, k_cap, K)
    assert torch.equal(new[0], old[0].clamp(max=k_cap))
    for a, b in zip(new[1:], old[1:]):
        assert torch.equal(a, b)
    got = tba.ba_iterative(*args, torch.tensor(1, dtype=torch.int32),
                           torch.tensor(n, dtype=torch.int32), **kw)
    monkeypatch.setattr(tba, "_patch_slots", _nonzero_slots)
    want = tba.ba_iterative(*args, 1, n, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    ref = jba.ba_iterative(
        poses0, patches_gt, intr, target, jnp.asarray(weight), 1e-4, ii, jj,
        kk, jnp.asarray(valid), jnp.int32(1), jnp.int32(n), **kw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                               atol=ATOL_POSE)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                               atol=ATOL_DEPTH)


@pytest.mark.parametrize("k_cap", [256, 128])
def test_ba_masked_rows_are_a_group_each(monkeypatch, k_cap):
    """The patch ranks ``ba_iterative`` hands ``ba_cuda.ba_blocks`` (its
    plain version here) when rows are masked: dense from 0 with steps of at
    most 1, the live rows' ranks those of the sort, and the masked tail a
    group per row, so no warp walks the whole tail.  The results are
    bitwise those of the tail summed as one group of zero-weight rows;
    at k_cap 128 live patches also fall past the depth capacity."""
    from dpvo_tpu_torch.ops import agg_cuda, ba_cuda
    poses_gt, patches_gt, intr, _, target, ii, jj, kk = build_problem(KEY)
    n = poses_gt.shape[0]
    noise = jax.random.normal(jax.random.PRNGKey(5), (n, 6)) * 0.02
    poses0 = jlie.se3_retr(poses_gt, noise.at[:2].set(0.0))
    E, n_masked = ii.shape[0], 9
    valid = np.arange(E) < E - n_masked
    args = (t(poses0), t(patches_gt), t(intr), t(target),
            t(np.ones((E, 2), np.float32)), 1e-4, t(ii), t(jj), t(kk),
            t(valid), 1, n)
    kw = dict(n_cap=8, k_cap=k_cap, iterations=2)
    ranks, plain = [], ba_cuda.ba_blocks_plain

    def recorded(poses, ctr, intrinsics, pl):
        ranks.append(pl.gid.clone())
        return plain(poses, ctr, intrinsics, pl)

    monkeypatch.setattr(ba_cuda, "ba_blocks_plain", recorded)
    got = tba.ba_iterative(*args, **kw)
    gid = ranks[-1].long()
    steps = torch.diff(gid)
    assert gid[0] == 0 and ((steps == 0) | (steps == 1)).all()
    # past k_cap the first masked row shares the folded slot k_cap, which
    # the solve drops
    assert (steps[-(n_masked - 1):] == 1).all()
    kk_m = torch.where(t(valid), t(kk).long(), tba.INT_MAX)
    head = torch.ones(E, dtype=torch.bool)
    s = torch.sort(kk_m, stable=True).values
    head[1:] = s[1:] != s[:-1]
    live = (torch.cumsum(head, 0) - 1)[:E - n_masked].clamp(max=k_cap)
    assert torch.equal(gid[:E - n_masked], live)
    monkeypatch.setattr(agg_cuda, "split_masked", lambda g, v: g)
    want = tba.ba_iterative(*args, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
