"""The port's proximity loop closure and global BA against the JAX package
on CPU, at toy sizes.

- ``ops.scatter.compactify`` equals JAX's on random ids: unique count
  below ``size``, exactly ``size``, past it, all ids invalid, no rows.
- ``ops.ba.ba_global`` against ``dpvo_tpu.ops.ba.ba_global`` on
  tests/test_ba.py's scene (8 frames, some edges invalid, uneven weights,
  perturbed poses and depths) at ``n_cap=64``, the branch the engine takes,
  with a roomy ``k_cap`` and with ``k_cap`` exactly the live patch count
  (the invalid edges' slot falls past the end).  The patch table has one
  spare frame: JAX's depth write sends every padded slot to the last patch
  row, so a live last row would read a scatter conflict there
  (ROADMAP Queue 3).
- ``reduce_edges`` and ``propose_loop_edges`` exactly equal to JAX's on a
  scripted 45-keyframe state, with every pair under the threshold and with
  a threshold that drops some.
- ``engine.kernels``' ``normalize_scene``, ``store_inactive`` and
  ``concat_edge_tw`` against JAX's.
- The engine's update capacity covers loop edges, and why: ``ba_iterative``
  (JAX's and the port's alike) leaves the newest patches out of the solve
  when the live patches outnumber ``k_cap``.
- A port-only drive of 45 frames (``M=8``, ``REMOVAL_WINDOW=6``,
  ``GLOBAL_OPT_FREQ=10``; ``chip_smoke.py``'s loop-closure drive) reaches
  proposals and ``ba_global``; the inputs of its first ``ba_global`` call go
  through JAX's ``ba_global``.

The engine against one JAX drive is tests/test_torch_lc_engine.py.

Tolerances for ``ba_global`` (fp32): poses atol 2e-4, as tests/test_ba.py
holds ``ba_global`` to ``ba_iterative``.  Depths atol 1e-3: 48 CG
iterations in fp32 reassociate every segment sum (``index_add_`` here,
``segment_sum`` there), and the weakly observable depth direction (C ~
lmbda for a patch with few valid edges) amplifies that; the scene reads
2.4e-4 at most, the engine's inputs less.
"""
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dpvo_tpu.config import VOConfig as JaxConfig
from dpvo_tpu.engine import kernels as jkernels
from dpvo_tpu.loop_closure import proximity as jprox
from dpvo_tpu.ops import ba as jba, lie as jlie, scatter as jscatter
from dpvo_tpu_torch.config import VOConfig
from dpvo_tpu_torch.engine import DPVO, kernels
from dpvo_tpu_torch.engine.state import allocate
from dpvo_tpu_torch.loop_closure import proximity as tprox
from dpvo_tpu_torch.ops import ba as tba, scatter as tscatter
from test_ba import KEY, build_problem
from test_torch_engine import DEPTH0, INTR, TINY, centroid_grid

torch.set_num_threads(1)

INT_MAX = np.iinfo(np.int32).max
ATOL_POSE, ATOL_DEPTH = 2e-4, 1e-3


def t(a):
    return torch.from_numpy(np.array(a))


# --- compactify --------------------------------------------------------------

def _ids(case, rng):
    if case == "below":
        return rng.integers(0, 40, 50), 64
    if case == "exact":           # 31 ids and the invalid one fill 32 slots
        return np.concatenate([rng.permutation(31), np.full(9, INT_MAX)]), 32
    if case == "past":            # 28 uniques into 20 slots
        return rng.integers(0, 40, 50), 20
    if case == "all_invalid":
        return np.full(30, INT_MAX), 16
    return np.zeros(0), 8          # no rows


@pytest.mark.parametrize("case", ["below", "exact", "past", "all_invalid",
                                  "empty"])
def test_compactify_matches_jax(case):
    ix, size = _ids(case, np.random.default_rng(0))
    ix = ix.astype(np.int32)
    kx, ku = jscatter.compactify(jnp.asarray(ix), size)
    kx_t, ku_t = tscatter.compactify(t(ix), size)
    np.testing.assert_array_equal(kx_t.numpy(), np.asarray(kx))
    np.testing.assert_array_equal(ku_t.numpy(), np.asarray(ku))


# --- ba_global ---------------------------------------------------------------

@pytest.fixture(scope="module")
def ba_scene():
    poses_gt, patches_gt, intr, _, target, ii, jj, kk = build_problem(
        KEY, n_frames=8)
    n = poses_gt.shape[0]
    noise = jax.random.normal(jax.random.PRNGKey(5), (n, 6)) * 0.02
    poses0 = np.asarray(jlie.se3_retr(poses_gt, noise.at[:2].set(0.0)))
    rng = np.random.default_rng(0)
    E = ii.shape[0]
    weight = rng.uniform(0.2, 1.0, (E, 2)).astype(np.float32)
    valid = np.ones(E, bool)
    valid[::7] = False
    patches = np.array(patches_gt)
    patches[:, 2] *= rng.uniform(0.9, 1.1, (len(patches), 1, 1))
    spare = np.zeros((24,) + patches.shape[1:], np.float32)
    patches = np.concatenate([patches, spare + 1.0])
    return (poses0, patches, np.asarray(intr), np.asarray(target), weight,
            np.asarray(ii, np.int32), np.asarray(jj, np.int32),
            np.asarray(kk, np.int32), valid, n)


def _ba_global_both(poses, patches, intr, target, weight, ii, jj, kk, valid,
                    t0, t1, n_cap, k_cap):
    want = jba.ba_global(
        jnp.asarray(poses), jnp.asarray(patches), jnp.asarray(intr),
        jnp.asarray(target), jnp.asarray(weight), jnp.float32(1e-4),
        jnp.asarray(ii), jnp.asarray(jj), jnp.asarray(kk), jnp.asarray(valid),
        jnp.int32(t0), jnp.int32(t1), n_cap=n_cap, k_cap=k_cap)
    got = tba.ba_global(t(poses), t(patches), t(intr), t(target), t(weight),
                        1e-4, t(ii), t(jj), t(kk), t(valid), t0, t1,
                        n_cap=n_cap, k_cap=k_cap)
    return [np.asarray(a) for a in want], [a.numpy() for a in got]


@pytest.mark.parametrize("fill", ["roomy", "full"])
def test_ba_global_matches_jax(ba_scene, fill):
    poses, patches, intr, target, weight, ii, jj, kk, valid, n = ba_scene
    live = len(np.unique(kk[valid]))
    k_cap = 256 if fill == "roomy" else live
    (p_want, z_want), (p_got, z_got) = _ba_global_both(
        poses, patches, intr, target, weight, ii, jj, kk, valid, 1, n,
        n_cap=64, k_cap=k_cap)
    assert np.abs(p_want - poses).max() > 1e-3      # BA moved the poses
    np.testing.assert_allclose(p_got, p_want, atol=ATOL_POSE)
    np.testing.assert_allclose(z_got, z_want, atol=ATOL_DEPTH)
    np.testing.assert_array_equal(p_got[:1], poses[:1])


# --- proposals ---------------------------------------------------------------

def test_reduce_edges_matches_jax():
    rng = np.random.default_rng(3)
    E = 400
    ii = rng.integers(0, 40, E)
    jj = rng.integers(30, 80, E)
    mag = rng.uniform(0, 10, E).round(1)        # ties included
    want = jprox.reduce_edges(mag, ii, jj, max_num_edges=25, nms=1)
    got = tprox.reduce_edges(mag, ii, jj, max_num_edges=25, nms=1)
    assert len(want) == 25
    np.testing.assert_array_equal(got, want)


def _scripted_state(N=64, M=8, P=3):
    rng = np.random.default_rng(7)
    xi = (rng.normal(size=(N, 6)) * np.array([0.02, 0.02, 0.02, 0.01, 0.01,
                                              0.01])).astype(np.float32)
    xi[:, 0] += 0.3 * np.sin(np.arange(N) / 6.0)
    xi[:, 2] += 0.3 * np.cos(np.arange(N) / 6.0)
    poses = np.asarray(jlie.se3_exp(jnp.asarray(xi)))
    K = N * M
    off = np.arange(P, dtype=np.float32) - 1
    cx = rng.uniform(2, 30, (K, 1, 1))
    cy = rng.uniform(2, 22, (K, 1, 1))
    d = rng.uniform(0.3, 1.5, (K, 1, 1))
    patches = np.stack([np.broadcast_to(cx + off[None, None, :], (K, P, P)),
                        np.broadcast_to(cy + off[None, :, None], (K, P, P)),
                        np.broadcast_to(d, (K, P, P))], 1).astype(np.float32)
    intr = np.tile(np.array([[16.0, 16.0, 16.0, 12.0]], np.float32), (N, 1))
    return poses, patches, intr


@pytest.mark.parametrize("thresh,pairs", [(1e9, 13), (2.0, 6)])
def test_propose_loop_edges_matches_jax(thresh, pairs):
    M, n = 8, 45
    poses, patches, intr = _scripted_state(M=M)
    kw = dict(PATCHES_PER_FRAME=M, REMOVAL_WINDOW=6, KEYFRAME_INDEX=4,
              GLOBAL_OPT_FREQ=10, MAX_EDGE_AGE=64, BACKEND_THRESH=thresh)
    js = SimpleNamespace(cfg=JaxConfig(**kw), M=M, n=n, ds=SimpleNamespace(
        poses=jnp.asarray(poses), patches=jnp.asarray(patches),
        intrinsics=jnp.asarray(intr)))
    ts = SimpleNamespace(cfg=VOConfig(**kw), M=M, n=n, ds=SimpleNamespace(
        poses=t(poses), patches=t(patches), intrinsics=t(intr)))
    kk_want, jj_want = jprox.propose_loop_edges(js)
    kk_got, jj_got = tprox.propose_loop_edges(ts)
    assert len(kk_want) == pairs * M
    np.testing.assert_array_equal(kk_got, kk_want)
    np.testing.assert_array_equal(jj_got, jj_want)
    assert kk_got.dtype == jj_got.dtype == np.int32


# --- device functions of the inactive store and the rescale -----------------

def _device_state(seed=0, N=16, M=4, E=64, E_inac=96):
    cfg = VOConfig(BUFFER_SIZE=N, PATCHES_PER_FRAME=M, EDGE_CAPACITY=E,
                   EDGE_CAPACITY_INAC=E_inac, MIXED_PRECISION=False)
    ds = allocate(cfg, 32, 32, 3, 4, 4, torch.device("cpu"), torch.float32)
    rng = np.random.default_rng(seed)
    xi = rng.normal(size=(N, 6)).astype(np.float32) * 0.3
    ds.poses[:] = t(np.asarray(jlie.se3_exp(jnp.asarray(xi))))
    ds.patches[:] = t(rng.uniform(0.2, 1.5, ds.patches.shape)
                      .astype(np.float32))
    for name in ("target", "weight", "target_inac", "weight_inac"):
        getattr(ds, name)[:] = t(rng.normal(size=getattr(ds, name).shape)
                                 .astype(np.float32))
    return ds


def test_normalize_scene_matches_jax():
    ds = _device_state()
    n, M = 11, 4
    poses, patches = ds.poses.numpy().copy(), ds.patches.numpy().copy()
    p_want, z_want, s_want = jkernels.normalize_scene(
        jnp.asarray(poses), jnp.asarray(patches), jnp.int32(n), M=M)
    s_got = kernels.normalize_scene(ds, n, M)
    assert s_got.shape == ()
    np.testing.assert_allclose(float(s_got), float(s_want), rtol=1e-6)
    np.testing.assert_allclose(ds.poses.numpy(), np.asarray(p_want),
                               atol=1e-5)
    np.testing.assert_allclose(ds.patches.numpy(), np.asarray(z_want),
                               rtol=1e-6)
    np.testing.assert_array_equal(ds.poses.numpy()[n:], poses[n:])
    # a scene with no live depth keeps its scale
    ds = _device_state()
    ds.patches[:, 2] = 0.0
    assert float(kernels.normalize_scene(ds, n, M)) == 1.0


def test_store_inactive_and_concat_edge_tw_match_jax():
    ds = _device_state(seed=1)
    idx = np.array([5, 0, 17, 3, 40], np.int64)
    dest = 7
    tab = {k: getattr(ds, k).numpy().copy()
           for k in ("target", "weight", "target_inac", "weight_inac")}
    chunk = 32
    idx_p = np.zeros(chunk, np.int32)
    idx_p[:len(idx)] = idx
    t_want, w_want = jkernels.store_inactive(
        jnp.asarray(tab["target"]), jnp.asarray(tab["weight"]),
        jnp.asarray(tab["target_inac"]), jnp.asarray(tab["weight_inac"]),
        idx_p, np.int32(dest), chunk=chunk)
    kernels.store_inactive(ds, t(idx), dest)
    live = slice(0, dest + len(idx))      # JAX's pad rows are not live
    np.testing.assert_array_equal(ds.target_inac.numpy()[live],
                                  np.asarray(t_want)[live])
    np.testing.assert_array_equal(ds.weight_inac.numpy()[live],
                                  np.asarray(w_want)[live])
    np.testing.assert_array_equal(ds.target_inac.numpy()[dest + len(idx):],
                                  tab["target_inac"][dest + len(idx):])

    n_inac, e, cap = dest + len(idx), 23, 64
    want = jkernels.concat_edge_tw(
        jnp.asarray(ds.target_inac.numpy()), jnp.asarray(ds.weight_inac
                                                         .numpy()),
        jnp.asarray(tab["target"]), jnp.asarray(tab["weight"]),
        np.int32(n_inac), np.int32(e), cap=cap)
    got = kernels.concat_edge_tw(ds, n_inac, e, cap)
    for g, w in zip(got, want):
        assert g.shape == (cap, 2)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# --- the engine's capacities under loop closure ------------------------------

def test_update_patch_capacity_covers_loop_edges():
    """An update's patch groups (k_cap + 8) cover every patch of every
    frame the live edges leave from: loop edges reach old frames, which a
    capacity from the removal window alone does not hold."""
    cfg = {**TINY, "REMOVAL_WINDOW": 6, "MAX_EDGE_AGE": 64}
    plain = DPVO(VOConfig(**cfg), ht=96, wd=128, device="cpu")
    slam = DPVO(VOConfig(**cfg, LOOP_CLOSURE=True), ht=96, wd=128,
                device="cpu")
    M, hs = slam.M, slam.hs
    hs.e_num = 500
    hs.ii[:500] = np.arange(500) % 12          # the window's 12 frames
    assert slam._update_k_cap() == plain._update_k_cap() == slam.k_cap
    hs.ii[:500] = np.arange(500) % 50          # loop edges from 50 frames
    assert slam._update_k_cap() + 8 >= 50 * M > slam.k_cap + 8
    plain.hs.e_num, plain.hs.ii[:500] = 500, hs.ii[:500]
    assert plain._update_k_cap() == plain.k_cap


def test_local_ba_past_k_cap_leaves_the_newest_patches(ba_scene):
    """Why the engine sizes an update's patch capacity from its live edges.
    ``ba_iterative`` gives the first ``k_cap`` patches in kk order a slot
    and leaves the rest out of the solve: with more live patches than
    ``k_cap`` (loop edges from old frames, under the JAX engine's capacity
    from the removal window) JAX's local BA keeps the newest patches'
    depths as they were and solves the poses without them.  The port's
    ``ba_iterative`` does the same at the same ``k_cap`` and agrees with
    JAX at a ``k_cap`` that holds every patch (tests/test_torch_ba.py's
    tolerances: poses 1e-4, depths 3e-4)."""
    poses, patches, intr, target, weight, ii, jj, kk, valid, n = ba_scene
    live = np.unique(kk[valid])
    small, roomy = 128, 256
    assert small < len(live) <= roomy
    out = {}
    for k_cap in (small, roomy):
        want = jba.ba_iterative(
            jnp.asarray(poses), jnp.asarray(patches), jnp.asarray(intr),
            jnp.asarray(target), jnp.asarray(weight), jnp.float32(1e-4),
            jnp.asarray(ii), jnp.asarray(jj), jnp.asarray(kk),
            jnp.asarray(valid), jnp.int32(1), jnp.int32(n), n_cap=8,
            k_cap=k_cap)
        got = tba.ba_iterative(t(poses), t(patches), t(intr), t(target),
                               t(weight), 1e-4, t(ii), t(jj), t(kk),
                               t(valid), 1, n, n_cap=8, k_cap=k_cap)
        want = [np.asarray(a) for a in want]
        np.testing.assert_allclose(got[0].numpy(), want[0], atol=1e-4)
        np.testing.assert_allclose(got[1].numpy(), want[1], atol=3e-4)
        out[k_cap] = want
    newest = live[small:]                    # past the small capacity
    np.testing.assert_array_equal(out[small][1][newest], patches[newest])
    assert np.abs(out[roomy][1][newest, 2]
                  - patches[newest, 2]).max() > 5e-2
    assert np.abs(out[small][0] - out[roomy][0]).max() > 1e-2


# --- a port-only drive that reaches proposals and ba_global ------------------

def test_lc_drive_reaches_ba_global(monkeypatch):
    """45 frames at chip_smoke.py's loop-closure settings: proposals land
    and global BA takes ``ba_global``; its first call's inputs give JAX's
    result."""
    M, ht, wd = 8, 96, 128
    cfg = VOConfig(**{**TINY, "REMOVAL_WINDOW": 6, "LOOP_CLOSURE": True,
                      "GLOBAL_OPT_FREQ": 10, "BACKEND_THRESH": 1e9,
                      "MAX_EDGE_AGE": 64, "EDGE_CAPACITY": 2048,
                      "KEYFRAME_THRESH": 0.0})
    slam = DPVO(cfg, ht=ht, wd=wd, device="cpu", seed=0)
    slam.motion_probe = lambda: 100.0
    slam.test_centroids = centroid_grid
    slam.test_fixed_depth = DEPTH0
    calls, proposals = [], []
    ba_global = tba.ba_global

    def capture(*args, **kw):
        calls.append(([a.clone() if torch.is_tensor(a) else a
                       for a in args], kw))
        return ba_global(*args, **kw)

    monkeypatch.setattr(tba, "ba_global", capture)
    edges_loop = slam.edges_loop

    def record():
        kk, jj = edges_loop()
        if len(kk):
            proposals.append((slam.n, len(kk) // M))
        return kk, jj

    slam.edges_loop = record
    base = np.random.default_rng(11).integers(0, 255, (ht, 2 * wd, 3),
                                              dtype=np.uint8)
    for i in range(45):
        slam(i, np.ascontiguousarray(np.roll(base, -3 * i, 1)[:, :wd]), INTR)
    assert proposals and calls, (proposals, len(calls))
    assert torch.isfinite(slam.ds.poses[:slam.n]).all()

    args, kw = calls[0]
    (poses, patches, intr, target, weight, _, ii, jj, kk, valid, t0,
     t1) = args
    assert kw["n_cap"] >= 64 and valid.sum() > 1000
    (p_want, z_want), (p_got, z_got) = _ba_global_both(
        poses.numpy(), patches.numpy(), intr.numpy(), target.numpy(),
        weight.numpy(), *(a.numpy().astype(np.int32) for a in (ii, jj, kk)),
        valid.numpy(), t0, t1, kw["n_cap"], kw["k_cap"])
    np.testing.assert_allclose(p_got, p_want, atol=ATOL_POSE)
    np.testing.assert_allclose(z_got, z_want, atol=ATOL_DEPTH)
