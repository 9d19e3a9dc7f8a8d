"""Edge-sharded inference of the port (``dpvo_tpu_torch.parallel``) on the
CPU, two gloo ranks spawned by ``parallel.launch.spawn``, against the JAX
package's ``make_sharded_update_step`` on a 2-device mesh of the conftest's
8 CPU devices (same partition) and against the port's single-device
``engine.kernels.update_step``, at tests/test_infer_sharded.py's
tolerances (poses atol 1e-4 / rtol 2e-4, depths 2e-3 / 5e-4, net, delta
and weight 5e-4 / 1e-3, target 5e-3 / 1e-3).  The pieces are held against
the JAX package's at 1e-5: SoftAgg's cross-rank form against its
``shard_axis`` path, ``ba_iterative_sharded`` against JAX's (targets at
the patch centres' reprojections plus noise); ``shard_edges_by_patch`` is
JAX's, with its invariants.

The problem is tests/test_infer_sharded.py's with the engine's padded
rings and two changes that make it well posed: three fixed frames behind
``t0`` (with one, only BA's damping holds the scale), and the newest
frame's patches pointing back (with only ii == jj edges a patch's depth
update is rounding noise times 1 / lmbda = 1e4).  As it stands there, the
JAX package's own 2-device step breaks these tolerances against its
single-device step (4 pose entries, 22 of 64 patches' depths).
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as PS

import torch_ranks
from dpvo_tpu.models.blocks import SoftAgg as JSoftAgg
from dpvo_tpu.models.update import DIM, Update as JUpdate
from dpvo_tpu.ops import ba as jba, corr_pallas as cp
from dpvo_tpu.ops import projective as jpops
from dpvo_tpu.parallel import infer_step as jis
from dpvo_tpu.parallel.mesh import make_mesh as jmesh
from dpvo_tpu_torch.engine import kernels as tk
from dpvo_tpu_torch.models.update import Update as TUpdate
from dpvo_tpu_torch.parallel import infer_step as tis, launch
from dpvo_tpu_torch.utils.checkpoint import flax_to_state_dict

torch.set_num_threads(1)

NDEV = 2
M, P = 4, 3
PMEM = MEM = 8
H, W = 24, 32
N_FRAMES = 16
N_CAP, K_CAP = 8, 64
E_LIVE = 300
SPAN = 16
N_NOW = 12
T0, T1 = N_NOW - 3, N_NOW
AGG_DIM, AGG_GROUPS = 16, 20


def _problem():
    """tests/test_infer_sharded.py's inputs (seed 0)."""
    rng = np.random.default_rng(0)
    poses = np.zeros((N_FRAMES, 7), np.float32)
    poses[:, 6] = 1.0
    poses[:, 0] = 0.05 * np.arange(N_FRAMES)
    patches = rng.uniform(2.0, 20.0,
                          (N_FRAMES * M, 3, P, P)).astype(np.float32)
    patches[:, 2] = rng.uniform(0.3, 2.0, (N_FRAMES * M, 1, 1))
    intrinsics = np.tile(np.array([[24., 24., 16., 12.]], np.float32),
                         (N_FRAMES, 1))
    imap = rng.normal(size=(PMEM * M, DIM)).astype(np.float32)
    gmap = rng.normal(size=(PMEM * M, P, P, 128)).astype(np.float32)
    fmap1 = rng.normal(size=(MEM, H, W, 128)).astype(np.float32)
    fmap2 = rng.normal(size=(MEM, H // 4, W // 4, 128)).astype(np.float32)
    kk = np.sort(rng.integers((N_NOW - 6) * M, N_NOW * M, E_LIVE)
                 ).astype(np.int32)
    ii = (kk // M).astype(np.int32)
    step = rng.integers(1, 5, E_LIVE)
    # the newest frame's patches point back, so no patch has only
    # self-edges (ii == jj), whose depth update is rounding noise
    # amplified by 1 / lmbda
    jj = np.where(ii == N_NOW - 1, ii - step,
                  np.minimum(ii + step, N_NOW - 1)).astype(np.int32)
    net = rng.normal(size=(E_LIVE, DIM)).astype(np.float32) * 0.1
    target = rng.uniform(0, 24, (E_LIVE, 2)).astype(np.float32)
    weight = rng.uniform(0, 1, (E_LIVE, 2)).astype(np.float32)
    # the rings as the engines store them: zero-padded
    fmap1 = np.asarray(cp.pad_fmap(jnp.asarray(fmap1)))
    fmap2 = np.asarray(cp.pad_fmap(jnp.asarray(fmap2)))
    return dict(poses=poses, patches=patches, intrinsics=intrinsics,
                imap=imap, gmap=gmap, fmap1=fmap1, fmap2=fmap2, net=net,
                target=target, weight=weight, ii=ii, jj=jj, kk=kk)


def _agg_problem():
    """Rows whose groups span both halves, a trash row and an empty
    group."""
    rng = np.random.default_rng(4)
    n = 64
    x = rng.normal(size=(n, AGG_DIM)).astype(np.float32)
    jx = rng.integers(0, AGG_GROUPS - 1, n).astype(np.int32)  # last empty
    valid = rng.uniform(size=n) > 0.15
    return dict(x=x, jx=jx, valid=valid, num_groups=AGG_GROUPS)


def _smap(fn, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=jmesh(NDEV, axis_name="edges"),
                                 in_specs=in_specs, out_specs=out_specs,
                                 check_vma=False))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    if len(jax.devices()) < NDEV:
        pytest.skip("needs 2 JAX devices")
    prob = _problem()
    key = jax.random.PRNGKey(0)
    jupd = JUpdate(P, dtype=jnp.float32)
    params = jupd.init(
        key, jnp.zeros((8, DIM)), jnp.zeros((8, DIM)),
        jnp.zeros((8, 2 * 49 * P * P)), jnp.zeros((8,), jnp.int32),
        jnp.zeros((8,), jnp.int32), jnp.zeros((8,), jnp.int32))
    update_sd = {k: v.numpy() for k, v in flax_to_state_dict(
        jax.tree.map(np.asarray, params["params"])).items()}

    perm, valid_s = jis.shard_edges_by_patch(prob["ii"], prob["jj"],
                                             prob["kk"], NDEV, k_cap=K_CAP)
    shard = {k: prob[k][perm] for k in ("net", "target", "weight", "ii",
                                        "jj", "kk")}
    shard["valid"] = valid_s
    upd_in = dict({k: prob[k] for k in ("poses", "patches", "intrinsics",
                                        "imap", "gmap", "fmap1",
                                        "fmap2")}, **shard, t0=T0, t1=T1)

    agg = _agg_problem()
    jagg = JSoftAgg(AGG_DIM)
    agg_params = jagg.init(jax.random.PRNGKey(1), jnp.asarray(agg["x"]),
                           jnp.asarray(agg["jx"]), AGG_GROUPS,
                           jnp.asarray(agg["valid"]))
    agg_sd = {k: v.numpy() for k, v in flax_to_state_dict(
        jax.tree.map(np.asarray, agg_params["params"])).items()}

    # BA inputs: the partition's edges, targets at the patch centres'
    # reprojections plus 0.3 px of noise, poses moved off them
    rng = np.random.default_rng(5)
    coords = jpops.transform(*(jnp.asarray(prob[k]) for k in (
        "poses", "patches", "intrinsics")), *(jnp.asarray(shard[k])
                                             for k in ("ii", "jj", "kk")))
    target = np.asarray(coords[:, P // 2, P // 2]) + rng.normal(
        scale=0.3, size=(len(perm), 2)).astype(np.float32)
    poses = prob["poses"].copy()
    poses[:, :3] += rng.normal(scale=0.01, size=(N_FRAMES, 3))
    ba_in = dict(poses=poses, patches=prob["patches"],
                 intrinsics=prob["intrinsics"][0], target=target,
                 weight=rng.uniform(0.2, 1.0, (len(perm), 2)).astype(
                     np.float32),
                 **{k: shard[k] for k in ("ii", "jj", "kk", "valid")},
                 t0=T0, t1=T1)

    cfg = {"step": dict(M=M, pmem=PMEM, mem=MEM, n_cap=N_CAP, k_cap=K_CAP,
                        span=SPAN, iterations=2),
           "ba": dict(n_cap=N_CAP, k_cap=K_CAP, iterations=2)}
    ranks = launch.spawn(
        torch_ranks.sharded_pieces, NDEV,
        (update_sd, agg_sd, {"update": upd_in, "agg": agg, "ba": ba_in},
         cfg), rendezvous_dir=str(tmp_path_factory.mktemp("rdzv")),
        timeout=300)
    return SimpleNamespace(prob=prob, params=params, jupd=jupd,
                           update_sd=update_sd, perm=perm, valid_s=valid_s,
                           upd_in=upd_in, agg=agg, jagg=jagg,
                           agg_params=agg_params, ba_in=ba_in, ranks=ranks)


def _cat(ranks, key, i=None):
    return np.concatenate([r[key] if i is None else r[key][i]
                           for r in ranks])


def _replicated(ranks, key, i):
    """A replicated output: equal on every rank; -> rank 0's."""
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[key][i], ranks[0][key][i])
    return ranks[0][key][i]


def _check_update(got, want_edges, poses_w, patches_w, rows):
    """got: (net, target, weight, delta, poses, patches) sharded rows;
    want_edges: (net, target, weight, delta) in input edge order."""
    net, target, weight, delta, poses, patches = got
    np.testing.assert_allclose(poses, poses_w, atol=1e-4, rtol=2e-4)
    bad = np.abs(patches - patches_w) > 2e-3 + 5e-4 * np.abs(patches_w)
    assert bad.any(axis=(1, 2, 3)).mean() <= 1e-3, bad.sum()
    for g, w, (atol, rtol) in zip(
            (net, target, weight, delta), want_edges,
            ((5e-4, 1e-3), (5e-3, 1e-3), (5e-4, 1e-3), (5e-4, 1e-3))):
        np.testing.assert_allclose(g[rows], w, atol=atol, rtol=rtol)


def _inverse(perm, valid_s):
    inv = np.full(E_LIVE, -1, np.int64)
    rows = np.nonzero(valid_s)[0]
    inv[perm[rows]] = rows
    assert (inv >= 0).all()
    return inv


def test_sharded_update_matches_jax_sharded(runs):
    u = runs.upd_in
    step = jis.make_sharded_update_step(
        runs.jupd, jmesh(NDEV, axis_name="edges"), M=M, pmem=PMEM, mem=MEM,
        n_cap=N_CAP, k_cap=K_CAP, span=SPAN, iterations=2)
    want = [np.asarray(o) for o in step(
        runs.params, *(jnp.asarray(u[k]) for k in (
            "poses", "patches", "intrinsics", "imap", "gmap", "fmap1",
            "fmap2", "net", "target", "weight", "ii", "jj", "kk", "valid")),
        jnp.int32(T0), jnp.int32(T1))]
    got = [_cat(runs.ranks, "update", i) for i in range(4)] + [
        _replicated(runs.ranks, "update", i) for i in (4, 5)]
    inv = _inverse(runs.perm, runs.valid_s)
    _check_update(got, [w[inv] for w in want[:4]], want[4], want[5], inv)
    # padded rows stay zero
    pad = ~runs.valid_s
    for g in got[:4]:
        assert (g[pad] == 0).all()


def test_sharded_update_matches_single_device(runs):
    p = runs.prob
    upd = TUpdate(P)
    upd.load_state_dict({k: torch.as_tensor(v)
                         for k, v in runs.update_sd.items()})
    upd.eval()
    t = lambda a: torch.as_tensor(np.array(a))         # noqa: E731
    ds = SimpleNamespace(
        poses=t(p["poses"]), patches=t(p["patches"]),
        intrinsics=t(p["intrinsics"]), imap=t(p["imap"]),
        gmap=t(p["gmap"]), fmap1=t(p["fmap1"]), fmap2=t(p["fmap2"]),
        net=t(p["net"]), target=t(p["target"]), weight=t(p["weight"]),
        eii=t(p["ii"]), ejj=t(p["jj"]), ekk=t(p["kk"]))
    with torch.no_grad():
        delta = tk.update_step(ds, upd, E_LIVE, T0, T1, M, PMEM, MEM,
                               n_cap=N_CAP, k_cap=K_CAP, iterations=2)
    want = [ds.net.numpy(), ds.target.numpy(), ds.weight.numpy(),
            delta.numpy()]
    got = [_cat(runs.ranks, "update", i) for i in range(4)] + [
        _replicated(runs.ranks, "update", i) for i in (4, 5)]
    _check_update(got, want, ds.poses.numpy(), ds.patches.numpy(),
                  _inverse(runs.perm, runs.valid_s))


def test_sharded_step_leaves_the_callers_tf32(runs):
    """The step turns TF32 off only while it runs (each rank set it on
    before building and calling the step)."""
    for r in runs.ranks:
        assert r["tf32_after"] == (True, True)


def test_softagg_cross_rank_matches_jax(runs):
    a = runs.agg
    fn = _smap(lambda x, jx, v: runs.jagg.apply(
        runs.agg_params, x, jx, AGG_GROUPS, v, shard_axis="edges"),
        (PS("edges"),) * 3, PS("edges"))
    want = np.asarray(fn(jnp.asarray(a["x"]), jnp.asarray(a["jx"]),
                         jnp.asarray(a["valid"])))
    got = _cat(runs.ranks, "agg")
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_ba_sharded_matches_jax(runs):
    b = runs.ba_in

    def body(poses, patches, intr, target, weight, ii, jj, kk, valid):
        return jba.ba_iterative_sharded(
            poses, patches, intr, target, weight, jnp.float32(1e-4), ii, jj,
            kk, valid, T0, T1, n_cap=N_CAP, k_cap=K_CAP, iterations=2,
            axis_name="edges")

    fn = _smap(body, (PS(),) * 3 + (PS("edges"),) * 6, (PS(), PS()))
    want = fn(*(jnp.asarray(b[k]) for k in (
        "poses", "patches", "intrinsics", "target", "weight", "ii", "jj",
        "kk", "valid")))
    for i, w in enumerate(want):
        got = _replicated(runs.ranks, "ba", i)
        np.testing.assert_allclose(got, np.asarray(w), atol=1e-5, rtol=1e-5)


def test_shard_edges_by_patch_is_jax_s():
    rng = np.random.default_rng(1)
    kk = np.sort(rng.integers(0, 60, 500)).astype(np.int32)
    ii = kk // 4
    jj = ii + 1
    for n in (2, 3, 8):
        got = tis.shard_edges_by_patch(ii, jj, kk, n)
        want = jis.shard_edges_by_patch(ii, jj, kk, n)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        perm, valid = got
        e_shard = len(perm) // n
        assert len(perm) % n == 0
        assert sorted(perm[valid].tolist()) == list(range(500))
        shard_of = {}
        for r in np.nonzero(valid)[0]:
            k = int(kk[perm[r]])
            assert shard_of.setdefault(k, r // e_shard) == r // e_shard
    with pytest.raises(ValueError, match="k_cap"):
        tis.shard_edges_by_patch(ii, jj, kk, 2, k_cap=32)
    with pytest.raises(ValueError, match="exceeds the shard"):
        tis.shard_edges_by_patch(ii, jj, kk, 2, e_shard=4)


def test_ba_reduce_bytes():
    D = 6 * 16
    assert tis.ba_reduce_bytes(16, 4096) == 4 * (D * D + D + D * 4096
                                                  + 2 * 4096)
