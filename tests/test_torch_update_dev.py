"""The port's fixed-shape update program (``engine.kernels.update_step_dev``)
and the engine dispatch around it, against the JAX package on CPU.

One state: the port's engine tracks 12 synthetic 64x96 frames at a tiny
config (M 8, ``EDGE_CAPACITY`` 512, lagged decisions, never merging) with
the JAX engine's weights (``params_from_jax``, flow-delta head scaled by
0.02 as tests/test_torch_engine.py does), scripted centroids, a fixed
pre-init depth and the motion probe forced, and stops before
``terminate()``: 424 live edges, so the update's bucket (512) pads 88
masked rows.  On that state:

- the port's ``update_step_dev`` at bucket 512 against the JAX package's
  (``use_pallas=False``, how its tests run it on the CPU; one compile):
  net, target and weight on the live rows at models' atol 2e-4 (the
  bound tests/test_torch_models.py holds the update operator to), poses
  at atol 1e-4 and depths at 3e-4 (tests/test_torch_ba.py's), and the
  in-program magnitude within 1e-3 px of JAX's (the poses it is taken on
  differ by up to 1e-4), and within motionmag's rtol 1e-4 / atol 1e-5 of
  JAX's ``flowmag_two_blob`` on the port's own post-update state;
- the padded program against the port's own program at exactly the live
  count (``update_step``): atol 1e-5 (fp32 summation order: the padded
  rows join the shared SoftAgg shift and the BA products' zero rows);
- ``split_blob`` and ``flowmag_two_blob`` against JAX's;
- ``DPVO._bucket_for`` against the JAX engine's for every edge count from
  1 to the capacity in steps of 256, at four capacities;
- ``DPVO._mm_blob`` byte-equal to the JAX engine's on the drive's host
  state (the JAX engine's method on a stub holding that state).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpvo_tpu.config import VOConfig as JaxConfig
from dpvo_tpu.engine import DPVO as JaxDPVO
from dpvo_tpu.engine import kernels as jk
from dpvo_tpu_torch.config import VOConfig
from dpvo_tpu_torch.engine import DPVO
from dpvo_tpu_torch.engine import kernels as tk
from dpvo_tpu_torch.engine.state import DeviceState, MM_CAP, UPDATE_SCALARS
from dpvo_tpu_torch.utils.checkpoint import params_from_jax

torch.set_num_threads(1)

HT, WD = 64, 96
FH, FW = HT // 4, WD // 4
M = 8
N_FRAMES = 12
BUCKET = 512
INTR = np.array([48.0, 48.0, 48.0, 32.0], np.float32)
CFG = dict(BUFFER_SIZE=32, PATCHES_PER_FRAME=M, PATCH_LIFETIME=5,
           REMOVAL_WINDOW=7, OPTIMIZATION_WINDOW=5, KEYFRAME_INDEX=4,
           MIXED_PRECISION=False, EDGE_CAPACITY=BUCKET, BA_WINDOW_CAP=8,
           KEYFRAME_THRESH=0.0, ASYNC_KEYFRAME=True, ASYNC_KEYFRAME_LAG=3,
           ASYNC_KEYFRAME_BATCH=2)
ATOL_NET = 2e-4               # the update operator (test_torch_models)
ATOL_POSE, ATOL_DEPTH = 1e-4, 3e-4          # BA (test_torch_ba)
ATOL_MAG = 1e-3               # px, on poses that differ by ATOL_POSE
RTOL_MM, ATOL_MM = 1e-4, 1e-5               # motionmag on one state
ATOL_PAD = 1e-5               # padded against exact, fp32 order


def centroids(t):
    k = np.arange(M)
    x = 1 + (7 * k + 3 * t) % (FW - 2)
    y = 1 + (5 * k + 11 * t) % (FH - 2)
    return np.stack([x, y], axis=-1).astype(np.float32)


def frames():
    rng = np.random.default_rng(5)
    base = rng.integers(0, 255, size=(HT, WD * 2, 3), dtype=np.uint8)
    return [np.ascontiguousarray(np.roll(base, -3 * t, axis=1)[:, :WD])
            for t in range(N_FRAMES)]


def clone_state(ds):
    return DeviceState(**{k: v.clone() for k, v in vars(ds).items()})


@pytest.fixture(scope="module")
def drive():
    """(JAX init engine, its params, the port engine after the drive)."""
    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    try:
        init = JaxDPVO(JaxConfig(**CFG, CORR_BACKEND="xla"), network=None,
                       ht=HT, wd=WD)
        p = jax.tree.map(np.asarray, init.params_patchify)
        u = jax.tree.map(np.asarray, init.params_update)
        for k in ("kernel", "bias"):
            u["params"]["d"][k] = u["params"]["d"][k] * 0.02
        slam = DPVO(VOConfig(**CFG), network=params_from_jax(p, u), ht=HT,
                    wd=WD, device="cpu")
        slam.motion_probe = lambda: 100.0
        slam.test_centroids = centroids
        slam.test_fixed_depth = 0.7
        for t, img in enumerate(frames()):
            slam(t, img, INTR)
        yield init, u, slam
    finally:
        jax.config.update("jax_default_matmul_precision", old)


@pytest.fixture(scope="module")
def updates(drive):
    """The padded update on the port, on JAX and at the exact count."""
    init, u, slam = drive
    hs = slam.hs
    e_num, n = hs.e_num, slam.n
    assert 0 < e_num < BUCKET
    t0, t1 = n - CFG["OPTIMIZATION_WINDOW"], n
    blob, tcand = slam._mm_blob()
    assert tcand is not None
    kw = dict(M=M, pmem=slam.pmem, mem=slam.mem, n_cap=slam.n_cap,
              k_cap=slam.k_cap, iterations=2)

    padded = clone_state(slam.ds)
    with torch.no_grad():
        _, mag = tk.update_step_dev(
            padded, slam.update_mod, BUCKET, torch.tensor(e_num),
            torch.tensor(t0), torch.tensor(t1), torch.from_numpy(blob),
            has_mm=True, mm_cap=MM_CAP, **kw)
    exact = clone_state(slam.ds)
    with torch.no_grad():
        tk.update_step(exact, slam.update_mod, e_num, t0, t1, **kw)

    ds = {k: jnp.asarray(v.numpy()) for k, v in vars(slam.ds).items()}
    out = jk.update_step_dev(
        jax.tree.map(jnp.asarray, u), ds["poses"], ds["patches"],
        ds["intrinsics"], ds["imap"], ds["gmap"], ds["fmap1"], ds["fmap2"],
        ds["net"], ds["target"], ds["weight"], ds["eii"], ds["ejj"],
        ds["ekk"], np.int32(e_num),
        np.int32(t0), np.int32(t1), jnp.asarray(blob),
        update_mod=init.update_mod, bucket=BUCKET, run_ba=True,
        use_pallas=False, has_mm=True, **kw)
    want = dict(zip(("net", "target", "weight", "delta", "poses", "patches",
                     "mag"), (np.asarray(a) for a in out)))
    return dict(e_num=e_num, blob=blob, padded=padded, mag=mag, exact=exact,
                want=want)


def test_update_step_dev_matches_jax(updates):
    e, got, want = updates["e_num"], updates["padded"], updates["want"]
    for name in ("net", "target", "weight"):
        np.testing.assert_allclose(getattr(got, name)[:e].numpy(),
                                   want[name][:e], atol=ATOL_NET,
                                   err_msg=name)
        # the masked rows are written as zeros, as JAX writes them
        assert not getattr(got, name)[e:BUCKET].any()
    np.testing.assert_allclose(got.poses.numpy(), want["poses"],
                               atol=ATOL_POSE)
    np.testing.assert_allclose(got.patches.numpy(), want["patches"],
                               atol=ATOL_DEPTH)
    assert abs(float(updates["mag"]) - float(want["mag"])) <= ATOL_MAG


def test_in_program_magnitude_matches_jax_flowmag_two_blob(updates):
    got = updates["padded"]
    want = float(jk.flowmag_two_blob(
        jnp.asarray(got.poses.numpy()), jnp.asarray(got.patches.numpy()),
        jnp.asarray(got.intrinsics.numpy()), jnp.asarray(updates["blob"]),
        cap=MM_CAP))
    assert want > 0
    assert abs(float(updates["mag"]) - want) <= ATOL_MM + RTOL_MM * want


def test_padded_update_matches_the_exact_count(updates):
    e, got, ref = updates["e_num"], updates["padded"], updates["exact"]
    for name in ("net", "target", "weight"):
        np.testing.assert_allclose(getattr(got, name)[:e].numpy(),
                                   getattr(ref, name)[:e].numpy(),
                                   atol=ATOL_PAD, err_msg=name)
    for name in ("poses", "patches"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   getattr(ref, name).numpy(),
                                   atol=ATOL_PAD, err_msg=name)


def test_blob_helpers_match_jax(drive):
    _, _, slam = drive
    blob, _ = slam._mm_blob()
    sizes = (MM_CAP,) * 8
    got = tk.split_blob(torch.from_numpy(blob), sizes, bools=(3, 7))
    want = jk.split_blob(jnp.asarray(blob), sizes, bools=(3, 7))
    for a, b in zip(got, want):
        assert a.dtype == (torch.bool if b.dtype == bool else torch.int32)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ds = slam.ds
    mag = tk.flowmag_two_blob(ds.poses, ds.patches, ds.intrinsics,
                              torch.from_numpy(blob), MM_CAP)
    ref = float(jk.flowmag_two_blob(
        *(jnp.asarray(t.numpy()) for t in (ds.poses, ds.patches,
                                           ds.intrinsics)),
        jnp.asarray(blob), cap=MM_CAP))
    assert ref > 0
    assert abs(float(mag) - ref) <= ATOL_MM + RTOL_MM * ref
    # an all-invalid blob (no candidate yet) gives 0
    zero = tk.flowmag_two_blob(ds.poses, ds.patches, ds.intrinsics,
                               torch.zeros(8 * MM_CAP, dtype=torch.int32),
                               MM_CAP)
    assert float(zero) == 0.0


def test_mm_blob_is_byte_equal_to_jax(drive):
    _, _, slam = drive
    jcfg = JaxConfig(**CFG, CORR_BACKEND="xla")
    stub = types.SimpleNamespace(cfg=jcfg, hs=slam.hs, n=slam.n,
                                 _mm_tcand=None)
    stub._motionmag_edges = lambda i, j, cap=256: \
        JaxDPVO._motionmag_edges(stub, i, j, cap)
    want = JaxDPVO._mm_blob(stub)
    got, tcand = slam._mm_blob()
    assert got.dtype == want.dtype == np.int32
    assert got.tobytes() == want.tobytes()
    assert tcand == stub._mm_tcand is not None
    # the staged update inputs carry the blob behind e_num, t0, t1
    slam._stage_update(slam.hs.e_num, 3, 9, got)
    staged = slam.ds.update_in.numpy()
    assert staged[:UPDATE_SCALARS].tolist() == [slam.hs.e_num, 3, 9]
    assert staged[UPDATE_SCALARS:].tobytes() == want.tobytes()


@pytest.mark.parametrize("capacity", [512, 2048, 57344, 0])
def test_bucket_for_matches_jax(capacity):
    jcfg = JaxConfig(EDGE_CAPACITY=capacity)
    cfg = VOConfig(EDGE_CAPACITY=capacity)
    cap = cfg.edge_capacity()
    assert cap == jcfg.edge_capacity()
    mine = types.SimpleNamespace(cfg=cfg, E_cap=cap)
    ref = types.SimpleNamespace(cfg=jcfg, E_cap=cap)
    for e in range(1, cap + 1, 256):
        assert DPVO._bucket_for(mine, e) == JaxDPVO._bucket_for(ref, e), e
    mine._bucket_for = lambda e: DPVO._bucket_for(mine, e)
    ref._bucket_for = lambda e: JaxDPVO._bucket_for(ref, e)
    assert DPVO._bucket_ladder(mine) == JaxDPVO._bucket_ladder(ref)


def test_bucket_ladder_of_the_bench_drives():
    """The lagged merge drive's 11520-18720 live edges visit 12288, 14336,
    16384 and 20480; the retain drive's 44736-45312 visit 49152."""
    cfg = VOConfig(EDGE_CAPACITY=57344)
    stub = types.SimpleNamespace(cfg=cfg, E_cap=57344)
    merge = {DPVO._bucket_for(stub, e) for e in range(11520, 18721, 96)}
    retain = {DPVO._bucket_for(stub, e) for e in range(44736, 45313, 96)}
    assert merge == {12288, 14336, 16384, 20480}
    assert retain == {49152}


def test_captured_launches_count_per_replay():
    """A capture's launches leave the counts and come back once per
    replay."""
    from dpvo_tpu_torch.ops import _cuda
    saved = dict(_cuda.launches)
    try:
        _cuda.reset_launches()
        _cuda.launches["corr_enc"] += 2
        with _cuda.captured_launches() as captured:
            _cuda.count("corr_enc")           # as a wrapper counts
            _cuda.count("segment_sums")
            _cuda.count("segment_sums")
        assert dict(_cuda.launches) == {"corr_enc": 2}
        assert dict(captured) == {"corr_enc": 1, "segment_sums": 2}
        for _ in range(3):
            _cuda.replayed(captured)
        assert dict(_cuda.launches) == {"corr_enc": 5, "segment_sums": 6}
    finally:
        _cuda.reset_launches()
        _cuda.launches.update(saved)


def test_engine_runs_the_program_eagerly_on_the_cpu(drive):
    """On the CPU the engine asks for no graph (whatever ``cuda_graphs``
    says) and runs every update at a bucket of the ladder."""
    _, _, slam = drive
    assert not slam.cuda_graphs and not slam._graphs
    assert slam.graph_pool_bytes() is None
    assert set(slam.buckets_seen) == {BUCKET}
    assert sum(slam.buckets_seen.values()) >= 12    # initialisation's 12


def test_masked_rows_stay_out_of_the_softagg_sums():
    """The compact SoftAgg over a padded bucket: the masked rows' INT_MAX
    group is never summed (``agg_cuda.skip_masked`` ranks it past the
    table), and the live rows' outputs equal those of the same SoftAgg
    over the live rows alone."""
    from dpvo_tpu_torch.models.blocks import SoftAgg
    from dpvo_tpu_torch.ops import agg_cuda, scatter
    gen = torch.Generator().manual_seed(3)
    live, pad, g_cap = 40, 24, 16
    kk = torch.randint(0, 9, (live + pad,), generator=gen)
    valid = torch.arange(live + pad) < live
    x = torch.randn((live + pad, 32), generator=gen)
    agg = SoftAgg(32)
    perm, gid_sorted, gid_orig = scatter.group_meta_compact(
        torch.where(valid, kk, scatter.INT_MAX))
    skipped = agg_cuda.skip_masked(gid_sorted, valid[perm], g_cap)
    assert torch.equal(skipped[:live], gid_sorted[:live])  # live sort first
    assert (skipped[live:] == agg_cuda.padded_groups(g_cap)).all()
    with torch.no_grad():
        got = agg(x, compact_meta=(perm, skipped, gid_orig), g_cap=g_cap)
        want = agg(x[:live], compact_meta=scatter.group_meta_compact(
            kk[:live]), g_cap=g_cap)
    torch.testing.assert_close(got[:live], want, rtol=0, atol=1e-6)


def test_masked_rows_form_groups_of_their_own():
    """BA's ranks over a padded bucket (``agg_cuda.split_masked``): the
    masked tail a group per row after the live groups, the ranks dense,
    and K4's plain version and its row-order reference give the live
    groups' sums of the live rows alone."""
    from dpvo_tpu_torch.ops import agg_cuda, scatter
    gen = torch.Generator().manual_seed(4)
    live, pad, g_cap = 40, 300, 16
    kk = torch.randint(0, 9, (live + pad,), generator=gen)
    valid = torch.arange(live + pad) < live
    x = torch.randn((live + pad, 6), generator=gen)
    perm, gid_sorted, _ = scatter.group_meta_compact(
        torch.where(valid, kk, scatter.INT_MAX))
    split = agg_cuda.split_masked(gid_sorted, valid[perm])
    n_live = int(gid_sorted[:live].max()) + 1
    assert torch.equal(split[:live], gid_sorted[:live])
    assert torch.equal(split[live:], torch.arange(
        n_live, n_live + pad, dtype=split.dtype))
    want = agg_cuda.segment_sums_plain(x[perm][:live], gid_sorted[:live],
                                       g_cap)
    for fn in (agg_cuda.segment_sums_plain, agg_cuda.segment_sums_ordered):
        got = fn(x[perm], split, g_cap)
        torch.testing.assert_close(got[:n_live], want[:n_live], rtol=0,
                                   atol=1e-6)
