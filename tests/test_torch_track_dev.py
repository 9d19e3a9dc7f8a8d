"""The port's fixed-shape tracking and keyframe-merge programs and
``DPVO.precompile``, against the JAX package on CPU.

Small size throughout: 96x128 frames, M 8, fp32, rings of ``PMEM`` 6 patch
slots and ``MEM`` 4 feature-map slots (so a frame slot ``n`` >= 4 wraps),
states filled from a numpy seed; weights from a JAX engine's initialisation
through ``utils.checkpoint.params_from_jax``.

- ``kernels.track_frame_u8`` on its staged inputs with the parity seam
  (staged centroids, a fixed pre-init depth) against JAX
  ``kernels.track_frame(fixed_depth=)`` at n in {0, 1, 2, 5, 7} (5 and 7
  past ``MEM``, 7 past ``PMEM``), before and after initialisation: every
  table it writes.  Poses at atol 1e-5 (the motion model's fp32 Lie
  algebra, one op order against another), the Patchifier's outputs (imap,
  gmap, fmap rings) at atol 2e-4 (the bound tests/test_torch_models.py
  holds the Patchifier to), patches, intrinsics and colors bitwise (grid
  coordinates, the exact median or the fixed depth, copied and integer
  values);
- ``kernels.keyframe_merge`` against JAX ``relative_pose`` +
  ``shift_edge_indices`` + ``compact_frames`` at k 1, k near n-1, k +
  shift_cap past n-1 and across a ring wrap (n > MEM and > PMEM): every
  table bitwise, the relative pose at atol 1e-6;
- the u8 program, drawing centroids and depth from the generator, against
  the same pieces called one by one from the same generator state:
  bitwise, and the generator left as far advanced, on every branch;
- ``DPVO.precompile``'s plan against JAX ``DPVO.precompile``'s (its device
  programs replaced by recorders in this test): the same (bucket, local BA,
  magnitude) keys, the port's largest bucket first;
- a CPU drive with ``precompile`` before the first frame and again mid-drive
  against the same drive without: bitwise, and each call leaves the state
  as it found it.
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
from dpvo_tpu_torch.engine.state import (TRACK_SCALARS, allocate,
                                         track_inputs)
from dpvo_tpu_torch.models.vonet import (Patchifier, image_gradient,
                                         normalize_images, select_centroids)
from dpvo_tpu_torch.ops.corr_cuda import PAD
from dpvo_tpu_torch.utils.checkpoint import params_from_jax

torch.set_num_threads(1)

HT, WD = 96, 128
FH, FW = HT // 4, WD // 4
M, P, N = 8, 3, 12
PMEM, MEM = 6, 4
DAMPING = 0.5
DEPTH0 = 0.7
ATOL_POSE = 1e-5
ATOL_NET = 2e-4
ATOL_REL = 1e-6
CFG = dict(BUFFER_SIZE=N, PATCHES_PER_FRAME=M, MIXED_PRECISION=False,
           EDGE_CAPACITY=64)
TABLES = ("poses", "patches", "intrinsics", "colors", "imap", "gmap",
          "fmap1", "fmap2")
EDGES = ("eii", "ejj", "ekk")


@pytest.fixture(scope="module")
def nets():
    """(JAX patchifier module, its params, the port's Patchifier)."""
    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    try:
        init = JaxDPVO(JaxConfig(**CFG, CORR_BACKEND="xla"), network=None,
                       ht=HT, wd=WD)
        p = jax.tree.map(np.asarray, init.params_patchify)
        u = jax.tree.map(np.asarray, init.params_update)
        p_sd, _ = params_from_jax(p, u)
        pf = Patchifier(P)
        pf.load_state_dict(p_sd)
        yield init.patchifier, init.params_patchify, pf.eval()
    finally:
        jax.config.update("jax_default_matmul_precision", old)


def random_state(seed):
    """A port DeviceState (fp32, CPU) at the small size, every table filled
    from a numpy seed: unit quaternions, patches with positive depths, the
    feature rings' zero border left zero (the port never writes it)."""
    rng = np.random.default_rng(seed)
    ds = allocate(VOConfig(**CFG), HT, WD, P, PMEM, MEM,
                  torch.device("cpu"), torch.float32)
    q = rng.normal(size=(N, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    poses = np.concatenate([rng.normal(size=(N, 3)) * 0.3, q], 1)
    ds.poses.copy_(torch.from_numpy(poses.astype(np.float32)))
    patches = rng.uniform(0, 20, size=ds.patches.shape)
    patches[:, 2] = rng.uniform(0.2, 1.0, size=(N * M, 1, 1))
    ds.patches.copy_(torch.from_numpy(patches.astype(np.float32)))
    ds.intrinsics.copy_(torch.from_numpy(
        rng.uniform(10, 40, size=(N, 4)).astype(np.float32)))
    ds.colors.copy_(torch.from_numpy(
        rng.integers(0, 256, size=(N, M, 3), dtype=np.uint8)))
    for name in ("imap", "gmap"):
        t = getattr(ds, name)
        t.copy_(torch.from_numpy(rng.normal(size=t.shape).astype(np.float32)))
    for t, h, w in ((ds.fmap1, FH, FW), (ds.fmap2, FH // 4, FW // 4)):
        t[:, PAD:PAD + h, PAD:PAD + w] = torch.from_numpy(
            rng.normal(size=(MEM, h, w, 128)).astype(np.float32))
    E = ds.eii.shape[0]
    kk = rng.integers(0, N * M, E)
    ds.ekk.copy_(torch.from_numpy(kk.astype(np.int32)))
    ds.eii.copy_(torch.from_numpy((kk // M).astype(np.int32)))
    ds.ejj.copy_(torch.from_numpy(rng.integers(0, N, E).astype(np.int32)))
    return ds


def jax_tables(ds, names=TABLES):
    """Copies: the JAX programs donate their buffers, and a JAX array made
    from a numpy view could share the port's memory."""
    return [jnp.array(getattr(ds, k).numpy(), copy=True) for k in names]


def frame(seed):
    return np.random.default_rng(seed).integers(0, 256, (HT, WD, 3),
                                                dtype=np.uint8)


def centroids(seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(1, FW - 1, M)
    y = rng.integers(1, FH - 1, M)
    return np.stack([x, y], -1).astype(np.float32)


def stage(ds, img, n, fac, initialized, intr, coords=None):
    ds.image_in.copy_(torch.from_numpy(img))
    ds.track_in.copy_(torch.from_numpy(
        track_inputs(M, n, fac, initialized, intr, coords)))


# --- the tracking program ---------------------------------------------------

@pytest.mark.parametrize("initialized", [False, True])
@pytest.mark.parametrize("n", [0, 1, 2, 5, 7])
def test_track_program_matches_jax(nets, n, initialized):
    jmod, jparams, pf = nets
    ds = random_state(seed=n)
    img, coords = frame(100 + n), centroids(200 + n)
    intr = np.array([24.0, 25.0, 16.0, 12.0], np.float32)
    fac = 1.5
    want = jk.track_frame(
        jparams, jmod, *jax_tables(ds),
        jnp.asarray(2.0 * (img.astype(np.float32) / 255.0) - 0.5),
        jnp.asarray(coords), jnp.asarray(intr), np.int32(n),
        np.float32(fac), np.bool_(initialized), jax.random.PRNGKey(0),
        M=M, pmem=PMEM, mem=MEM, motion_damping=DAMPING,
        fixed_depth=DEPTH0)
    stage(ds, img, n, fac, initialized, intr, coords)
    with torch.no_grad():
        tk.track_frame_u8(ds, pf, torch.Generator(), M=M, pmem=PMEM,
                          mem=MEM, motion_damping=DAMPING,
                          staged_centroids=True, fixed_depth=DEPTH0)
    got = {k: getattr(ds, k).numpy() for k in TABLES}
    want = dict(zip(TABLES, (np.asarray(a) for a in want)))
    np.testing.assert_allclose(got["poses"], want["poses"], atol=ATOL_POSE)
    for name in ("patches", "intrinsics", "colors"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    for name in ("imap", "gmap", "fmap1", "fmap2"):
        np.testing.assert_allclose(got[name], want[name], atol=ATOL_NET,
                                   err_msg=name)
    # the depth init took the branch the staged flag asks for
    depth = got["patches"][n * M:(n + 1) * M, 2]
    assert (depth != DEPTH0).all() if initialized else (depth == DEPTH0).all()


@pytest.mark.parametrize("strat", ["RANDOM", "GRADIENT_BIAS"])
@pytest.mark.parametrize("n, initialized", [(0, False), (5, True)])
def test_u8_program_matches_its_pieces(nets, strat, n, initialized):
    """The u8 program draws the centroids, then the pre-init depth, from the
    generator on every branch; the same draws by hand, then
    ``track_frame``, give bitwise the same state and generator."""
    _, _, pf = nets
    img = frame(7)
    intr = np.array([24.0, 25.0, 16.0, 12.0], np.float32)
    got, ref = random_state(3), random_state(3)
    stage(got, img, n, 1.0, initialized, intr)
    g1 = torch.Generator().manual_seed(11)
    g2 = torch.Generator().manual_seed(11)
    with torch.no_grad():
        tk.track_frame_u8(got, pf, g1, M=M, pmem=PMEM, mem=MEM,
                          motion_damping=DAMPING, strat=strat)
        x = normalize_images(torch.from_numpy(img))
        grad = image_gradient(x[None]) if strat == "GRADIENT_BIAS" else None
        coords = select_centroids(g2, strat, 1, FH, FW, M, gradient=grad)[0]
        rand_d = torch.rand((M, 1, 1), generator=g2)
        tk.track_frame(ref, pf, x, coords, torch.from_numpy(intr),
                       torch.tensor(n), torch.tensor(1.0),
                       torch.tensor(initialized), rand_d, M=M, pmem=PMEM,
                       mem=MEM, motion_damping=DAMPING)
    for name in TABLES:
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    assert torch.equal(g1.get_state(), g2.get_state())
    assert not torch.equal(g1.get_state(),
                           torch.Generator().manual_seed(11).get_state())


def test_engine_stages_what_the_program_reads():
    """``DPVO._stage_track`` writes n, fac, is_initialized, the intrinsics
    at feature resolution and the seam's centroids in ``track_in``'s
    layout, and the frame in ``image_in``; a frame of another size
    raises."""
    slam = DPVO(VOConfig(**CFG), ht=HT, wd=WD, device="cpu")
    slam.test_centroids = centroids
    img = frame(1)
    slam._stage_track(img, [64.0, 60.0, 32.0, 24.0], 3, 0.5, True)
    block = slam.ds.track_in.numpy()
    assert block[:TRACK_SCALARS].tolist() == [3, 0.5, 1, 16, 15, 8, 6]
    assert block[TRACK_SCALARS:].tolist() == centroids(0).reshape(-1).tolist()
    assert np.array_equal(slam.ds.image_in.numpy(), img)
    with pytest.raises(ValueError, match="shape"):
        slam._stage_track(img[:, :-4], [64.0, 60.0, 32.0, 24.0], 3, 0.5,
                          True)


# --- the keyframe merge -----------------------------------------------------

SHIFT_CAP = 3
# (k, n): k 1; k near n-1; k + shift_cap past n-1; the shift across the
# rings' wrap (slots 2, 3 -> 3, 0 of MEM; 0, 1 -> 1, 2 of PMEM, n > both)
MERGES = [(1, 6), (8, 10), (4, 6), (6, 9), (5, 9), (10, 11)]


@pytest.mark.parametrize("k, n", MERGES)
def test_merge_program_matches_jax(k, n):
    ds = random_state(seed=50 + k)
    want_dp = jk.relative_pose(*jax_tables(ds, ("poses",)), np.int32(k))
    want_e = jk.shift_edge_indices(*jax_tables(ds, EDGES), np.int32(k), M=M)
    want_t = jk.compact_frames(*jax_tables(ds), np.int32(k), np.int32(n),
                               M=M, pmem=PMEM, mem=MEM, shift_cap=SHIFT_CAP)
    ds.merge_in.copy_(torch.tensor([k, n]))
    dp = tk.keyframe_merge(ds, M=M, pmem=PMEM, mem=MEM, shift_cap=SHIFT_CAP)
    for name, a in zip(TABLES + EDGES, (*want_t, *want_e)):
        np.testing.assert_array_equal(getattr(ds, name).numpy(),
                                      np.asarray(a), err_msg=name)
    np.testing.assert_allclose(dp.numpy(), np.asarray(want_dp),
                               atol=ATOL_REL)


def test_merge_ring_shift_is_the_ascending_slot_copy():
    """At the wrap, the one gather-then-scatter shift equals copying the
    slots one by one in ascending order (each read before it is
    overwritten)."""
    k, n = 6, 9
    ds, ref = random_state(8), random_state(8)
    ds.merge_in.copy_(torch.tensor([k, n]))
    tk.keyframe_merge(ds, M=M, pmem=PMEM, mem=MEM, shift_cap=SHIFT_CAP)
    for i in range(k, min(k + SHIFT_CAP, n - 1)):
        dp, sp = (i % PMEM) * M, ((i + 1) % PMEM) * M
        ref.imap[dp:dp + M] = ref.imap[sp:sp + M]
        ref.gmap[dp:dp + M] = ref.gmap[sp:sp + M]
        ref.fmap1[i % MEM] = ref.fmap1[(i + 1) % MEM]
        ref.fmap2[i % MEM] = ref.fmap2[(i + 1) % MEM]
    for name in ("imap", "gmap", "fmap1", "fmap2"):
        assert torch.equal(getattr(ds, name), getattr(ref, name)), name


def test_merge_shift_cap_must_stay_inside_the_rings():
    ds = random_state(0)
    with pytest.raises(ValueError, match="kf_shift_cap"):
        tk.keyframe_merge(ds, M=M, pmem=PMEM, mem=MEM, shift_cap=MEM)


# --- precompile -------------------------------------------------------------

class Recorder:
    """Stands in for a JAX program: records each call's static key and
    returns its first arguments; ``lower(...).compile()`` does nothing."""

    def __init__(self, n_out, key=None):
        self.n_out, self.key, self.calls = n_out, key, []

    def __call__(self, *args, **kw):
        if self.key is not None:
            self.calls.append(self.key(kw))
        return args[:self.n_out] if self.n_out > 1 else args[0]

    def lower(self, *args, **kw):
        return types.SimpleNamespace(compile=lambda: None)


def jax_plan(monkeypatch, cfg_kw, e_num, plan):
    """The (bucket, run_ba, has_mm) of every update_step_dev dispatch JAX
    ``DPVO.precompile`` makes, its device programs recorded, not run."""
    jcfg = JaxConfig(**cfg_kw)
    step = Recorder(7, lambda kw: (kw["bucket"], kw["run_ba"],
                                   kw["has_mm"]))
    for name, n_out in (("track_frame_u8", 8), ("relative_pose", 1),
                        ("shift_edge_indices", 3), ("compact_frames", 8),
                        ("append_edges", 4), ("permute_edges_b", 6)):
        monkeypatch.setattr(jk, name, Recorder(n_out))
    monkeypatch.setattr(jk, "update_step_dev", step)
    stub = types.SimpleNamespace(
        cfg=jcfg, E_cap=jcfg.edge_capacity(), hs=types.SimpleNamespace(
            e_num=e_num), ht=32, wd=32, P=3, M=jcfg.PATCHES_PER_FRAME,
        pmem=36, mem=36, n_cap=16, k_cap=1024, params_patchify=None,
        patchifier=None, _rng=None, params_update=None, update_mod=None,
        use_pallas=False, _warm_update=set())
    stub._bucket_for = lambda e: JaxDPVO._bucket_for(stub, e)
    stub._bucket_ladder = lambda: JaxDPVO._bucket_ladder(stub)
    JaxDPVO.precompile(stub, **plan)
    return step.calls


PLANS = {
    "merge": (dict(EDGE_CAPACITY=57344), dict(max_edges=20480)),
    "retain": (dict(EDGE_CAPACITY=57344), dict(max_edges=46000)),
    "around": (dict(EDGE_CAPACITY=57344), dict(around=14000, steps=2)),
    "around_top": (dict(EDGE_CAPACITY=57344), dict(around=56000, steps=1)),
    "live_count": (dict(EDGE_CAPACITY=57344), dict()),
    "lc_sync": (dict(EDGE_CAPACITY=8192, LOOP_CLOSURE=True,
                     ASYNC_KEYFRAME=False), dict(max_edges=4096)),
}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_precompile_plan_matches_jax(monkeypatch, case):
    cfg_kw, plan = PLANS[case]
    cfg_kw = dict(cfg_kw, PATCHES_PER_FRAME=M, MIXED_PRECISION=False)
    want = jax_plan(monkeypatch, cfg_kw, 0, plan)
    slam = DPVO(VOConfig(**cfg_kw), ht=32, wd=32, device="cpu")
    calls = []

    def update_step_dev(ds, update_mod, bucket, *args, run_ba, has_mm,
                        **kw):
        calls.append((bucket, run_ba, has_mm))
        return None, None

    monkeypatch.setattr(tk, "update_step_dev", update_step_dev)
    out = slam.precompile(**plan)
    assert sorted(calls) == sorted(want)
    assert calls == sorted(calls, key=lambda c: -c[0])   # largest first
    names = [k[0] for k in out["ms"] if isinstance(k[0], str)]
    assert names == ["track", "merge"]
    assert out["pool_bytes"] is None and not slam._graphs
    top = slam._bucket_ladder()[-1]
    assert (top, True, slam.cfg.ASYNC_KEYFRAME) in calls


# --- precompile on a drive --------------------------------------------------

DRIVE = dict(BUFFER_SIZE=64, PATCHES_PER_FRAME=M, REMOVAL_WINDOW=7,
             OPTIMIZATION_WINDOW=5, PATCH_LIFETIME=5, KEYFRAME_INDEX=4,
             KEYFRAME_THRESH=1e9, MIXED_PRECISION=False, EDGE_CAPACITY=512,
             BA_WINDOW_CAP=8, ASYNC_KEYFRAME_LAG=3, ASYNC_KEYFRAME_BATCH=2)
DRIVE_FRAMES = 20
MID = 12


def snapshot(slam):
    return ({k: v.clone() for k, v in vars(slam.ds).items()},
            slam.gen.get_state())


def assert_same(a, b):
    (ta, ga), (tb, gb) = a, b
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k
    assert torch.equal(ga, gb)


def drive(precompile):
    """The random-weight lagged merge drive (random centroids and depths from
    the engine's generator); with ``precompile`` called before the first
    frame and after frame ``MID``, each call checked to leave the state
    and the generator bitwise as they were."""
    slam = DPVO(VOConfig(**DRIVE), ht=HT, wd=WD, device="cpu", seed=3)
    slam.motion_probe = lambda: 100.0
    base = np.random.default_rng(0).integers(0, 255, (HT, 2 * WD, 3),
                                             np.uint8)
    intr = np.array([64.0, 64.0, 64.0, 48.0])

    def ready(**plan):
        before = snapshot(slam)
        out = slam.precompile(**plan)
        assert_same(before, snapshot(slam))
        return out

    if precompile:
        ready(max_edges=400)
    for t in range(DRIVE_FRAMES):
        slam(t, np.ascontiguousarray(np.roll(base, -3 * t, 1)[:, :WD]), intr)
        if precompile and t == MID:
            assert slam.hs.e_num > 0
            ready(around=slam.hs.e_num, steps=2)
    state = snapshot(slam)
    merges = len(slam.hs.delta)
    poses, tstamps = slam.terminate()
    return poses, tstamps, state, merges


def test_precompile_leaves_the_drive_bitwise_unchanged():
    p0, t0, s0, merges = drive(False)
    p1, t1, s1, _ = drive(True)
    assert merges >= 2
    assert np.array_equal(p0, p1) and np.array_equal(t0, t1)
    assert np.isfinite(p0).all()
    assert_same(s0, s1)
