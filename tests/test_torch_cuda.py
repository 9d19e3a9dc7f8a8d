"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA GPU with ``nvcc`` (the kernels are built at first use)
and skip elsewhere.  On a GPU machine run them with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`` (the
suite's conftest configures JAX, which that machine need not have).
``chip_smoke.py`` runs the same comparison at the main path's shapes.
Tolerances: fp32 correlation atol 1e-4 (summation order only); bf16
correlation one bf16 step of the output's magnitude (1e-2 relative); the
segment sums rtol 2e-5 / atol 1e-5, as the CPU tests hold the plain
versions to the Pallas kernels, and K4 (``segment_sums``) bitwise equal to
``segment_sums_ordered``, the plain version in its summation order, on
``tests/test_torch_segments.py``'s cases (runs across slice boundaries,
one group, a low last rank, single rows), at (3000, 98, 900 groups, g_cap
256: ranks past the table dropped), at an odd width and with no rows.  The
raw-feature kernels (K1 ``corr_fused`` in the raw, v10 and v12 layouts, K5
``corr_single`` raw and in the reference order) are held to their plain
versions the same way, dead lanes and rows past ``n_live_rows`` included.
The D3 phase probes (``corr_probe``) are held to theirs at 1e-5 of the
largest output (fp32 sums of exact bf16 products), on uniform coordinates
and on fitted, spread and border-clamped 3x3 patches, and the engine with lagged keyframe decisions on
the card to the same engine on the CPU (structure exact, translation 5e-2,
quaternion dot > 1-1e-3, the envelopes of the CPU parity tests).  The bf16
kernels' box window stage is held to the plain versions on compact 3x3
patches, on patches spread beyond one box (mixed in one block with compact
ones, so the per-window path runs), on patches clamped at every border of
the map and on NaN coordinates (NaN where the plain version is NaN, the
other values within tolerance), at edge counts that leave the last block
partial.  The classic loop-closure backend's device work: PGO on a drifted
300-pose loop, card against CPU within 1e-3 after first-pose alignment
(the CPU tests' gate against the JAX package), and the structure-only BA
of ``long_term.triangulate`` at 1024 keypoints with K4 launched, points
within 1e-4 of the CPU's.  The engine's update program replayed as a CUDA
graph equals the same program run eagerly, bitwise, and each replay counts
its kernels' launches; so do its tracking program (from the same generator
state, which the replay advances as far) and its keyframe merge; and
``DPVO.precompile`` leaves the engine's state and generator bitwise as it
found them, before the first frame and mid-drive, and the drive it
precompiled for bitwise the same as one without.  The cold-bucket guard:
a cover's replay against the exact key's on one state (TOL_COVER_CARD), a
background capture held open while the engine thread replays, copies and
waits (the capture lands and replays bitwise as its eager program), and a
failure injected into the worker's capture raising on the engine thread;
``utils.timing.Timer`` around a frame while a capture is open.
"""
import threading

import numpy as np
import pytest
import torch

from dpvo_tpu_torch.ops import _cuda, agg_cuda, corr_cuda
from test_torch_corr_box import patch_coords
from test_torch_segments import CASES as SEGMENT_CASES, segment_case

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _corr_inputs(dev, dtype, E=200, F=3, h=32, w=48, K=40, DIMo=384,
                 seed=0):
    rng = np.random.default_rng(seed)

    def d(a, dt=dtype):
        return torch.as_tensor(a).to(dev, dt)

    fmap1 = corr_cuda.pad_fmap(d(rng.normal(size=(F, h, w, 128))))
    fmap2 = corr_cuda.pad_fmap(d(rng.normal(size=(F, h // 4, w // 4, 128))))
    g_all = d(rng.normal(size=(K, 9, 128)))
    w_raw = d(rng.normal(size=(2 * corr_cuda.RAW_DIM, DIMo)) / 30)
    coords = d(rng.uniform(-6, w + 6, (E, 2, 3, 3)), torch.float32)
    kk = d(rng.integers(0, K, E), torch.int32)
    ff = d(rng.integers(0, F, E), torch.int32)
    return g_all, kk, w_raw, fmap1, fmap2, coords, ff


@pytest.mark.parametrize("dtype,rel", [(torch.float32, None),
                                       (torch.bfloat16, 1e-2)])
def test_corr_enc_kernel_vs_plain(dev, dtype, rel):
    args = _corr_inputs(dev, dtype)
    before = _cuda.launches["corr_enc"]
    got = corr_cuda.corr_enc(*args).float()
    want = corr_cuda.corr_enc_plain(*args).float()
    torch.cuda.synchronize()
    assert _cuda.launches["corr_enc"] == before + 1
    atol = 1e-4 if rel is None else rel * want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=0, atol=atol)


def test_corr_enc_kernel_nonfinite_coords(dev):
    g_all, kk, w_raw, f1, f2, coords, ff = _corr_inputs(dev, torch.float32,
                                                        E=16)
    coords[0, 0, 0, 0] = float("nan")
    coords[1, 1, 1, 1] = float("inf")
    coords[2] = 1e9
    coords[3] = -1e9
    got = corr_cuda.corr_enc(g_all, kk, w_raw, f1, f2, coords, ff)
    torch.cuda.synchronize()
    assert torch.isfinite(got[2:]).all()
    torch.testing.assert_close(got[2:4], torch.zeros_like(got[2:4]),
                               rtol=0, atol=1e-6)


def test_corr_enc_kernel_rejects_bad_inputs(dev):
    g_all, kk, w_raw, f1, f2, coords, ff = _corr_inputs(dev, torch.float32,
                                                        E=8)
    with pytest.raises(ValueError, match="kk_rows"):
        corr_cuda.corr_enc(g_all, kk.long(), w_raw, f1, f2, coords, ff)
    with pytest.raises(ValueError, match="contiguous"):
        corr_cuda.corr_enc(g_all, kk, w_raw, f1, f2,
                           coords.transpose(2, 3), ff)


F32, BF16 = torch.float32, torch.bfloat16


def _raw_inputs(dev, dtype, E=200):
    g_all, kk, _, f1, f2, coords, ff = _corr_inputs(dev, dtype, E=E, seed=1)
    return g_all[kk.long()].contiguous(), f1, f2, coords, ff


def _close(got, want, out_dtype):
    atol = 1e-4 if out_dtype == F32 else 1e-2 * want.abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)


@pytest.mark.parametrize("layout", ["raw", "v10", "v12"])
@pytest.mark.parametrize("dtype,out_dtype", [(F32, F32), (BF16, BF16),
                                             (BF16, F32)])
def test_corr_fused_kernel_vs_plain(dev, layout, dtype, out_dtype):
    args = _raw_inputs(dev, dtype)
    before = _cuda.launches["corr_fused"]
    got = corr_cuda.corr_fused(*args, layout, out_dtype)
    want = corr_cuda.corr_fused_plain(*args, layout, out_dtype)
    torch.cuda.synchronize()
    assert _cuda.launches["corr_fused"] == before + 1
    assert got.shape == want.shape and got.dtype == out_dtype
    _close(got, want, out_dtype)


@pytest.mark.parametrize("raw", [True, False], ids=["raw", "ref"])
@pytest.mark.parametrize("dtype,out_dtype", [(F32, F32), (BF16, F32)])
def test_corr_single_kernel_vs_plain(dev, raw, dtype, out_dtype):
    g_pre, f1, _, coords, ff = _raw_inputs(dev, dtype)
    before = _cuda.launches["corr_single"]
    got = corr_cuda.corr_single(g_pre, f1, coords, ff, raw, out_dtype)
    want = corr_cuda.corr_single_plain(g_pre, f1, coords, ff, raw,
                                       out_dtype)
    torch.cuda.synchronize()
    assert _cuda.launches["corr_single"] == before + 1
    assert got.shape == want.shape
    _close(got, want, out_dtype)


def test_corr_raw_kernels_zero_tail(dev):
    g_pre, f1, f2, coords, ff = _raw_inputs(dev, F32, E=77)
    n = 40
    for layout in ("raw", "v12"):
        full = corr_cuda.corr_fused(g_pre, f1, f2, coords, ff, layout)
        cut = corr_cuda.corr_fused(g_pre, f1, f2, coords, ff, layout,
                                   n_live_rows=n)
        torch.cuda.synchronize()
        torch.testing.assert_close(cut[:n], full[:n], rtol=0, atol=0)
        assert not cut[n:].any()
    cut = corr_cuda.corr_single(g_pre, f1, coords, ff, n_live_rows=n)
    want = corr_cuda.corr_single_plain(g_pre, f1, coords, ff, n_live_rows=n)
    torch.cuda.synchronize()
    assert not cut[n:].any()
    _close(cut, want, F32)


def _close_nan(got, want, rel):
    """NaN exactly where the plain version is NaN; the rest within
    ``rel`` of the largest finite plain value (fp32 out: atol 1e-4)."""
    got, want = got.float(), want.float()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    fin = torch.isfinite(want)
    if not fin.any():
        return
    atol = 1e-4 if rel is None else rel * want[fin].abs().max().item()
    torch.testing.assert_close(got[fin], want[fin], rtol=0, atol=atol)


@pytest.mark.parametrize("E", [1, 33, 200])
@pytest.mark.parametrize("kind", ["compact", "spread", "borders", "nan"])
def test_bf16_box_stage_vs_plain(dev, kind, E):
    """K2, K1 (raw, v10, v12) and K5 (raw, ref; fp32 out) on bf16 rings."""
    g_all, kk, w_raw, f1, f2, _, ff = _corr_inputs(dev, BF16, E=E, seed=E)
    coords = torch.as_tensor(patch_coords(kind, E, seed=E, h=32, w=48),
                             device=dev)
    got = corr_cuda.corr_enc(g_all, kk, w_raw, f1, f2, coords, ff)
    want = corr_cuda.corr_enc_plain(g_all, kk, w_raw, f1, f2, coords, ff)
    torch.cuda.synchronize()
    _close_nan(got, want, 1e-2)
    nan_rows = torch.isnan(coords).reshape(E, -1).any(1)
    assert torch.isnan(got[nan_rows]).all()
    assert torch.isfinite(got[~nan_rows]).all()
    g_pre = g_all[kk.long()].contiguous()
    for layout in ("raw", "v10", "v12"):
        args = (g_pre, f1, f2, coords, ff, layout, BF16)
        got = corr_cuda.corr_fused(*args)
        want = corr_cuda.corr_fused_plain(*args)
        torch.cuda.synchronize()
        _close_nan(got, want, 1e-2)
    for raw in (True, False):
        args = (g_pre, f1, coords, ff, raw, F32)
        got = corr_cuda.corr_single(*args)
        want = corr_cuda.corr_single_plain(*args)
        torch.cuda.synchronize()
        _close_nan(got, want, None)


@pytest.mark.parametrize("DIMo", [48, 400])
def test_corr_enc_bf16_column_passes(dev, DIMo):
    """Output widths below and above one 384-column pass."""
    args = _corr_inputs(dev, BF16, E=70, DIMo=DIMo, seed=3)
    got = corr_cuda.corr_enc(*args).float()
    want = corr_cuda.corr_enc_plain(*args).float()
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-2 * want.abs().max().item())


def test_corr_enc_bf16_rejects_dimo(dev):
    g_all, kk, w_raw, f1, f2, coords, ff = _corr_inputs(dev, BF16, E=8,
                                                        DIMo=100)
    before = _cuda.launches["corr_enc"]
    with pytest.raises(ValueError, match="multiple of 16"):
        corr_cuda.corr_enc(g_all, kk, w_raw, f1, f2, coords, ff)
    assert _cuda.launches["corr_enc"] == before


def _segments(dev, E, D, n_groups, seed):
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.integers(0, n_groups, E))
    new = np.ones(E, bool)
    new[1:] = ids[1:] != ids[:-1]
    gid = torch.as_tensor((np.cumsum(new) - 1).astype(np.int32), device=dev)
    a = torch.as_tensor(rng.normal(size=(E, D)).astype(np.float32),
                        device=dev)
    b = torch.as_tensor(rng.normal(size=(E, D)).astype(np.float32),
                        device=dev)
    return a, b, gid


@pytest.mark.parametrize("E,D,n_groups,g_cap", [(512, 384, 60, 64),
                                                (3000, 98, 900, 256),
                                                (0, 384, 1, 8)])
def test_segment_kernels_vs_plain(dev, E, D, n_groups, g_cap):
    gate, val, gid = _segments(dev, E, D, n_groups, seed=E)
    shift = (gate.max(dim=0, keepdim=True).values if E
             else torch.zeros((1, D), device=dev))
    got = agg_cuda.segment_softmax_sums(gate, val, shift, gid, g_cap)
    want = agg_cuda.segment_softmax_sums_plain(gate, val, shift, gid, g_cap)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-5)
    got = agg_cuda.segment_sums(val, gid, g_cap)
    want = agg_cuda.segment_sums_plain(val, gid, g_cap)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("kind", SEGMENT_CASES + ["main", "odd", "empty"])
def test_segment_sums_kernel_bitwise(dev, kind):
    if kind == "main":
        vals, _, gid = _segments(dev, 3000, 98, 900, seed=5)
        g_cap = 256
    else:
        E, D = {"odd": (1000, 7), "empty": (0, 98)}.get(kind, (512, 98))
        vals, gid, g_cap = segment_case("random" if kind in ("odd", "empty")
                                        else kind, E=E, D=D)
        vals, gid = torch.as_tensor(vals, device=dev), torch.as_tensor(
            gid, device=dev)
    before = _cuda.launches["segment_sums"]
    got = agg_cuda.segment_sums(vals, gid, g_cap)
    want = agg_cuda.segment_sums_ordered(vals, gid, g_cap)
    torch.cuda.synchronize()
    assert _cuda.launches["segment_sums"] == before + 1
    assert got.shape == want.shape == (agg_cuda.padded_groups(g_cap),
                                       vals.shape[1])
    assert torch.equal(got, want)


def _wrapper_call(dev, name):
    """(launch counter key, call) for each kernel wrapper, with one float
    input that requires grad."""
    g_all, kk, w_raw, f1, f2, coords, ff = _corr_inputs(dev, F32, E=64)
    g_pre = g_all[kk.long()].contiguous()
    gate, val, gid = _segments(dev, 64, 32, 9, seed=1)
    shift = gate.max(dim=0, keepdim=True).values
    w_raw.requires_grad_(True)
    g_pre.requires_grad_(True)
    val.requires_grad_(True)
    gmap = g_all.reshape(-1, 3, 3, 128).requires_grad_(True)
    calls = {
        "corr_enc": ("corr_enc", lambda: corr_cuda.corr_enc(
            g_all, kk, w_raw, f1, f2, coords, ff)),
        "corr_fused": ("corr_fused", lambda: corr_cuda.corr_fused(
            g_pre, f1, f2, coords, ff)),
        "corr_single": ("corr_single", lambda: corr_cuda.corr_single(
            g_pre, f1, coords, ff)),
        "corr_grouped": ("corr_single", lambda: corr_cuda.corr_grouped(
            gmap, f1, coords, kk, ff)),
        "corr_probe": ("corr_probe.p_load", lambda: corr_cuda.corr_probe(
            g_pre.to(BF16), f1.to(BF16), f2.to(BF16), coords, ff,
            "p_load")),
        "segment_softmax_sums": ("segment_softmax_sums",
                                 lambda: agg_cuda.segment_softmax_sums(
                                     gate, val, shift, gid, 16)),
        "segment_sums": ("segment_sums", lambda: agg_cuda.segment_sums(
            val, gid, 16)),
    }
    return calls[name]


@pytest.mark.parametrize("name", ["corr_enc", "corr_fused", "corr_single",
                                  "corr_grouped", "corr_probe",
                                  "segment_softmax_sums", "segment_sums"])
def test_wrappers_refuse_autograd(dev, name):
    """The kernels have no backward: in grad mode with an input that
    requires grad each wrapper raises before launching; under no_grad it
    launches."""
    key, call = _wrapper_call(dev, name)
    before = _cuda.launches[key]
    with pytest.raises(RuntimeError, match="no backward"):
        call()
    assert _cuda.launches[key] == before
    with torch.no_grad():
        out = call()
    torch.cuda.synchronize()
    assert _cuda.launches[key] == before + 1
    assert not out.requires_grad


@pytest.mark.parametrize("probe", corr_cuda.PROBES)
def test_corr_probe_kernel_vs_plain(dev, probe):
    g_pre, f1, f2, coords, ff = _raw_inputs(dev, BF16, E=208)
    key = f"corr_probe.{probe}"
    before = _cuda.launches[key]
    got = corr_cuda.corr_probe(g_pre, f1, f2, coords, ff, probe)
    want = corr_cuda.corr_probe_plain(g_pre, f1, f2, coords, ff, probe)
    torch.cuda.synchronize()
    assert _cuda.launches[key] == before + 1
    assert got.shape == want.shape == (16, 2, 9, 8, 128)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("kind", ["compact", "spread", "borders"])
@pytest.mark.parametrize("probe", corr_cuda.PROBES)
def test_corr_probe_kernel_fitted(dev, probe, kind):
    """The probes' box path: patches whose windows fit one box (compact),
    half of them spread beyond it, and clamped at the map's borders."""
    g_pre, f1, f2, _, ff = _raw_inputs(dev, BF16, E=208)
    coords = torch.as_tensor(patch_coords(kind, 208, seed=9, h=32, w=48),
                             device=dev)
    got = corr_cuda.corr_probe(g_pre, f1, f2, coords, ff, probe)
    want = corr_cuda.corr_probe_plain(g_pre, f1, f2, coords, ff, probe)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * want.abs().max().item())


def test_lagged_engine_card_vs_cpu(dev):
    """ASYNC_KEYFRAME=True (lag 3, batch 2) on 16 small always-merge frames:
    the card engine against the CPU engine, same seeded weights."""
    from dpvo_tpu_torch.config import VOConfig
    from dpvo_tpu_torch.engine import DPVO
    cfg = VOConfig(BUFFER_SIZE=64, PATCHES_PER_FRAME=8, PATCH_LIFETIME=5,
                   REMOVAL_WINDOW=7, OPTIMIZATION_WINDOW=5, KEYFRAME_INDEX=4,
                   MIXED_PRECISION=False, EDGE_CAPACITY=512, BA_WINDOW_CAP=8,
                   KEYFRAME_THRESH=1e9, ASYNC_KEYFRAME=True,
                   ASYNC_KEYFRAME_LAG=3, ASYNC_KEYFRAME_BATCH=2)
    base = np.random.default_rng(11).integers(0, 255, (96, 256, 3),
                                              dtype=np.uint8)
    intr = np.array([64.0, 64.0, 64.0, 48.0])

    def run(device):
        slam = DPVO(cfg, ht=96, wd=128, device=device, seed=2)
        slam.motion_probe = lambda: 100.0
        k = np.arange(8)
        slam.test_centroids = lambda t: np.stack(
            [1 + (7 * k + 3 * t) % 30, 1 + (5 * k + 11 * t) % 22], -1)
        slam.test_fixed_depth = 0.7
        for t in range(16):
            slam(t, np.ascontiguousarray(np.roll(base, -3 * t, 1)[:, :128]),
                 intr)
        state = (slam.n, slam.hs.e_num, slam.hs.tstamps[:slam.n].tolist(),
                 sorted(slam.hs.delta))
        return slam.terminate()[0], state

    p_gpu, s_gpu = run(dev)
    p_cpu, s_cpu = run("cpu")
    assert s_gpu == s_cpu and s_gpu[0] < 16
    np.testing.assert_allclose(p_gpu[:, :3], p_cpu[:, :3], atol=5e-2)
    qd = np.abs((p_gpu[:, 3:] * p_cpu[:, 3:]).sum(-1))
    assert np.all(qd > 1 - 1e-3)


def test_update_graph_replay_vs_eager(dev):
    """The engine's update program replayed as a CUDA graph against the same
    program run eagerly, on one state of the small lagged drive (bucket 512
    with masked rows): bitwise (the same kernels in the same order), and
    the replay adds its kernels' launches to the counts."""
    from dpvo_tpu_torch.config import VOConfig
    from dpvo_tpu_torch.engine import DPVO
    cfg = VOConfig(BUFFER_SIZE=64, PATCHES_PER_FRAME=8, PATCH_LIFETIME=5,
                   REMOVAL_WINDOW=7, OPTIMIZATION_WINDOW=5, KEYFRAME_INDEX=4,
                   MIXED_PRECISION=True, EDGE_CAPACITY=512, BA_WINDOW_CAP=8,
                   KEYFRAME_THRESH=0.0, ASYNC_KEYFRAME=True,
                   ASYNC_KEYFRAME_LAG=3, ASYNC_KEYFRAME_BATCH=2)
    base = np.random.default_rng(11).integers(0, 255, (96, 256, 3),
                                              dtype=np.uint8)
    slam = DPVO(cfg, ht=96, wd=128, device=dev, seed=2)
    slam.motion_probe = lambda: 100.0
    for t in range(12):
        slam(t, np.ascontiguousarray(np.roll(base, -3 * t, 1)[:, :128]),
             np.array([64.0, 64.0, 64.0, 48.0]))
    assert slam._graphs and slam.hs.e_num < 512
    blob, tcand = slam._mm_blob()
    assert tcand is not None
    k_cap = slam._update_k_cap()
    slam._stage_update(slam.hs.e_num, slam.n - 5, slam.n, blob)
    names = ("net", "target", "weight", "poses", "patches")
    saved = [getattr(slam.ds, k).clone() for k in names]
    outs = []
    for graph in (True, False):
        for k, v in zip(names, saved):
            getattr(slam.ds, k).copy_(v)
        before = dict(_cuda.launches)
        if graph:
            mag = slam._call_update_step(512, True, True, k_cap)
        else:
            mag = slam._update_program(512, True, True, k_cap)()
        torch.cuda.synchronize()
        for name in ("corr_enc", "segment_softmax_sums", "segment_sums"):
            assert _cuda.launches[name] > before.get(name, 0)
        outs.append([getattr(slam.ds, k).clone() for k in names]
                    + [mag.clone()])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def _small_lagged(dev, frames=12, precompile=False):
    """The small lagged engine of test_update_graph_replay_vs_eager (bf16,
    bucket 512, never merging) after ``frames`` frames; with
    ``precompile`` readied before the first frame and after frame 6, each
    call checked to leave the state and the generator as they were."""
    from dpvo_tpu_torch.config import VOConfig
    from dpvo_tpu_torch.engine import DPVO
    cfg = VOConfig(BUFFER_SIZE=64, PATCHES_PER_FRAME=8, PATCH_LIFETIME=5,
                   REMOVAL_WINDOW=7, OPTIMIZATION_WINDOW=5, KEYFRAME_INDEX=4,
                   MIXED_PRECISION=True, EDGE_CAPACITY=512, BA_WINDOW_CAP=8,
                   KEYFRAME_THRESH=0.0, ASYNC_KEYFRAME=True,
                   ASYNC_KEYFRAME_LAG=3, ASYNC_KEYFRAME_BATCH=2)
    base = np.random.default_rng(11).integers(0, 255, (96, 256, 3),
                                              dtype=np.uint8)
    slam = DPVO(cfg, ht=96, wd=128, device=dev, seed=2)
    slam.motion_probe = lambda: 100.0

    def snapshot():
        return ([v.clone() for v in vars(slam.ds).values()],
                slam.gen.get_state())

    def ready(**plan):
        before = snapshot()
        slam.precompile(**plan)
        after = snapshot()
        assert all(torch.equal(a, b) for a, b in zip(before[0], after[0]))
        assert torch.equal(before[1], after[1])

    if precompile:
        ready(max_edges=400)
    for t in range(frames):
        slam(t, np.ascontiguousarray(np.roll(base, -3 * t, 1)[:, :128]),
             np.array([64.0, 64.0, 64.0, 48.0]))
        if precompile and t == 6:
            ready(around=slam.hs.e_num)
    return slam


def test_track_graph_replay_vs_eager(dev):
    """The tracking program replayed as a CUDA graph against the same
    program run eagerly from the same state and generator state: bitwise,
    and the replay advances the generator as far as the eager run."""
    from dpvo_tpu_torch.engine.dpvo import TRACK_WRITES
    slam = _small_lagged(dev)
    key, program = slam._track_program()
    assert key in slam._graphs
    img = np.random.default_rng(3).integers(0, 255, (96, 128, 3), np.uint8)
    slam._stage_track(img, [64.0, 64.0, 64.0, 48.0], slam.n, 1.0, True)
    (a, ga), (b, gb) = slam._replay_against_eager(
        key, program, slam._writes(TRACK_WRITES), True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert torch.equal(ga, gb)


def test_merge_graph_replay_vs_eager(dev):
    """The keyframe merge replayed as a CUDA graph (captured here: the
    drive merges nothing) against the same program run eagerly: every
    table and the relative pose bitwise."""
    from dpvo_tpu_torch.engine.dpvo import MERGE_WRITES
    slam = _small_lagged(dev)
    key, program = slam._merge_program()
    assert key not in slam._graphs
    slam._copy_in(slam.ds.merge_in, np.array([slam.n - 5, slam.n], np.int32))
    (a, _), (b, _) = slam._replay_against_eager(
        key, program, slam._writes(MERGE_WRITES), False)
    assert key in slam._graphs and len(a) == len(MERGE_WRITES) + 1
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_precompile_leaves_the_state_unchanged(dev):
    """``precompile`` before the first frame and mid-drive leaves the state
    and the generator bitwise as they were (``_small_lagged`` checks each
    call), captures the tracking and merge graphs and the plan's update
    graphs, and the drive equals one without it, bitwise."""
    ref = _small_lagged(dev)
    slam = _small_lagged(dev, precompile=True)
    names = {k[0] for k in slam._graphs if isinstance(k[0], str)}
    assert names == {"track", "merge"}
    assert slam.graph_pool_bytes() > 0
    for a, b in zip(vars(ref.ds).values(), vars(slam.ds).values()):
        assert torch.equal(a, b)


# the cold-bucket guard: a cover's replay against the exact key's differs
# by the summation order of kernels launched at another row count (fp32,
# TF32 off)
TOL_COVER_CARD = 1e-5    # on an H100: 1.9e-6 (depths), the rest 0 to 2.4e-7
UPDATE_WRITES = ("net", "target", "weight", "poses", "patches")


def _guard_frame(slam, t):
    """Frame ``t`` of ``_guard_engine``'s drive."""
    base = np.random.default_rng(11).integers(0, 255, (96, 256, 3),
                                              dtype=np.uint8)
    slam(t, np.ascontiguousarray(np.roll(base, -3 * t, 1)[:, :128]),
         np.array([64.0, 64.0, 64.0, 48.0]))


def _guard_engine(dev, frames=12):
    """The small lagged engine (fp32) on a two-step ladder: EDGE_CAPACITY
    1536 with BUCKET_FLOOR 1024, so its updates ask for bucket 1024 and
    1536 covers them; after ``frames`` frames, the 1024 key captured at
    first reach and the update of its live state staged.  -> (engine, the
    exact key, the cover key (1536, twice the patch capacity), restore:
    puts back what the update writes)."""
    from dpvo_tpu_torch.config import VOConfig
    from dpvo_tpu_torch.engine import DPVO
    cfg = VOConfig(BUFFER_SIZE=64, PATCHES_PER_FRAME=8, PATCH_LIFETIME=5,
                   REMOVAL_WINDOW=7, OPTIMIZATION_WINDOW=5, KEYFRAME_INDEX=4,
                   MIXED_PRECISION=False, EDGE_CAPACITY=1536,
                   BUCKET_FLOOR=1024, BA_WINDOW_CAP=8, KEYFRAME_THRESH=0.0,
                   ASYNC_KEYFRAME=True, ASYNC_KEYFRAME_LAG=3,
                   ASYNC_KEYFRAME_BATCH=2)
    slam = DPVO(cfg, ht=96, wd=128, device=dev, seed=2)
    slam.motion_probe = lambda: 100.0
    for t in range(frames):
        _guard_frame(slam, t)
    k_cap = slam._update_k_cap()
    exact = slam._update_key(1024, True, True, k_cap)
    assert exact in slam._graphs and slam.hs.e_num < 1024
    blob, tcand = slam._mm_blob()
    assert tcand is not None
    slam._stage_update(slam.hs.e_num, slam.n - 5, slam.n, blob)
    saved = [getattr(slam.ds, k).clone() for k in UPDATE_WRITES]

    def restore():
        for k, v in zip(UPDATE_WRITES, saved):
            getattr(slam.ds, k).copy_(v)
    return (slam, exact, slam._update_key(1536, True, True, 2 * k_cap),
            restore)


def _run_key(slam, key):
    return slam._run(key, slam._update_program(*key),
                     slam._update_writes(key[0]))


def test_cover_replay_vs_exact_replay(dev):
    """On one state, the cover's replay (bucket 1536, twice the patch
    capacity) against the exact key's (1024): the live rows, poses, depths
    and magnitude within TOL_COVER_CARD, the rows past the live count
    zero."""
    slam, exact, cover, restore = _guard_engine(dev)
    e = slam.hs.e_num
    outs = []
    for key in (exact, cover):
        restore()
        mag = _run_key(slam, key)
        torch.cuda.synchronize()
        ds = slam.ds
        outs.append([getattr(ds, k)[:e].clone() for k in UPDATE_WRITES[:3]]
                    + [getattr(ds, k).clone() for k in UPDATE_WRITES[3:]]
                    + [mag.clone()])
        if key == cover:
            for k in UPDATE_WRITES[:3]:
                assert not getattr(slam.ds, k)[e:1536].any()
    restore()
    errs = {k: (a - b).abs().max().item()
            for k, a, b in zip(UPDATE_WRITES + ("mag",), *outs)}
    print(f"cover against exact, max abs error: {errs}")
    assert max(errs.values()) <= TOL_COVER_CARD, errs


def _gated(slam, gate, entered):
    """Make the worker's update programs wait for ``gate`` inside the
    capture (``entered`` set there), so the test acts while it is open."""
    real = slam._update_program
    main = threading.current_thread()

    def program(*key):
        run = real(*key)

        def gated_run():
            if threading.current_thread() is not main:
                entered.set()
                assert gate.wait(60)
            return run()
        return gated_run
    slam._update_program = program
    return real


def test_background_capture_while_the_engine_works(dev):
    """A cold key with a cover: the cover replays and the worker captures
    the exact key; while that capture is open the engine thread replays the
    cover again, stages inputs through pinned copies (under sync debug mode
    "error": no host synchronisation), records and waits on an event and
    synchronises its stream.  The capture lands, counts its launches as a
    capture on this thread would, the replays alone add to the counts, and
    the exact key's replay then equals its eager program bitwise.  The
    engine's device is named without an index, as ``device="cuda"``
    gives it: the worker finds the index."""
    slam, exact, cover, restore = _guard_engine(torch.device("cuda"))
    restore()
    _run_key(slam, cover)                         # the cover, captured here
    del slam._graphs[exact]
    gate, entered = threading.Event(), threading.Event()
    real = _gated(slam, gate, entered)
    _cuda.reset_launches()
    restore()
    slam._call_update_step(1024, True, True, exact[3])
    assert entered.wait(60) and exact in slam._in_flight
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            slam._call_update_step(1024, True, True, exact[3])
            slam._stage_update(slam.hs.e_num, slam.n - 5, slam.n,
                               slam._mm_blob()[0])
            slam._dev(np.arange(64, dtype=np.int32))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ev = torch.cuda.Event()
    ev.record()
    ev.synchronize()
    torch.cuda.current_stream().synchronize()
    assert not slam._in_flight[exact].done()     # still open until now
    gate.set()
    slam._wait_captures()
    slam._update_program = real
    assert exact in slam._graphs and slam.background_capture_ms[exact] > 0
    assert slam.cover_served[exact] == 3
    per_replay = slam._graphs[cover][2]
    assert slam._graphs[exact][2] == per_replay
    assert dict(_cuda.launches) == {k: 3 * v for k, v in per_replay.items()}
    (a, _), (b, _) = slam._replay_against_eager(
        exact, real(*exact), slam._update_writes(1024))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    slam.terminate()
    assert slam._worker is None


def test_timer_around_a_frame_while_a_capture_is_open(dev):
    """``utils.timing.Timer`` around a frame (as ``demo_torch.py --timeit``
    wraps each) while the worker holds a capture open: the timer's fences
    wait on the stream, so the capture lands and the next update raises
    nothing (a device-wide synchronise would fail the capture, and the
    update would re-raise its error)."""
    from dpvo_tpu_torch.utils.timing import Timer
    slam, exact, cover, restore = _guard_engine(dev)
    restore()
    _run_key(slam, cover)
    del slam._graphs[exact]
    gate, entered = threading.Event(), threading.Event()
    real = _gated(slam, gate, entered)
    restore()
    slam._call_update_step(1024, True, True, exact[3])
    assert entered.wait(60)
    # a frame whose update has no cover captures here, after the open
    # capture: the gate opens on its own then
    threading.Timer(2.0, gate.set).start()
    with Timer("frame while a capture is open"):
        assert not slam._in_flight[exact].done()
        _guard_frame(slam, 12)
    gate.set()
    slam._wait_captures()
    slam._update_program = real
    assert exact in slam._graphs and slam.background_capture_ms[exact] > 0
    slam.update()
    _guard_frame(slam, 13)
    slam.terminate()


def test_failed_background_capture_raises_on_the_engine_thread(dev):
    """A capture that fails in the worker raises at the engine's next
    update with the worker's error; the next cold call schedules the key
    again and that capture lands."""
    slam, exact, cover, restore = _guard_engine(dev)
    restore()
    _run_key(slam, cover)
    del slam._graphs[exact]
    real = slam._update_program
    main = threading.current_thread()

    def failing(*key):
        run = real(*key)

        def failing_run():
            if threading.current_thread() is not main:
                raise RuntimeError("injected capture failure")
            return run()
        return failing_run
    slam._update_program = failing
    slam._call_update_step(1024, True, True, exact[3])
    assert isinstance(slam._in_flight[exact].exception(timeout=60),
                      RuntimeError)
    with pytest.raises(RuntimeError, match="injected capture failure"):
        slam.update()
    slam._update_program = real
    restore()
    slam._call_update_step(1024, True, True, exact[3])
    slam._wait_captures()
    assert exact in slam._graphs
    slam.terminate()


def _drifted_loop(n, seed=2, noise=0.01):
    """A circle of n poses with drifted odometry (the port's Lie ops) and
    one Sim3 loop constraint between the last and the first pose."""
    from dpvo_tpu_torch.ops import lie
    rng = np.random.default_rng(seed)
    ang = np.linspace(0, 2 * np.pi, n)
    gt = torch.zeros((n, 7))
    gt[:, 0], gt[:, 1], gt[:, 6] = (torch.from_numpy(np.cos(ang)),
                                    torch.from_numpy(np.sin(ang)), 1.0)
    drift = [gt[0]]
    for i in range(1, n):
        rel = lie.se3_mul(gt[i], lie.se3_inv(gt[i - 1]))
        nz = lie.se3_exp(torch.from_numpy(rng.normal(size=6) * noise).float())
        drift.append(lie.se3_mul(lie.se3_mul(nz, rel), drift[-1]))
    C = lie.sim3_mul(lie.sim3_inv(lie.se3_to_sim3(gt[0])),
                     lie.se3_to_sim3(gt[n - 1]))
    return torch.stack(drift).numpy(), C[None].numpy()


def test_pgo_card_vs_cpu(dev):
    """The classic backend's pose-graph LM on the card against the CPU at
    300 poses: the same corrected poses within 1e-3 once both are aligned
    at their first pose (tests/test_torch_classic_lc.py's gate against the
    JAX package: its own result moves by 1e-4 to 5e-4 when the inputs move
    by 1e-6)."""
    from dpvo_tpu_torch.loop_closure import pgo
    from dpvo_tpu_torch.ops import lie
    n = 300
    poses, C = _drifted_loop(n)
    args = (poses, C, np.array([n - 1]), np.array([0]))
    out = [pgo.perform_updates(*args, device=d).cpu() for d in (dev, "cpu")]
    a, b = (lie.sim3_mul(lie.sim3_inv(o[0])[None], o).numpy() for o in out)
    assert np.isfinite(a).all()
    np.testing.assert_allclose(a, b, atol=1e-3)


def triplet_problem(K, seed=0):
    """K world points seen by three cameras moving along x (cam from world
    poses), projected at feature resolution into the middle frame and its
    two neighbours: (poses3, intrinsics, pts_c, targets, points)."""
    from dpvo_tpu_torch.ops import lie
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-1, 1, K), rng.uniform(-0.75, 0.75, K),
                  rng.uniform(1.5, 3.0, K)], -1).astype(np.float32)
    poses = np.zeros((3, 7), np.float32)
    poses[:, 0] = [0.1, 0.0, -0.1]
    poses[:, 1] = [0.0, 0.01, 0.0]
    poses[:, 3:7] = lie.so3_exp(torch.tensor(
        [[0, 0.02, 0], [0, 0, 0], [0.01, -0.02, 0]])).numpy()
    intr = np.array([120.0, 120.0, 80.0, 60.0], np.float32)
    cam = lie.se3_act(torch.from_numpy(poses)[:, None],
                      torch.from_numpy(X)[None]).numpy()     # (3, K, 3)
    uv = intr[:2] * cam[..., :2] / cam[..., 2:] + intr[2:]
    return poses, intr, uv[1], np.stack([uv[0], uv[2]], 1), X


def test_structure_only_ba_card_vs_cpu(dev):
    """estimate_3d_keypoints' structure-only BA (``long_term.triangulate``:
    ba_iterative with t0 == t1, 6 iterations) at 1024 keypoints x 2 edges
    on the card, with the K4 kernel, against the CPU: points within
    1e-4, and near the true points."""
    from dpvo_tpu_torch.loop_closure.long_term import triangulate
    poses, intr, pts_c, targets, X = triplet_problem(1024)
    _cuda.reset_launches()
    got = triangulate(torch.from_numpy(poses).to(dev),
                      torch.from_numpy(intr).to(dev), pts_c, targets)
    assert _cuda.launches["segment_sums"] == 6
    want = triangulate(torch.from_numpy(poses), torch.from_numpy(intr),
                       pts_c, targets)
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(got, X, atol=1e-2)
