"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA GPU with ``nvcc`` (the kernels are built at first use)
and skip elsewhere.  On a GPU machine run them with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`` (the
suite's conftest configures JAX, which that machine need not have).
``chip_smoke.py`` runs the same comparison at the main path's shapes.
Tolerances: fp32 correlation atol 1e-4 (summation order only); bf16
correlation one bf16 step of the output's magnitude (1e-2 relative); the
segment sums rtol 2e-5 / atol 1e-5, as the CPU tests hold the plain
versions to the Pallas kernels.  The raw-feature kernels (K1 ``corr_fused``
in the raw, v10 and v12 layouts, K5 ``corr_single`` raw and in the
reference order) are held to their plain versions the same way, dead lanes
and rows past ``n_live_rows`` included.
"""
import numpy as np
import pytest
import torch

from dpvo_tpu_torch.ops import _cuda, agg_cuda, corr_cuda

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
