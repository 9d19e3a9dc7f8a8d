"""The raw-feature correlation ops of the port (K1 ``corr_fused``, K5
``corr_single`` / ``corr_grouped``, the row maps, CorrDense's raw forms)
against the JAX package on CPU.

- ``corr_fused_plain`` (fp32) against ``corr_pallas_fused(...,
  interpret=True)``: versions 4 and 9 in the raw layout at rtol/atol 1e-4;
  versions 10 and 12 on their live lanes within 1e-2 of max|v4| (the gate of
  tests/test_corr_pallas.py; v12's dead lanes carry garbage on the TPU and
  zeros in the port), and their row-mapped product ``feat @ [W; 0][rows]``
  against v4's ``feat @ W[raw_to_ref_perm]`` at atol 1e-3; the dead last
  tile is zero;
- ``corr_single_plain`` against ``corr_pallas(..., version=1|3)``, raw and
  the reference order (through ``corr_grouped``), atol 1e-3 as
  tests/test_corr_pallas.py holds K5, in bounds and 500 px outside;
- the row maps equal JAX's exactly; CorrDense's ("raw", feat) forms equal
  the flax CorrDense's ("raw", feat, inv) forms with the same parameters;
- the dev variants of K1 in ``scripts/dev/corr_variants.py`` (loaded by
  path): ``fused_variant`` v4 raw at atol 1e-4, ``v10_variant`` and
  ``v12_variant`` on their live lanes within 1e-2 of max|v4|.
"""
import importlib.util
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dpvo_tpu.models.update import CorrDense as JaxCorrDense
from dpvo_tpu.ops import corr_pallas as cp
from dpvo_tpu_torch.models.update import CorrDense
from dpvo_tpu_torch.ops import _cuda, corr_cuda as tc
from dpvo_tpu_torch.utils.checkpoint import flax_to_state_dict

torch.set_num_threads(1)

E, N_LIVE_TILES = 64, 3          # the last of 4 tiles is dead
N_LIVE = N_LIVE_TILES * cp.TILE


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def live_lanes(out, width):
    """(E, P2, 2*8*width) lane layout -> (E, 2, P2, 7, 7) live values."""
    x = np.asarray(out, np.float32).reshape(out.shape[0], cp.P2, 2, 8, width)
    return x[:, :, :, :7, :7].transpose(0, 2, 1, 3, 4)


@pytest.fixture(scope="module")
def fused_case():
    rng = np.random.default_rng(1)
    F, H, W, C = 5, 32, 48, 128
    fmap1 = rng.normal(size=(F, H, W, C)).astype(np.float32)
    fmap2 = rng.normal(size=(F, H // 4, W // 4, C)).astype(np.float32)
    g = rng.normal(size=(E, cp.P2, C)).astype(np.float32)
    coords = rng.uniform(-4, 40, (E, 2, 3, 3)).astype(np.float32)
    tf = np.sort(rng.integers(0, F, E // cp.TILE)).astype(np.int32)
    jargs = (jnp.asarray(g), cp.pad_fmap(jnp.asarray(fmap1)),
             cp.pad_fmap(jnp.asarray(fmap2)), jnp.asarray(coords),
             jnp.asarray(tf))
    pallas = {}

    def jax_out(version):
        if version not in pallas:
            pallas[version] = np.asarray(cp.corr_pallas_fused(
                *jargs, n_live=jnp.full((1,), N_LIVE_TILES, jnp.int32),
                interpret=True, version=version))
        return pallas[version]

    def port(layout):
        return tc.corr_fused_plain(
            t(g), tc.pad_fmap(t(fmap1)), tc.pad_fmap(t(fmap2)), t(coords),
            torch.from_numpy(np.repeat(tf, cp.TILE)), layout,
            n_live_rows=N_LIVE).numpy()

    return jax_out, port, rng.normal(size=(2 * cp.RAW_DIM, 8)) / 30


@pytest.mark.parametrize("version", [4, 9])
def test_corr_fused_plain_raw_vs_pallas(fused_case, version):
    jax_out, port, _ = fused_case
    want = jax_out(version)
    got = port(tc.layout_for_version(version))
    assert got.shape == want.shape == (E, 2, cp.P2, 7, 7)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert not got[N_LIVE:].any() and not want[N_LIVE:].any()


@pytest.mark.parametrize("version,width,rows", [
    (10, 8, tc.v10_row_map), (12, 16, tc.v12_row_map)])
def test_corr_fused_plain_lanes_vs_pallas(fused_case, version, width, rows):
    jax_out, port, w = fused_case
    want = jax_out(version)
    got = port(tc.layout_for_version(version))
    assert got.shape == want.shape == (E, cp.P2, 16 * width)
    scale = np.abs(jax_out(4)).max()
    assert (np.abs(live_lanes(got, width) - live_lanes(want, width)).max()
            < 1e-2 * scale)
    # the port's dead lanes and dead rows are zero
    x = got.reshape(E, cp.P2, 2, 8, width)
    assert not x[:, :, :, 7].any() and not x[..., 7:].any()
    assert not got[N_LIVE:].any()
    # the row-mapped product against v4's exact features times the
    # permuted rows (v10 rounds its windows to bf16 even for fp32 inputs,
    # so its own product is only within the 1e-2 gate)
    wz = np.concatenate([w, np.zeros((1, w.shape[1]))])[rows()]
    np.testing.assert_allclose(
        got.reshape(E, -1) @ wz,
        jax_out(4).reshape(E, -1) @ w[tc.raw_to_ref_perm()], atol=1e-3)


@pytest.fixture(scope="module")
def single_case():
    rng = np.random.default_rng(0)
    F, H, W, C, K, Es = 3, 24, 32, 128, 40, 32
    gmap = rng.normal(size=(K, 3, 3, C)).astype(np.float32)
    fmap = rng.normal(size=(F, H, W, C)).astype(np.float32)
    coords = rng.uniform(6, min(H, W) - 7, (Es, 2, 3, 3)).astype(np.float32)
    kidx = rng.integers(0, K, Es).astype(np.int32)
    tf = rng.integers(0, F, Es // cp.TILE).astype(np.int32)
    return gmap, fmap, coords, kidx, tf


@pytest.mark.parametrize("outside", [False, True], ids=["inside", "outside"])
@pytest.mark.parametrize("raw", [True, False], ids=["raw", "ref"])
@pytest.mark.parametrize("version", [1, 3])
def test_corr_single_plain_vs_pallas(single_case, version, raw, outside):
    gmap, fmap, coords, kidx, tf = single_case
    if outside:
        coords = coords.copy()
        coords[:cp.TILE] = -500.0
    fpad = cp.pad_fmap(jnp.asarray(fmap))
    ff = torch.from_numpy(np.repeat(tf, cp.TILE))
    if raw:
        g_pre = gmap[kidx].reshape(-1, cp.P2, gmap.shape[-1])
        want = cp.corr_pallas(jnp.asarray(g_pre), fpad, jnp.asarray(coords),
                              jnp.asarray(tf), interpret=True,
                              version=version, raw=True)
        got = tc.corr_single_plain(t(g_pre), tc.pad_fmap(t(fmap)),
                                   t(coords), ff, raw=True)
    else:
        want = cp.corr_grouped(jnp.asarray(gmap), fpad, jnp.asarray(coords),
                               jnp.asarray(kidx), jnp.asarray(tf),
                               interpret=True, version=version)
        got = tc.corr_grouped(t(gmap), tc.pad_fmap(t(fmap)), t(coords),
                              torch.from_numpy(kidx), ff)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)
    if outside:
        assert not got[:cp.TILE].any()


def test_corr_single_plain_zero_tail(single_case):
    gmap, fmap, coords, kidx, tf = single_case
    g_pre = t(gmap[kidx].reshape(-1, cp.P2, gmap.shape[-1]))
    args = (g_pre, tc.pad_fmap(t(fmap)), t(coords),
            torch.from_numpy(np.repeat(tf, cp.TILE)))
    full = tc.corr_single_plain(*args, raw=True)
    cut = tc.corr_single_plain(*args, raw=True, n_live_rows=cp.TILE)
    np.testing.assert_array_equal(cut[:cp.TILE].numpy(),
                                  full[:cp.TILE].numpy())
    assert not cut[cp.TILE:].any()


def test_row_maps_match_jax():
    np.testing.assert_array_equal(tc.raw_to_ref_perm(), cp.raw_to_ref_perm())
    np.testing.assert_array_equal(tc.v10_row_map(), cp.v10_row_map())
    np.testing.assert_array_equal(tc.v12_row_map(), cp.v12_row_map())
    assert (tc.RAW_DIM, tc.V10_DIM, tc.V12_DIM) == (
        cp.RAW_DIM, cp.V10_DIM, cp.V12_DIM)


@pytest.mark.parametrize("in_dim", [2 * cp.RAW_DIM, cp.V10_DIM, cp.V12_DIM])
def test_corrdense_raw_forms_match_jax(in_dim):
    rng = np.random.default_rng(in_dim)
    n, dim = 6, 24
    jm = JaxCorrDense(dim)
    params = {"params": {
        "kernel": rng.normal(size=(2 * cp.RAW_DIM, dim)).astype(np.float32),
        "bias": rng.normal(size=(dim,)).astype(np.float32)}}
    feat = rng.normal(size=(n, in_dim)).astype(np.float32)
    want = jm.apply(params, ("raw", jnp.asarray(feat),
                             jnp.arange(n, dtype=jnp.int32)))
    m = CorrDense(2 * cp.RAW_DIM, dim)
    m.load_state_dict(flax_to_state_dict(params))
    with torch.no_grad():
        got = m(("raw", t(feat)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_wrappers_take_the_plain_versions_on_cpu(fused_case, single_case):
    _, port, _ = fused_case
    gmap, fmap, coords, kidx, tf = single_case
    before = dict(_cuda.launches)
    ff = torch.from_numpy(np.repeat(tf, cp.TILE))
    g_pre = t(gmap[kidx].reshape(-1, cp.P2, gmap.shape[-1]))
    f1 = tc.pad_fmap(t(fmap))
    f2 = tc.pad_fmap(t(fmap[:, ::4, ::4]))
    for layout in ("raw", "v10", "v12"):
        np.testing.assert_array_equal(
            tc.corr_fused(g_pre, f1, f2, t(coords), ff, layout).numpy(),
            tc.corr_fused_plain(g_pre, f1, f2, t(coords), ff,
                                layout).numpy())
    np.testing.assert_array_equal(
        tc.corr_single(g_pre, f1, t(coords), ff, raw=True).numpy(),
        tc.corr_single_plain(g_pre, f1, t(coords), ff, raw=True).numpy())
    assert dict(_cuda.launches) == before
    with pytest.raises(ValueError, match="layout"):
        tc.corr_fused(g_pre, f1, f2, t(coords), ff, "v11")
    assert [tc.layout_for_version(v) for v in (4, 5, 9, 10, 12, 13)] == [
        "raw", "raw", "raw", "v10", "v12", "v12"]


@pytest.fixture(scope="module")
def variants():
    """scripts/dev/corr_variants.py, loaded by path, and its check() inputs
    (bf16 rings at 120x160 / 30x40, 32 edges, 3 frames)."""
    path = (Path(__file__).resolve().parent.parent / "scripts" / "dev"
            / "corr_variants.py")
    spec = importlib.util.spec_from_file_location("corr_variants", path)
    cv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cv)
    g, f1, f2, coords, tf = cv.make_inputs(32, mem=3)
    ref4 = np.asarray(cv.fused_variant(g, f1, f2, coords, tf, variant="v4",
                                       interpret=True), np.float32)

    def bf(a):
        return t(np.asarray(a, np.float32)).to(torch.bfloat16)

    def port(layout):
        return tc.corr_fused_plain(
            bf(g), bf(f1), bf(f2), t(coords),
            torch.from_numpy(np.repeat(np.asarray(tf), cp.TILE)),
            layout).numpy()

    return cv, (g, f1, f2, coords, tf), ref4, port


def test_dev_fused_variant_v4_vs_corr_fused_plain(variants):
    _, _, ref4, port = variants
    got = port("raw")
    assert got.shape == ref4.shape
    np.testing.assert_allclose(got, ref4, atol=1e-4)


@pytest.mark.parametrize("name", ["v10", "v12"])
def test_dev_lane_variants_vs_corr_fused_plain(variants, name):
    cv, args, ref4, port = variants
    if name == "v10":
        want = cv.v10_variant(*args, variant="v10", interpret=True)
    else:
        want = cv.v12_variant(*args, interpret=True)
    width = 8 if name == "v10" else 16
    got = port(name)
    assert got.shape == want.shape
    assert (np.abs(live_lanes(got, width) - live_lanes(want, width)).max()
            < 1e-2 * np.abs(ref4).max())
