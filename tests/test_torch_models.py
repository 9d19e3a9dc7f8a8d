"""The port's network modules against the flax modules on CPU.

Both sides run the same weights (the flax params carried across with
``utils.checkpoint.params_from_jax``) on the same numpy-seeded inputs, in
fp32, at atol 2e-4 (the bound tests/test_sorted_segments.py holds the
compact Update path to).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dpvo_tpu.models import blocks as jblocks, encoder as jenc
from dpvo_tpu.models import update as jupd, vonet as jvonet
from dpvo_tpu.ops import graph as jgraph, scatter as jscatter
from dpvo_tpu_torch.models import blocks as tblocks, encoder as tenc
from dpvo_tpu_torch.models import update as tupd, vonet as tvonet
from dpvo_tpu_torch.ops import graph as tgraph, scatter as tscatter
from dpvo_tpu_torch.utils.checkpoint import (flax_to_state_dict,
                                             params_from_jax)

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(3)
ATOL = 2e-4
INT_MAX = np.iinfo(np.int32).max


def t(a):
    return torch.from_numpy(np.array(a))


def load(module, flax_params):
    module.load_state_dict(flax_to_state_dict(
        jax.tree.map(np.asarray, flax_params)))
    return module.eval()


@pytest.mark.parametrize("norm_fn", ["instance", "none"])
def test_basic_encoder4(norm_fn):
    x = np.random.default_rng(0).normal(size=(1, 32, 48, 3)).astype(
        np.float32)
    jm = jenc.BasicEncoder4(output_dim=64, norm_fn=norm_fn)
    params = jm.init(KEY, jnp.asarray(x))
    want = jm.apply(params, jnp.asarray(x))
    tm = load(tenc.BasicEncoder4(output_dim=64, norm_fn=norm_fn), params)
    with torch.no_grad():
        got = tm(t(x))
    assert got.shape == want.shape == (1, 8, 12, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_patchifier():
    rng = np.random.default_rng(1)
    img = (2.0 * rng.uniform(size=(1, 32, 48, 3)) - 0.5).astype(np.float32)
    coords = rng.uniform(1, 11, (1, 6, 2)).astype(np.float32)
    jm = jvonet.Patchifier(3)
    p_params = jm.init(KEY, jnp.asarray(img), jnp.asarray(coords))
    want = jm.apply(p_params, jnp.asarray(img), jnp.asarray(coords))
    tm = tvonet.Patchifier(3)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, p_params),
                                       {"params": {}})[0])
    with torch.no_grad():
        got = tm.eval()(t(img), t(coords))
    for name, a, b in zip(("fmap", "gmap", "imap", "patches", "index",
                           "clr"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   err_msg=name)


def test_gated_residual():
    x = np.random.default_rng(2).normal(size=(10, 32)).astype(np.float32)
    jm = jblocks.GatedResidual(32)
    params = jm.init(KEY, jnp.asarray(x))
    tm = load(tblocks.GatedResidual(32), params)
    with torch.no_grad():
        got = tm(t(x))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jm.apply(params, jnp.asarray(x))),
                               atol=ATOL)


@pytest.mark.parametrize("n_groups", [7, 40])
def test_softagg_compact(n_groups):
    rng = np.random.default_rng(3)
    E, D, g_cap = 64, 16, 80
    ids = rng.integers(0, n_groups, E).astype(np.int32)
    ids[-4:] = INT_MAX                                # invalid rows
    x = rng.normal(size=(E, D)).astype(np.float32)
    jm = jblocks.SoftAgg(D)
    cm = jscatter.group_meta_compact_device(jnp.asarray(ids))
    params = jm.init(KEY, jnp.asarray(x), compact_meta=cm, g_cap=g_cap)
    want = jm.apply(params, jnp.asarray(x), compact_meta=cm, g_cap=g_cap)
    tm = load(tblocks.SoftAgg(D), params)
    with torch.no_grad():
        got = tm(t(x), compact_meta=tscatter.group_meta_compact(
            t(ids).long()), g_cap=g_cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def _update_inputs(seed, E=48, P=3):
    rng = np.random.default_rng(seed)
    ii = rng.integers(0, 6, E).astype(np.int32)
    jj = (ii + rng.integers(1, 4, E)).astype(np.int32)
    kk = (ii * 4 + rng.integers(0, 4, E)).astype(np.int32)
    valid = np.ones(E, bool)
    valid[-5:] = False
    net = rng.normal(size=(E, jupd.DIM)).astype(np.float32)
    inp = rng.normal(size=(E, jupd.DIM)).astype(np.float32)
    corr = rng.normal(size=(E, 2 * 49 * P * P)).astype(np.float32)
    return ii, jj, kk, valid, net, inp, corr


@pytest.fixture(scope="module")
def update_pair():
    ii, jj, kk, valid, net, inp, corr = _update_inputs(6)
    jm = jupd.Update(3)
    params = jm.init(KEY, *map(jnp.asarray, (net, inp, corr, ii, jj, kk)))
    tm = tupd.Update(3)
    tm.load_state_dict(params_from_jax({"params": {}},
                                       jax.tree.map(np.asarray, params))[1])
    return jm, params, tm.eval()


@pytest.mark.parametrize("seed", [6, 7])
def test_update_compact_meta(update_pair, seed):
    """Update with compact metadata (the engine's path) against the flax
    Update's compact path, invalid rows included."""
    jm, params, tm = update_pair
    ii, jj, kk, valid, net, inp, corr = _update_inputs(seed)
    kk_m = np.where(valid, kk, INT_MAX)
    pair = np.where(valid, ii * 12345 + jj, INT_MAX)
    cm = (jscatter.group_meta_compact_device(jnp.asarray(kk_m)),
          jscatter.group_meta_compact_device(jnp.asarray(pair)))
    nbrs = jgraph.neighbors(jnp.asarray(kk), jnp.asarray(jj),
                            jnp.asarray(valid))
    want = jm.apply(params, *map(jnp.asarray, (net, inp, corr, ii, jj, kk,
                                               valid)),
                    nbrs=nbrs, compact_meta=cm, g_cap=32)
    tcm = (tscatter.group_meta_compact(t(kk_m).long()),
           tscatter.group_meta_compact(t(pair).long()))
    tnb = tgraph.neighbors(t(kk), t(jj), t(valid))
    with torch.no_grad():
        got = tm(*map(t, (net, inp, corr, ii, jj, kk, valid)), nbrs=tnb,
                 compact_meta=tcm, g_cap=32)
        # no metadata: the scatter path (training's)
        got2 = tm(*map(t, (net, inp, corr, ii, jj, kk, valid)))
    for a, a2, b in zip(got, got2, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
        np.testing.assert_allclose(a2.numpy(), np.asarray(b), atol=ATOL)


def test_centroid_helpers():
    rng = np.random.default_rng(8)
    u8 = rng.integers(0, 255, (1, 32, 48, 3), dtype=np.uint8)
    img = jvonet.normalize_images(jnp.asarray(u8))
    np.testing.assert_allclose(tvonet.normalize_images(t(u8)).numpy(),
                               np.asarray(img), atol=1e-6)
    np.testing.assert_allclose(tvonet.image_gradient(t(np.asarray(img))
                                                     ).numpy(),
                               np.asarray(jvonet.image_gradient(img)),
                               rtol=1e-5, atol=1e-4)
    gen = torch.Generator().manual_seed(0)
    for strat in ("RANDOM", "GRADIENT_BIAS"):
        grad = tvonet.image_gradient(t(np.asarray(img)))
        c = tvonet.select_centroids(gen, strat, 1, 8, 12, 5, gradient=grad)
        assert c.shape == (1, 5, 2)
        assert (c[..., 0] >= 1).all() and (c[..., 0] < 11).all()
        assert (c[..., 1] >= 1).all() and (c[..., 1] < 7).all()
