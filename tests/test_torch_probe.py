"""D3: the port's correlation phase probes against the TPU probes.

``scripts/dev/corr_variants.py`` (loaded by path) holds the TPU kernel
``probe_variant``: K1's tile loop with five truncated bodies (``PROBES``)
and a constant output block, so its result is the last 16-edge tile's
values, fp32 (16, 2, 9, 8, 128).  Here each body runs through
``pl.pallas_call(..., interpret=True)`` with ``probe_variant``'s grid spec,
on the script's ``make_inputs`` (bf16 rings at 120x160 / 30x40, 3 frames),
at E=16 (one tile) and E=32 (the last of two tiles), against
``corr_cuda.corr_probe_plain``.

Tolerance: 1e-5 of the largest output.  Products of bf16 values are exact
in fp32, so only the order of the fp32 sums differs (p_load and p_roll
copy values and match exactly).
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from dpvo_tpu_torch.ops import _cuda, corr_cuda as tc

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cv():
    path = (Path(__file__).resolve().parent.parent / "scripts" / "dev"
            / "corr_variants.py")
    spec = importlib.util.spec_from_file_location("corr_variants", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_probe(cv, probe, g, f1, f2, coords, tf):
    """``probe_variant``'s pallas_call, run in interpret mode."""
    cp, TILE, P2, D = cv.cp, cv.TILE, cv.P2, cv.D
    E, _, C = g.shape
    _, Hp1, Wp1, _ = f1.shape
    _, Hp2, Wp2, _ = f2.shape
    n_tiles = E // TILE
    n_live = jnp.full((1,), n_tiles, jnp.int32)
    x0a, bya, ria, dxa, dya = cp._window_meta(coords, Hp1, Wp1)
    x0b, byb, rib, dxb, dyb = cp._window_meta(coords / 4.0, Hp2, Wp2)
    sspec = pl.BlockSpec((TILE, P2), lambda i, tf, nl: (i, 0),
                         memory_space=pltpu.SMEM)
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=2,
        grid=(n_tiles,),
        in_specs=[sspec] * 10 + [
            pl.BlockSpec((TILE, P2, C), lambda i, tf, nl: (i, 0, 0)),
            pl.BlockSpec((1, Hp1, Wp1, C),
                         lambda i, tf, nl: (tf[i], 0, 0, 0)),
            pl.BlockSpec((1, Hp2, Wp2, C),
                         lambda i, tf, nl: (tf[i], 0, 0, 0)),
        ],
        out_specs=pl.BlockSpec((TILE, 2, P2, D, C),
                               lambda i, tf, nl: (0, 0, 0, 0, 0)),
    )
    kernel, _ = cv._mk_probe(cv.PROBES[probe], None)
    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((TILE, 2, P2, D, C), jnp.float32),
        grid_spec=grid_spec,
        interpret=True,
    )(tf, n_live, x0a, bya, ria,
      dxa.astype(jnp.float32), dya.astype(jnp.float32),
      x0b, byb, rib, dxb.astype(jnp.float32), dyb.astype(jnp.float32),
      g, f1, f2)
    return np.asarray(out)


def port_args(cv, args):
    """The same inputs as torch tensors: bf16 values carried exactly through
    fp32, one ring slot per edge (each tile reads its tile_frame)."""
    g, f1, f2, coords, tf = args

    def bf(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)

    ff = torch.from_numpy(np.repeat(np.asarray(tf), cv.TILE).astype(np.int32))
    return (bf(g), bf(f1), bf(f2),
            torch.from_numpy(np.array(coords, np.float32)), ff)


def test_probe_names_match(cv):
    assert tuple(cv.PROBES) == tc.PROBES
    assert cv.TILE == tc.PROBE_TILE


@pytest.mark.parametrize("E", [16, 32])
@pytest.mark.parametrize("probe", tc.PROBES)
def test_probe_plain_vs_jax(cv, probe, E):
    args = cv.make_inputs(E, mem=3)
    want = jax_probe(cv, probe, *args)
    got = tc.corr_probe_plain(*port_args(cv, args), probe).numpy()
    assert got.shape == want.shape == (16, 2, 9, 8, 128)
    assert np.isfinite(want).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    if probe in ("p_load", "p_roll"):
        np.testing.assert_array_equal(got, want)


def test_probe_wrapper_on_cpu(cv):
    """On CPU tensors the wrapper runs the plain version (no launch); it
    rejects an unknown probe and an edge count that is not a multiple of
    16."""
    args = port_args(cv, cv.make_inputs(32, mem=3))
    before = dict(_cuda.launches)
    for probe in tc.PROBES:
        np.testing.assert_array_equal(tc.corr_probe(*args, probe).numpy(),
                                      tc.corr_probe_plain(*args,
                                                          probe).numpy())
    assert dict(_cuda.launches) == before
    with pytest.raises(ValueError, match="unknown probe"):
        tc.corr_probe(*args, "p_blend")
    cut = [a[:24] if i in (0, 3, 4) else a for i, a in enumerate(args)]
    with pytest.raises(ValueError, match="multiple of 16"):
        tc.corr_probe(*cut, "p_load")


def test_probe_full_dot_is_k1_taps(cv):
    """p_full_dot's 8x8 taps, blended y then x, are K1's raw output."""
    args = port_args(cv, cv.make_inputs(32, mem=3))
    taps = tc.corr_probe_plain(*args, "p_full_dot")[..., :8]
    g, f1, f2, coords, ff = args
    coords = coords[16:]
    raw = tc.corr_fused_plain(g[16:], f1, f2, coords, ff[16:], "raw")
    for level, scale in ((0, 1.0), (1, 0.25)):
        c = coords * scale
        fx = (c[:, 0] - torch.floor(c[:, 0])).reshape(16, 9)[..., None, None]
        fy = (c[:, 1] - torch.floor(c[:, 1])).reshape(16, 9)[..., None, None]
        t = taps[:, level]
        ty = (1 - fy) * t[:, :, :-1] + fy * t[:, :, 1:]
        blended = (1 - fx) * ty[..., :-1] + fx * ty[..., 1:]
        torch.testing.assert_close(blended, raw[:, level], rtol=0,
                                   atol=1e-5)
