"""The box plan of the bf16 correlation kernels' window stage
(``corr_cuda.window_boxes``, the Python model of ``level_taps`` in
``dpvo_tpu_torch/csrc/corr_window.cuh``), on the CPU.

On seeded coordinates (compact, spread, clamped at the borders, NaN and
per-pixel random patches): every window the plan says fits lies inside its
box, every box lies inside the padded map, compact 3x3 patches always fit,
and taps read through the plan (one box per patch, a box of its own for a
window that does not fit) equal the plain version's window taps (fp32,
atol 1e-4: summation order only).
"""
import numpy as np
import pytest
import torch

from dpvo_tpu_torch.ops import corr_cuda as tc

torch.set_num_threads(1)

H, W = 24, 40                     # unpadded level-1 map
HW = (tc.padded_hw(H, W), tc.padded_hw(H // 4, W // 4))
KINDS = ["compact", "spread", "borders", "nan", "random"]


def patch_coords(kind, E=96, seed=0, h=H, w=W):
    """(E, 2, 3, 3) level-1 coords on an h x w map: jittered 3x3 patches
    (``compact``), every other one scaled by 6 (``spread``), centred from
    14 px beyond to 2 px inside each border in turn (``borders``), one NaN
    pixel in every third patch (``nan``), or every pixel uniform over the
    map and 6 px beyond (``random``).  ``tests/test_torch_cuda.py`` uses
    them too."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.uniform(-6, w + 6, (E, 2, 3, 3)).astype(np.float32)
    ctr = rng.uniform([0.0, 0.0], [w, h], (E, 2))
    if kind == "borders":
        side = np.arange(E) % 4
        off = rng.uniform(-14, 2, E)
        ctr[side == 0, 0] = off[side == 0]
        ctr[side == 1, 0] = w - off[side == 1]
        ctr[side == 2, 1] = off[side == 2]
        ctr[side == 3, 1] = h - off[side == 3]
    scale = np.ones(E)
    if kind == "spread":
        scale[1::2] = 6.0
    grid = np.arange(3) - 1.0
    x = ctr[:, 0, None, None] + grid[None, None, :] * scale[:, None, None]
    y = ctr[:, 1, None, None] + grid[None, :, None] * scale[:, None, None]
    coords = np.stack(np.broadcast_arrays(x, y), 1)
    coords = coords + rng.normal(0, 0.3, coords.shape)
    if kind == "nan":
        coords[::3, 0, 1, 1] = np.nan
    return coords.astype(np.float32)


def _plan(coords):
    return tc.window_boxes(coords, [h for h, _ in HW], [w for _, w in HW])


def _origins(coords):
    """Window origins bx, by (E, L, 9), as the kernels clamp them."""
    c = torch.as_tensor(coords)
    out = [tc._window_origin(c * 0.25 ** lvl, Hp, Wp)[:2]
           for lvl, (Hp, Wp) in enumerate(HW)]
    return (torch.stack([o[0] for o in out], 1),
            torch.stack([o[1] for o in out], 1))


@pytest.mark.parametrize("kind", KINDS)
def test_fitting_windows_lie_in_their_box(kind):
    coords = patch_coords(kind)
    b = _plan(coords)
    bx, by = _origins(coords)
    x0, y0 = b["x0"][..., None], b["y0"][..., None]
    inside = ((bx >= x0) & (bx + tc.D <= x0 + b["ncols"][..., None])
              & (by >= y0) & (by + tc.D <= y0 + b["nrows"][..., None]))
    assert inside[b["window_fits"]].all()
    assert torch.equal(b["fits"], b["window_fits"].all(-1))


@pytest.mark.parametrize("kind", KINDS)
def test_boxes_lie_in_the_padded_map(kind):
    b = _plan(patch_coords(kind))
    Hp = torch.tensor([h for h, _ in HW])
    Wp = torch.tensor([w for _, w in HW])
    assert (b["x0"] >= 0).all() and (b["y0"] >= 0).all()
    assert (b["x0"] + tc.DW <= Wp).all()
    assert (b["y0"] + b["nrows"] <= Hp).all()
    for key in ("nrows", "ncols"):
        assert (b[key] >= tc.D).all() and (b[key] <= 2 * tc.D).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compact_patches_always_fit(seed):
    """3x3 patches at one depth (pixels 1 px apart, jitter under 0.5 px),
    centred anywhere on the map or beyond it, fit one box at both
    levels."""
    rng = np.random.default_rng(seed)
    E = 500
    ctr = rng.uniform([-20.0, -20.0], [W + 20, H + 20], (E, 2))
    grid = np.arange(3) - 1.0
    coords = np.stack(np.broadcast_arrays(
        ctr[:, 0, None, None] + grid[None, None, :],
        ctr[:, 1, None, None] + grid[None, :, None]), 1)
    coords = coords + rng.uniform(-0.45, 0.45, coords.shape)
    assert _plan(coords.astype(np.float32))["fits"].all()


def test_plan_exercises_the_per_window_path():
    for kind in ("spread", "nan", "random"):
        assert not _plan(patch_coords(kind))["fits"].all(), kind
    assert _plan(patch_coords("compact"))["fits"].all()


def test_two_level_plan_is_each_level_at_its_scale():
    coords = patch_coords("borders")
    both = _plan(coords)
    for lvl, (Hp, Wp) in enumerate(HW):
        one = tc.window_boxes(coords * 0.25 ** lvl, [Hp], [Wp])
        for key, val in one.items():
            assert torch.equal(both[key][:, lvl], val[:, 0]), (lvl, key)


@pytest.mark.parametrize("kind", KINDS)
def test_taps_through_the_plan_match_window_taps(kind):
    """The taps as the kernels take them (the 9 patch rows times the box
    rows, each window's 8x8 taps at its origin in its box, or from a box
    of its own) equal the plain version's window taps, at both levels."""
    rng = np.random.default_rng(5)
    E, F, C = 40, 3, 8
    coords = patch_coords(kind, E=E, seed=3)
    ff = rng.integers(0, F, E)
    g = rng.normal(size=(E, tc.P2, C)).astype(np.float32)
    b = _plan(coords)
    bx, by = _origins(coords)
    for lvl, (h, w) in enumerate(((H, W), (H // 4, W // 4))):
        fmap = tc.pad_fmap(torch.as_tensor(
            rng.normal(size=(F, h, w, C)).astype(np.float32)))
        Wp = fmap.shape[2]
        want = tc._window_taps(torch.as_tensor(g), fmap,
                               torch.as_tensor(coords) * 0.25 ** lvl,
                               torch.as_tensor(ff))[0].numpy()
        fm = fmap.numpy()
        got = np.empty_like(want)
        for e in range(E):
            x0, y0 = int(b["x0"][e, lvl]), int(b["y0"][e, lvl])
            nr, nc = int(b["nrows"][e, lvl]), int(b["ncols"][e, lvl])
            plane = np.einsum("pc,rxc->prx", g[e],
                              fm[ff[e], y0:y0 + nr, x0:x0 + nc])
            for p in range(tc.P2):
                x, y = int(bx[e, lvl, p]), int(by[e, lvl, p])
                if b["window_fits"][e, lvl, p]:
                    got[e, p] = plane[p, y - y0:y - y0 + tc.D,
                                      x - x0:x - x0 + tc.D]
                else:
                    px0 = min(x, Wp - tc.DW)
                    own = np.einsum("c,rxc->rx", g[e, p],
                                    fm[ff[e], y:y + tc.D, px0:x + tc.D])
                    got[e, p] = own[:, x - px0:]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


# --- D3's probes: the aligned box of load / convert, and PROBE_PLAN --------

C_PROBE = 128     # the probes' lanes are channels: full width

def _probe_plan(coords, probe):
    return tc.window_boxes(coords, [h for h, _ in HW], [w for _, w in HW],
                           aligned=tc.PROBE_PLAN[probe][0],
                           min_fit=tc.PROBE_MIN_FIT)


@pytest.mark.parametrize("kind", KINDS)
def test_probe_boxes_lie_in_the_map(kind):
    """The aligned plan: windows start at their 8-aligned origin; a fitting
    window's 16 columns and 8 rows lie in its box, the box (at most 24
    columns) and every window's own columns in the padded map."""
    coords = patch_coords(kind)
    b = tc.window_boxes(coords, [h for h, _ in HW], [w for _, w in HW],
                        aligned=True)
    bx, by = _origins(coords)
    Wp = torch.tensor([w for _, w in HW])
    Hp = torch.tensor([h for h, _ in HW])
    wx = b["wx"]
    assert torch.equal(wx, torch.clamp(bx // 8 * 8, max=Wp[:, None] - tc.DW))
    assert ((wx <= bx) & (bx + tc.D <= wx + tc.DW)).all()
    x0, y0 = b["x0"][..., None], b["y0"][..., None]
    inside = ((wx >= x0) & (wx + tc.DW <= x0 + b["ncols"][..., None])
              & (by >= y0) & (by + tc.D <= y0 + b["nrows"][..., None]))
    assert inside[b["window_fits"]].all()
    assert (b["x0"] >= 0).all() and (b["x0"] + b["ncols"] <= Wp).all()
    assert (b["y0"] + b["nrows"] <= Hp).all()
    assert (b["ncols"] <= tc.PROBE_BOX_W).all()
    assert (wx + tc.DW <= Wp[:, None]).all()


def test_compact_patches_fit_the_probe_box():
    rng = np.random.default_rng(4)
    E = 500
    ctr = rng.uniform([-20.0, -20.0], [W + 20, H + 20], (E, 2))
    grid = np.arange(3) - 1.0
    coords = np.stack(np.broadcast_arrays(
        ctr[:, 0, None, None] + grid[None, None, :],
        ctr[:, 1, None, None] + grid[None, :, None]), 1)
    coords = (coords + rng.uniform(-0.45, 0.45, coords.shape)).astype(
        np.float32)
    for probe in tc.PROBES:
        assert _probe_plan(coords, probe)["fits"].all(), probe


def probe_through_plan(probe, g, fmaps, coords, ff):
    """A probe's values as its kernel takes them: a fitting window's rows
    and columns from its (edge, level) box, the others from the probe's own
    columns, ``PROBE_PLAN``'s pixels from wx; convert as two 8-pixel sums
    -> (E, 2, 9, 8, 128)."""
    own_w = tc.PROBE_PLAN[probe][1]
    b = _probe_plan(coords, probe)
    _, by = _origins(coords)
    E, C = g.shape[0], g.shape[-1]
    out = np.zeros((E, 2, tc.P2, tc.D, 128), np.float32)
    for e in range(E):
        for lvl, fmap in enumerate(fmaps):
            fm = fmap[ff[e]]
            x0, y0 = int(b["x0"][e, lvl]), int(b["y0"][e, lvl])
            nr, nc = int(b["nrows"][e, lvl]), int(b["ncols"][e, lvl])
            box = fm[y0:y0 + nr, x0:x0 + nc]
            for p in range(tc.P2):
                wx, y = int(b["wx"][e, lvl, p]), int(by[e, lvl, p])
                if b["window_fits"][e, lvl, p]:
                    src = box[y - y0:y - y0 + tc.D, wx - x0:]
                else:
                    src = fm[y:y + tc.D, wx:wx + own_w]
                    assert src.shape[1] == own_w
                if probe in ("p_load", "p_roll"):
                    v = src[:, 0]
                elif probe == "p_convert":
                    v = src[:, :8].sum(1) + src[:, 8:16].sum(1)
                elif probe == "p_mult_subl":
                    v = (src[:, :tc.D] * g[e, p]).sum(1)
                else:
                    v = np.zeros((tc.D, 128), np.float32)
                    v[:, :tc.D] = src[:, :tc.D] @ g[e, p]
                out[e, lvl, p, :, :v.shape[-1]] = v
    return out


@pytest.mark.parametrize("probe", tc.PROBES)
@pytest.mark.parametrize("kind", KINDS)
def test_probes_through_the_plan_match_plain(kind, probe):
    """Each probe read through its plan equals ``corr_probe_plain`` (fp32,
    1e-5 of the largest value: summation order only)."""
    rng = np.random.default_rng(6)
    E, F = 16, 3
    coords = patch_coords(kind, E=E, seed=7)
    ff = rng.integers(0, F, E)
    g = rng.normal(size=(E, tc.P2, C_PROBE)).astype(np.float32)
    fmaps = [tc.pad_fmap(torch.as_tensor(rng.normal(
        size=(F, h, w, C_PROBE)).astype(np.float32)))
        for h, w in ((H, W), (H // 4, W // 4))]
    want = tc.corr_probe_plain(torch.as_tensor(g), *fmaps,
                               torch.as_tensor(coords),
                               torch.as_tensor(ff, dtype=torch.int32),
                               probe).numpy()
    got = probe_through_plan(probe, g, [f.numpy() for f in fmaps], coords,
                             ff)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
