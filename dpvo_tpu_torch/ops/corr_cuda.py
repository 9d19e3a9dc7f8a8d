"""Patch correlation on zero-padded feature rings: the CUDA kernels and
their plain twins.

Counterpart of ``dpvo_tpu/ops/corr_pallas.py``:

- ``corr_enc`` (K2, ``csrc/corr_enc.cu``): two-level correlation fused with
  the corr encoder's first matmul, ``corr_pallas_enc``;
- ``corr_fused`` (K1, ``csrc/corr_raw.cu``): two-level correlation in the
  raw, v10 or v12 feature layout, ``corr_pallas_fused``;
- ``corr_single`` (K5, the same source) and ``corr_grouped``: one level, raw
  or the reference's (E, 7, 7, 3, 3) order, ``corr_pallas``;
- ``corr_probe`` (D3, the same source): K1's box stage stopped after one
  phase, ``scripts/dev/corr_variants.py:probe_variant``.

On bf16 rings the kernels take each patch's 9 windows at a level from one
box of ring rows read once (``window_boxes`` is the plan, in Python; the
probes' is ``window_boxes(aligned=...)`` with ``PROBE_PLAN``); fp32 rings
keep the per-window-row stage.

Feature rings are stored zero-padded (``pad_fmap``), so every 8x8 tap
window is an in-bounds read and out-of-image taps read zeros.  The kernels
take edges in table order with a ring slot per edge (``ff_rows``): no frame
grouping, no tile padding.  ``n_live_rows`` zeroes every row at or past it,
as the TPU kernels zero their dead tail tiles.

Feature order: the kernels blend into the raw (level, p, dy, dx) order; the
reference's interleaved corr-encoder rows are (dx, dy, py, px, level).
``raw_enc_kernel`` reorders the checkpoint-shaped corr1 kernel's ROWS to a
kernel layout (``raw_to_ref_perm``, ``v10_row_map``, ``v12_row_map``),
which keeps the matmul exact.

``FUSED_VERSION`` is the port's read of ``DPVO_CORR_VERSION`` (default 13):
the engine reads it at call time, runs K2 at 13 and K1 in the layout of
``layout_for_version`` otherwise.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F

from . import _cuda

PAD = 8        # zero border on top/left/bottom (and at least PAD on right)
R = 3          # correlation radius (2R+2 = 8 tap rows/cols)
D = 2 * R + 2  # tap window size
DW = 16        # the TPU kernels' aligned window width (v12 lanes per row)
P2 = 9         # patch pixels (3x3)
C = 128        # feature channels
RAW_DIM = P2 * (D - 1) * (D - 1)   # per-level feature dim (441)
V10_DIM = P2 * 128                 # v10 feature dim incl. dead lanes
V12_DIM = P2 * 256                 # v12 feature dim incl. dead lanes

FUSED_VERSION = int(os.environ.get("DPVO_CORR_VERSION", "13"))

# output layouts of csrc/corr_raw.cu (its Layout enum)
_LAYOUTS = {"raw": 0, "v10": 1, "v12": 2, "ref": 3}
# D3's phase probes, in pipeline order (csrc/corr_window.cuh's Probe enum)
PROBES = ("p_load", "p_convert", "p_roll", "p_mult_subl", "p_full_dot")
PROBE_TILE = 16    # edges of the probe's output block (the TPU's last tile)
PROBE_BOX_W = DW + D   # columns of the load / convert probes' aligned box
PROBE_MIN_FIT = 5      # windows that must fit before a probe reads a box
# per probe (csrc/corr_window.cuh ProbePlan): whether its box is the
# 8-aligned one (window_boxes(aligned=True)), and the pixels per window row
# its per-window path reads
PROBE_PLAN = {"p_load": (True, 1), "p_convert": (True, DW),
              "p_roll": (False, 1), "p_mult_subl": (False, D),
              "p_full_dot": (False, D)}


def layout_for_version(version):
    """K1's output layout for a ``DPVO_CORR_VERSION``: v12 for 12 (and 13,
    whose standalone core is v12), v10 for 10, raw for the v4-family."""
    return {12: "v12", 13: "v12", 10: "v10"}.get(version, "raw")


def padded_hw(H, W):
    """Padded frame dims: PAD border, W rounded up to a multiple of 8."""
    Wp = W + 2 * PAD
    return H + 2 * PAD, Wp + (-Wp % 8)


def pad_fmap(fmap):
    """(F, H, W, C) -> (F, Hp, Wp, C) zero-padded (see padded_hw)."""
    _, H, W, _ = fmap.shape
    Hp, Wp = padded_hw(H, W)
    return F.pad(fmap, (0, 0, PAD, Wp - W - PAD, PAD, Hp - H - PAD))


def _ref_row(level, py, px, dy, dx):
    """Row of the reference's interleaved (dx, dy, py, px, level) order."""
    return (((dx * (D - 1) + dy) * 3 + py) * 3 + px) * 2 + level


def raw_to_ref_perm():
    """Row permutation mapping the raw (level, p, dy, dx) feature order to
    the reference's interleaved (dx, dy, py, px, level) order."""
    return np.array([_ref_row(level, py, px, dy, dx)
                     for level in range(2) for py in range(3)
                     for px in range(3) for dy in range(D - 1)
                     for dx in range(D - 1)], np.int64)


def _lane_row_map(width):
    """Rows of the (p, level, dy < 8, dx < width) lane layouts; dead lanes
    (dy or dx >= 7) map to the zero row 2*RAW_DIM."""
    rows = np.full(P2 * 2 * D * width, 2 * RAW_DIM, np.int64)
    i = 0
    for py in range(3):
        for px in range(3):
            for level in range(2):
                for dy in range(D):
                    for dx in range(width):
                        if dy < D - 1 and dx < D - 1:
                            rows[i] = _ref_row(level, py, px, dy, dx)
                        i += 1
    return rows


def v10_row_map():
    """Rows of the v10 layout (E, 9, 128), lanes level*64 + dy*8 + dx."""
    return _lane_row_map(D)


def v12_row_map():
    """Rows of the v12 layout (E, 9, 256), lanes level*128 + dy*16 + dx."""
    return _lane_row_map(DW)


@functools.lru_cache(maxsize=None)
def _layout_rows(in_dim, device):
    """The row index of ``raw_enc_kernel``'s layout of width ``in_dim`` on
    ``device``, built once per process (the engine asks at every update).
    Callers only index with it."""
    maps = {2 * RAW_DIM: raw_to_ref_perm, V10_DIM: v10_row_map,
            V12_DIM: v12_row_map}
    if in_dim not in maps:
        raise ValueError(f"no corr feature layout of width {in_dim}")
    return torch.as_tensor(maps[in_dim](), device=device)


def raw_enc_kernel(kernel, in_dim=2 * RAW_DIM):
    """(2*RAW_DIM, DIMo) corr1 kernel in (in, out) layout with reference
    row order -> the rows of a kernel feature layout of width ``in_dim``:
    882 (raw), 1152 (v10) or 2304 (v12); dead lanes get a zero row."""
    rows = _layout_rows(in_dim, kernel.device)
    if in_dim != 2 * RAW_DIM:
        kernel = torch.cat([kernel, kernel.new_zeros((1, kernel.shape[1]))])
    return kernel[rows].contiguous()


def _window_origin(c, Hp, Wp):
    """c (E, 2, 3, 3) level coords -> the 8x8 windows' origins bx, by
    (E, P2) int64 in the padded map, clamped in float (non-finite coords
    stay in bounds), and the fractional offsets fx, fy (E, P2)."""
    E = c.shape[0]
    cx = c[:, 0].reshape(E, P2)
    cy = c[:, 1].reshape(E, P2)
    bx_f, by_f = torch.floor(cx), torch.floor(cy)
    bx = torch.nan_to_num(bx_f + (PAD - R), nan=0.0).clamp(0, Wp - D).long()
    by = torch.nan_to_num(by_f + (PAD - R), nan=0.0).clamp(0, Hp - D).long()
    return bx, by, cx - bx_f, cy - by_f


def window_boxes(coords, Hp, Wp, aligned=False, min_fit=1):
    """The box plan of the bf16 kernels' window stage
    (``csrc/corr_window.cuh``, ``level_taps``), per (edge, level).

    coords  (E, 2, 3, 3) level-1 pixel coords (unpadded; numpy or torch)
    Hp, Wp  sequences of the padded map dims, one per level; level l
            samples coords / 4**l
    aligned the plan of D3's load and convert probes (``probe_level``):
            windows read DW columns from their 8-aligned origin
            min(8 * (bx // 8), Wp - DW) instead of 8 from bx
    min_fit the box is read only when at least this many of the 9 windows
            fit it; otherwise none counts as fitting (the probes:
            ``PROBE_MIN_FIT``)
    -> dict of torch tensors: ``x0``, ``y0``, ``nrows``, ``ncols`` (E, L)
    int64, the box of rows [y0, y0 + nrows) and columns [x0, x0 + ncols)
    of the padded map; ``wx`` (E, L, 9) each window's first column;
    ``window_fits`` (E, L, 9) whether each window lies in the box; ``fits``
    (E, L) whether all 9 do.  The box starts at the windows' smallest
    origin (x0 moved left so 16 columns stay inside the map) and spans at
    most 16 rows and 16 columns (aligned: 24 columns, and a window fits
    when its origin is x0 or x0 + 8); a window that does not fit is read
    from a box of its own, its 8 rows from its origin (the kernels' columns:
    K1 and K2 from min(bx, Wp - 16) to bx + 8, the probes ``PROBE_PLAN``'s
    from wx).
    """
    c = torch.as_tensor(coords, dtype=torch.float32)
    keys = ("x0", "y0", "nrows", "ncols", "wx", "window_fits")
    out = {k: [] for k in keys}
    width, box_w = (DW, PROBE_BOX_W) if aligned else (D, DW)
    for level, (H, W) in enumerate(zip(Hp, Wp)):
        bx, by, _, _ = _window_origin(c * 0.25 ** level, H, W)
        if aligned:
            wx = torch.clamp(torch.div(bx, 8, rounding_mode="floor") * 8,
                             max=W - DW)
            x0 = wx.min(1).values
            dx = wx - x0[:, None]
            fit_x = (dx == 0) | (dx == D)
        else:
            wx = bx
            x0 = torch.clamp(bx.min(1).values, max=W - DW)
            fit_x = wx - x0[:, None] <= D
        y0 = by.min(1).values
        out["x0"].append(x0)
        out["y0"].append(y0)
        out["nrows"].append(torch.clamp(by.max(1).values - y0 + D,
                                        max=2 * D))
        out["ncols"].append(torch.clamp(wx.max(1).values - x0 + width,
                                        max=box_w))
        out["wx"].append(wx)
        fit = fit_x & (by - y0[:, None] <= D)
        out["window_fits"].append(fit & (fit.sum(1, keepdim=True)
                                         >= min_fit))
    out = {k: torch.stack(v, 1) for k, v in out.items()}
    out["fits"] = out["window_fits"].all(-1)
    return out


def _window_pixels(fmap, ff, bx, by, width):
    """The ``width`` pixels from column bx of the 8 window rows from by:
    fmap (F, Hp, Wp, C), ff (E,), bx, by (E, P2) -> (E, P2, D, width, C)."""
    E = bx.shape[0]
    _, Hp, Wp, Cc = fmap.shape
    rows = torch.arange(D, device=fmap.device)
    cols = torch.arange(width, device=fmap.device)
    lin = ((ff.long()[:, None, None, None] * Hp
            + by[..., None, None] + rows[:, None]) * Wp
           + bx[..., None, None] + cols)                # (E, P2, D, width)
    return fmap.reshape(-1, Cc)[lin.reshape(-1)].reshape(E, P2, D, width, Cc)


def _window_taps(g_rows, fmap, c, ff):
    """Taps of every (edge, pixel) 8x8 window: g_rows (E, P2, C), fmap
    (F, Hp, Wp, C), c (E, 2, 3, 3) level coords, ff (E,) ring slots ->
    (taps (E, P2, D, D) fp32, fx, fy (E, P2))."""
    bx, by, fx, fy = _window_origin(c, *fmap.shape[1:3])
    win = _window_pixels(fmap, ff, bx, by, D)
    taps = torch.einsum("epc,epyxc->epyx", g_rows.float(), win.float())
    return taps, fx, fy


def _blend_plain(g_pre, levels, coords, ff_rows, chunk=4096):
    """fp32 blended correlation (E, L, P2, 7, 7) of g_pre (E, P2, C)
    against ``levels`` ((fmap_padded, coord scale), ...): fp32 taps, y then
    x blend.  Chunked over edges to bound the gathered windows."""
    E = coords.shape[0]
    outs = []
    for s in range(0, E, chunk):
        c = coords[s:s + chunk].float()
        g = g_pre[s:s + chunk]
        ff = ff_rows[s:s + chunk]
        lv = []
        for fmap, scale in levels:
            taps, fx, fy = _window_taps(g, fmap, c * scale, ff)
            fx, fy = fx[..., None, None], fy[..., None, None]
            ty = (1 - fy) * taps[:, :, :-1, :] + fy * taps[:, :, 1:, :]
            lv.append((1 - fx) * ty[..., :-1] + fx * ty[..., 1:])
        outs.append(torch.stack(lv, 1))
    if not outs:
        return torch.zeros((0, len(levels), P2, D - 1, D - 1),
                           device=coords.device)
    return torch.cat(outs)


def _zero_tail(raw, n_live_rows):
    if n_live_rows is not None and n_live_rows < raw.shape[0]:
        raw[max(n_live_rows, 0):] = 0.0
    return raw


def corr_fused_plain(g_pre, fmap1_padded, fmap2_padded, coords, ff_rows,
                     layout="raw", out_dtype=torch.float32,
                     n_live_rows=None):
    """Plain PyTorch version of ``corr_fused`` (fp32 taps, y-then-x blend,
    one rounding to ``out_dtype``; dead lanes and rows zero)."""
    raw = _zero_tail(_blend_plain(
        g_pre, ((fmap1_padded, 1.0), (fmap2_padded, 0.25)), coords,
        ff_rows), n_live_rows)                          # (E, 2, P2, 7, 7)
    if layout == "raw":
        return raw.to(out_dtype)
    if layout not in ("v10", "v12"):
        raise ValueError(f"corr_fused layout must be raw, v10 or v12, "
                         f"not {layout!r}")
    E = raw.shape[0]
    width = D if layout == "v10" else DW
    out = raw.new_zeros((E, P2, 2, D, width))
    out[..., :D - 1, :D - 1] = raw.transpose(1, 2)
    return out.reshape(E, P2, -1).to(out_dtype)


def corr_single_plain(g_pre, fmap_padded, coords, ff_rows, raw=False,
                      out_dtype=torch.float32, n_live_rows=None):
    """Plain PyTorch version of ``corr_single``."""
    out = _zero_tail(_blend_plain(g_pre, ((fmap_padded, 1.0),), coords,
                                  ff_rows), n_live_rows)[:, 0]
    if not raw:           # (E, p, dy, dx) -> (E, dx, dy, py, px)
        out = out.reshape(-1, 3, 3, D - 1, D - 1).permute(0, 4, 3, 1, 2)
    return out.to(out_dtype).contiguous()


def corr_enc_plain(g_all, kk_rows, w_raw, fmap1_padded, fmap2_padded,
                   coords, ff_rows, chunk=4096):
    """Plain PyTorch version of ``corr_enc``: ``corr_fused_plain`` in the
    raw layout, cast to the compute dtype, then the product with fp32
    accumulation.  Chunked over edges to bound the gathered windows."""
    E = coords.shape[0]
    outs = []
    for s in range(0, E, chunk):
        g = g_all[kk_rows[s:s + chunk].long()]            # (e, P2, C)
        feat = corr_fused_plain(g, fmap1_padded, fmap2_padded,
                                coords[s:s + chunk], ff_rows[s:s + chunk],
                                "raw", w_raw.dtype)
        outs.append(feat.reshape(g.shape[0], -1) @ w_raw)
    if not outs:
        return torch.zeros((0, w_raw.shape[1]), dtype=w_raw.dtype,
                           device=w_raw.device)
    return torch.cat(outs)


def corr_enc(g_all, kk_rows, w_raw, fmap1_padded, fmap2_padded, coords,
             ff_rows):
    """Two-level correlation fused with the corr encoder's first matmul.

    g_all        (K, P2, C) the whole gmap ring, compute dtype
    kk_rows      (E,) int32 row of each edge's patch in g_all
    w_raw        (2*RAW_DIM, DIMo) corr1 kernel, raw row order
                 (``raw_enc_kernel``), compute dtype
    fmap1_padded (F, Hp1, Wp1, C), fmap2_padded (F, Hp2, Wp2, C) rings
    coords       (E, 2, 3, 3) fp32 level-1 pixel coords (unpadded)
    ff_rows      (E,) int32 ring slot of each edge's target frame
    -> (E, DIMo) pre-bias activations in the compute dtype.
    """
    if coords.device.type == "cpu":
        return corr_enc_plain(g_all, kk_rows, w_raw, fmap1_padded,
                              fmap2_padded, coords, ff_rows)
    dt = w_raw.dtype
    if dt == torch.float32:
        fn = "dpvo_corr_enc_f32"
    elif dt == torch.bfloat16:
        fn = "dpvo_corr_enc_bf16"
    else:
        raise ValueError(f"corr_enc supports float32 and bfloat16, not {dt}")
    E = coords.shape[0]
    K = g_all.shape[0]
    Fn, Hp1, Wp1, _ = fmap1_padded.shape
    _, Hp2, Wp2, _ = fmap2_padded.shape
    DIMo = w_raw.shape[1]
    _cuda.require(g_all, "g_all", dt, (K, P2, C), aligned=True)
    _cuda.require(kk_rows, "kk_rows", torch.int32, (E,))
    _cuda.require(w_raw, "w_raw", dt, (2 * RAW_DIM, DIMo), aligned=True)
    _cuda.require(fmap1_padded, "fmap1_padded", dt, (Fn, Hp1, Wp1, C),
                  aligned=True)
    _cuda.require(fmap2_padded, "fmap2_padded", dt, (Fn, Hp2, Wp2, C),
                  aligned=True)
    _cuda.require(coords, "coords", torch.float32, (E, 2, 3, 3))
    _cuda.require(ff_rows, "ff_rows", torch.int32, (E,))
    _check_maps(dt, (Hp1, Wp1), (Hp2, Wp2))
    if dt == torch.bfloat16 and (DIMo <= 0 or DIMo % 16):
        raise ValueError(f"corr_enc on bf16 needs a positive multiple of 16 "
                         f"output columns (mma n-tile pairs), got {DIMo}")
    out = torch.empty((E, DIMo), dtype=dt, device=coords.device)
    code = getattr(_cuda.lib(), fn)(
        g_all.data_ptr(), kk_rows.data_ptr(), ff_rows.data_ptr(),
        w_raw.data_ptr(), fmap1_padded.data_ptr(), fmap2_padded.data_ptr(),
        coords.data_ptr(), out.data_ptr(), E, Hp1, Wp1, Hp2, Wp2, DIMo,
        _cuda.stream_ptr(out.device))
    _cuda.check(code, "corr_enc")
    _cuda.launches["corr_enc"] += 1
    return out


def _check_maps(dtype, *hw):
    """Map sizes the kernels take: every window inside, and on bf16 rings
    a 16-column box row inside (``padded_hw`` gives at least 24)."""
    if min(min(h, w) for h, w in hw) < D:
        raise ValueError("padded feature maps must be at least 8x8")
    if dtype == torch.bfloat16 and min(w for _, w in hw) < DW:
        raise ValueError(f"bf16 padded feature maps must be at least {DW} "
                         f"columns wide")


def _corr_raw(name, levels, layout, shape, g_pre, fmaps, coords, ff_rows,
              out_dtype, n_live_rows):
    """Launch csrc/corr_raw.cu at ``levels`` levels into ``layout``."""
    dt = g_pre.dtype
    kinds = (torch.float32, torch.bfloat16)
    if dt not in kinds or out_dtype not in kinds:
        raise ValueError(f"{name} supports float32 and bfloat16, not "
                         f"{dt} -> {out_dtype}")
    E = coords.shape[0]
    _cuda.require(g_pre, "g_pre", dt, (E, P2, C), aligned=True)
    Fn = fmaps[0].shape[0]
    for i, fm in enumerate(fmaps, 1):
        _cuda.require(fm, f"fmap{i}_padded", dt, (Fn, None, None, C),
                      aligned=True)
    _check_maps(dt, *(fm.shape[1:3] for fm in fmaps))
    _cuda.require(coords, "coords", torch.float32, (E, 2, 3, 3))
    _cuda.require(ff_rows, "ff_rows", torch.int32, (E,))
    n_live = E if n_live_rows is None else min(max(int(n_live_rows), 0), E)
    f1, f2 = fmaps[0], fmaps[-1]
    out = torch.empty((E, *shape), dtype=out_dtype, device=coords.device)
    code = _cuda.lib().dpvo_corr_raw(
        levels, int(dt == torch.bfloat16), int(out_dtype == torch.bfloat16),
        _LAYOUTS[layout], g_pre.data_ptr(), ff_rows.data_ptr(),
        f1.data_ptr(), f2.data_ptr(), coords.data_ptr(), out.data_ptr(), E,
        n_live, f1.shape[1], f1.shape[2], f2.shape[1], f2.shape[2],
        _cuda.stream_ptr(out.device))
    _cuda.check(code, name)
    _cuda.launches[name] += 1
    return out


def corr_fused(g_pre, fmap1_padded, fmap2_padded, coords, ff_rows,
               layout="raw", out_dtype=torch.float32, n_live_rows=None):
    """Two-level correlation (K1).

    g_pre        (E, P2, C) patch feature rows, bf16 or fp32
    fmap1_padded (F, Hp1, Wp1, C), fmap2_padded (F, Hp2, Wp2, C) rings of
                 g_pre's dtype; level 2 samples coords / 4
    coords       (E, 2, 3, 3) fp32 level-1 pixel coords (unpadded)
    ff_rows      (E,) int32 ring slot of each edge's target frame
    layout       "raw" -> (E, 2, P2, 7, 7) in (level, p, dy, dx) order;
                 "v10" -> (E, P2, 128), lanes level*64 + dy*8 + dx;
                 "v12" -> (E, P2, 256), lanes level*128 + dy*16 + dx;
                 dead lanes (dy or dx >= 7) are zero
    n_live_rows  rows at or past it are zero (default: none)
    -> features in ``out_dtype``.
    """
    if coords.device.type == "cpu":
        return corr_fused_plain(g_pre, fmap1_padded, fmap2_padded, coords,
                                ff_rows, layout, out_dtype, n_live_rows)
    shapes = {"raw": (2, P2, D - 1, D - 1), "v10": (P2, 128),
              "v12": (P2, 256)}
    if layout not in shapes:
        raise ValueError(f"corr_fused layout must be raw, v10 or v12, "
                         f"not {layout!r}")
    return _corr_raw("corr_fused", 2, layout, shapes[layout], g_pre,
                     (fmap1_padded, fmap2_padded), coords, ff_rows,
                     out_dtype, n_live_rows)


def corr_single(g_pre, fmap_padded, coords, ff_rows, raw=False,
                out_dtype=torch.float32, n_live_rows=None):
    """One-level correlation (K5): the arguments of ``corr_fused`` at one
    ring, sampled at ``coords`` as given.  -> (E, 7, 7, 3, 3) in the
    reference's [dx, dy, py, px] order, or with ``raw`` (E, P2, 7, 7) in
    (p, dy, dx) order, in ``out_dtype``."""
    if coords.device.type == "cpu":
        return corr_single_plain(g_pre, fmap_padded, coords, ff_rows, raw,
                                 out_dtype, n_live_rows)
    shape = (P2, D - 1, D - 1) if raw else (D - 1, D - 1, 3, 3)
    return _corr_raw("corr_single", 1, "raw" if raw else "ref", shape,
                     g_pre, (fmap_padded,), coords, ff_rows, out_dtype,
                     n_live_rows)


def corr_grouped(gmap, fmap_padded, coords, kidx, ff_rows):
    """Gather the patch rows gmap[kidx] ((K, 3, 3, C) -> (E, P2, C)) and
    run ``corr_single``: (E, 7, 7, 3, 3) fp32 in the reference's order."""
    E = coords.shape[0]
    g_pre = gmap[kidx.long()].reshape(E, P2, gmap.shape[-1])
    return corr_single(g_pre, fmap_padded, coords, ff_rows)


def _probe_edges(E):
    if E < PROBE_TILE or E % PROBE_TILE:
        raise ValueError(f"corr_probe needs a positive multiple of "
                         f"{PROBE_TILE} edges, got {E}")


def corr_probe_plain(g_pre, fmap1_padded, fmap2_padded, coords, ff_rows,
                     probe):
    """Plain PyTorch version of ``corr_probe``: the last 16 edges' values,
    in fp32, of ``probe`` at both levels."""
    if probe not in PROBES:
        raise ValueError(f"unknown probe {probe!r}; one of {PROBES}")
    E = coords.shape[0]
    _probe_edges(E)
    s = E - PROBE_TILE
    g = g_pre[s:].float()
    outs = []
    for fmap, scale in ((fmap1_padded, 1.0), (fmap2_padded, 0.25)):
        Hp, Wp = fmap.shape[1:3]
        bx, by, _, _ = _window_origin(coords[s:].float() * scale, Hp, Wp)
        if probe in ("p_load", "p_convert"):      # the 8-aligned origin
            x0 = torch.clamp(torch.div(bx, 8, rounding_mode="floor") * 8,
                             max=Wp - DW)
            win = _window_pixels(fmap, ff_rows[s:], x0, by,
                                 DW if probe == "p_convert" else 1).float()
        else:
            win = _window_pixels(fmap, ff_rows[s:], bx, by,
                                 1 if probe == "p_roll" else D).float()
        if probe == "p_convert":
            v = win.sum(3)
        elif probe == "p_mult_subl":
            v = (win * g[:, :, None, None, :]).sum(3)
        elif probe == "p_full_dot":
            taps = torch.einsum("epc,epyxc->epyx", g, win)
            v = F.pad(taps, (0, C - D))
        else:
            v = win[:, :, :, 0]
        outs.append(v)                                  # (16, P2, D, C)
    return torch.stack(outs, 1).contiguous()


def corr_probe(g_pre, fmap1_padded, fmap2_padded, coords, ff_rows, probe):
    """D3: one phase probe of the two-level correlation's window stage.

    g_pre, fmap1_padded, fmap2_padded  bf16, as for ``corr_fused``
    coords (E, 2, 3, 3) fp32, ff_rows (E,) int32; E a multiple of 16
    probe  one of ``PROBES``:
           p_load      pixel x0 of each window row (x0 the 8-aligned origin
                       min(8 * (bx // 8), Wp - 16) the TPU loads from);
           p_convert   the sum over the 16 pixels from x0, fp32;
           p_roll      pixel bx (the true window's first column);
           p_mult_subl the sum over the window's 8 pixels of pixel * g;
           p_full_dot  the 8 taps g . pixel (no blend), zero-padded to 128
    -> (16, 2, P2, 8, 128) fp32: the last 16 edges' (level, pixel, window
    row, lane) values, as the TPU probe's constant output block holds them.
    """
    if coords.device.type == "cpu":
        return corr_probe_plain(g_pre, fmap1_padded, fmap2_padded, coords,
                                ff_rows, probe)
    if probe not in PROBES:
        raise ValueError(f"unknown probe {probe!r}; one of {PROBES}")
    E = coords.shape[0]
    _probe_edges(E)
    bf = torch.bfloat16
    _cuda.require(g_pre, "g_pre", bf, (E, P2, C), aligned=True)
    Fn = fmap1_padded.shape[0]
    for i, fm in enumerate((fmap1_padded, fmap2_padded), 1):
        _cuda.require(fm, f"fmap{i}_padded", bf, (Fn, None, None, C),
                      aligned=True)
        if fm.shape[1] < D or fm.shape[2] < DW:
            raise ValueError("padded feature maps must be at least 8 rows "
                             "by 16 columns")
    _cuda.require(coords, "coords", torch.float32, (E, 2, 3, 3))
    _cuda.require(ff_rows, "ff_rows", torch.int32, (E,))
    out = torch.empty((PROBE_TILE, 2, P2, D, C), dtype=torch.float32,
                      device=coords.device)
    code = _cuda.lib().dpvo_corr_probe(
        PROBES.index(probe), g_pre.data_ptr(), ff_rows.data_ptr(),
        fmap1_padded.data_ptr(), fmap2_padded.data_ptr(), coords.data_ptr(),
        out.data_ptr(), float("nan"), E, *fmap1_padded.shape[1:3],
        *fmap2_padded.shape[1:3], _cuda.stream_ptr(out.device))
    _cuda.check(code, f"corr_probe ({probe})")
    _cuda.launches[f"corr_probe.{probe}"] += 1
    return out
