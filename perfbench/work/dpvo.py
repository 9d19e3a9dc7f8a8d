"""Operations and bytes of DPVO's frame, counted from shapes: the yardstick
of ``frame_mfu`` and of the kernels' roofline shares.

FLOPs count a multiply-add as two.  A frame's model FLOPs are its two
``BasicEncoder4`` passes at the frame size and, for each update, the update
operator over the live edges: the correlation's taps (two levels, 3x3
patch pixels, 8x8 taps, 128 channels), its 882x384 projection, the fifteen
384x384 layers run per edge, the two soft aggregations' output layers run
per group, and the two heads.  BA, the norms and the elementwise work are
left out.

A kernel's least time is the larger of its bytes at the memory's rate and
its operations at the peak of its precision (``peaks.json``): each input
byte it needs counted once, each output byte once, at the live rows of the
call.
"""
from __future__ import annotations

import json
from pathlib import Path

C = 128          # fmap channels
DIM = 384        # update operator width
P2 = 9           # 3x3 patch pixels
TAPS = 64        # 8x8 integer taps per pixel and level
LEVELS = 2
CORR_DIM = 2 * 49 * P2   # 882

PEAKS = json.loads((Path(__file__).resolve().parent.parent
                    / "peaks.json").read_text())


def encoder_flops(H, W, out):
    """One BasicEncoder4 pass at an H x W frame."""
    h2, w2, h4, w4 = H // 2, W // 2, H // 4, W // 4
    macs = (h2 * w2 * 32 * 3 * 49 + 4 * h2 * w2 * 32 * 32 * 9
            + h4 * w4 * (64 * 32 * 9 + 64 * 64 * 9 + 64 * 32)
            + 2 * h4 * w4 * 64 * 64 * 9 + h4 * w4 * out * 64)
    return 2 * macs


def tracking_flops(H, W):
    return encoder_flops(H, W, C) + encoder_flops(H, W, DIM)


def update_flops(edges, groups):
    """The update operator over ``edges`` live edges whose patches and frame
    pairs form ``groups`` groups in all."""
    per_edge = (LEVELS * P2 * TAPS * C + CORR_DIM * DIM + 15 * DIM * DIM
                + 2 * 2 * DIM)
    return 2 * (edges * per_edge + groups * DIM * DIM)


def bound_s(nbytes, nops, precision):
    return max(nbytes / PEAKS["hbm_bytes_per_s"],
               nops / PEAKS["flops_per_s"][precision])


def corr_least_s(edges, patches, window_bytes, elem=2):
    """K2 (correlation and the projection's first layer in one kernel) at
    ``edges`` live edges reading ``patches`` distinct patches' features and
    ``window_bytes`` of distinct feature-map pixels."""
    nbytes = (window_bytes + patches * P2 * C * elem + CORR_DIM * DIM * elem
              + edges * (2 * P2 * 4 + 2 * 4) + edges * DIM * elem)
    nops = 2 * edges * (LEVELS * P2 * TAPS * C + CORR_DIM * DIM)
    return bound_s(nbytes, nops, "bf16" if elem == 2 else "fp32")


def agg_least_s(edges, groups_kk, groups_ij, free_poses, patches,
                iterations=2):
    """K3 (the soft aggregations' grouped softmax sums, over patches and
    over frame pairs) and K4 (local BA's pose-depth coupling sums, one call
    per Gauss-Newton iteration), fp32."""
    t = 0.0
    for groups in (groups_kk, groups_ij):
        nbytes = edges * (2 * DIM * 4 + 4) + DIM * 4 + groups * 2 * DIM * 4
        t += bound_s(nbytes, 4 * edges * DIM, "fp32")
    cols = 6 * free_poses + 2
    nbytes = edges * (cols * 4 + 4) + patches * cols * 4
    t += iterations * bound_s(nbytes, edges * cols, "fp32")
    return t
