"""The DPVO network and its geometry in plain PyTorch: the reference the
benchmark holds the program's outputs to.

Everything runs on a dict of weights keyed as the program's state dicts
(``fnet.*``, ``inet.*`` of the patchifier; ``corr1.*`` ... ``w.*`` of the
update operator), in float32 with TF32 off, or with ``prec="fp8"`` as the
benchmark's control: every convolution's and linear layer's input and
weight, and the stored features, rounded to float8 e4m3 with a per-tensor
scale (the precision one step below the configuration's bf16).  Layer
equations follow DPVO (Teed, Lipson, Deng 2023): two /4-resolution
encoders (``fnet`` with instance norm, 128 channels; ``inet`` without, 384),
3x3 patches, a two-level 7x7 correlation, the update operator with its
temporal neighbours, two soft aggregations and two gated residual blocks.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import lie

DIM = 384
P = 3
RADIUS = 3
FP8_MAX = 448.0


def rnd(t, prec):
    """``t`` as ``prec`` stores it: itself in fp32; rounded to bf16; in fp8,
    rounded to e4m3 after scaling its largest magnitude to the format's
    largest."""
    if prec == "fp32":
        return t
    if prec == "bf16":
        return t.to(torch.bfloat16).float()
    s = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


def conv(w, name, x, prec, stride=1, padding=0):
    return F.conv2d(rnd(x, prec), rnd(w[name + ".weight"].float(), prec),
                    w[name + ".bias"].float(), stride=stride, padding=padding)


def linear(w, name, x, prec):
    return F.linear(rnd(x, prec), rnd(w[name + ".weight"].float(), prec),
                    w[name + ".bias"].float())


def layer_norm(w, name, x, eps=1e-3):
    return F.layer_norm(x, (x.shape[-1],), w[name + ".weight"].float(),
                        w[name + ".bias"].float(), eps)


def instance_norm(x, eps=1e-5):
    mean = x.mean(dim=(-2, -1), keepdim=True)
    var = x.var(dim=(-2, -1), unbiased=False, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps)


def encoder(w, pre, img, norm, prec):
    """BasicEncoder4: img (1, 3, H, W) -> (H/4, W/4, C)."""
    nf = instance_norm if norm else (lambda t: t)
    x = F.relu(nf(conv(w, pre + "conv1", img, prec, 2, 3)))
    for blk, stride in (("layer1_0", 1), ("layer1_1", 1), ("layer2_0", 2),
                        ("layer2_1", 1)):
        b = f"{pre}{blk}."
        y = F.relu(nf(conv(w, b + "conv1", x, prec, stride, 1)))
        y = F.relu(nf(conv(w, b + "conv2", y, prec, 1, 1)))
        if stride != 1:
            x = nf(conv(w, b + "downsample", x, prec, stride))
        x = F.relu(x + y)
    return conv(w, pre + "conv2", x, prec)[0].permute(1, 2, 0)


def sample(fmap, pts):
    """Bilinear samples of fmap (h, w, C) at pts (..., 2) [x, y], zero
    outside the map -> (..., C)."""
    h, wd, C = fmap.shape
    base = torch.floor(pts)
    off = pts - base
    out = 0
    for dy in (0, 1):
        for dx in (0, 1):
            x = base[..., 0].long() + dx
            y = base[..., 1].long() + dy
            ok = (x >= 0) & (x < wd) & (y >= 0) & (y < h)
            v = fmap[y.clamp(0, h - 1), x.clamp(0, wd - 1)]
            wt = ((off[..., 0] if dx else 1 - off[..., 0])
                  * (off[..., 1] if dy else 1 - off[..., 1]))
            out = out + v * (wt * ok)[..., None]
    return out


def patch_grid(ctr):
    """Centroids (M, 2) -> the 3x3 pixel grid (M, P, P, 2) [x, y] around
    each, rows y, columns x."""
    o = torch.arange(P, device=ctr.device, dtype=torch.float32) - P // 2
    gx = ctr[:, None, None, 0] + o[None, None, :]
    gy = ctr[:, None, None, 1] + o[None, :, None]
    return torch.stack(torch.broadcast_tensors(gx, gy), dim=-1)


def avg_pool4(fmap):
    """4x4 average pooling, stride 4 (a partial border is dropped)."""
    h, wd, C = fmap.shape
    h, wd = h // 4, wd // 4
    return fmap[:4 * h, :4 * wd].reshape(h, 4, wd, 4, C).mean(dim=(1, 3))


def frame_features(w, image_u8, ctr, prec):
    """One frame's features at its patch centroids: image (H, W, 3) uint8,
    ctr (M, 2) feature-resolution centroids -> dict fmap1 (h, w, 128),
    fmap2 (h/4, w/4, 128), gmap (M, P, P, 128), imap (M, DIM)."""
    img = (2.0 * (image_u8.float() / 255.0) - 0.5).permute(2, 0, 1)[None]
    fmap = rnd(encoder(w, "fnet.", img, True, prec) / 4.0, prec)
    imap = rnd(encoder(w, "inet.", img, False, prec) / 4.0, prec)
    return dict(fmap1=fmap, fmap2=rnd(avg_pool4(fmap), prec),
                gmap=sample(fmap, patch_grid(ctr)),
                imap=sample(imap, ctr))


def reproject(poses, ctr, depth, intr, ii, jj, kk):
    """The patch grids of patches kk, from frame ii into frame jj:
    poses (n, 7), ctr (K, 2), depth (K,), intr (4,) -> (E, P, P, 2)."""
    fx, fy, cx, cy = intr
    g = patch_grid(ctr[kk])
    d = depth[kk][:, None, None].expand(g.shape[:-1])
    X0 = torch.stack([(g[..., 0] - cx) / fx, (g[..., 1] - cy) / fy,
                      torch.ones_like(d), d], dim=-1)
    Gij = lie.mul(poses[jj], lie.inv(poses[ii]))
    X1 = lie.act4(Gij[:, None, None], X0)
    z = 1.0 / X1[..., 2].clamp(min=0.1)
    return torch.stack([fx * z * X1[..., 0] + cx, fy * z * X1[..., 1] + cy],
                       dim=-1)


def correlation(gmap, fmaps, coords, prec, chunk=1024):
    """Two-level correlation: gmap (E, P, P, C) the edges' patch features,
    fmaps a (maps (F, h, w, C), fidx (E,)) pair per level, coords (E, P, P,
    2) in level-1 pixels -> (E, 882) in the order of the corr1 weight: (x
    offset, y offset, patch row, patch column, level).  Each level takes the 8x8
    integer taps around floor(coords / 4**l) and blends them bilinearly to
    7x7; taps outside the map read 0."""
    E = coords.shape[0]
    D = 2 * RADIUS + 2
    t = torch.arange(D, device=coords.device) - RADIUS
    out = torch.empty((E, 7, 7, P, P, len(fmaps)), device=coords.device)
    g_all = rnd(gmap.float(), prec)
    for s in range(0, E, chunk):
        e = slice(s, min(s + chunk, E))
        for lvl, (maps, fidx) in enumerate(fmaps):
            Fn, h, wd, C = maps.shape
            c = coords[e] / 4 ** lvl
            b = torch.floor(c)
            off = c - b
            y = b[..., 1].long()[..., None, None] + t[:, None]
            x = b[..., 0].long()[..., None, None] + t[None, :]
            ok = (x >= 0) & (x < wd) & (y >= 0) & (y < h)
            lin = (fidx[e].long()[:, None, None, None, None] * h
                   + y.clamp(0, h - 1)) * wd + x.clamp(0, wd - 1)
            f = maps.reshape(-1, C)[lin]          # (e, P, P, D, D, C)
            v = torch.einsum("epqc,epqyxc->epqyx", g_all[e], f) * ok
            dx = off[..., 0, None, None]
            dy = off[..., 1, None, None]
            v = ((1 - dy) * (1 - dx) * v[..., :-1, :-1]
                 + (1 - dy) * dx * v[..., :-1, 1:]
                 + dy * (1 - dx) * v[..., 1:, :-1] + dy * dx * v[..., 1:, 1:])
            out[e, ..., lvl] = v.permute(0, 4, 3, 1, 2)
    return out.reshape(E, -1)


def neighbours(kk, jj):
    """The previous and next edge of the same patch by target frame, -1
    where there is none."""
    E = kk.shape[0]
    order = torch.sort(jj, stable=True).indices
    order = order[torch.sort(kk[order], stable=True).indices]
    ks = kk[order]
    same = ks[1:] == ks[:-1]
    no = torch.zeros(1, dtype=torch.bool, device=kk.device)
    m1 = torch.full_like(order, -1)
    ix = torch.empty(E, dtype=torch.long, device=kk.device)
    jx = torch.empty(E, dtype=torch.long, device=kk.device)
    ix[order] = torch.where(torch.cat([no, same]), order.roll(1), m1)
    jx[order] = torch.where(torch.cat([same, no]), order.roll(-1), m1)
    return ix, jx


def soft_agg(w, name, x, group, prec):
    """Softmax-weighted pooling of the rows of each group, per channel,
    projected and broadcast back."""
    _, inv = torch.unique(group, return_inverse=True)
    G = int(inv.max()) + 1
    f = linear(w, name + ".f", x, prec)
    g = linear(w, name + ".g", x, prec)
    idx = inv[:, None].expand_as(g)
    mx = torch.full((G, g.shape[1]), float("-inf"), device=x.device)
    mx = mx.scatter_reduce(0, idx, g, "amax")
    e = torch.exp(g - mx[inv])
    den = torch.zeros((G, g.shape[1]), device=x.device).index_add_(0, inv, e)
    y = torch.zeros((G, g.shape[1]), device=x.device).index_add_(
        0, inv, f * e) / den
    return linear(w, name + ".h", y, prec)[inv]


def gated_residual(w, name, x, prec):
    return x + torch.sigmoid(linear(w, name + ".gate", x, prec)) * linear(
        w, name + ".res2", F.relu(linear(w, name + ".res1", x, prec)), prec)


def update_operator(w, net, inp, corr, ii, jj, kk, prec):
    """One recurrent update -> (net', delta (E, 2), weight (E, 2))."""
    c = F.relu(linear(w, "corr1", corr, prec))
    c = F.relu(layer_norm(w, "corr_norm", linear(w, "corr2", c, prec)))
    c = linear(w, "corr3", c, prec)
    net = layer_norm(w, "norm", net + inp + c)
    ix, jx = neighbours(kk, jj)
    for nb, pre in ((ix, "c1"), (jx, "c2")):
        m = net[nb.clamp(min=0)] * (nb >= 0)[:, None]
        net = net + linear(w, pre + "_1", F.relu(linear(w, pre + "_0", m,
                                                        prec)), prec)
    net = net + soft_agg(w, "agg_kk", net, kk, prec)
    net = net + soft_agg(w, "agg_ij", net, ii * 12345 + jj, prec)
    net = gated_residual(w, "gru_res1", layer_norm(w, "gru_norm1", net), prec)
    net = gated_residual(w, "gru_res2", layer_norm(w, "gru_norm2", net), prec)
    hd = F.relu(net)
    return (net, linear(w, "d", hd, prec),
            torch.sigmoid(linear(w, "w", hd, prec)))


def param_shapes():
    """{name: shape} of every weight, keyed as the program's patchifier
    (``fnet.``, ``inet.``) and update operator state dicts."""
    shapes = {}

    def add(name, *shape, bias=True):
        shapes[name + ".weight"] = shape
        if bias:
            shapes[name + ".bias"] = shape[:1]

    for pre, out in (("fnet.", 128), ("inet.", DIM)):
        add(pre + "conv1", 32, 3, 7, 7)
        for blk, cin, cout in (("layer1_0", 32, 32), ("layer1_1", 32, 32),
                               ("layer2_0", 32, 64), ("layer2_1", 64, 64)):
            add(f"{pre}{blk}.conv1", cout, cin, 3, 3)
            add(f"{pre}{blk}.conv2", cout, cout, 3, 3)
            if blk == "layer2_0":
                add(f"{pre}{blk}.downsample", cout, cin, 1, 1)
        add(pre + "conv2", out, 64, 1, 1)
    add("corr1", DIM, 2 * 49 * P * P)
    for name in ("corr2", "corr3", "c1_0", "c1_1", "c2_0", "c2_1",
                 "agg_kk.f", "agg_kk.g", "agg_kk.h", "agg_ij.f", "agg_ij.g",
                 "agg_ij.h", "gru_res1.gate", "gru_res1.res1",
                 "gru_res1.res2", "gru_res2.gate", "gru_res2.res1",
                 "gru_res2.res2"):
        add(name, DIM, DIM)
    for name in ("corr_norm", "norm", "gru_norm1", "gru_norm2"):
        add(name, DIM)
    add("d", 2, DIM)
    add("w", 2, DIM)
    return shapes
