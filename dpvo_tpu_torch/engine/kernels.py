"""Device programs of the SLAM engine (PyTorch).

Counterpart of ``dpvo_tpu/engine/kernels.py``.  Each function is one step
the host engine (``engine.dpvo.DPVO``) runs on the device state; where the
JAX programs returned new arrays, these update ``DeviceState`` tensors in
place.  The update step runs at the live edge count (no shape buckets):
every row it sees is live.

- ``track_frame_u8`` / ``track_frame`` — Patchifier forward on one frame,
  ring writes, damped-linear motion model and depth init;
- ``update_step`` — edge metadata, reprojection, the correlation (the
  fused correlation + corr-encoder kernel, or at ``DPVO_CORR_VERSION`` other
  than 13 the two-level correlation kernel in that version's layout), the
  recurrent update, local BA;
- ``motion_probe`` — median flow delta for the init motion check;
- ``flowmag_pair`` / ``flowmag_two`` — keyframe motion magnitude;
- ``compact_frames``, ``append_edges``, ``permute_edges``,
  ``shift_edge_indices``, ``relative_pose`` — keyframe merge and edge
  table bookkeeping;
- ``store_inactive``, ``concat_edge_tw``, ``normalize_scene`` — the
  inactive edge store and the scene rescale of global BA (loop closure);
- ``point_cloud`` — world points at the patch centres, for the exports.
"""
from __future__ import annotations

import torch

from ..models.update import DIM, Update, compact_meta_for
from ..models.vonet import (Patchifier, image_gradient, normalize_images,
                            select_centroids)
from ..ops import ba, graph, lie, projective as pops, scatter
from ..ops import corr as corr_ops, corr_cuda
from ..ops.corr_cuda import PAD
from .state import DeviceState


# ---------------------------------------------------------------------------
# frame tracking
# ---------------------------------------------------------------------------

def process_frame(patchifier: Patchifier, image, coords):
    """image (H, W, 3) normalized float; coords (M, 2) feature-res
    centroids -> fmap1 (h, w, 128), fmap2 (h/4, w/4, 128),
    gmap (M, P, P, 128), imap (M, DIM), patches (M, 3, P, P) f32,
    clr (M, 3) u8."""
    fmap, gmap, imap, patches, _, clr = patchifier(image[None], coords[None])
    fmap1 = fmap[0]
    fmap2 = corr_ops.avg_pool2d(fmap1, 4)
    clr_u8 = ((clr[0].flip(-1) + 0.5) * (255.0 / 2)).clamp(0, 255).to(
        torch.uint8)
    return fmap1, fmap2, gmap[0], imap[0], patches[0].float(), clr_u8


def write_frame(ds: DeviceState, fmap1, fmap2, gmap, imap, patches, clr,
                intrinsics, n, fac, is_initialized, gen, M, pmem, mem,
                motion_damping, fixed_depth=None):
    """All state writes for a new frame at slot ``n``."""
    P = patches.shape[-1]
    poses = ds.poses

    # motion model
    if n > 1:
        P1, P2 = poses[n - 1], poses[n - 2]
        xi = motion_damping * fac * lie.se3_log(
            lie.se3_mul(P1, lie.se3_inv(P2)))
        poses[n] = lie.se3_mul(lie.se3_exp(xi), P1)
    elif n == 1:
        poses[1] = poses[0]

    # depth init: torch.median of a flattened even-length tensor is the
    # LOWER middle order statistic
    if is_initialized:
        start = max(n - 3, 0) * M
        recent = ds.patches[start:start + 3 * M, 2].reshape(-1)
        depth = torch.sort(recent).values[(recent.numel() - 1) // 2]
    elif fixed_depth is not None:
        depth = torch.tensor(fixed_depth, device=poses.device)
    else:
        depth = torch.rand((M, 1, 1), generator=gen, device=poses.device)
    patches = patches.clone()
    patches[:, 2] = depth

    ds.patches[n * M:(n + 1) * M] = patches
    ds.intrinsics[n] = intrinsics
    ds.colors[n] = clr
    slot_p = (n % pmem) * M
    ds.imap[slot_p:slot_p + M] = imap.to(ds.imap.dtype)
    ds.gmap[slot_p:slot_p + M] = gmap.to(ds.gmap.dtype)
    # the rings' zero border is never written: only the interior changes
    h, w = fmap1.shape[:2]
    ds.fmap1[n % mem, PAD:PAD + h, PAD:PAD + w] = fmap1.to(ds.fmap1.dtype)
    h, w = fmap2.shape[:2]
    ds.fmap2[n % mem, PAD:PAD + h, PAD:PAD + w] = fmap2.to(ds.fmap2.dtype)


def track_frame(ds, patchifier, image, coords, intrinsics, n, fac,
                is_initialized, gen, M, pmem, mem, motion_damping,
                fixed_depth=None):
    """process_frame + write_frame on a normalized image and given
    centroids."""
    out = process_frame(patchifier, image, coords)
    write_frame(ds, *out, intrinsics, n, fac, is_initialized, gen, M=M,
                pmem=pmem, mem=mem, motion_damping=motion_damping,
                fixed_depth=fixed_depth)


def track_frame_u8(ds, patchifier, image_u8, intrinsics, n, fac,
                   is_initialized, gen, M, pmem, mem, motion_damping,
                   strat="RANDOM"):
    """The whole per-frame pipeline from a uint8 (H, W, 3) image:
    normalization, centroid selection, Patchifier forward, state writes."""
    img = normalize_images(image_u8)
    h, w = img.shape[0] // 4, img.shape[1] // 4
    grad = image_gradient(img[None]) if strat == "GRADIENT_BIAS" else None
    coords = select_centroids(gen, strat, 1, h, w, M, gradient=grad)[0]
    track_frame(ds, patchifier, img, coords, intrinsics, n, fac,
                is_initialized, gen, M=M, pmem=pmem, mem=mem,
                motion_damping=motion_damping)


# ---------------------------------------------------------------------------
# the hot loop: one optimization update
# ---------------------------------------------------------------------------

def _corr_act(ds, update_mod, coords, kk_mod, jj_mod):
    """The corr features of the edges, as CorrDense takes them: at
    ``corr_cuda.FUSED_VERSION`` 13 the fused two-level correlation +
    corr-encoder first matmul ("enc"), otherwise the two-level correlation
    of the gathered patch rows in that version's layout ("raw")."""
    K = ds.gmap.shape[0]
    g_all = ds.gmap.reshape(K, -1, ds.gmap.shape[-1])
    c = coords.permute(0, 3, 1, 2).contiguous()
    version = corr_cuda.FUSED_VERSION
    if version != 13:
        feat = corr_cuda.corr_fused(
            g_all[kk_mod], ds.fmap1, ds.fmap2, c, jj_mod.int(),
            corr_cuda.layout_for_version(version), ds.gmap.dtype)
        return ("raw", feat.reshape(c.shape[0], -1))
    w_raw = update_mod.corr1.raw_kernel().to(ds.gmap.dtype)
    act = corr_cuda.corr_enc(g_all, kk_mod.int(), w_raw, ds.fmap1, ds.fmap2,
                             c, jj_mod.int())
    return ("enc", act)


def update_step(ds: DeviceState, update_mod: Update, e_num, t0, t1, M,
                pmem, mem, n_cap, k_cap, iterations=2, run_ba=True):
    """Reproject -> correlate -> recurrent update -> bundle adjust over the
    ``e_num`` live edges; writes net/target/weight rows, poses and patches
    of ``ds``.  Returns the flow deltas (E, 2)."""
    E = e_num
    ii = ds.eii[:E].long()
    jj = ds.ejj[:E].long()
    kk = ds.ekk[:E].long()
    valid = torch.ones(E, dtype=torch.bool, device=ii.device)
    P = ds.patches.shape[-1]
    c = P // 2

    # ONE (kk, jj) sort feeds the temporal neighbors, the agg_kk metadata
    # and the BA edge sort
    pair = ii * 12345 + jj
    order = graph.lexsort_kk_jj(kk, jj)
    nbrs = graph.neighbors_from_order(kk, valid, order)
    cm_kk = scatter.group_meta_compact(kk, order=order)
    cm_ij = scatter.group_meta_compact(pair)
    g_cap = k_cap + 8

    # relative poses per frame PAIR: each pair rank's first sorted member
    perm_ij, gid_s_ij, gid_o_ij = cm_ij
    first = torch.searchsorted(
        gid_s_ij, torch.arange(g_cap, dtype=torch.int32, device=ii.device)
    ).clamp(max=E - 1)
    pair_rep = perm_ij[first]
    Gij_tab = lie.se3_mul(ds.poses[jj[pair_rep]],
                          lie.se3_inv(ds.poses[ii[pair_rep]]))

    coords = pops.transform(ds.poses, ds.patches, ds.intrinsics, ii, jj, kk,
                            Gij=Gij_tab[gid_o_ij])          # (E, P, P, 2)
    kk_mod = kk % (M * pmem)
    corr = _corr_act(ds, update_mod, coords, kk_mod, jj % mem)
    ctx = ds.imap[kk_mod].float()
    net, delta, weight = update_mod(
        ds.net[:E], ctx, corr, ii, jj, kk, valid, nbrs=nbrs,
        compact_meta=(cm_kk, cm_ij), g_cap=g_cap)
    target = coords[:, c, c] + delta

    if run_ba:
        ds.poses, ds.patches = ba.ba_iterative(
            ds.poses, ds.patches, ds.intrinsics[0], target, weight, 1e-4,
            ii, jj, kk, valid, t0, t1, n_cap=n_cap, k_cap=k_cap,
            iterations=iterations, eperm=order, pair_gid=gid_o_ij,
            pair_cap=g_cap, pair_rep=pair_rep)

    ds.net[:E] = net.float()
    ds.target[:E] = target
    ds.weight[:E] = weight
    return delta


def motion_probe(ds: DeviceState, update_mod: Update, ii, jj, kk, M, pmem,
                 mem):
    """Median flow delta of the newest frame's patches (init motion check;
    ``torch.quantile`` interpolates linearly, like ``jnp.quantile``)."""
    E = ii.shape[0]
    net = torch.zeros((E, DIM), device=ii.device)
    coords = pops.transform(ds.poses, ds.patches, ds.intrinsics, ii, jj, kk)
    kk_mod = kk % (M * pmem)
    corr = _corr_act(ds, update_mod, coords, kk_mod, jj % mem)
    ctx = ds.imap[kk_mod].float()
    valid = torch.ones(E, dtype=torch.bool, device=ii.device)
    _, delta, _ = update_mod(net, ctx, corr, ii, jj, kk, valid,
                             compact_meta=compact_meta_for(ii, jj, kk, valid),
                             g_cap=E)
    return torch.quantile(torch.linalg.norm(delta, dim=-1), 0.5)


# ---------------------------------------------------------------------------
# keyframing
# ---------------------------------------------------------------------------

def flowmag_pair(poses, patches, intrinsics, ii, jj, kk):
    """Mean flow magnitude over the given edges (0 for none)."""
    if ii.numel() == 0:
        return torch.zeros((), device=poses.device)
    flow, _ = pops.flow_mag(poses, patches, intrinsics, ii, jj, kk,
                            beta=0.5)
    return flow.mean()


def flowmag_two(poses, patches, intrinsics, a, b):
    """Both keyframe motionmag directions; a, b = (ii, jj, kk) each."""
    return (flowmag_pair(poses, patches, intrinsics, *a)
            + flowmag_pair(poses, patches, intrinsics, *b))


def compact_frames(ds: DeviceState, k, n, M, pmem, mem, shift_cap):
    """Remove keyframe slot ``k``: shift frames (k, N) down by one, and the
    ring slots i % ring <- (i+1) % ring for i in [k, n-1) (at most
    ``shift_cap`` of them), copied in ascending order so each slot is read
    before it is overwritten."""
    N = ds.poses.shape[0]
    ds.poses[k:N - 1] = ds.poses[k + 1:N].clone()
    ds.intrinsics[k:N - 1] = ds.intrinsics[k + 1:N].clone()
    ds.colors[k:N - 1] = ds.colors[k + 1:N].clone()
    ds.patches[k * M:(N - 1) * M] = ds.patches[(k + 1) * M:N * M].clone()

    for i in range(k, min(k + shift_cap, n - 1)):
        dp, sp = (i % pmem) * M, ((i + 1) % pmem) * M
        ds.imap[dp:dp + M] = ds.imap[sp:sp + M]
        ds.gmap[dp:dp + M] = ds.gmap[sp:sp + M]
        ds.fmap1[i % mem] = ds.fmap1[(i + 1) % mem]
        ds.fmap2[i % mem] = ds.fmap2[(i + 1) % mem]


def append_edges(ds: DeviceState, kk_new, jj_new, s, M):
    """Write new edge rows at ``s`` and zero their hidden state."""
    cnt = kk_new.shape[0]
    ds.ekk[s:s + cnt] = kk_new
    ds.ejj[s:s + cnt] = jj_new
    ds.eii[s:s + cnt] = torch.div(kk_new, M, rounding_mode="floor")
    ds.net[s:s + cnt] = 0.0


def permute_edges(ds: DeviceState, perm, zero_from):
    """Reorder the first len(perm) edge rows by ``perm``; rows >= zero_from
    get zero state (fresh edges start from zero)."""
    L = perm.shape[0]
    for name in ("net", "target", "weight"):
        tab = getattr(ds, name)
        rows = tab[:L][perm]
        rows[zero_from:] = 0.0
        tab[:L] = rows
    for name in ("eii", "ejj", "ekk"):
        tab = getattr(ds, name)
        tab[:L] = tab[:L][perm]


def shift_edge_indices(ds: DeviceState, k, M):
    """Keyframe-merge index shift: frames above the removed slot move
    down."""
    mi = ds.eii > k
    ds.ekk.sub_(mi.int() * M)
    ds.eii.sub_(mi.int())
    ds.ejj.sub_((ds.ejj > k).int())


def relative_pose(poses, k):
    """dP = poses[k] * poses[k-1]^-1."""
    return lie.se3_mul(poses[k], lie.se3_inv(poses[max(k - 1, 0)]))


def store_inactive(ds: DeviceState, idx, dest):
    """Copy the target/weight rows ``idx`` (retired edges) into the
    inactive store at ``dest``."""
    cnt = idx.shape[0]
    ds.target_inac[dest:dest + cnt] = ds.target[idx]
    ds.weight_inac[dest:dest + cnt] = ds.weight[idx]


def concat_edge_tw(ds: DeviceState, n_inac, e, cap):
    """The inactive then the active target/weight rows, zero-padded to
    ``cap`` rows: (cap, 2) each."""
    pad = ds.target.new_zeros((cap - n_inac - e, 2))
    return (torch.cat([ds.target_inac[:n_inac], ds.target[:e], pad]),
            torch.cat([ds.weight_inac[:n_inac], ds.weight[:e], pad]))


def normalize_scene(ds: DeviceState, n, M):
    """Rescale the scene before global BA: s = mean inverse depth of the
    live patches; depths /= s, translations *= s, and the live poses are
    re-anchored to the first frame.  Returns s, a device scalar (1 where
    the mean is not finite and positive: a where, not a host branch)."""
    live = ds.patches[:n * M, 2]
    s_raw = live.sum() / max(live.numel(), 1)
    s = torch.where(torch.isfinite(s_raw) & (s_raw > 0), s_raw, 1.0)
    ds.patches[:n * M, 2] = live / s
    poses = ds.poses[:n].clone()
    poses[:, :3] *= s
    ds.poses[:n] = lie.se3_mul(poses, lie.se3_inv(poses[0])[None])
    return s


def point_cloud(poses, patches, intrinsics, ix):
    """World points (K, 3) at the patch centres of patches (K, 3, P, P),
    ix (K,) their frames; for the map exports."""
    pts = pops.point_cloud(poses, patches, intrinsics, ix)
    c = patches.shape[-1] // 2
    ctr = pts[:, c, c]
    return ctr[:, :3] / ctr[:, 3:].clamp(min=1e-8)
