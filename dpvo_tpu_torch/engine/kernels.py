"""Device programs of the SLAM engine (PyTorch).

Counterpart of ``dpvo_tpu/engine/kernels.py``.  Each function is one step
the host engine (``engine.dpvo.DPVO``) runs on the device state; where the
JAX programs returned new arrays, these update ``DeviceState`` tensors in
place.  The tracking program, the update step (at a static edge bucket
with the rows past the live count masked) and the keyframe merge read
their dynamic inputs as device tensors and branch on none on the host, so
the engine can replay each as a CUDA graph.

- ``track_frame_u8`` / ``track_frame`` / ``write_frame`` — Patchifier
  forward on one frame, ring writes, damped-linear motion model and depth
  init, at fixed shapes on staged device scalars;
- ``update_step_dev`` — edge metadata, reprojection, the correlation (the
  fused correlation + corr-encoder kernel, or at ``DPVO_CORR_VERSION`` other
  than 13 the two-level correlation kernel in that version's layout), the
  recurrent update, local BA and the keyframe candidate's magnitude, at a
  bucket; ``update_step`` the same at the exact live count;
- ``motion_probe`` — median flow delta for the init motion check;
- ``flowmag_pair`` / ``flowmag_two`` / ``flowmag_two_blob`` (with
  ``split_blob``) — keyframe motion magnitude over fixed-capacity edges;
- ``keyframe_merge`` (``relative_pose``, ``shift_edge_indices``,
  ``compact_frames`` on staged device scalars), ``append_edges``,
  ``permute_edges`` — keyframe merge and edge table bookkeeping;
- ``store_inactive``, ``concat_edge_tw``, ``normalize_scene`` — the
  inactive edge store and the scene rescale of global BA (loop closure);
- ``point_cloud`` — world points at the patch centres, for the exports.
"""
from __future__ import annotations

import torch

from ..models.update import DIM, Update, compact_meta_for
from ..models.vonet import (Patchifier, image_gradient, normalize_images,
                            select_centroids)
from ..ops import agg_cuda, ba, graph, lie, projective as pops, scatter
from ..ops import corr as corr_ops, corr_cuda
from ..ops.corr_cuda import PAD
from .state import TRACK_SCALARS, DeviceState


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


def _rows(t, idx):
    """Rows ``idx`` (integer device tensor, any shape) of ``t``: a gather,
    never a host read of the index."""
    return t.index_select(0, idx.reshape(-1))


def write_frame(ds: DeviceState, fmap1, fmap2, gmap, imap, patches, clr,
                intrinsics, n, fac, is_initialized, rand_depth, M, pmem, mem,
                motion_damping):
    """All state writes for a new frame at slot ``n``, at fixed shapes.

    ``n`` (integer), ``fac`` (float32, the motion model's timestamp
    ratio) and ``is_initialized`` (bool) are 0-dim device tensors: both
    branches of the motion model and of the depth init are computed and
    one is taken by a where, and every write goes to rows computed on the
    device, so the program reads no value on the host (``write_frame`` of
    the JAX package).  ``rand_depth`` (M, 1, 1) is the pre-init depth."""
    dev = ds.poses.device
    poses = ds.poses
    n1 = n.reshape(1)

    # motion model: damped linear from the two previous poses (n > 1),
    # a copy of the previous one (n == 1), frame 0 as it is (n == 0)
    P1 = _rows(poses, (n1 - 1).clamp(min=0))[0]
    P2 = _rows(poses, (n1 - 2).clamp(min=0))[0]
    xi = motion_damping * fac * lie.se3_log(
        lie.se3_mul(P1, lie.se3_inv(P2)))
    pred = lie.se3_mul(lie.se3_exp(xi), P1)
    new_pose = torch.where(n > 1, pred, P1)
    new_pose = torch.where(n > 0, new_pose, poses[0])
    poses.index_copy_(0, n1, new_pose[None])

    # depth init: the median of the last 3 frames' depths once initialized
    # (torch.median of a flattened even-length tensor is the LOWER middle
    # order statistic), else ``rand_depth``
    start = (n1 - 3).clamp(min=0) * M
    recent = _rows(ds.patches, start + torch.arange(3 * M, device=dev))
    flat = torch.sort(recent[:, 2].reshape(-1)).values
    med = flat[(flat.numel() - 1) // 2]
    depth = torch.where(is_initialized, med, rand_depth)
    patches = patches.clone()
    patches[:, 2] = depth

    rows = n1 * M + torch.arange(M, device=dev)
    ds.patches.index_copy_(0, rows, patches)
    ds.intrinsics.index_copy_(0, n1, intrinsics[None])
    ds.colors.index_copy_(0, n1, clr[None])
    slot_p = (n1 % pmem) * M + torch.arange(M, device=dev)
    ds.imap.index_copy_(0, slot_p, imap.to(ds.imap.dtype))
    ds.gmap.index_copy_(0, slot_p, gmap.to(ds.gmap.dtype))
    # the rings' zero border is never written: only the interior changes
    for ring, fmap in ((ds.fmap1, fmap1), (ds.fmap2, fmap2)):
        h, w = fmap.shape[:2]
        ring[:, PAD:PAD + h, PAD:PAD + w].index_copy_(
            0, n1 % mem, fmap[None].to(ring.dtype))


def track_frame(ds, patchifier, image, coords, intrinsics, n, fac,
                is_initialized, rand_depth, M, pmem, mem, motion_damping):
    """process_frame + write_frame on a normalized image and given
    centroids."""
    out = process_frame(patchifier, image, coords)
    write_frame(ds, *out, intrinsics, n, fac, is_initialized, rand_depth,
                M=M, pmem=pmem, mem=mem, motion_damping=motion_damping)


def track_frame_u8(ds: DeviceState, patchifier, gen, M, pmem, mem,
                   motion_damping, strat="RANDOM", staged_centroids=False,
                   fixed_depth=None):
    """The whole per-frame pipeline as one fixed-shape program of the staged
    inputs (``ds.image_in``, ``ds.track_in``): uint8 normalization,
    centroid selection, Patchifier forward, state writes.

    Every frame draws the centroids and then the pre-init depth from
    ``gen``, whatever the branch, as the JAX program always splits its key
    into both.  The parity seam: with ``staged_centroids`` the centroids
    are the staged (M, 2) block instead, and with ``fixed_depth`` the
    pre-init depth is that constant; neither then draws."""
    dev = ds.poses.device
    scal = ds.track_in[:TRACK_SCALARS]
    n = scal[0].long()
    fac = scal[1]
    is_initialized = scal[2] > 0.5
    intrinsics = scal[3:TRACK_SCALARS]
    img = normalize_images(ds.image_in)
    h, w = img.shape[0] // 4, img.shape[1] // 4
    if staged_centroids:
        coords = ds.track_in[TRACK_SCALARS:].view(M, 2)
    else:
        grad = image_gradient(img[None]) if strat == "GRADIENT_BIAS" else None
        coords = select_centroids(gen, strat, 1, h, w, M, gradient=grad)[0]
    if fixed_depth is None:
        rand_depth = torch.rand((M, 1, 1), generator=gen, device=dev)
    else:
        rand_depth = torch.full((M, 1, 1), float(fixed_depth), device=dev)
    track_frame(ds, patchifier, img, coords, intrinsics, n, fac,
                is_initialized, rand_depth, M=M, pmem=pmem, mem=mem,
                motion_damping=motion_damping)


# ---------------------------------------------------------------------------
# the hot loop: one optimization update
# ---------------------------------------------------------------------------

def _corr_act(ds, update_mod, coords, kk_mod, jj_mod, version=None):
    """The corr features of the edges, as CorrDense takes them: at
    correlation version 13 (``version``, default
    ``corr_cuda.FUSED_VERSION``) the fused two-level correlation +
    corr-encoder first matmul ("enc"), otherwise the two-level correlation
    of the gathered patch rows in that version's layout ("raw")."""
    K = ds.gmap.shape[0]
    g_all = ds.gmap.reshape(K, -1, ds.gmap.shape[-1])
    c = coords.permute(0, 3, 1, 2).contiguous()
    if version is None:
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


def update_step_dev(ds: DeviceState, update_mod: Update, bucket, e_num,
                    t0, t1, mm_blob, M, pmem, mem, n_cap, k_cap,
                    iterations=2, run_ba=True, has_mm=False, mm_cap=256,
                    corr_version=None, stamp=None):
    """Reproject -> correlate -> recurrent update -> bundle adjust as one
    fixed-shape program over rows [0, bucket) of the device edge tables,
    the rows at or past ``e_num`` masked (``update_step_dev`` of the JAX
    package).  All edge metadata is computed here, and with ``has_mm`` the
    keyframe candidate's motion magnitude too, on the poses after local BA
    (``flowmag_two_blob`` of ``mm_blob``, (8 * mm_cap,) int32).

    ``bucket``, ``run_ba``, ``has_mm``, ``k_cap`` and ``corr_version``
    (``_corr_act``'s) are static; ``e_num``,
    ``t0``, ``t1`` are ints or integer device scalars, so the program
    reads no value on the host and can be captured in a CUDA graph.
    Masked rows are neutral: their indices clamp to 0, their target and
    weight are 0, and their patch and frame-pair keys are INT_MAX, so they
    sort to the tail as one group, whose rank stays inside the pair
    poses' capacity (k_cap + 8).  No segment sum adds that tail as one
    long run: the SoftAggs rank it past their table here
    (``agg_cuda.skip_masked``), local BA gives it a patch rank per row
    (``agg_cuda.split_masked`` in ``ba_iterative``).  Writes rows
    [0, bucket) of net/target/weight, poses and patches IN PLACE (a graph
    holds the addresses).  -> (delta (bucket, 2), magnitude (device
    scalar) or None).  ``stamp`` (the engine's tracing, ``utils.timing``):
    called with "corr" after the correlation, "net" after the update
    operator and "ba" after local BA and its copy-back."""
    dev = ds.eii.device
    imax = scatter.INT_MAX
    valid = torch.arange(bucket, device=dev) < e_num
    ii = torch.where(valid, ds.eii[:bucket].long(), 0)
    jj = torch.where(valid, ds.ejj[:bucket].long(), 0)
    kk = torch.where(valid, ds.ekk[:bucket].long(), 0)
    P = ds.patches.shape[-1]
    c = P // 2

    # ONE (kk, jj) sort feeds the temporal neighbors, the agg_kk metadata
    # and the BA edge sort
    kk_g = torch.where(valid, kk, imax)
    pair = torch.where(valid, ii * 12345 + jj, imax)
    order = graph.lexsort_kk_jj(kk_g, jj)
    nbrs = graph.neighbors_from_order(kk_g, valid, order)
    cm_kk = scatter.group_meta_compact(kk_g, order=order)
    cm_ij = scatter.group_meta_compact(pair)
    g_cap = k_cap + 8

    # relative poses per frame PAIR: each pair rank's first sorted member
    perm_ij, gid_s_ij, gid_o_ij = cm_ij
    first = torch.searchsorted(
        gid_s_ij, torch.arange(g_cap, dtype=torch.int32, device=dev)
    ).clamp(max=bucket - 1)
    pair_rep = perm_ij[first]
    Gij_tab = lie.se3_mul(ds.poses[jj[pair_rep]],
                          lie.se3_inv(ds.poses[ii[pair_rep]]))

    coords = pops.transform(ds.poses, ds.patches, ds.intrinsics, ii, jj, kk,
                            Gij=Gij_tab[gid_o_ij])          # (E, P, P, 2)
    kk_mod = kk % (M * pmem)
    corr = _corr_act(ds, update_mod, coords, kk_mod, jj % mem, corr_version)
    if stamp:
        stamp("corr")
    ctx = ds.imap[kk_mod].float()
    meta = tuple((perm, agg_cuda.skip_masked(gid_s, valid[perm], g_cap),
                  gid_o) for perm, gid_s, gid_o in (cm_kk, cm_ij))
    net, delta, weight = update_mod(
        ds.net[:bucket], ctx, corr, ii, jj, kk, valid, nbrs=nbrs,
        compact_meta=meta, g_cap=g_cap)
    if stamp:
        stamp("net")
    target = torch.where(valid[:, None], coords[:, c, c] + delta, 0.0)

    if run_ba:
        poses, patches = ba.ba_iterative(
            ds.poses, ds.patches, ds.intrinsics[0], target, weight, 1e-4,
            ii, jj, kk, valid, t0, t1, n_cap=n_cap, k_cap=k_cap,
            iterations=iterations, eperm=order)
        ds.poses.copy_(poses)
        ds.patches.copy_(patches)
    if stamp:
        stamp("ba")

    ds.net[:bucket].copy_(net)
    ds.target[:bucket].copy_(target)
    ds.weight[:bucket].copy_(weight)

    mag = None
    if has_mm:
        mag = flowmag_two_blob(ds.poses, ds.patches, ds.intrinsics, mm_blob,
                               mm_cap)
    return delta, mag


def update_step(ds: DeviceState, update_mod: Update, e_num, t0, t1, M,
                pmem, mem, n_cap, k_cap, iterations=2, run_ba=True):
    """``update_step_dev`` over exactly the ``e_num`` live edges (host
    ints; no magnitude): the exact-count program the dev benches and the
    sharded update's reference time and hold.  -> delta (e_num, 2)."""
    delta, _ = update_step_dev(ds, update_mod, e_num, e_num, t0, t1, None,
                               M, pmem, mem, n_cap, k_cap,
                               iterations=iterations, run_ba=run_ba)
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

def flowmag_pair(poses, patches, intrinsics, ii, jj, kk, valid):
    """Mean flow magnitude over the valid rows of fixed-capacity edge
    arrays (0 for none); invalid rows are computed at index 0 and
    masked."""
    ii, jj, kk = (torch.where(valid, a.long(), 0) for a in (ii, jj, kk))
    flow, _ = pops.flow_mag(poses, patches, intrinsics, ii, jj, kk,
                            beta=0.5)
    cnt = (valid.sum() * (flow.shape[1] * flow.shape[2])).clamp(min=1)
    return torch.where(valid[:, None, None], flow, 0.0).sum() / cnt


def flowmag_two(poses, patches, intrinsics, a, b):
    """Both keyframe motionmag directions; a, b = (ii, jj, kk, valid)
    each."""
    return (flowmag_pair(poses, patches, intrinsics, *a)
            + flowmag_pair(poses, patches, intrinsics, *b))


def split_blob(blob, sizes, bools=()):
    """Split one packed int32 tensor into consecutive slices of ``sizes``
    (views), the slices at the indices ``bools`` cast to bool."""
    out = blob.split(list(sizes))
    return tuple(a.bool() if i in bools else a for i, a in enumerate(out))


def flowmag_two_blob(poses, patches, intrinsics, blob, cap):
    """``flowmag_two`` with both directions' (ii, jj, kk, valid) packed into
    one (8 * cap,) int32 tensor."""
    p = split_blob(blob, (cap,) * 8, bools=(3, 7))
    return flowmag_two(poses, patches, intrinsics, p[:4], p[4:])


def _words(t):
    """``t`` (contiguous) as rows of 64-bit words where its rows' bytes
    allow, else as flat rows: the merge only moves bytes, and the index
    kernels move one element per thread, so wider elements move faster."""
    flat = t.view(t.shape[0], -1)
    if flat.shape[1] * flat.element_size() % 8:
        return flat
    return flat.view(torch.int64)


def _shift_ring(buf, k, n, slots, shift_cap, rows):
    """Ring slots i % slots <- (i+1) % slots for i in [k, n-1), at most
    ``shift_cap`` of them, each slot ``rows`` rows of ``buf``: one gather of
    the ``shift_cap`` source slots (a slot past n-1 reads itself), then one
    scatter.  Every slot is read before any is written, which is what
    copying them one by one in ascending order gives, as long as the
    shifted range does not wrap onto itself (``shift_cap < slots``)."""
    dev = buf.device
    i = k + torch.arange(shift_cap, device=dev)
    dst = i % slots
    src = torch.where(i < n - 1, (i + 1) % slots, dst)
    r = torch.arange(rows, device=dev)
    buf = _words(buf)
    buf.index_copy_(0, (dst[:, None] * rows + r).reshape(-1),
                    _rows(buf, src[:, None] * rows + r))


def compact_frames(ds: DeviceState, k, n, M, pmem, mem, shift_cap):
    """Remove keyframe slot ``k``: shift frames (k, N) down by one (an index
    gather of the frame tables, as the JAX program's), and the ring slots
    i <- i+1 for i in [k, n-1) (``_shift_ring``: the ``shift_cap`` slots
    that can move, not the whole ring).  ``k``, ``n`` are 0-dim integer
    device tensors; ``M``, ``pmem``, ``mem``, ``shift_cap`` static."""
    if shift_cap >= min(pmem, mem):
        raise ValueError(f"kf_shift_cap {shift_cap} must be below the rings' "
                         f"slots (pmem {pmem}, mem {mem})")
    N = ds.poses.shape[0]
    idx = torch.arange(N, device=ds.poses.device)
    src = torch.where(idx >= k, (idx + 1).clamp(max=N - 1), idx)
    for t in (ds.poses, ds.intrinsics, ds.colors, ds.patches.view(N, -1)):
        t = _words(t)
        t.copy_(_rows(t, src))
    for buf, slots, rows in ((ds.imap, pmem, M), (ds.gmap, pmem, M),
                             (ds.fmap1, mem, 1), (ds.fmap2, mem, 1)):
        _shift_ring(buf, k, n, slots, shift_cap, rows)


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
    """Keyframe-merge index shift: frames above the removed slot ``k`` (an
    int or 0-dim integer device tensor) move down."""
    mi = ds.eii > k
    ds.ekk.sub_(mi.int() * M)
    ds.eii.sub_(mi.int())
    ds.ejj.sub_((ds.ejj > k).int())


def relative_pose(poses, k):
    """dP = poses[k] * poses[k-1]^-1, ``k`` >= 1 a 0-dim integer device
    tensor."""
    k1 = k.reshape(1)
    return lie.se3_mul(_rows(poses, k1),
                       lie.se3_inv(_rows(poses, (k1 - 1).clamp(min=0))))[0]


def keyframe_merge(ds: DeviceState, M, pmem, mem, shift_cap):
    """One keyframe merge as one fixed-shape program of the staged
    ``ds.merge_in`` = (k, n): ``relative_pose``, ``shift_edge_indices`` and
    ``compact_frames``.  -> the removed frame's relative pose (7,)."""
    k, n = ds.merge_in[0].long(), ds.merge_in[1].long()
    dP = relative_pose(ds.poses, k)
    shift_edge_indices(ds, k, M)
    compact_frames(ds, k, n, M=M, pmem=pmem, mem=mem, shift_cap=shift_cap)
    return dP


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
