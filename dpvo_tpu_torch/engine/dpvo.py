"""The DPVO SLAM engine on one GPU: frame-by-frame visual odometry.

Counterpart of ``dpvo_tpu/engine/dpvo.py``, same public API::

    slam = DPVO(cfg, network, ht=480, wd=640, device="cuda")
    for t, image, intrinsics in stream:
        slam(t, image, intrinsics)
    poses, tstamps = slam.terminate()

The host owns the edge bookkeeping (numpy); the device programs of
``engine.kernels`` update fixed-capacity device tensors in place.

Keyframe decisions come in two timings:

- ``ASYNC_KEYFRAME=False`` (the reference's): each frame computes its
  motion magnitude after its update and reads it back before deciding;
- ``ASYNC_KEYFRAME=True`` (the default, the JAX engine's lag, made
  deterministic): every update computes the magnitude of the current
  candidate on the device and queues it; the queue is stacked into one
  vector every ``b_eff = max(1, min(BATCH, LAG))`` decisions, whose
  device-to-host copy starts at once, and a batch applies, oldest first, at
  the first ``keyframe()`` where ``kf_clock - batch_clock + b_eff - 1 >=
  ASYNC_KEYFRAME_LAG``, never earlier.  The copy has landed long before,
  and the schedule never depends on whether it has, so a drive gives the
  same structure on the CPU and on the card.  ``terminate()`` drops what is
  still pending, as the JAX engine does.

Proximity loop closure (``LOOP_CLOSURE=True``, ``configs/default.yaml``):
the patch rings hold ``MAX_EDGE_AGE`` frames; retired edges go to the
inactive store; every ``GLOBAL_OPT_FREQ`` keyframes, and at
``terminate()``, ``loop_closure.proximity`` proposes edges from old
patches into recent frames; and an update whose active edges reach behind
the removal window runs global BA over the active and inactive edges
instead of local BA (once per keyframe count), after rescaling the scene.

The classic backend (``CLASSIC_LOOP_CLOSURE=True``,
``loop_closure.long_term``) sees every frame, follows every merge as it
applies, tries to close a loop after every frame and merges each finished
pose-graph optimisation; it needs OpenCV (``cv2``), which construction
checks for.

The viewer (``viz=True``, ``viz.viewer.Viewer``, matplotlib) gets every
frame and, at most once a period, a host snapshot of the map taken on this
thread; ``terminate()`` joins it, which writes ``latest.png`` and
``map.html`` and re-raises an error of its render thread.

Phase timers (off by default, the JAX engine's): set ``enable_timing``,
run frames, read ``timing_report()``.  Each phase is wall time on the host
clock; with ``timing_block`` (the default) both ends of a phase first
synchronise the card, so the time covers the phase's device work, and
without it the time is the host's dispatch alone.  The phases nest:
``keyframe`` holds ``keyframe/*``, and ``update/meta`` and
``update/step`` lie inside no other phase, so only ``track_frame``,
``append_factors``, ``update/*`` and ``keyframe`` are disjoint.
"""
from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

from ..config import VOConfig
from ..device import resolve_device
from ..models.update import Update
from ..models.vonet import Patchifier, normalize_images
from ..loop_closure.proximity import propose_loop_edges
from ..ops import ba, lie
from ..utils.checkpoint import load_network
from . import kernels
from .state import allocate, allocate_host


class DPVO:
    def __init__(self, cfg: VOConfig, network=None, ht: int = 480,
                 wd: int = 640, viz: bool = False, seed: int = 0,
                 device="cuda"):
        if cfg.CLASSIC_LOOP_CLOSURE:
            # the one check: without it the import fails in a worker
            # process or at the first triangulation, long after this
            try:
                import cv2  # noqa: F401
            except ImportError as e:
                raise ImportError(
                    "CLASSIC_LOOP_CLOSURE=True needs OpenCV (the cv2 module) "
                    "for its keypoints, matcher and frame cache; it is not "
                    "installed") from e
        self.cfg = cfg
        self.device = resolve_device(device)
        self.ht, self.wd = ht, wd
        self.P = 3
        self.M = cfg.PATCHES_PER_FRAME
        self.N = cfg.BUFFER_SIZE
        self.RES = 4
        self.is_initialized = False
        # per-phase wall timing: {phase: [seconds, ...]}
        self.enable_timing = False
        self.timing_block = True
        self.timings: dict[str, list] = {}

        # frame memory sizes
        self.mem = 36
        self.pmem = cfg.MAX_EDGE_AGE if cfg.LOOP_CLOSURE else self.mem
        self.last_global_ba = -1000
        # keyframe counts at which global BA has run (once per count)
        self.ran_global_ba = np.zeros(100000, dtype=bool)
        self.ctype = torch.bfloat16 if cfg.MIXED_PRECISION else torch.float32

        # fp32 islands (geometry, BA, fp32 parity runs) stay full fp32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        self.load_weights(network, seed)
        self.ds = allocate(cfg, ht, wd, self.P, self.pmem, self.mem,
                           self.device, self.ctype)
        self.hs = allocate_host(cfg)
        self.E_cap = cfg.edge_capacity()
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)

        # BA capacities: the local window frees at most OPTIMIZATION_WINDOW
        # poses; k_cap bounds the patches an update touches
        self.n_cap = cfg.BA_WINDOW_CAP or (1 << math.ceil(math.log2(
            max(cfg.OPTIMIZATION_WINDOW + 2, 8))))
        self.k_cap = 1 << math.ceil(math.log2(
            max((cfg.REMOVAL_WINDOW + 4) * self.M, 256)))

        self._pending_perm = None
        # lagged keyframe decisions (ASYNC_KEYFRAME): device magnitudes
        # with their candidate timestamps, then flushed batches
        # (host vector, copy event, timestamps, kf_clock at the flush)
        self._mag_pending: list = []
        self._kf_queue: list = []
        self._kf_clock = 0
        self._b_eff = max(1, min(cfg.ASYNC_KEYFRAME_BATCH,
                                 cfg.ASYNC_KEYFRAME_LAG))
        # test seams for cross-engine parity runs: scripted centroids
        # (counter -> (M, 2) float [x, y]) and a constant pre-init depth
        self.test_centroids = None
        self.test_fixed_depth = None

        # the viewer (viz=True) raises here when matplotlib is missing
        self.viewer = None
        if viz:
            from ..viz.viewer import Viewer
            self.viewer = Viewer(self)

        self.long_term_lc = None
        if cfg.CLASSIC_LOOP_CLOSURE:
            from ..loop_closure.long_term import LongTermLoopClosure
            self.long_term_lc = LongTermLoopClosure(cfg, self)

    # --- weights -----------------------------------------------------------

    def load_weights(self, network, seed=0):
        """network: (patchifier state dict, update state dict), e.g. from
        ``utils.checkpoint.params_from_jax``; a path to the reference's
        ``.pth`` or the JAX package's ``.npz`` checkpoint; or None for
        seeded random weights."""
        if isinstance(network, (str, os.PathLike)):
            network = load_network(network)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            patchifier = Patchifier(self.P)
            update = Update(self.P)
        if network is not None:
            p_sd, u_sd = network
            patchifier.load_state_dict(p_sd)
            update.load_state_dict(u_sd)
        self.patchifier = patchifier.to(self.device, self.ctype).eval()
        self.update_mod = update.to(self.device, self.ctype).eval()

    # --- phase timing ------------------------------------------------------

    def _fence(self):
        if self.timing_block and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _tick(self):
        if not self.enable_timing:
            return 0.0
        self._fence()
        return time.perf_counter()

    def _tock(self, t0, name):
        if not self.enable_timing:
            return
        self._fence()
        self.timings.setdefault(name, []).append(time.perf_counter() - t0)

    def timing_report(self):
        """{phase: (mean_ms, count)} over all recorded frames, sorted by
        phase."""
        return {k: (1e3 * float(np.mean(v)), len(v))
                for k, v in sorted(self.timings.items())}

    # --- small helpers -----------------------------------------------------

    @property
    def n(self):
        return self.hs.n

    @n.setter
    def n(self, v):
        self.hs.n = v

    @property
    def m(self):
        return self.hs.m

    @m.setter
    def m(self, v):
        self.hs.m = v

    @property
    def ix(self):
        """Patch index -> source frame (dense arange mapping)."""
        return np.arange(self.N * self.M, dtype=np.int32) // self.M

    @property
    def points(self):
        """World points (N*M, 3) at every patch slot's centre (the first
        ``m`` are live)."""
        ix = torch.as_tensor(self.ix, dtype=torch.long, device=self.device)
        return kernels.point_cloud(self.ds.poses, self.ds.patches,
                                   self.ds.intrinsics, ix)

    def _dev(self, a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(self.device)

    # --- edge bookkeeping (host) ------------------------------------------

    def append_factors(self, kk_new, jj_new):
        cnt = len(kk_new)
        if cnt == 0:
            return
        self._flush_edge_permute()
        s = self.hs.e_num
        if s + cnt > self.E_cap:
            raise RuntimeError(f"edge table overflow: {s}+{cnt} > "
                               f"{self.E_cap}; increase EDGE_CAPACITY")
        self.hs.kk[s:s + cnt] = kk_new
        self.hs.jj[s:s + cnt] = jj_new
        self.hs.ii[s:s + cnt] = kk_new // self.M
        self.hs.e_num = s + cnt
        kernels.append_edges(self.ds, self._dev(kk_new.astype(np.int32)),
                             self._dev(jj_new.astype(np.int32)), s, self.M)

    def remove_factors(self, mask, store=False):
        """Drop the masked edges among the first e_num live ones; with
        ``store`` under loop closure, keep them in the inactive store for
        global BA.  The device rows move by one permutation per frame:
        consecutive removals compose on the host and flush before the next
        device use."""
        e = self.hs.e_num
        mask = np.asarray(mask, bool)
        if store and self.cfg.LOOP_CLOSURE and mask.any():
            self._store_inactive(np.nonzero(mask)[0])
        keep = np.nonzero(~mask)[0]
        cnt = len(keep)
        perm = np.concatenate([keep, np.nonzero(mask)[0]]).astype(np.int64)
        self.hs.ii[:cnt] = self.hs.ii[:e][keep]
        self.hs.jj[:cnt] = self.hs.jj[:e][keep]
        self.hs.kk[:cnt] = self.hs.kk[:e][keep]
        self.hs.e_num = cnt
        if self._pending_perm is None:
            self._pending_perm = perm
        else:
            # the earlier permutation covers more rows; keep its length
            prev = self._pending_perm
            if len(perm) < len(prev):
                perm = np.concatenate([perm, np.arange(len(perm), len(prev))])
            self._pending_perm = prev[perm]

    def _store_inactive(self, idx):
        """Append the live edges ``idx`` to the inactive store: indices on
        the host, target/weight rows copied on the device (no fetch)."""
        hs = self.hs
        dest, cnt = hs.n_inac, len(idx)
        cap = self.ds.target_inac.shape[0]
        if dest + cnt > cap:
            raise RuntimeError(f"inactive edge store overflow: {dest}+{cnt} "
                               f"> {cap}; increase EDGE_CAPACITY_INAC")
        # the gather reads the device rows in the host's current layout
        self._flush_edge_permute()
        kernels.store_inactive(self.ds, self._dev(idx.astype(np.int64)),
                               dest)
        hs.ii_inac = np.concatenate([hs.ii_inac, hs.ii[idx]])
        hs.jj_inac = np.concatenate([hs.jj_inac, hs.jj[idx]])
        hs.kk_inac = np.concatenate([hs.kk_inac, hs.kk[idx]])
        hs.n_inac = dest + cnt

    def _flush_edge_permute(self):
        if self._pending_perm is None:
            return
        kernels.permute_edges(self.ds, self._dev(self._pending_perm),
                              self.hs.e_num)
        self._pending_perm = None

    def __edges_forw(self):
        r = self.cfg.PATCH_LIFETIME
        t0 = self.M * max(self.n - r, 0)
        t1 = self.M * max(self.n - 1, 0)
        kk = np.arange(t0, t1, dtype=np.int32)
        jj = np.full_like(kk, self.n - 1)
        return kk, jj

    def __edges_back(self):
        r = self.cfg.PATCH_LIFETIME
        t0 = self.M * max(self.n - 1, 0)
        t1 = self.M * max(self.n - 0, 0)
        kk0 = np.arange(t0, t1, dtype=np.int32)
        jrange = np.arange(max(self.n - r, 0), self.n, dtype=np.int32)
        kk = np.repeat(kk0, len(jrange))
        jj = np.tile(jrange, len(kk0))
        return kk, jj

    # --- core steps --------------------------------------------------------

    def update(self):
        cfg, hs = self.cfg, self.hs
        if hs.e_num == 0:            # no keyframe pair yet: nothing to solve
            return
        self._flush_edge_permute()
        # global BA once per keyframe count, when the active edges reach
        # behind the removal window (loop edges, or frame 0 at init)
        run_global = (cfg.LOOP_CLOSURE and not self.ran_global_ba[self.n]
                      and (hs.ii[:hs.e_num]
                           < self.n - cfg.REMOVAL_WINDOW - 1).any())
        t0 = self.n - cfg.OPTIMIZATION_WINDOW if self.is_initialized else 1
        t_meta = self._tick()
        cand = self._candidate() if cfg.ASYNC_KEYFRAME else None
        k_cap = self._update_k_cap()
        self._tock(t_meta, "update/meta")
        # as in the JAX engine, update/step times the local-BA branch only
        t_up = self._tick() if not run_global else 0.0
        kernels.update_step(
            self.ds, self.update_mod, hs.e_num, max(t0, 1), self.n,
            M=self.M, pmem=self.pmem, mem=self.mem, n_cap=self.n_cap,
            k_cap=k_cap, iterations=2, run_ba=not run_global)
        if cand is not None:
            # the candidate's magnitude on the poses of this update step
            # (after local BA, or before global BA), queued
            a, b, tcand = cand
            self._mag_pending.append((kernels.flowmag_two(
                self.ds.poses, self.ds.patches, self.ds.intrinsics, a, b),
                tcand))
        if run_global:
            self._run_global_ba()
        else:
            self._tock(t_up, "update/step")

    def _update_k_cap(self):
        """The patch capacity of an update (its groups are k_cap + 8):
        ``k_cap``, or under loop closure room for every patch of every
        frame the live edges leave from, since loop edges reach frames far
        behind the removal window."""
        if not self.cfg.LOOP_CLOSURE:
            return self.k_cap
        frames = np.count_nonzero(np.bincount(self.hs.ii[:self.hs.e_num]))
        return max(self.k_cap,
                   1 << math.ceil(math.log2(frames * self.M + 8)))

    def _run_global_ba(self):
        """Global BA over the inactive and active edges, padded to a power
        of two, after ``normalize``: ``ops.ba.ba_global`` when the window
        from the oldest active source frame spans 64 pose blocks or more,
        else ``ops.ba.ba_iterative``."""
        hs, ds = self.hs, self.ds
        e = hs.e_num
        ii = np.concatenate([hs.ii_inac, hs.ii[:e]])
        jj = np.concatenate([hs.jj_inac, hs.jj[:e]])
        kk = np.concatenate([hs.kk_inac, hs.kk[:e]])

        self.normalize()

        E = len(ii)
        cap = 1 << math.ceil(math.log2(max(E, 1024)))
        pad = np.zeros(cap - E, np.int64)
        t_p, w_p = kernels.concat_edge_tw(ds, hs.n_inac, e, cap)
        t0 = int(hs.ii[:e].min())
        n_cap = 1 << math.ceil(math.log2(max(self.n - t0 + 1, 16)))
        k_cap = 1 << math.ceil(math.log2(
            max(len(np.unique(kk)) + 8, 1024)))
        ba_fn = ba.ba_global if n_cap >= 64 else ba.ba_iterative
        ds.poses, ds.patches = ba_fn(
            ds.poses, ds.patches, ds.intrinsics[0], t_p, w_p, 1e-4,
            *(self._dev(np.concatenate([a, pad])) for a in (ii, jj, kk)),
            self._dev(np.arange(cap) < E), t0, self.n, n_cap=n_cap,
            k_cap=k_cap, iterations=2)
        self.ran_global_ba[self.n] = True

    def normalize(self):
        """Rescale depths and poses (``kernels.normalize_scene``) and the
        deltas of removed frames by the same device scalar: no host
        fetch."""
        s = kernels.normalize_scene(self.ds, self.n, self.M)
        for t, (t0, dP) in self.hs.delta.items():
            self.hs.delta[t] = (t0, lie.se3_scale(dP, s))

    def _motionmag_edges(self, i, j):
        hs = self.hs
        e = hs.e_num
        k = (hs.ii[:e] == i) & (hs.jj[:e] == j)
        return tuple(self._dev(a[:e][k].astype(np.int64))
                     for a in (hs.ii, hs.jj, hs.kk))

    def motionmag(self, i, j):
        """Mean flow magnitude of the live edges from frame ``i`` into frame
        ``j`` on the current poses (0.0 when no edge joins them): one host
        read.  The engine's own decisions use ``flowmag_two`` on the
        device instead."""
        ii, jj, kk = self._motionmag_edges(i, j)
        if ii.numel() == 0:
            return 0.0
        return float(kernels.flowmag_pair(self.ds.poses, self.ds.patches,
                                          self.ds.intrinsics, ii, jj, kk))

    def _candidate(self):
        """The keyframe candidate's motion-magnitude edges, both directions
        (ii, jj, kk each), and its timestamp; None while it has no edges."""
        cfg = self.cfg
        i = self.n - cfg.KEYFRAME_INDEX - 1
        j = self.n - cfg.KEYFRAME_INDEX + 1
        a = self._motionmag_edges(i, j)
        b = self._motionmag_edges(j, i)
        if not (a[0].numel() or b[0].numel()):
            return None
        return a, b, int(self.hs.tstamps[self.n - cfg.KEYFRAME_INDEX])

    def _flush_mags(self):
        """Stack the pending magnitudes into one vector and start its copy
        to the host; the batch is stamped with the keyframe clock."""
        if not self._mag_pending:
            return
        mags, tcands = zip(*self._mag_pending)
        self._mag_pending.clear()
        vec = torch.stack(mags)
        event = None
        if vec.device.type == "cuda":
            host = torch.empty(vec.shape, dtype=vec.dtype, pin_memory=True)
            host.copy_(vec, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            vec = host
        self._kf_queue.append((vec, event, tcands, self._kf_clock))

    def _apply_overdue(self):
        """Apply, oldest first, every flushed batch that is overdue."""
        q = self._kf_queue
        while q and (self._kf_clock - q[0][3] + self._b_eff - 1
                     >= self.cfg.ASYNC_KEYFRAME_LAG):
            vec, event, tcands, _ = q.pop(0)
            t_r = self._tick()
            if event is not None:
                event.synchronize()
            self._tock(t_r, "keyframe/result")
            t_a = self._tick()
            for m, tcand in zip(vec.tolist(), tcands):
                self._keyframe_apply(m, tcand)
            self._tock(t_a, "keyframe/apply")

    def _keyframe_apply(self, m, tcand):
        """Merge the candidate frame (found by timestamp) if motion is
        small."""
        cfg, hs, ds = self.cfg, self.hs, self.ds
        if not m / 2 < cfg.KEYFRAME_THRESH:
            return
        k = int(np.searchsorted(hs.tstamps[:self.n], tcand))
        if k >= self.n or hs.tstamps[k] != tcand or k < 1:
            return
        if self.n - 1 - k > cfg.kf_shift_cap():
            raise RuntimeError(f"keyframe merge shift {self.n - 1 - k} "
                               f"exceeds kf_shift_cap {cfg.kf_shift_cap()}")
        hs.delta[int(hs.tstamps[k])] = (int(hs.tstamps[k - 1]),
                                        kernels.relative_pose(ds.poses, k))

        e = hs.e_num
        self.remove_factors((hs.ii[:e] == k) | (hs.jj[:e] == k))

        # shift indices above the removed frame
        e = hs.e_num
        mask_i = hs.ii[:e] > k
        hs.kk[:e][mask_i] -= self.M
        hs.ii[:e][mask_i] -= 1
        hs.jj[:e][hs.jj[:e] > k] -= 1
        # elementwise, so it commutes with the deferred row permute
        kernels.shift_edge_indices(ds, k, self.M)
        kernels.compact_frames(ds, k, self.n, M=self.M, pmem=self.pmem,
                               mem=self.mem, shift_cap=cfg.kf_shift_cap())

        hs.tstamps[k:self.n - 1] = hs.tstamps[k + 1:self.n].copy()
        self.n -= 1
        self.m -= self.M
        if self.long_term_lc is not None:
            self.long_term_lc.keyframe(k)

    def keyframe(self):
        cfg, hs, ds = self.cfg, self.hs, self.ds
        if cfg.ASYNC_KEYFRAME:
            self._kf_clock += 1
            t_l = self._tick()
            if len(self._mag_pending) >= self._b_eff:
                self._flush_mags()
            self._tock(t_l, "keyframe/launch")
            self._apply_overdue()
        else:
            cand = self._candidate()
            if cand is not None:
                a, b, tcand = cand
                mag = kernels.flowmag_two(ds.poses, ds.patches,
                                          ds.intrinsics, a, b)
                self._keyframe_apply(float(mag), tcand)

        # retire edges outside the removal window; under loop closure the
        # loop edges into the optimization window stay
        t_rt = self._tick()
        e = hs.e_num
        to_remove = (hs.kk[:e] // self.M) < self.n - cfg.REMOVAL_WINDOW
        if cfg.LOOP_CLOSURE:
            to_remove &= ~(((hs.jj[:e] - hs.ii[:e]) > 30)
                           & (hs.jj[:e] > self.n - cfg.OPTIMIZATION_WINDOW))
        self.remove_factors(to_remove, store=True)
        self._flush_edge_permute()
        self._tock(t_rt, "keyframe/retire")

    def motion_probe(self):
        kk = torch.arange(self.m - self.M, self.m, device=self.device)
        jj = torch.full_like(kk, self.n)
        return float(kernels.motion_probe(
            self.ds, self.update_mod, kk // self.M, jj, kk, M=self.M,
            pmem=self.pmem, mem=self.mem))

    def edges_loop(self):
        """Loop-closure edge proposals: (kk, jj) numpy arrays."""
        return propose_loop_edges(self)

    # --- main entry --------------------------------------------------------

    @torch.no_grad()
    def __call__(self, tstamp, image, intrinsics):
        """Track one frame.  image: (H, W, 3) uint8 BGR (numpy or tensor);
        intrinsics: (4,) at full image resolution."""
        cfg, hs, ds = self.cfg, self.hs, self.ds
        if self.long_term_lc is not None:
            self.long_term_lc(image.cpu().numpy() if torch.is_tensor(image)
                              else np.asarray(image), self.n)
        if (self.n + 1) >= self.N:
            raise RuntimeError(
                f'The buffer size is too small. You can increase it using '
                f'"--opts BUFFER_SIZE {self.N * 2}"')

        if self.viewer is not None:
            # the map as the previous frame left it, at most once a period
            self.viewer.update_image(image)
            self.viewer.snapshot()

        hs.tlist.append(tstamp)
        hs.tstamps[self.n] = hs.counter

        # timestamp ratio for the motion model
        *_, a, b, c = [1] * 3 + hs.tlist
        fac = (c - b) / (b - a) if (b - a) != 0 else 1.0

        img = torch.as_tensor(image).to(self.device)
        intr = self._dev(np.asarray(intrinsics, np.float32)) / self.RES
        kw = dict(M=self.M, pmem=self.pmem, mem=self.mem,
                  motion_damping=float(cfg.MOTION_DAMPING))
        t_tr = self._tick()
        if self.test_centroids is None:
            kernels.track_frame_u8(
                ds, self.patchifier, img, intr, self.n, fac,
                self.is_initialized, self.gen,
                strat=cfg.CENTROID_SEL_STRAT, **kw)
        else:
            # parity test seam: scripted centroids + constant depth init
            coords = self._dev(np.asarray(self.test_centroids(hs.counter),
                                          np.float32))
            kernels.track_frame(
                ds, self.patchifier, normalize_images(img), coords, intr,
                self.n, fac, self.is_initialized, self.gen,
                fixed_depth=self.test_fixed_depth, **kw)
        self._tock(t_tr, "track_frame")

        hs.counter += 1
        if self.n > 0 and not self.is_initialized:
            if self.motion_probe() < 2.0:
                hs.delta[hs.counter - 1] = (
                    hs.counter - 2, lie.se3_identity(device=self.device))
                return

        self.n += 1
        self.m += self.M

        if (cfg.LOOP_CLOSURE
                and self.n - self.last_global_ba >= cfg.GLOBAL_OPT_FREQ):
            lkk, ljj = self.edges_loop()
            if len(lkk) > 0:
                self.last_global_ba = self.n
                self.append_factors(lkk, ljj)

        # forward + backward factors in one append
        t_ap = self._tick()
        kf, jf = self._DPVO__edges_forw()
        kb, jb = self._DPVO__edges_back()
        self.append_factors(np.concatenate([kf, kb]),
                            np.concatenate([jf, jb]))
        self._tock(t_ap, "append_factors")

        if self.n == 8 and not self.is_initialized:
            self.is_initialized = True
            for _ in range(12):
                self.update()
        elif self.is_initialized:
            # a full batch is flushed before the update, so its copy is
            # queued ahead of the update's work
            if (cfg.ASYNC_KEYFRAME
                    and len(self._mag_pending) >= self._b_eff):
                self._flush_mags()
            self.update()
            t_kf = self._tick()
            self.keyframe()
            self._tock(t_kf, "keyframe")

        if self.long_term_lc is not None:
            self.long_term_lc.attempt_loop_closure(self.n)
            self.long_term_lc.lc_callback()

    # --- trajectory extraction --------------------------------------------

    def get_pose(self, t):
        """Chase delta chains for removed frames."""
        if t in self.traj:
            return self.traj[t]
        t0, dP = self.hs.delta[t]
        return lie.se3_mul(dP.cpu(), self.get_pose(t0))

    @torch.no_grad()
    def terminate(self):
        """-> (poses (T, 7) xyz+quat numpy, tstamps (T,))."""
        if self.long_term_lc is not None:
            self.long_term_lc.terminate(self.n)
        if self.cfg.LOOP_CLOSURE:
            lkk, ljj = self.edges_loop()
            if len(lkk) > 0:
                self.append_factors(lkk, ljj)
        for _ in range(12):
            self.ran_global_ba[self.n] = False
            self.update()
        # lagged decisions still pending never apply
        self._mag_pending.clear()
        self._kf_queue.clear()
        poses_h = self.ds.poses.cpu()
        self.traj = {int(self.hs.tstamps[i]): poses_h[i]
                     for i in range(self.n)}
        poses = torch.stack([self.get_pose(t)
                             for t in range(self.hs.counter)])
        poses = lie.se3_inv(poses).numpy()
        if self.viewer is not None:
            self.viewer.join()
        return poses, np.array(self.hs.tlist, dtype=np.float64)
