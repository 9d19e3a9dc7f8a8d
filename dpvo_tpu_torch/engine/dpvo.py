"""The DPVO SLAM engine on one GPU: frame-by-frame visual odometry.

Counterpart of ``dpvo_tpu/engine/dpvo.py``, same public API::

    slam = DPVO(cfg, network, ht=480, wd=640, device="cuda")
    for t, image, intrinsics in stream:
        slam(t, image, intrinsics)
    poses, tstamps = slam.terminate()

The host owns the edge bookkeeping (numpy); the device programs of
``engine.kernels`` update fixed-capacity device tensors in place.

The device work of a frame is three fixed-shape programs, each reading
its dynamic inputs from a block of ``DeviceState`` that one copy refreshes
(from a pinned host block, ``non_blocking``; a frame already on the card
is copied device to device):

- tracking (``kernels.track_frame_u8``): the frame (``image_in``) and
  ``n``, ``fac``, ``is_initialized`` and the intrinsics (``track_in``);
- the update (``kernels.update_step_dev``) at a bucket of the JAX engine's
  ladder (``_bucket_for``): the live count, the BA window and the keyframe
  candidate's packed edges (``update_in``);
- the keyframe merge (``kernels.keyframe_merge``): ``k`` and ``n``
  (``merge_in``), once per merge, in order.

A steady frame never waits on the card but for the overdue batch of
lagged decisions.  On the card each program replays as a CUDA graph, one
per static key (tracking: the centroid strategy and the parity seam; the
update: bucket, local BA, magnitude, patch capacity, correlation version;
the merge: one), all in one pool, captured the first time the key is
reached or ahead of the frames by ``precompile``; ``cuda_graphs=False``
runs them eagerly, as the CPU always does.  The JAX engine's cold-bucket
guard: an update whose key has no graph yet replays the smallest captured
key that covers it (a larger bucket and patch capacity: the extra rows are
masked) while a worker thread captures its own graph, so an edge count
past the plan does not stop a frame for a capture.

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

Tracing (``utils.timing``, off by default): a call is traced when
``enable_timing`` is set or a ``torch.profiler`` is recording.  A traced
call records host spans (``call``; the JAX engine's phases ``track_frame``,
``append_factors``, ``update/meta``, ``update/step``, ``keyframe`` and its
``keyframe/{launch,result,apply,retire}``; ``update``, ``stage``,
``capture``, ``ba_global``, ``wait``, and one span per program run named
after the program) and the card's stamps at each program's boundaries,
with no fence.  ``timing_report()`` gives the phases' host ms, and
``timing_report("device")`` the device ms of the programs each ran.  The
phases nest: ``keyframe`` holds ``keyframe/*``, and ``update/meta`` and
``update/step`` lie inside no other phase, so only ``track_frame``,
``append_factors``, ``update/*`` and ``keyframe`` are disjoint.
"""
from __future__ import annotations

import contextlib
import math
import os
import threading
import time
from concurrent import futures

import numpy as np
import torch
from torch.autograd import profiler as _profiler

from ..config import VOConfig
from ..device import resolve_device
from ..models.update import Update
from ..models.vonet import Patchifier
from ..loop_closure.proximity import propose_loop_edges
from ..ops import _cuda, ba, corr_cuda, lie
from ..utils import timing
from ..utils.checkpoint import load_network
from . import kernels
from .state import (MM_CAP, UPDATE_SCALARS, allocate, allocate_host,
                    track_inputs)

# what each program writes: a capture's eager warm-up puts these back
TRACK_WRITES = ("poses", "patches", "intrinsics", "colors", "imap", "gmap",
                "fmap1", "fmap2")
MERGE_WRITES = TRACK_WRITES + ("eii", "ejj", "ekk")


def _program_name(key):
    """The ``engine.kernels`` program a graph key runs."""
    return {"track": "track_frame_u8", "merge": "keyframe_merge"}.get(
        key[0], "update_step_dev")


class DPVO:
    def __init__(self, cfg: VOConfig, network=None, ht: int = 480,
                 wd: int = 640, viz: bool = False, seed: int = 0,
                 device="cuda", cuda_graphs: bool = True):
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
        # tracing: the operator switch, the engine's tracer, and the tracer
        # while a traced call runs (None otherwise)
        self.enable_timing = False
        self.tracer = timing.Tracer(self.device)
        self._tr = None

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
        # the device programs on the card: one CUDA graph per static key
        # (update: bucket, run_ba, has_mm, k_cap, correlation version;
        # ("track", strategy, seam); ("merge",)), captured the first time
        # the key is reached (an update key with a captured cover: in the
        # worker, meanwhile replaying the cover) or by precompile();
        # cuda_graphs=False runs them eagerly (on the CPU they always run
        # eagerly)
        self.cuda_graphs = cuda_graphs and self.device.type == "cuda"
        self._graphs: dict = {}
        self._graph_pool = None
        self._capture_stream = None       # every capture records on it
        self.graph_capture_ms: dict = {}  # key -> ms, captures on this thread
        self.buckets_seen: dict = {}      # bucket -> updates run at it
        # the cold-bucket guard (the JAX engine's, ``_call_update_step``):
        # updates a cover served per exact key, and the worker's captures
        self.cover_served: dict = {}
        self.background_capture_ms: dict = {}
        self._graph_lock = threading.Lock()   # the worker picks, publishes
        self._worker = None               # one capture thread, made lazily
        self._in_flight: dict = {}        # key -> Future of its capture
        self._last_ask: dict = {}         # key -> ask number of its last ask
        self._asked_in: dict = {}         # key -> its last ask's span
        self._asks = 0
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

    # --- tracing -----------------------------------------------------------

    def timing_report(self, clock="host"):
        """{phase: (mean_ms, count)} over the traced calls the span ring
        holds, sorted by phase: ``clock`` "host", each phase's span;
        "device", the card's time of the programs each phase instance ran
        (``utils.timing.report``)."""
        return timing.report(self.tracer.engine, clock)

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
        """A host array on the device with no synchronisation: on the card
        a pinned copy sent with ``non_blocking``.  The pinned block comes
        from PyTorch's caching host allocator, which gives it out again only
        after the copy that read it has run."""
        t = torch.as_tensor(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

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

    # --- the bucket ladder (the JAX engine's) ------------------------------

    def _bucket_for(self, e):
        """Bucket an edge count to a ladder of static sizes: {1, 1.5}*2^k
        below 16384, quarter steps {1, 1.25, 1.5, 1.75}*2^k at or above
        (padding waste <= 12.5% where a wasted row costs real per-edge
        compute); BUCKET_FLOOR truncates the ladder's small end, so early
        frames pad up to it.  Capped at the edge capacity."""
        e = max(e, 1024, min(getattr(self.cfg, "BUCKET_FLOOR", 1024),
                             self.E_cap))
        p2 = 1 << math.ceil(math.log2(e))
        if p2 >= 16384:
            for m in (4, 5, 6, 7):
                c = m * (p2 // 8)
                if c >= e:
                    p2 = c
                    break
        elif 3 * (p2 // 4) >= e and (3 * (p2 // 4)) % 1024 == 0:
            p2 = 3 * (p2 // 4)
        return min(p2, self.E_cap)

    def _bucket_ladder(self):
        """All values ``_bucket_for`` can return, ascending."""
        vals = set()
        e = 1
        while e <= self.E_cap:
            vals.add(self._bucket_for(e))
            e += 256
        vals.add(self._bucket_for(self.E_cap))
        return sorted(vals)

    def _edge_bucket(self):
        return self._bucket_for(self.hs.e_num)

    # --- the update program ------------------------------------------------

    def update(self):
        cfg, hs = self.cfg, self.hs
        self._check_captures()
        if hs.e_num == 0:            # no keyframe pair yet: nothing to solve
            return
        tr = self._tr
        sp_update = tr and tr.begin("update")
        self._flush_edge_permute()
        # global BA once per keyframe count, when the active edges reach
        # behind the removal window (loop edges, or frame 0 at init)
        run_global = (cfg.LOOP_CLOSURE and not self.ran_global_ba[self.n]
                      and (hs.ii[:hs.e_num]
                           < self.n - cfg.REMOVAL_WINDOW - 1).any())
        if run_global:
            t0 = t1 = 0              # unused: no local BA in this update
        else:
            t0 = max(self.n - cfg.OPTIMIZATION_WINDOW
                     if self.is_initialized else 1, 1)
            t1 = self.n
        sp = tr and tr.begin("update/meta")
        bucket = self._edge_bucket()
        blob, tcand = self._mm_blob()
        k_cap = self._update_k_cap()
        self._stage_update(hs.e_num, t0, t1, blob)
        if sp:
            sp.end()
        # as in the JAX engine, update/step times the local-BA branch only
        sp = tr and not run_global and tr.begin("update/step")
        mag = self._call_update_step(bucket, not run_global,
                                     blob is not None, k_cap)
        if tcand is not None:
            # the candidate's magnitude on the poses of this update step
            # (after local BA, or before global BA), queued; a graph's
            # output is overwritten by its next replay
            self._mag_pending.append((mag.clone(), tcand))
        if run_global:
            self._run_global_ba()
        elif sp:
            sp.end()
        if sp_update:
            sp_update.end()

    def _copy_in(self, dst, src):
        """Write ``src`` (a numpy array or tensor of ``dst``'s shape) into the
        device block ``dst`` with one copy: from host memory through a
        pinned block of PyTorch's caching host allocator (which gives it
        out again only after the copy has run), ``non_blocking``; a tensor
        already on the card device to device."""
        if not torch.is_tensor(src):
            src = torch.from_numpy(np.ascontiguousarray(src))
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"expected shape {tuple(dst.shape)}, got "
                             f"{tuple(src.shape)}")
        sp = self._tr and self._tr.begin("stage")
        if self.device.type == "cuda" and src.device.type == "cpu":
            src = src.pin_memory()
        dst.copy_(src, non_blocking=True)
        if sp:
            sp.end()

    def _stage_update(self, e_num, t0, t1, blob):
        """Write the update's inputs (``DeviceState.update_in``) with one
        copy."""
        host = np.zeros(self.ds.update_in.shape[0], np.int32)
        host[:UPDATE_SCALARS] = (e_num, t0, t1)
        if blob is not None:
            host[UPDATE_SCALARS:] = blob
        self._copy_in(self.ds.update_in, host)

    def _update_program(self, bucket, run_ba, has_mm, k_cap, version=None):
        """The update as a function of the device state alone: reads
        ``update_in``, writes the state, returns the magnitude or None;
        ``version``: the correlation version (default the current one)."""
        ds = self.ds
        e_num, t0, t1 = ds.update_in[:UPDATE_SCALARS]
        blob = ds.update_in[UPDATE_SCALARS:]

        @torch.no_grad()
        def program():
            return kernels.update_step_dev(
                ds, self.update_mod, bucket, e_num, t0, t1, blob, M=self.M,
                pmem=self.pmem, mem=self.mem, n_cap=self.n_cap, k_cap=k_cap,
                iterations=2, run_ba=run_ba, has_mm=has_mm, mm_cap=MM_CAP,
                corr_version=version, stamp=self.tracer.stamper())[1]
        return program

    def _call_update_step(self, bucket, run_ba, has_mm, k_cap):
        """Run the update program at ``bucket`` (``_run``), behind the JAX
        engine's cold-bucket guard: on the card, when the exact key has no
        graph yet and a captured key covers it (``_cover``), the update
        replays the cover, and the worker captures the exact key off this
        thread (``_capture_later``); with no cover the key is captured
        here, at first reach.  A cover's extra rows are masked and its
        extra patch slots unused, so it computes what the exact program
        does; the rows it writes past ``bucket`` are past the live count,
        which the tables keep at zero (``append_edges``, ``permute_edges``)
        and the cover writes as zeros.  ``buckets_seen`` counts the bucket
        asked for, ``cover_served`` the updates a cover ran per exact
        key."""
        self.buckets_seen[bucket] = self.buckets_seen.get(bucket, 0) + 1
        key = self._update_key(bucket, run_ba, has_mm, k_cap)
        if self.cuda_graphs and key not in self._graphs:
            cover = self._cover(key)
            if cover is not None:
                self._capture_later(key)
                self.cover_served[key] = self.cover_served.get(key, 0) + 1
                return self._replay(cover)
        return self._run(key, self._update_program(*key),
                         self._update_writes(bucket))

    def _cover(self, key):
        """The captured update key that serves ``key`` while its own graph
        is missing (the JAX engine's rule, ``_call_update_step`` there):
        the same local BA, magnitude and correlation version, a bucket and
        a patch capacity at least ``key``'s; the smallest bucket, then the
        smallest capacity.  None if no key covers it."""
        bucket, run_ba, has_mm, k_cap, version = key
        with self._graph_lock:
            keys = list(self._graphs)
        covers = [k for k in keys if isinstance(k[0], int)
                  and (k[1], k[2], k[4]) == (run_ba, has_mm, version)
                  and k[0] >= bucket and k[3] >= k_cap]
        return min(covers, key=lambda k: (k[0], k[3]), default=None)

    def _update_key(self, bucket, run_ba, has_mm, k_cap):
        return (bucket, run_ba, has_mm, k_cap, corr_cuda.FUSED_VERSION)

    def _update_writes(self, bucket):
        ds = self.ds
        return (ds.net[:bucket], ds.target[:bucket], ds.weight[:bucket],
                ds.poses, ds.patches)

    def _stage_track(self, image, intrinsics, n, fac, is_initialized):
        """Write the tracking program's inputs: the frame into ``image_in``,
        and ``n``, ``fac``, ``is_initialized``, the intrinsics at feature
        resolution and (the parity seam) the scripted centroids into
        ``track_in``; one copy each."""
        centroids = (None if self.test_centroids is None
                     else self.test_centroids(self.hs.counter))
        self._copy_in(self.ds.track_in, track_inputs(
            self.M, n, fac, is_initialized,
            np.asarray(intrinsics, np.float32) / self.RES, centroids))
        self._copy_in(self.ds.image_in, image)

    def _track_program(self):
        """-> (key, the tracking program of the staged inputs)."""
        cfg = self.cfg
        seam = self.test_centroids is not None
        fixed = self.test_fixed_depth if seam else None
        kw = dict(M=self.M, pmem=self.pmem, mem=self.mem,
                  motion_damping=float(cfg.MOTION_DAMPING),
                  strat=cfg.CENTROID_SEL_STRAT, staged_centroids=seam,
                  fixed_depth=fixed)

        @torch.no_grad()
        def program():
            kernels.track_frame_u8(self.ds, self.patchifier, self.gen, **kw)
        return ("track", cfg.CENTROID_SEL_STRAT, seam, fixed), program

    def _merge_program(self):
        """-> (key, the keyframe merge of the staged (k, n))."""
        shift_cap = self.cfg.kf_shift_cap()

        def program():
            return kernels.keyframe_merge(self.ds, M=self.M, pmem=self.pmem,
                                          mem=self.mem, shift_cap=shift_cap)
        return ("merge", shift_cap), program

    def _writes(self, names):
        return tuple(getattr(self.ds, k) for k in names)

    def _run(self, key, program, written, draws=False):
        """Run ``program``: eagerly on the CPU (or with ``cuda_graphs=
        False``), else by replaying its CUDA graph, captured the first time
        its key is reached.  In a traced call an eager program stamps like
        its graph.  -> the program's output."""
        if not self.cuda_graphs:
            if self._tr is None:
                return program()
            sp = self._tr.replay(_program_name(key))
            with self.tracer.stamped():
                out = program()
            sp.end()
            return out
        if key not in self._graphs:
            # one capture into the pool at a time: the worker's running
            # one ends first, its queued ones are dropped (asked again,
            # they are scheduled again)
            self._wait_captures(queued=False)
            if key not in self._graphs:
                self._graphs[key] = self._capture(key, program, written,
                                                  draws)
        return self._replay(key)

    def _replay(self, key):
        """Replay ``key``'s graph and count its launches; in a traced call
        inside a span named after the program, after its ``pre`` stamp.
        -> its output."""
        graph, out, launches = self._graphs[key]
        sp = self._tr and self._tr.replay(_program_name(key))
        graph.replay()
        if sp:
            sp.end()
        _cuda.replayed(launches)
        return out

    @contextlib.contextmanager
    def _kept(self, written):
        """Put ``written`` and the engine's generator back as they were
        on leaving."""
        saved = [t.clone() for t in written]
        gen_state = self.gen.get_state()
        try:
            yield
        finally:
            for dst, src in zip(written, saved):
                dst.copy_(src)
            self.gen.set_state(gen_state)

    def _warm(self, program, written):
        """One eager run of ``program`` (on a side stream on the card) with
        what it writes, ``written``, and the engine's generator put back
        after (``_kept``)."""
        with self._kept(written):
            if self.device.type == "cuda":
                here = torch.cuda.current_stream(self.device)
                side = torch.cuda.Stream(self.device)
                side.wait_stream(here)
                with torch.cuda.stream(side):
                    program()
                here.wait_stream(side)
            else:
                program()

    def _replay_against_eager(self, key, program, written, draws=False):
        """The checks' view of a graph: ``program`` through ``_run`` (its
        graph replayed, captured first if need be) and then eagerly, each
        from the state and generator state found here, which are put back
        after each (``_kept``).  -> [(what it wrote and its output, cloned;
        the generator state after) for the replay, for the eager run]."""
        self._wait_captures()
        res = []
        for graph in (True, False):
            with self._kept(written):
                out = (self._run(key, program, written, draws) if graph
                       else program())
                res.append(([t.clone() for t in written]
                            + ([out.clone()] if out is not None else []),
                            self.gen.get_state()))
        return res

    def _capture(self, key, program, written, draws=False):
        """Capture ``program`` on this thread: the eager warm-up
        (``_warm``), then the capture (``_record``).  A program that
        ``draws`` from the engine's generator has it registered with its
        graph: a replay draws what the eager program would draw from the
        same generator state, and advances it as much.  A failed capture
        raises.  -> (graph, the program's output, the launches one replay
        makes)."""
        sp = self._tr and self._tr.begin("capture")
        t_c = time.perf_counter()
        self._warm(program, written)
        entry = self._record(program, draws)
        self.graph_capture_ms[key] = (time.perf_counter() - t_c) * 1e3
        if sp:
            sp.end()
        return entry

    def _record(self, program, draws=False):
        """Record ``program`` as a CUDA graph into the engine's graph pool,
        shared by all its graphs (their replays never overlap: all run on
        the engine's stream), on the capture stream, from the engine's
        thread or the worker alike: ``capture_begin``/``capture_end`` in
        thread-local mode, so that the other thread's allocations, pinned
        copies, replays and stream or event waits meanwhile neither fail
        the capture nor are refused (not ``torch.cuda.graph``, which
        synchronises the card and empties the allocator's caches on
        entering).  A device-wide synchronise from any thread while a
        capture is open is refused by CUDA and fails it: the engine waits
        on its stream.  The program is captured between its head and tail
        stamps, with its own (``utils.timing``).  -> (graph, output,
        launches one replay makes)."""
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
            self._capture_stream = torch.cuda.Stream(self.device)
        graph = torch.cuda.CUDAGraph()
        if draws:
            graph.register_generator_state(self.gen)
        with (_cuda.captured_launches() as launches,
              torch.cuda.stream(self._capture_stream)):
            graph.capture_begin(pool=self._graph_pool,
                                capture_error_mode="thread_local")
            try:
                with self.tracer.stamped():
                    out = program()
            except BaseException:
                # the program's error, not the capture's on ending; the
                # failed graph is freed here, while no capture is open
                # (freed later, its release fails the capture under way)
                with contextlib.suppress(Exception):
                    graph.capture_end()
                with contextlib.suppress(Exception):
                    graph.reset()
                raise
            graph.capture_end()
        return graph, out, launches

    # --- the cold-bucket guard's worker ------------------------------------

    @staticmethod
    def _capture_thread_init(device, stream, ctype):
        """Ready the worker thread for captures: its current device, and
        this thread's cuBLAS and cuSOLVER handles with their workspaces on
        the capture stream (a throwaway product in each compute dtype and a
        Cholesky solve), which a capture must not create."""
        torch.cuda.set_device(device)
        with torch.no_grad(), torch.cuda.stream(stream):
            for dt in {torch.float32, ctype}:
                a = torch.ones((16, 16), device=device, dtype=dt)
                torch.nn.functional.linear(a, a, a[0]) @ a
            eye = torch.eye(8, device=device)
            torch.cholesky_solve(eye[:, :1], torch.linalg.cholesky_ex(eye)[0])

    def _start_worker(self):
        """The capture worker, started on first use: one thread, readied by
        ``_capture_thread_init`` on the engine's device (by index: a thread
        starts on device 0)."""
        if self._worker is None:
            device = self.device
            if device.type == "cuda" and device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
            self._worker = futures.ThreadPoolExecutor(
                1, thread_name_prefix="dpvo-capture",
                initializer=self._capture_thread_init,
                initargs=(device, self._capture_stream, self.ctype))
        return self._worker

    def _capture_later(self, key):
        """Have the worker capture update ``key``, once: a key in flight is
        not scheduled again, but its ask is noted, and the worker takes
        the queued key asked for last first (``_capture_off_thread``)."""
        self._asks += 1
        with self._graph_lock:
            self._last_ask[key] = self._asks
            self._asked_in[key] = self._tr and self._tr.ask()
            if key in self._in_flight:
                return
            self._in_flight[key] = futures.Future()
        # one task per key scheduled: every queued key finds one
        self._start_worker().submit(self._capture_off_thread)

    def _capture_off_thread(self):
        """A worker task: capture the queued update key asked for last
        (``_record``), with no eager pass: the state is the frames', and
        every library the program runs was loaded when its cover was
        captured.  The graph is published into ``_graphs`` under the lock;
        a failure stays in the key's future (``_check_captures``).  Asked
        in a traced call, the capture is a ``capture`` span under the span
        that asked last."""
        with self._graph_lock:
            queued = [k for k, f in self._in_flight.items()
                      if not (f.running() or f.done())]
            if not queued:            # dropped (``_wait_captures``)
                return
            key = max(queued, key=self._last_ask.__getitem__)
            fut = self._in_flight[key]
            fut.set_running_or_notify_cancel()
            ask = self._asked_in.get(key)
        sp = ask and self.tracer.begin("capture", ask)
        t_c = time.perf_counter()
        try:
            entry = self._record(self._update_program(*key))
        except BaseException as e:
            fut.set_exception(e)
            fut = None       # no cycle: the error's frames hold this one
            return
        finally:
            if sp:
                sp.end()
        ms = (time.perf_counter() - t_c) * 1e3
        with self._graph_lock:
            self._graphs[key] = entry
            self.background_capture_ms[key] = ms
        fut.set_result(None)

    def _check_captures(self):
        """Forget the finished background captures, and re-raise a failed
        one's error here, with the worker's traceback."""
        with self._graph_lock:
            done = {k: f for k, f in self._in_flight.items() if f.done()}
            self._in_flight = {k: f for k, f in self._in_flight.items()
                               if k not in done}
        for fut in done.values():
            fut.result()

    def _wait_captures(self, queued=True):
        """Wait for the background captures in flight (two captures into
        the pool may not run at once) and re-raise a failure here; with
        ``queued=False`` only for the running one: the keys not started
        are dropped, and a cover's next ask schedules them again."""
        if not queued:
            with self._graph_lock:
                self._in_flight = {k: f for k, f in self._in_flight.items()
                                   if not f.cancel()}
        sp = self._tr and self._tr.begin("wait")
        futures.wait(list(self._in_flight.values()))
        if sp:
            sp.end()
        self._check_captures()

    def graph_pool_bytes(self):
        """Bytes the card reserves for the engine's graph pool (from the
        allocator's snapshot), or None without graphs."""
        if self._graph_pool is None:
            return None
        segs = torch.cuda.memory._snapshot()["segments"]
        return sum(s["total_size"] for s in segs
                   if tuple(s.get("segment_pool_id", ())) ==
                   tuple(self._graph_pool))

    def _plan_buckets(self, max_edges=None, around=None, steps=2):
        """``precompile``'s buckets, the JAX engine's plan: the ladder values
        at or below ``_bucket_for(max_edges)``, else the ``steps`` ladder
        places either side of ``_bucket_for(around or the live count)``;
        plus the ladder's top (the cover of any edge count)."""
        ladder = self._bucket_ladder()
        if max_edges is not None:
            top = self._bucket_for(max_edges)
            buckets = [b for b in ladder if b <= top]
        else:
            c = ladder.index(self._bucket_for(
                around if around is not None else max(self.hs.e_num, 1)))
            buckets = ladder[max(c - steps, 0):c + steps + 1]
        if ladder and ladder[-1] not in buckets:
            buckets = buckets + [ladder[-1]]
        return buckets

    @torch.no_grad()
    def precompile(self, max_edges=None, around=None, steps=2,
                   verbose=False):
        """Ready every program the steady loop can dispatch before it runs
        (``DPVO.precompile`` of the JAX engine, its signature and bucket
        plan, ``_plan_buckets``): the update at each planned bucket with
        local BA (and without, under ``LOOP_CLOSURE``), its magnitude as
        ``ASYNC_KEYFRAME`` sets it, at the default patch capacity and the
        current correlation version; then the tracking program and the
        keyframe merge.  On the card each key not yet captured is captured
        now, the largest bucket first, so that the shared graph pool is
        sized by the first capture; with ``cuda_graphs=False`` and on the
        CPU each program runs its eager warm-up alone (``_warm``) and
        nothing is captured.  It first waits for the background captures in
        flight and skips the keys they published, and on the card it
        starts the capture worker (``_start_worker``).  Under loop closure an
        update whose live edges leave from more frames raises its patch
        capacity (``_update_k_cap``): such a key is served by a captured
        cover of at least its capacity where there is one
        (``_call_update_step``), else captured at first reach.

        A graph holds the addresses of the state it was captured on, so the
        programs run on the engine's own state, with a well-posed slot 0
        (identity pose, unit intrinsics and depths: the masked rows of an
        empty bucket read it) and staged inputs of their own; the state, the
        staged inputs and the generator are put back bitwise as they were.
        Call it again with ``around`` after warm frames to cover drift past
        a bucket boundary.  -> dict: ``seconds``, ``ms`` (capture or warm-up
        ms of each key readied now), ``pool_bytes`` (``graph_pool_bytes``
        after)."""
        cfg, ds = self.cfg, self.ds
        t_all = time.perf_counter()
        self._wait_captures()
        run_bas = (True, False) if cfg.LOOP_CLOSURE else (True,)
        has_mm = bool(cfg.ASYNC_KEYFRAME)
        buckets = sorted(self._plan_buckets(max_edges, around, steps),
                         reverse=True)
        saved = {k: v.clone() for k, v in vars(ds).items()}
        gen_state = self.gen.get_state()
        ms = {}
        try:
            ds.poses[0] = lie.se3_identity(device=self.device)
            ds.intrinsics[0] = 1.0
            ds.patches[:self.M, 2] = 1.0
            self._stage_update(0, 1, 2, np.zeros(8 * MM_CAP, np.int32)
                               if has_mm else None)
            plan = [(self._update_key(b, rb, has_mm, self.k_cap),
                     self._update_program(b, rb, has_mm, self.k_cap),
                     self._update_writes(b), False)
                    for b in buckets for rb in run_bas]
            # staged as a first frame
            self._stage_track(np.zeros(tuple(ds.image_in.shape), np.uint8),
                              np.full(4, self.RES, np.float32), 0, 1.0,
                              False)
            plan.append((*self._track_program(),
                         self._writes(TRACK_WRITES), True))
            plan.append((*self._merge_program(),
                         self._writes(MERGE_WRITES), False))
            self._copy_in(ds.merge_in, np.array([1, 2], np.int32))
            for key, program, written, draws in plan:
                if key in self._graphs:
                    continue
                t0 = time.perf_counter()
                if self.cuda_graphs:
                    self._graphs[key] = self._capture(key, program, written,
                                                      draws)
                else:
                    self._warm(program, written)
                ms[key] = (time.perf_counter() - t0) * 1e3
                if verbose:
                    print(f"precompile {key}: {ms[key]:.1f} ms", flush=True)
        finally:
            for k, v in saved.items():
                getattr(ds, k).copy_(v)
            self.gen.set_state(gen_state)
        if self.cuda_graphs:
            # the worker's one-off start (its thread's libraries) here,
            # not in the first frame a cover serves
            self._start_worker().submit(int).result()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        out = dict(seconds=time.perf_counter() - t_all, ms=ms,
                   pool_bytes=self.graph_pool_bytes())
        if verbose:
            print(f"precompile: {len(ms)} keys in {out['seconds']:.2f} s, "
                  f"pool bytes {out['pool_bytes']}", flush=True)
        return out

    # --- core steps --------------------------------------------------------

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
        sp = self._tr and self._tr.begin("ba_global")
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
        poses, patches = ba_fn(
            ds.poses, ds.patches, ds.intrinsics[0], t_p, w_p, 1e-4,
            *(self._dev(np.concatenate([a, pad])) for a in (ii, jj, kk)),
            self._dev(np.arange(cap) < E), t0, self.n, n_cap=n_cap,
            k_cap=k_cap, iterations=2)
        # in place: the update's graphs hold the state's addresses
        ds.poses.copy_(poses)
        ds.patches.copy_(patches)
        self.ran_global_ba[self.n] = True
        if sp:
            sp.end()

    def normalize(self):
        """Rescale depths and poses (``kernels.normalize_scene``) and the
        deltas of removed frames by the same device scalar: no host
        fetch."""
        s = kernels.normalize_scene(self.ds, self.n, self.M)
        for t, (t0, dP) in self.hs.delta.items():
            self.hs.delta[t] = (t0, lie.se3_scale(dP, s))

    def _motionmag_edges(self, i, j, cap=MM_CAP):
        """Fixed-capacity edge slice of one motionmag direction: (ii, jj,
        kk, valid) numpy arrays of ``cap`` rows and the live count.  A
        direction holds at most M edges; the assert keeps a larger config
        from silently changing keyframing."""
        hs = self.hs
        e = hs.e_num
        k = (hs.ii[:e] == i) & (hs.jj[:e] == j)
        cnt = int(k.sum())
        assert cnt <= cap, (
            f"motionmag edge slice overflow: {cnt} > {cap}; raise cap "
            f"(PATCHES_PER_FRAME={self.M})")
        out = [np.zeros(cap, np.int32) for _ in range(3)]
        for dst, src in zip(out, (hs.ii, hs.jj, hs.kk)):
            dst[:cnt] = src[:e][k]
        valid = np.zeros(cap, bool)
        valid[:cnt] = True
        return (*out, valid, cnt)

    def motionmag(self, i, j):
        """Mean flow magnitude of the live edges from frame ``i`` into frame
        ``j`` on the current poses (0.0 when no edge joins them): one
        upload, one host read.  The engine's own decisions take the
        magnitude inside the update program instead."""
        *edges, cnt = self._motionmag_edges(i, j)
        if cnt == 0:
            return 0.0
        blob = self._dev(np.concatenate([a.astype(np.int32) for a in edges]))
        p = kernels.split_blob(blob, (MM_CAP,) * 4, bools=(3,))
        return float(kernels.flowmag_pair(self.ds.poses, self.ds.patches,
                                          self.ds.intrinsics, *p))

    def _candidate_blob(self):
        """The keyframe candidate's motionmag edges, both directions, packed
        into one (8 * MM_CAP,) int32 array, and its timestamp; (an
        all-invalid blob, None) while it has no edges."""
        cfg = self.cfg
        i = self.n - cfg.KEYFRAME_INDEX - 1
        j = self.n - cfg.KEYFRAME_INDEX + 1
        *a, na = self._motionmag_edges(i, j)
        *b, nb = self._motionmag_edges(j, i)
        if na == 0 and nb == 0:
            return np.zeros(8 * MM_CAP, np.int32), None
        blob = np.concatenate([x.astype(np.int32) for x in (*a, *b)])
        return blob, int(self.hs.tstamps[self.n - cfg.KEYFRAME_INDEX])

    def _mm_blob(self):
        """The update program's magnitude input: (blob, candidate
        timestamp) with lagged decisions, the blob all-invalid and the
        timestamp None while there is no candidate (so each bucket has one
        program); (None, None) with synchronous ones, which take the
        magnitude after the update (``keyframe``)."""
        if not self.cfg.ASYNC_KEYFRAME:
            return None, None
        return self._candidate_blob()

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
        q, tr = self._kf_queue, self._tr
        while q and (self._kf_clock - q[0][3] + self._b_eff - 1
                     >= self.cfg.ASYNC_KEYFRAME_LAG):
            vec, event, tcands, _ = q.pop(0)
            sp = tr and tr.begin("keyframe/result")
            if event is not None:
                sp_wait = tr and tr.begin("wait")
                event.synchronize()
                if sp_wait:
                    sp_wait.end()
            if sp:
                sp.end()
            sp = tr and tr.begin("keyframe/apply")
            for m, tcand in zip(vec.tolist(), tcands):
                self._keyframe_apply(m, tcand)
            if sp:
                sp.end()

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
        e = hs.e_num
        self.remove_factors((hs.ii[:e] == k) | (hs.jj[:e] == k))

        # shift indices above the removed frame
        e = hs.e_num
        mask_i = hs.ii[:e] > k
        hs.kk[:e][mask_i] -= self.M
        hs.ii[:e][mask_i] -= 1
        hs.jj[:e][hs.jj[:e] > k] -= 1
        # the device program: the relative pose, the device index shift
        # (elementwise, so it commutes with the deferred row permute) and
        # the frame compaction; a graph's output is overwritten by its next
        # replay
        self._copy_in(ds.merge_in, np.array([k, self.n], np.int32))
        dP = self._run(*self._merge_program(), self._writes(MERGE_WRITES))
        hs.delta[int(hs.tstamps[k])] = (int(hs.tstamps[k - 1]), dP.clone())

        hs.tstamps[k:self.n - 1] = hs.tstamps[k + 1:self.n].copy()
        self.n -= 1
        self.m -= self.M
        if self.long_term_lc is not None:
            self.long_term_lc.keyframe(k)

    def keyframe(self):
        cfg, hs, ds, tr = self.cfg, self.hs, self.ds, self._tr
        if cfg.ASYNC_KEYFRAME:
            self._kf_clock += 1
            sp = tr and tr.begin("keyframe/launch")
            if len(self._mag_pending) >= self._b_eff:
                self._flush_mags()
            if sp:
                sp.end()
            self._apply_overdue()
        else:
            blob, tcand = self._candidate_blob()
            if tcand is not None:
                mag = kernels.flowmag_two_blob(ds.poses, ds.patches,
                                               ds.intrinsics,
                                               self._dev(blob), MM_CAP)
                self._keyframe_apply(float(mag), tcand)

        # retire edges outside the removal window; under loop closure the
        # loop edges into the optimization window stay
        sp = tr and tr.begin("keyframe/retire")
        e = hs.e_num
        to_remove = (hs.kk[:e] // self.M) < self.n - cfg.REMOVAL_WINDOW
        if cfg.LOOP_CLOSURE:
            to_remove &= ~(((hs.jj[:e] - hs.ii[:e]) > 30)
                           & (hs.jj[:e] > self.n - cfg.OPTIMIZATION_WINDOW))
        self.remove_factors(to_remove, store=True)
        self._flush_edge_permute()
        if sp:
            sp.end()

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
        intrinsics: (4,) at full image resolution.  Traced (``utils.timing``)
        when ``enable_timing`` is set or a ``torch.profiler`` records."""
        if not (self.enable_timing or _profiler._is_profiler_enabled):
            return self._frame(tstamp, image, intrinsics)
        self._tr = self.tracer.begin_call(self.hs.counter)
        try:
            return self._frame(tstamp, image, intrinsics)
        finally:
            self._tr = None
            self.tracer.end_call()

    def _frame(self, tstamp, image, intrinsics):
        cfg, hs, tr = self.cfg, self.hs, self._tr
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

        sp = tr and tr.begin("track_frame")
        self._stage_track(image, intrinsics, self.n, fac, self.is_initialized)
        key, program = self._track_program()
        self._run(key, program, self._writes(TRACK_WRITES), draws=True)
        if sp:
            sp.end()

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
        sp = tr and tr.begin("append_factors")
        kf, jf = self._DPVO__edges_forw()
        kb, jb = self._DPVO__edges_back()
        self.append_factors(np.concatenate([kf, kb]),
                            np.concatenate([jf, jb]))
        if sp:
            sp.end()

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
            sp = tr and tr.begin("keyframe")
            self.keyframe()
            if sp:
                sp.end()

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
        """-> (poses (T, 7) xyz+quat numpy, tstamps (T,)).  Waits for the
        background captures (re-raising a failure) and stops the worker."""
        self._wait_captures()
        if self.long_term_lc is not None:
            self.long_term_lc.terminate(self.n)
        if self.cfg.LOOP_CLOSURE:
            lkk, ljj = self.edges_loop()
            if len(lkk) > 0:
                self.append_factors(lkk, ljj)
        for _ in range(12):
            self.ran_global_ba[self.n] = False
            self.update()
        self._wait_captures()
        if self._worker is not None:
            self._worker.shutdown()
            self._worker = None
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
