"""DPVO's frame loop as plain Python and PyTorch: the bookkeeping of keyframes
and edges for every frame of a run (``Structure``), and the numerical
state of one frame's step (``Numeric``).

``Structure`` follows, frame by frame, what DPVO's ``__call__`` does to its
host state: the frame's slot and timestamp, the forward and backward edges of
the patch graph (``PATCH_LIFETIME``), the twelve updates at the eighth
keyframe, the keyframe decisions lagged and batched as the configuration
states (``ASYNC_KEYFRAME_LAG``, ``ASYNC_KEYFRAME_BATCH``), the merges they
apply and the retirement of edges behind ``REMOVAL_WINDOW``.  A decision's
outcome is pinned by the traffic (``KEYFRAME_THRESH`` 0: never merge; a
threshold no finite motion reaches: always merge), since random weights
cannot decide one; which frame it concerns and when it applies is the
schedule's.

Under proximity loop closure (``LOOP_CLOSURE``, DPV-SLAM), in the regime
that never merges, it follows loop closure's bookkeeping as DPV-SLAM's
code does it: a loop round at each frame where ``GLOBAL_OPT_FREQ``
keyframes have passed since the last round with edges, its edges appended
before the frame's own; loop edges into the optimization window kept at
retirement; every retired edge appended to an inactive store, in the order
the program stores them; and, for each update, whether global BA runs.
The proposals of a round are taken as the program made them (``proposals``,
by frame), as its random centroids are: they follow from its poses.

``Numeric`` is the state one step needs, taken from the program before the
frame (poses, patch centroids and depths, the edges' hidden state), and
moved by the same bookkeeping: tracking (both encoders, the patches, the
damped linear motion model, the depth of a new frame), the update (the
two-level correlation, the update operator, local BA) and the merge.
"""
from __future__ import annotations

import numpy as np
import torch

from . import ba, lie, model

INIT_FRAMES = 8       # keyframes before the first update
INIT_UPDATES = 12     # updates at initialisation


class Structure:
    """The host bookkeeping of a run, from frame 0."""

    def __init__(self, cfg: dict, proposals=None):
        self.M = cfg["PATCHES_PER_FRAME"]
        self.life = cfg["PATCH_LIFETIME"]
        self.rw = cfg["REMOVAL_WINDOW"]
        self.ow = cfg["OPTIMIZATION_WINDOW"]
        self.ki = cfg["KEYFRAME_INDEX"]
        self.lag = cfg["ASYNC_KEYFRAME_LAG"]
        self.batch = max(1, min(cfg["ASYNC_KEYFRAME_BATCH"], self.lag))
        self.shift_cap = self.ki + self.lag + 1
        self.buffer = cfg["BUFFER_SIZE"]
        if not cfg.get("ASYNC_KEYFRAME", True):
            raise ValueError("the reference follows lagged keyframing only")
        thresh = cfg["KEYFRAME_THRESH"]
        if thresh <= 0:
            self.merges = False
        elif thresh >= 1e6:
            self.merges = True
        else:
            raise ValueError(f"KEYFRAME_THRESH {thresh} leaves the decision "
                             "to the motion; the traffic must pin it")
        self.lc = bool(cfg.get("LOOP_CLOSURE"))
        if self.lc and self.merges:
            raise ValueError("the reference follows loop closure in the "
                             "regime that never merges (KEYFRAME_THRESH 0) "
                             "only, not with merges (KEYFRAME_THRESH >= 1e6)")
        self.freq = cfg.get("GLOBAL_OPT_FREQ")
        # the program's loop proposals: frame -> [(kk, jj)], one a call
        self.proposals = proposals or {}
        self.last_global_ba = -1000
        self.ran_global: set[int] = set()   # keyframe counts global BA ran at
        self.inac: list = []                # retired edges: (ii, jj, kk) chunks
        self.n_inac = 0
        self._inac = None                   # the chunks joined
        # loop edges appended, and for each update whether global BA ran,
        # by the frame that did it
        self.loop_edges: dict[int, int] = {}
        self.global_ba: dict[int, list[bool]] = {}
        self.n = 0
        self.counter = 0
        self.tstamps: list[int] = []
        self.ii = np.zeros(0, np.int64)
        self.jj = np.zeros(0, np.int64)
        self.kk = np.zeros(0, np.int64)
        self.initialized = False
        self.kf_clock = 0
        self.pending: list[int] = []
        self.queue: list[tuple[list[int], int]] = []
        # the live edges of each update, by the frame that ran it
        self.update_edges: dict[int, list[int]] = {}

    def key(self):
        """The edge set as sorted keys kk * 2^20 + jj."""
        return np.sort(self.kk * (1 << 20) + self.jj)

    def frame(self, num=None, init_updates=INIT_UPDATES):
        """One frame's call; ``num`` (a ``Numeric``) follows it.  With
        ``init_updates`` the initialisation stops after that many updates
        (the state the check's start copies)."""
        if self.n + 1 >= self.buffer:
            raise RuntimeError("the buffer is full")
        slot = self.n
        self.tstamps.append(self.counter)
        if num is not None:
            num.track(self, slot)
        self.counter += 1
        self.n += 1
        if self.lc and self.n - self.last_global_ba >= self.freq:
            self.loop(num)
        n, M, r = self.n, self.M, self.life
        kf = np.arange(M * max(n - r, 0), M * max(n - 1, 0))
        jf = np.full_like(kf, n - 1)
        k0 = np.arange(M * (n - 1), M * n)
        jr = np.arange(max(n - r, 0), n)
        kk = np.concatenate([kf, np.repeat(k0, len(jr))])
        jj = np.concatenate([jf, np.tile(jr, len(k0))])
        self.kk = np.concatenate([self.kk, kk])
        self.jj = np.concatenate([self.jj, jj])
        self.ii = np.concatenate([self.ii, kk // M])
        if num is not None:
            num.append(len(kk))
        if self.n == INIT_FRAMES and not self.initialized:
            self.initialized = True
            for _ in range(init_updates):
                self.update(num)
        elif self.initialized:
            if len(self.pending) >= self.batch:
                self.flush()
            self.update(num)
            self.keyframe(num)

    def loop(self, num):
        """A loop round: the program's proposal at this frame (its first
        call here; none recorded reads as empty), appended when not
        empty."""
        calls = self.proposals.get(self.counter - 1)
        if not calls or len(calls[0][0]) == 0:
            return
        kk, jj = (np.asarray(a, np.int64) for a in calls[0])
        self.last_global_ba = self.n
        self.loop_edges[self.counter - 1] = len(kk)
        self.kk = np.concatenate([self.kk, kk])
        self.jj = np.concatenate([self.jj, jj])
        self.ii = np.concatenate([self.ii, kk // self.M])
        if num is not None:
            num.append(len(kk))

    def update(self, num):
        n = self.n
        self.update_edges.setdefault(self.counter - 1, []).append(
            len(self.kk))
        if self.lc:
            # global BA in place of local BA, once a keyframe count, while
            # an active edge leaves from behind the removal window
            run_global = (n not in self.ran_global
                          and bool((self.ii < n - self.rw - 1).any()))
            self.global_ba.setdefault(self.counter - 1, []).append(run_global)
            if run_global:
                self.ran_global.add(n)
                if num is not None:
                    raise NotImplementedError(
                        "the reference's step has no global BA: the "
                        "configuration's check follows it")
        if num is not None:
            num.update(self, max(n - self.ow, 1), n)
        i, j = n - self.ki - 1, n - self.ki + 1
        if (((self.ii == i) & (self.jj == j)).any()
                or ((self.ii == j) & (self.jj == i)).any()):
            self.pending.append(self.tstamps[n - self.ki])

    def flush(self):
        self.queue.append((list(self.pending), self.kf_clock))
        self.pending.clear()

    def keyframe(self, num):
        self.kf_clock += 1
        if len(self.pending) >= self.batch:
            self.flush()
        while self.queue and (self.kf_clock - self.queue[0][1]
                              + self.batch - 1 >= self.lag):
            for tcand in self.queue.pop(0)[0]:
                self.apply(tcand, num)
        retire = self.kk // self.M < self.n - self.rw
        if self.lc:
            # loop edges into the optimization window stay
            retire &= ~(((self.jj - self.ii) > 30)
                        & (self.jj > self.n - self.ow))
        self.remove(retire, num, store=True)

    def apply(self, tcand, num):
        if not self.merges or tcand not in self.tstamps[:self.n]:
            return
        k = self.tstamps.index(tcand)
        if k < 1:
            return
        if self.n - 1 - k > self.shift_cap:
            raise RuntimeError("keyframe merge shift past its cap")
        self.remove((self.ii == k) | (self.jj == k), num)
        up = self.ii > k
        self.kk = self.kk - up * self.M
        self.ii = self.ii - up
        self.jj = self.jj - (self.jj > k)
        if num is not None:
            num.merge(k)
        del self.tstamps[k]
        self.n -= 1

    def remove(self, mask, num, store=False):
        if store and self.lc and mask.any():
            self.inac.append((self.ii[mask], self.jj[mask], self.kk[mask]))
            self.n_inac += int(mask.sum())
            self._inac = None
        keep = ~mask
        self.ii, self.jj, self.kk = self.ii[keep], self.jj[keep], self.kk[keep]
        if num is not None:
            num.keep(torch.as_tensor(keep, device=num.device))

    def inactive(self):
        """The inactive store's (ii, jj, kk), in the order stored."""
        if self._inac is None:
            self._inac = tuple(
                np.concatenate([c[i] for c in self.inac]) if self.inac
                else np.zeros(0, np.int64) for i in range(3))
        return self._inac


class Numeric:
    """One step's numerical state, from the program's state before it.

    ``poses`` (n, 7), ``ctr`` (n*M, 2) patch centroids, ``depth`` (n*M,),
    ``net`` (E, DIM), ``target``/``weight`` (E, 2) in the order of the
    ``Structure``'s edges; ``centroids`` maps a frame's timestamp to its
    (M, 2) centroids and ``draws`` to the (M,) depths drawn for it before
    initialisation (both the program's random draws); ``image(t)`` gives
    frame t (H, W, 3) uint8 on the device, ``intr`` (4,) the intrinsics at
    feature resolution.  ``features`` caches each frame's by timestamp
    (steps of one run share it)."""

    def __init__(self, weights, state, centroids, image, intr, M, damping,
                 prec="fp32", draws=None, features=None):
        self.w = weights
        self.poses = state["poses"].float().clone()
        self.ctr = state["ctr"].float().clone()
        self.depth = state["depth"].float().clone()
        self.net = state["net"].float().clone()
        self.target = state["target"].float().clone()
        self.weight = state["weight"].float().clone()
        self.device = self.poses.device
        self.centroids, self.draws = centroids, draws or {}
        self.image, self.intr, self.M = image, intr, M
        self.damping, self.prec = damping, prec
        self.features = {} if features is None else features
        self.delta = torch.zeros_like(self.target)
        # what the step made: each new frame's features, its predicted pose
        # and first depth, by timestamp; the last update's inputs
        self.made, self.base_pose, self.base_depth = {}, {}, {}
        self.coords = self.upd = None     # the last update's inputs
        # depths whose last step rounding can set (``ba.local_ba``)
        self.loose = torch.zeros_like(self.depth, dtype=torch.bool)

    def feats(self, t):
        if t not in self.features:
            self.features[t] = model.frame_features(
                self.w, self.image(t), self.centroids[t].to(self.device),
                self.prec)
        return self.features[t]

    def track(self, st, slot):
        t = st.tstamps[slot]
        self.made[t] = self.feats(t)
        n, P = slot, self.poses
        if n == 0:        # the identity the program's pose table starts at
            pose = torch.tensor([0.0] * 6 + [1.0], device=self.device)
        elif n == 1:
            pose = P[0]
        else:
            # the damped linear model (timestamps one frame apart)
            xi = self.damping * lie.log(lie.mul(P[n - 1], lie.inv(P[n - 2])))
            pose = lie.mul(lie.exp(xi), P[n - 1])
        if st.initialized:
            recent = self.depth[max(n - 3, 0) * self.M:
                                (max(n - 3, 0) + 3) * self.M]
            flat = torch.sort(recent.repeat_interleave(model.P * model.P))
            d = flat.values[(flat.values.numel() - 1) // 2].expand(self.M)
        else:
            d = self.draws[t].to(self.device).float()
        self.base_pose[t], self.base_depth[t] = pose, d
        self.poses = torch.cat([self.poses[:n], pose[None]])
        self.ctr = torch.cat([self.ctr[:n * self.M],
                              self.centroids[t].to(self.device).float()])
        self.depth = torch.cat([self.depth[:n * self.M], d])
        self.loose = torch.cat([self.loose[:n * self.M],
                               torch.zeros_like(d, dtype=torch.bool)])

    def append(self, cnt):
        z = self.net.new_zeros
        self.net = torch.cat([self.net, z((cnt, self.net.shape[1]))])
        self.target = torch.cat([self.target, z((cnt, 2))])
        self.weight = torch.cat([self.weight, z((cnt, 2))])
        self.delta = torch.cat([self.delta, z((cnt, 2))])

    def update(self, st, t0, t1):
        dev = self.device
        ii, jj, kk = (torch.as_tensor(a, device=dev) for a in
                      (st.ii, st.jj, st.kk))
        coords = model.reproject(self.poses, self.ctr, self.depth,
                                 self.intr, ii, jj, kk)
        # the features of every frame the edges read, by slot
        slots = sorted(set(st.ii.tolist()) | set(st.jj.tolist()))
        f = {s: self.feats(st.tstamps[s]) for s in slots}
        loc = torch.full((st.n,), -1, dtype=torch.long, device=dev)
        loc[slots] = torch.arange(len(slots), device=dev)
        fm1 = torch.stack([f[s]["fmap1"] for s in slots])
        fm2 = torch.stack([f[s]["fmap2"] for s in slots])
        gmap = torch.stack([f[s]["gmap"] for s in slots])   # (S, M, P, P, C)
        imap = torch.stack([f[s]["imap"] for s in slots])
        pk = kk % self.M
        corr = model.correlation(gmap[loc[ii], pk], [(fm1, loc[jj]),
                                                     (fm2, loc[jj])],
                                 coords, self.prec)
        self.coords, self.upd = coords, (ii, jj, kk, t0, t1)
        net, delta, weight = model.update_operator(
            self.w, self.net, imap[loc[ii], pk], corr, ii, jj, kk, self.prec)
        c = model.P // 2
        target = coords[:, c, c] + delta
        self.net, self.target, self.weight = net, target, weight
        self.delta = delta
        self.poses, self.depth, self.loose = ba.local_ba(
            self.poses, self.ctr, self.depth, self.intr, target, weight,
            ii, jj, kk, t0, t1)

    def merge(self, k):
        M = self.M
        self.poses = torch.cat([self.poses[:k], self.poses[k + 1:]])
        self.ctr = torch.cat([self.ctr[:k * M], self.ctr[(k + 1) * M:]])
        self.depth = torch.cat([self.depth[:k * M], self.depth[(k + 1) * M:]])
        self.loose = torch.cat([self.loose[:k * M], self.loose[(k + 1) * M:]])

    def keep(self, keep):
        self.net, self.target, self.weight, self.delta = (
            self.net[keep], self.target[keep], self.weight[keep],
            self.delta[keep])
