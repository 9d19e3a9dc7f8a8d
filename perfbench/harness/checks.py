"""The comparison that decides ``correct``.

The reference (``perfbench/reference``) cannot replay a whole window in
less time than the window took, so it follows the program step by step
from the program's own state:

- ``structure``: the keyframe and edge bookkeeping of every frame of the
  run, worked out from frame 0 by the reference, against the program's at
  each copy and at the window's close (keyframe timestamps and the live
  edge set; an exact count of the copies that differ);
- the start: the first eight frames and the first of the updates at
  initialisation, worked out by the reference from the frames alone (the
  program's random centroids and first depths taken as drawn), against the
  program's state after them: ``start_track`` (every frame's features in
  the rings), ``start_update`` (hidden state, targets, weights) and
  ``start_ba`` (the change of every pose and depth).  The eleven updates
  after it compound the rounding of each into a spread from seed to seed
  that no limit separates from the control's; they are the update the
  window's steps check;
- the window: for each frame of a group that begins at a share of the
  window drawn from the seed, the reference's step from the program's
  state before the frame against the program's state after it:
  ``step_track`` (the new frame's features) and ``step_update``; and
  ``step_ba``, local BA alone: the reference's BA from the program's own
  inputs to it (the poses and depths before the update, the targets and
  weights it made) against the program's poses and depths after it.

A gap is a relative L2 distance, ``|program - reference| / |reference|``,
against the fp32 reference from the same state.  ``*_track`` is the worst
gap of the features (both feature maps, the patches' features, the
context).  ``*_update`` is the worst gap of the hidden state, the weights
and the targets (over the reference's flow update), summed over the
stage's steps and divided by the same sum for the reference rounded to
bf16 in the same states (``prec="bf16"``); ``start_ba`` the poses' and the
depths' changes over the step, the two gaps summed and divided alike: how
far rounding carries through the update operator and BA varies with the
state by more than the control's margin, the features' gap does not, and
one part's ratio of two small gaps swings more than both parts'.
``step_ba`` takes the poses' and the depths' changes against the
reference's BA in float64, each gap over the same gap of the reference's
own BA in float32, and the worst of these over the group: BA's change is
known to float32 only as far as the state's conditioning carries the
rounding of the absolute poses it reads, 1e-5 to 0.1 and more of the change
by state, which the float32 reference's gap reads too.  The control puts
the reference in the program's place, computed in fp8 (``prec="fp8"``),
and for ``step_ba`` its BA in bfloat16.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from ..reference import ba, lie
from ..reference.ba import NEAR_RESET
from ..reference.engine import INIT_FRAMES, Numeric, Structure
from . import state

# the smallest float32 gap ``step_ba`` divides by: a sum over thousands of
# edges in float32 is known to about this share, however well conditioned
F32_FLOOR = 1e-6


def rel(a, b):
    a, b = a.float(), b.float()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b).clamp(
        min=1e-30))


def _rel64(a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b).clamp(
        min=1e-300))


def compare(prog, ref, base_pose, base_depth):
    """Gaps of the program's view against the reference's after the same
    step(s): -> {"track", "update", "pose", "depth", "banded"}, or None
    when their structure differs.  ``base_pose``/``base_depth`` map a
    timestamp to its pose and depths before the step."""
    if (len(prog["tstamps"]) != len(ref["tstamps"])
            or (prog["tstamps"] != ref["tstamps"]).any()
            or len(prog["keys"]) != len(ref["keys"])
            or (prog["keys"] != ref["keys"]).any()):
        return None
    track = max((rel(prog["features"][t][k], f[k])
                 for t, f in ref["features"].items() for k in f), default=0.0)
    update = max(rel(prog["net"], ref["net"]),
                 float(torch.linalg.norm(prog["target"] - ref["target"])
                       / torch.linalg.norm(ref["delta"]).clamp(min=1e-30)),
                 rel(prog["weight"], ref["weight"]))
    ts = [int(t) for t in ref["tstamps"]]
    P0 = torch.stack([base_pose[t] for t in ts])
    d0 = torch.cat([base_depth[t] for t in ts])
    xi_p = lie.log(lie.mul(prog["poses"], lie.inv(P0)))
    xi_r = lie.log(lie.mul(ref["poses"], lie.inv(P0)))
    # BA resets a depth past 20 to 1: rounding decides which side of it a
    # patch near it lands, so patches the reference finds near it before the
    # step or at any of its BA's iterations are left out of the depths' gap;
    # and so are the patches its edges all but leave free, whose step the
    # damping alone bounds, so rounding sets its size (both ``loose``)
    keep = (d0 < NEAR_RESET) & ~ref["loose"]
    pose = rel(xi_p, xi_r)
    depth = rel(prog["depth"][keep] - d0[keep], ref["depth"][keep] - d0[keep])
    return dict(track=track, update=update, pose=pose, depth=depth,
                left_out=int((~keep).sum()), loose=int(ref["loose"].sum()))


def _bases(view, M):
    """Poses and depths by timestamp of a view."""
    return ({int(t): view["poses"][s] for s, t in enumerate(view["tstamps"])},
            {int(t): view["depth"][s * M:(s + 1) * M]
             for s, t in enumerate(view["tstamps"])})


def _centroids(views, M):
    out = {}
    for v in views:
        for s, t in enumerate(v["tstamps"]):
            out[int(t)] = v["ctr"][s * M:(s + 1) * M]
    return out


def window_pixels(coords, jj, dims):
    """Distinct feature-map pixels the correlation's 8x8 taps read, per
    level: coords (E, P, P, 2), jj (E,) target slots, dims [(h, w)] per
    level -> [count]."""
    out = []
    t = torch.arange(8, device=coords.device) - 3
    slots = int(jj.max()) + 1
    for lvl, (h, w) in enumerate(dims):
        b = torch.floor(coords / 4 ** lvl).long()
        y = b[..., 1].reshape(-1, 1, 1) + t[:, None]
        x = b[..., 0].reshape(-1, 1, 1) + t[None, :]
        f = jj.reshape(-1, 1).expand(-1, coords.shape[1] * coords.shape[2])
        f = f.reshape(-1, 1, 1).expand(y.shape[0], 8, 8)
        y, x = y.expand(-1, 8, 8), x.expand(-1, 8, 8)
        ok = (x >= 0) & (x < w) & (y >= 0) & (y < h)
        mark = torch.zeros(slots * h * w, dtype=torch.bool,
                           device=coords.device)
        mark[((f * h + y) * w + x)[ok]] = True
        out.append(int(mark.sum()))
    return out


class Checker:
    """The reference's side of one run.  ``ctx``: ``cfg`` (the engine
    configuration as a dict), ``weights``, ``frames`` (``inputs.Frames``),
    ``device``, ``intr`` (4,) at feature resolution, ``M``."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.features = {"fp32": {}, "bf16": {}, "fp8": {}}

    def numeric(self, start, centroids, prec, draws=None):
        c = self.ctx
        return Numeric(c["weights"], start, centroids,
                       lambda t: c["frames"].device(t, c["device"]),
                       c["intr"], c["M"], c["cfg"]["MOTION_DAMPING"], prec,
                       draws=draws, features=self.features[prec])

    def empty(self):
        dev = self.ctx["device"]
        z = lambda *s: torch.zeros(s, device=dev)          # noqa: E731
        return dict(poses=z(0, 7), ctr=z(0, 2), depth=z(0), net=z(0, 384),
                    target=z(0, 2), weight=z(0, 2))

    def _precs(self, control):
        return ("fp32", "bf16", "fp8") if control else ("fp32", "bf16")

    def _gaps(self, prog, runs, bases):
        """The program's gaps and, as the scale, the bf16 reference's (and
        the fp8 control's) against the fp32 reference."""
        ref = state.reference_view(*runs["fp32"])
        out = dict(prog=compare(prog, ref, *bases))
        for prec in ("bf16", "fp8"):
            if prec in runs:
                out[prec] = compare(state.reference_view(*runs[prec]), ref,
                                    *bases)
        return out

    def start(self, probe, after, control=False):
        """The first INIT_FRAMES frames from the frames alone; ``probe``: the
        program's state with the last of them tracked (its draws), ``after``:
        its state after their call.  -> (structure mismatches, gaps)."""
        M = self.ctx["M"]
        pv = state.program_view(probe)
        draws = {int(t): pv["depth"][s * M:(s + 1) * M]
                 for s, t in enumerate(pv["tstamps"])}
        runs = {}
        for prec in self._precs(control):
            st = Structure(self.ctx["cfg"])
            num = self.numeric(self.empty(), _centroids([pv], M), prec, draws)
            for _ in range(INIT_FRAMES):
                st.frame(num, init_updates=1)
            runs[prec] = (st, num)
        st, num = runs["fp32"]
        prog = state.program_view(after)
        prog["features"] = probe["features"]
        return (int(not _same(st, after)),
                self._gaps(prog, runs, (num.base_pose, num.base_depth)))

    def steps(self, copies, c0, end, last, control=False):
        """The window's group: ``copies`` the program's states before frame
        c0 and after each of the frames c0, c0+1, ...; the bookkeeping then
        goes on to frame ``end``, where the program's state was ``last``.
        -> (structure mismatches, [gaps], [work of each update], the
        bookkeeping)."""
        M = self.ctx["M"]
        st = Structure(self.ctx["cfg"])
        while st.counter < c0:
            st.frame()
        bad, gaps, work = 0, [], []
        views = [state.program_view(s) for s in copies]
        for i, pre in enumerate(copies[:-1]):
            if not _same(st, pre):
                bad += 1
                gaps.append(None)
                st.frame()
                continue
            cents = _centroids(views[i:i + 2], M)
            bp, bd = _bases(views[i], M)
            runs = {}
            for prec in self._precs(control):
                s2 = copy.deepcopy(st)
                num = self.numeric(state.numeric_state(pre, s2), cents, prec)
                s2.frame(num)
                runs[prec] = (s2, num)
            num = runs["fp32"][1]
            work.append(self.work(num))
            bp.update(num.base_pose)
            bd.update(num.base_depth)
            gaps.append(self._gaps(views[i + 1], runs, (bp, bd)))
            st.frame()
        # a window too short to reach the group compares nothing: inf
        bad += int(not copies or not _same(st, copies[-1]))
        gaps += [None] * (len(copies) < 2)
        while st.counter < end:
            st.frame()
        bad += int(not _same(st, last))
        return bad, gaps, work, st

    def ba_alone(self, pairs, control=False):
        """Local BA alone, from the program's inputs to each update's BA:
        ``pairs`` of the program's states before an update and after it
        (with the targets and weights BA read).  -> [{"pose", "depth",
        "f32_pose", "f32_depth"}]: the gaps of the program's pose and depth
        changes against the reference's in float64, and those of the
        reference's own float32 BA (the root mean square over the edges in
        three orders): how far float32 rounding carries in this state; with
        ``control``, ``ctl_pose`` and ``ctl_depth``: the gaps of the
        reference computed in bfloat16 in the program's place."""
        out = []
        for i, (pre, post) in enumerate(pairs):
            poses, depth, loose = self._ba(pre, post, torch.float64)
            P0 = pre["poses"].double()
            d0 = pre["patches"][:, 2].double()
            keep = (d0 < NEAR_RESET) & ~loose
            inv = lie.inv(P0)
            xi, dd = lie.log(lie.mul(poses, inv)), depth[keep] - d0[keep]

            def gaps(P, d):
                return (_rel64(lie.log(lie.mul(P.double(), inv)), xi),
                        _rel64(d.double()[keep] - d0[keep], dd))
            g = dict(zip(("pose", "depth"), gaps(
                post["poses"], post["patches"][:, 2])))
            E = len(post["ii"])
            gen = torch.Generator().manual_seed(i)
            perm = torch.randperm(E, generator=gen)
            f32 = [gaps(*self._ba(pre, post, torch.float32, o)[:2])
                   for o in (None, torch.arange(E - 1, -1, -1), perm)]
            g["f32_pose"], g["f32_depth"] = (
                (sum(x[k] ** 2 for x in f32) / 3) ** 0.5 for k in (0, 1))
            if control:
                g["ctl_pose"], g["ctl_depth"] = gaps(
                    *self._ba(pre, post, torch.bfloat16)[:2])
            out.append(g)
        return out

    def _ba(self, pre, post, dtype, order=None):
        n = pre["n"]
        t0 = max(n - self.ctx["cfg"]["OPTIMIZATION_WINDOW"], 1)
        dev = pre["poses"].device
        o = slice(None) if order is None else order.to(dev)
        return ba.local_ba(
            pre["poses"].float(), pre["patches"][:, :2].float(),
            pre["patches"][:, 2].float(), self.ctx["intr"],
            post["target"].float()[o], post["weight"].float()[o],
            *(torch.as_tensor(post[k], device=dev)[o]
              for k in ("ii", "jj", "kk")), t0, n, dtype=dtype)

    def work(self, num):
        """What the step's update read, for the kernels' least times."""
        ii, jj, kk, t0, t1 = num.upd
        h, w = self.ctx["fmap_hw"]
        return dict(edges=int(kk.shape[0]),
                    patches=int(torch.unique(kk).numel()),
                    pairs=int(torch.unique(ii * 12345 + jj).numel()),
                    free=t1 - t0,
                    pixels=window_pixels(num.coords, jj,
                                         [(h, w), (h // 4, w // 4)]))


def _same(st, s):
    """The reference's bookkeeping ``st`` against the program's copy ``s``;
    under loop closure also the inactive store's edges, in order, and the
    loop rounds' and global BA's bookkeeping (``state.take_lc``)."""
    same = (st.n == s["n"] and list(st.tstamps) == s["tstamps"].tolist()
            and np.array_equal(np.sort(state.edge_keys(st.ii, st.jj, st.kk)),
                               np.sort(state.edge_keys(s["ii"], s["jj"],
                                                       s["kk"]))))
    inac = s.get("inac")
    if inac is None:
        return same
    ii, jj, kk = st.inactive()
    return (same and inac["n"] == st.n_inac
            and np.array_equal(inac["ii"], ii)
            and np.array_equal(inac["jj"], jj)
            and np.array_equal(inac["kk"], kk)
            and inac["last_global_ba"] == st.last_global_ba
            and inac["ran"] == (st.n in st.ran_global))


def bookkeeping(run):
    """The reference's bookkeeping alone, from frame 0 with the program's
    loop proposals (``run["proposals"]``), against the program's copies in
    ``run`` (``compare``'s argument): the start's state after its first
    update, each of the group's copies and the copy at the window's close.
    -> (the copies that differ, the ``Structure`` at the close)."""
    cfg, props = run["cfg"], run.get("proposals")
    st = Structure(cfg, props)
    for _ in range(INIT_FRAMES):
        st.frame(init_updates=1)
    bad = int(not _same(st, run["start"]["after"]))
    st = Structure(cfg, props)
    while st.counter < run["c0"]:
        st.frame()
    copies = run["copies"]
    for pre in copies[:-1]:
        bad += int(not _same(st, pre))
        st.frame()
    bad += int(not copies or not _same(st, copies[-1]))
    while st.counter < run["end"]:
        st.frame()
    return bad + int(not _same(st, run["last"])), st


def _ratio(results, who, parts):
    """The sum over ``results`` and ``parts`` of ``who``'s gaps over the same
    sum of the bf16 reference's; inf where a gap could not be taken."""
    if not results or any(r is None or r[who] is None or r["bf16"] is None
                          for r in results):
        return float("inf")
    return (sum(r[who][p] for r in results for p in parts)
            / max(sum(r["bf16"][p] for r in results for p in parts), 1e-30))


def numbers(start, steps, ba_gaps, who="prog"):
    """The compared numbers from ``Checker.start``'s, ``Checker.steps``' and
    ``Checker.ba_alone``'s results; a gap that could not be taken reads
    inf.  ``who="fp8"``: the control's (its BA in bfloat16)."""
    out = dict(structure=start[0] + steps[0])
    for stage, results in (("start", [start[1]]), ("step", steps[1])):
        whole = results and all(r is not None and r[who] is not None
                                for r in results)
        out[f"{stage}_track"] = (max(r[who]["track"] for r in results)
                                 if whole else float("inf"))
        out[f"{stage}_update"] = _ratio(results, who, ("update",))
        if stage == "start":
            out["start_ba"] = _ratio(results, who, ("pose", "depth"))
    p = "" if who == "prog" else "ctl_"
    out["step_ba"] = max((max(g[p + k] / max(g["f32_" + k], F32_FLOOR)
                              for k in ("pose", "depth")) for g in ba_gaps),
                         default=float("inf"))
    return out
