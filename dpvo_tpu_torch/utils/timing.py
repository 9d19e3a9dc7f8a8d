"""Timing and tracing: a section timer, a call benchmark, a profiler trace,
and the engine's tracing (host spans and device stamps).

Counterpart of ``dpvo_tpu/utils/timing.py``.  On the card the timer and
the benchmark wait for the current stream around a host clock, so the
time covers the queued kernels and not only their launch; on the CPU
there is nothing to fence.  The fence is the stream's, not the device's:
a device-wide ``torch.cuda.synchronize`` while the engine's capture
worker holds a CUDA graph capture open (``DPVO``'s cold-bucket guard) is
refused by CUDA and fails that capture.

The engine's tracing (``Tracer``, one per ``DPVO``) is on for a call of
the engine when the operator switch ``DPVO.enable_timing`` is set or a
``torch.profiler`` is recording.  It keeps two kinds of record in rings
held by this module, so a reader finds them after the engine is freed:

- ``SPANS``: host spans (``Span``), each with its name, start and end on
  ``time.perf_counter()``, its parent span, the frame it belongs to (the
  engine's frame counter at the call's entry), the thread and the engine.
  While a profiler records, each span is also a ``record_function``
  named ``dpvo.<name>``, on the profiler's timeline beside the kernels.
- ``REPLAYS``: one record (``Replay``) per program run in a traced call,
  with the card's own ``%globaltimer`` stamps (``csrc/stamp.cu``): ``pre``,
  launched eagerly just before the graph's replay, then the stamps
  captured into the graph (``head``, the update's ``corr``, ``net`` and
  ``ba``, ``tail``).  The stamps land in a device ring, one row per
  replay (``RING_ROWS`` rows); the rows of a call are copied to pinned
  host memory behind an event when the call ends and read once the event
  is done (``poll``), or by ``drain``.  Nothing waits on the card.

Off, a call records nothing, enters no ``record_function``, launches no
eager stamp and takes no fence; the stamps inside the graphs still run
(they are captured before any profiler starts) and write to the ring's
discard row.  ``frames`` reduces the replays to per-frame device
milliseconds: each program head to tail, the update's segments, launch
waits (head - pre) and the engine's idle between a call's programs
(pre - the previous program's tail).
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import os
import tempfile
import threading
import time
from contextlib import ContextDecorator

import torch
from torch.autograd import profiler as _profiler

SPAN_CAP = 1 << 17     # host spans kept, newest first out last
REPLAY_CAP = 1 << 16   # program replays kept
RING_ROWS = 256        # device stamp rows: replays the host may run ahead

# the JAX engine's phase timers: ``DPVO.timing_report``'s names
PHASES = ("append_factors", "keyframe", "keyframe/apply", "keyframe/launch",
          "keyframe/result", "keyframe/retire", "track_frame", "update/meta",
          "update/step")
PROGRAMS = ("track_frame_u8", "update_step_dev", "keyframe_merge")
BOUNDARIES = ("pre", "head", "corr", "net", "ba", "tail")
STAMPED = {"track_frame_u8": ("pre", "head", "tail"),
           "update_step_dev": BOUNDARIES,
           "keyframe_merge": ("pre", "head", "tail")}

Span = collections.namedtuple(
    "Span", "id name t0 t1 parent frame thread engine")
# stamps: {boundary: device ns, None where the row was overwritten}
Replay = collections.namedtuple(
    "Replay", "engine frame t_call program span device stamps")

SPANS: collections.deque = collections.deque(maxlen=SPAN_CAP)
REPLAYS: collections.deque = collections.deque(maxlen=REPLAY_CAP)
_PENDING: collections.deque = collections.deque()  # copies not yet read
_ids = itertools.count(1)
_engines = itertools.count(1)
_local = threading.local()     # .on: this thread's programs stamp


def _fence():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.current_stream().synchronize()


class Timer(ContextDecorator):
    """Wall-clock section timer that fences outstanding device work and
    prints ``name ms``."""

    def __init__(self, name, enabled=True):
        self.name = name
        self.enabled = enabled

    def __enter__(self):
        if self.enabled:
            _fence()
            self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.enabled:
            _fence()
            elapsed = (time.perf_counter() - self.start) * 1000.0
            print(f"{self.name} {elapsed:.03f}")
        return False


def benchmark(fn, *args, warmup=3, iters=10):
    """Median milliseconds of ``fn(*args)`` over ``iters`` fenced calls,
    after ``warmup`` calls."""
    for _ in range(warmup):
        fn(*args)
    _fence()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _fence()
        times.append((time.perf_counter() - t0) * 1000.0)
    times.sort()
    return times[len(times) // 2]


class profile_trace:
    """``torch.profiler`` over the block (host, and the card's kernels where
    there is one), written on leaving as a Chrome trace,
    ``logdir/trace.json`` (view it in Perfetto or ``chrome://tracing``).
    The default ``logdir`` is ``dpvo_tpu_torch_trace`` in the temporary
    directory."""

    def __init__(self, logdir=None):
        self.logdir = logdir or os.path.join(tempfile.gettempdir(),
                                             "dpvo_tpu_torch_trace")
        self.path = os.path.join(self.logdir, "trace.json")

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        os.makedirs(self.logdir, exist_ok=True)
        self.prof.export_chrome_trace(self.path)
        return False


# --- device stamps: the kernels and their CPU twins -------------------------

def _ring_rows(ring, cur):
    if (ring.dtype != torch.int64 or ring.dim() != 3 or ring.shape[2] != 2
            or not ring.is_contiguous() or cur.dtype != torch.int64
            or cur.numel() != 1 or cur.device != ring.device):
        raise ValueError("a stamp ring is (rows + 1, cols, 2) int64 with a "
                         "one-element int64 slot cell on its device")
    return ring.shape[0] - 1, ring.shape[1]


def _write(ring, slot, col, t):
    rows = ring.shape[0] - 1
    row = rows if slot < 0 else slot % rows
    ring[row, col, 0] = t
    ring[row, col, 1] = slot


def stamp_set_ref(ring, cur, slot, col=-1):
    """The plain version of ``stamp_set``, the host clock for the card's."""
    cur[0] = slot
    if col >= 0:
        _write(ring, slot, col, time.perf_counter_ns())


def stamp_graph_ref(ring, cur, col):
    """The plain version of ``stamp_graph``."""
    _write(ring, int(cur[0]), col, time.perf_counter_ns())


def stamp_set(ring, cur, slot, col=-1):
    """``cur = slot``, and with ``col`` >= 0 the clock into ``slot``'s cell
    ``col`` (``csrc/stamp.cu``; launched eagerly).  ``slot`` -1 parks: the
    graphs' stamps then go to the discard row."""
    rows, cols = _ring_rows(ring, cur)
    if ring.device.type != "cuda":
        return stamp_set_ref(ring, cur, slot, col)
    from ..ops import _cuda
    _cuda.check(_cuda.lib().dpvo_stamp_set(
        ring.data_ptr(), cur.data_ptr(), slot, col, rows, cols,
        _cuda.stream_ptr(ring.device)), "stamp_set")
    _cuda.count("stamp_set")


def stamp_graph(ring, cur, col):
    """The clock into cell ``col`` of the slot ``cur`` holds when the kernel
    runs (``csrc/stamp.cu``; captured into a program's graph)."""
    rows, cols = _ring_rows(ring, cur)
    if ring.device.type != "cuda":
        return stamp_graph_ref(ring, cur, col)
    from ..ops import _cuda
    _cuda.check(_cuda.lib().dpvo_stamp_graph(
        ring.data_ptr(), cur.data_ptr(), col, rows, cols,
        _cuda.stream_ptr(ring.device)), "stamp_graph")
    _cuda.count("stamp_graph")


# --- host spans and the engine's tracer --------------------------------------

class _Open:
    """A span being recorded; ``end()`` records it."""
    __slots__ = ("stack", "id", "name", "t0", "parent", "frame", "thread",
                 "engine", "rf")

    def end(self):
        t1 = time.perf_counter()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        if self.stack is not None and self in self.stack:
            del self.stack[self.stack.index(self):]
        SPANS.append(Span(self.id, self.name, self.t0, t1, self.parent,
                          self.frame, self.thread, self.engine))


class Tracer:
    """One engine's tracing: its spans, and its device stamp ring
    (``RING_ROWS`` rows and a discard row, one column per boundary, each
    cell (ns, slot)) with the slot cell the graphs' stamps read.  The
    engine opens a frame with ``begin_call`` when tracing is on and ends it
    with ``end_call``; between them ``begin`` opens spans on the engine's
    thread and ``replay`` opens a program run's span and stamps ``pre``."""

    def __init__(self, device):
        self.engine = next(_engines)
        self.device = device
        self.ring = torch.zeros((RING_ROWS + 1, len(BOUNDARIES), 2),
                                dtype=torch.int64, device=device)
        self.cur = torch.full((1,), -1, dtype=torch.int64, device=device)
        self.host = None          # pinned mirror of the ring
        self.slot = 0             # the next replay's slot
        self.stack: list = []     # open spans of the engine's thread
        self.frame = None
        self.profiled = False
        self.call = None
        self.runs: list = []      # this call's (slot, program, span id)

    def begin(self, name, ask=None):
        """Open span ``name`` under the innermost open span of the engine's
        thread, or, from another thread, under the span of ``ask``
        (``Tracer.ask()``'s, taken on the engine's thread)."""
        sp = _Open()
        sp.id, sp.name, sp.engine = next(_ids), name, self.engine
        sp.thread = threading.get_ident()
        if ask is None:
            sp.stack, sp.frame, profiled = self.stack, self.frame, \
                self.profiled
            sp.parent = self.stack[-1].id if self.stack else None
        else:
            sp.stack = None
            sp.parent, sp.frame, profiled = ask
        sp.rf = None
        if profiled and _profiler._is_profiler_enabled:
            # record_function's C++ path: ~1.5 us a span where the Python
            # context manager takes ~13 us under a recording profiler
            sp.rf = torch._C._profiler._RecordFunctionFast("dpvo." + name)
            sp.rf.__enter__()
        sp.t0 = time.perf_counter()
        if ask is None:
            self.stack.append(sp)
        return sp

    def begin_call(self, frame):
        """Open the call of ``frame``.  -> self."""
        self.frame = frame
        self.profiled = _profiler._is_profiler_enabled
        self.stack.clear()
        self.runs = []
        self.call = self.begin("call")
        return self

    def end_call(self):
        """Close the call, start the copy of its stamp rows to the host and
        park the slot cell."""
        self.call.end()
        if self.runs:
            self._copy_rows()
            stamp_set(self.ring, self.cur, -1)
        poll()
        self.frame = None

    def ask(self):
        """(innermost open span id, frame, profiled) for work another
        thread does on this call's behalf."""
        return (self.stack[-1].id if self.stack else None, self.frame,
                self.profiled)

    def replay(self, program):
        """Open ``program``'s run: its span, a new slot and the eager
        ``pre`` stamp.  -> the span."""
        sp = self.begin(program)
        slot = self.slot
        self.slot += 1
        self.runs.append((slot, program, sp.id))
        stamp_set(self.ring, self.cur, slot, BOUNDARIES.index("pre"))
        return sp

    @contextlib.contextmanager
    def stamped(self):
        """Around a program being captured, or run eagerly in a traced
        call: its ``head`` and ``tail`` stamps, and on this thread the
        program's own inside (``stamper``)."""
        outer = getattr(_local, "on", False)
        _local.on = True
        try:
            self.stamp("head")
            yield
            self.stamp("tail")
        finally:
            _local.on = outer

    def stamper(self):
        """The stamp function of a program inside ``stamped``, else
        None."""
        return self.stamp if getattr(_local, "on", False) else None

    def stamp(self, boundary):
        stamp_graph(self.ring, self.cur, BOUNDARIES.index(boundary))

    def _copy_rows(self):
        """Queue this call's stamp rows for reading: on the card a copy to
        the pinned mirror behind an event (a mirror row still pending from
        ``RING_ROWS`` slots back is read first), on the CPU the ring
        itself, read at once."""
        first, last = self.runs[0][0], self.runs[-1][0]
        entry = dict(engine=self.engine, frame=self.frame,
                     t_call=self.call.t0, runs=self.runs,
                     device=self.device.type, rows=self.ring, event=None)
        if self.device.type == "cuda":
            for old in _PENDING:
                if (old["engine"] == self.engine
                        and old["runs"][0][0] <= last - RING_ROWS):
                    old["event"].synchronize()
            poll()
            if self.host is None:
                self.host = torch.zeros(self.ring.shape, dtype=torch.int64,
                                        pin_memory=True)
            a, b = first % RING_ROWS, last % RING_ROWS
            for lo, hi in ([(a, b + 1)] if a <= b
                           else [(a, RING_ROWS), (0, b + 1)]):
                self.host[lo:hi].copy_(self.ring[lo:hi], non_blocking=True)
            entry["rows"], entry["event"] = self.host, torch.cuda.Event()
            entry["event"].record()
        _PENDING.append(entry)


def _read(entry):
    rows = entry["rows"]
    for slot, program, span in entry["runs"]:
        row = rows[slot % RING_ROWS]
        stamps = {}
        for b in STAMPED[program]:
            t, tag = row[BOUNDARIES.index(b)].tolist()
            stamps[b] = t if tag == slot else None
        REPLAYS.append(Replay(entry["engine"], entry["frame"],
                              entry["t_call"], program, span,
                              entry["device"], stamps))


def poll():
    """Read every pending row copy that has landed."""
    for entry in [e for e in _PENDING
                  if e["event"] is None or e["event"].query()]:
        _PENDING.remove(entry)
        _read(entry)


def drain():
    """Read every pending row copy, waiting for each (after the caller's
    own synchronise there is nothing left to wait for)."""
    while _PENDING:
        entry = _PENDING.popleft()
        if entry["event"] is not None:
            entry["event"].synchronize()
        _read(entry)


def clear():
    """Forget every record and pending copy."""
    drain()
    SPANS.clear()
    REPLAYS.clear()


# --- readers -----------------------------------------------------------------

def frames(t0=float("-inf"), t1=float("inf"), device="cuda", engine=None):
    """Per-frame device milliseconds of the traced calls that started in
    [t0, t1] (host clock) on ``device`` (and ``engine``), in call order:
    dicts with each program's head-to-tail sum (``track_frame_u8``,
    ``update_step_dev``, ``keyframe_merge``), the updates' ``corr`` (head to
    after the correlation), ``net`` (the update operator), ``ba`` (local BA
    and its copy-back) and ``rest``, ``launch`` (each replay's head - pre),
    ``idle`` (each replay after the call's first: pre - the previous tail),
    ``replays`` and ``lost`` (replays with a stamp overwritten, left out of
    the sums)."""
    drain()
    calls: dict = {}
    for r in REPLAYS:
        if r.device == device and t0 <= r.t_call <= t1 and (
                engine is None or r.engine == engine):
            calls.setdefault((r.engine, r.frame, r.t_call), []).append(r)
    out = []
    for runs in calls.values():
        f = dict.fromkeys(PROGRAMS + ("corr", "net", "ba", "rest", "launch",
                                      "idle"), 0.0)
        f.update(replays=len(runs), lost=0)
        tail = None
        for r in runs:
            s = r.stamps
            if None in s.values():
                f["lost"] += 1
                tail = None
                continue
            f[r.program] += (s["tail"] - s["head"]) * 1e-6
            f["launch"] += (s["head"] - s["pre"]) * 1e-6
            if tail is not None:
                f["idle"] += (s["pre"] - tail) * 1e-6
            if r.program == "update_step_dev":
                for a, b in (("head", "corr"), ("corr", "net"),
                             ("net", "ba"), ("ba", "tail")):
                    f["rest" if b == "tail" else b] += (s[b] - s[a]) * 1e-6
            tail = s["tail"]
        out.append(f)
    return out


def stretch_mean(t0, t1, key):
    """The mean over the frames of ``frames(t0, t1)`` with no stamp lost of
    their ``key``, or None without such a frame (nothing traced on the
    card)."""
    whole = [f[key] for f in frames(t0, t1) if f["lost"] == 0]
    return sum(whole) / len(whole) if whole else None


def report(engine, clock="host"):
    """{phase: (mean ms, count)} of ``engine``'s phases (``PHASES``):
    ``clock`` "host", the spans' own times; "device", the device time of
    the programs each phase instance ran (head to tail of the replays
    under it), over the instances that ran one."""
    spans = [s for s in SPANS if s.engine == engine]
    per: dict = {}
    if clock == "host":
        for s in spans:
            if s.name in PHASES:
                per.setdefault(s.name, []).append((s.t1 - s.t0) * 1e3)
    elif clock == "device":
        drain()
        parent = {s.id: s.parent for s in spans}
        name = {s.id: s.name for s in spans}
        sums: dict = {}
        for r in REPLAYS:
            if r.engine != engine or None in r.stamps.values():
                continue
            p = parent.get(r.span)
            while p is not None:
                if name.get(p) in PHASES:
                    sums[p] = sums.get(p, 0.0) + (
                        r.stamps["tail"] - r.stamps["head"]) * 1e-6
                p = parent.get(p)
        for p, ms in sums.items():
            per.setdefault(name[p], []).append(ms)
    else:
        raise ValueError(f"clock {clock!r}: 'host' or 'device'")
    return {k: (sum(v) / len(v), len(v)) for k, v in sorted(per.items())}
