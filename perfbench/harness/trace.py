"""The traced stretch: ``torch.profiler`` over a few steady frames of the
window, reduced in memory (no trace file is written).

``reduce`` gives the device's busy time (the union of the CUDA kernels'
intervals), each kernel name's launches and device seconds, the kernels
with the most device time, and the idle gaps between kernels by what the
host was doing meanwhile: the benchmark's own span (``perfbench.*``, its
``record_function`` labels) and the innermost host operation inside it.
"""
from __future__ import annotations

import bisect

SPAN = "perfbench."


def profiler():
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


def span(name):
    """A host span the gaps are named by."""
    import torch
    return torch.profiler.record_function(SPAN + name)


def _host_label(cpu, starts, t):
    """The benchmark span and innermost host op running at time ``t``."""
    i = bisect.bisect_right(starts, t)
    ours, inner = None, None
    for s, e, name in reversed(cpu[max(0, i - 400):i]):
        if s <= t <= e:
            if name.startswith(SPAN):
                ours = ours or (e - s, name[len(SPAN):])
            elif inner is None or e - s < inner[0]:
                inner = (e - s, name)
    label = ours[1] if ours else "outside the frame loop"
    return label + ("/" + inner[1] if inner else "")


def reduce(prof, top=10):
    """-> dict ``busy_s``, ``kernels`` {name: [launches, seconds]},
    ``device_ops`` and ``idle_gaps`` ([[name, seconds]], the ``top``
    largest), or None when the profiler saw no kernel."""
    from torch.autograd import DeviceType
    events = prof.events()
    kern = sorted(((e.time_range.start, e.time_range.end, e.name)
                   for e in events if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and not e.name.startswith(SPAN)))
    if not kern:
        return None
    cpu = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in events if e.device_type == DeviceType.CPU)
    starts = [c[0] for c in cpu]
    busy, end, kernels, gaps = 0.0, None, {}, {}
    for s, t, name in kern:
        if end is not None and s > end:
            label = _host_label(cpu, starts, 0.5 * (s + end))
            gaps[label] = gaps.get(label, 0.0) + (s - end) * 1e-6
        busy += max(0.0, t - max(s, end if end is not None else s))
        end = t if end is None else max(end, t)
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += (t - s) * 1e-6
    by_time = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:top]
    return dict(busy_s=busy * 1e-6, kernels=kernels,
                device_ops=[[n[:120], v[1]] for n, v in by_time],
                idle_gaps=[[n[:120], v] for n, v in
                           sorted(gaps.items(), key=lambda kv: -kv[1])[:top]])


def kernel_time(red, needle):
    """(launches, device seconds) of the kernels whose name holds
    ``needle``."""
    hits = [v for n, v in red["kernels"].items() if needle in n]
    return sum(v[0] for v in hits), sum(v[1] for v in hits)
