"""K2's share of its roofline (``ops/corr_cuda``, the correlation fused
with the first layer of the correlation encoder): the least time of the
traced stretch's K2 launches over their device time (``torch.profiler``,
kernels named ``corr_enc``).  A launch's least time is counted at the live
edges of the updates the check's group ran (``perfbench/work``), which
stand for the stretch's."""
LAYER = "kernels"
UNIT = "%"
MOVES = "fps"


def read(ctx):
    from perfbench.harness.trace import kernel_time
    red, w, steps = ctx["trace"], ctx["work"], ctx["steps"]
    if red is None or not steps:
        return None
    n, seconds = kernel_time(red, "corr_enc")
    if n == 0 or seconds <= 0:
        return None
    least = sum(w.corr_least_s(s["edges"], s["patches"],
                               sum(s["pixels"]) * w.C * 2)
                for s in steps) / len(steps)
    return 100.0 * n * least / seconds
