"""K3's and K4's share of their roofline (``ops/agg_cuda``: the soft
aggregations' grouped softmax sums, two a update, and local BA's coupling
sums, one a Gauss-Newton iteration): the least time of the traced
stretch's updates over the device time of the kernels named
``segment_sums*`` (``torch.profiler``).  Least times are counted at the
live edges of the check group's updates (``perfbench/work``), one update a
K2 launch."""
LAYER = "kernels"
UNIT = "%"
MOVES = "fps"


def read(ctx):
    from perfbench.harness.trace import kernel_time
    red, w, steps = ctx["trace"], ctx["work"], ctx["steps"]
    if red is None or not steps:
        return None
    updates, _ = kernel_time(red, "corr_enc")
    n, seconds = kernel_time(red, "segment_sums")
    if updates == 0 or n == 0 or seconds <= 0:
        return None
    least = sum(w.agg_least_s(s["edges"], s["patches"], s["pairs"],
                              s["free"], s["patches"])
                for s in steps) / len(steps)
    return 100.0 * updates * least / seconds
