"""The card's idle share of the traced stretch: 1 minus the union of the
CUDA kernels' intervals (``torch.profiler``) over the stretch's wall time,
from its first frame's call to the engine's stream drained after its
last."""
LAYER = "device"
UNIT = "%"
MOVES = "fps"


def read(ctx):
    red, tr = ctx["trace"], ctx["stretch"]
    if red is None or "t1" not in tr:
        return None
    return 100.0 * (1.0 - red["busy_s"] / (tr["t1"] - tr["t0"]))
