"""The whole frame's share of the card's bf16 peak: model FLOPs per frame
(both encoders at the frame size, and the update operator over the live
edges of each update the frame ran; ``perfbench/work``), summed over the
window's frames outside the traced stretch, over their wall time.  BA and
the elementwise work are not counted."""
LAYER = "device"
UNIT = "%"
MOVES = "fps"


def read(ctx):
    w, tr = ctx["work"], ctx["stretch"]
    steps = ctx["steps"]
    if not steps:
        return None
    groups = sum(s["patches"] + s["pairs"] for s in steps) / sum(
        s["edges"] for s in steps)
    flops = 0.0
    for i in range(ctx["frames"]):
        if ctx["in_stretch"](i):
            continue
        flops += w.tracking_flops(ctx["ht"], ctx["wd"])
        for e in ctx["updates"].get(ctx["first"] + i, []):
            flops += w.update_flops(e, e * groups)
    seconds = ctx["window_s"] - (tr["t1"] - tr["t0"] if "t1" in tr else 0.0)
    return 100.0 * flops / seconds / w.PEAKS["flops_per_s"]["bf16"]
