"""Device milliseconds a frame between each program's eager ``pre`` stamp,
launched just before its graph's replay, and the graph's head stamp: the
card waiting for the graph's launch, summed over the frame's programs.  The
stamps are the card's own ``%globaltimer``, written by
``dpvo_tpu_torch.utils.timing``'s stamp kernels; the mean is over the frames
whose call starts in the traced stretch (``ctx["stretch"]``, host clock)
with no stamp lost.  Taken under the profiler, so it includes the profiler's
overhead.  Where the host trails the card, a graph whose launch is still
streaming in also stalls the card between its later nodes: those stalls fall
inside the programs' head to tail, not here, so this undercounts the
launches' cost.  A program without the stamps, or a run with nothing traced
on the card, reads nothing."""
LAYER = "device-program graphs"
UNIT = "ms"
MOVES = "fps"


def read(ctx):
    tr = ctx["stretch"]
    if "t1" not in tr:
        return None
    try:
        from dpvo_tpu_torch.utils import timing
        stretch_mean = timing.stretch_mean
    except (ImportError, AttributeError):
        return None
    return stretch_mean(tr["t0"], tr["t1"], "launch")
