"""Device milliseconds a frame of the update program (``update_step_dev``,
its CUDA graph), from the stamp at the graph's head to the one at its tail.
The stamps are the card's own ``%globaltimer``, written by
``dpvo_tpu_torch.utils.timing``'s stamp kernels; the mean is over the frames
whose call starts in the traced stretch (``ctx["stretch"]``, host clock)
with no stamp lost.  Taken under the profiler, so it includes the profiler's
overhead.  Where the host trails the card, a graph whose launch is still
streaming in stalls the card between its nodes, and head to tail includes
those stalls (launch_idle_ms counts only the first node's wait), so this
reading moves with the host's speed as well.  A program without the stamps,
or a run with nothing traced on the card, reads nothing."""
import sys

LAYER = "device programs"
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
    fr = timing.frames(tr["t0"], tr["t1"])
    print(f"[trace] engine stamps in the stretch: {len(fr)} frames, "
          f"{sum(f['replays'] for f in fr)} program runs, "
          f"{sum(f['lost'] for f in fr)} with a stamp lost", file=sys.stderr)
    return stretch_mean(tr["t0"], tr["t1"], "update_step_dev")
