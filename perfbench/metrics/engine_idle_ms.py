"""Device milliseconds a frame between a program's tail stamp and the next
program's ``pre`` stamp within one call (the programs after the call's
first): the card waiting on the engine's host work between programs, and the
eager work it queues there.  The stamps are the card's own ``%globaltimer``,
written by ``dpvo_tpu_torch.utils.timing``'s stamp kernels; the mean is over
the frames whose call starts in the traced stretch (``ctx["stretch"]``, host
clock) with no stamp lost.  Taken under the profiler, so it includes the
profiler's overhead.  Where the host trails the card, the programs' own head
to tail also holds launch stalls (launch_idle_ms), so this and that do not
split the host's cost between bookkeeping and launches on such a run.  A
program without the stamps, or a run with nothing traced on the card, reads
nothing."""
LAYER = "host engine"
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
    return stretch_mean(tr["t0"], tr["t1"], "idle")
