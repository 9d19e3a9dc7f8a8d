"""Host milliseconds of ``DPVO.__call__`` per frame in the offline cells:
the benchmark's host-clock span around each call, without fences, as a
mean over the window's frames outside the traced stretch.  With the device
setting the pace the call also waits wherever the engine waits on it."""
LAYER = "host engine"
UNIT = "ms"
MOVES = "fps"


def read(ctx):
    if ctx["loop"] != "offline":
        return None
    s = [d for i, d in ctx["spans"] if not ctx["in_stretch"](i)]
    return 1e3 * sum(s) / len(s) if s else None
