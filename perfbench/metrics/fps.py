"""Frames a second of an offline cell: the frames whose call was made in
the window over the time from its start to the engine's stream drained
after the last one."""


def read(ctx):
    if ctx["loop"] != "offline":
        return None
    return ctx["frames"] / ctx["window_s"]
