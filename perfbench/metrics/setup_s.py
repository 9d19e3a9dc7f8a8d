"""Seconds from the process's start to the first timed frame: imports,
CUDA, weights, the engine, its programs' capture, the warm frames, and in
a checkout's first run the kernels' build."""


def read(ctx):
    return ctx["setup_s"]
