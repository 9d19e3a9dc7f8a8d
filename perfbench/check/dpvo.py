"""DPVO's visual odometry check: the comparison ``harness/checks.py``
describes (the start, the window's group step by step from the program's
state, local BA alone, the bookkeeping at the close), with its control.

It follows no loop closure: its steps and its local BA read the active
edges only, so a configuration with ``LOOP_CLOSURE`` names a check of its
own.
"""
from __future__ import annotations

from perfbench.harness import checks
from perfbench.harness.cell import log

NUMBERS = ("structure", "start_track", "start_update", "start_ba",
           "step_track", "step_update", "step_ba")
REFUSES = {"LOOP_CLOSURE": True}


def compare(run):
    """``run``: what the harness collected (``harness/cell.py``).  -> (the
    compared numbers, the control's or None, the work of each of the
    group's updates, the edges of every update by frame)."""
    control = run["control"]
    ck = checks.Checker(run)
    s0 = ck.start(run["start"]["probe"], run["start"]["after"], control)
    s1 = ck.steps(run["copies"], run["c0"], run["end"], run["last"], control)
    for g in [s0[1]] + [g for g in s1[1] if g is not None]:
        log("[check-detail] " + " ".join(
            f"{w}:" + ",".join(f"{k}={v:.3g}" for k, v in (g[w] or {}).items())
            for w in g))
    ba = ck.ba_alone(run["pairs"], control)
    for g in ba:
        log("[check-detail] ba alone: " + ", ".join(
            f"{k}={v:.3g}" for k, v in g.items()))
    nums = checks.numbers(s0, s1, ba)
    ctl = checks.numbers(s0, s1, ba, "fp8") if control else None
    return nums, ctl, s1[2], s1[3].update_edges
