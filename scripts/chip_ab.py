#!/usr/bin/env python3
"""Compare the port's engine time per frame between two checkouts on one GPU.

    python3 scripts/chip_ab.py OTHER_CHECKOUT [--rounds N]

Runs ``chip_smoke.drive_engine`` (480x640, M=96, bf16, the merge and retain
regimes at the default correlation version, 40 frames each) from the other
checkout and from this one, in turns other, this, this, other per round,
each in a fresh process that builds its own kernels, and prints one
``[ab]`` line per run and a summary of the medians per side.  Comparing in
one call on one card keeps the host's run-to-run spread out of the
difference.  Needs one CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

DRIVE = """
import json, torch, chip_smoke as cs
dev = torch.device("cuda:0")
out = {r: cs.drive_engine(dev, r)["median_ms"] for r in ("merge", "retain")}
print("AB " + json.dumps(out), flush=True)
"""


def run(tree: Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", DRIVE], cwd=tree,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise SystemExit(f"drive in {tree} failed:\n{proc.stdout[-2000:]}"
                         f"\n{proc.stderr[-2000:]}")
    line = [x for x in proc.stdout.splitlines() if x.startswith("AB ")][-1]
    return json.loads(line[3:])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 1
    sides = {"other": args.other.resolve(), "this": ROOT}
    got = {"other": [], "this": []}
    for rnd in range(args.rounds):
        for side in ("other", "this", "this", "other"):
            ms = run(sides[side])
            got[side].append(ms)
            print(f"[ab] round {rnd} {side}: " + ", ".join(
                f"{r} {v:.2f} ms/frame" for r, v in ms.items()), flush=True)
    for regime in ("merge", "retain"):
        med = {s: statistics.median(m[regime] for m in got[s]) for s in got}
        print(f"[ab] {regime}: median of run medians other "
              f"{med['other']:.2f}, this {med['this']:.2f} ms/frame "
              f"(runs other {[round(m[regime], 2) for m in got['other']]}, "
              f"this {[round(m[regime], 2) for m in got['this']]})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
