#!/usr/bin/env python3
"""Compare the port's kernel times between two checkouts on one GPU.

    python3 scripts/kernel_ab.py OTHER_CHECKOUT [--rounds N]

Times the kernels of the other checkout and of this one on the same inputs
(this checkout's ``chip_smoke.py`` makes them from fixed seeds, and its
timers measure): K2 ``corr_enc`` and K1 ``corr_fused`` (raw, bf16) at 6144,
14336 and 45312 edges; the five D3 probes (``corr_probe``) on the fitted
inputs at each of those edge counts and on the probe path's scattered
inputs at 6144 (``scripts/dev/corr_variants_torch.py make_inputs``); K4
``segment_sums`` and K3 ``segment_softmax_sums`` as device time from a CUDA
graph of 20 calls and back to back, with ``index_add_`` beside K4.  Runs in
turns other, this, this, other per round, each in a fresh process that
builds its own kernels, prints one ``[ab]`` JSON line per run, then the
median of each time per side.  Comparing in one call on one card keeps the
card's and the host's run-to-run spread out of the difference.  Needs one
CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

TIME = """
import importlib.util, json, sys
from pathlib import Path
sys.path.insert(0, str(Path.cwd()))
import torch
spec = importlib.util.spec_from_file_location("cs", {chip_smoke!r})
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
sys.path.insert(0, {dev_scripts!r})
import corr_variants_torch as cvt
from dpvo_tpu_torch.ops import _cuda, agg_cuda, corr_cuda
dev = torch.device("cuda:0")
_cuda.lib()
out = {{}}
def t(fn, reps=10):
    return cs.time_ms(fn, reps=reps, windows=cs.KERNEL_WINDOWS)
for E, n_frames, n_patches in cs.SHAPES:
    gen = torch.Generator(device=dev)
    gen.manual_seed(E)
    g_all, kk, w_raw, f1, f2, coords, ff = cs.corr_inputs(
        E, n_frames, n_patches, dev, gen)
    g = g_all[kk.long()]
    out[f"k2 {{E}}"] = t(lambda: corr_cuda.corr_enc(
        g_all, kk, w_raw, f1, f2, coords, ff))
    out[f"k1 raw {{E}}"] = t(lambda: corr_cuda.corr_fused(
        g, f1, f2, coords, ff, "raw", torch.bfloat16))
    for p in cs.PROBES:
        out[f"{{p}} fitted {{E}}"] = t(lambda: corr_cuda.corr_probe(
            g, f1, f2, coords, ff, p))
    del g_all, kk, w_raw, f1, f2, coords, ff, g
    vals, _, gid = cs.segment_inputs(E, 98, n_patches, dev, gen)
    G = agg_cuda.padded_groups(4097)
    gid_l = gid.long()
    out[f"k4 graph {{E}}"] = cs.graph_ms(
        lambda: agg_cuda.segment_sums(vals, gid, 4097), 20)
    out[f"k4 back to back {{E}}"] = t(
        lambda: agg_cuda.segment_sums(vals, gid, 4097), 20)
    out[f"index_add_ graph {{E}}"] = cs.graph_ms(lambda: torch.zeros(
        (G, 98), device=dev).index_add_(0, gid_l, vals), 20)
    gate, val, gid = cs.segment_inputs(E, 384, n_patches, dev, gen)
    shift = gate.max(0, keepdim=True).values
    out[f"k3 graph {{E}}"] = cs.graph_ms(
        lambda: agg_cuda.segment_softmax_sums(gate, val, shift, gid, 4104),
        20)
    out[f"k3 back to back {{E}}"] = t(
        lambda: agg_cuda.segment_softmax_sums(gate, val, shift, gid, 4104),
        20)
g, f1, f2, c, ff = cvt.make_inputs(6144)
for p in cs.PROBES:
    out[f"{{p}} scattered 6144"] = t(
        lambda: corr_cuda.corr_probe(g, f1, f2, c, ff, p))
out["k1 raw scattered 6144"] = t(lambda: corr_cuda.corr_fused(
    g, f1, f2, c, ff, "raw", torch.bfloat16))
print("AB " + json.dumps(out), flush=True)
"""


def run(tree: Path) -> dict:
    code = TIME.format(chip_smoke=str(ROOT / "chip_smoke.py"),
                       dev_scripts=str(ROOT / "scripts" / "dev"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tree,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise SystemExit(f"timing in {tree} failed:\n{proc.stdout[-2000:]}"
                         f"\n{proc.stderr[-2000:]}")
    line = [x for x in proc.stdout.splitlines() if x.startswith("AB ")][-1]
    return json.loads(line[3:])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    sides = {"other": args.other.resolve(), "this": ROOT}
    got = {"other": [], "this": []}
    for rnd in range(args.rounds):
        for side in ("other", "this", "this", "other"):
            ms = run(sides[side])
            got[side].append(ms)
            print(f"[ab] round {rnd} {side}: {json.dumps(ms)}", flush=True)
    for key in got["this"][0]:
        med = {s: statistics.median(r[key] for r in got[s]) for s in got}
        print(f"[ab] {key}: other {med['other']:.4f} ms, this "
              f"{med['this']:.4f} ms (other / this "
              f"{med['other'] / med['this']:.2f})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
