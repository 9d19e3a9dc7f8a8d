#!/usr/bin/env python3
"""Sizing data for a loop-closure cell, on this machine's card: the cell
``dpvo_480p.retain`` with proximity loop closure on (``LOOP_CLOSURE``,
DPV-SLAM), through the harness's whole run (``harness/cell.py``), at each
``BACKEND_THRESH`` and seed given.  A stub check compares the bookkeeping
alone (``structure``, ``harness/checks.bookkeeping``); it is no cell and
prints no result line.

    python3 perfbench/tools/lc_dry_run.py --seeds 2147483701 2147483713 \\
        --thresh 64 1e9 --seconds 51

For each run: the window's frames and ``fps``, the loop rounds with edges
and the edges of each, the global BAs run in the window with the host and
device milliseconds of each (``_run_global_ba``, timed with CUDA events),
the inactive rows at the close, ``memory_peak_bytes``, ``terminate()``
seconds and ``structure``.  One JSON line a run on standard output, and
all of them in ``chiprun_out/lc_dry_run.json``.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse   # noqa: E402
import gc         # noqa: E402
import json       # noqa: E402
import os         # noqa: E402
import statistics  # noqa: E402
import sys        # noqa: E402
import types      # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]
WORKLOAD = "dpvo_480p.retain"
# the live edges (45.3k) and one round's loop edges at reduce_edges' cap
# (1000 frame pairs x 96 patches), in multiples of 4096
EDGE_CAPACITY = 147456


def stub_check(seen):
    """A check of ``structure`` alone, its limit 0."""
    from perfbench.harness import checks

    def compare(run):
        bad, st = checks.bookkeeping(run)
        seen.append(dict(run, structure=st))
        return dict(structure=bad), None, [], st.update_edges
    return types.SimpleNamespace(NUMBERS=("structure",), compare=compare)


def timed_engine(engines):
    """``DPVO`` with each ``_run_global_ba`` timed (host clock, and CUDA
    events on the engine's stream) and ``terminate`` timed."""
    import torch
    from dpvo_tpu_torch.engine import DPVO

    class Timed(DPVO):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.global_bas, self.closing, self.terminate_s = [], False, None
            engines.append(self)

        def _run_global_ba(self):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            a.record()
            super()._run_global_ba()
            b.record()
            self.global_bas.append(dict(
                frame=self.hs.counter - 1, closing=self.closing,
                edges=self.hs.n_inac + self.hs.e_num,
                host_ms=(time.perf_counter() - t0) * 1e3, events=(a, b)))

        def terminate(self):
            self.closing = True
            t0 = time.perf_counter()
            out = super().terminate()
            self.terminate_s = time.perf_counter() - t0
            return out
    return Timed


def one(cell, device, seed, thresh, seconds, seen, engines, sizes=None):
    """One run; ``sizes``: overrides of the cell's sizes (a rehearsal's)."""
    import torch
    torch.cuda.reset_peak_memory_stats(device)
    ov = dict(sizes or {})
    ov["config"] = {**ov.get("config", {}), "LOOP_CLOSURE": True,
                    "BACKEND_THRESH": thresh}
    ov["engine"] = {"EDGE_CAPACITY": EDGE_CAPACITY, **ov.get("engine", {})}
    out, nums, _, _ = cell.run(WORKLOAD, seed, seconds, False, device,
                               time.perf_counter(), overrides=ov)
    slam, run = engines.pop(), seen.pop()
    torch.cuda.synchronize(device)
    end = run["end"]
    first = end - out["attempted"]
    rounds = [len(calls[0][0]) for f, calls in sorted(run["proposals"].items())
              if first <= f < end and len(calls[0][0])]
    bas = [dict(frame=g["frame"], edges=g["edges"],
                host_ms=g["host_ms"],
                device_ms=g["events"][0].elapsed_time(g["events"][1]))
           for g in slam.global_bas if not g["closing"]]
    in_window = [g for g in bas if first <= g["frame"] < end]
    st = run["structure"]
    res = dict(
        seed=seed, backend_thresh=thresh, setup_s=out["metrics"].get(
            "setup_s", {}).get("value"),
        window_frames=out["attempted"],
        fps=out["metrics"].get("fps", {}).get("value"),
        failed=out["failed"], loop_rounds=len(rounds),
        loop_edges_per_round=rounds,
        global_bas=len(in_window),
        global_bas_by_reference=sum(
            sum(v) for f, v in st.global_ba.items() if first <= f < end),
        ba_global_ms=in_window,
        terminate_global_bas=len(slam.global_bas) - len(bas),
        inactive_rows=run["last"]["inac"]["n"],
        memory_peak_bytes=out["memory_peak_bytes"],
        terminate_s=slam.terminate_s, structure=nums["structure"])
    # the run froze its objects before its window (``gc.freeze``): freed
    # here, or the next run's peak holds this run's engine
    del slam, run
    gc.unfreeze()
    gc.collect()
    torch.cuda.empty_cache()
    return res


def summary(r):
    dev = [g["device_ms"] for g in r["ba_global_ms"]]
    return {k: v for k, v in r.items() if k not in (
        "ba_global_ms", "loop_edges_per_round")} | dict(
        loop_edges_mean=(statistics.mean(r["loop_edges_per_round"])
                         if r["loop_edges_per_round"] else 0),
        ba_global_device_ms_median=statistics.median(dev) if dev else None,
        ba_global_device_ms_max=max(dev, default=None))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--thresh", type=float, nargs="+", default=[64.0, 1e9])
    ap.add_argument("--seconds", type=float, default=51)
    args = ap.parse_args(argv)

    cache = ROOT / ".perfbench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ["USE_FLAX"] = "0"
    os.environ["OMP_NUM_THREADS"] = "1"
    sys.path.insert(0, str(ROOT))

    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import dpvo_tpu_torch.engine as engine_mod
    from perfbench.harness import cell, manifest

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    seen, engines = [], []
    mod = stub_check(seen)
    load = manifest.load_json
    manifest.check = lambda config: mod
    manifest.load_json = lambda p: ({"structure": 0}
                                    if Path(p).parent.name == "limits"
                                    else load(p))
    engine_mod.DPVO = timed_engine(engines)
    card = cell.card_info("name,power.limit")
    results = []
    for thresh in args.thresh:
        for seed in args.seeds:
            try:
                r = one(cell, device, seed, thresh, args.seconds, seen,
                        engines)
            except (RuntimeError, ValueError) as e:
                r = dict(seed=seed, backend_thresh=thresh,
                         error=f"{type(e).__name__}: {e}")
                seen.clear()
                engines.clear()
                gc.unfreeze()
                gc.collect()
                torch.cuda.empty_cache()
            r["card"] = card
            results.append(r)
            print(json.dumps(summary(r) if "error" not in r else r),
                  flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "lc_dry_run.json").write_text(json.dumps(results, indent=1))
    print(f"[dry run] {time.perf_counter() - T_START:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
