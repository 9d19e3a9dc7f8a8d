#!/usr/bin/env python3
"""Run one cell of the benchmark once, on this machine's card.

    python3 perfbench/run.py --workload dpvo_480p.retain --seed 7 \\
        --seconds 51 --trace 0

Diagnostics go to standard error; the last line of standard output is the
result: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``, each compared number
with its limit.  ``--control 1`` also prints the numbers of the check's
control (the reference in fp8, its BA in bfloat16, in the program's place);
the benchmark's own runs never ask for it.  The run fails, printing no
result, without a card, with JAX or the JAX package loaded, or where the
program is missing.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse   # noqa: E402
import json       # noqa: E402
import math       # noqa: E402
import os         # noqa: E402
import sys        # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "dpvo_tpu"}


def forbidden_modules(names):
    """The loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's (``dpvo_tpu_torch`` is not ``dpvo_tpu``)."""
    return sorted({n.split(".")[0] for n in names} & FORBIDDEN)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache of the program inside the checkout, at fixed paths
    cache = ROOT / ".perfbench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ["USE_FLAX"] = "0"
    # one process with few threads: no host thread pool beside the frame loop
    os.environ["OMP_NUM_THREADS"] = "1"
    sys.path.insert(0, str(ROOT))

    import torch
    from perfbench.harness import cell, manifest

    entry = [w for w in manifest.benchmark()["workloads"]
             if w["name"] == args.workload]
    chips = entry[0]["chips"] if entry else 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out, nums, limits, ctl = cell.run(
        args.workload, args.seed, args.seconds, bool(args.trace), device,
        T_START, control=bool(args.control))
    # after the run: nvidia-smi takes up to seconds, which set-up would count
    cell.log(f"[card] {torch.cuda.get_device_name(device)}, "
             f"{torch.cuda.device_count()} device(s); " + cell.card_info(
                 "name,power.limit,power.draw,clocks.sm,temperature.gpu"))

    found = forbidden_modules(sys.modules)
    if found:
        print(f"loaded in this process: {', '.join(found)} (JAX or the JAX "
              "package); no result", file=sys.stderr)
        return 3

    checks = {k: dict(value=nums[k], limit=limits[k]) for k in limits}
    out["correct"] = (out["failed"] == 0 and all(
        v["value"] <= v["limit"] for v in checks.values()))
    dev = dict(platform="gpu", kind=torch.cuda.get_device_name(device),
               count=chips, memory_peak_bytes=out.pop("memory_peak_bytes"))
    if args.trace:
        dev["busy_s"] = out.pop("busy_s", 0.0)
        dev["window_s"] = out.pop("window_s", 0.0)
    out["device"] = dev
    breakdown = out.pop("breakdown", None)
    if breakdown is not None:
        out["breakdown"] = breakdown
    if ctl is not None:
        cell.log("[control] " + json.dumps(ctl))
    out["checks"] = checks
    for k, v in checks.items():
        cell.log(f"check {k} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(finite(out), allow_nan=False), flush=True)
    return 0


def finite(x):
    """``x`` with every non-finite number as None (strict JSON)."""
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


if __name__ == "__main__":
    sys.exit(main())
