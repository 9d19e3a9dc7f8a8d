"""Everything a cell needs, found by name.

``BENCHMARK.json`` at the checkout's root lists the cells (``workloads``)
and metrics.  A cell ``<config>.<traffic>`` reads:

- ``perfbench/configs/<config>.json``: the engine configuration as run, the
  frame size and intrinsics, and ``work``, the module of
  ``perfbench/work/`` that counts its operations and bytes;
- ``perfbench/traffic/<traffic>.json``: the keyframing regime the traffic
  pins, the keyframe slots a second of window needs (``buffer_fps``), the
  loop (``offline``), the frame motion, the warm-up and ``precompile``
  plan, where the check's group (a share of the window) and the traced
  stretch fall;
- ``perfbench/limits/<workload>.json``: the limit of each number the check
  compares;
- ``perfbench/metrics/<metric>.py`` for each metric, end-to-end or
  per-layer: a reader with ``read(ctx)``.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return load_json(Path(root) / "BENCHMARK.json")


def applies(metric, workload):
    """A metric without ``workloads`` applies to every cell."""
    return workload in metric.get("workloads", [workload])


def cell(workload, bench=None):
    """-> dict: ``workload`` (its BENCHMARK.json entry), ``config``,
    ``traffic``, ``limits``, ``end_to_end`` and ``per_layer`` (the metric
    entries that apply to it)."""
    bench = bench or benchmark()
    entries = [w for w in bench["workloads"] if w["name"] == workload]
    if not entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = entries[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    return dict(
        workload=w,
        config=load_json(ROOT / conf["file"]),
        traffic=load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(BENCH / "limits" / f"{workload}.json"),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if applies(m, workload)])


def module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric):
    """The metric's reader, ``perfbench/metrics/<metric>.py``."""
    return module(BENCH / "metrics" / f"{metric}.py",
                  "perfbench_metric_" + re.sub(r"\W", "_", metric))


def work(config):
    """The configuration's counts of operations and bytes."""
    return module(BENCH / "work" / f"{config['work']}.py",
                  "perfbench_work_" + config["work"])
