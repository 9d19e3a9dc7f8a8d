"""Everything a cell needs, found by name.

``BENCHMARK.json`` at the checkout's root lists the cells (``workloads``)
and metrics.  A cell ``<config>.<traffic>`` reads:

- ``perfbench/configs/<config>.json``: the engine configuration as run, the
  frame size and intrinsics, ``work``, the module of ``perfbench/work/``
  that counts its operations and bytes, and ``check`` (default ``dpvo``),
  the module of ``perfbench/check/`` that decides ``correct``;
- ``perfbench/traffic/<traffic>.json``: the keyframing regime the traffic
  pins, the keyframe slots a second of window needs (``buffer_fps``), the
  loop (``offline``), the frame motion, the warm-up and ``precompile``
  plan, where the check's group (a share of the window) and the traced
  stretch fall;
- ``perfbench/limits/<workload>.json``: the limit of each number the check
  compares, one for each name in the check's ``NUMBERS`` and no other;
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
    ``traffic``, ``limits``, ``check`` (the configuration's check module),
    ``end_to_end`` and ``per_layer`` (the metric entries that apply to it).
    Fails where the limits and the check's ``NUMBERS`` differ: a number
    without a limit, or a limit on a number the check does not compute."""
    bench = bench or benchmark()
    entries = [w for w in bench["workloads"] if w["name"] == workload]
    if not entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = entries[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    config = load_json(ROOT / conf["file"])
    limits = load_json(BENCH / "limits" / f"{workload}.json")
    chk = check(config)
    unlimited = sorted(set(chk.NUMBERS) - set(limits))
    unknown = sorted(set(limits) - set(chk.NUMBERS))
    if unlimited or unknown:
        raise ValueError(
            f"limits/{workload}.json against the check "
            f"{check_name(config)!r}: no limit for {unlimited}, limits on "
            f"numbers it does not compute {unknown}")
    return dict(
        workload=w, config=config,
        traffic=load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
        limits=limits, check=chk,
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


def check_name(config):
    return config.get("check", "dpvo")


def check(config):
    """The configuration's check, ``perfbench/check/<check>.py``: it
    declares ``NUMBERS``, the names of the numbers it compares, and
    ``compare(run)``; with ``REFUSES`` the engine settings it cannot
    follow."""
    name = check_name(config)
    return module(BENCH / "check" / f"{name}.py",
                  "perfbench_check_" + re.sub(r"\W", "_", name))


def admit(spec, cfg):
    """Refuse, before anything runs, an engine configuration ``cfg`` (a
    ``VOConfig``) that the cell's check cannot follow (its ``REFUSES``)."""
    refused = {k: v for k, v in getattr(spec["check"], "REFUSES", {}).items()
               if getattr(cfg, k) == v}
    if refused:
        name = check_name(spec["config"])
        raise ValueError(
            f"the check {name!r} cannot follow "
            + ", ".join(f"{k}={v!r}" for k, v in refused.items())
            + ": such a configuration must name its own check (its "
            "\"check\" key, perfbench/check/<name>.py)")
