"""BENCHMARK.json against the benchmark's contract, and every cell's files
found by name."""
import json
import re

import pytest

from perfbench.harness import manifest

B = manifest.benchmark()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")


def test_keys_and_limits():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["paths"] == ["perfbench"]
    assert B["command"][1].startswith("perfbench/")
    assert 1 <= B["run_seconds"] <= 51
    assert len(json.dumps(B)) < 64 * 1024
    assert {m["name"] for m in B["end_to_end"]} >= {"setup_s"}
    for m in B["end_to_end"]:
        assert 0 < m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_names_and_units():
    names = ([c["name"] for c in B["configs"]]
             + [w["name"] for w in B["workloads"]]
             + [m["name"] for m in B["end_to_end"] + B["per_layer"]])
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in B["workloads"]]:
        assert NAME.match(n), n
    for c in B["configs"]:
        for k in c["reduced"]:
            assert NAME.match(k), k
    for m in B["end_to_end"] + B["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in B["workloads"]]
                 + [c["why"] for c in B["configs"]]
                 + [m["layer"] for m in B["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("w", [w["name"] for w in B["workloads"]])
def test_cell_resolves(w):
    spec = manifest.cell(w)
    assert spec["workload"]["chips"] == 1
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec["per_layer"]
    assert spec["limits"]["structure"] == 0
    assert spec["traffic"]["loop"] == "offline"
    assert 0 < spec["traffic"]["check_share"][0] <= spec["traffic"][
        "check_share"][1] < 1
    assert manifest.work(spec["config"]).tracking_flops(96, 128) > 0


@pytest.mark.parametrize("m", [m["name"] for m in B["per_layer"]])
def test_reader_declares_its_entry(m):
    entry = [x for x in B["per_layer"] if x["name"] == m][0]
    mod = manifest.reader(m)
    assert (mod.LAYER, mod.UNIT, mod.MOVES) == (
        entry["layer"], entry["unit"], entry["moves"])
    assert entry["moves"] in {x["name"] for x in B["end_to_end"]}
    moved = [x for x in B["end_to_end"] if x["name"] == entry["moves"]][0]
    for w in entry["workloads"]:
        assert manifest.applies(moved, w)


@pytest.mark.parametrize("m", [m["name"] for m in B["end_to_end"]])
def test_end_to_end_reader_found(m):
    assert callable(manifest.reader(m).read)
