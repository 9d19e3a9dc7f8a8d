"""One short run of a cell on the card, through the command the benchmark
runs, and its result line's form."""
import json

import pytest

from test_perfbench_imports import load_run


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_short_run_on_the_card(card, capsys, trace):
    run = load_run()
    rc = run.main(["--workload", "dpvo_480p.retain", "--seed", "2147483659",
                   "--seconds", "2", "--trace", str(trace)])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(
        line)
    assert line["device"]["platform"] == "gpu"
    assert line["correct"] is True
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert line["breakdown"]["device_ops"]
