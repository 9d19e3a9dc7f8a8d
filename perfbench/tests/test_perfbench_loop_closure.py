"""The harness under proximity loop closure (``LOOP_CLOSURE``, DPV-SLAM), at
the tiny CPU size: a stub check stands in for the check module a
loop-closure configuration brings (``perfbench/check/<name>.py``), with its
own limits, so that such a configuration needs new files only.  The
reference's bookkeeping follows the program's loop rounds, retirements and
inactive store exactly, and each planted fault shows in ``structure``.
The VO cells' numbers stay bitwise what they were before the check became
the configuration's."""
import itertools
import types

import numpy as np
import pytest
import torch

from conftest import MERGE, tiny_run
from dpvo_tpu_torch.engine import DPVO
from perfbench.harness import cell, checks, inputs, manifest, state

# the first frame at which a loop round can find a frame pair 30 frames
# apart comes early in a tiny window only with rounds every few frames;
# KEYFRAME_INDEX 1 leaves a round's targets, [n - GLOBAL_OPT_FREQ,
# n - KEYFRAME_INDEX), two frames
LC = dict(LOOP_CLOSURE=True, BACKEND_THRESH=1e9, GLOBAL_OPT_FREQ=3,
          KEYFRAME_INDEX=1, EDGE_CAPACITY=1024, MAX_EDGE_AGE=64)
WARM = 12     # the tiny traffic's warm frames (conftest.TINY)
SEED = 2 ** 31 + 7


class Clock:
    """A host clock that moves ``dt`` each time it is read: the window's
    frames, and where its group falls, are then the same on every run."""

    def __init__(self, dt=0.01):
        self.ticks, self.dt = itertools.count(), dt

    def perf_counter(self):
        return next(self.ticks) * self.dt


@pytest.fixture
def stub(monkeypatch):
    """A stub check with ``structure`` alone (``checks.bookkeeping``) and its
    limit, in place of every configuration's; -> the runs it judged."""
    seen = []

    def compare(run):
        bad, st = checks.bookkeeping(run)
        seen.append(dict(run, structure=st))
        return dict(structure=bad), None, [], st.update_edges
    mod = types.SimpleNamespace(NUMBERS=("structure",), compare=compare)
    load = manifest.load_json

    def limits(path):
        return ({"structure": 0} if path.parent.name == "limits"
                else load(path))
    monkeypatch.setattr(manifest, "check", lambda config: mod)
    monkeypatch.setattr(manifest, "load_json", limits)
    monkeypatch.setattr(cell, "time", Clock())
    return seen


def lc_run(**kw):
    return tiny_run(seed=SEED, seconds=1.2, engine=LC, **kw)


def test_loop_closure_bookkeeping_is_followed(stub):
    _, nums, limits, _ = lc_run()
    assert limits == {"structure": 0}
    run = stub[-1]
    st = run["structure"]
    rounds = {f: e for f, e in st.loop_edges.items() if f >= WARM}
    ran = [f for f, v in st.global_ba.items() if f >= WARM and any(v)]
    assert len(rounds) >= 2 and min(rounds.values()) > 0, st.loop_edges
    assert ran, st.global_ba
    assert run["last"]["inac"]["n"] == st.n_inac > 0
    assert nums["structure"] == 0, nums


def drop_a_loop_edge(monkeypatch):
    """Each loop round loses its last edge after its append."""
    real = DPVO.append_factors

    def append(self, kk, jj):
        real(self, kk, jj)
        if len(kk) and ((np.asarray(jj) - np.asarray(kk) // self.M)
                        >= 30).all():
            self.hs.e_num -= 1
    monkeypatch.setattr(DPVO, "append_factors", append)


def lose_an_inactive_row(monkeypatch):
    """Each retirement stores all but its last edge."""
    real = DPVO._store_inactive
    monkeypatch.setattr(DPVO, "_store_inactive",
                        lambda self, idx: real(self, idx[:-1]))


def retire_a_loop_edge_early(monkeypatch):
    """Loop edges retired one keyframe before the optimization window lets
    them go."""
    real = DPVO.keyframe

    def keyframe(self):
        real(self)
        hs, cfg, e = self.hs, self.cfg, self.hs.e_num
        ii, jj, kk = hs.ii[:e], hs.jj[:e], hs.kk[:e]
        self.remove_factors(
            (kk // self.M < self.n - cfg.REMOVAL_WINDOW) & (jj - ii > 30)
            & (jj == self.n - cfg.OPTIMIZATION_WINDOW + 1), store=True)
        self._flush_edge_permute()
    monkeypatch.setattr(DPVO, "keyframe", keyframe)


@pytest.mark.parametrize("fault", [drop_a_loop_edge, lose_an_inactive_row,
                                   retire_a_loop_edge_early],
                         ids=lambda f: f.__name__)
def test_broken_loop_closure_bookkeeping_shows(stub, monkeypatch, fault):
    fault(monkeypatch)
    _, nums, _, _ = lc_run()
    assert nums["structure"] >= 1, nums


def test_copies_hold_the_final_store_prefix(stub, monkeypatch):
    """The store only appends: each copy's rows, cloned when it was taken,
    are bitwise the rows the check slices from the store at the close."""
    take = state.take_lc

    def cloned(slam, *a, **kw):
        s = take(slam, *a, **kw)
        n = s["inac"]["n"]
        s["rows"] = (slam.ds.target_inac[:n].clone(),
                     slam.ds.weight_inac[:n].clone())
        return s
    monkeypatch.setattr(state, "take_lc", cloned)
    lc_run()
    run = stub[-1]
    target, weight = run["store"]
    last = run["last"]["inac"]
    assert any(c["inac"]["n"] > 0 for c in run["copies"])
    for c in run["copies"] + [run["last"]]:
        n = c["inac"]["n"]
        assert torch.equal(c["rows"][0], target[:n])
        assert torch.equal(c["rows"][1], weight[:n])
        for k in ("ii", "jj", "kk"):
            assert np.array_equal(c["inac"][k], last[k][:n])


@pytest.fixture
def no_setup(monkeypatch):
    """Set-up never reached: the weights are the first thing it makes."""
    def made(*a, **kw):
        raise AssertionError("set-up ran")
    monkeypatch.setattr(inputs, "make_weights", made)


def test_the_default_check_refuses_loop_closure(no_setup):
    with pytest.raises(ValueError, match="must name its own check"):
        tiny_run(engine=LC)


def test_loop_closure_with_merges_is_refused(stub, no_setup):
    with pytest.raises(ValueError, match="never merges"):
        lc_run(traffic=MERGE)


@pytest.mark.parametrize("numbers", [("structure",), (
    "structure", "start_track", "start_update", "start_ba", "step_track",
    "step_update", "step_ba", "loop_pose")], ids=["unknown", "unlimited"])
def test_limits_and_numbers_must_agree(monkeypatch, no_setup, numbers):
    mod = types.SimpleNamespace(NUMBERS=numbers, compare=None)
    monkeypatch.setattr(manifest, "check", lambda config: mod)
    with pytest.raises(ValueError, match="limits/dpvo_480p.retain.json"):
        tiny_run()


def test_inactive_store_sized_from_the_window():
    spec = manifest.cell("dpvo_480p.retain")
    assert cell.engine_config(spec, 51).EDGE_CAPACITY_INAC == 16384
    spec["config"]["LOOP_CLOSURE"] = True
    # 16384 slots x (96 x 25 + ceil(96000 / 15)): 2.3 GB of rows
    assert cell.engine_config(spec, 51).EDGE_CAPACITY_INAC == 144179200
    assert cell.engine_config(spec, 51, dict(
        EDGE_CAPACITY_INAC=5000)).EDGE_CAPACITY_INAC == 5000


# the seven numbers at the tiny size, on four threads: the first six as
# before the check moved into ``check/dpvo.py``, ``step_ba`` as measured
# against BA in float64 (both cells' overrides make the same run)
PINNED = dict(
    structure=0, start_track="0x1.f726bc0000000p-21",
    start_update="0x1.cfec185a30f12p-13", start_ba="0x1.32ca0045bc3a9p-7",
    step_track="0x1.f7cf880000000p-21", step_update="0x1.0db94d8b17e7bp-12",
    step_ba="0x1.5855b59109ab1p+0")


@pytest.mark.parametrize("workload", ["dpvo_480p.retain",
                                      "dpvo_kitti.retain"])
def test_vo_numbers_are_unchanged(monkeypatch, workload):
    monkeypatch.setattr(cell, "time", Clock())
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        _, nums, _, _ = tiny_run(workload, seed=SEED, seconds=1.0)
    finally:
        torch.set_num_threads(threads)
    assert {k: v if isinstance(v, int) else float(v).hex()
            for k, v in nums.items()} == PINNED
