"""A run with the timed path broken underneath must come out not correct:
the harness's whole run but the look for a card, at the tiny CPU size,
against the limits of the retain cell, in its regime and in the merge
regime.  One case per fault the
cells can have; the exchange between chips has none to leave out (every
cell runs on one card)."""
import pytest
import torch

from conftest import MERGE, tiny_run
from dpvo_tpu_torch.engine import kernels

REAL = kernels.update_step_dev


def unchanged(ds, update_mod, bucket, e_num, t0, t1, mm_blob, *a, **kw):
    """The update returns, the state as it found it."""
    mag = torch.zeros((), device=ds.poses.device)
    return (torch.zeros((bucket, 2), device=ds.poses.device),
            mag if kw.get("has_mm") else None)


def half_batch(ds, update_mod, bucket, e_num, *a, **kw):
    """Half of the live edges left out."""
    return REAL(ds, update_mod, bucket, e_num // 2, *a, **kw)


def altered(ds, update_mod, bucket, e_num, t0, t1, *a, **kw):
    """The newest pose altered where BA writes it."""
    out = REAL(ds, update_mod, bucket, e_num, t0, t1, *a, **kw)
    ds.poses[int(t1) - 1, :3] += 0.05
    return out


@pytest.mark.parametrize("fault", [unchanged, half_batch, altered],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("traffic", [None, MERGE], ids=["retain", "merge"])
def test_broken_update_is_not_correct(monkeypatch, fault, traffic):
    monkeypatch.setattr(kernels, "update_step_dev", fault)
    _, nums, limits, _ = tiny_run(traffic=traffic)
    assert any(nums[k] > v for k, v in limits.items()), nums


def test_edges_lost_after_the_group_are_not_correct(monkeypatch):
    """The program's bookkeeping broken after the group's copies: each frame
    loses its newest edge.  The copy taken when the window closes catches
    it."""
    from dpvo_tpu_torch.engine import DPVO
    from perfbench.harness import state
    taken = []
    take, call = state.take, DPVO.__call__

    def counted(slam, *a, **kw):
        taken.append(1)
        return take(slam, *a, **kw)

    def losing(self, *a, **kw):
        out = call(self, *a, **kw)
        # the start's two copies and the group's five are taken
        if len(taken) >= 7:
            self.hs.e_num -= 1
        return out
    monkeypatch.setattr(state, "take", counted)
    monkeypatch.setattr(DPVO, "__call__", losing)
    _, nums, limits, _ = tiny_run()
    assert nums["structure"] > limits["structure"], nums
