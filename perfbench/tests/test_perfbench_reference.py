"""The frozen reference against the port, in fp32 at a tiny CPU size, so
that a drift of either shows; and the control (the reference in fp8 in
the program's place, its local BA in bfloat16) failing the same numbers'
limits."""

from conftest import MERGE, tiny_run
from perfbench.reference.model import param_shapes


def test_weights_keyed_as_the_port():
    from dpvo_tpu_torch.models.update import Update
    from dpvo_tpu_torch.models.vonet import Patchifier
    port = {**Patchifier(3).state_dict(), **Update(3).state_dict()}
    assert {k: tuple(v.shape) for k, v in port.items()} == {
        k: tuple(s) for k, s in param_shapes().items()}


def test_port_matches_reference_in_fp32_and_control_fails():
    out, nums, limits, ctl = tiny_run(traffic=MERGE, control=True)
    assert nums["structure"] == 0
    # fp32 against fp32, summation order only: the features' gap, and the
    # update's and BA's gaps a small share of what bf16 rounding gives
    for stage in ("start", "step"):
        assert nums[f"{stage}_track"] < 1e-4, nums
        assert nums[f"{stage}_update"] < 0.05, nums
    assert nums["start_ba"] < 0.05, nums
    # local BA alone against float64: within a few times the float32
    # reference's own gap there
    assert nums["step_ba"] < 4, nums
    assert all(nums[k] <= v for k, v in limits.items())
    # the control, fp8, breaks a limit: the features' at least; and its BA,
    # in bfloat16, BA's
    assert ctl["step_track"] > limits["step_track"], ctl
    assert ctl["start_track"] > limits["start_track"], ctl
    assert ctl["step_ba"] > limits["step_ba"], ctl
    assert out["failed"] == 0 and out["attempted"] > 0
