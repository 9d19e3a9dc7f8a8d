"""The frozen reference against the port, in fp32 at a tiny CPU size, so
that a drift of either shows; and the control (the reference in fp8 in
the program's place) failing the same numbers' limits."""

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
        assert nums[f"{stage}_ba"] < 0.05, nums
    assert all(nums[k] <= v for k, v in limits.items())
    # the control, fp8, breaks a limit: the features' at least
    assert ctl["step_track"] > limits["step_track"], ctl
    assert ctl["start_track"] > limits["start_track"], ctl
    assert out["failed"] == 0 and out["attempted"] > 0
