"""The port's RxSO3, Sim3 and SE3 helpers (``quat_normalize``,
``se3_scale``, ``se3_to_sim3`` / ``sim3_to_se3``) against
``dpvo_tpu.ops.lie`` on CPU, on tests/test_lie.py's cases: the same seeded
numpy inputs through both, fp32, atol 1e-5 (1e-4 where a 4x4 or 7x7 matrix
product or the Sim3 log's 3x3 solve sums in a different order).  Also the
round trips ``sim3_exp`` then ``sim3_log`` and ``se3_to_sim3`` then
``sim3_to_se3``, and the Sim3 group identities.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dpvo_tpu.ops import lie as jlie
from dpvo_tpu_torch.ops import lie

ATOL = 1e-5
RNG = np.random.default_rng(0)


def rand(*shape, scale=1.0):
    return (RNG.normal(size=shape) * scale).astype(np.float32)


XI_RX = rand(32, 4, scale=0.5)
XI_SIM = rand(64, 7, scale=0.5)
XI_SE = rand(32, 6)
PTS = rand(64, 3)
PTS4 = np.concatenate([PTS, np.abs(rand(64, 1)) + 0.1], -1)
# small-angle / small-scale limits of W and both at once
XI_SIM_EDGE = np.zeros((4, 7), np.float32)
XI_SIM_EDGE[:, :3] = rand(4, 3)
XI_SIM_EDGE[1, 3:6] = 1e-6
XI_SIM_EDGE[2, 6] = 1e-7
XI_SIM_EDGE[3, 3:] = rand(4, scale=0.3)


def both(name, *args):
    want = np.asarray(getattr(jlie, name)(*(jnp.asarray(a) for a in args)))
    got = getattr(lie, name)(*(torch.from_numpy(np.array(a))
                               for a in args)).numpy()
    return got, want


def sim3(xi):
    return np.asarray(jlie.sim3_exp(jnp.asarray(xi)))


def rxso3(xi):
    return np.asarray(jlie.rxso3_exp(jnp.asarray(xi)))


CASES = {
    "quat_normalize": (lambda: (rand(16, 4),), ATOL),
    "se3_scale": (lambda: (np.asarray(jlie.se3_exp(XI_SE[:4])),
                           np.full((4,), 2.0, np.float32)), ATOL),
    "rxso3_exp": (lambda: (XI_RX,), ATOL),
    "rxso3_log": (lambda: (rxso3(XI_RX),), ATOL),
    "rxso3_inv": (lambda: (rxso3(XI_RX),), ATOL),
    "rxso3_mul": (lambda: (rxso3(XI_RX), rxso3(XI_RX[::-1].copy())), ATOL),
    "rxso3_act": (lambda: (rxso3(XI_RX), PTS[:32]), ATOL),
    "sim3_exp": (lambda: (XI_SIM,), ATOL),
    "sim3_exp_limits": (lambda: (XI_SIM_EDGE,), ATOL),
    "sim3_log": (lambda: (sim3(XI_SIM),), 1e-4),
    "sim3_inv": (lambda: (sim3(XI_SIM),), ATOL),
    "sim3_mul": (lambda: (sim3(XI_SIM), sim3(XI_SIM[::-1].copy())), ATOL),
    "sim3_act": (lambda: (sim3(XI_SIM), PTS), ATOL),
    "sim3_act4": (lambda: (sim3(XI_SIM), PTS4), ATOL),
    "sim3_matrix": (lambda: (sim3(XI_SIM),), ATOL),
    "sim3_adj_matrix": (lambda: (sim3(XI_SIM),), ATOL),
    "sim3_adjT": (lambda: (sim3(XI_SIM), rand(64, 7)), 1e-4),
    "sim3_retr": (lambda: (sim3(XI_SIM), rand(64, 7, scale=0.1)), ATOL),
    "se3_to_sim3": (lambda: (np.asarray(jlie.se3_exp(XI_SE)),), ATOL),
    "sim3_to_se3": (lambda: (sim3(XI_SIM),), ATOL),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax(case):
    make, atol = CASES[case]
    name = case.removesuffix("_limits")
    got, want = both(name, *make())
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=atol)


def test_sim3_identity_matches_jax():
    np.testing.assert_array_equal(lie.sim3_identity((3, 2)).numpy(),
                                  np.asarray(jlie.sim3_identity((3, 2))))


def test_sim3_exp_log_roundtrip():
    g = lie.sim3_exp(torch.from_numpy(XI_SIM))
    np.testing.assert_allclose(lie.sim3_log(g).numpy(), XI_SIM, atol=1e-3)
    g = lie.sim3_exp(torch.from_numpy(XI_SIM_EDGE))
    np.testing.assert_allclose(lie.sim3_log(g).numpy(), XI_SIM_EDGE,
                               atol=1e-4)


def test_se3_sim3_roundtrip():
    g = lie.se3_exp(torch.from_numpy(XI_SE))
    s = lie.se3_to_sim3(g)
    assert s.shape == (32, 8)
    np.testing.assert_array_equal(lie.sim3_to_se3(s).numpy(), g.numpy())
    p = torch.from_numpy(PTS[:32])
    np.testing.assert_allclose(lie.sim3_act(s, p).numpy(),
                               lie.se3_act(g, p).numpy(), atol=ATOL)


def test_sim3_group_identities():
    g = lie.sim3_exp(torch.from_numpy(XI_SIM))
    np.testing.assert_allclose(lie.sim3_mul(g, lie.sim3_inv(g)).numpy(),
                               lie.sim3_identity(64).numpy(), atol=ATOL)
    ph = torch.cat([torch.from_numpy(PTS), torch.ones(64, 1)], -1)
    np.testing.assert_allclose(
        lie.sim3_act(g, torch.from_numpy(PTS)).numpy(),
        (lie.sim3_matrix(g) @ ph[..., None])[..., :3, 0].numpy(), atol=1e-4)


def test_se3_scale_by_device_scalar():
    """The engine rescales deltas by a 0-dim tensor (no host fetch)."""
    g = lie.se3_exp(torch.from_numpy(XI_SE[:4]))
    got = lie.se3_scale(g, torch.tensor(0.5))
    np.testing.assert_allclose(got[:, :3].numpy(), 0.5 * g[:, :3].numpy(),
                               atol=ATOL)
    np.testing.assert_array_equal(got[:, 3:].numpy(), g[:, 3:].numpy())
