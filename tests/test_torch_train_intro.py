"""The port's rollout against the JAX package's across frame introduction:
10 frames, M=2, 10 steps, so frames 8 and 9 come in at steps 8 and 9
(pose copied from the previous frame, the new patches' depth the median
of the two previous frames' patch depths; ``torch.nanquantile`` at 0.5
averages the two middle values as ``jnp.nanmedian`` does).  Forward only,
both modes, fp32: flow_err atol 1e-4 (values about 4), poses atol 1e-4,
the one-call BA bound, which holds here after 20 BA solves.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dpvo_tpu.models.update import DIM, Update as JUpdate
from dpvo_tpu.ops import corr as jcorr, lie as jlie
from dpvo_tpu.training import rollout as jR
from dpvo_tpu_torch.models.update import Update as TUpdate
from dpvo_tpu_torch.training import rollout as tR
from dpvo_tpu_torch.utils.checkpoint import flax_to_state_dict

torch.set_num_threads(1)
N, M, S, h, w = 10, 2, 10, 8, 12
K = N * M


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    sch = jR.build_schedule(N, M, S, rng)
    key = jax.random.PRNGKey(0)
    um = JUpdate(3, dtype=jnp.float32)
    params = um.init(key, jnp.zeros((8, DIM)), jnp.zeros((8, DIM)),
                     jnp.zeros((8, 882)), jnp.zeros((8,), jnp.int32),
                     jnp.zeros((8,), jnp.int32), jnp.zeros((8,), jnp.int32))
    xi = (jax.random.normal(key, (N, 6)) * 0.03).at[:, 0].add(
        jnp.arange(N) * 0.05)
    a = dict(poses_gt=jlie.se3_inv(jlie.se3_exp(xi)),
             imap=jnp.asarray(rng.normal(size=(K, DIM)), jnp.float32) * 0.1,
             gmap=jnp.asarray(rng.normal(size=(K, 3, 3, 128)),
                              jnp.float32) * 0.1,
             fmap1=jnp.asarray(rng.normal(size=(N, h, w, 128)),
                               jnp.float32) * 0.1,
             intr=jnp.tile(jnp.asarray([[40.0, 40.0, w / 2, h / 2]]),
                           (N, 1)))
    a["fmap4"] = jcorr.avg_pool2d(a["fmap1"], 4)
    cx = rng.uniform(2, w - 2, (K, 1, 1))
    cy = rng.uniform(2, h - 2, (K, 1, 1))
    off = np.arange(3.0) - 1
    d = rng.uniform(0.5, 1.5, (K, 1, 1))
    pg = np.stack([np.broadcast_to(cx + off[None, None, :], (K, 3, 3)),
                   np.broadcast_to(cy + off[None, :, None], (K, 3, 3)),
                   np.broadcast_to(d, (K, 3, 3))], axis=1).astype(np.float32)
    pi = pg.copy()
    pi[:, 2] = rng.uniform(0.3, 1.0, (K, 1, 1))
    a["patches_gt"], a["patches_init"] = jnp.asarray(pg), jnp.asarray(pi)
    want = {so: jR.vonet_rollout(
        params, a["imap"], a["gmap"], a["fmap1"], a["fmap4"],
        a["patches_init"], a["patches_gt"], a["poses_gt"], a["intr"],
        sch.ii, sch.jj, sch.kk, sch.active, sch.fresh, sch.intro,
        update_mod=um, structure_only=so, steps=S, M=M)
        for so in (False, True)}
    tm = TUpdate(3)
    tm.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, params)))
    return sch, {k: t(v) for k, v in a.items()}, want, tm


@pytest.mark.parametrize("structure_only", [False, True])
def test_rollout_through_frame_introduction(inputs, structure_only):
    sch, a, want, tm = inputs
    assert list(sch.intro[8:]) == [8, 9]
    with torch.no_grad():
        got = tR.vonet_rollout(
            tm, a["imap"], a["gmap"], a["fmap1"], a["fmap4"],
            a["patches_init"], a["patches_gt"], a["poses_gt"], a["intr"],
            sch.ii, sch.jj, sch.kk, sch.active, sch.fresh, sch.intro,
            structure_only=structure_only, steps=S, M=M)
    want = want[structure_only]
    np.testing.assert_allclose(got["flow_err"].numpy(),
                               np.asarray(want["flow_err"]), atol=1e-4)
    np.testing.assert_allclose(got["px1"].numpy(), np.asarray(want["px1"]),
                               atol=1e-6)
    np.testing.assert_allclose(got["poses"].numpy(),
                               np.asarray(want["poses"]), atol=1e-4)


def test_intro_depth_is_the_two_middle_values_mean():
    """An even count of source depths: the median is the mean of the two
    middle ones (torch.nanmedian would return the lower)."""
    src = torch.tensor([0.1, 0.4, 0.2, 0.9])
    assert float(torch.nanquantile(src, 0.5)) == pytest.approx(0.3)
    assert float(jnp.nanmedian(jnp.asarray(src.numpy()))) == pytest.approx(
        0.3)
