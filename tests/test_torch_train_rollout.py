"""The port's training rollout against the JAX package's on CPU, at the
size of tests/test_training.py (N=5 frames of 32x48, M=4 patches, 3
steps): per-step ``flow_err``, ``px1`` and poses, the loss gradient leaf
by leaf, ``pose_loss_terms`` and ``kabsch_umeyama``; the structure-only
rollout keeps the GT poses.

Both packages run the same flax-initialised Update weights on the same
numpy-seeded inputs, in fp32.  Tolerances: flow_err and px1 rtol 1e-4;
poses atol 2e-4 (tests/test_torch_ba.py holds one BA call to 1e-4; the
rollout makes six).  The loss gradient of each parameter leaf, as
|g_port - g_jax| / |g_jax| (L2 norms): through one rollout step within
1e-3, through three within 3e-2 (ROADMAP.md Queue 3: the three-step
gradient is ill-conditioned; the JAX package's own moves by about as much
when the initial depths move by 3e-6 of themselves, which
``test_three_step_gradient_is_ill_conditioned`` measures, so fp32 rounding
alone separates the two packages by that much).  SoftAgg's ``g`` biases are
left out: their exact gradient is 0 (the softmax is invariant to them),
so both sides hold rounding noise.
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
N, H, W, M, S = 5, 32, 48, 4, 3
h, w = H // 4, W // 4
K = N * M


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def setup():
    """tests/test_training.py's fixture, and one JAX run of everything the
    tests compare: the full and structure-only rollouts and the loss
    gradient."""
    update_mod = JUpdate(3, dtype=jnp.float32)
    key = jax.random.PRNGKey(0)
    rng = np.random.default_rng(0)
    sch = jR.build_schedule(N, M, S, rng)
    u_params = update_mod.init(
        key, jnp.zeros((8, DIM)), jnp.zeros((8, DIM)),
        jnp.zeros((8, 2 * 49 * 9)), jnp.zeros((8,), jnp.int32),
        jnp.zeros((8,), jnp.int32), jnp.zeros((8,), jnp.int32))
    xi = jax.random.normal(key, (N, 6)) * 0.05
    xi = xi.at[:, 0].add(jnp.arange(N) * 0.1)
    poses_gt = jlie.se3_inv(jlie.se3_exp(xi))
    imap = jnp.asarray(rng.normal(size=(K, DIM)), jnp.float32) * 0.1
    gmap = jnp.asarray(rng.normal(size=(K, 3, 3, 128)), jnp.float32) * 0.1
    fmap1 = jnp.asarray(rng.normal(size=(N, h, w, 128)), jnp.float32) * 0.1
    fmap4 = jcorr.avg_pool2d(fmap1, 4)
    intr = jnp.tile(jnp.asarray([[40.0, 40.0, w / 2, h / 2]]), (N, 1))
    cx = jnp.asarray(rng.uniform(2, w - 2, (K, 1, 1)), jnp.float32)
    cy = jnp.asarray(rng.uniform(2, h - 2, (K, 1, 1)), jnp.float32)
    off = jnp.arange(3, dtype=jnp.float32) - 1
    d = jnp.asarray(rng.uniform(0.5, 1.5, (K, 1, 1)), jnp.float32)
    patches_gt = jnp.stack([
        jnp.broadcast_to(cx + off[None, None, :], (K, 3, 3)),
        jnp.broadcast_to(cy + off[None, :, None], (K, 3, 3)),
        jnp.broadcast_to(d, (K, 3, 3))], axis=1)
    patches_init = patches_gt.at[:, 2].set(
        jnp.asarray(rng.uniform(0.3, 1.0, (K, 1, 1)), jnp.float32))
    arrays = dict(imap=imap, gmap=gmap, fmap1=fmap1, fmap4=fmap4,
                  patches_init=patches_init, patches_gt=patches_gt,
                  poses_gt=poses_gt, intr=intr)

    def rollout(params, structure_only=False):
        return jR.vonet_rollout(
            params, imap, gmap, fmap1, fmap4, patches_init, patches_gt,
            poses_gt, intr, sch.ii, sch.jj, sch.kk, sch.active, sch.fresh,
            sch.intro, update_mod=update_mod, structure_only=structure_only,
            steps=S, M=M)

    def loss(params, steps, patches_init=patches_init):
        out = jR.vonet_rollout(
            params, imap, gmap, fmap1, fmap4, patches_init, patches_gt,
            poses_gt, intr, sch.ii, sch.jj, sch.kk, sch.active[:steps],
            sch.fresh[:steps], sch.intro[:steps], update_mod=update_mod,
            structure_only=False, steps=steps, M=M)
        tr, ro, _ = jR.pose_loss_terms(out["poses"], poses_gt)
        return (0.1 * jnp.sum(out["flow_err"])
                + 10.0 * jnp.sum((tr + ro) * (jnp.arange(steps)
                                              >= min(2, steps - 1))))

    want = {"full": rollout(u_params)}
    tr, ro, fr = jR.pose_loss_terms(want["full"]["poses"], poses_gt)
    grads = {n: jax.grad(loss)(u_params, n) for n in (1, S)}
    # the same gradient from initial depths moved by 3e-6 of themselves
    grads["moved"] = jax.grad(loss)(
        u_params, S, patches_init.at[:, 2].multiply(1 + 3e-6))
    tm = TUpdate(3)
    tm.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray,
                                                       u_params)))
    return dict(sch=sch, arrays={k: t(v) for k, v in arrays.items()},
                want=want, pose_terms=(tr, ro, fr), grads=grads, tm=tm)


def _rollout(s, structure_only=False):
    a, sch = s["arrays"], s["sch"]
    return tR.vonet_rollout(
        s["tm"], a["imap"], a["gmap"], a["fmap1"], a["fmap4"],
        a["patches_init"], a["patches_gt"], a["poses_gt"], a["intr"],
        sch.ii, sch.jj, sch.kk, sch.active, sch.fresh, sch.intro,
        structure_only=structure_only, steps=S, M=M)


def test_rollout_matches(setup):
    with torch.no_grad():
        got = _rollout(setup)
    want = setup["want"]["full"]
    assert got["flow_err"].shape == (S,) and got["poses"].shape == (S, N, 7)
    for k in ("flow_err", "px1"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(got["poses"].numpy(),
                               np.asarray(want["poses"]), atol=2e-4)


def test_structure_only_keeps_gt_poses(setup):
    """Structure-only: the poses stay the GT at every step (its parity
    with the JAX package is tests/test_torch_train_intro.py's)."""
    with torch.no_grad():
        got = _rollout(setup, structure_only=True)
    assert torch.isfinite(got["flow_err"]).all()
    for s_i in range(S):
        np.testing.assert_allclose(got["poses"][s_i].numpy(),
                                   setup["arrays"]["poses_gt"].numpy(),
                                   atol=1e-6)


@pytest.mark.parametrize("steps,rel", [(1, 1e-3), (S, 3e-2)])
def test_rollout_loss_gradient_per_leaf(setup, steps, rel):
    """The loss of tests/test_training.py (over one step, the pose term
    unmasked) through the checkpointed rollout: every Update parameter's
    gradient against jax.grad."""
    tm = setup["tm"]
    tm.zero_grad()
    a, sch = setup["arrays"], setup["sch"]
    out = tR.vonet_rollout(
        tm, a["imap"], a["gmap"], a["fmap1"], a["fmap4"], a["patches_init"],
        a["patches_gt"], a["poses_gt"], a["intr"], sch.ii, sch.jj, sch.kk,
        sch.active[:steps], sch.fresh[:steps], sch.intro[:steps],
        structure_only=False, steps=steps, M=M)
    tr, ro, _ = tR.pose_loss_terms(out["poses"], a["poses_gt"])
    mask = (torch.arange(steps) >= min(2, steps - 1)).float()
    loss = 0.1 * out["flow_err"].sum() + 10.0 * ((tr + ro) * mask).sum()
    loss.backward()
    gw = flax_to_state_dict(jax.tree.map(np.asarray, setup["grads"][steps]))
    gt = {n: p.grad for n, p in tm.named_parameters()}
    assert gw.keys() == gt.keys()
    for k in gw:
        a, b = gt[k].numpy(), gw[k].numpy()
        if k in ("agg_kk.g.bias", "agg_ij.g.bias"):
            assert np.abs(a).max() < 1e-6 and np.abs(b).max() < 1e-6, k
            continue
        err = float(np.linalg.norm(a - b))
        assert np.linalg.norm(b) > 0 and err <= rel * np.linalg.norm(b), (
            k, err, float(np.linalg.norm(b)))


def test_three_step_gradient_is_ill_conditioned(setup):
    """The cause of the three-step gate: moving the initial depths by 3e-6
    of themselves moves the JAX package's own three-step gradient by more
    than 5e-3 of a leaf (L2) in most leaves, against less than 1e-3 over one
    step (the one-step gate); the port's gap from JAX stays within twice
    the largest such move."""
    a, b = (flax_to_state_dict(jax.tree.map(np.asarray, setup["grads"][k]))
            for k in (S, "moved"))
    moved = {k: float(np.linalg.norm(b[k].numpy() - a[k].numpy())
                      / np.linalg.norm(a[k].numpy()))
             for k in a if k not in ("agg_kk.g.bias", "agg_ij.g.bias")}
    assert np.median(list(moved.values())) > 5e-3, moved
    tm = setup["tm"]
    tm.zero_grad()
    out = _rollout(setup)
    tr, ro, _ = tR.pose_loss_terms(out["poses"], setup["arrays"]["poses_gt"])
    mask = (torch.arange(S) >= 2).float()
    (0.1 * out["flow_err"].sum() + 10.0 * ((tr + ro) * mask).sum()
     ).backward()
    gt = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    gap = max(float(np.linalg.norm(gt[k] - a[k].numpy())
                    / np.linalg.norm(a[k].numpy())) for k in moved)
    assert gap <= 2 * max(moved.values()), (gap, max(moved.values()))


def test_pose_loss_terms(setup):
    want_tr, want_ro, want_fr = setup["pose_terms"]
    poses = t(setup["want"]["full"]["poses"])
    tr, ro, fr = tR.pose_loss_terms(poses, setup["arrays"]["poses_gt"])
    np.testing.assert_allclose(tr.numpy(), np.asarray(want_tr), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(ro.numpy(), np.asarray(want_ro), rtol=1e-4,
                               atol=1e-6)
    for k in ("r1", "r2", "t1", "t2"):
        np.testing.assert_allclose(fr[k].numpy(), np.asarray(want_fr[k]),
                                   err_msg=k)


def test_pose_loss_gradient_eps_safe():
    """Identical estimated and GT poses: the eps-safe norms keep the
    gradient finite (and 0)."""
    rng = np.random.default_rng(3)
    xi = torch.from_numpy(rng.normal(size=(4, 6)).astype(np.float32) * 0.1)
    from dpvo_tpu_torch.ops import lie
    gt = lie.se3_exp(xi)
    est = gt[None].repeat(2, 1, 1).requires_grad_(True)
    tr, ro, _ = tR.pose_loss_terms(est, gt)
    (tr.sum() + ro.sum()).backward()
    assert torch.isfinite(est.grad).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_kabsch_umeyama(seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(20, 3)).astype(np.float32)
    B = (A * 0.5 + rng.normal(size=(20, 3)) * 0.05).astype(np.float32)
    np.testing.assert_allclose(float(tR.kabsch_umeyama(t(A), t(B))),
                               float(jR.kabsch_umeyama(A, B)), rtol=1e-5)
    np.testing.assert_allclose(float(tR.kabsch_umeyama(t(A), t(A * 0.5))),
                               2.0, rtol=1e-4)
