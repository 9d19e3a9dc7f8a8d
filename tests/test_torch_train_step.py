"""The port's optimizer, schedules and whole training step against the JAX
package's on CPU.

- Every schedule of ``make_optimizer`` against optax's at many steps
  (rtol 1e-5: the port evaluates them in float64, optax in float32, whose
  cosine loses digits to cancellation at the end of its decay).
- Two clip + AdamW steps against ``optax.chain(clip_by_global_norm,
  adamw)`` on the same gradients, one clipped and one not (rtol 1e-5:
  the same fp32 arithmetic in another order).
- ``train_torch.prepare_batch`` against ``train.py``'s: equal arrays from
  one numpy seed.
- A structure-only step, then a full step, then an eval step, against the
  JAX package's ``make_train_step`` / ``make_eval_step`` with amp off, on
  the same flax-initialised weights (N=5 frames of 32x48, M=4, 3 rollout
  steps, batch 2).  Loss and metrics rtol 2e-2 and gnorm rtol 2e-2: the
  three-step rollout gradient is ill-conditioned (ROADMAP.md Queue 3: the
  JAX package's own moves by about 1% of each leaf when the initial depths
  move by 3e-6 of themselves).  Parameters after the two steps: per leaf,
  the update |dp_port - dp_jax| / |dp_jax| (L2) within 0.1; Adam's first
  updates are lr * g / |g| elementwise, so elements whose gradient is at
  the rounding level move by a full learning rate in either direction
  (a leaf's reference is at least a tenth of a learning rate per element).
  The fnet convolutions' biases that an instance norm follows are left
  out: their exact gradient is 0, and Adam turns both sides' rounding
  noise into full-size steps.
"""
import importlib.util
import os.path as osp

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from dpvo_tpu.models.update import DIM, Update as JUpdate
from dpvo_tpu.models.vonet import Patchifier as JPatchifier
from dpvo_tpu.parallel import train_step as jts
from dpvo_tpu_torch.models.update import Update as TUpdate
from dpvo_tpu_torch.models.vonet import Patchifier as TPatchifier
from dpvo_tpu_torch.parallel import train_step as tts
from dpvo_tpu_torch.utils.checkpoint import params_from_jax

torch.set_num_threads(1)
ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
B, N, H, W, M, S = 2, 5, 32, 48, 4, 3


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"repo_{name}", osp.join(ROOT, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("scheduler,steps,lr,pct", [
    ("onecycle", 1000, 8e-5, 0.01), ("onecycle", 240000, 8e-5, 0.01),
    ("onecycle", 50, 1e-3, 0.3), ("cosine", 1000, 8e-5, 0.01),
    ("step", 999, 1e-4, 0.01), ("constant", 10, 3e-4, 0.01)])
def test_schedules_match_optax(scheduler, steps, lr, pct):
    """The learning rate at every step up to ``steps`` and past it."""
    want = {
        "onecycle": lambda: optax.linear_onecycle_schedule(
            transition_steps=steps, peak_value=lr, pct_start=pct,
            pct_final=1.0, div_factor=25.0, final_div_factor=1e4),
        "cosine": lambda: optax.cosine_decay_schedule(lr, steps,
                                                      alpha=1e-7 / lr),
        "step": lambda: optax.piecewise_constant_schedule(
            lr, {steps // 3: 0.1, 2 * steps // 3: 0.1}),
        "constant": lambda: (lambda c: lr),
    }[scheduler]()
    got = tts.make_schedule(lr, steps, scheduler, pct)
    counts = np.unique(np.concatenate([
        np.arange(0, min(steps, 3000) + 5),
        np.linspace(0, steps + 10, 500).astype(int)]))
    np.testing.assert_allclose([got(int(c)) for c in counts],
                               [float(want(int(c))) for c in counts],
                               rtol=1e-5, atol=1e-12)


def test_onecycle_values():
    """T=1000, peak 8e-5, pct_start 0.01: one ramp up, one ramp down."""
    s = tts.make_schedule(8e-5, 1000)
    np.testing.assert_allclose([s(0), s(10), s(500), s(1000), s(5000)],
                               [3.2e-6, 8e-5, 4.0408e-5, 8e-9, 8e-9],
                               rtol=1e-9)
    with pytest.raises(ValueError):
        tts.make_schedule(1e-3, 10, "linear")


@pytest.mark.parametrize("clip", [10.0, 0.5])
def test_adamw_clip_matches_optax(clip):
    """Two steps on the same gradients; with clip 0.5 both are clipped."""
    rng = np.random.default_rng(0)
    shapes = [(7, 3), (5,), (2, 2, 3)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes]
             for _ in range(2)]
    tx = jts.make_optimizer(1e-2, 100, weight_decay=1e-2, clip=clip,
                            scheduler="onecycle", pct_start=0.1)
    jp = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jp)
    tp = [torch.tensor(p) for p in params]
    opt = tts.make_optimizer(tp, 1e-2, 100, weight_decay=1e-2, clip=clip,
                             scheduler="onecycle", pct_start=0.1)
    for g in grads:
        jg = [jnp.asarray(x) for x in g]
        upd, opt_state = tx.update(jg, opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(tp, g):
            p.grad = torch.tensor(x)
        gnorm = opt.step()
        np.testing.assert_allclose(float(gnorm),
                                   float(optax.global_norm(jg)), rtol=1e-6)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-7)


def _images(rng):
    """Two textured 5-frame clips rolled 2 px per frame, uint8 range."""
    base = rng.uniform(0, 255, size=(B, H, W * 2, 3))
    return np.stack([np.stack([np.roll(base[b], -2 * t, axis=1)[:, :W]
                               for t in range(N)]) for b in range(B)])


def _raw_batch(seed):
    rng = np.random.default_rng(seed)
    poses = np.zeros((B, N, 7), np.float32)
    poses[..., 6] = 1.0
    poses[..., 0] = np.arange(N) * 0.05
    disps = rng.uniform(0.4, 0.6, (B, N, H, W)).astype(np.float32)
    intr = np.tile(np.float32([40.0, 40.0, W / 2, H / 2]), (B, N, 1))
    return _images(rng).astype(np.float32), poses, disps, intr


def test_prepare_batch_matches_train_py():
    want = _load("train").prepare_batch(np.random.default_rng(3),
                                        *_raw_batch(1), M, S)
    got = _load("train_torch").prepare_batch(np.random.default_rng(3),
                                             *_raw_batch(1), M, S)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)


@pytest.fixture(scope="module")
def both_steps():
    """One JAX run: a structure-only step, a full step, an eval step; and
    the port's modules built from the same initial weights."""
    key = jax.random.PRNGKey(0)
    jp_mod, ju_mod = JPatchifier(3, dtype=jnp.float32), JUpdate(
        3, dtype=jnp.float32)
    p_params = jp_mod.init(key, jnp.zeros((1, 64, 64, 3)),
                           jnp.zeros((1, 4, 2)))
    u_params = ju_mod.init(
        key, jnp.zeros((8, DIM)), jnp.zeros((8, DIM)),
        jnp.zeros((8, 2 * 49 * 9)), jnp.zeros((8,), jnp.int32),
        jnp.zeros((8,), jnp.int32), jnp.zeros((8,), jnp.int32))
    params0 = {"patchify": p_params, "update": u_params}
    # the step donates its state: keep the initial weights on the host
    to_np = jax.tree.map(np.asarray, (p_params, u_params))
    tx = jts.make_optimizer(1e-4, 100, weight_decay=1e-6, clip=10.0)
    state = jts.TrainState(params0, tx.init(params0), jnp.int32(0))
    prep = _load("train_torch").prepare_batch
    batches = [prep(np.random.default_rng(s), *_raw_batch(s), M, S)
               for s in (10, 11, 12)]
    metrics = []
    for so, batch in zip((True, False), batches):
        step = jts.make_train_step(jp_mod, ju_mod, tx, steps=S, M=M,
                                   structure_only=so)
        state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        metrics.append(jax.tree.map(float, m))
    est, em = jts.make_eval_step(jp_mod, ju_mod, steps=S, M=M)(
        state.params, {k: jnp.asarray(v) for k, v in batches[2].items()})
    after = jax.tree.map(np.asarray, (state.params["patchify"],
                                      state.params["update"]))
    return dict(batches=batches, metrics=metrics, params0=to_np,
                params2=after, est=np.asarray(est),
                eval_metrics=jax.tree.map(float, em))


def test_train_and_eval_steps_match(both_steps):
    p_sd, u_sd = params_from_jax(*both_steps["params0"])
    patchifier, update_mod = TPatchifier(3), TUpdate(3)
    patchifier.load_state_dict(p_sd)
    update_mod.load_state_dict(u_sd)
    opt = tts.make_optimizer(tts.train_params(patchifier, update_mod), 1e-4,
                             100, weight_decay=1e-6, clip=10.0)
    state = tts.TrainState(patchifier, update_mod, opt)
    to_t = lambda b: {k: (v if k.startswith("sch_") else torch.tensor(v))
                      for k, v in b.items()}
    for i, so in enumerate((True, False)):
        step = tts.make_train_step(steps=S, M=M, structure_only=so)
        state, m = step(state, to_t(both_steps["batches"][i]))
        want = both_steps["metrics"][i]
        assert set(m) == set(want)
        for k in want:
            np.testing.assert_allclose(float(m[k]), want[k], rtol=2e-2,
                                       atol=1e-5, err_msg=f"step {i} {k}")
    assert state.step == 2
    w_p, w_u = params_from_jax(*both_steps["params2"])
    p0, u0 = params_from_jax(*both_steps["params0"])
    lr_sum = sum(opt.schedule(i) for i in range(2))
    bad = []
    for mod, want, before in ((patchifier, w_p, p0), (update_mod, w_u, u0)):
        for k, v in mod.state_dict().items():
            if k.startswith("fnet.") and k.endswith(".bias") and k != (
                    "fnet.conv2.bias"):
                continue       # an instance norm follows: exact gradient 0
            d_got, d_want = v - before[k], want[k] - before[k]
            err = float(torch.linalg.norm(d_got - d_want))
            floor = 0.1 * lr_sum * v.numel() ** 0.5
            ref = max(float(torch.linalg.norm(d_want)), floor)
            if err > 0.1 * ref:
                bad.append(k)
    assert not bad, bad

    est, em = tts.make_eval_step(steps=S, M=M)(state,
                                               to_t(both_steps["batches"][2]))
    assert est.shape == both_steps["est"].shape == (B, S, N, 7)
    assert set(em) == set(both_steps["eval_metrics"])
    for k, v in both_steps["eval_metrics"].items():
        np.testing.assert_allclose(float(em[k]), v, rtol=2e-2, atol=1e-5,
                                   err_msg=k)
