"""The port's training ops against the JAX package's on CPU: the segment
reductions, the gradient-surgery ops, SoftAgg's and Update's scatter path,
``transform(jacobian=True)`` and the DROID ops, the training correlation,
``ba_differentiable`` and the rollout schedule.  Values and gradients (the
port's autograd against ``jax.vjp`` / ``jax.grad`` on the same cotangents).

Tolerances (fp32): values atol 2e-4 where tests/test_torch_models.py holds
the network to it, 1e-5 for elementwise ops; a gradient holds 1e-4 of the
largest magnitude of its JAX counterpart (``rel``), BA's 1e-3 (a Cholesky
solve of a 30x30 damped system, fp32).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dpvo_tpu.models import blocks as jblocks, update as jupd
from dpvo_tpu.ops import ba as jba, corr as jcorr, lie as jlie
from dpvo_tpu.ops import projective as jpops, scatter as jscatter
from dpvo_tpu.training import rollout as jR
from dpvo_tpu_torch.models import blocks as tblocks, update as tupd
from dpvo_tpu_torch.ops import ba as tba, corr as tcorr
from dpvo_tpu_torch.ops import projective as tpops, scatter as tscatter
from dpvo_tpu_torch.training import rollout as tR
from dpvo_tpu_torch.utils.checkpoint import flax_to_state_dict
from test_ba import KEY as BA_KEY, build_problem

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(5)
ATOL = 2e-4


def t(a, grad=False):
    x = torch.from_numpy(np.array(a))
    return x.requires_grad_(True) if grad else x


def close_rel(got, want, rel, name="", floor=0.0):
    """max|got - want| <= rel * max(max|want|, floor).  ``floor`` holds a
    leaf whose exact gradient is 0 (SoftAgg's ``g`` bias: the softmax is
    invariant to it) to a share of the largest leaf's magnitude."""
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    assert err <= rel * max(scale, floor) + 1e-12, (name, err, scale)


def close_trees(gt, gw, rel):
    """Leaf by leaf; a leaf's floor is 1e-2 of the largest leaf's max."""
    assert gw.keys() == gt.keys()
    top = max(float(np.max(np.abs(np.asarray(v)))) for v in gw.values())
    for k in gw:
        close_rel(gt[k], gw[k], rel, k, floor=1e-2 * top)


def torch_grads(module):
    return {n: p.grad for n, p in module.named_parameters()}


def jax_grads(tree):
    return flax_to_state_dict(jax.tree.map(np.asarray, tree))


# --- segment reductions -----------------------------------------------------

@pytest.mark.parametrize("op", ["scatter_sum", "scatter_mean", "scatter_max",
                                "scatter_softmax"])
def test_scatter_ops(op):
    """Values and gradients, with empty segments (5 and 8 of 9)."""
    rng = np.random.default_rng(0)
    E, D, S = 40, 6, 9
    idx = rng.integers(0, 5, E).astype(np.int32)
    idx[:3] = 6
    src = rng.normal(size=(E, D)).astype(np.float32)
    jf, tf = getattr(jscatter, op), getattr(tscatter, op)
    want, vjp = jax.vjp(lambda x: jf(x, jnp.asarray(idx), S),
                        jnp.asarray(src))
    x = t(src, grad=True)
    got = tf(x, t(idx).long(), S)
    if op == "scatter_max":
        # empty segments: -inf on both sides
        np.testing.assert_array_equal(np.isinf(got.detach().numpy()),
                                      np.isinf(np.asarray(want)))
        want = jnp.where(jnp.isinf(want), 0.0, want)
        got = torch.where(torch.isinf(got), 0.0, got)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    cot = rng.normal(size=want.shape).astype(np.float32)
    (g_want,) = vjp(jnp.asarray(cot))
    got.backward(t(cot))
    close_rel(x.grad, g_want, 1e-5, op)


def test_scatter_softmax_empty_segment_shift():
    """A segment with no rows shifts by 0, not -inf: the rows of the other
    segments still sum to one."""
    idx = torch.tensor([0, 0, 2, 2, 2])
    w = tscatter.scatter_softmax(torch.randn(5, 3), idx, 4)
    sums = tscatter.scatter_sum(w, idx, 4)
    np.testing.assert_allclose(sums[[0, 2]].numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(sums[[1, 3]].numpy(), 0.0)


# --- gradient surgery -------------------------------------------------------

@pytest.mark.parametrize("name", ["grad_clip", "grad_zero", "grad_mag"])
def test_grad_ops(name, capsys):
    """Identity forward; backward against jax.vjp of the custom_vjp, on a
    cotangent with NaNs and entries on both sides of each threshold."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(50,)).astype(np.float32)
    cot = (rng.normal(size=(50,)) * 0.1).astype(np.float32)
    cot[:5] = np.nan
    cot[5:10] = [0.005, -0.005, 0.09, -0.2, 0.3]
    jf, tf = getattr(jblocks, name), getattr(tblocks, name)
    want, vjp = jax.vjp(jf, jnp.asarray(x))
    xt = t(x, grad=True)
    got = tf(xt)
    np.testing.assert_array_equal(got.detach().numpy(), x)
    if name == "grad_mag":
        cot = np.nan_to_num(cot)                   # printed mean is finite
    (g_want,) = vjp(jnp.asarray(cot))
    got.backward(t(cot))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(g_want))
    if name == "grad_mag":
        out = capsys.readouterr().out
        assert out.startswith("grad_mag: ")
        np.testing.assert_allclose(float(out.split()[-1]),
                                   np.abs(cot).mean(), rtol=1e-5)


# --- SoftAgg and Update, scatter path ---------------------------------------

def test_softagg_scatter_path():
    """SoftAgg with group ids and a validity mask (the trash group): output
    and every parameter gradient."""
    rng = np.random.default_rng(2)
    E, D, G = 60, 16, 12
    jx = rng.integers(0, G, E).astype(np.int32)
    valid = rng.random(E) > 0.2
    x = rng.normal(size=(E, D)).astype(np.float32)
    cot = rng.normal(size=(E, D)).astype(np.float32)
    jm = jblocks.SoftAgg(D)
    args = (jnp.asarray(x), jnp.asarray(jx), G, jnp.asarray(valid))
    params = jm.init(KEY, *args)
    want = jm.apply(params, *args)
    g_want = jax.grad(lambda p: jnp.sum(jm.apply(p, *args) * cot))(params)
    tm = tblocks.SoftAgg(D)
    tm.load_state_dict(jax_grads(params))
    got = tm(t(x), t(jx).long(), G, t(valid))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL)
    (got * t(cot)).sum().backward()
    close_trees(torch_grads(tm), jax_grads(g_want), 1e-4)


def _update_inputs(seed, E=48):
    rng = np.random.default_rng(seed)
    ii = rng.integers(0, 6, E).astype(np.int32)
    jj = (ii + rng.integers(-2, 3, E)).astype(np.int32)
    kk = (ii * 4 + rng.integers(0, 4, E)).astype(np.int32)
    valid = np.ones(E, bool)
    valid[-5:] = False
    net = rng.normal(size=(E, jupd.DIM)).astype(np.float32)
    inp = rng.normal(size=(E, jupd.DIM)).astype(np.float32)
    corr = rng.normal(size=(E, 882)).astype(np.float32)
    cots = [rng.normal(size=s).astype(np.float32)
            for s in ((E, jupd.DIM), (E, 2), (E, 2))]
    return (net, inp, corr, ii, jj, kk, valid), cots


@pytest.mark.parametrize("seed", [3, 4])
def test_update_scatter_path_gradients(seed):
    """Update with no metadata (the rollout's call): outputs and every
    parameter gradient, through grad_clip on the d and w heads (the
    cotangents are large enough that the clip is active)."""
    args, cots = _update_inputs(seed)
    jm = jupd.Update(3)
    jargs = tuple(map(jnp.asarray, args))
    params = jm.init(KEY, *jargs)

    def jloss(p):
        outs = jm.apply(p, *jargs)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots))

    want = jm.apply(params, *jargs)
    g_want = jax.grad(jloss)(params)
    tm = tupd.Update(3)
    tm.load_state_dict(jax_grads(params))
    got = tm(*map(t, args))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=ATOL)
    sum((o * t(c)).sum() for o, c in zip(got, cots)).backward()
    close_trees(torch_grads(tm), jax_grads(g_want), 1e-3)


# --- projective ops ---------------------------------------------------------

def test_transform_jacobian():
    poses, patches, _, intr_f, _, ii, jj, kk = build_problem(BA_KEY)
    want = jpops.transform(poses, patches, intr_f, ii, jj, kk, jacobian=True)
    got = tpops.transform(*map(t, (poses, patches, intr_f, ii, jj, kk)),
                          jacobian=True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-3, rtol=1e-5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for a, b in zip(got[2], want[2]):
        close_rel(a, b, 1e-5)


def _droid_inputs():
    rng = np.random.default_rng(4)
    N, H, W = 4, 12, 16
    xi = rng.normal(size=(N, 6)).astype(np.float32) * 0.05
    xi[:, 0] += np.arange(N) * 0.1
    poses = np.asarray(jlie.se3_exp(jnp.asarray(xi)))
    disps = rng.uniform(0.2, 1.0, (N, H, W)).astype(np.float32)
    disps[0, :2] = 0.0                                # points at infinity
    intr = np.tile(np.float32([[14.0, 14.0, 8.0, 6.0]]), (N, 1))
    ii, jj = [a.reshape(-1).astype(np.int32)
              for a in np.meshgrid(np.arange(N), np.arange(N))]
    return poses, disps, intr, ii, jj


@pytest.mark.parametrize("op", ["iproj_droid", "proj_droid",
                                "projective_transform", "induced_flow"])
def test_droid_ops(op):
    poses, disps, intr, ii, jj = _droid_inputs()
    if op == "iproj_droid":
        want = [jpops.iproj_droid(disps, intr)]
        got = [tpops.iproj_droid(t(disps), t(intr))]
    elif op == "proj_droid":
        X = np.array(jpops.iproj_droid(disps, intr))
        X[..., 2] = np.linspace(-0.5, 2.0, X[..., 2].size).reshape(
            X[..., 2].shape)                          # Z below MIN_DEPTH / 2
        want = [jpops.proj_droid(X, intr, return_depth=True)]
        got = [tpops.proj_droid(t(X), t(intr), return_depth=True)]
    else:
        want = getattr(jpops, op)(poses, disps, intr, ii, jj)
        got = getattr(tpops, op)(*map(t, (poses, disps, intr, ii, jj)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-5)


# --- the training correlation -----------------------------------------------

@pytest.mark.parametrize("pad", [0, 3])
def test_corr_values_and_gradients(pad):
    """The port's correlation (the rollout's) against the JAX package's
    ``corr`` (which the JAX rollout calls): values, and gradients wrt gmap,
    fmap and coords, with taps off every edge of the map; on an unpadded
    map and on one with a zero border."""
    rng = np.random.default_rng(5)
    K, N, h, w, C, E = 10, 3, 9, 13, 16, 30
    gmap = rng.normal(size=(K, 3, 3, C)).astype(np.float32)
    fmap = np.pad(rng.normal(size=(N, h, w, C)).astype(np.float32),
                  ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    coords = np.stack([rng.uniform(-3, w + 3, (E, 3, 3)),
                       rng.uniform(-3, h + 3, (E, 3, 3))],
                      axis=1).astype(np.float32)
    kidx = rng.integers(0, K, E).astype(np.int32)
    fidx = rng.integers(0, N, E).astype(np.int32)
    want, vjp = jax.vjp(
        lambda g, f, c: jcorr.corr(g, f, c, jnp.asarray(kidx),
                                   jnp.asarray(fidx), 3, pad=pad),
        *map(jnp.asarray, (gmap, fmap, coords)))
    xs = [t(a, grad=True) for a in (gmap, fmap, coords)]
    got = tcorr.corr(*xs, t(kidx), t(fidx), 3, pad=pad)
    assert got.shape == want.shape == (E, 7, 7, 3, 3)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4)
    cot = rng.normal(size=want.shape).astype(np.float32)
    g_want = vjp(jnp.asarray(cot))
    got.backward(t(cot))
    for x, g, name in zip(xs, g_want, ("gmap", "fmap", "coords")):
        close_rel(x.grad, g, 1e-5, name)


# --- differentiable BA ------------------------------------------------------

@pytest.mark.parametrize("structure_only", [False, True])
def test_ba_differentiable(structure_only):
    """Forward (poses atol 1e-4, depths 3e-4 as tests/test_torch_ba.py) and
    the gradients of a loss of the outputs wrt targets and weights, with
    perturbed poses and depths, 7 invalid edges and k_cap > unique
    patches."""
    poses_gt, patches_gt, _, intr_f, target, ii, jj, kk = build_problem(
        BA_KEY, n_frames=5, patches_per_frame=8)
    n, E = poses_gt.shape[0], ii.shape[0]
    poses0 = jlie.se3_retr(poses_gt, (jax.random.normal(
        jax.random.PRNGKey(6), (n, 6)) * 0.02).at[0].set(0.0))
    patches0 = patches_gt.at[:, 2].multiply(1.1)
    rng = np.random.default_rng(6)
    targets = np.asarray(target) + rng.normal(size=(E, 2)).astype(
        np.float32)
    weights = rng.uniform(0.1, 1.0, (E, 2)).astype(np.float32)
    valid = np.arange(E) < E - 7
    bounds = (-64.0, -64.0, 224.0, 184.0)
    cp = rng.normal(size=(n, 7)).astype(np.float32)
    cz = rng.normal(size=patches_gt.shape).astype(np.float32)

    def jf(tg, wt):
        return jba.ba_differentiable(
            poses0, patches0, intr_f, tg, wt, 1e-4, ii, jj, kk,
            jnp.asarray(valid), jnp.asarray(bounds), ep=10.0, fixedp=1,
            structure_only=structure_only, k_cap=64)

    (p_w, z_w), vjp = jax.vjp(jf, jnp.asarray(targets), jnp.asarray(weights))
    g_tg, g_wt = vjp((jnp.asarray(cp), jnp.asarray(cz)))
    tg, wt = t(targets, grad=True), t(weights, grad=True)
    p_g, z_g = tba.ba_differentiable(
        *map(t, (poses0, patches0, intr_f)), tg, wt, 1e-4,
        *map(t, (ii, jj, kk, valid)), bounds, ep=10.0, fixedp=1,
        structure_only=structure_only, k_cap=64)
    np.testing.assert_allclose(p_g.detach().numpy(), np.asarray(p_w),
                               atol=1e-4)
    np.testing.assert_allclose(z_g.detach().numpy(), np.asarray(z_w),
                               atol=3e-4)
    ((p_g * t(cp)).sum() + (z_g * t(cz)).sum()).backward()
    close_rel(tg.grad, g_tg, 1e-3, "targets")
    close_rel(wt.grad, g_wt, 1e-3, "weights")
    assert float(tg.grad.abs().sum()) > 0


def test_ba_differentiable_failed_solve_is_skipped():
    """A non-finite solve (NaN weights) leaves poses and depths unchanged,
    as cho_factor's failure does in the JAX package."""
    poses, patches, _, intr_f, target, ii, jj, kk = map(
        t, build_problem(BA_KEY, n_frames=4, patches_per_frame=4))
    E = ii.shape[0]
    w = torch.full((E, 2), float("nan"))
    p1, z1 = tba.ba_differentiable(poses, patches, intr_f, target, w, 1e-4,
                                   ii, jj, kk, torch.ones(E, dtype=bool),
                                   (-64.0, -64.0, 224.0, 184.0), k_cap=32)
    np.testing.assert_array_equal(p1.numpy(), poses.numpy())
    np.testing.assert_array_equal(z1.numpy(), patches.numpy())


# --- the rollout schedule ---------------------------------------------------

@pytest.mark.parametrize("n_frames,M,steps", [(5, 4, 3), (15, 2, 18),
                                              (12, 3, 12)])
def test_build_schedule_matches(n_frames, M, steps):
    """Equal arrays from the same numpy seed (dropout draws included), and
    the same padding."""
    a = jR.build_schedule(n_frames, M, steps, np.random.default_rng(9))
    b = tR.build_schedule(n_frames, M, steps, np.random.default_rng(9))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    cap = len(a.ii) + 5
    for x, y in zip(jR.pad_schedule(a, cap), tR.pad_schedule(b, cap)):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError):
        tR.pad_schedule(b, len(b.ii) - 1)


def test_full_width_schedule_edges():
    """The full-width rollout (15 frames, M=80, 18 steps) has 18000 edge
    slots; 5120 are live at step 0."""
    sch = tR.build_schedule(15, 80, 18, np.random.default_rng(0),
                            dropout_p=0.0)
    assert len(sch.ii) == 18000
    assert int(sch.active[0].sum()) == 8 * 80 * 8 == 5120


# --- float64 gradients of the Lie ops ---------------------------------------

@pytest.mark.parametrize("op", ["se3_exp", "se3_log", "se3_inv", "se3_mul",
                                "se3_act4", "se3_adjT", "se3_retr",
                                "se3_scale"])
def test_lie_gradcheck_float64(op):
    """``torch.autograd.gradcheck`` in float64 (the Lie ops keep float64
    inputs in float64), at poses away from the small-angle branches."""
    from dpvo_tpu_torch.ops import lie
    rng = np.random.default_rng(7)
    xi = torch.tensor(rng.normal(size=(4, 6)) * 0.5, dtype=torch.float64)
    g = lie.se3_exp(xi).detach()
    v = torch.tensor(rng.normal(size=(4, 6)), dtype=torch.float64)
    p4 = torch.tensor(rng.normal(size=(4, 4)), dtype=torch.float64)
    args = {"se3_exp": (xi,), "se3_log": (g,), "se3_inv": (g,),
            "se3_mul": (g, lie.se3_exp(v * 0.3).detach()),
            "se3_act4": (g, p4), "se3_adjT": (g, v), "se3_retr": (g, v * 0.1),
            "se3_scale": (g, torch.tensor(rng.uniform(0.5, 2, 4)))}[op]
    args = tuple(a.clone().requires_grad_(True) for a in args)
    assert torch.autograd.gradcheck(getattr(lie, op), args, eps=1e-6,
                                    atol=1e-6)
