"""The port's training entry point and data plane on CPU, against the JAX
package where both have the piece:

- ``save_network`` files load in ``dpvo_tpu.utils.checkpoint.load_network``
  as the flax trees of the modules (equal structure and values);
- ``init_flax_like`` draws each leaf from flax's initialiser's distribution;
- the Patchifier with GT disparities against the flax Patchifier;
- a resumed training step equals an uninterrupted one, bit for bit;
- ``compute_distance_matrix_flow`` / ``all_pairs_distance_matrix`` against
  the JAX package's (rtol 1e-4: fp32 induced flow, averaged);
- one TartanAir item of the synthetic scene of tests/test_e2e_data_eval.py
  through both packages' readers from one numpy seed, augmentation on;
- ``train_torch.train(config, device="cpu")`` for a few steps with
  validation on a held-out scene, a checkpoint written and read back, a
  run resumed from its state file, and ``train_torch.main`` (a YAML
  config through ``load_train_config``) raising without a card unless
  ``--device cpu`` is given.
"""
import importlib.util
import json
import os.path as osp
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import test_e2e_data_eval as E
from dpvo_tpu.models.update import DIM, Update as JUpdate
from dpvo_tpu.models.vonet import Patchifier as JPatchifier
from dpvo_tpu_torch.models.update import Update as TUpdate
from dpvo_tpu_torch.models.vonet import Patchifier as TPatchifier
from dpvo_tpu_torch.models.vonet import init_flax_like
from dpvo_tpu_torch.parallel import train_step as tts
from dpvo_tpu_torch.utils import checkpoint as tck

torch.set_num_threads(1)


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        f"repo_{name}", osp.join(E._REPO, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flax_inits():
    key = jax.random.PRNGKey(0)
    p = JPatchifier(3).init(key, jnp.zeros((1, 64, 64, 3)),
                            jnp.zeros((1, 4, 2)))
    u = JUpdate(3).init(
        key, jnp.zeros((8, DIM)), jnp.zeros((8, DIM)),
        jnp.zeros((8, 2 * 49 * 9)), jnp.zeros((8,), jnp.int32),
        jnp.zeros((8,), jnp.int32), jnp.zeros((8,), jnp.int32))
    return p, u


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _seeded_modules(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return (init_flax_like(TPatchifier(3), gen),
            init_flax_like(TUpdate(3), gen))


def test_save_network_loads_in_jax(tmp_path):
    from dpvo_tpu.utils.checkpoint import load_network as jload
    patchifier, update_mod = _seeded_modules()
    path = str(tmp_path / "net.npz")
    tck.save_network(path, patchifier, update_mod)
    got = jload(path)
    for tree, flax_tree, module in zip(got, _flax_inits(),
                                       (patchifier, update_mod)):
        a, b = _flat(tree), _flat(flax_tree)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].shape == b[k].shape, k
        # and back through the port's reader: the same state dict
        back = tck.flax_to_state_dict(jax.tree.map(np.asarray, tree))
        for k, v in module.state_dict().items():
            np.testing.assert_array_equal(back[k].numpy(), v.numpy(),
                                          err_msg=k)
    p_sd, u_sd = tck.load_network(path)
    assert p_sd.keys() == patchifier.state_dict().keys()
    assert u_sd.keys() == update_mod.state_dict().keys()


def test_init_flax_like_matches_flax_distribution():
    """Kernels: lecun_normal's std within 10% on leaves of >= 4096
    elements; biases zero; LayerNorm scale one."""
    patchifier, update_mod = _seeded_modules(1)
    for flax_tree, module in zip(_flax_inits(), (patchifier, update_mod)):
        want = tck.flax_to_state_dict(jax.tree.map(np.asarray, flax_tree))
        got = module.state_dict()
        assert want.keys() == got.keys()
        for k, v in got.items():
            w = want[k].numpy()
            if k.endswith("bias") or w.ndim == 1:
                np.testing.assert_array_equal(v.numpy(), w, err_msg=k)
            elif w.size >= 4096:
                np.testing.assert_allclose(v.std().item(), w.std(),
                                           rtol=0.1, err_msg=k)
                assert np.abs(v.numpy()).max() <= np.abs(w).max() * 1.1, k


def test_patchifier_with_disps():
    rng = np.random.default_rng(2)
    img = (2.0 * rng.uniform(size=(2, 32, 48, 3)) - 0.5).astype(np.float32)
    coords = rng.uniform(1, 11, (2, 5, 2)).astype(np.float32)
    disps = rng.uniform(0.2, 2.0, (2, 8, 12)).astype(np.float32)
    jm = JPatchifier(3)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(img),
                     jnp.asarray(coords))
    want = jm.apply(params, jnp.asarray(img), jnp.asarray(coords),
                    disps=jnp.asarray(disps))
    tm = TPatchifier(3)
    tm.load_state_dict(tck.flax_to_state_dict(jax.tree.map(np.asarray,
                                                           params)))
    with torch.no_grad():
        got = tm(torch.tensor(img), torch.tensor(coords),
                 disps=torch.tensor(disps))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-4)


def _tiny_batch(seed, N=4, H=32, W=48, M=3, S=2):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (H, 2 * W, 3))
    images = np.stack([np.roll(base, -2 * t, axis=1)[:, :W]
                       for t in range(N)])[None].astype(np.float32)
    poses = np.zeros((1, N, 7), np.float32)
    poses[..., 6] = 1.0
    poses[..., 0] = np.arange(N) * 0.05
    disps = rng.uniform(0.4, 0.6, (1, N, H, W)).astype(np.float32)
    intr = np.tile(np.float32([40.0, 40.0, W / 2, H / 2]), (1, N, 1))
    batch = _load_script("train_torch").prepare_batch(
        rng, images, poses, disps, intr, M, S)
    return {k: (v if k.startswith("sch_") else torch.tensor(v))
            for k, v in batch.items()}


def _tiny_state(seed):
    patchifier, update_mod = _seeded_modules(seed)
    opt = tts.make_optimizer(tts.train_params(patchifier, update_mod), 1e-3,
                             10, scheduler="onecycle", pct_start=0.2)
    return tts.TrainState(patchifier, update_mod, opt)


def test_train_state_round_trip(tmp_path):
    """Two steps in one run equal one step, a save, a fresh state (other
    weights) loaded from the file, and the second step."""
    step = tts.make_train_step(steps=2, M=3)
    b1, b2 = _tiny_batch(1), _tiny_batch(2)
    a = _tiny_state(0)
    step(a, b1)
    path = str(tmp_path / "state.npz")
    tck.save_train_state(path, a)
    step(a, b2)
    r = tck.load_train_state(path, _tiny_state(5))
    assert r.step == 1 and r.opt.count == 1
    step(r, b2)
    for x, y in zip(tts.train_params(a.patchifier, a.update),
                    tts.train_params(r.patchifier, r.update)):
        np.testing.assert_array_equal(x.detach().numpy(),
                                      y.detach().numpy())
    sa, sr = a.opt.state_dict(), r.opt.state_dict()
    assert sa["count"] == sr["count"] == 2
    for x, y in zip(sa["mu"] + sa["nu"], sr["mu"] + sr["nu"]):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    other = _tiny_state(0)
    del other.update.w                     # a parameter set that differs
    with pytest.raises(ValueError):
        tck.load_train_state(path, other)


def test_distance_matrices_match_jax():
    from dpvo_tpu.data import rgbd_utils as jr
    from dpvo_tpu.ops import lie as jlie
    from dpvo_tpu_torch.data import rgbd_utils as tr
    rng = np.random.default_rng(3)
    N = 9
    xi = rng.normal(size=(N, 6)).astype(np.float32) * 0.05
    xi[:, 0] += np.arange(N) * 0.2
    poses = np.asarray(jlie.se3_exp(jnp.asarray(xi)))
    disps = rng.uniform(0.1, 1.0, (N, 6, 8)).astype(np.float32)
    intr = np.float32([8.0, 8.0, 4.0, 3.0])
    want = jr.compute_distance_matrix_flow(poses, disps, intr,
                                           batch_pairs=32)
    got = tr.compute_distance_matrix_flow(poses, disps, intr,
                                          batch_pairs=32, device="cpu")
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    assert fin.sum() > N
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-4)
    np.testing.assert_allclose(
        tr.all_pairs_distance_matrix(poses, device="cpu"),
        jr.all_pairs_distance_matrix(poses), rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The geometrically consistent training scene of
    tests/test_train_smoke.py, and a copy named into the held-out split."""
    root = str(tmp_path_factory.mktemp("tartan_torch"))
    scene = E._make_scene(root, step=5 * 2 * 2.0 / 320.0)
    held = osp.join(root, "abandonedfactory", "abandonedfactory", "Easy",
                    "P011")
    shutil.copytree(scene, held)
    return root, scene


def test_tartan_item_matches_jax(scenes, tmp_path):
    from dpvo_tpu.data.tartan import TartanAir as JTartan
    from dpvo_tpu_torch.data.tartan import TartanAir as TTartan
    root, scene = scenes
    kw = dict(mode="training", datapath=root, n_frames=4,
              crop_size=(48, 64), aug=True)
    dj = JTartan(cache_dir=str(tmp_path / "j"), **kw)
    dt = TTartan(cache_dir=str(tmp_path / "t"), device="cpu", **kw)
    assert dj.dataset_index == dt.dataset_index and len(dt) > 0
    gj, gt = dj.scene_info[scene]["graph"], dt.scene_info[scene]["graph"]
    for i in gj:
        np.testing.assert_array_equal(gt[i][0], gj[i][0])
        np.testing.assert_allclose(gt[i][1], gj[i][1], rtol=1e-4)
    for idx in (0, 3):
        np.random.seed(idx)
        want = dj[idx]
        np.random.seed(idx)
        got = dt[idx]
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-4)


def _config(root, tmp_path, **training):
    return {
        "dataset": {"names": ["tartan"], "roots": [root], "n_frames": 5,
                    "fmin": 8.0, "fmax": 100.0, "crop_size": [48, 64],
                    "aug": False, "cache_dir": str(tmp_path / "cache")},
        "training": dict({"steps": 4, "iters": 3, "M": 4, "batch_size": 1,
                          "lr": 1e-3, "weight_decay": 1e-5, "clip": 10.0,
                          "amp": False, "structure_warmup": 1,
                          "save_freq": 2, "name": "smoke"}, **training),
        "scheduler": {"type": "constant"},
        "loss": {"flow_weight": 0.1, "pose_weight": 10.0},
        "dataloader": {"num_workers": 0, "prefetch": 2},
        "validation": {"enabled": True, "freq": 2, "n_samples": 1},
    }


def test_train_torch_cpu_and_resume(scenes, tmp_path, monkeypatch):
    import yaml
    from dpvo_tpu.utils.checkpoint import load_network as jload
    from dpvo_tpu_torch.utils import logger as L
    train_torch = _load_script("train_torch")
    root, _ = scenes
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(L, "SUM_FREQ", 1)
    state = train_torch.train(_config(root, tmp_path), device="cpu")
    assert state.step == 4
    for s in (2, 4):
        assert osp.isfile(f"checkpoints/smoke_{s:06d}.npz")
        assert osp.isfile(f"checkpoints/smoke_{s:06d}_state.npz")
    with open("runs/smoke/metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    losses = [r["loss"] for r in recs if "loss" in r]
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert all(r["gnorm"] > 0 for r in recs if "gnorm" in r)
    assert [r["step"] for r in recs if "val/ate_mean" in r] == [2, 4]
    p, u = jload("checkpoints/smoke_000004.npz")
    assert len(jax.tree_util.tree_leaves(p)) > 10
    final = state.update.state_dict()
    for k, v in tck.load_network("checkpoints/smoke_000004.npz")[1].items():
        np.testing.assert_array_equal(v.numpy(), final[k].numpy(), err_msg=k)

    cfg = _config(root, tmp_path, steps=3,
                  resume="checkpoints/smoke_000002_state.npz")
    resumed = train_torch.train(cfg, device="cpu")
    assert resumed.step == 3 and resumed.opt.count == 3
    with open("runs/smoke/metrics.jsonl") as f:
        n_recs = sum("loss" in json.loads(line) for line in f)
    assert n_recs == 5                  # one more step: 2 -> 3
    with open("resume.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    if not torch.cuda.is_available():
        # the entry point runs on the card unless told otherwise
        with pytest.raises(RuntimeError, match="CUDA"):
            train_torch.main(["resume.yaml"])
