"""The port's Redwood reader (``dpvo_tpu_torch.data.redwood``) against the
JAX package's on the synthetic on-disk tree of tests/test_redwood_data.py
(JPEG images, uint16 millimetre depth PNGs, a column-major PoseGraph JSON,
``intrinsic.npy``):

- both readers index the same samples and build the same scene_info:
  file lists, poses and intrinsics equal, the co-visibility graph's frame
  lists equal and its flows within rtol 1e-4 (fp32 induced flow, as
  tests/test_torch_train_cli.py holds TartanAir's);
- a cache pickled by either reader loads in the other, and on one cache
  both give bitwise-equal samples from one numpy seed, augmentation on;
- ``dataset_factory(["redwood"])`` builds the reader;
- ``scripts/build_redwood_pickle_torch.py`` writes the strided pickle that
  ``scripts/build_redwood_pickle.py`` writes;
- ``train_torch.train`` runs a Redwood config with the cosine schedule
  from a ``.npz`` checkpoint written by ``save_network``.
"""
import importlib.util
import json
import os
import os.path as osp
import pickle
import shutil
import sys

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
pytest.importorskip("scipy")

import test_redwood_data as RD

torch.set_num_threads(1)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
KW = dict(mode="train", n_frames=4, crop_size=(48, 64))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("redwood_src"))
    RD._make_redwood_scene(root)
    return root


def _copy(tree, dst):
    """A fresh copy of the tree (the readers cache inside the root)."""
    shutil.copytree(tree, dst, ignore=shutil.ignore_patterns("cache"))
    return str(dst)


def _cache(root):
    return osp.join(root, "cache", "Redwood_train.pickle")


def _assert_scene_info_equal(got, want, graph_exact):
    assert list(got) == list(want)
    for scene in want:
        g, w = got[scene], want[scene]
        assert g["images"] == w["images"] and g["depths"] == w["depths"]
        np.testing.assert_array_equal(g["poses"], w["poses"])
        np.testing.assert_array_equal(np.stack(g["intrinsics"]),
                                      np.stack(w["intrinsics"]))
        assert list(g["graph"]) == list(w["graph"])
        for i in w["graph"]:
            np.testing.assert_array_equal(g["graph"][i][0], w["graph"][i][0])
            if graph_exact:
                np.testing.assert_array_equal(g["graph"][i][1],
                                              w["graph"][i][1])
            else:
                np.testing.assert_allclose(g["graph"][i][1],
                                           w["graph"][i][1], rtol=1e-4)


def test_scene_info_matches_jax(tree, tmp_path):
    from dpvo_tpu.data.redwood import Redwood as JRedwood
    from dpvo_tpu_torch.data.redwood import Redwood as TRedwood
    root = _copy(tree, tmp_path / "tree")
    dj = JRedwood(datapath=root, **KW)
    os.remove(_cache(root))             # the port builds its own
    dt = TRedwood(datapath=root, device="cpu", **KW)
    assert len(dt) > 0 and dt.dataset_index == dj.dataset_index
    info = dt.scene_info["train/scene01"]
    assert len(info["images"]) == RD.N_SYN
    np.testing.assert_allclose(info["poses"][:, 0],
                               RD.STEP * np.arange(RD.N_SYN), atol=1e-5)
    _assert_scene_info_equal(dt.scene_info, dj.scene_info, graph_exact=False)
    assert osp.isfile(_cache(dt.root))
    assert not TRedwood.is_test_scene("train/scene01")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cache_loads_across_packages_and_samples_match(tree, tmp_path,
                                                       writer):
    """One package writes the cache, the other loads it: equal scene_info
    bit for bit, and bitwise-equal samples (images, poses, disparities,
    intrinsics) from one numpy seed with augmentation on."""
    from dpvo_tpu.data.redwood import Redwood as JRedwood
    from dpvo_tpu_torch.data.redwood import Redwood as TRedwood
    root = _copy(tree, tmp_path / "tree")
    first = (JRedwood(datapath=root, **KW) if writer == "jax"
             else TRedwood(datapath=root, device="cpu", **KW))
    with open(_cache(root), "rb") as f:
        written = pickle.load(f)
    mtime = os.stat(_cache(root)).st_mtime_ns
    second = (TRedwood(datapath=root, device="cpu", **KW) if writer == "jax"
              else JRedwood(datapath=root, **KW))
    assert os.stat(_cache(root)).st_mtime_ns == mtime    # loaded, not built
    _assert_scene_info_equal(second.scene_info, written, graph_exact=True)
    dj, dt = (first, second) if writer == "jax" else (second, first)
    assert dt.dataset_index == dj.dataset_index
    for idx in (0, 2, 5):
        np.random.seed(idx)
        want = dj[idx]
        np.random.seed(idx)
        got = dt[idx]
        assert len(got) == len(want) == 4
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_factory_builds_redwood(tree, tmp_path):
    from dpvo_tpu_torch.data.factory import dataset_factory
    from dpvo_tpu_torch.data.redwood import Redwood
    db = dataset_factory(["redwood"], datapath=_copy(tree, tmp_path / "t"),
                         device="cpu", **KW)
    assert isinstance(db.datasets[0], Redwood) and len(db) > 0
    images, poses, disps, intrinsics = db[0]
    assert images.shape == (4, 48, 64, 3) and poses.shape == (4, 7)
    assert disps.shape == (4, 48, 64) and intrinsics.shape == (4, 4)
    assert np.isfinite(disps).all()


def _run_script(name, argv, monkeypatch):
    spec = importlib.util.spec_from_file_location(
        f"script_{name}", osp.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [name] + argv)
    mod.main()


def test_build_pickle_script_matches_jax(tree, tmp_path, monkeypatch):
    root = _copy(tree, tmp_path / "tree")
    built = {}
    for name, extra in (("build_redwood_pickle", []),
                        ("build_redwood_pickle_torch", ["--device", "cpu"])):
        _run_script(name, ["--root", root, "--stride", "2"] + extra,
                    monkeypatch)
        with open(_cache(root), "rb") as f:
            built[name] = pickle.load(f)
    got = built["build_redwood_pickle_torch"]
    want = built["build_redwood_pickle"]
    assert len(got["train/scene01"]["images"]) == RD.N_SYN // 2
    _assert_scene_info_equal(got, want, graph_exact=False)


def test_train_torch_runs_the_redwood_config(tree, tmp_path, monkeypatch):
    """``configs/redwood_train.yaml`` cut to toy size: the cosine schedule
    reaches ``cosine_schedule``, ``ckpt`` loads a ``save_network`` file, and
    with a checkpoint no step is structure-only (as in ``train.py``)."""
    from dpvo_tpu_torch.config import load_train_config
    from dpvo_tpu_torch.models.update import Update
    from dpvo_tpu_torch.models.vonet import Patchifier, init_flax_like
    from dpvo_tpu_torch.parallel import train_step as tts
    from dpvo_tpu_torch.utils.checkpoint import save_network
    spec = importlib.util.spec_from_file_location(
        "repo_train_torch", osp.join(REPO, "train_torch.py"))
    train_torch = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(train_torch)

    cfg = load_train_config(osp.join(REPO, "configs", "redwood_train.yaml"))
    assert cfg["dataset"]["names"] == ["redwood"]
    assert cfg["scheduler"]["type"] == "cosine"
    gen = torch.Generator().manual_seed(3)
    ckpt = str(tmp_path / "start.npz")
    save_network(ckpt, init_flax_like(Patchifier(3), gen),
                 init_flax_like(Update(3), gen))
    cfg["dataset"].update(roots=[_copy(tree, tmp_path / "t")], n_frames=4,
                          crop_size=[48, 64], aug=False)
    cfg["training"].update(steps=2, iters=3, M=4, amp=False, ckpt=ckpt,
                           save_freq=2, name="redwood_smoke")
    cfg["dataloader"].update(num_workers=0, prefetch=2)
    cfg["validation"]["enabled"] = False

    ran = []
    make_step = tts.make_train_step

    def spy(**kw):
        step = make_step(**kw)

        def counted(*args):
            ran.append(kw["structure_only"])
            return step(*args)
        return counted

    from dpvo_tpu_torch.utils import logger as L
    monkeypatch.setattr(L, "SUM_FREQ", 1)
    monkeypatch.setattr(train_torch, "make_train_step", spy)
    monkeypatch.chdir(tmp_path)
    state = train_torch.train(cfg, device="cpu")
    assert state.step == 2 and ran == [False, False]
    lr = cfg["training"]["lr"]
    sched = tts.cosine_schedule(2, lr, alpha=1e-7 / lr)
    assert state.opt.opt.param_groups[0]["lr"] == sched(1)
    assert osp.isfile("checkpoints/redwood_smoke_000002.npz")
    with open("runs/redwood_smoke/metrics.jsonl") as f:
        losses = [json.loads(line)["loss"] for line in f
                  if "loss" in json.loads(line)]
    assert len(losses) == 2 and np.isfinite(losses).all()
