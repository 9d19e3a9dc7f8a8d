"""Data-parallel training of the port on the CPU: two gloo ranks spawned by
``dpvo_tpu_torch.parallel.launch.spawn`` against one process, on the same
global batch of 2 and the same seeded weights.

- the step (``make_train_step(group=...)``): a structure-only step, then a
  full step; metrics, gnorm and every parameter within 1e-5 of the
  single-process steps (the same per-sample backwards; the reduction adds
  the same two halves), and the parameters equal across the ranks;
- ``train_torch.train`` under torchrun's variables on a Redwood tree
  (tests/test_redwood_data.py): both ranks, each loading only its rows,
  end with the parameters of one torchrun process trained on batch 2 (the
  same seeded draws), and only rank 0 writes checkpoints; both checks
  share one spawn of the two ranks;
- the per-rank rows: ``data.loader.RowSampler`` and ``prepare_batch``'s
  ``shard`` give each rank its rows of world 1's global batch;
- ``training.devices`` other than the world size raises;
- ``parallel.mesh``: ``make_mesh`` joins through torchrun's variables and
  refuses a world other than ``n_devices``, ``shard_batch`` takes a
  rank's rows.

The JAX package's data-parallel step is one jitted program over a mesh;
its per-sample math is held against the port's by
tests/test_torch_train_step.py, so this file holds the port's
data-parallel step against its own single-process step.
"""
import importlib.util
import os
import os.path as osp
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_ranks
from dpvo_tpu_torch.parallel import launch, mesh
from dpvo_tpu_torch.parallel.train_step import make_train_step

torch.set_num_threads(1)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
STEP_CFG = dict(steps=2, M=4, amp=False)
TOL = 1e-5


def _train_torch():
    spec = importlib.util.spec_from_file_location(
        "repo_train_torch", osp.join(REPO, "train_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _global_batch(B=2, N=4, H=48, W=64):
    rng = np.random.default_rng(11)
    images = rng.uniform(0, 255, (B, N, H, W, 3)).astype(np.float32)
    poses = np.zeros((B, N, 7), np.float32)
    poses[..., 6] = 1.0
    poses[..., 0] = 0.05 * np.arange(N)
    disps = rng.uniform(0.3, 1.0, (B, N, H, W)).astype(np.float32)
    intr = np.tile(np.float32([60.0, 60.0, W / 2, H / 2]), (B, N, 1))
    return _train_torch().prepare_batch(np.random.default_rng(0), images,
                                        poses, disps, intr, 4, 2)


def _close(got, want, what):
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL,
                                   err_msg=f"{what} {k}")


@pytest.fixture(scope="module")
def redwood(tmp_path_factory):
    pytest.importorskip("cv2")
    pytest.importorskip("scipy")
    import test_redwood_data as RD
    from dpvo_tpu_torch.data.redwood import Redwood
    root = str(tmp_path_factory.mktemp("redwood_dp"))
    RD._make_redwood_scene(root)
    # build the cache once: the ranks share the tree
    Redwood(mode="train", datapath=root, n_frames=4, crop_size=(48, 64),
            device="cpu")
    return root


def _config(root, **training):
    return {
        "dataset": {"names": ["redwood"], "roots": [root], "n_frames": 4,
                    "fmin": 8.0, "fmax": 48.0, "crop_size": [48, 64],
                    "aug": True},
        "training": dict({"steps": 2, "iters": 2, "M": 4, "batch_size": 1,
                          "lr": 1e-3, "weight_decay": 1e-5, "clip": 10.0,
                          "amp": False, "structure_warmup": 1,
                          "save_freq": 2, "name": "dp"}, **training),
        "scheduler": {"type": "constant"},
        "loss": {"flow_weight": 0.1, "pose_weight": 10.0},
        "dataloader": {"num_workers": 0, "prefetch": 2},
        "validation": {"enabled": False},
    }


KINDS = (True, False)


@pytest.fixture(scope="module")
def ranks(request, tmp_path_factory):
    """One spawn of two gloo ranks for both checks: the train steps on
    ``_global_batch()``, then ``train_torch.train`` on the Redwood tree
    (where cv2 and scipy import)."""
    work = tmp_path_factory.mktemp("dp_ranks")
    for r in range(2):
        os.makedirs(work / f"rank{r}")
    try:
        root = request.getfixturevalue("redwood")
        config = _config(root, devices=2)
    except pytest.skip.Exception:
        root = config = None
    out = launch.spawn(torch_ranks.dp_ranks, 2,
                       ((_global_batch(), 3, KINDS, STEP_CFG), config,
                        str(work)),
                       rendezvous_dir=str(work), timeout=300)
    return root, out


def test_two_rank_step_equals_one_process(ranks):
    batch = _global_batch()
    state = torch_ranks.train_state(seed=3)
    tb = {k: v if k.startswith("sch_") else torch.as_tensor(v)
          for k, v in batch.items()}
    want = []
    for so in KINDS:
        state, m = make_train_step(structure_only=so, **STEP_CFG)(state, tb)
        want.append({k: float(v) for k, v in m.items()})
    want_params = torch_ranks.state_arrays(state)

    steps = [r[0] for r in ranks[1]]
    for metrics, params in steps:
        for g, w in zip(metrics, want):
            _close(g, w, "metric")
        _close(params, want_params, "parameter")
    for k, v in steps[0][1].items():
        np.testing.assert_array_equal(steps[1][1][k], v, err_msg=k)
    assert want[1]["gnorm"] > 0


def test_train_torch_two_ranks_equals_one_process(ranks, tmp_path,
                                                  monkeypatch):
    """Two torchrun ranks of batch 1 (each loading only its sample) end
    where one torchrun process of batch 2 does (run here, in this
    process)."""
    root, out = ranks
    if root is None:
        pytest.skip("the Redwood reader needs cv2 and scipy")
    trained = [r[1] for r in out]
    assert trained[0][1] == ["dp_000002.npz", "dp_000002_state.npz"]
    assert trained[1][1] == []
    for k, v in trained[0][0].items():
        np.testing.assert_array_equal(trained[1][0][k], v, err_msg=k)

    # one torchrun rank on the global batch of 2
    for k, v in dict(WORLD_SIZE="1", RANK="0", LOCAL_RANK="0").items():
        monkeypatch.setenv(k, v)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.chdir(tmp_path)
    state = _train_torch().train(_config(root, batch_size=2), device="cpu")
    _close(trained[0][0], torch_ranks.state_arrays(state), "parameter")


def test_row_sampler_splits_global_batches():
    """Each rank's rows of every global batch, from the same draws: the
    ranks' rows together are world 1's batch, with the same seeds."""
    from dpvo_tpu_torch.data.loader import RowSampler
    batches = []
    for rank, world, b in ((0, 2, 3), (1, 2, 3), (0, 1, 6)):
        sampler = RowSampler(14, b, rank, world, seed=5)
        torch.manual_seed(rank)          # the global generator plays no part
        batches.append([list(sampler) for _ in range(2)])   # two epochs
    for epoch in range(2):
        assert len(batches[2][epoch]) == 2
        for r0, r1, one in zip(*(b[epoch] for b in batches)):
            assert r0 + r1 == one
        picked = [i for b in batches[2][epoch] for i, _ in b]
        assert len(set(picked)) == 12 and set(picked) <= set(range(14))
    assert batches[2][0] != batches[2][1]


def test_prepare_batch_rows_of_the_global_batch():
    """``prepare_batch`` with ``shard=(rank, 2)`` on a rank's rows gives
    those rows of the global batch's arrays and the same schedule."""
    prep = _train_torch().prepare_batch
    rng = np.random.default_rng(2)
    arrays = (rng.uniform(0, 255, (4, 4, 32, 48, 3)),
              np.tile(np.float32([0, 0, 0, 0, 0, 0, 1]), (4, 4, 1)),
              rng.uniform(0.3, 1.0, (4, 4, 32, 48)),
              np.tile(np.float32([40, 40, 24, 16]), (4, 4, 1)))
    want = prep(np.random.default_rng(9), *arrays, 4, 2)
    for rank in (0, 1):
        got = prep(np.random.default_rng(9),
                   *(a[2 * rank:2 * rank + 2] for a in arrays), 4, 2,
                   shard=(rank, 2))
        for k, v in want.items():
            w = v if k.startswith("sch_") else v[2 * rank:2 * rank + 2]
            np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_devices_other_than_the_world_raise(redwood, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="training.devices is 2"):
        _train_torch().train(_config(redwood, devices=2), device="cpu")


def test_mesh_world_and_rows(tmp_path):
    init = f"file://{tmp_path / 'store'}"
    try:
        with pytest.raises(RuntimeError, match="make_mesh.2."):
            mesh.make_mesh(2, device="cpu", init_method=init, rank=0,
                           world_size=1)
        group, dev = mesh.make_mesh(1, device="cpu")
        assert dev.type == "cpu"
        x = torch.arange(12).reshape(6, 2)
        rows = mesh.shard_batch({"a": x, "b": x.numpy()}, group)
        assert torch.equal(rows["a"], x) and rows["b"].shape == (6, 2)
        t = torch.ones(3)
        assert mesh.replicate(t, group) is t
        with pytest.raises(RuntimeError, match="gloo"):
            mesh.make_mesh(1, device="cpu", backend="nccl")
    finally:
        dist.destroy_process_group()


def test_make_mesh_reads_torchrun_variables(monkeypatch):
    """With no arguments ``make_mesh`` joins through torchrun's variables
    (``env://``), as ``train_torch.train`` calls it; one rank, a free
    localhost port."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    for k, v in dict(RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    try:
        group, dev = mesh.make_mesh(1, device="cpu")
        assert dist.get_world_size() == 1 and dev.type == "cpu"
    finally:
        dist.destroy_process_group()
