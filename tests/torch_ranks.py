"""Rank functions for the spawned-rank CPU tests (tests/test_torch_sharded.py,
tests/test_torch_dp_train.py).

``dpvo_tpu_torch.parallel.launch.spawn`` starts each rank in a fresh
interpreter that imports this module to find its function, so it imports
only torch, numpy and the port, never JAX (the test modules import JAX,
which would cost every child seconds).  Each spawned function
(``sharded_pieces``, ``dp_ranks``) takes (rank, world_size, init_method,
...), joins a gloo group on the CPU and returns numpy.
"""
from __future__ import annotations

import importlib.util
import os
import os.path as osp

import numpy as np
import torch

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


def _group(rank, world, init_method):
    from dpvo_tpu_torch.parallel.mesh import make_mesh
    group, _ = make_mesh(world, device="cpu", init_method=init_method,
                         rank=rank, world_size=world)
    return group


def _t(a):
    return torch.as_tensor(np.asarray(a))


def sharded_pieces(rank, world, init_method, update_sd, agg_sd, inputs,
                   cfg):
    """This rank's rows through the sharded update step, SoftAgg's
    cross-rank form and ``ba_iterative_sharded``; -> dict of numpy."""
    from dpvo_tpu_torch.models.blocks import SoftAgg
    from dpvo_tpu_torch.models.update import Update
    from dpvo_tpu_torch.ops import ba
    from dpvo_tpu_torch.parallel.infer_step import make_sharded_update_step
    group = _group(rank, world, init_method)

    def rows(a):
        n = a.shape[0] // world
        return _t(a[rank * n:(rank + 1) * n])

    upd = Update(3)
    upd.load_state_dict({k: _t(v) for k, v in update_sd.items()})
    # the step turns TF32 off while it runs and gives the caller's back
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    step = make_sharded_update_step(upd, group, **cfg["step"])
    u = inputs["update"]
    out = step(*(_t(u[k]) for k in ("poses", "patches", "intrinsics",
                                    "imap", "gmap", "fmap1", "fmap2")),
               *(rows(u[k]) for k in ("net", "target", "weight", "ii",
                                      "jj", "kk", "valid")),
               u["t0"], u["t1"])
    res = {"update": [o.numpy() for o in out],
           "tf32_after": (torch.backends.cuda.matmul.allow_tf32,
                          torch.backends.cudnn.allow_tf32)}

    a = inputs["agg"]
    agg = SoftAgg(agg_sd["f.weight"].shape[0])
    agg.load_state_dict({k: _t(v) for k, v in agg_sd.items()})
    with torch.no_grad():
        res["agg"] = agg(rows(a["x"]), rows(a["jx"]), a["num_groups"],
                         rows(a["valid"]), group=group).numpy()

    b = inputs["ba"]
    poses, patches = ba.ba_iterative_sharded(
        _t(b["poses"]), _t(b["patches"]), _t(b["intrinsics"]),
        rows(b["target"]), rows(b["weight"]), 1e-4, rows(b["ii"]),
        rows(b["jj"]), rows(b["kk"]), rows(b["valid"]), b["t0"], b["t1"],
        **cfg["ba"], group=group)
    res["ba"] = [poses.numpy(), patches.numpy()]
    return res


def _train_torch():
    spec = importlib.util.spec_from_file_location(
        "repo_train_torch", osp.join(REPO, "train_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def train_state(seed, lr=1e-3, total=100):
    """Patchifier, Update and optimizer from flax-like seeded weights."""
    from dpvo_tpu_torch.models.update import Update
    from dpvo_tpu_torch.models.vonet import Patchifier, init_flax_like
    from dpvo_tpu_torch.parallel.train_step import (TrainState,
                                                    make_optimizer,
                                                    train_params)
    gen = torch.Generator().manual_seed(seed)
    p = init_flax_like(Patchifier(3), gen)
    u = init_flax_like(Update(3), gen)
    opt = make_optimizer(train_params(p, u), lr, total,
                         scheduler="constant")
    return TrainState(p, u, opt)


def state_arrays(state):
    return {f"{m}.{k}": v.detach().numpy().copy()
            for m, mod in state.modules().items()
            for k, v in mod.state_dict().items()}


def dp_train_steps(group, batch, seed, kinds, cfg):
    """The data-parallel train step on this rank's rows of ``batch`` (a
    prepared global batch), once per entry of ``kinds`` (structure-only
    or not); -> (metrics per step, parameters after)."""
    from dpvo_tpu_torch.parallel.mesh import replicate, shard_batch
    from dpvo_tpu_torch.parallel.train_step import make_train_step
    state = train_state(seed)
    replicate(state.patchifier, group)
    replicate(state.update, group)
    local = dict(batch, **shard_batch(
        {k: v for k, v in batch.items() if not k.startswith("sch_")},
        group))
    local = {k: v if k.startswith("sch_") else _t(v)
             for k, v in local.items()}
    metrics = []
    for so in kinds:
        step = make_train_step(structure_only=so, group=group, **cfg)
        state, m = step(state, local)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state_arrays(state)


def dp_train_torch(rank, world, config, workdir):
    """``train_torch.train`` as torchrun would start it on this rank
    (torchrun's variables; at world > 1 the process group is joined
    already); -> (parameters after, the checkpoint files this rank wrote).
    TensorBoard is hidden from the logger (its import alone takes tens of
    seconds where TensorFlow is installed)."""
    import sys
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    sys.modules["torch.utils.tensorboard"] = None
    os.chdir(osp.join(workdir, f"rank{rank}"))
    state = _train_torch().train(config, device="cpu")
    ckpts = sorted(os.listdir("checkpoints")) if osp.isdir("checkpoints") \
        else []
    return state_arrays(state), ckpts


def dp_ranks(rank, world, init_method, step_args, config, workdir):
    """One spawn for both data-parallel checks: ``dp_train_steps`` on
    ``step_args``, then (when ``config`` is given) ``dp_train_torch`` in
    the same process group, which ``train`` leaves at its end."""
    group = _group(rank, world, init_method)
    steps = dp_train_steps(group, *step_args)
    if config is None:
        import torch.distributed as dist
        dist.destroy_process_group()
        return steps, None
    return steps, dp_train_torch(rank, world, config, workdir)
