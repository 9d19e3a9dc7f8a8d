#!/usr/bin/env python3
"""Train VONet with the PyTorch/CUDA port on one GPU.

    python train_torch.py configs/tartan_train.yaml [--device cpu]

The counterpart of ``train.py``: the same YAML config, TartanAir readers,
host-side batch preparation (``prepare_batch``: the same numpy draws, so
both packages prepare the same batch from one seed), structure-only
warm-up, validation on the held-out split, ``save_freq`` checkpoints in
the JAX package's ``.npz`` layout beside a ``_state.npz`` of the port's own
(parameters, optimizer moments, step), ``training.resume`` and
``training.ckpt``.  The step is ``dpvo_tpu_torch.parallel.train_step``'s;
``training.amp`` (default true) runs the encoders and the update operator
under bf16 autocast.  Weights start from the flax-like initialisers drawn
from a seeded generator unless ``training.ckpt`` names a checkpoint.
Reading real data needs OpenCV (``cv2``), as ``train.py`` does.  Runs on
the GPU unless ``--device cpu`` is given; the data-parallel mesh of
``train.py`` is not ported (``training.devices`` is ignored).
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from dpvo_tpu_torch.config import load_train_config
from dpvo_tpu_torch.device import resolve_device
from dpvo_tpu_torch.models.update import Update
from dpvo_tpu_torch.models.vonet import Patchifier, init_flax_like
from dpvo_tpu_torch.ops import lie
from dpvo_tpu_torch.parallel.train_step import (TrainState, make_eval_step,
                                                make_optimizer,
                                                make_train_step,
                                                train_params)
from dpvo_tpu_torch.training import rollout as R
from dpvo_tpu_torch.utils.checkpoint import (load_network, load_train_state,
                                             save_network, save_train_state)
from dpvo_tpu_torch.utils.logger import Logger


def prepare_batch(rng, images, poses, disps, intrinsics, M, steps):
    """Host-side batch preparation (numpy in, numpy out): normalisation,
    feature-resolution disparities and intrinsics, centroid sampling, the
    rollout schedule and the initial depths, drawn from ``rng`` in
    ``train.py``'s order.  The schedule is not padded: its edge count
    depends only on N, M and steps (dropout marks slots dead and removes
    none), and an eager step needs no static shape."""
    B, N, H, W, _ = images.shape
    h, w = H // 4, W // 4

    images = 2.0 * (images / 255.0) - 0.5
    intrinsics = intrinsics / 4.0
    disps_feat = disps[:, :, 1::4, 1::4]

    coords = np.stack([
        rng.integers(1, w - 1, size=(B, N, M)),
        rng.integers(1, h - 1, size=(B, N, M)),
    ], axis=-1).astype(np.float32)

    sch = R.build_schedule(N, M, steps, rng)

    poses_inv = lie.se3_inv(torch.as_tensor(np.asarray(poses, np.float32)))

    return {
        "images": images.astype(np.float32),
        "poses": poses_inv.numpy(),
        "disps": disps_feat.astype(np.float32),
        "intrinsics": intrinsics.astype(np.float32),
        "coords": coords,
        "depth_init": rng.uniform(0.0, 1.0, (B, N * M)).astype(np.float32),
        "sch_ii": sch.ii, "sch_jj": sch.jj, "sch_kk": sch.kk,
        "sch_active": sch.active, "sch_fresh": sch.fresh,
        "sch_intro": sch.intro,
    }


def to_device(batch, dev):
    """The batch's arrays as tensors on ``dev``; the schedule stays numpy
    (the step moves it, and reads ``sch_intro`` on the host)."""
    return {k: (v if k.startswith("sch_") else torch.as_tensor(v, device=dev))
            for k, v in batch.items()}


def build_state(tcfg, scheduler, steps_total, dev, seed=0):
    """Modules (from ``ckpt`` or the flax-like initialisers drawn from a
    generator seeded with ``seed``), optimizer and step 0."""
    patchifier = Patchifier(3).to(dev)
    update_mod = Update(3).to(dev)
    ckpt = tcfg.get("ckpt")
    if ckpt:
        p_sd, u_sd = load_network(ckpt)
        patchifier.load_state_dict(p_sd)
        update_mod.load_state_dict(u_sd)
    else:
        gen = torch.Generator(device=dev).manual_seed(seed)
        init_flax_like(patchifier, gen)
        init_flax_like(update_mod, gen)
    opt = make_optimizer(train_params(patchifier, update_mod), tcfg["lr"],
                         steps_total, weight_decay=tcfg["weight_decay"],
                         clip=tcfg["clip"], scheduler=scheduler["type"],
                         pct_start=scheduler.get("pct_start", 0.01))
    return TrainState(patchifier, update_mod, opt)


def train(config, device="cuda"):
    """Run ``config`` (a ``load_train_config`` dict) to
    ``training.steps``; returns the final TrainState."""
    from dpvo_tpu_torch.data.factory import dataset_factory
    from dpvo_tpu_torch.data.loader import make_loader

    dev = resolve_device(device)
    tcfg = config["training"]
    dcfg = config["dataset"]
    steps_total = tcfg["steps"]
    STEPS = tcfg.get("iters", 18)
    M = tcfg.get("M", 80)
    n_frames = dcfg.get("n_frames", 15)
    B = tcfg.get("batch_size", 1)
    amp = tcfg.get("amp", True)

    reader_kw = dict(
        n_frames=n_frames, fmin=dcfg.get("fmin", 16.0),
        fmax=dcfg.get("fmax", 60.0),
        crop_size=tuple(dcfg.get("crop_size", (480, 640))),
        aug=dcfg.get("aug", True), device=dev)
    if dcfg.get("cache_dir"):
        reader_kw["cache_dir"] = dcfg["cache_dir"]
    db = dataset_factory(dcfg["names"], datapath=dcfg["roots"][0],
                         **reader_kw)
    if len(db) < B:
        raise RuntimeError(
            f"dataset has {len(db)} samples but the batch is {B}; with "
            "drop_last the loader would never yield: add data or reduce "
            "training.batch_size")
    loader = make_loader(db, batch_size=B,
                         num_workers=config["dataloader"]["num_workers"],
                         prefetch=config["dataloader"]["prefetch"])

    state = build_state(tcfg, config["scheduler"], steps_total, dev)
    resume = tcfg.get("resume")
    if resume:
        load_train_state(resume, state)
        print(f"resumed from {resume} at step {state.step}")

    name = tcfg.get("name", "dpvo_tpu")
    logger = Logger(name)
    rng = np.random.default_rng(0)
    fw = config["loss"].get("flow_weight", 0.1)
    pw = config["loss"].get("pose_weight", 10.0)

    step_fns = {so: make_train_step(steps=STEPS, M=M, structure_only=so,
                                    flow_weight=fw, pose_weight=pw, amp=amp)
                for so in (False, True)}

    ckpt = tcfg.get("ckpt")
    save_freq = tcfg.get("save_freq", 10000)
    warmup = tcfg.get("structure_warmup", 1000)
    val_cfg = config.get("validation", {})
    val_freq = val_cfg.get("freq", 10000)
    val_samples, eval_step = ([], None)
    if val_cfg.get("enabled", False):
        val_samples = _validation_samples(dcfg, reader_kw, val_cfg, M, STEPS,
                                          dev)
        eval_step = make_eval_step(steps=STEPS, M=M, amp=amp)

    try:
        while state.step < steps_total:
            for images, poses, disps, intrinsics in loader:
                so = state.step < warmup and not ckpt
                batch = prepare_batch(rng, images, poses, disps, intrinsics,
                                      M, STEPS)
                state, metrics = step_fns[so](state, to_device(batch, dev))
                logger.push({k: float(v) for k, v in metrics.items()})

                if val_samples and state.step % val_freq == 0:
                    from dpvo_tpu_torch.training.validate import validate
                    stats = validate(
                        lambda s: {"poses": eval_step(state, s["_batch"])[0][0]
                                   .cpu().numpy()},
                        val_samples, logger, state.step,
                        make_figures=val_cfg.get("figures", False))
                    print(f"step {state.step} validation: {stats}")

                if state.step % save_freq == 0:
                    os.makedirs("checkpoints", exist_ok=True)
                    path = f"checkpoints/{name}_{state.step:06d}.npz"
                    save_network(path, state.patchifier, state.update)
                    save_train_state(
                        f"checkpoints/{name}_{state.step:06d}_state.npz",
                        state)
                    print(f"saved {path} (+_state.npz)")

                if state.step >= steps_total:
                    break
    finally:
        logger.close()
    print(f"Training completed at step {state.step}")
    return state


def _validation_samples(dcfg, reader_kw, val_cfg, M, STEPS, dev):
    """Prepared batches of the held-out split (no augmentation, so the
    validation numbers repeat run to run), drawn with seed 7 as train.py
    draws them; none (and a printed reason) without validation data."""
    from dpvo_tpu_torch.data.factory import dataset_factory
    from dpvo_tpu_torch.data.loader import make_loader
    try:
        val_db = dataset_factory(dcfg["names"], datapath=dcfg["roots"][0],
                                 mode="validation", **dict(reader_kw,
                                                           aug=False))
    except (OSError, ValueError) as e:
        print(f"validation disabled (no validation data): {e}")
        return []
    if len(val_db) == 0:
        print("validation disabled (no validation data)")
        return []
    val_loader = make_loader(val_db, batch_size=1, num_workers=0, prefetch=1,
                             shuffle=False)
    vrng = np.random.default_rng(7)
    samples = []
    for vimages, vposes, vdisps, vintr in val_loader:
        if len(samples) >= val_cfg.get("n_samples", 4):
            break
        prepared = prepare_batch(vrng, vimages, vposes, vdisps, vintr, M,
                                 STEPS)
        samples.append({"_batch": to_device(prepared, dev),
                        "poses": prepared["poses"][0]})
    print(f"validation set: {len(samples)} samples")
    return samples


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("config", nargs="?",
                        default="configs/tartan_train.yaml")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    train(load_train_config(args.config), device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
