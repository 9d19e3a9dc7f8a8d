#!/usr/bin/env python3
"""Scale-out of the port over the cards of one host, one process per card
(NCCL).

    python3 scripts/multi_gpu_torch.py [--ranks N] [--device cuda|cpu]
                                       [--small] [--parent DIR]

Two measurements, each first at one rank, then at ``--ranks`` ranks
(default: every visible card):

- the edge-sharded tracking update (``parallel.infer_step``) at
  docs/MULTICHIP.md's retain scale (``chip_smoke.py``'s ``sharded``
  problem: 32000 live edges, M=96, k_cap=4096, 480x640 maps, fp32),
  against the single-device ``engine.kernels.update_step`` at
  tests/test_infer_sharded.py's tolerances; ms per sharded update on each
  rank and K2's launches;
- the data-parallel train step at ``configs/tartan_train.yaml``'s size
  (480x640, N=15, M=80, 18 iterations, bf16), one sample per rank (a
  global batch of N): ms per step, samples per second, the parameters
  equal across ranks after the steps;
- then ``train_torch.py configs/redwood_train.yaml`` itself under
  ``torchrun --standalone`` (a synthetic full-width Redwood tree, a
  seeded ``.npz`` checkpoint, 8 steps, a checkpoint after each), at one
  rank and at ``--ranks``: its wall time, and ms per steady step from the
  times rank 0's checkpoints were written (steps 3-8: the step, the wait
  for the loader, one checkpoint write, which is timed alone beside it).
  The data-parallel step above feeds prepared clips and bypasses the
  loader; this one runs the whole path.  ``--parent DIR`` times DIR's
  ``train_torch.py`` (a parent checkout) the same way at ``--ranks``, in
  the same call.

``--device cpu --small`` runs everything on gloo ranks at toy sizes (the
rehearsal before a multi-card call).  Prints one JSON line of the numbers
last, after the card line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SMALL_SH = dict(cs.SH, M=8, E_LIVE=2000, E_ROWS=2048, H=24, W=32, MEM=8,
                PMEM=8)
SMALL_TRAIN = dict(N=5, H=64, W=96, M=4, iters=3)
TRAIN_REPS = 3
TORCHRUN_STEPS = 8       # a checkpoint after each; steps 3-8 are timed


def _mesh(rank, world, init_method, device):
    from dpvo_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(world, device=device, init_method=init_method,
                     rank=rank, world_size=world)


def sharded_rank(rank, world, init_method, device, sh):
    """The sharded update at the sizes ``sh`` on this rank's share of the
    edges."""
    group, dev = _mesh(rank, world, init_method, device)
    out, perm, valid, launches, ms = cs.run_sharded(group, dev, world,
                                                    rank, sh)
    return out, perm, valid, launches.get("corr_enc", 0), ms


def train_rank(rank, world, init_method, device, c, amp):
    """The data-parallel train step at the sizes ``c`` on this rank's
    sample of the global batch: -> (ms per full step, losses, a parameter
    checksum)."""
    import torch
    import train_torch
    from dpvo_tpu_torch.parallel.mesh import shard_batch
    from dpvo_tpu_torch.parallel import train_step as ts
    group, dev = _mesh(rank, world, init_method, device)
    clips = [cs.train_clip(5 + i, c["N"], c["H"], c["W"])
             for i in range(world)]
    batch = train_torch.prepare_batch(
        np.random.default_rng(5), *[np.concatenate(p) for p in zip(*clips)],
        c["M"], c["iters"])
    batch = dict(batch, **shard_batch(
        {k: v for k, v in batch.items() if not k.startswith("sch_")},
        group))
    batch = train_torch.to_device(batch, dev)
    state = cs.train_state(dev, seed=0)
    step = ts.make_train_step(steps=c["iters"], M=c["M"], amp=amp,
                              group=group if world > 1 else None)
    losses, times = [], []
    for _ in range(1 + TRAIN_REPS):
        cs.synchronize(dev)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        cs.synchronize(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    flat = torch.cat([p.detach().float().reshape(-1)
                      for p in cs.params_of(state)])
    return times[1:], losses, float(flat.double().sum()), \
        float(flat.double().abs().sum())


def redwood_run(small, tmp):
    """The synthetic Redwood tree (its cache built here: the ranks share
    it), a seeded checkpoint and configs/redwood_train.yaml for them,
    TORCHRUN_STEPS steps with a checkpoint after each; -> config."""
    import torch
    from dpvo_tpu_torch.data.redwood import Redwood
    from dpvo_tpu_torch.models.update import Update
    from dpvo_tpu_torch.models.vonet import Patchifier, init_flax_like
    from dpvo_tpu_torch.utils.checkpoint import save_network
    root = cs.redwood_tree(tmp / "redwood",
                           hw=(96, 128) if small else cs.REDWOOD_HW)
    gen = torch.Generator().manual_seed(0)
    ckpt = str(tmp / "start.npz")
    save_network(ckpt, init_flax_like(Patchifier(3), gen),
                 init_flax_like(Update(3), gen))
    cfg = cs.redwood_config(root, ckpt, steps=TORCHRUN_STEPS, save_freq=1,
                            name="torchrun")
    if small:
        cfg["dataset"]["n_frames"] = 5
        cfg["training"].update(M=4, iters=3, amp=False)
    cfg["validation"]["enabled"] = False
    Redwood(mode="train", datapath=root, n_frames=cfg["dataset"]["n_frames"],
            device="cpu")
    return cfg


def save_ms(dev, reps=3):
    """ms of one checkpoint write as rank 0 makes it after a step
    (save_network + save_train_state of the port's modules)."""
    from dpvo_tpu_torch.utils.checkpoint import save_network, \
        save_train_state
    state = cs.train_state(dev, seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        times = []
        for i in range(reps):
            t0 = time.perf_counter()
            save_network(f"{tmp}/{i}.npz", state.patchifier, state.update)
            save_train_state(f"{tmp}/{i}_state.npz", state)
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def torchrun_train(n, device, cfg, tmp, script):
    """``script`` (a train_torch.py) at ``cfg`` under torchrun on ``n``
    ranks; -> (wall seconds, ms per steady step: the median interval
    between rank 0's checkpoints after steps 3-8)."""
    import subprocess
    import yaml
    run = Path(tempfile.mkdtemp(dir=tmp))
    cfg = dict(cfg, training=dict(cfg["training"], devices=n))
    path = run / "redwood.yaml"
    path.write_text(yaml.safe_dump(cfg))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={n}", str(script), str(path),
           "--device", device]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=run, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, timeout=900)
    wall = time.perf_counter() - t0
    ckpts = run / "checkpoints"
    saved = sorted(p.name for p in ckpts.iterdir()) if ckpts.is_dir() \
        else []
    text = proc.stdout.decode(errors="replace")
    if proc.returncode:
        print(text[-6000:], file=sys.stderr)
    last = TORCHRUN_STEPS
    ok = proc.returncode == 0 and f"torchrun_{last:06d}.npz" in saved
    step_ms = float("nan")
    if ok:
        t = [(ckpts / f"torchrun_{i:06d}_state.npz").stat().st_mtime
             for i in range(2, last + 1)]
        step_ms = float(np.median(np.diff(t))) * 1e3
    cs.log(f"[multi] torchrun --nproc_per_node={n} {script} "
           f"configs/redwood_train.yaml ({last} steps, a checkpoint after "
           f"each, {device}): exit {proc.returncode}, {wall:.1f} s wall "
           f"with start-up, {step_ms:.1f} ms per steady step (steps "
           f"3-{last}, with the loader and one checkpoint write), rank 0 "
           f"wrote {len(saved)} files; last lines: "
           + " | ".join(text.splitlines()[-3:])
           + f" {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("multi_gpu_torch: train_torch under torchrun "
                         "failed")
    return wall, step_ms


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--ranks", type=int, default=None)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--small", action="store_true")
    parser.add_argument("--parent", default=None,
                        help="a parent checkout whose train_torch.py is "
                             "also timed under torchrun")
    args = parser.parse_args(argv)
    import torch
    from dpvo_tpu_torch.parallel import launch
    sh = SMALL_SH if args.small else cs.SH
    train = SMALL_TRAIN if args.small else cs.TRAIN_FULL
    dev = torch.device(args.device, 0) if args.device == "cuda" else \
        torch.device("cpu")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("multi_gpu_torch: no CUDA device", file=sys.stderr)
            return 1
        from dpvo_tpu_torch.ops import _cuda
        _cuda.lib()                     # build once, before any rank
        card = cs.card_line()
        cs.log(f"[machine] {card}; {torch.cuda.device_count()} card(s)")
    else:
        card = "cpu"
    n = args.ranks or (torch.cuda.device_count() if dev.type == "cuda"
                       else 4)
    device = "cuda" if dev.type == "cuda" else "cpu"
    out = {"ranks": n}
    ref = cs.single_device_update(dev, sh)
    with tempfile.TemporaryDirectory() as tmp:
        for world in (1, n):
            t0 = time.perf_counter()
            ranks = launch.spawn(sharded_rank, world, (device, sh),
                                 rendezvous_dir=tmp, timeout=900, threads=4)
            got = [np.concatenate([r[0][i] for r in ranks])
                   for i in range(4)] + list(ranks[0][0][4:])
            ok, summary = cs.sharded_errors(got, ranks[0][1], ranks[0][2],
                                            ref)
            ms = [r[4] for r in ranks]
            k2 = [r[3] for r in ranks]
            cs.log(f"[multi] sharded update, {world} rank(s) ({device}): "
                   f"{summary}; K2 launches per rank {k2}; ms per update by "
                   f"rank " + ", ".join(f"{x:.2f}" for x in ms)
                   + f"; {time.perf_counter() - t0:.1f} s with start-up "
                   f"{'OK' if ok else 'FAIL'}")
            if not ok or (dev.type == "cuda" and min(k2) < 1):
                raise SystemExit("multi_gpu_torch: the sharded update "
                                 "failed")
            out[f"sharded_ms_{world}"] = max(ms)
        for world in (1, n):
            ranks = launch.spawn(train_rank, world,
                                 (device, train, not args.small),
                                 rendezvous_dir=tmp, timeout=900, threads=4)
            ms = [float(np.median(r[0])) for r in ranks]
            sums = {(r[2], r[3]) for r in ranks}
            finite = all(np.isfinite(r[1]).all() for r in ranks)
            rate = world / (max(ms) / 1e3)
            cs.log(f"[multi] data-parallel train step, {world} rank(s) "
                   f"({device}, one sample each): ms per full step by rank "
                   + ", ".join(f"{x:.1f}" for x in ms)
                   + f"; {rate:.3f} samples/s; losses rank 0 "
                   + ", ".join(f"{x:.4f}" for x in ranks[0][1])
                   + f"; parameter checksums equal across ranks "
                   f"{len(sums) == 1} {'OK' if finite and len(sums) == 1 else 'FAIL'}")
            if not finite or len(sums) != 1:
                raise SystemExit("multi_gpu_torch: the data-parallel step "
                                 "failed")
            out[f"train_ms_{world}"] = max(ms)
            out[f"samples_per_s_{world}"] = rate
        cfg = redwood_run(args.small, Path(tmp))
        script = ROOT / "train_torch.py"
        for world in (1, n):
            out[f"torchrun_s_{world}"], out[f"torchrun_step_ms_{world}"] = \
                torchrun_train(world, device, cfg, tmp, script)
        if args.parent:
            parent = Path(args.parent).resolve() / "train_torch.py"
            out[f"parent_torchrun_s_{n}"], \
                out[f"parent_torchrun_step_ms_{n}"] = torchrun_train(
                    n, device, cfg, tmp, parent)
        out["checkpoint_ms"] = save_ms(dev)
        cs.log(f"[multi] one checkpoint write (save_network + "
               f"save_train_state) {out['checkpoint_ms']:.1f} ms")
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
