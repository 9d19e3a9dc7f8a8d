#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on an image directory or a video.

    python demo_torch.py --imagedir <dir-or-video> --calib calib/tartan.txt \
        --network weights.npz --plot --save_ply --save_trajectory

The counterpart of ``demo.py``, argument for argument.  ``--network`` takes
the JAX package's ``.npz`` checkpoint (``dpvo_tpu.utils.checkpoint``
``save_network``); without it the weights are seeded random ones.  Outputs
go under the working directory: ``saved_trajectories/<name>.txt`` (TUM),
``<name>.ply``, ``colmap_saves/<name>/`` and
``trajectory_plots/<name>.pdf``; ``--viz`` writes the viewer's
``viewer_out/latest.png`` while it runs and ``viewer_out/map.html`` at the
end (it needs matplotlib).  Runs on the GPU unless ``--device cpu`` is
given.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from dpvo_tpu_torch.config import VOConfig
from dpvo_tpu_torch.data.stream import spawn_stream
from dpvo_tpu_torch.engine import DPVO
from dpvo_tpu_torch.utils.plot_utils import (plot_trajectory, save_ply,
                                             save_output_for_COLMAP,
                                             save_trajectory_tum_format)
from dpvo_tpu_torch.utils.timing import Timer


@torch.no_grad()
def run(cfg, network, imagedir, calib, stride=1, skip=0, viz=False,
        timeit=False, device="cuda"):
    """Track every frame of ``imagedir`` -> ((poses, tstamps), (points,
    colors, (fx, fy, cx, cy, H, W)))."""
    slam = None
    intrinsics = None
    queue, reader = spawn_stream(imagedir, calib, stride, skip)

    while True:
        # the sentinel is (-1, None, None): the last real intrinsics stay
        # for the COLMAP export
        t, image, intr = queue.get()
        if t < 0:
            break
        intrinsics = intr

        if slam is None:
            H, W = image.shape[:2]
            slam = DPVO(cfg, network, ht=H, wd=W, viz=viz, device=device)

        with Timer("SLAM", enabled=timeit):
            slam(t, image, intrinsics)

    reader.join()
    if slam is None:
        raise RuntimeError(f"no frames in {imagedir}")

    points = slam.points[:slam.m].cpu().numpy()
    colors = slam.ds.colors[:slam.n].reshape(-1, 3).cpu().numpy()

    return slam.terminate(), (points, colors, (*intrinsics, H, W))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--network", type=str, default=None)
    parser.add_argument("--imagedir", type=str, required=True)
    parser.add_argument("--calib", type=str, required=True)
    parser.add_argument("--name", type=str, default="result",
                        help="name your run")
    parser.add_argument("--stride", type=int, default=2)
    parser.add_argument("--skip", type=int, default=0)
    parser.add_argument("--config", default="configs/default.yaml")
    parser.add_argument("--timeit", action="store_true")
    parser.add_argument("--viz", action="store_true")
    parser.add_argument("--plot", action="store_true")
    parser.add_argument("--opts", nargs="+", default=[])
    parser.add_argument("--save_ply", action="store_true")
    parser.add_argument("--save_colmap", action="store_true")
    parser.add_argument("--save_trajectory", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: the GPU)")
    args = parser.parse_args(argv)

    cfg = VOConfig()
    if os.path.exists(args.config):
        cfg = cfg.merge_yaml(args.config)
    cfg = cfg.merge_opts(args.opts)
    print("Running with config...")
    print(cfg)

    (poses, tstamps), (points, colors, calib_out) = run(
        cfg, args.network, args.imagedir, args.calib, args.stride,
        args.skip, args.viz, args.timeit, args.device)

    if args.save_ply:
        save_ply(f"{args.name}.ply", points,
                 np.tile(colors, (len(points) // max(len(colors), 1) + 1,
                                  1))[:len(points)])

    if args.save_trajectory:
        save_trajectory_tum_format(poses, tstamps,
                                   f"saved_trajectories/{args.name}.txt")

    if args.save_colmap:
        save_output_for_COLMAP(f"colmap_saves/{args.name}", poses, tstamps,
                               points, colors, *calib_out)

    if args.plot:
        plot_trajectory(poses, tstamps, title=f"DPVO-torch: {args.name}",
                        filename=f"trajectory_plots/{args.name}.pdf")
    return 0


if __name__ == "__main__":
    sys.exit(main())
