#!/usr/bin/env python
"""ICL-NUIM evaluation with the PyTorch/CUDA port.

The counterpart of ``evaluate_icl_nuim.py``, argument for argument, plus
``--device`` (default the GPU): frames in numeric order, cropped to
multiples of 16, Sim3 ATE against the freiburg-format groundtruth.

    python evaluate_icl_nuim_torch.py --network dpvo.pth --datapath DIR
"""
import glob
import os.path as osp
import sys

import numpy as np

from dpvo_tpu_torch.utils.evaluation import (ate_rmse, eval_config,
                                             eval_parser, run_frames)

icl_scenes = [
    "living_room_traj0_frei_png", "living_room_traj1_frei_png",
    "living_room_traj2_frei_png", "living_room_traj3_frei_png",
    "office_room_traj0_frei_png", "office_room_traj1_frei_png",
    "office_room_traj2_frei_png", "office_room_traj3_frei_png",
]

ICL_CALIB = np.array([481.20, -480.00, 319.50, 239.50])


def read_frames(seq_path, stride=1):
    """(t, image, intrinsics) of ``rgb/<n>.png`` in numeric order."""
    import cv2
    images = sorted(glob.glob(osp.join(seq_path, "rgb/*.png")),
                    key=lambda p: int(osp.splitext(osp.basename(p))[0]))
    for t, imfile in enumerate(images[::stride]):
        image = cv2.imread(imfile)
        h, w = image.shape[:2]
        yield t, image[:h - h % 16, :w - w % 16], np.abs(ICL_CALIB)


def run_sequence(cfg, network, seq_path, stride=1, device="cuda"):
    return run_frames(cfg, network, read_frames(seq_path, stride), device)


def score(poses, gt):
    """Sim3 ATE over the frames both trajectories have."""
    n = min(len(poses), len(gt))
    return ate_rmse(poses[:n], gt[:n, 1:4], correct_scale=True)


def main(argv=None):
    args = eval_parser(__doc__.splitlines()[0], "datasets/ICL-NUIM",
                       1).parse_args(argv)
    cfg = eval_config(args)

    results = {}
    for scene in icl_scenes:
        seq = osp.join(args.datapath, scene)
        gt_file = osp.join(seq, "groundtruth.txt")
        if not osp.isdir(seq) or not osp.isfile(gt_file):
            print(f"skipping missing {scene}")
            continue
        poses, _ = run_sequence(cfg, args.network, seq, args.stride,
                                args.device)
        results[scene] = score(poses, np.loadtxt(gt_file)[::args.stride])
        print(f"{scene}: ATE {results[scene]:.4f}")

    if results:
        print("AVG:", np.mean(list(results.values())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
