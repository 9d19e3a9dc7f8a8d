#!/usr/bin/env python
"""TUM-RGBD (freiburg1) evaluation with the PyTorch/CUDA port.

The counterpart of ``evaluate_tum.py``, argument for argument, plus
``--device`` (default the GPU): fr1 intrinsics, radtan undistortion, a
16-pixel boundary crop, then a crop to multiples of 16; Sim3 ATE against
``groundtruth.txt`` by timestamp (``max_diff=0.02`` s).

    python evaluate_tum_torch.py --network dpvo.pth --datapath DIR
"""
import os.path as osp
import sys

import numpy as np

from dpvo_tpu_torch.data.rgbd_utils import parse_list
from dpvo_tpu_torch.utils.evaluation import (associate_trajectories,
                                             ate_rmse, eval_config,
                                             eval_parser, run_frames)

fr1_scenes = [
    "rgbd_dataset_freiburg1_360", "rgbd_dataset_freiburg1_desk",
    "rgbd_dataset_freiburg1_desk2", "rgbd_dataset_freiburg1_floor",
    "rgbd_dataset_freiburg1_plant", "rgbd_dataset_freiburg1_room",
    "rgbd_dataset_freiburg1_rpy", "rgbd_dataset_freiburg1_teddy",
    "rgbd_dataset_freiburg1_xyz",
]

# fr1 intrinsics + distortion (fx fy cx cy k1 k2 p1 p2 k3)
FR1_CALIB = np.array([517.3, 516.5, 318.6, 255.3,
                      0.2624, -0.9531, -0.0054, 0.0026, 1.1633])


def read_frames(seq_path, files):
    """(t, image, intrinsics): undistorted, boundary-cropped, cropped to
    multiples of 16."""
    import cv2
    K = np.eye(3)
    K[0, 0], K[0, 2] = FR1_CALIB[0], FR1_CALIB[2]
    K[1, 1], K[1, 2] = FR1_CALIB[1], FR1_CALIB[3]
    intr = FR1_CALIB[:4] - np.array([0, 0, 16, 16])
    for t, imfile in enumerate(files):
        image = cv2.imread(osp.join(seq_path, imfile))
        image = cv2.undistort(image, K, FR1_CALIB[4:])[16:-16, 16:-16]
        h, w = image.shape[:2]
        yield t, image[:h - h % 16, :w - w % 16], intr


def run_sequence(cfg, network, seq_path, stride=1, device="cuda"):
    """-> (poses, tstamps from rgb.txt)."""
    rgb_list = parse_list(osp.join(seq_path, "rgb.txt"), skiprows=1)
    tstamps = rgb_list[:, 0].astype(np.float64)[::stride]
    files = rgb_list[:, 1][::stride]
    poses, _ = run_frames(cfg, network, read_frames(seq_path, files),
                          device)
    return poses, tstamps


def score(poses, tstamps, gt):
    """Sim3 ATE over the estimates within 0.02 s of a groundtruth row."""
    ii, jj = associate_trajectories(tstamps, gt[:, 0], max_diff=0.02)
    return ate_rmse(poses[ii], gt[jj, 1:4], correct_scale=True)


def main(argv=None):
    args = eval_parser(__doc__.splitlines()[0], "datasets/TUM-RGBD",
                       1).parse_args(argv)
    cfg = eval_config(args)

    results = {}
    for scene in fr1_scenes:
        seq = osp.join(args.datapath, scene)
        if not osp.isdir(seq):
            print(f"skipping missing {scene}")
            continue
        poses, tstamps = run_sequence(cfg, args.network, seq, args.stride,
                                      args.device)
        results[scene] = score(poses, tstamps,
                               np.loadtxt(osp.join(seq, "groundtruth.txt")))
        print(f"{scene}: ATE {results[scene]:.4f}")

    if results:
        print("AVG:", np.mean(list(results.values())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
