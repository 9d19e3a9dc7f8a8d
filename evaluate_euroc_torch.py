#!/usr/bin/env python
"""EuRoC-MAV evaluation with the PyTorch/CUDA port.

The counterpart of ``evaluate_euroc.py``, argument for argument, plus
``--device`` (default the GPU): streams cam0 images undistorted with the
EuRoC calibration (radtan), cropped to multiples of 16, aligns against
the state-estimate groundtruth by timestamp (``max_diff=0.02`` s) and
reports Sim3-aligned ATE RMSE per sequence.

    python evaluate_euroc_torch.py --network dpvo.pth --datapath DIR
"""
import glob
import os.path as osp
import sys

import numpy as np

from dpvo_tpu_torch.utils.evaluation import (associate_trajectories,
                                             ate_rmse, eval_config,
                                             eval_parser, run_frames)

euroc_scenes = [
    "MH_01_easy", "MH_02_easy", "MH_03_medium", "MH_04_difficult",
    "MH_05_difficult", "V1_01_easy", "V1_02_medium", "V1_03_difficult",
    "V2_01_easy", "V2_02_medium", "V2_03_difficult",
]

# cam0 calibration (fx fy cx cy k1 k2 p1 p2), calib/euroc.txt
EUROC_CALIB = np.array([458.654, 457.296, 367.215, 248.375,
                        -0.28340811, 0.07395907, 0.00019359, 1.76187114e-05])


def image_files(imagedir, stride=2, skip=0):
    return sorted(glob.glob(osp.join(imagedir, "*.png")))[skip::stride]


def read_frames(images):
    """(t, image, intrinsics): undistorted, cropped to multiples of 16."""
    import cv2
    K = np.eye(3)
    K[0, 0], K[0, 2] = EUROC_CALIB[0], EUROC_CALIB[2]
    K[1, 1], K[1, 2] = EUROC_CALIB[1], EUROC_CALIB[3]
    for t, imfile in enumerate(images):
        image = cv2.undistort(cv2.imread(imfile), K, EUROC_CALIB[4:])
        h, w = image.shape[:2]
        yield t, image[:h - h % 16, :w - w % 16], EUROC_CALIB[:4]


def run_sequence(cfg, network, imagedir, stride=2, skip=0, device="cuda"):
    """-> (poses, tstamps in seconds from the file names)."""
    images = image_files(imagedir, stride, skip)
    poses, _ = run_frames(cfg, network, read_frames(images), device)
    return poses, np.array([float(osp.basename(f)[:-4]) / 1e9
                            for f in images])


def load_groundtruth(seq_path):
    gt_file = osp.join(seq_path, "mav0/state_groundtruth_estimate0/data.csv")
    data = np.loadtxt(gt_file, delimiter=",", skiprows=1)
    tstamps = data[:, 0] / 1e9
    # csv is [t, px py pz, qw qx qy qz, ...] -> xyz + qxyzw
    poses = np.concatenate([data[:, 1:4], data[:, 5:8], data[:, 4:5]],
                           axis=1)
    return tstamps, poses


def score(poses, tstamps, gt_t, gt_p):
    """Sim3 ATE over the estimates within 0.02 s of a groundtruth sample."""
    ii, jj = associate_trajectories(tstamps, gt_t, max_diff=0.02)
    return ate_rmse(poses[ii], gt_p[jj], correct_scale=True)


def main(argv=None):
    args = eval_parser(__doc__.splitlines()[0], "datasets/EuRoC",
                       2).parse_args(argv)
    cfg = eval_config(args)

    results = {}
    for scene in euroc_scenes:
        seq = osp.join(args.datapath, scene)
        imagedir = osp.join(seq, "mav0/cam0/data")
        if not osp.isdir(imagedir):
            print(f"skipping missing {scene}")
            continue
        poses, tstamps = run_sequence(cfg, args.network, imagedir,
                                      args.stride, device=args.device)
        results[scene] = score(poses, tstamps, *load_groundtruth(seq))
        print(f"{scene}: ATE {results[scene]:.4f}")

    if results:
        print("AVG:", np.mean(list(results.values())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
