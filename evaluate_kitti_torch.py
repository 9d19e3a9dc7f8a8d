#!/usr/bin/env python
"""KITTI odometry evaluation with the PyTorch/CUDA port.

The counterpart of ``evaluate_kitti.py``, argument for argument, plus
``--device`` (default the GPU): reads each sequence's ``image_0`` with the
P0 calibration, crops to multiples of 4, and scores Sim3-aligned ATE
against the groundtruth pose files.

    python evaluate_kitti_torch.py --network dpvo.pth --datapath DIR
"""
import glob
import os.path as osp
import sys

import numpy as np

from dpvo_tpu_torch.utils.evaluation import (ate_rmse, eval_config,
                                             eval_parser, run_frames)


def read_calib(seq_path):
    """P0 projection matrix -> [fx fy cx cy]."""
    calib_file = osp.join(seq_path, "calib.txt")
    with open(calib_file) as f:
        for line in f:
            if line.startswith("P0:"):
                P0 = np.array([float(x) for x in line.split()[1:]])
                P0 = P0.reshape(3, 4)
                return np.array([P0[0, 0], P0[1, 1], P0[0, 2], P0[1, 2]])
    raise ValueError(f"P0 not found in {calib_file}")


def load_kitti_gt(gt_file):
    """KITTI pose file: 3x4 row-major world-from-camera matrices."""
    data = np.loadtxt(gt_file).reshape(-1, 3, 4)
    return data[:, :, 3]  # translations suffice for ATE


def read_frames(seq_path, stride=1):
    """(t, image, intrinsics): gray frames as BGR, cropped to multiples
    of 4."""
    import cv2
    intrinsics = read_calib(seq_path)
    images = sorted(glob.glob(osp.join(seq_path, "image_0/*.png")))[::stride]
    for t, imfile in enumerate(images):
        image = cv2.imread(imfile)
        if image.ndim == 2 or image.shape[2] == 1:
            image = cv2.cvtColor(image, cv2.COLOR_GRAY2BGR)
        h, w = image.shape[:2]
        yield t, image[:h - h % 4, :w - w % 4], intrinsics


def run_sequence(cfg, network, seq_path, stride=1, device="cuda"):
    return run_frames(cfg, network, read_frames(seq_path, stride), device)


def score(poses, gt_t):
    """Sim3 ATE over the frames both trajectories have."""
    n = min(len(poses), len(gt_t))
    return ate_rmse(poses[:n], gt_t[:n], correct_scale=True)


def main(argv=None):
    parser = eval_parser(__doc__.splitlines()[0], "datasets/KITTI/odometry",
                         1)
    parser.add_argument("--sequences", nargs="+",
                        default=[f"{i:02d}" for i in range(11)])
    args = parser.parse_args(argv)
    cfg = eval_config(args)

    results = {}
    for seq in args.sequences:
        seq_path = osp.join(args.datapath, "sequences", seq)
        gt_file = osp.join(args.datapath, "poses", f"{seq}.txt")
        if not osp.isdir(seq_path) or not osp.isfile(gt_file):
            print(f"skipping missing {seq}")
            continue
        poses, _ = run_sequence(cfg, args.network, seq_path, args.stride,
                                args.device)
        results[seq] = score(poses, load_kitti_gt(gt_file)[::args.stride])
        print(f"{seq}: ATE {results[seq]:.4f}")

    if results:
        print("AVG:", np.mean(list(results.values())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
