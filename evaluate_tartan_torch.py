#!/usr/bin/env python
"""TartanAir evaluation with the PyTorch/CUDA port.

The counterpart of ``evaluate_tartan.py``, argument for argument, plus
``--device`` (default the GPU): runs the validation (or test) split, scores
Sim3-aligned ATE RMSE per scene (median over trials), and reports AUC =
mean(max(1 - ATE, 0)) and the average of the scene medians, written to
``results/tartan_<stamp>.txt``.

    python evaluate_tartan_torch.py --network dpvo.pth --datapath DIR
"""
import glob
import os
import os.path as osp
import sys
from datetime import datetime

import numpy as np

from dpvo_tpu_torch.data.tartan import test_split
from dpvo_tpu_torch.utils.evaluation import (ate_rmse, eval_config,
                                             eval_parser,
                                             load_tartan_pose_file,
                                             run_frames)

test_sequences = [f"MH{i:03d}" for i in range(8)]  # mono test split
INTRINSICS = np.array([320.0, 320.0, 320.0, 240.0])


def read_frames(scene_path, stride=1):
    """(t, image, intrinsics) of ``image_left/*.png``, every ``stride``-th."""
    import cv2
    images = sorted(glob.glob(osp.join(scene_path, "image_left/*.png")))
    if len(images) == 0:
        raise FileNotFoundError(f"no images in {scene_path}")
    for t, imfile in enumerate(images[::stride]):
        yield t, cv2.imread(imfile), INTRINSICS


def run_sequence(cfg, network, scene_path, stride=1, device="cuda"):
    return run_frames(cfg, network, read_frames(scene_path, stride), device)


def score(poses, traj_ref):
    """Sim3 ATE over the frames both trajectories have."""
    n = min(len(poses), len(traj_ref))
    return ate_rmse(poses[:n], traj_ref[:n], correct_scale=True)


def evaluate_scene(cfg, network, scene_path, trials=1, stride=1,
                   device="cuda"):
    traj_ref = load_tartan_pose_file(
        osp.join(scene_path, "pose_left.txt"))[::stride]
    return [score(run_sequence(cfg, network, scene_path, stride, device)[0],
                  traj_ref) for _ in range(trials)]


def summarize(results):
    """{scene: ATE} -> (AUC, AVG)."""
    ates = np.array(list(results.values()))
    return (float(np.mean(np.maximum(1.0 - ates, 0.0))),
            float(ates.mean()))


def main(argv=None):
    parser = eval_parser(__doc__.splitlines()[0], "datasets/TartanAir", 1)
    parser.add_argument("--split", choices=["validation", "test"],
                        default="validation")
    parser.add_argument("--trials", type=int, default=1)
    args = parser.parse_args(argv)
    cfg = eval_config(args)

    if args.split == "validation":
        scenes = [osp.join(args.datapath, s) for s in test_split]
    else:
        scenes = [osp.join(args.datapath, "mono", s)
                  for s in test_sequences]

    results = {}
    for scene in scenes:
        if not osp.isdir(scene):
            print(f"skipping missing scene {scene}")
            continue
        errs = evaluate_scene(cfg, args.network, scene, args.trials,
                              args.stride, args.device)
        results[scene] = float(np.median(errs))
        print(f"{scene}: ATE median {results[scene]:.4f} "
              f"(trials: {['%.4f' % e for e in errs]})")

    if results:
        auc, avg = summarize(results)
        print(f"AUC: {auc:.4f}  AVG: {avg:.4f}")

        stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
        os.makedirs("results", exist_ok=True)
        with open(f"results/tartan_{stamp}.txt", "w") as f:
            for k, v in results.items():
                f.write(f"{k} {v:.6f}\n")
            f.write(f"AUC {auc:.6f}\nAVG {avg:.6f}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
