"""Redwood indoor RGB-D dataset reader.

Copy of ``dpvo_tpu/data/redwood.py``.  Layout: root/{train,validation,
test}/{scene}/{image/*.jpg, depth/*.png, {scene}.json} with a shared
root/intrinsic.npy (3x3).  Depth is uint16 millimetres; poses come from a
PoseGraph JSON whose node poses are column-major 4x4 matrices.  The pickle
cache lives inside the dataset root (``cache/Redwood_{mode}.pickle``, the
JAX package's file and format, so a cache built by either package loads in
the other).  ``cv2`` and ``scipy`` are imported where they are used.
"""
from __future__ import annotations

import glob
import json
import os
import os.path as osp
import pickle

import numpy as np

from .base import RGBDDataset


def _matrix_to_pose(T):
    """4x4 -> [tx ty tz qx qy qz qw]."""
    from scipy.spatial.transform import Rotation
    t = T[:3, 3]
    q = Rotation.from_matrix(T[:3, :3]).as_quat()
    return np.concatenate([t, q])


class Redwood(RGBDDataset):
    DEPTH_SCALE = 1.0
    DEPTH_MM_TO_M = 1000.0

    def __init__(self, mode="train", **kwargs):
        self.mode = mode
        self.__class__.CACHE_NAME = f"Redwood_{mode}"
        super().__init__(name="Redwood", **kwargs)

    def _load_or_build_scene_info(self, _cache_dir):
        """The cache lives in the dataset root, not in ``cache_dir``."""
        cache_dir = osp.join(self.root, "cache")
        os.makedirs(cache_dir, exist_ok=True)
        cache_path = osp.join(cache_dir,
                              f"{self.__class__.CACHE_NAME}.pickle")
        if osp.isfile(cache_path):
            print(f"Loading {self.__class__.CACHE_NAME} from cache: "
                  f"{cache_path}")
            with open(cache_path, "rb") as f:
                return pickle.load(f)
        print(f"Building {self.__class__.CACHE_NAME} dataset...")
        print("Hint: scripts/build_redwood_pickle_torch.py builds with "
              "stride")
        scene_info = self._build_dataset()
        with open(cache_path, "wb") as f:
            pickle.dump(scene_info, f)
        return scene_info

    @staticmethod
    def is_test_scene(scene):
        return False  # the splits are folders

    def load_intrinsic(self):
        path = osp.join(self.root, "intrinsic.npy")
        if osp.isfile(path):
            K = np.load(path)
            return np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]])
        print("Warning: intrinsic.npy not found, using PrimeSense default")
        return self.calib_read()

    def _build_dataset(self):
        scene_info = {}
        mode_path = osp.join(self.root, self.mode)
        if not osp.isdir(mode_path):
            raise ValueError(f"Mode path does not exist: {mode_path}")
        intrinsic = self.load_intrinsic()

        for scene_path in sorted(glob.glob(osp.join(mode_path, "*"))):
            scene_name = osp.basename(scene_path)
            images = sorted(osp.abspath(p) for p in glob.glob(
                osp.join(scene_path, "image", "*.jpg")))
            depths = sorted(osp.abspath(p) for p in glob.glob(
                osp.join(scene_path, "depth", "*.png")))
            if not images or not depths:
                print(f"Skipping {scene_name}: no images or depths")
                continue
            n = min(len(images), len(depths))
            images, depths = images[:n], depths[:n]

            json_file = osp.join(scene_path, f"{scene_name}.json")
            if not osp.isfile(json_file):
                print(f"Skipping {scene_name}: pose file not found")
                continue
            poses = self._load_poses_from_json(json_file)
            n = min(n, len(poses))
            images, depths, poses = images[:n], depths[:n], poses[:n]
            poses[:, :3] /= Redwood.DEPTH_SCALE

            intrinsics = [intrinsic.copy() for _ in range(n)]
            graph = self.build_frame_graph(poses, depths, intrinsics)
            scene_info[f"{self.mode}/{scene_name}"] = {
                "images": images, "depths": depths, "poses": poses,
                "intrinsics": intrinsics, "graph": graph}
            print(f"  {scene_name}: {n} frames")
        return scene_info

    @staticmethod
    def _load_poses_from_json(json_file):
        with open(json_file) as f:
            data = json.load(f)
        poses = []
        for node in data["nodes"]:
            # column-major 16 floats -> row-major 4x4
            T = np.array(node["pose"], np.float32).reshape(4, 4).T
            poses.append(_matrix_to_pose(T))
        return np.array(poses, np.float32)

    @staticmethod
    def calib_read():
        return np.array([525.0, 525.0, 319.5, 239.5])

    @staticmethod
    def image_read(image_file):
        import cv2
        return cv2.imread(image_file)

    @staticmethod
    def depth_read(depth_file):
        import cv2
        depth = cv2.imread(depth_file, cv2.IMREAD_UNCHANGED)
        depth = depth.astype(np.float32) / Redwood.DEPTH_MM_TO_M
        depth[depth == 0] = 1.0
        depth[np.isnan(depth)] = 1.0
        depth[np.isinf(depth)] = 1.0
        return depth / Redwood.DEPTH_SCALE
