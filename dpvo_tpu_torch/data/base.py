"""Base RGB-D training dataset.

Copy of ``dpvo_tpu/data/base.py``: numpy arrays in channels-last layout, a
pickle-cached scene_info with a flow-based co-visibility graph, flow-
targeted frame sampling (numpy's global random state, as the JAX package
draws it), safe disparities with invalid masking, and the 0.7 * q98 scale
normalisation.  The co-visibility graph is computed on ``device`` through
the port's ``induced_flow`` (``rgbd_utils``).
"""
from __future__ import annotations

import os
import os.path as osp
import pickle

import numpy as np

from .augmentation import RGBDAugmentor
from .rgbd_utils import compute_distance_matrix_flow


class RGBDDataset:
    DEPTH_SCALE = 1.0
    CACHE_NAME = None

    def __init__(self, name, datapath, n_frames=4, crop_size=(480, 640),
                 fmin=10.0, fmax=75.0, aug=True, sample=True,
                 cache_dir=None, device="cuda"):
        self.root = datapath
        self.name = name
        self.n_frames = n_frames
        self.fmin = fmin   # exclude very easy examples
        self.fmax = fmax   # exclude very hard examples
        self.sample = sample
        self.device = device
        self.aug = RGBDAugmentor(crop_size=crop_size) if aug else None

        if cache_dir is None:
            cache_dir = osp.join(osp.dirname(osp.abspath(__file__)),
                                 "cache")
        os.makedirs(cache_dir, exist_ok=True)
        self.scene_info = self._load_or_build_scene_info(cache_dir)
        self._build_dataset_index()

    # --- scene info --------------------------------------------------------

    def _load_or_build_scene_info(self, cache_dir):
        cache_name = self.__class__.CACHE_NAME or self.name
        cache_path = osp.join(cache_dir, f"{cache_name}.pickle")
        if osp.isfile(cache_path):
            print(f"Loading {cache_name} from cache: {cache_path}")
            data = pickle.load(open(cache_path, "rb"))
            if isinstance(data, tuple) and len(data) == 1:
                data = data[0]
            return data
        print(f"Building {cache_name} dataset (this may take a while)...")
        scene_info = self._build_dataset()
        pickle.dump(scene_info, open(cache_path, "wb"))
        print(f"Saved cache to: {cache_path}")
        return scene_info

    def _build_dataset(self):
        raise NotImplementedError

    def _build_dataset_index(self):
        """Training mode indexes non-test scenes (ref base.py:70-80);
        validation mode indexes ONLY the held-out test scenes, so a
        ``mode="validation"`` dataset actually samples the reserved
        split instead of silently re-serving training scenes."""
        want_test = getattr(self, "mode", "training") == "validation"
        self.dataset_index = []
        for scene in self.scene_info:
            if self.__class__.is_test_scene(scene) == want_test:
                graph = self.scene_info[scene]["graph"]
                for i in graph:
                    if i < len(graph) - 65:
                        self.dataset_index.append((scene, i))
            elif not want_test:
                print(f"Reserving {scene} for validation")

    @staticmethod
    def is_test_scene(scene):
        return False

    @staticmethod
    def image_read(image_file):
        import cv2
        return cv2.imread(image_file)

    @staticmethod
    def depth_read(depth_file):
        return np.load(depth_file)

    def build_frame_graph(self, poses, depths, intrinsics, f=16,
                          max_flow=256):
        """Optical-flow distance between all frame pairs
        (ref base.py:93-111)."""
        def read_disp(fn):
            depth = self.__class__.depth_read(fn)[f // 2::f, f // 2::f]
            depth[depth < 0.01] = np.mean(depth)
            return 1.0 / depth

        poses = np.array(poses)
        intrinsics = np.array(intrinsics) / f
        disps = np.stack(list(map(read_disp, depths)), 0)
        d = f * compute_distance_matrix_flow(poses, disps, intrinsics[0],
                                             device=self.device)

        graph = {}
        for i in range(d.shape[0]):
            (j,) = np.where(d[i] < max_flow)
            graph[i] = (j, d[i, j])
        return graph

    # --- sampling ----------------------------------------------------------

    def _sample_frame_indices(self, scene_id, ix):
        """Flow-targeted frame walk (ref base.py:127-167)."""
        frame_graph = self.scene_info[scene_id]["graph"]
        images_list = self.scene_info[scene_id]["images"]

        d = np.random.uniform(self.fmin, self.fmax)
        s = 1
        inds = [ix]
        while len(inds) < self.n_frames:
            if self.sample:
                k = (frame_graph[ix][1] > self.fmin) \
                    & (frame_graph[ix][1] < self.fmax)
                frames = frame_graph[ix][0][k]
                if np.count_nonzero(frames[frames > ix]):
                    ix = np.random.choice(frames[frames > ix])
                elif ix + 1 < len(images_list):
                    ix = ix + 1
                elif np.count_nonzero(frames):
                    ix = np.random.choice(frames)
            else:
                i = frame_graph[ix][0].copy()
                g = frame_graph[ix][1].copy()
                g[g > d] = -1
                if s > 0:
                    g[i <= ix] = -1
                else:
                    g[i >= ix] = -1
                if len(g) > 0 and np.max(g) > 0:
                    ix = i[np.argmax(g)]
                else:
                    if ix + s >= len(images_list) or ix + s < 0:
                        s *= -1
                    ix = ix + s
            inds.append(ix)
        return inds

    def __getitem__(self, index):
        """-> (images (N, H, W, 3) f32 BGR, poses (N, 7), disps (N, H, W),
        intrinsics (N, 4)), scale-normalized."""
        index = index % len(self.dataset_index)
        scene_id, ix = self.dataset_index[index]
        info = self.scene_info[scene_id]

        inds = self._sample_frame_indices(scene_id, ix)

        images, depths, poses, intrinsics = [], [], [], []
        for i in inds:
            images.append(self.__class__.image_read(info["images"][i]))
            depths.append(self.__class__.depth_read(info["depths"][i]))
            poses.append(info["poses"][i])
            intrinsics.append(info["intrinsics"][i])

        images = np.stack(images).astype(np.float32)
        depths = np.stack(depths).astype(np.float32)
        poses = np.stack(poses).astype(np.float32)
        intrinsics = np.stack(intrinsics).astype(np.float32)

        # safe disparity with invalid masking (ref base.py:182-192)
        max_depth, min_depth = 20.0, 0.1
        invalid = (depths > max_depth) | (depths < min_depth)
        disps = 1.0 / np.where(invalid, 1.0, depths)
        disps[invalid] = 0.0

        if self.aug is not None:
            images, poses, disps, intrinsics = self.aug(
                images, poses, disps, intrinsics)

        # scale normalization (ref base.py:206-208)
        s = 0.7 * np.quantile(disps, 0.98)
        if s > 0:
            disps = disps / s
            poses = poses.copy()
            poses[..., :3] *= s

        return images, poses, disps, intrinsics

    def __len__(self):
        return len(self.dataset_index)

    def __imul__(self, x):
        self.dataset_index *= x
        return self
