"""Async JPEG spill cache for full-resolution frames.

Copy of ``dpvo_tpu/loop_closure/retrieval/image_cache.py`` (this package
imports nothing of ``dpvo_tpu``): frames are JPEG-compressed to a temp dir
by a 1-worker spawned pool so the classic loop-closure path can reload
full-res triplets later without holding every frame in RAM.
Keyframe-index remapping mirrors the engine's.
"""
from __future__ import annotations

import multiprocessing as mp
import os.path as osp
import shutil
import tempfile

import numpy as np


def _write_image(path, image):
    import cv2
    cv2.imwrite(path, image, [cv2.IMWRITE_JPEG_QUALITY, 90])


class ImageCache:
    def __init__(self):
        self.dir = tempfile.mkdtemp(prefix="dpvo_tpu_torch_imcache_")
        ctx = mp.get_context("spawn")
        self.pool = ctx.Pool(1)
        self.remap = []

    def __call__(self, image, n):
        while len(self.remap) <= n:
            self.remap.append(len(self.remap))
        path = osp.join(self.dir, f"{n:08d}.jpg")
        self.pool.apply_async(_write_image,
                              (path, np.ascontiguousarray(image)))

    def keyframe(self, k):
        for i in range(len(self.remap)):
            if self.remap[i] is not None and self.remap[i] > k:
                self.remap[i] -= 1
            elif self.remap[i] == k:
                self.remap[i] = None

    def load_frames(self, indices):
        """Reload cached frames by ORIGINAL submission index
        (ref image_cache.py:43-57)."""
        import cv2
        self.pool.close()
        self.pool.join()
        ctx = mp.get_context("spawn")
        self.pool = ctx.Pool(1)
        out = []
        for i in indices:
            path = osp.join(self.dir, f"{i:08d}.jpg")
            img = cv2.imread(path)
            out.append(img)
        return out

    def original_index(self, remapped):
        """Inverse remap: current keyframe index -> submission index."""
        for i, r in enumerate(self.remap):
            if r == remapped:
                return i
        return remapped

    def close(self):
        try:
            self.pool.close()
            self.pool.join()
        finally:
            shutil.rmtree(self.dir, ignore_errors=True)
