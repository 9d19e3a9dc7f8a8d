"""RGB-D augmentation, numpy/cv2 native.

Copy of ``dpvo_tpu/data/augmentation.py`` (``cv2`` is imported inside the
functions that need it).

Color jitter in random order (brightness/contrast/saturation/hue) +
grayscale/invert at p=0.1, applied in RGB space with the BGR round-trip
the reference does (augmentation.py:58-100); random 2^U(log2(min), +0.5)
scale with p=0.8 and random crop with intrinsics adjustment (:20-56).
Operates on channels-last arrays.
"""
from __future__ import annotations

import numpy as np


def _adjust_brightness(img, factor):
    return np.clip(img * factor, 0.0, 1.0)


def _adjust_contrast(img, factor):
    # torchvision: blend with the mean of the grayscale image
    gray = (0.299 * img[..., 0] + 0.587 * img[..., 1]
            + 0.114 * img[..., 2]).mean()
    return np.clip(gray + factor * (img - gray), 0.0, 1.0)


def _adjust_saturation(img, factor):
    gray = (0.299 * img[..., 0] + 0.587 * img[..., 1]
            + 0.114 * img[..., 2])[..., None]
    return np.clip(gray + factor * (img - gray), 0.0, 1.0)


def _adjust_hue(img, factor):
    import cv2
    hsv = cv2.cvtColor((img * 255).astype(np.uint8), cv2.COLOR_RGB2HSV)
    h = hsv[..., 0].astype(np.int32)
    h = (h + int(factor * 180)) % 180
    hsv[..., 0] = h.astype(np.uint8)
    out = cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)
    return out.astype(np.float32) / 255.0


class RGBDAugmentor:
    def __init__(self, crop_size=(480, 640)):
        self.crop_size = tuple(crop_size)
        self.max_scale = 0.5
        self.brightness = 0.4
        self.contrast = 0.4
        self.saturation = 0.4
        self.hue = 0.2 / 3.14

    def color_transform(self, images):
        """images (N, H, W, 3) BGR float [0, 255]."""
        N, H, W, _ = images.shape
        # process as one wide RGB image in [0, 1] (ref :62-66)
        img = images[..., ::-1] / 255.0
        img = img.transpose(1, 0, 2, 3).reshape(H, N * W, 3)

        for fn_id in np.random.permutation(4):
            if fn_id == 0:
                img = _adjust_brightness(
                    img, 1 + np.random.uniform(-self.brightness,
                                               self.brightness))
            elif fn_id == 1:
                img = _adjust_contrast(
                    img, 1 + np.random.uniform(-self.contrast,
                                               self.contrast))
            elif fn_id == 2:
                img = _adjust_saturation(
                    img, 1 + np.random.uniform(-self.saturation,
                                               self.saturation))
            else:
                img = _adjust_hue(img, np.random.uniform(-self.hue,
                                                         self.hue))

        if np.random.rand() < 0.1:   # grayscale
            gray = (0.299 * img[..., 0] + 0.587 * img[..., 1]
                    + 0.114 * img[..., 2])[..., None]
            img = np.repeat(gray, 3, axis=-1)
        if np.random.rand() < 0.1:   # invert
            img = 1.0 - img

        img = img.reshape(H, N, W, 3).transpose(1, 0, 2, 3)
        return np.ascontiguousarray(img[..., ::-1] * 255.0,
                                    dtype=np.float32)

    def spatial_transform(self, images, depths, poses, intrinsics):
        """Random scale + random crop, adjusting intrinsics (ref :20-56)."""
        import cv2
        N, ht, wd, _ = images.shape
        ch, cw = self.crop_size

        min_scale = max(ch / ht, cw / wd, 1.0)
        scale = min_scale
        if np.random.rand() < 0.8:
            scale = 2 ** np.random.uniform(np.log2(min_scale),
                                           np.log2(min_scale)
                                           + self.max_scale)
        intrinsics = intrinsics * scale

        ht1, wd1 = int(scale * ht), int(scale * wd)
        imgs, dps = [], []
        for i in range(N):
            imgs.append(cv2.resize(images[i], (wd1, ht1),
                                   interpolation=cv2.INTER_CUBIC))
            dps.append(cv2.resize(depths[i], (wd1, ht1),
                                  interpolation=cv2.INTER_NEAREST))
        images = np.stack(imgs)
        depths = np.stack(dps)

        max_y0 = max(0, ht1 - ch)
        max_x0 = max(0, wd1 - cw)
        y0 = np.random.randint(0, max_y0 + 1) if max_y0 > 0 else 0
        x0 = np.random.randint(0, max_x0 + 1) if max_x0 > 0 else 0

        intrinsics = intrinsics - np.array([0.0, 0.0, x0, y0],
                                           np.float32)
        images = images[:, y0:y0 + ch, x0:x0 + cw]
        depths = depths[:, y0:y0 + ch, x0:x0 + cw]
        return images, poses, depths, intrinsics

    def __call__(self, images, poses, disps, intrinsics):
        if np.random.rand() < 0.5:
            images = self.color_transform(images)
        return self.spatial_transform(images, disps, poses, intrinsics)
