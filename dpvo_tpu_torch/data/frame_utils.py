"""Flow/depth file IO: .flo, KITTI 16-bit flow PNGs, PFM, DPT depth,
Sintel camera files.

Copy of ``dpvo_tpu/data/frame_utils.py`` (numpy; ``cv2`` is imported inside
the functions that need it).
"""
from __future__ import annotations

import re

import numpy as np

TAG_CHAR = np.array([202021.25], np.float32)


def readFlow(fn):
    """Read a middlebury .flo file (ref frame_utils.py:18-36)."""
    with open(fn, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic != 202021.25:
            print("Magic number incorrect. Invalid .flo file")
            return None
        w = int(np.fromfile(f, np.int32, count=1))
        h = int(np.fromfile(f, np.int32, count=1))
        data = np.fromfile(f, np.float32, count=2 * w * h)
        return np.resize(data, (h, w, 2))


def writeFlow(filename, uv, v=None):
    """Write a .flo file (ref frame_utils.py:81-103)."""
    n_bands = 2
    if v is None:
        assert uv.ndim == 3 and uv.shape[2] == 2
        u = uv[:, :, 0]
        v = uv[:, :, 1]
    else:
        u = uv
    assert u.shape == v.shape
    height, width = u.shape
    with open(filename, "wb") as f:
        TAG_CHAR.tofile(f)
        np.array(width).astype(np.int32).tofile(f)
        np.array(height).astype(np.int32).tofile(f)
        tmp = np.zeros((height, width * n_bands), np.float32)
        tmp[:, ::2] = u
        tmp[:, 1::2] = v
        tmp.tofile(f)


def readFlowKITTI(fn):
    """KITTI 16-bit flow PNG -> (flow, valid)."""
    import cv2
    flow = cv2.imread(fn, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR)
    flow = flow[:, :, ::-1].astype(np.float32)
    flow, valid = flow[:, :, :2], flow[:, :, 2]
    flow = (flow - 2 ** 15) / 64.0
    return flow, valid


def writeFlowKITTI(filename, uv):
    import cv2
    uv = 64.0 * uv + 2 ** 15
    valid = np.ones([uv.shape[0], uv.shape[1], 1])
    uv = np.concatenate([uv, valid], axis=-1).astype(np.uint16)
    cv2.imwrite(filename, uv[..., ::-1])


def readPFM(file):
    """PFM reader (ref frame_utils.py:39-78)."""
    with open(file, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise Exception("Not a PFM file.")

        dim_match = re.match(rb"^(\d+)\s(\d+)\s$", f.readline())
        if dim_match:
            width, height = map(int, dim_match.groups())
        else:
            raise Exception("Malformed PFM header.")

        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        if scale < 0:
            scale = -scale

        data = np.fromfile(f, endian + "f")
        shape = (height, width, 3) if color else (height, width)
        data = np.reshape(data, shape)
        return np.flipud(data)


def readDPT(filename):
    """DPT depth map (ref frame_utils.py:113-124)."""
    with open(filename, "rb") as f:
        tag = f.read(4)
        if tag != b"PIEH":
            raise Exception("bad tag in DPT file")
        w = np.frombuffer(f.read(4), "<i4")[0]
        h = np.frombuffer(f.read(4), "<i4")[0]
        data = np.frombuffer(f.read(), "<f4")
        return data.reshape(h, w)


def cam_read(filename):
    """Sintel camera file -> (intrinsics 3x3, extrinsics 3x4)
    (ref frame_utils.py:127-136)."""
    with open(filename, "rb") as f:
        tag = np.frombuffer(f.read(4), "<f4")[0]
        M = np.frombuffer(f.read(9 * 4), "<f4").reshape(3, 3)
        N = np.frombuffer(f.read(12 * 4), "<f4").reshape(3, 4)
        return M, N


def read_gen(file_name, pil=False):
    ext = file_name.split(".")[-1].lower()
    if ext in ("png", "jpeg", "ppm", "jpg"):
        import cv2
        return cv2.imread(file_name)
    if ext == "bin" or ext == "raw":
        return np.load(file_name)
    if ext == "flo":
        return readFlow(file_name).astype(np.float32)
    if ext == "pfm":
        flow = readPFM(file_name).astype(np.float32)
        return flow if len(flow.shape) == 2 else flow[:, :, :-1]
    return []
