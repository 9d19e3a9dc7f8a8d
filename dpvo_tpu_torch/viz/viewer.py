"""Background 3D map viewer.

Counterpart of ``dpvo_tpu/viz/viewer.py``: a daemon thread renders the
point cloud, the camera trajectory with wireframe frusta and the latest
frame into ``out_dir/latest.png`` (matplotlib's Agg canvas) every
``period`` seconds, and ``join()`` renders once more and writes the
interactive ``map.html`` (``viz.html_map.export_html``).  The engine-facing
API is the JAX package's: ``Viewer(slam)``, ``update_image(image)``,
``join()``, plus ``snapshot()``.

Two differences from the JAX viewer:

- nothing is swallowed: construction raises an ``ImportError`` naming
  matplotlib when it is missing, the render thread keeps its first
  exception and stops, and ``join()`` re-raises it;
- the render thread reads no live engine state.  The engine writes its
  poses, patches and edge tables in place from its own thread, so it calls
  ``snapshot()`` once per frame, which at most once per ``period`` copies
  ``n``, the poses, the points at the patch centres and the colors (and
  the latest frame) into fresh host buffers (pinned, with a CUDA event
  behind the copies on the card).  The thread waits on that event and
  renders host numpy only.
"""
from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..ops import lie

JOIN_TIMEOUT_S = 120.0


def _frustum_segments(pose_c2w, size=0.12):
    """Wireframe camera frustum line segments in world coordinates.

    pose_c2w: (7,) camera-to-world xyz+quat.  Returns a list of 8 (2, 3)
    numpy segments: apex to each corner, then the image-plane rectangle."""
    w, h, z = size, 0.75 * size, 1.6 * size
    corners = np.array([[w, h, z], [w, -h, z], [-w, -h, z], [-w, h, z]],
                       np.float32)
    pts = np.concatenate([np.zeros((1, 3), np.float32), corners])
    pose = torch.as_tensor(np.asarray(pose_c2w, np.float32))
    world = lie.se3_act(pose[None], torch.from_numpy(pts)).numpy()
    apex, c = world[0], world[1:]
    segs = [np.stack([apex, c[k]]) for k in range(4)]
    segs += [np.stack([c[k], c[(k + 1) % 4]]) for k in range(4)]
    return segs


@dataclass
class Snapshot:
    """The map at one moment, in host memory.  ``event`` (on the card)
    completes when the copies have landed."""
    n: int
    m: int
    poses: torch.Tensor       # (n, 7) world-to-camera
    points: torch.Tensor      # (m, 3) world points at the patch centres
    colors: torch.Tensor      # (n, M, 3) uint8
    image: Any                # latest frame (H, W, 3) uint8 BGR, or None
    event: Any = None

    def host(self):
        """-> (poses, points, colors (m, 3), image) as numpy, after the
        copies have landed."""
        if self.event is not None:
            self.event.synchronize()
        image = self.image
        if torch.is_tensor(image):
            image = image.numpy()
        colors = self.colors.numpy().reshape(-1, 3)[:self.m]
        return self.poses.numpy(), self.points.numpy(), colors, image


def _to_host(x, pinned):
    buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=pinned)
    buf.copy_(x, non_blocking=pinned)
    return buf


def take_snapshot(slam, image=None):
    """The engine's map now, copied into fresh host buffers (pinned, with a
    CUDA event behind the copies, on the card); call it on the engine's
    thread.  ``image`` (a tensor or numpy frame) goes with it."""
    n, m = slam.n, slam.m
    pinned = slam.device.type == "cuda"
    if torch.is_tensor(image):
        image = _to_host(image, pinned and image.is_cuda)
    snap = Snapshot(n, m, _to_host(slam.ds.poses[:n], pinned),
                    _to_host(slam.points[:m], pinned),
                    _to_host(slam.ds.colors[:n], pinned), image)
    if pinned:
        snap.event = torch.cuda.Event()
        snap.event.record(torch.cuda.current_stream(slam.device))
    return snap


class Viewer:
    def __init__(self, slam, out_dir="viewer_out", period=2.0):
        try:
            from matplotlib.figure import Figure  # noqa: F401
            from mpl_toolkits import mplot3d  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "the viewer (viz=True) renders with matplotlib, which is "
                "not installed") from e
        self.slam = slam
        self.out_dir = out_dir
        self.period = period
        os.makedirs(out_dir, exist_ok=True)

        self._image = None
        self._snap = None           # the newest snapshot
        self._rendered = None       # the snapshot the thread drew last
        self._last_snap = -float("inf")
        self._error = None          # the render thread's first exception
        self._counter = 0           # PNG renders written
        self._lock = threading.Lock()   # snapshot / image handoff
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="dpvo-viewer")
        self._thread.start()

    # --- the engine's side --------------------------------------------------

    def update_image(self, image):
        """Keep the newest frame (a copy: callers reuse their buffers)."""
        image = (image.detach().clone() if torch.is_tensor(image)
                 else np.array(image, copy=True))
        with self._lock:
            self._image = image

    def snapshot(self, force=False):
        """Copy the map to host memory if ``period`` has passed since the
        last copy (or ``force``); runs on the engine's thread.  Returns
        whether it copied."""
        now = time.monotonic()
        if not force and now - self._last_snap < self.period:
            return False
        self._last_snap = now
        with self._lock:
            image = self._image
        snap = take_snapshot(self.slam, image)
        with self._lock:
            self._snap = snap
        return True

    def join(self):
        """Stop the thread, re-raise its error if it had one, then render
        the final map and write ``map.html`` (on the caller's thread)."""
        self._stop.set()
        self._thread.join(timeout=JOIN_TIMEOUT_S)
        if self._thread.is_alive():
            raise RuntimeError(
                f"the viewer's render thread did not stop within "
                f"{JOIN_TIMEOUT_S} s")
        if self._error is not None:
            raise self._error
        self.snapshot(force=True)
        self._render(self._snap)
        self._export_html(self._snap)

    # --- the render thread --------------------------------------------------

    def _loop(self):
        try:
            while not self._stop.is_set():
                with self._lock:
                    snap = self._snap
                if snap is not None and snap is not self._rendered:
                    self._render(snap)
                    self._rendered = snap
                self._stop.wait(self.period)
        except Exception as e:      # re-raised by join()
            self._error = e

    def _render(self, snap):
        from matplotlib.figure import Figure
        from mpl_toolkits import mplot3d  # noqa: F401  (the 3d projection)

        n = snap.n
        if n < 2:
            return
        poses, points, colors, img = snap.host()
        ok = np.isfinite(points).all(axis=1)
        ok &= np.linalg.norm(points, axis=1) < 50.0
        pts = points[ok]
        cls = colors[ok] / 255.0

        fig = Figure(figsize=(10, 5))
        ax = fig.add_subplot(121, projection="3d")
        if len(pts):
            ax.scatter(pts[:, 0], pts[:, 2], -pts[:, 1], s=0.5,
                       c=cls[:, ::-1])
        # camera trajectory and wireframe frusta
        inv = lie.se3_inv(torch.from_numpy(poses)).numpy()
        cams = inv[:, :3]
        ax.plot(cams[:, 0], cams[:, 2], -cams[:, 1], "r-", lw=1)
        for k in range(0, n, max(n // 12, 1)):
            for seg in _frustum_segments(inv[k]):
                ax.plot(seg[:, 0], seg[:, 2], -seg[:, 1], "g-", lw=0.5)
        ax.set_title(f"map (n={n}, pts={len(pts)})")

        ax2 = fig.add_subplot(122)
        if img is not None:
            ax2.imshow(img[..., ::-1])
        ax2.axis("off")
        ax2.set_title("current frame")

        fig.savefig(os.path.join(self.out_dir, "latest.png"), dpi=80)
        self._counter += 1

    def _export_html(self, snap):
        """The interactive map: points, trajectory and frusta embedded in
        one HTML file (``viz.html_map``)."""
        from .html_map import export_html

        n = snap.n
        if n < 2:
            return
        poses, pts, colors, img = snap.host()
        inv = lie.se3_inv(torch.from_numpy(poses)).numpy()
        segs = []
        for k in range(0, n, max(n // 24, 1)):
            segs += _frustum_segments(inv[k])
        export_html(os.path.join(self.out_dir, "map.html"), pts,
                    colors[:, ::-1], inv[:, :3], segs, image=img)
