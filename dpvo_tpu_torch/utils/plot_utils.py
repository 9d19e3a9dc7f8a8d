"""Trajectory plotting and map export.

Counterpart of ``dpvo_tpu/utils/plot_utils.py``, writing the same bytes:
TUM-format trajectory text, an ASCII PLY point cloud, a COLMAP sparse text
directory, and a PDF trajectory plot (matplotlib, skipped with a warning
where it is missing).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np


def save_trajectory_tum_format(poses, tstamps, path):
    """poses (T, 7) [x y z qx qy qz qw], one ``t x y z qx qy qz qw`` line
    per frame."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        for t, p in zip(tstamps, poses):
            vals = " ".join(f"{x:.8f}" for x in p)
            f.write(f"{t:.6f} {vals}\n")


def plot_trajectory(poses, tstamps, title="DPVO", filename="trajectory.pdf"):
    """2D top-down (x, z) trajectory plot."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("WARNING: matplotlib unavailable, skipping plot")
        return
    Path(filename).parent.mkdir(parents=True, exist_ok=True)
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.plot(poses[:, 0], poses[:, 2], "b-", lw=1)
    ax.scatter(poses[0, 0], poses[0, 2], c="g", marker="o", label="start")
    ax.scatter(poses[-1, 0], poses[-1, 2], c="r", marker="x", label="end")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_title(title)
    ax.axis("equal")
    ax.legend()
    fig.savefig(filename)
    plt.close(fig)


def save_ply(path, points, colors=None):
    """ASCII PLY of the finite points (and their uint8 RGB colors)."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    points = np.asarray(points)
    ok = np.isfinite(points).all(axis=-1)
    points = points[ok]
    if colors is not None:
        colors = np.asarray(colors)[ok]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(points)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write("end_header\n")
        for i, p in enumerate(points):
            line = f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}"
            if colors is not None:
                c = colors[i]
                line += f" {int(c[0])} {int(c[1])} {int(c[2])}"
            f.write(line + "\n")


def save_output_for_COLMAP(name, poses, tstamps, points, colors,
                           fx, fy, cx, cy, H, W):
    """COLMAP sparse text: cameras.txt, images.txt, points3D.txt under
    directory ``name``."""
    colmap_dir = Path(name)
    colmap_dir.mkdir(parents=True, exist_ok=True)

    with open(colmap_dir / "cameras.txt", "w") as f:
        f.write(f"1 PINHOLE {W} {H} {fx} {fy} {cx} {cy}\n")

    with open(colmap_dir / "images.txt", "w") as f:
        for i, (t, p) in enumerate(zip(tstamps, poses)):
            # COLMAP wants world-to-camera qw qx qy qz tx ty tz
            x, y, z, qx, qy, qz, qw = p
            f.write(f"{i+1} {qw} {qx} {qy} {qz} {x} {y} {z} 1 {t:.3f}.png\n")
            f.write("\n")

    with open(colmap_dir / "points3D.txt", "w") as f:
        pts = np.asarray(points)
        cls = np.asarray(colors).reshape(-1, 3) if colors is not None \
            else np.full((len(pts), 3), 128)
        for i, p in enumerate(pts):
            if not np.isfinite(p).all():
                continue
            c = cls[i % len(cls)]
            f.write(f"{i+1} {p[0]} {p[1]} {p[2]} "
                    f"{int(c[0])} {int(c[1])} {int(c[2])} 0\n")
