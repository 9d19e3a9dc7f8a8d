"""The port's viewer (``dpvo_tpu_torch.viz``) against the JAX package's on
the CPU:

- ``dense.backproject_and_filter`` on tests/test_viz.py's plane case (the
  consistent plane survives, a corrupted depth map is rejected) and on a
  random case: points within 1e-5, colors and ``keep`` equal;
- ``viewer._frustum_segments`` within 1e-6;
- ``html_map.export_html`` byte for byte (with a video pane, NaN points
  and more points than ``max_points``);
- a CPU engine drive with ``viz=True`` writes ``latest.png`` and a
  ``map.html`` that embeds the finite points ``terminate()`` leaves;
- an error in the render thread surfaces at ``join()``, and with
  matplotlib hidden construction raises an ``ImportError`` naming it.
"""
import json
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpvo_tpu.ops import lie as jlie
from dpvo_tpu.viz import dense as jdense, html_map as jhtml
from dpvo_tpu.viz import viewer as jviewer
from dpvo_tpu_torch.config import VOConfig
from dpvo_tpu_torch.engine import DPVO
from dpvo_tpu_torch.viz import dense, html_map, viewer

torch.set_num_threads(1)


def _both(images, poses, disps, intr, index, **kw):
    want = jdense.backproject_and_filter(
        jnp.asarray(images), jnp.asarray(poses), jnp.asarray(disps),
        jnp.asarray(intr), jnp.int32(index), **kw)
    got = dense.backproject_and_filter(
        torch.from_numpy(images), torch.from_numpy(poses),
        torch.from_numpy(disps), torch.from_numpy(intr), index, **kw)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


def _check(got, want):
    (pg, cg, kg), (pw, cw, kw) = got, want
    assert pg.shape == pw.shape and cg.shape == cw.shape == (len(kg), 3)
    np.testing.assert_allclose(pg, pw, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(cg, cw)
    np.testing.assert_array_equal(kg, kw)


def _plane(N=4, H=12, W=16, scale=4):
    intr = np.tile(np.array([20.0, 20.0, W / 2.0, H / 2.0], np.float32),
                   (N, 1))
    xi = np.zeros((N, 6), np.float32)
    xi[:, 0] = 0.1 * np.arange(N)
    poses = np.array(jax.vmap(jlie.se3_exp)(jnp.asarray(xi)))
    disps = np.full((N, H, W), 0.2, np.float32)
    images = np.random.default_rng(0).integers(
        0, 255, (N, H * scale, W * scale, 3), np.uint8)
    return images, poses, disps, intr


def test_backproject_plane_matches_jax():
    images, poses, disps, intr = _plane()
    got, want = _both(images, poses, disps, intr, 0, thresh=2.0, scale=4,
                      min_count=2)
    _check(got, want)
    keep = got[2]
    assert keep.sum() > 0.5 * keep.size
    np.testing.assert_allclose(got[0][keep][:, 2], 5.0, atol=1e-3)
    bad = disps.copy()
    bad[0] *= 3.0
    got, want = _both(images, poses, bad, intr, 0, thresh=2.0, scale=4,
                      min_count=2)
    _check(got, want)
    assert got[2].sum() == 0


@pytest.mark.parametrize("index", [0, 3])
def test_backproject_random_matches_jax(index):
    """Random poses near a surface, noisy depths: some points kept, some
    rejected, some voting frames out of view."""
    rng = np.random.default_rng(7 + index)
    N, H, W, scale = 6, 15, 20, 2
    intr = np.tile(np.array([18.0, 18.0, W / 2.0, H / 2.0], np.float32),
                   (N, 1))
    xi = (rng.normal(size=(N, 6)) * 0.05).astype(np.float32)
    xi[:, 0] += 0.08 * np.arange(N)
    poses = np.array(jax.vmap(jlie.se3_exp)(jnp.asarray(xi)))
    disps = (0.25 + 0.002 * rng.normal(size=(N, H, W))).astype(np.float32)
    disps[:, :3] = 0.05          # below the 0.1 vote floor
    images = rng.integers(0, 255, (N, H * scale, W * scale, 3), np.uint8)
    got, want = _both(images, poses, disps, intr, index, thresh=2.0,
                      scale=scale, min_count=2)
    _check(got, want)
    assert 0 < got[2].sum() < got[2].size


def test_frustum_segments_match_jax():
    rng = np.random.default_rng(2)
    for _ in range(4):
        xi = rng.normal(size=6).astype(np.float32)
        pose = np.asarray(jlie.se3_exp(jnp.asarray(xi)))
        got = viewer._frustum_segments(pose)
        want = jviewer._frustum_segments(pose)
        assert len(got) == len(want) == 8
        for g, w in zip(got, want):
            assert g.shape == (2, 3)
            np.testing.assert_allclose(g, w, atol=1e-6)


def test_export_html_byte_equal(tmp_path):
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(700, 3)).astype(np.float32)
    pts[3] = np.nan
    cols = rng.integers(0, 255, (700, 3)).astype(np.uint8)
    cams = rng.normal(size=(10, 3)).astype(np.float32)
    segs = [rng.normal(size=(2, 3)).astype(np.float32) for _ in range(8)]
    img = rng.integers(0, 255, (24, 32, 3), np.uint8)
    for kw in ({}, {"image": img}, {"max_points": 300, "image": img}):
        a = jhtml.export_html(str(tmp_path / "j.html"), pts, cols, cams,
                              segs, **kw)
        b = html_map.export_html(str(tmp_path / "t.html"), pts, cols, cams,
                                 segs, **kw)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            ja, tb = fa.read(), fb.read()
        assert ja == tb and b"NaN" not in tb


CFG = dict(BUFFER_SIZE=64, PATCHES_PER_FRAME=8, REMOVAL_WINDOW=7,
           OPTIMIZATION_WINDOW=5, PATCH_LIFETIME=5, KEYFRAME_INDEX=4,
           KEYFRAME_THRESH=1e9, MIXED_PRECISION=False, EDGE_CAPACITY=512,
           BA_WINDOW_CAP=8)


def _drive(slam, n=14):
    base = np.random.default_rng(0).integers(0, 255, (96, 256, 3), np.uint8)
    slam.motion_probe = lambda: 100.0       # random weights: force init
    for t in range(n):
        slam(t, np.ascontiguousarray(np.roll(base, -3 * t, axis=1)[:, :128]),
             np.array([64.0, 64.0, 64.0, 48.0]))


def test_engine_drive_writes_png_and_map(tmp_path, monkeypatch):
    pytest.importorskip("matplotlib")
    monkeypatch.chdir(tmp_path)
    slam = DPVO(VOConfig(**CFG), ht=96, wd=128, viz=True, device="cpu")
    slam.viewer.period = 0.05
    _drive(slam)
    poses, _ = slam.terminate()
    assert np.isfinite(poses).all()
    assert slam.viewer._counter >= 1 and not slam.viewer._thread.is_alive()
    with open("viewer_out/latest.png", "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    html = open("viewer_out/map.html").read()
    npts = int(re.search(r"dpvo_tpu map — (\d+) points, (\d+) cameras",
                         html).group(1))
    pts = slam.points[:slam.m].numpy()
    assert npts == np.isfinite(pts).all(axis=1).sum() > 0
    flat = np.array(json.loads(re.search(r"const PTS = (\[.*?\]);", html)
                               .group(1)), np.float64)
    assert flat.size == 6 * npts


def test_render_error_surfaces_at_join(tmp_path, monkeypatch):
    pytest.importorskip("matplotlib")
    monkeypatch.chdir(tmp_path)

    def broken(self, snap):
        raise ValueError("render failed")

    monkeypatch.setattr(viewer.Viewer, "_render", broken)
    slam = DPVO(VOConfig(**CFG), ht=96, wd=128, viz=True, device="cpu")
    slam.viewer.period = 0.01
    _drive(slam, n=10)
    slam.viewer._thread.join(timeout=30)
    assert not slam.viewer._thread.is_alive()    # stopped at its error
    with pytest.raises(ValueError, match="render failed"):
        slam.terminate()


def test_missing_matplotlib_raises(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.figure", None)
    with pytest.raises(ImportError, match="matplotlib"):
        DPVO(VOConfig(**CFG), ht=96, wd=128, viz=True, device="cpu")
    slam = DPVO(VOConfig(**CFG), ht=96, wd=128, device="cpu")
    assert slam.viewer is None
