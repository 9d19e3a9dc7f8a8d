"""The port's entry points and exports on the CPU, at a tiny size.

- ``demo_torch.main`` on a directory of PNGs written by ``cv2``, with
  ``--save_trajectory``, ``--save_ply`` and ``--plot``, the files parsed
  back; and with ``--config configs/default.yaml`` (loop closure on);
- the engine at configs/default.yaml; the viewer, which is not ported
  yet, raising; a ``.pth`` checkpoint loading and the classic
  loop-closure backend constructing;
- ``bench_torch.run_regime`` with a tiny config and one short window, and
  ``bench_line``'s keys against ``bench.py``'s;
- ``utils.plot_utils`` against ``dpvo_tpu.utils.plot_utils`` byte for
  byte on the same poses (TUM, PLY and COLMAP files);
- the ``.npz`` reader on a file written by
  ``dpvo_tpu.utils.checkpoint.save_network``, against ``params_from_jax``
  of the same flax trees;
- ``engine.kernels.point_cloud`` against the JAX engine's.
"""
import filecmp
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpvo_tpu.engine import kernels as jkernels
from dpvo_tpu.models.update import DIM as JDIM, Update as JUpdate
from dpvo_tpu.models.vonet import Patchifier as JPatchifier
from dpvo_tpu.utils import plot_utils as jplot
from dpvo_tpu.utils.checkpoint import save_network
from dpvo_tpu_torch.engine import kernels
from dpvo_tpu_torch.utils import checkpoint, plot_utils

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TINY_OPTS = ["BUFFER_SIZE", "64", "PATCHES_PER_FRAME", "8",
             "PATCH_LIFETIME", "5", "REMOVAL_WINDOW", "7",
             "OPTIMIZATION_WINDOW", "5", "KEYFRAME_INDEX", "4",
             "MIXED_PRECISION", "false", "EDGE_CAPACITY", "1024",
             "BA_WINDOW_CAP", "8"]


def load_script(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def random_poses(T, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(T, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return np.concatenate([rng.normal(size=(T, 3)), q], -1)


def test_demo_torch_on_an_image_directory(tmp_path, monkeypatch):
    cv2 = pytest.importorskip("cv2")
    frames = tmp_path / "frames"
    frames.mkdir()
    base = np.random.default_rng(5).integers(0, 255, (96, 256, 3), np.uint8)
    n = 12
    for t in range(n):
        cv2.imwrite(str(frames / f"{t:04d}.png"),
                    np.ascontiguousarray(np.roll(base, -3 * t, 1)[:, :128]))
    calib = tmp_path / "calib.txt"
    calib.write_text("64.0 64.0 64.0 48.0")
    monkeypatch.chdir(tmp_path)
    demo = load_script("demo_torch")
    assert demo.main(["--imagedir", str(frames), "--calib", str(calib),
                      "--stride", "1", "--device", "cpu", "--name", "run",
                      "--save_trajectory", "--save_ply", "--save_colmap",
                      "--plot", "--opts", *TINY_OPTS]) == 0
    traj = np.loadtxt(tmp_path / "saved_trajectories" / "run.txt")
    assert traj.shape == (n, 8)
    np.testing.assert_array_equal(traj[:, 0], np.arange(n))
    assert np.isfinite(traj).all()
    np.testing.assert_allclose(np.linalg.norm(traj[:, 4:], axis=-1), 1.0,
                               atol=1e-4)
    ply = (tmp_path / "run.ply").read_text().splitlines()
    assert ply[0] == "ply"
    count = int(ply[2].split()[-1])
    body = ply[ply.index("end_header") + 1:]
    assert count == len(body) > 0
    assert all(len(line.split()) == 6 for line in body)
    assert (tmp_path / "trajectory_plots" / "run.pdf").stat().st_size > 0
    assert (tmp_path / "colmap_saves" / "run" / "images.txt").exists()


def test_demo_torch_default_config_runs_loop_closure(tmp_path, monkeypatch):
    """``--config configs/default.yaml`` (LOOP_CLOSURE true) with the tiny
    opts: the loop-closure engine tracks every frame to finite poses."""
    cv2 = pytest.importorskip("cv2")
    frames = tmp_path / "frames"
    frames.mkdir()
    base = np.random.default_rng(6).integers(0, 255, (96, 256, 3), np.uint8)
    n = 12
    for t in range(n):
        cv2.imwrite(str(frames / f"{t:04d}.png"),
                    np.ascontiguousarray(np.roll(base, -3 * t, 1)[:, :128]))
    calib = tmp_path / "calib.txt"
    calib.write_text("64.0 64.0 64.0 48.0")
    monkeypatch.chdir(tmp_path)
    demo = load_script("demo_torch")
    assert demo.main(["--imagedir", str(frames), "--calib", str(calib),
                      "--stride", "1", "--device", "cpu", "--name", "lc",
                      "--config", str(ROOT / "configs" / "default.yaml"),
                      "--save_trajectory", "--opts", *TINY_OPTS]) == 0
    traj = np.loadtxt(tmp_path / "saved_trajectories" / "lc.txt")
    assert traj.shape == (n, 8) and np.isfinite(traj).all()


def test_default_config_constructs_with_loop_closure():
    """configs/default.yaml turns loop closure on: the patch rings hold
    MAX_EDGE_AGE = 1000 frames and the inactive store is allocated."""
    from dpvo_tpu_torch.config import VOConfig
    from dpvo_tpu_torch.engine import DPVO
    cfg = VOConfig().merge_yaml(str(ROOT / "configs" / "default.yaml"))
    assert cfg.LOOP_CLOSURE and not cfg.CLASSIC_LOOP_CLOSURE
    slam = DPVO(cfg, ht=96, wd=128, device="cpu")
    assert slam.pmem == cfg.MAX_EDGE_AGE == 1000
    assert slam.ds.gmap.shape[0] == 1000 * cfg.PATCHES_PER_FRAME
    assert slam.ds.target_inac.shape == (cfg.EDGE_CAPACITY_INAC, 2)
    assert slam.hs.n_inac == 0 and not slam.ran_global_ba.any()


def test_demo_torch_rejects_what_is_not_ported(tmp_path):
    """The viewer raises, naming the ROADMAP item that ports it; a
    reference ``.pth`` loads (tests/test_torch_eval.py holds its
    conversion) and the classic loop-closure backend constructs."""
    ref = {f"update.d.1.{k}": torch.zeros(v) for k, v in
           (("weight", (2, 384)), ("bias", (2,)))}
    torch.save(ref, tmp_path / "weights.pth")
    p_sd, u_sd = checkpoint.load_network(str(tmp_path / "weights.pth"))
    assert p_sd is None and set(u_sd) == {"d.weight", "d.bias"}
    from dpvo_tpu_torch.config import VOConfig
    from dpvo_tpu_torch.engine import DPVO
    with pytest.raises(NotImplementedError, match="viewer"):
        DPVO(VOConfig(), ht=96, wd=128, viz=True, device="cpu")
    with pytest.raises(NotImplementedError, match="item 17"):
        DPVO(VOConfig(LOOP_CLOSURE=True), ht=96, wd=128, viz=True,
             device="cpu")
    pytest.importorskip("cv2")
    for lc in (False, True):
        slam = DPVO(VOConfig(CLASSIC_LOOP_CLOSURE=True, LOOP_CLOSURE=lc),
                    ht=96, wd=128, device="cpu")
        assert slam.long_term_lc is not None
        slam.long_term_lc.terminate(slam.n)


def test_bench_torch_run_regime_tiny():
    bench = load_script("bench_torch")
    r = bench.run_regime("merge", device="cpu", ht=96, wd=128, n_warm=10,
                         n_bench=3, min_windows=1, max_windows=1,
                         PATCHES_PER_FRAME=8, EDGE_CAPACITY=4096,
                         MIXED_PRECISION=False)
    assert len(r["windows"]) == 1 and r["fps"] == r["windows"][0] > 0
    assert r["poses"].shape == (13, 7) and np.isfinite(r["poses"]).all()
    assert r["keyframes"] < 13 and r["edges"][0] > 0
    assert r["points"].shape == (r["keyframes"] * 8, 3)
    assert r["colors"].shape == (r["keyframes"] * 8, 3)
    line = bench.bench_line({"merge": r, "retain": r})
    assert set(line) == {"metric", "unit", "value", "vs_baseline",
                         "median_fps", "windows", "value_retain",
                         "vs_baseline_retain", "median_fps_retain",
                         "windows_retain"}
    assert line["metric"] == "vo_fps_480p"
    cfg = bench.regime_config("retain")
    assert (cfg.BUFFER_SIZE, cfg.KEYFRAME_THRESH, cfg.EDGE_CAPACITY,
            cfg.MIXED_PRECISION, cfg.ASYNC_KEYFRAME) == (1024, 0.0, 57344,
                                                         True, True)


def test_plot_utils_match_jax_byte_for_byte(tmp_path):
    poses = random_poses(9)
    tstamps = np.arange(9, dtype=np.float64) * 0.5
    pts = np.random.default_rng(1).normal(size=(40, 3))
    pts[3] = np.nan
    clr = np.random.default_rng(2).integers(0, 255, (40, 3), np.uint8)
    for mod, tag in ((plot_utils, "port"), (jplot, "jax")):
        mod.save_trajectory_tum_format(poses, tstamps,
                                       tmp_path / tag / "traj.txt")
        mod.save_ply(tmp_path / tag / "cloud.ply", pts, clr)
        mod.save_output_for_COLMAP(str(tmp_path / tag / "colmap"), poses,
                                   tstamps, pts, clr, 60.0, 61.0, 48.0,
                                   32.0, 64, 96)
    for rel in ("traj.txt", "cloud.ply", "colmap/cameras.txt",
                "colmap/images.txt", "colmap/points3D.txt"):
        assert filecmp.cmp(tmp_path / "port" / rel, tmp_path / "jax" / rel,
                           shallow=False), rel


def test_npz_reader_matches_params_from_jax(tmp_path):
    key = jax.random.PRNGKey(0)
    p = JPatchifier(3).init(key, jnp.zeros((1, 64, 64, 3)),
                            jnp.zeros((1, 4, 2)))
    E = 8
    u = JUpdate(3).init(key, jnp.zeros((E, JDIM)), jnp.zeros((E, JDIM)),
                        jnp.zeros((E, 2 * 49 * 9)),
                        jnp.zeros((E,), jnp.int32),
                        jnp.zeros((E,), jnp.int32),
                        jnp.zeros((E,), jnp.int32))
    path = str(tmp_path / "weights.npz")
    save_network(path, p, u)
    got = checkpoint.load_network(path)
    want = checkpoint.params_from_jax(jax.tree.map(np.asarray, p),
                                      jax.tree.map(np.asarray, u))
    for g, w in zip(got, want):
        assert set(g) == set(w) and len(g) > 10
        for name in w:
            torch.testing.assert_close(g[name], w[name], rtol=0, atol=0)


def test_point_cloud_matches_jax():
    rng = np.random.default_rng(4)
    N, M, P = 6, 5, 3
    poses = random_poses(N, seed=4).astype(np.float32)
    poses[:, :3] *= 0.3
    patches = np.concatenate([
        rng.uniform(0, 30, (N * M, 2, P, P)),
        rng.uniform(0.2, 1.5, (N * M, 1, P, P))], 1).astype(np.float32)
    intr = np.tile(np.array([[40.0, 41.0, 16.0, 12.0]], np.float32), (N, 1))
    ix = np.arange(N * M, dtype=np.int32) // M
    want = np.asarray(jkernels.point_cloud(poses, patches, intr, ix))
    got = kernels.point_cloud(*(torch.from_numpy(a) for a in (
        poses, patches, intr, ix.astype(np.int64)))).numpy()
    assert got.shape == want.shape == (N * M, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
