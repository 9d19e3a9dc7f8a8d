"""The port's evaluation harnesses and ``.pth`` reader against the JAX
package's, on the CPU.

- ``utils.checkpoint.convert_state_dict`` on a state dict with the
  reference VONet's names and shapes (seeded numpy, scaled like trained
  weights) equals ``params_from_jax`` of the JAX package's conversion
  bitwise, with and without ``module.`` prefixes and ``update.lmbda``, and
  for a dict holding only ``patchify``; ``load_network`` reads it from a
  ``.pth`` / ``.pt``; ``Patchifier`` and ``Update`` run with the converted
  weights match the flax modules with the JAX conversion at
  tests/test_torch_models.py's atol 2e-4.
- Each ``evaluate_*_torch.py`` on a synthetic scene in its dataset's
  on-disk layout (written with ``cv2``) against the JAX script: the same
  frames (bit for bit, with their intrinsics) handed to the engine and the
  same timestamps out of ``run_sequence``, poses within
  tests/test_torch_engine.py's never-merge envelope (translation 5e-3,
  quaternion dot > 1 - 1e-4; both engines get the same weights, scripted
  centroids, fixed depth and a forced motion probe through their ``DPVO``
  name), and on equal poses the same ATE to 1e-9; TartanAir's AUC/AVG
  file from ``main`` is the JAX script's, byte for byte.
"""
import importlib.util
import os
from pathlib import Path

import cv2
import jax
import numpy as np
import pytest
import torch

from dpvo_tpu.config import VOConfig as JaxConfig
from dpvo_tpu.engine import DPVO as JaxDPVO
from dpvo_tpu.models import update as jupd, vonet as jvonet
from dpvo_tpu.utils import checkpoint as jckpt, evaluation as jeval
from dpvo_tpu_torch.config import VOConfig
from dpvo_tpu_torch.engine import DPVO
from dpvo_tpu_torch.models import update as tupd, vonet as tvonet
from dpvo_tpu_torch.utils import checkpoint, evaluation

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
ATOL = 2e-4                     # tests/test_torch_models.py's
HT, WD = 96, 128                # every scene's frames after its crops
M = 4
N_FRAMES = 10
TINY = dict(BUFFER_SIZE=64, PATCHES_PER_FRAME=M, PATCH_LIFETIME=5,
            REMOVAL_WINDOW=7, OPTIMIZATION_WINDOW=5, KEYFRAME_INDEX=4,
            MIXED_PRECISION=False, ASYNC_KEYFRAME=False, EDGE_CAPACITY=512,
            BA_WINDOW_CAP=8, KEYFRAME_THRESH=0.0)
ATOL_T, ATOL_Q = 5e-3, 1e-4     # never-merge envelope


def load_script(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --- the .pth reader ---------------------------------------------------------

def reference_state_dict(seed=0):
    """The reference VONet's state dict names and shapes (net.py,
    extractor.py), weights uniform in +-1/sqrt(fan_in) from a seeded numpy
    generator, as torch tensors."""
    rng = np.random.default_rng(seed)
    sd = {}

    def put(name, *shape, fan_in):
        a = rng.uniform(-1, 1, shape) / np.sqrt(fan_in)
        sd[name] = torch.from_numpy(a.astype(np.float32))

    def conv(name, cin, cout, k):
        put(f"{name}.weight", cout, cin, k, k, fan_in=cin * k * k)
        put(f"{name}.bias", cout, fan_in=cin * k * k)

    def lin(name, cin, cout):
        put(f"{name}.weight", cout, cin, fan_in=cin)
        put(f"{name}.bias", cout, fan_in=cin)

    def ln(name, d):
        sd[f"{name}.weight"] = torch.from_numpy(
            1 + 0.1 * rng.standard_normal(d).astype(np.float32))
        put(f"{name}.bias", d, fan_in=d)

    for enc, outd in (("patchify.fnet", 128), ("patchify.inet", 384)):
        conv(f"{enc}.conv1", 3, 32, 7)
        for layer, cin, cout in (("layer1.0", 32, 32), ("layer1.1", 32, 32),
                                 ("layer2.0", 32, 64), ("layer2.1", 64, 64)):
            conv(f"{enc}.{layer}.conv1", cin, cout, 3)
            conv(f"{enc}.{layer}.conv2", cout, cout, 3)
        conv(f"{enc}.layer2.0.downsample.0", 32, 64, 1)
        conv(f"{enc}.conv2", 64, outd, 1)
    u = "update"
    lin(f"{u}.corr.0", 2 * 49 * 9, 384)
    lin(f"{u}.corr.2", 384, 384)
    ln(f"{u}.corr.3", 384)
    lin(f"{u}.corr.5", 384, 384)
    ln(f"{u}.norm", 384)
    for c in ("c1", "c2"):
        lin(f"{u}.{c}.0", 384, 384)
        lin(f"{u}.{c}.2", 384, 384)
    for agg in ("agg_kk", "agg_ij"):
        for nm in ("f", "g", "h"):
            lin(f"{u}.{agg}.{nm}", 384, 384)
    for g, i in (("gru.1", 0), ("gru.3", 2)):
        ln(f"{u}.gru.{i}", 384)
        lin(f"{u}.{g}.gate.0", 384, 384)
        lin(f"{u}.{g}.res.0", 384, 384)
        lin(f"{u}.{g}.res.2", 384, 384)
    lin(f"{u}.d.1", 384, 2)
    lin(f"{u}.w.1", 384, 2)
    return sd


VARIANTS = {
    "plain": lambda sd: sd,
    "module_and_lmbda": lambda sd: {
        **{f"module.{k}": v for k, v in sd.items()},
        "module.update.lmbda": torch.ones(1)},
    "patchify_only": lambda sd: {k: v for k, v in sd.items()
                                 if k.startswith("patchify.")},
}


def assert_sd_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype == torch.float32, k
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_convert_state_dict_matches_jax_bitwise(variant):
    raw = VARIANTS[variant](reference_state_dict())
    p_sd, u_sd = checkpoint.convert_state_dict(raw)
    jp, ju = jckpt.convert_state_dict(raw)
    want_p = checkpoint.flax_to_state_dict(jax.tree.map(np.asarray, jp))
    assert_sd_equal(p_sd, want_p)
    if variant == "patchify_only":
        assert ju is None and u_sd is None
    else:
        assert_sd_equal(u_sd, checkpoint.flax_to_state_dict(
            jax.tree.map(np.asarray, ju)))
    # the conversion loads into the port's modules exactly
    tvonet.Patchifier(3).load_state_dict(p_sd)
    if u_sd is not None:
        tupd.Update(3).load_state_dict(u_sd)


@pytest.mark.parametrize("suffix", [".pth", ".pt"])
def test_load_network_reads_a_pth(tmp_path, suffix):
    raw = VARIANTS["module_and_lmbda"](reference_state_dict(1))
    path = tmp_path / f"dpvo{suffix}"
    torch.save(raw, path)
    p_sd, u_sd = checkpoint.load_network(str(path))
    want = checkpoint.params_from_jax(*jax.tree.map(
        np.asarray, jckpt.convert_state_dict(raw)))
    assert_sd_equal(p_sd, want[0])
    assert_sd_equal(u_sd, want[1])
    # and the engine takes the path as its network
    slam = DPVO(VOConfig(**TINY), network=str(path), ht=HT, wd=WD,
                device="cpu")
    assert torch.equal(slam.update_mod.corr1.weight,
                       raw["module.update.corr.0.weight"])
    assert torch.equal(slam.patchifier.fnet.layer2_0.downsample.weight,
                       raw["module.patchify.fnet.layer2.0.downsample.0"
                           ".weight"])


def test_converted_weights_run_like_jax():
    """Patchifier and Update with the converted reference weights against
    the flax modules with the JAX package's conversion."""
    raw = reference_state_dict(2)
    jp, ju = jckpt.convert_state_dict(raw)
    p_sd, u_sd = checkpoint.convert_state_dict(raw)
    rng = np.random.default_rng(3)

    img = (2.0 * rng.uniform(size=(1, 32, 48, 3)) - 0.5).astype(np.float32)
    coords = rng.uniform(1, 11, (1, 6, 2)).astype(np.float32)
    want = jvonet.Patchifier(3).apply(jp, img, coords)
    tp = tvonet.Patchifier(3)
    tp.load_state_dict(p_sd)
    with torch.no_grad():
        got = tp.eval()(torch.from_numpy(img), torch.from_numpy(coords))
    for name, a, b in zip(("fmap", "gmap", "imap", "patches", "index",
                           "clr"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   err_msg=name)

    E = 48
    ii = rng.integers(0, 6, E).astype(np.int32)
    jj = (ii + rng.integers(1, 4, E)).astype(np.int32)
    kk = (ii * 4 + rng.integers(0, 4, E)).astype(np.int32)
    net, inp = (rng.normal(size=(E, 384)).astype(np.float32)
                for _ in range(2))
    corr = rng.normal(size=(E, 882)).astype(np.float32)
    want = jupd.Update(3).apply(ju, net, inp, corr, ii, jj, kk)
    tu = tupd.Update(3)
    tu.load_state_dict(u_sd)
    with torch.no_grad():
        got = tu.eval()(*map(torch.from_numpy, (net, inp, corr, ii, jj, kk)))
    for name, a, b in zip(("net", "delta", "weight"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   err_msg=name)


# --- the harnesses on synthetic scenes ---------------------------------------

def frames(n, h=HT, w=WD):
    rng = np.random.default_rng(11)
    base = cv2.GaussianBlur(rng.integers(0, 255, (h, 2 * w, 3), np.uint8),
                            (5, 5), 0)
    return [np.ascontiguousarray(np.roll(base, -3 * t, axis=1)[:, :w])
            for t in range(n)]


def gt_xyz(n):
    t = np.arange(n, dtype=np.float64)
    return np.stack([0.01 * t, 0.002 * t * t, 0.003 * np.sin(t)], -1)


def write_frames(paths, imgs):
    for p, img in zip(paths, imgs):
        os.makedirs(os.path.dirname(p), exist_ok=True)
        assert cv2.imwrite(str(p), img)


def tartan_scene(root):
    scene = root / "abandonedfactory" / "Easy" / "P000"
    write_frames([scene / "image_left" / f"{t:06d}_left.png"
                  for t in range(N_FRAMES)], frames(N_FRAMES))
    ned = np.zeros((N_FRAMES, 7))
    ned[:, [1, 2, 0]] = gt_xyz(N_FRAMES)        # the reader's permutation
    ned[:, 6] = 1.0
    np.savetxt(scene / "pose_left.txt", ned, delimiter=" ")
    return scene


EUROC_T0 = 1403636579763555584


def euroc_scene(root):
    seq = root / "MH_01_easy"
    n = 2 * N_FRAMES                             # stride 2
    stamps = EUROC_T0 + 50_000_000 * np.arange(n, dtype=np.int64)
    write_frames([seq / "mav0/cam0/data" / f"{s}.png" for s in stamps],
                 frames(n))
    gtd = seq / "mav0/state_groundtruth_estimate0"
    gtd.mkdir(parents=True)
    rows = np.concatenate([stamps[:, None].astype(np.float64), gt_xyz(n),
                           np.tile([1.0, 0, 0, 0], (n, 1)),
                           np.zeros((n, 9))], 1)
    np.savetxt(gtd / "data.csv", rows, delimiter=",",
               header="#timestamp,p,q,v,bw,ba")
    return seq


def kitti_scene(root):
    seq = root / "sequences" / "00"
    gray = [cv2.cvtColor(f, cv2.COLOR_BGR2GRAY)
            for f in frames(N_FRAMES, HT + 3, WD + 2)]
    write_frames([seq / "image_0" / f"{t:06d}.png" for t in range(N_FRAMES)],
                 gray)
    (seq / "calib.txt").write_text(
        "P0: 64.0 0 64.0 0 0 64.0 48.0 0 0 0 1 0\n"
        "P1: 64.0 0 64.0 -30.0 0 64.0 48.0 0 0 0 1 0\n")
    poses = np.tile(np.eye(3, 4).reshape(-1), (N_FRAMES, 1))
    poses[:, [3, 7, 11]] = gt_xyz(N_FRAMES)
    (root / "poses").mkdir()
    np.savetxt(root / "poses" / "00.txt", poses)
    return seq


def tum_scene(root):
    seq = root / "rgbd_dataset_freiburg1_xyz"
    stamps = 1305031102.175304 + 0.0333 * np.arange(N_FRAMES)
    names = [f"rgb/{s:.6f}.png" for s in stamps]
    write_frames([seq / nm for nm in names], frames(N_FRAMES, HT + 32,
                                                    WD + 32))
    (seq / "rgb.txt").write_text(
        "# color images\n" + "".join(f"{s:.6f} {nm}\n"
                                     for s, nm in zip(stamps, names)))
    gt = np.concatenate([stamps[:, None] + 0.004, gt_xyz(N_FRAMES),
                         np.tile([0, 0, 0, 1.0], (N_FRAMES, 1))], 1)
    np.savetxt(seq / "groundtruth.txt", gt, fmt="%.6f")
    return seq


def icl_scene(root):
    seq = root / "living_room_traj0_frei_png"
    write_frames([seq / "rgb" / f"{t}.png" for t in range(N_FRAMES)],
                 frames(N_FRAMES, HT + 8, WD + 5))
    gt = np.concatenate([np.arange(N_FRAMES)[:, None], gt_xyz(N_FRAMES),
                         np.tile([0, 0, 0, 1.0], (N_FRAMES, 1))], 1)
    np.savetxt(seq / "groundtruth.txt", gt)
    return seq


def _ate(poses, ref):
    return jeval.ate_rmse(poses, ref, correct_scale=True)


# dataset -> (script, scene writer, run_sequence's arguments after the
# network, the JAX script's scoring (its main's arithmetic), the port's)
HARNESSES = {
    "tartan": ("evaluate_tartan", tartan_scene, lambda s: (str(s), 1),
               lambda jm, s, p, ts: jm.evaluate_scene(None, None, str(s))[0],
               lambda pm, s, p, ts: pm.evaluate_scene(None, None, str(s))[0]),
    "euroc": ("evaluate_euroc", euroc_scene,
              lambda s: (str(s / "mav0/cam0/data"), 2),
              lambda jm, s, p, ts: _ate(p[(ij := jeval.associate_trajectories(
                  ts, jm.load_groundtruth(str(s))[0], max_diff=0.02))[0]],
                  jm.load_groundtruth(str(s))[1][ij[1]]),
              lambda pm, s, p, ts: pm.score(p, ts,
                                            *pm.load_groundtruth(str(s)))),
    "kitti": ("evaluate_kitti", kitti_scene, lambda s: (str(s), 1),
              lambda jm, s, p, ts: _ate(p, jm.load_kitti_gt(
                  str(s.parent.parent / "poses/00.txt"))[:len(p)]),
              lambda pm, s, p, ts: pm.score(p, pm.load_kitti_gt(
                  str(s.parent.parent / "poses/00.txt")))),
    "tum": ("evaluate_tum", tum_scene, lambda s: (str(s), 1),
            lambda jm, s, p, ts: _ate(p[(ij := jeval.associate_trajectories(
                ts, (gt := np.loadtxt(s / "groundtruth.txt"))[:, 0],
                max_diff=0.02))[0]], gt[ij[1], 1:4]),
            lambda pm, s, p, ts: pm.score(p, ts,
                                          np.loadtxt(s / "groundtruth.txt"))),
    "icl": ("evaluate_icl_nuim", icl_scene, lambda s: (str(s), 1),
            lambda jm, s, p, ts: _ate(p, np.loadtxt(
                s / "groundtruth.txt")[:len(p), 1:4]),
            lambda pm, s, p, ts: pm.score(p, np.loadtxt(
                s / "groundtruth.txt"))),
}


def centroid_grid(t):
    fh, fw = HT // 4, WD // 4
    k = np.arange(M)
    return np.stack([1 + (7 * k + 3 * t) % (fw - 2),
                     1 + (5 * k + 11 * t) % (fh - 2)], -1).astype(np.float32)


def with_seams(slam):
    slam.motion_probe = lambda: 100.0
    slam.test_centroids = centroid_grid
    slam.test_fixed_depth = 0.7
    return slam


def recording(engine, log):
    """``engine`` whose every frame, as the harness hands it over, is
    appended to ``log``."""
    class Recording(engine):
        def __call__(self, t, image, intrinsics):
            log.append((t, np.array(image), np.array(intrinsics)))
            return super().__call__(t, image, intrinsics)
    return Recording


@pytest.fixture(scope="module")
def weights():
    """Seeded flax weights (flow-delta head x0.02, as the engine parity
    tests) and the same carried into the port."""
    init = JaxDPVO(JaxConfig(**TINY, CORR_BACKEND="xla"), network=None,
                   ht=HT, wd=WD)
    p = jax.tree.map(np.asarray, init.params_patchify)
    u = jax.tree.map(np.asarray, init.params_update)
    for k in ("kernel", "bias"):
        u["params"]["d"][k] = u["params"]["d"][k] * 0.02
    return (p, u), checkpoint.params_from_jax(p, u)


def _as_run(out):
    poses, tstamps = out
    return np.asarray(poses), np.asarray(tstamps)


@pytest.mark.parametrize("dataset", sorted(HARNESSES))
def test_harness_matches_jax(dataset, weights, tmp_path, monkeypatch):
    script, make_scene, seq_args, jax_score, port_score = HARNESSES[dataset]
    scene = make_scene(tmp_path)
    jm, pm = load_script(script), load_script(f"{script}_torch")
    (jp, ju), port_net = weights

    fed_ref, fed_my = [], []
    jax_engine, port_engine = (recording(JaxDPVO, fed_ref),
                               recording(DPVO, fed_my))
    monkeypatch.setattr(jm, "DPVO", lambda cfg, net, ht, wd: with_seams(
        jax_engine(cfg, net, ht=ht, wd=wd)))
    monkeypatch.setattr(evaluation, "DPVO", lambda cfg, net, ht, wd, device:
                        with_seams(port_engine(cfg, net, ht=ht, wd=wd,
                                               device=device)))
    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    try:
        p_ref, t_ref = _as_run(jm.run_sequence(
            JaxConfig(**TINY, CORR_BACKEND="xla"), (jp, ju),
            *seq_args(scene)))
    finally:
        jax.config.update("jax_default_matmul_precision", old)
    p_my, t_my = _as_run(pm.run_sequence(VOConfig(**TINY), port_net,
                                         *seq_args(scene), device="cpu"))

    # the readers hand the engines the same frames, bit for bit
    assert len(fed_my) == len(fed_ref) == N_FRAMES
    for (t0, img0, intr0), (t1, img1, intr1) in zip(fed_my, fed_ref):
        assert t0 == t1 and img0.shape == (HT, WD, 3)
        np.testing.assert_array_equal(img0, img1)
        np.testing.assert_array_equal(intr0, intr1)
    assert p_my.shape == p_ref.shape == (N_FRAMES, 7)
    np.testing.assert_array_equal(t_my, t_ref)
    assert np.isfinite(p_my).all()
    np.testing.assert_allclose(p_my[:, :3], p_ref[:, :3], atol=ATOL_T)
    qd = np.abs(np.sum(p_my[:, 3:] * p_ref[:, 3:], axis=-1)) / (
        np.linalg.norm(p_my[:, 3:], axis=-1)
        * np.linalg.norm(p_ref[:, 3:], axis=-1))
    assert np.all(qd > 1 - ATOL_Q)

    # the scoring on equal poses: the JAX script's arithmetic and the port's
    monkeypatch.setattr(jm, "run_sequence", lambda *a, **k: (p_ref, t_ref))
    monkeypatch.setattr(pm, "run_sequence", lambda *a, **k: (p_ref, t_ref))
    want = jax_score(jm, scene, p_ref, t_ref)
    got = port_score(pm, scene, p_ref, t_ref)
    assert np.isfinite(want) and want > 0
    assert abs(got - want) <= 1e-9, (got, want)


def test_tartan_main_writes_the_jax_summary(tmp_path, monkeypatch):
    """evaluate_tartan_torch.main against evaluate_tartan.main with equal
    per-scene errors: the same results file (scene medians, AUC, AVG)."""
    jm, pm = load_script("evaluate_tartan"), load_script(
        "evaluate_tartan_torch")
    data = tmp_path / "data"
    errs = {}
    for i, s in enumerate(jm.test_split[:4]):
        (data / s).mkdir(parents=True)
        errs[str(data / s)] = [0.05 + 0.4 * i, 0.3 * i, 2.0 - 0.1 * i]
    for mod in (jm, pm):
        monkeypatch.setattr(mod, "evaluate_scene",
                            lambda cfg, net, scene, *a, **k: errs[scene])
    outs = []
    for name, mod, argv in (("jax", jm, []), ("port", pm, ["--device",
                                                           "cpu"])):
        cwd = tmp_path / name
        cwd.mkdir()
        monkeypatch.chdir(cwd)
        monkeypatch.setattr("sys.argv", ["x", "--datapath", str(data),
                                         "--trials", "3", *argv])
        mod.main() if name == "jax" else mod.main(
            ["--datapath", str(data), "--trials", "3", *argv])
        (res,) = (cwd / "results").iterdir()
        outs.append(res.read_text())
    assert outs[0] == outs[1]
    assert outs[1].count("\n") == 4 + 2 and "AUC" in outs[1]
