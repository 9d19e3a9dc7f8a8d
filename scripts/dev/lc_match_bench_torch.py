#!/usr/bin/env python3
"""What the loop-closure matchers cost on one exactly known revisit.

    python scripts/dev/lc_match_bench_torch.py

The port's counterpart of ``lc_match_bench.py``: the same synthetic
revisit, seeds and scenarios, on the port's ``long_term._match``,
``long_term._sift_descriptors``, ``retrieval_dbow._orb_descriptors`` and
``optim_utils.ransac_umeyama``.  A textured plane is rendered through
pinhole homographies; visit A (3 frames) and visit B (3 frames) see it
from poses related by a known drift Sim3 (rotation, translation, scale).
Per matcher (ORB with a ratio-test ``BFMatcher``; SIFT, the default
``LOOP_MATCHER``; and an oracle of ground-truth correspondences on ORB
keypoints, the ceiling a near-perfect learned matcher would reach at that
keypoint budget), the close_loop pipeline runs: detect and describe,
triangulate each visit's triplet on its poses, match across the visits,
RANSAC-Umeyama.  Prints the match and inlier counts, the inlier rate and
the rotation (deg), translation and scale (%) errors; ``run`` takes the
stress scenarios (illumination, in-plane roll, a second plane).

Everything here is host work (numpy and OpenCV): it runs where ``cv2``
imports, with or without a card.
"""
import sys
from pathlib import Path

import numpy as np

import cv2

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from dpvo_tpu_torch.loop_closure.optim_utils import ransac_umeyama
from dpvo_tpu_torch.loop_closure.long_term import _match, _sift_descriptors
from dpvo_tpu_torch.loop_closure.retrieval.retrieval_dbow import (
    _orb_descriptors)

H, W = 480, 640
FX = FY = 320.0
CX, CY = 320.0, 240.0
K = np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1.0]])
PLANE_Z = 4.0                     # scene plane z in visit-A world
TEX = 1400                        # texture resolution
TEX_SCALE = 120.0                 # px per world unit on the plane


def make_texture(seed=7):
    """Multi-octave value noise — corner-rich, ORB-friendly."""
    rng = np.random.default_rng(seed)
    img = np.zeros((TEX, TEX), np.float32)
    for octv in (8, 32, 128, 512):
        layer = rng.random((octv, octv)).astype(np.float32)
        img += cv2.resize(layer, (TEX, TEX),
                          interpolation=cv2.INTER_CUBIC) / 4
    img = cv2.normalize(img, None, 0, 255, cv2.NORM_MINMAX)
    return cv2.cvtColor(img.astype(np.uint8), cv2.COLOR_GRAY2BGR)


def plane_to_world(u, v):
    """Texture pixel (u, v) -> world point on the plane (visit-A frame)."""
    x = (u - TEX / 2) / TEX_SCALE
    y = (v - TEX / 2) / TEX_SCALE
    return np.stack([x, y, np.full_like(x, PLANE_Z)], axis=-1)


def cam_homography(Rcw, tcw):
    """World plane (z=PLANE_Z) -> image homography for camera (Rcw|tcw)
    (world-to-camera).  Plane param: X = [u', v', PLANE_Z]."""
    # columns: world x, world y, and the fixed z*e3 + t contribution
    A = np.stack([Rcw[:, 0] / TEX_SCALE,
                  Rcw[:, 1] / TEX_SCALE,
                  Rcw[:, 2] * PLANE_Z + tcw], axis=1)
    # texture pixel -> plane coords shift
    S = np.array([[1, 0, -TEX / 2], [0, 1, -TEX / 2], [0, 0, 1.0]])
    return K @ A @ S


def render(Rcw, tcw, tex):
    Hmat = cam_homography(Rcw, tcw)
    return cv2.warpPerspective(tex, Hmat, (W, H),
                               flags=cv2.INTER_LINEAR)


def rodr(axis, angle):
    return cv2.Rodrigues(np.asarray(axis, np.float64)
                         * angle)[0]


def visit_poses(base_t, yaw, n=3, baseline=0.25):
    """n cameras looking at the plane with slight baseline steps."""
    out = []
    for i in range(n):
        Rcw = rodr([0, 1, 0], yaw + 0.02 * (i - 1))
        c = np.asarray(base_t) + np.array([baseline * (i - 1), 0.02 * i, 0])
        tcw = -Rcw @ c
        out.append((Rcw, tcw))
    return out


def triangulate_triplet(frames, poses, matcher, kp_budget=1024,
                        detect=_orb_descriptors):
    """estimate_3d_keypoints analog on known poses: detect on the center
    frame, match to both neighbors, midpoint-triangulate each track
    (exact poses make DLT unnecessary for the bench)."""
    kps, descs = [], []
    for f in frames:
        p, d = detect(f, n_features=kp_budget)
        kps.append(p)
        descs.append(d)
    m01 = matcher(1, 0, kps, descs)
    m12 = matcher(1, 2, kps, descs)
    common, i01, i12 = np.intersect1d(m01[:, 0], m12[:, 0],
                                      return_indices=True)
    if len(common) < 8:
        return None
    pts3d = []
    keep = []
    for c, a, b in zip(common, i01, i12):
        obs = [(1, kps[1][c]), (0, kps[0][m01[a, 1]]),
               (2, kps[2][m12[b, 1]])]
        A = []
        for fi, uv in obs:
            Rcw, tcw = poses[fi]
            P = K @ np.concatenate([Rcw, tcw[:, None]], axis=1)
            A.append(uv[0] * P[2] - P[0])
            A.append(uv[1] * P[2] - P[1])
        _, _, vt = np.linalg.svd(np.asarray(A))
        Xh = vt[-1]
        X = Xh[:3] / Xh[3]
        # cheirality + sane depth
        z = (poses[1][0] @ X + poses[1][1])[2]
        if 0.5 < z < 50:
            pts3d.append(X)
            keep.append(c)
    if len(keep) < 8:
        return None
    return np.asarray(pts3d), descs[1][np.asarray(keep)], \
        kps[1][np.asarray(keep)]


def orb_matcher(qi, ti, kps, descs):
    return _match(descs[qi], descs[ti])


def oracle_map(pts, pose_q, pose_t, two_plane=False):
    """Map image points of camera q onto camera t via the true scene
    geometry.  Single plane: one homography.  Two-plane scene: each
    point inverse-maps through both planes' homographies; the one whose
    texture coords land on that plane's texture half is the true
    surface."""
    def H_of(pose, z):
        from numpy.linalg import inv  # noqa: F401 (clarity)
        return cam_homography_z(pose[0], pose[1], z)

    if not two_plane:
        Hqt = (H_of(pose_t, PLANE_Z)
               @ np.linalg.inv(H_of(pose_q, PLANE_Z)))
        return cv2.perspectiveTransform(
            pts.reshape(-1, 1, 2).astype(np.float64), Hqt).reshape(-1, 2)

    out = np.full((len(pts), 2), np.inf)
    for z, half in ((PLANE_Z, 0), (PLANE_Z2, 1)):
        Hq = H_of(pose_q, z)
        Ht = H_of(pose_t, z)
        uv = cv2.perspectiveTransform(
            pts.reshape(-1, 1, 2).astype(np.float64),
            np.linalg.inv(Hq)).reshape(-1, 2)
        on = ((uv[:, 0] >= TEX // 2) if half else
              (uv[:, 0] < TEX // 2))
        on &= (uv[:, 0] >= 0) & (uv[:, 0] < TEX) \
            & (uv[:, 1] >= 0) & (uv[:, 1] < TEX)
        mapped = cv2.perspectiveTransform(
            pts.reshape(-1, 1, 2).astype(np.float64),
            Ht @ np.linalg.inv(Hq)).reshape(-1, 2)
        out[on] = mapped[on]
    return out


def make_oracle_matcher(pose_list, frame_shape, two_plane=False):
    """Ground-truth matcher: keypoints correspond iff they observe the
    same scene point (via the known geometry) within 1.5 px."""
    def matcher(qi, ti, kps, descs):
        if len(kps[qi]) == 0 or len(kps[ti]) == 0:
            return np.zeros((0, 2), np.int32)
        q = oracle_map(kps[qi], pose_list[qi], pose_list[ti], two_plane)
        d = np.linalg.norm(q[:, None] - kps[ti][None], axis=2)
        nn = d.argmin(axis=1)
        ok = d[np.arange(len(q)), nn] < 1.5
        return np.stack([np.nonzero(ok)[0], nn[ok]], axis=1).astype(
            np.int32)
    return matcher


PLANE_Z2 = 2.8                    # near plane (two-plane scene)


def cam_homography_z(Rcw, tcw, z):
    """cam_homography for a plane at depth ``z``."""
    A = np.stack([Rcw[:, 0] / TEX_SCALE,
                  Rcw[:, 1] / TEX_SCALE,
                  Rcw[:, 2] * z + tcw], axis=1)
    S = np.array([[1, 0, -TEX / 2], [0, 1, -TEX / 2], [0, 0, 1.0]])
    return K @ A @ S


def render_two_plane(Rcw, tcw, tex):
    """Off-plane scene: texture left half on the far plane (PLANE_Z),
    right half on a near plane (PLANE_Z2) — depth discontinuity plus
    parallax that no single homography explains."""
    Hf = cam_homography_z(Rcw, tcw, PLANE_Z)
    Hn = cam_homography_z(Rcw, tcw, PLANE_Z2)
    tex_f = tex.copy()
    tex_f[:, TEX // 2:] = 0
    tex_n = tex.copy()
    tex_n[:, :TEX // 2] = 0
    mask_n = np.zeros(tex.shape[:2], np.uint8)
    mask_n[:, TEX // 2:] = 255
    img_f = cv2.warpPerspective(tex_f, Hf, (W, H),
                                flags=cv2.INTER_LINEAR)
    img_n = cv2.warpPerspective(tex_n, Hn, (W, H),
                                flags=cv2.INTER_LINEAR)
    m = cv2.warpPerspective(mask_n, Hn, (W, H),
                            flags=cv2.INTER_NEAREST)
    out = img_f.copy()
    out[m > 0] = img_n[m > 0]
    return out


def apply_illum(img, gain, bias, gamma):
    """Per-visit photometric change: out = clip(gain*(img/255)^gamma*255
    + bias)."""
    f = (img.astype(np.float32) / 255.0) ** gamma
    return np.clip(gain * f * 255.0 + bias, 0, 255).astype(np.uint8)


def run(seed=7, drift_rot_deg=6.0, drift_t=(0.35, -0.2, 0.15),
        drift_scale=1.12, verbose=True, illum=None, roll_deg=0.0,
        two_plane=False):
    """One revisit scenario.

    Stress knobs (SIFT beyond its comfort zone):
    illum      (gain, bias, gamma) applied to visit-B frames only
    roll_deg   in-plane camera rotation of visit B
    two_plane  off-plane structure: near+far planes with parallax
    """
    tex = make_texture(seed)
    rend = render_two_plane if two_plane else render

    # visit A observes the plane head-on; visit B revisits from nearby
    poses_a = visit_poses([0.0, 0.0, 0.0], yaw=0.0)
    poses_b_true = visit_poses([0.5, 0.1, -0.2], yaw=0.06)
    if roll_deg:
        Rroll = rodr([0, 0, 1], np.deg2rad(roll_deg))
        poses_b_true = [(Rroll @ Rcw, Rroll @ tcw)
                        for Rcw, tcw in poses_b_true]

    frames_a = [rend(R, t, tex) for R, t in poses_a]
    frames_b = [rend(R, t, tex) for R, t in poses_b_true]
    if illum is not None:
        frames_b = [apply_illum(f, *illum) for f in frames_b]

    # drift Sim3: the SLAM believes visit-B world coords are
    # X_drift = s * R_d @ X_true + t_d. Triangulating visit B against
    # its *drifted* poses produces points in the drifted frame, so the
    # A->B Umeyama estimate should recover (R_d, t_d, s) exactly.
    R_d = rodr([0.2, 1.0, -0.3], np.deg2rad(drift_rot_deg))
    t_d = np.asarray(drift_t)
    s_d = drift_scale

    # camera poses consistent with the drifted world: if X' = sRX + t,
    # x_cam = Rcw X + tcw = (Rcw R_d^T / s) X' + (tcw - Rcw R_d^T t_d / s)
    poses_b_drift = []
    for Rcw, tcw in poses_b_true:
        Rp = Rcw @ R_d.T
        poses_b_drift.append((Rp, tcw - (Rp @ t_d) / s_d))
        # note scale folds into the triangulated depth below

    results = {}
    for name in ("orb", "sift", "oracle"):
        detect = _sift_descriptors if name == "sift" else _orb_descriptors
        if name in ("orb", "sift"):
            m_a = orb_matcher
            m_b = orb_matcher
        else:
            m_a = make_oracle_matcher(poses_a, frames_a[0].shape,
                                      two_plane)
            m_b = make_oracle_matcher(poses_b_true, frames_b[0].shape,
                                      two_plane)

        tri_a = triangulate_triplet(frames_a, poses_a, m_a, detect=detect)
        # triangulate B against drifted poses but with the TRUE-geometry
        # matcher (the matcher sees images; drift only affects poses).
        # scale: homogeneous triangulation against (Rp, tp) with
        # tp = (tcw - Rp t_d / s); X' solves x = Rp X' + tp * 1 — to get
        # X' = s R X + t we scale the drifted translation consistently:
        poses_bd = [(Rp, s_d * tp) for Rp, tp in poses_b_drift]
        tri_b = triangulate_triplet(frames_b, poses_bd, m_b,
                                    detect=detect)
        if tri_a is None or tri_b is None:
            results[name] = None
            continue
        pts_a, d_a, kp_a = tri_a
        pts_b, d_b, kp_b = tri_b

        if name in ("orb", "sift"):
            m = _match(d_a, d_b)
        else:
            # oracle cross-visit: same scene point within 1.5 px via the
            # true geometry of the CENTER frames of each visit
            q = oracle_map(kp_a, poses_a[1], poses_b_true[1], two_plane)
            d = np.linalg.norm(q[:, None] - kp_b[None], axis=2)
            nn = d.argmin(axis=1)
            ok = d[np.arange(len(q)), nn] < 1.5
            m = np.stack([np.nonzero(ok)[0], nn[ok]], axis=1)
        if len(m) < 8:
            results[name] = None
            continue

        src = pts_a[m[:, 0]]
        dst = pts_b[m[:, 1]]
        R, t, s, inl = ransac_umeyama(src, dst, iterations=400,
                                      threshold=0.1)
        if R is None:
            results[name] = None
            continue

        rot_err = np.rad2deg(np.arccos(
            np.clip((np.trace(R @ R_d.T) - 1) / 2, -1, 1)))
        t_err = np.linalg.norm(t - t_d)
        s_err = abs(s / s_d - 1) * 100
        results[name] = dict(matches=len(m), inliers=int(inl),
                             inlier_rate=inl / len(m),
                             rot_err_deg=float(rot_err),
                             t_err=float(t_err),
                             scale_err_pct=float(s_err))
        if verbose:
            r = results[name]
            print(f"{name:8s} matches={r['matches']:4d} "
                  f"inliers={r['inliers']:4d} "
                  f"({100 * r['inlier_rate']:.0f}%) "
                  f"rot_err={r['rot_err_deg']:.3f}deg "
                  f"t_err={r['t_err']:.4f} "
                  f"scale_err={r['scale_err_pct']:.2f}%", flush=True)
    return results


def main(argv):
    seeds = [7, 17, 27]
    agg = {"orb": [], "sift": [], "oracle": []}
    for s in seeds:
        print(f"--- seed {s}")
        r = run(seed=s)
        for k, v in r.items():
            if v is not None:
                agg[k].append(v)
    for k, rows in agg.items():
        if not rows:
            print(f"{k}: FAILED on all seeds")
            continue
        med = {f: float(np.median([r[f] for r in rows]))
               for f in rows[0]}
        print(f"[median/{len(rows)}] {k}: {med}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
