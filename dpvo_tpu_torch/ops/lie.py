"""SO(3), RxSO(3), SE(3) and Sim(3) in plain PyTorch.

Counterpart of ``dpvo_tpu/ops/lie.py``, same conventions:

- quaternions are ``[x, y, z, w]`` (scalar last);
- SO3 ``(..., 4) = q``, RxSO3 ``(..., 5) = [q, s]``, SE3 ``(..., 7) =
  [t, q]``, Sim3 ``(..., 8) = [t, q, s]``;
- tangents so3 ``(..., 3) = phi``, rxso3 ``(..., 4) = [phi, sigma]``, se3
  ``(..., 6) = [tau, phi]``, sim3 ``(..., 7) = [tau, phi, sigma]``;
- every function broadcasts over leading axes and computes in float32
  (float64 inputs stay float64).  The small matrix products here are fp32
  geometry: callers keep TF32 off (``torch.backends.cuda.matmul``).
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def _f32(*xs):
    out = tuple(x if x.dtype == torch.float64 else x.float() for x in xs)
    return out if len(out) > 1 else out[0]


def _mv(m, v):
    return torch.matmul(m, v[..., None])[..., 0]


def _mtv(m, v):
    return torch.matmul(m.transpose(-1, -2), v[..., None])[..., 0]


# ---------------------------------------------------------------------------
# quaternion primitives
# ---------------------------------------------------------------------------

def quat_mul(q1, q2):
    """Hamilton product, scalar-last layout."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], dim=-1)


def quat_conj(q):
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def quat_rotate(q, v):
    """Rotate vectors v (..., 3) by unit quaternions q (..., 4)."""
    qv = q[..., :3]
    w = q[..., 3:4]
    uv = torch.linalg.cross(qv, v)
    uuv = torch.linalg.cross(qv, uv)
    return v + 2.0 * (w * uv + uuv)


def quat_normalize(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp(min=_EPS)


def quat_to_matrix(q):
    """(..., 4) -> (..., 3, 3) rotation matrix."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


def skew(v):
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    m = torch.stack([o, -z, y, z, o, -x, -y, x, o], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


# ---------------------------------------------------------------------------
# SO(3)
# ---------------------------------------------------------------------------

def so3_exp(phi):
    """so3 (..., 3) -> unit quaternion (..., 4)."""
    phi = _f32(phi)
    theta_sq = (phi * phi).sum(-1, keepdim=True)
    small = theta_sq < 1e-8
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta_sq),
                                   theta_sq))
    half = 0.5 * theta
    k = torch.where(small, 0.5 - theta_sq / 48.0, torch.sin(half) / theta)
    w = torch.where(small, 1.0 - theta_sq / 8.0, torch.cos(half))
    return torch.cat([k * phi, w], dim=-1)


def so3_log(q):
    """Unit quaternion (..., 4) -> so3 (..., 3)."""
    q = _f32(q)
    qv = q[..., :3]
    w = q[..., 3:4]
    n_sq = (qv * qv).sum(-1, keepdim=True)
    small = n_sq < 1e-8
    n = torch.sqrt(torch.where(small, torch.ones_like(n_sq), n_sq))
    theta = 2.0 * torch.atan2(n, w.abs())
    sign = torch.where(w < 0, -1.0, 1.0)
    k = torch.where(small, 2.0 / w.abs().clamp(min=_EPS), theta / n)
    return sign * k * qv


def so3_inv(q):
    return quat_conj(_f32(q))


def so3_mul(q1, q2):
    return quat_mul(*_f32(q1, q2))


def so3_act(q, p):
    return quat_rotate(*_f32(q, p))


def so3_matrix(q):
    """SO3 as a 4x4 homogeneous matrix."""
    q = _f32(q)
    m = torch.zeros(q.shape[:-1] + (4, 4), dtype=q.dtype, device=q.device)
    m[..., :3, :3] = quat_to_matrix(q)
    m[..., 3, 3] = 1.0
    return m


def so3_adj(q):
    """Adjoint of SO3 = rotation matrix (..., 3, 3)."""
    return quat_to_matrix(_f32(q))


def _so3_left_jacobian(phi):
    """V(phi), integrating translation for SE3 exp: (..., 3) -> (..., 3, 3)."""
    theta_sq = (phi * phi).sum(-1)[..., None, None]
    small = theta_sq < 1e-8
    ts_safe = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(ts_safe)
    Phi = skew(phi)
    Phi2 = torch.matmul(Phi, Phi)
    a = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1.0 - torch.cos(theta)) / ts_safe)
    b = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                    (theta - torch.sin(theta)) / (ts_safe * theta))
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye + a * Phi + b * Phi2


def _so3_left_jacobian_inv(phi):
    theta_sq = (phi * phi).sum(-1)[..., None, None]
    small = theta_sq < 1e-8
    ts_safe = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(ts_safe)
    Phi = skew(phi)
    Phi2 = torch.matmul(Phi, Phi)
    half = 0.5 * theta
    cot_term = half * torch.cos(half) / torch.sin(half).clamp(min=_EPS)
    b = torch.where(small, 1.0 / 12.0 + theta_sq / 720.0,
                    (1.0 - cot_term) / ts_safe)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye - 0.5 * Phi + b * Phi2


# ---------------------------------------------------------------------------
# SE(3): [t (3), q (4)]
# ---------------------------------------------------------------------------

def se3_identity(shape=(), device=None):
    if isinstance(shape, int):
        shape = (shape,)
    g = torch.zeros(tuple(shape) + (7,), dtype=torch.float32, device=device)
    g[..., 6] = 1.0
    return g


def se3_exp(xi):
    """se3 (..., 6) [tau, phi] -> SE3 (..., 7)."""
    xi = _f32(xi)
    tau, phi = xi[..., :3], xi[..., 3:6]
    q = so3_exp(phi)
    t = _mv(_so3_left_jacobian(phi), tau)
    return torch.cat([t, q], dim=-1)


def se3_log(g):
    """SE3 (..., 7) -> se3 (..., 6)."""
    g = _f32(g)
    phi = so3_log(g[..., 3:7])
    tau = _mv(_so3_left_jacobian_inv(phi), g[..., :3])
    return torch.cat([tau, phi], dim=-1)


def se3_inv(g):
    g = _f32(g)
    qi = quat_conj(g[..., 3:7])
    return torch.cat([-quat_rotate(qi, g[..., :3]), qi], dim=-1)


def se3_mul(g1, g2):
    g1, g2 = _f32(g1, g2)
    q1 = g1[..., 3:7]
    q = quat_mul(q1, g2[..., 3:7])
    t = g1[..., :3] + quat_rotate(q1, g2[..., :3])
    return torch.cat([t, q], dim=-1)


def se3_act(g, p):
    """Apply SE3 to 3D points (..., 3)."""
    g, p = _f32(g, p)
    return quat_rotate(g[..., 3:7], p) + g[..., :3]


def se3_act4(g, p4):
    """Apply SE3 to homogeneous points (..., 4): [R p + W t, W]."""
    g, p4 = _f32(g, p4)
    xyz = quat_rotate(g[..., 3:7], p4[..., :3]) + p4[..., 3:4] * g[..., :3]
    return torch.cat([xyz, p4[..., 3:4].expand(xyz.shape[:-1] + (1,))],
                     dim=-1)


def se3_matrix(g):
    """SE3 (..., 7) -> homogeneous 4x4 matrix."""
    g = _f32(g)
    m = torch.zeros(g.shape[:-1] + (4, 4), dtype=g.dtype, device=g.device)
    m[..., :3, :3] = quat_to_matrix(g[..., 3:7])
    m[..., :3, 3] = g[..., :3]
    m[..., 3, 3] = 1.0
    return m


def se3_adj_matrix(g):
    """Adjoint (..., 6, 6) in [tau, phi] block order: [[R, [t]x R], [0, R]]."""
    g = _f32(g)
    R = quat_to_matrix(g[..., 3:7])
    tR = torch.matmul(skew(g[..., :3]), R)
    top = torch.cat([R, tR], dim=-1)
    bot = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def se3_adj(g, a):
    """Adjoint action on tangent vectors a (..., 6)."""
    return _mv(se3_adj_matrix(g), _f32(a))


def se3_adjT(g, a):
    """Transpose-adjoint action on cotangent vectors a (..., 6)."""
    g, a = _f32(g, a)
    return _mtv(se3_adj_matrix(g), a)


def se3_retr(g, xi):
    """Retraction: exp(xi) * g."""
    return se3_mul(se3_exp(xi), g)


def se3_scale(g, s):
    """Scale the translation part by s (a float or a tensor broadcasting
    over the leading axes; lietorch's SE3.scale)."""
    g = _f32(g)
    s = torch.as_tensor(s, dtype=g.dtype, device=g.device)
    return torch.cat([g[..., :3] * s[..., None], g[..., 3:7]], dim=-1)


# ---------------------------------------------------------------------------
# RxSO(3): [q (4), s (1)]
# ---------------------------------------------------------------------------

def rxso3_exp(xi):
    """(..., 4) [phi, sigma] -> (..., 5) [q, s]."""
    xi = _f32(xi)
    return torch.cat([so3_exp(xi[..., :3]), torch.exp(xi[..., 3:4])], dim=-1)


def rxso3_log(g):
    g = _f32(g)
    return torch.cat([so3_log(g[..., :4]),
                      torch.log(g[..., 4:5].clamp(min=_EPS))], dim=-1)


def rxso3_inv(g):
    g = _f32(g)
    return torch.cat([quat_conj(g[..., :4]), 1.0 / g[..., 4:5]], dim=-1)


def rxso3_mul(g1, g2):
    g1, g2 = _f32(g1, g2)
    return torch.cat([quat_mul(g1[..., :4], g2[..., :4]),
                      g1[..., 4:5] * g2[..., 4:5]], dim=-1)


def rxso3_act(g, p):
    g, p = _f32(g, p)
    return g[..., 4:5] * quat_rotate(g[..., :4], p)


# ---------------------------------------------------------------------------
# Sim(3): [t (3), q (4), s (1)]
# ---------------------------------------------------------------------------

def sim3_identity(shape=(), device=None):
    if isinstance(shape, int):
        shape = (shape,)
    g = torch.zeros(tuple(shape) + (8,), dtype=torch.float32, device=device)
    g[..., 6] = 1.0
    g[..., 7] = 1.0
    return g


def _sim3_calcW(phi, sigma):
    """W (..., 3, 3), integrating the translation of Sim3 exp (lietorch
    sim3.h), with the small-angle and small-scale limits."""
    theta_sq = (phi * phi).sum(-1)[..., None, None]
    small_theta = theta_sq < 1e-8
    theta = torch.sqrt(torch.where(small_theta, torch.ones_like(theta_sq),
                                   theta_sq))
    sig = sigma[..., None]
    scale = torch.exp(sig)
    Phi = skew(phi)
    Phi2 = torch.matmul(Phi, Phi)
    small_sigma = sig.abs() < 1e-5
    one = torch.ones_like(sig)

    # C = (scale - 1) / sigma, -> 1 as sigma -> 0
    sig_safe = torch.where(small_sigma, one, sig)
    C = torch.where(small_sigma, 1.0 + 0.5 * sig, (scale - 1.0) / sig_safe)
    th_safe = torch.where(small_theta, torch.ones_like(theta), theta)
    ts2 = torch.where(small_theta, torch.ones_like(theta_sq), theta_sq)
    denom = sig_safe * sig_safe + theta_sq
    sin_t, cos_t = torch.sin(th_safe), torch.cos(th_safe)

    a_gen = ((sig_safe * sin_t + (1.0 - scale * cos_t) * th_safe)
             / (th_safe * denom))
    b_gen = (C - ((scale * cos_t - 1.0) * sig_safe
                  + scale * sin_t * th_safe) / denom) / ts2
    # sigma -> 0
    a_s0 = (1.0 - cos_t) / ts2
    b_s0 = (th_safe - sin_t) / (ts2 * th_safe)
    # theta -> 0
    a_t0 = ((sig_safe - 1.0) * scale + 1.0) / (sig_safe * sig_safe)
    b_t0 = ((scale * 0.5 * sig_safe * sig_safe + scale - 1.0
             - sig_safe * scale) / (sig_safe * sig_safe * sig_safe))
    # both small
    a_00 = 0.5 + sig / 6.0
    b_00 = 1.0 / 6.0 + sig / 24.0

    a = torch.where(small_theta, torch.where(small_sigma, a_00, a_t0),
                    torch.where(small_sigma, a_s0, a_gen))
    b = torch.where(small_theta, torch.where(small_sigma, b_00, b_t0),
                    torch.where(small_sigma, b_s0, b_gen))
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return C * eye + a * Phi + b * Phi2


def sim3_exp(xi):
    """(..., 7) [tau, phi, sigma] -> Sim3 (..., 8)."""
    xi = _f32(xi)
    tau, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6:7]
    t = _mv(_sim3_calcW(phi, sigma), tau)
    return torch.cat([t, so3_exp(phi), torch.exp(sigma)], dim=-1)


def sim3_log(g):
    g = _f32(g)
    phi = so3_log(g[..., 3:7])
    sigma = torch.log(g[..., 7:8].clamp(min=_EPS))
    W = _sim3_calcW(phi, sigma)
    tau = torch.linalg.solve(W, g[..., :3, None])[..., 0]
    return torch.cat([tau, phi, sigma], dim=-1)


def sim3_inv(g):
    g = _f32(g)
    qi = quat_conj(g[..., 3:7])
    si = 1.0 / g[..., 7:8]
    return torch.cat([-si * quat_rotate(qi, g[..., :3]), qi, si], dim=-1)


def sim3_mul(g1, g2):
    g1, g2 = _f32(g1, g2)
    q1, s1 = g1[..., 3:7], g1[..., 7:8]
    t = g1[..., :3] + s1 * quat_rotate(q1, g2[..., :3])
    return torch.cat([t, quat_mul(q1, g2[..., 3:7]), s1 * g2[..., 7:8]],
                     dim=-1)


def sim3_act(g, p):
    g, p = _f32(g, p)
    return g[..., 7:8] * quat_rotate(g[..., 3:7], p) + g[..., :3]


def sim3_act4(g, p4):
    """Apply Sim3 to homogeneous points: [s R p + W t, W]."""
    g, p4 = _f32(g, p4)
    xyz = (g[..., 7:8] * quat_rotate(g[..., 3:7], p4[..., :3])
           + p4[..., 3:4] * g[..., :3])
    return torch.cat([xyz, p4[..., 3:4].expand(xyz.shape[:-1] + (1,))],
                     dim=-1)


def sim3_matrix(g):
    g = _f32(g)
    m = torch.zeros(g.shape[:-1] + (4, 4), dtype=g.dtype, device=g.device)
    m[..., :3, :3] = quat_to_matrix(g[..., 3:7]) * g[..., 7:8, None]
    m[..., :3, 3] = g[..., :3]
    m[..., 3, 3] = 1.0
    return m


def sim3_adj_matrix(g):
    """Sim3 adjoint (..., 7, 7), tangent order [tau, phi, sigma]."""
    g = _f32(g)
    R = quat_to_matrix(g[..., 3:7])
    t = g[..., :3]
    A = torch.zeros(g.shape[:-1] + (7, 7), dtype=g.dtype, device=g.device)
    A[..., :3, :3] = g[..., 7:8, None] * R
    A[..., :3, 3:6] = torch.matmul(skew(t), R)
    A[..., :3, 6] = -t
    A[..., 3:6, 3:6] = R
    A[..., 6, 6] = 1.0
    return A


def sim3_adjT(g, a):
    """Transpose-adjoint on cotangent vectors a (..., 7)."""
    g, a = _f32(g, a)
    return _mtv(sim3_adj_matrix(g), a)


def sim3_retr(g, xi):
    return sim3_mul(sim3_exp(xi), g)


def se3_to_sim3(g):
    g = _f32(g)
    return torch.cat([g, torch.ones_like(g[..., :1])], dim=-1)


def sim3_to_se3(g):
    """Drop the scale (renormalising the translation is the caller's)."""
    return _f32(g)[..., :7]
