"""SE(3) in plain PyTorch, float32: the reference's geometry.

Poses are ``[t (3), q (4)]`` with the quaternion scalar last; tangents are
``[tau (3), phi (3)]``.  Written from the group's formulas (the exponential
with the left Jacobian, its inverse for the logarithm), as DPVO's lietorch
defines them.
"""
from __future__ import annotations

import torch

EPS = 1e-8


def quat_mul(a, b):
    x1, y1, z1, w1 = a.unbind(-1)
    x2, y2, z2, w2 = b.unbind(-1)
    return torch.stack([w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
                        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2], dim=-1)


def quat_conj(q):
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def quat_rotate(q, v):
    uv = torch.linalg.cross(q[..., :3], v, dim=-1)
    return v + 2.0 * (q[..., 3:4] * uv
                      + torch.linalg.cross(q[..., :3], uv, dim=-1))


def quat_matrix(q):
    x, y, z, w = q.unbind(-1)
    r = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y), 2 * (x * y + w * z),
                     1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                     2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], dim=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


def skew(v):
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([o, -z, y, z, o, -x, -y, x, o],
                       dim=-1).reshape(v.shape[:-1] + (3, 3))


def _jacobian_terms(theta_sq):
    small = theta_sq < 1e-8
    ts = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    return small, ts, torch.sqrt(ts)


def left_jacobian(phi):
    theta_sq = (phi * phi).sum(-1)[..., None, None]
    small, ts, th = _jacobian_terms(theta_sq)
    Phi = skew(phi)
    a = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(th)) / ts)
    b = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                    (th - torch.sin(th)) / (ts * th))
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye + a * Phi + b * (Phi @ Phi)


def left_jacobian_inv(phi):
    theta_sq = (phi * phi).sum(-1)[..., None, None]
    small, ts, th = _jacobian_terms(theta_sq)
    Phi = skew(phi)
    half = 0.5 * th
    cot = half * torch.cos(half) / torch.sin(half).clamp(min=EPS)
    b = torch.where(small, 1.0 / 12.0 + theta_sq / 720.0, (1.0 - cot) / ts)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye - 0.5 * Phi + b * (Phi @ Phi)


def so3_exp(phi):
    theta_sq = (phi * phi).sum(-1, keepdim=True)
    small, _, th = _jacobian_terms(theta_sq)
    k = torch.where(small, 0.5 - theta_sq / 48.0, torch.sin(0.5 * th) / th)
    w = torch.where(small, 1.0 - theta_sq / 8.0, torch.cos(0.5 * th))
    return torch.cat([k * phi, w], dim=-1)


def so3_log(q):
    qv, w = q[..., :3], q[..., 3:4]
    n_sq = (qv * qv).sum(-1, keepdim=True)
    small, _, n = _jacobian_terms(n_sq)
    theta = 2.0 * torch.atan2(n, w.abs())
    sign = torch.where(w < 0, -1.0, 1.0)
    k = torch.where(small, 2.0 / w.abs().clamp(min=EPS), theta / n)
    return sign * k * qv


def exp(xi):
    """se3 (..., 6) -> SE3 (..., 7)."""
    q = so3_exp(xi[..., 3:])
    t = (left_jacobian(xi[..., 3:]) @ xi[..., :3, None])[..., 0]
    return torch.cat([t, q], dim=-1)


def log(g):
    """SE3 (..., 7) -> se3 (..., 6)."""
    phi = so3_log(g[..., 3:])
    tau = (left_jacobian_inv(phi) @ g[..., :3, None])[..., 0]
    return torch.cat([tau, phi], dim=-1)


def inv(g):
    qi = quat_conj(g[..., 3:])
    return torch.cat([-quat_rotate(qi, g[..., :3]), qi], dim=-1)


def mul(a, b):
    return torch.cat([a[..., :3] + quat_rotate(a[..., 3:], b[..., :3]),
                      quat_mul(a[..., 3:], b[..., 3:])], dim=-1)


def act4(g, p):
    """g applied to homogeneous points (..., 4): [R p + w t, w]."""
    xyz = quat_rotate(g[..., 3:], p[..., :3]) + p[..., 3:] * g[..., :3]
    return torch.cat([xyz, p[..., 3:]], dim=-1)


def adjT(g, a):
    """The transposed adjoint of g applied to cotangents a (..., 6)."""
    R = quat_matrix(g[..., 3:])
    tR = skew(g[..., :3]) @ R
    adj = torch.cat([torch.cat([R, tR], -1),
                     torch.cat([torch.zeros_like(R), R], -1)], -2)
    return (adj.transpose(-1, -2) @ a[..., None])[..., 0]


def retr(g, xi):
    return mul(exp(xi), g)
