"""Unit quaternions (w, x, y, z) on trailing axes, from PlasticineLab's
plb/engine/primitive/utils.py (qrot, qmul, w2quat, inv_trans)."""
from __future__ import annotations

import torch


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def qrot(q, v):
    """v rotated by q: v + 2 (w (q_v x v) + q_v x (q_v x v))."""
    uv = cross(q[..., 1:], v)
    return v + 2.0 * (q[..., :1] * uv + cross(q[..., 1:], uv))


def qmul(q, r):
    """Hamilton product, renormalised."""
    w = q[..., 0] * r[..., 0] - (q[..., 1:] * r[..., 1:]).sum(-1)
    xyz = q[..., :1] * r[..., 1:] + r[..., :1] * q[..., 1:] + cross(q[..., 1:], r[..., 1:])
    out = torch.cat([w[..., None], xyz], dim=-1)
    return out / out.norm(dim=-1, keepdim=True)


def w2quat(w, thresh=1e-9):
    """Axis-angle -> quaternion; the identity at or under `thresh`."""
    dot = (w * w).sum(-1, keepdim=True)
    big = dot > thresh * thresh
    theta = torch.sqrt(torch.where(big, dot, torch.ones_like(dot)))
    rot = torch.cat([torch.cos(theta / 2), w / theta * torch.sin(theta / 2)], dim=-1)
    ident = torch.cat([torch.ones_like(dot), torch.zeros_like(w)], dim=-1)
    return torch.where(big, rot, ident)


def conj(q):
    c = torch.cat([q[..., :1], -q[..., 1:]], dim=-1)
    return c / c.norm(dim=-1, keepdim=True)


def to_local(p, pos, rot):
    """World point -> the primitive's frame."""
    return qrot(conj(rot), p - pos)
