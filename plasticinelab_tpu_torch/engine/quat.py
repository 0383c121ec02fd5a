"""Quaternion utilities (wxyz convention) on trailing axes.

Counterpart of `plasticinelab_tpu/engine/quat.py`; behavioral reference
plb/engine/primitive/utils.py:7-47 (qrot, qmul, w2quat, inv_trans).
"""
from __future__ import annotations

import torch

__all__ = ["length", "qrot", "qmul", "w2quat", "quat_conj", "inv_trans"]


def length(x, eps=1e-8, dim=-1):
    """sqrt(x.x + eps) — matches reference utils.length (eps=1e-8)."""
    return torch.sqrt(torch.sum(x * x, dim=dim) + eps)


def _cross(a, b):
    return torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=-1)


def qrot(q, v):
    """Rotate vector(s) v by quaternion(s) q = (w, x, y, z).

    v' = v + 2*(w*(qvec x v) + qvec x (qvec x v))  [reference utils.py:7-13]
    """
    qvec = q[..., 1:4]
    uv = _cross(qvec, v)
    uuv = _cross(qvec, uv)
    return v + 2.0 * (q[..., 0:1] * uv + uuv)


def qmul(q, r):
    """Hamilton product q ⊗ r, renormalized (reference utils.py:19-27)."""
    w = q[..., 0] * r[..., 0] - q[..., 1] * r[..., 1] - q[..., 2] * r[..., 2] - q[..., 3] * r[..., 3]
    x = q[..., 0] * r[..., 1] + q[..., 1] * r[..., 0] + q[..., 2] * r[..., 3] - q[..., 3] * r[..., 2]
    y = q[..., 0] * r[..., 2] - q[..., 1] * r[..., 3] + q[..., 2] * r[..., 0] + q[..., 3] * r[..., 1]
    z = q[..., 0] * r[..., 3] + q[..., 1] * r[..., 2] - q[..., 2] * r[..., 1] + q[..., 3] * r[..., 0]
    out = torch.stack([w, x, y, z], dim=-1)
    return out / torch.sqrt(torch.sum(out * out, dim=-1, keepdim=True))


def w2quat(axis_angle, thresh=1e-9):
    """Axis-angle (3,) -> unit quaternion; identity below |w| <= thresh
    (reference utils.py:29-41)."""
    dot = torch.sum(axis_angle * axis_angle, dim=-1, keepdim=True)
    big = dot > thresh * thresh
    w = torch.sqrt(torch.where(big, dot, torch.ones_like(dot)))
    half = w * 0.5
    v = (axis_angle / w) * torch.sin(half)
    rot = torch.cat([torch.cos(half), v], dim=-1)
    ident = torch.cat([torch.ones_like(half), torch.zeros_like(axis_angle)], dim=-1)
    return torch.where(big, rot, ident)


def quat_conj(q):
    """Conjugate (w, -x, -y, -z), renormalized like reference inv_trans."""
    conj = torch.cat([q[..., :1], -q[..., 1:]], dim=-1)
    return conj / torch.sqrt(torch.sum(conj * conj, dim=-1, keepdim=True))


def inv_trans(pos, position, rotation):
    """World point -> primitive local frame (reference utils.py:43-47)."""
    return qrot(quat_conj(rotation), pos - position)
