"""Cylinder (plb/engine/primitive/primitives.py:157-192): about the local
y axis, with PlasticineLab's roles of the two sizes swapped against the
usual ones: h is the radius, r the half-height (:163-167). The signed
distance is a 2-D box's in (|p_xz|, p_y); the normal is the 2-D box's,
turned back about the axis (its y by the sign of p_y)."""
import torch

from ..quat import qrot, to_local


def _len(d):
    return torch.sqrt((d * d).sum(-1) + 1e-14)


def _d(params, q):
    xz = torch.stack([q[..., 0], q[..., 2]], dim=-1)
    return xz, torch.stack([_len(xz).abs() - params["h"], q[..., 1].abs() - params["r"]], dim=-1)


def sdf(params, pos, rot, p, gap):
    _, d = _d(params, to_local(p, pos, rot))
    return (torch.clamp(torch.maximum(d[..., 0], d[..., 1]), max=0.0)
            + _len(torch.clamp(d, min=0.0)))


def normal(params, pos, rot, p, gap):
    q = to_local(p, pos, rot)
    xz, d = _d(params, q)
    f = (d[..., 0] > d[..., 1]).to(q.dtype)
    inside = (torch.maximum(d[..., 0], d[..., 1]) <= 0.0).to(q.dtype)
    n2 = torch.clamp(d, min=0.0) + inside[..., None] * torch.stack([f, 1.0 - f], dim=-1)
    n2 = n2 / _len(n2)[..., None]
    p2 = xz / _len(xz)[..., None]
    side = (q[..., 1] >= 0).to(q.dtype) * 2.0 - 1.0
    n3 = torch.stack([p2[..., 0] * n2[..., 0], n2[..., 1] * side, p2[..., 1] * n2[..., 0]],
                     dim=-1)
    return qrot(rot, n3 / _len(n3)[..., None])


def bounding_radius(params, gap):
    return float((params["h"] ** 2 + params["r"] ** 2) ** 0.5)
