"""Capsule (plb/engine/primitive/primitives.py:31-45): a segment of
length h along the local y axis, radius r."""
import torch

from ..quat import qrot, to_local


def _segment_offset(params, q):
    h = params.get("h", 0.06)
    y = q[..., 1] + h / 2
    y = y - torch.clamp(y, 0.0, h)
    return torch.stack([q[..., 0], y, q[..., 2]], dim=-1)


def _len(d):
    return torch.sqrt((d * d).sum(-1) + 1e-14)


def sdf(params, pos, rot, p):
    return _len(_segment_offset(params, to_local(p, pos, rot))) - params.get("r", 0.03)


def normal(params, pos, rot, p):
    q2 = _segment_offset(params, to_local(p, pos, rot))
    return qrot(rot, q2 / _len(q2)[..., None])


def bounding_radius(params):
    return params.get("h", 0.06) / 2 + params.get("r", 0.03)
