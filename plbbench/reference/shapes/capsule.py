"""Capsule (plb/engine/primitive/primitives.py:31-45): a segment of
length h along the local y axis, radius r (defaults h 0.06, r 0.03,
`Capsule.default_config`)."""
import torch

from ..quat import qrot, to_local


def _segment_offset(params, q):
    h = params.get("h", 0.06)
    y = q[..., 1] + h / 2
    y = y - torch.clamp(y, 0.0, h)
    return torch.stack([q[..., 0], y, q[..., 2]], dim=-1)


def _len(d):
    return torch.sqrt((d * d).sum(-1) + 1e-14)


def local_sdf(params, q):
    """The signed distance at q in the capsule's own frame."""
    return _len(_segment_offset(params, q)) - params.get("r", 0.03)


def local_normal(params, q):
    """The outward unit normal at q in the capsule's own frame."""
    q2 = _segment_offset(params, q)
    return q2 / _len(q2)[..., None]


def sdf(params, pos, rot, p, gap):
    return local_sdf(params, to_local(p, pos, rot))


def normal(params, pos, rot, p, gap):
    return qrot(rot, local_normal(params, to_local(p, pos, rot)))


def bounding_radius(params, gap):
    return params.get("h", 0.06) / 2 + params.get("r", 0.03)
