"""Torus (plb/engine/primitive/primitives.py:193-222): a ring of radius tx
about the local y axis, its tube ty thick."""
import torch

from ..quat import qrot, to_local


def _len(d):
    return torch.sqrt((d * d).sum(-1) + 1e-14)


def _ring(params, q):
    xz = torch.stack([q[..., 0], q[..., 2]], dim=-1)
    return xz, torch.stack([_len(xz) - params["tx"], q[..., 1]], dim=-1)


def sdf(params, pos, rot, p, gap):
    _, t = _ring(params, to_local(p, pos, rot))
    return _len(t) - params["ty"]


def normal(params, pos, rot, p, gap):
    xz, t = _ring(params, to_local(p, pos, rot))
    n = t / _len(t)[..., None]
    x2 = xz / _len(xz)[..., None]
    n3 = torch.stack([x2[..., 0] * n[..., 0], n[..., 1], x2[..., 1] * n[..., 0]], dim=-1)
    return qrot(rot, n3 / _len(n3)[..., None])


def bounding_radius(params, gap):
    return float(params["tx"] + params["ty"])
