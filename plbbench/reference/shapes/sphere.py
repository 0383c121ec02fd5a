"""Sphere (plb/engine/primitive/primitives.py:22-28): world frame, the
rotation ignored."""
import torch


def _len(d):
    return torch.sqrt((d * d).sum(-1) + 1e-14)


def sdf(params, pos, rot, p, gap):
    return _len(p - pos) - params["radius"]


def normal(params, pos, rot, p, gap):
    d = p - pos
    return d / _len(d)[..., None]


def bounding_radius(params, gap):
    return float(params["radius"])
