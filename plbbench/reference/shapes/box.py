"""Box (plb/engine/primitive/primitives.py:223-257): half-sizes `size`
along the local axes (0.1 each by `Box.default_config`); the normal by
central differences of the signed distance, d = 1e-4 (:240-251)."""
import torch

from ..quat import qrot, to_local

D = 1e-4


def _size(params):
    return params.get("size", (0.1, 0.1, 0.1))


def _len(d):
    return torch.sqrt((d * d).sum(-1) + 1e-14)


def _local_sdf(params, q):
    half = torch.tensor(_size(params), dtype=q.dtype, device=q.device)
    e = q.abs() - half
    return _len(torch.clamp(e, min=0.0)) + torch.clamp(e.amax(-1), max=0.0)


def sdf(params, pos, rot, p, gap):
    return _local_sdf(params, to_local(p, pos, rot))


def normal(params, pos, rot, p, gap):
    q = to_local(p, pos, rot)
    step = torch.eye(3, dtype=q.dtype, device=q.device) * D
    n = torch.stack([(_local_sdf(params, q + step[i]) - _local_sdf(params, q - step[i]))
                     * (0.5 / D) for i in range(3)], dim=-1)
    return qrot(rot, n / _len(n)[..., None])


def bounding_radius(params, gap):
    return float(sum(s * s for s in _size(params)) ** 0.5)
