"""Chopsticks (plb/engine/primitive/primitives.py:83-156): two capsules of
length h and radius r along the local y axis, offset by +-gap/2 along the
local x axis about a handle origin h/2 below the primitive's position; the
signed distance is the nearer stick's, and so is the normal (the first
stick's where they tie). The gap opens and closes by the seventh action
(set_velocity :101-109) and never falls under `minimal_gap` (0.06 by
`Chopsticks.default_config`); the turn composes in the sticks' own frame,
rot w2quat(w) (forward_kinematics :94-99)."""
import torch

from ..quat import qmul, qrot, to_local, w2quat
from .capsule import local_normal, local_sdf


def _sticks(params, q, gap):
    """The point q, in the primitive's frame, in each stick's frame."""
    h = params.get("h", 0.06)
    gap = torch.as_tensor(gap, dtype=q.dtype, device=q.device)
    zero = torch.zeros_like(gap)
    delta = torch.stack([gap / 2, zero, zero], dim=-1)
    mid = torch.tensor([0.0, -h / 2, 0.0], dtype=q.dtype, device=q.device)
    pp = q - mid
    return pp - delta, pp + delta


def sdf(params, pos, rot, p, gap):
    a, b = _sticks(params, to_local(p, pos, rot), gap)
    return torch.minimum(local_sdf(params, a), local_sdf(params, b))


def normal(params, pos, rot, p, gap):
    a, b = _sticks(params, to_local(p, pos, rot), gap)
    first = (local_sdf(params, a) <= local_sdf(params, b))[..., None]
    return qrot(rot, torch.where(first, local_normal(params, a), local_normal(params, b)))


def bounding_radius(params, gap):
    """The sticks span y in [-h, 0] about the handle origin, each r thick
    and |gap| / 2 off the axis."""
    return params.get("h", 0.06) + params.get("r", 0.03) + torch.as_tensor(gap).abs() / 2


def init_gap(params):
    return float(params.get("init_gap", 0.06))


def fk(params, pos, rot, gap, v, w, gap_vel):
    new_gap = torch.clamp(gap - gap_vel, min=float(params.get("minimal_gap", 0.06)))
    return pos + v, qmul(rot, w2quat(w)), new_gap
