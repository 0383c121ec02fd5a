"""RollingPin (plb/engine/primitive/primitives.py:64-80): a Capsule's
shape, moved by its own kinematics (forward_kinematics :66-80): of the
action's velocity v, v0 = dw rolls the pin about its own axis and moves it
0.03 dw along x_dir = e_y x (rot e_-y), v1 = dth turns it about the world's
y axis, v2 = dy lifts it; rot <- w2quat((0, -dth, 0)) rot w2quat((0, dw, 0))."""
import torch

from ..quat import cross, qmul, qrot, w2quat
from .capsule import bounding_radius, normal, sdf  # noqa: F401  the Capsule's shape


def fk(params, pos, rot, gap, v, w, gap_vel):
    dw, dth, dy = v[..., 0], v[..., 1], v[..., 2]
    down = torch.tensor([0.0, -1.0, 0.0], dtype=pos.dtype, device=pos.device)
    up = torch.tensor([0.0, 1.0, 0.0], dtype=pos.dtype, device=pos.device)
    x_dir = cross(up, qrot(rot, down)) * dw[..., None] * 0.03
    move = torch.stack([x_dir[..., 0], dy, x_dir[..., 2]], dim=-1)
    zero = torch.zeros_like(dw)
    new_rot = qmul(w2quat(torch.stack([zero, -dth, zero], dim=-1)),
                   qmul(rot, w2quat(torch.stack([zero, dw, zero], dim=-1))))
    return pos + move, new_rot, gap
