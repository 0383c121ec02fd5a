"""Rigid SDF manipulators: analytic SDF/normal, contact response, kinematics.

Counterpart of `plasticinelab_tpu/engine/primitives.py`; behavioral
reference plb/engine/primitive/{primive_base.py, primitives.py}. Every
function is plain tensor code over one primitive's pose (pos (3,), rot (4,),
gap ()), broadcast over points (..., 3). The CUDA grid-update kernel
(`csrc/gridop.cu`) carries the same math per cell.

Conventions carried over from the reference:
- `length` eps is 1e-14 inside shape SDFs/normals (primitives.py:8-10) and
  1e-8 in the contact response (primive_base.py imports utils.length).
- Sphere's sdf/normal are world-frame and ignore rotation (primitives.py:22-28).
- Box normals are central finite differences with d=1e-4 (primitives.py:240-251).
"""
from __future__ import annotations

import math
import struct
from typing import Dict

import torch

from ..config.spec import PrimitiveSpec
from ..utils.profiling import counter_group
from .quat import inv_trans, qmul, qrot, quat_conj, w2quat

__all__ = [
    "sdf", "normal", "collide", "collider_v", "forward_kinematics",
    "action_to_velocity", "bounding_radius",
]


def _length(x, eps=1e-14):
    return torch.sqrt(torch.sum(x * x, dim=-1) + eps)


def _normalize(x, eps=1e-14):
    return x / _length(x, eps)[..., None]


# the constant vectors of the shapes, built once per values, dtype and device
_consts: Dict[tuple, torch.Tensor] = {}
counts = counter_group("primitives", ("consts_built", "consts_reused"))


def _const(like, *vals):
    """The vector `vals` in `like`'s dtype on its device, the same tensor on
    every call: `torch.tensor` on a card copies from pageable host memory and
    waits for the stream to drain, so a constant is uploaded only the first
    time. Keyed by the values' float64 bits (0.0 and -0.0 differ). Built
    outside inference mode, so that autograd may save it later; never
    modified in place."""
    key = (struct.pack(f"{len(vals)}d", *vals), like.dtype, like.device)
    out = _consts.get(key)
    if out is None:
        with torch.inference_mode(False):
            out = _consts[key] = torch.tensor(vals, dtype=like.dtype, device=like.device)
        counts["consts_built"] += 1
    else:
        counts["consts_reused"] += 1
    return out


# --------------------------------------------------------------------------
# local-frame sdf / normal per shape
# --------------------------------------------------------------------------

def _capsule_p2(spec: PrimitiveSpec, p):
    y = p[..., 1] + spec.h / 2
    y = y - torch.clamp(y, 0.0, spec.h)
    return torch.stack([p[..., 0], y, p[..., 2]], dim=-1)


def _capsule_sdf(spec: PrimitiveSpec, p):
    return _length(_capsule_p2(spec, p)) - spec.r


def _capsule_normal(spec: PrimitiveSpec, p):
    return _normalize(_capsule_p2(spec, p))


def _chopsticks_parts(spec: PrimitiveSpec, p, gap):
    gap = torch.as_tensor(gap, dtype=p.dtype, device=p.device)
    zero = torch.zeros_like(gap)
    delta = torch.stack([gap / 2, zero, zero], dim=-1)
    pp = p - _const(p, 0.0, -spec.h / 2, 0.0)
    return pp - delta, pp + delta


def _cylinder_sdf(spec: PrimitiveSpec, p):
    # NB the reference swaps the usual roles: h is radial extent, r is the
    # half-height (primitives.py:163-167).
    d0 = torch.abs(_length(torch.stack([p[..., 0], p[..., 2]], dim=-1))) - spec.h
    d1 = torch.abs(p[..., 1]) - spec.r
    d0c = torch.clamp(d0, min=0.0)
    d1c = torch.clamp(d1, min=0.0)
    return torch.clamp(torch.maximum(d0, d1), max=0.0) + torch.sqrt(
        d0c * d0c + d1c * d1c + 1e-14
    )


def _cylinder_normal(spec: PrimitiveSpec, p):
    xz = torch.stack([p[..., 0], p[..., 2]], dim=-1)
    l = _length(xz)
    d = torch.stack([l, torch.abs(p[..., 1])], dim=-1) - _const(p, spec.h, spec.r)
    f = (d[..., 0] > d[..., 1]).to(p.dtype)
    inside = (torch.maximum(d[..., 0], d[..., 1]) <= 0.0).to(p.dtype)
    n2 = torch.clamp(d, min=0.0) + inside[..., None] * torch.stack([f, 1.0 - f], dim=-1)
    n2 = _normalize(n2)
    p2 = xz / l[..., None]
    ysign = (p[..., 1] >= 0).to(p.dtype) * 2.0 - 1.0
    n3 = torch.stack(
        [p2[..., 0] * n2[..., 0], n2[..., 1] * ysign, p2[..., 1] * n2[..., 0]],
        dim=-1,
    )
    return _normalize(n3)


def _torus_sdf(spec: PrimitiveSpec, p):
    xz = torch.stack([p[..., 0], p[..., 2]], dim=-1)
    q = torch.stack([_length(xz) - spec.tx, p[..., 1]], dim=-1)
    return _length(q) - spec.ty


def _torus_normal(spec: PrimitiveSpec, p):
    xz = torch.stack([p[..., 0], p[..., 2]], dim=-1)
    l = _length(xz)
    q = torch.stack([l - spec.tx, p[..., 1]], dim=-1)
    n2 = q / _length(q)[..., None]
    x2 = xz / l[..., None]
    n3 = torch.stack(
        [x2[..., 0] * n2[..., 0], n2[..., 1], x2[..., 1] * n2[..., 0]], dim=-1
    )
    return _normalize(n3)


def _box_sdf(spec: PrimitiveSpec, p):
    q = torch.abs(p) - _const(p, *spec.size)
    out = _length(torch.clamp(q, min=0.0))
    return out + torch.clamp(torch.amax(q, dim=-1), max=0.0)


def _box_normal(spec: PrimitiveSpec, p):
    # central FD with d=1e-4, like the reference (primitives.py:240-251)
    d = 1e-4
    comps = []
    for i in range(3):
        e = torch.zeros(3, dtype=p.dtype, device=p.device)
        e[i] = d
        comps.append((_box_sdf(spec, p + e) - _box_sdf(spec, p - e)) * (0.5 / d))
    return _normalize(torch.stack(comps, dim=-1))


def _local_sdf(spec: PrimitiveSpec, p, gap):
    shape = spec.shape
    if shape in ("Capsule", "RollingPin"):
        return _capsule_sdf(spec, p)
    if shape == "Chopsticks":
        a, b = _chopsticks_parts(spec, p, gap)
        return torch.minimum(_capsule_sdf(spec, a), _capsule_sdf(spec, b))
    if shape == "Cylinder":
        return _cylinder_sdf(spec, p)
    if shape == "Torus":
        return _torus_sdf(spec, p)
    if shape == "Box":
        return _box_sdf(spec, p)
    raise NotImplementedError(shape)


def _local_normal(spec: PrimitiveSpec, p, gap):
    shape = spec.shape
    if shape in ("Capsule", "RollingPin"):
        return _capsule_normal(spec, p)
    if shape == "Chopsticks":
        a, b = _chopsticks_parts(spec, p, gap)
        m = (_capsule_sdf(spec, a) <= _capsule_sdf(spec, b)).to(p.dtype)[..., None]
        return m * _capsule_normal(spec, a) + (1.0 - m) * _capsule_normal(spec, b)
    if shape == "Cylinder":
        return _cylinder_normal(spec, p)
    if shape == "Torus":
        return _torus_normal(spec, p)
    if shape == "Box":
        return _box_normal(spec, p)
    raise NotImplementedError(shape)


# --------------------------------------------------------------------------
# world-frame interface
# --------------------------------------------------------------------------

def sdf(spec: PrimitiveSpec, pos, rot, gap, p):
    """World-frame signed distance at point(s) p (...,3)."""
    if spec.shape == "Sphere":
        return _length(p - pos) - spec.radius
    return _local_sdf(spec, inv_trans(p, pos, rot), gap)


def bounding_radius(spec: PrimitiveSpec, gap):
    """Radius of a sphere centered at the primitive's world position that
    contains its entire {sdf <= 0} set (conservative): a float, or for a
    Chopsticks given its gap as a tensor, a tensor of the gap's shape and
    type (no host sync)."""
    shape = spec.shape
    if shape == "Sphere":
        return float(spec.radius)
    if shape in ("Capsule", "RollingPin"):
        return spec.h / 2 + spec.r
    if shape == "Chopsticks":
        # parts span y in [-h, 0] around the handle origin, offset +-gap/2
        return spec.h + spec.r + abs(gap) / 2
    if shape == "Cylinder":
        return math.hypot(spec.h, spec.r)
    if shape == "Torus":
        return spec.tx + spec.ty
    if shape == "Box":
        return math.sqrt(sum(s * s for s in spec.size))
    raise NotImplementedError(shape)


def normal(spec: PrimitiveSpec, pos, rot, gap, p):
    """World-frame outward normal at point(s) p (...,3)."""
    if spec.shape == "Sphere":
        return _normalize(p - pos)
    local = inv_trans(p, pos, rot)
    return qrot(rot, _local_normal(spec, local, gap))


def collider_v(pos_f, rot_f, pos_f1, rot_f1, p, dt):
    """Rigid-body velocity of the collider surface at point(s) p
    (reference primive_base.py:82-89)."""
    rel = qrot(quat_conj(rot_f), p - pos_f)
    new_pos = qrot(rot_f1, rel) + pos_f1
    return (new_pos - p) / dt


def collide(spec: PrimitiveSpec, pos_f, rot_f, gap_f, pos_f1, rot_f1,
            friction, softness, grid_pos, v_out, dt):
    """Softness-weighted friction contact response on grid velocities
    (reference primive_base.py:91-115). Branchless: the update is computed
    everywhere and selected with the reference's condition."""
    dist = sdf(spec, pos_f, rot_f, gap_f, grid_pos)
    influence = torch.clamp(torch.exp(-dist * softness), max=1.0)
    cond = ((softness > 0) & (influence > 0.1)) | (dist <= 0)

    D = normal(spec, pos_f, rot_f, gap_f, grid_pos)
    cv = collider_v(pos_f, rot_f, pos_f1, rot_f1, grid_pos, dt)

    input_v = v_out - cv
    normal_component = torch.sum(input_v * D, dim=-1)
    grid_v_t = input_v - torch.clamp(normal_component, max=0.0)[..., None] * D
    grid_v_t_norm = _length(grid_v_t, 1e-8)  # utils.length eps
    scale = torch.clamp(grid_v_t_norm + normal_component * friction, min=0.0)
    grid_v_t_friction = grid_v_t / grid_v_t_norm[..., None] * scale[..., None]
    flag = ((normal_component < 0)
            & (torch.sqrt(torch.sum(grid_v_t * grid_v_t, dim=-1)) > 1e-30)
            ).to(v_out.dtype)[..., None]
    grid_v_t = grid_v_t_friction * flag + grid_v_t * (1.0 - flag)
    new_v = cv + input_v * (1.0 - influence[..., None]) + grid_v_t * influence[..., None]
    return torch.where(cond[..., None], new_v, v_out)


# --------------------------------------------------------------------------
# kinematics & actions
# --------------------------------------------------------------------------

def forward_kinematics(spec: PrimitiveSpec, pos, rot, gap, v, w, gap_vel):
    """One-substep pose integration -> (pos', rot', gap'). Elementwise over
    leading dims (envs): pos (..., 3), rot (..., 4), gap (...).

    Base: primive_base.py:117-121; RollingPin: primitives.py:66-80;
    Chopsticks: primitives.py:94-99.
    """
    lb = _const(pos, *spec.lower_bound)
    ub = _const(pos, *spec.upper_bound)

    if spec.shape == "RollingPin":
        dw, dth, dy = v[..., 0], v[..., 1], v[..., 2]
        y_dir = qrot(rot, _const(pos, 0.0, -1.0, 0.0))
        x_dir = torch.linalg.cross(_const(pos, 0.0, 1.0, 0.0).expand_as(y_dir), y_dir)
        x_dir = x_dir * dw[..., None] * 0.03
        x_dir = torch.stack([x_dir[..., 0], dy, x_dir[..., 2]], dim=-1)
        zeros = torch.zeros_like(dth)
        new_rot = qmul(
            w2quat(torch.stack([zeros, -dth, zeros], dim=-1)),
            qmul(rot, w2quat(torch.stack([zeros, dw, zeros], dim=-1))),
        )
        new_pos = torch.maximum(torch.minimum(pos + x_dir, ub), lb)
        return new_pos, new_rot, gap

    new_pos = torch.maximum(torch.minimum(pos + v, ub), lb)
    if spec.shape == "Chopsticks":
        new_gap = torch.clamp(gap - gap_vel, min=spec.minimal_gap)
        return new_pos, qmul(rot, w2quat(w)), new_gap
    return new_pos, qmul(w2quat(w), rot), gap


def action_to_velocity(spec: PrimitiveSpec, action, n_substeps):
    """Env-step action slice (..., action_dim) -> per-substep (v (..., 3),
    w (..., 3), gap_vel (...)) (reference primive_base.py:184-192,
    Chopsticks primitives.py:101-109); leading dims are envs."""
    lead = action.shape[:-1]
    zeros3 = action.new_zeros(lead + (3,))
    zero = action.new_zeros(lead)
    if spec.action_dim == 0:
        return zeros3, zeros3, zero
    a = action * _const(action, *spec.action_scale) / n_substeps
    v = a[..., :3]
    w = a[..., 3:6] if spec.action_dim > 3 else zeros3
    gap_vel = a[..., 6] if spec.shape == "Chopsticks" else zero
    return v, w, gap_vel
