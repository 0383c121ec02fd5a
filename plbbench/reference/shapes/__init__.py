"""One module per manipulator shape, found by its lower-case name
(PlasticineLab's plb/engine/primitive/primitives.py: Sphere :17, Capsule
:36, RollingPin :64, Chopsticks :83, Cylinder :157, Torus :193, Box :223).

Every module has, in world space, with pos (..., 3), rot (..., 4) and the
primitive's gap (...) broadcast against the points p (..., 3):

- `sdf(params, pos, rot, p, gap)`: the signed distance at p;
- `normal(params, pos, rot, p, gap)`: the outward unit normal at p;
- `bounding_radius(params, gap)`: the radius of a sphere about pos that
  holds the shape, a float, or a tensor of the gap's shape where the
  shape's extent follows its gap.

The gap is the opening of a Chopsticks; every other shape takes it and
ignores it. A module may also have

- `init_gap(params)`: the gap at the start; a shape without it has no gap
  (0 in the state, none in the observation, no gap velocity);
- `fk(params, pos, rot, gap, v, w, gap_vel)` -> (pos, rot, gap): its own
  kinematics of one substep, pos before the bounds' clamp; a shape without
  it moves by the base rule (`mpm.fk`).

A configuration with a new shape adds a module here.
"""
import importlib


def shape_module(shape: str):
    return importlib.import_module(f"{__name__}.{shape.lower()}")


def has_gap(shape: str) -> bool:
    return hasattr(shape_module(shape), "init_gap")


def init_gap(shape: str, params: dict) -> float:
    """The gap of a primitive at the start: its shape's, or 0."""
    return shape_module(shape).init_gap(params) if has_gap(shape) else 0.0
