"""A configuration's frozen task spec as the plain reference reads it.

The derived simulator constants follow PlasticineLab's own formulas
(plb/engine/mpm_simulator.py:15-34, plb/config/default_config.py); nothing
here is read from the program under test. `Scene` is plain data: numbers,
tuples and one tuple of `Prim` per manipulator.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class Prim:
    shape: str
    params: dict                    # shape parameters (radius, h, r, ...)
    friction: float
    init_pos: Tuple[float, float, float]
    init_rot: Tuple[float, float, float, float]
    lower: Tuple[float, float, float]
    upper: Tuple[float, float, float]
    action_dim: int
    action_scale: Tuple[float, ...]
    color: Tuple[float, float, float]


@dataclass(frozen=True)
class Scene:
    n_grid: int
    dx: float
    inv_dx: float
    dt: float
    substeps: int
    p_vol: float
    p_mass: float
    mu: float
    lam: float
    yield_stress: float
    gravity: Tuple[float, float, float]
    ground_friction: float
    grid_v_clamp: float
    prims: Tuple[Prim, ...]
    weight_sdf: float
    weight_density: float
    weight_contact: float
    soft_contact: bool
    n_observed: int
    renderer: dict

    @property
    def action_dim(self) -> int:
        return sum(p.action_dim for p in self.prims)


_SHAPE_KEYS = ("radius", "h", "r", "size", "tx", "ty", "minimal_gap", "init_gap")


def scene_of(spec: dict) -> Scene:
    """The frozen resolved spec of a configuration file -> Scene."""
    sim = spec.get("SIMULATOR") or {}
    quality = float(sim.get("quality", 1.0)) * 0.5          # 3-D halves the quality
    n_grid = int(128 * quality)
    dx = 1.0 / n_grid
    dt = 0.5e-4 / quality
    E, nu = float(sim.get("E", 5e3)), float(sim.get("nu", 0.2))
    p_vol = (dx * 0.5) ** 2
    prims = []
    for p in spec.get("PRIMITIVES") or []:
        action = p.get("action") or {}
        prims.append(Prim(
            shape=p["shape"],
            params={k: p[k] for k in _SHAPE_KEYS if k in p},
            friction=float(p.get("friction", 0.9)),
            init_pos=tuple(p.get("init_pos", (0.3, 0.3, 0.3))),
            init_rot=tuple(p.get("init_rot", (1.0, 0.0, 0.0, 0.0))),
            lower=tuple(p.get("lower_bound", (0.0, 0.0, 0.0))),
            upper=tuple(p.get("upper_bound", (1.0, 1.0, 1.0))),
            action_dim=int(action.get("dim", 0)),
            action_scale=tuple(action.get("scale", ())),
            color=tuple(p.get("color", (0.3, 0.3, 0.3)))))
    loss = (spec.get("ENV") or {}).get("loss") or {}
    weight = loss.get("weight") or {}
    return Scene(
        n_grid=n_grid, dx=dx, inv_dx=float(n_grid), dt=dt, substeps=int(2e-3 // dt),
        p_vol=p_vol, p_mass=p_vol, mu=E / (2 * (1 + nu)),
        lam=E * nu / ((1 + nu) * (1 - 2 * nu)),
        yield_stress=float(sim.get("yield_stress", 50.0)),
        gravity=tuple(sim.get("gravity", (0.0, -1.0, 0.0))),
        ground_friction=float(sim.get("ground_friction", 1.5)),
        grid_v_clamp=float(sim.get("grid_v_clamp", 0.0)),
        prims=tuple(prims),
        weight_sdf=float(weight.get("sdf", 10.0)),
        weight_density=float(weight.get("density", 10.0)),
        weight_contact=float(weight.get("contact", 1.0)),
        soft_contact=bool(loss.get("soft_contact", False)),
        n_observed=int((spec.get("ENV") or {}).get("n_observed_particles", 200)),
        renderer=dict(spec.get("RENDERER") or {}))
