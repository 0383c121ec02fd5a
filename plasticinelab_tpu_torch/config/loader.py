"""Task config loading: a resolved task JSON -> SceneSpec.

Counterpart of `plasticinelab_tpu/config/loader.py` for the resolved specs
only (`plasticinelab_tpu/envs/specs/*.json`, variants already applied). The
reference-schema YAML path is not ported: it needs PyYAML, which the GPU
machines do not carry. Arithmetic-string values like "0.2/2" or "(127<<16)"
are evaluated as the reference does (shape_maker.py:23).
"""
from __future__ import annotations

import json
from typing import Any, Dict

from .spec import (
    EnvSpec,
    LossSpec,
    PrimitiveSpec,
    RendererSpec,
    SceneSpec,
    ShapeSpec,
    SimulatorSpec,
)

__all__ = ["load_scene", "scene_from_dict"]


def _ev(v: Any) -> Any:
    """Evaluate arithmetic strings like '(0.5, 0.1)' or '0.2/2' or '127<<16'."""
    if isinstance(v, str):
        try:
            return eval(v, {"__builtins__": {}}, {})
        except Exception:
            return v
    if isinstance(v, list):
        return [_ev(x) for x in v]
    return v


def _fields(d: Dict[str, Any], names) -> Dict[str, Any]:
    """The listed keys of an evaluated dict, lists turned into tuples."""
    d = {k: _ev(v) for k, v in (d or {}).items()}
    return {k: tuple(d[k]) if isinstance(d[k], (list, tuple)) else d[k]
            for k in names if k in d}


def _prim_from_dict(d: Dict[str, Any]) -> PrimitiveSpec:
    kw = _fields(d, (
        "shape", "init_pos", "init_rot", "color", "lower_bound", "upper_bound",
        "friction", "radius", "h", "r", "size", "tx", "ty", "minimal_gap", "init_gap",
    ))
    action = _ev(d.get("action")) or {}
    if action:
        kw["action_dim"] = int(_ev(action.get("dim", 0)))
        scale = _ev(action.get("scale", ()))
        if isinstance(scale, (int, float)):
            scale = (scale,)
        kw["action_scale"] = tuple(scale)
    return PrimitiveSpec(**kw)


def scene_from_dict(cfg: Dict[str, Any]) -> SceneSpec:
    """Build a SceneSpec from a resolved (variant-applied) config dict."""
    sim_kw = _fields(cfg.get("SIMULATOR"), (
        "dim", "quality", "yield_stress", "dtype", "max_steps", "n_particles",
        "E", "nu", "ground_friction", "gravity",
    ))
    ren_kw = _fields(cfg.get("RENDERER"), (
        "spp", "max_ray_depth", "image_res", "voxel_res", "target_res", "dx",
        "sdf_threshold", "bake_size", "use_roulette", "light_direction",
        "camera_pos", "camera_rot", "use_directional_light", "max_num_particles",
    ))
    env_d = cfg.get("ENV") or {}
    loss_d = env_d.get("loss") or {}
    weight_d = loss_d.get("weight") or {}
    loss = LossSpec(
        soft_contact=bool(loss_d.get("soft_contact", False)),
        weight_sdf=float(weight_d.get("sdf", 10.0)),
        weight_density=float(weight_d.get("density", 10.0)),
        weight_contact=float(weight_d.get("contact", 1.0)),
        target_path=str(loss_d.get("target_path", "") or ""),
    )
    env = EnvSpec(loss=loss, n_observed_particles=int(env_d.get("n_observed_particles", 200)))
    shapes = []
    for s in cfg.get("SHAPES") or []:
        kw = _fields(s, ("init_pos", "width", "radius", "n_particles", "color", "init_rot"))
        shapes.append(ShapeSpec(shape=_ev(s["shape"]), **kw))
    return SceneSpec(
        simulator=SimulatorSpec(**sim_kw),
        primitives=tuple(_prim_from_dict(p) for p in (cfg.get("PRIMITIVES") or [])),
        shapes=tuple(shapes),
        renderer=RendererSpec(**ren_kw),
        env=env,
    )


def load_scene(path: str, version: int = 1) -> SceneSpec:
    """Load a resolved task spec (.json) -> SceneSpec. `version` selects a
    variant of a YAML config in the reference; a resolved spec has its
    variant applied, so it is ignored here as it is there for .json."""
    if not path.endswith(".json"):
        raise ValueError(f"only resolved .json task specs are supported: {path}")
    with open(path) as f:
        return scene_from_dict(json.load(f))
