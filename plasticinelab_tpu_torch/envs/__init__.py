"""Task registry: 10 tasks x 5 variants (reference plb/envs/__init__.py).

Counterpart of `plasticinelab_tpu/envs/__init__.py`. make() returns a
PlasticineEnv on an explicit device, with the loss weights applied to the
scene at build time (the reference mutates Taichi fields instead,
envs/__init__.py:16-20).
"""
from __future__ import annotations

import dataclasses
import re

from .env import PlasticineEnv

ENV_NAMES = [
    "Move", "Torus", "Rope", "Writer", "Pinch", "Rollingpin", "Chopsticks",
    "Table", "TripleMove", "Assembly",
]

ENVS = [f"{name}-v{v}" for name in ENV_NAMES for v in range(1, 6)]


def _parse(env_name: str):
    m = re.fullmatch(r"([A-Za-z]+)-v(\d+)", env_name)
    if not m or m.group(1) not in ENV_NAMES:
        raise ValueError(f"unknown env {env_name!r}; registered: {ENVS}")
    return m.group(1).lower(), int(m.group(2))


def make(env_name: str, nn: bool = False, sdf_loss: float = 10,
         density_loss: float = 10, contact_loss: float = 1,
         soft_contact_loss: bool = False, max_episode_steps: int = 50,
         obs_mode: str = "state", image_obs_res: int = 64,
         image_obs_spp: int = 2, *, device="cuda") -> PlasticineEnv:
    """The reference's parameters in its order; `nn` is passed down to
    PhysicsEnv as there and changes nothing. device: keyword only."""
    task, version = _parse(env_name)
    scene = PlasticineEnv.load_scene(task, version)
    loss = dataclasses.replace(
        scene.env.loss,
        weight_sdf=sdf_loss, weight_density=density_loss,
        weight_contact=contact_loss, soft_contact=soft_contact_loss,
    )
    scene = scene.replace(env=dataclasses.replace(scene.env, loss=loss))
    return PlasticineEnv(f"{task}.yml", version, nn, scene=scene, obs_mode=obs_mode,
                         image_obs_res=image_obs_res, image_obs_spp=image_obs_spp,
                         device=device, max_episode_steps=max_episode_steps)
