"""Gym-style environment over PhysicsEnv.

Counterpart of `plasticinelab_tpu/envs/env.py`: state observations (the
reference layout) or, with `obs_mode="rgb"`, rendered
`image_obs_res`^2 uint8 frames (the visual-RL mode; no reference
counterpart). Behavioral reference: plb/envs/env.py (obs layout :33-41, reward :43-57 via
loss deltas, NaN crash-dump guard :50-56). It keeps the gymnasium surface
(`reset`, `step` -> (obs, reward, terminated, truncated, info),
`action_space.shape`, `observation_space.shape`, `unwrapped`) without
depending on gymnasium, which the GPU machines do not carry; the episode
limit of gymnasium's TimeLimit wrapper is kept here as `truncated`.
"""
from __future__ import annotations

import datetime
import os
import pickle
from typing import Optional, Tuple

import numpy as np

from ..config.loader import load_scene
from ..config.spec import SceneSpec
from ..engine.sim import PhysicsEnv

# resolved task specs are read from the TPU package's directory, by path
SPEC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                        "plasticinelab_tpu", "envs", "specs")


class Box:
    """A box-shaped space: `shape`, `low`, `high`, `dtype`, `sample()`."""

    def __init__(self, low: float, high: float, shape: Tuple[int, ...],
                 dtype=np.float32, seed: Optional[int] = None):
        self.low = np.full(shape, low, dtype=dtype)
        self.high = np.full(shape, high, dtype=dtype)
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self._rng = np.random.default_rng(seed)

    def sample(self) -> np.ndarray:
        return self._rng.uniform(self.low, self.high).astype(self.dtype)

    def seed(self, seed: Optional[int] = None) -> None:
        self._rng = np.random.default_rng(seed)


class PlasticineEnv:
    def __init__(self, cfg_path: str, version: int = 1, nn: bool = False,
                 scene: Optional[SceneSpec] = None, obs_mode: str = "state",
                 image_obs_res: int = 64, image_obs_spp: int = 2, *, device="cuda",
                 max_episode_steps: int = 50):
        """The reference's parameters in its order. With `scene` None the
        task is read from the resolved spec `<base>-v<version>.json` of
        `cfg_path`'s base name. device and max_episode_steps (the episode
        limit) are keyword only."""
        if obs_mode not in ("state", "rgb"):
            raise ValueError(f"obs_mode must be 'state' or 'rgb', got {obs_mode!r}")
        self.cfg_path = cfg_path
        self.obs_mode = obs_mode
        self._image_obs_res = image_obs_res
        self._image_obs_spp = image_obs_spp
        if scene is None:
            scene = self._load_scene(cfg_path, version)
        self.taichi_env = PhysicsEnv(scene, nn=nn, device=device)
        self.taichi_env.initialize()
        self.taichi_env.set_copy(True)
        self._init_state = self.taichi_env.get_state()
        self._max_episode_steps = max_episode_steps
        self._elapsed_steps = 0

        obs, _ = self.reset()
        if obs_mode == "rgb":
            self.observation_space = Box(0, 255, obs.shape, dtype=np.uint8)
        else:
            self.observation_space = Box(-np.inf, np.inf, obs.shape)
        self.action_space = Box(-1.0, 1.0, (self.taichi_env.scene.action_dim,))

    @staticmethod
    def load_scene(name: str, version: int) -> SceneSpec:
        """Resolved task spec `<name>-v<version>.json`."""
        return load_scene(os.path.join(SPEC_DIR, f"{name}-v{version}.json"))

    @staticmethod
    def _load_scene(cfg_path: str, version: int) -> SceneSpec:
        """The resolved spec of `cfg_path`'s task and `version`
        (`plasticinelab_tpu/envs/env.py:60-68`). A reference-schema YAML
        with no resolved spec is refused: reading it needs PyYAML."""
        base = os.path.splitext(os.path.basename(cfg_path))[0]
        cand = os.path.join(SPEC_DIR, f"{base}-v{version}.json")
        if os.path.exists(cand):
            return load_scene(cand)
        if cfg_path.endswith(".json"):
            return load_scene(cfg_path, version)
        raise FileNotFoundError(
            f"no resolved spec {cand} for {cfg_path!r}; the port reads resolved .json specs "
            "only (a YAML task config needs PyYAML)")

    @property
    def unwrapped(self) -> "PlasticineEnv":
        return self

    # ------------------------------------------------------------------
    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self.action_space.seed(seed)
        self.taichi_env.set_state(**self._init_state)
        self._recorded_actions = []
        self._elapsed_steps = 0
        return self._get_obs(), {}

    def _get_obs(self):
        if self.obs_mode == "rgb":
            return self.taichi_env.render_obs(res=self._image_obs_res, spp=self._image_obs_spp)
        return self.taichi_env.get_obs()

    def step(self, action):
        self.taichi_env.step(action)
        loss_info = self.taichi_env.compute_loss()
        self._recorded_actions.append(action)
        self._elapsed_steps += 1
        obs = self._get_obs()
        r = loss_info["reward"]
        obs_nan = obs.dtype != np.uint8 and np.isnan(obs).any()
        if obs_nan or np.isnan(r):
            if np.isnan(r):
                print("nan in r")
            with open(f"{self.cfg_path}_nan_action_{datetime.datetime.now()}", "wb") as f:
                pickle.dump(self._recorded_actions, f)
            raise FloatingPointError("NaN in the observation or the reward")
        truncated = self._elapsed_steps >= self._max_episode_steps
        return obs, r, False, truncated, loss_info

    def render(self, mode="rgb_array"):
        return self.taichi_env.render(mode)

    def seed(self, seed=None):
        """Seeds numpy's global generator, from which `Solver.init_actions`
        draws (legacy gym; `plasticinelab_tpu/envs/env.py:104-105`)."""
        np.random.seed(seed)
