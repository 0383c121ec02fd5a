"""Scene facade: particles, physics, loss and observation of one env.

Counterpart of `plasticinelab_tpu/engine/sim.py:PhysicsEnv`, forward only:
`initialize`, the fused `step` (env step + loss + observation),
`compute_loss` (reward, incremental IoU), `get_obs`, `get_state` /
`set_state` and `retarget`. The API follows the reference composition root
plb/engine/taichi_env.py. The trajectory gradient and rendering are not
ported yet.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List

import numpy as np
import torch

from ..config.spec import SceneSpec
from . import cuda_transfer, mpm
from . import losses as losses_mod
from .shapes import build_particles
from .state import (
    SimState,
    default_materials,
    flat_primitive_states,
    initial_state,
    scene_dtype,
    state_from_numpy,
    state_to_numpy,
)

# goal grids are read from the TPU package's asset directory, by path
ASSET_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                          "plasticinelab_tpu", "envs", "assets")

_LOSS_KEYS = ("loss", "contact_loss", "density_loss", "sdf_loss", "iou")


class PhysicsEnv:
    """Owns one scene's state and physics on one device. Replaces the
    reference TaichiEnv."""

    def __init__(self, scene: SceneSpec, device="cuda"):
        self.init_particles, _ = build_particles(scene.shapes)
        scene = scene.with_n_particles(len(self.init_particles))
        self.scene = scene
        self.device = torch.device(device)
        self.dtype = scene_dtype(scene)
        self.n_particles = scene.simulator.n_particles
        self.mats = default_materials(scene)
        self.softness = 666.0
        self._is_copy = True
        self.state: SimState = initial_state(scene, self.init_particles, self.device, self.dtype)
        # the last fused step's obs and loss scalars stay on the device
        # (_pending) until compute_loss or get_obs fetches both in one
        # device-to-host copy (_obs_host, _loss_host); set by retarget
        self._load_target()

    # ------------------------------------------------------------------
    # construction helpers
    # ------------------------------------------------------------------
    def _load_target(self):
        path = self.scene.env.loss.target_path
        if not path:
            grids = np.zeros((self.scene.simulator.n_grid,) * 3)
        else:
            cand = [path, os.path.join(ASSET_ROOT, os.path.basename(path))]
            found = [c for c in cand if os.path.exists(c)]
            if not found:
                raise FileNotFoundError(f"goal grid not found: {path}")
            grids = np.load(found[0])
        self.retarget(grids)

    def retarget(self, target_density: np.ndarray):
        """Swap the goal grid and reset the loss bookkeeping."""
        self.target_density = np.asarray(target_density, dtype=np.float64)
        self.loss_state = losses_mod.make_loss_state(
            self.scene, self.target_density, self.device, self.dtype)
        # IoU of the goal with itself — normalizer for incremental_iou
        # (reference loss.py:46-57)
        td = self.loss_state.target_density
        self._target_iou = float(losses_mod.iou(td, td))
        self._reset_loss_tracker()

    def _loss_tensor(self, state: SimState, grid_m) -> torch.Tensor:
        info = losses_mod.loss_and_components(self.scene, self.loss_state, state, grid_m)
        return torch.stack([info[k] for k in _LOSS_KEYS])

    def _obs(self, state: SimState) -> torch.Tensor:
        """Observation (reference envs/env.py:33-41 layout)."""
        step = self.n_particles // self.scene.env.n_observed_particles
        xv = torch.cat([state.x[::step], state.v[::step]], dim=-1).reshape(-1)
        return torch.cat([xv, flat_primitive_states(self.scene, state).reshape(-1)])

    # ------------------------------------------------------------------
    # reference TaichiEnv API
    # ------------------------------------------------------------------
    def set_copy(self, is_copy: bool):
        self._is_copy = is_copy

    def initialize(self):
        self.state = initial_state(self.scene, self.init_particles, self.device, self.dtype)
        self._reset_loss_tracker()

    def step(self, action=None):
        """One env step. The loss and the observation of the new state are
        computed on the device in the same call and fetched by the next
        compute_loss / get_obs."""
        if action is not None:
            action = np.asarray(action, dtype=np.float64)
        self.state, grid_m = mpm.env_step_with_grid_m(
            self.scene, self.mats, self.state, action, self.softness)
        self._pending = torch.cat([self._obs(self.state),
                                   self._loss_tensor(self.state, grid_m)])
        self._obs_host = self._loss_host = None

    def _fetch(self):
        if self._pending is None:
            return
        flat = self._pending.cpu().numpy()
        self._pending = None
        n = len(_LOSS_KEYS)
        self._obs_host = flat[:-n]
        self._loss_host = dict(zip(_LOSS_KEYS, map(float, flat[-n:])))

    # ---- loss bookkeeping (reference loss.py:281-302 semantics) ----
    def _reset_loss_tracker(self):
        info = self._current_loss()
        self._start_loss = info["loss"]
        self._init_iou = info["iou"]
        self._last_loss = 0.0
        self._pending = self._obs_host = self._loss_host = None

    def _current_loss(self) -> Dict[str, float]:
        grid_m = cuda_transfer.grid_mass(self.scene, self.state.x)
        return dict(zip(_LOSS_KEYS, self._loss_tensor(self.state, grid_m).tolist()))

    def compute_loss(self) -> Dict[str, float]:
        self._fetch()
        info, self._loss_host = self._loss_host, None
        if info is None:
            info = self._current_loss()
        if self._is_copy:
            # RL mode: per-step loss, reward relative to the start
            r = self._start_loss - info["loss"]
            cur_step_loss = info["loss"]
            self._last_loss = 0.0
        else:
            r = self._start_loss - (info["loss"] - self._last_loss)
            cur_step_loss = info["loss"] - self._last_loss
            self._last_loss = info["loss"]
        denom = self._target_iou - self._init_iou
        info["reward"] = r
        info["incremental_iou"] = max(min((info["iou"] - self._init_iou) / denom, 1), 0)
        info["target_iou"] = self._target_iou
        info["loss"] = cur_step_loss
        return info

    def get_obs(self) -> np.ndarray:
        self._fetch()
        if self._obs_host is not None:
            return self._obs_host
        return self._obs(self.state).cpu().numpy()

    def get_state(self) -> Dict[str, Any]:
        state_list: List[np.ndarray] = state_to_numpy(self.scene, self.state)
        return {"state": state_list, "softness": self.softness, "is_copy": self._is_copy}

    def set_state(self, state, softness, is_copy):
        self.state = state_from_numpy(self.scene, state, self.device, self.dtype)
        self.softness = softness
        self._is_copy = is_copy
        self._reset_loss_tracker()

