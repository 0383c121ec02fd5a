"""Scene facade: particles, physics, loss and observation of one env.

Counterpart of `plasticinelab_tpu/engine/sim.py:PhysicsEnv`: `initialize`,
the fused `step` (env step + loss + observation), `compute_loss` (reward,
incremental IoU), `get_obs`, `get_state` / `set_state`, `retarget`, the
trajectory gradient `rollout_value_and_grad` (:271-309), and rendering:
`render` (:314-340) and the visual observation `render_obs` (:342-381),
through `renderer.Renderer`. The API follows the reference composition root
plb/engine/taichi_env.py. `rollout_losses_batched` is the rollout of B envs
stepped together that `parallel.mesh.build_batched_rollout_grad`
differentiates (`plasticinelab_tpu/parallel/mesh.py:104-127`).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..config.spec import SceneSpec
from . import cuda_transfer, mpm
from . import losses as losses_mod
from .renderer import Renderer
from .renderer.renderer import obs_scene
from .shapes import build_particles
from .state import (
    SimState,
    default_materials,
    flat_primitive_states,
    initial_state,
    scene_dtype,
    state_fields as _fields,
    state_from_numpy,
    state_to_numpy,
)

# goal grids are read from the TPU package's asset directory, by path
ASSET_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                          "plasticinelab_tpu", "envs", "assets")

_LOSS_KEYS = ("loss", "contact_loss", "density_loss", "sdf_loss", "iou")


def rollout_losses(scene, mats, loss_state, state0: SimState, actions: torch.Tensor,
                   softness: float, remat: str = "none", ops: mpm.Ops = mpm.KERNEL_OPS):
    """Roll `state0` through the (horizon, action_dim) `actions` -> (per-step
    rows (loss, sdf_loss, density_loss, contact_loss, iou) (horizon, 5), the
    IoU without gradient; final state), differentiable in the actions
    (`plasticinelab_tpu/engine/sim.py:284-301`). Each step's loss is the
    full-grid loss of the state after it, from `env_step_with_grid_m`'s grid
    mass. remat "env_step" recomputes each env step in the backward
    (torch.utils.checkpoint) instead of keeping its substeps; "none" keeps
    everything (`mpm.resolve_remat`)."""
    def step(*args):
        state, action = SimState(*args[:7]), args[7]
        st, gm = mpm.env_step_with_grid_m(scene, mats, state, action, softness, ops)
        info = losses_mod.loss_and_components(scene, loss_state, st, gm)
        comps = torch.stack([info["loss"], info["sdf_loss"], info["density_loss"],
                             info["contact_loss"], info["iou"].detach()])
        return (*_fields(st), comps)

    return _scan(step, state0, actions, remat)


def _scan(step, state0: SimState, actions, remat: str):
    """state, row = step(*fields(state), action) over the leading axis of
    `actions` -> (stacked rows, final state); under remat "env_step" each
    step is a torch.utils.checkpoint, recomputed in the backward."""
    if remat not in ("none", "env_step"):
        raise ValueError(f"remat must be 'none' or 'env_step', got {remat!r}")
    state, rows = state0, []
    for action in actions:
        if remat == "env_step":
            out = checkpoint(step, *_fields(state), action, use_reentrant=False)
        else:
            out = step(*_fields(state), action)
        state = SimState(*out[:7])
        rows.append(out[7])
    return torch.stack(rows), state


def rollout_losses_batched(scene, mats, loss_state, states0: SimState, actions: torch.Tensor,
                           softness, remat: str = "none",
                           ops: mpm.Ops = mpm.KERNEL_OPS_BATCHED):
    """Roll B envs together, `states0` with a leading B, through `actions`
    (B, horizon, action_dim) -> (each step's loss of each env (horizon, B),
    final states), differentiable in the actions
    (`plasticinelab_tpu/parallel/mesh.py:104-127` on the full grid). Every
    step is one `mpm.env_step_batched` of all envs and the full-grid loss of
    each env from its grid mass (B, G^3). softness: a number or (B,). remat
    as in `rollout_losses`: under "env_step" one batched env step's substeps
    live at a time, and the recomputed forward scatters with atomics again,
    so its grids differ from the first pass's in the last bits."""
    def step(*args):
        states, acts = SimState(*args[:7]), args[7]
        st, gm = mpm.env_step_batched(scene, mats, states, acts, softness, want_grid_m=True,
                                      ops=ops)
        return (*_fields(st), losses_mod.loss_and_components(scene, loss_state, st, gm)["loss"])

    return _scan(step, states0, actions.transpose(0, 1), remat)


def observation(scene: SceneSpec, state: SimState) -> torch.Tensor:
    """State observation (reference envs/env.py:33-41 layout): strided
    particle x|v, then the flat primitive states; (B, obs_dim) for states
    with a leading B."""
    step = scene.simulator.n_particles // scene.env.n_observed_particles
    xv = torch.cat([state.x[..., ::step, :], state.v[..., ::step, :]], dim=-1).flatten(-2)
    return torch.cat([xv, flat_primitive_states(scene, state)], dim=-1)


def load_target_density(scene: SceneSpec) -> np.ndarray:
    """The scene's goal grid (G, G, G) from its `target_path`, looked up as
    given and then in the TPU package's asset directory; zeros where the
    scene names none."""
    path = scene.env.loss.target_path
    if not path:
        return np.zeros((scene.simulator.n_grid,) * 3)
    cand = [path, os.path.join(ASSET_ROOT, os.path.basename(path))]
    found = [c for c in cand if os.path.exists(c)]
    if not found:
        raise FileNotFoundError(f"goal grid not found: {path}")
    return np.load(found[0])


class PhysicsEnv:
    """Owns one scene's state and physics on one device. Replaces the
    reference TaichiEnv."""

    def __init__(self, scene: SceneSpec, nn: bool = False, loss: bool = True, *,
                 device="cuda"):
        """nn: accepted as the reference accepts it, and changes nothing: a
        caller that needs a policy attaches it to `self.nn` later. loss=False
        skips the goal and the loss state (no `compute_loss`, no reward)."""
        self.init_particles, self.particle_colors = build_particles(scene.shapes)
        scene = scene.with_n_particles(len(self.init_particles))
        self.scene = scene
        self.device = torch.device(device)
        self.dtype = scene_dtype(scene)
        self.n_particles = scene.simulator.n_particles
        self.mats = default_materials(scene)
        self.softness = 666.0
        self._is_copy = True
        self.state: SimState = initial_state(scene, self.init_particles, self.device, self.dtype)
        self.nn = None
        self._renderer = None
        # the observation renderer and its render function, cached per (res, spp)
        self._obs_renderer = self._obs_renderer_key = self._visual_obs_fn = None
        # the last fused step's obs and loss scalars stay on the device
        # (_pending) until compute_loss or get_obs fetches both in one
        # device-to-host copy (_obs_host, _loss_host)
        self._pending = self._obs_host = self._loss_host = None
        self.loss_state = None
        self._loss_enabled = loss
        if loss:
            self._load_target()

    # ------------------------------------------------------------------
    # construction helpers
    # ------------------------------------------------------------------
    def _load_target(self):
        self.retarget(load_target_density(self.scene))

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
        self._obs_host = self._loss_host = None
        if not self._loss_enabled:
            self.state = mpm.env_step(self.scene, self.mats, self.state, action, self.softness)
            self._pending = None
            return
        self.state, grid_m = mpm.env_step_with_grid_m(
            self.scene, self.mats, self.state, action, self.softness)
        self._pending = torch.cat([observation(self.scene, self.state),
                                   self._loss_tensor(self.state, grid_m)])

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
        self._pending = self._obs_host = self._loss_host = None
        if not self._loss_enabled:
            return
        info = self._current_loss()
        self._start_loss = info["loss"]
        self._init_iou = info["iou"]
        self._last_loss = 0.0

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
        return observation(self.scene, self.state).cpu().numpy()

    def get_state(self) -> Dict[str, Any]:
        state_list: List[np.ndarray] = state_to_numpy(self.scene, self.state)
        return {"state": state_list, "softness": self.softness, "is_copy": self._is_copy}

    def set_state(self, state, softness, is_copy):
        self.state = state_from_numpy(self.scene, state, self.device, self.dtype)
        self.softness = softness
        self._is_copy = is_copy
        self._reset_loss_tracker()


    # ------------------------------------------------------------------
    # the differentiable rollout (reference solver.py:31-44 under ti.Tape)
    # ------------------------------------------------------------------
    def rollout_value_and_grad(self, state: SimState, actions, softness: float):
        """Loss summed over a whole action trajectory and its gradient with
        respect to the (horizon, action_dim) actions -> (loss 0-d tensor,
        grad (horizon, action_dim) tensor, final state), all detached. The
        backward runs the kernels' backward kernels on CUDA; its remat
        policy comes from `mpm.resolve_remat` and is kept in `last_remat`."""
        actions = torch.as_tensor(actions, dtype=self.dtype, device=self.device)
        actions = actions.detach().clone().requires_grad_(True)
        # the particle state is differentiated too, and its gradient dropped,
        # so that the first substep runs the same backward as every other (as
        # in the reference's scan): one launch of each substep backward
        # kernel per substep
        particles = [t.detach().requires_grad_(True) for t in (state.x, state.v, state.C, state.F)]
        state = dataclasses.replace(state, **dict(zip("xvCF", particles)))
        self.last_remat = mpm.resolve_remat(self.scene, actions.shape[0], self.device)
        with torch.enable_grad():
            comps, final = rollout_losses(self.scene, self.mats, self.loss_state, state,
                                          actions, softness, self.last_remat)
            loss = comps[:, 0].sum()
            grad = torch.autograd.grad(loss, [actions, *particles])[0]
        return loss.detach(), grad, SimState(*(t.detach() for t in _fields(final)))

    # ------------------------------------------------------------------
    # rendering
    # ------------------------------------------------------------------
    def _state_args(self):
        s = self.state
        return s.x, self.particle_colors, s.prim_pos, s.prim_rot, s.prim_gap

    def _new_renderer(self, scene: SceneSpec) -> Renderer:
        r = Renderer(scene, self.device)
        r.set_target_density(self.target_density / self.scene.simulator.p_mass)
        return r

    def render(self, mode="rgb_array", **kwargs):
        """One frame at the scene's RendererSpec -> (H, W, 3) uint8. Modes
        "human" (cv2 window) and "plt" (matplotlib) also show it
        (reference taichi_env.py:68-70)."""
        if not self._is_copy:
            raise RuntimeError("The environment must be in the copy mode for render ...")
        if self._renderer is None:
            self._renderer = self._new_renderer(self.scene)
        img = self._renderer.render_frame(*self._state_args(), **kwargs)
        img = np.uint8(np.clip(img, 0, 1) * 255)
        if mode == "human":
            import cv2

            cv2.imshow("x", img[..., ::-1])
            cv2.waitKey(1)
        elif mode == "plt":
            import matplotlib.pyplot as plt

            plt.imshow(img)
            plt.show()
        return img

    def render_obs(self, res: int = 64, spp: int = 2, **kwargs) -> np.ndarray:
        """Low-resolution observation render for visual RL -> (res, res, 3)
        uint8: the same tracer on `obs_scene`'s half-resolution voxel grid,
        all spp samples in one pass. Its renderer is its own, cached per
        (res, spp), and leaves the state observation alone."""
        if self._obs_renderer is None or self._obs_renderer_key != (res, spp):
            self._obs_renderer = self._new_renderer(obs_scene(self.scene, res, spp))
            self._obs_renderer_key = (res, spp)
            self._visual_obs_fn = self._obs_renderer.build_obs_fn()
        if kwargs:
            # non-default flags (e.g. the goal ghost): the frame path
            img = self._obs_renderer.render_frame(*self._state_args(), **kwargs)
        else:
            img = self._visual_obs_fn(*self._state_args()).cpu().numpy()
        return np.uint8(np.clip(img, 0, 1) * 255)


# Alias for users porting from the reference
TaichiEnv = PhysicsEnv
