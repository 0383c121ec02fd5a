"""Batched RL rollouts: B envs of one task stepping in lockstep on one card.

Counterpart of `plasticinelab_tpu/parallel/rollout.py:VecPlasticineEnv`
(:49-256), with state or rgb observations. Each step is one
`mpm.env_step_batched` of all B envs, whose kernels (K1 on the B n
particles; K3, K8 forward and K5 over B envs; K7 forward for the loss)
launch once per substep for the whole batch, so the host's launch cost is
paid once per batch, not once per env. Observations, rewards and losses are
computed on the device for the whole batch and stay there: the caller's
fetch is the step's one host sync.

rgb observations render all B envs' frames in one pass of the observation
renderer (`Renderer.build_obs_fn` on x (B, n, 3)): one launch of the
voxelizer K9 for the batch and one march over the B envs' rays, where the
TPU package vmaps its single-env render over the envs (:133-157).

Reward semantics are the RL ("is_copy") mode of `PhysicsEnv.compute_loss`
(reference envs/env.py:43-57): r_t = start_loss - loss_t, start_loss fixed
at reset per env; episodes are fixed-horizon and `done` is t >= horizon for
every env; `incremental_iou` is the IoU gain over the reset state's,
normalised by the goal's IoU with itself (reference loss.py:293-294).

Not here, unlike the TPU package: a device mesh (one card; ROADMAP A15).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..config.loader import load_scene
from ..config.spec import SceneSpec
from ..engine import cuda_transfer, mpm
from ..engine import losses as losses_mod
from ..engine.shapes import build_particles
from ..engine.renderer import Renderer
from ..engine.renderer.renderer import obs_scene, torch_sampler
from ..engine.sim import load_target_density, observation
from ..engine.state import SimState, default_materials, initial_states, scene_dtype
from ..envs.env import SPEC_DIR
from ..utils.profiling import span

__all__ = ["VecPlasticineEnv"]

SOFTNESS = 666.0


class VecPlasticineEnv:
    """B independent copies of one task, stepped together.

    API (batch-first, device-resident):
      reset() -> obs
      step(actions (B, action_dim)) -> (obs, reward (B,), done (B,),
                                        info {loss, iou, incremental_iou})
    obs is (B, obs_dim) float for obs_mode "state", (B, res, res, 3) uint8
    frames (`obs_shape`) for "rgb": the envs' `image_obs_res`^2 renders with
    `image_obs_spp` samples, from a sampler on the device seeded `seed` + 1
    (the renderer's `uniform`, which a caller may replace).

    The envs start from the task's initial cloud, each moved by
    uniform(-jitter, jitter) noise from a generator seeded with `seed`
    (`state.initial_states`). The step runs under no_grad; the gradient of
    a batched rollout is `parallel.mesh.build_batched_rollout_grad`. `mesh`
    takes only None: one card (ROADMAP A15)."""

    def __init__(self, env_name: Optional[str], batch: int, seed: int = 0,
                 jitter: float = 1e-3, mesh=None, horizon: int = 50,
                 scene: Optional[SceneSpec] = None,
                 target_density: Optional[np.ndarray] = None,
                 particles: Optional[np.ndarray] = None, obs_mode: str = "state",
                 image_obs_res: int = 64, image_obs_spp: int = 2, *, device="cuda"):
        if obs_mode not in ("state", "rgb"):
            raise ValueError(f"obs_mode must be 'state' or 'rgb', got {obs_mode!r}")
        if mesh is not None:
            raise NotImplementedError(
                "VecPlasticineEnv(mesh=...): the port runs on one card; a device mesh is "
                "ROADMAP item A15")
        self.obs_mode = obs_mode
        if scene is None:
            scene = load_scene(os.path.join(SPEC_DIR, f"{env_name.lower()}.json"))
        colors = None
        if particles is None:
            particles, colors = build_particles(scene.shapes)
        elif obs_mode == "rgb":
            colors = np.full((len(particles),), 0x999999, np.int32)
        scene = scene.with_n_particles(len(particles))
        self.scene = scene
        self.batch = batch
        self.horizon = horizon
        self.device = torch.device(device)
        self.dtype = scene_dtype(scene)
        self.mats = default_materials(scene)
        self._softness = torch.full((batch,), SOFTNESS, dtype=self.dtype, device=self.device)

        if target_density is None:
            target_density = load_target_density(scene)
        self.loss_state = losses_mod.make_loss_state(scene, target_density, self.device,
                                                     self.dtype)
        # incremental-IoU normalizer: IoU of the goal with itself
        td = self.loss_state.target_density
        self._target_iou = float(losses_mod.iou(td, td))

        gen = torch.Generator().manual_seed(seed)
        self._init_states = initial_states(scene, particles, batch, self.device, self.dtype,
                                           jitter, gen)
        self.states = self._init_states
        self._start_loss = self._init_iou = None
        self._t = 0

        self.action_dim = scene.action_dim
        self.obs_dim = (scene.env.n_observed_particles * 6
                        + sum(7 + (p.shape == "Chopsticks") for p in scene.primitives))

        if obs_mode == "rgb":
            self._renderer = Renderer(obs_scene(scene, image_obs_res, image_obs_spp),
                                      self.device)
            self._renderer.set_target_density(
                np.asarray(target_density, np.float32) / scene.simulator.p_mass)
            self._renderer.uniform = torch_sampler(self.device, seed + 1)
            self._obs_fn = self._renderer.build_obs_fn()
            self._colors = torch.as_tensor(colors, dtype=torch.int32, device=self.device)
            self.obs_shape = (image_obs_res, image_obs_res, 3)

    def _loss(self, states: SimState, grid_m):
        with span("plb.loss"):
            return losses_mod.loss_and_components(self.scene, self.loss_state, states, grid_m)

    def _observe(self, states: SimState) -> torch.Tensor:
        with span("plb.observe"):
            if self.obs_mode == "state":
                return observation(self.scene, states)
            img = self._obs_fn(states.x.to(torch.float32), self._colors, states.prim_pos,
                               states.prim_rot, states.prim_gap)
            return (torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8)

    def reset(self) -> torch.Tensor:
        self.states = self._init_states
        with torch.no_grad():
            grid_m = cuda_transfer.grid_mass_batched(self.scene, self.states.x)
            info = self._loss(self.states, grid_m)
            obs = self._observe(self.states)
        self._start_loss, self._init_iou = info["loss"], info["iou"]
        self._t = 0
        return obs

    def step(self, actions):
        """actions (B, action_dim): a tensor or an array."""
        with span("plb.env.step"):
            with torch.no_grad():
                self.states, grid_m = mpm.env_step_batched(
                    self.scene, self.mats, self.states, actions, self._softness,
                    want_grid_m=True)
                info = self._loss(self.states, grid_m)
                obs = self._observe(self.states)
                loss, iou = info["loss"], info["iou"]
                reward = self._start_loss - loss
                inc = torch.clamp((iou - self._init_iou) / (self._target_iou - self._init_iou),
                                  0.0, 1.0)
            self._t += 1
            done = torch.full((self.batch,), self._t >= self.horizon, device=self.device)
            return obs, reward, done, {"loss": loss, "iou": iou, "incremental_iou": inc}
