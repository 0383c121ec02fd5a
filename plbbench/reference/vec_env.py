"""The plain reference put in the program's place, with the program's
`VecPlasticineEnv` interface: the control run of the comparison, computed
in a lower precision than the configuration states."""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import mpm


class Fields(NamedTuple):
    """A state under the program's field names."""
    x: torch.Tensor
    v: torch.Tensor
    C: torch.Tensor
    F: torch.Tensor
    prim_pos: torch.Tensor
    prim_rot: torch.Tensor
    prim_gap: torch.Tensor


class Uniform:
    """The renderer's sampler seam: `uniform(shape)` draws."""

    def __init__(self, device, seed):
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.device = device
        self.uniform = lambda shape: torch.rand(shape, generator=self.gen, device=self.device)


class RefVecEnv:
    """B envs stepped by `compare.Reference` `ref`, in its dtype."""

    def __init__(self, ref, batch: int, horizon: int, obs_mode: str, seed: int):
        self.ref, self.batch, self.horizon, self.obs_mode = ref, batch, horizon, obs_mode
        self._renderer = Uniform(ref.device, seed + 1)
        self._t = 0
        self.reset()

    @property
    def states(self):
        return Fields(*self._st)

    def _obs(self, st):
        if self.obs_mode == "state":
            return mpm.state_obs(self.ref.sc, st)
        return self.ref.render.frames(st, self._renderer.uniform)

    def reset(self):
        self._st = self.ref.on_device(self.ref.start_state())
        self._t = 0
        return self._obs(self._st)

    def step(self, actions):
        self._st, loss, reward, iou, inc = self.ref.step(self._st, actions)
        self._t += 1
        done = torch.full((self.batch,), self._t >= self.horizon, device=self.ref.device)
        return self._obs(self._st), reward, done, {"loss": loss, "iou": iou,
                                                   "incremental_iou": inc}
