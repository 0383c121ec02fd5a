"""TD3 in torch.

Counterpart of `plasticinelab_tpu/algorithms/td3/td3.py`; behavioral
reference plb/algorithms/TD3/TD3.py: twin critics, delayed policy updates,
target policy smoothing, and its defaults (discount 0.99, tau 0.005,
policy_noise 0.2, noise_clip 0.5, policy_freq 2, learning rates 3e-4).

The delayed actor step counts updates on the host (`total_it`), so choosing
it costs no sync. The target critic moves only on actor steps, as in the
reference. Randomness goes through the seams of `sac.samplers`, which a
caller may replace: `normal(shape)`, the target-policy noise and the
exploration noise of `train_td3_vec`, and `indices(size, batch)`, the device
minibatch rows.
"""
from __future__ import annotations

import copy
import os

import numpy as np
import torch

from ..common import (Actor, ReplayBuffer, TwinQ, VisualActor, VisualTwinQ, apply_grads,
                      device_batch, soft_update)
from ..sac.sac import samplers


class TD3:
    def __init__(self, state_dim, action_dim, max_action=1.0, discount=0.99, tau=0.005,
                 policy_noise=0.2, noise_clip=0.5, policy_freq=2, lr=3e-4, seed=0, *,
                 device="cuda"):
        """state_dim: an int, or an (H, W, C) image shape: the networks then
        take ConvEncoder torsos and observations are uint8 frames scaled to
        [0, 1]. Initial weights come from a torch.Generator seeded `seed`."""
        self.device = torch.device(device)
        self.max_action = max_action
        self.discount = discount
        self.tau = tau
        self.policy_noise = policy_noise
        self.noise_clip = noise_clip
        self.policy_freq = policy_freq
        self.visual = isinstance(state_dim, (tuple, list))
        gen = torch.Generator().manual_seed(seed)
        if self.visual:
            self.actor = VisualActor(tuple(state_dim), action_dim, max_action, generator=gen)
            self.critic = VisualTwinQ(tuple(state_dim), action_dim, generator=gen)
        else:
            self.actor = Actor(state_dim, action_dim, max_action, generator=gen)
            self.critic = TwinQ(state_dim + action_dim, generator=gen)
        self.actor.to(self.device)
        self.critic.to(self.device)
        self.actor_target = copy.deepcopy(self.actor).requires_grad_(False)
        self.critic_target = copy.deepcopy(self.critic).requires_grad_(False)
        self.actor_opt = torch.optim.Adam(self.actor.parameters(), lr=lr)
        self.critic_opt = torch.optim.Adam(self.critic.parameters(), lr=lr)
        self.total_it = 0
        self.normal, self.indices = samplers(self.device, seed)

    @property
    def dtype(self) -> torch.dtype:
        return next(self.actor.parameters()).dtype

    def _prep(self, states) -> torch.Tensor:
        x = torch.as_tensor(states, device=self.device)
        if self.visual:
            return x.to(torch.float32) / 255.0
        return x.to(self.dtype)

    def select_action(self, state: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            return self.actor(self._prep(np.asarray(state)[None]))[0].cpu().numpy()

    def select_action_batch(self, states) -> torch.Tensor:
        """Actions (B, action_dim) for a (B, ...) observation stack, a tensor
        on the device (vectorised collection, `run_td3.train_td3_vec`)."""
        with torch.no_grad():
            return self.actor(self._prep(states))

    # ------------------------------------------------------------------
    def _update(self, batch) -> torch.Tensor:
        """One TD3 step (`td3.py:88-138`): the smoothed target from the
        target actor and critic; the critic's Adam step; then, on every
        policy_freq-th update, the actor's step against the new critic and
        the soft updates of both targets. Returns the critic loss (a device
        scalar)."""
        dtype = self.dtype
        state, action, next_state = (b.to(dtype) for b in batch[:3])
        reward, not_done = batch[3:]
        with torch.no_grad():
            noise = torch.clamp(self.normal(action.shape).to(dtype) * self.policy_noise,
                                -self.noise_clip, self.noise_clip)
            next_action = torch.clamp(self.actor_target(next_state) + noise,
                                      -self.max_action, self.max_action)
            tq1, tq2 = self.critic_target(next_state, next_action)
            target_q = reward + not_done * self.discount * torch.minimum(tq1, tq2)

        c_params = list(self.critic.parameters())
        q1, q2 = self.critic(state, action)
        closs = torch.mean((q1 - target_q) ** 2) + torch.mean((q2 - target_q) ** 2)
        apply_grads(self.critic_opt, c_params, torch.autograd.grad(closs, c_params))

        self.total_it += 1
        if self.total_it % self.policy_freq == 0:
            a_params = list(self.actor.parameters())
            q1, _ = self.critic(state, self.actor(state))
            aloss = -torch.mean(q1)
            apply_grads(self.actor_opt, a_params, torch.autograd.grad(aloss, a_params))
            soft_update(self.actor_target, self.actor, self.tau)
            soft_update(self.critic_target, self.critic, self.tau)
        return closs.detach()

    def _tensors(self, arrays):
        return tuple(torch.as_tensor(a, device=self.device) for a in arrays)

    def train(self, replay_buffer: ReplayBuffer, batch_size: int = 256, rng=None):
        """One update on a minibatch of the host buffer drawn with numpy's
        `rng`; returns the critic loss as a device scalar."""
        rng = rng or np.random.default_rng(0)
        return self._update(self._tensors(replay_buffer.sample(batch_size, rng)))

    def train_many(self, replay_buffer, batch_size=256, rng=None, n=1):
        """n updates on n minibatches of the host buffer, all drawn first."""
        if n <= 1:
            return self.train(replay_buffer, batch_size, rng)
        rng = rng or np.random.default_rng(0)
        parts = [replay_buffer.sample(batch_size, rng) for _ in range(n)]
        for part in parts:
            loss = self._update(self._tensors(part))
        return loss

    def train_many_device(self, replay_buffer, batch_size=256, n=1, obs_stats=None):
        """n updates, each on a minibatch drawn on the device from a
        Device(Image)ReplayBuffer (`indices`), as `SAC.update_many_device`;
        obs_stats: (mean, inv_std) normalising the raw stored observations."""
        for _ in range(n):
            loss = self._update(device_batch(self, replay_buffer, batch_size, obs_stats))
        return loss

    # ---- persistence (reference TD3.py:152-159) ----
    def _modules(self):
        return {"actor": self.actor, "actor_target": self.actor_target,
                "critic": self.critic, "critic_target": self.critic_target,
                "actor_opt": self.actor_opt, "critic_opt": self.critic_opt}

    def save(self, filename):
        """`filename`.pt: the networks, their targets, the optimizer states
        and the update count, through torch.save."""
        d = os.path.dirname(filename)
        if d:
            os.makedirs(d, exist_ok=True)
        st = {k: m.state_dict() for k, m in self._modules().items()}
        torch.save(dict(st, total_it=self.total_it), filename + ".pt")

    def load(self, filename):
        st = torch.load(filename + ".pt", map_location=self.device)
        for k, m in self._modules().items():
            m.load_state_dict(st[k])
        self.total_it = st["total_it"]
