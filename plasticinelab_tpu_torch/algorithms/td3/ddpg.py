"""DDPG in torch.

Counterpart of `plasticinelab_tpu/algorithms/td3/ddpg.py`; behavioral
reference plb/algorithms/TD3/OurDDPG.py (the cleaned-up DDPG the TD3 package
ships beside TD3: one critic, no target policy smoothing, no delayed
updates; tau 0.005, discount 0.99, learning rates 3e-4) and DDPG.py
(`OriginalDDPG`). Like the reference, neither has a batched
`select_action_batch` or a `train_many_device`, and neither takes image
observations.
"""
from __future__ import annotations

import copy
import os
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from ..common import MLP, Actor, ReplayBuffer, apply_grads, soft_update


class Critic(nn.Module):
    """Q(s, a): an MLP (400, 300) -> 1 on concat(obs, act) (reference
    OurDDPG.py:31-37; flax `MLP_0`)."""

    def __init__(self, in_dim: int, hidden=(400, 300), *, generator=None):
        super().__init__()
        self.mlp = MLP(in_dim, hidden, 1, generator=generator)

    def forward(self, obs, act):
        return self.mlp(torch.cat([obs, act], dim=-1)).squeeze(-1)

    def flax_children(self):
        return [("MLP_0", self.mlp)]


Factory = Callable[[list], torch.optim.Optimizer]


class DDPG:
    def __init__(self, state_dim, action_dim, max_action=1.0, discount=0.99, tau=0.005,
                 lr=3e-4, seed=0, actor_tx: Optional[Factory] = None,
                 critic_tx: Optional[Factory] = None, *, device="cuda"):
        """actor_tx / critic_tx: optimizer factories (parameters ->
        torch.optim.Optimizer), Adam(lr) by default."""
        self.device = torch.device(device)
        self.max_action = max_action
        self.discount = discount
        self.tau = tau
        gen = torch.Generator().manual_seed(seed)
        self.actor = Actor(state_dim, action_dim, max_action, hidden=(400, 300),
                           generator=gen).to(self.device)  # OurDDPG.py:14-28
        self.critic = Critic(state_dim + action_dim, generator=gen).to(self.device)
        self.actor_target = copy.deepcopy(self.actor).requires_grad_(False)
        self.critic_target = copy.deepcopy(self.critic).requires_grad_(False)
        adam = lambda params: torch.optim.Adam(params, lr=lr)  # noqa: E731
        self.actor_opt = (actor_tx or adam)(list(self.actor.parameters()))
        self.critic_opt = (critic_tx or adam)(list(self.critic.parameters()))

    @property
    def dtype(self) -> torch.dtype:
        return next(self.actor.parameters()).dtype

    def select_action(self, state: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            x = torch.as_tensor(np.asarray(state)[None], device=self.device).to(self.dtype)
            return self.actor(x)[0].cpu().numpy()

    def _update(self, batch) -> torch.Tensor:
        """One DDPG step (`ddpg.py:67-100`): the critic's step on the target
        from both targets, the actor's step against the new critic, then the
        soft updates of both targets. Returns the critic loss."""
        dtype = self.dtype
        state, action, next_state = (b.to(dtype) for b in batch[:3])
        reward, not_done = batch[3:]
        with torch.no_grad():
            target_q = reward + not_done * self.discount * self.critic_target(
                next_state, self.actor_target(next_state))

        c_params = list(self.critic.parameters())
        closs = torch.mean((self.critic(state, action) - target_q) ** 2)
        apply_grads(self.critic_opt, c_params, torch.autograd.grad(closs, c_params))

        a_params = list(self.actor.parameters())
        aloss = -torch.mean(self.critic(state, self.actor(state)))
        apply_grads(self.actor_opt, a_params, torch.autograd.grad(aloss, a_params))
        soft_update(self.actor_target, self.actor, self.tau)
        soft_update(self.critic_target, self.critic, self.tau)
        return closs.detach()

    def train(self, replay_buffer: ReplayBuffer, batch_size=256, rng=None):
        """One update on a minibatch of the host buffer drawn with numpy's
        `rng`; returns the critic loss as a device scalar."""
        rng = rng or np.random.default_rng(0)
        batch = replay_buffer.sample(batch_size, rng)
        return self._update(tuple(torch.as_tensor(a, device=self.device) for a in batch))

    # ---- persistence (reference DDPG.py save / load) ----
    def _modules(self):
        return {"actor": self.actor, "actor_target": self.actor_target,
                "critic": self.critic, "critic_target": self.critic_target,
                "actor_opt": self.actor_opt, "critic_opt": self.critic_opt}

    def save(self, filename):
        """`filename`_ddpg.pt through torch.save."""
        d = os.path.dirname(filename)
        if d:
            os.makedirs(d, exist_ok=True)
        torch.save({k: m.state_dict() for k, m in self._modules().items()},
                   filename + "_ddpg.pt")

    def load(self, filename):
        st = torch.load(filename + "_ddpg.pt", map_location=self.device)
        for k, m in self._modules().items():
            m.load_state_dict(st[k])


class OriginalDDPG(DDPG):
    """The TD3 package's vanilla-DDPG baseline (reference
    plb/algorithms/TD3/DDPG.py:48-58): tau 0.001, actor Adam 1e-4, critic
    Adam 1e-3 with an L2 penalty of 1e-2 added to the gradient before Adam
    (torch's coupled `weight_decay`, the reference's add_decayed_weights in
    front of adam; not the decoupled AdamW)."""

    def __init__(self, state_dim, action_dim, max_action=1.0, discount=0.99, tau=0.001,
                 seed=0, *, device="cuda"):
        super().__init__(
            state_dim, action_dim, max_action=max_action, discount=discount, tau=tau,
            seed=seed, device=device,
            actor_tx=lambda params: torch.optim.Adam(params, lr=1e-4),
            critic_tx=lambda params: torch.optim.Adam(params, lr=1e-3, weight_decay=1e-2))
