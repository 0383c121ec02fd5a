"""PPO (clipped surrogate) in torch.

Counterpart of `plasticinelab_tpu/algorithms/ppo/ppo.py`; behavioral
reference plb/algorithms/ppo (the vendored ikostrikov baseline): a tanh MLP
actor-critic (64x64) with separate actor and critic towers and a
state-independent diagonal-Gaussian log-std, 10 epochs x 32 minibatches an
update, clip 0.2, value coefficient 0.5, entropy coefficient 0.01, the
gradient's global norm clipped at 0.5, Adam(3e-4, eps 1e-5) with the
learning rate set from outside (`set_lr`, the loop's linear decay).

The clip is written as optax's `clip_by_global_norm`, which leaves the
gradient alone below max_norm and scales it by max_norm / norm above it.
`torch.nn.utils.clip_grad_norm_` scales by max_norm / (norm + 1e-6), a
different function. Randomness goes through `normal(shape)`, a seam a caller
may replace, drawing from a torch.Generator on the device seeded `seed`.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..common import ConvEncoder, _dense, apply_grads
from ..sac.sac import samplers

_LOG_2PI = math.log(2 * math.pi)
_ENTROPY_CONST = 0.5 * math.log(2 * math.pi * math.e)


class ActorCritic(nn.Module):
    """Actor and critic towers of tanh layers, a mean head, a value head and
    a log-std parameter (zeros). flax names the layers in creation order,
    interleaved: `Dense_0` actor, `Dense_1` critic, `Dense_2` actor, ...,
    then the mean head and the value head."""

    def __init__(self, in_dim: int, action_dim: int, hidden: Sequence[int] = (64, 64), *,
                 generator=None):
        super().__init__()
        dims = (in_dim, *hidden)
        self.actor = nn.ModuleList()
        self.critic = nn.ModuleList()
        for a, b in zip(dims[:-1], dims[1:]):  # creation order: actor, critic
            self.actor.append(_dense(a, b, generator))
            self.critic.append(_dense(a, b, generator))
        self.mean = _dense(dims[-1], action_dim, generator)
        self.value = _dense(dims[-1], 1, generator)
        self.log_std = nn.Parameter(torch.zeros(action_dim))

    def forward(self, obs):
        ha = hc = obs
        for la, lc in zip(self.actor, self.critic):
            ha = torch.tanh(la(ha))
            hc = torch.tanh(lc(hc))
        return self.mean(ha), self.log_std, self.value(hc).squeeze(-1)

    def dense_layers(self):
        """(flax name, Linear) in flax's creation order."""
        out = []
        for la, lc in zip(self.actor, self.critic):
            out += [la, lc]
        out += [self.mean, self.value]
        return [(f"Dense_{i}", lin) for i, lin in enumerate(out)]

    def flax_children(self):
        return self.dense_layers() + [("log_std", self.log_std)]


class VisualActorCritic(nn.Module):
    """ConvEncoder torso + the state ActorCritic heads on (N, H, W, C)
    images in [0, 1]."""

    def __init__(self, obs_shape, action_dim: int, *, generator=None):
        super().__init__()
        self.encoder = ConvEncoder(tuple(obs_shape), generator=generator)
        self.head = ActorCritic(256, action_dim, generator=generator)

    def forward(self, img):
        return self.head(self.encoder(img))

    def flax_children(self):
        return [("ConvEncoder_0", self.encoder), ("ActorCritic_0", self.head)]


def gaussian_logp(mean, log_std, action):
    var = torch.exp(2 * log_std)
    return (-0.5 * ((action - mean) ** 2) / var - log_std - 0.5 * _LOG_2PI).sum(-1)


def gaussian_entropy(log_std):
    return (log_std + _ENTROPY_CONST).sum(-1)


def clip_by_global_norm_(grads, max_norm: float) -> None:
    """optax.clip_by_global_norm in place: g * max_norm / norm where the
    global norm is at least max_norm, else g unchanged (a select on the
    device, no sync)."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))


class ActorCriticAgent:
    """Acting with an `ActorCritic` (`self.net`) on `self.device`, the
    standard normal draws from `self.normal(shape)` (PPO, A2C, ACKTR)."""

    @property
    def dtype(self) -> torch.dtype:
        return next(self.net.parameters()).dtype

    def _obs(self, obs) -> torch.Tensor:
        return torch.as_tensor(obs, device=self.device).to(self.dtype)

    def _act(self, x):
        mean, log_std, value = self.net(x)
        action = mean + torch.exp(log_std) * self.normal(mean.shape).to(mean)
        return action, gaussian_logp(mean, log_std, action), value, mean

    def act(self, obs: np.ndarray, deterministic=False):
        """(action, logp, value) for one observation, as numpy and floats;
        deterministic: (mean, None, value). A normal is drawn either way,
        as the reference splits its key either way."""
        with torch.no_grad():
            a, logp, v, mean = self._act(self._obs(np.asarray(obs)[None]))
        if deterministic:
            return mean[0].cpu().numpy(), None, float(v[0])
        return a[0].cpu().numpy(), float(logp[0]), float(v[0])

    def get_value(self, obs: np.ndarray) -> float:
        with torch.no_grad():
            return float(self.net(self._obs(np.asarray(obs)[None]))[2][0])

    def act_batch(self, obs):
        """(actions, logp, values) for a (B, ...) observation stack, tensors
        on the device (the vec-env collection path)."""
        with torch.no_grad():
            return self._act(self._obs(obs))[:3]

    def get_value_batch(self, obs) -> torch.Tensor:
        with torch.no_grad():
            return self.net(self._obs(obs))[2]


class PPO(ActorCriticAgent):
    def __init__(self, state_dim, action_dim, clip_param=0.2, ppo_epoch=10, num_mini_batch=32,
                 value_loss_coef=0.5, entropy_coef=0.01, lr=3e-4, eps=1e-5, max_grad_norm=0.5,
                 seed=0, *, device="cuda"):
        """state_dim: an int, or an (H, W, C) image shape: the network then
        takes a ConvEncoder torso on frames in [0, 1]."""
        self.device = torch.device(device)
        self.clip_param = clip_param
        self.ppo_epoch = ppo_epoch
        self.num_mini_batch = num_mini_batch
        self.value_loss_coef = value_loss_coef
        self.entropy_coef = entropy_coef
        self.max_grad_norm = max_grad_norm
        self.visual = isinstance(state_dim, (tuple, list))
        gen = torch.Generator().manual_seed(seed)
        if self.visual:
            self.net = VisualActorCritic(tuple(state_dim), action_dim, generator=gen)
        else:
            self.net = ActorCritic(state_dim, action_dim, generator=gen)
        self.net.to(self.device)
        self.base_lr = lr
        self.opt = torch.optim.Adam(self.net.parameters(), lr=lr, eps=eps)
        self.normal, _ = samplers(self.device, seed)

    def set_lr(self, lr: float):
        for group in self.opt.param_groups:
            group["lr"] = lr

    # ------------------------------------------------------------------
    def _minibatch_update(self, obs, act, old_logp, returns, adv, old_value):
        """One clipped-surrogate step on a minibatch (`ppo.py:127-155`).
        Returns (loss, (action_loss, value_loss, entropy)), device
        scalars."""
        mean, log_std, value = self.net(obs)
        logp = gaussian_logp(mean, log_std, act)
        ratio = torch.exp(logp - old_logp)
        surr1 = ratio * adv
        surr2 = torch.clamp(ratio, 1 - self.clip_param, 1 + self.clip_param) * adv
        action_loss = -torch.minimum(surr1, surr2).mean()
        # clipped value loss (ikostrikov ppo.py use_clipped_value_loss)
        value_clipped = old_value + torch.clamp(value - old_value, -self.clip_param,
                                                self.clip_param)
        vloss = 0.5 * torch.maximum((value - returns) ** 2, (value_clipped - returns) ** 2).mean()
        ent = gaussian_entropy(log_std).mean()
        total = action_loss + self.value_loss_coef * vloss - self.entropy_coef * ent
        params = list(self.net.parameters())
        grads = torch.autograd.grad(total, params)
        clip_by_global_norm_(grads, self.max_grad_norm)
        apply_grads(self.opt, params, grads)
        return total.detach(), (action_loss.detach(), vloss.detach(), ent.detach())

    def update(self, rollouts: dict, rng: np.random.Generator):
        """rollouts: dict of stacked arrays or tensors obs, actions, logp,
        returns, values (advantages computed here). Each epoch's numpy
        permutation goes to the device once, and the losses are summed
        there: one sync for the update's mean loss."""
        data = {k: torch.as_tensor(rollouts[k], device=self.device)
                for k in ("obs", "actions", "logp", "returns", "values")}
        obs = data["obs"].to(self.dtype)
        n = obs.shape[0]
        adv = data["returns"] - data["values"]
        adv = (adv - adv.mean()) / (adv.std(unbiased=False) + 1e-5)
        total, count = 0.0, 0
        mb_size = max(n // self.num_mini_batch, 1)
        for _ in range(self.ppo_epoch):
            perm = torch.as_tensor(rng.permutation(n), device=self.device)
            for start in range(0, n - mb_size + 1, mb_size):
                ind = perm[start:start + mb_size]
                loss, _ = self._minibatch_update(
                    obs[ind], data["actions"][ind], data["logp"][ind], data["returns"][ind],
                    adv[ind], data["values"][ind])
                total = total + loss
                count += 1
        return float(total) / max(count, 1)
