"""A2C in torch.

Counterpart of `plasticinelab_tpu/algorithms/ppo/a2c.py`; behavioral
reference plb/algorithms/ppo/ppo/algo/a2c_acktr.py: one advantage
actor-critic step over the whole rollout, value coefficient 0.5, entropy
coefficient 0.01, the gradient's global norm clipped at 0.5, then RMSprop
(lr 7e-4, decay 0.99, eps 1e-5). ACKTR swaps the optimizer for K-FAC
(`kfac.A2C_ACKTR`).

The RMSprop step is written by hand as optax's `rmsprop`: the accumulator
starts at 0 and eps sits inside the square root, g / sqrt(nu + eps).
`torch.optim.RMSprop` adds eps outside it, g / (sqrt(nu) + eps).
"""
from __future__ import annotations

import torch

from ..sac.sac import samplers
from .ppo import (ActorCritic, ActorCriticAgent, clip_by_global_norm_, gaussian_entropy,
                  gaussian_logp)


def a2c_loss(net, obs, act, returns, value_loss_coef, entropy_coef):
    """The A2C loss (`a2c.py:53-63`): the policy gradient on the detached
    advantage, value_loss_coef x the squared advantage, minus entropy."""
    mean, log_std, value = net(obs)
    adv = returns - value
    logp = gaussian_logp(mean, log_std, act)
    action_loss = -(adv.detach() * logp).mean()
    value_loss = (adv ** 2).mean()
    ent = gaussian_entropy(log_std).mean()
    return action_loss + value_loss_coef * value_loss - entropy_coef * ent


class A2C(ActorCriticAgent):
    def __init__(self, state_dim, action_dim, value_loss_coef=0.5, entropy_coef=0.01, lr=7e-4,
                 eps=1e-5, alpha=0.99, max_grad_norm=0.5, seed=0, *, device="cuda"):
        self.device = torch.device(device)
        self.value_loss_coef = value_loss_coef
        self.entropy_coef = entropy_coef
        self.lr, self.eps, self.alpha = lr, eps, alpha
        self.max_grad_norm = max_grad_norm
        gen = torch.Generator().manual_seed(seed)
        self.net = ActorCritic(state_dim, action_dim, generator=gen).to(self.device)
        self.nu = None  # RMSprop's accumulators, made at the first update
        self.normal, _ = samplers(self.device, seed)

    def _rmsprop_(self, params, grads) -> None:
        """optax.rmsprop(lr, decay=alpha, eps=eps): nu <- (1 - alpha) g^2 +
        alpha nu, then p <- p - lr g / sqrt(nu + eps)."""
        if self.nu is None:
            self.nu = [torch.zeros_like(p) for p in params]
        with torch.no_grad():
            for p, g, nu in zip(params, grads, self.nu):
                nu.copy_((1 - self.alpha) * g ** 2 + self.alpha * nu)
                p.add_(-self.lr * (torch.rsqrt(nu + self.eps) * g))

    def update(self, rollouts: dict):
        obs, act, returns = (torch.as_tensor(rollouts[k], device=self.device)
                             for k in ("obs", "actions", "returns"))
        loss = a2c_loss(self.net, obs.to(self.dtype), act, returns, self.value_loss_coef,
                        self.entropy_coef)
        params = list(self.net.parameters())
        grads = torch.autograd.grad(loss, params)
        clip_by_global_norm_(grads, self.max_grad_norm)
        self._rmsprop_(params, grads)
        return float(loss.detach())
