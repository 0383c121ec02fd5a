"""GAIL discriminator in torch.

Counterpart of `plasticinelab_tpu/algorithms/ppo/gail.py`; behavioral
reference plb/algorithms/ppo/ppo/gail.py: a (state, action) discriminator
(tanh 100x100, logits) trained with the sigmoid cross-entropy of expert = 1
and agent = 0 plus a gradient penalty 10 mean((|grad D| - 1)^2) on
interpolates; the policy's reward is log D - log(1 - D). The interpolation
weights go through `uniform(shape)`, a seam a caller may replace, drawing
from a torch.Generator on the device seeded `seed`.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..common import _dense, apply_grads


class Discriminator(nn.Module):
    def __init__(self, in_dim: int, hidden: int = 100, *, generator=None):
        super().__init__()
        self.layers = nn.ModuleList([_dense(in_dim, hidden, generator),
                                     _dense(hidden, hidden, generator),
                                     _dense(hidden, 1, generator)])

    def forward(self, obs, act):
        x = torch.cat([obs, act], dim=-1)
        x = torch.tanh(self.layers[0](x))
        x = torch.tanh(self.layers[1](x))
        return self.layers[2](x).squeeze(-1)  # logits

    def flax_children(self):
        return [(f"Dense_{i}", lin) for i, lin in enumerate(self.layers)]


class GAIL:
    def __init__(self, obs_dim, act_dim, hidden=100, lr=3e-4, seed=0, *, device="cuda"):
        self.device = torch.device(device)
        gen = torch.Generator().manual_seed(seed)
        self.net = Discriminator(obs_dim + act_dim, hidden, generator=gen).to(self.device)
        self.opt = torch.optim.Adam(self.net.parameters(), lr=lr)
        ugen = torch.Generator(device=self.device)
        ugen.manual_seed(seed)
        self.uniform = lambda shape: torch.rand(shape, generator=ugen, device=self.device)

    def _tensors(self, *arrays):
        dtype = next(self.net.parameters()).dtype
        return [torch.as_tensor(a, device=self.device).to(dtype) for a in arrays]

    def update(self, expert_batch, agent_batch):
        """One Adam step on the discriminator loss (`gail.py:38-63`);
        returns it as a float."""
        eo, ea, po, pa = self._tensors(*expert_batch, *agent_batch)
        params = list(self.net.parameters())
        # sigmoid cross-entropy: -log s(x) on experts, -log s(-x) on agents
        expert_loss = -F.logsigmoid(self.net(eo, ea)).mean()
        agent_loss = -F.logsigmoid(-self.net(po, pa)).mean()
        # gradient penalty on interpolates (gail.py grad_pen)
        alpha = self.uniform((eo.shape[0], 1)).to(eo)
        mo = (alpha * eo + (1 - alpha) * po).requires_grad_(True)
        ma = (alpha * ea + (1 - alpha) * pa).requires_grad_(True)
        go, ga = torch.autograd.grad(self.net(mo, ma).sum(), (mo, ma), create_graph=True)
        g = torch.cat([go, ga], dim=-1)
        grad_pen = ((torch.linalg.vector_norm(g, dim=-1) - 1) ** 2).mean() * 10.0
        loss = expert_loss + agent_loss + grad_pen
        apply_grads(self.opt, params, torch.autograd.grad(loss, params))
        return float(loss.detach())

    def predict_reward(self, obs, act, gamma=0.99, masks=None):
        """log D - log(1 - D), D = sigmoid(logits) clipped to [1e-7, 1 - 1e-7]
        (reference gail.py predict_reward), as numpy."""
        with torch.no_grad():
            s = torch.clamp(torch.sigmoid(self.net(*self._tensors(obs, act))), 1e-7, 1 - 1e-7)
            return (torch.log(s) - torch.log(1 - s)).cpu().numpy()
