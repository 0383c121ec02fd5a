"""SAC with automatic entropy tuning, in torch.

Counterpart of `plasticinelab_tpu/algorithms/sac/sac.py`; behavioral
reference plb/algorithms/discor/algorithm/sac.py: twin soft-Q, a
tanh-Gaussian policy, target entropy -|A|, log-alpha optimised; the same
hyperparameters (gamma 0.99, learning rates 3e-4, tau 0.005, hidden
256x256). `torch.optim.Adam` stands in for optax's adam: the same update
(betas 0.9 / 0.999, eps 1e-8 added outside the square root of the
bias-corrected second moment).

Randomness goes through two samplers on the object, which a caller may
replace (as `Renderer.uniform`): `normal(shape)`, the policy's standard
normal draws, and `indices(size, batch)`, the device minibatch rows. Both
draw from one `torch.Generator` on the device seeded with `seed`.
"""
from __future__ import annotations

import copy
import os
from typing import Callable, Tuple

import numpy as np
import torch

from ..common import (GaussianPolicy, ReplayBuffer, TwinQ, VisualGaussianPolicy, VisualTwinQ,
                      apply_grads, device_batch, soft_update)


def samplers(device, seed: int) -> Tuple[Callable, Callable]:
    """(normal(shape) -> float32 standard normal draws, indices(size, batch)
    -> int64 rows in [0, size)) on `device`, from one generator seeded
    `seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def normal(shape):
        return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)

    def indices(size, batch):
        return torch.randint(0, size, (batch,), generator=gen, device=device)

    return normal, indices


class SAC:
    def __init__(self, state_dim, action_dim, gamma=0.99, policy_lr=3e-4, q_lr=3e-4,
                 entropy_lr=3e-4, target_update_coef=0.005, seed=0, alpha_cap=2.0, *,
                 device="cuda"):
        """state_dim: an int (state-vector observations) or an (H, W, C)
        image shape: the networks then take ConvEncoder torsos, and
        explore / exploit / the replay's frames are uint8 images scaled to
        [0, 1]. alpha_cap: the entropy temperature's upper bound (the
        reference's deviation 10 of its parity notes: log_alpha is clamped
        to [-9.2, log(alpha_cap)] after each step); None leaves it uncapped.
        Initial weights come from a torch.Generator seeded `seed`
        (`common.py`), not the reference's draws."""
        self.device = torch.device(device)
        self.gamma = gamma
        self.tau = target_update_coef
        self.target_entropy = -float(action_dim)
        self.log_alpha_max = (float(np.log(alpha_cap)) if alpha_cap is not None
                              else float("inf"))
        self.visual = isinstance(state_dim, (tuple, list))
        gen = torch.Generator().manual_seed(seed)
        if self.visual:
            self.policy = VisualGaussianPolicy(tuple(state_dim), action_dim, generator=gen)
            self.q = VisualTwinQ(tuple(state_dim), action_dim, generator=gen)
        else:
            self.policy = GaussianPolicy(state_dim, action_dim, generator=gen)
            self.q = TwinQ(state_dim + action_dim, generator=gen)
        self.policy.to(self.device)
        self.q.to(self.device)
        self.q_target = copy.deepcopy(self.q).requires_grad_(False)
        self.log_alpha = torch.zeros((), device=self.device, requires_grad=True)
        self.policy_opt = torch.optim.Adam(self.policy.parameters(), lr=policy_lr)
        self.q_opt = torch.optim.Adam(self.q.parameters(), lr=q_lr)
        self.alpha_opt = torch.optim.Adam([self.log_alpha], lr=entropy_lr)
        self.normal, self.indices = samplers(self.device, seed)

    # ---- acting ----
    def _prep(self, states) -> torch.Tensor:
        x = torch.as_tensor(states, device=self.device)
        if self.visual:
            return x.to(torch.float32) / 255.0
        return x.to(self.log_alpha.dtype)

    def _explore(self, obs):
        with torch.no_grad():
            mean, log_std = self.policy(obs)
            action, _ = GaussianPolicy.sample(mean, log_std, self.normal(mean.shape).to(mean))
        return action

    def explore(self, state: np.ndarray) -> np.ndarray:
        return self._explore(self._prep(np.asarray(state)[None]))[0].cpu().numpy()

    def exploit(self, state: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            mean, _ = self.policy(self._prep(np.asarray(state)[None]))
        return torch.tanh(mean)[0].cpu().numpy()

    def explore_batch(self, states) -> torch.Tensor:
        """Actions (B, action_dim) for a (B, ...) observation stack, a
        tensor on the device (vectorised collection, `run_sac.train_vec`):
        the observations and the actions stay on the card."""
        return self._explore(self._prep(states))

    # ---- learning ----
    def _update(self, batch) -> torch.Tensor:
        """One SAC step on a minibatch (`sac.py:117-175`), in this order:
        the target from the old target critic and exp(old log_alpha); the
        critic's Adam step; the policy loss against the updated critic,
        stepping only the policy; the alpha loss, linear in log_alpha, on
        the policy pass's log-probabilities; the clamp of log_alpha; the
        soft update of the target from the new critic. Returns the critic
        loss (a device scalar)."""
        dtype = self.log_alpha.dtype
        # the networks' inputs in their dtype; reward and not_done keep
        # theirs, and promote as in the reference
        state, action, next_state = (b.to(dtype) for b in batch[:3])
        reward, not_done = batch[3:]
        alpha = torch.exp(self.log_alpha.detach())
        eps1 = self.normal(action.shape).to(dtype)
        eps2 = self.normal(action.shape).to(dtype)
        with torch.no_grad():
            mean, log_std = self.policy(next_state)
            next_action, next_logp = GaussianPolicy.sample(mean, log_std, eps1)
            tq1, tq2 = self.q_target(next_state, next_action)
            target_q = reward + not_done * self.gamma * (torch.minimum(tq1, tq2)
                                                         - alpha * next_logp)

        q_params = list(self.q.parameters())
        q1, q2 = self.q(state, action)
        qloss = torch.mean((q1 - target_q) ** 2) + torch.mean((q2 - target_q) ** 2)
        apply_grads(self.q_opt, q_params, torch.autograd.grad(qloss, q_params))

        p_params = list(self.policy.parameters())
        m, ls = self.policy(state)
        a, logp = GaussianPolicy.sample(m, ls, eps2)
        q1, q2 = self.q(state, a)
        ploss = torch.mean(alpha * logp - torch.minimum(q1, q2))
        apply_grads(self.policy_opt, p_params, torch.autograd.grad(ploss, p_params))

        # linear in log_alpha (discor/algorithm/sac.py:134-136): the gradient
        # is bounded by |logp + target_entropy| whatever alpha is
        aloss = -torch.mean(self.log_alpha * (logp.detach() + self.target_entropy))
        apply_grads(self.alpha_opt, [self.log_alpha], torch.autograd.grad(aloss, [self.log_alpha]))
        with torch.no_grad():
            self.log_alpha.clamp_(-9.2, self.log_alpha_max)

        soft_update(self.q_target, self.q, self.tau)
        return qloss.detach()

    def _tensors(self, arrays):
        return tuple(torch.as_tensor(a, device=self.device) for a in arrays)

    def update(self, replay_buffer: ReplayBuffer, batch_size=256, rng=None):
        """One update on a minibatch of the host buffer drawn with numpy's
        `rng`. Returns the critic loss as a device scalar: fetch it where it
        is logged, not here."""
        rng = rng or np.random.default_rng(0)
        return self._update(self._tensors(replay_buffer.sample(batch_size, rng)))

    def update_many(self, replay_buffer, batch_size=256, rng=None, n=1):
        """n updates on n minibatches of the host buffer, all drawn first
        (as the reference draws them for its scanned dispatch)."""
        if n <= 1:
            return self.update(replay_buffer, batch_size, rng)
        rng = rng or np.random.default_rng(0)
        parts = [replay_buffer.sample(batch_size, rng) for _ in range(n)]
        for part in parts:
            loss = self._update(self._tensors(part))
        return loss

    def update_many_device(self, replay_buffer, batch_size=256, n=1, obs_stats=None):
        """n updates, one after another on the device, each on a minibatch
        drawn on the device from a DeviceReplayBuffer (`indices`), with no
        host round trip for the data. Image frames are scaled to [0, 1];
        with obs_stats (mean, inv_std) the buffer's raw state observations
        are normalised with the stats current at update time. The
        reference runs the n updates as one scanned dispatch; here each is
        its own launches, so the loop is bound by the host's launch rate."""
        for _ in range(n):
            loss = self._update(device_batch(self, replay_buffer, batch_size, obs_stats))
        return loss

    # ---- persistence ----
    def save_models(self, path):
        """`sac_state.pt` in `path`: the networks, the target critic,
        log_alpha and the optimizer states, through torch.save. The TPU
        package's `sac_state.pkl` pickles its own device arrays and can be
        read only where that package's array library is installed."""
        os.makedirs(path, exist_ok=True)
        torch.save({"policy": self.policy.state_dict(), "q": self.q.state_dict(),
                    "q_target": self.q_target.state_dict(),
                    "log_alpha": self.log_alpha.detach(),
                    "policy_opt": self.policy_opt.state_dict(),
                    "q_opt": self.q_opt.state_dict(),
                    "alpha_opt": self.alpha_opt.state_dict()},
                   os.path.join(path, "sac_state.pt"))

    def load_models(self, path):
        st = torch.load(os.path.join(path, "sac_state.pt"), map_location=self.device)
        self.policy.load_state_dict(st["policy"])
        self.q.load_state_dict(st["q"])
        self.q_target.load_state_dict(st["q_target"])
        with torch.no_grad():
            self.log_alpha.copy_(st["log_alpha"])
        for name in ("policy_opt", "q_opt", "alpha_opt"):
            getattr(self, name).load_state_dict(st[name])
