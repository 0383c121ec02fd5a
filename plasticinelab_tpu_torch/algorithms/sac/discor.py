"""DisCor-weighted SAC in torch.

Counterpart of `plasticinelab_tpu/algorithms/sac/discor.py`; behavioral
reference plb/algorithms/discor/algorithm/discor.py: an auxiliary twin
error network estimates how Bellman errors accumulate; the critic's squared
errors are weighted by softmax(-gamma * err(s', a') * not_done / tau) over
the batch (times the batch size), and tau tracks the error net's mean
prediction. Same interface as `SAC`, whose `update` and
`update_many_device` run this class's `_update`.
"""
from __future__ import annotations

import copy
import os

import torch

from ..common import GaussianPolicy, TwinQ, VisualTwinQ, apply_grads, soft_update
from .sac import SAC


class DisCor(SAC):
    def __init__(self, state_dim, action_dim, error_lr=3e-4, tau_init=10.0, **kwargs):
        """The error net is TwinQ (256, 256, 256) (the reference's
        error_hidden_units, run_discor.py), or a VisualTwinQ on images, with
        weights from a generator seeded `seed` + 123; tau1 and tau2 start at
        `tau_init` and live on the device."""
        super().__init__(state_dim, action_dim, **kwargs)
        gen = torch.Generator().manual_seed(kwargs.get("seed", 0) + 123)
        if self.visual:
            self.err = VisualTwinQ(tuple(state_dim), action_dim, generator=gen)
        else:
            self.err = TwinQ(state_dim + action_dim, hidden=(256, 256, 256), generator=gen)
        self.err.to(self.device)
        self.err_target = copy.deepcopy(self.err).requires_grad_(False)
        self.err_opt = torch.optim.Adam(self.err.parameters(), lr=error_lr)
        self.tau1 = torch.full((), tau_init, device=self.device)
        self.tau2 = torch.full((), tau_init, device=self.device)

    def _update(self, batch) -> torch.Tensor:
        """One DisCor step (`discor.py:57-138`), in the reference's order:
        the target and the importance weights from the target error net;
        the critic's weighted step; the error net's regression on
        |q - target| + not_done gamma err'(s', a'), with q from the critic
        before its step; the policy's step against the new critic; alpha and
        its clamp; the soft updates of both targets; the tau EMA of the
        online error net's mean on (s, a). Returns the critic loss."""
        dtype = self.log_alpha.dtype
        state, action, next_state = (b.to(dtype) for b in batch[:3])
        reward, not_done = batch[3:]
        alpha = torch.exp(self.log_alpha.detach())
        eps1 = self.normal(action.shape).to(dtype)
        eps2 = self.normal(action.shape).to(dtype)
        n = action.shape[0]
        with torch.no_grad():
            mean, log_std = self.policy(next_state)
            next_action, next_logp = GaussianPolicy.sample(mean, log_std, eps1)
            e1, e2 = self.err_target(next_state, next_action)
            w1 = torch.softmax(-self.gamma * e1 * not_done / self.tau1, dim=-1) * n
            w2 = torch.softmax(-self.gamma * e2 * not_done / self.tau2, dim=-1) * n
            tq1, tq2 = self.q_target(next_state, next_action)
            target_q = reward + not_done * self.gamma * (torch.minimum(tq1, tq2)
                                                         - alpha * next_logp)

        q_params = list(self.q.parameters())
        q1, q2 = self.q(state, action)
        qloss = torch.mean(w1 * (q1 - target_q) ** 2) + torch.mean(w2 * (q2 - target_q) ** 2)
        apply_grads(self.q_opt, q_params, torch.autograd.grad(qloss, q_params))

        with torch.no_grad():
            tgt_e1 = torch.abs(q1 - target_q) + not_done * self.gamma * e1
            tgt_e2 = torch.abs(q2 - target_q) + not_done * self.gamma * e2
        e_params = list(self.err.parameters())
        c1, c2 = self.err(state, action)
        eloss = torch.mean((c1 - tgt_e1) ** 2) + torch.mean((c2 - tgt_e2) ** 2)
        apply_grads(self.err_opt, e_params, torch.autograd.grad(eloss, e_params))

        p_params = list(self.policy.parameters())
        m, ls = self.policy(state)
        a, logp = GaussianPolicy.sample(m, ls, eps2)
        pq1, pq2 = self.q(state, a)
        ploss = torch.mean(alpha * logp - torch.minimum(pq1, pq2))
        apply_grads(self.policy_opt, p_params, torch.autograd.grad(ploss, p_params))

        aloss = -torch.mean(self.log_alpha * (logp.detach() + self.target_entropy))
        apply_grads(self.alpha_opt, [self.log_alpha], torch.autograd.grad(aloss, [self.log_alpha]))
        with torch.no_grad():
            self.log_alpha.clamp_(-9.2, self.log_alpha_max)

        soft_update(self.q_target, self.q, self.tau)
        soft_update(self.err_target, self.err, self.tau)
        # tau tracks the online error net's mean prediction on (s, a)
        # (reference discor.py curr_errs.detach().mean())
        self.tau1 = self.tau1 * (1 - self.tau) + self.tau * torch.mean(c1.detach())
        self.tau2 = self.tau2 * (1 - self.tau) + self.tau * torch.mean(c2.detach())
        return qloss.detach()

    # ---- persistence ----
    def save_models(self, path):
        """`sac_state.pt` and `discor_state.pt`: the error net, its target,
        its optimizer state, tau1 and tau2."""
        super().save_models(path)
        torch.save({"err": self.err.state_dict(), "err_target": self.err_target.state_dict(),
                    "err_opt": self.err_opt.state_dict(), "tau1": self.tau1,
                    "tau2": self.tau2}, os.path.join(path, "discor_state.pt"))

    def load_models(self, path):
        super().load_models(path)
        dpath = os.path.join(path, "discor_state.pt")
        if not os.path.exists(dpath):
            # a checkpoint written by plain SAC: its weights loaded; keep the
            # freshly initialised error model
            print(f"[discor] no discor_state.pt under {path}; keeping fresh error model")
            return
        st = torch.load(dpath, map_location=self.device)
        self.err.load_state_dict(st["err"])
        self.err_target.load_state_dict(st["err_target"])
        self.err_opt.load_state_dict(st["err_opt"])
        self.tau1, self.tau2 = st["tau1"], st["tau2"]
