"""K-FAC natural-gradient optimizer and the ACKTR learner, in torch.

Counterpart of `plasticinelab_tpu/algorithms/ppo/kfac.py`; behavioral
reference plb/algorithms/ppo/ppo/algo/kfac.py:1-242 (per-layer Kronecker
factors, eigendecomposed every Tf steps, a KL-clipped step applied with SGD
momentum at lr * (1 - momentum)) and a2c_acktr.py:54-68 (the Fisher pass:
the actor's mean log-probability of sampled actions plus the sampled
value-function Fisher loss).

The Fisher pass takes each dense layer's input and the cotangent of its
pre-activation: forward hooks record the input and add a zero tensor to the
output, and torch.autograd.grad with respect to those zeros gives the
cotangents (the reference's backward hooks). Biases are factors of their
own whose input factor is the scalar 1 (the reference's SplitBias). The
eigendecomposition runs on a host-side step counter (`steps`), so choosing
it costs no sync. Weight factors are kept in torch's (out, in) layout.
"""
from __future__ import annotations

import torch

from ..sac.sac import samplers
from .a2c import a2c_loss
from .ppo import ActorCritic, ActorCriticAgent, gaussian_logp


class KFACOptimizer:
    """The reference's vendored hyperparameters (kfac.py:88-98). `init(net)`
    makes the state for an `ActorCritic`: per dense layer `name` and its
    bias `name/bias` the running factors m_aa, m_gg, their eigenvectors
    q_a, q_g and thresholded eigenvalues d_a, d_g, and the momentum buffers
    `mom` (one per parameter, `log_std` too)."""

    def __init__(self, lr=0.25, momentum=0.9, stat_decay=0.99, kl_clip=0.001, damping=1e-2,
                 weight_decay=0.0, Ts=1, Tf=10):
        self.lr = lr
        self.momentum = momentum
        self.stat_decay = stat_decay
        self.kl_clip = kl_clip
        self.damping = damping
        self.weight_decay = weight_decay
        self.Ts = Ts
        self.Tf = Tf

    def init(self, net: ActorCritic) -> None:
        self.layers = net.dense_layers()
        self.m_aa, self.m_gg, self.q_a, self.q_g, self.d_a, self.d_g, self.mom = (
            {}, {}, {}, {}, {}, {}, {})
        for name, lin in self.layers:
            dout, din = lin.weight.shape
            kw = dict(dtype=lin.weight.dtype, device=lin.weight.device)
            for key, n_in in ((name, din), (name + "/bias", 1)):
                self.m_aa[key] = torch.zeros((n_in, n_in), **kw)
                self.m_gg[key] = torch.zeros((dout, dout), **kw)
                self.q_a[key] = torch.eye(n_in, **kw)
                self.q_g[key] = torch.eye(dout, **kw)
                self.d_a[key] = torch.zeros((n_in,), **kw)
                self.d_g[key] = torch.zeros((dout,), **kw)
            self.mom[name] = torch.zeros_like(lin.weight)
            self.mom[name + "/bias"] = torch.zeros_like(lin.bias)
        self.mom["log_std"] = torch.zeros_like(net.log_std)
        self.steps = 0

    # -- statistics ---------------------------------------------------------

    def _fisher_pass(self, net, obs, normal):
        """Each dense layer's input and its pre-activation cotangent under
        the Fisher loss (`kfac.py:105-124`). Draws: the action noise, then
        the value noise."""
        inputs, zeros = {}, {}

        def hook(name):
            def record(module, args, out):
                inputs[name] = args[0].detach()
                zeros[name] = torch.zeros_like(out, requires_grad=True)
                return out + zeros[name]
            return record

        handles = [lin.register_forward_hook(hook(name)) for name, lin in self.layers]
        try:
            mean, log_std, value = net(obs)
        finally:
            for h in handles:
                h.remove()
        action = (mean + torch.exp(log_std) * normal(mean.shape).to(mean)).detach()
        pg = -gaussian_logp(mean, log_std, action).mean()
        sample_v = (value + normal(value.shape).to(value)).detach()
        vf = -((value - sample_v) ** 2).mean()
        names = [name for name, _ in self.layers]
        cts = torch.autograd.grad(pg + vf, [zeros[n] for n in names])
        return inputs, dict(zip(names, cts))

    def accumulate_stats(self, net, obs, normal) -> None:
        """The running-average update of every factor (`kfac.py:126-145`);
        the first call sets them."""
        inputs, cts = self._fisher_pass(net, obs, normal)
        B = obs.shape[0]
        decay = self.stat_decay
        first = self.steps == 0

        def mix(store, key, new):
            store[key] = new if first else decay * store[key] + (1 - decay) * new

        for name, _ in self.layers:
            a = inputs[name]
            g_ = cts[name] * B
            gg = g_.T @ (g_ / B)
            ones = torch.ones((B, 1), dtype=a.dtype, device=a.device)
            mix(self.m_aa, name, a.T @ (a / B))
            mix(self.m_aa, name + "/bias", ones.T @ (ones / B))
            mix(self.m_gg, name, gg)
            mix(self.m_gg, name + "/bias", gg)

    # -- the step -----------------------------------------------------------

    def _precondition(self, key, grad):
        """The factored inverse Fisher applied to an (out, in) gradient in
        the factors' eigenbases."""
        v1 = self.q_g[key].T @ grad @ self.q_a[key]
        v2 = v1 / (self.d_g[key][:, None] * self.d_a[key][None, :]
                   + (self.damping + self.weight_decay))
        return self.q_g[key] @ v2 @ self.q_a[key].T

    def step(self, net, grads) -> None:
        """The natural-gradient step on `net`'s parameters, in place; grads
        are in the order of `net.parameters()` (`kfac.py:149-211`)."""
        grad = dict(zip(net.parameters(), grads))
        if self.steps % self.Tf == 0:
            for key in self.m_aa:
                for m, q, d in ((self.m_aa, self.q_a, self.d_a), (self.m_gg, self.q_g, self.d_g)):
                    evals, evecs = torch.linalg.eigh(m[key])
                    q[key] = evecs
                    d[key] = evals * (evals > 1e-6)
        lr = self.lr
        updates, vg_sum = {}, 0.0
        for name, lin in self.layers:
            gw, gb = grad[lin.weight], grad[lin.bias]
            updates[name] = vw = self._precondition(name, gw)
            vg_sum = vg_sum + torch.sum(vw * gw * lr * lr)
            updates[name + "/bias"] = vb = self._precondition(name + "/bias", gb[:, None])[:, 0]
            vg_sum = vg_sum + torch.sum(vb * gb * lr * lr)
        nu = torch.clamp(torch.sqrt(self.kl_clip / (vg_sum + 1e-30)), max=1.0)

        eff_lr = lr * (1 - self.momentum)
        with torch.no_grad():
            for name, lin in self.layers:
                for key, p in ((name, lin.weight), (name + "/bias", lin.bias)):
                    self.mom[key] = self.momentum * self.mom[key] + updates[key] * nu
                    p.sub_(eff_lr * self.mom[key])
            # log_std follows plain SGD momentum on its raw gradient
            self.mom["log_std"] = self.momentum * self.mom["log_std"] + grad[net.log_std]
            net.log_std.sub_(eff_lr * self.mom["log_std"])
        self.steps += 1


class A2C_ACKTR(ActorCriticAgent):
    """A2C with the K-FAC optimizer (reference a2c_acktr.py with
    acktr=True; value coefficient 0.5, entropy coefficient 0.01). Draws go
    through `normal(shape)`: per update the Fisher pass's action noise,
    then its value noise."""

    def __init__(self, state_dim, action_dim, value_loss_coef=0.5, entropy_coef=0.01, seed=0,
                 *, device="cuda", **kfac_kwargs):
        self.device = torch.device(device)
        self.value_loss_coef = value_loss_coef
        self.entropy_coef = entropy_coef
        gen = torch.Generator().manual_seed(seed)
        self.net = ActorCritic(state_dim, action_dim, generator=gen).to(self.device)
        self.kfac = KFACOptimizer(**kfac_kwargs)
        self.kfac.init(self.net)
        self.normal, _ = samplers(self.device, seed)

    def update(self, rollouts: dict):
        obs, act, returns = (torch.as_tensor(rollouts[k], device=self.device)
                             for k in ("obs", "actions", "returns"))
        obs = obs.to(self.dtype)
        self.kfac.accumulate_stats(self.net, obs, self.normal)
        loss = a2c_loss(self.net, obs, act, returns, self.value_loss_coef, self.entropy_coef)
        params = list(self.net.parameters())
        self.kfac.step(self.net, torch.autograd.grad(loss, params))
        return float(loss.detach())
