"""Shared RL building blocks: torch networks, replay buffers, observation
normalisation.

Counterpart of `plasticinelab_tpu/algorithms/common.py`; behavioral
reference the vendored baselines in plb/algorithms/ (TD3/utils.py ring
buffer; discor network.py MLPs). The networks are `torch.nn.Module`s with
the reference's layers in its call order, taking observations (N, dim) or
images (N, H, W, C) in [0, 1]. Their initial weights are drawn from a
`torch.Generator` seeded by the caller: kernels lecun-normal (a normal of
variance 1 / fan_in truncated at two standard deviations), biases zero, the
same distributions as flax's defaults but not its draws, which cannot be
reproduced without the reference's random number generator.
`params_from_flax` carries a flax parameter tree across instead.

The host buffers are numpy rings; `DeviceReplayBuffer` and
`DeviceImageReplayBuffer` are rings of tensors allocated once on the
device, written with one indexed copy per array for a batch of
transitions, so collected observations never leave the card.
"""
from __future__ import annotations

import math
from typing import Callable, Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _lecun_normal_(weight: torch.Tensor, fan_in: int, generator) -> None:
    # flax's default kernel init: variance 1 / fan_in after truncation at
    # +-2 standard deviations (0.8796... is the truncated normal's std)
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std, generator=generator)


def _dense(fan_in: int, fan_out: int, generator) -> nn.Linear:
    lin = torch.nn.utils.skip_init(nn.Linear, fan_in, fan_out)
    _lecun_normal_(lin.weight, fan_in, generator)
    nn.init.zeros_(lin.bias)
    return lin


def _conv(c_in: int, c_out: int, k: int, stride: int, generator) -> nn.Conv2d:
    conv = torch.nn.utils.skip_init(nn.Conv2d, c_in, c_out, k, stride)
    _lecun_normal_(conv.weight, k * k * c_in, generator)
    nn.init.zeros_(conv.bias)
    return conv


def _clip(x, lo: float, hi: float):
    # min(max(.)) as the reference's clip: at a bound the gradient splits.
    # The bounds are filled on x's device: a tensor made from a host number
    # would be a blocking copy on every call.
    return torch.minimum(torch.maximum(x, x.new_full((), lo)), x.new_full((), hi))


class MLP(nn.Module):
    """ReLU MLP in_dim -> hidden -> out_dim (flax `Dense_0`, `Dense_1`, ...)."""

    def __init__(self, in_dim: int, hidden: Sequence[int], out_dim: int,
                 activate_final: bool = False, *, generator=None):
        super().__init__()
        dims = (in_dim, *hidden, out_dim)
        self.layers = nn.ModuleList(_dense(a, b, generator) for a, b in zip(dims[:-1], dims[1:]))
        self.activate_final = activate_final

    def forward(self, x):
        for lin in self.layers[:-1]:
            x = F.relu(lin(x))
        x = self.layers[-1](x)
        return F.relu(x) if self.activate_final else x

    def flax_children(self):
        return [(f"Dense_{i}", lin) for i, lin in enumerate(self.layers)]


class GaussianPolicy(nn.Module):
    """Tanh-squashed diagonal Gaussian (reference discor/network.py): hidden
    ReLU layers, then a mean head and a log-std head clipped to
    [log_std_min, log_std_max]."""

    def __init__(self, in_dim: int, action_dim: int, hidden: Sequence[int] = (256, 256),
                 log_std_min: float = -20.0, log_std_max: float = 2.0, *, generator=None):
        super().__init__()
        dims = (in_dim, *hidden)
        self.hidden = nn.ModuleList(_dense(a, b, generator) for a, b in zip(dims[:-1], dims[1:]))
        self.mean = _dense(dims[-1], action_dim, generator)
        self.log_std = _dense(dims[-1], action_dim, generator)
        self.log_std_min, self.log_std_max = log_std_min, log_std_max

    def forward(self, obs):
        h = obs
        for lin in self.hidden:
            h = F.relu(lin(h))
        return self.mean(h), _clip(self.log_std(h), self.log_std_min, self.log_std_max)

    def flax_children(self):
        n = len(self.hidden)
        return ([(f"Dense_{i}", lin) for i, lin in enumerate(self.hidden)]
                + [(f"Dense_{n}", self.mean), (f"Dense_{n + 1}", self.log_std)])

    @staticmethod
    def sample(mean, log_std, eps):
        """tanh(mean + std eps) and its log-probability with the tanh
        correction; eps: standard normal draws of mean's shape."""
        std = torch.exp(log_std)
        action = torch.tanh(mean + std * eps)
        log_prob = ((-0.5 * eps ** 2 - log_std - 0.5 * math.log(2 * math.pi)).sum(-1)
                    - torch.log(1 - action ** 2 + 1e-6).sum(-1))
        return action, log_prob


class TwinQ(nn.Module):
    """Twin state-action values (TD3.py:12-49 / discor network.py): two
    MLPs on concat(obs, act) (flax `MLP_0`, `MLP_1`)."""

    def __init__(self, in_dim: int, hidden: Sequence[int] = (256, 256), *, generator=None):
        super().__init__()
        self.q1 = MLP(in_dim, hidden, 1, generator=generator)
        self.q2 = MLP(in_dim, hidden, 1, generator=generator)

    def forward(self, obs, act):
        x = torch.cat([obs, act], dim=-1)
        return self.q1(x).squeeze(-1), self.q2(x).squeeze(-1)

    def flax_children(self):
        return [("MLP_0", self.q1), ("MLP_1", self.q2)]


class Actor(nn.Module):
    """Deterministic tanh actor (reference TD3.py:12-27)."""

    def __init__(self, in_dim: int, action_dim: int, max_action: float = 1.0,
                 hidden: Sequence[int] = (256, 256), *, generator=None):
        super().__init__()
        dims = (in_dim, *hidden, action_dim)
        self.layers = nn.ModuleList(_dense(a, b, generator) for a, b in zip(dims[:-1], dims[1:]))
        self.max_action = max_action

    def forward(self, obs):
        h = obs
        for lin in self.layers[:-1]:
            h = F.relu(lin(h))
        return self.max_action * torch.tanh(self.layers[-1](h))

    def flax_children(self):
        return [(f"Dense_{i}", lin) for i, lin in enumerate(self.layers)]


def _same_padding(n: int, k: int, s: int) -> Tuple[int, int]:
    """flax's "SAME" padding of one spatial axis: ceil(n / s) outputs, the
    odd pixel on the high side."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class ConvEncoder(nn.Module):
    """NatureCNN-style torso for (N, H, W, C) images in [0, 1] (the
    visual-RL extension; the reference has no pixel observations): three
    ReLU convolutions padded "SAME" as flax pads them, per layer for the
    input's size, then a ReLU Dense on the features flattened in (H, W, C)
    order, as flax flattens them."""

    LAYERS = ((32, 8, 4), (64, 4, 2), (64, 3, 1))  # (channels, kernel, stride)

    def __init__(self, obs_shape: Tuple[int, int, int], feature_dim: int = 256, *,
                 generator=None):
        super().__init__()
        h, w, c = obs_shape
        convs = []
        for c_out, k, s in self.LAYERS:
            convs.append(_conv(c, c_out, k, s, generator))
            h, w, c = -(-h // s), -(-w // s), c_out
        self.convs = nn.ModuleList(convs)
        self.dense = _dense(h * w * c, feature_dim, generator)

    def forward(self, img):
        x = img.permute(0, 3, 1, 2)
        for conv in self.convs:
            k, s = conv.kernel_size[0], conv.stride[0]
            ph, pw = _same_padding(x.shape[2], k, s), _same_padding(x.shape[3], k, s)
            x = F.relu(conv(F.pad(x, (*pw, *ph))))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return F.relu(self.dense(x))

    def flax_children(self):
        return [(f"Conv_{i}", c) for i, c in enumerate(self.convs)] + [("Dense_0", self.dense)]


class VisualGaussianPolicy(nn.Module):
    """ConvEncoder + tanh-Gaussian head (one hidden layer of 256)."""

    sample = staticmethod(GaussianPolicy.sample)

    def __init__(self, obs_shape, action_dim: int, *, generator=None):
        super().__init__()
        self.encoder = ConvEncoder(obs_shape, generator=generator)
        self.head = GaussianPolicy(256, action_dim, hidden=(256,), generator=generator)

    def forward(self, img):
        return self.head(self.encoder(img))

    def flax_children(self):
        return [("ConvEncoder_0", self.encoder), ("GaussianPolicy_0", self.head)]


class VisualActor(nn.Module):
    """ConvEncoder + deterministic tanh head (one hidden layer of 256)."""

    def __init__(self, obs_shape, action_dim: int, max_action: float = 1.0, *, generator=None):
        super().__init__()
        self.encoder = ConvEncoder(obs_shape, generator=generator)
        self.head = Actor(256, action_dim, max_action, hidden=(256,), generator=generator)

    def forward(self, img):
        return self.head(self.encoder(img))

    def flax_children(self):
        return [("ConvEncoder_0", self.encoder), ("Actor_0", self.head)]


class VisualTwinQ(nn.Module):
    """ConvEncoder + twin Q heads (one hidden layer of 256) with an encoder
    of their own: critic gradients shape the representation."""

    def __init__(self, obs_shape, action_dim: int, *, generator=None):
        super().__init__()
        self.encoder = ConvEncoder(obs_shape, generator=generator)
        self.head = TwinQ(256 + action_dim, hidden=(256,), generator=generator)

    def forward(self, img, act):
        return self.head(self.encoder(img), act)

    def flax_children(self):
        return [("ConvEncoder_0", self.encoder), ("TwinQ_0", self.head)]


def params_from_flax(module: nn.Module, tree: Mapping) -> nn.Module:
    """Copy a flax parameter tree (nested dicts of arrays, with or without
    the top-level "params") into `module`, in place, in its dtype. A flax
    `Dense` kernel is (in, out), a `Linear` weight its transpose; a `Conv`
    kernel is HWIO, a `Conv2d` weight OIHW; a bare `nn.Parameter` (flax's
    `self.param`) takes its array as it is. Layers are matched by flax's
    names in call order (`flax_children`)."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    with torch.no_grad():
        _carry(module, tree)
    return module


def _copy(param: torch.Tensor, value, name: str) -> None:
    value = torch.as_tensor(np.array(value))
    if value.shape != param.shape:
        raise ValueError(f"{name}: {tuple(value.shape)} vs {tuple(param.shape)}")
    param.copy_(value)


def _carry(module, tree) -> None:
    if isinstance(module, nn.Parameter):
        if isinstance(tree, Mapping):
            raise ValueError(f"a parameter leaf vs the tree's layer {sorted(tree)}")
        _copy(module, tree, "parameter")
        return
    if not isinstance(tree, Mapping):
        raise ValueError(f"{type(module).__name__} vs the tree's array leaf")
    if isinstance(module, (nn.Linear, nn.Conv2d)):
        kernel = np.asarray(tree["kernel"])
        kernel = kernel.T if isinstance(module, nn.Linear) else kernel.transpose(3, 2, 0, 1)
        for param, value in ((module.weight, kernel), (module.bias, tree["bias"])):
            _copy(param, value, type(module).__name__)
        return
    children = module.flax_children()
    if sorted(name for name, _ in children) != sorted(tree):
        raise ValueError(f"{type(module).__name__}: layers {[n for n, _ in children]} vs "
                         f"the tree's {sorted(tree)}")
    for name, child in children:
        _carry(child, tree[name])


class ImageReplayBuffer:
    """Ring buffer for uint8 image observations (stored compact; sampled as
    float32 in [0, 1]). 100k 64^2 rgb frames ~ 2.5 GB host RAM."""

    def __init__(self, obs_shape: Tuple[int, ...], action_dim: int,
                 max_size: int = 100_000):
        self.max_size = max_size
        self.ptr = 0
        self.size = 0
        self.state = np.zeros((max_size,) + tuple(obs_shape), np.uint8)
        self.action = np.zeros((max_size, action_dim), np.float32)
        self.next_state = np.zeros((max_size,) + tuple(obs_shape), np.uint8)
        self.reward = np.zeros((max_size,), np.float32)
        self.not_done = np.zeros((max_size,), np.float32)

    def add(self, state, action, next_state, reward, done):
        self.state[self.ptr] = state
        self.action[self.ptr] = action
        self.next_state[self.ptr] = next_state
        self.reward[self.ptr] = reward
        self.not_done[self.ptr] = 1.0 - done
        self.ptr = (self.ptr + 1) % self.max_size
        self.size = min(self.size + 1, self.max_size)

    def sample(self, batch_size: int, rng: np.random.Generator):
        ind = rng.integers(0, self.size, size=batch_size)
        return (
            self.state[ind].astype(np.float32) / 255.0,
            self.action[ind],
            self.next_state[ind].astype(np.float32) / 255.0,
            self.reward[ind],
            self.not_done[ind],
        )


class ReplayBuffer:
    """Ring buffer (reference TD3/utils.py:5-40)."""

    def __init__(self, state_dim: int, action_dim: int, max_size: int = int(1e6)):
        self.max_size = max_size
        self.ptr = 0
        self.size = 0
        self.state = np.zeros((max_size, state_dim), np.float32)
        self.action = np.zeros((max_size, action_dim), np.float32)
        self.next_state = np.zeros((max_size, state_dim), np.float32)
        self.reward = np.zeros((max_size,), np.float32)
        self.not_done = np.zeros((max_size,), np.float32)

    def add(self, state, action, next_state, reward, done):
        self.state[self.ptr] = state
        self.action[self.ptr] = action
        self.next_state[self.ptr] = next_state
        self.reward[self.ptr] = reward
        self.not_done[self.ptr] = 1.0 - done
        self.ptr = (self.ptr + 1) % self.max_size
        self.size = min(self.size + 1, self.max_size)

    def sample(self, batch_size: int, rng: np.random.Generator):
        ind = rng.integers(0, self.size, size=batch_size)
        return (
            self.state[ind], self.action[ind], self.next_state[ind],
            self.reward[ind], self.not_done[ind],
        )


class DeviceReplayBuffer:
    """Device-resident ring buffer: transitions never leave the card.

    The storage is allocated once, at construction, on `device`; a batch
    of B transitions lands with one indexed copy per array at rows
    (ptr + arange(B)) % max_size, and the learners draw their minibatches
    on the device (`SAC.update_many_device`). Capacity is a real device
    commitment (max_size x obs_dim x 8 bytes for the two float32
    observation arrays: 2^18 rows of Move-v1's 1,214 ~ 2.5 GB), sized to
    the run, not the reference's 1e6."""

    def __init__(self, state_dim, action_dim: int, max_size: int = 1 << 18,
                 obs_dtype=torch.float32, *, device="cuda"):
        obs_shape = (tuple(state_dim) if isinstance(state_dim, (tuple, list))
                     else (state_dim,))
        self.device = torch.device(device)
        self.max_size = max_size
        self.ptr = 0
        self.size = 0
        self.obs_dtype = obs_dtype
        kw = dict(device=self.device)
        self.state = torch.zeros((max_size,) + obs_shape, dtype=obs_dtype, **kw)
        self.action = torch.zeros((max_size, action_dim), dtype=torch.float32, **kw)
        self.next_state = torch.zeros((max_size,) + obs_shape, dtype=obs_dtype, **kw)
        self.reward = torch.zeros((max_size,), dtype=torch.float32, **kw)
        self.not_done = torch.zeros((max_size,), dtype=torch.float32, **kw)

    def _tensor(self, a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def add_batch(self, state, action, next_state, reward, done):
        """Append B transitions (device tensors or host arrays)."""
        state = self._tensor(state, self.obs_dtype)
        b = state.shape[0]
        idx = (self.ptr + torch.arange(b, device=self.device)) % self.max_size
        self.state[idx] = state
        self.action[idx] = self._tensor(action, torch.float32)
        self.next_state[idx] = self._tensor(next_state, self.obs_dtype)
        self.reward[idx] = self._tensor(reward, torch.float32)
        self.not_done[idx] = 1.0 - self._tensor(done, torch.float32)
        self.ptr = (self.ptr + b) % self.max_size
        self.size = min(self.size + b, self.max_size)

    def arrays(self):
        return (self.state, self.action, self.next_state, self.reward, self.not_done)


class DeviceImageReplayBuffer(DeviceReplayBuffer):
    """Device-resident ring buffer for uint8 image observations, scaled to
    float32 [0, 1] by the learner when it draws a minibatch (2^16 64^2 rgb
    frames ~ 1.6 GB for both observation arrays)."""

    def __init__(self, obs_shape, action_dim: int, max_size: int = 1 << 16, *, device="cuda"):
        super().__init__(obs_shape, action_dim, max_size, torch.uint8, device=device)


def sample_device_batch(bufs, size: int, batch_size: int,
                        indices: Callable[[int, int], torch.Tensor]):
    """A uniform minibatch of a DeviceReplayBuffer's arrays at the rows
    `indices(size, batch_size)` draws on the device."""
    idx = indices(size, batch_size)
    return tuple(b[idx] for b in bufs)


def device_batch(algo, replay_buffer, batch_size: int, obs_stats=None):
    """A minibatch of a Device(Image)ReplayBuffer drawn with `algo.indices`:
    frames scaled to [0, 1], or raw state observations normalised with
    `obs_stats` (mean, inv_std) where given."""
    batch = sample_device_batch(replay_buffer.arrays(), replay_buffer.size, batch_size,
                                algo.indices)
    if algo.visual:
        # times the float32 reciprocal of 255, as the reference's compiled
        # division by a constant rounds
        return (batch[0].to(torch.float32) * (1.0 / 255.0), batch[1],
                batch[2].to(torch.float32) * (1.0 / 255.0)) + batch[3:]
    if obs_stats is not None:
        return (normalize_obs(batch[0], obs_stats), batch[1],
                normalize_obs(batch[2], obs_stats)) + batch[3:]
    return batch


def normalize_obs(x, stats, clip: float = 10.0):
    """(x - mean) * inv_std, clipped (VecNormalize semantics, the
    normalisation the PPO loop applies, run_ppo.RunningMeanStd)."""
    mean, inv_std = stats
    return torch.clamp((x - mean) * inv_std, -clip, clip)


class DeviceObsRMS:
    """Running observation mean and variance as device tensors
    (parallel-merge Welford, ppo.run_ppo.RunningMeanStd's update rule).
    `stats()` feeds the normalisation of `SAC.update_many_device`, so raw
    observations never cross to the host for it."""

    def __init__(self, dim: int, *, device="cuda"):
        self.device = torch.device(device)
        self.mean = torch.zeros((dim,), dtype=torch.float32, device=self.device)
        self.var = torch.ones((dim,), dtype=torch.float32, device=self.device)
        self.count = 1e-4

    def update(self, x):
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        bmean, bvar = x.mean(0), x.var(0, unbiased=False)
        bcount = x.shape[0]
        delta = bmean - self.mean
        tot = self.count + bcount
        new_mean = self.mean + delta * bcount / tot
        m_a = self.var * self.count
        m_b = bvar * bcount
        self.var = (m_a + m_b + delta ** 2 * self.count * bcount / tot) / tot
        self.mean = new_mean
        self.count += bcount

    def stats(self):
        return self.mean, 1.0 / (torch.sqrt(self.var) + 1e-8)


def env_reset(env):
    """The observation of `env.reset()`, gymnasium's (obs, info) or gym's."""
    out = env.reset()
    return out[0] if isinstance(out, tuple) else out


def env_step(env, action):
    """(obs, reward, done, info) of `env.step(action)`: gymnasium's
    terminated or truncated is `done`."""
    out = env.step(action)
    if len(out) == 5:
        obs, r, term, trunc, info = out
        return obs, r, bool(term or trunc), info
    return out


def apply_grads(opt: torch.optim.Optimizer, params, grads) -> None:
    """One step of `opt` on `params` with the gradients `grads`."""
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()


def soft_update(target: nn.Module, online: nn.Module, tau: float) -> nn.Module:
    """target <- target (1 - tau) + online tau, parameter by parameter, in
    place."""
    with torch.no_grad():
        for t, o in zip(target.parameters(), online.parameters()):
            t.mul_(1.0 - tau).add_(o, alpha=tau)
    return target
