"""In-graph MLP policy: observations -> actions inside the differentiable
rollout.

Counterpart of `plasticinelab_tpu/engine/nn.py:21-98`; behavioral
reference plb/engine/nn/mlp.py. The observation layout (obs_num sampled
particle (x, v) pairs, then the primitive pose vectors, mlp.py:63-87), the
[-1, 1] output clamp (mlp.py:89-100) and the flat get/set of the
parameters with the optional trailing velocity_weight scalar
(mlp.py:154-183) are kept. Parameters are a dict of tensors `W{i}`
(fan_out, fan_in) and `b{i}`; the initial draws are numpy's, so both
packages start from the same numbers. The matrix products are plain
`torch.matmul`: no kernel of the port is involved.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..config.spec import SceneSpec
from .mpm import _clip
from .state import SimState, flat_primitive_states


class MLPPolicy:
    def __init__(self, scene: SceneSpec, hidden_dims: Tuple[int, ...] = (256, 256),
                 activation: str = "relu", n_observed_particles: int = 200):
        for p in scene.primitives:
            assert p.shape != "Chopsticks", "Chopstick is not supported now.."
        self.scene = scene
        n = scene.simulator.n_particles
        self.obs_step = n // n_observed_particles
        self.obs_num = n // self.obs_step
        inp_dim = self.obs_num * 6 + scene.primitive_state_dim
        self.dims = (inp_dim,) + tuple(hidden_dims) + (scene.action_dim,)
        self.n_layer = len(self.dims) - 1
        self.activation = activation
        self.velocity_weight = 1.0

    # ---- parameters ----
    def init_params(self, seed: int = 0, dtype=torch.float32, *,
                    device="cuda") -> Dict[str, torch.Tensor]:
        """W{i} (fan_out, fan_in) and b{i} drawn uniform(+-1/sqrt(fan_in))
        from `np.random.default_rng(seed)`, in layer order."""
        rng = np.random.default_rng(seed)
        params = {}
        for i in range(self.n_layer):
            fan_in, fan_out = self.dims[i], self.dims[i + 1]
            bound = 1.0 / np.sqrt(fan_in)
            for name, shape in ((f"W{i}", (fan_out, fan_in)), (f"b{i}", (fan_out,))):
                params[name] = torch.as_tensor(rng.uniform(-bound, bound, shape), dtype=dtype,
                                               device=device)
        return params

    def get_params(self, params: Dict[str, torch.Tensor]) -> np.ndarray:
        """Flat float64 vector: W0, b0, W1, b1, ... each row-major."""
        outs = []
        for i in range(self.n_layer):
            for name in (f"W{i}", f"b{i}"):
                outs.append(params[name].detach().cpu().numpy().astype(np.float64).reshape(-1))
        return np.concatenate(outs)

    def set_params(self, flat, dtype=torch.float32, *, device="cuda") -> Dict[str, torch.Tensor]:
        """Inverse of get_params. A trailing scalar sets velocity_weight;
        without one it is reset to 1.0."""
        flat = np.asarray(flat)
        params = self.unflatten(torch.as_tensor(flat[:self.n_params], dtype=dtype, device=device))
        rest = flat[self.n_params:]
        if len(rest) == 1:
            self.velocity_weight = float(rest[0])
        else:
            self.velocity_weight = 1.0
            assert len(rest) == 0
        return params

    @property
    def n_params(self) -> int:
        return sum(self.dims[i + 1] * (self.dims[i] + 1) for i in range(self.n_layer))

    def unflatten(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Views of a flat parameter tensor as W{i}, b{i}: differentiable in
        `flat`."""
        params, o = {}, 0
        for i in range(self.n_layer):
            fo, fi = self.dims[i + 1], self.dims[i]
            params[f"W{i}"] = flat[o:o + fo * fi].reshape(fo, fi)
            o += fo * fi
            params[f"b{i}"] = flat[o:o + fo]
            o += fo
        return params

    # ---- forward ----
    def observe(self, state: SimState) -> torch.Tensor:
        """mlp.py:63-87 input layout: obs_num x (x, v * velocity_weight),
        then the primitive poses."""
        x = state.x[::self.obs_step][:self.obs_num]
        v = state.v[::self.obs_step][:self.obs_num] * self.velocity_weight
        prim = flat_primitive_states(self.scene, state)
        return torch.cat([torch.cat([x, v], dim=-1).reshape(-1), prim])

    def apply(self, params: Dict[str, torch.Tensor], obs: torch.Tensor) -> torch.Tensor:
        """The MLP on one observation, clipped to [-1, 1]. ReLU is
        `torch.maximum(h, 0)` and the clip `mpm._clip`: at a tie both split
        the gradient in half, as the reference's maximum and clip do."""
        h = obs
        zero = obs.new_zeros(())
        for i in range(self.n_layer):
            h = torch.matmul(params[f"W{i}"], h) + params[f"b{i}"]
            if i != self.n_layer - 1:
                if self.activation == "relu":
                    h = torch.maximum(h, zero)
                elif self.activation == "tanh":
                    h = torch.tanh(h)
        return _clip(h)

    def act(self, params: Dict[str, torch.Tensor], state: SimState) -> torch.Tensor:
        return self.apply(params, self.observe(state))
