"""Host-facing optimizers with the reference's exact update rules.

Counterpart of `plasticinelab_tpu/optimizer/optim.py`; behavioral reference
plb/optimizer/optim.py (Adam :49-78, Momentum :33-46): step(grads) updates
the stored float64 parameters and clips them to bounds. The device solve
(`solver.Solver.solve_device`) runs the same rules on device tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass
class OptimizerConfig:
    lr: float = 0.1
    bounds: Tuple[float, float] = (-1.0, 1.0)
    type: str = "Adam"
    momentum: float = 0.9
    beta_1: float = 0.9
    beta_2: float = 0.999
    epsilon: float = 1e-8


class Optimizer:
    def __init__(self, parameters: np.ndarray, cfg: OptimizerConfig = None, **kwargs):
        self.cfg = cfg or OptimizerConfig(**kwargs)
        self.lr = self.cfg.lr
        self.bounds = self.cfg.bounds
        self.parameters = np.array(parameters, dtype=np.float64)
        self.initialize()

    def initialize(self):
        raise NotImplementedError

    def _step(self, grads):
        raise NotImplementedError

    def step(self, grads):
        grads = np.asarray(grads, dtype=np.float64)
        if grads.shape != self.parameters.shape:
            raise ValueError(f"grads {grads.shape} vs parameters {self.parameters.shape}")
        self.parameters[:] = self._step(grads).clip(*self.bounds)
        return self.parameters.copy()


class Momentum(Optimizer):
    def initialize(self):
        self.momentum_buffer = np.zeros_like(self.parameters)
        self.momentum = self.cfg.momentum

    def _step(self, grads):
        grads = self.momentum_buffer * self.momentum + grads * (1 - self.momentum)
        self.momentum_buffer[:] = grads
        return self.parameters - self.lr * grads


class Adam(Optimizer):
    def initialize(self):
        self.momentum_buffer = np.zeros_like(self.parameters)
        self.v_buffer = np.zeros_like(self.parameters)
        self.iter = 0

    def _step(self, grads):
        b1, b2, eps = self.cfg.beta_1, self.cfg.beta_2, self.cfg.epsilon
        m_t = b1 * self.momentum_buffer + (1 - b1) * grads
        v_t = b2 * self.v_buffer + (1 - b2) * (grads * grads)
        self.momentum_buffer[:] = m_t
        self.v_buffer[:] = v_t
        m_cap = m_t / (1 - b1 ** (self.iter + 1))
        v_cap = v_t / (1 - b2 ** (self.iter + 1))
        self.iter += 1
        return self.parameters - (self.lr * m_cap) / (np.sqrt(v_cap) + eps)


OPTIMS = {"Adam": Adam, "Momentum": Momentum}
