"""Inputs that the benchmark makes and hands to both the program and the
reference: the task's particle cloud, the jittered starts of B envs and the
actions, all from a configuration file and `--seed`."""
from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def task_cloud(spec: dict) -> np.ndarray:
    """The task's initial cloud (n, 3) float64 as PlasticineLab samples it
    (plb/engine/shapes/shape_maker.py: NumPy's legacy generator seeded 0,
    boxes uniform, spheres uniform in the ball). Every env of every run
    starts from this cloud; `--seed` moves it by the jitter only."""
    rng = np.random.RandomState(0)
    parts = []
    for s in spec["SHAPES"]:
        n = int(s.get("n_particles", 10000))
        pos = np.asarray(s["init_pos"], np.float64)
        if s["shape"] == "box":
            width = np.asarray(s["width"], np.float64)
            parts.append((rng.random_sample((n, 3)) * 2 - 1) * (0.5 * width) + pos)
        elif s["shape"] == "sphere":
            p = rng.normal(size=(n, 3))
            p /= np.linalg.norm(p, axis=-1, keepdims=True)
            u = rng.random_sample((n, 1)) ** (1.0 / 3)
            parts.append(p * u * float(s["radius"]) + pos)
        else:
            raise ValueError(f"no sampler for the shape {s['shape']!r}")
    return np.concatenate(parts)


def goal_grid(config: dict) -> np.ndarray:
    """The configuration's goal grid (G, G, G), after its sha256 is checked."""
    path = os.path.join(ROOT, config["goal"]["file"])
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    if digest != config["goal"]["sha256"]:
        raise ValueError(f"{path}: sha256 {digest}, the configuration states "
                         f"{config['goal']['sha256']}")
    return np.load(path)


def jittered_starts(cloud: np.ndarray, batch: int, seed: int, jitter: float) -> torch.Tensor:
    """(B, n, 3) float32 starts: the cloud moved by uniform(-jitter, jitter)
    from a CPU torch.Generator seeded `seed` and clipped to [0, 0.95], the
    rule `VecPlasticineEnv` documents for its starts."""
    x = torch.as_tensor(cloud, dtype=torch.float32).expand(batch, -1, -1)
    gen = torch.Generator().manual_seed(seed)
    noise = torch.rand(x.shape, generator=gen, dtype=torch.float32) * (2 * jitter) - jitter
    return torch.clamp(x + noise, 0.0, 0.95)


class Actions:
    """Actions uniform in [-1, 1), float32, made on `device` from a
    generator there seeded from `seed`: `episode()` draws the next
    (horizon, B, dim) block."""

    def __init__(self, seed: int, horizon: int, batch: int, dim: int, device):
        self.gen = torch.Generator(device=device).manual_seed(seed ^ 0x5EED)
        self.shape, self.device = (horizon, batch, dim), device

    def episode(self) -> torch.Tensor:
        return torch.rand(self.shape, generator=self.gen, device=self.device) * 2.0 - 1.0
