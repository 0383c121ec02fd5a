"""Initial particle cloud sampling (host-side NumPy).

Counterpart of `plasticinelab_tpu/engine/shapes.py`, bit for bit.
Behavioral reference: plb/engine/shapes/shape_maker.py. Sampling uses NumPy's
legacy global RNG re-seeded to 0 (shape_maker.py:21) so particle sets are
bit-identical to the reference given the same scene spec.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from ..config.spec import ShapeSpec

COLORS = [
    (127 << 16) + 127,
    (127 << 8),
    127,
    127 << 16,
]


def _rotate(particles: np.ndarray, init_rot) -> np.ndarray:
    """Rotate about the centroid by quaternion (w,x,y,z) (shape_maker.py:37-41)."""
    w, x, y, z = init_rot
    n = w * w + x * x + y * y + z * z
    s = 0.0 if n == 0 else 2.0 / n
    X, Y, Z = x * s, y * s, z * s
    wX, wY, wZ = w * X, w * Y, w * Z
    xX, xY, xZ = x * X, x * Y, x * Z
    yY, yZ, zZ = y * Y, y * Z, z * Z
    q = np.array(
        [
            [1.0 - (yY + zZ), xY - wZ, xZ + wY],
            [xY + wZ, 1.0 - (xX + zZ), yZ - wX],
            [xZ - wY, yZ + wX, 1.0 - (xX + yY)],
        ]
    )
    origin = particles.mean(axis=0)
    return (particles - origin) @ q.T + origin


def _n_for_volume(volume: float) -> int:
    return max(int(volume / 0.2**3) * 10000, 1)


def sample_box(init_pos, width, n_particles=10000) -> np.ndarray:
    width = np.array([width] * 3 if np.isscalar(width) else width, dtype=np.float64)
    if n_particles is None:
        n_particles = _n_for_volume(float(np.prod(width)))
    return (np.random.random((n_particles, 3)) * 2 - 1) * (0.5 * width) + np.array(init_pos)


def sample_sphere(init_pos, radius, n_particles=10000) -> np.ndarray:
    if n_particles is None:
        n_particles = _n_for_volume(radius**3 * 4 * np.pi / 3)
    p = np.random.normal(size=(n_particles, 3))
    p /= np.linalg.norm(p, axis=-1, keepdims=True)
    u = np.random.random(size=(n_particles, 1)) ** (1.0 / 3)
    return p * u * radius + np.array(init_pos)[:3]


def build_particles(shapes: Sequence[ShapeSpec]) -> Tuple[np.ndarray, np.ndarray]:
    """Sample all scene shapes -> (particles (n,3) f64, colors (n,) i32)."""
    if not shapes:
        raise ValueError("please add at least one shape into the scene")
    objects, colors = [], []
    state = np.random.get_state()
    np.random.seed(0)  # fixed seed, reference shape_maker.py:21
    try:
        for i, s in enumerate(shapes):
            if s.shape == "box":
                p = sample_box(s.init_pos, s.width, s.n_particles)
            elif s.shape == "sphere":
                p = sample_sphere(s.init_pos, s.radius, s.n_particles)
            else:
                raise NotImplementedError(f"Shape {s.shape} is not supported!")
            if s.init_rot is not None:
                p = _rotate(p, s.init_rot)
            objects.append(p)
            c = s.color if s.color is not None else COLORS[i]
            colors.append(np.full(len(p), c, np.int32))
    finally:
        np.random.set_state(state)
    return np.concatenate(objects), np.concatenate(colors)
