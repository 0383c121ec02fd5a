"""Simulation state: small dataclasses of tensors.

Counterpart of `plasticinelab_tpu/engine/state.py`. One SimState per
instant (reference globals plb/engine/mpm_simulator.py:33-51 and
primive_base.py:31-44). Every tensor of a state lies on one device in one
float dtype; the kernels take float32 on CUDA. The states of B envs stepped
together are one SimState whose tensors have a leading B.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..config.spec import SceneSpec


@dataclass
class SimState:
    """Full state of one env at one instant."""

    x: torch.Tensor         # (n, 3) particle positions
    v: torch.Tensor         # (n, 3) particle velocities
    C: torch.Tensor         # (n, 3, 3) APIC affine velocity field
    F: torch.Tensor         # (n, 3, 3) deformation gradient
    prim_pos: torch.Tensor  # (k, 3)
    prim_rot: torch.Tensor  # (k, 4) unit quaternion (w, x, y, z)
    prim_gap: torch.Tensor  # (k,) chopsticks opening (0 where unused)


@dataclass
class Controls:
    """Per-substep rigid-manipulator velocities (constant within an env step,
    reference primive_base.py:184-192)."""

    v: torch.Tensor        # (k, 3) linear velocity per substep
    w: torch.Tensor        # (k, 3) angular velocity per substep
    gap_vel: torch.Tensor  # (k,) gap closing rate per substep


@dataclass
class Materials:
    """Per-scene material constants as 0-d host tensors (the reference fills
    per-particle fields uniformly, mpm_simulator.py:53-57)."""

    mu: torch.Tensor
    lam: torch.Tensor
    yield_stress: torch.Tensor


def scene_dtype(scene: SceneSpec) -> torch.dtype:
    return torch.float64 if scene.simulator.dtype == "float64" else torch.float32


def default_materials(scene: SceneSpec) -> Materials:
    sim = scene.simulator
    f64 = torch.float64
    return Materials(
        mu=torch.tensor(sim.mu_0, dtype=f64),
        lam=torch.tensor(sim.lam_0, dtype=f64),
        yield_stress=torch.tensor(sim.yield_stress, dtype=f64),
    )


def _prim_init(scene: SceneSpec):
    k = len(scene.primitives)
    pos = np.zeros((k, 3))
    rot = np.zeros((k, 4))
    gap = np.zeros((k,))
    for i, p in enumerate(scene.primitives):
        pos[i] = p.init_pos
        rot[i] = p.init_rot
        if p.shape == "Chopsticks":
            gap[i] = p.init_gap
    return pos, rot, gap


def initial_state(scene: SceneSpec, particles: np.ndarray, device,
                  dtype: torch.dtype) -> SimState:
    """Rest state: particles at rest with identity F (mpm_simulator.py:330-341),
    primitives at their configured init pose (primive_base.py:157-164)."""
    n = len(particles)
    pos, rot, gap = _prim_init(scene)
    kw = dict(device=device, dtype=dtype)
    return SimState(
        x=torch.as_tensor(np.asarray(particles), **kw).contiguous(),
        v=torch.zeros((n, 3), **kw),
        C=torch.zeros((n, 3, 3), **kw),
        F=torch.eye(3, **kw).expand(n, 3, 3).contiguous(),
        prim_pos=torch.as_tensor(pos, **kw),
        prim_rot=torch.as_tensor(rot, **kw),
        prim_gap=torch.as_tensor(gap, **kw),
    )


def tile_states(state: SimState, batch: int, jitter: float = 0.0,
                generator: Optional[torch.Generator] = None) -> SimState:
    """One state tiled over `batch` envs (a leading B on every tensor), each
    env's particles moved by uniform(-jitter, jitter) noise and clipped to
    [0, 0.95] (`plasticinelab_tpu/parallel/rollout.py:110-117`,
    `parallel/mesh.py:49-62`). The noise is drawn on the CPU from
    `generator` (a fresh default one if None), so a seed gives the same
    starts on every device; its bits differ from the TPU package's draws
    (its PRNGKey(seed) uniform) from the same seed."""
    tiled = [t.expand((batch,) + t.shape).contiguous() for t in state_fields(state)]
    if jitter > 0:
        x = tiled[0]
        noise = torch.rand(x.shape, generator=generator, dtype=x.dtype) * (2 * jitter) - jitter
        tiled[0] = torch.clamp(x + noise.to(x.device), 0.0, 0.95)
    return SimState(*tiled)


def initial_states(scene: SceneSpec, particles: np.ndarray, batch: int, device,
                   dtype: torch.dtype, jitter: float = 0.0,
                   generator: Optional[torch.Generator] = None) -> SimState:
    """`initial_state` tiled over `batch` envs with jittered particles
    (`tile_states`), on `device`."""
    return tile_states(initial_state(scene, particles, device, dtype), batch, jitter, generator)


def state_fields(state: SimState):
    """The tensors of a state in SimState order."""
    return (state.x, state.v, state.C, state.F, state.prim_pos, state.prim_rot, state.prim_gap)


def states_from_numpy(arrays: Sequence[np.ndarray], device, dtype: torch.dtype) -> SimState:
    """A batch of states carried across from the TPU package: the fields of
    its SimState with a leading B, in its order (x, v, C, F, prim_pos,
    prim_rot, prim_gap), as numpy arrays."""
    return SimState(*(torch.tensor(np.asarray(a), device=device, dtype=dtype) for a in arrays))


def state_from_numpy(scene: SceneSpec, state_list: Sequence[np.ndarray],
                     device, dtype: torch.dtype) -> SimState:
    """The reference layout of `PhysicsEnv.get_state()["state"]` — x, v, F,
    C, then per primitive pos+rot (+ gap for Chopsticks) — as a SimState.
    Carries a state across from the TPU package, as weights are carried for
    a model."""
    x, v, F, C = state_list[:4]
    k = len(scene.primitives)
    pos = np.zeros((k, 3))
    rot = np.zeros((k, 4))
    gap = np.zeros((k,))
    for i, (p, entry) in enumerate(zip(scene.primitives, state_list[4:])):
        entry = np.asarray(entry)
        pos[i] = entry[:3]
        rot[i] = entry[3:7]
        if p.shape == "Chopsticks" and len(entry) > 7:
            gap[i] = entry[7]

    def t(a):  # a copy: the caller's arrays may be read-only or reused
        return torch.tensor(np.asarray(a), device=device, dtype=dtype)

    return SimState(x=t(x), v=t(v), C=t(C), F=t(F),
                    prim_pos=t(pos), prim_rot=t(rot), prim_gap=t(gap))


def state_to_numpy(scene: SceneSpec, state: SimState):
    """Inverse of state_from_numpy: the reference layout as float64 arrays."""
    def a(t):
        return t.detach().cpu().numpy().astype(np.float64)

    out = [a(state.x), a(state.v), a(state.F), a(state.C)]
    pos, rot, gap = a(state.prim_pos), a(state.prim_rot), a(state.prim_gap)
    for i, p in enumerate(scene.primitives):
        entry = np.concatenate([pos[i], rot[i]])
        if p.shape == "Chopsticks":
            entry = np.append(entry, gap[i])
        out.append(entry)
    return out


def flat_primitive_states(scene: SceneSpec, state: SimState) -> torch.Tensor:
    """Concatenated per-primitive observation vectors: pos+rot (+gap for
    Chopsticks), reference primive_base.py:143-146 / primitives.py:134-135;
    (B, dim) for states with a leading B."""
    outs = []
    for i, p in enumerate(scene.primitives):
        outs.append(state.prim_pos[..., i, :])
        outs.append(state.prim_rot[..., i, :])
        if p.shape == "Chopsticks":
            outs.append(state.prim_gap[..., i : i + 1])
    if not outs:
        return state.x.new_zeros(state.x.shape[:-2] + (0,))
    return torch.cat(outs, dim=-1)
