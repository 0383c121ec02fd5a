"""Differentiable MLS-MPM env step with von Mises plasticity.

Counterpart of `plasticinelab_tpu/engine/mpm.py:837-932` (`make_controls`,
`substep`, `env_step`, `env_step_with_grid_m`) and of its `resolve_remat`
(:386-422). Behavioral reference:
plb/engine/mpm_simulator.py (p2g 157-184, grid_op 189-221, g2p 223-243,
substep 245-257, step 365-376).

A substep runs, in order:
1. stress: `cuda_stress.stress_affine` (TPU kernel K1),
2. P2G: `cuda_transfer.p2g` (K3),
3. forward kinematics of the primitives (plain tensor code),
4. grid update: `cuda_gridop.grid_op` (K8),
5. G2P with advection: `cuda_transfer.g2p` (K5).
An env step is a Python loop of `substeps` substeps; `env_step_with_grid_m`
adds the mass-only P2G of the final positions for the loss
(`cuda_transfer.grid_mass`, K7 forward). At its entry an env step sorts the
particles' indices by base cell (`transfer.cell_order`, as the reference
sorts once per env step, `mpm.py:545-546`, `:748-752`) and hands that order
to the transfers of all its substeps and to the final mass P2G: the scatter
kernels walk the particles in it. The state is not permuted, and the sums
do not depend on the order, so it may go stale within the step. Each of
these dispatches to its
CUDA kernel for CUDA tensors and to its plain version on the CPU.
`PLAIN_OPS` runs the same steps through the plain versions on any device,
to hold the kernels against them. Both are differentiable in the state and
the actions: on CUDA each kernel's autograd Function runs its backward
kernel (K2, K4, K8 backward, K6, K7 backward); the plain versions go
through torch.autograd.

`env_step_batched` steps B envs at once, states with a leading B, the
counterpart of `mpm.py:629-795` (`substep_rows_batched`,
`env_step_batched`) without the crop and windows: stress on the B n
particles, then the batched kernels (`KERNEL_OPS_BATCHED`: K3, K8 forward
and K5 over B envs, K7 forward for the loss), each launched once per
substep for the whole batch. Controls and forward kinematics run over the
batch in the same tensor ops, so a substep's launches do not grow with B.
It is differentiable in the states and the actions like the single env
step: the same autograd Functions run the backward kernels over B envs
(K2 on the B n particles; K4, K8 backward, K6 and K7 backward batched),
one launch each per substep.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..config.spec import SceneSpec
from ..utils.profiling import span
from . import cuda_gridop, cuda_stress, cuda_transfer
from . import primitives as prim
from .state import Controls, Materials, SimState
from .transfer import cell_order

__all__ = ["Ops", "KERNEL_OPS", "PLAIN_OPS", "KERNEL_OPS_BATCHED", "PLAIN_OPS_BATCHED",
           "make_controls", "make_controls_batched", "fk_step", "substep", "substep_batched",
           "env_step", "env_step_with_grid_m", "env_step_batched", "resolve_remat",
           "remat_for"]


class Ops(NamedTuple):
    """The per-substep operations of an env step."""

    stress_affine: Callable
    p2g: Callable
    grid_op: Callable
    g2p: Callable
    grid_mass: Callable


KERNEL_OPS = Ops(cuda_stress.stress_affine, cuda_transfer.p2g,
                 cuda_gridop.grid_op, cuda_transfer.g2p, cuda_transfer.grid_mass)
PLAIN_OPS = Ops(cuda_stress.stress_affine_plain, cuda_transfer.p2g_plain,
                cuda_gridop.grid_op_plain, cuda_transfer.g2p_plain,
                cuda_transfer.grid_mass_plain)
# B envs per call: stress on the flat B n particles, the rest batched
KERNEL_OPS_BATCHED = Ops(cuda_stress.stress_affine, cuda_transfer.p2g_batched,
                         cuda_gridop.grid_op_batched, cuda_transfer.g2p_batched,
                         cuda_transfer.grid_mass_batched)
PLAIN_OPS_BATCHED = Ops(cuda_stress.stress_affine_plain, cuda_transfer.p2g_plain_batched,
                        cuda_gridop.grid_op_plain_batched, cuda_transfer.g2p_plain_batched,
                        cuda_transfer.grid_mass_plain_batched)


def _clip(action):
    # min(max(., -1), 1) as the reference's clip: at a bound the gradient
    # splits in half, where torch.clamp would pass it whole
    one = action.new_ones(())
    return torch.minimum(torch.maximum(action, -one), one)


def _controls(scene: SceneSpec, action) -> Controls:
    """Clipped actions (..., action_dim) -> per-substep Controls with the
    same leading dims: v, w (..., k, 3), gap_vel (..., k)."""
    n_sub = scene.simulator.substeps
    offs = scene.action_dims
    lead = action.shape[:-1]
    if not scene.primitives:
        z3 = action.new_zeros(lead + (0, 3))
        return Controls(v=z3, w=z3, gap_vel=action.new_zeros(lead + (0,)))
    vwg = [prim.action_to_velocity(p, action[..., offs[i]: offs[i + 1]], n_sub)
           for i, p in enumerate(scene.primitives)]
    return Controls(v=torch.stack([c[0] for c in vwg], dim=-2),
                    w=torch.stack([c[1] for c in vwg], dim=-2),
                    gap_vel=torch.stack([c[2] for c in vwg], dim=-1))


def make_controls(scene: SceneSpec, action, device, dtype) -> Controls:
    """Full action vector (action_dim,) -> per-substep Controls, clipped to
    [-1, 1] (reference primitives.py:289-293). action None means zeros. A
    tensor action stays in the autograd graph."""
    if action is None:
        action = torch.zeros((scene.action_dim,), dtype=dtype, device=device)
    else:
        action = _clip(torch.as_tensor(action, dtype=dtype, device=device).reshape(-1))
    return _controls(scene, action)


def make_controls_batched(scene: SceneSpec, actions, device, dtype) -> Controls:
    """Actions of B envs (B, action_dim) -> Controls with a leading B,
    clipped to [-1, 1], in one set of tensor ops for the whole batch."""
    actions = torch.as_tensor(actions, dtype=dtype, device=device)
    return _controls(scene, _clip(actions.reshape(actions.shape[0], -1)))


def fk_step(scene: SceneSpec, poses, ctrl: Controls):
    """Forward kinematics of all primitives: poses (pos (..., k, 3), rot
    (..., k, 4), gap (..., k)) at f -> at f+1. Leading dims are envs,
    stepped in the same tensor ops (`mpm.py:_fk_step_batched`)."""
    if not scene.primitives:
        return poses
    pos_f, rot_f, gap_f = poses
    with span("plb.physics.fk"):
        out = [prim.forward_kinematics(p, pos_f[..., i, :], rot_f[..., i, :], gap_f[..., i],
                                       ctrl.v[..., i, :], ctrl.w[..., i, :], ctrl.gap_vel[..., i])
               for i, p in enumerate(scene.primitives)]
        return (torch.stack([o[0] for o in out], dim=-2),
                torch.stack([o[1] for o in out], dim=-2), torch.stack([o[2] for o in out], dim=-1))


def substep(scene: SceneSpec, mats: Materials, state: SimState, ctrl: Controls,
            softness: float, ops: Ops = KERNEL_OPS, order=None) -> SimState:
    """One MLS-MPM substep (reference substep :245-257). order: the env
    step's `cell_order`, which the scatter kernels walk (None: the particles
    as they lie)."""
    new_F, affine = ops.stress_affine(scene, mats, state.C, state.F)
    grid4 = ops.p2g(scene, state.x, state.v, affine, order)
    pose_f = (state.prim_pos, state.prim_rot, state.prim_gap)
    pose_f1 = fk_step(scene, pose_f, ctrl)
    grid_v = ops.grid_op(scene, grid4, pose_f, pose_f1, softness)
    new_v, new_C, new_x = ops.g2p(scene, state.x, grid_v, order)
    return SimState(x=new_x, v=new_v, C=new_C, F=new_F, prim_pos=pose_f1[0],
                    prim_rot=pose_f1[1], prim_gap=pose_f1[2])


def env_step(scene: SceneSpec, mats: Materials, state: SimState, action,
             softness: float, ops: Ops = KERNEL_OPS, order=None) -> SimState:
    """One environment step = `substeps` substeps under constant manipulator
    velocities (reference MPMSimulator.step :365-376), all walking the
    particles in `order`, by default the `cell_order` of the entry state."""
    if order is None:
        order = cell_order(scene, state.x)
    ctrl = make_controls(scene, action, state.x.device, state.x.dtype)
    for _ in range(scene.simulator.substeps):
        state = substep(scene, mats, state, ctrl, softness, ops, order)
    return state


def env_step_with_grid_m(scene: SceneSpec, mats: Materials, state: SimState,
                         action, softness: float, ops: Ops = KERNEL_OPS):
    """env_step plus the final state's grid mass for the loss:
    (new_state, grid_m (G^3,)), the mass P2G too in the entry state's order."""
    with span("plb.physics"):
        order = cell_order(scene, state.x)
        state = env_step(scene, mats, state, action, softness, ops, order)
        return state, ops.grid_mass(scene, state.x, order)


def substep_batched(scene: SceneSpec, mats: Materials, states: SimState, ctrl: Controls,
                    softness, ops: Ops = KERNEL_OPS_BATCHED, order=None) -> SimState:
    """One substep of B envs (states and ctrl with a leading B, softness
    (B,), order (B, n) as in `substep`) (`mpm.py:substep_rows_batched`,
    :629-689)."""
    B, n = states.x.shape[:2]
    new_F, affine = ops.stress_affine(scene, mats, states.C.reshape(B * n, 3, 3),
                                      states.F.reshape(B * n, 3, 3))
    grid4 = ops.p2g(scene, states.x, states.v, affine.reshape(B, n, 3, 3), order)
    pose_f = (states.prim_pos, states.prim_rot, states.prim_gap)
    pose_f1 = fk_step(scene, pose_f, ctrl)
    grid_v = ops.grid_op(scene, grid4, pose_f, pose_f1, softness)
    new_v, new_C, new_x = ops.g2p(scene, states.x, grid_v, order)
    return SimState(x=new_x, v=new_v, C=new_C, F=new_F.reshape(B, n, 3, 3),
                    prim_pos=pose_f1[0], prim_rot=pose_f1[1], prim_gap=pose_f1[2])


def env_step_batched(scene: SceneSpec, mats: Materials, states: SimState, actions, softness,
                     want_grid_m: bool = False, ops: Ops = KERNEL_OPS_BATCHED):
    """One env step of B envs: states with a leading B, actions (B,
    action_dim), softness a scalar or (B,) -> new states and, with
    `want_grid_m`, their grid mass (B, G^3) for the loss (`mpm.py:715-795`
    on the full grid: no crop or windows, and of the sort only the order,
    each env's `cell_order` at entry, which all substeps and the mass P2G
    walk)."""
    with span("plb.physics"):
        x = states.x
        B = x.shape[0]
        order = cell_order(scene, x)
        ctrl = make_controls_batched(scene, actions, x.device, x.dtype)
        softness = torch.as_tensor(softness, dtype=x.dtype,
                                   device=x.device).expand(B).contiguous()
        for _ in range(scene.simulator.substeps):
            states = substep_batched(scene, mats, states, ctrl, softness, ops, order)
        if want_grid_m:
            return states, ops.grid_mass(scene, states.x, order)
        return states


# Bytes one substep keeps alive for the backward when nothing is recomputed
# ("none"), through the kernels, float32: per grid cell the grid4 GridOp
# saves (16 B) and the grid velocities G2P saves (12 B); per particle the
# substep's state (x, v, C, F: 96 B), the affine P2G saves (36 B) and what
# the peak backward adds. Measured on the card: 8.346 MiB per substep over
# a 50-step Move-v1 trajectory gradient (10,000 particles, 64^3 grid; H100
# 80GB HBM3, PERF.md), which sets the per-particle share to 141 B. B envs
# stepped together keep B times as much.
_BYTES_PER_PARTICLE = 141
_BYTES_PER_CELL = 28
# share of the free device memory a rollout's stored substeps may take
_REMAT_BUDGET = 0.8


def substep_bytes(scene: SceneSpec) -> int:
    """Device bytes one substep keeps for the backward under remat "none"."""
    sim = scene.simulator
    return sim.n_particles * _BYTES_PER_PARTICLE + sim.n_grid ** 3 * _BYTES_PER_CELL


def resolve_remat(scene: SceneSpec, horizon: int, device, batch: int = 1) -> str:
    """The cheapest rematerialisation policy for the backward of a
    `horizon`-step rollout of `batch` envs stepped together
    (`plasticinelab_tpu/engine/mpm.py:resolve_remat`, with this card's
    sizes):

    - "none": keep every substep's saved tensors (no recompute);
    - "env_step": keep one state per env step and recompute each env step's
      substeps in the backward (torch.utils.checkpoint), so one env step's
      saved tensors live at a time.

    "none" where batch x horizon x substeps x `substep_bytes` fits in
    `_REMAT_BUDGET` of the free memory: what `torch.cuda.mem_get_info`
    reports plus what PyTorch's allocator holds in reserve without using
    it; on the CPU, "none"."""
    device = torch.device(device)
    if device.type != "cuda":
        return "none"
    free, _ = torch.cuda.mem_get_info(device)
    free += torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    return remat_for(scene, horizon, batch, free)


def remat_for(scene: SceneSpec, horizon: int, batch: int, free_bytes: int) -> str:
    """`resolve_remat`'s rule for a device with `free_bytes` free."""
    need = batch * horizon * scene.simulator.substeps * substep_bytes(scene)
    return "none" if need <= _REMAT_BUDGET * free_bytes else "env_step"
