"""Batched trajectory gradient: B envs of one task rolled out together and
differentiated in one backward pass, on one card.

Counterpart of `plasticinelab_tpu/parallel/mesh.py`: `batch_states`
(:49-62) and `build_batched_rollout_grad` (:65-171), the path of the TPU
package's batched backward kernels (K4-b, K6-b, K7-bwd-b, K8-bwd-b). It is
how a differentiable-physics user solves B starts or B variants of a task
at once: every substep, forward and backward, launches each kernel once for
the whole batch, so the host's launch cost is paid once per batch, not once
per env.

Not here, unlike the TPU package: a device mesh and a sharded batch (one
card; ROADMAP A15).
"""
from __future__ import annotations

import dataclasses

import torch

from ..config.spec import SceneSpec
from ..engine import mpm
from ..engine.losses import LossState
from ..engine.sim import rollout_losses_batched
from ..engine.state import Materials, SimState, scene_dtype, tile_states

__all__ = ["batch_states", "build_batched_rollout_grad", "BatchedRolloutGrad"]


def batch_states(state: SimState, batch: int, jitter: float = 0.0, seed: int = 0) -> SimState:
    """Tile one SimState into a leading batch axis, on its device, each
    env's particles moved by uniform(-jitter, jitter) noise and clipped to
    [0, 0.95] so that the envs decorrelate. The noise comes from a
    torch.Generator seeded with `seed` (`state.tile_states`): reproducible,
    but not the TPU package's bits for the same seed."""
    return tile_states(state, batch, jitter, torch.Generator().manual_seed(seed))


class BatchedRolloutGrad:
    """step(states, actions (B, T, action_dim), softness) -> (mean loss 0-d,
    grad (B, T, action_dim)), both detached: the mean over envs of each
    env's loss summed over its T steps, and its gradient with respect to the
    actions (`mesh.py:129-138`). states: a SimState with a leading B on
    `device`; softness: a number or (B,).

    The rematerialisation policy comes from `mpm.resolve_remat` for the
    call's B and T and is kept in `last_remat`."""

    def __init__(self, scene: SceneSpec, mats: Materials, loss_state: LossState, device):
        self.scene, self.mats, self.loss_state = scene, mats, loss_state
        self.device = torch.device(device)
        self.dtype = scene_dtype(scene)
        self.last_remat = None

    def __call__(self, states: SimState, actions, softness):
        actions = torch.as_tensor(actions, dtype=self.dtype, device=self.device)
        actions = actions.detach().clone().requires_grad_(True)
        B, T = actions.shape[:2]
        softness = torch.as_tensor(softness, dtype=self.dtype, device=self.device)
        softness = softness.expand(B).contiguous()
        # the particle states are differentiated too, and their gradient
        # dropped, so that the first substep runs the same backward as every
        # other: one launch of each substep backward kernel per substep
        particles = [t.detach().requires_grad_(True)
                     for t in (states.x, states.v, states.C, states.F)]
        states = dataclasses.replace(states, **dict(zip("xvCF", particles)))
        self.last_remat = mpm.resolve_remat(self.scene, T, self.device, batch=B)
        with torch.enable_grad():
            losses, _ = rollout_losses_batched(self.scene, self.mats, self.loss_state, states,
                                               actions, softness, self.last_remat)
            loss = losses.sum(dim=0).mean()
            grad = torch.autograd.grad(loss, [actions, *particles])[0]
        return loss.detach(), grad


def build_batched_rollout_grad(scene: SceneSpec, mats: Materials, loss_state: LossState,
                               mesh=None, axis_name: str = "env", out_mode: str = "force", *,
                               device="cuda") -> BatchedRolloutGrad:
    """d(mean rollout loss)/d(actions) for a batch of envs of `scene` on
    `device` (`BatchedRolloutGrad`). On CUDA every substep runs the batched
    kernels and their backward kernels; on the CPU, the plain versions
    through torch.autograd.

    The reference's positional parameters: `mesh` takes only None (one
    card; ROADMAP A15) and `axis_name` names the batch axis there. Its
    `out_mode` only pins the output shardings ("force") or leaves them to
    the compiler ("auto"); on one card both are the same computation, and
    any other value is refused as it is there."""
    if mesh is not None:
        raise NotImplementedError(
            "build_batched_rollout_grad(mesh=...): the port runs on one card; a device mesh "
            "is ROADMAP item A15")
    if out_mode not in ("force", "auto"):
        raise ValueError(f"out_mode must be 'force' or 'auto', got {out_mode!r}")
    return BatchedRolloutGrad(scene, mats, loss_state, device)
