"""Task losses: density L1 + goal-SDF mass + manipulator contact; IoU.

Counterpart of `plasticinelab_tpu/engine/losses.py` on the full grid:
`loss_from_crop` with the crop equal to the grid is `loss_and_components`
(`losses.py:77-149`). Behavioral reference: plb/engine/losses/loss.py. The
goal SDF is the exact Euclidean distance transform from scipy, as in the
TPU package. Every function also takes the states and grid masses of B envs
with a leading B (the vmapped `loss_from_crop` of
`plasticinelab_tpu/parallel/rollout.py:178-181`): sums run over the last
axis.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from ..config.spec import SceneSpec
from . import primitives as prim
from .state import SimState

__all__ = ["LossState", "precompute_target_sdf", "make_loss_state",
           "contact_distances", "loss_and_components", "iou"]


@dataclass
class LossState:
    """Static per-task goal tensors on the simulation device."""

    target_density: torch.Tensor  # (G^3,)
    target_sdf: torch.Tensor      # (G^3,)


def precompute_target_sdf(target_density: np.ndarray, dx: float,
                          threshold: float = 1e-4) -> np.ndarray:
    """Exact EDT from every cell center to the nearest occupied cell center
    (occupied = density > threshold). Units: world space (indices * dx)."""
    from scipy import ndimage

    occupied = np.asarray(target_density) > threshold
    if not occupied.any():
        return np.full(target_density.shape, 1000.0, dtype=np.float64)
    return ndimage.distance_transform_edt(~occupied) * dx


def make_loss_state(scene: SceneSpec, target_density: np.ndarray, device,
                    dtype: torch.dtype) -> LossState:
    G = scene.simulator.n_grid
    td = np.asarray(target_density, dtype=np.float64)
    sdf = precompute_target_sdf(td.reshape((G,) * 3), scene.simulator.dx)
    # cast through the simulation dtype in numpy, as the reference does
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    return LossState(
        target_density=torch.as_tensor(td.astype(np_dt).reshape(-1), device=device),
        target_sdf=torch.as_tensor(sdf.astype(np_dt).reshape(-1), device=device),
    )


def _soft_weight(d):
    return 1.0 / (1.0 + d * d * 10000.0)  # reference loss.py:112-114


def contact_distances(scene: SceneSpec, state: SimState):
    """Per movable primitive: the (soft-)min clamped SDF over all particles
    (reference loss.py:116-140), each env's against its own pose. Returns a
    list of tensors of the states' leading shape (0-d for one env)."""
    out = []
    soft = scene.env.loss.soft_contact
    for i, p in enumerate(scene.primitives):
        if p.action_dim <= 0:
            continue  # only movable primitives (loss.py:21-24)
        d = prim.sdf(p, state.prim_pos[..., i, None, :], state.prim_rot[..., i, None, :],
                     state.prim_gap[..., i, None], state.x)
        d = torch.clamp(d, min=0.0)
        if soft:
            w = _soft_weight(d)
            out.append(torch.sum(d * w, dim=-1) / torch.sum(w, dim=-1))
        else:
            out.append(torch.amin(d, dim=-1))
    return out


def iou(grid_m, target_density):
    """Soft IoU (reference iou_kernel, loss.py:239-254) over the last axis."""
    ma = torch.amax(grid_m, dim=-1)
    mb = torch.amax(target_density, dim=-1)
    I = torch.sum(grid_m * target_density, dim=-1) / ma / mb
    Ua = torch.sum(grid_m, dim=-1) / ma
    Ub = torch.sum(target_density, dim=-1) / mb
    return I / (Ua + Ub - I)


def loss_and_components(scene: SceneSpec, loss_state: LossState,
                        state: SimState, grid_m) -> Dict[str, torch.Tensor]:
    """Total loss, its components and the IoU at `state`, whose grid mass is
    `grid_m` (G^3,) (reference compute_loss_kernel, loss.py:186-208); each
    of shape (B,) for B envs' states and grid_m (B, G^3)."""
    ls = scene.env.loss
    td = loss_state.target_density
    density_loss = torch.sum(torch.abs(grid_m - td), dim=-1)
    sdf_loss = torch.sum(loss_state.target_sdf * grid_m, dim=-1)
    dists = contact_distances(scene, state)
    contact_loss = (sum(d * d for d in dists) if dists
                    else state.x.new_zeros(state.x.shape[:-2]))
    total = (ls.weight_contact * contact_loss
             + ls.weight_density * density_loss
             + ls.weight_sdf * sdf_loss)
    return {
        "loss": total,
        "contact_loss": contact_loss,
        "density_loss": density_loss,
        "sdf_loss": sdf_loss,
        "iou": iou(grid_m, td),
    }
