"""Quadratic B-spline stencil of the particle<->grid transfers, full grid.

Counterpart of `plasticinelab_tpu/engine/transfer.py:axis_weights` with the
crop edge D equal to the grid edge G and the crop offset 0: that is the same
math as the TPU package's cropped transfers, with none of its TPU-only
machinery (crop, locality windows, Khatri-Rao matmuls). The plain transfers
(`cuda_transfer.p2g_plain`, `grid_mass_plain`, `g2p_plain`) scatter and
gather through this stencil; the CUDA kernels compute it per thread.

Grids are cell-major and flattened x-major: cell (i, j, k) is row
(i * G + j) * G + k of a (G^3, channels) tensor.
"""
from __future__ import annotations

import torch

from ..config.spec import SceneSpec

_TAPS = [(a, b, c) for a in range(3) for b in range(3) for c in range(3)]


def stencil(scene: SceneSpec, x: torch.Tensor):
    """27-cell stencil of each particle -> (idx (n, 27) int64 flat cell
    index, W (n, 27) weight, dpos (n, 27, 3) cell - x in grid units).

    The base cell is floor(x * inv_dx - 0.5) clamped to [0, G-3]; the
    weights come from the unclamped fraction (reference p2g :160-163,
    `transfer.axis_weights` with D = G)."""
    sim = scene.simulator
    G = sim.n_grid
    px = x * sim.inv_dx
    base = torch.floor(px - 0.5)
    fx = px - base
    w = torch.stack(
        [0.5 * (1.5 - fx) ** 2, 0.75 - (fx - 1.0) ** 2, 0.5 * (fx - 0.5) ** 2],
        dim=1,
    )  # (n, 3 taps, 3 axes)
    taps = torch.tensor(_TAPS, device=x.device)  # (27, 3)
    cells = torch.clamp(base.long(), 0, G - 3)[:, None, :] + taps[None]
    W = w[:, taps[:, 0], 0] * w[:, taps[:, 1], 1] * w[:, taps[:, 2], 2]
    idx = (cells[..., 0] * G + cells[..., 1]) * G + cells[..., 2]
    dpos = cells.to(x.dtype) - px[:, None, :]
    return idx, W, dpos
