"""Quadratic B-spline stencil of the particle<->grid transfers, full grid.

Counterpart of `plasticinelab_tpu/engine/transfer.py:axis_weights` with the
crop edge D equal to the grid edge G and the crop offset 0: that is the same
math as the TPU package's cropped transfers, with none of its TPU-only
machinery (crop, locality windows, Khatri-Rao matmuls). The plain transfers
(`cuda_transfer.p2g_plain`, `grid_mass_plain`, `g2p_plain`) scatter and
gather through this stencil; the CUDA kernels compute it per thread.

`cell_order` is the order in which the scatter kernels walk the particles:
each env's particles sorted by the key of their base cell, so that the
particles of one block are neighbours on the grid
(`plasticinelab_tpu/engine/local_transfer.py:sort_keys` and the sort of
`mpm.py:545-546`, `:748-752`; here the state is not permuted, the kernels
read particle order[t]).

Grids are cell-major and flattened x-major: cell (i, j, k) is row
(i * G + j) * G + k of a (G^3, channels) tensor.
"""
from __future__ import annotations

import torch

from ..config.spec import SceneSpec
from ..utils.profiling import span

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


def cell_keys(scene: SceneSpec, x: torch.Tensor) -> torch.Tensor:
    """x-major raster key (i * G + j) * G + k of each particle's base cell,
    the stencil's clamped one: x (..., 3) -> (...) int32. Equal to the
    reference package's `sort_keys` wherever the base cell needs no clamp
    at the upper wall (it clamps to G-1 for the sort alone, the stencil to
    G-3)."""
    sim = scene.simulator
    G = sim.n_grid
    base = torch.clamp(torch.floor(x * sim.inv_dx - 0.5).to(torch.int32), 0, G - 3)
    return (base[..., 0] * G + base[..., 1]) * G + base[..., 2]


def cell_order(scene: SceneSpec, x: torch.Tensor) -> torch.Tensor:
    """The stable argsort of each env's cell keys: x (n, 3) -> (n,) int32, x
    (B, n, 3) -> (B, n), row b a permutation of env b's particles. No
    gradient flows through it. The transfers take it as `order`; they give
    the same sums for any permutation, so an order computed from earlier
    positions stays valid and only costs the kernels time."""
    with span("plb.physics.cell_order"), torch.no_grad():
        return torch.argsort(cell_keys(scene, x), dim=-1, stable=True).to(torch.int32)
