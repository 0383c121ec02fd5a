"""Voxelizer: plain PyTorch version and the CUDA kernel K9.

Replaces the TPU kernel K9, `plasticinelab_tpu/engine/renderer/
pallas_voxelize.py` `_kernel` (:69), reached through `voxelize_packed`
(:124) from `Renderer._packed_volume` (`renderer.py:430-437`). Both compute
the reference's bit-packed particle volume (plb build_sdf_from_particles):
for every voxel, the min over nearby particles of
`(q << 24) + colour`, q = clamp(255 * dist_scale * |voxel - p|, 0, 255)
truncated, colour a 24-bit RGB, 0xFFFFFFFF where no particle reaches.

The plain version is `Renderer._scatter_packed` (`renderer.py:439-491`), the
path the reference package takes off the TPU: a loop over chunks of the
offset table, `scatter_reduce_(..., "amin")` on int64 packed values.
`csrc/voxelize.cu` is the same scatter with one thread per (particle,
offset) and `atomicMin` on the volume as unsigned int, which lies in L2
whole; min is order-independent, so kernel and plain version agree bit for
bit. Like the scatter path, cells whose only contributors are saturated
take a tint (docs/PARITY.md deviation 8); their sdf byte is 255 and the
march never shades them.

Both return the volume as (rx * ry * rz,) int32 holding the uint32 bit
pattern (-1 where empty): torch's uint32 has no scatter-min on CUDA, and
the renderer unpacks bytes with shifts and masks, which int32 serves.

The wrapper takes the plain version only for a CPU tensor; for a CUDA
tensor it launches the kernel (float32 positions, int32 colours,
contiguous) or raises. `launches` counts kernel launches.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from .. import cuda_build as cb

launches = {"voxelize": 0}

CHUNK = 128  # offsets per step of the plain version


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@functools.lru_cache(maxsize=None)
def offsets(bake_size: int, dist_scale: float) -> np.ndarray:
    """(m, 3) int32 voxel offsets around a particle's cell: the reference's
    ndrange(-bake_size - 1, bake_size + 1)^3, culled to those within the
    saturation radius 1 / dist_scale of the unit cube. A particle lies at
    coord + r, r in [0, 1)^3, so any write beyond that radius is 255 << 24
    and cannot change the sdf (`renderer.py:452-461`)."""
    r = range(-bake_size - 1, bake_size + 1)
    offs = np.array([(i, j, k) for i in r for j in r for k in r], np.int32)
    cube_d = np.linalg.norm(offs - np.clip(offs, 0.0, 1.0), axis=1)
    return offs[cube_d <= 1.0 / dist_scale]


@functools.lru_cache(maxsize=None)
def _device_offsets(bake_size: int, dist_scale: float, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(offsets(bake_size, dist_scale), device=device).contiguous()


def _to_int32_bits(vol: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same bits."""
    return torch.where(vol >= 2 ** 31, vol - 2 ** 32, vol).to(torch.int32)


def _fma_squares(dx, dy, dz):
    """fma(dz, dz, fma(dy, dy, dx * dx)) in float32, from float64 inputs that
    hold float32 values: the square of a float32 is exact in float64, so each
    fused step is one float64 add rounded to float32. This is the order in
    which the reference package's norm runs on the CPU."""
    s = (dx * dx).float().double()
    s = (dy * dy + s).float().double()
    return (dz * dz + s).float()


def voxelize_plain(p, color, res: Tuple[int, int, int], bake_size: int, dist_scale: float):
    """p (n, 3) float32 positions in voxel units, color (n,) int -> packed
    volume (prod(res),) int32 (the uint32 bits)."""
    rx, ry, rz = res
    vol = torch.full((rx * ry * rz,), 0xFFFFFFFF, dtype=torch.int64, device=p.device)
    coord = p.to(torch.int32)
    col = color.to(torch.int64)[:, None]
    rbound = torch.tensor(res, dtype=torch.int32, device=p.device)
    table = torch.as_tensor(offsets(bake_size, dist_scale), device=p.device)
    scale = 255.0 * dist_scale
    for start in range(0, table.shape[0], CHUNK):
        idx = coord[:, None, :] + table[None, start:start + CHUNK, :]  # (n, c, 3)
        ok = ((idx >= 0) & (idx < rbound)).all(dim=-1)
        diff = (idx.to(torch.float32) - p[:, None, :]).double()
        dist = torch.sqrt(_fma_squares(diff[..., 0], diff[..., 1], diff[..., 2]))
        q = torch.clamp(dist * scale, 0.0, 255.0).to(torch.int64)
        packed = (q << 24) + col
        flat = (idx[..., 0].to(torch.int64) * ry + idx[..., 1]) * rz + idx[..., 2]
        vol.scatter_reduce_(0, flat[ok], packed[ok], reduce="amin", include_self=True)
    return _to_int32_bits(vol)


def _launch(p, color, res, bake_size: int, dist_scale: float):
    cb.require_kernel_input(p, "p")
    if color.dtype != torch.int32 or not color.is_contiguous():
        raise TypeError("color: the kernel takes contiguous int32")
    rx, ry, rz = res
    table = _device_offsets(bake_size, dist_scale, p.device)
    vol = torch.full((rx * ry * rz,), -1, dtype=torch.int32, device=p.device)
    err = cb.library().plb_voxelize(
        p.data_ptr(), color.data_ptr(), table.data_ptr(), vol.data_ptr(), p.shape[0],
        table.shape[0], rx, ry, rz, 255.0 * dist_scale, p.device.index, cb.stream_of(p))
    cb.check(err, "voxelize")
    launches["voxelize"] += 1
    return vol


def voxelize(p, color, res: Tuple[int, int, int], bake_size: int, dist_scale: float):
    """-> packed volume (prod(res),) int32; the K9 kernel on CUDA, the plain
    version on the CPU."""
    n = p.shape[0]
    cb.require(p, "p", (n, 3), p.device)
    cb.require(color, "color", (n,), p.device)
    res = tuple(int(r) for r in res)
    if p.device.type == "cpu":
        return voxelize_plain(p, color, res, bake_size, dist_scale)
    return _launch(p, color, res, bake_size, dist_scale)
