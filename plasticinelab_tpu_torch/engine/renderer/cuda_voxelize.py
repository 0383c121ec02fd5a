"""Voxelizer: plain PyTorch version and the CUDA kernel K9, for B envs.

Replaces the TPU kernel K9, `plasticinelab_tpu/engine/renderer/
pallas_voxelize.py` `_kernel` (:69), reached through `voxelize_packed`
(:124) from `Renderer._packed_volume` (`renderer.py:430-437`), and its
vmapped form, which the TPU package's batched rgb rollout runs
(`parallel/rollout.py:148`). Both compute the reference's bit-packed particle
volume (plb build_sdf_from_particles): for every voxel, the min over nearby
particles of `(q << 24) + colour`, q = clamp(255 * dist_scale * |voxel -
p|, 0, 255) truncated, colour a 24-bit RGB, 0xFFFFFFFF where no particle
reaches.

The plain version is `Renderer._scatter_packed` (`renderer.py:439-491`), the
path the reference package takes off the TPU: a loop over chunks of the
offset table, `scatter_reduce_(..., "amin")` on int64 packed values, each
env's cells at `b * prod(res)`. `csrc/voxelize.cu` fills the volume and
scatters in one launch for all B envs; a launch with the particles to fill
the card first sorts them by coarse cell and takes each chunk's min in shared
memory (`launch_shape`). Min is order-independent, so kernel and plain
version agree bit for bit, and per env with a B = 1 launch. Like the scatter
path, cells whose only contributors are saturated take a tint
(docs/PARITY.md deviation 8); their sdf byte is 255 and the march never
shades them.

Both return the volume as int32 holding the uint32 bit pattern (-1 where
empty), (prod(res),) for particles (n, 3) and (B, prod(res)) for (B, n, 3):
torch's uint32 has no scatter-min on CUDA, and the renderer unpacks bytes
with shifts and masks, which int32 serves.

The wrapper takes the plain version only for a CPU tensor; for a CUDA
tensor it launches the kernel (float32 positions, int32 colours,
contiguous) or raises. `launches` (the counter group `cuda_voxelize`)
counts kernel launches: a launch on particles (B, n, 3) (B = 1 too) counts
under `voxelize_batched`. A launch runs in a `plb.kernel.voxelize` span.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ...utils.profiling import counter_group, span
from .. import cuda_build as cb

launches = counter_group("cuda_voxelize", ("voxelize", "voxelize_batched"))

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


def _updates(pb, color, res: Tuple[int, int, int], table, dist_scale: float):
    """The updates of B envs' particles pb (B, n, 3) over the offsets table
    (c, 3): (flat (B, n, c) int64 cell index into the (B * prod(res),)
    volume, env b's cells from b * prod(res); packed (B, n, c) int64 values;
    ok (B, n, c) whether the cell lies in the volume)."""
    rx, ry, rz = res
    idx = pb.to(torch.int32)[:, :, None, :] + table[None, None]  # (B, n, c, 3)
    ok = ((idx >= 0) & (idx < torch.tensor(res, dtype=torch.int32, device=pb.device))).all(-1)
    diff = (idx.to(torch.float32) - pb[:, :, None, :]).double()
    dist = torch.sqrt(_fma_squares(diff[..., 0], diff[..., 1], diff[..., 2]))
    q = torch.clamp(dist * (255.0 * dist_scale), 0.0, 255.0).to(torch.int64)
    packed = (q << 24) + color.to(torch.int64)[None, :, None]
    env = torch.arange(pb.shape[0], device=pb.device)[:, None, None] * (rx * ry * rz)
    flat = (idx[..., 0].to(torch.int64) * ry + idx[..., 1]) * rz + idx[..., 2] + env
    return flat, packed, ok


def scatter_inputs(p, color, res: Tuple[int, int, int], bake_size: int, dist_scale: float):
    """The plain version's updates that land in the volume, over the whole
    offset table: (flat, packed) int64 1-D, for one
    `scatter_reduce_(0, flat, packed, "amin")` into the (B * prod(res),)
    int64 volume (p (n, 3) or (B, n, 3))."""
    pb = p if p.dim() == 3 else p[None]
    table = torch.as_tensor(offsets(bake_size, dist_scale), device=p.device)
    flat, packed, ok = _updates(pb, color, tuple(res), table, dist_scale)
    return flat[ok], packed[ok]


def voxelize_plain(p, color, res: Tuple[int, int, int], bake_size: int, dist_scale: float):
    """p (n, 3) or (B, n, 3) float32 positions in voxel units, color (n,)
    int -> packed volume (prod(res),) or (B, prod(res)) int32 (the uint32
    bits)."""
    pb = p if p.dim() == 3 else p[None]
    B, cells = pb.shape[0], int(np.prod(res))
    vol = torch.full((B * cells,), 0xFFFFFFFF, dtype=torch.int64, device=p.device)
    table = torch.as_tensor(offsets(bake_size, dist_scale), device=p.device)
    for start in range(0, table.shape[0], CHUNK):
        flat, packed, ok = _updates(pb, color, res, table[start:start + CHUNK],
                                    dist_scale)
        vol.scatter_reduce_(0, flat[ok], packed[ok], reduce="amin", include_self=True)
    vol = _to_int32_bits(vol).reshape(B, cells)
    return vol if p.dim() == 3 else vol[0]


COARSE_BITS = 4  # the sort's coarse cells: fewer than 2^4 an axis (`voxel_bin_kernel`)
SORTED_CHUNK = 256  # particles a block takes of the sorted order
DIRECT_CHUNK = 8    # ... of the particles as they lie: one a warp


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch_shape(res, n: int, B: int, sms: int) -> Tuple[bool, int, int]:
    """(sort, shift, chunk) of a launch. B n particles that fill the card
    with two sorted chunks an SM are sorted by coarse cell (cell >> shift,
    the fewest bits that leave under 2^COARSE_BITS a side) and privatise
    each chunk's box; fewer go to the volume as they lie."""
    shift = 0
    while max(int(r) - 1 for r in res) >> shift >= 1 << COARSE_BITS:
        shift += 1
    sort = B * n >= 2 * sms * SORTED_CHUNK
    return sort, shift, SORTED_CHUNK if sort else DIRECT_CHUNK


def _launch(p, color, res, bake_size: int, dist_scale: float):
    with span("plb.kernel.voxelize"):
        cb.require_kernel_input(p, "p")
        if color.dtype != torch.int32 or not color.is_contiguous():
            raise TypeError("color: the kernel takes contiguous int32")
        pb = p if p.dim() == 3 else p[None]
        B, n = pb.shape[:2]
        rx, ry, rz = res
        table = _device_offsets(bake_size, dist_scale, p.device)
        offs = offsets(bake_size, dist_scale)
        sort, shift, chunk = launch_shape(res, n, B, _sms(p.device))
        ordered = torch.empty((B, n, 4) if sort else (0,), dtype=torch.float32, device=p.device)
        count = torch.empty((B,), dtype=torch.int32, device=p.device)
        vol = torch.empty((B, rx * ry * rz), dtype=torch.int32, device=p.device)
        err = cb.library().plb_voxelize(
            pb.data_ptr(), color.data_ptr(), table.data_ptr(), ordered.data_ptr(),
            count.data_ptr(), vol.data_ptr(), n, B, table.shape[0], rx, ry, rz,
            int(offs.min()), int(offs.max()), int(sort), shift, chunk, 255.0 * dist_scale,
            p.device.index, cb.stream_of(p))
        cb.check(err, "voxelize")
        launches[cb.launch_key("voxelize", p)] += 1
        return vol if p.dim() == 3 else vol[0]


def voxelize(p, color, res: Tuple[int, int, int], bake_size: int, dist_scale: float):
    """p (n, 3) or (B, n, 3) float32 positions in voxel units, color (n,)
    int32 shared by the envs -> packed volume (prod(res),) or
    (B, prod(res)) int32; the K9 kernel on CUDA, the plain version on the
    CPU."""
    if p.dim() not in (2, 3) or p.shape[-1] != 3:
        raise ValueError(f"p: expected shape (n, 3) or (B, n, 3), got {tuple(p.shape)}")
    cb.require(color, "color", (p.shape[-2],), p.device)
    res = tuple(int(r) for r in res)
    if p.device.type == "cpu":
        return voxelize_plain(p, color, res, bake_size, dist_scale)
    return _launch(p, color, res, bake_size, dist_scale)
