"""Grid update: plain PyTorch version and the CUDA kernels.

Replaces the TPU kernel K8, `plasticinelab_tpu/engine/pallas_gridop.py`:
its forward `_fwd_kernel` (:82), which runs
`plasticinelab_tpu/engine/mpm.py:grid_op_core` (:193-255) per cell, and its
backward `_bwd_kernel` (:97), the reference's autodiff of that core run
inside the kernel, here an adjoint written by hand (`GridOp`). The
plain version follows `mpm.py:grid_op` (:133-190) on the full grid (crop
offset 0): mass normalise, gravity x 30, per-primitive SDF collision with
friction and softness at poses f and f+1, walls with bound 3, ground
friction with the reference's 1e-30 tie-breakers, and the velocity clamp.

On the H100 both directions are bound by bytes: the forward reads 16 B
and writes 12 B per cell (262,144 cells at 64^3), the backward reads 16 B
(and the 12-byte cotangent of a cell with mass) and writes 16 B, all dense;
the arithmetic of the SDF, normal and contact response runs only in the
~1% of cells with mass (Move-v1) and, within them, only where a primitive
touches. `csrc/gridop.cu` launches a 2-D grid of blocks of one env's
consecutive cells: a warp without mass loads its rows as 16-byte loads,
votes, and writes zeros as 16-byte stores. The primitives come in as a
small table passed by value (shape id and parameters) and a (k, 16) device
tensor of the poses at f and f+1, staged per block with each rotation's
renormalised conjugate.

The backward recomputes each cell's forward and runs it backwards; the
SDF and normal Jacobians of the 7 shapes come from the same shape code on a
dual number, evaluated only where the float SDF says the cell is in
contact. It returns d grid4 (G^3, 4) and the pose cotangents (k, 16) in
the layout of `pack_poses`, which autograd routes back into pose_f and
pose_f1 and on through the forward kinematics to the actions. The pose
cotangents are summed in the same launch, deterministically and without
contended atomics: per primitive a shuffle tree over each warp's cells,
the warps of a block in order, then the env's last block to finish sums
the blocks' rows in block order. The partition of an env's cells into
blocks depends on G alone (`BWD_BLOCK_CELLS` cells each), so each env's
result is bit for bit what a B = 1 launch gives, whichever block ends
last. The rows and the per-env flags and counter (`_bwd_scratch`) are
allocated once per device, B, scene size and stream and reused: the
kernel leaves the flags and counters zero, and launches that share them
run on one stream, one after the other.

Both kernels take a batch of envs, a (B, G^3, 4) grid, each env with its
own (k, 16) poses and its own softness from a (B,) device tensor (one env:
a cached (1,) tensor). So they also replace the batched grids of K8
(`pallas_gridop.py:205` `grid_op_fns_batched`, forward `:234`, backward
`:247`): `grid_op_batched` launches them over B envs, `grid_op` with B = 1,
through the same autograd Function `GridOp`, which returns no gradient for
softness. A launch over a leading B counts under `<name>_batched`,
whatever B.

The wrapper takes the plain version only for a CPU tensor; for a CUDA
tensor it launches the kernel (float32, contiguous) or raises, and so does
the backward. `launches` (the counter group `cuda_gridop`) counts kernel
launches; each launch runs in a `plb.kernel.<name>` span. `templates` (the
group `cuda_gridop_template`) counts the same launches, forward and
backward, by the kernels' instantiation: `spheres` for a scene of Spheres
alone, `all_shapes` for any other (`template_of`).
"""
from __future__ import annotations

import functools

import torch

from ..config.spec import SceneSpec
from ..utils.profiling import counter_group, span
from . import cuda_build as cb
from . import primitives as prim

launches = counter_group("cuda_gridop", ("grid_op", "grid_op_bwd", "grid_op_batched",
                                         "grid_op_bwd_batched"))
templates = counter_group("cuda_gridop_template", ("spheres", "all_shapes"))

# csrc/gridop.cu kBwdTiles x kThreads: an env's cells per block of the
# backward, which sizes its scratch
BWD_BLOCK_CELLS = 8 * cb.THREADS
POSE_COMPONENTS = 19  # csrc/gridop.cu kPG: a cell's pose cotangent terms per primitive

SHAPE_IDS = {"Sphere": 0, "Capsule": 1, "RollingPin": 1, "Chopsticks": 2,
             "Cylinder": 3, "Torus": 4, "Box": 5}


def reset_launches() -> None:
    for group in (launches, templates):
        for k in group:
            group[k] = 0


def template_of(scene: SceneSpec) -> str:
    """The instantiation of the grid kernels that a launch on `scene` takes,
    as `all_spheres` (csrc/gridop.cu) picks it: "spheres" where every
    primitive is a Sphere (no primitive too), else "all_shapes"."""
    sphere = SHAPE_IDS["Sphere"]
    return ("spheres" if all(SHAPE_IDS[p.shape] == sphere for p in scene.primitives)
            else "all_shapes")


def grid_coords(G: int, device) -> torch.Tensor:
    """(G^3, 3) int64 cell coordinates, x-major like the flat grids."""
    r = torch.arange(G, device=device)
    return torch.stack(torch.meshgrid(r, r, r, indexing="ij"), dim=-1).reshape(-1, 3)


def grid_op_plain(scene: SceneSpec, grid4, pose_f, pose_f1, softness):
    """grid4 (G^3, 4) [mom x, y, z, mass] -> grid velocities (G^3, 3)
    (reference grid_op :189-221). pose_f / pose_f1: (pos (k,3), rot (k,4),
    gap (k,)) at the substep's start and end."""
    sim = scene.simulator
    G, dt, dtype = sim.n_grid, sim.dt, grid4.dtype
    grid_m = grid4[:, 3]
    mask = grid_m > 1e-12
    v = grid4[:, :3] / torch.where(mask, grid_m, torch.ones_like(grid_m))[:, None]
    v = v + dt * torch.tensor(sim.gravity, dtype=dtype, device=grid4.device) * 30.0

    coords = grid_coords(G, grid4.device)
    coord_f = coords.to(dtype)
    grid_pos = coord_f * sim.dx
    pos_f, rot_f, gap_f = pose_f
    pos_f1, rot_f1, _ = pose_f1
    for i, p in enumerate(scene.primitives):
        v = prim.collide(p, pos_f[i], rot_f[i], gap_f[i], pos_f1[i], rot_f1[i],
                         p.friction, softness, grid_pos, v, dt)

    bound = 3
    gf = sim.ground_friction
    v = v.clone()
    for d in range(3):
        cd = coords[:, d]
        low = (cd < bound) & (v[:, d] < 0)
        if d != 1 or gf == 0:
            v[:, d] = torch.where(low, torch.zeros_like(v[:, d]), v[:, d])
        elif gf < 10:
            # Coulomb-like ground friction (reference :206-215), with its
            # 1e-30 tie-breakers (normal floats in f32)
            lin = v[:, 1] + 1e-30
            e_y = torch.tensor([0.0, 1.0, 0.0], dtype=dtype, device=v.device)
            vit = v - lin[:, None] * e_y - coord_f * 1e-30
            lit = torch.sqrt(torch.sum(vit * vit, dim=-1) + 1e-8)
            scale = torch.clamp(1.0 + gf * lin / lit, min=0.0)
            fric_v = scale[:, None] * (vit + coord_f * 1e-30)
            fric_v[:, 1] = 0.0
            v = torch.where(low[:, None], fric_v, v)
        else:
            v = torch.where(low[:, None], torch.zeros_like(v), v)
        high = (cd > G - bound) & (v[:, d] > 0)
        v[:, d] = torch.where(high, torch.zeros_like(v[:, d]), v[:, d])

    if sim.grid_v_clamp > 0:
        vmax = sim.grid_v_clamp * sim.dx / sim.dt
        v = torch.clamp(v, -vmax, vmax)
    # cells with no mass keep zero velocity (reference only writes masked cells)
    return torch.where(mask[:, None], v, torch.zeros_like(v))


def grid_op_plain_batched(scene: SceneSpec, grid4, pose_f, pose_f1, softness):
    """`grid_op_plain` of B envs: grid4 (B, G^3, 4), poses with a leading B,
    softness (B,) -> (B, G^3, 3), env by env; differentiable in grid4 and the
    poses of every env."""
    return torch.stack([
        grid_op_plain(scene, grid4[b], tuple(t[b] for t in pose_f),
                      tuple(t[b] for t in pose_f1), softness[b])
        for b in range(grid4.shape[0])])


@functools.lru_cache(maxsize=None)
def prim_table(primitives) -> cb.PrimTable:
    """Static parameters of a scene's primitives, in csrc/gridop.cu order."""
    if len(primitives) > cb.MAX_PRIMS:
        raise ValueError(f"the grid kernel takes at most {cb.MAX_PRIMS} primitives")
    t = cb.PrimTable()
    t.k = len(primitives)
    for i, p in enumerate(primitives):
        t.shape[i] = SHAPE_IDS[p.shape]
        vals = (p.friction, p.radius, p.h, p.r, p.tx, p.ty, *p.size, p.minimal_gap)
        for j, val in enumerate(vals):
            t.param[i][j] = val
    return t


def pack_poses(pose_f, pose_f1) -> torch.Tensor:
    """(k, 16) rows [pos_f 3, rot_f 4, gap_f, pos_f1 3, rot_f1 4, gap_f1]
    (the layout of `pallas_gridop._unpack_poses`, gaps inlined); (B, k, 16)
    for poses with a leading B."""
    (p0, r0, g0), (p1, r1, g1) = pose_f, pose_f1
    return torch.cat([p0, r0, g0[..., None], p1, r1, g1[..., None]], dim=-1)


def _consts(scene: SceneSpec):
    """Scalar arguments after the table that all envs share: G, dx, dt,
    gravity x 30 dt (3), ground friction, velocity clamp (0 = none)."""
    sim = scene.simulator
    g30 = [sim.dt * g * 30.0 for g in sim.gravity]
    vmax = sim.grid_v_clamp * sim.dx / sim.dt if sim.grid_v_clamp > 0 else 0.0
    return (sim.n_grid, sim.dx, sim.dt, *g30, sim.ground_friction, vmax)


@functools.lru_cache(maxsize=None)
def _softness_tensor(value: float, device: torch.device) -> torch.Tensor:
    """The (1,) softness of one env on the device, made once per value."""
    return torch.full((1,), value, dtype=torch.float32, device=device)


def _check_packed(scene: SceneSpec, grid4, poses, lead=()):
    G, k = scene.simulator.n_grid, len(scene.primitives)
    cb.require(grid4, "grid4", lead + (G ** 3, 4), grid4.device)
    cb.require(poses, "poses", lead + (k, 16), grid4.device)
    cb.require_kernel_input(grid4, "grid4")
    cb.require_kernel_input(poses, "poses")


def bwd_blocks(G: int) -> int:
    """Blocks of one env in the backward launch: ceil(G^3 / BWD_BLOCK_CELLS)."""
    return -(-G ** 3 // BWD_BLOCK_CELLS)


_scratch: dict = {}


def _bwd_scratch(device, B: int, G: int, k: int, stream: int):
    """(partials (B, nblocks, k, 19) float32, done (B, nblocks + 1) int32
    zeros) for the backward launch, made once per (device, B, G, k,
    stream): the blocks' pose rows, then per env a flag per block (it wrote
    a row) and the counter of finished blocks, which the kernel leaves
    zero. Launches on one stream run one after the other; launches on two
    streams could overlap, so each stream has its own."""
    key = (str(device), B, G, k, stream)
    if key not in _scratch:
        nblocks = bwd_blocks(G)
        _scratch[key] = (
            torch.empty((B, nblocks, k, POSE_COMPONENTS), device=device, dtype=torch.float32),
            torch.zeros((B, nblocks + 1), device=device, dtype=torch.int32))
    return _scratch[key]


def _check_launch(scene: SceneSpec, grid4, poses, softness) -> int:
    """Checks one env's (grid4 (G^3, 4), poses (k, 16), softness (1,)) or B
    envs' (grid4 (B, G^3, 4), poses (B, k, 16), softness (B,)) kernel
    inputs; -> B."""
    if grid4.dim() not in (2, 3):
        raise ValueError(f"grid4: expected (G^3, 4) or (B, G^3, 4), got {tuple(grid4.shape)}")
    lead = tuple(grid4.shape[:-2])
    B = lead[0] if lead else 1
    _check_packed(scene, grid4, poses, lead)
    cb.require(softness, "softness", (B,), grid4.device)
    cb.require_kernel_input(softness, "softness")
    if grid4.data_ptr() % 16:
        raise ValueError("grid4: the kernels read each cell as one 16-byte load; "
                         "it must start on 16 bytes")
    return B


def _launch_fwd(scene: SceneSpec, grid4, poses, softness):
    """K8 forward over one env or B envs (`_check_launch`)."""
    with span("plb.kernel.grid_op"):
        B = _check_launch(scene, grid4, poses, softness)
        out = torch.empty(grid4.shape[:-1] + (3,), device=grid4.device, dtype=torch.float32)
        err = cb.library().plb_grid_op(
            grid4.data_ptr(), poses.data_ptr(), softness.data_ptr(), out.data_ptr(),
            prim_table(scene.primitives), B, *_consts(scene), grid4.device.index,
            cb.stream_of(grid4))
        name = cb.launch_key("grid_op", grid4)
        cb.check(err, name)
        launches[name] += 1
        templates[template_of(scene)] += 1
        return out


def grid_op_bwd(scene: SceneSpec, grid4, poses, softness, ct):
    """The K8 backward kernel: grid velocity cotangent (G^3, 3) -> (d grid4
    (G^3, 4), d poses (k, 16)), the VJP of `grid_op_plain` through
    `pack_poses`; with a leading B on every tensor, of
    `grid_op_plain_batched`, in one launch. softness: a (B,) tensor on the
    device ((1,) for one env, or then a number). CUDA tensors only."""
    with span("plb.kernel.grid_op_bwd"):
        if not torch.is_tensor(softness):
            softness = _softness_tensor(float(softness), grid4.device)
        B = _check_launch(scene, grid4, poses, softness)
        cb.require(ct, "ct", grid4.shape[:-1] + (3,), grid4.device)
        cb.require_kernel_input(ct, "ct")
        stream = cb.stream_of(grid4)
        partials, done = _bwd_scratch(grid4.device, B, scene.simulator.n_grid,
                                      len(scene.primitives), stream)
        dgrid4 = torch.empty_like(grid4)
        dposes = torch.empty_like(poses)
        err = cb.library().plb_grid_op_bwd(
            grid4.data_ptr(), poses.data_ptr(), softness.data_ptr(), ct.data_ptr(),
            dgrid4.data_ptr(), dposes.data_ptr(), partials.data_ptr(), done.data_ptr(),
            prim_table(scene.primitives), B, *_consts(scene), grid4.device.index, stream)
        name = cb.launch_key("grid_op_bwd", grid4)
        cb.check(err, name)
        launches[name] += 1
        templates[template_of(scene)] += 1
        return dgrid4, dposes


class GridOp(torch.autograd.Function):
    """(grid4, poses, softness (B,)) -> grid_v: forward K8, backward K8-bwd
    (saves all three); one env (grid4 (G^3, 4), poses (k, 16), softness
    (1,)) or B envs. No gradient for softness."""

    @staticmethod
    def forward(ctx, grid4, poses, softness, scene):
        ctx.scene = scene
        ctx.save_for_backward(grid4, poses, softness)
        return _launch_fwd(scene, grid4, poses, softness)

    @staticmethod
    def backward(ctx, ct):
        grid4, poses, softness = ctx.saved_tensors
        dgrid4, dposes = grid_op_bwd(ctx.scene, grid4, poses, softness, ct.contiguous())
        return dgrid4, dposes, None, None


def _check_poses(scene: SceneSpec, grid4, pose_f, pose_f1, lead=()):
    G, k = scene.simulator.n_grid, len(scene.primitives)
    cb.require(grid4, "grid4", lead + (G ** 3, 4), grid4.device)
    for pose in (pose_f, pose_f1):
        for t, name, shape in zip(pose, ("pos", "rot", "gap"), ((k, 3), (k, 4), (k,))):
            cb.require(t, name, lead + shape, grid4.device)


def grid_op(scene: SceneSpec, grid4, pose_f, pose_f1, softness: float):
    """-> grid_v (G^3, 3); the K8 kernel (backward K8-bwd) on CUDA, the plain
    version on the CPU."""
    _check_poses(scene, grid4, pose_f, pose_f1)
    if grid4.device.type == "cpu":
        return grid_op_plain(scene, grid4, pose_f, pose_f1, softness)
    return GridOp.apply(grid4, pack_poses(pose_f, pose_f1),
                        _softness_tensor(float(softness), grid4.device), scene)


def grid_op_batched(scene: SceneSpec, grid4, pose_f, pose_f1, softness):
    """grid4 (B, G^3, 4), poses (pos (B, k, 3), rot (B, k, 4), gap (B, k)) at
    f and f+1, softness (B,) -> grid_v (B, G^3, 3); the K8 kernels over B
    envs (forward, and backward K8-bwd) on CUDA, `grid_op_plain_batched` on
    the CPU."""
    B = grid4.shape[0]
    _check_poses(scene, grid4, pose_f, pose_f1, (B,))
    cb.require(softness, "softness", (B,), grid4.device)
    if grid4.device.type == "cpu":
        return grid_op_plain_batched(scene, grid4, pose_f, pose_f1, softness)
    return GridOp.apply(grid4, pack_poses(pose_f, pose_f1), softness, scene)
