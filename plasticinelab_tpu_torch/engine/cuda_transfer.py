"""Particle<->grid transfers: plain PyTorch versions and the CUDA kernels.

Replaces the TPU kernels
- K3 `plasticinelab_tpu/engine/pallas_local.py:_p2g_fwd_kernel` (:163),
- K7 forward `pallas_local.py:_mass_fwd_kernel` (:943), the mass-only P2G
  of the loss, here the `MASS_ONLY` instantiation of the same P2G kernel,
- K5 `pallas_local.py:_g2p_fwd_kernel` (:223), G2P with fused advection,
and their VJPs
- K4 `_p2g_bwd_kernel` (:288): the (G^3, 4) cotangent gathered over each
  particle's 27 cells -> dx, dv, daffine (`P2G`),
- K7 backward `_mass_bwd_kernel` (:970), d/dx of the mass-only P2G, the
  `MASS_ONLY` instantiation of the K4 kernel (`GridMass`),
- K6 `_g2p_bwd_kernel` (:388): d grid_v scattered with atomics, dx with the
  strict advection mask of :450-477 (`G2P`).

The TPU kernels contract per-axis weight matrices on the MXU inside a
cropped, cell-sorted window layout, because a TPU has no fast scatter. On
the H100 the natural form is the reference's own: one thread per particle,
27 stencil cells (`csrc/transfer.cu`).
- The scatters (P2G, the mass-only P2G, K6's d grid_v) are bound by the
  atomic unit of the L2, not by bytes or arithmetic: a cloud touches about
  one cell in a hundred, so a float atomicAdd per particle, cell and
  channel puts some hundred adds on each touched address. The kernels
  reduce on the SM first: they walk each env's particles in `order`, a
  permutation sorted by base cell (`transfer.cell_order`, computed once per
  env step by `mpm.env_step`), so that the lanes of a warp hold runs of
  particles of one base cell, which share all 27 cells; each run is found
  with a warp match and summed with shuffles, and one lane adds for it.
  A lane whose neighbours are in other cells adds alone, so the sums are
  the same for any permutation: a stale order, or none (the identity),
  costs time only. `lane_groups` counts the adds that remain. The state is
  never permuted. (A shared-memory tile per block under the groups, and
  16-byte vector atomics, were measured slower on this card: PERF.md.)
- Atomics sum in a run-dependent order, so P2G and everything downstream
  is not bitwise reproducible (the TPU transfers are). The tests bound the
  difference to the plain version instead.
- The gathers, G2P (K5) and the backward gathers (K4, K7 backward), read
  the grid or its cotangent under each particle's stencil with no atomics,
  in a fixed order per particle: the same bits for any B. They take no
  order: they walk the particles as they lie, because walking the cell
  order put each particle's rows at permuted addresses and measured
  1.4-2.4x slower on the H100 (K5, K4). They sum each plane of the stencil alone and the
  three at the end (shorter chains than one running sum), load 16 bytes at
  a time, and K5 stores its rows as slabs through shared memory when a
  launch has many particles (PERF.md).
- K6 scatters its grid cotangent like K3, through the order of its forward
  call, and gathers dx per particle. The dx terms run through the spline
  weight derivatives (chained by inv_dx) and through dpos = cell - x
  inv_dx.

Every kernel, forward and backward, takes a batch of envs (x (B, n, 3),
grids and their cotangents (B, G^3, C), order (B, n)), one thread per
particle of all envs, each scattering into or gathering from its own env's
grid. So they
also replace the batched grids of the same TPU kernels
(`pallas_local.py:725` `transfer_fns_batched`: K3-b `:767`, K4-b `:780`,
K5-b `:793`, K6-b `:805`; `:865` `mass_fns_batched`: K7-fwd-b `:892`,
K7-bwd-b `:904`): `p2g_batched`, `g2p_batched` and `grid_mass_batched`
launch them over B envs, `p2g`, `g2p` and `grid_mass` with B = 1, through
the same autograd Functions. A launch over a leading B counts under
`<name>_batched` (`p2g_bwd_batched`, ...), whatever B.

Each wrapper takes its plain version (differentiable through index_add_
and gather; it ignores `order`) only for a CPU tensor; for a CUDA tensor it
launches its kernel (float32, contiguous) or raises, and so do the
backwards. `launches` (the counter group `cuda_transfer`) counts kernel
launches per wrapper; each launch runs in a `plb.kernel.<wrapper>` span.
"""
from __future__ import annotations

import torch

from ..config.spec import SceneSpec
from ..utils.profiling import counter_group, span
from . import cuda_build as cb
from .transfer import cell_keys, stencil

WARP = 32  # lanes of a warp: consecutive entries of an env's order that may add as one

launches = counter_group("cuda_transfer", (
    "p2g", "grid_mass", "g2p", "p2g_bwd", "grid_mass_bwd", "g2p_bwd", "p2g_batched",
    "grid_mass_batched", "g2p_batched", "p2g_bwd_batched", "grid_mass_bwd_batched",
    "g2p_bwd_batched"))


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _batched_stencil(scene: SceneSpec, x):
    """Stencil of B envs' particles x (B, n, 3), flattened env-major to
    (B n, 27): idx points into the (B G^3)-row grid of all envs, whose env b
    starts at row b G^3."""
    B, n = x.shape[:2]
    idx, W, dpos = stencil(scene, x.reshape(B * n, 3))
    env_row = torch.arange(B, device=x.device).repeat_interleave(n) * scene.simulator.n_grid ** 3
    return idx + env_row[:, None], W, dpos


def p2g_plain_batched(scene: SceneSpec, x, v, affine, order=None):
    """APIC momentum + mass P2G of B envs, x and v (B, n, 3), affine (B, n,
    3, 3) -> (B, G^3, 4) [mom x, y, z, mass]: mom_s = sum_p W (p_mass v_s +
    dx affine_s . dpos), mass = sum_p W p_mass (reference p2g :157-184), one
    index_add_ into the flat (B G^3, 4) grid. `order` is the kernels' and
    does not change a sum: ignored here, as in every plain version."""
    sim = scene.simulator
    B, n = x.shape[:2]
    G3 = sim.n_grid ** 3
    idx, W, dpos = _batched_stencil(scene, x)
    mom = (sim.p_mass * v.reshape(B * n, 1, 3)
           + sim.dx * torch.einsum("nij,nkj->nki", affine.reshape(B * n, 3, 3), dpos))
    contrib = torch.cat([W[..., None] * mom, (W * sim.p_mass)[..., None]], dim=-1)
    grid = x.new_zeros((B * G3, 4)).index_add_(0, idx.reshape(-1), contrib.reshape(-1, 4))
    return grid.reshape(B, G3, 4)


def p2g_plain(scene: SceneSpec, x, v, affine, order=None):
    """`p2g_plain_batched` of one env: x, v (n, 3), affine (n, 3, 3) -> (G^3,
    4)."""
    return p2g_plain_batched(scene, x[None], v[None], affine[None])[0]


def grid_mass_plain_batched(scene: SceneSpec, x, order=None):
    """Mass-only P2G of B envs, x (B, n, 3) -> (B, G^3) (reference
    compute_grid_m_kernel :382-392)."""
    B = x.shape[0]
    G3 = scene.simulator.n_grid ** 3
    idx, W, _ = _batched_stencil(scene, x)
    grid = x.new_zeros((B * G3,))
    return grid.index_add_(0, idx.reshape(-1), (W * scene.simulator.p_mass).reshape(-1)).reshape(
        B, G3)


def grid_mass_plain(scene: SceneSpec, x, order=None):
    """`grid_mass_plain_batched` of one env: x (n, 3) -> (G^3,)."""
    return grid_mass_plain_batched(scene, x[None])[0]


def g2p_plain_batched(scene: SceneSpec, x, grid_v, order=None):
    """Velocity gather, APIC C and advection of B envs, x (B, n, 3), grid_v
    (B, G^3, 3) -> (new_v (B, n, 3), new_C (B, n, 3, 3), new_x (B, n, 3)):
    v = sum W g, C = 4 inv_dx sum W g dpos^T, x' = clip(x + dt v, 0, 1 - 3
    dx) (reference g2p :223-243, `mpm.py:351-353`), one gather from the
    flat (B G^3, 3) grid."""
    sim = scene.simulator
    B, n = x.shape[:2]
    idx, W, dpos = _batched_stencil(scene, x)
    x = x.reshape(B * n, 3)
    g = grid_v.reshape(-1, 3)[idx]  # (B n, 27, 3)
    new_v = torch.sum(W[..., None] * g, dim=1)
    new_C = (4.0 * sim.inv_dx) * torch.einsum("nj,njs,nja->nsa", W, g, dpos)
    # max(min(., hi), lo) as the reference (mpm.py:351-353): at a tie its
    # gradient splits in half, where torch.clamp would pass it whole
    hi, lo = x.new_tensor(1.0 - 3 * sim.dx), x.new_tensor(0.0)
    new_x = torch.maximum(torch.minimum(x + sim.dt * new_v, hi), lo)
    return new_v.reshape(B, n, 3), new_C.reshape(B, n, 3, 3), new_x.reshape(B, n, 3)


def g2p_plain(scene: SceneSpec, x, grid_v, order=None):
    """`g2p_plain_batched` of one env: x (n, 3), grid_v (G^3, 3) -> (new_v
    (n, 3), new_C (n, 3, 3), new_x (n, 3))."""
    return tuple(t[0] for t in g2p_plain_batched(scene, x[None], grid_v[None]))


def lane_groups(scene: SceneSpec, x, order=None):
    """The scatter kernels' grouping rule, in plain PyTorch: the number of
    lane groups that add to global memory when particles x (n, 3) or (B, n,
    3) are walked in `order` (None: as they lie) -> a 0-d or (B,) int64
    tensor. A warp takes `WARP` consecutive entries of one env's order (the
    blocks are whole warps and start at multiples of it); its entries of
    equal base cell form one group, wherever they stand in the warp
    (`csrc/transfer.cu` make_peers). Each group makes 27 x channels global
    adds, so groups / n is the share that remains of the adds of one thread
    per particle."""
    keys = cell_keys(scene, x if x.dim() == 3 else x[None]).long()
    B, n = keys.shape
    if order is not None:
        keys = torch.gather(keys, 1, order.reshape(B, n).long())
    warp = torch.arange(n, device=x.device) // WARP
    pairs = warp * scene.simulator.n_grid ** 3 + keys  # (B, n): one value per (warp, cell)
    counts = torch.tensor([torch.unique(row).numel() for row in pairs])
    return counts if x.dim() == 3 else counts[0]


# ---------------------------------------------------------------------------
# kernels and their autograd Functions
# ---------------------------------------------------------------------------

def _envs(x) -> tuple:
    """(B, n) of particles x (n, 3) (one env) or (B, n, 3)."""
    return (x.shape[0], x.shape[1]) if x.dim() == 3 else (1, x.shape[0])


def _check_particles(x, v, affine):
    """x, v (n, 3) and affine (n, 3, 3) of one env, or each with a leading B."""
    if x.dim() not in (2, 3):
        raise ValueError(f"x: expected (n, 3) or (B, n, 3), got {tuple(x.shape)}")
    lead = tuple(x.shape[:-1])
    for t, name, shape in ((x, "x", lead + (3,)), (v, "v", lead + (3,)),
                           (affine, "affine", lead + (3, 3))):
        cb.require(t, name, shape, x.device)


def _order_ptr(order, x) -> int:
    """The pointer a scatter kernel takes for `order`: 0 (the particles as
    they lie) for None, else that of an int32, contiguous tensor of x's
    leading shape on x's device, per env a permutation of range(n)."""
    if order is None:
        return 0
    cb.require(order, "order", x.shape[:-1], x.device)
    if order.dtype != torch.int32:
        raise TypeError(f"order: the kernel takes int32, got {order.dtype}")
    if not order.is_contiguous():
        raise ValueError("order: the kernel takes contiguous tensors")
    return order.data_ptr()


def _launch_p2g(scene: SceneSpec, x, v, affine, order=None):
    """K3 over x (n, 3) -> (G^3, 4), or over B envs x (B, n, 3) -> (B, G^3, 4)."""
    with span("plb.kernel.p2g"):
        for t, arg in ((x, "x"), (v, "v"), (affine, "affine")):
            cb.require_kernel_input(t, arg)
        sim = scene.simulator
        B, n = _envs(x)
        grid = torch.zeros(x.shape[:-2] + (sim.n_grid ** 3, 4), device=x.device,
                           dtype=torch.float32)
        err = cb.library().plb_p2g(
            x.data_ptr(), v.data_ptr(), affine.data_ptr(), _order_ptr(order, x), grid.data_ptr(),
            n, B, sim.n_grid, sim.inv_dx, sim.dx, sim.p_mass, x.device.index,
            cb.stream_of(x))
        name = cb.launch_key("p2g", x)
        cb.check(err, name)
        launches[name] += 1
        return grid


def p2g_bwd(scene: SceneSpec, x, v, affine, ct):
    """The K4 kernel: grid4 cotangent (G^3, 4) -> (dx (n, 3), dv (n, 3),
    daffine (n, 3, 3)), the VJP of `p2g_plain`; with a leading B on every
    tensor, of `p2g_plain_batched`, in one launch. CUDA tensors only."""
    with span("plb.kernel.p2g_bwd"):
        sim = scene.simulator
        B, n = _envs(x)
        _check_particles(x, v, affine)
        cb.require(ct, "ct", x.shape[:-2] + (sim.n_grid ** 3, 4), x.device)
        for t, arg in ((x, "x"), (v, "v"), (affine, "affine"), (ct, "ct")):
            cb.require_kernel_input(t, arg)
        if ct.data_ptr() % 16:
            raise ValueError("ct: the kernel reads its 16-byte cells whole, so it takes a 16-byte "
                             "aligned tensor")
        gx, gv, gaff = torch.empty_like(x), torch.empty_like(v), torch.empty_like(affine)
        err = cb.library().plb_p2g_bwd(
            x.data_ptr(), v.data_ptr(), affine.data_ptr(), ct.data_ptr(), gx.data_ptr(),
            gv.data_ptr(), gaff.data_ptr(), n, B, sim.n_grid, sim.inv_dx, sim.dx, sim.p_mass,
            x.device.index, cb.stream_of(x))
        name = cb.launch_key("p2g_bwd", x)
        cb.check(err, name)
        launches[name] += 1
        return gx, gv, gaff


class P2G(torch.autograd.Function):
    """(x, v, affine) -> grid4: forward K3 walking `order`, backward K4
    (saves x, v, affine; K4 takes no order); one env or B envs."""

    @staticmethod
    def forward(ctx, x, v, affine, order, scene):
        ctx.scene = scene
        ctx.save_for_backward(x, v, affine)
        return _launch_p2g(scene, x, v, affine, order)

    @staticmethod
    def backward(ctx, ct):
        x, v, affine = ctx.saved_tensors
        return (*p2g_bwd(ctx.scene, x, v, affine, ct.contiguous()), None, None)


def _launch_grid_mass(scene: SceneSpec, x, order=None):
    """K7 forward over x (n, 3) -> (G^3,), or over x (B, n, 3) -> (B, G^3)."""
    with span("plb.kernel.grid_mass"):
        cb.require_kernel_input(x, "x")
        sim = scene.simulator
        B, n = _envs(x)
        grid = torch.zeros(x.shape[:-2] + (sim.n_grid ** 3,), device=x.device, dtype=torch.float32)
        err = cb.library().plb_grid_mass(
            x.data_ptr(), _order_ptr(order, x), grid.data_ptr(), n, B, sim.n_grid, sim.inv_dx,
            sim.p_mass, x.device.index, cb.stream_of(x))
        name = cb.launch_key("grid_mass", x)
        cb.check(err, name)
        launches[name] += 1
        return grid


def grid_mass_bwd(scene: SceneSpec, x, ct):
    """The K7 backward kernel (the MASS_ONLY form of K4): grid mass
    cotangent (G^3,) -> dx (n, 3), or (B, G^3) -> (B, n, 3) in one launch.
    CUDA tensors only."""
    with span("plb.kernel.grid_mass_bwd"):
        sim = scene.simulator
        B, n = _envs(x)
        cb.require(x, "x", x.shape[:-1] + (3,), x.device)
        cb.require(ct, "ct", x.shape[:-2] + (sim.n_grid ** 3,), x.device)
        cb.require_kernel_input(x, "x")
        cb.require_kernel_input(ct, "ct")
        gx = torch.empty_like(x)
        err = cb.library().plb_grid_mass_bwd(
            x.data_ptr(), ct.data_ptr(), gx.data_ptr(), n, B, sim.n_grid, sim.inv_dx,
            sim.p_mass, x.device.index, cb.stream_of(x))
        name = cb.launch_key("grid_mass_bwd", x)
        cb.check(err, name)
        launches[name] += 1
        return gx


class GridMass(torch.autograd.Function):
    """x -> grid_m: forward K7 walking `order`, backward K7-bwd (saves x);
    one env or B envs."""

    @staticmethod
    def forward(ctx, x, order, scene):
        ctx.scene = scene
        ctx.save_for_backward(x)
        return _launch_grid_mass(scene, x, order)

    @staticmethod
    def backward(ctx, ct):
        (x,) = ctx.saved_tensors
        return grid_mass_bwd(ctx.scene, x, ct.contiguous()), None, None


def _launch_g2p(scene: SceneSpec, x, grid_v):
    """K5 over x (n, 3) and grid_v (G^3, 3), or over B envs: x (B, n, 3),
    grid_v (B, G^3, 3) -> new_v, new_C, new_x with x's leading shape."""
    with span("plb.kernel.g2p"):
        cb.require_kernel_input(x, "x")
        cb.require_kernel_input(grid_v, "grid_v")
        sim = scene.simulator
        B, n = _envs(x)
        new_v = torch.empty_like(x)
        new_C = torch.empty(x.shape + (3,), device=x.device, dtype=torch.float32)
        new_x = torch.empty_like(x)
        err = cb.library().plb_g2p(
            x.data_ptr(), grid_v.data_ptr(), new_v.data_ptr(), new_C.data_ptr(),
            new_x.data_ptr(), n, B, sim.n_grid, sim.inv_dx, sim.dt,
            1.0 - 3 * sim.dx, x.device.index, cb.stream_of(x))
        name = cb.launch_key("g2p", x)
        cb.check(err, name)
        launches[name] += 1
        return new_v, new_C, new_x


def _check_g2p(scene: SceneSpec, x, grid_v):
    if x.dim() not in (2, 3):
        raise ValueError(f"x: expected (n, 3) or (B, n, 3), got {tuple(x.shape)}")
    cb.require(x, "x", x.shape[:-1] + (3,), x.device)
    cb.require(grid_v, "grid_v", x.shape[:-2] + (scene.simulator.n_grid ** 3, 3), x.device)


def g2p_bwd(scene: SceneSpec, x, grid_v, ct_v, ct_C, ct_x, order=None):
    """The K6 kernel: cotangents of (new_v, new_C, new_x) -> (dx (n, 3),
    d grid_v (G^3, 3)), the VJP of `g2p_plain` away from the clamp's ties;
    with a leading B on every tensor, of `g2p_plain_batched`, in one launch.
    It scatters d grid_v walking `order`; dx does not depend on it. CUDA
    tensors only."""
    with span("plb.kernel.g2p_bwd"):
        sim = scene.simulator
        B, n = _envs(x)
        _check_g2p(scene, x, grid_v)
        for t, arg, shape in ((ct_v, "ct_v", x.shape), (ct_C, "ct_C", x.shape + (3,)),
                              (ct_x, "ct_x", x.shape)):
            cb.require(t, arg, shape, x.device)
        for t, arg in ((x, "x"), (grid_v, "grid_v"), (ct_v, "ct_v"), (ct_C, "ct_C"),
                       (ct_x, "ct_x")):
            cb.require_kernel_input(t, arg)
        gx = torch.empty_like(x)
        g_grid = torch.zeros_like(grid_v)
        err = cb.library().plb_g2p_bwd(
            x.data_ptr(), grid_v.data_ptr(), ct_v.data_ptr(), ct_C.data_ptr(),
            ct_x.data_ptr(), _order_ptr(order, x), gx.data_ptr(), g_grid.data_ptr(), n, B,
            sim.n_grid, sim.inv_dx, sim.dt, 1.0 - 3 * sim.dx, x.device.index, cb.stream_of(x))
        name = cb.launch_key("g2p_bwd", x)
        cb.check(err, name)
        launches[name] += 1
        return gx, g_grid


class G2P(torch.autograd.Function):
    """(x, grid_v) -> (new_v, new_C, new_x): forward K5, backward K6 walking
    the forward call's `order` (saves x, grid_v); one env or B envs."""

    @staticmethod
    def forward(ctx, x, grid_v, order, scene):
        ctx.scene, ctx.order = scene, order
        ctx.save_for_backward(x, grid_v)
        return _launch_g2p(scene, x, grid_v)

    @staticmethod
    def backward(ctx, ct_v, ct_C, ct_x):
        x, grid_v = ctx.saved_tensors
        gx, g_grid = g2p_bwd(ctx.scene, x, grid_v, ct_v.contiguous(), ct_C.contiguous(),
                             ct_x.contiguous(), ctx.order)
        return gx, g_grid, None, None


# ---------------------------------------------------------------------------
# wrappers: one env, or B envs in one launch; both differentiable
# ---------------------------------------------------------------------------

def _require_dim(x, dim: int, what: str):
    if x.dim() != dim:
        raise ValueError(f"x: expected {what}, got {tuple(x.shape)}")


def p2g(scene: SceneSpec, x, v, affine, order=None):
    """-> grid4 (G^3, 4); the K3 kernel (backward K4) on CUDA, `p2g_plain`
    on the CPU. order: `transfer.cell_order` of these or of earlier
    positions, or None; it changes the kernel's time, not the sums."""
    _require_dim(x, 2, "(n, 3)")
    _check_particles(x, v, affine)
    if x.device.type == "cpu":
        return p2g_plain(scene, x, v, affine)
    return P2G.apply(x, v, affine, order, scene)


def grid_mass(scene: SceneSpec, x, order=None):
    """-> grid_m (G^3,); the mass-only P2G kernel (K7 forward, backward K7
    backward) on CUDA, `grid_mass_plain` on the CPU. order as in `p2g`."""
    cb.require(x, "x", (x.shape[0], 3), x.device)
    if x.device.type == "cpu":
        return grid_mass_plain(scene, x)
    return GridMass.apply(x, order, scene)


def g2p(scene: SceneSpec, x, grid_v, order=None):
    """-> (new_v, new_C, new_x); the K5 kernel (backward K6, which scatters
    walking `order`, as in `p2g`) on CUDA, `g2p_plain` on the CPU."""
    _require_dim(x, 2, "(n, 3)")
    _check_g2p(scene, x, grid_v)
    if x.device.type == "cpu":
        return g2p_plain(scene, x, grid_v)
    return G2P.apply(x, grid_v, order, scene)


def p2g_batched(scene: SceneSpec, x, v, affine, order=None):
    """x, v (B, n, 3), affine (B, n, 3, 3) -> grid4 (B, G^3, 4); the K3
    kernel over B envs (backward K4 over B envs) on CUDA,
    `p2g_plain_batched` on the CPU. order (B, n) as in `p2g`, per env."""
    _require_dim(x, 3, "(B, n, 3)")
    _check_particles(x, v, affine)
    if x.device.type == "cpu":
        return p2g_plain_batched(scene, x, v, affine)
    return P2G.apply(x, v, affine, order, scene)


def grid_mass_batched(scene: SceneSpec, x, order=None):
    """x (B, n, 3) -> grid_m (B, G^3); the K7 forward kernel over B envs
    (backward K7 backward over B envs) on CUDA, `grid_mass_plain_batched` on
    the CPU. order (B, n) as in `p2g`, per env."""
    _require_dim(x, 3, "(B, n, 3)")
    cb.require(x, "x", (x.shape[0], x.shape[1], 3), x.device)
    if x.device.type == "cpu":
        return grid_mass_plain_batched(scene, x)
    return GridMass.apply(x, order, scene)


def g2p_batched(scene: SceneSpec, x, grid_v, order=None):
    """x (B, n, 3), grid_v (B, G^3, 3) -> (new_v, new_C, new_x) with a
    leading B; the K5 kernel over B envs (backward K6 over B envs, which
    scatters walking `order` (B, n)) on CUDA, `g2p_plain_batched` on the
    CPU."""
    _require_dim(x, 3, "(B, n, 3)")
    _check_g2p(scene, x, grid_v)
    if x.device.type == "cpu":
        return g2p_plain_batched(scene, x, grid_v)
    return G2P.apply(x, grid_v, order, scene)
