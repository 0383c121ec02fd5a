"""The particle order the port's scatter kernels walk, on the CPU:

- `transfer.cell_order` is, per env, the stable argsort of the particles'
  base-cell keys (held against numpy's on the same keys computed in numpy);
- `transfer.cell_keys` against the reference package's `sort_keys`;
- the transfers' plain versions, and through them `p2g`, `grid_mass`, `g2p`
  and their batched forms on CPU tensors, give bit for bit the same outputs
  and gradients whatever `order` they are handed: the order is the
  kernels' business and changes no sum;
- `cuda_transfer.lane_groups`, the plain model of the kernels' rule of
  which lanes of a warp add as one, on a hand-made case and on Move-v1's
  own cloud;
- `mpm.env_step` and `env_step_batched` compute the order once, from the
  entry state, and hand that one tensor to every transfer of the step.

Inputs come from numpy seeds; the small cases run at quality 0.25 (G = 16).
"""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plasticinelab_tpu.engine import local_transfer as lt
from plasticinelab_tpu_torch.engine import cuda_build, cuda_transfer, mpm
from plasticinelab_tpu_torch.engine.shapes import build_particles
from plasticinelab_tpu_torch.engine.state import default_materials, initial_state
from plasticinelab_tpu_torch.engine.transfer import cell_keys, cell_order
from plasticinelab_tpu_torch.envs.env import PlasticineEnv
from plasticinelab_tpu_torch.parallel import batch_states
from test_torch_kernels_plain import G, _scenes

N = 400


def _cloud(kind, B, seed=0):
    """(B, N, 3) float32 positions: a random blob; particles exactly on
    cell boundaries of the stencil's base (x inv_dx - 0.5 integral); and
    particles beyond both walls' clamp of the base cell to [0, G-3]."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        x = rng.random((B, N, 3)) * 0.35 + 0.3
    elif kind == "boundaries":
        x = (rng.integers(3, G - 3, (B, N, 3)) + 0.5) / G
        x[:, ::2] += rng.uniform(-0.02, 0.02, (B, N // 2, 3))
    else:
        x = np.where(rng.random((B, N, 3)) < 0.5, rng.uniform(0.0, 0.08, (B, N, 3)),
                     rng.uniform(0.85, 1.0, (B, N, 3)))
    return x.astype(np.float32)


def _numpy_keys(scene, x):
    """The stencil's clamped base cell, keyed x-major, in numpy float32."""
    sim = scene.simulator
    px = x.astype(np.float32) * np.float32(sim.inv_dx)
    base = np.clip(np.floor(px - np.float32(0.5)).astype(np.int64), 0, G - 3)
    return (base[..., 0] * G + base[..., 1]) * G + base[..., 2]


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("kind", ["random", "boundaries", "clamp"])
def test_cell_order_is_the_stable_argsort_per_env(kind, B):
    scene, _ = _scenes("float32", n=N)
    x = _cloud(kind, B)
    keys = _numpy_keys(scene, x)
    np.testing.assert_array_equal(cell_keys(scene, torch.tensor(x)).numpy(), keys)
    if kind == "clamp":
        assert keys.min() == 0 and keys.max() == ((G - 3) * G + G - 3) * G + G - 3
    order = cell_order(scene, torch.tensor(x))
    assert order.shape == (B, N) and order.dtype == torch.int32 and not order.requires_grad
    for b in range(B):
        o = order[b].numpy()
        np.testing.assert_array_equal(np.sort(o), np.arange(N))  # a permutation
        assert (np.diff(keys[b][o]) >= 0).all()
        np.testing.assert_array_equal(o, np.argsort(keys[b], kind="stable"))
        # one env alone gives its row of the batched call
        assert torch.equal(cell_order(scene, torch.tensor(x[b])), order[b])
    assert len(np.unique(keys)) < keys.size  # ties: the stable order was exercised


def test_cell_keys_match_reference_sort_keys():
    """Equal to the reference package's `sort_keys` wherever the base cell
    lies in [0, G-3]. Beyond the upper wall the two are not comparable on
    the full grid: the reference clamps its sort key to G-1 (its stencil is
    clamped elsewhere, inside the crop), the port keys the stencil's own
    clamped base cell, G-3; there the port's key is held to numpy's
    (`test_cell_order_is_the_stable_argsort_per_env`)."""
    scene, jscene = _scenes("float32", n=N)
    for kind in ("random", "boundaries", "clamp"):
        x = _cloud(kind, 1, seed=1)[0]
        ours = cell_keys(scene, torch.tensor(x)).numpy()
        theirs = np.asarray(lt.sort_keys(jscene, jnp.asarray(x)))
        base = np.floor(x * np.float32(scene.simulator.inv_dx) - np.float32(0.5))
        free = (base <= G - 3).all(axis=1)
        assert free.sum() > N // 10
        np.testing.assert_array_equal(ours[free], theirs[free])
        if kind == "clamp":
            assert (ours[~free] != theirs[~free]).all()


def _orders(scene, x, v):
    """None, the sorted order, one that is 19 substeps stale, and a random
    permutation, for x and v (B, n, 3)."""
    sim = scene.simulator
    gen = torch.Generator().manual_seed(5)
    rand = torch.stack([torch.randperm(x.shape[1], generator=gen) for _ in range(x.shape[0])])
    return {"none": None, "sorted": cell_order(scene, x),
            "stale": cell_order(scene, x - 19 * sim.dt * v), "random": rand.to(torch.int32)}


@pytest.mark.parametrize("name", ["sorted", "stale", "random"])
def test_transfers_give_the_same_sums_for_any_order(name):
    """Outputs and gradients of P2G, the mass-only P2G and G2P, one env and
    batched, under `order` equal bit for bit those without one."""
    scene, _ = _scenes("float64", n=N)
    rng = np.random.default_rng(2)
    B = 2
    x = torch.tensor(_cloud("random", B, seed=3).astype(np.float64))
    v = torch.tensor(rng.standard_normal((B, N, 3)) * 0.5)
    aff = torch.tensor(rng.standard_normal((B, N, 3, 3)) * 0.3)
    grid_v = torch.tensor(rng.standard_normal((B, G ** 3, 3)) * 0.5)
    cts = [torch.tensor(rng.standard_normal(s)) for s in ((B, N, 3), (B, N, 3, 3), (B, N, 3))]
    orders = _orders(scene, x, v)
    if name == "stale":
        assert not torch.equal(orders["stale"], orders["sorted"])
    order = orders[name]
    ct = cuda_transfer

    def g2p_vjp(fn, xs, gs, o):
        xs, gs = xs.clone().requires_grad_(True), gs.clone().requires_grad_(True)
        out = fn(scene, xs, gs, o)
        c = cts if xs.dim() == 3 else [t[0] for t in cts]
        return (*out, *torch.autograd.grad(out, [xs, gs], c))

    for fn in (ct.p2g_batched, ct.p2g_plain_batched):
        assert torch.equal(fn(scene, x, v, aff, order), fn(scene, x, v, aff))
    for fn in (ct.grid_mass_batched, ct.grid_mass_plain_batched):
        assert torch.equal(fn(scene, x, order), fn(scene, x))
    for fn in (ct.g2p_batched, ct.g2p_plain_batched):
        for got, want in zip(g2p_vjp(fn, x, grid_v, order), g2p_vjp(fn, x, grid_v, None)):
            assert torch.equal(got, want)
    # one env
    for fn in (ct.p2g, ct.p2g_plain):
        assert torch.equal(fn(scene, x[0], v[0], aff[0], order[0]), fn(scene, x[0], v[0], aff[0]))
    for fn in (ct.grid_mass, ct.grid_mass_plain):
        assert torch.equal(fn(scene, x[0], order[0]), fn(scene, x[0]))
    for fn in (ct.g2p, ct.g2p_plain):
        for got, want in zip(g2p_vjp(fn, x[0], grid_v[0], order[0]),
                             g2p_vjp(fn, x[0], grid_v[0], None)):
            assert torch.equal(got, want)


def test_lane_groups_by_hand():
    """Warps of 32 entries, G = 16 (cell 1/16): base cell = floor(16 x -
    0.5). 40 particles: the first warp holds 3 base cells (one of them in
    two separate runs, which still add as one), the second warp 8 entries
    of one of those cells again: 3 + 1 groups."""
    scene, _ = _scenes("float32", n=40)
    cell = lambda *b: [(c + 0.75) / G for c in b]  # noqa: E731
    x = torch.tensor([cell(5, 5, 5)] * 10 + [cell(5, 5, 6)] * 10 + [cell(5, 5, 5)] * 4
                     + [cell(9, 2, 3)] * 8 + [cell(5, 5, 6)] * 8)
    assert int(cuda_transfer.lane_groups(scene, x)) == 4
    # walked backwards: warp 0 = 8 x (5,5,6), 8 x (9,2,3), 4 x (5,5,5), 10 x
    # (5,5,6), 2 x (5,5,5) -> 3 groups; warp 1 = 8 x (5,5,5) -> 1
    back = torch.arange(39, -1, -1, dtype=torch.int32)
    assert int(cuda_transfer.lane_groups(scene, x, back)) == 4
    # the even entries, then the odd ones: warp 0 sees all three cells, warp 1
    # the entries 25, 27, .. 39, of two cells
    mixed = torch.cat([torch.arange(0, 40, 2), torch.arange(1, 40, 2)]).to(torch.int32)
    assert int(cuda_transfer.lane_groups(scene, x, mixed)) == 5
    # batched: each env is counted alone
    both = cuda_transfer.lane_groups(scene, torch.stack([x, x]), torch.stack([back, mixed]))
    assert both.tolist() == [4, 5]


def test_lane_groups_on_move_v1():
    """Move-v1's own initial cloud (10,000 particles, 64^3 grid). Measured
    groups per particle, the share that is left of the global adds of one
    thread per particle: 0.166 walking the sorted order, 0.278 walking an
    order one env step stale (19 substeps at 1 m/s in a random direction
    per particle, more than the manipulators move it), 0.987 walking the
    particles as `build_particles` drew them."""
    scene = PlasticineEnv.load_scene("move", 1)
    x_np, _ = build_particles(scene.shapes)
    scene = scene.with_n_particles(len(x_np))
    assert len(x_np) == 10000 and scene.simulator.n_grid == 64
    x = torch.tensor(x_np, dtype=torch.float32)
    rng = np.random.default_rng(4)
    d = rng.standard_normal(x_np.shape)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    moved = x + torch.tensor(19 * scene.simulator.dt * d, dtype=torch.float32)
    left = lambda o: int(cuda_transfer.lane_groups(scene, moved, o)) / len(x_np)  # noqa: E731
    assert left(cell_order(scene, moved)) <= 0.2
    stale = cell_order(scene, x)
    assert not torch.equal(stale, cell_order(scene, moved))
    assert left(stale) <= 0.3
    assert left(None) >= 0.9


def test_grouping_constants_are_the_kernels():
    """The model's warp is the kernels' group span, and the kernels' blocks
    are whole warps."""
    src = open(os.path.join(cuda_build.CSRC, "transfer.cu")).read()
    assert 2 ** int(re.search(r"kPeerRounds = (\d+);", src).group(1)) == cuda_transfer.WARP
    assert int(re.search(r"kScatterThreads = (\d+);", src).group(1)) % cuda_transfer.WARP == 0


@pytest.mark.parametrize("batched", [False, True])
def test_env_step_orders_once_per_step(batched):
    """An env step computes `cell_order` of its entry state once and hands
    that tensor to P2G and G2P of every substep and to the final mass P2G;
    an order passed in is used as it is."""
    scene, _ = _scenes("float64", prims=(dict(shape="Sphere", radius=0.12),), n=N)
    mats = default_materials(scene)
    x_np, _ = build_particles(scene.shapes)
    scene = scene.with_n_particles(len(x_np))
    state = initial_state(scene, x_np, torch.device("cpu"), torch.float64)
    base = mpm.PLAIN_OPS_BATCHED if batched else mpm.PLAIN_OPS
    seen = []

    def spy(fn):
        def call(sc, *args):
            seen.append(args[-1])
            return fn(sc, *args)
        return call

    ops = base._replace(p2g=spy(base.p2g), g2p=spy(base.g2p), grid_mass=spy(base.grid_mass))
    sub = scene.simulator.substeps
    if batched:
        state = batch_states(state, 2, jitter=0.0)
        action = np.zeros((2, scene.action_dim))
        mpm.env_step_batched(scene, mats, state, action, 666.0, want_grid_m=True, ops=ops)
    else:
        mpm.env_step_with_grid_m(scene, mats, state, np.zeros(scene.action_dim), 666.0, ops)
    assert len(seen) == 2 * sub + 1
    assert all(o is seen[0] for o in seen)
    assert torch.equal(seen[0], cell_order(scene, state.x))
    if not batched:
        seen.clear()
        mine = torch.arange(len(x_np), dtype=torch.int32)
        mpm.env_step(scene, mats, state, None, 666.0, ops, mine)
        assert len(seen) == 2 * sub and all(o is mine for o in seen)
