"""The port's batched trajectory gradient on the CPU (the plain versions
through torch.autograd) against the TPU package, and its pieces:

(a) the VJP of each batched plain version (P2G, mass, G2P, grid update) at
    B = 3 in float64 equals the single-env plain version's VJP env by env,
    to 1e-12 of the largest value (the same arithmetic in one index_add_ or
    gather over all envs); the grid update for all 7 primitive shapes, each
    env with its own poses and softness, its pose cotangents too;
(b) d/d actions of `mpm.env_step_batched` (loss sum x^2 of the new states)
    against `jax.grad` of the TPU package's `mpm.env_step_batched`, whose
    batched Pallas kernels (forward and K4-b, K6-b, K8-bwd-b) run in
    interpret mode as tests/test_batched_rows.py:140-154 runs them, on that
    file's scene, B = 2, the states carried across, but with the Sphere
    lowered onto the box (y = 0.300 and 0.304; at that file's y = 0.35 it
    touches nothing in one step and both gradients are zero); float32, atol
    1e-4 / rtol 1e-3, that test's tolerance for its own batched-vs-single
    comparison (the Pallas transfers contract with a 3-pass bf16 split, the
    port in float32);
(c) `build_batched_rollout_grad` against the TPU package's on
    tests/test_parallel.py:42-74's scene in float64, where the TPU package
    takes its dense transfer route (no Pallas on the CPU in float64): the
    same numpy states (its jittered `batch_states` carried across), seeded
    non-zero actions and goal; mean loss and the (B, T, A) gradient to 1e-8
    of the largest value (the same math in another summation order); rows
    differ across the jittered envs;
(d) remat "env_step" equals "none" for the batched rollout (the CPU's plain
    versions sum without atomics, so to 1e-12);
(e) `resolve_remat` scales with the batch; (f) `batch_states`' shapes,
    jitter, clip and seeding; (g) the default device is "cuda"."""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plasticinelab_tpu.config import spec as jspec
from plasticinelab_tpu.engine import losses as jlosses
from plasticinelab_tpu.engine import mpm as jmpm
from plasticinelab_tpu.engine.shapes import build_particles as jbuild_particles
from plasticinelab_tpu.engine.state import default_materials as jdefault_materials
from plasticinelab_tpu.engine.state import initial_state as jinitial_state
from plasticinelab_tpu.parallel import mesh as jmesh
from plasticinelab_tpu_torch.config import spec as tspec
from plasticinelab_tpu_torch.engine import cuda_gridop, cuda_transfer, losses, mpm
from plasticinelab_tpu_torch.engine.sim import rollout_losses, rollout_losses_batched
from plasticinelab_tpu_torch.engine.state import (
    SimState, default_materials, initial_state, state_fields, states_from_numpy,
)
from plasticinelab_tpu_torch.parallel import batch_states, build_batched_rollout_grad
from test_torch_vec_kernels_plain import (
    B, F64, IDS, SHAPE_KW, _close, _ct, _env, _grid_op_inputs, _rows_scene, _scene,
    _transfer_cases, _vjp, rows_interpret,
)

VJP_TOL = 1e-12
F64_TOL = 1e-8


# ---------------------------------------------------------------------------
# (a) VJPs of the batched plain versions = single-env VJPs, env by env
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["p2g_batched", "grid_mass_batched", "g2p_batched"])
def test_batched_plain_transfer_vjps_equal_per_env(name):
    scene = _scene(prims=())
    _, plain_b, plain_1, inputs, cts = _transfer_cases(scene)[name]
    got = _vjp(lambda *a: plain_b(scene, *a), inputs, cts)
    for b in range(B):
        want = _vjp(lambda *a: plain_1(scene, *a), [t[b] for t in inputs], [c[b] for c in cts])
        for g, w in zip(got, want):
            assert float(w.abs().max()) > 0
            _close(g[b], w, VJP_TOL)
    assert not torch.allclose(got[0][0], got[0][1])


@pytest.mark.parametrize("kw", SHAPE_KW, ids=IDS)
def test_batched_plain_grid_op_vjp_equal_per_env(kw):
    scene = _scene(prims=[kw])
    grid4, pf, pf1, softness = _grid_op_inputs(scene)
    ct = _ct(27, B, grid4.shape[1], 3)
    got = _vjp(lambda g, *ps: cuda_gridop.grid_op_plain_batched(scene, g, ps[:3], ps[3:],
                                                                softness),
               [grid4, *pf, *pf1], [ct])
    for b in range(B):
        want = _vjp(lambda g, *ps: cuda_gridop.grid_op_plain(scene, g, ps[:3], ps[3:],
                                                             float(softness[b])),
                    [grid4[b], *_env(pf, b), *_env(pf1, b)], [ct[b]])
        for g, w in zip(got, want):
            _close(g[b], w, VJP_TOL)
    # d grid4 and the pose cotangents at f (position, rotation) are not zero
    assert all(float(got[i].abs().max()) > 0 for i in (0, 1, 2))


# ---------------------------------------------------------------------------
# (b) d/d actions of the batched env step against the TPU package's
# ---------------------------------------------------------------------------

def test_env_step_batched_gradient_matches_tpu_package(rows_interpret):
    js = _rows_scene(jspec)
    particles, _ = jbuild_particles(js.shapes)
    js = js.with_n_particles(len(particles))
    ts = _rows_scene(tspec).with_n_particles(len(particles))
    assert jmpm.use_rows_path(js, jnp.float32)
    nb = 2
    base = jinitial_state(js, particles)
    rng = np.random.default_rng(5)
    envs = []
    for b in range(nb):
        x = np.asarray(base.x) + rng.uniform(-2e-3, 2e-3, base.x.shape).astype(np.float32)
        pos = np.asarray(base.prim_pos).copy()
        pos[0, 1] = 0.30 + 0.004 * b  # the Sphere (radius 0.06) on the box's top (y = 0.25)
        envs.append(base._replace(x=jnp.asarray(x), prim_pos=jnp.asarray(pos)))
    states = jax.tree.map(lambda *a: jnp.stack(a), *envs)
    actions = np.random.default_rng(4).uniform(-0.5, 0.5, (nb, 3)).astype(np.float32)
    jmats, softness = jdefault_materials(js), jnp.asarray(666.0, jnp.float32)

    def loss_b(acts):
        st = jmpm.env_step_batched(js, jmats, states, acts, softness)
        return jnp.sum(st.x ** 2)

    want = np.asarray(jax.grad(loss_b)(jnp.asarray(actions)))

    ours = states_from_numpy([np.asarray(a) for a in states], "cpu", torch.float32)
    a = torch.tensor(actions, requires_grad=True)
    st = mpm.env_step_batched(ts, default_materials(ts), ours, a, 666.0)
    (got,) = torch.autograd.grad(torch.sum(st.x ** 2), a)
    assert got.shape == (nb, 3) and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-3)
    assert not np.allclose(got[0].numpy(), got[1].numpy())


# ---------------------------------------------------------------------------
# (c) build_batched_rollout_grad against the TPU package's
# ---------------------------------------------------------------------------

def _tiny(mod, dtype="float64", n=32):
    """tests/test_parallel.py:42-74's scene, particles and goal."""
    sim = mod.SimulatorSpec(quality=0.25, n_particles=n, dtype=dtype)
    prim = mod.PrimitiveSpec(shape="Sphere", radius=0.08, init_pos=(0.45, 0.5, 0.5),
                             friction=0.9, action_dim=3, action_scale=(0.01,) * 3)
    scene = mod.SceneSpec(simulator=sim, primitives=(prim,))
    particles = np.random.default_rng(0).random((n, 3)) * 0.2 + 0.4
    G = sim.n_grid
    target = np.zeros((G, G, G))
    target[6:10, 3:7, 6:10] = sim.p_mass * 4
    return scene, particles, target


def _port_tiny(dtype="float64"):
    scene, particles, target = _tiny(tspec, dtype)
    tdtype = torch.float64 if dtype == "float64" else torch.float32
    state = initial_state(scene, particles, "cpu", tdtype)
    ls = losses.make_loss_state(scene, target, "cpu", tdtype)
    return scene, default_materials(scene), ls, state


def test_batched_rollout_grad_matches_tpu_package():
    jscene, particles, target = _tiny(jspec)
    nb, T = 4, 2
    jstates = jmesh.batch_states(jinitial_state(jscene, particles), nb, jitter=1e-3)
    assert jstates.x.dtype == jnp.float64 and not jmpm.use_rows_path(jscene, jnp.float32)
    actions = np.random.default_rng(1).uniform(-1, 1, (nb, T, 3))
    jstep = jmesh.build_batched_rollout_grad(jscene, jdefault_materials(jscene),
                                             jlosses.make_loss_state(jscene, target),
                                             jmesh.make_mesh(1))
    want_loss, want_grad = jstep(jstates, jnp.asarray(actions), jnp.float64(666.0))
    want_grad = np.asarray(want_grad)

    scene, mats, ls, _ = _port_tiny()
    step = build_batched_rollout_grad(scene, mats, ls, device="cpu")
    states = states_from_numpy([np.asarray(a) for a in jstates], "cpu", torch.float64)
    loss, grad = step(states, actions, 666.0)
    assert step.last_remat == "none"
    assert grad.shape == (nb, T, 3) and grad.dtype == torch.float64
    assert loss.dim() == 0 and not loss.requires_grad and not grad.requires_grad
    assert np.abs(want_grad).max() > 0
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=F64_TOL)
    np.testing.assert_allclose(grad.numpy(), want_grad, rtol=0,
                               atol=F64_TOL * np.abs(want_grad).max())
    # envs were jittered -> gradients differ across the batch
    assert not np.allclose(grad[0].numpy(), grad[1].numpy())


def test_batched_rollout_grad_is_the_mean_of_single_env_gradients():
    """Row b of the gradient is 1/B of env b's own trajectory gradient, the
    loss the mean of the envs' loss sums; softness per env."""
    scene, mats, ls, state = _port_tiny()
    nb, T = 3, 2
    states = batch_states(state, nb, jitter=1e-3, seed=2)
    actions = np.random.default_rng(3).uniform(-1, 1, (nb, T, 3))
    softness = torch.tensor([666.0, 100.0, 300.0], dtype=F64)
    loss, grad = build_batched_rollout_grad(scene, mats, ls, device="cpu")(
        states, actions, softness)
    total = 0.0
    for b in range(nb):
        a = torch.tensor(actions[b], requires_grad=True)
        one = SimState(*(f[b] for f in state_fields(states)))
        comps, _ = rollout_losses(scene, mats, ls, one, a, float(softness[b]))
        one_loss = comps[:, 0].sum()
        (g,) = torch.autograd.grad(one_loss, a)
        total += float(one_loss.detach())
        _close(grad[b] * nb, g, 1e-12)
    np.testing.assert_allclose(float(loss), total / nb, rtol=1e-13)


# ---------------------------------------------------------------------------
# (d) remat
# ---------------------------------------------------------------------------

def test_batched_checkpointed_equals_uncheckpointed():
    scene, mats, ls, state = _port_tiny()
    nb, T = 2, 3
    states = batch_states(state, nb, jitter=1e-3, seed=4)
    actions = np.random.default_rng(5).uniform(-0.5, 0.5, (nb, T, 3))
    out = {}
    for remat in ("none", "env_step"):
        a = torch.tensor(actions, requires_grad=True)
        rows, final = rollout_losses_batched(scene, mats, ls, states, a, 666.0, remat)
        assert rows.shape == (T, nb) and final.x.shape == states.x.shape
        loss = rows.sum(dim=0).mean()
        (g,) = torch.autograd.grad(loss, a)
        out[remat] = (float(loss.detach()), g.numpy())
    assert out["none"][0] == out["env_step"][0]
    np.testing.assert_allclose(out["env_step"][1], out["none"][1], rtol=1e-12, atol=0)
    with pytest.raises(ValueError, match="remat"):
        rollout_losses_batched(scene, mats, ls, states, torch.tensor(actions), 666.0, "substep")


# ---------------------------------------------------------------------------
# (e) resolve_remat, (f) batch_states, (g) the default device
# ---------------------------------------------------------------------------

def test_resolve_remat_scales_with_batch():
    from plasticinelab_tpu_torch.envs.env import PlasticineEnv

    scene = PlasticineEnv.load_scene("move", 1).with_n_particles(10000)
    per_env = 50 * scene.simulator.substeps * mpm.substep_bytes(scene)
    assert 7.7 * 2 ** 30 < per_env < 7.8 * 2 ** 30  # 7.74 GiB per 50-step gradient per env
    free = 79 * 2 ** 30  # an 80 GB card with little else on it: a budget of 63.2 GiB
    assert mpm.remat_for(scene, 50, 1, free) == "none"
    assert mpm.remat_for(scene, 50, 8, free) == "none"      # 61.9 GiB
    assert mpm.remat_for(scene, 50, 9, free) == "env_step"  # 69.7 GiB
    assert mpm.remat_for(scene, 50, 32, free) == "env_step"
    assert mpm.remat_for(scene, 5, 32, free) == "none"      # a short horizon fits
    assert mpm.remat_for(scene, 50, 8, free // 2) == "env_step"  # less free memory
    # on the CPU nothing is recomputed, whatever the batch
    assert mpm.resolve_remat(scene, 50, "cpu", batch=32) == "none"
    assert inspect.signature(mpm.resolve_remat).parameters["batch"].default == 1


def test_batch_states_shapes_jitter_clip_and_seeding():
    scene, _, _, state = _port_tiny("float32")
    tiled = batch_states(state, 8)
    for got, one in zip(state_fields(tiled), state_fields(state)):
        assert got.shape == (8,) + one.shape and got.is_contiguous()
        assert torch.equal(got, one.expand_as(got))
    a, b, c = (batch_states(state, 8, jitter=1e-3, seed=s) for s in (7, 7, 8))
    assert a.x.shape == (8, 32, 3) and a.x.dtype == torch.float32
    assert torch.equal(a.x, b.x) and not torch.equal(a.x, c.x)
    assert not torch.equal(a.x[0], a.x[1])
    d = a.x - tiled.x
    assert 0 < float(d.abs().max()) <= 1e-3 + 1e-7  # uniform(-jitter, jitter)
    assert torch.equal(a.v, tiled.v) and torch.equal(a.prim_pos, tiled.prim_pos)
    # positions are clipped to [0, 0.95]
    edge = SimState(*state_fields(state))
    edge.x = torch.tensor([[0.0, 0.5, 0.96]] * 32)
    e = batch_states(edge, 4, jitter=1e-2, seed=0).x
    assert float(e.min()) >= 0.0 and float(e.max()) <= 0.95
    assert bool((e[..., 0] == 0.0).any()) and bool((e[..., 2] == 0.95).all())


def test_batched_gradient_runs_on_the_card_by_default():
    assert inspect.signature(build_batched_rollout_grad).parameters["device"].default == "cuda"
