"""The batched plain versions and the batched env step of the port, on the
CPU:

(a) each batched plain version (P2G, mass, G2P, grid update) at B = 3 on a
    small scene in float64 equals its single-env plain version called env
    by env, to 1e-15 relative to the largest value (the same arithmetic in
    one index_add_ or gather over all envs); so do the batched controls,
    forward kinematics and losses, and the batched env step;
(b) the port's `env_step_batched` through the plain versions against the
    TPU package's `mpm.env_step_batched`, whose batched Pallas kernels
    (K3-b, K5-b, K7-fwd-b, K8-fwd-b) run in interpret mode as
    tests/test_batched_rows.py runs them, on that file's scene, B = 2, the
    states carried across. Tolerances are that test's: x 1e-6; v and F
    2e-5 absolute / 1e-4 relative; grid_m 1e-5 / 1e-4 (the Pallas
    transfers contract with a 3-pass bf16 split, the port in float32);
(c) on CPU tensors that require grad each batched wrapper returns its
    plain version's output and gradient."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plasticinelab_tpu.config import spec as jspec
from plasticinelab_tpu.engine import mpm as jmpm
from plasticinelab_tpu.engine.shapes import build_particles as jbuild_particles
from plasticinelab_tpu.engine.state import default_materials as jdefault_materials
from plasticinelab_tpu.engine.state import initial_state as jinitial_state
from plasticinelab_tpu.engine.transfer import crop_size
from plasticinelab_tpu_torch.config import spec as tspec
from plasticinelab_tpu_torch.engine import cuda_gridop, cuda_transfer, losses, mpm
from plasticinelab_tpu_torch.engine.state import (
    SimState, default_materials, initial_states, states_from_numpy,
)

F64 = torch.float64
B = 3
EXACT = 1e-15
SHAPE_KW = [
    dict(shape="Sphere", radius=0.12, action_dim=3, action_scale=(0.01,) * 3),
    dict(shape="Capsule", h=0.12, r=0.06, action_dim=6, action_scale=(0.01,) * 3 + (0.02,) * 3),
    dict(shape="RollingPin", h=0.3, r=0.05, action_dim=3, action_scale=(0.7, 0.005, 0.005)),
    dict(shape="Chopsticks", h=0.25, r=0.04, init_gap=0.1, action_dim=7,
         action_scale=(0.01,) * 3 + (0.02,) * 3 + (0.01,), minimal_gap=0.06),
    dict(shape="Cylinder", h=0.15, r=0.1),
    dict(shape="Torus", tx=0.15, ty=0.06, action_dim=3, action_scale=(0.01,) * 3),
    dict(shape="Box", size=(0.1, 0.13, 0.08), action_dim=6,
         action_scale=(0.01,) * 3 + (0.02,) * 3),
]
IDS = [k["shape"] for k in SHAPE_KW]


def _scene(prims=SHAPE_KW, soft_contact=False, dtype="float64"):
    sim = tspec.SimulatorSpec(quality=0.25, n_particles=200, dtype=dtype, yield_stress=30.0)
    env = tspec.EnvSpec(loss=tspec.LossSpec(target_path="", soft_contact=soft_contact),
                        n_observed_particles=50)
    return tspec.SceneSpec(simulator=sim, env=env,
                           primitives=tuple(tspec.PrimitiveSpec(friction=0.9, **p)
                                            for p in prims),
                           shapes=(tspec.ShapeSpec(shape="box", init_pos=(0.5, 0.35, 0.5),
                                                   width=0.1, n_particles=200),))


def _close(got, want, rel=EXACT):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-300))


def _particles(seed, n=200):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a, dtype=F64)  # noqa: E731
    return (t(rng.random((B, n, 3)) * 0.35 + 0.3), t(rng.standard_normal((B, n, 3))),
            t(rng.standard_normal((B, n, 3, 3)) * 0.3))


def _poses(seed, k):
    rng = np.random.default_rng(seed)
    rot = rng.standard_normal((B, k, 4))
    rot /= np.linalg.norm(rot, axis=-1, keepdims=True)
    pos, gap = rng.uniform(0.3, 0.7, (B, k, 3)), rng.uniform(0.05, 0.1, (B, k))
    t = lambda a: torch.tensor(a, dtype=F64)  # noqa: E731
    return (t(pos), t(rot), t(gap)), (t(pos + 1e-3), t(rot), t(gap + 5e-4))


def _env(tree, b):
    return tuple(t[b] for t in tree)


# ---------------------------------------------------------------------------
# (a) batched plain versions = single-env plain versions, env by env
# ---------------------------------------------------------------------------

def test_batched_plain_transfers_equal_per_env():
    scene = _scene(prims=())
    G3 = scene.simulator.n_grid ** 3
    x, v, aff = _particles(0)
    grid4 = cuda_transfer.p2g_plain_batched(scene, x, v, aff)
    grid_m = cuda_transfer.grid_mass_plain_batched(scene, x)
    grid_v = torch.tensor(np.random.default_rng(1).standard_normal((B, G3, 3)), dtype=F64)
    g2p = cuda_transfer.g2p_plain_batched(scene, x, grid_v)
    assert grid4.shape == (B, G3, 4) and grid_m.shape == (B, G3)
    for b in range(B):
        _close(grid4[b], cuda_transfer.p2g_plain(scene, x[b], v[b], aff[b]))
        _close(grid_m[b], cuda_transfer.grid_mass_plain(scene, x[b]))
        for got, want in zip(g2p, cuda_transfer.g2p_plain(scene, x[b], grid_v[b])):
            _close(got[b], want)
    # the envs differ, so an env-indexing slip would show
    assert not torch.allclose(grid4[0], grid4[1])


@pytest.mark.parametrize("kw", SHAPE_KW, ids=IDS)
def test_batched_plain_grid_op_equal_per_env(kw):
    scene = _scene(prims=[kw])
    G3 = scene.simulator.n_grid ** 3
    rng = np.random.default_rng(2)
    g4 = rng.standard_normal((B, G3, 4)) * 1e-4
    g4[..., 3] = np.where(rng.random((B, G3)) < 0.25, 0.0,
                          np.abs(rng.standard_normal((B, G3))) * 1e-4 + 1e-6)
    grid4 = torch.tensor(g4, dtype=F64)
    pf, pf1 = _poses(3, 1)
    softness = torch.tensor([666.0, 0.0, 100.0], dtype=F64)
    got = cuda_gridop.grid_op_plain_batched(scene, grid4, pf, pf1, softness)
    for b in range(B):
        _close(got[b], cuda_gridop.grid_op_plain(scene, grid4[b], _env(pf, b), _env(pf1, b),
                                                 float(softness[b])))
    # the dispatching wrapper takes the plain version on the CPU
    assert torch.equal(cuda_gridop.grid_op_batched(scene, grid4, pf, pf1, softness), got)


def test_batched_controls_and_kinematics_equal_per_env():
    """All 7 shapes in one scene (RollingPin and Chopsticks have their own
    kinematics): controls and one substep of forward kinematics for B envs
    in one set of tensor ops equal the single-env ones."""
    scene = _scene()
    actions = torch.tensor(np.random.default_rng(4).uniform(-1.5, 1.5, (B, scene.action_dim)),
                           dtype=F64)
    ctrl = mpm.make_controls_batched(scene, actions, "cpu", F64)
    pf, _ = _poses(5, len(scene.primitives))
    pf1 = mpm.fk_step(scene, pf, ctrl)
    for b in range(B):
        c1 = mpm.make_controls(scene, actions[b], "cpu", F64)
        for got, want in ((ctrl.v, c1.v), (ctrl.w, c1.w), (ctrl.gap_vel, c1.gap_vel)):
            _close(got[b], want)
        for got, want in zip(pf1, mpm.fk_step(scene, _env(pf, b), c1)):
            _close(got[b], want)


@pytest.mark.parametrize("soft_contact", [False, True], ids=["min", "soft"])
def test_batched_losses_equal_per_env(soft_contact):
    scene = _scene(soft_contact=soft_contact)
    G = scene.simulator.n_grid
    target = np.random.default_rng(6).random((G, G, G)) * 1e-3 * (
        np.random.default_rng(7).random((G, G, G)) < 0.1)
    ls = losses.make_loss_state(scene, target, "cpu", F64)
    x, v, _ = _particles(8)
    pf, _ = _poses(9, len(scene.primitives))
    k, n = len(scene.primitives), x.shape[1]
    states = SimState(x=x, v=v, C=torch.zeros(B, n, 3, 3, dtype=F64),
                      F=torch.eye(3, dtype=F64).expand(B, n, 3, 3), prim_pos=pf[0],
                      prim_rot=pf[1], prim_gap=pf[2])
    assert states.prim_pos.shape == (B, k, 3)
    grid_m = cuda_transfer.grid_mass_plain_batched(scene, x)
    info = losses.loss_and_components(scene, ls, states, grid_m)
    for b in range(B):
        one = SimState(*_env((states.x, states.v, states.C, states.F, *pf), b))
        want = losses.loss_and_components(scene, ls, one, grid_m[b])
        for key, val in info.items():
            assert val.shape == (B,), key
            _close(val[b], want[key])


def test_env_step_batched_plain_equals_single_env_steps():
    scene = _scene(prims=SHAPE_KW[:2])
    mats = default_materials(scene)
    from plasticinelab_tpu_torch.engine.shapes import build_particles

    particles, _ = build_particles(scene.shapes)
    scene = scene.with_n_particles(len(particles))
    states = initial_states(scene, particles, B, "cpu", F64, 2e-3,
                            torch.Generator().manual_seed(0))
    actions = torch.tensor(np.random.default_rng(10).uniform(-1, 1, (B, scene.action_dim)),
                           dtype=F64)
    new, grid_m = mpm.env_step_batched(scene, mats, states, actions, 666.0, want_grid_m=True,
                                       ops=mpm.PLAIN_OPS_BATCHED)
    for b in range(B):
        one = SimState(*(getattr(states, f)[b] for f in SimState.__dataclass_fields__))
        st, gm = mpm.env_step_with_grid_m(scene, mats, one, actions[b], 666.0, mpm.PLAIN_OPS)
        for f in SimState.__dataclass_fields__:
            _close(getattr(new, f)[b], getattr(st, f), 1e-12)
        _close(grid_m[b], gm, 1e-12)
    # KERNEL_OPS_BATCHED takes the same plain versions on CPU tensors
    new_k = mpm.env_step_batched(scene, mats, states, actions, 666.0)
    assert torch.equal(new_k.x, new.x)


# ---------------------------------------------------------------------------
# (b) against the TPU package's batched env step (Pallas interpret mode)
# ---------------------------------------------------------------------------

def _rows_scene(mod):
    """tests/test_batched_rows.py's scene: a dense 1,500-particle box under
    a Sphere, whose sorted chunks stay inside the batched kernels' windows."""
    sim = mod.SimulatorSpec(quality=0.5, n_particles=0, dtype="float32")
    return mod.SceneSpec(
        simulator=sim,
        shapes=(mod.ShapeSpec(shape="box", init_pos=(0.5, 0.2, 0.5), width=(0.15, 0.1, 0.15),
                              n_particles=1500),),
        primitives=(mod.PrimitiveSpec(shape="Sphere", radius=0.06, init_pos=(0.5, 0.35, 0.5),
                                      action_dim=3, action_scale=(0.01,) * 3),))


@pytest.fixture()
def rows_interpret():
    old = jmpm.ROWS_INTERPRET
    jmpm.ROWS_INTERPRET = True
    yield
    jmpm.ROWS_INTERPRET = old


def test_env_step_batched_plain_matches_tpu_package(rows_interpret):
    js = _rows_scene(jspec)
    particles, _ = jbuild_particles(js.shapes)
    js = js.with_n_particles(len(particles))
    ts = _rows_scene(tspec).with_n_particles(len(particles))
    assert jmpm.use_rows_path(js, jnp.float32)
    nb = 2
    base = jinitial_state(js, particles)
    rng = np.random.default_rng(5)
    states = jax.tree.map(lambda *a: jnp.stack(a), *[
        base._replace(x=jnp.asarray(np.asarray(base.x) + rng.uniform(
            -2e-3, 2e-3, base.x.shape).astype(np.float32))) for _ in range(nb)])
    actions = np.random.default_rng(4).uniform(-0.5, 0.5, (nb, 3)).astype(np.float32)
    ref, ref_gm, off = jmpm.env_step_batched(
        js, jdefault_materials(js), states, jnp.asarray(actions),
        jnp.asarray(666.0, jnp.float32), want_grid_m=True)

    ours, gm = mpm.env_step_batched(
        ts, default_materials(ts), states_from_numpy([np.asarray(a) for a in states], "cpu",
                                                     torch.float32),
        torch.tensor(actions), 666.0, want_grid_m=True, ops=mpm.PLAIN_OPS_BATCHED)
    for name, atol, rtol in (("x", 1e-6, 1e-6), ("v", 2e-5, 1e-4), ("F", 2e-5, 1e-4)):
        np.testing.assert_allclose(getattr(ours, name).numpy(), np.asarray(getattr(ref, name)),
                                   atol=atol, rtol=rtol, err_msg=name)
    for name in ("prim_pos", "prim_rot", "prim_gap"):
        np.testing.assert_allclose(getattr(ours, name).numpy(), np.asarray(getattr(ref, name)),
                                   atol=1e-7, err_msg=name)
    # the TPU package's grid mass is a D^3 crop at each env's offset: place
    # it in the full grid the port computes
    G, D = js.simulator.n_grid, crop_size(js)
    full = np.zeros((nb, G, G, G), np.float32)
    for b, o in enumerate(np.asarray(off)):
        full[b, o[0]:o[0] + D, o[1]:o[1] + D, o[2]:o[2] + D] = np.asarray(ref_gm[b]).reshape(
            (D,) * 3)
    np.testing.assert_allclose(gm.numpy(), full.reshape(nb, -1), atol=1e-5, rtol=1e-4)
    assert not np.allclose(ours.x[0].numpy(), ours.x[1].numpy())


# ---------------------------------------------------------------------------
# (c) the batched wrappers differentiate their plain versions on the CPU
# ---------------------------------------------------------------------------

def _vjp(fn, inputs, cts):
    """fn's VJP at inputs for cotangents cts through torch.autograd."""
    ins = [t.clone().requires_grad_(True) for t in inputs]
    out = fn(*ins)
    out = out if isinstance(out, tuple) else (out,)
    grads = torch.autograd.grad(out, ins, cts, allow_unused=True)
    return [torch.zeros_like(i) if g is None else g for g, i in zip(grads, ins)]


def _ct(seed, *shape):
    return torch.tensor(np.random.default_rng(seed).standard_normal(shape), dtype=F64)


def _transfer_cases(scene):
    """name -> (batched wrapper, batched plain, single plain, inputs, cotangents)."""
    G3 = scene.simulator.n_grid ** 3
    x, v, aff = _particles(20)
    n = x.shape[1]
    grid_v = _ct(21, B, G3, 3)
    return {
        "p2g_batched": (cuda_transfer.p2g_batched, cuda_transfer.p2g_plain_batched,
                        cuda_transfer.p2g_plain, [x, v, aff], [_ct(22, B, G3, 4)]),
        "grid_mass_batched": (cuda_transfer.grid_mass_batched,
                              cuda_transfer.grid_mass_plain_batched,
                              cuda_transfer.grid_mass_plain, [x], [_ct(23, B, G3)]),
        "g2p_batched": (cuda_transfer.g2p_batched, cuda_transfer.g2p_plain_batched,
                        cuda_transfer.g2p_plain, [x, grid_v],
                        [_ct(24, B, n, 3), _ct(25, B, n, 3, 3), _ct(26, B, n, 3)]),
    }


def _grid_op_inputs(scene):
    G3 = scene.simulator.n_grid ** 3
    rng = np.random.default_rng(2)
    g4 = rng.standard_normal((B, G3, 4)) * 1e-4
    g4[..., 3] = np.where(rng.random((B, G3)) < 0.25, 0.0,
                          np.abs(rng.standard_normal((B, G3))) * 1e-4 + 1e-6)
    pf, pf1 = _poses(3, 1)
    return torch.tensor(g4, dtype=F64), pf, pf1, torch.tensor([666.0, 0.0, 100.0], dtype=F64)


@pytest.mark.parametrize("name", ["p2g_batched", "grid_mass_batched", "g2p_batched",
                                  "grid_op_batched"])
def test_batched_wrappers_differentiate_their_plain_versions_on_the_cpu(name):
    """On CPU tensors that require grad a batched wrapper returns what its
    plain version returns, and autograd gives the plain version's VJP."""
    if name == "grid_op_batched":
        scene = _scene(prims=SHAPE_KW[:1])
        grid4, pf, pf1, softness = _grid_op_inputs(scene)
        inputs, cts = [grid4, *pf, *pf1], [_ct(28, B, grid4.shape[1], 3)]
        wrapper = lambda g, *ps: cuda_gridop.grid_op_batched(  # noqa: E731
            scene, g, ps[:3], ps[3:], softness)
        plain = lambda g, *ps: cuda_gridop.grid_op_plain_batched(  # noqa: E731
            scene, g, ps[:3], ps[3:], softness)
    else:
        scene = _scene(prims=())
        wrap, plain_b, _, inputs, cts = _transfer_cases(scene)[name]
        wrapper = lambda *a: wrap(scene, *a)  # noqa: E731
        plain = lambda *a: plain_b(scene, *a)  # noqa: E731
    got, want = _vjp(wrapper, inputs, cts), _vjp(plain, inputs, cts)
    assert float(want[0].abs().max()) > 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)
