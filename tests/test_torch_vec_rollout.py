"""The port's batched env `VecPlasticineEnv` on the CPU (the plain versions)
against the TPU package's `VecPlasticineEnv`, on tests/test_vec_rollout.py's
tiny scene: B = 4, the TPU package's jittered initial states carried across,
3 seeded steps. Compared: obs, reward, done and info's loss, iou and
incremental_iou. Tolerances: float64 1e-8 relative to each quantity's
largest value (the same math in another summation order, over 3 x 5
substeps); float32 rtol 2e-4 / atol 1e-5, the bound
tests/test_vec_rollout.py holds its own batched env to against the
single env (float32 rounding through stress and contact), with atol raised
to 2e-5 of the quantity's largest value where that is larger: the
observation's velocities at the contact differ by up to 1.8e-5 on a 0.035
component (1.4e-5 of the largest velocity, 1.28) after 3 steps.

Also the semantics of tests/test_vec_rollout.py on the port alone: shapes,
decorrelated jittered envs, entry 0 equal to the port's single-env reward
and incremental IoU, seeded starts and the default device. The rgb mode:
tests/test_torch_vec_rgb.py."""
import inspect

import numpy as np
import pytest
import torch

from plasticinelab_tpu.config import spec as jspec
from plasticinelab_tpu.parallel.rollout import VecPlasticineEnv as JaxVecPlasticineEnv
from plasticinelab_tpu_torch.config import spec as tspec
from plasticinelab_tpu_torch.engine import cuda_transfer, losses, mpm
from plasticinelab_tpu_torch.engine.sim import PhysicsEnv
from plasticinelab_tpu_torch.engine.state import (
    default_materials, initial_state, states_from_numpy,
)
from plasticinelab_tpu_torch.parallel import VecPlasticineEnv

TOL = {"float64": dict(rtol=0, rel=1e-8), "float32": dict(rtol=2e-4, atol=1e-5, rel=2e-5)}


def _tiny(mod, dtype="float32", n=32):
    sim = mod.SimulatorSpec(quality=0.25, n_particles=n, dtype=dtype)
    prim = mod.PrimitiveSpec(shape="Sphere", radius=0.08, init_pos=(0.45, 0.5, 0.5),
                             friction=0.9, action_dim=3, action_scale=(0.01,) * 3)
    scene = mod.SceneSpec(simulator=sim, primitives=(prim,),
                          env=mod.EnvSpec(loss=mod.LossSpec(), n_observed_particles=16))
    rng = np.random.default_rng(0)
    particles = rng.random((n, 3)) * 0.2 + 0.4
    G = sim.n_grid
    target = np.zeros((G, G, G))
    target[6:10, 3:7, 6:10] = sim.p_mass * 4
    return scene, particles, target


def _vec(batch=4, jitter=1e-3, seed=0, horizon=5, **kw):
    scene, particles, target = _tiny(tspec, **kw)
    return VecPlasticineEnv(None, batch=batch, scene=scene, jitter=jitter, seed=seed,
                            target_density=target, particles=particles, horizon=horizon,
                            device="cpu")


def _agree(got, want, dtype, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    tol = TOL[dtype]
    atol = max(tol.get("atol", 0.0), tol["rel"] * np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=tol["rtol"], atol=atol, err_msg=name)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_vec_env_matches_reference(dtype):
    jscene, particles, target = _tiny(jspec, dtype)
    tscene, _, _ = _tiny(tspec, dtype)
    B, horizon = 4, 3
    ref = JaxVecPlasticineEnv(None, batch=B, scene=jscene, jitter=1e-3, target_density=target,
                              particles=particles, horizon=horizon)
    ours = VecPlasticineEnv(None, batch=B, scene=tscene, jitter=1e-3, target_density=target,
                            particles=particles, horizon=horizon, device="cpu")
    ours._init_states = states_from_numpy([np.asarray(a) for a in ref._init_states], "cpu",
                                          ours.dtype)
    assert abs(ours._target_iou - ref._target_iou) <= 1e-12
    _agree(ours.reset(), ref.reset(), dtype, "reset obs")
    rng = np.random.default_rng(0)
    for step in range(horizon):
        a = rng.uniform(-1, 1, (B, ours.action_dim))
        o, r, d, info = ours.step(a)
        ro, rr, rd, rinfo = ref.step(a)
        _agree(o, ro, dtype, f"step {step} obs")
        _agree(r, rr, dtype, f"step {step} reward")
        for k in ("loss", "iou", "incremental_iou"):
            _agree(info[k], rinfo[k], dtype, f"step {step} {k}")
        np.testing.assert_array_equal(d.numpy(), np.asarray(rd))
    assert bool(d.all()) and float(r.abs().max()) > 0


def test_vec_reset_and_step_shapes():
    ve = _vec()
    obs = ve.reset()
    assert obs.shape == (4, ve.obs_dim) and ve.obs_dim == 16 * 6 + 7
    obs, reward, done, info = ve.step(np.zeros((4, ve.action_dim), np.float32))
    assert obs.shape == (4, ve.obs_dim) and reward.shape == done.shape == (4,)
    assert all(info[k].shape == (4,) for k in ("loss", "iou", "incremental_iou"))
    assert torch.isfinite(obs).all() and torch.isfinite(reward).all()
    assert not bool(done[0]) and done.dtype == torch.bool


def test_vec_envs_decorrelate():
    ve = _vec()
    ve.reset()
    rng = np.random.default_rng(1)
    for _ in range(2):
        obs, *_ = ve.step(rng.uniform(-0.5, 0.5, (4, ve.action_dim)))
    assert not torch.allclose(obs[0], obs[1])  # jittered starts diverge


def test_vec_matches_single_env_semantics():
    """Batch entry 0 with zero jitter reproduces the port's single-env
    step's reward (is_copy mode: r = start_loss - loss_t)."""
    ve = _vec(batch=2, jitter=0.0)
    ve.reset()
    a = np.full((2, 3), 0.1, np.float32)
    _, reward, _, _ = ve.step(a)

    scene, particles, target = _tiny(tspec)
    scene = scene.with_n_particles(len(particles))
    st = initial_state(scene, particles, "cpu", torch.float32)
    ls = losses.make_loss_state(scene, target, "cpu", torch.float32)
    start = losses.loss_and_components(scene, ls, st, cuda_transfer.grid_mass(scene, st.x))
    st1, gm = mpm.env_step_with_grid_m(scene, default_materials(scene), st, a[0], 666.0)
    l1 = losses.loss_and_components(scene, ls, st1, gm)
    np.testing.assert_allclose(float(reward[0]), float(start["loss"] - l1["loss"]), rtol=2e-4,
                               atol=1e-5)


def test_vec_incremental_iou_matches_host_env(tmp_path):
    """info["incremental_iou"] equals the port's PhysicsEnv.compute_loss
    incremental_iou for the same scene, goal and actions (the benchmark's
    headline metric, reference loss.py:293-294)."""
    sim = tspec.SimulatorSpec(quality=0.25, n_particles=64, dtype="float32")
    prim = tspec.PrimitiveSpec(shape="Sphere", radius=0.08, init_pos=(0.45, 0.5, 0.5),
                               friction=0.9, action_dim=3, action_scale=(0.01,) * 3)
    shape = tspec.ShapeSpec(shape="sphere", init_pos=(0.55, 0.5, 0.5), radius=0.06,
                            n_particles=64)
    G = sim.n_grid
    target = np.zeros((G, G, G))
    target[6:12, 5:11, 6:12] = sim.p_mass * 4
    tpath = tmp_path / "goal.npy"
    np.save(tpath, target)
    scene = tspec.SceneSpec(simulator=sim, primitives=(prim,), shapes=(shape,),
                            env=tspec.EnvSpec(loss=tspec.LossSpec(target_path=str(tpath)),
                                              n_observed_particles=16))
    host = PhysicsEnv(scene, device="cpu")
    host.initialize()
    # the goal comes from the scene's target_path, as in the host env
    ve = VecPlasticineEnv(None, batch=2, scene=scene, jitter=0.0, horizon=4,
                          particles=np.asarray(host.init_particles), device="cpu")
    ve.reset()
    assert abs(ve._target_iou - host._target_iou) < 1e-6
    rng = np.random.default_rng(3)
    for _ in range(3):
        a = rng.uniform(-0.5, 0.5, 3).astype(np.float32)
        host.step(a)
        hinfo = host.compute_loss()
        _, _, _, vinfo = ve.step(np.tile(a, (2, 1)))
    vinc = vinfo["incremental_iou"].numpy()
    np.testing.assert_allclose(vinc[0], hinfo["incremental_iou"], rtol=5e-3, atol=1e-5)
    np.testing.assert_allclose(vinc[0], vinc[1], atol=1e-6)  # jitter 0


def test_seeded_starts():
    a, b, c = _vec(seed=7), _vec(seed=7), _vec(seed=8)
    assert torch.equal(a._init_states.x, b._init_states.x)
    assert not torch.equal(a._init_states.x, c._init_states.x)
    d = a._init_states.x - _vec(jitter=0.0)._init_states.x
    assert 0 < float(d.abs().max()) <= 1e-3 + 1e-7  # uniform(-jitter, jitter)
    assert not torch.equal(a._init_states.x[0], a._init_states.x[1])


def test_vec_env_runs_on_the_card_by_default():
    assert inspect.signature(VecPlasticineEnv).parameters["device"].default == "cuda"


def test_vec_env_from_task_name():
    """Move-v1 by name (its spec, initial cloud and goal), B = 2 without
    jitter, one step through the plain versions: both envs equal the port's
    make("Move-v1") stepped with the same action (the single-env slice's
    float32 bound, 1e-4 of the largest value)."""
    from plasticinelab_tpu_torch.envs import make

    ve = VecPlasticineEnv("Move-v1", batch=2, jitter=0.0, device="cpu")
    assert ve.scene.simulator.n_particles == 10000 and ve.obs_dim == 200 * 6 + 2 * 7
    env = make("Move-v1", device="cpu")
    obs0, _ = env.reset()
    a = np.random.default_rng(0).uniform(-1, 1, 6)
    obs1, reward1, *_ = env.step(a)
    vobs0 = ve.reset()
    vobs1, vreward1, _, _ = ve.step(np.stack([a, a]))
    for got, want in ((vobs0, obs0), (vobs1, obs1)):
        assert got.shape == (2, 1214)
        for b in range(2):
            np.testing.assert_allclose(got[b].numpy(), want, rtol=0,
                                       atol=1e-4 * np.abs(want).max())
    # the reward, a difference of two losses ~13.27, to float32 rounding
    np.testing.assert_allclose(vreward1.numpy(), [reward1] * 2, rtol=0, atol=2e-5)
