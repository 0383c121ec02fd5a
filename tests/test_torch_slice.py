"""The forward env slice of the port against the TPU package: one small
scene, built from the same spec and started from the same state, stepped
twice with seeded actions through the reference PhysicsEnv (env_step +
loss, jnp path on the CPU) and through the port's PhysicsEnv (plain
versions on the CPU). Compared: particle state x, v, C, F, primitive poses,
observation, loss, reward and IoU.

Tolerances, relative to each quantity's largest value: float64 1e-8 (the
same math in another summation order, after 2 x 5 substeps); float32 1e-4
(float32 rounding, amplified through 10 substeps of stress and contact).

Also the port alone: make("Move-v1", device="cpu") + reset + 1 step, and
the env surface of test_env.py (obs layout, clipping, reset, truncation,
get/set state) on its tiny scene."""
import dataclasses

import numpy as np
import pytest
import torch

from plasticinelab_tpu.config import spec as jspec
from plasticinelab_tpu.engine.sim import PhysicsEnv as JaxPhysicsEnv
from plasticinelab_tpu_torch.config import spec as tspec
from plasticinelab_tpu_torch.engine.sim import PhysicsEnv
from plasticinelab_tpu_torch.envs import make

TOL = {"float64": 1e-8, "float32": 1e-4}


def _scene(mod, dtype):
    sim = mod.SimulatorSpec(quality=0.25, n_particles=250, dtype=dtype,
                            yield_stress=50.0)
    prims = (
        mod.PrimitiveSpec(shape="Sphere", radius=0.05, init_pos=(0.4, 0.42, 0.5),
                          friction=0.9, action_dim=3, action_scale=(0.01,) * 3),
        mod.PrimitiveSpec(shape="Box", size=(0.04, 0.03, 0.05),
                          init_pos=(0.6, 0.45, 0.5), init_rot=(0.9, 0.1, 0.3, 0.0),
                          friction=0.5, action_dim=6,
                          action_scale=(0.01,) * 3 + (0.02,) * 3),
    )
    shapes = (mod.ShapeSpec(shape="sphere", init_pos=(0.5, 0.4, 0.5), radius=0.1,
                            n_particles=250),)
    env = mod.EnvSpec(loss=mod.LossSpec(target_path=""), n_observed_particles=50)
    return mod.SceneSpec(simulator=sim, primitives=prims, shapes=shapes, env=env)


def _goal(G):
    """A goal blob beside the initial cloud (mass per cell ~ p_mass)."""
    i = np.arange(G) + 0.5
    X, Y, Z = np.meshgrid(i, i, i, indexing="ij")
    blob = np.exp(-((X - 0.6 * G) ** 2 + (Y - 0.35 * G) ** 2 + (Z - 0.5 * G) ** 2) / 4.0)
    return blob * (1.0 / (2 * G)) ** 2


def _close(got, want, tol, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=name)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_two_env_steps_match_reference(dtype):
    tscene, jscene = _scene(tspec, dtype), _scene(jspec, dtype)
    assert dataclasses.asdict(tscene)["shapes"] == dataclasses.asdict(jscene)["shapes"]
    goal = _goal(tscene.simulator.n_grid)
    ref = JaxPhysicsEnv(jscene)
    ref.retarget(goal)
    ref.initialize()
    ours = PhysicsEnv(tscene, device="cpu")
    ours.retarget(goal)
    ours.initialize()
    tol = TOL[dtype]

    rng = np.random.default_rng(0)
    for step in range(2):
        action = rng.uniform(-1, 1, tscene.action_dim)
        ref.step(action)
        ours.step(action)
        ri, oi = ref.compute_loss(), ours.compute_loss()
        for k in ("loss", "reward", "iou", "incremental_iou", "density_loss",
                  "sdf_loss", "contact_loss"):
            assert np.isfinite(oi[k]), k
            np.testing.assert_allclose(oi[k], ri[k], rtol=tol, atol=tol * abs(ri["loss"]),
                                       err_msg=f"step {step} {k}")
        _close(ours.get_obs(), ref.get_obs(), tol, f"step {step} obs")
        rs, os_ = ref.state, ours.state
        for name in ("x", "v", "C", "F", "prim_pos", "prim_rot", "prim_gap"):
            _close(getattr(os_, name), getattr(rs, name), tol, f"step {step} {name}")
    assert ri["iou"] > 0  # the goal overlaps the cloud: IoU is exercised


def test_make_move_v1_port_only():
    env = make("Move-v1", device="cpu")
    obs, _ = env.reset()
    assert obs.shape == (200 * 6 + 2 * 7,) == env.observation_space.shape
    assert env.action_space.shape == (6,)
    action = np.random.default_rng(1).uniform(-1, 1, 6)
    obs, r, term, trunc, info = env.step(action)
    assert obs.shape == (1214,) and obs.dtype == np.float32
    assert np.isfinite(obs).all() and np.isfinite(r)
    assert np.isfinite(info["iou"]) and np.isfinite(info["incremental_iou"])
    assert not term and not trunc
    # the first sphere moved by its clipped action x scale
    te = env.unwrapped.taichi_env
    np.testing.assert_allclose(te.state.prim_pos[0].numpy(),
                               np.asarray(te.scene.primitives[0].init_pos) + 0.01 * action[:3],
                               atol=1e-6)
    assert te.state.x.dtype == torch.float32


@pytest.fixture(scope="module")
def tiny_env():
    """test_env.py's tiny scene on the port (1 Sphere, 200 particles)."""
    from plasticinelab_tpu_torch.envs.env import PlasticineEnv

    sim = tspec.SimulatorSpec(quality=0.25, n_particles=200, dtype="float32",
                              yield_stress=200.0)
    prim = tspec.PrimitiveSpec(shape="Sphere", radius=0.05, init_pos=(0.38, 0.5, 0.5),
                               friction=0.9, action_dim=3, action_scale=(0.01,) * 3)
    shape = tspec.ShapeSpec(shape="sphere", init_pos=(0.5, 0.5, 0.5), radius=0.06,
                            n_particles=200)
    scene = tspec.SceneSpec(simulator=sim, primitives=(prim,), shapes=(shape,),
                            env=tspec.EnvSpec(n_observed_particles=50))
    return PlasticineEnv("tiny.yml", 1, scene=scene, device="cpu", max_episode_steps=3)


def test_env_obs_reset_clip_and_truncation(tiny_env):
    env = tiny_env
    obs0, _ = env.reset()
    assert obs0.shape == (50 * 6 + 7,) == env.observation_space.shape
    np.testing.assert_allclose(obs0[-7:], [0.38, 0.5, 0.5, 1, 0, 0, 0], atol=1e-6)
    # actions beyond [-1, 1] are clipped (reference primitives.py:290)
    obs_a, *_ = env.step(np.asarray([5.0, 0.0, 0.0]))
    env.reset()
    obs_b, *_ = env.step(np.asarray([1.0, 0.0, 0.0]))
    np.testing.assert_array_equal(obs_a, obs_b)
    assert obs_b[-7] == pytest.approx(0.39, abs=1e-6)
    # reset restores the initial state; the episode limit truncates
    obs1, _ = env.reset()
    np.testing.assert_array_equal(obs0, obs1)
    truncs = [env.step(env.action_space.sample())[3] for _ in range(3)]
    assert truncs == [False, False, True]


def test_env_get_set_state_roundtrip(tiny_env):
    te = tiny_env.unwrapped.taichi_env
    tiny_env.reset()
    tiny_env.step(np.asarray([0.3, 0.3, 0.3]))
    snap = te.get_state()
    x_before = te.state.x.clone()
    tiny_env.step(np.asarray([-1.0, 0.5, 0.0]))
    te.set_state(**snap)
    assert torch.equal(te.state.x, x_before)
    assert snap["state"][0].shape == (200, 3) and snap["state"][4].shape == (7,)
