"""The visual-observation path and the rendering entry points of the port,
on tests/test_visual_obs.py's tiny scene, on the CPU: the rgb observation
mode of the env (shape, dtype, space, step, reset), the interleave of state
and rgb observations on one PhysicsEnv (the reference package's round-4
regression), `render_obs` against the reference package's with its draws
replayed (pixel values within 1e-5: the same float32 operations, reductions
summed in another order), `render`, and `solve_action` writing its images."""
import os
from types import SimpleNamespace

import numpy as np
import pytest

import jax
from plasticinelab_tpu.config import spec as jspec
from plasticinelab_tpu.engine.sim import PhysicsEnv as JaxPhysicsEnv
from plasticinelab_tpu_torch.config import spec as tspec
from plasticinelab_tpu_torch.engine.sim import PhysicsEnv
from plasticinelab_tpu_torch.envs import make
from plasticinelab_tpu_torch.envs.env import PlasticineEnv
from plasticinelab_tpu_torch.optimizer.solver import solve_action
from test_torch_renderer import pass_draws, replay

RES = 16


def _tiny_scene(mod, dtype="float32"):
    sim = mod.SimulatorSpec(quality=0.25, n_particles=200, dtype=dtype, yield_stress=200.0)
    prim = mod.PrimitiveSpec(shape="Sphere", radius=0.05, init_pos=(0.38, 0.5, 0.5),
                             friction=0.9, action_dim=3, action_scale=(0.01, 0.01, 0.01))
    shape = mod.ShapeSpec(shape="sphere", init_pos=(0.5, 0.5, 0.5), radius=0.06,
                          n_particles=200)
    ren = mod.RendererSpec(spp=1, image_res=(48, 48), voxel_res=(32, 32, 32),
                           target_res=(16, 16, 16), use_directional_light=False)
    return mod.SceneSpec(simulator=sim, primitives=(prim,), shapes=(shape,), renderer=ren,
                         env=mod.EnvSpec(loss=mod.LossSpec(target_path=""),
                                         n_observed_particles=50))


@pytest.fixture(scope="module")
def rgb_env():
    return PlasticineEnv("tiny.yml", 1, scene=_tiny_scene(tspec), device="cpu",
                         obs_mode="rgb", image_obs_res=RES, image_obs_spp=1)


def test_rgb_obs_shape_and_space(rgb_env):
    obs, _ = rgb_env.reset()
    assert obs.shape == (RES, RES, 3) and obs.dtype == np.uint8
    space = rgb_env.observation_space
    assert space.shape == (RES, RES, 3) and space.dtype == np.uint8
    assert space.low.min() == 0 and space.high.max() == 255
    assert obs.max() > 0  # not all black


def test_rgb_step_and_reset(rgb_env):
    obs0, _ = rgb_env.reset()
    obs, r, term, trunc, info = rgb_env.step(np.asarray([1.0, 0.0, 0.0]))
    assert obs.shape == (RES, RES, 3) and obs.dtype == np.uint8
    assert np.isfinite(r) and not term and not trunc  # (no goal: the IoU is 0/0)
    assert rgb_env.taichi_env._obs_renderer_key == (RES, 1)
    obs1, _ = rgb_env.reset()
    assert obs1.shape == obs0.shape and obs1.max() > 0


def test_make_rgb_keywords():
    env = make("Move-v1", device="cpu", obs_mode="rgb", image_obs_res=8, image_obs_spp=1)
    assert env.observation_space.shape == (8, 8, 3)
    assert env.observation_space.dtype == np.uint8
    with pytest.raises(ValueError):
        make("Move-v1", device="cpu", obs_mode="depth")


def test_get_obs_render_obs_interleave():
    """render_obs must not disturb the state observation (the reference
    package's round-4 regression, tests/test_visual_obs.py:211)."""
    te = PhysicsEnv(_tiny_scene(tspec), device="cpu")
    obs0 = te.get_obs()
    img = te.render_obs(res=RES, spp=1)
    assert img.shape == (RES, RES, 3) and img.dtype == np.uint8
    te.step(np.zeros(3))
    te.compute_loss()
    obs1 = te.get_obs()
    assert obs1.shape == obs0.shape and not np.array_equal(obs1, obs0)
    img2 = te.render_obs(res=RES, spp=1)
    assert img2.shape == (RES, RES, 3)
    np.testing.assert_array_equal(te.get_obs(), obs1)


def test_render_obs_matches_reference_with_replayed_draws():
    ref = JaxPhysicsEnv(_tiny_scene(jspec))
    ours = PhysicsEnv(_tiny_scene(tspec), device="cpu")
    want = ref.render_obs(res=RES, spp=1)
    # the reference's first observation key (sim.py:376-377) and its one
    # pass (renderer.py:886-888)
    _, sub = jax.random.split(jax.random.PRNGKey(0))
    ours.render_obs(res=RES, spp=1)  # builds the observation renderer
    ours._obs_renderer.uniform = replay(
        pass_draws(jax.random.fold_in(sub, 0), 1, RES, RES, 2, False))
    got = ours.render_obs(res=RES, spp=1)
    np.testing.assert_array_equal(got, want)
    assert got.max() > 0


def test_render_frame_entry():
    te = PhysicsEnv(_tiny_scene(tspec), device="cpu")
    img = te.render(mode="rgb_array")
    assert img.shape == (48, 48, 3) and img.dtype == np.uint8 and img.max() > 0
    te.set_copy(False)
    with pytest.raises(RuntimeError):
        te.render()


def test_solve_action_writes_one_image_per_step(tmp_path):
    env = PlasticineEnv("tiny.yml", 1, scene=_tiny_scene(tspec, "float64"), device="cpu",
                        max_episode_steps=3)
    args = SimpleNamespace(num_steps=6, softness=666.0, lr=0.1, optim="Adam")
    actions = solve_action(env, str(tmp_path), None, args)
    assert actions.shape == (3, 3) and np.isfinite(actions).all()
    files = sorted(os.listdir(tmp_path))
    assert [f.split(".")[0] for f in files] == ["0000", "0001", "0002"]
    if files[0].endswith(".npy"):
        img = np.load(tmp_path / files[0])
        assert img.shape == (48, 48, 3) and img.dtype == np.uint8


@pytest.mark.parametrize("host_loop", [False, True])
def test_solve_action_honours_host_loop(tmp_path, monkeypatch, host_loop):
    """`args.host_loop` takes `Solver.solve` (the host optimizers), its
    absence or False `Solver.solve_device`, as the reference package's
    `solve_action` (`optimizer/solver.py:318-321`); both return finite
    actions of the episode's shape and a finite best loss."""
    from plasticinelab_tpu_torch.optimizer.solver import Solver

    taken = []
    for name in ("solve", "solve_device"):
        real = getattr(Solver, name)

        def spy(self, *a, _real=real, _name=name, **kw):
            taken.append(_name)
            spy.solver = self
            return _real(self, *a, **kw)

        monkeypatch.setattr(Solver, name, spy)
    env = PlasticineEnv("tiny.yml", 1, scene=_tiny_scene(tspec, "float64"), device="cpu",
                        max_episode_steps=2)
    args = SimpleNamespace(num_steps=4, softness=666.0, lr=0.1, optim="Adam")
    if host_loop:
        args.host_loop = True
    actions = solve_action(env, str(tmp_path), None, args)
    assert taken == ["solve" if host_loop else "solve_device"]
    assert actions.shape == (2, 3) and np.isfinite(actions).all()
    assert np.isfinite(spy.solver.best_loss)
    assert len(os.listdir(tmp_path)) == 2


def test_env_seed_seeds_the_solvers_initial_actions():
    """`PlasticineEnv.seed` seeds numpy's global generator as the reference
    package's env does (`envs/env.py:104-105`): two envs seeded alike give
    equal `Solver.init_actions`, equal to the reference package's after the
    same seed, and another seed gives others."""
    from plasticinelab_tpu.envs.env import PlasticineEnv as JaxEnv
    from plasticinelab_tpu.optimizer.solver import Solver as JaxSolver, SolverConfig as JaxCfg
    from plasticinelab_tpu_torch.optimizer.solver import Solver, SolverConfig

    cfg = dict(horizon=4, init_range=0.5)
    draws = []
    for _ in range(2):
        env = PlasticineEnv("tiny.yml", 1, scene=_tiny_scene(tspec), device="cpu")
        env.seed(7)
        draws.append(Solver.init_actions(env.taichi_env, SolverConfig(**cfg)))
    np.testing.assert_array_equal(draws[0], draws[1])
    assert draws[0].shape == (4, 3) and np.abs(draws[0]).max() > 0
    ref = JaxEnv("", scene=_tiny_scene(jspec))
    ref.seed(7)
    np.testing.assert_array_equal(draws[0], JaxSolver.init_actions(ref.taichi_env, JaxCfg(**cfg)))
    env.seed(8)
    assert not np.array_equal(draws[0], Solver.init_actions(env.taichi_env, SolverConfig(**cfg)))


def test_taichi_env_alias():
    """`sim.TaichiEnv` names `PhysicsEnv`, for users of the reference's name
    (`plasticinelab_tpu/engine/sim.py:385`)."""
    from plasticinelab_tpu_torch.engine import sim

    assert sim.TaichiEnv is sim.PhysicsEnv
