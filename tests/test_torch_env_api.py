"""The port's entry points take the reference's parameters in its order,
with the port's `device` keyword only wherever it appears: `make(env_name,
nn=False, sdf_loss=10, ...)`, `PhysicsEnv(scene, nn=False, loss=True)`,
`VecPlasticineEnv(env_name, batch, seed=0, jitter=1e-3, mesh=None, ...)`,
`PlasticineEnv(cfg_path, version=1, nn=False, scene=None, ...)`,
`build_batched_rollout_grad(scene, mats, loss_state, mesh=None,
axis_name="env", out_mode="force")` (the reference's `mesh` has no
default), `Timer(name="", print_on_exit=True)`, `checkpoint.load(path,
device_put=False)`, `load_scene(path, version=1)` and the NN solver's and
SAC's entry points. `nn` is passed down and changes nothing, as in the
reference (`plasticinelab_tpu/engine/sim.py`: the env sets `self.nn = None`
and a caller attaches a policy later); `loss=False` skips the goal and the
loss state. On the CPU, on tests/test_visual_obs.py's tiny scene."""
import inspect
import os

import numpy as np
import pytest
import torch

from plasticinelab_tpu.algorithms.logger import Logger as JaxLogger
from plasticinelab_tpu.algorithms.sac import run_sac as jax_run_sac
from plasticinelab_tpu.algorithms.sac.sac import SAC as JaxSAC
from plasticinelab_tpu.algorithms.solve import get_args as jax_get_args
from plasticinelab_tpu.config.loader import load_scene as jax_load_scene
from plasticinelab_tpu.engine.nn import MLPPolicy as JaxMLPPolicy
from plasticinelab_tpu.engine.sim import PhysicsEnv as JaxPhysicsEnv
from plasticinelab_tpu.envs import make as jax_make
from plasticinelab_tpu.envs.env import PlasticineEnv as JaxPlasticineEnv
from plasticinelab_tpu.optimizer.solver_nn import SolverNN as JaxSolverNN
from plasticinelab_tpu.parallel.mesh import (
    build_batched_rollout_grad as jax_build_batched_rollout_grad)
from plasticinelab_tpu.parallel.rollout import VecPlasticineEnv as JaxVecPlasticineEnv
from plasticinelab_tpu.utils import checkpoint as jax_checkpoint
from plasticinelab_tpu.utils.timer import Timer as JaxTimer
from plasticinelab_tpu_torch.algorithms.logger import Logger
from plasticinelab_tpu_torch.algorithms.sac import run_sac
from plasticinelab_tpu_torch.algorithms.sac.sac import SAC
from plasticinelab_tpu_torch.algorithms.solve import get_args
from plasticinelab_tpu_torch.config import spec as tspec
from plasticinelab_tpu_torch.config.loader import load_scene
from plasticinelab_tpu_torch.engine.nn import MLPPolicy
from plasticinelab_tpu_torch.engine.sim import PhysicsEnv
from plasticinelab_tpu_torch.envs import make
from plasticinelab_tpu_torch.envs.env import SPEC_DIR, PlasticineEnv
from plasticinelab_tpu_torch.optimizer.solver_nn import SolverNN
from plasticinelab_tpu_torch.parallel import VecPlasticineEnv, build_batched_rollout_grad
from plasticinelab_tpu_torch.utils import checkpoint
from plasticinelab_tpu_torch.utils.timer import Timer
from test_torch_visual_obs import _tiny_scene

EMPTY = inspect.Parameter.empty


def _positional(fn):
    """(name, default) of the parameters a caller may pass by position."""
    return [(p.name, p.default) for p in inspect.signature(fn).parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]


ENTRY_POINTS = {
    "make": (make, jax_make),
    "PhysicsEnv": (PhysicsEnv.__init__, JaxPhysicsEnv.__init__),
    "VecPlasticineEnv": (VecPlasticineEnv.__init__, JaxVecPlasticineEnv.__init__),
    "build_batched_rollout_grad": (build_batched_rollout_grad, jax_build_batched_rollout_grad),
    "PlasticineEnv": (PlasticineEnv.__init__, JaxPlasticineEnv.__init__),
    "Timer": (Timer.__init__, JaxTimer.__init__),
    "checkpoint.load": (checkpoint.load, jax_checkpoint.load),
    "load_scene": (load_scene, jax_load_scene),
    "MLPPolicy": (MLPPolicy.__init__, JaxMLPPolicy.__init__),
    "SolverNN": (SolverNN.__init__, JaxSolverNN.__init__),
    "SAC": (SAC.__init__, JaxSAC.__init__),
    "Logger": (Logger.__init__, JaxLogger.__init__),
    "train": (run_sac.train, jax_run_sac.train),
    "train_vec": (run_sac.train_vec, jax_run_sac.train_vec),
    "get_args": (get_args, jax_get_args),
}


@pytest.mark.parametrize("port,ref", list(ENTRY_POINTS.values()), ids=list(ENTRY_POINTS))
def test_positional_parameters_are_the_references(port, ref):
    ours, theirs = _positional(port), _positional(ref)
    assert [n for n, _ in ours] == [n for n, _ in theirs]
    # the port may default a parameter the reference requires: only mesh=None
    for (name, mine), (_, want) in zip(ours, theirs):
        assert mine == want or (want is EMPTY and name == "mesh" and mine is None), name
    device = inspect.signature(port).parameters.get("device")
    if device is not None:
        assert device.kind == device.KEYWORD_ONLY and device.default == "cuda"
    others = [p for p in inspect.signature(port).parameters.values()
              if p.kind == p.KEYWORD_ONLY and p.name not in ("device", "max_episode_steps")]
    assert not others, others


def _stepped(env):
    env.step(np.asarray([0.5, -0.3, 0.2]))
    return env.state.x.clone(), env.get_obs()


def test_nn_changes_nothing():
    scene = _tiny_scene(tspec)
    plain, with_nn = PhysicsEnv(scene, device="cpu"), PhysicsEnv(scene, True, device="cpu")
    assert with_nn.nn is None and plain.nn is None
    (x0, obs0), (x1, obs1) = _stepped(plain), _stepped(with_nn)
    assert torch.equal(x0, x1) and np.array_equal(obs0, obs1)
    np.testing.assert_equal(with_nn.compute_loss(), plain.compute_loss())  # NaN IoU: no goal
    env = make("Move-v1", True, device="cpu")
    assert env.taichi_env.nn is None


def test_loss_false_skips_the_goal_and_the_loss():
    scene = _tiny_scene(tspec)
    full, bare = PhysicsEnv(scene, device="cpu"), PhysicsEnv(scene, False, False, device="cpu")
    assert bare.loss_state is None and not hasattr(bare, "target_density")
    (x0, obs0), (x1, obs1) = _stepped(full), _stepped(bare)
    assert torch.equal(x0, x1) and np.array_equal(obs0, obs1)
    bare.initialize()
    assert np.array_equal(bare.get_obs(), PhysicsEnv(scene, device="cpu").get_obs())
    bare.set_state(**full.get_state())
    assert torch.equal(bare.state.x, full.state.x)


def test_batched_rollout_grad_takes_mesh_by_position():
    scene = _tiny_scene(tspec)
    env = PhysicsEnv(scene, device="cpu")
    args = (env.scene, env.mats, env.loss_state)
    for out_mode in ("force", "auto"):
        step = build_batched_rollout_grad(*args, None, "env", out_mode, device="cpu")
        assert step.device == torch.device("cpu")
    with pytest.raises(NotImplementedError, match="A15"):
        build_batched_rollout_grad(*args, object())  # no longer taken for a device
    with pytest.raises(ValueError, match="out_mode"):
        build_batched_rollout_grad(*args, None, "env", "replicated", device="cpu")


def test_plasticine_env_resolves_the_spec_of_its_config(tmp_path):
    want = load_scene(os.path.join(SPEC_DIR, "move-v2.json"))
    assert PlasticineEnv._load_scene("envs/tasks/move.yml", 2) == want
    assert PlasticineEnv._load_scene(os.path.join(SPEC_DIR, "move-v2.json"), 1) == want
    with pytest.raises(FileNotFoundError, match="PyYAML"):
        PlasticineEnv._load_scene(str(tmp_path / "custom.yml"), 1)
    env = PlasticineEnv("tiny.yml", 1, True, _tiny_scene(tspec), device="cpu",
                        max_episode_steps=2)
    assert env.cfg_path == "tiny.yml" and env.taichi_env.nn is None
    assert env._max_episode_steps == 2 and env.obs_mode == "state"


def test_timer_prints_its_name_unless_asked_not_to(capsys):
    with Timer("[solver] iter 3") as t:
        pass
    out = capsys.readouterr().out
    assert out.startswith("[solver] iter 3: ") and out.rstrip().endswith("s")
    assert t.elapsed >= 0
    with Timer("quiet", print_on_exit=False) as t:
        pass
    assert capsys.readouterr().out == "" and t.elapsed >= 0


def test_checkpoint_load_device_put_and_load_scene_version(tmp_path):
    path = str(tmp_path / "ckpt_1.pkl")
    checkpoint.save(path, {"iter": 1, "a": torch.arange(3.0), "b": [np.ones(2), 0.5]})
    host = checkpoint.load(path)
    assert isinstance(host["a"], np.ndarray) and isinstance(host["b"][0], np.ndarray)
    dev = checkpoint.load(path, True, device="cpu")
    assert isinstance(dev["a"], torch.Tensor) and torch.equal(dev["a"], torch.arange(3.0))
    assert isinstance(dev["b"][0], torch.Tensor) and dev["b"][1] == 0.5 and dev["iter"] == 1
    spec = os.path.join(SPEC_DIR, "torus-v3.json")
    assert load_scene(spec, 5) == load_scene(spec) == load_scene(spec, version=1)
