"""The port's entry points take the reference's parameters in its order:
`make(env_name, nn=False, sdf_loss=10, ...)`, `PhysicsEnv(scene, nn=False,
loss=True)` and `VecPlasticineEnv(env_name, batch, seed=0, jitter=1e-3,
mesh=None, ...)`, with the port's `device` keyword only. `nn` is passed down and
changes nothing, as in the reference (`plasticinelab_tpu/engine/sim.py`: the
env sets `self.nn = None` and a caller attaches a policy later);
`loss=False` skips the goal and the loss state. On the CPU, on
tests/test_visual_obs.py's tiny scene."""
import inspect

import numpy as np
import pytest
import torch

from plasticinelab_tpu.engine.sim import PhysicsEnv as JaxPhysicsEnv
from plasticinelab_tpu.envs import make as jax_make
from plasticinelab_tpu.parallel.rollout import VecPlasticineEnv as JaxVecPlasticineEnv
from plasticinelab_tpu_torch.config import spec as tspec
from plasticinelab_tpu_torch.engine.sim import PhysicsEnv
from plasticinelab_tpu_torch.envs import make
from plasticinelab_tpu_torch.parallel import VecPlasticineEnv
from test_torch_visual_obs import _tiny_scene


def _positional(fn):
    """(name, default) of the parameters a caller may pass by position."""
    return [(p.name, p.default) for p in inspect.signature(fn).parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]


@pytest.mark.parametrize("port,ref", [(make, jax_make),
                                      (PhysicsEnv.__init__, JaxPhysicsEnv.__init__),
                                      (VecPlasticineEnv.__init__, JaxVecPlasticineEnv.__init__)],
                         ids=["make", "PhysicsEnv", "VecPlasticineEnv"])
def test_positional_parameters_are_the_references(port, ref):
    assert _positional(port) == _positional(ref)
    device = inspect.signature(port).parameters["device"]
    assert device.kind == device.KEYWORD_ONLY and device.default == "cuda"


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
