"""The port's NN-policy solver against the TPU package's, on the tiny
float64 scene of tests/test_torch_solver.py with a (16, 16) policy over 20
observed particles:
- the 2-step NN rollout's loss and d loss / d params against the reference
  package's jitted value_and_grad of the same rollout
  (`optimizer/solver_nn.py:44-57`), within 1e-8 relative, under remat
  "none" and "env_step" (the non-reentrant checkpoint routes the gradient
  to the parameters its step closes over); the gradient non-zero and
  finite in every layer;
- `SolverNN.solve` against `solve_device` (1e-10: the same float64 rollout
  and update rule), and both against the reference's `SolverNN.solve`
  iterate by iterate over 3 Adam iterations, horizon 2 (1e-8);
- `solve_nn`: the replay of the best parameters writes one frame per step
  (tests/test_torch_visual_obs.py's tiny scene with its small renderer)."""
import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plasticinelab_tpu.config import spec as jspec
from plasticinelab_tpu.engine.nn import MLPPolicy as JaxMLPPolicy
from plasticinelab_tpu.engine.sim import PhysicsEnv as JaxPhysicsEnv
from plasticinelab_tpu.optimizer.solver_nn import SolverNN as JaxSolverNN
from plasticinelab_tpu_torch.config import spec as tspec
from plasticinelab_tpu_torch.engine import mpm
from plasticinelab_tpu_torch.engine.nn import MLPPolicy
from plasticinelab_tpu_torch.engine.sim import PhysicsEnv
from plasticinelab_tpu_torch.optimizer.solver_nn import SolverNN, nn_value_and_grad, solve_nn
from test_torch_slice import _goal
from test_torch_solver import _scene

F64_TOL = 1e-8
HORIZON = 2
POLICY = dict(hidden_dims=(16, 16), n_observed_particles=20)
KW = {"optim.lr": 50.0}  # x 0.001 inside


@pytest.fixture(scope="module")
def envs():
    """(port env, reference env, the reference solver with its jitted
    value_and_grad built), both with a (16, 16) policy attached."""
    scene = _scene(tspec)
    ours = PhysicsEnv(scene, device="cpu")
    ours.retarget(_goal(scene.simulator.n_grid))
    ours.nn = MLPPolicy(ours.scene, **POLICY)
    jscene = _scene(jspec)
    theirs = JaxPhysicsEnv(jscene)
    theirs.retarget(_goal(jscene.simulator.n_grid))
    theirs.nn = JaxMLPPolicy(theirs.scene, **POLICY)
    ref = JaxSolverNN(theirs, None, None, n_iters=3, horizon=HORIZON, **KW)
    ref._build(theirs.nn)
    return ours, theirs, ref


def _flat(policy):
    """A start that moves the manipulator: the reference's init_params(0),
    output biases raised so the sphere pushes into the cloud."""
    flat = policy.get_params(policy.init_params(0, jnp.float64))
    flat[-3:] += (0.8, -0.3, 0.2)
    return flat


@pytest.mark.parametrize("remat", ["none", "env_step"])
def test_two_step_value_and_grad_match_reference(envs, remat):
    ours, theirs, ref = envs
    flat = _flat(theirs.nn)
    loss_j, g_j = ref._vg(theirs.state, theirs.nn.set_params(flat, jnp.float64),
                          np.float64(666.0))
    g_j = theirs.nn.get_params(g_j)
    ours.nn.set_params(flat, torch.float64, device="cpu")
    loss, grad = nn_value_and_grad(ours, ours.nn, torch.as_tensor(flat), ours.state, HORIZON,
                                   666.0, remat)
    assert float(loss) == pytest.approx(float(loss_j), rel=F64_TOL)
    grad = grad.numpy()
    np.testing.assert_allclose(grad, g_j, rtol=0, atol=F64_TOL * np.abs(g_j).max())
    assert np.isfinite(grad).all()
    for name, part in ours.nn.unflatten(torch.as_tensor(grad)).items():
        assert part.abs().max() > 0, f"no gradient reaches {name}"
    if remat == "env_step":  # the same value as without recompute, through the plain ops too
        loss_p, grad_p = nn_value_and_grad(ours, ours.nn, torch.as_tensor(flat), ours.state,
                                           HORIZON, 666.0, "none", mpm.PLAIN_OPS)
        assert float(loss_p) == pytest.approx(float(loss), rel=1e-12)
        np.testing.assert_allclose(grad_p.numpy(), grad, rtol=0,
                                   atol=1e-12 * np.abs(grad).max())


def test_solve_and_solve_device_match_reference_iterate_by_iterate(envs):
    ours, theirs, ref = envs
    theirs.nn_params = None
    ref_losses = []
    ref_best = ref.solve(callbacks=((lambda s, o, l, g: ref_losses.append(l)),))
    ours.nn_params = None
    host = SolverNN(ours, None, None, n_iters=3, horizon=HORIZON, **KW)
    host_losses = []
    host_best = host.solve(callbacks=((lambda s, o, l, g: host_losses.append(l)),))
    ours.nn_params = None
    dev = SolverNN(ours, None, None, n_iters=3, horizon=HORIZON, **KW)
    dev_best = dev.solve_device(chunk=2)
    assert host.cfg.optim.lr == pytest.approx(0.05) and host.cfg.optim.bounds[1] == np.inf
    assert len(set(ref_losses)) == 3  # the parameters moved the loss
    np.testing.assert_allclose(host_losses, ref_losses, rtol=F64_TOL)
    np.testing.assert_allclose(host_best, ref_best, rtol=0, atol=F64_TOL)
    assert host.best_loss == pytest.approx(ref.best_loss, rel=F64_TOL)
    np.testing.assert_allclose(dev.iter_losses, host_losses, rtol=1e-10)
    np.testing.assert_allclose(dev_best, host_best, rtol=0, atol=1e-10)
    assert dev.best_loss == pytest.approx(host.best_loss, rel=1e-10)
    assert len(dev.chunk_seconds) == 2 and dev.total_steps == 3 * HORIZON
    # the best parameters are left on the env, and the next solve starts there
    np.testing.assert_array_equal(ours.nn.get_params(ours.nn_params), dev_best)
    again = SolverNN(ours, None, None, n_iters=1, horizon=HORIZON, **KW)
    again.solve_device()
    assert again.iter_losses[0] == pytest.approx(dev.best_loss, rel=1e-12)
    ours.nn_params = None


def test_solve_nn_replays_one_frame_per_step(tmp_path, monkeypatch):
    from plasticinelab_tpu_torch.envs.env import PlasticineEnv
    from test_torch_visual_obs import _tiny_scene

    env = PlasticineEnv("tiny.yml", 1, scene=_tiny_scene(tspec, "float64"), device="cpu",
                        max_episode_steps=2)
    taken = []
    real = SolverNN.solve_device

    def spy(self, *a, **kw):
        taken.append(self)
        return real(self, *a, **kw)

    monkeypatch.setattr(SolverNN, "solve_device", spy)
    acts = []
    real_step = PhysicsEnv.step
    monkeypatch.setattr(PhysicsEnv, "step", lambda self, a=None: (acts.append(a),
                                                                  real_step(self, a))[1])
    args = SimpleNamespace(num_steps=4, softness=666.0, lr=0.1, optim="Adam")
    params = solve_nn(env, str(tmp_path), None, args)
    te = env.unwrapped.taichi_env
    assert isinstance(te.nn, MLPPolicy) and te.nn.dims[1:] == (256, 256, 3)
    assert taken[0].cfg.n_iters == 2 and np.isfinite(params).all()
    assert len(os.listdir(tmp_path)) == 2
    # the replay acts with the best parameters from the reset state
    te.set_state(**env._init_state)
    ptree = te.nn.set_params(params, torch.float64, device="cpu")
    with torch.no_grad():
        want = te.nn.act(ptree, te.state).numpy()
    np.testing.assert_array_equal(acts[0], want)
