"""The port's optimizers and solver: Adam and Momentum step for step against
the reference package's optim.py, the device solve against the host solve,
the device solve's recovery from a non-finite rollout, and its checkpoint
resume (tests/test_solver.py carried over, on a tiny float64 scene)."""
import numpy as np
import pytest
import torch

from plasticinelab_tpu.optimizer import optim as joptim
from plasticinelab_tpu_torch.config import spec as tspec
from plasticinelab_tpu_torch.engine.sim import PhysicsEnv
from plasticinelab_tpu_torch.optimizer import optim, solver
from plasticinelab_tpu_torch.optimizer.solver import Solver
from test_torch_slice import _goal


def _scene(mod):
    """The tiny float64 scene, from either package's spec module."""
    sim = mod.SimulatorSpec(quality=0.25, n_particles=160, dtype="float64",
                            yield_stress=200.0)
    prim = mod.PrimitiveSpec(shape="Sphere", radius=0.05, init_pos=(0.4, 0.5, 0.5),
                             friction=0.9, action_dim=3, action_scale=(0.01, 0.01, 0.01))
    shape = mod.ShapeSpec(shape="sphere", init_pos=(0.5, 0.5, 0.5), radius=0.06,
                          n_particles=160)
    return mod.SceneSpec(simulator=sim, primitives=(prim,), shapes=(shape,),
                         env=mod.EnvSpec(loss=mod.LossSpec(target_path=""),
                                         n_observed_particles=20))


@pytest.fixture(scope="module")
def env():
    scene = _scene(tspec)
    env = PhysicsEnv(scene, device="cpu")
    env.retarget(_goal(scene.simulator.n_grid))
    return env


def _init_actions(horizon=3):
    return np.random.default_rng(3).uniform(-1e-4, 1e-4, (horizon, 3))


@pytest.mark.parametrize("name", ["Adam", "Momentum"])
def test_optimizers_match_reference(name):
    rng = np.random.default_rng(0)
    p0 = rng.uniform(-0.5, 0.5, (4, 3))
    kw = dict(lr=0.3, bounds=(-0.6, 0.6))
    ours = optim.OPTIMS[name](p0.copy(), optim.OptimizerConfig(type=name, **kw))
    ref = joptim.OPTIMS[name](p0.copy(), joptim.OptimizerConfig(type=name, **kw))
    for _ in range(10):
        g = rng.standard_normal((4, 3))
        np.testing.assert_array_equal(ours.step(g), ref.step(g))
    assert np.abs(ours.parameters).max() == 0.6  # the bounds clip was exercised


@pytest.mark.parametrize("optim_type", ["Adam", "Momentum"])
def test_device_solver_matches_host(env, optim_type):
    kw = {"optim.lr": 0.5, "optim.type": optim_type}
    host = Solver(env, None, None, n_iters=4, horizon=3, **kw)
    host_losses = []
    host_best = host.solve(init_actions=_init_actions(),
                           callbacks=((lambda s, o, l, g: host_losses.append(l)),))
    dev = Solver(env, None, None, n_iters=4, horizon=3, **kw)
    dev_best = dev.solve_device(init_actions=_init_actions(), chunk=3)
    # same rollout program and update rule, both float64
    assert len(set(host_losses)) == 4  # the actions moved the loss
    np.testing.assert_allclose(dev.iter_losses, host_losses, rtol=1e-10)
    np.testing.assert_allclose(dev_best, host_best, atol=1e-10)
    assert dev.best_loss == pytest.approx(host.best_loss, rel=1e-10)
    assert len(dev.chunk_seconds) == 2 and len(dev.iter_ious) == 4


def test_device_solver_recovers_from_non_finite_rollout(env, monkeypatch):
    """A non-finite rollout restarts from the best actions seen, with fresh
    moments and half the step (the reference package's b337530)."""
    calls = []
    real = solver.rollout_losses

    def flaky(scene, mats, loss_state, state0, actions, *args):
        calls.append(actions.detach().clone())
        comps, final = real(scene, mats, loss_state, state0, actions, *args)
        if len(calls) == 2:
            comps = comps * float("nan")
        return comps, final

    monkeypatch.setattr(solver, "rollout_losses", flaky)
    dev = Solver(env, None, None, n_iters=4, horizon=3,
                 **{"optim.lr": 0.5, "optim.type": "Momentum"})
    best = dev.solve_device(init_actions=_init_actions(), chunk=4)
    losses = dev.iter_losses
    assert np.isnan(losses[1]) and np.isfinite([losses[0], *losses[2:]]).all()
    # back to the only finite iterate, then a step from fresh moments at half
    # the rate: the same gradient, so half the first step
    torch.testing.assert_close(calls[2], calls[0], rtol=0, atol=0)
    torch.testing.assert_close(calls[3] - calls[2], 0.5 * (calls[1] - calls[0]),
                               rtol=1e-9, atol=1e-15)
    assert np.isfinite(best).all() and dev.best_loss == np.nanmin(losses)


def test_device_solver_checkpoint_resume(env, tmp_path):
    kw = {"optim.lr": 0.5, "optim.type": "Adam"}
    full = Solver(env, None, None, n_iters=4, horizon=3, **kw)
    full_best = full.solve_device(init_actions=_init_actions(), chunk=2)
    first = Solver(env, None, None, n_iters=2, horizon=3, **kw)
    first.solve_device(init_actions=_init_actions(), chunk=2, checkpoint_dir=str(tmp_path))
    assert (tmp_path / "ckpt_2.pkl").exists()
    second = Solver(env, None, None, n_iters=4, horizon=3, **kw)
    best = second.solve_device(init_actions=_init_actions(), chunk=2,
                               checkpoint_dir=str(tmp_path))
    np.testing.assert_allclose(second.iter_losses, full.iter_losses[2:], rtol=1e-12)
    np.testing.assert_allclose(best, full_best, atol=1e-12)


def test_device_solver_matches_reference_iterate_by_iterate(env):
    """Both packages' `solve_device` from the same seeded actions on the same
    tiny float64 scene: 4 Adam iterations, lr 0.1, softness 666. The
    per-iteration losses and the best actions agree to 1e-8 relative (the
    same float64 rollout and update rule; only the summation order of the
    transfers differs)."""
    from plasticinelab_tpu.config import spec as jspec
    from plasticinelab_tpu.engine.sim import PhysicsEnv as JaxPhysicsEnv
    from plasticinelab_tpu.optimizer.solver import Solver as JaxSolver

    jscene = _scene(jspec)
    ref = JaxPhysicsEnv(jscene)
    ref.retarget(_goal(jscene.simulator.n_grid))
    init = _init_actions()
    kw = {"optim.lr": 0.1, "optim.type": "Adam", "softness": 666.0}
    theirs = JaxSolver(ref, None, None, n_iters=4, horizon=3, **kw)
    their_best = theirs.solve_device(init_actions=init, chunk=4)
    ours = Solver(env, None, None, n_iters=4, horizon=3, **kw)
    our_best = ours.solve_device(init_actions=init, chunk=4)
    assert len(set(theirs.iter_losses)) == 4  # the actions moved the loss
    np.testing.assert_allclose(ours.iter_losses, theirs.iter_losses, rtol=1e-8)
    np.testing.assert_allclose(ours.iter_ious, theirs.iter_ious, rtol=1e-8)
    np.testing.assert_allclose(our_best, their_best, rtol=1e-8, atol=1e-12)
    assert ours.best_loss == pytest.approx(theirs.best_loss, rel=1e-8)
