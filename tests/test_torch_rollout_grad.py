"""The port's trajectory gradient against the TPU package, and the gradient
checks of tests/test_rollout_grad.py carried over to the port.

`PhysicsEnv.rollout_value_and_grad` (loss summed over the steps, gradient
with respect to the (horizon, action_dim) actions) on test_torch_slice.py's
small scene (a Sphere and a rotated Box beside a sphere of 250 particles),
started from the same numpy state and fed the same numpy actions in both
packages:
- smooth: both manipulators far from the cloud, F and v perturbed (the
  configuration of test_rollout_grad.py:42-56), 2 steps;
- contact: the manipulators start touching the cloud, 2 steps, float64
  only: in float32, rounding moves cells across the contact condition and
  the gradient by ~2e-2 of its largest entry.
Tolerances relative to the largest value: float64 1e-8 (the same math in
another summation order); the port in float32 against the reference in
float64, smooth configuration, 3e-3 (float32 rounding through 10 substeps
of stress and their adjoints).

The physics has jump discontinuities (the contact condition, boundaries):
finite differences and the remat equality use the smooth configuration;
rich contact is checked for finite gradients, and descent under Adam in
the smooth regime (the contact-distance loss pulls the manipulators)."""
import numpy as np
import pytest
import torch

from plasticinelab_tpu.engine.sim import PhysicsEnv as JaxPhysicsEnv
from plasticinelab_tpu_torch.engine import mpm
from plasticinelab_tpu_torch.engine.sim import PhysicsEnv, rollout_losses
from plasticinelab_tpu_torch.optimizer.optim import Adam, OptimizerConfig
from test_torch_slice import _goal, _scene
from plasticinelab_tpu.config import spec as jspec
from plasticinelab_tpu_torch.config import spec as tspec

F64_TOL = 1e-8
F32_TOL = 3e-3
SOFTNESS = 666.0
FAR = {"smooth": ((0.85, 0.85, 0.85), (0.15, 0.85, 0.85)), "contact": None}


def _state(env, config):
    """The numpy state list of `config`, from the env's initial state."""
    env.initialize()
    st = env.get_state()["state"]
    if FAR[config] is not None:
        rng = np.random.default_rng(7)
        n = st[0].shape[0]
        st[1] = 0.05 * rng.standard_normal((n, 3))
        st[2] = np.eye(3) + 0.02 * rng.standard_normal((n, 3, 3))
        for i, pos in enumerate(FAR[config]):
            st[4 + i] = np.concatenate([pos, st[4 + i][3:]])
    return st


def _actions(config, horizon=2):
    scale = 0.5 if config == "smooth" else 1.0
    return np.random.default_rng(1).uniform(-scale, scale, (horizon, 9))


def _port_env(dtype="float64"):
    env = PhysicsEnv(_scene(tspec, dtype), device="cpu")
    env.retarget(_goal(env.scene.simulator.n_grid))
    return env


@pytest.fixture(scope="module")
def reference():
    """JAX float64 loss and gradient for both configurations (one compile)."""
    env = JaxPhysicsEnv(_scene(jspec, "float64"))
    env.retarget(_goal(env.scene.simulator.n_grid))
    out = {}
    for config in FAR:
        env.set_state(_state(env, config), SOFTNESS, False)
        loss, grad, _ = env.rollout_value_and_grad(env.state, _actions(config), SOFTNESS)
        out[config] = (float(loss), np.asarray(grad))
    return out


@pytest.mark.parametrize("config,dtype", [("smooth", "float64"), ("smooth", "float32"),
                                          ("contact", "float64")])
def test_rollout_value_and_grad_matches_reference(reference, config, dtype):
    env = _port_env(dtype)
    env.set_state(_state(env, config), SOFTNESS, False)
    loss, grad, final = env.rollout_value_and_grad(env.state, _actions(config), SOFTNESS)
    want_loss, want_grad = reference[config]
    tol = F64_TOL if dtype == "float64" else F32_TOL
    assert env.last_remat == "none"
    assert grad.shape == (2, 9) and grad.dtype == env.dtype
    assert np.abs(want_grad).max() > 0
    np.testing.assert_allclose(float(loss), want_loss, rtol=tol)
    np.testing.assert_allclose(grad.numpy(), want_grad, rtol=0,
                               atol=tol * np.abs(want_grad).max())
    assert torch.isfinite(final.x).all() and not final.x.requires_grad


def _smooth_rollout(env, remat="none"):
    """loss(actions) and its gradient function on the smooth configuration."""
    env.set_state(_state(env, "smooth"), SOFTNESS, False)
    state0 = env.state

    def value_and_grad(actions):
        a = torch.tensor(actions, requires_grad=True)
        comps, _ = rollout_losses(env.scene, env.mats, env.loss_state, state0, a, SOFTNESS,
                                  remat)
        loss = comps[:, 0].sum()
        (g,) = torch.autograd.grad(loss, a)
        return float(loss.detach()), g.numpy()

    return value_and_grad


def test_trajectory_gradient_matches_fd_smooth():
    vg = _smooth_rollout(_port_env())
    actions = np.random.default_rng(2).uniform(-0.3, 0.3, (2, 9))
    _, g = vg(actions)
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    eps = 1e-6
    for t, i in [(0, 0), (0, 2), (1, 1), (0, 4)]:
        ap, am = actions.copy(), actions.copy()
        ap[t, i] += eps
        am[t, i] -= eps
        fd = (vg(ap)[0] - vg(am)[0]) / (2 * eps)
        np.testing.assert_allclose(g[t, i], fd, rtol=5e-4, atol=1e-9)


def test_checkpointed_equals_uncheckpointed_smooth():
    """remat "env_step" (recompute each env step in the backward) and
    "none" give the same gradient."""
    env = _port_env()
    actions = np.random.default_rng(1).uniform(-0.5, 0.5, (3, 9))
    l1, g1 = _smooth_rollout(env, "env_step")(actions)
    l2, g2 = _smooth_rollout(env, "none")(actions)
    assert l1 == l2
    np.testing.assert_allclose(g1, g2, rtol=1e-12, atol=0)
    assert mpm.resolve_remat(env.scene, 50, "cpu") == "none"


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_contact_rich_gradients_finite(dtype):
    """Manipulators inside and beside the cloud, large random actions: the
    gradient exists and is finite in float64 and float32."""
    env = _port_env(dtype)
    actions = np.random.default_rng(3).uniform(-1, 1, (3, 9))
    loss, grad, _ = env.rollout_value_and_grad(env.state, actions, SOFTNESS)
    assert torch.isfinite(loss) and torch.isfinite(grad).all()
    assert grad.abs().max() > 0


def test_gradient_descent_attracts_manipulator():
    """In the smooth regime a few Adam steps reduce the rollout loss."""
    vg = _smooth_rollout(_port_env())
    opt = Adam(np.zeros((3, 9)), OptimizerConfig(lr=0.2))
    losses = []
    for _ in range(8):
        loss, g = vg(opt.parameters.copy())
        losses.append(loss)
        opt.step(g)
    assert losses[-1] < losses[0], losses
