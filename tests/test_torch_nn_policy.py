"""The port's in-graph MLP policy (`engine/nn.py`) against the TPU
package's: `init_params` bit for bit (both draw from numpy), the flat
get/set round trip with and without the trailing velocity_weight
(tests/test_algorithms.py:209 carried over), `observe`, `apply` (relu and
tanh, the [-1, 1] clip) and d apply / d params in float64 within 1e-12
relative, ties of the ReLU and the clip included (both split the gradient
in half there), and the Chopsticks refusal. On the CPU, on a small scene."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plasticinelab_tpu.config import spec as jspec
from plasticinelab_tpu.engine.nn import MLPPolicy as JaxMLPPolicy
from plasticinelab_tpu.engine.state import initial_state as jax_initial_state
from plasticinelab_tpu_torch.config import spec as tspec
from plasticinelab_tpu_torch.engine.nn import MLPPolicy
from plasticinelab_tpu_torch.engine.state import initial_state

F64_TOL = 1e-12
N = 400


def _scene(mod):
    return mod.SceneSpec(
        simulator=mod.SimulatorSpec(quality=0.25, n_particles=N, dtype="float64"),
        primitives=(mod.PrimitiveSpec(shape="Sphere", radius=0.05, init_pos=(0.3, 0.5, 0.5),
                                      action_dim=3, action_scale=(0.01,) * 3),
                    mod.PrimitiveSpec(shape="Box", size=(0.1, 0.05, 0.1),
                                      init_pos=(0.7, 0.4, 0.5), init_rot=(0.9, 0.1, 0.3, 0.3),
                                      action_dim=6, action_scale=(0.01,) * 3 + (0.02,) * 3)))


def _policies(activation="relu"):
    kw = dict(hidden_dims=(32, 16), activation=activation, n_observed_particles=50)
    return MLPPolicy(_scene(tspec), **kw), JaxMLPPolicy(_scene(jspec), **kw)


def _states():
    """One moved state in both packages, from numpy."""
    rng = np.random.default_rng(0)
    x = rng.random((N, 3)) * 0.2 + 0.4
    v = rng.standard_normal((N, 3))
    ours = initial_state(_scene(tspec), x, "cpu", torch.float64)
    ours.v = torch.as_tensor(v)
    ours.prim_pos = ours.prim_pos + 0.01
    theirs = jax_initial_state(_scene(jspec), x)._replace(v=jnp.asarray(v))
    theirs = theirs._replace(prim_pos=theirs.prim_pos + 0.01)
    return ours, theirs


def _close(got, want, tol=F64_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-300))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_init_params_bit_for_bit(dtype):
    ours, theirs = _policies()
    for seed in (0, 3):
        p = ours.init_params(seed, getattr(torch, dtype), device="cpu")
        q = theirs.init_params(seed, getattr(jnp, dtype))
        assert list(p) == list(q)
        for k in p:
            assert p[k].dtype == getattr(torch, dtype)
            np.testing.assert_array_equal(p[k].numpy(), np.asarray(q[k]))
    assert ours.dims == theirs.dims == (50 * 6 + 14, 32, 16, 9)
    np.testing.assert_array_equal(ours.get_params(p), theirs.get_params(q))


def test_params_roundtrip_and_velocity_weight():
    ours, theirs = _policies()
    params = ours.init_params(device="cpu", dtype=torch.float64)
    flat = ours.get_params(params)
    assert flat.dtype == np.float64 and flat.shape == (ours.n_params,)
    again = ours.set_params(flat, torch.float64, device="cpu")
    assert np.abs(ours.get_params(again) - flat).max() < 1e-12  # solver_nn.py:110-111
    assert ours.velocity_weight == 1.0
    # a trailing scalar sets velocity_weight, as in the reference
    ours.set_params(np.append(flat, 0.25), torch.float64, device="cpu")
    theirs.set_params(np.append(flat, 0.25), jnp.float64)
    assert ours.velocity_weight == theirs.velocity_weight == 0.25
    ours_state, theirs_state = _states()
    _close(ours.observe(ours_state), theirs.observe(theirs_state))
    # none resets it to 1.0
    ours.set_params(flat, torch.float64, device="cpu")
    assert ours.velocity_weight == 1.0
    with pytest.raises(AssertionError):
        ours.set_params(np.append(flat, [1.0, 2.0]), device="cpu")


@pytest.mark.parametrize("activation", ["relu", "tanh"])
def test_observe_apply_and_grad_match_reference(activation):
    ours, theirs = _policies(activation)
    ours_state, theirs_state = _states()
    flat = theirs.get_params(theirs.init_params(1, jnp.float64))
    obs_t, obs_j = ours.observe(ours_state), theirs.observe(theirs_state)
    assert obs_t.shape == (ours.dims[0],)
    _close(obs_t, obs_j)
    for scale in (1.0, 40.0):  # 40x: most outputs beyond the clip
        p_j = theirs.set_params(flat * scale, jnp.float64)
        p_t = ours.set_params(flat * scale, torch.float64, device="cpu")
        out_t = ours.act(p_t, ours_state)
        out_j = theirs.act(p_j, theirs_state)
        _close(out_t, out_j)
        assert out_t.abs().max() <= 1.0
        if scale > 1:
            assert (out_t.abs() == 1.0).sum() >= 5
        ct = np.random.default_rng(2).standard_normal(out_t.shape)

        def f_j(p):
            return jnp.dot(theirs.apply(p, obs_j), ct)

        g_j = theirs.get_params(jax.grad(f_j)(p_j))
        ft = torch.as_tensor(flat * scale).requires_grad_(True)
        (g_t,) = torch.autograd.grad(ours.apply(ours.unflatten(ft), obs_t) @ torch.as_tensor(ct),
                                     ft)
        _close(g_t, g_j)


def test_ties_split_the_gradient_as_the_reference():
    """A ReLU input of exactly 0 and an output of exactly 1: the port's
    maximum and clip split the gradient in half there, as jnp.maximum and
    jnp.clip do (torch.relu and torch.clamp would not)."""
    ours, theirs = _policies()
    ours_state, theirs_state = _states()
    p = theirs.init_params(2, jnp.float64)
    p = {k: np.array(a) for k, a in p.items()}
    p["W0"][0] = 0.0
    p["b0"][0] = 0.0         # hidden unit 0 sits at the ReLU's kink
    p["W2"][1] = 0.0
    p["b2"][1] = 1.0         # output 1 sits at the clip's bound
    flat = np.concatenate([p[f"{k}{i}"].reshape(-1) for i in range(3) for k in "Wb"])
    p_j = theirs.set_params(flat, jnp.float64)
    ct = np.arange(1, 10, dtype=np.float64)
    g_j = theirs.get_params(jax.grad(
        lambda q: jnp.dot(theirs.act(q, theirs_state), ct))(p_j))
    ft = torch.as_tensor(flat).requires_grad_(True)
    out = ours.act(ours.unflatten(ft), ours_state)
    assert float(out[1].detach()) == 1.0
    (g_t,) = torch.autograd.grad(out @ torch.as_tensor(ct), ft)
    _close(g_t, g_j)
    b2 = slice(ours.n_params - 9, ours.n_params)
    assert g_t[b2][1] == 0.5 * ct[1]  # half the cotangent at the bound


def test_chopsticks_is_refused():
    scene = tspec.SceneSpec(
        simulator=tspec.SimulatorSpec(quality=0.25, n_particles=N),
        primitives=(tspec.PrimitiveSpec(shape="Chopsticks", action_dim=7,
                                        action_scale=(0.01,) * 7),))
    with pytest.raises(AssertionError, match="Chopstick"):
        MLPPolicy(scene)
