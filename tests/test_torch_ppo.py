"""The port's PPO, A2C, RunningMeanStd and `train_ppo_vec` against the TPU
package's, on the CPU.

- `ActorCritic` and `VisualActorCritic` (42^2) against their flax twins
  after `params_from_flax`, whose interleaved `Dense_i` names and bare
  `log_std` leaf it carries (float64, 1e-10 relative).
- From the reference's initial weights carried across and cast to float64,
  the seams filled with the reference's own draws (its key splits
  replayed), within 1e-9 of each tensor's largest value (Adam's rounding,
  tests/test_torch_sac.py): `_minibatch_update` alone where the gradient's
  global norm is above 0.5 (clipped) and where it is below (left alone),
  the whole `update` with the numpy `rng` (tests/test_algorithms.py:190),
  `act` / `act_batch`; A2C's two updates, the second on a non-zero RMSprop
  accumulator (eps inside the square root, as optax's rmsprop).
- `RunningMeanStd` against the reference's numpy class (1e-12).
- `train_ppo_vec` on the tiny CPU `VecPlasticineEnv` of
  tests/test_torch_sac.py, its physics in float64, with `rollout_len=8`,
  both packages' loops run with float32 networks as the reference runs
  them, from the same initial states, weights and action draws: the
  rollouts handed to the first `update` (obs, actions, logp, returns,
  values) within 1e-5 of each array's largest entry (float32 networks in
  two implementations). Each package's `run_ppo.PPO` is replaced by a
  recording subclass; nothing in the JAX package changes."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plasticinelab_tpu.algorithms.ppo import a2c as ja2c
from plasticinelab_tpu.algorithms.ppo import ppo as jppo
from plasticinelab_tpu.algorithms.ppo import run_ppo as jrun
from plasticinelab_tpu_torch.algorithms.common import params_from_flax
from plasticinelab_tpu_torch.algorithms.ppo import a2c, ppo, run_ppo
from test_torch_sac import NET_TOL, _close, _replaying, _to64
from test_torch_td3 import compare_adam, compare_module, one_thread  # noqa: F401

TOL = 1e-9
A = 3


@pytest.mark.parametrize("visual", [False, True], ids=["ActorCritic", "VisualActorCritic"])
def test_actor_critic_matches_flax(visual):
    rng = np.random.default_rng(1)
    x = rng.random((2, 42, 42, 3)) if visual else rng.standard_normal((7, 12))
    ref = jppo.VisualActorCritic(A) if visual else jppo.ActorCritic(A)
    tree = _to64(ref.init(jax.random.PRNGKey(0), jnp.asarray(x, jnp.float32)))
    gen = torch.Generator().manual_seed(0)
    ours = (ppo.VisualActorCritic((42, 42, 3), A, generator=gen) if visual
            else ppo.ActorCritic(12, A, generator=gen)).double()
    tree = jax.tree.map(lambda a: np.asarray(a) + 0.1, tree)  # log_std away from its zeros
    params_from_flax(ours, tree)
    with torch.no_grad():
        got = ours(torch.as_tensor(x))
    for g, w, name in zip(got, ref.apply(tree, x), ("mean", "log_std", "value")):
        _close(g, w, NET_TOL, name)


def _f32(x):
    return float(np.float32(x))


def _pair(cls_t, cls_j, **kw):
    ref = cls_j(12, A, seed=0, **kw)
    ref.state = _to64(ref.state)
    ours = cls_t(12, A, seed=0, device="cpu", **kw)
    params_from_flax(ours.net.double(), jax.tree.map(np.asarray, ref.state.params))
    if cls_t is ppo.PPO:
        # the reference's injected Adam hyperparameters are float32 arrays:
        # the port takes their values
        group = ours.opt.param_groups[0]
        group.update(lr=_f32(3e-4), eps=_f32(1e-5), betas=(_f32(0.9), _f32(0.999)))
    return ours, ref


def _batch(ours, rng, n, scale):
    """A minibatch whose actions, old log-probabilities and values sit near
    the current policy's, with returns `scale` away from the values."""
    obs = rng.standard_normal((n, 12))
    with torch.no_grad():
        mean, log_std, value = ours.net(torch.as_tensor(obs))
        log_std = log_std.detach()
    act = mean.numpy() + 0.3 * rng.standard_normal((n, A))
    old_logp = ppo.gaussian_logp(mean, log_std, torch.as_tensor(act)).detach().numpy()
    old_logp = old_logp + 0.05 * rng.standard_normal(n)
    old_value = value.numpy() + 0.1 * rng.standard_normal(n)
    returns = value.numpy() + scale * rng.standard_normal(n)
    adv = scale * rng.standard_normal(n)
    return obs, act, old_logp, returns, adv, old_value


@pytest.mark.parametrize("scale,clipped", [(5.0, True), (1e-3, False)],
                         ids=["above-max-norm", "below-max-norm"])
def test_minibatch_update_matches_reference(scale, clipped):
    ours, ref = _pair(ppo.PPO, jppo.PPO)
    data = _batch(ours, np.random.default_rng(3), 16, scale)
    # the case: the gradient's global norm against max_grad_norm
    seen = []
    real = ppo.clip_by_global_norm_

    def spy(grads, max_norm):
        seen.append(float(torch.sqrt(sum(torch.sum(g * g) for g in grads))))
        real(grads, max_norm)

    ppo.clip_by_global_norm_ = spy
    try:
        loss_t, aux_t = ours._minibatch_update(*(torch.as_tensor(a) for a in data))
    finally:
        ppo.clip_by_global_norm_ = real
    assert (seen[0] >= ours.max_grad_norm) == clipped
    ref.state, loss_j, aux_j = ref._minibatch_update(ref.state, *data)
    assert float(loss_t) == pytest.approx(float(loss_j), rel=TOL)
    for g, w in zip(aux_t, aux_j):
        assert float(g) == pytest.approx(float(w), rel=TOL)
    compare_module("net", ours.net, ref.state.params)
    compare_adam("net", ours.net, ours.opt, ref.state.opt)


def test_update_matches_reference():
    ours, ref = _pair(ppo.PPO, jppo.PPO, num_mini_batch=4)
    rng = np.random.default_rng(4)
    n = 64
    rollouts = {"obs": rng.standard_normal((n, 12)), "actions": rng.uniform(-1, 1, (n, A)),
                "logp": rng.standard_normal(n), "returns": rng.standard_normal(n),
                "values": rng.standard_normal(n)}
    for agent in (ours, ref):
        agent.set_lr(2e-4)
    loss_j = ref.update(rollouts, np.random.default_rng(7))
    loss_t = ours.update(rollouts, np.random.default_rng(7))
    assert loss_t == pytest.approx(loss_j, rel=TOL)
    compare_module("net", ours.net, ref.state.params)
    compare_adam("net", ours.net, ours.opt, ref.state.opt)
    assert ours.opt.state[ours.net.log_std]["step"] == 10 * 4


def test_act_and_act_batch_replay_the_reference_draws():
    ours, ref = _pair(ppo.PPO, jppo.PPO)
    rng = np.random.default_rng(5)
    one, many = rng.standard_normal(12), rng.standard_normal((4, 12))
    key, eps = ref._key, []
    for shape in ((1, A), (1, A), (4, A)):
        key, sub = jax.random.split(key)
        eps.append(jax.random.normal(sub, shape))
    ours.normal = _replaying(eps)
    for deterministic in (False, True):
        got, want = ours.act(one, deterministic), ref.act(one, deterministic)
        _close(torch.as_tensor(got[0]), want[0], NET_TOL, "action")
        assert got[1] == want[1] or got[1] == pytest.approx(want[1], rel=NET_TOL)
        assert got[2] == pytest.approx(want[2], rel=NET_TOL)
    got, want = ours.act_batch(many), ref.act_batch(many)
    assert all(isinstance(g, torch.Tensor) for g in got)
    for g, w, name in zip(got, want, ("actions", "logp", "values")):
        _close(g, w, NET_TOL, name)
    _close(ours.get_value_batch(many), ref.get_value_batch(many), NET_TOL, "values")
    assert ours.get_value(one) == pytest.approx(ref.get_value(one), rel=NET_TOL)


def _rms_nu(opt_state):
    if hasattr(opt_state, "nu") and not hasattr(opt_state, "mu"):
        return opt_state
    for s in opt_state if isinstance(opt_state, tuple) else ():
        found = _rms_nu(s)
        if found is not None:
            return found
    return None


def test_a2c_two_updates_match_reference():
    ours, ref = _pair(a2c.A2C, ja2c.A2C)
    rng = np.random.default_rng(6)
    n = 64
    for _ in range(2):
        rollouts = {"obs": rng.standard_normal((n, 12)), "actions": rng.uniform(-1, 1, (n, A)),
                    "returns": 3.0 * rng.standard_normal(n)}
        loss_j, loss_t = ref.update(rollouts), ours.update(rollouts)
        assert loss_t == pytest.approx(loss_j, rel=TOL)
        compare_module("net", ours.net, ref.state.params)
    nu = params_from_flax(type(ours.net)(12, A).double(),
                          jax.tree.map(np.asarray, _rms_nu(ref.state.opt).nu))
    for i, (g, w) in enumerate(zip(ours.nu, nu.parameters())):
        _close(g, w.detach().numpy(), TOL, f"nu {i}")
    assert all(float(v.abs().max()) > 0 for v in ours.nu[:-1])


def test_running_mean_std_matches_reference():
    rng = np.random.default_rng(0)
    ours, ref = run_ppo.RunningMeanStd((5,), device="cpu"), jrun.RunningMeanStd((5,))
    ours_s, ref_s = run_ppo.RunningMeanStd((), device="cpu"), jrun.RunningMeanStd(())
    for b in (1, 7, 16, 3):
        x = rng.normal(2.0, 3.0, (b, 5)).astype(np.float32)
        ours.update(x)
        ref.update(x)
        ours_s.update(x[:, 0])
        ref_s.update(x[:, 0])
    for got, want in ((ours, ref), (ours_s, ref_s)):
        assert got.mean.dtype == torch.float64 and got.count == want.count
        np.testing.assert_allclose(got.mean.numpy(), want.mean, rtol=1e-12)
        np.testing.assert_allclose(got.var.numpy(), want.var, rtol=1e-12)


def _tiny_venvs(batch, horizon, dtype):
    from plasticinelab_tpu.config import spec as jspec
    from plasticinelab_tpu.parallel.rollout import VecPlasticineEnv as JaxVec
    from plasticinelab_tpu_torch.config import spec as tspec
    from plasticinelab_tpu_torch.engine.state import states_from_numpy
    from plasticinelab_tpu_torch.parallel import VecPlasticineEnv
    from test_torch_vec_rollout import _tiny

    jscene, particles, target = _tiny(jspec, dtype)
    tscene, _, _ = _tiny(tspec, dtype)
    kw = dict(batch=batch, jitter=1e-3, target_density=target, particles=particles,
              horizon=horizon)
    ref = JaxVec(None, scene=jscene, **kw)
    ours = VecPlasticineEnv(None, scene=tscene, device="cpu", **kw)
    ours._init_states = states_from_numpy([np.asarray(a) for a in ref._init_states], "cpu",
                                          ours.dtype)
    return ours, ref


def test_train_ppo_vec_rollouts_match_reference(tmp_path, monkeypatch):
    B, T = 3, 8
    # float64 physics: in float32 the two envs' observations differ by up to
    # 2e-5 of the largest value (tests/test_torch_vec_rollout.py), which the
    # per-dimension normalisation magnifies where the B envs barely differ
    venv_t, venv_j = _tiny_venvs(B, horizon=4, dtype="float64")
    seen = {}

    class RefPPO(jppo.PPO):
        def update(self, rollouts, rng):
            seen.setdefault("ref", rollouts)
            return 0.0

    class PortPPO(ppo.PPO):
        """The reference's initial weights and action draws."""

        def __init__(self, state_dim, action_dim, seed=0, **kw):
            super().__init__(state_dim, action_dim, seed=seed, **kw)
            twin = jppo.PPO(state_dim, action_dim, seed=seed)
            params_from_flax(self.net, jax.tree.map(np.asarray, twin.state.params))
            key, eps = twin._key, []
            for _ in range(T):
                key, sub = jax.random.split(key)
                eps.append(jax.random.normal(sub, (B, action_dim)))
            self.normal = _replaying(eps)

        def update(self, rollouts, rng):
            seen.setdefault("port", rollouts)
            return 0.0

    monkeypatch.setattr(jrun, "PPO", RefPPO)
    monkeypatch.setattr(run_ppo, "PPO", PortPPO)
    args = types.SimpleNamespace(env_name=None, seed=0, num_steps=B * T)
    jrun.train_ppo_vec(args, str(tmp_path / "ref"), venv=venv_j, rollout_len=T)
    agent = run_ppo.train_ppo_vec(args, str(tmp_path / "port"), venv=venv_t, rollout_len=T)
    assert isinstance(agent, PortPPO) and agent.vec_stats["updates"] == 1
    got, want = seen["port"], seen["ref"]
    for k in ("obs", "actions", "logp", "returns", "values"):
        g, w = got[k].numpy(), np.asarray(want[k], np.float64)
        assert g.shape == w.shape and g.dtype == np.float32, k
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max(), err_msg=k)
    saved = torch.load(tmp_path / "port" / "ppo_model.pt")
    assert saved["ob_rms"][0].dtype == torch.float64
    assert set(saved["params"]) == set(agent.net.state_dict())
