"""The port's K-FAC / ACKTR and GAIL against the TPU package's, on the CPU,
and the one-env `train_ppo` loop.

- `A2C_ACKTR`: 11 updates from the reference's initial weights carried
  across and cast to float64, the Fisher pass's two normal draws replayed
  from the reference's key splits (the action noise from split(key)[0],
  the value noise from the key itself): the 11th crosses the Tf = 10 eigen
  refresh (tests/test_algorithms.py:269). The parameters, the momentum
  buffers and the losses within 1e-8 of each tensor's largest value: eigh
  in two libraries. Eigenvector signs and the degenerate eigenspaces of the
  hidden layers' input factors (rank <= the batch of 32 < 64) do not move
  the update, which is basis-invariant, so updates are compared, not
  eigenvectors.
- GAIL: the `Discriminator` against its flax twin (float64, 1e-10
  relative); one `update` (the gradient penalty's double backward) with the
  interpolation weights replayed, and `predict_reward`, within 1e-9 of each
  tensor's largest value (Adam's rounding, tests/test_torch_sac.py).
- `train_ppo` for ACKTR and PPO on a tiny one-env `PlasticineEnv`, run to
  `ppo_model.pt` and loaded back."""
import os
import types

import jax
import numpy as np
import pytest
import torch

from plasticinelab_tpu.algorithms.ppo import gail as jgail
from plasticinelab_tpu.algorithms.ppo.kfac import A2C_ACKTR as JaxACKTR
from plasticinelab_tpu_torch.algorithms.common import params_from_flax
from plasticinelab_tpu_torch.algorithms.ppo import gail
from plasticinelab_tpu_torch.algorithms.ppo.kfac import A2C_ACKTR
from plasticinelab_tpu_torch.algorithms.ppo.ppo import ActorCritic
from plasticinelab_tpu_torch.algorithms.ppo.run_ppo import train_ppo
from test_torch_sac import NET_TOL, _close, _replaying, _to64
from test_torch_td3 import compare_adam, compare_module, one_thread  # noqa: F401

KFAC_TOL = 1e-8
TOL = 1e-9
A = 3


@pytest.fixture(scope="module")
def tiny_env():
    from test_torch_td3 import _tiny_env

    return _tiny_env()


def test_acktr_eleven_updates_match_reference():
    ref = JaxACKTR(12, A, seed=0)
    ref.params, ref.kstate = _to64(ref.params), _to64(ref.kstate)
    ours = A2C_ACKTR(12, A, seed=0, device="cpu")
    params_from_flax(ours.net.double(), jax.tree.map(np.asarray, ref.params))
    ours.kfac.init(ours.net)  # the state in float64
    rng = np.random.default_rng(0)
    B, n = 32, 11
    key, eps = ref._key, []
    for _ in range(n):
        key, sub = jax.random.split(key)
        k1, _ = jax.random.split(sub)
        eps += [jax.random.normal(k1, (B, A)), jax.random.normal(sub, (B,))]
    ours.normal = _replaying(eps)
    for i in range(n):
        rollouts = {"obs": rng.standard_normal((B, 12)),
                    "actions": rng.standard_normal((B, A)),
                    "returns": rng.standard_normal(B)}
        loss_j, loss_t = ref.update(rollouts), ours.update(rollouts)
        assert loss_t == pytest.approx(loss_j, rel=KFAC_TOL), i
        compare_module(f"params after {i + 1}", ours.net, ref.params, KFAC_TOL)
    assert ours.kfac.steps == int(ref.kstate.step) == n
    mom = jax.tree.map(np.asarray, ref.kstate.mom)
    for name, lin in ours.net.dense_layers():
        _close(ours.kfac.mom[name], mom[name].T, KFAC_TOL, name)
        _close(ours.kfac.mom[name + "/bias"], mom[name + "/bias"], KFAC_TOL, name + "/bias")
    _close(ours.kfac.mom["log_std"], mom["log_std"], KFAC_TOL, "log_std")
    for name in ("Dense_1", "Dense_2/bias"):
        _close(ours.kfac.m_aa[name], np.asarray(ref.kstate.m_aa[name]).T, KFAC_TOL, name)
        _close(ours.kfac.m_gg[name], np.asarray(ref.kstate.m_gg[name]), KFAC_TOL, name)


def test_discriminator_matches_flax():
    rng = np.random.default_rng(1)
    obs, act = rng.standard_normal((7, 8)), rng.uniform(-1, 1, (7, A))
    ref = jgail.Discriminator()
    tree = _to64(ref.init(jax.random.PRNGKey(0), obs.astype(np.float32),
                          act.astype(np.float32)))
    ours = gail.Discriminator(8 + A, generator=torch.Generator().manual_seed(0)).double()
    params_from_flax(ours, jax.tree.map(np.asarray, tree))
    with torch.no_grad():
        got = ours(torch.as_tensor(obs), torch.as_tensor(act))
    _close(got, ref.apply(tree, obs, act), NET_TOL, "Discriminator")


def test_gail_update_and_reward_match_reference():
    ref = jgail.GAIL(8, A, seed=0)
    ref.state = _to64(ref.state)
    ours = gail.GAIL(8, A, seed=0, device="cpu")
    params_from_flax(ours.net.double(), jax.tree.map(np.asarray, ref.state.params))
    rng = np.random.default_rng(5)
    expert = (rng.standard_normal((32, 8)) + 1.0, rng.uniform(-1, 1, (32, A)))
    agent = (rng.standard_normal((32, 8)) - 1.0, rng.uniform(-1, 1, (32, A)))
    _, sub = jax.random.split(ref._key)
    ours.uniform = _replaying([jax.random.uniform(sub, (32, 1))])
    loss_j, loss_t = ref.update(expert, agent), ours.update(expert, agent)
    assert loss_t == pytest.approx(loss_j, rel=TOL)
    compare_module("discriminator", ours.net, ref.state.params)
    compare_adam("discriminator", ours.net, ours.opt, ref.state.opt)
    for obs, act in (expert, agent):
        _close(torch.as_tensor(ours.predict_reward(obs, act)), ref.predict_reward(obs, act),
               TOL, "reward")


@pytest.mark.parametrize("algo", ["acktr", "ppo"])
def test_train_ppo_one_env_saves_and_loads(algo, tiny_env, tmp_path):
    env = tiny_env
    args = types.SimpleNamespace(seed=0, num_steps=4, vec_envs=0, rollout_len=4)
    agent = train_ppo(env, str(tmp_path), None, args, algo=algo)
    assert agent.device == torch.device("cpu")
    if algo == "acktr":
        assert isinstance(agent, A2C_ACKTR) and agent.kfac.steps == 1
    else:
        assert agent.opt.state[agent.net.log_std]["step"] == 10 * 4
    saved = torch.load(os.path.join(tmp_path, "ppo_model.pt"))
    net = ActorCritic(env.observation_space.shape[0], A)
    net.load_state_dict(saved["params"])
    for a, b in zip(net.parameters(), agent.net.parameters()):
        assert torch.equal(a, b)
    mean, var = saved["ob_rms"]
    assert mean.shape == env.observation_space.shape and bool((var > 0).all())
