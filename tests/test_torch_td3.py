"""The port's TD3, DDPG and OriginalDDPG and their loops against the TPU
package's, on the CPU.

- The DDPG critic against its flax twin after `params_from_flax` (float64,
  1e-10 relative).
- TD3: two consecutive `train` calls (the first skips the actor, the second
  steps it and both targets) and one `train_many_device(n=4)`, state with
  obs_stats and visual at 42^2; DDPG and OriginalDDPG: two `train`s each.
  Each from the reference's initial weights carried across and cast to
  float64, the seams (`normal`, `indices`) filled with the reference's own
  draws (its key splits replayed). The loss, every parameter, both targets
  and the Adam moments within 1e-9 of each tensor's largest value (the same
  float64 math; Adam's rounding differs, see tests/test_torch_sac.py).
  OriginalDDPG's critic L2 is the coupled form (the penalty added to the
  gradient before Adam, tests/test_algorithms.py:68-83): torch's
  `weight_decay`, held to the reference's add_decayed_weights + adam.
- `train_td3_vec` on the tiny CPU `VecPlasticineEnv` of
  tests/test_torch_sac.py (tests/test_vec_learners.py:36), `train_td3` for
  each `--policy` on a tiny one-env `PlasticineEnv` to its save file and
  back, and the refusal of
  `--policy OurDDPG|DDPG --vec_envs B`, whose reference dies after its
  warm-up (`run_td3.py:174`, `:185`)."""
import copy
import os
import types

import jax
import numpy as np
import pytest
import torch

from plasticinelab_tpu.algorithms import common as jcommon
from plasticinelab_tpu.algorithms.td3 import ddpg as jddpg
from plasticinelab_tpu.algorithms.td3.td3 import TD3 as JaxTD3
from plasticinelab_tpu_torch.algorithms import common
from plasticinelab_tpu_torch.algorithms.common import params_from_flax
from plasticinelab_tpu_torch.algorithms.td3 import ddpg
from plasticinelab_tpu_torch.algorithms.td3.run_td3 import train_td3, train_td3_vec
from plasticinelab_tpu_torch.algorithms.td3.td3 import TD3
from test_torch_sac import NET_TOL, _close, _replaying, _tiny_venv, _to64

TOL = 1e-9
A = 3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this module runs: the env loops' many
    small ops otherwise wait on a thread pool that the suite's other
    workers starve. Restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def adam_state(opt_state):
    """The ScaleByAdamState inside an optax state (chains, injected
    hyperparameters)."""
    if hasattr(opt_state, "mu"):
        return opt_state
    if hasattr(opt_state, "inner_state"):
        return adam_state(opt_state.inner_state)
    for s in opt_state if isinstance(opt_state, tuple) else ():
        found = adam_state(s)
        if found is not None:
            return found
    return None


def compare_module(name, module, tree, tol=TOL):
    """Every parameter of `module` against the flax tree, in the module's
    layout."""
    want = params_from_flax(copy.deepcopy(module), jax.tree.map(np.asarray, tree))
    for i, (g, w) in enumerate(zip(module.parameters(), want.parameters())):
        _close(g, w.detach().numpy(), tol, f"{name} {i}")


def compare_adam(name, module, opt, opt_state, tol=TOL):
    """torch Adam's exp_avg / exp_avg_sq against optax's mu / nu (zeros
    where torch has not stepped yet)."""
    st = adam_state(opt_state)
    for what, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        want = params_from_flax(copy.deepcopy(module),
                                jax.tree.map(np.asarray, getattr(st, what)))
        for i, (p, w) in enumerate(zip(module.parameters(), want.parameters())):
            got = opt.state[p][key] if p in opt.state else torch.zeros_like(p)
            _close(got, w.detach().numpy(), tol, f"{name} {what} {i}")


def _carry(ours, ref, names):
    """Cast the port's networks to float64 and carry the reference's
    (float64) weights into them."""
    ref.state = _to64(ref.state)
    tree = jax.tree.map(np.asarray, ref.state)
    for name in names:
        getattr(ours, name).double()
        params_from_flax(getattr(ours, name), getattr(tree, name))
    return ours, ref


def _td3_pair(state_dim):
    return _carry(TD3(state_dim, A, seed=0, device="cpu"), JaxTD3(state_dim, A, seed=0),
                  ("actor", "actor_target", "critic", "critic_target"))


def _compare_learner(ours, ref, loss_t, loss_j):
    assert float(loss_t) == pytest.approx(float(loss_j), rel=TOL)
    st = ref.state
    for name in ("actor", "actor_target", "critic", "critic_target"):
        compare_module(name, getattr(ours, name), getattr(st, name))
    compare_adam("actor", ours.actor, ours.actor_opt, st.actor_opt)
    compare_adam("critic", ours.critic, ours.critic_opt, st.critic_opt)


def _host_buffers(shape, seed=0, n=30):
    visual = isinstance(shape, tuple)
    rng = np.random.default_rng(seed)
    if visual:
        bufs = [common.ImageReplayBuffer(shape, A, 40), jcommon.ImageReplayBuffer(shape, A, 40)]
    else:
        bufs = [common.ReplayBuffer(shape, A, 40), jcommon.ReplayBuffer(shape, A, 40)]
    for _ in range(n):
        s = rng.integers(0, 256, shape, dtype=np.uint8) if visual else rng.standard_normal(shape)
        ns = rng.integers(0, 256, shape, dtype=np.uint8) if visual else rng.standard_normal(shape)
        a, r, d = rng.uniform(-1, 1, A), rng.standard_normal(), float(rng.random() < 0.2)
        for buf in bufs:
            buf.add(s, a, ns, r, d)
    return bufs


def _device_buffers(shape, seed=1):
    """A port DeviceReplayBuffer and the reference's with the same rows,
    and (port, reference) obs_stats for state observations."""
    visual = isinstance(shape, tuple)
    rng = np.random.default_rng(seed)
    if visual:
        bt = common.DeviceImageReplayBuffer(shape, A, 32, device="cpu")
        bj = jcommon.DeviceImageReplayBuffer(shape, A, 32)
    else:
        bt = common.DeviceReplayBuffer(shape, A, 64, device="cpu")
        bj = jcommon.DeviceReplayBuffer(shape, A, 64)
    for _ in range(3):
        n = 16
        if visual:
            s = rng.integers(0, 256, (n,) + shape, dtype=np.uint8)
            ns = rng.integers(0, 256, (n,) + shape, dtype=np.uint8)
        else:
            s = rng.normal(3.0, 2.0, (n, shape)).astype(np.float32)
            ns = rng.normal(3.0, 2.0, (n, shape)).astype(np.float32)
        args = (s, rng.uniform(-1, 1, (n, A)), ns, rng.standard_normal(n),
                (rng.random(n) < 0.2).astype(np.float32))
        bt.add_batch(*args)
        bj.add_batch(*args)
    stats = (None, None)
    if not visual:
        rms = jcommon.DeviceObsRMS(shape)
        rms.update(bj.state[:bj.size])
        stats_j = rms.stats()
        stats = (tuple(torch.as_tensor(np.array(a)) for a in stats_j), stats_j)
    return bt, bj, stats


def test_ddpg_critic_matches_flax():
    rng = np.random.default_rng(1)
    obs, act = rng.standard_normal((7, 12)), rng.standard_normal((7, A))
    ref = jddpg.Critic()
    tree = _to64(ref.init(jax.random.PRNGKey(0), obs.astype(np.float32),
                          act.astype(np.float32)))
    ours = params_from_flax(ddpg.Critic(12 + A, generator=torch.Generator().manual_seed(0))
                            .double(), jax.tree.map(np.asarray, tree))
    with torch.no_grad():
        got = ours(torch.as_tensor(obs), torch.as_tensor(act))
    _close(got, ref.apply(tree, obs, act), NET_TOL, "DDPG Critic")


def test_td3_train_skips_then_steps_the_actor():
    ours, ref = _td3_pair(12)
    bufs = _host_buffers(12)
    B = 8
    key, eps = ref._key, []
    for _ in range(2):
        key, sub = jax.random.split(key)
        eps.append(jax.random.normal(sub, (B, A)))
    ours.normal = _replaying(eps)
    actor0 = [p.clone() for p in ours.actor.parameters()]
    target0 = [p.clone() for p in ours.critic_target.parameters()]
    for update, rng_seed in ((1, 5), (2, 6)):
        loss_j = ref.train(bufs[1], B, np.random.default_rng(rng_seed))
        loss_t = ours.train(bufs[0], B, np.random.default_rng(rng_seed))
        _compare_learner(ours, ref, loss_t, loss_j)
        moved = [not torch.equal(a, b) for a, b in zip(actor0, ours.actor.parameters())]
        moved_t = [not torch.equal(a, b) for a, b in zip(target0, ours.critic_target.parameters())]
        # the actor and the target critic move on the policy_freq-th update only
        assert all(moved) == any(moved) == all(moved_t) == any(moved_t) == (update == 2)
    assert ours.total_it == int(ref.state.step) == 2


@pytest.mark.parametrize("visual", [False, True], ids=["state+obs_stats", "visual"])
def test_td3_train_many_device_matches_reference(visual):
    shape = (42, 42, 3) if visual else 12
    ours, ref = _td3_pair(shape)
    bt, bj, (stats_t, stats_j) = _device_buffers(shape)
    B, n = 8, 4
    key, idx, eps = ref._key, [], []
    for _ in range(n):
        key, ks, sub = jax.random.split(key, 3)
        idx.append(jax.random.randint(ks, (B,), 0, np.asarray(bj.size)))
        eps.append(jax.random.normal(sub, (B, A)))
    ours.indices, ours.normal = _replaying(idx), _replaying(eps)
    loss_j = ref.train_many_device(bj, B, n, obs_stats=stats_j)
    loss_t = ours.train_many_device(bt, B, n, obs_stats=stats_t)
    _compare_learner(ours, ref, loss_t, loss_j)
    assert ours.total_it == int(ref.state.step) == n


@pytest.mark.parametrize("cls", ["DDPG", "OriginalDDPG"])
def test_ddpg_train_matches_reference(cls):
    ours, ref = _carry(getattr(ddpg, cls)(12, A, seed=0, device="cpu"),
                       getattr(jddpg, cls)(12, A, seed=0),
                       ("actor", "actor_target", "critic", "critic_target"))
    assert ours.tau == ref.tau == (0.001 if cls == "OriginalDDPG" else 0.005)
    bufs = _host_buffers(12)
    # two updates: the second's moments carry the first's decayed weights
    for seed in (5, 6):
        loss_j = ref.train(bufs[1], 8, np.random.default_rng(seed))
        loss_t = ours.train(bufs[0], 8, np.random.default_rng(seed))
        _compare_learner(ours, ref, loss_t, loss_j)
    wd = ours.critic_opt.param_groups[0]["weight_decay"]
    assert wd == (1e-2 if cls == "OriginalDDPG" else 0.0)
    assert not isinstance(ours.critic_opt, torch.optim.AdamW)
    a = ours.select_action(np.zeros(12, np.float32))
    assert a.shape == (A,) and np.all(np.abs(a) <= 1.0)


def test_train_td3_vec_consumes_a_batch(tmp_path):
    venv = _tiny_venv()
    policy = TD3(venv.obs_dim, venv.action_dim, seed=0, device="cpu")
    c0 = [p.clone() for p in policy.critic.parameters()]
    args = types.SimpleNamespace(env_name=None, seed=0, num_steps=12)
    out = train_td3_vec(policy, args, str(tmp_path), venv=venv, start_timesteps=6)
    assert out is policy
    # 4 batched steps of 3; updates from the 2nd on, 3 per batched step
    assert policy.vec_stats["env_steps"] == 12 and policy.vec_stats["updates"] == 9
    assert policy.total_it == 9
    assert any(not torch.equal(a, b) for a, b in zip(c0, policy.critic.parameters()))
    assert all(torch.isfinite(p).all() for p in policy.actor.parameters())
    again = TD3(venv.obs_dim, venv.action_dim, seed=1, device="cpu")
    again.load(os.path.join(tmp_path, "model"))
    for a, b in zip(again.actor_target.parameters(), policy.actor_target.parameters()):
        assert torch.equal(a, b)
    assert again.total_it == 9


def _tiny_env():
    from plasticinelab_tpu_torch.config import spec as tspec
    from plasticinelab_tpu_torch.envs.env import PlasticineEnv
    from test_torch_visual_obs import _tiny_scene

    return PlasticineEnv("tiny.yml", 1, scene=_tiny_scene(tspec), device="cpu",
                         max_episode_steps=3)


@pytest.fixture(scope="module")
def tiny_env():
    return _tiny_env()


@pytest.mark.parametrize("which", ["TD3", "OurDDPG", "DDPG"])
def test_train_td3_host_loop_saves_and_loads(which, tiny_env, tmp_path, monkeypatch):
    cls = {"TD3": TD3, "OurDDPG": ddpg.DDPG, "DDPG": ddpg.OriginalDDPG}[which]
    trained = []
    real = cls.train
    monkeypatch.setattr(cls, "train", lambda self, *a: trained.append(1) or real(self, *a))
    args = types.SimpleNamespace(seed=0, num_steps=6, vec_envs=0, policy=which,
                                 start_timesteps=4)
    policy = train_td3(tiny_env, str(tmp_path), None, args)
    assert type(policy) is cls and policy.device == torch.device("cpu")
    assert policy.tau == (0.001 if which == "DDPG" else 0.005)
    assert len(trained) == 2  # steps 4 and 5 of 0..5
    again = cls(tiny_env.observation_space.shape[0], tiny_env.action_space.shape[0], seed=3,
                device="cpu")
    again.load(os.path.join(tmp_path, "model"))
    for a, b in zip(again.critic_target.parameters(), policy.critic_target.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("which", ["OurDDPG", "DDPG"])
def test_batched_ddpg_is_refused_naming_the_reference_gap(which, tmp_path):
    args = types.SimpleNamespace(seed=0, num_steps=6, vec_envs=4, policy=which)
    with pytest.raises(NotImplementedError, match="select_action_batch"):
        train_td3(None, str(tmp_path), None, args)
    policy = (ddpg.DDPG if which == "OurDDPG" else ddpg.OriginalDDPG)(8, A, device="cpu")
    with pytest.raises(NotImplementedError, match="run_td3.py:174"):
        train_td3_vec(policy, args, str(tmp_path), venv=object())
    # the reference's gap, pinned: its DDPGs have neither method
    assert not hasattr(jddpg.DDPG, "select_action_batch")
    assert not hasattr(jddpg.DDPG, "train_many_device")
