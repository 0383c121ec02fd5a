"""The port's RL building blocks and SAC against the TPU package's, on the
CPU.

- Every network against its flax twin after `params_from_flax` (float64,
  1e-10 relative): MLP, GaussianPolicy, TwinQ, Actor, ConvEncoder at 64^2
  and 42^2 (flax's "SAME" padding puts the odd pixel on the high side
  there), and the visual networks.
- One SAC `update` and one `update_many_device(n=4)`, state (with
  obs_stats) and visual, from the reference's initial weights carried
  across and cast to float64, the seams (`normal`, `indices`) filled with
  the reference's own draws (its key splits replayed): the loss, every new
  parameter, the Adam moments, log_alpha and the target critic within
  1e-9 of the largest value of each tensor (the same float64 math; Adam's
  sqrt(v) / sqrt(1 - b2^t) against optax's sqrt(v / (1 - b2^t)) rounds
  differently).
- The alpha cap and the alpha loss's gradient independent of alpha
  (tests/test_algorithms.py:103 carried over), the host and device replay
  rings' wrap-around (tests/test_vec_learners.py:121), DeviceObsRMS
  against numpy (tests/test_learning.py:76), `train_vec` on a tiny CPU
  `VecPlasticineEnv` (tests/test_vec_learners.py:48) and the host `train`
  loop, save / load."""
import copy
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plasticinelab_tpu.algorithms import common as jcommon
from plasticinelab_tpu.algorithms.sac.sac import SAC as JaxSAC
from plasticinelab_tpu_torch.algorithms import common
from plasticinelab_tpu_torch.algorithms.common import (DeviceObsRMS, DeviceReplayBuffer,
                                                       ReplayBuffer, normalize_obs,
                                                       params_from_flax)
from plasticinelab_tpu_torch.algorithms.sac.run_sac import train, train_vec
from plasticinelab_tpu_torch.algorithms.sac.sac import SAC

NET_TOL = 1e-10
SAC_TOL = 1e-9
A = 3


def _to64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64)
                        if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


def _close(got, want, tol, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-300),
                               err_msg=name)


NETS = {  # name: (flax module, port module, input shapes)
    "MLP": (lambda: jcommon.MLP((32, 16), 5), lambda g: common.MLP(12, (32, 16), 5, generator=g),
            [(7, 12)]),
    "GaussianPolicy": (lambda: jcommon.GaussianPolicy(A), lambda g: common.GaussianPolicy(
        12, A, generator=g), [(7, 12)]),
    "TwinQ": (lambda: jcommon.TwinQ(), lambda g: common.TwinQ(12 + A, generator=g),
              [(7, 12), (7, A)]),
    "Actor": (lambda: jcommon.Actor(A, 2.0), lambda g: common.Actor(12, A, 2.0, generator=g),
              [(7, 12)]),
    "ConvEncoder64": (lambda: jcommon.ConvEncoder(), lambda g: common.ConvEncoder(
        (64, 64, 3), generator=g), [(2, 64, 64, 3)]),
    "ConvEncoder42": (lambda: jcommon.ConvEncoder(), lambda g: common.ConvEncoder(
        (42, 42, 3), generator=g), [(2, 42, 42, 3)]),
    "VisualGaussianPolicy": (lambda: jcommon.VisualGaussianPolicy(A), lambda g: (
        common.VisualGaussianPolicy((42, 42, 3), A, generator=g)), [(2, 42, 42, 3)]),
    "VisualActor": (lambda: jcommon.VisualActor(A), lambda g: common.VisualActor(
        (42, 42, 3), A, generator=g), [(2, 42, 42, 3)]),
    "VisualTwinQ": (lambda: jcommon.VisualTwinQ(), lambda g: common.VisualTwinQ(
        (64, 64, 3), A, generator=g), [(2, 64, 64, 3), (2, A)]),
}


@pytest.mark.parametrize("name", list(NETS))
def test_network_matches_flax(name):
    flax_net, port_net, shapes = NETS[name]
    rng = np.random.default_rng(1)
    xs = [rng.random(s) if len(s) == 4 else rng.standard_normal(s) for s in shapes]
    ref = flax_net()
    tree = _to64(ref.init(jax.random.PRNGKey(0), *[jnp.asarray(x, jnp.float32) for x in xs]))
    want = ref.apply(tree, *[jnp.asarray(x) for x in xs])
    ours = port_net(torch.Generator().manual_seed(0)).double()
    before = [p.clone() for p in ours.parameters()]
    params_from_flax(ours, jax.tree.map(np.asarray, tree))
    assert any(not torch.equal(a, b) for a, b in zip(before, ours.parameters()))
    with torch.no_grad():
        got = ours(*[torch.as_tensor(x) for x in xs])
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        _close(g, w, NET_TOL, name)


def test_params_from_flax_refuses_a_mismatch():
    ref = jcommon.TwinQ(hidden=(8,))
    tree = ref.init(jax.random.PRNGKey(0), jnp.zeros((1, 4)), jnp.zeros((1, 2)))
    with pytest.raises(ValueError):
        params_from_flax(common.TwinQ(6, hidden=(8, 8)), jax.tree.map(np.asarray, tree))
    with pytest.raises(ValueError):
        params_from_flax(common.TwinQ(7, hidden=(8,)), jax.tree.map(np.asarray, tree))


def _pair(state_dim):
    """(port SAC, reference SAC), both float64 with the reference's
    initial weights."""
    ref = JaxSAC(state_dim, A, seed=0)
    ref.state = _to64(ref.state)
    ours = SAC(state_dim, A, seed=0, device="cpu")
    for m in (ours.policy, ours.q, ours.q_target):
        m.double()
    ours.log_alpha.data = ours.log_alpha.data.double()
    tree = jax.tree.map(np.asarray, ref.state)
    for m, t in ((ours.policy, tree.policy), (ours.q, tree.q), (ours.q_target, tree.q_target)):
        params_from_flax(m, t)
    return ours, ref


def _replaying(draws):
    """A seam sampler handing out `draws` in order."""
    it = iter(draws)

    def sampler(*_):
        return torch.as_tensor(np.array(next(it)))

    return sampler


def _reference_draws(key, n, batch, size=None):
    """The reference's draws in its order: per update, with `size` the
    minibatch rows (update_many_device's split), then the two normals of
    `_update_impl` (next state, then the policy loss)."""
    idx, eps = [], []
    for _ in range(n):
        if size is not None:
            key, ks = jax.random.split(key)
            idx.append(jax.random.randint(ks, (batch,), 0, jnp.asarray(size)))
        key, k1, k2 = jax.random.split(key, 3)
        eps += [jax.random.normal(k1, (batch, A)), jax.random.normal(k2, (batch, A))]
    return idx, eps


def _compare(ours, ref, loss_t, loss_j):
    assert float(loss_t) == pytest.approx(float(loss_j), rel=SAC_TOL)
    st = jax.tree.map(np.asarray, ref.state)
    for name, module, tree, opt, adam in (
            ("policy", ours.policy, st.policy, ours.policy_opt, st.policy_opt[0]),
            ("q", ours.q, st.q, ours.q_opt, st.q_opt[0]),
            ("q_target", ours.q_target, st.q_target, None, None)):
        views = [(name, tree)] + ([("mu", adam.mu), ("nu", adam.nu)] if opt else [])
        for what, t in views:
            want = list(params_from_flax(copy.deepcopy(module), t).parameters())
            if what == name:
                got = list(module.parameters())
            else:
                key = "exp_avg" if what == "mu" else "exp_avg_sq"
                got = [opt.state[p][key] for p in module.parameters()]
            for i, (g, w) in enumerate(zip(got, want)):
                _close(g, w.detach().numpy(), SAC_TOL, f"{name} {what} {i}")
    _close(ours.log_alpha, st.log_alpha, SAC_TOL, "log_alpha")
    astate = ours.alpha_opt.state[ours.log_alpha]
    _close(astate["exp_avg"], st.alpha_opt[0].mu, SAC_TOL, "alpha mu")
    _close(astate["exp_avg_sq"], st.alpha_opt[0].nu, SAC_TOL, "alpha nu")


@pytest.mark.parametrize("visual", [False, True], ids=["state", "visual"])
def test_update_matches_reference(visual):
    shape = (42, 42, 3) if visual else 12
    ours, ref = _pair(shape)
    rng = np.random.default_rng(0)
    B = 8
    if visual:
        bufs = [common.ImageReplayBuffer(shape, A, 40), jcommon.ImageReplayBuffer(shape, A, 40)]
    else:
        bufs = [common.ReplayBuffer(12, A, 40), jcommon.ReplayBuffer(12, A, 40)]
    for _ in range(30):
        s = rng.integers(0, 256, shape, dtype=np.uint8) if visual else rng.standard_normal(12)
        ns = rng.integers(0, 256, shape, dtype=np.uint8) if visual else rng.standard_normal(12)
        a, r, d = rng.uniform(-1, 1, A), rng.standard_normal(), float(rng.random() < 0.2)
        for buf in bufs:
            buf.add(s, a, ns, r, d)
    _, eps = _reference_draws(ref._key, 1, B)
    ours.normal = _replaying(eps)
    loss_j = ref.update(bufs[1], B, np.random.default_rng(5))
    loss_t = ours.update(bufs[0], B, np.random.default_rng(5))
    _compare(ours, ref, loss_t, loss_j)


@pytest.mark.parametrize("visual", [False, True], ids=["state+obs_stats", "visual"])
def test_update_many_device_matches_reference(visual):
    shape = (42, 42, 3) if visual else 12
    ours, ref = _pair(shape)
    rng = np.random.default_rng(1)
    if visual:
        bt = common.DeviceImageReplayBuffer(shape, A, 32, device="cpu")
        bj = jcommon.DeviceImageReplayBuffer(shape, A, 32)
    else:
        bt = DeviceReplayBuffer(12, A, 64, device="cpu")
        bj = jcommon.DeviceReplayBuffer(12, A, 64)
    for _ in range(3):
        n = 16
        if visual:
            s = rng.integers(0, 256, (n,) + shape, dtype=np.uint8)
            ns = rng.integers(0, 256, (n,) + shape, dtype=np.uint8)
        else:
            s = rng.normal(3.0, 2.0, (n, 12)).astype(np.float32)
            ns = rng.normal(3.0, 2.0, (n, 12)).astype(np.float32)
        args = (s, rng.uniform(-1, 1, (n, A)), ns, rng.standard_normal(n),
                (rng.random(n) < 0.2).astype(np.float32))
        bt.add_batch(*args)
        bj.add_batch(*args)
    stats_j = stats_t = None
    if not visual:
        rms = jcommon.DeviceObsRMS(12)
        rms.update(bj.state[:bj.size])
        stats_j = rms.stats()
        stats_t = tuple(torch.as_tensor(np.array(a)) for a in stats_j)
    B, n = 8, 4
    idx, eps = _reference_draws(ref._key, n, B, bj.size)
    ours.indices, ours.normal = _replaying(idx), _replaying(eps)
    loss_j = ref.update_many_device(bj, B, n, obs_stats=stats_j)
    loss_t = ours.update_many_device(bt, B, n, obs_stats=stats_t)
    _compare(ours, ref, loss_t, loss_j)


def _filled(state_dim=8, n=300, seed=0):
    rng = np.random.default_rng(seed)
    buf = ReplayBuffer(state_dim, A, max_size=1000)
    for _ in range(n):
        buf.add(rng.standard_normal(state_dim), rng.uniform(-1, 1, A),
                rng.standard_normal(state_dim), rng.standard_normal(), 0.0)
    return buf


def test_alpha_is_capped_and_its_gradient_does_not_depend_on_alpha():
    buf = _filled()
    moments = []
    for log_alpha in (0.0, 10.0):
        algo = SAC(8, A, seed=0, device="cpu")
        with torch.no_grad():
            algo.log_alpha.fill_(log_alpha)
        algo.update(buf, batch_size=32, rng=np.random.default_rng(5))
        moments.append(algo.alpha_opt.state[algo.log_alpha]["exp_avg"].item())
        assert algo.log_alpha.item() <= algo.log_alpha_max + 1e-6
    assert moments[0] == moments[1] != 0.0  # linear in log_alpha
    assert SAC(8, A, alpha_cap=None, device="cpu").log_alpha_max == float("inf")


def test_explore_exploit_and_update_many():
    algo = SAC(8, A, seed=0, device="cpu")
    a = algo.explore(np.zeros(8, np.float32))
    assert a.shape == (A,) and np.all(np.abs(a) <= 1.0)
    assert np.all(np.abs(algo.exploit(np.zeros(8, np.float32))) <= 1.0)
    b = algo.explore_batch(torch.zeros((4, 8)))
    assert isinstance(b, torch.Tensor) and b.shape == (4, A)
    la0 = algo.log_alpha.item()
    loss = algo.update_many(_filled(), batch_size=32, rng=np.random.default_rng(3), n=3)
    assert np.isfinite(float(loss)) and algo.log_alpha.item() != la0
    assert algo.policy_opt.state[next(algo.policy.parameters())]["step"] == 3


def test_replay_rings_wrap_around():
    buf = ReplayBuffer(3, 2, max_size=10)
    for i in range(25):
        buf.add(np.full(3, i), np.zeros(2), np.zeros(3), float(i), 0.0)
    assert buf.size == 10
    s, a, ns, r, nd = buf.sample(32, np.random.default_rng(0))
    assert s.shape == (32, 3) and r.min() >= 15  # only the last 10 remain
    dev = DeviceReplayBuffer(12, 3, max_size=64, device="cpu")
    ref = jcommon.DeviceReplayBuffer(12, 3, max_size=64)
    rng = np.random.default_rng(0)
    for _ in range(5):
        s = rng.random((16, 12)).astype(np.float32)
        args = (s, rng.random((16, 3)), s + 1.0, rng.random(16), np.zeros(16))
        dev.add_batch(*args)
        ref.add_batch(*args)
    assert dev.size == 64 and dev.ptr == 80 % 64
    # the 5th write of 16 wrapped to rows 0..15 of the ring
    torch.testing.assert_close(dev.next_state[:16], torch.as_tensor(s + 1.0))
    for got, want in zip(dev.arrays(), ref.arrays()):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_device_obs_rms_matches_numpy():
    rms = DeviceObsRMS(3, device="cpu")
    rng = np.random.default_rng(0)
    xs = [rng.normal(5.0, 2.0, (16, 3)).astype(np.float32) for _ in range(8)]
    for x in xs:
        rms.update(x)
    allx = np.concatenate(xs)
    np.testing.assert_allclose(rms.mean.numpy(), allx.mean(0), rtol=1e-4)
    np.testing.assert_allclose(rms.var.numpy(), allx.var(0), rtol=1e-3)
    z = normalize_obs(torch.as_tensor(allx), rms.stats()).numpy()
    assert abs(z.mean()) < 0.05 and abs(z.std() - 1.0) < 0.05


def _tiny_venv(batch=3, horizon=4):
    """tests/test_vec_learners.py's tiny batched env on the port."""
    from plasticinelab_tpu_torch.config import spec as tspec
    from plasticinelab_tpu_torch.parallel import VecPlasticineEnv

    sim = tspec.SimulatorSpec(quality=0.25, n_particles=32, dtype="float32")
    prim = tspec.PrimitiveSpec(shape="Sphere", radius=0.08, init_pos=(0.45, 0.5, 0.5),
                               friction=0.9, action_dim=3, action_scale=(0.01,) * 3)
    scene = tspec.SceneSpec(simulator=sim, primitives=(prim,),
                            env=tspec.EnvSpec(loss=tspec.LossSpec(), n_observed_particles=16))
    particles = np.random.default_rng(0).random((32, 3)) * 0.2 + 0.4
    G = sim.n_grid
    target = np.zeros((G, G, G))
    target[6:10, 3:7, 6:10] = sim.p_mass * 4
    return VecPlasticineEnv(None, batch=batch, scene=scene, jitter=1e-3, target_density=target,
                            particles=particles, horizon=horizon, device="cpu")


def test_train_vec_consumes_a_batch(tmp_path):
    venv = _tiny_venv()
    algo = SAC(venv.obs_dim, venv.action_dim, seed=0, device="cpu")
    p0 = [p.clone() for p in algo.policy.parameters()]
    args = types.SimpleNamespace(env_name=None, seed=0, num_steps=24)
    out = train_vec(None, algo, str(tmp_path), args, venv=venv, start_steps=6)
    assert out is algo
    # 8 batched steps of 3; updates from the 2nd on, 3 per batched step
    assert algo.vec_stats["env_steps"] == 24 and algo.vec_stats["updates"] == 21
    assert algo.policy_opt.state[next(algo.policy.parameters())]["step"] == 21
    assert any(not torch.equal(a, b) for a, b in zip(p0, algo.policy.parameters()))
    assert all(torch.isfinite(p).all() for p in algo.policy.parameters())
    # the final model is saved and loads back
    again = SAC(venv.obs_dim, venv.action_dim, seed=1, device="cpu")
    again.load_models(os.path.join(tmp_path, "model", "final"))
    for a, b in zip(again.q_target.parameters(), algo.q_target.parameters()):
        assert torch.equal(a, b)


def test_host_train_loop(tmp_path, monkeypatch):
    from plasticinelab_tpu_torch.config import spec as tspec
    from plasticinelab_tpu_torch.envs.env import PlasticineEnv
    from test_torch_visual_obs import _tiny_scene

    env = PlasticineEnv("tiny.yml", 1, scene=_tiny_scene(tspec), device="cpu",
                        max_episode_steps=3)
    monkeypatch.setenv("PLB_SAC_START_STEPS", "4")
    updates = []
    real = SAC.update
    monkeypatch.setattr(SAC, "update", lambda self, *a: updates.append(1) or real(self, *a))
    args = types.SimpleNamespace(seed=0, num_steps=6, vec_envs=0)
    algo = train(env, str(tmp_path), None, args)
    assert isinstance(algo, SAC) and algo.device == torch.device("cpu")
    assert len(updates) == 3  # steps 4, 5, 6
    assert os.path.exists(os.path.join(tmp_path, "model", "final", "sac_state.pt"))
