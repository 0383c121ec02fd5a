"""The port's DisCor against the TPU package's, on the CPU.

- The error net (TwinQ (256, 256, 256)) against its flax twin after
  `params_from_flax` (float64, 1e-10 relative).
- One `update` and one `update_many_device(n=4)`, state (with obs_stats)
  and visual at 42^2, from the reference's initial weights (SAC's and the
  error net's) carried across and cast to float64, the seams filled with
  the reference's own draws (its key splits replayed): the loss, the
  policy, the critic and its target, the error net and its target, their
  Adam moments, log_alpha, tau1 and tau2 within 1e-9 of each tensor's
  largest value (Adam's rounding, tests/test_torch_sac.py).
- `save_models` / `load_models` with `discor_state.pt`, a fresh error model
  kept when the file is missing, and `run_sac.train` building DisCor for
  `args.algo == "discor"` (tests/test_algorithms.py:151-190)."""
import os
import types

import jax
import numpy as np
import pytest
import torch

from plasticinelab_tpu.algorithms.common import TwinQ as JaxTwinQ
from plasticinelab_tpu.algorithms.sac.discor import DisCor as JaxDisCor
from plasticinelab_tpu_torch.algorithms import common
from plasticinelab_tpu_torch.algorithms.common import params_from_flax
from plasticinelab_tpu_torch.algorithms.sac.discor import DisCor
from plasticinelab_tpu_torch.algorithms.sac.run_sac import train
from plasticinelab_tpu_torch.algorithms.sac.sac import SAC
from test_torch_sac import NET_TOL, _close, _replaying, _to64
from test_torch_td3 import (_device_buffers, _host_buffers, compare_adam, compare_module,
                            one_thread)  # noqa: F401

TOL = 1e-9
A = 3


def test_error_net_matches_flax():
    rng = np.random.default_rng(2)
    obs, act = rng.standard_normal((7, 12)), rng.uniform(-1, 1, (7, A))
    ref = JaxTwinQ(hidden=(256, 256, 256))
    tree = _to64(ref.init(jax.random.PRNGKey(3), obs.astype(np.float32),
                          act.astype(np.float32)))
    ours = DisCor(12, A, device="cpu").err.double()
    params_from_flax(ours, jax.tree.map(np.asarray, tree))
    with torch.no_grad():
        got = ours(torch.as_tensor(obs), torch.as_tensor(act))
    for g, w in zip(got, ref.apply(tree, obs, act)):
        _close(g, w, NET_TOL, "error net")


def _pair(state_dim):
    ref = JaxDisCor(state_dim, A, seed=0)
    ref.state, ref.dstate = _to64(ref.state), _to64(ref.dstate)
    ours = DisCor(state_dim, A, seed=0, device="cpu")
    st = jax.tree.map(np.asarray, ref.state)
    ds = jax.tree.map(np.asarray, ref.dstate)
    for m, t in ((ours.policy, st.policy), (ours.q, st.q), (ours.q_target, st.q_target),
                 (ours.err, ds.err), (ours.err_target, ds.err_target)):
        params_from_flax(m.double(), t)
    ours.log_alpha.data = ours.log_alpha.data.double()
    ours.tau1, ours.tau2 = ours.tau1.double(), ours.tau2.double()
    return ours, ref


def _draws(key, n, batch, size=None):
    """The reference's draws in its order: per update (with `size`, the
    minibatch rows first), the next-state normal and the policy's normal
    (discor.py:57-59, :165-170)."""
    idx, eps = [], []
    for _ in range(n):
        if size is None:
            key, sub = jax.random.split(key)
        else:
            key, ks, sub = jax.random.split(key, 3)
            idx.append(jax.random.randint(ks, (batch,), 0, np.asarray(size)))
        k1, k2, _ = jax.random.split(sub, 3)
        eps += [jax.random.normal(k1, (batch, A)), jax.random.normal(k2, (batch, A))]
    return idx, eps


def _compare(ours, ref, loss_t, loss_j):
    assert float(loss_t) == pytest.approx(float(loss_j), rel=TOL)
    st, ds = ref.state, ref.dstate
    for name, module, tree in (("policy", ours.policy, st.policy), ("q", ours.q, st.q),
                               ("q_target", ours.q_target, st.q_target),
                               ("err", ours.err, ds.err),
                               ("err_target", ours.err_target, ds.err_target)):
        compare_module(name, module, tree)
    for name, module, opt, ostate in (("policy", ours.policy, ours.policy_opt, st.policy_opt),
                                      ("q", ours.q, ours.q_opt, st.q_opt),
                                      ("err", ours.err, ours.err_opt, ds.err_opt)):
        compare_adam(name, module, opt, ostate)
    for name, got, want in (("log_alpha", ours.log_alpha, st.log_alpha),
                            ("tau1", ours.tau1, ds.tau1), ("tau2", ours.tau2, ds.tau2)):
        _close(got, np.asarray(want), TOL, name)


@pytest.mark.parametrize("visual", [False, True], ids=["state", "visual"])
def test_update_matches_reference(visual):
    shape = (42, 42, 3) if visual else 12
    ours, ref = _pair(shape)
    bufs = _host_buffers(shape)
    B = 8
    _, eps = _draws(ref._key, 1, B)
    ours.normal = _replaying(eps)
    tau0 = float(ours.tau1)
    loss_j = ref.update(bufs[1], B, np.random.default_rng(5))
    loss_t = ours.update(bufs[0], B, np.random.default_rng(5))
    _compare(ours, ref, loss_t, loss_j)
    assert float(ours.tau1) != tau0


@pytest.mark.parametrize("visual", [False, True], ids=["state+obs_stats", "visual"])
def test_update_many_device_matches_reference(visual):
    shape = (42, 42, 3) if visual else 12
    ours, ref = _pair(shape)
    bt, bj, (stats_t, stats_j) = _device_buffers(shape)
    B, n = 8, 4
    idx, eps = _draws(ref._key, n, B, bj.size)
    ours.indices, ours.normal = _replaying(idx), _replaying(eps)
    loss_j = ref.update_many_device(bj, B, n, obs_stats=stats_j)
    loss_t = ours.update_many_device(bt, B, n, obs_stats=stats_t)
    _compare(ours, ref, loss_t, loss_j)


def test_save_load_and_a_sac_checkpoint(tmp_path, capsys):
    bt = _host_buffers(8)[0]
    algo = DisCor(8, A, seed=0, device="cpu")
    algo.update(bt, 16, np.random.default_rng(0))
    algo.save_models(str(tmp_path / "d"))
    assert os.path.exists(tmp_path / "d" / "discor_state.pt")
    again = DisCor(8, A, seed=1, device="cpu")
    again.load_models(str(tmp_path / "d"))
    for a, b in zip(again.err_target.parameters(), algo.err_target.parameters()):
        assert torch.equal(a, b)
    assert torch.equal(again.tau1, algo.tau1) and torch.equal(again.tau2, algo.tau2)
    assert again.err_opt.state_dict()["state"][0]["step"] == 1
    # a plain SAC checkpoint: its networks load, the error model stays fresh
    SAC(8, A, seed=2, device="cpu").save_models(str(tmp_path / "s"))
    fresh = DisCor(8, A, seed=1, device="cpu")
    err0 = [p.clone() for p in fresh.err.parameters()]
    fresh.load_models(str(tmp_path / "s"))
    assert "keeping fresh error model" in capsys.readouterr().out
    assert all(torch.equal(a, b) for a, b in zip(err0, fresh.err.parameters()))


def test_run_sac_builds_discor(tmp_path, monkeypatch):
    from test_torch_td3 import _tiny_env

    monkeypatch.setenv("PLB_SAC_START_STEPS", "4")
    args = types.SimpleNamespace(seed=0, num_steps=6, vec_envs=0, algo="discor")
    algo = train(_tiny_env(), str(tmp_path), None, args)
    assert isinstance(algo, DisCor) and algo.device == torch.device("cpu")
    assert algo.err_opt.state_dict()["state"][0]["step"] == 3  # steps 4, 5, 6
    assert os.path.exists(os.path.join(tmp_path, "model", "final", "discor_state.pt"))
    assert common.TwinQ is type(algo.err)
