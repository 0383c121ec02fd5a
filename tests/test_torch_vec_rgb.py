"""The port's batched rgb observations, on the CPU (the voxelizer K9 runs its
plain version there), on tests/test_visual_obs.py's tiny scene at 16^2 and
one sample:
- the batched plain voxelizer against B single-env calls and the reference
  package's scatter path per env: equal bit for bit (the same scatter, the
  same float32 distance);
- the batched observation render (`build_obs_fn` on x (B, n, 3)) against the
  port's single-env render per env, from the same replayed draws: equal bit
  for bit (the same float32 operations per ray);
- against the reference package's `obs_fn` per env, each env's draws those of
  `pass_draws(fold_in(keys[b], 0), ...)`: within 1e-5, the bound to which
  tests/test_visual_obs.py holds the reference's own vmap of it;
- `VecPlasticineEnv(obs_mode="rgb")` against the reference's, reset and one
  step with the reference's keys replayed: rewards to the float32 bound of
  tests/test_torch_vec_rollout.py, frames equal at reset (the same state)
  and within one level after the step (the states differ by float32
  rounding);
- shapes, dtype, the caller's particles in 0x999999, the refused mesh."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from plasticinelab_tpu.config import spec as jspec
from plasticinelab_tpu.engine.renderer import Renderer as JaxRenderer
from plasticinelab_tpu.engine.renderer.renderer import obs_scene as jax_obs_scene
from plasticinelab_tpu.parallel.rollout import VecPlasticineEnv as JaxVecPlasticineEnv
from plasticinelab_tpu_torch.config import spec as tspec
from plasticinelab_tpu_torch.engine.renderer import Renderer, cuda_voxelize
from plasticinelab_tpu_torch.engine.renderer.renderer import obs_scene
from plasticinelab_tpu_torch.engine.shapes import build_particles
from plasticinelab_tpu_torch.engine.state import states_from_numpy
from plasticinelab_tpu_torch.parallel import VecPlasticineEnv
from test_torch_renderer import pass_draws, replay
from test_torch_visual_obs import RES, _tiny_scene

B = 3
DEPTH = 2  # the tiny scene's max_ray_depth; no directional light


def _batched(per_env):
    """One sampler's draws for B envs' pass: each draw the envs' own, env-major."""
    return [np.concatenate([np.asarray(d) for d in ds]) for ds in zip(*per_env)]


def _clouds():
    """B jittered copies of the tiny scene's cloud, their colours, poses."""
    particles, colors = build_particles(_tiny_scene(tspec).shapes)
    rng = np.random.default_rng(0)
    x = np.stack([particles + rng.uniform(-0.02, 0.02, particles.shape) for _ in range(B)])
    pos = np.array([[[0.38 + 0.02 * b, 0.5, 0.5]] for b in range(B)], np.float32)
    rot = np.tile(np.array([1.0, 0, 0, 0], np.float32), (B, 1, 1))
    return x.astype(np.float32), colors, pos, rot, np.zeros((B, 1), np.float32)


def _goal():
    target = np.zeros((16, 16, 16), np.float32)
    target[6:10, 6:10, 6:10] = _tiny_scene(tspec).simulator.p_mass * 4
    return target


def test_batched_plain_voxelizer_matches_single_and_reference():
    x, colors, *_ = _clouds()
    ours = Renderer(obs_scene(_tiny_scene(tspec), RES, 1), device="cpu")
    ref = JaxRenderer(jax_obs_scene(_tiny_scene(jspec), RES, 1))
    xt, ct = torch.tensor(x), torch.tensor(colors)
    p = (xt - ours.frame_bbox(xt, host_bbox=False)[:, 0, None]) * ours.inv_dx
    args = (ours.voxel_res, ours.bake_size, ours.dist_scale)
    got = cuda_voxelize.voxelize(p, ct, *args)
    assert got.shape == (B, int(np.prod(ours.voxel_res))) and got.dtype == torch.int32
    for b in range(B):
        np.testing.assert_array_equal(got[b].numpy(), cuda_voxelize.voxelize(p[b], ct, *args))
        want = np.asarray(ref._scatter_packed(jnp.asarray(p[b].numpy()), jnp.asarray(colors)))
        np.testing.assert_array_equal(got[b].numpy().view(np.uint32), want)
    assert (got >> 24 & 255 < 255).sum() > 100  # unsaturated cells were written


def test_batched_obs_equals_single_env_obs():
    x, colors, pos, rot, gap = _clouds()
    r = Renderer(obs_scene(_tiny_scene(tspec), RES, 1), device="cpu")
    r.set_target_density(_goal() / _tiny_scene(tspec).simulator.p_mass)
    obs_fn = r.build_obs_fn()
    rng = np.random.default_rng(1)
    draws = [[rng.random(a.shape, np.float32) for a in
              pass_draws(jax.random.PRNGKey(0), 1, RES, RES, DEPTH, False)] for _ in range(B)]
    single = []
    for b in range(B):
        r.uniform = replay(draws[b])
        single.append(obs_fn(x[b], colors, pos[b], rot[b], gap[b]))
    r.uniform = replay(_batched(draws))
    got = obs_fn(x, colors, pos, rot, gap)
    assert got.shape == (B, RES, RES, 3) and got.dtype == torch.float32
    for b in range(B):
        assert torch.equal(got[b], single[b]), b
    assert not torch.equal(got[0], got[1]) and float(got.max()) > 0


def test_batched_obs_matches_reference_obs_fn():
    x, colors, pos, rot, gap = _clouds()
    ref = JaxRenderer(jax_obs_scene(_tiny_scene(jspec), RES, 1))
    ours = Renderer(obs_scene(_tiny_scene(tspec), RES, 1), device="cpu")
    for r in (ref, ours):
        r.set_target_density(_goal() / _tiny_scene(tspec).simulator.p_mass)
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    ref_fn = ref.build_obs_fn()
    want = [np.asarray(ref_fn(x[b], jnp.asarray(colors), pos[b], rot[b], gap[b], keys[b]))
            for b in range(B)]
    ours.uniform = replay(_batched(
        [pass_draws(jax.random.fold_in(keys[b], 0), 1, RES, RES, DEPTH, False)
         for b in range(B)]))
    got = ours.build_obs_fn()(x, colors, pos, rot, gap).numpy()
    for b in range(B):
        np.testing.assert_allclose(got[b], want[b], rtol=0, atol=1e-5, err_msg=f"env {b}")


def _env_draws(seed, batch, steps):
    """The reference rgb env's render draws for reset and `steps` steps:
    each render splits the env's key (rollout.py:227, :233) and renders env b
    from fold_in(split(sub, batch)[b], 0)."""
    key, out = jax.random.PRNGKey(seed + 1), []
    for _ in range(steps + 1):
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, batch)
        out += _batched([pass_draws(jax.random.fold_in(keys[b], 0), 1, RES, RES, DEPTH, False)
                         for b in range(batch)])
    return out


def test_vec_env_rgb_matches_reference():
    batch = 2
    kw = dict(batch=batch, target_density=_goal(), horizon=3, obs_mode="rgb",
              image_obs_res=RES, image_obs_spp=1)
    ref = JaxVecPlasticineEnv(None, scene=_tiny_scene(jspec), **kw)
    ours = VecPlasticineEnv(None, scene=_tiny_scene(tspec), device="cpu", **kw)
    assert ours.obs_shape == ref.obs_shape == (RES, RES, 3)
    ours._init_states = states_from_numpy([np.asarray(a) for a in ref._init_states], "cpu",
                                          ours.dtype)
    ours._renderer.uniform = replay(_env_draws(0, batch, 1))
    got0, want0 = ours.reset(), np.asarray(ref.reset())
    assert got0.shape == (batch, RES, RES, 3) and got0.dtype == torch.uint8
    np.testing.assert_array_equal(got0.numpy(), want0)
    a = np.random.default_rng(0).uniform(-1, 1, (batch, ours.action_dim))
    got1, reward, done, info = ours.step(a)
    want1, rreward, rdone, rinfo = ref.step(a)
    assert got1.shape == (batch, RES, RES, 3) and got1.dtype == torch.uint8
    diff = np.abs(got1.numpy().astype(np.int32) - np.asarray(want1, np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01
    np.testing.assert_allclose(reward.numpy(), np.asarray(rreward), rtol=2e-4, atol=1e-5)
    np.testing.assert_array_equal(done.numpy(), np.asarray(rdone))
    assert float(got1.max()) > 0


def test_vec_env_rgb_caller_particles_and_defaults():
    particles, _ = build_particles(_tiny_scene(tspec).shapes)
    ve = VecPlasticineEnv(None, 2, 0, 1e-3, None, 3, _tiny_scene(tspec), _goal(), particles,
                          "rgb", RES, 1, device="cpu")
    assert (ve._colors == 0x999999).all() and ve._colors.shape == (len(particles),)
    obs = ve.reset()
    assert obs.shape == (2, RES, RES, 3) and obs.dtype == torch.uint8 and int(obs.max()) > 0
    obs, reward, done, _ = ve.step(np.zeros((2, ve.action_dim)))
    assert obs.shape == (2, RES, RES, 3) and torch.isfinite(reward).all() and not bool(done[0])
    with pytest.raises(NotImplementedError, match="A15"):
        VecPlasticineEnv(None, 2, mesh=object(), scene=_tiny_scene(tspec), device="cpu")
