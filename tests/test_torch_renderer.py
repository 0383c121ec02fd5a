"""The port's renderer against the reference package's, on the tiny scenes
of tests/test_renderer.py and tools/gen_golden_image.py, on the CPU (the
port's voxelizer then runs its plain version).

The port draws its randomness through `Renderer.uniform`; these tests hand
it the reference package's own draws (`frame_draws`, the key splits of
renderer.py:787-888 and :1058), so that both trace the same rays.

Tolerances, each with its reason:
- the texture tuple: equal bit for bit (the same float32 operations in the
  same order, the same bf16 rounding);
- probe_rays: 1e-5 on distances and normals (the same march; float32
  reductions over the 8 corners may sum in another order);
- render_frame with replayed draws: 1e-5 on every pixel value (the same);
  the PSNR of the uint8 frames is then far above 40 dB;
- the golden frame: PSNR > 35 dB, the bound of tests/test_render_image.py
  (the golden was rendered by an earlier revision of the reference)."""
import inspect
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from plasticinelab_tpu.config import spec as jspec
from plasticinelab_tpu.engine.renderer import Renderer as JaxRenderer
from plasticinelab_tpu_torch.config import spec as tspec
from plasticinelab_tpu_torch.engine.renderer import Renderer
from plasticinelab_tpu_torch.engine.renderer.renderer import LANE_CAP

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets", "golden_frame.npy")


# ---------------------------------------------------------------------------
# the reference package's draws, in the order the port's sampler is called
# ---------------------------------------------------------------------------

def pass_draws(key, S, W, H, depth, light):
    """One render_pass (renderer.py:861-867) and its trace (:820, :787-804,
    :836): pixel jitter x and y, then per bounce phi, r, the sphere's u, v
    and, with the directional light, its noise."""
    k1, k2, k3 = jax.random.split(key, 3)
    out = [jax.random.uniform(k1, (S, W, H), jnp.float32),
           jax.random.uniform(k2, (S, W, H), jnp.float32)]
    R, key = S * W * H, k3
    for _ in range(depth):
        key, a, b, c = jax.random.split(key, 4)
        for k in (a, b):
            ka, kb = jax.random.split(k)
            out += [jax.random.uniform(ka, (R,), jnp.float32),
                    jax.random.uniform(kb, (R,), jnp.float32)]
        if light:
            out.append(jax.random.uniform(c, (R, 3), jnp.float32))
    return out


def frame_draws(key, spp, target, W, H, depth, light):
    """render_frame's draws (renderer.py:1048-1059) from the renderer key."""
    out = []
    n_ghost = spp // 2 if target else 0
    lanes = W * H if W * H >= 256 * 256 else LANE_CAP
    for n in (spp - n_ghost, n_ghost):
        if n == 0:
            continue
        S = max(s for s in range(1, n + 1) if n % s == 0 and s * W * H <= lanes)
        key, sub = jax.random.split(key)
        for i in range(n // S):
            out += pass_draws(jax.random.fold_in(sub, i), S, W, H, depth, light)
    return out


def replay(draws):
    """A sampler for Renderer.uniform that hands out `draws` in order."""
    it = iter(draws)

    def uniform(shape):
        a = np.asarray(next(it))
        assert a.shape == tuple(shape), (a.shape, shape)
        return torch.tensor(a)

    return uniform


def psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


# ---------------------------------------------------------------------------
# scenes
# ---------------------------------------------------------------------------

def _tiny_scene(mod, light=False):
    """tests/test_renderer.py's scene; light: with the directional light."""
    ren = mod.RendererSpec(spp=2, image_res=(16, 16), voxel_res=(32, 32, 32),
                           target_res=(16, 16, 16), use_directional_light=light)
    prim = mod.PrimitiveSpec(shape="Sphere", radius=0.06, init_pos=(0.5, 0.4, 0.5),
                             color=(0.7, 0.7, 0.7), action_dim=3, action_scale=(0.01,) * 3)
    return mod.SceneSpec(simulator=mod.SimulatorSpec(quality=0.25, n_particles=200),
                         primitives=(prim,), renderer=ren)


POSE = (np.array([[0.5, 0.4, 0.5]], np.float32), np.array([[1.0, 0, 0, 0]], np.float32),
        np.zeros(1, np.float32))


def _cloud():
    x = (np.random.default_rng(0).random((200, 3)) * 0.1 + 0.45).astype(np.float32)
    return x, np.full(200, (127 << 16) + 127, np.int32)


def _goal():
    target = np.zeros((16, 16, 16))
    target[6:10, 6:10, 6:10] = 8.0
    return target


def _pair(light=False):
    ref = JaxRenderer(_tiny_scene(jspec, light))
    ours = Renderer(_tiny_scene(tspec, light), device="cpu")
    for r in (ref, ours):
        r.set_target_density(_goal())
    return ref, ours


def test_textures_match_reference():
    ref, ours = _pair()
    x, colors = _cloud()
    want = ref._prepare_textures(x, colors, *POSE)
    got = ours._prepare_textures(x, colors, *POSE)
    names = ("sdf_pack", "sdf_tight", "col_pack", "bbox", "tgt_pack", "tgt_tight")
    for name, w, g in zip(names, want, got):
        assert g.dtype == (torch.bfloat16 if "pack" in name else torch.float32), name
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32), err_msg=name)
    for w, g in zip(want[6], got[6]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the cloud is near the threshold somewhere: the skip field is not trivial
    assert float(got[0][:, 8].float().max()) > 1 and float(got[1][1, 0]) > float(got[1][0, 0])


def _probe_cloud():
    """A dense 7^3 blob away from the probe rays (test_renderer._probe_setup)."""
    g = np.linspace(0.27, 0.33, 7)
    x = np.stack(np.meshgrid(g, g - 0.15, g, indexing="ij"), axis=-1).reshape(-1, 3)
    return x.astype(np.float32), np.full(343, (127 << 16) + 127, np.int32)


PROBES = {
    "sphere": (np.array([[0.5, 0.4, 2.0], [0.52, 0.43, 2.0]], np.float32),
               np.array([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]], np.float32),
               dict(shape=0)),
    "ground": (np.array([[0.9, 0.5, 0.9], [0.1, 0.3, 0.2]], np.float32),
               np.array([[0.0, -1.0, 0.0], [0.1, -0.9, 0.05]], np.float32),
               dict(shape=0, primitive=0)),
    "plasticine": (np.array([[0.3, 0.15, 2.0], [0.31, 0.14, 2.0], [0.28, 0.6, 0.3]], np.float32),
                   np.array([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0], [0.0, -1.0, 0.0]], np.float32),
                   dict(primitive=0)),
}


@pytest.mark.parametrize("probe", sorted(PROBES))
def test_probe_rays_match_reference(probe):
    o, d, flags = PROBES[probe]
    ref, ours = _pair()
    x, colors = _probe_cloud()
    want = ref.probe_rays(x, colors, *POSE, o, d, **flags)
    got = ours.probe_rays(x, colors, *POSE, o, d, **flags)
    for name, g, w in zip(("closest", "normal", "color"), got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=f"{probe} {name}")
    assert (got[0] < 10).all()  # every probe ray hits something near


@pytest.mark.parametrize("light", [False, True], ids=["sky", "directional_light"])
def test_render_frame_matches_reference_with_replayed_draws(light):
    ref, ours = _pair(light)
    x, colors = _cloud()
    want = ref.render_frame(x, colors, *POSE, spp=2, target=1)
    ours.uniform = replay(frame_draws(jax.random.PRNGKey(0), 2, 1, 16, 16, 2, light))
    got = ours.render_frame(x, colors, *POSE, spp=2, target=1)
    assert got.shape == want.shape == (16, 16, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    to8 = lambda im: np.uint8(np.clip(im, 0, 1) * 255)  # noqa: E731
    assert psnr(to8(got), to8(want)) >= 40.0
    assert np.unique(got.round(2).reshape(-1, 3), axis=0).shape[0] > 5


def test_golden_frame():
    """tools/gen_golden_image.py's scene (every shading path: the march, a
    sphere, both planes, the ghost, the light's shadows, the tone map),
    rendered by the port with the draws of PRNGKey(0)."""
    ren = tspec.RendererSpec(spp=8, image_res=(64, 64), voxel_res=(64, 64, 64),
                             target_res=(32, 32, 32), use_directional_light=True,
                             light_direction=(0.3, 1.0, 0.2))
    prim = tspec.PrimitiveSpec(shape="Sphere", radius=0.07, init_pos=(0.62, 0.12, 0.5),
                               color=(0.8, 0.6, 0.2), action_dim=3, action_scale=(0.01,) * 3)
    r = Renderer(tspec.SceneSpec(simulator=tspec.SimulatorSpec(quality=0.25, n_particles=343),
                                 primitives=(prim,), renderer=ren), device="cpu")
    g = np.linspace(0.33, 0.45, 7)
    x = np.stack(np.meshgrid(g, g - 0.25, g, indexing="ij"), axis=-1).reshape(-1, 3)
    colors = np.full(len(x), (76 << 16) + (102 << 8) + 179, np.int32)
    target = np.zeros((32, 32, 32))
    target[20:26, 2:8, 13:19] = 8.0
    r.set_target_density(target)
    r.uniform = replay(frame_draws(jax.random.PRNGKey(0), 8, 1, 64, 64, 2, True))
    img = r.render_frame(x.astype(np.float32), colors, np.array([[0.62, 0.12, 0.5]], np.float32),
                         POSE[1], POSE[2], spp=8, target=1)
    img = np.uint8(np.clip(img, 0, 1) * 255)
    golden = np.load(GOLDEN)
    assert img.shape == golden.shape
    assert psnr(img, golden) > 35.0


def test_small_goal_upsamples_nearest_neighbour():
    """A goal grid smaller than the goal texture repeats each cell (the
    reference package's 2228672), as the reference does."""
    ref, ours = JaxRenderer(_tiny_scene(jspec)), Renderer(_tiny_scene(tspec), device="cpu")
    small = np.zeros((8, 8, 8))
    small[2:5, 3:6, 1:4] = 4.0
    for r in (ref, ours):
        r.set_target_density(small)
    np.testing.assert_array_equal(ours.target_density.numpy(), np.asarray(ref.target_density))
    inner = ours.target_density.numpy()[1:-1, 1:-1, 1:-1]
    assert inner.min() < 3.0 - 1.0 and inner.max() == pytest.approx(3.0)


def test_non_cubic_goal_fails_as_in_reference():
    """A goal grid with a non-cube cell count fails in both packages: the
    reference's defect pinned in ROADMAP queue C, not repaired in the port."""
    goal = np.zeros((8, 8, 4))
    with pytest.raises((TypeError, ValueError)):
        JaxRenderer(_tiny_scene(jspec)).set_target_density(goal)
    with pytest.raises(ValueError, match="not a cube"):
        Renderer(_tiny_scene(tspec), device="cpu").set_target_density(goal)


def test_renderer_runs_on_the_card_by_default():
    """Renderer(scene), like make() and PhysicsEnv, takes the card unless the
    caller names the CPU."""
    assert inspect.signature(Renderer).parameters["device"].default == "cuda"
