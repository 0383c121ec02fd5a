"""The port's voxelizer (K9's plain version, `cuda_voxelize.voxelize_plain`,
which the wrapper runs on CPU tensors) against the reference package, on the
four clouds of tests/test_pallas_voxelize.py:
- against `Renderer._scatter_packed`, the reference's scatter-min path:
  equal bit for bit (the same scatter, the same float32 distance);
- against the Pallas gather kernel `voxelize_packed` in interpret mode: the
  bound of docs/PARITY.md deviation 8 that test_pallas_voxelize.py holds
  the kernel to (sdf bytes within 1 on under 1e-3 of the cells, equal
  values wherever the sdf byte agrees and is unsaturated).
The CUDA kernel is held against the plain version on the card by
chip_smoke.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from plasticinelab_tpu.config.spec import RendererSpec, SceneSpec
from plasticinelab_tpu.engine.renderer import Renderer as JaxRenderer
from plasticinelab_tpu.engine.renderer.pallas_voxelize import voxelize_packed
from plasticinelab_tpu_torch.engine.renderer import cuda_voxelize


def _random_cloud(seed):
    rng = np.random.default_rng(seed)
    p = rng.uniform(6.0, 30.0, (300, 3)).astype(np.float32)
    return p, rng.integers(0, 1 << 24, 300).astype(np.int32), (40, 40, 40), 0.2, 64


def _edge_and_fat_blocks():
    rng = np.random.default_rng(2)
    edge = np.array([[0.2, 0.3, 0.1], [39.7, 47.8, 39.9], [0.1, 47.9, 20.0],
                     [39.9, 0.05, 0.02]], np.float32)
    cluster = rng.uniform(16.0, 18.0, (200, 3)).astype(np.float32)
    p = np.concatenate([edge, cluster]).astype(np.float32)
    return p, rng.integers(0, 1 << 24, len(p)).astype(np.int32), (40, 48, 40), 0.2, 32


def _coarse_scale():
    rng = np.random.default_rng(3)
    p = rng.uniform(5.0, 35.0, (150, 3)).astype(np.float32)
    return p, rng.integers(0, 1 << 24, 150).astype(np.int32), (48, 40, 40), 0.4, 64


def _y_blocked_volume():
    rng = np.random.default_rng(4)
    ys = np.concatenate([rng.uniform(60.0, 68.0, 40), rng.uniform(124.0, 132.0, 40),
                         rng.uniform(8.0, 150.0, 60)])
    p = np.stack([rng.uniform(8.0, 120.0, len(ys)), ys,
                  rng.uniform(6.0, 34.0, len(ys))], -1).astype(np.float32)
    return p, rng.integers(0, 1 << 24, len(ys)).astype(np.int32), (128, 160, 40), 0.2, 32


CASES = {"random_cloud_0": lambda: _random_cloud(0), "random_cloud_1": lambda: _random_cloud(1),
         "edge_particles_and_fat_blocks": _edge_and_fat_blocks,
         "coarse_scale": _coarse_scale, "y_blocked_volume": _y_blocked_volume}


def _reference_renderer(res, scale):
    """A reference Renderer whose voxel grid is `res` and whose dist_scale
    is `scale`: dx = scale / 30 (dist_scale = 0.2 * dx * 150), the bake size
    of the frame (6) or of the observation grid (3)."""
    ren = RendererSpec(voxel_res=res, dx=scale / 30.0, bake_size=6 if scale < 0.3 else 3)
    return JaxRenderer(SceneSpec(renderer=ren))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_voxelizer_matches_reference(case):
    p, colors, res, scale, P = CASES[case]()
    ref = _reference_renderer(res, scale)
    got = cuda_voxelize.voxelize(torch.tensor(p), torch.tensor(colors), res, ref.bake_size,
                                 ref.dist_scale).numpy().view(np.uint32)
    scatter = np.asarray(ref._scatter_packed(jnp.asarray(p), jnp.asarray(colors)), np.uint32)
    np.testing.assert_array_equal(got, scatter)
    assert (got >> 24 < 255).sum() > 100  # unsaturated cells were written

    gather = np.asarray(voxelize_packed(p, colors, res, ref.dist_scale, P=P, interpret=True),
                        np.uint32)
    sdf_g, sdf_k = (got >> 24).astype(np.int32), (gather >> 24).astype(np.int32)
    diff = np.abs(sdf_g - sdf_k)
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    live = (sdf_k < 255) & (diff == 0)
    np.testing.assert_array_equal(got[live], gather[live])


def test_offset_table_counts():
    """The culled offset tables of the frame and the observation grids."""
    assert len(cuda_voxelize.offsets(6, 0.2 * (1 / 150) * 150.0)) == 720
    assert len(cuda_voxelize.offsets(3, 0.2 * (2 / 150) * 150.0)) == 160


def test_launch_shape_picks_the_mode_from_the_launch_size():
    """Move-v1's 10,000 particles on a card of 132 SMs: one env goes to the
    volume directly, 8 chunks a warp; from B = 7 (two sorted chunks of 256
    an SM) the launch sorts by coarse cell and privatises each chunk; the
    coarse cells are under 16 a side at both grids."""
    assert cuda_voxelize.launch_shape((84, 84, 84), 10_000, 1, 132) == (False, 3, 8)
    assert cuda_voxelize.launch_shape((84, 84, 84), 10_000, 6, 132)[0] is False
    assert cuda_voxelize.launch_shape((84, 84, 84), 10_000, 7, 132) == (True, 3, 256)
    assert cuda_voxelize.launch_shape((84, 84, 84), 10_000, 32, 132) == (True, 3, 256)
    assert cuda_voxelize.launch_shape((168, 168, 168), 10_000, 1, 132) == (False, 4, 8)
    assert cuda_voxelize.launch_shape((40, 48, 40), 5, 1, 132)[1] == 2


@pytest.mark.parametrize("batch", [None, 3], ids=["one_env", "B_envs"])
def test_launch_passes_its_signature(monkeypatch, batch):
    """The wrapper hands the C entry point what `cuda_build._SIGNATURES`
    declares, through ctypes' own conversion of each argument, with the
    volume and scratch it allocates, and counts the launch under
    `voxelize` for particles (n, 3), `voxelize_batched` for (B, n, 3)."""
    import ctypes

    from plasticinelab_tpu_torch.engine import cuda_build

    calls = []
    proto = ctypes.CFUNCTYPE(ctypes.c_int, *cuda_build._SIGNATURES["plb_voxelize"])
    entry = proto(lambda *args: calls.append(args) or 0)
    # a CPU tensor's device has no index: the card's ordinal is 0 here
    lib = type("Lib", (), {"plb_voxelize": staticmethod(
        lambda *args: entry(*(0 if a is None else a for a in args)))})
    monkeypatch.setattr(cuda_build, "library", lambda: lib)
    monkeypatch.setattr(cuda_build, "require_kernel_input", lambda t, name: None)
    monkeypatch.setattr(cuda_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(cuda_voxelize, "_sms", lambda device: 132)
    p = torch.rand((batch or 1, 50, 3)) * 40
    p = p if batch else p[0]
    cuda_voxelize.reset_launches()
    vol = cuda_voxelize._launch(p, torch.zeros(50, dtype=torch.int32), (40, 44, 36), 3, 0.4)
    offs = cuda_voxelize.offsets(3, 0.4)
    (args,) = calls
    assert args[0] == p.data_ptr()
    assert args[6:17] == (50, batch or 1, len(offs), 40, 44, 36, offs.min(), offs.max(), 0, 2, 8)
    assert vol.shape == ((batch, 40 * 44 * 36) if batch else (40 * 44 * 36,))
    assert cuda_voxelize.launches == {"voxelize": 0 if batch else 1,
                                      "voxelize_batched": 1 if batch else 0}


def test_wrapper_checks_its_inputs():
    """Shapes are checked; the launch path takes CUDA tensors only (no
    fallback to the plain version there)."""
    p = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="shape"):
        cuda_voxelize.voxelize(p, torch.zeros(3, dtype=torch.int32), (8, 8, 8), 6, 0.2)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_voxelize._launch(p, torch.zeros(4, dtype=torch.int32), (8, 8, 8), 6, 0.2)
