"""Port config, particle sampling and state carry-over against the TPU
package: spec parsing on all 50 resolved task specs, bitwise particle
sampling, and the get_state() list <-> SimState round trip."""
import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

from plasticinelab_tpu.config.loader import load_scene as jax_load_scene
from plasticinelab_tpu.engine.sim import PhysicsEnv as JaxPhysicsEnv
from plasticinelab_tpu.engine.shapes import build_particles as jax_build_particles
from plasticinelab_tpu_torch.config import spec as tspec
from plasticinelab_tpu_torch.config.loader import load_scene
from plasticinelab_tpu_torch.engine.shapes import build_particles
from plasticinelab_tpu_torch.engine.state import (
    default_materials, flat_primitive_states, initial_state, state_from_numpy,
    state_to_numpy,
)
from plasticinelab_tpu_torch.envs import ENVS
from plasticinelab_tpu_torch.envs.env import SPEC_DIR, PlasticineEnv

SPECS = sorted(glob.glob(os.path.join(SPEC_DIR, "*.json")))
# TPU-only switches of the reference's SimulatorSpec, not carried by the port
TPU_ONLY = {"remat", "transfer"}


def _asdict(scene):
    d = dataclasses.asdict(scene)
    for k in TPU_ONLY:
        d["simulator"].pop(k, None)
    return d


def test_fifty_specs():
    assert len(SPECS) == 50
    assert len(ENVS) == 50


@pytest.mark.parametrize("path", SPECS, ids=[os.path.basename(p) for p in SPECS])
def test_spec_parse_matches_reference(path):
    ours, ref = load_scene(path), jax_load_scene(path)
    assert _asdict(ours) == _asdict(ref)
    for prop in ("n_grid", "dx", "inv_dx", "dt", "substeps", "p_vol", "p_mass",
                 "mu_0", "lam_0"):
        assert getattr(ours.simulator, prop) == getattr(ref.simulator, prop), prop
    assert ours.action_dim == ref.action_dim
    assert ours.action_dims == ref.action_dims
    assert ours.primitive_state_dim == ref.primitive_state_dim


def test_build_particles_bitwise_move_v1():
    scene = PlasticineEnv.load_scene("move", 1)
    ref_scene = jax_load_scene(os.path.join(SPEC_DIR, "move-v1.json"))
    p, c = build_particles(scene.shapes)
    rp, rc = jax_build_particles(ref_scene.shapes)
    assert p.shape == (10000, 3)
    assert np.array_equal(p, rp) and p.dtype == rp.dtype
    assert np.array_equal(c, rc)


def _chopsticks_scene(dtype):
    sim = tspec.SimulatorSpec(quality=0.25, n_particles=64, dtype=dtype)
    prims = (
        tspec.PrimitiveSpec(shape="Chopsticks", h=0.2, r=0.02, init_gap=0.06,
                            init_pos=(0.5, 0.6, 0.5), action_dim=7,
                            action_scale=(0.01,) * 7),
        tspec.PrimitiveSpec(shape="Sphere", radius=0.05, init_pos=(0.3, 0.5, 0.5),
                            action_dim=3, action_scale=(0.01,) * 3),
    )
    shapes = (tspec.ShapeSpec(shape="box", init_pos=(0.5, 0.4, 0.5), width=0.1,
                              n_particles=64),)
    return tspec.SceneSpec(simulator=sim, primitives=prims, shapes=shapes)


def _to_reference(scene):
    """The same scene as reference-package dataclasses."""
    from plasticinelab_tpu.config import spec as jspec

    d = dataclasses.asdict(scene)
    return jspec.SceneSpec(
        simulator=jspec.SimulatorSpec(**d["simulator"]),
        primitives=tuple(jspec.PrimitiveSpec(**p) for p in d["primitives"]),
        shapes=tuple(jspec.ShapeSpec(**s) for s in d["shapes"]),
        renderer=jspec.RendererSpec(**d["renderer"]),
        env=jspec.EnvSpec(loss=jspec.LossSpec(**d["env"]["loss"]),
                          n_observed_particles=d["env"]["n_observed_particles"]),
    )


def test_state_from_numpy_roundtrips_reference_get_state():
    """A reference PhysicsEnv state (random, set through its own set_state)
    carried into the port and back is unchanged, field by field (float64:
    exact)."""
    scene = _chopsticks_scene("float64")
    jenv = JaxPhysicsEnv(_to_reference(scene), loss=False)
    n = jenv.n_particles
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    state = [rng.random((n, 3)), rng.standard_normal((n, 3)),
             np.eye(3) + 0.1 * rng.standard_normal((n, 3, 3)),
             rng.standard_normal((n, 3, 3)),
             np.concatenate([rng.random(3), q[0], [0.07]]),
             np.concatenate([rng.random(3), q[1]])]
    jenv.set_state(state, 666.0, True)
    ref = jenv.get_state()["state"]

    st = state_from_numpy(scene, ref, "cpu", torch.float64)
    np.testing.assert_array_equal(st.x.numpy(), ref[0])
    np.testing.assert_array_equal(st.v.numpy(), ref[1])
    np.testing.assert_array_equal(st.F.numpy(), ref[2])
    np.testing.assert_array_equal(st.C.numpy(), ref[3])
    assert float(st.prim_gap[0]) == ref[4][7]
    back = state_to_numpy(scene, st)
    assert len(back) == len(ref)
    for a, b in zip(back, ref):
        np.testing.assert_array_equal(a, b)
    # pos+rot+gap, then pos+rot: the observation's primitive tail
    np.testing.assert_array_equal(flat_primitive_states(scene, st).numpy(),
                                  np.concatenate(ref[4:]))


def test_initial_state_and_materials():
    scene = _chopsticks_scene("float32")
    particles, _ = build_particles(scene.shapes)
    st = initial_state(scene, particles, "cpu", torch.float32)
    assert st.x.dtype == torch.float32 and st.x.shape == (64, 3)
    assert torch.equal(st.F, torch.eye(3).expand(64, 3, 3))
    assert float(st.prim_gap[0]) == pytest.approx(0.06)
    assert float(st.prim_gap[1]) == 0.0
    mats = default_materials(scene)
    assert float(mats.mu) == scene.simulator.mu_0
    assert float(mats.lam) == scene.simulator.lam_0
