"""The plain reference against the program's CPU path (its plain versions),
from the same inputs, at B = 2 envs: one env step of each configuration and
one 64^2 observation frame of the rgb one.

Tolerances and their reasons:
- state, relative to each field's change over the step (x, F, poses) or its
  size (v, C): 1e-3. The program steps in float32 and the reference in
  float64; the gap measured here is 3e-5 to 2e-4.
- loss and reward, relative to the loss: 1e-5 (float32 sums over the 64^3
  grid; measured 1e-7 to 8e-6).
- frames (Writer-v1's Capsule, Chopsticks-v1's two sticks at their gap):
  a mean absolute difference under 5 of 255 levels and 90% of the pixels
  equal. The reference marches at fixed steps, the program skips far
  cells and samples bf16 textures; where a hit moves by a step's fraction,
  a shadow ray from just above the surface can flip between lit and
  occluded. Measured: 2.6 levels, 94% of the pixels equal.
"""
import json
import os

import numpy as np
import pytest
import torch

from conftest import BENCH, task_goal, task_spec

FIELDS = ("x", "v", "C", "F", "prim_pos", "prim_rot", "prim_gap")


def _setup(name, B, obs_mode="state", seed=11):
    """A configuration of the benchmark by name, or else a task's v1 spec
    (`chopsticks-v1`) as a configuration file would hold it."""
    from plasticinelab_tpu_torch.config.loader import scene_from_dict
    from plasticinelab_tpu_torch.parallel.rollout import VecPlasticineEnv

    import inputs
    from reference.scene import scene_of

    path = os.path.join(BENCH, "configs", name + ".json")
    if os.path.exists(path):
        with open(path) as f:
            cfg = json.load(f)
        goal = inputs.goal_grid(cfg)
    else:
        cfg = {"spec": task_spec(name.split("-")[0])}
        goal = task_goal(cfg["spec"])
    cloud = inputs.task_cloud(cfg["spec"])
    env = VecPlasticineEnv(None, batch=B, seed=seed, jitter=1e-3,
                           scene=scene_from_dict(cfg["spec"]), target_density=goal,
                           particles=cloud, obs_mode=obs_mode, device="cpu")
    return cfg, scene_of(cfg["spec"]), goal, env, inputs


def _rel(port, ref, base=None):
    den = (ref - base).norm() if base is not None else ref.norm()
    return float((port.double() - ref).norm() / den)


@pytest.mark.parametrize("name", ["move-v1", "writer-v1"])
def test_one_env_step_matches_the_program(name):
    from compare import Reference
    from reference import mpm

    cfg, sc, goal, env, inputs = _setup(name, 2)
    ref = Reference(sc, goal, inputs.jittered_starts(inputs.task_cloud(cfg["spec"]), 2, 11, 1e-3),
                    torch.device("cpu"), torch.float64, 666.0)
    assert torch.equal(env.states.x, ref.x0)
    env.reset()
    actions = inputs.Actions(11, 1, 2, sc.action_dim, "cpu").episode()[0]
    before = mpm.State(*(getattr(env.states, f).double() for f in FIELDS))
    _, reward, _, info = env.step(actions)
    st, loss, ref_reward, _, _ = ref.step(before, actions)
    port = [getattr(env.states, f) for f in FIELDS]
    for f, p, r, b in zip(FIELDS, port, st, before):
        if f in ("x", "F", "prim_pos"):
            assert _rel(p, r, b) < 1e-3, f
        elif f in ("v", "C"):
            assert _rel(p, r) < 1e-3, f
        else:
            assert float((p.double() - r).abs().max()) < 1e-6, f
    assert float(((info["loss"].double() - loss) / loss).abs().max()) < 1e-5
    assert float(((reward.double() - ref_reward) / loss).abs().max()) < 1e-5


@pytest.mark.parametrize("name", ["writer-v1", "chopsticks-v1"])
def test_one_rgb_frame_matches_the_program(name):
    from reference import mpm
    from reference.render import ObsRenderer, Replay

    cfg, sc, goal, env, inputs = _setup(name, 2, "rgb")
    draws, inner = [], env._renderer.uniform

    def recording(shape):
        draws.append(inner(shape))
        return draws[-1]

    env.reset()
    env._renderer.uniform = recording
    obs, _, _, _ = env.step(inputs.Actions(11, 1, 2, sc.action_dim, "cpu").episode()[0])
    st = mpm.State(*(getattr(env.states, f) for f in FIELDS))
    R = ObsRenderer(sc, goal, 64, 2, torch.device("cpu"), torch.float64)
    frames = R.frames(st, Replay(draws, 2, torch.arange(2), torch.device("cpu"), torch.float64))
    diff = (obs.double() - frames.double()).abs()
    assert frames.shape == obs.shape == (2, 64, 64, 3)
    assert float(diff.mean()) < 5.0
    assert float((diff == 0).double().mean()) > 0.9


def test_the_svd_is_proper_and_exact():
    from reference import mpm

    torch.manual_seed(0)
    F = torch.eye(3, dtype=torch.float64) + 0.3 * torch.randn(2000, 3, 3, dtype=torch.float64)
    U, s, V = mpm.svd_proper(F)
    assert float((U @ torch.diag_embed(s) @ V.transpose(-1, -2) - F).abs().max()) < 1e-12
    assert float((mpm.det3(U) - 1).abs().max()) < 1e-12
    assert float((mpm.det3(V) - 1).abs().max()) < 1e-12
    ref = torch.linalg.svdvals(F)
    assert np.allclose(s.abs().sort(-1, descending=True)[0].numpy(), ref.numpy(), atol=1e-12)


@pytest.mark.parametrize("scale", [1.0, 1e-29])
def test_the_svd_of_a_particle_squeezed_flat_is_a_rotation(scale):
    """F of rank 1 (a particle squeezed to a line, as a RollingPin or the
    Chopsticks leave a few on the card, at sizes down to 1e-29) and of rank
    0: U and V are rotations, F is rebuilt, the stress is finite."""
    from reference import mpm
    from reference.scene import scene_of

    gen = torch.Generator().manual_seed(1)
    a = torch.randn(400, 3, 1, generator=gen, dtype=torch.float64)
    b = torch.randn(400, 1, 3, generator=gen, dtype=torch.float64)
    F = torch.cat([a @ b, torch.zeros(1, 3, 3, dtype=torch.float64)]) * scale
    U, s, V = mpm.svd_proper(F)
    eye = torch.eye(3, dtype=torch.float64)
    for Q in (U, V):
        assert float((Q.transpose(-1, -2) @ Q - eye).abs().max()) < 1e-6
        assert float((mpm.det3(Q) - 1).abs().max()) < 1e-6
    rebuilt = U @ torch.diag_embed(s) @ V.transpose(-1, -2)
    assert float((rebuilt - F).abs().max()) < 1e-7 * float(F.abs().max())
    with open(os.path.join(BENCH, "configs", "move-v1.json")) as f:
        sc = scene_of(json.load(f)["spec"])
    new_F, affine = mpm.stress_affine(sc, torch.zeros_like(F), F)
    assert bool(torch.isfinite(new_F).all() and torch.isfinite(affine).all())
