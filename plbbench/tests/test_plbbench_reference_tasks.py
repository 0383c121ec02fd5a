"""The plain reference against the program's CPU path in every task's v1
scene, so that a configuration of any of the ten tasks comes in as files:
all seven manipulator shapes, Chopsticks' gap and its turn in its own frame,
RollingPin's roll.

Each scene is the task's v1 spec as a configuration file holds it
(`conftest.task_spec`); one more puts all seven shapes into Writer-v1's
scene, a Box among them, which no task has. B = 2 envs take 3 env steps
under actions drawn from a seed over every action dimension (turns and the
gap's velocity included); the reference steps each from the program's state
before it, in float64, as the benchmark's comparison does.

The numbers are the benchmark's own (`compare.py`): the particle fields
over the bulk of each env's particles (the 5% with the largest gaps left
out), positions in grid cells. Tolerances and their reasons:
- x, the bulk's rms gap in grid cells: 1e-3 (read: 3e-6 to 1.2e-4);
- F (to F - I), v and C (to their size), the bulk's relative gap: 2e-2.
  The program steps in float32, the reference in float64, and over three
  steps in a scene at rest on a floor (Rope, Table, Pinch, Torus) float32
  reads far above the 1e-3 of one Move or Writer step
  (`test_plbbench_reference.py`): the port 3e-5 to 6.4e-3, the reference
  itself in float32 1.1e-4 to 2.0e-2, spread through the bulk;
- positions of the manipulators relative to their change, 1e-3; rotations
  and gaps absolute, 1e-6 (float32 rounding of unit quaternions and of
  gaps of a few hundredths), and so the reset observation (the float32
  start poses): `test_plbbench_reference.py`'s;
- loss and reward relative to the loss, 1e-5 (float32 sums over the 64^3
  grid), as there.
"""
import math

import pytest
import torch

from conftest import task_goal, task_spec

TASKS = ("move", "writer", "chopsticks", "rollingpin", "rope", "torus", "table", "pinch",
         "assembly", "triplemove")
FIELDS = ("x", "v", "C", "F", "prim_pos", "prim_rot", "prim_gap")
STEPS = 3
SEED = 2 ** 31 + 11


def seven_shapes_spec() -> dict:
    """Writer-v1's slab under one manipulator of each of the seven shapes,
    each a centimetre into its top (at y = 0.1), each with the actions its
    shape takes (the Box turns too; the Cylinder stands still)."""
    spec = task_spec("writer")

    def prim(shape, pos, scale, **kw):
        return dict(kw, shape=shape, init_pos=list(pos), friction=0.9,
                    color=[0.8, 0.8, 0.8], action={"dim": len(scale), "scale": list(scale)})

    s3 = [0.01] * 3
    spec["PRIMITIVES"] = [
        prim("Sphere", (0.4, 0.11, 0.4), s3, radius=0.03),
        prim("Capsule", (0.6, 0.13, 0.4), s3, h=0.06, r=0.03, init_rot=[0.0, 0.0, 0.0, 1.0]),
        prim("RollingPin", (0.5, 0.11, 0.62), (0.7, 0.07, 0.001), h=0.1, r=0.02,
             init_rot=[0.707, 0.707, 0.0, 0.0]),
        prim("Chopsticks", (0.4, 0.2, 0.6), (0.02, 0.02, 0.02, 0.04, 0.04, 0.04, 0.02),
             h=0.1, r=0.015, init_gap=0.06),
        prim("Cylinder", (0.62, 0.11, 0.62), (), h=0.03, r=0.02),
        prim("Torus", (0.5, 0.11, 0.5), s3, tx=0.04, ty=0.015, init_rot=[0.0, 0.0, 0.0, 1.0]),
        prim("Box", (0.43, 0.11, 0.5), s3 + [0.04] * 3, size=[0.02, 0.02, 0.03]),
    ]
    spec["PRIMITIVES"][4].pop("action")
    return spec


def spec_of(scene: str) -> dict:
    return seven_shapes_spec() if scene == "seven-shapes" else task_spec(scene)


def scene_and_envs(task):
    """(the reference's scene, the program's 2 envs on the CPU, the
    reference in float64) of a scene."""
    from plasticinelab_tpu_torch.config.loader import scene_from_dict
    from plasticinelab_tpu_torch.parallel.rollout import VecPlasticineEnv

    import inputs
    from compare import Reference
    from reference.scene import scene_of

    spec = spec_of(task)
    cloud, goal = inputs.task_cloud(spec), task_goal(spec)
    env = VecPlasticineEnv(None, batch=2, seed=SEED, jitter=1e-3, scene=scene_from_dict(spec),
                           target_density=goal, particles=cloud, device="cpu")
    sc = scene_of(spec)
    ref = Reference(sc, goal, inputs.jittered_starts(cloud, 2, SEED, 1e-3),
                    torch.device("cpu"), torch.float64, 666.0)
    return sc, env, ref


def step_gaps(task):
    """The worst gap of each number over the 3 env steps."""
    import inputs
    from compare import bulk_rel_per_env, bulk_rms_per_env, rel_per_env, worst
    from reference import mpm

    sc, env, ref = scene_and_envs(task)
    assert torch.equal(env.states.x, ref.x0)
    obs0 = env.reset()
    gaps = {"start": float((obs0.double() - mpm.state_obs(sc, ref.start_state())).abs().max())}
    eye = torch.eye(3, dtype=torch.float64)
    acts = inputs.Actions(SEED, STEPS, 2, sc.action_dim, "cpu").episode()
    for a in acts:
        before = mpm.State(*(getattr(env.states, f).double() for f in FIELDS))
        _, reward, _, info = env.step(a)
        port = mpm.State(*(getattr(env.states, f) for f in FIELDS))
        st, loss, ref_reward, _, _ = ref.step(before, a)
        now = {"x": bulk_rms_per_env(port.x, st.x, sc.dx),
               "F": bulk_rel_per_env(port.F, st.F, st.F - eye),
               "v": bulk_rel_per_env(port.v, st.v, st.v),
               "C": bulk_rel_per_env(port.C, st.C, st.C),
               "pos": rel_per_env(port.pos, st.pos, before.pos),
               "rot": float((port.rot.double() - st.rot).abs().max()),
               "gap": float((port.gap.double() - st.gap).abs().max()),
               "loss": worst(float(((info["loss"].double() - loss) / loss).abs().max()),
                             float(((reward.double() - ref_reward) / loss).abs().max()))}
        gaps.update({k: worst(gaps.get(k, 0.0), v) for k, v in now.items()})
    return gaps


LIMITS = {"x": 1e-3, "F": 2e-2, "v": 2e-2, "C": 2e-2, "pos": 1e-3, "rot": 1e-6, "gap": 1e-6,
          "loss": 1e-5, "start": 1e-6}


@pytest.mark.parametrize("task", TASKS + ("seven-shapes",))
def test_three_env_steps_match_the_program(task):
    gaps = step_gaps(task)
    over = {k: v for k, v in gaps.items() if not v <= LIMITS[k]}
    assert not over, (over, gaps)


def test_chopsticks_turn_composes_in_its_own_frame(monkeypatch):
    """The base rule's turn, w2quat(w) rot, fed to the Chopsticks scene
    fails the parity: from the second step on the sticks are turned, and
    the two orders part."""
    from reference.shapes import chopsticks
    from reference.quat import qmul, w2quat

    def base_turn(params, pos, rot, gap, v, w, gap_vel):
        _, _, new_gap = real(params, pos, rot, gap, v, w, gap_vel)
        return pos + v, qmul(w2quat(w), rot), new_gap

    real = chopsticks.fk
    monkeypatch.setattr(chopsticks, "fk", base_turn)
    gaps = step_gaps("chopsticks")
    assert gaps["rot"] > 100 * LIMITS["rot"], gaps


def test_chopsticks_gap_stops_at_its_minimal_gap():
    from reference import mpm
    from reference.scene import scene_of

    sc = scene_of(task_spec("chopsticks"))
    f64 = torch.float64
    pos = torch.tensor([[[0.5, 0.15, 0.5]]] * 3, dtype=f64)
    rot = torch.tensor([[[1.0, 0.0, 0.0, 0.0]]] * 3, dtype=f64)
    gap = torch.tensor([[0.07], [0.1], [0.061]], dtype=f64)
    # action 7 at +1 closes the gap by its scale over the substeps
    actions = torch.zeros(3, 7, dtype=f64)
    actions[:, 6] = torch.tensor([1.0, 1.0, -1.0])
    v, w, gap_vel = mpm.controls(sc, actions)
    assert float(gap_vel[0, 0]) == pytest.approx(0.02 / sc.substeps)
    g = gap
    for _ in range(sc.substeps):
        _, _, g = mpm.fk(sc, pos, rot, g, v, w, gap_vel)
    assert g[:, 0].tolist() == pytest.approx([0.06, 0.08, 0.081])
    assert float(g.min()) >= 0.06


def test_one_rollingpin_roll_matches_a_hand_worked_pose():
    """From a pin turned a quarter about x (its axis along world z), one
    substep of (dw, dth, dy) rolls it about its own axis by dw, moves it
    -0.03 dw along x and dy up, and turns it by dth about the world's y."""
    from reference import mpm
    from reference.scene import scene_of

    sc = scene_of(task_spec("rollingpin"))
    f64 = torch.float64
    h = math.sqrt(0.5)
    pos = torch.tensor([[[0.5, 0.2, 0.5]]], dtype=f64)
    rot = torch.tensor([[[h, h, 0.0, 0.0]]], dtype=f64)
    dw, dth, dy = 0.3, 0.2, 0.01
    v = torch.tensor([[[dw, dth, dy]]], dtype=f64)
    zero3, zero = torch.zeros(1, 1, 3, dtype=f64), torch.zeros(1, 1, dtype=f64)
    pos1, rot1, gap1 = mpm.fk(sc, pos, rot, zero, v, zero3, zero)
    # rot e_-y = -e_z, e_y x -e_z = -e_x: the pin moves -0.03 dw along x
    assert pos1[0, 0].tolist() == pytest.approx([0.5 - 0.03 * dw, 0.2 + dy, 0.5], abs=1e-15)
    # (cos t, 0, -sin t, 0) (h, h, 0, 0) (cos u, 0, sin u, 0), t = dth / 2,
    # u = dw / 2, multiplied out by hand
    ct, st, cu, su = math.cos(dth / 2), math.sin(dth / 2), math.cos(dw / 2), math.sin(dw / 2)
    want = [h * (ct * cu + st * su), h * (ct * cu - st * su), h * (ct * su - st * cu),
            h * (ct * su + st * cu)]
    assert rot1[0, 0].tolist() == pytest.approx(want, abs=1e-15)
    assert float(gap1) == 0.0


@pytest.mark.parametrize("shape", ["Sphere", "Capsule", "RollingPin", "Chopsticks", "Cylinder",
                                   "Torus", "Box"])
def test_every_shape_has_its_normal_and_bounding_sphere(shape):
    """Each shape's normal is its signed distance's gradient away from its
    creases, and its bounding sphere holds its surface."""
    from reference.shapes import shape_module

    params = seven_shapes_spec()["PRIMITIVES"][
        ["Sphere", "Capsule", "RollingPin", "Chopsticks", "Cylinder", "Torus", "Box"].index(shape)]
    mod = shape_module(shape)
    f64 = torch.float64
    gen = torch.Generator().manual_seed(3)
    n = 4000
    pos = torch.tensor([0.5, 0.4, 0.5], dtype=f64)
    rot = torch.nn.functional.normalize(torch.tensor([0.9, 0.2, -0.3, 0.1], dtype=f64), dim=0)
    gap = torch.full((n,), 0.07, dtype=f64)
    p = pos + (torch.rand(n, 3, generator=gen, dtype=f64) - 0.5) * 0.3
    d = mod.sdf(params, pos, rot, p, gap)
    nrm = mod.normal(params, pos, rot, p, gap)
    eps = 1e-6
    grad = torch.stack([(mod.sdf(params, pos, rot, p + e, gap)
                         - mod.sdf(params, pos, rot, p - e, gap)) / (2 * eps)
                        for e in torch.eye(3, dtype=f64) * eps], -1)
    # a crease (two sticks tied, a box's edge) has no gradient of length 1
    smooth = (grad.norm(dim=-1) - 1).abs() < 1e-4
    assert float(smooth.double().mean()) > 0.9
    # the Box's normal is PlasticineLab's central difference of step 1e-4,
    # which near a crease straddles a face's region and an edge's: off by up
    # to the step over the edge's distance
    tol = 1e-2 if shape == "Box" else 1e-4
    assert float((nrm[smooth] - grad[smooth]).abs().max()) < tol
    rad = torch.as_tensor(mod.bounding_radius(params, gap), dtype=f64).expand(n)
    near = d.abs() < 2e-3
    assert bool(near.any())
    assert bool(((p[near] - pos).norm(dim=-1) <= rad[near] + 2e-3).all())
