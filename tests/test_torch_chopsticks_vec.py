"""Chopsticks-v1 through the port's `VecPlasticineEnv` against the
benchmark's plain reference (`plbbench/reference/`), and the benchmark cell
`chopsticks-v1.vec-state-b256` that runs it.

The scene is the cell's configuration file, `plbbench/configs/
chopsticks-v1.json`, in float64 on the CPU, at a small size: B = 2 envs of
400 particles drawn from a seed out of the task's 10,000-particle rod, and
half the published quality (a 32^3 grid, 9 substeps of 2e-4 s; the goal
summed over 2^3 blocks), because the port's plain grid update runs every
cell of the grid: at 64^3 the three steps took 46 s of one core, and 15
minutes in the suite's parallel run. The manipulator, its gap, turn and
action scales, and the materials are as published. Three
env steps under actions drawn from the seed, whose seventh entry opens the
gap by one step's scale (0.06 -> 0.08), then closes it onto its
`minimal_gap` (0.06) and pushes on it once more (held there by the clamp);
the turns (entries 4-6) turn the sticks in their own frame. The reference
steps each env step from the port's state before it, as the benchmark's
comparison does; the sticks start inside the rod, so the step's contact
throws particles at the grid's velocity clamp.

Tolerances, float64 on both sides. The two sides add the scatter in
different orders and take different SVDs (the port's Jacobi sweeps, the
reference's `torch.linalg.svd`), which the plastic projection and the
contact's friction (10) carry through 27 substeps; read here: x 6.9e-15,
v 2.0e-13, C 1.0e-13 (of their largest magnitudes), F 1.8e-13, the
observation 1.9e-13, the rotations 1.1e-16, positions and gaps equal, loss
and reward 1.1e-15, IoU 7.6e-16. Each limit is 1e-9 of the field's largest magnitude (F, the
quaternions, the gap, IoU absolute): hundreds of times what float64 reads,
and far under one float32 rounding (6e-8), so a step taken in float32
anywhere on the port's path fails it.
"""
import hashlib
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from plasticinelab_tpu_torch.config.loader import scene_from_dict
from plasticinelab_tpu_torch.parallel.rollout import VecPlasticineEnv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "plbbench")
CELL = "chopsticks-v1.vec-state-b256"
SEED = 2 ** 31 + 19
N_PARTICLES = 400
GAP_ACTIONS = (-1.0, 1.0, 1.0)   # open, close onto minimal_gap, close against it
TOL = 1e-9
QUALITY = 0.5   # a 32^3 grid
FIELDS = ("x", "v", "C", "F", "prim_pos", "prim_rot", "prim_gap")


def _bench_module(name):
    """A module of the benchmark (`plbbench/<name>.py`), with `plbbench/`
    on the path as the benchmark runs."""
    if BENCH not in sys.path:
        sys.path.insert(0, BENCH)
    return importlib.import_module(name)


def _task_spec(task):
    """`plbbench/tests/conftest.py`'s `task_spec`, loaded from its file."""
    path = os.path.join(BENCH, "tests", "conftest.py")
    spec = importlib.util.spec_from_file_location("plbbench_tests_conftest", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.task_spec(task)


def _config():
    with open(os.path.join(BENCH, "configs", "chopsticks-v1.json")) as f:
        return json.load(f)


def test_the_configuration_is_the_frozen_v1_spec_and_its_goal():
    config = _config()
    assert config["spec"] == _task_spec("chopsticks")
    assert config["reduced"] == [] and config["precision"] == "float32"
    with open(os.path.join(ROOT, config["goal"]["file"]), "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == config["goal"]["sha256"]
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    (entry,) = [c for c in bench["configs"] if c["name"] == "chopsticks-v1"]
    assert entry["file"] == "plbbench/configs/chopsticks-v1.json" and entry["reduced"] == []


def test_the_cell_finds_a_reader_for_each_metric_and_its_limits():
    run = _bench_module("run")
    cell = run.load_cell(CELL)
    assert cell.entry["chips"] == 1 and cell.entry["traffic"] == "vec-state-b256"
    assert {m["name"] for m in cell.end_to_end} == {"env_steps_per_s", "peak_mem_gib", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        f"{n}.chopsticks" for n in ("step_host_ms", "syncs_per_step", "device_ops_per_step",
                                    "device_idle_share", "physics_roofline_share")}
    for m in cell.end_to_end + cell.per_layer:
        assert callable(run.reader(m["name"]).read), m["name"]
    with open(cell.limits_path) as f:
        limits = json.load(f)
    assert set(limits) == {"missed_samples", "start_gap", "state_gap", "x_gap", "obs_gap",
                           "loss_gap"}
    for name, lim in limits.items():
        assert lim["lower"] <= lim["limit"], name
        assert lim["upper"] is None or lim["limit"] < lim["upper"], name


@pytest.fixture(scope="module")
def three_steps():
    """The port's and the reference's states, observations and losses
    after each of the three env steps."""
    inputs = _bench_module("inputs")
    from compare import Reference
    from reference import mpm
    from reference.scene import scene_of

    config = _config()
    spec = json.loads(json.dumps(config["spec"]))
    spec["SIMULATOR"]["quality"] = QUALITY
    cloud = inputs.task_cloud(config["spec"])
    cloud = cloud[np.sort(np.random.default_rng(SEED).choice(len(cloud), N_PARTICLES,
                                                              replace=False))]
    G = inputs.goal_grid(config).shape[0] // 2
    goal = inputs.goal_grid(config).reshape(G, 2, G, 2, G, 2).sum((1, 3, 5))
    port_spec = json.loads(json.dumps(spec))
    port_spec["SIMULATOR"]["dtype"] = "float64"
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # small tensors: one thread, whatever the suite's load
    try:
        env = VecPlasticineEnv(None, batch=2, seed=SEED, jitter=1e-3,
                               scene=scene_from_dict(port_spec), target_density=goal,
                               particles=cloud, device="cpu")
        sc = scene_of(spec)
        ref = Reference(sc, goal, env.states.x.clone(), torch.device("cpu"), torch.float64,
                        666.0)
        start = (env.reset(), mpm.state_obs(sc, ref.start_state()))
        gen = torch.Generator().manual_seed(SEED)
        actions = torch.rand(len(GAP_ACTIONS), 2, sc.action_dim, generator=gen,
                             dtype=torch.float64) * 2 - 1
        actions[:, :, 6] = torch.tensor(GAP_ACTIONS)[:, None]
        steps = []
        for a in actions:
            before = mpm.State(*(getattr(env.states, f).clone() for f in FIELDS))
            obs, reward, _, info = env.step(a)
            st, loss, ref_reward, iou, inc = ref.step(before, a)
            port = mpm.State(*(getattr(env.states, f).clone() for f in FIELDS))
            steps.append({"port": port, "ref": st, "before": before,
                          "obs": (obs, mpm.state_obs(sc, st)),
                          "loss": (info["loss"], loss), "reward": (reward, ref_reward),
                          "iou": (info["iou"], iou), "inc": (info["incremental_iou"], inc)})
    finally:
        torch.set_num_threads(threads)
    assert sc.n_grid == env.scene.simulator.n_grid == G
    return {"start": start, "steps": steps, "sc": sc}


def _rel(got, want):
    """Largest gap over the largest magnitude of `want`."""
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("field", ["x", "v", "C"])
def test_particle_field_matches_the_reference(three_steps, field):
    for s in three_steps["steps"]:
        assert _rel(getattr(s["port"], field), getattr(s["ref"], field)) <= TOL, field


def test_deformation_gradient_matches_the_reference(three_steps):
    for s in three_steps["steps"]:
        assert float((s["port"].F - s["ref"].F).abs().max()) <= TOL


def test_pose_matches_the_reference_and_the_sticks_turn(three_steps):
    for s in three_steps["steps"]:
        assert _rel(s["port"].pos, s["ref"].pos) <= TOL
        assert float((s["port"].rot - s["ref"].rot).abs().max()) <= TOL
    identity = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float64)
    # every env's sticks turned away from their start
    assert float((three_steps["steps"][-1]["port"].rot - identity).abs().amax(-1).min()) > 1e-2


def test_gap_opens_then_closes_onto_its_minimal_gap(three_steps):
    sc = three_steps["sc"]
    minimal = sc.prims[0].params.get("minimal_gap", 0.06)
    scale = sc.prims[0].action_scale[6]
    want = (0.06 + scale, 0.06, minimal)
    for s, g in zip(three_steps["steps"], want):
        assert float((s["port"].gap - s["ref"].gap).abs().max()) <= TOL
        assert torch.allclose(s["port"].gap, torch.full_like(s["port"].gap, g), rtol=0, atol=1e-12)
    # held at the clamp, not under it
    assert bool((three_steps["steps"][-1]["port"].gap == minimal).all())


def test_the_sticks_act_on_the_rod(three_steps):
    """Gravity alone speeds a particle up by at most 0.27 a step (30 g dt
    over 9 substeps); the sticks' contact throws some far faster."""
    s = three_steps["steps"][0]
    assert float(s["ref"].v.norm(dim=-1).max()) > 10.0


def test_observation_matches_the_reference(three_steps):
    port, ref = three_steps["start"]
    assert _rel(port, ref) <= TOL
    for s in three_steps["steps"]:
        port, ref = s["obs"]
        assert port.shape == ref.shape == (2, 200 * 6 + 8)
        assert _rel(port, ref) <= TOL


@pytest.mark.parametrize("what", ["loss", "reward", "iou", "inc"])
def test_loss_matches_the_reference(three_steps, what):
    for s in three_steps["steps"]:
        port, ref = s[what]
        scale = s["loss"][1].abs() if what in ("loss", "reward") else 1.0
        assert float(((port - ref).abs() / scale).max()) <= TOL, what
