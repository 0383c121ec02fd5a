"""The harness: cells resolve by name, new cells come as files, names keep
to the allowed characters, the roofline's arithmetic, and whole runs on the
CPU at a test's size (B = 2) with the timed path sound, broken underneath,
or replaced by the bfloat16 control, where `correct` has to come out
true, false and false."""
import json
import os
import re
import shutil
import subprocess
import sys
import time

import pytest
import torch

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_cell_resolves_by_name():
    import run

    bench = _bench()
    for w in bench["workloads"]:
        cell = run.load_cell(w["name"])
        assert cell.config["spec"]["SIMULATOR"]["n_particles"] > 0
        assert hasattr(cell.kind, "run") and hasattr(cell.kind, "compare")
        assert os.path.exists(cell.limits_path)
        for m in cell.end_to_end + cell.per_layer:
            assert hasattr(run.reader(m["name"]), "read")
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer


def test_names_and_units_keep_to_the_allowed_characters():
    bench = _bench()
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    names += [w["traffic"] for w in bench["workloads"]] + [w["config"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for group in (bench["configs"], bench["workloads"], bench["end_to_end"] + bench["per_layer"]):
        assert len({g["name"] for g in group}) == len(group)
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]


def test_a_new_config_traffic_kind_and_metric_are_found_as_files(tmp_path):
    """Copy the benchmark, add a configuration, a traffic mix of a new kind
    and a per-layer metric as new files and entries; every file that was
    there stays as it was, and the new cell resolves in a fresh process."""
    dst = tmp_path / "checkout"
    shutil.copytree(BENCH, dst / "plbbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (dst / "plbbench").rglob("*") if p.is_file()}
    b = dst / "plbbench"
    cfg = json.loads((b / "configs" / "move-v1.json").read_text())
    (b / "configs" / "move-v2.json").write_text(json.dumps(cfg))
    (b / "traffic" / "burst-b8.json").write_text(json.dumps({"kind": "burst", "batch": 8}))
    (b / "traffic" / "burst.py").write_text("def run(ctx):\n    return {}\n\n\n"
                                            "def compare(ctx, out):\n    return {}\n")
    (b / "metrics" / "queue_ms.py").write_text("def read(run):\n    return 1.0\n")
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="move-v2",
                                 file="plbbench/configs/move-v2.json"))
    bench["workloads"].append({"name": "move-v2.burst-b8", "config": "move-v2",
                               "traffic": "burst-b8", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "queue_ms", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "device (H100)",
                               "moves": "env_steps_per_s", "workloads": ["move-v2.burst-b8"]})
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import sys; sys.path.insert(0, sys.argv[1] + '/plbbench'); import run; "
            "c = run.load_cell('move-v2.burst-b8', root=sys.argv[1]); "
            "print(c.kind.__file__, [m['name'] for m in c.per_layer], "
            "run.reader('queue_ms').read(None))")
    out = subprocess.run([sys.executable, "-c", code, str(dst)], capture_output=True,
                         text=True, check=True).stdout
    assert str(b / "traffic" / "burst.py") in out and "queue_ms" in out and "1.0" in out
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_roofline_of_one_move_substep_at_b2_by_hand():
    import roofline

    # B = 2 envs x n = 10,000 particles = 20,000; 5,000 cells with mass (the
    # grid is touched there only). Bytes, float32: stress 20,000 x 144 =
    # 2,880,000; P2G in 20,000 x 60 = 1,200,000, out 5,000 x 16 = 80,000;
    # grid update 5,000 x 28 = 140,000; G2P x in 20,000 x 12 = 240,000, the
    # grid 5,000 x 12 = 60,000, out 20,000 x 60 = 1,200,000: 5,800,000.
    # Operations: 20,000 x (2,093 + 900 + 700) + 5,000 x 300 = 75,360,000.
    assert roofline.substep(2, 10_000, 5_000) == (5_800_000, 75_360_000)
    # the mass P2G: 20,000 x 12 in, 5,000 x 4 out; 20,000 x 150 operations
    assert roofline.grid_mass(2, 10_000, 5_000) == (260_000, 3_000_000)
    # the substep is bytes-bound (1.73 us against 1.12 us of operations),
    # and so is the mass P2G (78 ns against 45 ns)
    least = roofline.env_step_least_s(2, 10_000, 19, 5_000)
    assert least == pytest.approx(19 * 5_800_000 / 3.35e12 + 260_000 / 3.35e12)


@pytest.mark.parametrize("B", [2, 256])
def test_one_env_at_fault_reads_as_itself(B):
    """Each compared number is the worst env's: one env of B left unstepped,
    or with a black frame, reads as it would alone, however large B; the
    bulk numbers leave out each env's few particles with the largest gaps,
    and no more."""
    from compare import (TRIM, bulk_rel_per_env, bulk_rms_per_env, frame_gap, frame_unequal,
                         rel_per_env)

    gen = torch.Generator().manual_seed(5)
    before = torch.randn(B, 100, 3, generator=gen, dtype=torch.float64)
    after = before + 0.01 * torch.randn(B, 100, 3, generator=gen, dtype=torch.float64)
    port = after + 1e-6 * torch.randn(B, 100, 3, generator=gen, dtype=torch.float64)
    assert rel_per_env(port, after, before) < 1e-3
    assert bulk_rel_per_env(port, after, after - before) < 1e-3
    assert bulk_rms_per_env(port, after, 0.01) < 1e-3
    # a branch flipped at a few particles of one env: the bulk numbers do not
    # see it, the whole one does
    flipped = port.clone()
    flipped[0, : int(100 * TRIM)] += 0.01
    assert rel_per_env(flipped, after, before) > 0.1
    assert bulk_rel_per_env(flipped, after, after - before) < 1e-3
    assert bulk_rms_per_env(flipped, after, 0.01) < 1e-3
    flipped[0, : int(100 * TRIM) + 1] += 0.01
    assert bulk_rel_per_env(flipped, after, after - before) > 1e-2
    port[B - 1] = before[B - 1]
    assert rel_per_env(port, after, before) == pytest.approx(1.0)
    assert bulk_rel_per_env(port, after, after - before) == pytest.approx(1.0)
    moved = (after[B - 1] - before[B - 1]).norm(dim=1).sort().values[: 100 - int(100 * TRIM)]
    assert bulk_rms_per_env(port, after, 0.01) == pytest.approx(
        float(moved.pow(2).mean().sqrt()) / 0.01)
    frames = torch.randint(1, 256, (B, 8, 8, 3), generator=gen).to(torch.uint8)
    port = frames.clone()
    port[0] = 0
    assert frame_gap(port, frames) == pytest.approx(float(frames[0].double().mean()))
    assert frame_unequal(port, frames) == 1.0
    assert frame_gap(frames, frames) == frame_unequal(frames, frames) == 0.0


def test_a_value_that_is_not_finite_fails_every_number():
    """A NaN on either side is no rounding: the bulk does not leave it out,
    and the worst of several numbers is NaN, which no limit passes."""
    import math

    from compare import bulk_rel_per_env, bulk_rms_per_env, rel_per_env, worst

    gen = torch.Generator().manual_seed(6)
    ref = torch.randn(4, 100, 3, generator=gen, dtype=torch.float64)
    port = ref + 1e-6 * torch.randn(4, 100, 3, generator=gen, dtype=torch.float64)
    port[2, 7, 1] = math.nan
    assert math.isnan(bulk_rel_per_env(port, ref, ref))
    assert math.isnan(bulk_rms_per_env(port, ref, 0.01))
    assert math.isnan(rel_per_env(port, ref, torch.zeros_like(ref)))
    assert math.isnan(worst(0.0, 1e-3, math.nan)) and worst(0.0, 1e-3) == 1e-3
    assert not math.nan <= 1.0


# -- whole runs on the CPU -----------------------------------------------------

def _cpu_run(name, control=False, seconds=2.0, seed=2 ** 31 + 77):
    import run

    cell = run.load_cell(name)
    cell.traffic = dict(cell.traffic, batch=3, check_envs=2, samples=1, profile_steps=1)
    ctx = run.Context(cell, seed, seconds, False, torch.device("cpu"), t0=time.perf_counter())
    if control:
        ctx.make_env = cell.kind.control_env(ctx, torch.bfloat16)
    with pytest.MonkeyPatch.context() as mp:
        # the window's first step is the sampled one: a CPU step takes seconds
        mp.setattr(cell.kind, "SAMPLE_SPAN", (0.0, 0.0))
        mp.setattr(cell.kind, "WARM_STEPS", 1)
        return run.run_cell(ctx)


def test_a_sound_run_is_correct():
    res = _cpu_run("move-v1.vec-state-b256")
    assert res["correct"], res["checks"]
    assert list(res)[-2:] == ["checks", "_reference_s"]


def _break(monkeypatch, how):
    from plasticinelab_tpu_torch.engine import mpm
    from plasticinelab_tpu_torch.parallel import rollout

    real_step = mpm.env_step_batched
    real_loss = rollout.losses_mod.loss_and_components

    def unchanged(scene, mats, states, actions, softness, want_grid_m=False, ops=None):
        grid_m = mpm.KERNEL_OPS_BATCHED.grid_mass(scene, states.x)
        return (states, grid_m) if want_grid_m else states

    def half(scene, mats, states, actions, softness, want_grid_m=False, ops=None):
        B = states.x.shape[0]
        new, grid_m = real_step(scene, mats, states, actions, softness, want_grid_m=True)
        keep = torch.arange(B) < B // 2
        mixed = type(states)(*(torch.where(keep.view((B,) + (1,) * (a.dim() - 1)), n, a)
                               for n, a in zip(vars(new).values(), vars(states).values())))
        old_m = mpm.KERNEL_OPS_BATCHED.grid_mass(scene, states.x)
        grid_m = torch.where(keep[:, None], grid_m, old_m)
        return (mixed, grid_m) if want_grid_m else mixed

    def altered(scene, loss_state, state, grid_m):
        info = dict(real_loss(scene, loss_state, state, grid_m))
        info["loss"] = info["loss"] * 1.001
        return info

    if how == "unchanged":
        monkeypatch.setattr(rollout.mpm, "env_step_batched", unchanged)
    elif how == "half":
        monkeypatch.setattr(rollout.mpm, "env_step_batched", half)
    else:
        monkeypatch.setattr(rollout.losses_mod, "loss_and_components", altered)


@pytest.mark.parametrize("how", ["unchanged", "half", "altered"])
def test_a_broken_step_is_not_correct(monkeypatch, how):
    _break(monkeypatch, how)
    res = _cpu_run("move-v1.vec-state-b256")
    assert res["checks"]["missed_samples"]["value"] == 0
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", ["move-v1.vec-state-b256", "writer-v1.vec-rgb-b128"])
def test_the_bf16_control_is_not_correct(name):
    res = _cpu_run(name, control=True)
    assert res["checks"]["missed_samples"]["value"] == 0
    assert not res["correct"], res["checks"]


def test_a_sound_rgb_run_is_correct():
    res = _cpu_run("writer-v1.vec-rgb-b128")
    assert res["correct"], res["checks"]


@pytest.mark.card
def test_a_cell_runs_on_the_card(card):
    """One short run of each cell on the card, as the benchmark's command
    runs it."""
    bench = _bench()
    for w in bench["workloads"]:
        out = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                              w["name"], "--seed", "3141592653", "--seconds", "3",
                              "--trace", "0"], capture_output=True, text=True, cwd=ROOT)
        assert out.returncode == 0, out.stderr[-4000:]
        res = json.loads(out.stdout.strip().splitlines()[-1])
        assert res["correct"], res["checks"]
