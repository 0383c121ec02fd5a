"""The port's spans and counters (`utils/profiling.py`), on the CPU:
- `span()` is one shared no-op context with no profiler running, and a
  `record_function` under one;
- one batched Move-v1 step at B = 2 under torch.profiler gives the span
  tree `plb.env.step` > `plb.physics` > (`plb.physics.cell_order`, 19
  `plb.physics.fk`), then `plb.loss` and `plb.observe`;
- a Writer-v1 rgb step at B = 1 and 16^2 x 1 spp gives `plb.observe` >
  `plb.render.textures`, `plb.render.march`, and a positive count of
  `render.march_iters`;
- `snapshot()` and `reset()` cover the four launch groups and the
  renderer's, the modules' `launches` being the registry's own dicts;
- the primitives' constants are built once: a second forward kinematics
  and controls of a scene reuse 3 a primitive and build none;
- no span name, in a profile or in the package's source, contains
  `Synchronize` or lies outside `plb.`;
- `trace(path)` writes a chrome trace that holds the spans."""
import json
import pathlib
import re

import numpy as np
import pytest
import torch

from plasticinelab_tpu_torch.engine import cuda_gridop, cuda_stress, cuda_transfer, mpm
from plasticinelab_tpu_torch.engine import primitives as prim
from plasticinelab_tpu_torch.engine.renderer import cuda_voxelize, renderer
from plasticinelab_tpu_torch.envs.env import PlasticineEnv
from plasticinelab_tpu_torch.parallel import VecPlasticineEnv
from plasticinelab_tpu_torch.utils import profiling

PACKAGE = pathlib.Path(profiling.__file__).resolve().parents[1]
LAUNCH_GROUPS = {"cuda_stress": cuda_stress, "cuda_transfer": cuda_transfer,
                 "cuda_gridop": cuda_gridop, "cuda_voxelize": cuda_voxelize}


def _profiled(fn):
    """fn() under torch.profiler (CPU) -> the profile's `plb.` spans as
    (start, end, name), in start order."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                  if e.name.startswith("plb."))


def _children(spans, parent):
    """Names of the spans whose innermost enclosing span is `parent`."""
    ps, pe, _ = parent
    inside = [s for s in spans if ps <= s[0] and s[1] <= pe and s != parent]
    return [s[2] for s in inside
            if not any(o[0] <= s[0] and s[1] <= o[1] and o != s for o in inside)]


def _one(spans, name):
    found = [s for s in spans if s[2] == name]
    assert len(found) == 1, (name, found)
    return found[0]


@pytest.fixture(scope="module")
def move_spans():
    env = VecPlasticineEnv("Move-v1", batch=2, device="cpu")
    env.reset()
    actions = torch.zeros(2, env.action_dim)
    return _profiled(lambda: env.step(actions))


def test_span_is_a_shared_no_op_without_a_profiler():
    assert not torch._C._autograd._profiler_enabled()
    a, b = profiling.span("plb.a"), profiling.span("plb.b")
    assert a is b and not isinstance(a, torch.profiler.record_function)
    with a:
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert isinstance(profiling.span("plb.a"), torch.profiler.record_function)


def test_move_step_span_tree(move_spans):
    step = _one(move_spans, "plb.env.step")
    assert _children(move_spans, step) == ["plb.physics", "plb.loss", "plb.observe"]
    physics = _children(move_spans, _one(move_spans, "plb.physics"))
    # one forward-kinematics span a substep, whichever primitives move
    assert physics == ["plb.physics.cell_order"] + ["plb.physics.fk"] * 19
    # the kernels run only on a card; their plain versions open no span
    assert not [s for s in move_spans if s[2].startswith("plb.kernel.")]


def test_rgb_step_spans_and_march_count():
    env = VecPlasticineEnv("Writer-v1", 1, obs_mode="rgb", image_obs_res=16, image_obs_spp=1,
                           device="cpu")
    env.reset()
    before = profiling.snapshot()["render.march_iters"]
    spans = _profiled(lambda: env.step(np.zeros((1, env.action_dim))))
    iters = profiling.snapshot()["render.march_iters"] - before
    assert iters > 0
    observe = _children(spans, _one(spans, "plb.observe"))
    assert observe[0] == "plb.render.textures"
    assert "plb.render.march" in observe and "plb.render.sphere_trace" in observe
    assert set(observe) <= {"plb.render.textures", "plb.render.march",
                            "plb.render.sphere_trace"}


def test_registry_holds_the_launch_groups():
    for group, module in LAUNCH_GROUPS.items():
        assert profiling.counter_group(group, ()) is module.launches
    assert profiling.counter_group("render", ()) is renderer.counts
    before = profiling.snapshot()
    cuda_transfer.launches["p2g_batched"] += 3
    renderer.counts["march_iters"] += 2
    snap = profiling.snapshot()
    assert snap["cuda_transfer.p2g_batched"] == before["cuda_transfer.p2g_batched"] + 3
    assert snap["render.march_iters"] == before["render.march_iters"] + 2
    keys = {f"{g}.{k}" for g, m in LAUNCH_GROUPS.items() for k in m.launches}
    assert keys | {"render.march_iters"} <= set(snap)
    cuda_transfer.reset_launches()
    assert profiling.snapshot()["cuda_transfer.p2g_batched"] == 0
    profiling.reset()
    assert not any(profiling.snapshot().values())
    assert cuda_transfer.launches["p2g_batched"] == 0 and renderer.counts["march_iters"] == 0


def test_primitive_constants_are_built_once():
    scene = PlasticineEnv.load_scene("move", 1)
    k = len(scene.primitives)
    poses = (torch.rand(2, k, 3), torch.rand(2, k, 4), torch.rand(2, k))
    actions = torch.rand(2, scene.action_dim)

    def fk_and_controls():
        mpm.fk_step(scene, poses, mpm.make_controls_batched(scene, actions, "cpu",
                                                            torch.float32))
        snap = profiling.snapshot()
        return snap["primitives.consts_built"], snap["primitives.consts_reused"]

    assert profiling.counter_group("primitives", ()) is prim.counts
    fk_and_controls()
    built, reused = fk_and_controls()
    # two bounds a primitive in fk_step, one action scale in the controls
    assert fk_and_controls() == (built, reused + 3 * k)


def _span_names_in_source():
    names = set()
    for path in PACKAGE.rglob("*.py"):
        names |= set(re.findall(r'span\("([^"]*)"\)', path.read_text()))
    return names


def test_span_names(move_spans):
    names = _span_names_in_source()
    assert {"plb.env.step", "plb.physics", "plb.physics.fk", "plb.kernel.p2g",
            "plb.kernel.voxelize", "plb.render.march"} <= names
    names |= {s[2] for s in move_spans}
    for name in names:
        assert name.startswith("plb.") and "Synchronize" not in name, name


def test_trace_writes_the_spans(tmp_path):
    path = tmp_path / "trace.json"
    with profiling.trace(str(path)):
        with profiling.span("plb.test"):
            torch.ones(4).add_(1)
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "plb.test" for e in events)
