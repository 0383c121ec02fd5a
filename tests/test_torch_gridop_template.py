"""Which instantiation of the grid update (K8, `csrc/gridop.cu`) a launch
takes, and its counter `cuda_gridop_template` (`engine/cuda_gridop.py`).

`plb_grid_op` and `plb_grid_op_bwd` launch the sphere-only instantiation
where `all_spheres(table)` holds, and the all-shapes one otherwise;
`cuda_gridop.template_of` mirrors that choice, and each launch, forward or
backward, counts one under its key `spheres` or `all_shapes`:
- on the CPU: `template_of` for each task's v1 scene against a table
  written out from the tasks' primitives, the source's test against the
  shape id of a Sphere, and the count of each launch through a recording
  fake of the kernel library;
- on the card (`card` marker; skips without one): one batched env step
  counts its 19 forward launches under its scene's key and none under the
  other. The file imports no JAX, so on a machine without it:
  `python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gridop_template.py`.
"""
import os
import re

import pytest
import torch

from plasticinelab_tpu_torch.engine import cuda_build, cuda_gridop
from plasticinelab_tpu_torch.envs.env import PlasticineEnv

# each task's v1 primitives: Move 2 Spheres, Table, Pinch 1, Assembly 2,
# TripleMove 6; Writer a Capsule, Chopsticks, RollingPin, Rope 2 Spheres
# and a Cylinder, Torus
TEMPLATES = {"move": "spheres", "table": "spheres", "pinch": "spheres",
             "assembly": "spheres", "triplemove": "spheres", "writer": "all_shapes",
             "chopsticks": "all_shapes", "rollingpin": "all_shapes", "rope": "all_shapes",
             "torus": "all_shapes"}
SUBSTEPS = 19


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("task", sorted(TEMPLATES))
def test_template_of_each_task(task):
    assert cuda_gridop.template_of(PlasticineEnv.load_scene(task, 1)) == TEMPLATES[task]


def test_template_of_mirrors_the_source():
    """`all_spheres` holds where no primitive's shape id differs from
    kSphere, whose id is the wrapper's for a Sphere; no primitive is
    spheres."""
    path = os.path.join(os.path.dirname(cuda_build.__file__), "..", "csrc", "gridop.cu")
    with open(path) as f:
        src = f.read()
    assert int(re.search(r"\bkSphere = (\d+)", src).group(1)) == cuda_gridop.SHAPE_IDS["Sphere"]
    body = re.search(r"bool all_spheres\(const PrimTable& table\) \{(.*?)\n\}", src, re.S)
    assert "if (table.shape[i] != kSphere) return false;" in body.group(1)
    assert "return true;" in body.group(1)
    scene = PlasticineEnv.load_scene("move", 1)
    assert cuda_gridop.template_of(scene.replace(primitives=())) == "spheres"


class _Recorder:
    """A stand-in for the kernel library: each entry point returns 0."""

    def __getattr__(self, name):
        return lambda *args: 0


@pytest.mark.parametrize("task", ["chopsticks", "move"])
def test_each_launch_counts_its_template(monkeypatch, task):
    monkeypatch.setattr(cuda_build, "library", lambda: _Recorder())
    monkeypatch.setattr(cuda_build, "require_kernel_input", lambda t, name: None)
    monkeypatch.setattr(cuda_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(cuda_gridop, "_scratch", {})
    scene = PlasticineEnv.load_scene(task, 1)
    B, G, k = 2, scene.simulator.n_grid, len(scene.primitives)
    grid4, poses = torch.zeros(B, G ** 3, 4), torch.zeros(B, k, 16)
    soft, ct = torch.full((B,), 666.0), torch.zeros(B, G ** 3, 3)
    before = dict(cuda_gridop.templates)
    launches = dict(cuda_gridop.launches)
    cuda_gridop._launch_fwd(scene, grid4, poses, soft)
    cuda_gridop.grid_op_bwd(scene, grid4, poses, soft, ct)
    key = TEMPLATES[task]
    assert {t: n - before[t] for t, n in cuda_gridop.templates.items()} == {
        t: 2 * (t == key) for t in ("spheres", "all_shapes")}
    assert {n: c - launches[n] for n, c in cuda_gridop.launches.items()} == {
        n: int(n in ("grid_op_batched", "grid_op_bwd_batched")) for n in launches}


@pytest.mark.card
@pytest.mark.parametrize("task,key", [("Chopsticks-v1", "all_shapes"), ("Move-v1", "spheres")])
def test_one_batched_step_counts_its_substeps_under_its_template(card, task, key):
    from plasticinelab_tpu_torch.parallel import VecPlasticineEnv

    env = VecPlasticineEnv(task, batch=8, device=card)
    env.reset()
    actions = torch.rand(8, env.action_dim, device=card) * 2 - 1
    env.step(actions)
    before = dict(cuda_gridop.templates)
    env.step(actions)
    torch.cuda.synchronize(card)
    assert {t: n - before[t] for t, n in cuda_gridop.templates.items()} == {
        t: SUBSTEPS * (t == key) for t in ("spheres", "all_shapes")}
