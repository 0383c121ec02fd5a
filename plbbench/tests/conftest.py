"""The benchmark's own tests: `python -m pytest plbbench/tests -q` from the
repository root. Tests that need the card carry the `card` marker and skip
here with the reason; whether a card is present is decided inside them."""
import json
import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _evaluated(v):
    """A spec value with its arithmetic strings ('(0.5, 0.1)', '127<<16')
    evaluated, as PlasticineLab's loader does."""
    if isinstance(v, str):
        try:
            v = eval(v, {"__builtins__": {}}, {})
        except (SyntaxError, NameError):
            return v
        return list(v) if isinstance(v, tuple) else v
    if isinstance(v, list):
        return [_evaluated(x) for x in v]
    if isinstance(v, dict):
        return {k: _evaluated(x) for k, x in v.items()}
    return v


def task_spec(task: str) -> dict:
    """The task's v1 spec as a configuration file holds it: the JAX
    package's frozen spec (`plasticinelab_tpu/envs/specs/<task>-v1.json`,
    read as a file), its arithmetic strings evaluated and the program's
    grid-velocity clamp (0.5) stated."""
    with open(os.path.join(ROOT, "plasticinelab_tpu", "envs", "specs", f"{task}-v1.json")) as f:
        spec = _evaluated(json.load(f))
    spec.pop("VARIANTS", None)
    spec["SIMULATOR"]["grid_v_clamp"] = 0.5
    return spec


def task_goal(spec: dict) -> np.ndarray:
    """The goal grid that the spec names, from the JAX package's assets."""
    return np.load(os.path.join(ROOT, "plasticinelab_tpu", "envs", "assets",
                                spec["ENV"]["loss"]["target_path"]))
