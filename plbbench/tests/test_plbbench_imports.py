"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program either. Names are compared by
their top-level part (before the first dot), whole: the program's name
begins with the JAX package's."""
import ast
import os

import pytest

from conftest import BENCH

JAX_NAMES = {"jax", "jaxlib", "flax", "plasticinelab_tpu"}
PROGRAM = "plasticinelab_tpu_torch"


def _sources():
    for dirpath, _, files in os.walk(BENCH):
        if os.sep + "tests" in dirpath[len(BENCH):] or "__pycache__" in dirpath:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


SOURCES = sorted(_sources())


def test_the_harness_files_are_all_seen():
    names = {os.path.relpath(p, BENCH) for p in SOURCES}
    for must in ("run.py", "roofline.py", "compare.py", "inputs.py", "tracing.py",
                 os.path.join("traffic", "vec_env.py"), os.path.join("reference", "mpm.py"),
                 os.path.join("reference", "render.py"),
                 os.path.join("metrics", "env_steps_per_s.py")):
        assert must in names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_import(path):
    found = set(_top_level_imports(path)) & JAX_NAMES
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize("path", [p for p in SOURCES
                                  if os.path.relpath(p, BENCH).startswith("reference")],
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in set(_top_level_imports(path))


def test_the_run_checks_loaded_modules_by_whole_top_level_name():
    import run

    assert run.forbidden_modules(["plasticinelab_tpu_torch.engine.mpm", "numpy"]) == []
    assert run.forbidden_modules(["plasticinelab_tpu.engine", "jax.numpy", "flax",
                                  "jaxlib.xla_client"]) == ["flax", "jax", "jaxlib",
                                                            "plasticinelab_tpu"]
