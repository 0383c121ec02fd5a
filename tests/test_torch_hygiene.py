"""The PyTorch port stands alone: no source in `plasticinelab_tpu_torch/`
(nor `chip_smoke.py`) mentions JAX or imports the TPU package, whose
`__init__` imports JAX, which the GPU machines do not carry, nor imports
flax or optax (the RL networks are torch modules, the optimizers
torch.optim); and every port module has an importer
(tests/test_no_orphans.py covers the TPU package)."""
import os
import re

import pytest

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
PKG = os.path.join(ROOT, "plasticinelab_tpu_torch")
SMOKE = os.path.join(ROOT, "chip_smoke.py")

MENTIONS_JAX = re.compile(r"jax", re.IGNORECASE)
IMPORTS_TPU_PKG = re.compile(
    r"^\s*(?:from|import)\s+plasticinelab_tpu(?:\.|\s|$)", re.MULTILINE)
IMPORTS_FLAX_OPTAX = re.compile(r"^\s*(?:from|import)\s+(?:flax|optax)\b|"
                                r"import_module\(\s*[\"'](?:flax|optax)", re.MULTILINE)


def _sources(exts):
    out = []
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(exts)]
    return sorted(out)


def _read(path):
    with open(path) as f:
        return f.read()


@pytest.mark.parametrize("path", [SMOKE] + _sources((".py", ".cu", ".cuh")),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_and_no_tpu_package(path):
    src = _read(path)
    assert not MENTIONS_JAX.search(src), f"{path} mentions jax"
    assert not IMPORTS_TPU_PKG.search(src), f"{path} imports plasticinelab_tpu"


@pytest.mark.parametrize("path", [SMOKE] + _sources((".py",)),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_flax_and_no_optax(path):
    assert not IMPORTS_FLAX_OPTAX.search(_read(path)), f"{path} imports flax or optax"


def test_every_port_module_has_an_importer():
    blob = "\n".join(_read(p) for p in _sources((".py",)) + [SMOKE])
    for root, _, files in os.walk(os.path.join(ROOT, "tests")):
        blob += "\n".join(_read(os.path.join(root, f)) for f in files if f.endswith(".py"))
    orphans = []
    for path in _sources((".py",)):
        if os.path.basename(path) == "__init__.py":
            continue
        leaf = os.path.basename(path)[:-3]
        pat = re.compile(r"(?:from\s+[\w.]*\.?%s\s+import|import\s+[\w.]*\b%s\b|"
                         r"from\s+[\w.]+\s+import\s+[^\n]*\b%s\b)" % (leaf, leaf, leaf))
        if not pat.search(blob):
            orphans.append(os.path.relpath(path, PKG))
    assert not orphans, f"port modules with no importer: {orphans}"


def test_kernel_sources_are_in_the_package():
    cu = [os.path.basename(p) for p in _sources((".cu",))]
    assert sorted(cu) == ["gridop.cu", "stress.cu", "transfer.cu", "voxelize.cu"]
