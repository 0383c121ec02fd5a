"""Spans and counters of the port, on torch.profiler's clock.

Counterpart of `plasticinelab_tpu/utils/profiling.py`, whose `trace`
captures a device trace; `trace` here does the same with torch.profiler.

- `span(name)` marks a layer of the program (`plb.env.step`, `plb.physics`,
  `plb.kernel.p2g`, ...). While a torch profiler runs it is a
  `torch.profiler.record_function`, so the span shares the device trace's
  clock and nests around the runtime calls and device operations launched
  inside it; otherwise it is one shared no-op context, which costs a
  function call (a `record_function` costs ~10 us even with no profiler).
  Names start with `plb.` and never contain `Synchronize`: trace readers
  count host events by that word as waits on the device.
- Counters are plain dicts of ints in one registry, always on: an int add
  per event. `counter_group(name, keys)` registers a group and returns its
  dict, `snapshot()` reads every group as `{"<group>.<key>": int}`,
  `reset()` zeroes them. The kernel wrappers count their launches in the
  groups `cuda_stress`, `cuda_transfer`, `cuda_gridop` and `cuda_voxelize`,
  the grid update's launches again by instantiation in
  `cuda_gridop_template` (`.spheres`, `.all_shapes`), the renderer its
  march steps in `render.march_iters`, the manipulators
  their constant vectors in `primitives.consts_built` / `.consts_reused`.
- `trace(path)` profiles a block (CPU, and CUDA where there is a card) and
  writes a chrome trace to `path`, viewable in ui.perfetto.dev or
  chrome://tracing.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterable

import torch

_profiling = torch._C._autograd._profiler_enabled
_NO_SPAN = contextlib.nullcontext()
_groups: Dict[str, Dict[str, int]] = {}


def span(name: str):
    """`with span("plb.physics"): ...`: a profiler annotation while a torch
    profiler runs, else a shared no-op context."""
    return torch.profiler.record_function(name) if _profiling() else _NO_SPAN


def counter_group(name: str, keys: Iterable[str]) -> Dict[str, int]:
    """The registry's dict of group `name`, with a zero for each key it
    lacks; the same dict on every call."""
    group = _groups.setdefault(name, {})
    for k in keys:
        group.setdefault(k, 0)
    return group


def snapshot() -> Dict[str, int]:
    """Every counter, `{"<group>.<key>": count}`."""
    return {f"{g}.{k}": v for g, group in _groups.items() for k, v in group.items()}


def reset() -> None:
    """Zero every counter of every group."""
    for group in _groups.values():
        for k in group:
            group[k] = 0


@contextlib.contextmanager
def trace(path: str):
    """`with profiling.trace("step.json"): env.step(a)`: profile the block
    and write its chrome trace to `path`. Device work queued in the block
    is waited for before the profiler stops."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
