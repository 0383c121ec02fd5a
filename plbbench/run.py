#!/usr/bin/env python3
"""Benchmark of plasticinelab_tpu_torch on one NVIDIA H100: one run of one cell.

    python3 plbbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A run loads the cell's files by name (`BENCHMARK.json`'s workload entry,
`configs/<config>.json`, `traffic/<traffic>.json` and the kind that file
names, `traffic/<kind>.py`, the readers `metrics/<metric>.py` and the
limits `limits/<cell>.json`), sets up and warms the program, drives the
traffic for `--seconds`, compares the window's sampled steps with the plain
reference under `reference/`, and prints one JSON line last on stdout:
`correct`, `attempted`, `failed`, `metrics` (the end-to-end ones, or with
`--trace 1` the per-layer ones read from a profile of a fixed slice of the
window), `device`, `breakdown` (traced runs) and `checks`, each compared
number with its limit. Without a CUDA card, or with fewer cards than the
cell asks for, it prints no result and exits 2.

`--control bf16` puts the reference itself, in bfloat16, in the program's
place: the comparison's control run, which has to come out not correct.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()   # set-up is timed from here

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from typing import Callable, Optional  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "plasticinelab_tpu")


def _cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    program builds its library under build/ there by itself)."""
    build = os.path.join(ROOT, "build")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(build, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build, "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


for _p in (HERE, ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)


@dataclass
class Cell:
    name: str
    entry: dict
    config: dict
    traffic: dict
    kind: object
    end_to_end: list
    per_layer: list
    limits_path: str


def load_cell(name: str, root: str = ROOT) -> Cell:
    """Everything that belongs to the cell `name`, found by name."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    here = os.path.join(root, "plbbench")
    with open(os.path.join(here, "traffic", entry["traffic"] + ".json")) as f:
        traffic = json.load(f)
    kind = importlib.import_module(f"traffic.{traffic['kind']}")

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return Cell(name, entry, config, traffic, kind, mine(bench["end_to_end"]),
                mine(bench["per_layer"]), os.path.join(here, "limits", name + ".json"))


def reader(metric: str):
    """The reader of a metric: `metrics/<name>.py`, where a name split by
    the cells it serves (`<name>.<part>`) shares the reader of <name>."""
    return importlib.import_module(f"metrics.{metric.split('.')[0]}")


@dataclass
class Context:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    t0: float = T0
    make_env: Optional[Callable] = None
    chrome_trace: Optional[str] = None

    @property
    def config(self):
        return self.cell.config

    @property
    def traffic(self):
        return self.cell.traffic

    def sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


@dataclass
class RunView:
    outcome: dict
    reading: object = None


def run_cell(ctx: Context) -> dict:
    """Drive the cell and compare; -> the result line's object."""
    cell = ctx.cell
    out = cell.kind.run(ctx)
    view = RunView(out, out.get("reading"))
    if ctx.trace:
        if ctx.device.type == "cuda" and (view.reading is None or view.reading.busy_s <= 0):
            raise RuntimeError("the profiler recorded no device operation in the profiled steps")
        metrics = cell.per_layer if view.reading is not None else []
    else:
        metrics = cell.end_to_end
    values = {}
    for m in metrics:
        v = reader(m["name"]).read(view)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    t = time.perf_counter()
    numbers = cell.kind.compare(ctx, out)
    ref_s = time.perf_counter() - t
    limits = {}
    if os.path.exists(cell.limits_path):
        with open(cell.limits_path) as f:
            limits = {k: float(v["limit"]) for k, v in json.load(f).items()}
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    correct = bool(limits) and all(c["limit"] is not None and c["value"] <= c["limit"]
                                   for c in checks.values())
    device = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
              "kind": _device_name(ctx.device), "count": int(cell.entry["chips"]),
              "memory_peak_bytes": int(out["peak_bytes"])}
    result = {"correct": correct, "attempted": out["batch"] * out["steps"],
              "failed": int(out["failed"]), "metrics": values, "device": device}
    if ctx.trace:
        r = view.reading
        device["busy_s"] = r.busy_s
        device["window_s"] = r.span_s
        result["breakdown"] = {"device_ops": [list(x) for x in r.top_ops],
                               "idle_gaps": [list(x) for x in r.idle_gaps]}
    result["checks"] = checks
    result["_reference_s"] = ref_s
    return result


def _device_name(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def forbidden_modules(names=None):
    """The JAX names among the top-level names of `names` (by default the
    loaded modules), each compared whole."""
    return sorted({m.split(".")[0] for m in (sys.modules if names is None else names)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("bf16",), default=None,
                    help="put the reference in bfloat16 in the program's place")
    ap.add_argument("--chrome-trace", default=None,
                    help="with --trace 1, also write the profile there as a chrome trace")
    args = ap.parse_args(argv)
    _cache_dirs()
    cell = load_cell(args.workload)
    import torch

    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"plbbench: the cell needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    ctx = Context(cell, args.seed, args.seconds, bool(args.trace), device,
                  chrome_trace=args.chrome_trace)
    if args.control:
        ctx.make_env = cell.kind.control_env(ctx, torch.bfloat16)
    result = run_cell(ctx)
    found = forbidden_modules()
    if found:
        print(f"plbbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    ref_s = result.pop("_reference_s")
    print(f"plbbench: reference {ref_s:.3f} s", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
