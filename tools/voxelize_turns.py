#!/usr/bin/env python3
"""Time the voxelizer K9 of this tree beside an earlier tree's, in turns, on
one GPU, at Move-v1's shapes.

    python3 tools/voxelize_turns.py --parent DIR

DIR holds an earlier tree of the repository (`git archive <commit> | tar -x
-C DIR`) whose `plasticinelab_tpu_torch/csrc/voxelize.cu` has the C entry
`plb_voxelize(p, color, offs, vol, n, m, rx, ry, rz, scale, device,
stream)` of one env on a volume that the caller fills with 0xFFFFFFFF; it is
built here alone with `cuda_build.NVCC_FLAGS`, and its B-env time is B
fills and launches. Cases: the observation grid (84^3) and the frame grid
(168^3) at one env, and the observation grid at B = 2, 4, 8 and 32 with
per-env noise on the cloud; the tree's K9 as its wrapper runs it and in its
other mode (privatised or direct, `cuda_voxelize.launch_shape`). Every
output is held bit for bit to the plain version (the parent's only logged).
Each case runs parent, tree, tree, parent; a time is the median of CUDA
events around single calls queued behind a device sleep (L2-warm), and the
device time of the call's kernels, fills included, from torch.profiler.
Also prints ptxas' registers and spills of the tree's kernels and their
SASS instructions by opcode.
"""
import argparse
import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from plasticinelab_tpu_torch.engine import cuda_build as cb  # noqa: E402
from plasticinelab_tpu_torch.engine.renderer import cuda_voxelize as cv  # noqa: E402

DEVICE = "cuda"
REPS = 30
SLEEP_CYCLES = 200_000


def build_parent(parent):
    src = os.path.join(parent, "plasticinelab_tpu_torch", "csrc", "voxelize.cu")
    out = os.path.join(ROOT, "build", "voxelize_parent")
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, "libparent.so")
    subprocess.run([cb._nvcc(), *cb.NVCC_FLAGS, "-o", lib, src], check=True,
                   capture_output=True, text=True)
    handle = ctypes.CDLL(lib)
    handle.plb_voxelize.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [
        ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    handle.plb_voxelize.restype = ctypes.c_int
    return handle


def parent_call(lib, p, colors, r):
    """The earlier tree's K9 on p ((B, n, 3)): a fill and a launch per env."""
    table = torch.as_tensor(cv.offsets(r.bake_size, r.dist_scale), device=DEVICE)
    cells = int(np.prod(r.voxel_res))
    out = torch.empty((p.shape[0], cells), dtype=torch.int32, device=DEVICE)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        for b in range(p.shape[0]):
            vol = out[b]
            vol.fill_(-1)
            cb.check(lib.plb_voxelize(p[b].data_ptr(), colors.data_ptr(), table.data_ptr(),
                                      vol.data_ptr(), p.shape[1], table.shape[0],
                                      *r.voxel_res, 255.0 * r.dist_scale, 0, stream), "parent")
        return out

    return call


def mode_call(p, colors, r, sort):
    """This tree's K9 on p ((B, n, 3)) in one mode, whatever the launch's
    size would choose: sort (privatised, chunks of 256) or not (direct,
    chunks of 8)."""
    B, n = p.shape[:2]
    table = cv._device_offsets(r.bake_size, r.dist_scale, p.device)
    offs = cv.offsets(r.bake_size, r.dist_scale)
    _, shift, _ = cv.launch_shape(r.voxel_res, n, B, cv._sms(p.device))
    chunk = cv.SORTED_CHUNK if sort else cv.DIRECT_CHUNK
    ordered = torch.empty((B, n, 4), device=DEVICE)
    count = torch.empty((B,), dtype=torch.int32, device=DEVICE)
    out = torch.empty((B, int(np.prod(r.voxel_res))), dtype=torch.int32, device=DEVICE)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        cb.check(cb.library().plb_voxelize(
            p.data_ptr(), colors.data_ptr(), table.data_ptr(), ordered.data_ptr(),
            count.data_ptr(), out.data_ptr(), n, B, table.shape[0], *r.voxel_res,
            int(offs.min()), int(offs.max()), int(sort), shift, chunk, 255.0 * r.dist_scale, 0,
            stream), "voxelize")
        return out

    return call


def event_ms(fn):
    """Median of CUDA events around single calls, each queued behind a
    device sleep so that no launch time counts (L2-warm)."""
    fn()
    pairs = []
    for _ in range(REPS):
        torch.cuda._sleep(SLEEP_CYCLES)
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def profiler_ms(fn):
    """Device ms per call (all kernels and fills, from torch.profiler) and
    the ms per call of each kernel by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = {}
    for e in events:
        by_name[e.name[:40]] = by_name.get(e.name[:40], 0.0) + e.device_time_total / 1e3 / REPS
    return sum(e.device_time_total for e in events) / 1e3 / REPS, by_name


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, help="an earlier tree of the repository")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("voxelize_turns: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    from chip_smoke import VOX_JITTER, grids, move_textures_inputs

    path = cb.library_path()
    with open(os.path.join(os.path.dirname(path), "build.log")) as f:
        lines = f.read().splitlines()
    for i, line in enumerate(lines):
        if "voxel_" in line and "Compiling entry function" in line:
            print("ptxas:", line.strip(), "|", " ".join(l.strip() for l in lines[i + 1:i + 4]))
    tool = os.path.join(os.path.dirname(cb._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", path], capture_output=True, text=True).stdout
    for block in sass.split("Function : ")[1:]:
        name = block.split()[0]
        if "voxel_" not in name:
            continue
        ops = {}
        for line in block.splitlines():
            if re.search(r"/\*[0-9a-f]{4,}\*/\s", line):
                op = line.split("*/", 1)[1].split()
                op = (op[1] if op[0].startswith("@") else op[0]).rstrip(";")
                ops[op] = ops.get(op, 0) + 1
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:12]
        atomics = [f"{k} {v}" for k, v in ops.items() if "ATOM" in k or "RED" in k]
        print(f"sass {name[:60]}: {sum(ops.values())} instructions; "
              + ", ".join(f"{k} {v}" for k, v in top) + "; atomics " + ", ".join(atomics),
              flush=True)
    parent = build_parent(args.parent)
    te, x, colors = move_textures_inputs()
    gen = torch.Generator(device=DEVICE).manual_seed(12)
    cases = []
    for name, r in grids(te).items():
        p = ((x - r.frame_bbox(x)[0]) * r.inv_dx)[None].contiguous()
        cases.append((f"{name} B=1", r, p))
    r = grids(te)["obs"]
    for B in (2, 4, 8, 32):
        xb = x + (torch.rand((B,) + x.shape, generator=gen, device=DEVICE) * 2 - 1) * VOX_JITTER
        p = ((xb - r.frame_bbox(xb, host_bbox=False)[:, 0, None]) * r.inv_dx).contiguous()
        cases.append((f"obs B={B}", r, p))
    for label, r, p in cases:
        want = cv.voxelize_plain(p, colors, r.voxel_res, r.bake_size, r.dist_scale)
        args = (p, colors, r.voxel_res, r.bake_size, r.dist_scale)
        sort = cv.launch_shape(r.voxel_res, p.shape[1], p.shape[0], cv._sms(p.device))[0]
        calls = {"parent": parent_call(parent, p, colors, r),
                 "tree": lambda a=args: cv.voxelize(*a),
                 "tree, the other mode": mode_call(p, colors, r, not sort)}
        for key, fn in calls.items():
            differ = int((fn() != want).sum())
            if differ:
                print(f"  {key}: {differ} cells differ from the plain version", flush=True)
                if key != "parent":
                    raise AssertionError(f"{label} {key}: differs from the plain version")
        print(f"{label}: {tuple(p.shape)} on {r.voxel_res}; the tree's outputs equal the plain "
              f"version; its mode {'privatised' if sort else 'direct'}", flush=True)
        order = [k for k in calls if k != "parent"]
        times = {k: [] for k in calls}
        for turn in (["parent"] + order, order[::-1] + ["parent"]):
            for key in turn:
                dev, parts = profiler_ms(calls[key])
                times[key].append((dev, event_ms(calls[key]), parts))
        for key, runs in times.items():
            dev = "; ".join(f"{d:.4f}" for d, _, _ in runs)
            ev = "; ".join(f"{e:.4f}" for _, e, _ in runs)
            parts = ", ".join(f"{n} {t:.4f}" for n, t in runs[-1][2].items())
            print(f"  {key:28s} profiler ms {dev}  events ms {ev}  ({parts})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
