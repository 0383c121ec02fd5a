"""Build and bind the hand-written CUDA kernels (`csrc/*.cu`).

The sources are compiled with nvcc for Hopper (`sm_90a`), one nvcc process
per source running at once, and linked into one shared library with a plain
C interface, loaded with ctypes. The build happens at
first use, into `build/plasticinelab_tpu_torch/<hash>/` beside the package,
keyed by a hash of the sources and flags, so a fresh checkout builds once
and an edited source builds anew. No `--use_fast_math`: it would change
`log`, `exp`, `sqrt` and division, which the von Mises map and the SVD
depend on.

Every C entry point launches on the stream it is given, allocates nothing,
and returns `cudaGetLastError()` after its launch; `check` raises on a
non-zero code.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "plasticinelab_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
MAX_PRIMS = 8  # csrc/gridop.cu PLB_MAX_PRIMS
THREADS = 256  # csrc/common.cuh kThreads: threads per block of the flat kernels


class PrimTable(ctypes.Structure):
    """Static per-primitive parameters, passed by value (csrc/gridop.cu)."""

    _fields_ = [
        ("k", ctypes.c_int),
        ("shape", ctypes.c_int * MAX_PRIMS),
        # friction, radius, h, r, tx, ty, size x/y/z, minimal_gap
        ("param", (ctypes.c_float * 10) * MAX_PRIMS),
    ]


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# name -> argtypes; every function returns int (a cudaError_t)
_SIGNATURES = {
    # C, F, newF, affine, n, dt, mu, lam, yield_stress, coeff, p_mass, device, stream
    "plb_stress_affine": [_P, _P, _P, _P, _L, _F, _F, _F, _F, _F, _F, _I, _P],
    # the transfers and the grid update, forward and backward, take B envs
    # (n particles each); one env is B = 1
    # (order: (B, n) int32 or null, the walk of the scatter kernels)
    # x, v, affine, order, grid4, n, B, G, inv_dx, dx, p_mass, device, stream
    "plb_p2g": [_P, _P, _P, _P, _P, _L, _I, _I, _F, _F, _F, _I, _P],
    # x, order, grid_m, n, B, G, inv_dx, p_mass, device, stream
    "plb_grid_mass": [_P, _P, _P, _L, _I, _I, _F, _F, _I, _P],
    # x, grid_v, new_v, new_C, new_x, n, B, G, inv_dx, dt, x_hi, device, stream
    "plb_g2p": [_P, _P, _P, _P, _P, _L, _I, _I, _F, _F, _F, _I, _P],
    # grid4, poses, softness (B,), grid_v, table, B, G, dx, dt, gravity xyz,
    # ground_friction, vmax, device, stream
    "plb_grid_op": [_P, _P, _P, _P, PrimTable, _I, _I, _F, _F, _F, _F, _F, _F, _F,
                    _I, _P],
    # C, F, gNewF, gAffine, gC, gF, n, dt, mu, lam, yield_stress, coeff,
    # p_mass, gap_mode, gap_eps, device, stream
    "plb_stress_affine_bwd": [_P, _P, _P, _P, _P, _P, _L, _F, _F, _F, _F, _F, _F,
                              _I, _F, _I, _P],
    # x, v, affine, ct, gx, gv, gaffine, n, B, G, inv_dx, dx, p_mass, device,
    # stream
    "plb_p2g_bwd": [_P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _F, _F, _F, _I, _P],
    # x, ct, gx, n, B, G, inv_dx, p_mass, device, stream
    "plb_grid_mass_bwd": [_P, _P, _P, _L, _I, _I, _F, _F, _I, _P],
    # x, grid_v, ct_v, ct_C, ct_x, order, gx, g_grid, n, B, G, inv_dx, dt,
    # x_hi, device, stream
    "plb_g2p_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _F, _F, _F, _I, _P],
    # grid4, poses, softness (B,), ct, dgrid4, dposes, partials, done, table,
    # B, G, dx, dt, gravity xyz, ground_friction, vmax, device, stream
    "plb_grid_op_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, PrimTable, _I, _I, _F, _F, _F, _F,
                        _F, _F, _F, _I, _P],
    # p, color, offs, sorted, count, vol, n, B, m, rx, ry, rz, lo, hi, sort,
    # shift, chunk, scale, device, stream
    "plb_voxelize": [_P] * 6 + [_I] * 11 + [_F, _I, _P],
}


def _sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        from torch.utils.cpp_extension import CUDA_HOME

        if CUDA_HOME is None:
            raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
        nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    return nvcc


def library_path() -> str:
    """Path of the built library for the current sources, building it first
    if it is missing: one nvcc per source, all started together, then one
    link."""
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + f.read())
    out_dir = os.path.join(BUILD_ROOT, h.hexdigest()[:16])
    lib = os.path.join(out_dir, "libplb_kernels.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs, procs = [], []
    for src in (s for s in srcs if s.endswith(".cu")):
        fd, obj = tempfile.mkstemp(suffix=".o", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, *compile_flags, "-c", "-o", obj, src]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True)))
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", tmp, *objs]
    log, failed = [], None
    try:
        for cmd, proc in procs:
            out, err = proc.communicate()
            log.append(" ".join(cmd) + "\n" + out + err)
            if proc.returncode != 0 and failed is None:
                failed = (proc.returncode, err)
        if failed is None:
            proc = subprocess.run(link, capture_output=True, text=True)
            log.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed = (proc.returncode, proc.stderr)
    finally:
        with open(os.path.join(out_dir, "build.log"), "w") as f:
            f.write("\n".join(log))
        for obj in objs:
            os.unlink(obj)
    if failed is not None:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({failed[0]}):\n{failed[1][-8000:]}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once per process."""
    lib = ctypes.CDLL(library_path())
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, shape, device: torch.device) -> None:
    """Shape and device check for every wrapper input."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")


def launch_key(name: str, t: torch.Tensor) -> str:
    """The key under which a wrapper counts a launch of kernel `name` on
    particles (n, 3) or a grid (G^3, C) `t`: with a leading B (any B) it
    counts under `<name>_batched`, apart from the single env's."""
    return name + "_batched" if t.dim() == 3 else name


def require_kernel_input(t: torch.Tensor, name: str) -> None:
    """What a kernel takes: float32, contiguous, on a CUDA device."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the kernel takes float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the kernel takes contiguous tensors")
