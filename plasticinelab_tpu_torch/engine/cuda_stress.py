"""Particle stress: F-update + SVD + von Mises + stress + APIC affine.

Plain PyTorch version and the CUDA kernel replacing the TPU kernel K1,
`plasticinelab_tpu/engine/pallas_stress.py:_fwd_kernel` (:201, core
`_forward_core` :70-194). The plain version follows
`plasticinelab_tpu/engine/mpm.py:stress_affine_jnp` (:112-130).

The work is ~2k float operations per particle with no data shared between
particles, so on the H100 it is bound by arithmetic and register pressure,
not bytes (72 B in, 72 B out per particle). `csrc/stress.cu` runs one thread
per particle with the whole chain in registers, in the same order as
`_forward_core`: the Jacobi rotation's scale-invariant hypot and stable
half-angles, the `cswap` sort, the det(V) sign flip, the `safe_normalize`
Gram-Schmidt U, then von Mises and the stress.

The wrapper takes the plain version only for a CPU tensor; for a CUDA
tensor it launches the kernel (float32, contiguous) or raises. `launches`
counts kernel launches.
"""
from __future__ import annotations

import torch

from ..config.spec import SceneSpec
from . import cuda_build as cb
from .state import Materials
from .svd3 import svd3

launches = {"stress_affine": 0}


def reset_launches() -> None:
    launches["stress_affine"] = 0


def _det3(m):
    return torch.sum(torch.linalg.cross(m[..., 0, :], m[..., 1, :], dim=-1) * m[..., 2, :], dim=-1)


def von_mises_project(F_tmp, U, sig, V, yield_stress, mu):
    """von Mises return mapping (reference compute_von_mises :124-141)."""
    sig_c = torch.clamp(sig, min=0.05)  # NaN guard (reference :128)
    eps = torch.log(sig_c)
    eps_hat = eps - torch.mean(eps, dim=-1, keepdim=True)
    eps_hat_norm = torch.sqrt(torch.sum(eps_hat * eps_hat, dim=-1) + 1e-8)
    delta_gamma = eps_hat_norm - yield_stress / (2.0 * mu)
    yields = delta_gamma > 0
    eps_proj = eps - (delta_gamma / eps_hat_norm)[..., None] * eps_hat
    F_proj = torch.einsum("nij,nj,nkj->nik", U, torch.exp(eps_proj), V)
    return torch.where(yields[..., None, None], F_proj, F_tmp)


def _coeff(scene: SceneSpec) -> float:
    sim = scene.simulator
    return -sim.dt * sim.p_vol * 4 * sim.inv_dx * sim.inv_dx


def stress_affine_plain(scene: SceneSpec, mats: Materials, C, F):
    """-> (new_F, affine), each (n, 3, 3) (reference p2g :158-174)."""
    sim = scene.simulator
    eye = torch.eye(3, dtype=F.dtype, device=F.device)
    F_tmp = torch.matmul(eye + sim.dt * C, F)
    U, sig, V = svd3(F_tmp)
    mu, lam, ys = float(mats.mu), float(mats.lam), float(mats.yield_stress)
    new_F = von_mises_project(F_tmp, U, sig, V, ys, mu)
    J = _det3(new_F)
    r = torch.matmul(U, V.transpose(-1, -2))
    stress = 2.0 * mu * torch.matmul(new_F - r, new_F.transpose(-1, -2)) \
        + eye * (lam * (J * (J - 1.0)))[..., None, None]
    affine = _coeff(scene) * stress + sim.p_mass * C
    return new_F, affine


def stress_affine(scene: SceneSpec, mats: Materials, C, F):
    """-> (new_F, affine); the K1 kernel on CUDA, the plain version on the
    CPU."""
    n = C.shape[0]
    cb.require(C, "C", (n, 3, 3), C.device)
    cb.require(F, "F", (n, 3, 3), C.device)
    if C.device.type == "cpu":
        return stress_affine_plain(scene, mats, C, F)
    cb.require_kernel_input(C, "C")
    cb.require_kernel_input(F, "F")
    sim = scene.simulator
    new_F = torch.empty_like(F)
    affine = torch.empty_like(C)
    err = cb.library().plb_stress_affine(
        C.data_ptr(), F.data_ptr(), new_F.data_ptr(), affine.data_ptr(), n,
        sim.dt, float(mats.mu), float(mats.lam), float(mats.yield_stress),
        _coeff(scene), sim.p_mass, C.device.index, cb.stream_of(C))
    cb.check(err, "stress_affine")
    launches["stress_affine"] += 1
    return new_F, affine
