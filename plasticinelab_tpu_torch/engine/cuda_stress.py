"""Particle stress: F-update + SVD + von Mises + stress + APIC affine.

Plain PyTorch version and the CUDA kernels replacing the TPU kernels K1,
`plasticinelab_tpu/engine/pallas_stress.py:_fwd_kernel` (:201, core
`_forward_core` :70-194), and K2, its hand-derived adjoint `_bwd_kernel`
(:222-330). The plain version follows
`plasticinelab_tpu/engine/mpm.py:stress_affine_jnp` (:112-130) and is
differentiable through `svd3.Svd3`, whose damped-eigengap backward K2
applies per particle too.

The work is ~2k float operations per particle with no data shared between
particles (72 B in, 72 B out). `csrc/stress.cu` runs one thread per
particle with the whole chain in registers, in the same order as
`_forward_core`: the Jacobi rotation (the reference's angle from one
reciprocal and two rsqrt, as `svd3._jacobi_rotation` computes it), the
`cswap` sort, the det(V) sign flip, the `safe_normalize` Gram-Schmidt U,
then von Mises and the stress. On the H100 one thread's chain sets the
time of a 10,000-particle launch; at the batched path's 320,000 the bytes
weigh too, so the outputs leave through shared memory as whole slabs.

The backward (K2, `StressAffine`) saves only C and F and recomputes the
forward chain from them in registers (the forward device code is shared
with K1), then applies the adjoint term by term: ~3k float operations per
particle against 144 B of input.

The wrapper takes the plain version only for a CPU tensor; for a CUDA
tensor it launches the kernel (float32, contiguous) or raises, and so does
the backward. `launches` (the counter group `cuda_stress`) counts kernel
launches; each launch runs in a `plb.kernel.<name>` span.
"""
from __future__ import annotations

import torch

from ..config.spec import SceneSpec
from ..utils.profiling import counter_group, span
from . import cuda_build as cb
from .state import Materials
from .svd3 import Svd3, gap_mode

launches = counter_group("cuda_stress", ("stress_affine", "stress_affine_bwd"))


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


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
    U, sig, V = Svd3.apply(F_tmp)
    mu, lam, ys = float(mats.mu), float(mats.lam), float(mats.yield_stress)
    new_F = von_mises_project(F_tmp, U, sig, V, ys, mu)
    J = _det3(new_F)
    r = torch.matmul(U, V.transpose(-1, -2))
    stress = 2.0 * mu * torch.matmul(new_F - r, new_F.transpose(-1, -2)) \
        + eye * (lam * (J * (J - 1.0)))[..., None, None]
    affine = _coeff(scene) * stress + sim.p_mass * C
    return new_F, affine


def _check(C, F):
    n = C.shape[0]
    cb.require(C, "C", (n, 3, 3), C.device)
    cb.require(F, "F", (n, 3, 3), C.device)


def _consts(scene: SceneSpec, mats: Materials):
    sim = scene.simulator
    return (sim.dt, float(mats.mu), float(mats.lam), float(mats.yield_stress),
            _coeff(scene), sim.p_mass)


def _launch_fwd(scene: SceneSpec, mats: Materials, C, F):
    with span("plb.kernel.stress_affine"):
        cb.require_kernel_input(C, "C")
        cb.require_kernel_input(F, "F")
        new_F = torch.empty_like(F)
        affine = torch.empty_like(C)
        err = cb.library().plb_stress_affine(
            C.data_ptr(), F.data_ptr(), new_F.data_ptr(), affine.data_ptr(), C.shape[0],
            *_consts(scene, mats), C.device.index, cb.stream_of(C))
        cb.check(err, "stress_affine")
        launches["stress_affine"] += 1
        return new_F, affine


def stress_affine_bwd(scene: SceneSpec, mats: Materials, C, F, g_new_F, g_affine):
    """The K2 kernel: cotangents of (new_F, affine) -> (gC, gF), the
    VJP of `stress_affine_plain` at (C, F). CUDA tensors only."""
    with span("plb.kernel.stress_affine_bwd"):
        _check(C, F)
        n = C.shape[0]
        cb.require(g_new_F, "g_new_F", (n, 3, 3), C.device)
        cb.require(g_affine, "g_affine", (n, 3, 3), C.device)
        for t, name in ((C, "C"), (F, "F"), (g_new_F, "g_new_F"), (g_affine, "g_affine")):
            cb.require_kernel_input(t, name)
        gC = torch.empty_like(C)
        gF = torch.empty_like(F)
        mode, eps = gap_mode(C.dtype)
        err = cb.library().plb_stress_affine_bwd(
            C.data_ptr(), F.data_ptr(), g_new_F.data_ptr(), g_affine.data_ptr(),
            gC.data_ptr(), gF.data_ptr(), n, *_consts(scene, mats), mode, eps,
            C.device.index, cb.stream_of(C))
        cb.check(err, "stress_affine_bwd")
        launches["stress_affine_bwd"] += 1
        return gC, gF


class StressAffine(torch.autograd.Function):
    """(C, F) -> (new_F, affine): forward K1, backward K2 (saves C, F)."""

    @staticmethod
    def forward(ctx, C, F, scene, mats):
        ctx.scene, ctx.mats = scene, mats
        ctx.save_for_backward(C, F)
        return _launch_fwd(scene, mats, C, F)

    @staticmethod
    def backward(ctx, g_new_F, g_affine):
        C, F = ctx.saved_tensors
        gC, gF = stress_affine_bwd(ctx.scene, ctx.mats, C, F, g_new_F.contiguous(),
                                   g_affine.contiguous())
        return gC, gF, None, None


def stress_affine(scene: SceneSpec, mats: Materials, C, F):
    """-> (new_F, affine); the K1 kernel (backward K2) on CUDA, the plain
    version on the CPU."""
    _check(C, F)
    if C.device.type == "cpu":
        return stress_affine_plain(scene, mats, C, F)
    return StressAffine.apply(C, F, scene, mats)
