"""Batched 3x3 SVD by cyclic Jacobi, with the damped-eigengap backward.

Counterpart of the forward of `plasticinelab_tpu/engine/svd3.py`
(`_svd3_fwd_impl`): eigendecomposition of F^T F by 6 cyclic Jacobi sweeps
(the reference's angles, computed as the CUDA kernels compute them), a
3-element sort network (descending), det(V) = +1 by flipping V's last column, U by a
Gram-Schmidt with fallbacks, and signed singular values (McAdams
convention: det(U) = det(V) = +1, the sign lands on the smallest value, so
R = U V^T is a proper rotation). `torch.linalg.svd` follows other sort and
sign conventions, and its backward is undamped, so it is not used. The CUDA
stress kernels (`csrc/stress.cu`) run the same steps per particle.

`Svd3` is the differentiable form: its backward is the eigengap formula of
`plasticinelab_tpu/engine/svd3.py:_svd3_vjp_bwd` (:205-235), the
reference's backward_svd (plb/engine/mpm_simulator.py:97-115) with the
inverse eigengap damped to gap / (gap^2 + eps^2) (`set_vjp_gap_mode`).

Matrices are handled as nested lists of (n,) component tensors, so every
operation is elementwise over the particle batch.
"""
from __future__ import annotations

import torch

__all__ = ["svd3", "Svd3", "set_vjp_gap_mode", "gap_mode"]

_N_SWEEPS = 6  # cyclic Jacobi sweeps; 3x3 converges quadratically


def _jacobi_rotation(a, v, p, q):
    """One Jacobi rotation zeroing a[(p,q)]. `a`: the 6 unique components of
    the symmetric matrix keyed (i<=j); `v`: the 9 eigenvector components.

    The angle is the reference's, t = atan2(2 apq, aqq - app) / 2, through
    the half-angle identities in the form the CUDA kernels take: one
    reciprocal and two rsqrt. (y, z) are scaled by the reciprocal of the
    larger magnitude, so y^2 + z^2 never underflows; u = (1 + |cos 2t|) / 2
    in [0.5, 1] is cos^2 t or sin^2 t, whichever is larger; that one of
    (c, s) is sqrt(u) = u rsqrt(u), the other |sin 2t| / (2 sqrt(u)), stable
    where |cos 2t| ~ 1. Signs follow atan2's. Then (c, s) times
    (3 - c^2 - s^2) / 2, one Newton step of rsqrt(c^2 + s^2) from 1: with
    the kernels' approximate rsqrt, c^2 + s^2 lies ~5e-7 off 1 before it and
    within float32 rounding after it."""
    r = 3 - p - q
    app, aqq, apq = a[(p, p)], a[(q, q)], a[(p, q)]
    y = 2.0 * apq
    z = aqq - app
    m = torch.maximum(torch.abs(y), torch.abs(z))
    ok = torch.abs(y) > 0  # apq == 0 -> identity rotation
    # at least the smallest normal number: below it the reciprocal would
    # overflow, and the exact 1/tiny scaling still keeps y^2 + z^2 normal
    inv_m = torch.reciprocal(torch.clamp(m, min=torch.finfo(m.dtype).tiny, max=2.0 ** 126))
    ym = y * inv_m
    zm = z * inv_m
    rinv = torch.rsqrt(torch.clamp(ym * ym + zm * zm, min=1e-30))
    cos2t = zm * rinv
    sin2t = ym * rinv
    u = (1.0 + torch.abs(cos2t)) * 0.5
    h = torch.rsqrt(u)
    big = u * h
    hs = sin2t * 0.5 * h  # sign(sin 2t) |sin 2t| / (2 sqrt(u))
    pos = cos2t >= 0
    c = torch.where(ok, torch.where(pos, big, torch.abs(hs)), torch.ones_like(big))
    s = torch.where(ok, torch.where(pos, hs, torch.copysign(big, sin2t)), torch.zeros_like(big))
    k = 1.5 - 0.5 * (c * c + s * s)
    c, s = c * k, s * k
    cc, ss, cs = c * c, s * s, c * s

    kpr = (min(p, r), max(p, r))
    kqr = (min(q, r), max(q, r))
    apr, aqr = a[kpr], a[kqr]
    a = dict(a)
    a[(p, p)] = cc * app - 2.0 * cs * apq + ss * aqq
    a[(q, q)] = ss * app + 2.0 * cs * apq + cc * aqq
    a[(p, q)] = cs * (app - aqq) + (cc - ss) * apq
    a[kpr] = c * apr - s * aqr
    a[kqr] = s * apr + c * aqr

    v = dict(v)
    for i in range(3):
        vip, viq = v[(i, p)], v[(i, q)]
        v[(i, p)] = c * vip - s * viq
        v[(i, q)] = s * vip + c * viq
    return a, v


def _dot3(x, y):
    return x[0] * y[0] + x[1] * y[1] + x[2] * y[2]


def _cross(x, y):
    return [x[1] * y[2] - x[2] * y[1],
            x[2] * y[0] - x[0] * y[2],
            x[0] * y[1] - x[1] * y[0]]


def _safe_normalize(x, fallback):
    n2 = _dot3(x, x)
    ok = n2 > 1e-16
    inv = torch.rsqrt(torch.where(ok, n2, torch.ones_like(n2)))
    return [torch.where(ok, x[i] * inv, fallback[i]) for i in range(3)]


def svd3(F: torch.Tensor):
    """Batched SVD of (n, 3, 3): returns (U (n,3,3), sigma (n,3), V (n,3,3))
    with F = U diag(sigma) V^T."""
    Fc = [[F[:, i, j] for j in range(3)] for i in range(3)]
    one = torch.ones_like(Fc[0][0])
    zero = torch.zeros_like(one)

    # A = F^T F
    a = {(i, j): sum(Fc[k][i] * Fc[k][j] for k in range(3))
         for i in range(3) for j in range(3) if i <= j}
    v = {(i, j): (one if i == j else zero) for i in range(3) for j in range(3)}
    for _ in range(_N_SWEEPS):
        for (p, q) in ((0, 1), (0, 2), (1, 2)):
            a, v = _jacobi_rotation(a, v, p, q)
    w = [a[(0, 0)], a[(1, 1)], a[(2, 2)]]
    V = [[v[(i, j)] for j in range(3)] for i in range(3)]

    def cswap(i, j):
        swap = w[i] < w[j]
        w[i], w[j] = torch.where(swap, w[j], w[i]), torch.where(swap, w[i], w[j])
        for rr in range(3):
            V[rr][i], V[rr][j] = (torch.where(swap, V[rr][j], V[rr][i]),
                                  torch.where(swap, V[rr][i], V[rr][j]))

    cswap(0, 1)
    cswap(0, 2)
    cswap(1, 2)

    col = lambda M, j: [M[0][j], M[1][j], M[2][j]]  # noqa: E731
    detV = _dot3(_cross(col(V, 0), col(V, 1)), col(V, 2))
    flip = torch.where(detV < 0, -one, one)
    for rr in range(3):
        V[rr][2] = V[rr][2] * flip

    FV = [[sum(Fc[i][k] * V[k][j] for k in range(3)) for j in range(3)]
          for i in range(3)]
    e0, e1, e2 = [one, zero, zero], [zero, one, zero], [zero, zero, one]
    u0 = _safe_normalize(col(FV, 0), e0)
    # u1: Gram-Schmidt against u0, with an orthogonal fallback for rank<2 F
    raw1 = col(FV, 1)
    d01 = _dot3(raw1, u0)
    raw1 = [raw1[i] - d01 * u0[i] for i in range(3)]
    near_y = torch.abs(u0[1]) < 0.9
    alt = [torch.where(near_y, e1[i], e2[i]) for i in range(3)]
    dalt = _dot3(alt, u0)
    alt = _safe_normalize([alt[i] - dalt * u0[i] for i in range(3)], e1)
    u1 = _safe_normalize(raw1, alt)
    u2 = _cross(u0, u1)  # det(U) = +1 by construction
    U = [[u0[i], u1[i], u2[i]] for i in range(3)]
    sig = [_dot3(col(FV, j), col(U, j)) for j in range(3)]

    stack33 = lambda M: torch.stack([torch.stack(r, dim=-1) for r in M], dim=-2)  # noqa: E731
    return stack33(U), torch.stack(sig, dim=-1), stack33(V)


# Backward eigengap handling. The reference hard-clamps the inverse gap at
# 1e-6 ("reference"), adequate in its float64 simulation; in float32 the
# ~1e6 amplification of rounding noise at (near-)repeated singular values
# compounds through long rollouts. "damped" replaces 1/clamp(gap) by the
# Lorentzian gap/(gap^2 + eps^2): the same for well-separated singular
# values, bounded by 1/(2 eps) at degeneracy. "zero" drops the U/V rotation
# terms (an ablation).
_GAP_MODES = ("reference", "damped", "zero")
_gap = {"mode": "damped", "eps": 1e-3}  # eps: the float32 damping
_GAP_EPS_F64 = 1e-6                      # float64: the reference clamp scale


def set_vjp_gap_mode(mode: str, eps: float = 1e-2) -> None:
    """Set the SVD backward's eigengap regularization for every later
    backward (float32 damping `eps`; float64 keeps 1e-6)."""
    if mode not in _GAP_MODES:
        raise ValueError(f"gap mode must be one of {_GAP_MODES}, got {mode!r}")
    _gap["mode"] = mode
    _gap["eps"] = eps


def gap_mode(dtype: torch.dtype):
    """(mode id, eps) of the backward for a dtype; the mode id indexes
    ("reference", "damped", "zero"), as the CUDA stress backward takes it."""
    eps = _gap["eps"] if dtype == torch.float32 else _GAP_EPS_F64
    return _GAP_MODES.index(_gap["mode"]), eps


def _inv_gap(gap, dtype):
    mode, eps = gap_mode(dtype)
    if mode == 0:  # reference clamp |gap| >= 1e-6
        return 1.0 / torch.where(gap >= 0, torch.clamp(gap, min=1e-6),
                                 torch.clamp(gap, max=-1e-6))
    if mode == 1:
        return gap / (gap * gap + eps * eps)
    return torch.zeros_like(gap)


class Svd3(torch.autograd.Function):
    """svd3 with the damped-eigengap backward: F (n,3,3) -> (U, sigma, V)."""

    @staticmethod
    def forward(ctx, F):
        U, sig, V = svd3(F)
        ctx.save_for_backward(U, sig, V)
        return U, sig, V

    @staticmethod
    def backward(ctx, gU, gsig, gV):
        U, sig, V = ctx.saved_tensors
        s = sig * sig
        gap = s[..., None, :] - s[..., :, None]  # gap[i, j] = s_j - s_i
        Fm = _inv_gap(gap, U.dtype) * (1.0 - torch.eye(3, dtype=U.dtype, device=U.device))
        Ut, Vt = U.transpose(-1, -2), V.transpose(-1, -2)
        UtgU = Ut @ gU
        inner_u = Fm * (UtgU - UtgU.transpose(-1, -2))
        VtgV = Vt @ gV
        inner_v = Fm * (VtgV - VtgV.transpose(-1, -2))
        mid = inner_u * sig[..., None, :] + sig[..., :, None] * inner_v \
            + torch.diag_embed(gsig)
        return U @ mid @ Vt
