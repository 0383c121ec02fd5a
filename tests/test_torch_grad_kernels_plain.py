"""The backward of each kernel's plain version, held against the TPU package
on the CPU. The plain versions' VJPs (torch.autograd, through `Svd3` for the
stress) are what the CUDA backward kernels (K2, K4, K6, K7 backward, K8
backward) are held against on the card.

(a) float64, against jax.vjp of the jnp functions (`mpm.stress_affine_jnp`,
    `transfer.p2g_dense` / `g2p_dense` / `grid_m_dense` on a full-grid crop,
    `mpm.grid_op_cm` per shape and per ground regime), with seeded
    cotangents. Tolerance 1e-8 relative to the largest value: the same
    float64 math in another summation order.
(b) float32, against the Pallas backward kernels in interpret mode, as
    test_pallas_local.py and test_pallas_gridop.py run them. Tolerances
    relative to the largest value, measured: 1e-4 for the stress (float32
    through the SVD adjoint, whose eigengap factors reach 1/gap), 1e-3 for
    the transfers (the Pallas kernels contract with a 3-pass bf16 split,
    ~16 mantissa bits, amplified by inv_dx in d/dx) and for the grid update
    (float32 collider velocities divided by dt; the box normal is a finite
    difference with d = 1e-4).
(c) `Svd3`'s VJP against finite differences, finite at repeated singular
    values, and in each eigengap mode equal to the reference formula.

The rotation at pose f enters the port through the renormalised conjugate
(`quat.quat_conj`, as `primitives.inv_trans` and the reference), the
channel-major jnp code through the plain conjugate: for a unit quaternion the
two gradients differ only along the quaternion itself, a direction the
forward kinematics' renormalisation (`quat.qmul`) removes. Those cotangents
are compared after projecting that direction out.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plasticinelab_tpu.engine import mpm as jmpm
from plasticinelab_tpu.engine import pallas_gridop as pgo
from plasticinelab_tpu.engine import pallas_local as pal
from plasticinelab_tpu.engine import svd3 as jsvd
from plasticinelab_tpu.engine import transfer as jtr
from plasticinelab_tpu.engine.pallas_stress import stress_affine_rows
from plasticinelab_tpu_torch.engine import cuda_gridop, cuda_stress, cuda_transfer
from plasticinelab_tpu_torch.engine import svd3 as tsvd
from plasticinelab_tpu_torch.engine.state import default_materials
from test_torch_kernels_plain import (G, IDS, SHAPE_KW, _grid4, _jmats, _particles,
                                      _poses, _scenes, _sorted_windows)

F64_TOL = 1e-8
STRESS_F32_TOL = 1e-4
TRANSFER_F32_TOL = 1e-3
GRID_OP_F32_TOL = 1e-3


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def _vjp(fn, inputs, cts):
    """torch.autograd VJP of fn at inputs (tensors) for cotangents cts."""
    ins = [t.clone().requires_grad_(True) for t in inputs]
    out = fn(*ins)
    out = out if isinstance(out, tuple) else (out,)
    grads = torch.autograd.grad(out, ins, cts, allow_unused=True)
    return [torch.zeros_like(i) if g is None else g for g, i in zip(grads, ins)]


def _project(rot, g):
    """Cotangent of a unit quaternion without its component along it."""
    rot, g = np.asarray(rot, np.float64), np.asarray(g, np.float64)
    return g - rot * np.sum(rot * g, axis=-1, keepdims=True)


def _rng_like(seed, *shapes, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(dtype) for s in shapes]


# ---------------------------------------------------------------------------
# (a) float64, against jax.vjp of the jnp functions
# ---------------------------------------------------------------------------

def test_stress_vjp_matches_jax_f64():
    ts, js = _scenes("float64")
    n = 512
    _, _, C, F, _ = _particles(10, n, np.float64)
    gnf, gaff = _rng_like(11, (n, 3, 3), (n, 3, 3))
    mats = default_materials(ts)
    gC, gF = _vjp(lambda c, f: cuda_stress.stress_affine_plain(ts, mats, c, f),
                  [torch.tensor(C), torch.tensor(F)], [torch.tensor(gnf), torch.tensor(gaff)])
    _, vjp = jax.vjp(lambda c, f: jmpm.stress_affine_jnp(js, _jmats(js, jnp.float64), c, f),
                     jnp.asarray(C), jnp.asarray(F))
    rC, rF = vjp((jnp.asarray(gnf), jnp.asarray(gaff)))
    _close(gC, rC, F64_TOL)
    _close(gF, rF, F64_TOL)


def test_transfer_vjps_match_jax_f64():
    ts, js = _scenes("float64")
    n = 300
    x, v, _, _, aff = _particles(12, n, np.float64)
    sim = js.simulator
    ct4, ctm, grid_v, ct_v, ct_C, ct_x = _rng_like(
        13, (G ** 3, 4), (G ** 3,), (G ** 3, 3), (n, 3), (n, 3, 3), (n, 3))
    tx, tv, taff = map(torch.tensor, (x, v, aff))

    def j_p2g(xx, vv, aa):
        gv, gm = jtr.p2g_dense(js, jtr.axis_weights(js, xx, G), vv, aa, G)
        return jnp.concatenate([gv, gm[:, None]], axis=1)

    got = _vjp(lambda a, b, c: cuda_transfer.p2g_plain(ts, a, b, c), [tx, tv, taff],
               [torch.tensor(ct4)])
    want = jax.vjp(j_p2g, jnp.asarray(x), jnp.asarray(v), jnp.asarray(aff))[1](jnp.asarray(ct4))
    for g, w in zip(got, want):
        _close(g, w, F64_TOL)

    (got,) = _vjp(lambda a: cuda_transfer.grid_mass_plain(ts, a), [tx], [torch.tensor(ctm)])
    (want,) = jax.vjp(lambda xx: jtr.grid_m_dense(js, xx, G), jnp.asarray(x))[1](jnp.asarray(ctm))
    _close(got, want, F64_TOL)

    def j_g2p(xx, gg):
        nv, nC = jtr.g2p_dense(js, jtr.axis_weights(js, xx, G), gg, G)
        return nv, nC, jnp.maximum(jnp.minimum(xx + sim.dt * nv, 1.0 - 3 * sim.dx), 0.0)

    got = _vjp(lambda a, g: cuda_transfer.g2p_plain(ts, a, g), [tx, torch.tensor(grid_v)],
               [torch.tensor(ct_v), torch.tensor(ct_C), torch.tensor(ct_x)])
    want = jax.vjp(j_g2p, jnp.asarray(x), jnp.asarray(grid_v))[1](
        (jnp.asarray(ct_v), jnp.asarray(ct_C), jnp.asarray(ct_x)))
    for g, w in zip(got, want):
        _close(g, w, F64_TOL)


def _grid_op_vjps(ts, js, g4, pose_f, pose_f1, ct):
    """(port VJP, reference VJP) of the grid update: d grid4 (M, 4), then
    pos_f, rot_f (projected), gap_f, pos_f1, rot_f1, gap_f1."""
    poses = [*pose_f, *pose_f1]
    got = _vjp(lambda g, *p: cuda_gridop.grid_op_plain(ts, g, tuple(p[:3]), tuple(p[3:]), 666.0),
               [torch.tensor(g4)] + [torch.tensor(p) for p in poses], [torch.tensor(ct)])

    def ref(g, *p):
        return jmpm.grid_op_cm(js, g, tuple(p[:3]), tuple(p[3:]), 666.0, G,
                               jnp.zeros(3, jnp.int32))

    want = jax.vjp(ref, jnp.asarray(g4.T), *map(jnp.asarray, poses))[1](jnp.asarray(ct.T))
    got = [g.numpy() for g in got]
    want = [np.asarray(w) for w in want]
    want[0] = want[0].T
    got[2], want[2] = _project(pose_f[1], got[2]), _project(pose_f[1], want[2])
    return got, want


@pytest.mark.parametrize("kw", SHAPE_KW, ids=IDS)
def test_grid_op_vjp_matches_jax_f64(kw):
    ts, js = _scenes("float64", prims=[kw])
    g4 = _grid4(14, np.float64)
    pose_f, pose_f1 = _poses(15, 1, np.float64)
    (ct,) = _rng_like(16, (G ** 3, 3))
    got, want = _grid_op_vjps(ts, js, g4, pose_f, pose_f1, ct)
    for name, g, w in zip(("grid4", "pos_f", "rot_f", "gap_f", "pos_f1", "rot_f1", "gap_f1"),
                          got, want):
        if np.abs(w).max() > 0:
            _close(g, w, F64_TOL)
        else:
            assert np.abs(g).max() == 0, name
    assert np.abs(got[1]).max() > 0  # the contact response carried a pose gradient


@pytest.mark.parametrize("gf", [0.0, 1.5, 100.0], ids=["walls", "ground-friction", "ground-stick"])
def test_grid_op_vjp_walls_and_ground_match_jax_f64(gf):
    ts, js = _scenes("float64", prims=SHAPE_KW[:1])
    ts = ts.replace(simulator=dataclasses.replace(ts.simulator, ground_friction=gf))
    js = js.replace(simulator=dataclasses.replace(js.simulator, ground_friction=gf))
    rng = np.random.default_rng(17)
    # every cell massive or empty at random, velocities O(1), so the walls
    # and the ground see both signs
    m = rng.uniform(1e-6, 1e-4, G ** 3) * (rng.random(G ** 3) > 0.25)
    g4 = np.concatenate([rng.standard_normal((G ** 3, 3)) * m[:, None], m[:, None]], axis=1)
    pose_f, pose_f1 = _poses(18, 1, np.float64)
    (ct,) = _rng_like(19, (G ** 3, 3))
    got, want = _grid_op_vjps(ts, js, g4, pose_f, pose_f1, ct)
    for g, w in zip(got, want):
        _close(g, w, F64_TOL)


# ---------------------------------------------------------------------------
# (b) float32, against the Pallas backward kernels in interpret mode
# ---------------------------------------------------------------------------

def test_stress_vjp_matches_pallas_interpret():
    ts, js = _scenes("float32")
    n = 2048  # the kernel's block
    _, _, C, F, _ = _particles(20, n, np.float32)
    gnf, gaff = _rng_like(21, (n, 3, 3), (n, 3, 3), dtype=np.float32)
    rows = np.concatenate([C.reshape(n, 9).T, F.reshape(n, 9).T], axis=0)
    ct = np.concatenate([gnf.reshape(n, 9).T, gaff.reshape(n, 9).T], axis=0)
    fn = stress_affine_rows(js, _jmats(js, jnp.float32), interpret=True)
    (want,) = jax.vjp(fn, jnp.asarray(rows))[1](jnp.asarray(ct))
    want = np.asarray(want)
    gC, gF = _vjp(lambda c, f: cuda_stress.stress_affine_plain(ts, default_materials(ts), c, f),
                  [torch.tensor(C), torch.tensor(F)], [torch.tensor(gnf), torch.tensor(gaff)])
    _close(gC.reshape(n, 9).T, want[0:9], STRESS_F32_TOL)
    _close(gF.reshape(n, 9).T, want[9:18], STRESS_F32_TOL)


def test_transfer_vjps_match_pallas_interpret():
    ts, js = _scenes("float32")
    x, v, _, _, aff = _particles(22, 300, np.float32)
    x = (x - 0.3) * 0.3 + 0.42  # a cloud the chunk windows hold
    plan, xj, offs, off = _sorted_windows(js, x)
    xs = np.asarray(xj)
    n = len(xs)
    ct4, ctm, grid3, ct_v, ct_C, ct_x = _rng_like(
        23, (4, G ** 3), (G ** 3,), (3, G ** 3), (n, 3), (n, 3, 3), (n, 3), dtype=np.float32)
    grid3 = grid3 * 0.1
    p2g_fn, g2p_fn = pal.transfer_fns(js, plan, G, interpret=True)[:2]
    tx, tv, taff = map(torch.tensor, (xs, v, aff))

    want = jax.vjp(lambda a, b, c: p2g_fn(a, b, c, offs, off), xj, jnp.asarray(v),
                   jnp.asarray(aff))[1](jnp.asarray(ct4))
    got = _vjp(lambda a, b, c: cuda_transfer.p2g_plain(ts, a, b, c), [tx, tv, taff],
               [torch.tensor(ct4.T.copy())])
    for g, w in zip(got, want):
        _close(g, w, TRANSFER_F32_TOL)

    n_pad = ((n + plan.P - 1) // plan.P) * plan.P
    mass_fn = pal.mass_fns(js, plan, G, interpret=True)
    (want,) = jax.vjp(lambda a: mass_fn(pal._pack4(a, n_pad), offs, off), xj)[1](jnp.asarray(ctm))
    (got,) = _vjp(lambda a: cuda_transfer.grid_mass_plain(ts, a), [tx], [torch.tensor(ctm)])
    _close(got, want, TRANSFER_F32_TOL)

    want = jax.vjp(lambda a, g: g2p_fn(a, g, offs, off), xj, jnp.asarray(grid3))[1](
        (jnp.asarray(ct_v), jnp.asarray(ct_C), jnp.asarray(ct_x)))
    got = _vjp(lambda a, g: cuda_transfer.g2p_plain(ts, a, g), [tx, torch.tensor(grid3.T.copy())],
               [torch.tensor(ct_v), torch.tensor(ct_C), torch.tensor(ct_x)])
    _close(got[0], want[0], TRANSFER_F32_TOL)
    _close(got[1].T, want[1], TRANSFER_F32_TOL)


def test_grid_op_vjp_matches_pallas_interpret():
    """Grid and pose cotangents for the box, whose normal is a finite
    difference. One primitive: where the contact shells of several overlap,
    float32 rounding can move a cell's cotangent from one primitive to the
    next (a contact-branch flip). The float64 tests above cover every shape
    against the function the Pallas kernel differentiates, grid_op_cm."""
    ts, js = _scenes("float32", prims=SHAPE_KW[6:])
    g4 = _grid4(24, np.float32)
    pose_f, pose_f1 = _poses(25, 1, np.float32)
    (ct,) = _rng_like(26, (G ** 3, 3), dtype=np.float32)
    (p0, r0, q0), (p1, r1, q1) = pose_f, pose_f1
    fn = pgo.grid_op_fns(js, G, interpret=True)
    pf = np.concatenate([p0, r0, p1, r1], axis=1)
    gap2 = np.stack([q0, q1], axis=1)
    dg4, dpf, dgap = jax.vjp(
        lambda a, b, c: fn(a, b, c, jnp.float32(666.0), jnp.zeros(3, jnp.int32)),
        jnp.asarray(g4.T.copy()), jnp.asarray(pf), jnp.asarray(gap2))[1](jnp.asarray(ct.T.copy()))
    got = _vjp(lambda g, *p: cuda_gridop.grid_op_plain(ts, g, tuple(p[:3]), tuple(p[3:]), 666.0),
               [torch.tensor(g4)] + [torch.tensor(a) for a in (p0, r0, q0, p1, r1, q1)],
               [torch.tensor(ct)])
    got = [g.numpy() for g in got]
    dpf, dgap = np.asarray(dpf), np.asarray(dgap)
    poses = np.concatenate([got[1], _project(r0, got[2]), got[4], got[5]], axis=1)
    want = np.concatenate([dpf[:, 0:3], _project(r0, dpf[:, 3:7]), dpf[:, 7:14]], axis=1)
    _close(got[0], np.asarray(dg4).T, GRID_OP_F32_TOL)
    _close(poses, want, GRID_OP_F32_TOL)
    _close(np.stack([got[3], got[6]], axis=1), dgap, GRID_OP_F32_TOL)


# ---------------------------------------------------------------------------
# (c) Svd3
# ---------------------------------------------------------------------------

def _loss_through_svd(F):
    """A scalar of all three outputs, like the MPM stress (test_svd3.py)."""
    U, sig, V = tsvd.Svd3.apply(F)
    r = U @ V.transpose(-1, -2)
    return torch.sum(torch.log(torch.clamp(sig, min=0.05)) ** 2) + torch.sum(F * r)


def test_svd3_vjp_matches_finite_difference():
    F = np.random.default_rng(2).standard_normal((8, 3, 3)) * 0.5 + np.eye(3)
    Ft = torch.tensor(F, requires_grad=True)
    (g,) = torch.autograd.grad(_loss_through_svd(Ft), Ft)
    eps = 1e-6
    for n in (0, 3, 7):
        for i in range(3):
            for j in range(3):
                Fp, Fm = F.copy(), F.copy()
                Fp[n, i, j] += eps
                Fm[n, i, j] -= eps
                fd = (float(_loss_through_svd(torch.tensor(Fp)))
                      - float(_loss_through_svd(torch.tensor(Fm)))) / (2 * eps)
                np.testing.assert_allclose(float(g[n, i, j]), fd, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("mode", ["reference", "damped", "zero"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_svd3_vjp_finite_at_repeated_singular_values(mode, dtype):
    rng = np.random.default_rng(1)
    cases = [
        np.eye(3)[None] + 1e-4 * rng.standard_normal((64, 3, 3)),
        np.repeat(np.eye(3)[None], 4, axis=0),                  # exact identity
        np.repeat(np.diag([2.0, 2.0, 2.0])[None], 4, axis=0),   # equal sigmas
        np.repeat(np.diag([1.0, 1.0, 0.0])[None], 4, axis=0),   # rank 2
    ]
    try:
        tsvd.set_vjp_gap_mode(mode, 1e-3)
        for F in cases:
            Ft = torch.tensor(F, dtype=dtype, requires_grad=True)
            (g,) = torch.autograd.grad(_loss_through_svd(Ft), Ft)
            assert torch.isfinite(g).all(), (mode, F[0])
    finally:
        tsvd.set_vjp_gap_mode("damped", 1e-3)


@pytest.mark.parametrize("mode", ["reference", "damped", "zero"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_svd3_vjp_matches_reference_formula(mode, dtype):
    """Svd3.backward against the reference package's _svd3_vjp_bwd at the
    same eigengap mode, including near-repeated singular values."""
    rng = np.random.default_rng(3)
    F = np.concatenate([rng.standard_normal((32, 3, 3)),
                        np.eye(3)[None] + 1e-5 * rng.standard_normal((8, 3, 3))]).astype(dtype)
    gU, gsig, gV = _rng_like(4, (40, 3, 3), (40, 3), (40, 3, 3), dtype=np.dtype(dtype))
    try:
        tsvd.set_vjp_gap_mode(mode, 1e-3)
        jsvd.set_vjp_gap_mode(mode, 1e-3)
        (got,) = _vjp(tsvd.Svd3.apply, [torch.tensor(F)],
                      [torch.tensor(gU), torch.tensor(gsig), torch.tensor(gV)])
        res = tsvd.svd3(torch.tensor(F))
        (want,) = jsvd._svd3_vjp_bwd(tuple(jnp.asarray(r.numpy()) for r in res),
                                     tuple(map(jnp.asarray, (gU, gsig, gV))))
    finally:
        tsvd.set_vjp_gap_mode("damped", 1e-3)
        jsvd.set_vjp_gap_mode("damped", 1e-3)
    _close(got, want, 1e-10 if dtype == "float64" else 1e-5)
