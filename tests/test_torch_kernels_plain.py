"""The plain versions of the port's kernels (stress, P2G, mass, grid update,
G2P) held two ways against the TPU package, on the CPU:

(a) against its jnp functions in float64 (`mpm.stress_affine_jnp`,
    `transfer.p2g_dense` / `g2p_dense` / `grid_m_dense` on a full-grid crop,
    `mpm.grid_op`). Tolerance 1e-9 relative to the largest value: the same
    float64 math, summed in another order (dense matmuls there, scatter /
    gather here).
(b) against its Pallas kernels run in interpret mode, as test_pallas_local.py
    and test_pallas_gridop.py run them, in float32. Tolerance 2e-4 relative
    to the largest value: those kernels contract with a 3-pass bf16 split
    (~16 mantissa bits), amplified up to 4*inv_dx by the APIC C
    reconstruction.

Inputs come from numpy seeds, at quality 0.25 (G = 16)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plasticinelab_tpu.config import spec as jspec
from plasticinelab_tpu.engine import local_transfer as lt
from plasticinelab_tpu.engine import mpm as jmpm
from plasticinelab_tpu.engine import pallas_gridop as pgo
from plasticinelab_tpu.engine import pallas_local as pal
from plasticinelab_tpu.engine import transfer as jtr
from plasticinelab_tpu.engine.pallas_stress import stress_affine_rows
from plasticinelab_tpu.engine.state import Materials as JMaterials
from plasticinelab_tpu_torch.config import spec as tspec
from plasticinelab_tpu_torch.engine import cuda_gridop, cuda_stress, cuda_transfer
from plasticinelab_tpu_torch.engine.state import default_materials

G = 16
F64_TOL = 1e-9
PALLAS_TOL = 2e-4

SHAPE_KW = [
    dict(shape="Sphere", radius=0.12),
    dict(shape="Capsule", h=0.12, r=0.06),
    dict(shape="RollingPin", h=0.3, r=0.05),
    dict(shape="Chopsticks", h=0.25, r=0.04, init_gap=0.1),
    dict(shape="Cylinder", h=0.15, r=0.1),
    dict(shape="Torus", tx=0.15, ty=0.06),
    dict(shape="Box", size=(0.1, 0.13, 0.08)),
]
IDS = [k["shape"] for k in SHAPE_KW]


def _scenes(dtype, prims=(), n=300):
    kw = dict(quality=0.25, n_particles=n, dtype=dtype, yield_stress=30.0)
    shape = dict(shape="box", init_pos=(0.5, 0.35, 0.5), width=0.1)
    t = tspec.SceneSpec(simulator=tspec.SimulatorSpec(**kw),
                        primitives=tuple(tspec.PrimitiveSpec(**p) for p in prims),
                        shapes=(tspec.ShapeSpec(**shape),))
    j = jspec.SceneSpec(simulator=jspec.SimulatorSpec(**kw),
                        primitives=tuple(jspec.PrimitiveSpec(**p) for p in prims),
                        shapes=(jspec.ShapeSpec(**shape),))
    assert t.simulator.n_grid == G
    return t, j


def _particles(seed, n, np_dtype):
    rng = np.random.default_rng(seed)
    x = rng.random((n, 3)) * 0.35 + 0.3
    v = rng.standard_normal((n, 3)) * 0.5
    C = rng.standard_normal((n, 3, 3)) * 2.0
    F = np.eye(3) + rng.standard_normal((n, 3, 3)) * 0.15
    aff = rng.standard_normal((n, 3, 3)) * 0.3
    return [a.astype(np_dtype) for a in (x, v, C, F, aff)]


def _grid4(seed, np_dtype):
    """(G^3, 4) momentum + mass, about a quarter of the cells empty."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((G ** 3, 4)) * 1e-4
    m = np.abs(rng.standard_normal(G ** 3)) * 1e-4 + 1e-6
    g[:, 3] = np.where(rng.random(G ** 3) < 0.25, 0.0, m)
    return g.astype(np_dtype)


def _poses(seed, k, np_dtype):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.3, 0.7, (k, 3))
    rot = rng.standard_normal((k, 4))
    rot /= np.linalg.norm(rot, axis=1, keepdims=True)
    gap = rng.uniform(0.05, 0.1, (k,))
    f = [a.astype(np_dtype) for a in (pos, rot, gap)]
    f1 = [a.astype(np_dtype) for a in (pos + 0.001, rot, gap + 0.0005)]
    return f, f1


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def _jmats(scene, dtype):
    sim = scene.simulator
    return JMaterials(mu=jnp.asarray(sim.mu_0, dtype), lam=jnp.asarray(sim.lam_0, dtype),
                      yield_stress=jnp.asarray(sim.yield_stress, dtype))


# ---------------------------------------------------------------------------
# (a) float64, against the jnp functions
# ---------------------------------------------------------------------------

def test_stress_plain_matches_jnp_f64():
    ts, js = _scenes("float64")
    _, _, C, F, _ = _particles(0, 512, np.float64)
    nF, aff = cuda_stress.stress_affine_plain(ts, default_materials(ts),
                                              torch.tensor(C), torch.tensor(F))
    rnF, raff = jmpm.stress_affine_jnp(js, _jmats(js, jnp.float64), jnp.asarray(C),
                                       jnp.asarray(F))
    _close(nF, rnF, F64_TOL)
    _close(aff, raff, F64_TOL)


def test_transfers_plain_match_dense_f64():
    ts, js = _scenes("float64")
    x, v, _, _, aff = _particles(1, 300, np.float64)
    aw = jtr.axis_weights(js, jnp.asarray(x), G)
    assert np.all(np.asarray(aw.off) == 0)  # the full grid is the crop
    gv, gm = jtr.p2g_dense(js, aw, jnp.asarray(v), jnp.asarray(aff), G)
    grid4 = cuda_transfer.p2g_plain(ts, torch.tensor(x), torch.tensor(v), torch.tensor(aff))
    _close(grid4[:, :3], gv, F64_TOL)
    _close(grid4[:, 3], gm, F64_TOL)
    _close(cuda_transfer.grid_mass_plain(ts, torch.tensor(x)),
           jtr.grid_m_dense(js, jnp.asarray(x), G), F64_TOL)

    grid_v = np.random.default_rng(2).standard_normal((G ** 3, 3))
    nv, nC = jtr.g2p_dense(js, aw, jnp.asarray(grid_v), G)
    sim = js.simulator
    nx = np.maximum(np.minimum(x + sim.dt * np.asarray(nv), 1.0 - 3 * sim.dx), 0.0)
    tv, tC, tx = cuda_transfer.g2p_plain(ts, torch.tensor(x), torch.tensor(grid_v))
    _close(tv, nv, F64_TOL)
    _close(tC, nC, F64_TOL)
    _close(tx, nx, F64_TOL)


@pytest.mark.parametrize("kw", SHAPE_KW, ids=IDS)
def test_grid_op_plain_matches_jnp_f64(kw):
    ts, js = _scenes("float64", prims=[kw])
    g4 = _grid4(3, np.float64)
    (p0, r0, q0), (p1, r1, q1) = _poses(4, 1, np.float64)
    ref = jmpm.grid_op(js, jnp.asarray(g4[:, :3]), jnp.asarray(g4[:, 3]),
                       tuple(map(jnp.asarray, (p0, r0, q0))),
                       tuple(map(jnp.asarray, (p1, r1, q1))), 666.0, G,
                       jnp.zeros(3, jnp.int32))
    got = cuda_gridop.grid_op_plain(ts, torch.tensor(g4),
                                    tuple(map(torch.tensor, (p0, r0, q0))),
                                    tuple(map(torch.tensor, (p1, r1, q1))), 666.0)
    _close(got, ref, F64_TOL)
    # the contact response ran: some cells differ from the scene without it
    free = cuda_gridop.grid_op_plain(_scenes("float64")[0], torch.tensor(g4),
                                     *[(torch.zeros(0, 3), torch.zeros(0, 4), torch.zeros(0))] * 2,
                                     666.0)
    assert (got != free).any(dim=1).sum() > 0


# ---------------------------------------------------------------------------
# (b) float32, against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

def test_stress_plain_matches_pallas_interpret():
    ts, js = _scenes("float32")
    n = 2048  # the kernel's block
    _, _, C, F, _ = _particles(5, n, np.float32)
    rows = np.concatenate([C.reshape(n, 9).T, F.reshape(n, 9).T], axis=0)
    out = np.asarray(stress_affine_rows(js, _jmats(js, jnp.float32),
                                        interpret=True)(jnp.asarray(rows)))
    nF, aff = cuda_stress.stress_affine_plain(ts, default_materials(ts),
                                              torch.tensor(C), torch.tensor(F))
    _close(nF.reshape(n, 9).T, out[0:9], PALLAS_TOL)
    _close(aff.reshape(n, 9).T, out[9:18], PALLAS_TOL)


def _sorted_windows(js, x):
    """Particles sorted by cell and the Pallas chunk windows over the full
    grid (crop offset 0), as test_pallas_local.py sets them up."""
    plan = lt.LocalPlan(P=128, Lx=8, Ly=G)
    xj = jnp.asarray(x)
    (xj,), _, _ = lt.sort_rows(lt.sort_keys(js, xj), (xj,))
    off = jnp.zeros(3, jnp.int32)
    ctx = lt.chunk_offsets(js, plan, xj, off, G)
    assert bool(ctx.ok)
    return plan, xj, ctx.offs, off


def test_transfers_plain_match_pallas_interpret():
    ts, js = _scenes("float32")
    x, v, _, _, aff = _particles(6, 300, np.float32)
    x = (x - 0.3) * 0.3 + 0.42  # a cloud the chunk windows hold
    plan, xj, offs, off = _sorted_windows(js, x)
    perm = np.asarray(lt.sort_rows(lt.sort_keys(js, jnp.asarray(x)),
                                   (jnp.arange(len(x)),))[0][0])
    v, aff = v[perm], aff[perm]
    xs = np.asarray(xj)
    p2g_fn, g2p_fn = pal.transfer_fns(js, plan, G, interpret=True)[:2]

    grid4 = np.asarray(p2g_fn(xj, jnp.asarray(v), jnp.asarray(aff), offs, off))
    ours = cuda_transfer.p2g_plain(ts, torch.tensor(xs), torch.tensor(v), torch.tensor(aff))
    _close(ours.T, grid4, PALLAS_TOL)

    n_pad = ((len(xs) + plan.P - 1) // plan.P) * plan.P
    gm = pal.mass_fns(js, plan, G, interpret=True)(pal._pack4(xj, n_pad), offs, off)
    _close(cuda_transfer.grid_mass_plain(ts, torch.tensor(xs)), gm, PALLAS_TOL)

    grid3 = (np.random.default_rng(7).standard_normal((3, G ** 3)) * 0.1).astype(np.float32)
    nv, nC, nx = g2p_fn(xj, jnp.asarray(grid3), offs, off)
    tv, tC, tx = cuda_transfer.g2p_plain(ts, torch.tensor(xs), torch.tensor(grid3.T.copy()))
    _close(tv, nv, PALLAS_TOL)
    _close(tC, nC, PALLAS_TOL)
    _close(tx, nx, PALLAS_TOL)


def test_grid_op_plain_matches_pallas_interpret():
    """All 7 shapes in one scene. The contact condition (influence > 0.1 or
    sdf <= 0) is a jump: a cell within rounding of it can take the other
    branch in f32, so at most 2 cells of the 4096 may differ beyond the
    tolerance (counted, not loosened)."""
    ts, js = _scenes("float32", prims=SHAPE_KW)
    k = len(SHAPE_KW)
    g4 = _grid4(8, np.float32)
    (p0, r0, q0), (p1, r1, q1) = _poses(9, k, np.float32)
    pf = np.concatenate([p0, r0, p1, r1], axis=1)
    gap2 = np.stack([q0, q1], axis=1)
    ref = np.asarray(pgo.grid_op_fns(js, G, interpret=True)(
        jnp.asarray(g4.T.copy()), jnp.asarray(pf), jnp.asarray(gap2),
        jnp.float32(666.0), jnp.zeros(3, jnp.int32))).T
    got = cuda_gridop.grid_op_plain(ts, torch.tensor(g4),
                                    tuple(map(torch.tensor, (p0, r0, q0))),
                                    tuple(map(torch.tensor, (p1, r1, q1))), 666.0).numpy()
    err = np.abs(got - ref).max(axis=1)
    bad = err > PALLAS_TOL * np.abs(ref).max()
    assert bad.sum() <= 2, (bad.sum(), err.max())
    assert np.isfinite(got).all()
