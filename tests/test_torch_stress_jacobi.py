"""The Jacobi rotation of the stress kernels K1 / K2 and the SVD around it,
held against the TPU package on the CPU.

`plasticinelab_tpu_torch/engine/svd3.py:_jacobi_rotation` is the plain twin
of the rotation in `csrc/stress.cu`: the reference's angle through one
reciprocal and two rsqrt instead of divisions and square roots.
- float64: rotation by rotation against the reference's own
  `_jacobi_rotation` (`plasticinelab_tpu/engine/svd3.py`) on the same dicts
  of components, to 1e-12 of each row's scale: the same angle, rounded
  differently.
- float32: the rotation is orthogonal, |c^2 + s^2 - 1| <= 1e-6, and zeroes
  its off-diagonal entry to 1e-6 of the matrix's scale, also where that
  entry is subnormal; with an rsqrt as inexact as the card's approximate
  one, |c^2 + s^2 - 1| stays within 3e-7.
- The SVD and the stress on inputs where the SVD is hardest (F = I exactly,
  pure rotations, two equal singular values, one below the 0.05 clamp, F
  scaled by 1e-3 and 1e3, a yielding cloud): U diag(sigma) V^T = F,
  det(U) = det(V) = +1, descending order, the reference's singular values;
  `stress_affine_plain` against `mpm.stress_affine_jnp` in float64 at the
  tolerance of tests/test_torch_kernels_plain.py.
Inputs come from numpy seeds."""
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plasticinelab_tpu.config import spec as jspec
from plasticinelab_tpu.engine import mpm as jmpm
from plasticinelab_tpu.engine import svd3 as jsvd
from plasticinelab_tpu.engine.state import Materials as JMaterials
from plasticinelab_tpu_torch.config import spec as tspec
from plasticinelab_tpu_torch.engine import cuda_stress
from plasticinelab_tpu_torch.engine import svd3 as tsvd
from plasticinelab_tpu_torch.engine.state import default_materials

PAIRS = ((0, 1), (0, 2), (1, 2))
KEYS_A = [(i, j) for i in range(3) for j in range(3) if i <= j]
KEYS_V = [(i, j) for i in range(3) for j in range(3)]
F64_ROT_TOL = 1e-12
F32_TOL = 1e-6
F64_TOL = 1e-9  # tests/test_torch_kernels_plain.py's float64 bound
N = 96          # matrices per degenerate case


def _symmetric(seed):
    """(rows, 6) symmetric matrices, upper triangle keyed like KEYS_A: random,
    then rows with a[p][q] = 0, with a[p][p] = a[q][q], both at once, and
    each kind again at scales 1e-20 and 1e18."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((64, 6))
    base[:, [0, 3, 5]] = np.abs(base[:, [0, 3, 5]]) + 0.1  # diagonal of F^T F
    zero_pq, equal, both = base.copy(), base.copy(), base.copy()
    for k in (1, 2, 4):  # every off-diagonal entry, so each (p, q) meets one
        zero_pq[k::3, k] = 0.0
    equal[:, 3] = equal[:, 0]
    equal[:, 5] = equal[:, 0]
    both[:, [1, 2, 4]] = 0.0
    both[:, [3, 5]] = both[:, [0]]
    both[::2, 1] = 0.3  # equal diagonals, one non-zero entry: a 45-degree turn
    rows = np.concatenate([base, zero_pq, equal, both])
    return np.concatenate([rows, rows * 1e-20, rows * 1e18])


def _dicts(rows, v_rows, to):
    a = {k: to(rows[:, i]) for i, k in enumerate(KEYS_A)}
    v = {k: to(v_rows[:, i]) for i, k in enumerate(KEYS_V)}
    return a, v


@pytest.mark.parametrize("p,q", PAIRS, ids=[f"{p}{q}" for p, q in PAIRS])
def test_jacobi_rotation_matches_reference_f64(p, q):
    rows = _symmetric(0)
    rng = np.random.default_rng(1)
    v_rows = np.linalg.qr(rng.standard_normal((len(rows), 3, 3)))[0].reshape(-1, 9)
    ta, tv = tsvd._jacobi_rotation(*_dicts(rows, v_rows, torch.tensor), p, q)
    ja, jv = jsvd._jacobi_rotation(*_dicts(rows, v_rows, jnp.asarray), p, q)
    scale = np.abs(rows).max(axis=1)
    for k in KEYS_A:
        err = np.abs(ta[k].numpy() - np.asarray(ja[k]))
        assert (err <= F64_ROT_TOL * scale).all(), (k, float((err / scale).max()))
    for k in KEYS_V:
        np.testing.assert_allclose(tv[k].numpy(), np.asarray(jv[k]), rtol=0, atol=F64_ROT_TOL)


@pytest.mark.parametrize("p,q", PAIRS, ids=[f"{p}{q}" for p, q in PAIRS])
def test_jacobi_rotation_is_orthogonal_and_zeroes_its_entry_f32(p, q):
    rows = _symmetric(2)
    # an off-diagonal entry far below the rest, down to subnormal float32
    tiny = np.repeat(_symmetric(3)[:64], 3, axis=0)
    tiny[:, KEYS_A.index((p, q))] = np.repeat([1e-30, 1e-39, 1e-44], 64)
    tiny[64:, KEYS_A.index((q, q))] = tiny[64:, KEYS_A.index((p, p))]
    rows = np.concatenate([rows[np.abs(rows).max(axis=1) < 1e18], tiny]).astype(np.float32)
    eye = np.tile(np.eye(3, dtype=np.float32).reshape(1, 9), (len(rows), 1))
    a, v = tsvd._jacobi_rotation(*_dicts(rows, eye, torch.tensor), p, q)
    # from the identity, column p of v is (c, -s) at rows (p, q)
    c, s = v[(p, p)].double(), v[(p, q)].double()
    assert torch.isfinite(c).all() and torch.isfinite(s).all()
    assert float((c * c + s * s - 1.0).abs().max()) <= F32_TOL
    assert torch.equal(v[(q, p)], -v[(p, q)]) and torch.equal(v[(q, q)], v[(p, p)])
    scale = np.abs(rows.astype(np.float64)).max(axis=1)
    off = a[(p, q)].double().abs().numpy()
    assert (off <= F32_TOL * scale).all(), float((off / scale).max())


APPROX_RSQRT_ERR = 2.0 ** -22  # relative error bound of the card's rsqrt.approx
ROT_ROUNDING_TOL = 3e-7        # 2.5 float32 ulps of 1; without the Newton step ~8e-7


@pytest.mark.parametrize("p,q", PAIRS, ids=[f"{p}{q}" for p, q in PAIRS])
def test_jacobi_rotation_stays_orthogonal_with_an_approximate_rsqrt_f32(p, q):
    """The kernels take the angle's rsqrt approximately: the Newton step on
    (c, s) keeps c^2 + s^2 = 1 to float32 rounding all the same."""
    rows = _symmetric(2)
    rows = rows[np.abs(rows).max(axis=1) < 1e18].astype(np.float32)
    eye = np.tile(np.eye(3, dtype=np.float32).reshape(1, 9), (len(rows), 1))
    exact = torch.rsqrt
    gen = torch.Generator().manual_seed(4)

    def approx_rsqrt(x):
        noise = 2 * torch.rand(x.shape, generator=gen, dtype=torch.float64) - 1
        return exact(x) * (1 + APPROX_RSQRT_ERR * noise).to(x.dtype)

    with mock.patch.object(tsvd.torch, "rsqrt", approx_rsqrt):
        _, v = tsvd._jacobi_rotation(*_dicts(rows, eye, torch.tensor), p, q)
    c, s = v[(p, p)].double(), v[(p, q)].double()
    assert float((c * c + s * s - 1.0).abs().max()) <= ROT_ROUNDING_TOL


def _proper(rng, n):
    q = np.linalg.qr(rng.standard_normal((n, 3, 3)))[0]
    return q * np.sign(np.linalg.det(q))[:, None, None]


def degenerate_cases(seed=0, n=N):
    """name -> F (n, 3, 3): where the SVD is hardest."""
    rng = np.random.default_rng(seed)
    R1, R2 = _proper(rng, n), _proper(rng, n)

    def with_singular_values(s):
        return R1 @ (s[:, :, None] * np.eye(3)) @ R2.transpose(0, 2, 1)

    one = np.ones(n)
    near_identity = np.eye(3) + rng.standard_normal((n, 3, 3)) * 0.15
    return {
        "identity": np.broadcast_to(np.eye(3), (n, 3, 3)).copy(),
        "rotation": R1,
        "two_equal": with_singular_values(np.stack([1.2 * one, 0.9 * one, 0.9 * one], 1)),
        "below_clamp": with_singular_values(np.stack([1.1 * one, 0.95 * one, 0.02 * one], 1)),
        "scaled_1e-3": near_identity * 1e-3,
        "scaled_1e3": near_identity * 1e3,
        "yielding": with_singular_values(np.exp(rng.uniform(-0.4, 0.4, (n, 3)))),
    }


CASES = list(degenerate_cases())


def _det(m):
    return np.linalg.det(np.asarray(m, np.float64))


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-10), (np.float32, 2e-5)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("case", CASES)
def test_svd3_on_hard_inputs_matches_reference(case, dtype, tol):
    F = degenerate_cases()[case].astype(dtype)
    U, sig, V = (t.numpy().astype(np.float64) for t in tsvd.svd3(torch.tensor(F)))
    jU, jsig, jV = (np.asarray(t, np.float64) for t in jsvd.svd3(jnp.asarray(F)))
    scale = np.abs(F.astype(np.float64)).max()
    for u, s, v in ((U, sig, V), (jU, jsig, jV)):
        recon = u @ (s[:, :, None] * np.eye(3)) @ v.transpose(0, 2, 1)
        np.testing.assert_allclose(recon, F, rtol=0, atol=tol * scale)
        np.testing.assert_allclose(_det(u), 1.0, rtol=0, atol=tol * 10)
        np.testing.assert_allclose(_det(v), 1.0, rtol=0, atol=tol * 10)
        # descending: sigma_0 >= sigma_1 >= |sigma_2|, the sign on the last
        assert (s[:, 0] >= s[:, 1] - tol * scale).all()
        assert (s[:, 1] >= np.abs(s[:, 2]) - tol * scale).all()
    np.testing.assert_allclose(sig, jsig, rtol=0, atol=tol * scale)


def _scenes():
    kw = dict(quality=0.25, n_particles=N, dtype="float64", yield_stress=30.0)
    shape = dict(shape="box", init_pos=(0.5, 0.35, 0.5), width=0.1)
    t = tspec.SceneSpec(simulator=tspec.SimulatorSpec(**kw), shapes=(tspec.ShapeSpec(**shape),))
    j = jspec.SceneSpec(simulator=jspec.SimulatorSpec(**kw), shapes=(jspec.ShapeSpec(**shape),))
    return t, j


@pytest.mark.parametrize("case", CASES)
def test_stress_plain_on_hard_inputs_matches_jnp_f64(case):
    ts, js = _scenes()
    F = degenerate_cases()[case]
    C = np.random.default_rng(7).standard_normal((N, 3, 3)) * 2.0
    nF, aff = cuda_stress.stress_affine_plain(ts, default_materials(ts), torch.tensor(C),
                                              torch.tensor(F))
    sim = js.simulator
    mats = JMaterials(mu=jnp.asarray(sim.mu_0), lam=jnp.asarray(sim.lam_0),
                      yield_stress=jnp.asarray(sim.yield_stress))
    rnF, raff = jmpm.stress_affine_jnp(js, mats, jnp.asarray(C), jnp.asarray(F))
    for got, want in ((nF, rnF), (aff, raff)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F64_TOL * np.abs(want).max())
    if case == "yielding":  # the return map ran
        assert not np.allclose(nF.numpy(), F + sim.dt * C @ F)
