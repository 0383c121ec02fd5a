"""The transfer kernels' particle walk, on the CPU, where no kernel runs.
The scatters (K3, K7 forward, K6) walk each env's `order`; the gathers (K5
G2P, K4 the P2G backward, K7 backward) take none and walk the particles as
they lie, which measured faster on the H100 than walking the order
(PERF.md):

- the autograd Functions `P2G`, `GridMass` and `G2P` hand the `order` of
  their forward call to their scatter kernels (forward K3, K7; G2P's
  backward K6) and none to their gathers (the launch functions
  monkeypatched); every launch function passes its C entry point the
  arguments `cuda_build._SIGNATURES` declares, the order's pointer among
  them where the kernel takes one (the library monkeypatched);
- every C entry point of `csrc/` takes the argument types that
  `cuda_build._SIGNATURES` declares, and the gathers' launch constants are
  the ones this file models;
- the VJPs of the transfers' plain versions, through the wrappers on CPU
  tensors, are the same bits under the sorted, a stale and a random order
  as under none, and within 1e-8 (float64) of jax.vjp of the JAX
  transfers;
- a plain model of the gathers' arithmetic in float32 (K5 and K4 sum each
  plane a of the stencil alone over its 9 cells, then (P0 + P1) + P2, K7
  backward the 27 cells in one running sum; the K4 and K7 backward dx
  through the weights and through dpos) is the plain versions' within
  float32 rounding.

Inputs come from numpy seeds, at quality 0.25 (G = 16).
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plasticinelab_tpu.engine import transfer as jtr
from plasticinelab_tpu_torch.engine import cuda_build, cuda_transfer
from plasticinelab_tpu_torch.engine.transfer import cell_order
from test_torch_kernels_plain import G, _particles, _scenes

N = 300
F64_TOL = 1e-8
F32_TOL = 1e-5  # float32 sums of 27 terms against float64, relative to the largest value


def _src(name):
    with open(os.path.join(cuda_build.CSRC, name)) as f:
        return f.read()


def _inputs(B, dtype=np.float64, seed=12):
    """x, v, affine (B, N, ...) and seeded grids and cotangents."""
    x, v, _, _, aff = _particles(seed, B * N, dtype)
    rng = np.random.default_rng(seed + 1)
    t = lambda a: torch.tensor(a.astype(dtype))  # noqa: E731
    return dict(x=t(x.reshape(B, N, 3)), v=t(v.reshape(B, N, 3)), aff=t(aff.reshape(B, N, 3, 3)),
                grid_v=t(rng.standard_normal((B, G ** 3, 3)) * 0.5),
                ct4=t(rng.standard_normal((B, G ** 3, 4))), ctm=t(rng.standard_normal((B, G ** 3))),
                ct_v=t(rng.standard_normal((B, N, 3))), ct_C=t(rng.standard_normal((B, N, 3, 3))),
                ct_x=t(rng.standard_normal((B, N, 3))))


def _orders(scene, x, v):
    """The sorted order, one 19 substeps stale and a random permutation per
    env, for x and v (B, n, 3)."""
    sim = scene.simulator
    gen = torch.Generator().manual_seed(7)
    rand = torch.stack([torch.randperm(x.shape[1], generator=gen) for _ in range(x.shape[0])])
    return {"sorted": cell_order(scene, x), "stale": cell_order(scene, x - 19 * sim.dt * v),
            "random": rand.to(torch.int32)}


# ---------------------------------------------------------------------------
# the order reaches the backward and the kernel
# ---------------------------------------------------------------------------

def _plain_grads(fn, ins, cts):
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in ins]
        out = fn(*ins)
        out = out if isinstance(out, tuple) else (out,)
        return torch.autograd.grad(out, ins, cts)


# name of the Function -> (its forward launch, its backward kernel, the
# number of differentiable inputs, whether each of the two walks the order)
_FUNCTIONS = {"P2G": ("_launch_p2g", "p2g_bwd", 3, (True, False)),
              "GridMass": ("_launch_grid_mass", "grid_mass_bwd", 1, (True, False)),
              "G2P": ("_launch_g2p", "g2p_bwd", 2, (False, True))}


@pytest.mark.parametrize("batched", [False, True], ids=["one-env", "B=2"])
@pytest.mark.parametrize("fn", list(_FUNCTIONS))
def test_functions_hand_the_forward_order_to_the_scatters(monkeypatch, fn, batched):
    """Each autograd Function hands the very `order` tensor its forward was
    called with (None stays None) to its scatter kernel, forward or
    backward, and none to its gather; the backward returns the plain
    version's VJP."""
    scene, _ = _scenes("float64", n=N)
    t = _inputs(2)
    pick = (lambda a: a) if batched else (lambda a: a[0])
    x, v, aff, grid_v = (pick(t[k]) for k in ("x", "v", "aff", "grid_v"))
    ct = cuda_transfer
    plain = {"P2G": ct.p2g_plain_batched if batched else ct.p2g_plain,
             "GridMass": ct.grid_mass_plain_batched if batched else ct.grid_mass_plain,
             "G2P": ct.g2p_plain_batched if batched else ct.g2p_plain}[fn]
    launch_name, bwd_name, n_in, walks = _FUNCTIONS[fn]
    seen = []

    def launch(scene_, *args):
        ins = args[:n_in]
        seen.append(("fwd", args[n_in] if walks[0] else "no order", len(args) - n_in))
        return plain(scene_, *ins)

    def backward(scene_, *args):
        ins, cts = args[:n_in], args[n_in:]
        if walks[1]:
            *cts, order = cts
        seen.append(("bwd", order if walks[1] else "no order", 0))
        grads = _plain_grads(lambda *a: plain(scene_, *a), ins, list(cts))
        return grads[0] if n_in == 1 else grads  # grid_mass_bwd returns dx alone

    monkeypatch.setattr(ct, launch_name, launch)
    monkeypatch.setattr(ct, bwd_name, backward)
    order = cell_order(scene, x)
    for o in (order, None):
        seen.clear()
        ins = {"P2G": [x, v, aff], "GridMass": [x], "G2P": [x, grid_v]}[fn]
        ins = [a.clone().requires_grad_(True) for a in ins]
        out = getattr(ct, fn).apply(*ins, o, scene)
        out = out if isinstance(out, tuple) else (out,)
        cts = [torch.ones_like(a) for a in out]
        got = torch.autograd.grad(out, ins, cts)
        assert [k for k, _, _ in seen] == ["fwd", "bwd"]
        for (_, s, _), walk in zip(seen, walks):
            assert s is o if walk else s == "no order"
        assert seen[0][2] == int(walks[0])  # a gather's launch takes no order argument
        want = _plain_grads(lambda *a: plain(scene, *a), ins, cts)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


class _Recorder:
    """A stand-in for the kernel library: records each entry point's
    arguments and returns 0 (no error)."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        def call(*args):
            self.calls[name] = args
            return 0
        return call


@pytest.mark.parametrize("with_order", [True, False], ids=["order", "none"])
def test_launches_pass_their_signature(monkeypatch, with_order):
    """Each transfer's launch function passes its C entry point as many
    arguments as `cuda_build._SIGNATURES` declares; the scatters the order's
    pointer (0 without one) where the kernel takes it."""
    scene, _ = _scenes("float32", n=N)
    t = _inputs(2, np.float32)
    lib = _Recorder()
    monkeypatch.setattr(cuda_build, "library", lambda: lib)
    monkeypatch.setattr(cuda_build, "require_kernel_input", lambda t, name: None)
    monkeypatch.setattr(cuda_build, "stream_of", lambda t: 0)
    order = cell_order(scene, t["x"]) if with_order else None
    want = order.data_ptr() if with_order else 0
    ct = cuda_transfer
    ct._launch_p2g(scene, t["x"], t["v"], t["aff"], order)
    ct._launch_grid_mass(scene, t["x"], order)
    ct._launch_g2p(scene, t["x"], t["grid_v"])
    ct.p2g_bwd(scene, t["x"], t["v"], t["aff"], t["ct4"])
    ct.grid_mass_bwd(scene, t["x"], t["ctm"])
    ct.g2p_bwd(scene, t["x"], t["grid_v"], t["ct_v"], t["ct_C"], t["ct_x"], order)
    order_at = {"plb_p2g": 3, "plb_grid_mass": 1, "plb_g2p_bwd": 5}
    for name in ("plb_p2g", "plb_grid_mass", "plb_g2p", "plb_p2g_bwd", "plb_grid_mass_bwd",
                 "plb_g2p_bwd"):
        args = lib.calls[name]
        assert len(args) == len(cuda_build._SIGNATURES[name]), name
        assert args[0] == t["x"].data_ptr()
        if name in order_at:
            assert args[order_at[name]] == want


def test_p2g_bwd_rejects_a_misaligned_cotangent(monkeypatch):
    """K4 reads each (G^3, 4) cotangent cell as one 16-byte load: a
    contiguous cotangent that does not start on 16 bytes is refused before
    any launch."""
    scene, _ = _scenes("float32", n=N)
    t = _inputs(1, np.float32)
    lib = _Recorder()
    monkeypatch.setattr(cuda_build, "library", lambda: lib)
    monkeypatch.setattr(cuda_build, "require_kernel_input", lambda t, name: None)
    monkeypatch.setattr(cuda_build, "stream_of", lambda t: 0)
    x, v, aff = t["x"][0], t["v"][0], t["aff"][0]
    shifted = torch.zeros(G ** 3 * 4 + 1)[1:].view(G ** 3, 4)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        cuda_transfer.p2g_bwd(scene, x, v, aff, shifted)
    assert "plb_p2g_bwd" not in lib.calls
    cuda_transfer.p2g_bwd(scene, x, v, aff, t["ct4"][0])
    assert "plb_p2g_bwd" in lib.calls


_C_TYPES = {"const float*": "_P", "float*": "_P", "const int*": "_P", "int*": "_P",
            "void*": "_P", "long long": "_L", "int": "_I", "float": "_F",
            "PrimTable": "PrimTable"}


def test_signatures_match_the_sources():
    """Every extern "C" entry point of csrc/*.cu takes, in order, the
    argument types that `cuda_build._SIGNATURES` gives ctypes."""
    kinds = {"_P": cuda_build._P, "_L": cuda_build._L, "_I": cuda_build._I, "_F": cuda_build._F,
             "PrimTable": cuda_build.PrimTable}
    found = {}
    for f in sorted(os.listdir(cuda_build.CSRC)):
        if f.endswith(".cu"):
            for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', _src(f)):
                types = [re.sub(r"\s+", " ", p.strip()).rsplit(" ", 1)[0].replace(" *", "*")
                         for p in params.split(",")]
                found[name] = [kinds[_C_TYPES[t]] for t in types]
    assert found.keys() == cuda_build._SIGNATURES.keys()
    for name, argtypes in found.items():
        assert argtypes == cuda_build._SIGNATURES[name], name


WARP = 32


def test_gather_launch_constants():
    """The gathers' launch shapes are whole warps, and the slab stores' one
    holds a block's 15 output floats per particle in shared memory."""
    src = _src("transfer.cu")
    threads = {k: int(re.search(k + r" = (\d+)", src).group(1))
               for k in ("kGatherThreads", "kSlabThreads")}
    assert all(t % WARP == 0 for t in threads.values())
    assert threads["kSlabThreads"] * 15 * 4 <= 48 * 1024  # static shared memory
    assert int(re.search(r"kSlabFrom = (\d+);", src).group(1)) > 0


# ---------------------------------------------------------------------------
# the plain versions: any order, against JAX
# ---------------------------------------------------------------------------

def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def _vjp(fn, inputs, cts):
    ins = [a.clone().requires_grad_(True) for a in inputs]
    out = fn(*ins)
    out = out if isinstance(out, tuple) else (out,)
    return torch.autograd.grad(out, ins, cts)


@pytest.mark.parametrize("oname", ["sorted", "stale", "random"])
@pytest.mark.parametrize("transfer", ["p2g", "grid_mass", "g2p"])
def test_plain_vjps_ignore_the_order_and_match_jax_f64(transfer, oname):
    """Through the wrappers on CPU tensors (the plain versions), one env:
    the VJP under each order equals that under none bit for bit, and
    jax.vjp of the JAX transfer within 1e-8."""
    ts, js = _scenes("float64", n=N)
    t = _inputs(1)
    order = _orders(ts, t["x"], t["v"])[oname][0]
    x, v, aff, grid_v = (t[k][0] for k in ("x", "v", "aff", "grid_v"))
    sim = js.simulator
    ct = cuda_transfer
    if transfer == "p2g":
        ins, cts = [x, v, aff], [t["ct4"][0]]

        def fn(o):
            return lambda a, b, c: ct.p2g(ts, a, b, c, o)

        def jfn(xx, vv, aa):
            gv, gm = jtr.p2g_dense(js, jtr.axis_weights(js, xx, G), vv, aa, G)
            return jnp.concatenate([gv, gm[:, None]], axis=1)
    elif transfer == "grid_mass":
        ins, cts = [x], [t["ctm"][0]]

        def fn(o):
            return lambda a: ct.grid_mass(ts, a, o)

        def jfn(xx):
            return jtr.grid_m_dense(js, xx, G)
    else:
        ins, cts = [x, grid_v], [t["ct_v"][0], t["ct_C"][0], t["ct_x"][0]]

        def fn(o):
            return lambda a, g: ct.g2p(ts, a, g, o)

        def jfn(xx, gg):
            nv, nC = jtr.g2p_dense(js, jtr.axis_weights(js, xx, G), gg, G)
            return nv, nC, jnp.maximum(jnp.minimum(xx + sim.dt * nv, 1.0 - 3 * sim.dx), 0.0)
    got = _vjp(fn(order), ins, cts)
    for g, w in zip(got, _vjp(fn(None), ins, cts)):
        assert torch.equal(g, w)
    _, pull = jax.vjp(jfn, *(jnp.asarray(a.numpy()) for a in ins))
    want = pull(tuple(jnp.asarray(c.numpy()) for c in cts) if len(cts) > 1
                else jnp.asarray(cts[0].numpy()))
    for g, w in zip(got, want):
        _close(g, w, F64_TOL)


# ---------------------------------------------------------------------------
# the gathers' arithmetic, modelled in float32
# ---------------------------------------------------------------------------

def _stencil32(scene, x):
    """The kernels' per-axis stencil in float32: px, base (clamped), w and
    dw/dpx [tap][axis] per particle."""
    sim = scene.simulator
    px = x.astype(np.float32) * np.float32(sim.inv_dx)
    b = np.floor(px - np.float32(0.5))
    fx = px - b
    base = np.clip(b.astype(np.int64), 0, G - 3)
    h = np.float32(0.5)
    w = np.stack([h * (np.float32(1.5) - fx) ** 2, np.float32(0.75) - (fx - 1) ** 2,
                  h * (fx - h) ** 2], axis=1)
    dw = np.stack([fx - np.float32(1.5), np.float32(-2) * (fx - 1), fx - h], axis=1)
    return px, base, w.astype(np.float32), dw.astype(np.float32)


def _stencil_sums(scene, x, cell_terms, n_sums, planes=True):
    """Each particle's sums in the kernels' order, in float32: each plane a
    of the stencil summed alone over its 9 cells in (b, c) order, then
    (P0 + P1) + P2; without `planes` one running sum over the 27 cells.
    cell_terms(cell, W, dW, dpos) -> (n, n_sums) float32 terms."""
    px, base, w, dw = _stencil32(scene, x)
    r = np.arange(len(x))
    sums = []
    acc = np.zeros((len(x), n_sums), np.float32)
    for a in range(3):
        if planes:
            acc = np.zeros((len(x), n_sums), np.float32)
        for b in range(3):
            for c in range(3):
                cells = base + np.array([a, b, c])
                W = w[r, a, 0] * w[r, b, 1] * w[r, c, 2]
                dW = np.stack([dw[r, a, 0] * w[r, b, 1] * w[r, c, 2],
                               w[r, a, 0] * dw[r, b, 1] * w[r, c, 2],
                               w[r, a, 0] * w[r, b, 1] * dw[r, c, 2]], axis=1)
                cell = (cells[:, 0] * G + cells[:, 1]) * G + cells[:, 2]
                acc = acc + cell_terms(cell, W, dW, cells.astype(np.float32) - px)
        sums.append(acc)
    return (sums[0] + sums[1]) + sums[2] if planes else acc


def test_gather_model_matches_plain_f32():
    """The gathers' arithmetic (K5: v and the APIC moment; K4: dx, dv,
    daffine; K7 backward: dx), modelled in float32 in the kernels' order,
    against the float64 plain versions and their VJPs, within float32
    rounding."""
    scene, _ = _scenes("float64", n=N)
    sim = scene.simulator
    t = _inputs(1)
    x, v, aff, grid_v = (t[k][0].numpy() for k in ("x", "v", "aff", "grid_v"))
    ct4, ctm = t["ct4"][0].numpy(), t["ctm"][0].numpy()
    f = np.float32
    g32, c32, m32 = grid_v.astype(f), ct4.astype(f), ctm.astype(f)
    v32, A32 = v.astype(f), aff.astype(f)
    pm, dx = f(sim.p_mass), f(sim.dx)

    def g2p_terms(cell, W, dW, dpos):
        Wg = W[:, None] * g32[cell]
        return np.concatenate([Wg, (Wg[:, :, None] * dpos[:, None, :]).reshape(-1, 9)], axis=1)

    sums = _stencil_sums(scene, x, g2p_terms, 12)
    new_v, new_C, _ = cuda_transfer.g2p_plain(scene, *map(torch.tensor, (x, grid_v)))
    _close(sums[:, :3], new_v, F32_TOL)
    _close(f(4 * sim.inv_dx) * sums[:, 3:].reshape(-1, 3, 3), new_C, F32_TOL)

    def p2g_bwd_terms(cell, W, dW, dpos):
        cs, cm = c32[cell, :3], c32[cell, 3]
        mom = pm * v32 + dx * np.einsum("nij,nj->ni", A32, dpos)
        S = pm * cm + np.sum(mom * cs, axis=1)
        gpx = dW * S[:, None] - W[:, None] * dx * np.einsum("ni,nid->nd", cs, A32)
        gv = W[:, None] * pm * cs
        gA = (W[:, None, None] * dx * dpos[:, None, :] * cs[:, :, None]).reshape(-1, 9)
        return np.concatenate([gpx, gv, gA], axis=1)

    sums = _stencil_sums(scene, x, p2g_bwd_terms, 15)
    want = _vjp(lambda a, b, c: cuda_transfer.p2g_plain(scene, a, b, c),
                list(map(torch.tensor, (x, v, aff))), [torch.tensor(ct4)])
    _close(f(sim.inv_dx) * sums[:, :3], want[0], F32_TOL)
    _close(sums[:, 3:6], want[1], F32_TOL)
    _close(sums[:, 6:].reshape(-1, 3, 3), want[2], F32_TOL)

    sums = _stencil_sums(scene, x, lambda cell, W, dW, dpos: dW * (pm * m32[cell])[:, None], 3,
                         planes=False)
    (want,) = _vjp(lambda a: cuda_transfer.grid_mass_plain(scene, a), [torch.tensor(x)],
                   [torch.tensor(ctm)])
    _close(f(sim.inv_dx) * sums, want, F32_TOL)
