"""The K8 backward's pose-cotangent sum, on the CPU, where no kernel runs.

`csrc/gridop.cu` `grid_op_bwd_kernel` sums each primitive's 19 pose
cotangent terms per cell (pos_f 3, the renormalised conjugate of rot_f 4,
rot_f 4, gap_f 1, pos_f1 3, rot_f1 4; zero where a cell has no mass or no
contact) in one launch, in an order fixed by the grid alone:

- each warp packs its cells with mass, tile by tile in cell order, into
  passes of 32 lanes; per pass and primitive, where some lane is in
  contact (a ballot), a `__shfl_down_sync` tree (offsets 16, 8, 4, 2, 1)
  into lane 0, which adds it to the warp's slot (passes in order);
- per block of `BWD_BLOCK_CELLS` cells, where some warp added, its warps'
  slots in warp order into the block's row, and the block's flag;
- per env, the block that finishes last sums the flagged rows in block
  order and maps the conjugate's terms back to rot_f (`pose_row`).

A float32 numpy model of that order, on seeded per-cell terms: within
float32 rounding of the float64 sum, the same bits under any finish order
of the blocks and for one env alone or inside a batch of 8. Its per-cell
inputs, taken from the plain version's autograd with every pose term a
per-cell leaf, sum in float64 to the plain VJP's pose cotangents (which
`test_torch_grad_kernels_plain.py` holds to jax.vjp of the JAX grid_op_cm).
With the kernel library replaced by a recording fake: the wrapper hands the
kernel rows, flags and counters sized by the per-env block count, reuses them
across calls of one (device, B), and counts one launch per call.
"""
import os
import re

import numpy as np
import pytest
import torch

from plasticinelab_tpu_torch.engine import cuda_build, cuda_gridop
from plasticinelab_tpu_torch.engine import primitives as tprim
from plasticinelab_tpu_torch.engine import quat as tquat
from test_torch_kernels_plain import G, IDS, SHAPE_KW, _grid4, _poses, _scenes

KPG = cuda_gridop.POSE_COMPONENTS
WARP = 32
EPS32 = float(np.finfo(np.float32).eps)


def _src(name):
    with open(os.path.join(cuda_build.CSRC, name)) as f:
        return f.read()


def _const(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _launch_shape():
    """(cells per block, threads per block) of the backward launch."""
    threads = _const(_src("common.cuh"), "kThreads")
    return _const(_src("gridop.cu"), "kBwdTiles") * threads, threads


def _tree(x):
    """Lane 0's sum of a `__shfl_down_sync` tree over the 32 lanes of x
    (32, ...), float32."""
    x = x.copy()
    for h in (16, 8, 4, 2, 1):
        x[:h] = x[:h] + x[h:2 * h]
    return x[0]


def _block_rows(pg, hit, mass):
    """Per block of one env: (did it write a row, its row (k, 19)), float32.
    pg (cells, k, 19) float32, hit (cells, k) and mass (cells,) bool. Each
    warp packs its cells with mass, tile by tile in cell order, into passes
    of 32 lanes."""
    per, threads = _launch_shape()
    cells, k = hit.shape
    nb = -(-cells // per)
    wrote = np.zeros(nb, bool)
    row = np.zeros((nb, k, KPG), np.float32)
    lanes = np.arange(WARP)
    for b in range(nb):
        slot = np.zeros((threads // WARP, k, KPG), np.float32)
        for w in range(threads // WARP):
            own = np.concatenate([b * per + t * threads + w * WARP + lanes
                                  for t in range(per // threads)])
            own = own[own < cells]
            own = own[mass[own]]
            for p in range(0, len(own), WARP):
                x = np.zeros((WARP, k, KPG), np.float32)
                h = np.zeros((WARP, k), bool)
                x[:len(own[p:p + WARP])] = pg[own[p:p + WARP]]
                h[:len(own[p:p + WARP])] = hit[own[p:p + WARP]]
                tree = _tree(x)
                for i in range(k):
                    if h[:, i].any():  # a pass without contact adds nothing
                        slot[w, i] = slot[w, i] + tree[i]
                        wrote[b] = True
        for w in range(threads // WARP):  # warps in order
            row[b] = row[b] + slot[w]
    return wrote, row


def _finish(events, rows):
    """Runs the blocks' ends in the order `events` ((env, block) pairs): a
    block that contributed writes its row and flag, then counts itself; the
    env's last block sums the flagged rows in block order. -> totals (B, k,
    19) float32. rows: per env, `_block_rows`."""
    B = len(rows)
    nb = [len(r[0]) for r in rows]
    buf = [np.full_like(r[1], np.nan) for r in rows]  # rows never written read NaN
    flags = [np.zeros(n, bool) for n in nb]
    count = [0] * B
    totals = [None] * B
    for env, b in events:
        wrote, row = rows[env]
        if wrote[b]:
            buf[env][b] = row[b]
            flags[env][b] = True
        count[env] += 1
        if count[env] == nb[env]:
            tot = np.zeros(row.shape[1:], np.float32)
            for bb in range(nb[env]):
                if flags[env][bb]:
                    tot = tot + buf[env][bb]
            totals[env] = tot
    return np.stack(totals)


def _model(pg, hit, mass, rng=None):
    """The kernel's float32 pose-cotangent totals (B, k, 19) of per-cell
    terms pg (B, cells, k, 19) where hit (B, cells, k), cells with mass
    (B, cells); the blocks end in a random order across envs with rng, else
    in block order."""
    rows = [_block_rows(pg[b].astype(np.float32), hit[b], mass[b]) for b in range(len(pg))]
    events = [(env, b) for env, r in enumerate(rows) for b in range(len(r[0]))]
    if rng is not None:
        events = [events[i] for i in rng.permutation(len(events))]
    return _finish(events, rows)


def _pose_row(tot, q):
    """csrc/gridop.cu pose_row: the (16,) pose cotangent of one primitive
    from its 19 summed terms; rot_f takes the conjugate's terms through
    c = conj(q) / |q|."""
    nq = np.sqrt(np.sum(q * q))
    c = np.array([q[0], -q[1], -q[2], -q[3]]) / nq
    gc = tot[3:7]
    sign = np.array([1.0, -1.0, -1.0, -1.0])
    out = np.zeros(16)
    out[0:3], out[8:11], out[11:15], out[7] = tot[0:3], tot[12:15], tot[15:19], tot[11]
    out[3:7] = tot[7:11] + sign * (gc - c * np.dot(c, gc)) / nq
    return out


def _shell_terms(seed, B=1, Gm=32, k=2):
    """Seeded per-cell terms (B, Gm^3, k, 19) on a spherical cloud of mass,
    non-zero in a contact shell around each primitive, as the kernel sees
    them; the hit mask (B, Gm^3, k) and the mass mask (B, Gm^3)."""
    rng = np.random.default_rng(seed)
    r = (np.arange(Gm) + 0.5) / Gm
    p = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    pg = np.zeros((B, Gm ** 3, k, KPG))
    hit = np.zeros((B, Gm ** 3, k), bool)
    mass = np.zeros((B, Gm ** 3), bool)
    for b in range(B):
        mass[b] = np.linalg.norm(p - 0.5 - rng.uniform(-0.05, 0.05, 3), axis=1) < 0.3
        for i in range(k):
            c = 0.5 + rng.uniform(-0.15, 0.15, 3)
            d = np.linalg.norm(p - c, axis=1)
            hit[b, :, i] = mass[b] & (d < 0.12)
            pg[b, hit[b, :, i], i] = rng.standard_normal((int(hit[b, :, i].sum()), KPG)) * \
                np.exp(rng.uniform(-3, 3, KPG))
    return pg, hit, mass


def _rounding_bound(pg):
    """A float32 bound on |model - float64 sum| per component: the input's
    rounding plus that of a chain of (tree + passes + warps + blocks) adds."""
    per, threads = _launch_shape()
    depth = 5 + per // threads + threads // WARP + -(-pg.shape[1] // per)
    return (depth + 1) * EPS32 * np.abs(pg).sum(axis=1)


def test_model_sum_within_float32_rounding_of_float64():
    pg, hit, mass = _shell_terms(1, B=2)
    got = _model(pg, hit, mass).astype(np.float64)
    want = pg.sum(axis=1)
    assert np.all(np.abs(got - want) <= _rounding_bound(pg))
    assert np.abs(want).max() > 0 and hit.any(axis=1).all()


def test_model_sum_ignores_the_finish_order():
    """Which block ends last does not reach the result: the same bits for
    the blocks ending in block order and in random orders."""
    pg, hit, mass = _shell_terms(2, B=2)
    want = _model(pg, hit, mass)
    assert np.isfinite(want).all()  # no row the last block read was unwritten
    for seed in range(5):
        assert np.array_equal(_model(pg, hit, mass, np.random.default_rng(seed)), want)


def test_model_env_alone_equals_env_in_a_batch_of_8():
    """An env's sum is bit for bit the same alone (B = 1) and inside a batch
    of 8 whose blocks end interleaved across envs."""
    pg, hit, mass = _shell_terms(3, B=8)
    batch = _model(pg, hit, mass, np.random.default_rng(7))
    for b in range(8):
        assert np.array_equal(_model(pg[b:b + 1], hit[b:b + 1], mass[b:b + 1])[0], batch[b])


def test_model_without_contact_sums_zero():
    pg, hit, mass = _shell_terms(4)
    assert np.array_equal(_model(pg * 0, hit & False, mass), np.zeros((1, 2, KPG), np.float32))


# ---------------------------------------------------------------------------
# the per-cell terms, from the plain version
# ---------------------------------------------------------------------------

def _per_cell_terms(scene, g4, pose_f, pose_f1, ct, softness):
    """(cells, k, 19) float64: each cell's pose cotangent terms per
    primitive, from autograd of `grid_op_plain` with every pose term a leaf
    of its own per cell and the renormalised conjugate of rot_f a leaf apart
    from rot_f itself (as the kernel splits them)."""
    cells, k = g4.shape[0], len(scene.primitives)

    def leaves(a):
        return [torch.tensor(np.broadcast_to(a[i], (cells,) + a[i].shape).copy(),
                             requires_grad=True) for i in range(k)]

    pos_f, rot_f, gap_f = map(leaves, pose_f)
    pos_f1, rot_f1, _ = map(leaves, pose_f1)
    conj = [tquat.quat_conj(r).detach().requires_grad_(True) for r in rot_f]
    own = {id(r): c for r, c in zip(rot_f, conj)}
    orig = tquat.quat_conj

    def conj_of(q):
        return own[id(q)] if id(q) in own else orig(q)

    mp = pytest.MonkeyPatch()
    mp.setattr(tquat, "quat_conj", conj_of)
    mp.setattr(tprim, "quat_conj", conj_of)
    try:
        out = cuda_gridop.grid_op_plain(scene, torch.tensor(g4), (pos_f, rot_f, gap_f),
                                        (pos_f1, rot_f1, [None] * k), softness)
    finally:
        mp.undo()
    ins = [t for i in range(k) for t in (pos_f[i], conj[i], rot_f[i], gap_f[i], pos_f1[i],
                                           rot_f1[i])]
    grads = torch.autograd.grad((out * torch.tensor(ct)).sum(), ins, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for g, t in zip(grads, ins)]
    per = [torch.cat([g.reshape(cells, -1) for g in grads[6 * i:6 * i + 6]], dim=1)
           for i in range(k)]
    return torch.stack(per, dim=1).numpy()


def _plain_pose_vjp(scene, g4, pose_f, pose_f1, ct, softness):
    """(k, 16) pose cotangents of the plain version, as `pack_poses` lays
    them out (gap_f1 zero)."""
    ins = [torch.tensor(a, requires_grad=True) for a in (*pose_f, *pose_f1)]
    out = cuda_gridop.grid_op_plain(scene, torch.tensor(g4), tuple(ins[:3]), tuple(ins[3:]),
                                    softness)
    grads = torch.autograd.grad((out * torch.tensor(ct)).sum(), ins, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for g, t in zip(grads, ins)]
    return cuda_gridop.pack_poses(grads[:3], grads[3:]).numpy()


@pytest.mark.parametrize("kw", SHAPE_KW, ids=IDS)
def test_per_cell_terms_sum_to_the_plain_vjp(kw):
    """Per primitive shape: the per-cell terms are zero where a cell has no
    mass; summed in float64 and mapped as `pose_row` maps them they are the
    plain VJP's pose cotangents; the model sums them within float32
    rounding."""
    scene, _ = _scenes("float64", prims=[kw])
    g4 = _grid4(20, np.float64)
    pose_f, pose_f1 = _poses(21, 1, np.float64)
    ct = np.random.default_rng(22).standard_normal((G ** 3, 3))
    pg = _per_cell_terms(scene, g4, pose_f, pose_f1, ct, 666.0)
    assert np.all(pg[g4[:, 3] <= 1e-12] == 0)
    hit = (pg != 0).any(axis=2)
    assert 0 < hit.sum() < (g4[:, 3] > 1e-12).sum()  # some cells with mass out of contact
    want = _plain_pose_vjp(scene, g4, pose_f, pose_f1, ct, 666.0)
    got = _pose_row(pg.sum(axis=0)[0], pose_f[1][0])
    np.testing.assert_allclose(got, want[0], rtol=0, atol=1e-12 * np.abs(want).max())
    model = _model(pg[None], hit[None], g4[None, :, 3] > 1e-12)[0].astype(np.float64)
    assert np.all(np.abs(model - pg.sum(axis=0)) <= _rounding_bound(pg[None])[0])


# ---------------------------------------------------------------------------
# the wrapper, with a recording fake of the kernel library
# ---------------------------------------------------------------------------

class _Recorder:
    """A stand-in for the kernel library: records each call of an entry
    point and returns 0 (no error)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.fixture
def fake_library(monkeypatch):
    lib = _Recorder()
    monkeypatch.setattr(cuda_build, "library", lambda: lib)
    monkeypatch.setattr(cuda_build, "require_kernel_input", lambda t, name: None)
    monkeypatch.setattr(cuda_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(cuda_gridop, "_scratch", {})
    cuda_gridop.reset_launches()
    yield lib
    cuda_gridop.reset_launches()


def _bwd_inputs(B, k=2):
    scene, _ = _scenes("float32", prims=SHAPE_KW[:k])
    lead = () if B is None else (B,)
    rng = np.random.default_rng(23)
    t = lambda *s: torch.tensor(rng.standard_normal(lead + s).astype(np.float32))  # noqa: E731
    return scene, t(G ** 3, 4), t(k, 16), torch.full(lead or (1,), 666.0), t(G ** 3, 3)


@pytest.mark.parametrize("B", [None, 1, 8], ids=["one env", "B=1", "B=8"])
def test_bwd_scratch_sized_by_the_per_env_block_count(fake_library, B):
    scene, g4, poses, soft, ct = _bwd_inputs(B)
    cuda_gridop.grid_op_bwd(scene, g4, poses, soft, ct)
    ((name, args),) = fake_library.calls
    assert name == "plb_grid_op_bwd"
    assert len(args) == len(cuda_build._SIGNATURES[name])
    nb = -(-G ** 3 // cuda_gridop.BWD_BLOCK_CELLS)
    assert cuda_gridop.bwd_blocks(G) == nb
    ((key, (partials, done)),) = cuda_gridop._scratch.items()
    n = B or 1
    assert partials.shape == (n, nb, 2, KPG) and partials.dtype == torch.float32
    assert done.shape == (n, nb + 1) and done.dtype == torch.int32
    assert not done.any()  # the flags and counters start zero
    assert args[6] == partials.data_ptr() and args[7] == done.data_ptr() and args[9] == n


def test_bwd_scratch_reused_across_calls_of_one_device_and_B(fake_library):
    calls = {}
    for B in (None, 8, None, 8, 4):
        scene, g4, poses, soft, ct = _bwd_inputs(B)
        cuda_gridop.grid_op_bwd(scene, g4, poses, soft, ct)
        args = fake_library.calls[-1][1]
        calls.setdefault(B or 1, set()).add((args[6], args[7]))
    assert all(len(ptrs) == 1 for ptrs in calls.values())
    assert len({p for ptrs in calls.values() for p in ptrs}) == 3
    assert len(cuda_gridop._scratch) == 3


def test_bwd_scratch_not_shared_across_streams(fake_library, monkeypatch):
    """Launches on two streams may overlap: each stream has its own rows,
    flags and counter, and passes its own stream to the launch."""
    scene, g4, poses, soft, ct = _bwd_inputs(8)
    seen = {}
    for stream in (7, 9, 7, 9):
        monkeypatch.setattr(cuda_build, "stream_of", lambda t, s=stream: s)
        cuda_gridop.grid_op_bwd(scene, g4, poses, soft, ct)
        args = fake_library.calls[-1][1]
        assert args[-1] == stream
        seen.setdefault(stream, set()).add((args[6], args[7]))
    assert all(len(ptrs) == 1 for ptrs in seen.values())
    assert seen[7] != seen[9]
    assert len(cuda_gridop._scratch) == 2


def test_one_launch_counted_per_call(fake_library):
    for B, key in ((None, "grid_op_bwd"), (8, "grid_op_bwd_batched"), (1, "grid_op_bwd_batched")):
        scene, g4, poses, soft, ct = _bwd_inputs(B)
        before = dict(cuda_gridop.launches)
        cuda_gridop.grid_op_bwd(scene, g4, poses, soft, ct)
        cuda_gridop._launch_fwd(scene, g4, poses, soft)
        after = cuda_gridop.launches
        fwd = key.replace("_bwd", "")
        assert {k: after[k] - before[k] for k in after} == {
            k: int(k in (key, fwd)) for k in after}
    assert [name for name, _ in fake_library.calls] == ["plb_grid_op_bwd", "plb_grid_op"] * 3


def test_grid4_must_start_on_16_bytes(fake_library):
    """The kernels read each cell as one 16-byte load."""
    scene, g4, poses, soft, ct = _bwd_inputs(None)
    shifted = torch.zeros(G ** 3 * 4 + 1)[1:].view(G ** 3, 4)
    with pytest.raises(ValueError, match="16 bytes"):
        cuda_gridop.grid_op_bwd(scene, shifted, poses, soft, ct)
    with pytest.raises(ValueError, match="16 bytes"):
        cuda_gridop._launch_fwd(scene, shifted, poses, soft)
    assert fake_library.calls == []


def test_launch_constants_match_the_source():
    """The wrapper's per-block cell count and term count are the kernel's;
    its flag words fit the last block's copy up to G = 128; whole warps."""
    src = _src("gridop.cu")
    per, threads = _launch_shape()
    assert cuda_gridop.BWD_BLOCK_CELLS == per
    assert cuda_gridop.POSE_COMPONENTS == _const(src, "kPG")
    assert threads % WARP == 0 and per % threads == 0
    assert -(-cuda_gridop.bwd_blocks(128) // 32) <= _const(src, "kMaxFlagWords")
