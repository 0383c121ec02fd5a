"""Port quaternion and primitive math against the TPU package's jnp
functions in float64: all 7 shapes' sdf, normal, contact response and
forward kinematics, at the cases of test_primitives.py / test_quat.py.
The shapes' constant vectors, cached on their device, give bit for bit the
values and gradients of constants built inline, in float32 and float64.

Tolerance 1e-10 (absolute, on O(1) quantities; the contact response is
held relative to its largest value): both sides evaluate the same float64
formulas, so they differ only by summation order (~1e-15)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plasticinelab_tpu.config import spec as jspec
from plasticinelab_tpu.engine import mpm as jmpm
from plasticinelab_tpu.engine import primitives as JP
from plasticinelab_tpu.engine import quat as jquat
from plasticinelab_tpu_torch.config import spec as tspec
from plasticinelab_tpu_torch.engine import mpm as tmpm
from plasticinelab_tpu_torch.engine import primitives as TP
from plasticinelab_tpu_torch.engine import quat as tquat

TOL = 1e-10
F64 = torch.float64

SHAPE_KW = [
    dict(shape="Sphere", radius=0.1),
    dict(shape="Capsule", h=0.06, r=0.03),
    dict(shape="RollingPin", h=0.2, r=0.02),
    dict(shape="Chopsticks", h=0.2, r=0.02, init_gap=0.06, action_dim=7,
         action_scale=(0.01,) * 7),
    dict(shape="Cylinder", h=0.2, r=0.1),
    dict(shape="Torus", tx=0.2, ty=0.1),
    dict(shape="Box", size=(0.1, 0.13, 0.08)),
]
IDS = [k["shape"] for k in SHAPE_KW]


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def _j(a):
    return jnp.asarray(np.asarray(a), dtype=jnp.float64)


def _rand_quat(rng, n=None):
    q = rng.standard_normal((4,) if n is None else (n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _pose(rng):
    return rng.random(3) * 0.5 + 0.25, _rand_quat(rng), 0.06


@pytest.mark.parametrize("kw", SHAPE_KW, ids=IDS)
def test_sdf_and_normal_match_reference(kw):
    tsp, jsp = tspec.PrimitiveSpec(**kw), jspec.PrimitiveSpec(**kw)
    rng = np.random.default_rng(len(kw["shape"]))
    for _ in range(4):
        pos, rot, gap = _pose(rng)
        p = pos + rng.standard_normal((64, 3)) * 0.15
        args_t = (_t(pos), _t(rot), _t(gap), _t(p))
        args_j = (_j(pos), _j(rot), _j(gap), _j(p))
        np.testing.assert_allclose(TP.sdf(tsp, *args_t).numpy(),
                                   np.asarray(JP.sdf(jsp, *args_j)), atol=TOL, rtol=0)
        np.testing.assert_allclose(TP.normal(tsp, *args_t).numpy(),
                                   np.asarray(JP.normal(jsp, *args_j)), atol=TOL, rtol=0)


@pytest.mark.parametrize("kw", SHAPE_KW, ids=IDS)
def test_collide_matches_reference(kw):
    tsp = tspec.PrimitiveSpec(friction=0.7, **kw)
    jsp = jspec.PrimitiveSpec(friction=0.7, **kw)
    rng = np.random.default_rng(10 + len(kw["shape"]))
    dt = 1e-4
    pos, rot, gap = _pose(rng)
    pos1 = pos + rng.standard_normal(3) * 1e-3
    rot1 = _rand_quat(rng) * 0.01 + rot
    rot1 /= np.linalg.norm(rot1)
    grid_pos = pos + rng.standard_normal((512, 3)) * 0.15
    v = rng.standard_normal((512, 3))
    out_t = TP.collide(tsp, _t(pos), _t(rot), _t(gap), _t(pos1), _t(rot1),
                       0.7, 666.0, _t(grid_pos), _t(v), dt).numpy()
    out_j = np.asarray(JP.collide(jsp, _j(pos), _j(rot), _j(gap), _j(pos1), _j(rot1),
                                  jnp.asarray(0.7), 666.0, _j(grid_pos), _j(v), dt))
    # the contact branch must be exercised, and the far field left alone
    touched = np.any(out_j != v, axis=-1)
    assert 0 < touched.sum() < len(v)
    np.testing.assert_allclose(out_t, out_j, atol=TOL * np.abs(out_j).max(), rtol=0)


@pytest.mark.parametrize("kw", SHAPE_KW, ids=IDS)
def test_forward_kinematics_matches_reference(kw):
    tsp, jsp = tspec.PrimitiveSpec(**kw), jspec.PrimitiveSpec(**kw)
    rng = np.random.default_rng(20 + len(kw["shape"]))
    pos, rot, gap = _pose(rng)
    v, w = rng.standard_normal(3) * 0.01, rng.standard_normal(3) * 0.01
    gv = 0.003
    out_t = TP.forward_kinematics(tsp, _t(pos), _t(rot), _t(gap), _t(v), _t(w), _t(gv))
    out_j = JP.forward_kinematics(jsp, _j(pos), _j(rot), _j(gap), _j(v), _j(w), _j(gv))
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=TOL, rtol=0)


def test_make_controls_matches_reference():
    kws = [SHAPE_KW[3], dict(shape="RollingPin", h=0.2, r=0.02, action_dim=3,
                             action_scale=(0.7, 0.005, 0.005)),
           dict(shape="Box", size=(0.1, 0.1, 0.1), action_dim=6,
                action_scale=(0.01,) * 3 + (0.015,) * 3),
           dict(shape="Sphere", radius=0.1)]
    sim = dict(quality=0.25, n_particles=10, dtype="float64")
    tsc = tspec.SceneSpec(simulator=tspec.SimulatorSpec(**sim),
                          primitives=tuple(tspec.PrimitiveSpec(**k) for k in kws))
    jsc = jspec.SceneSpec(simulator=jspec.SimulatorSpec(**sim),
                          primitives=tuple(jspec.PrimitiveSpec(**k) for k in kws))
    action = np.random.default_rng(3).uniform(-1.5, 1.5, tsc.action_dim)
    ct = tmpm.make_controls(tsc, action, "cpu", F64)
    cj = jmpm.make_controls(jsc, _j(action), jnp.float64)
    for a, b in ((ct.v, cj.v), (ct.w, cj.w), (ct.gap_vel, cj.gap_vel)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-15, rtol=0)


def test_quaternions_match_reference():
    rng = np.random.default_rng(0)
    qa, qb = _rand_quat(rng, 16), _rand_quat(rng, 16)
    v, p = rng.standard_normal((16, 3)), rng.standard_normal((16, 3))
    pairs = [
        (tquat.qrot(_t(qa), _t(v)), jquat.qrot(_j(qa), _j(v))),
        (tquat.qmul(_t(qa), _t(qb)), jquat.qmul(_j(qa), _j(qb))),
        (tquat.quat_conj(_t(qa)), jquat.quat_conj(_j(qa))),
        (tquat.inv_trans(_t(v), _t(p), _t(qa)), jquat.inv_trans(_j(v), _j(p), _j(qa))),
        (tquat.length(_t(v)), jquat.length(_j(v))),
    ]
    axis = np.array([1.0, 2.0, -0.5]) / np.linalg.norm([1.0, 2.0, -0.5])
    for angle in (0.0, 1e-10, 1e-6, 0.3, 2.0):
        pairs.append((tquat.w2quat(_t(axis * angle)), jquat.w2quat(_j(axis * angle))))
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-12, rtol=0)


@pytest.mark.parametrize("kw", SHAPE_KW, ids=IDS)
def test_bounding_radius_matches_reference(kw):
    tsp, jsp = tspec.PrimitiveSpec(**kw), jspec.PrimitiveSpec(**kw)
    np.testing.assert_allclose(TP.bounding_radius(tsp, 0.06),
                               float(JP.bounding_radius(jsp, jnp.asarray(0.06))),
                               rtol=1e-6)


def _inline_const(like, *vals):
    return torch.tensor(vals, dtype=like.dtype, device=like.device)


def _actuated(kw):
    """The shape of `kw` with an action and bounds that clamp some poses."""
    extra = dict(lower_bound=(0.4, 0.0, 0.3), upper_bound=(0.6, 1.0, 0.7))
    if kw["shape"] == "RollingPin":
        extra.update(action_dim=3, action_scale=(0.7, 0.005, 0.005))
    elif "action_dim" not in kw:
        extra.update(action_dim=6, action_scale=(0.01,) * 3 + (0.015,) * 3)
    return tspec.PrimitiveSpec(**kw, **extra)


def _fk_sdf_normal(sp, dtype):
    """action -> velocities -> forward kinematics -> sdf, normal at points
    around the new poses, at 16 envs, with the gradients of a weighted sum
    to pos, rot, gap, v, w and the action."""
    rng = np.random.default_rng(30 + len(sp.shape))
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype, requires_grad=True)
    pos = t(rng.random((16, 3)) * 0.5 + 0.25)
    rot = t(_rand_quat(rng, 16))
    gap = t(np.full(16, 0.06))
    action = t(rng.uniform(-20.0, 20.0, (16, sp.action_dim)))
    v, w, gap_vel = TP.action_to_velocity(sp, action, 19)
    new = TP.forward_kinematics(sp, pos, rot, gap, v, w, gap_vel)
    p = new[0][:, None].detach() + torch.tensor(rng.standard_normal((16, 32, 3)) * 0.15,
                                                dtype=dtype)
    pose = (new[0][:, None], new[1][:, None], new[2][:, None])
    outs = (v, w, gap_vel) + new + (TP.sdf(sp, *pose, p), TP.normal(sp, *pose, p))
    loss = sum((o * torch.tensor(rng.standard_normal(o.shape), dtype=dtype)).sum()
               for o in outs)
    ins = (pos, rot, gap, v, w, action)     # w is a constant zero below 6 actions
    found = iter(torch.autograd.grad(loss, [x for x in ins if x.requires_grad],
                                     allow_unused=True))
    return [o.detach() for o in outs], [next(found) if x.requires_grad else None for x in ins]


@pytest.mark.parametrize("dtype", [torch.float32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("kw", SHAPE_KW, ids=IDS)
def test_cached_constants_are_the_inline_ones(kw, dtype, monkeypatch):
    sp = _actuated(kw)
    _fk_sdf_normal(sp, dtype)                       # builds what the cache lacks
    built = TP.counts["consts_built"]
    reused = TP.counts["consts_reused"]
    outs, grads = _fk_sdf_normal(sp, dtype)
    assert TP.counts["consts_built"] == built and TP.counts["consts_reused"] > reused
    monkeypatch.setattr(TP, "_const", _inline_const)
    ref_outs, ref_grads = _fk_sdf_normal(sp, dtype)
    for a, b in zip(outs, ref_outs):
        assert a.dtype == dtype and torch.equal(a, b)
    for a, b in zip(grads, ref_grads):
        assert (a is None) == (b is None) and (a is None or torch.equal(a, b))
    assert grads[0] is not None and grads[-1] is not None


def test_constant_first_built_in_inference_mode_takes_a_gradient(monkeypatch):
    monkeypatch.setattr(TP, "_consts", {})
    sp = _actuated(SHAPE_KW[0])
    with torch.inference_mode():
        TP.action_to_velocity(sp, torch.ones(4, 6, dtype=F64), 19)
    scale = TP._const(torch.ones((), dtype=F64), *sp.action_scale)
    assert not scale.is_inference() and not scale.requires_grad
    action = torch.ones(4, 6, dtype=F64, requires_grad=True)
    v, w, _ = TP.action_to_velocity(sp, action, 19)
    (grad,) = torch.autograd.grad((v.sum() + w.sum()), action)
    assert torch.equal(grad, torch.ones_like(grad) / 19 * _inline_const(grad, *sp.action_scale))
