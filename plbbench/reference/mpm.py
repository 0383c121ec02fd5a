"""Plain PyTorch MLS-MPM env step, loss and state observation: the yardstick.

Written from PlasticineLab's formulas (plb/engine/mpm_simulator.py p2g
:157-184, grid_op :189-221, g2p :223-243, substep :245-257, step :365-376;
von Mises :124-141; primitive contact plb/engine/primitive/primive_base.py
:82-115, kinematics :117-121 and set_velocity :184-192, the shapes' own in
`shapes/`; losses plb/engine/losses/loss.py:112-254; observation
plb/envs/env.py:33-41), with the two conventions that the configuration
states beside them: the stencil's base cell is clamped to [0, G-3] with the
weights from the unclamped fraction, and grid velocities are clamped to
`grid_v_clamp` dx / dt where that is set.

Every function takes a block of b envs with a leading b and computes in the
dtype of its inputs; the SVD, which PyTorch offers in float32 and float64
only, runs in float32 for lower dtypes and its factors are cast back. No
kernel of the program, no sort and no cache: scatters are `index_add_`
into one flat (b G^3, 4) grid.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .quat import conj, qmul, qrot, w2quat
from .shapes import has_gap, shape_module

TAPS = torch.tensor([(a, b, c) for a in range(3) for b in range(3) for c in range(3)])


class State(NamedTuple):
    x: torch.Tensor     # (b, n, 3)
    v: torch.Tensor     # (b, n, 3)
    C: torch.Tensor     # (b, n, 3, 3)
    F: torch.Tensor     # (b, n, 3, 3)
    pos: torch.Tensor   # (b, k, 3)
    rot: torch.Tensor   # (b, k, 4)
    gap: torch.Tensor   # (b, k)


def det3(m):
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]))


def _sym_eig(A, sweeps):
    """Eigenvalues (m, 3) and eigenvectors (columns of (m, 3, 3)) of the
    symmetric A (m, 3, 3) by cyclic Jacobi rotations (Numerical Recipes'
    `jacobi`), each entry its own tensor of the m matrices."""
    a = {(i, j): A[:, i, j] for i in range(3) for j in range(i, 3)}
    one, zero = torch.ones_like(a[0, 0]), torch.zeros_like(a[0, 0])
    V = {(i, j): one if i == j else zero for i in range(3) for j in range(3)}

    def at(i, j):
        return a[min(i, j), max(i, j)]

    for _ in range(sweeps):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            r = 3 - p - q
            apq = at(p, q)
            live = apq != 0
            safe = torch.where(live, apq, one)
            tau = (at(q, q) - at(p, p)) / (2.0 * safe)
            t = torch.where(tau >= 0, one, -one) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
            t = torch.where(live, t, zero)
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = t * c
            arp, arq = at(r, p), at(r, q)
            a[p, p], a[q, q] = at(p, p) - t * apq, at(q, q) + t * apq
            a[min(p, q), max(p, q)] = zero
            a[min(r, p), max(r, p)] = c * arp - s * arq
            a[min(r, q), max(r, q)] = s * arp + c * arq
            for i in range(3):
                vp, vq = V[i, p], V[i, q]
                V[i, p], V[i, q] = c * vp - s * vq, s * vp + c * vq
    lam = torch.stack([a[0, 0], a[1, 1], a[2, 2]], -1)
    vecs = torch.stack([torch.stack([V[i, j] for j in range(3)], -1) for i in range(3)], -2)
    return lam, vecs


def svd_proper(F, sweeps: int = 6):
    """F = U diag(s) V^T with det U = det V = +1, the sign on the smallest
    singular value (Taichi's convention, which von Mises' clamp sees): V
    from the eigenvectors of F^T F, u0 and u1 from F V, u2 = u0 x u1. Runs
    in float32 for dtypes below it, and the factors are cast back.

    A particle squeezed flat or to a point has an F of rank 1 or 0: where
    s1 is under sqrt(eps) s0, s1^2 is lost in the rounding of s0^2 and F v1
    / s1 is 0 / 0 or noise, so u1 (and where s0 is 0, u0 = v0) completes U
    to a rotation, as Taichi's SVD returns one for any F."""
    work = F if F.dtype in (torch.float32, torch.float64) else F.float()
    shape = work.shape
    Fm = work.reshape(-1, 3, 3)
    lam, V = _sym_eig(Fm.transpose(-1, -2) @ Fm, sweeps)
    lam, order = torch.sort(lam, dim=-1, descending=True)
    V = torch.gather(V, 2, order[:, None, :].expand(-1, 3, 3))
    V[:, :, 2] = torch.where((det3(V) < 0)[:, None], -V[:, :, 2], V[:, :, 2])
    FV = Fm @ V
    sig = torch.sqrt(torch.clamp(lam, min=0.0))
    u0 = FV[:, :, 0] / sig[:, 0:1]
    u1 = FV[:, :, 1] / sig[:, 1:2]
    flat = sig[:, 1] <= sig[:, 0] * torch.finfo(work.dtype).eps ** 0.5
    if bool(flat.any()):
        u0 = torch.where((sig[:, 0] > 0)[:, None], u0, V[:, :, 0])
        e = torch.eye(3, dtype=work.dtype, device=work.device)
        axis = torch.where((u0[:, 0].abs() < 0.9)[:, None], e[0], e[1])
        w = axis - (axis * u0).sum(-1, keepdim=True) * u0
        u1 = torch.where(flat[:, None], w / w.norm(dim=-1, keepdim=True), u1)
    u2 = torch.linalg.cross(u0, u1, dim=-1)
    s2 = (u2 * FV[:, :, 2]).sum(-1)
    U = torch.stack([u0, u1, u2], -1)
    s = torch.stack([sig[:, 0], sig[:, 1], s2], -1)
    return (U.reshape(shape).to(F.dtype), s.reshape(shape[:-1]).to(F.dtype),
            V.reshape(shape).to(F.dtype))


def stress_affine(sc, C, F):
    """-> (new F, APIC affine), (..., 3, 3) each."""
    eye = torch.eye(3, dtype=F.dtype, device=F.device)
    F_tmp = (eye + sc.dt * C) @ F
    U, s, V = svd_proper(F_tmp)
    eps = torch.log(torch.clamp(s, min=0.05))
    eps_hat = eps - eps.mean(-1, keepdim=True)
    norm = torch.sqrt((eps_hat * eps_hat).sum(-1) + 1e-8)
    dgamma = norm - sc.yield_stress / (2.0 * sc.mu)
    proj = eps - (dgamma / norm)[..., None] * eps_hat
    F_proj = U @ torch.diag_embed(torch.exp(proj)) @ V.transpose(-1, -2)
    new_F = torch.where((dgamma > 0)[..., None, None], F_proj, F_tmp)
    J = det3(new_F)
    R = U @ V.transpose(-1, -2)
    stress = (2.0 * sc.mu * (new_F - R) @ new_F.transpose(-1, -2)
              + eye * (sc.lam * J * (J - 1.0))[..., None, None])
    coeff = -sc.dt * sc.p_vol * 4 * sc.inv_dx * sc.inv_dx
    return new_F, coeff * stress + sc.p_mass * C


def stencil(sc, x):
    """x (b, n, 3) -> (flat cell index into the (b G^3) grid (b, n, 27),
    weight (b, n, 27), cell - x in grid units (b, n, 27, 3))."""
    b, n, _ = x.shape
    G = sc.n_grid
    px = x * sc.inv_dx
    base = torch.floor(px - 0.5)
    fx = px - base
    w = torch.stack([0.5 * (1.5 - fx) ** 2, 0.75 - (fx - 1.0) ** 2, 0.5 * (fx - 0.5) ** 2],
                    dim=2)                                   # (b, n, tap, axis)
    taps = TAPS.to(x.device)
    cells = torch.clamp(base.long(), 0, G - 3)[:, :, None, :] + taps
    W = w[:, :, taps[:, 0], 0] * w[:, :, taps[:, 1], 1] * w[:, :, taps[:, 2], 2]
    env = torch.arange(b, device=x.device)[:, None, None] * G ** 3
    idx = env + (cells[..., 0] * G + cells[..., 1]) * G + cells[..., 2]
    return idx, W, cells.to(x.dtype) - px[:, :, None, :]


def p2g(sc, x, v, affine):
    """-> grid (b G^3, 4): momentum x, y, z and mass."""
    b = x.shape[0]
    idx, W, dpos = stencil(sc, x)
    mom = sc.p_mass * v[:, :, None, :] + sc.dx * torch.einsum("bnij,bnkj->bnki", affine, dpos)
    contrib = torch.cat([W[..., None] * mom, (W * sc.p_mass)[..., None]], dim=-1)
    grid = x.new_zeros((b * sc.n_grid ** 3, 4))
    return grid.index_add_(0, idx.reshape(-1), contrib.reshape(-1, 4))


def grid_mass(sc, x):
    """-> (b, G^3) mass of the particles x (b, n, 3)."""
    b = x.shape[0]
    idx, W, _ = stencil(sc, x)
    grid = x.new_zeros((b * sc.n_grid ** 3,))
    return grid.index_add_(0, idx.reshape(-1), (W * sc.p_mass).reshape(-1)).reshape(b, -1)


def collider_v(pos_f, rot_f, pos_f1, rot_f1, p, dt):
    new_p = qrot(rot_f1, qrot(conj(rot_f), p - pos_f)) + pos_f1
    return (new_p - p) / dt


def collide(sc, prim, pose_f, pose_f1, softness, gp, v):
    """Contact of one primitive with the grid velocities v at points gp
    (primive_base.py:91-115); pose_f (pos, rot, gap) and pose_f1 (pos,
    rot), and softness, per point."""
    shape = shape_module(prim.shape)
    (pf, rf, gf), (pf1, rf1) = pose_f, pose_f1
    dist = shape.sdf(prim.params, pf, rf, gp, gf)
    influence = torch.clamp(torch.exp(-dist * softness), max=1.0)
    cond = ((softness > 0) & (influence > 0.1)) | (dist <= 0)
    D = shape.normal(prim.params, pf, rf, gp, gf)
    cv = collider_v(pf, rf, pf1, rf1, gp, sc.dt)
    inp = v - cv
    nc = (inp * D).sum(-1)
    gvt = inp - torch.clamp(nc, max=0.0)[..., None] * D
    gvt_norm = torch.sqrt((gvt * gvt).sum(-1) + 1e-8)
    scale = torch.clamp(gvt_norm + nc * prim.friction, min=0.0)
    fric = gvt / gvt_norm[..., None] * scale[..., None]
    flag = (nc < 0) & (torch.sqrt((gvt * gvt).sum(-1)) > 1e-30)
    gvt = torch.where(flag[..., None], fric, gvt)
    new_v = cv + inp * (1.0 - influence[..., None]) + gvt * influence[..., None]
    return torch.where(cond[..., None], new_v, v)


def grid_op(sc, grid, pose_f, pose_f1, softness):
    """grid (b G^3, 4) -> grid velocities (b G^3, 3), computed at the cells
    with mass only; the others stay 0. pose_f is (pos, rot, gap) at the
    substep's start, pose_f1 (pos, rot) at its end, per env."""
    G = sc.n_grid
    dtype, dev = grid.dtype, grid.device
    cells = (grid[:, 3] > 1e-12).nonzero()[:, 0]
    g = grid[cells]
    v = g[:, :3] / g[:, 3:] + torch.tensor(sc.gravity, dtype=dtype, device=dev) * (sc.dt * 30.0)
    env, local = cells // G ** 3, cells % G ** 3
    coords = torch.stack([local // (G * G), (local // G) % G, local % G], dim=-1)
    coord_f = coords.to(dtype)
    gp = coord_f * sc.dx
    for i, prim in enumerate(sc.prims):
        v = collide(sc, prim, (pose_f[0][env, i], pose_f[1][env, i], pose_f[2][env, i]),
                    (pose_f1[0][env, i], pose_f1[1][env, i]), softness[env], gp, v)
    # walls 3 cells thick; on the floor (axis 1) Coulomb friction under a
    # ground friction below 10, a full stop at 10 or more
    gf = sc.ground_friction
    e_y = torch.tensor([0.0, 1.0, 0.0], dtype=dtype, device=dev)
    axis_y = e_y > 0
    for d in range(3):
        axis = torch.arange(3, device=dev) == d
        low = (coords[:, d] < 3) & (v[:, d] < 0)
        if d != 1 or gf == 0:
            v = torch.where(low[:, None] & axis, 0.0, v)
        elif gf < 10:
            lin = v[:, 1] + 1e-30
            vit = v - lin[:, None] * e_y - coord_f * 1e-30
            lit = torch.sqrt((vit * vit).sum(-1) + 1e-8)
            fv = torch.clamp(1.0 + gf * lin / lit, min=0.0)[:, None] * (vit + coord_f * 1e-30)
            v = torch.where(low[:, None], torch.where(axis_y, 0.0, fv), v)
        else:
            v = torch.where(low[:, None], 0.0, v)
        high = (coords[:, d] > G - 3) & (v[:, d] > 0)
        v = torch.where(high[:, None] & axis, 0.0, v)
    if sc.grid_v_clamp > 0:
        vmax = sc.grid_v_clamp * sc.dx / sc.dt
        v = torch.clamp(v, -vmax, vmax)
    out = grid.new_zeros((grid.shape[0], 3))
    out[cells] = v
    return out


def g2p(sc, x, grid_v):
    """-> (new v, new C, new x) of the particles x (b, n, 3)."""
    idx, W, dpos = stencil(sc, x)
    g = grid_v[idx]                                          # (b, n, 27, 3)
    new_v = (W[..., None] * g).sum(2)
    new_C = (4.0 * sc.inv_dx) * torch.einsum("bnj,bnjs,bnja->bnsa", W, g, dpos)
    new_x = torch.clamp(x + sc.dt * new_v, 0.0, 1.0 - 3 * sc.dx)
    return new_v, new_C, new_x


def controls(sc, actions):
    """Actions (b, action_dim) -> per-substep (v (b, k, 3), w (b, k, 3),
    gap_vel (b, k)): of each primitive's slice a scaled over the substeps,
    v from a[0:3], w from a[3:6], and for a shape with a gap its velocity
    from a[6] (Chopsticks' set_velocity, primitives.py:101-109); 0 where
    absent."""
    a = torch.clamp(actions, -1.0, 1.0)
    vs, ws, gs, off = [], [], [], 0
    for prim in sc.prims:
        zero = a.new_zeros(a.shape[0], 3)
        no_gap = a.new_zeros(a.shape[0])
        if prim.action_dim == 0:
            vs.append(zero)
            ws.append(zero)
            gs.append(no_gap)
            continue
        scale = torch.tensor(prim.action_scale, dtype=a.dtype, device=a.device)
        part = a[:, off:off + prim.action_dim] * scale / sc.substeps
        vs.append(part[:, :3])
        ws.append(part[:, 3:6] if prim.action_dim > 3 else zero)
        gs.append(part[:, 6] if has_gap(prim.shape) else no_gap)
        off += prim.action_dim
    return torch.stack(vs, 1), torch.stack(ws, 1), torch.stack(gs, 1)


def fk(sc, pos, rot, gap, v, w, gap_vel):
    """Poses (pos (b, k, 3), rot (b, k, 4), gap (b, k)) at the next substep:
    each primitive by its shape's own kinematics (`fk` of its module) or by
    the base rule (primive_base.py:117-121: pos + v, w2quat(w) rot, the gap
    kept), the position clamped to the primitive's bounds."""
    lo = torch.tensor([p.lower for p in sc.prims], dtype=pos.dtype, device=pos.device)
    hi = torch.tensor([p.upper for p in sc.prims], dtype=pos.dtype, device=pos.device)
    pos1, rot1, gap1 = pos + v, qmul(w2quat(w), rot), gap
    shapes = [shape_module(p.shape) for p in sc.prims]
    own = [i for i, shape in enumerate(shapes) if hasattr(shape, "fk")]
    if own:
        pos1, rot1, gap1 = (list(t.unbind(1)) for t in (pos1, rot1, gap1))
        for i in own:
            pos1[i], rot1[i], gap1[i] = shapes[i].fk(sc.prims[i].params, pos[:, i], rot[:, i],
                                                     gap[:, i], v[:, i], w[:, i], gap_vel[:, i])
        pos1, rot1, gap1 = (torch.stack(t, 1) for t in (pos1, rot1, gap1))
    return torch.maximum(torch.minimum(pos1, hi), lo), rot1, gap1


def substep(sc, st: State, ctrl, softness) -> State:
    b, n = st.x.shape[:2]
    new_F, affine = stress_affine(sc, st.C, st.F)
    grid = p2g(sc, st.x, st.v, affine)
    pos1, rot1, gap1 = fk(sc, st.pos, st.rot, st.gap, *ctrl)
    grid_v = grid_op(sc, grid, (st.pos, st.rot, st.gap), (pos1, rot1), softness)
    v, C, x = g2p(sc, st.x, grid_v)
    return State(x, v, C, new_F, pos1, rot1, gap1)


def env_step(sc, st: State, actions, softness) -> State:
    """One env step: `substeps` substeps under the actions' velocities."""
    ctrl = controls(sc, actions)
    for _ in range(sc.substeps):
        st = substep(sc, st, ctrl, softness)
    return st


def iou(a, b):
    """Soft IoU over the last axis (loss.py:239-254)."""
    ma, mb = a.amax(-1), b.amax(-1)
    inter = (a * b).sum(-1) / ma / mb
    return inter / (a.sum(-1) / ma + b.sum(-1) / mb - inter)


def loss(sc, target, target_sdf, st: State):
    """-> (loss (b,), iou (b,)) of the states st (loss.py:186-208)."""
    gm = grid_mass(sc, st.x)
    density = (gm - target).abs().sum(-1)
    sdf_loss = (target_sdf * gm).sum(-1)
    contact = gm.new_zeros(gm.shape[0])
    for i, prim in enumerate(sc.prims):
        if prim.action_dim <= 0:
            continue
        d = torch.clamp(shape_module(prim.shape).sdf(prim.params, st.pos[:, i, None],
                                                     st.rot[:, i, None], st.x,
                                                     st.gap[:, i, None]), min=0.0)
        if sc.soft_contact:
            w = 1.0 / (1.0 + d * d * 10000.0)
            d = (d * w).sum(-1) / w.sum(-1)
        else:
            d = d.amin(-1)
        contact = contact + d * d
    total = sc.weight_contact * contact + sc.weight_density * density + sc.weight_sdf * sdf_loss
    return total, iou(gm, target)


def state_obs(sc, st: State):
    """(b, obs_dim): strided particles' x | v, then each primitive's pose."""
    step = st.x.shape[1] // sc.n_observed
    xv = torch.cat([st.x[:, ::step], st.v[:, ::step]], dim=-1).flatten(1)
    parts = [xv]
    for i, prim in enumerate(sc.prims):
        parts += [st.pos[:, i], st.rot[:, i]]
        if has_gap(prim.shape):
            parts.append(st.gap[:, i:i + 1])
    return torch.cat(parts, dim=-1)
