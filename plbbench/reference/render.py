"""Plain PyTorch observation renderer of B envs: the yardstick of rgb frames.

Written from PlasticineLab's renderer (plb/engine/renderer/renderer.py,
renderer_utils.py) as the observation path configures it: the particles
voxelized into a bit-packed distance|colour min volume, smoothed twice
with a 27-tap box filter, a path tracer over the background and ground
planes, the primitives (sphere traced) and the plasticine (the smoothed
field marched at fixed steps, the crossing refined), `max_ray_depth`
diffuse bounces with the optional directional light and its shadow test,
then vignette and exposure. The observation frames keep the frame
volume's physical coverage at half its voxels (voxel_res / 2, dx x 2,
bake_size / 2) and show no goal ghost. The volume's particle reach is the
offset cube (-bake - 1 .. bake) culled to the saturation radius, the
program's stated convention.

Everything runs in the dtype of the renderer over plain tensors; the march
samples the texture at every `H_STEP` along the ray from its entry into
the volume, with no skipping. Random numbers come from `uniform(shape)`,
asked for in the renderer's documented order and shapes, so that a run's
recorded draws can be replayed: per frame pass the pixel jitter x and y
(B S, W, H), then per bounce the hemisphere's phi and r (R,), the glossy
sphere's u and v (R,) and with the light its noise (R, 3).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as Fn

from .shapes import shape_module

FOV = 0.23
DIST_LIMIT = 100.0
INF = 1e10
EXPOSURE = 1.5
H_STEP = 0.01            # the march's step, world units
REFINE = 8               # samples that localise a crossing inside one step
CHECK_EVERY = 16         # march steps between asks whether a ray is still going


def _norm(x, keepdim=False):
    return torch.sqrt((x * x).sum(-1, keepdim=keepdim))


def _normalize(x):
    return x / _norm(x, True)


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def smooth27(vol):
    """27-tap mean per env of vol (b, X, Y, Z), zero padded; border cells 1."""
    _, X, Y, Z = vol.shape
    p = Fn.pad(vol, (1, 1, 1, 1, 1, 1))
    out = sum(p[:, i:i + X, j:j + Y, k:k + Z]
              for i in range(3) for j in range(3) for k in range(3)) / 27.0
    out[:, 0], out[:, -1] = 1.0, 1.0
    out[:, :, 0], out[:, :, -1] = 1.0, 1.0
    out[..., 0], out[..., -1] = 1.0, 1.0
    return out


class Replay:
    """`uniform(shape)` that hands out the envs `envs` (indices) of recorded
    draws of B envs (each draw env-major)."""

    def __init__(self, draws, B: int, envs, device, dtype):
        self.it = iter(draws)
        self.B, self.envs, self.device, self.dtype = B, envs, device, dtype

    def __call__(self, shape):
        a = next(self.it)
        b = len(self.envs)
        part = a.reshape(self.B, -1)[self.envs]
        part = part.reshape((b * a.shape[0] // self.B,) + tuple(a.shape[1:]))
        if tuple(part.shape) != tuple(shape):
            raise ValueError(f"recorded draw {tuple(part.shape)} for {tuple(shape)}")
        return part.to(self.device, self.dtype)


class ObsRenderer:
    def __init__(self, sc, goal, res: int, spp: int, device, dtype):
        r = sc.renderer
        self.sc, self.device, self.dtype = sc, device, dtype
        self.res, self.spp = res, spp
        self.voxel_res = tuple(max(int(v) // 2, 1) for v in r.get("voxel_res", (168,) * 3))
        self.dx = float(r.get("dx", 1.0 / 150)) * 2.0
        self.bake = max(int(r.get("bake_size", 6)) // 2, 1)
        self.threshold = float(r.get("sdf_threshold", 0.37 * 0.56))
        self.depth = int(r.get("max_ray_depth", 2))
        self.light = bool(r.get("use_directional_light", False))
        self.light_dir = tuple(r.get("light_direction", (2.0, 1.0, 0.7)))
        self.camera_pos = tuple(r.get("camera_pos", (0.5, 1.2, 4.0)))
        self.camera_rot = tuple(r.get("camera_rot", (0.2, 0.0)))
        self.dist_scale = 0.2 * self.dx * 150.0
        rng = range(-self.bake - 1, self.bake + 1)
        offs = torch.tensor([(i, j, k) for i in rng for j in rng for k in rng])
        cube = (offs - offs.clamp(0, 1)).double().norm(dim=1)
        self.offsets = offs[cube <= 1.0 / self.dist_scale].to(device)

    def _t(self, vals):
        return torch.tensor(vals, dtype=self.dtype, device=self.device)

    # -- the volume ----------------------------------------------------------
    def volume(self, x, color: int):
        """x (b, n, 3) -> (smoothed sdf (b, X, Y, Z), colour (b, X, Y, Z, 3),
        the volume's low corner (b, 3))."""
        b = x.shape[0]
        X, Y, Z = self.voxel_res
        lower = (torch.floor(x.amin(1) / self.dx) - 6.0) * self.dx
        p = (x - lower[:, None]) / self.dx
        vol = torch.full((b * X * Y * Z,), 0xFFFFFFFF, dtype=torch.int64, device=self.device)
        env = torch.arange(b, device=self.device)[:, None] * (X * Y * Z)
        base = p.floor().long()
        for off in self.offsets:
            idx = base + off
            ok = ((idx >= 0) & (idx < torch.tensor([X, Y, Z], device=self.device))).all(-1)
            dist = _norm(idx.to(self.dtype) - p)
            q = torch.clamp(dist * (255.0 * self.dist_scale), 0.0, 255.0).long()
            flat = (idx[..., 0] * Y + idx[..., 1]) * Z + idx[..., 2] + env
            vol.scatter_reduce_(0, flat[ok], ((q << 24) + color)[ok], reduce="amin")
        vol = vol.reshape(b, X, Y, Z)
        sdf = smooth27(smooth27(((vol >> 24) & 255).to(self.dtype) / 255.0))
        col = torch.stack([(vol >> 16) & 255, (vol >> 8) & 255, vol & 255], -1).to(self.dtype)
        return sdf, col / 255.0, lower

    # -- texture sampling ----------------------------------------------------
    def _corners(self, rel, env):
        """Edge-clamped trilinear corners of the points rel (texture coords)
        in env's volume -> (flat indices (R, 8), weights (R, 8), fractions)."""
        X, Y, Z = self.voxel_res
        size = torch.tensor([X, Y, Z], device=self.device)
        p = rel * size.to(self.dtype)
        base = torch.clamp(torch.minimum(p.long(), size - 1), min=0)
        f = p - base.to(self.dtype)
        idx, wts = [], []
        for i in (0, 1):
            for j in (0, 1):
                for k in (0, 1):
                    c = torch.minimum(base + torch.tensor([i, j, k], device=self.device),
                                      size - 1)
                    idx.append(((env * X + c[:, 0]) * Y + c[:, 1]) * Z + c[:, 2])
                    wts.append((f[:, 0] if i else 1 - f[:, 0]) * (f[:, 1] if j else 1 - f[:, 1])
                               * (f[:, 2] if k else 1 - f[:, 2]))
        return torch.stack(idx, -1), torch.stack(wts, -1), f

    def _field(self, tex, o, d, t, env):
        """Threshold-shifted field at o + t d, 0 outside the volume."""
        pos = o + d * t[:, None]
        rel = (pos - tex["lo"][env]) / tex["span"]
        inside = (rel.amin(-1) >= 0) & (rel.amax(-1) <= 1)
        idx, w, _ = self._corners(rel, env)
        val = (tex["sdf"][idx] * w).sum(-1) - self.threshold
        return torch.where(inside, val, torch.zeros_like(val))

    def _normal(self, tex, pos, env):
        """Normalised gradient of the trilinear field."""
        rel = (pos - tex["lo"][env]) / tex["span"]
        idx, _, f = self._corners(rel, env)
        v = tex["sdf"][idx]
        g = []
        for a in range(3):
            w = torch.ones_like(v)
            for c in range(8):
                bits = ((c >> 2) & 1, (c >> 1) & 1, c & 1)
                for ax in range(3):
                    fa = f[:, ax]
                    if ax == a:
                        w[:, c] = w[:, c] * (1.0 if bits[ax] else -1.0)
                    else:
                        w[:, c] = w[:, c] * (fa if bits[ax] else 1 - fa)
            g.append((v * w).sum(-1))
        g = torch.stack(g, -1)
        return g / (_norm(g, True) + 1e-12)

    def _color(self, tex, pos, env):
        rel = (pos - tex["lo"][env]) / tex["span"]
        idx, w, _ = self._corners(rel, env)
        return (tex["col"][idx] * w[..., None]).sum(1)

    # -- ray casts -----------------------------------------------------------
    def _box(self, lo, hi, o, d):
        safe = torch.where(d == 0, torch.full_like(d, 1e-30), d)
        i1, i2 = (lo - o) / safe, (hi - o) / safe
        near = torch.minimum(i1, i2).amax(-1)
        far = torch.maximum(i1, i2).amin(-1)
        inside0 = ((d != 0) | ((o >= lo) & (o <= hi))).all(-1)
        return (near <= far) & inside0, near, far

    def _march(self, tex, env, o, d, active, refine):
        """First crossing of the field along each active ray -> (hit, t)."""
        R = o.shape[0]
        hit = torch.zeros(R, dtype=torch.bool, device=self.device)
        thit = torch.full((R,), INF, dtype=self.dtype, device=self.device)
        lo = tex["lo"][env]
        isect, near, far = self._box(lo, lo + tex["span"], o, d)
        lanes = (isect & active).nonzero()[:, 0]
        if lanes.numel() == 0:
            return hit, thit
        oo, dd, ee, tfar = o[lanes], d[lanes], env[lanes], far[lanes]
        t = torch.clamp(near[lanes], min=0.0) + 1e-4
        going = torch.ones_like(t, dtype=torch.bool)
        found = torch.zeros_like(going)
        tf = torch.full_like(t, INF)
        step = 0
        while True:
            if step % CHECK_EVERY == 0 and not bool(going.any()):
                break
            s = self._field(tex, oo, dd, t, ee)
            now = going & (s < 0)
            tf = torch.where(now, t, tf)
            found = found | now
            t = torch.where(going & ~now, t + H_STEP, t)
            going = going & ~now & (t < tfar)
            step += 1
        if refine and bool(found.any()):
            k = found.nonzero()[:, 0]
            tf[k] = self._refine(tex, oo[k], dd[k], ee[k], tf[k])
        hit[lanes], thit[lanes] = found, tf
        return hit, thit

    def _refine(self, tex, o, d, env, t):
        """The crossing inside (t - H_STEP, t]: REFINE samples, then linear
        interpolation between the two that bracket it."""
        h = H_STEP / REFINE
        base = torch.clamp(t - H_STEP, min=0.0)
        ks = torch.arange(1, REFINE + 1, device=self.device, dtype=self.dtype)
        ts = base[:, None] + h * ks
        s = torch.stack([self._field(tex, o, d, ts[:, j], env) for j in range(REFINE)], 1)
        neg = s < 0
        first = torch.argmax(neg.to(torch.uint8), 1)
        s_hi = s.gather(1, first[:, None])[:, 0]
        s_lo = torch.where(first > 0, s.gather(1, (first - 1).clamp(min=0)[:, None])[:, 0],
                           torch.ones_like(s_hi))
        den = torch.where((s_lo - s_hi).abs() < 1e-12, torch.ones_like(s_hi), s_lo - s_hi)
        frac = torch.clamp(s_lo / den, 0.0, 1.0)
        return torch.where(neg.any(1), base + h * (first + 1).to(self.dtype) - h + h * frac, t)

    @staticmethod
    def _poses(tex, env):
        """(pos, rot, gap) of every primitive, per ray of the envs env."""
        return tex["pos"][env], tex["rot"][env], tex["gap"][env]

    def _prim_sdf(self, poses, p):
        pos, rot, gap = poses
        vals = [shape_module(pr.shape).sdf(pr.params, pos[:, i], rot[:, i], p, gap[:, i])
                for i, pr in enumerate(self.sc.prims)]
        return torch.stack(vals, -1).min(-1)

    def _sphere_trace(self, poses, o, d, alive):
        """Sphere trace from the first bounding sphere entry, <= 200 steps ->
        (t, id of the nearest primitive at the last step); poses (pos, rot,
        gap) per ray."""
        pos, _, gap = poses
        R = o.shape[0]
        t = torch.full((R,), INF, dtype=self.dtype, device=self.device)
        for i, pr in enumerate(self.sc.prims):
            rad = shape_module(pr.shape).bounding_radius(pr.params, gap[:, i]) + 1e-3
            oc = o - pos[:, i]
            bb = (oc * d).sum(-1)
            c = (oc * oc).sum(-1) - rad * rad
            disc = bb * bb - c
            te = -bb - torch.sqrt(torch.clamp(disc, min=0.0))
            inside = c <= 0
            te = torch.where(inside, torch.zeros_like(te), te)
            t = torch.where(((disc > 0) & (te >= 0)) | inside, torch.minimum(t, te), t)
        ids = torch.zeros(R, dtype=torch.long, device=self.device)
        lanes = (alive & (t < DIST_LIMIT)).nonzero()[:, 0]
        if lanes.numel() == 0:
            return t, ids
        oo, dd, tt = o[lanes], d[lanes], t[lanes]
        pp = tuple(a[lanes] for a in poses)
        val = torch.full_like(tt, INF)
        sid = torch.zeros_like(lanes)
        going = torch.ones_like(tt, dtype=torch.bool)
        for j in range(200):
            if j % CHECK_EVERY == 0 and not bool(going.any()):
                break
            sv, si = self._prim_sdf(pp, oo + tt[:, None] * dd)
            val = torch.where(going, sv, val)
            sid = torch.where(going, si, sid)
            tt = torch.where(going, tt + sv, tt)
            going = going & (tt < DIST_LIMIT) & (val > 1e-8)
        t[lanes], ids[lanes] = tt, sid
        return t, ids

    def _planes(self, o, d):
        """Background plane z = -5.5 and ground y = -0.002 -> (t, normal,
        colour), INF where neither."""
        R = o.shape[0]
        closest = torch.full((R,), INF, dtype=self.dtype, device=self.device)
        normal = torch.zeros((R, 3), dtype=self.dtype, device=self.device)
        color = torch.zeros((R, 3), dtype=self.dtype, device=self.device)
        rc = -(o[:, 2] + 5.5) / torch.where(d[:, 2] == 0, torch.full_like(d[:, 2], 1e-30), d[:, 2])
        hit = (d[:, 2] != 0) & (rc > 0) & (rc < closest)
        closest = torch.where(hit, rc, closest)
        normal = torch.where(hit[:, None], self._t([0.0, 0.0, 1.0]), normal)
        color = torch.where(hit[:, None], self._t([0.6, 0.7, 0.7]), color)
        gd = (o[:, 1] + 0.002) / torch.where(d[:, 1] == 0, torch.full_like(d[:, 1], 1e-30),
                                             -d[:, 1])
        hit = (d[:, 1] < 0) & (gd < DIST_LIMIT) & (gd < closest)
        p = o + d * gd[:, None]
        inbox = (p[:, 0] <= 1) & (p[:, 0] >= 0) & (p[:, 2] <= 1) & (p[:, 2] >= 0)
        checker = ((p[:, 0] / 0.25).long() + (p[:, 2] / 0.25).long()) % 2
        shade = torch.where(inbox, checker.to(self.dtype) * 0.2 + 0.35,
                            torch.full_like(p[:, 0], 0.4))
        closest = torch.where(hit, gd, closest)
        normal = torch.where(hit[:, None], self._t([0.0, 1.0, 0.0]), normal)
        color = torch.where(hit[:, None], self._t([0.3, 0.5, 0.7]) * shade[:, None], color)
        return closest, normal, color

    def next_hit(self, tex, env, o, d, alive):
        closest, normal, color = self._planes(o, d)
        rough = torch.zeros(o.shape[0], dtype=self.dtype, device=self.device)
        no_plane = closest >= INF
        rough = torch.where(no_plane, torch.full_like(rough, 0.05), rough)
        if self.sc.prims:
            pos, rot, gap = self._poses(tex, env)
            t, ids = self._sphere_trace((pos, rot, gap), o, d, alive)
            hit = alive & (t < closest) & (t < DIST_LIMIT)
            pp = o + t[:, None] * d
            pn = torch.zeros_like(normal)
            pc = torch.zeros_like(color)
            for i, pr in enumerate(self.sc.prims):
                sel = (ids == i)[:, None]
                n_i = shape_module(pr.shape).normal(pr.params, pos[:, i], rot[:, i], pp, gap[:, i])
                pn = torch.where(sel, n_i, pn)
                pc = torch.where(sel, self._t(list(pr.color)), pc)
            closest = torch.where(hit, t, closest)
            normal = torch.where(hit[:, None], pn, normal)
            color = torch.where(hit[:, None], pc, color)
            rough = torch.where(hit, torch.zeros_like(rough), rough)
        hitm, tm = self._march(tex, env, o, d, alive, refine=True)
        hit = hitm & (tm < closest)
        k = hit.nonzero()[:, 0]
        ph = o[k] + d[k] * tm[k, None]
        closest = torch.where(hit, tm, closest)
        normal[k] = self._normal(tex, ph, env[k])
        color[k] = self._color(tex, ph, env[k])
        return closest, normal, color, rough

    def occluded(self, tex, env, o, d, alive):
        rc = -(o[:, 2] + 5.5) / torch.where(d[:, 2] == 0, torch.full_like(d[:, 2], 1e-30), d[:, 2])
        occ = (d[:, 2] != 0) & (rc > 0) & (rc < DIST_LIMIT)
        gd = (o[:, 1] + 0.002) / torch.where(d[:, 1] == 0, torch.full_like(d[:, 1], 1e-30),
                                             -d[:, 1])
        occ = occ | ((d[:, 1] < 0) & (gd < DIST_LIMIT))
        if self.sc.prims:
            t, _ = self._sphere_trace(self._poses(tex, env), o, d, alive & ~occ)
            occ = occ | (alive & (t < DIST_LIMIT))
        return occ | self._march(tex, env, o, d, alive & ~occ, refine=False)[0]

    # -- the path tracer -----------------------------------------------------
    def _out_dir(self, n, uniform):
        up = self._t([0.0, 1.0, 0.0]).expand_as(n)
        u = torch.where((n[:, 1].abs() < 1 - 1e-3)[:, None], _cross(n, up),
                        self._t([1.0, 0.0, 0.0]).expand_as(n))
        u = _normalize(u)
        v = _cross(n, u)
        phi = 2 * math.pi * uniform((n.shape[0],))
        r = uniform((n.shape[0],))
        return (torch.sqrt(1 - r)[:, None] * (torch.cos(phi)[:, None] * u
                                              + torch.sin(phi)[:, None] * v)
                + torch.sqrt(r)[:, None] * n)

    def _sphere(self, R, uniform):
        u, v = uniform((R,)), uniform((R,))
        x = u * 2 - 1
        phi = v * 2 * math.pi
        yz = torch.sqrt(1 - x * x)
        return torch.stack([x, yz * torch.cos(phi), yz * torch.sin(phi)], -1)

    def _sky(self, d):
        c = torch.clamp((d * self._t([0.8, 0.65, 0.15])).sum(-1) * 0.5 + 0.5, 0, 1)[:, None]
        return (c * self._t([0.9, 0.9, 0.9]) + (1 - c) * self._t([0.7, 0.7, 0.8])) * 1.5

    def _trace(self, tex, env, pos, d, uniform):
        R = pos.shape[0]
        contrib = torch.zeros((R, 3), dtype=self.dtype, device=self.device)
        through = torch.ones((R, 3), dtype=self.dtype, device=self.device)
        alive = torch.ones(R, dtype=torch.bool, device=self.device)
        for _ in range(self.depth):
            closest, normal, c, rough = self.next_hit(tex, env, pos, d, alive)
            hit_pos = pos + closest[:, None] * d
            step_alive = alive & (_norm(normal) != 0)
            nd = _normalize(self._out_dir(normal, uniform)
                            + self._sphere(R, uniform) * rough[:, None])
            d = torch.where(step_alive[:, None], nd, d)
            pos = torch.where(step_alive[:, None], hit_pos + 1e-4 * nd, pos)
            through = torch.where(step_alive[:, None], through * c, through)
            if self.light:
                noise = (uniform((R, 3)) - 0.5) * 0.03
                direct = _normalize(self._t(list(self.light_dir)) + noise)
                dot = (direct * normal).sum(-1)
                occ = self.occluded(tex, env, pos, direct, step_alive & (dot > 0))
                lit = step_alive & (dot > 0) & ~occ
                contrib = contrib + torch.where(lit[:, None], through * dot[:, None],
                                                torch.zeros_like(contrib))
            alive = step_alive
        return contrib if self.light else through * self._sky(d)

    def frames(self, st, uniform, color: int = 0x999999):
        """uint8 frames (b, H, W, 3) of the states st (x (b, n, 3), poses
        pos, rot and gap (b, k, ...)), in one pass of all spp samples."""
        x = st.x.to(self.device, self.dtype)
        b = x.shape[0]

        def draw(shape):
            return uniform(shape).to(self.device, self.dtype)

        sdf, col, lower = self.volume(x, color)
        span = self._t(list(self.voxel_res)) * self.dx
        tex = {"sdf": sdf.reshape(-1), "col": col.reshape(-1, 3), "lo": lower, "span": span,
               "pos": st.pos.to(self.device, self.dtype), "rot": st.rot.to(self.device, self.dtype),
               "gap": st.gap.to(self.device, self.dtype)}
        W = H = self.res
        S = self.spp
        ux = torch.arange(W, device=self.device, dtype=self.dtype)[None, :, None] + draw(
            (b * S, W, H))
        vx = torch.arange(H, device=self.device, dtype=self.dtype)[None, None, :] + draw(
            (b * S, W, H))
        dx = 2 * FOV * ux / H - FOV * (W / H) - 1e-5
        dy = 2 * FOV * vx / H - FOV - 1e-5
        d = _normalize(torch.stack([dx, dy, -torch.ones_like(dx)], -1))
        r0, r1 = self.camera_rot
        ry = torch.tensor([[math.cos(r1), 0, math.sin(r1)], [0, 1, 0],
                           [-math.sin(r1), 0, math.cos(r1)]], dtype=torch.float64)
        rx = torch.tensor([[1, 0, 0], [0, math.cos(r0), math.sin(r0)],
                           [0, -math.sin(r0), math.cos(r0)]], dtype=torch.float64)
        d = (d @ (ry @ rx).T.to(self.device, self.dtype)).reshape(-1, 3)
        o = self._t(list(self.camera_pos)).expand(d.shape[0], 3)
        env = torch.arange(b, device=self.device).repeat_interleave(S * W * H)
        buf = self._trace(tex, env, o, d, draw).reshape(b, S, W, H, 3).sum(1)
        u = torch.arange(W, dtype=torch.float64)[:, None] / W - 0.5
        v = torch.arange(H, dtype=torch.float64)[None, :] / H - 0.5
        dark = 1.0 - 0.9 * torch.clamp(torch.sqrt(u * u + v * v), min=0.0)
        img = torch.sqrt(buf * dark[..., None].to(self.device, self.dtype) * EXPOSURE / S)
        img = img.flip(2).permute(0, 2, 1, 3)
        return (torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8)
