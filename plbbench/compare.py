"""The comparison that decides `correct`: the window's sampled steps of the
program against the plain reference, which steps the same inputs again.

A sample is what the harness copied off around one batched step of the
window: the checked envs' state before it, the actions, and what the step
returned (state after it, observation, reward, loss, IoU, incremental IoU,
and for rgb the renderer's draws). The reference starts from the state
before, in float64 unless told otherwise, all checked envs in one call, and
works out everything the program derived (grid masses, goal SDF, start
losses). Each number is taken env by env and is the worst env's over the
samples, so that one env at fault reads as itself and is not averaged away;
`limits/<cell>.json` holds the limit of each.

The particle fields are compared over the bulk of each env's particles:
the TRIM share of them with the largest gaps is left out. The published
physics branches on signs that rounding can flip (the floor's full stop
where a grid cell's vertical velocity is ~0, a contact's influence at its
0.1 cut), and a float32 step and a float64 one then part at that cell and
its neighbours, a few hundred of 10,000 particles; a fault of the step
moves every particle of an env. Positions are compared in grid cells, not
to their change over the step, which in an env at rest is down to float32
rounding. A value that is not finite on either side is no rounding: it
reads NaN through every number, which fails every limit.
"""
from __future__ import annotations

import math
import sys
from typing import Dict, List

import numpy as np
import torch

from reference import mpm
from reference.render import Replay
from reference.scene import Scene
from reference.shapes import has_gap, init_gap

FIELDS = ("x", "v", "C", "F", "pos", "rot", "gap")
TRIM = 0.05   # share of each env's particles with the largest gaps left out


def worst(*values: float) -> float:
    """The largest of the values, NaN if any is NaN (Python's `max` would
    pass over it)."""
    return math.nan if any(math.isnan(v) for v in values) else max(values)


def _nan_if_any(gap: torch.Tensor, value: float) -> float:
    """`value`, or NaN where a gap is NaN: a non-finite particle is never
    among the few that the bulk leaves out."""
    return math.nan if bool(torch.isnan(gap).any()) else value


def rel_per_env(port, ref, base) -> float:
    """The worst env's ||port - ref|| over ||ref - base||."""
    ref = ref.double()
    gap = (port.double() - ref).flatten(1).norm(dim=1)
    den = (ref - base.double()).flatten(1).norm(dim=1)
    return float((gap / den.clamp_min(1e-300)).max())


def _bulk(gap: torch.Tensor, trim: float) -> torch.Tensor:
    """Indices (b, kept) of each env's particles outside the `trim` share
    with the largest per-particle gaps `gap` (b, n)."""
    keep = gap.shape[1] - int(gap.shape[1] * trim)
    return gap.argsort(dim=1)[:, :keep]


def bulk_rel_per_env(port, ref, scale, trim: float = TRIM) -> float:
    """The worst env's ||port - ref|| over ||scale||, both taken over the
    bulk of its particles (dim 1): those outside the `trim` share with the
    largest gaps."""
    gap = (port.double() - ref.double()).flatten(2).norm(dim=2)
    den = scale.double().flatten(2).norm(dim=2)
    idx = _bulk(gap, trim)
    return _nan_if_any(gap, float((gap.gather(1, idx).norm(dim=1)
                                   / den.gather(1, idx).norm(dim=1).clamp_min(1e-300)).max()))


def bulk_rms_per_env(port, ref, unit: float, trim: float = TRIM) -> float:
    """The worst env's root mean square gap per particle over the bulk of
    its particles, in `unit`."""
    gap = (port.double() - ref.double()).flatten(2).norm(dim=2)
    idx = _bulk(gap, trim)
    return _nan_if_any(gap, float(gap.gather(1, idx).pow(2).mean(dim=1).sqrt().max() / unit))


def frame_gap(port: torch.Tensor, ref: torch.Tensor) -> float:
    """The worst env's mean absolute difference of its uint8 frame, in levels."""
    return float((port.double() - ref.double()).abs().flatten(1).mean(dim=1).max())


def frame_unequal(port: torch.Tensor, ref: torch.Tensor) -> float:
    """The worst env's share of pixels in which any channel differs."""
    return float((port != ref).any(dim=-1).flatten(1).double().mean(dim=1).max())


class Reference:
    """The reference of one cell: its scene, goal and start states, on
    `device` in `dtype`."""

    def __init__(self, sc: Scene, goal: np.ndarray, x0: torch.Tensor, device, dtype,
                 softness: float, render=None):
        from scipy import ndimage

        self.sc, self.device, self.dtype = sc, device, dtype
        G = sc.n_grid
        goal = np.asarray(goal, np.float64).reshape(G, G, G)
        occupied = goal > 1e-4
        sdf = (ndimage.distance_transform_edt(~occupied) * sc.dx if occupied.any()
               else np.full(goal.shape, 1000.0))
        self.target = torch.as_tensor(goal.reshape(-1), device=device).to(dtype)
        self.target_sdf = torch.as_tensor(sdf.reshape(-1), device=device).to(dtype)
        self.target_iou = mpm.iou(self.target, self.target)
        self.softness = softness
        self.render = render
        self.x0 = x0
        self.start_loss, self.start_iou = self._loss(self.on_device(self.start_state()))

    def start_state(self) -> mpm.State:
        """The B envs' start: x0 at rest, F = I, the primitives at their
        initial poses and gaps (host tensors)."""
        B, n, _ = self.x0.shape
        k = len(self.sc.prims)
        f64 = torch.float64
        return mpm.State(
            x=self.x0.to(f64), v=torch.zeros(B, n, 3, dtype=f64),
            C=torch.zeros(B, n, 3, 3, dtype=f64),
            F=torch.eye(3, dtype=f64).expand(B, n, 3, 3),
            pos=torch.tensor([p.init_pos for p in self.sc.prims], dtype=f64).expand(B, k, 3),
            rot=torch.tensor([p.init_rot for p in self.sc.prims], dtype=f64).expand(B, k, 4),
            gap=torch.tensor([init_gap(p.shape, p.params) for p in self.sc.prims],
                             dtype=f64).expand(B, k))

    def on_device(self, st: mpm.State) -> mpm.State:
        """A host state on the device in the dtype."""
        return mpm.State(*(t.to(self.device, self.dtype).contiguous() for t in st))

    def _loss(self, st: mpm.State):
        return mpm.loss(self.sc, self.target, self.target_sdf, st)

    def step(self, st_in: mpm.State, actions: torch.Tensor):
        """One env step of every env -> (state after, loss, reward, iou,
        incremental iou)."""
        b = st_in.x.shape[0]
        soft = torch.full((b,), self.softness, dtype=self.dtype, device=self.device)
        st = mpm.env_step(self.sc, st_in, actions.to(self.device).to(self.dtype), soft)
        loss, iou = self._loss(st)
        inc = torch.clamp((iou - self.start_iou) / (self.target_iou - self.start_iou), 0.0, 1.0)
        return st, loss, self.start_loss - loss, iou, inc


def host_state(d: Dict[str, torch.Tensor]) -> mpm.State:
    return mpm.State(*(d[f] for f in FIELDS))


def compare(ref: Reference, samples: List[dict], start: dict, obs_mode: str,
            requested: int, envs: torch.Tensor, batch: int) -> Dict[str, float]:
    """The numbers that decide `correct`, each the worst env's over the
    samples of the checked envs `envs` of the `batch`; `missed_samples`
    counts the sampled steps that the window never ran."""
    out = {"missed_samples": float(requested - len(samples)), "start_gap": 0.0,
           "state_gap": 0.0, "x_gap": 0.0, "obs_gap": 0.0, "loss_gap": 0.0}
    if obs_mode != "state":
        out["obs_unequal"] = 0.0
    fields = {f: 0.0 for f in ("F", "v", "C", "pose")}
    gaps = [i for i, p in enumerate(ref.sc.prims) if has_gap(p.shape)]

    def pose(st):
        """pos and rot of every primitive, and the gap of those with one."""
        return torch.cat([st.pos.flatten(1), st.rot.flatten(1), st.gap[:, gaps]], 1)

    # the start: the program's start states and reset observation
    x0 = start["x"].double()
    out["start_gap"] = float((x0 - ref.x0.double()).abs().max())
    if obs_mode == "state":
        obs0 = mpm.state_obs(ref.sc, ref.on_device(ref.start_state())).cpu()
        out["start_gap"] = worst(out["start_gap"],
                                 float((start["obs"].double() - obs0.double()).abs().max()))
    eye = torch.eye(3, dtype=torch.float64)
    for s in samples:
        st_in = host_state(s["state_in"])
        port = host_state(s["state_out"])
        dev_in = ref.on_device(st_in)
        st, loss, reward, iou, inc = ref.step(dev_in, s["actions"])
        ref_st = mpm.State(*(t.cpu().double() for t in st))
        # F to the deformation it holds, v and C to their size, the poses
        # (gaps included) to their change over the step; positions in grid
        # cells
        fields["F"] = worst(fields["F"], bulk_rel_per_env(port.F, ref_st.F, ref_st.F - eye))
        fields["v"] = worst(fields["v"], bulk_rel_per_env(port.v, ref_st.v, ref_st.v))
        fields["C"] = worst(fields["C"], bulk_rel_per_env(port.C, ref_st.C, ref_st.C))
        fields["pose"] = worst(fields["pose"], rel_per_env(pose(port), pose(ref_st), pose(st_in)))
        out["x_gap"] = worst(out["x_gap"], bulk_rms_per_env(port.x, ref_st.x, ref.sc.dx))
        loss, reward, iou, inc = (t.cpu().double() for t in (loss, reward, iou, inc))
        scale = loss.abs()
        # loss and reward relative to the loss; IoU and incremental IoU, in
        # [0, 1], absolute
        out["loss_gap"] = worst(out["loss_gap"],
                                float(((s["loss"].double() - loss).abs() / scale).max()),
                                float(((s["reward"].double() - reward).abs() / scale).max()),
                                float((s["iou"].double() - iou).abs().max()),
                                float((s["inc"].double() - inc).abs().max()))
        if obs_mode == "state":
            # the observation is a gather of the state the step left: the
            # reference gathers it again from that state, to the bit
            obs_ref = mpm.state_obs(ref.sc, port)
            out["obs_gap"] = worst(out["obs_gap"],
                                   float((s["obs"].double() - obs_ref.double()).abs().max()))
        else:
            replay = Replay(s["draws"], batch, envs, ref.device, ref.dtype)
            frames = ref.render.frames(port, replay).cpu()
            out["obs_gap"] = worst(out["obs_gap"], frame_gap(s["obs"], frames))
            out["obs_unequal"] = worst(out["obs_unequal"], frame_unequal(s["obs"], frames))
    out["state_gap"] = worst(*fields.values())
    print("plbbench: state_gap by field " + " ".join(f"{k} {v!r}" for k, v in fields.items()),
          file=sys.stderr)
    return out
