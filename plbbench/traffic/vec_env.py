"""Traffic kind `vec_env`: one RL learner collecting from B envs in a closed
loop through the program's `VecPlasticineEnv`.

Each batched step takes actions uniform in [-1, 1) drawn from the seed,
a fresh (horizon, B, action) block at each episode's reset, and fetches
the observation, reward, loss, IoU and incremental IoU to the host (the
learner's sync); every `horizon` steps the learner calls `reset()`, inside
the window. The traffic file gives `batch`, `obs_mode`, `horizon`,
`jitter`, `image_res`, `image_spp`, `samples` (steps the
comparison checks, each the first to start after a time drawn from the
seed in SAMPLE_SPAN, fractions of the window), `check_envs` (how many of
the B envs, drawn from the seed, those checks cover) and `profile_steps`
(steps a traced run profiles).
"""
from __future__ import annotations

import gc
import sys
import time
from typing import Dict, List

import numpy as np
import torch

import inputs
import roofline
import tracing as trace_mod
from reference import mpm
from reference.scene import scene_of

SOFTNESS = 666.0
SAMPLE_SPAN = (0.05, 0.85)   # sampled steps start in this part of the window
WARM_STEPS = 3               # steps of the window's own calls in set-up
FIELDS = ("x", "v", "C", "F", "prim_pos", "prim_rot", "prim_gap")
REF_FIELDS = ("x", "v", "C", "F", "pos", "rot", "gap")


def _fetch(obs, reward, info):
    """The learner's fetch: each result to the host."""
    return (obs.cpu(), reward.cpu(), info["loss"].cpu(), info["iou"].cpu(),
            info["incremental_iou"].cpu())


class _Copier:
    """Copies of the envs' state into host buffers made in set-up, one pair
    (before, after) per sampled step; the copies run on the stream behind
    the step and are waited for once the window has closed."""

    def __init__(self, env, count: int, pin: bool, envs: torch.Tensor):
        st = env.states
        self.envs = envs
        self.bufs = [[{f: torch.empty((len(envs),) + getattr(st, f).shape[1:],
                                      dtype=torch.float32, pin_memory=pin) for f in FIELDS}
                      for _ in range(2)] for _ in range(count)]
        self.used = 0

    def take(self):
        pair = self.bufs[self.used]
        self.used += 1
        return pair

    def copy(self, env, buf):
        st = env.states
        for f in FIELDS:
            buf[f].copy_(getattr(st, f).index_select(0, self.envs), non_blocking=True)

    @staticmethod
    def as_reference(buf) -> Dict[str, torch.Tensor]:
        return {r: buf[f] for r, f in zip(REF_FIELDS, FIELDS)}


def checked_envs(seed: int, batch: int, count: int) -> torch.Tensor:
    """The envs whose answers the comparison checks: `count` of the
    `batch`, drawn from the seed, in order."""
    gen = torch.Generator().manual_seed(seed ^ 0xC4EC)
    return torch.sort(torch.randperm(batch, generator=gen)[:min(count, batch)]).values


def _recording(env):
    """Wrap the renderer's sampler seam so that it can record draws."""
    seam = env._renderer
    inner = seam.uniform
    draws: List[torch.Tensor] = []
    state = {"on": False}

    def uniform(shape):
        a = inner(shape)
        if state["on"]:
            draws.append(a.cpu())
        return a

    seam.uniform = uniform
    return draws, state


def run(ctx) -> dict:
    """Set up, warm, drive the window; -> the run's raw outcome."""
    p = ctx.traffic
    device = ctx.device
    B, horizon = int(p["batch"]), int(p["horizon"])
    obs_mode = p["obs_mode"]
    from plasticinelab_tpu_torch.config.loader import scene_from_dict
    from plasticinelab_tpu_torch.parallel.rollout import VecPlasticineEnv

    cloud = inputs.task_cloud(ctx.config["spec"])
    goal = inputs.goal_grid(ctx.config)
    sc = scene_of(ctx.config["spec"])
    x0 = inputs.jittered_starts(cloud, B, ctx.seed, float(p["jitter"]))
    if ctx.make_env is None:
        env = VecPlasticineEnv(None, batch=B, seed=ctx.seed, jitter=float(p["jitter"]),
                               horizon=horizon, scene=scene_from_dict(ctx.config["spec"]),
                               target_density=goal, particles=cloud, obs_mode=obs_mode,
                               image_obs_res=int(p.get("image_res", 64)),
                               image_obs_spp=int(p.get("image_spp", 2)), device=device)
    else:
        env = ctx.make_env(sc, goal, x0, p)
    check = checked_envs(ctx.seed, B, int(p.get("check_envs", B)))
    check_dev = check.to(device)
    start = {"x": env.states.x.index_select(0, check_dev).cpu()}
    draws, recording = (_recording(env) if obs_mode == "rgb" else (None, None))
    actions = inputs.Actions(ctx.seed, horizon, B, sc.action_dim, device)
    rng = np.random.default_rng(ctx.seed)
    sample_at = sorted(rng.uniform(*SAMPLE_SPAN, int(p["samples"])) * ctx.seconds)
    copier = _Copier(env, len(sample_at), device.type == "cuda", check_dev)
    start["obs"] = env.reset().index_select(0, check_dev).cpu()
    # warm-up: the window's own calls, a reset, its action draw and a state
    # copy included
    acts = actions.episode()
    for i in range(WARM_STEPS):
        obs, reward, _, info = env.step(acts[i])
        _fetch(obs, reward, info)
    if copier.bufs:
        copier.copy(env, copier.bufs[0][0])
    if ctx.trace:   # the profiler's own start-up, outside the profiled slice
        warm = _start_profiler(device)
        obs, reward, _, info = env.step(acts[0])
        _fetch(obs, reward, info)
        warm.stop()
    env.reset()
    acts = actions.episode()
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t0

    profile_at = 0.4 * ctx.seconds if ctx.trace else None
    profile_steps = int(p["profile_steps"])
    prof, profiled, prof_x, done, reading = None, 0, None, None, None
    samples, lat, host_ms, failed = [], [], [], 0
    i, t_ep = 0, 0
    t_start = time.perf_counter()
    while True:
        now = time.perf_counter() - t_start
        if now >= ctx.seconds and prof is None:   # a profiled slice runs to its end
            break
        if t_ep == horizon:
            env.reset().cpu()
            acts = actions.episode()
            t_ep = 0
            continue
        if (prof is None and profile_at is not None and now >= profile_at and profiled == 0
                and t_ep + profile_steps <= horizon):
            prof_x = env.states.x.to("cpu")
            prof = _start_profiler(device)
        sampled = (prof is None and sample_at and now >= sample_at[0])
        if sampled:
            while sample_at and now >= sample_at[0]:
                sample_at.pop(0)
            before, after = copier.take()
            copier.copy(env, before)
            if recording is not None:
                draws.clear()
                recording["on"] = True
        a = acts[t_ep]
        t0 = time.perf_counter()
        if prof is not None:
            with torch.profiler.record_function(trace_mod.STEP):
                obs, reward, _, info = env.step(a)
                t1 = time.perf_counter()
                got = _fetch(obs, reward, info)
        else:
            obs, reward, _, info = env.step(a)
            t1 = time.perf_counter()
            got = _fetch(obs, reward, info)
        t2 = time.perf_counter()
        lat.append(t2 - t0)
        if prof is None:
            host_ms.append((t1 - t0) * 1e3)
        failed += int((~torch.isfinite(got[1]) | ~torch.isfinite(got[2])).sum())
        if sampled:
            if recording is not None:
                recording["on"] = False
            copier.copy(env, after)
            samples.append({"t": i, "actions": a.index_select(0, check_dev).cpu(),
                            "before": before, "after": after, "obs": got[0][check],
                            "reward": got[1][check], "loss": got[2][check], "iou": got[3][check],
                            "inc": got[4][check],
                            "draws": list(draws) if draws is not None else None})
        if prof is not None:
            profiled += 1
            if profiled == profile_steps:
                # the window's clock stops for the observation pass and the
                # profiler's stop, so that the sampled steps still fall in it
                paused = time.perf_counter()
                done = _stop_profiler(ctx, prof, env, obs_mode)
                t_start += time.perf_counter() - paused
                prof = None
        i += 1
        t_ep += 1
    ctx.sync()
    window_s = time.perf_counter() - t_start
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    for s in samples:
        s["state_in"] = _Copier.as_reference(s.pop("before"))
        s["state_out"] = _Copier.as_reference(s.pop("after"))
    # the program's state goes before the yardstick and the reference run
    env = obs = reward = info = acts = actions = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if done is not None:
        t = time.perf_counter()
        events = done.profiler.kineto_results.events()
        reading = trace_mod.reduce(events)
        print(f"plbbench: profile of {reading.steps} steps, {len(events)} events, read in "
              f"{time.perf_counter() - t:.3f} s", file=sys.stderr)
        done = events = None
        reading.extra["step_host_ms"] = float(np.mean(host_ms)) if host_ms else None
        reading.extra["physics_least_s"] = physics_least_s(sc, prof_x, reading.steps, device)
    return {"setup_s": setup_s, "window_s": window_s, "steps": len(lat), "batch": B,
            "latencies": lat, "failed": failed, "samples": samples, "start": start,
            "peak_bytes": peak, "x0": x0, "check": check, "sc": sc, "goal": goal,
            "reading": reading}


def _reference(ctx, sc, goal, x0, dtype):
    from compare import Reference

    render = None
    if ctx.traffic["obs_mode"] == "rgb":
        from reference.render import ObsRenderer

        render = ObsRenderer(sc, goal, int(ctx.traffic.get("image_res", 64)),
                             int(ctx.traffic.get("image_spp", 2)), ctx.device, dtype)
    return Reference(sc, goal, x0, ctx.device, dtype, SOFTNESS, render)


def compare(ctx, out) -> dict:
    """The comparison's numbers: the sampled steps against the reference in
    float64."""
    import compare as cmp

    check = out["check"]
    ref = _reference(ctx, out["sc"], out["goal"], out["x0"][check], torch.float64)
    return cmp.compare(ref, out["samples"], out["start"], ctx.traffic["obs_mode"],
                       int(ctx.traffic["samples"]), check, out["batch"])


def control_env(ctx, dtype):
    """A maker of the reference in `dtype` in the program's place."""
    from reference.vec_env import RefVecEnv

    def make(sc, goal, x0, p):
        return RefVecEnv(_reference(ctx, sc, goal, x0, dtype), int(p["batch"]),
                         int(p["horizon"]), p["obs_mode"], ctx.seed)

    return make


def _start_profiler(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _stop_profiler(ctx, prof, env, obs_mode):
    """Run the observation pass under the profiler (rgb) and stop it; its
    events are read once the window has closed."""
    if obs_mode == "rgb" and hasattr(env, "_observe"):
        ctx.sync()
        with torch.profiler.record_function(trace_mod.OBSERVE):
            env._observe(env.states)
            ctx.sync()
    ctx.sync()
    prof.stop()
    if ctx.chrome_trace:
        prof.export_chrome_trace(ctx.chrome_trace)
    return prof


def physics_least_s(sc, x: torch.Tensor, steps: int, device) -> float:
    """Least seconds of `steps` batched env steps from particles x (B, n, 3),
    the cells with mass counted once from x."""
    B, n, _ = x.shape
    cells = 0
    for lo in range(0, B, 16):
        idx, _, _ = mpm.stencil(sc, x[lo:lo + 16].to(device))
        cells += int(torch.unique(idx).numel())
    return steps * roofline.env_step_least_s(B, n, sc.substeps, cells)
