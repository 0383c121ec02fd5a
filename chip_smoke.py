#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`plasticinelab_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
1. device: requires CUDA; prints the card and its power limit;
2. build: builds the CUDA kernels from `plasticinelab_tpu_torch/csrc`;
3. kernels: each kernel against its plain PyTorch version on the card, at
   Move-v1 shapes (10,000 particles, 64^3 grid), inputs from a numpy seed;
   the grid update once per primitive shape; kernel and plain times;
4. reference: Move-v1 reset + one fixed step against values computed by the
   reference package `plasticinelab_tpu` (loss terms, reward, observation sums);
5. slice: `make("Move-v1", device="cuda")`, `reset()`, 50 seeded steps;
   launch counts prove the steps ran through the kernels; then one env step
   through the kernels and through the plain versions from the same state.
6. device times: each kernel and plain version under torch.profiler, after
   the slice (an active profiler slows every later launch).
Prints a JSON line of the kernels (`ms` and `plain_ms`: device time per call
from torch.profiler), then as the last line {"ok": true, "device": {...}}.
"""
import json
import subprocess
import sys
import time

import numpy as np

DEVICE = "cuda"
SEED = 0
STEPS = 50
KERNEL_REPS = 20

# Tolerances, kernel vs plain version, both float32 on the card, relative to
# the largest |value| of the plain output:
# - stress: the same Jacobi/von Mises steps in another operation order (and
#   with fused multiply-adds); the stress term 2 mu (F - R) F^T cancels to
#   ~1e-1 of F and is scaled by mu ~ 2e3, so float32 rounding reaches ~1e-6.
# - transfers: sums of 27 stencil terms per cell or particle, in an order
#   that float atomics change from run to run (both sides use atomics).
# - grid update: the collider velocity (x_f+1(p) - p) / dt takes the
#   difference of two positions ~0.5 (float32 ulp 6e-8) and divides it by
#   dt = 1e-4, so two operation orders differ by up to ~1e-3 m/s absolute,
#   1e-4..1e-3 of the grid's largest velocity; the box normal is a finite
#   difference with d = 1e-4. The contact condition is a jump: a cell within
#   rounding of it may take the other branch. Such cells are counted against
#   FLIP_BUDGET, not hidden by a looser tolerance.
TOL = {"stress_affine": 1e-4, "p2g": 1e-5, "grid_mass": 1e-5, "g2p": 1e-5,
       "grid_op": 1e-3}
FLIP_BUDGET = 4  # grid cells per call that may take the other contact branch
# One env step (19 substeps) through kernels vs plain versions from the same
# state: float32 differences compound through stress and contact; bounded
# relative to the largest value of each field.
STEP_TOL = {"x": 1e-5, "v": 1e-2, "C": 5e-2, "F": 1e-3, "grid_m": 1e-3}

# Move-v1 from reset, one step of REF_ACTION, computed by the reference
# package (`plasticinelab_tpu.envs.make("Move-v1")`, float32, on the CPU): the
# reset loss, the step's loss terms and reward, and sums of the 1214-long
# observation. The port must agree to REF_TOL relative (the reward, a
# difference of two losses ~13.27 whose float32 ulp is ~1e-6, to
# REF_REWARD_ATOL absolute).
REF_ACTION = (0.5, -0.3, 0.2, -0.4, 0.1, 0.6)
REF_VALUES = {"reset_loss": 13.274866104125977, "loss": 13.274572372436523,
           "density_loss": 1.2207032442092896, "sdf_loss": 0.10675406455993652,
           "obs_sum": 488.732788, "obs_abs_sum": 656.550293}
REF_REWARD = 0.000293731689453125
REF_TOL = 1e-4
REF_REWARD_ATOL = 2e-5

REPLACES = {
    "stress_affine": "plasticinelab_tpu/engine/pallas_stress.py:201",
    "p2g": "plasticinelab_tpu/engine/pallas_local.py:163",
    "grid_mass": "plasticinelab_tpu/engine/pallas_local.py:943",
    "grid_op": "plasticinelab_tpu/engine/pallas_gridop.py:82",
    "g2p": "plasticinelab_tpu/engine/pallas_local.py:223",
}
SOURCES = {
    "stress_affine": "plasticinelab_tpu_torch/csrc/stress.cu",
    "p2g": "plasticinelab_tpu_torch/csrc/transfer.cu",
    "grid_mass": "plasticinelab_tpu_torch/csrc/transfer.cu",
    "grid_op": "plasticinelab_tpu_torch/csrc/gridop.cu",
    "g2p": "plasticinelab_tpu_torch/csrc/transfer.cu",
}
SHAPE_PARAMS = {
    "Sphere": dict(radius=0.06),
    "Capsule": dict(h=0.1, r=0.04),
    "RollingPin": dict(h=0.3, r=0.03),
    "Chopsticks": dict(h=0.15, r=0.02, init_gap=0.06),
    "Cylinder": dict(h=0.06, r=0.05),
    "Torus": dict(tx=0.06, ty=0.025),
    "Box": dict(size=(0.05, 0.04, 0.06)),
}


def log(msg):
    print(msg, flush=True)


def wall_time(fn, reps=KERNEL_REPS):
    """ms per call of fn() from CUDA events around reps calls, after a
    warm-up. For short kernels this includes the host's launch overhead the
    stream waits on."""
    import torch

    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_time(fn, reps=KERNEL_REPS, attempts=3):
    """ms per call of fn() on the device: the summed time of the kernels and
    memsets it ran, from torch.profiler. A profiling session now and then
    records no device events; it is repeated, up to `attempts` sessions
    (None if none saw any)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        dev_us = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages())
        if dev_us > 0:
            return dev_us / 1e3 / reps
    return None


def compare(name, got, want, tol, flip_budget=0):
    """Max abs / rel error of got vs want (tuples of tensors); rows (cells or
    particles) beyond tol x max|want| count as flips, at most flip_budget."""
    import torch

    max_abs, max_rel, flips = 0.0, 0.0, 0
    for g, w in zip(got, want):
        g = g.double().reshape(g.shape[0], -1)
        w = w.double().reshape(w.shape[0], -1)
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name}: non-finite kernel output")
        scale = float(w.abs().max()) or 1.0
        err = (g - w).abs().amax(dim=1)
        bad = err > tol * scale
        flips += int(bad.sum())
        good = err[~bad]
        if good.numel():
            max_abs = max(max_abs, float(good.max()))
            max_rel = max(max_rel, float(good.max()) / scale)
    log(f"  {name:28s} max_abs {max_abs:.3e}  max_rel {max_rel:.3e}  "
        f"(tol {tol:.0e})  flipped rows {flips} (budget {flip_budget})")
    if flips > flip_budget:
        raise AssertionError(f"{name}: {flips} rows beyond tolerance {tol}")
    return max_abs


def phase_kernels():
    import dataclasses

    import torch

    from plasticinelab_tpu_torch.config.spec import PrimitiveSpec
    from plasticinelab_tpu_torch.engine import cuda_gridop, cuda_stress, cuda_transfer
    from plasticinelab_tpu_torch.engine.shapes import build_particles
    from plasticinelab_tpu_torch.engine.state import default_materials
    from plasticinelab_tpu_torch.envs.env import PlasticineEnv

    scene = PlasticineEnv.load_scene("move", 1)
    x_np, _ = build_particles(scene.shapes)
    scene = scene.with_n_particles(len(x_np))
    sim = scene.simulator
    n, G = len(x_np), sim.n_grid
    log(f"phase kernels: Move-v1 shapes, n={n} particles, G={G} grid, seed {SEED}")
    rng = np.random.default_rng(SEED)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=DEVICE)

    mats = default_materials(scene)
    C = t(rng.standard_normal((n, 3, 3)) * 2.0)
    F = t(np.eye(3) + rng.standard_normal((n, 3, 3)) * 0.15)
    x = t(x_np)
    v = t(rng.standard_normal((n, 3)) * 0.5)
    aff = t(rng.standard_normal((n, 3, 3)) * 0.3)
    grid_v = t(rng.standard_normal((G ** 3, 3)) * 0.5)
    results = {}

    def record(name, err, kern, plain):
        k_wall, p_wall = wall_time(kern), wall_time(plain)
        results[name] = dict(max_abs_err=err, ms=k_wall, plain_ms=p_wall, calls=(kern, plain))
        log(f"  {name:28s} wall ms/call: kernel {k_wall:.4f}  plain {p_wall:.4f}")

    k = lambda: cuda_stress.stress_affine(scene, mats, C, F)  # noqa: E731
    p = lambda: cuda_stress.stress_affine_plain(scene, mats, C, F)  # noqa: E731
    record("stress_affine", compare("stress_affine", k(), p(), TOL["stress_affine"]), k, p)

    k = lambda: (cuda_transfer.p2g(scene, x, v, aff),)  # noqa: E731
    p = lambda: (cuda_transfer.p2g_plain(scene, x, v, aff),)  # noqa: E731
    record("p2g", compare("p2g", k(), p(), TOL["p2g"]), k, p)

    k = lambda: (cuda_transfer.grid_mass(scene, x),)  # noqa: E731
    p = lambda: (cuda_transfer.grid_mass_plain(scene, x),)  # noqa: E731
    record("grid_mass", compare("grid_mass (p2g MASS_ONLY)", k(), p(), TOL["grid_mass"]), k, p)

    k = lambda: cuda_transfer.g2p(scene, x, grid_v)  # noqa: E731
    p = lambda: cuda_transfer.g2p_plain(scene, x, grid_v)  # noqa: E731
    record("g2p", compare("g2p", k(), p(), TOL["g2p"]), k, p)

    # grid update on a realistic grid: P2G of the cloud with O(1) velocities
    grid4 = cuda_transfer.p2g_plain(scene, x, v, sim.p_mass * C)
    center = x_np.mean(axis=0)

    def poses(k_, seed):
        r = np.random.default_rng(seed)
        pos = center + r.uniform(-0.03, 0.03, (k_, 3))
        rot = r.standard_normal((k_, 4))
        rot /= np.linalg.norm(rot, axis=1, keepdims=True)
        gap = np.full(k_, 0.06)
        w = r.standard_normal((k_, 4)) * 0.003
        rot1 = (rot + w) / np.linalg.norm(rot + w, axis=1, keepdims=True)
        return (t(pos), t(rot), t(gap)), (t(pos + r.normal(0, 1e-3, (k_, 3))), t(rot1), t(gap - 1e-4))

    for i, (shape, kw) in enumerate(SHAPE_PARAMS.items()):
        sc = scene.replace(primitives=(PrimitiveSpec(shape=shape, friction=0.9, **kw),))
        pf, pf1 = poses(1, 100 + i)
        compare(f"grid_op[{shape}]", (cuda_gridop.grid_op(sc, grid4, pf, pf1, 666.0),),
                (cuda_gridop.grid_op_plain(sc, grid4, pf, pf1, 666.0),), TOL["grid_op"],
                FLIP_BUDGET)
    pf, pf1 = poses(len(scene.primitives), 99)
    # every cell massive or empty at random, velocities O(1): the walls and
    # the three ground regimes of the 50 tasks (friction 0, < 10, >= 10)
    m = rng.uniform(1e-6, 1e-4, G ** 3) * (rng.random(G ** 3) > 0.25)
    vel = rng.standard_normal((G ** 3, 3))
    grid_rand = t(np.concatenate([vel * m[:, None], m[:, None]], axis=1))
    for gf in (0.0, 1.5, 100.0):
        sc = scene.replace(simulator=dataclasses.replace(sim, ground_friction=gf))
        compare(f"grid_op[walls, ground {gf}]",
                (cuda_gridop.grid_op(sc, grid_rand, pf, pf1, 666.0),),
                (cuda_gridop.grid_op_plain(sc, grid_rand, pf, pf1, 666.0),), TOL["grid_op"],
                FLIP_BUDGET)
    k = lambda: (cuda_gridop.grid_op(scene, grid4, pf, pf1, 666.0),)  # noqa: E731
    p = lambda: (cuda_gridop.grid_op_plain(scene, grid4, pf, pf1, 666.0),)  # noqa: E731
    err = compare("grid_op[Move-v1: 2 Spheres]", k(), p(), TOL["grid_op"], FLIP_BUDGET)
    record("grid_op", err, k, p)
    return results


def phase_reference():
    from plasticinelab_tpu_torch.envs import make

    log("phase reference: Move-v1 reset + 1 step vs the reference package's values")
    env = make("Move-v1", device=DEVICE)
    env.reset()
    got = {"reset_loss": env.unwrapped.taichi_env.compute_loss()["loss"]}
    obs, r, *_, info = env.step(np.asarray(REF_ACTION))
    got.update({k: info[k] for k in ("loss", "density_loss", "sdf_loss")},
               obs_sum=float(obs.astype(np.float64).sum()),
               obs_abs_sum=float(np.abs(obs.astype(np.float64)).sum()))
    for k, want in REF_VALUES.items():
        rel = abs(got[k] - want) / abs(want)
        log(f"  {k:12s} port {got[k]:.9g}  reference {want:.9g}  rel {rel:.2e} (tol {REF_TOL:.0e})")
        if not rel <= REF_TOL:
            raise AssertionError(f"{k}: {got[k]} vs the reference package's {want}")
    log(f"  reward       port {r:.9g}  reference {REF_REWARD:.9g}  (atol {REF_REWARD_ATOL:.0e})")
    if not abs(r - REF_REWARD) <= REF_REWARD_ATOL:
        raise AssertionError(f"reward {r} vs the reference package's {REF_REWARD}")


def phase_slice():
    import torch

    from plasticinelab_tpu_torch.engine import cuda_gridop, cuda_stress, cuda_transfer, mpm
    from plasticinelab_tpu_torch.envs import make

    for mod in (cuda_stress, cuda_transfer, cuda_gridop):
        mod.reset_launches()
    log(f"phase slice: make('Move-v1', device='cuda'), reset(), {STEPS} steps")
    t0 = time.perf_counter()
    env = make("Move-v1", device=DEVICE)
    obs, _ = env.reset()
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    mass_before = cuda_transfer.launches["grid_mass"]
    rng = np.random.default_rng(SEED)
    actions = rng.uniform(-1, 1, (STEPS, env.action_space.shape[0]))
    stamps = []
    for a in actions:
        obs, r, term, trunc, info = env.step(a)  # fetches obs + loss: synchronises
        stamps.append(time.perf_counter())
        for key in ("reward", "iou", "incremental_iou"):
            if not np.isfinite(info[key]):
                raise AssertionError(f"non-finite {key}: {info[key]}")
        if obs.shape != (1214,) or not np.isfinite(obs).all():
            raise AssertionError(f"bad observation: shape {obs.shape}")
    launches = {**cuda_stress.launches, **cuda_transfer.launches, **cuda_gridop.launches}
    sub = env.unwrapped.taichi_env.scene.simulator.substeps
    log(f"  setup (make + reset) {t_setup:.3f} s; substeps per env step {sub}")
    log(f"  launches during make + reset + {STEPS} steps: {launches}")
    for key in ("stress_affine", "p2g", "grid_op", "g2p"):
        if launches[key] != STEPS * sub:
            raise AssertionError(f"{key} ran {launches[key]} times, expected {STEPS * sub}")
    if launches["grid_mass"] - mass_before != STEPS:
        raise AssertionError(f"grid_mass ran {launches['grid_mass'] - mass_before} times "
                             f"in {STEPS} steps")
    total = stamps[-1] - stamps[0]
    sps = (STEPS - 1) / total
    log(f"  env steps/s {sps:.3f} (steps 2..{STEPS}), substeps/s {sps * sub:.1f}; "
        f"final reward {info['reward']:.6g}, iou {info['iou']:.6g}, "
        f"incremental_iou {info['incremental_iou']:.6g}")

    # one env step from the same state: kernels vs plain versions
    te = env.unwrapped.taichi_env
    a = rng.uniform(-1, 1, env.action_space.shape[0])
    sk, gk = mpm.env_step_with_grid_m(te.scene, te.mats, te.state, a, te.softness, mpm.KERNEL_OPS)
    sp, gp = mpm.env_step_with_grid_m(te.scene, te.mats, te.state, a, te.softness, mpm.PLAIN_OPS)
    for name, g, w in (("x", sk.x, sp.x), ("v", sk.v, sp.v), ("C", sk.C, sp.C),
                       ("F", sk.F, sp.F), ("grid_m", gk, gp)):
        diff = float((g.double() - w.double()).abs().max())
        scale = float(w.abs().max())
        log(f"  one env step, kernels vs plain: {name:6s} max_abs {diff:.3e}  "
            f"rel {diff / scale:.3e}  (bound {STEP_TOL[name]:.0e})")
        if not diff <= STEP_TOL[name] * scale:
            raise AssertionError(f"env step {name} differs by {diff} (scale {scale})")
    return launches, sps


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from plasticinelab_tpu_torch.engine import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    log(f"phase device: {name}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi, flush=True)

    t0 = time.perf_counter()
    path = cuda_build.library_path()
    cuda_build.library()
    log(f"phase build: {time.perf_counter() - t0:.1f} s -> {path}")
    with open(path.rsplit("/", 1)[0] + "/build.log") as f:
        for line in f:
            if "registers" in line or "spill" in line:
                log("  ptxas: " + line.strip())

    results = phase_kernels()
    phase_reference()
    launches, _ = phase_slice()
    # after the slice: an active profiler slows every later launch
    log("phase device times (torch.profiler, ms per call)")
    for k, r in results.items():
        k_dev, p_dev = (device_time(fn) for fn in r.pop("calls"))
        if k_dev is None or p_dev is None:
            log(f"  {k:28s} the profiler saw no device time: keeping the CUDA-event times")
            continue
        r["ms"], r["plain_ms"] = k_dev, p_dev
        log(f"  {k:28s} kernel {k_dev:.4f}  plain {p_dev:.4f}")

    kernels = [dict(name=k, route="cuda", source=SOURCES[k], replaces=REPLACES[k],
                    launches=launches[k], **results[k]) for k in REPLACES]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
