#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`plasticinelab_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
1. device: requires CUDA; prints the card and its power limit;
2. build: builds the CUDA kernels from `plasticinelab_tpu_torch/csrc`;
   prints each kernel's ptxas registers and spills and its SASS counts
   (instructions, MUFU, CALL; `cuobjdump -sass`);
3. kernels: each kernel against its plain PyTorch version on the card, at
   Move-v1 shapes (10,000 particles, 64^3 grid), inputs from a numpy seed;
   the scatters (K3, K7 forward) under four particle orders each: none, the
   `cell_order` an env step computes, one an env step stale, a random
   permutation; the gather K5, which takes no order; the grid update once
   per primitive shape and on a grid without mass; kernel and plain times
   (the scatters' with the sorted order, the main path's);
4. reference: Move-v1 reset + one fixed step against values computed by the
   reference package `plasticinelab_tpu` (loss terms, reward, observation sums);
5. slice: `make("Move-v1", device="cuda")`, `reset()`, 50 seeded steps;
   launch counts prove the steps ran through the kernels; then one env step
   through the kernels and through the plain versions from the same state.
6. backward kernels: each backward kernel against the autograd VJP of its
   plain version on the card, at Move-v1 shapes, seeded cotangents; the
   grid update's backward once per primitive shape, for the walls and the
   three ground regimes, for a sphere whose contact crosses a boundary of
   its blocks and for a grid without mass (zeros), its pose cotangents
   compared too, every case with cells out of contact next to cells in
   contact and two calls bit for bit; K6 under the
   four orders; then K1 and K2 where the SVD is hardest (F = I with and
   without C, pure rotations, two equal singular values, one below the 0.05
   clamp, F scaled by 1e-3 and 1e3, a yielding cloud) and on Move-v1's C
   and F after 25 env steps tiled to 320,000 particles, held to the float64
   plain version within TOL or the case's `HARD_TOL`; the Move-v1 case also timed with the L2
   flushed before each call (`cold_time`); then the transfer cases: the
   scatters K3, K7 forward, K6 and the gathers K5, K4, K7 backward on a
   cloud spread over the whole domain (hardly two particles share a cell:
   every lane adds alone) and on a cloud in two corners (base cells clamped
   at both walls), B = 2, the scatters under four orders each, the gathers
   per env bit for bit to B = 1 launches;
7. gradient: 5 Move-v1 env steps through the kernels and through the plain
   versions from the same state (loss and d/d actions); a 2-step Move-v1
   loss and gradient against values computed by the reference package; the
   50-step trajectory gradient `rollout_value_and_grad` at bench.py's
   actions, whose launch counts prove it ran through the backward kernels,
   timed, with its peak memory and remat policy;
8. solve: `Solver.solve_device`, 3 Adam iterations on Move-v1, horizon 50;
   nn gradient: the default `MLPPolicy` (init_params(0)) acting inside 2
   Move-v1 steps, d loss / d params through the kernels against the plain
   versions, and the loss, each layer's gradient norm and 16 entries
   against values computed by the reference package (launch counts: 38 of
   each substep backward kernel, 2 of K7's); nn solve:
   `SolverNN.solve_device`, 3 Adam iterations, horizon 50 (950 launches of
   each substep backward kernel an iteration), iteration 0 against a direct
   rollout, seconds per iteration, remat, peak memory, a 5-step replay with
   `policy.act`;
9. voxelize kernel: K9 against its plain version at Move-v1 shapes (the
   task's initial 10,000-particle cloud), at the frame's 168^3 grid
   (dist_scale 0.2) and the observation's 84^3 grid (0.4), bit for bit,
   and the one `scatter_reduce_` that computes its min (`library_ms`;
   `flat` and `packed` computed before timing); bit for bit on three clouds
   at both grids, at one env (its direct mode) and as 32 copies (its
   privatised mode): 10,000 particles in one voxel, particles in the first
   and last cells and just outside the volume (negative coordinates too),
   stencils straddling the sort's coarse-cell edges on all three axes;
   K9-b (B envs in one launch) at B = 8 and 32 on Move-v1's cloud
   with per-env jitter, bit for bit against its plain version and per env
   against B = 1 launches; kernel, plain, bound and library times;
10. render reference: the Move-v1 initial-state packed volumes (unsaturated
   cells, sdf byte sum, CRC32) and 8 probe rays (plasticine, spheres,
   ground) against values computed by the reference package;
11. render: a 512^2 x 50 spp `env.render()` of Move-v1 after 5 steps,
   timed; the same frame through the kernel and through the plain
   voxelizer from one seeded sampler, identical; `make("Move-v1",
   obs_mode="rgb")` reset + 50 steps, whose launch counts prove that every
   observation went through K9 (51 launches); `solve_action` with 5-step
   episodes and 2 Adam iterations, 5 images written;
12. vec kernels: the batched kernels (K3-b, K7-fwd-b, K5-b, K8-fwd-b) at
   Move-v1 shapes for B = 8 envs against their plain versions, K5-b and
   K8-fwd-b bit for bit per env to B = 1 launches of the same kernels,
   K3-b and K7-fwd-b within tolerance of them and, at both B, under the
   four orders; kernel and plain times at B = 8 and B = 32;
13. vec: `VecPlasticineEnv("Move-v1", batch=B, device="cuda")` for B = 1, 8
   and 32, reset + 50 seeded steps, each fetching obs, reward and info
   (env steps/s, peak memory; launch counts prove that every substep ran
   each batched kernel once for the whole batch: 950 each and 50 of
   K7-fwd-b, whatever B); B = 8 without jitter: every env equals env 0, and
   env 0 equals `make("Move-v1")` after 5 steps; then vec rgb:
   `VecPlasticineEnv("Move-v1", batch=B, obs_mode="rgb")` for B = 1, 8 and
   32, reset + 50 seeded steps, each fetching the (B, 64, 64, 3) frames,
   reward and info (rgb vec env steps/s, peak memory; launch counts: one
   K9-b launch per batched step and one at reset, 51 whatever B, and no
   single-env K9 launch); at B = 8, each env's frame against the single
   env's `render_obs` of the same state, the draws of the single renders
   replayed into the batched one: equal uint8 frames; then sac: one
   `SAC.update_many_device(n=8)` of SAC(1214, 6) on the card against the
   same on the CPU (the same weights, buffer and seam draws), `train_vec` on
   `VecPlasticineEnv("Move-v1", batch=8)` for two 50-step horizons with
   start_steps 64 (744 updates; env steps/s, updates/s, the host seconds of
   collection and updates; launch counts: 19 of each batched forward kernel
   a batched step, K7-fwd-b a step and a reset, no single-env launch), and
   with obs_mode="rgb" for 5 steps and one update_many_device(n=8) of SAC on
   (64, 64, 3) frames (6 K9-b launches); then rl: the rest of the RL stack
   at its default widths on Move-v1's 1214 observations and 6 actions,
   each learner card vs CPU from the same weights, data and seam draws
   (TD3 train_many_device(n=8), OriginalDDPG 8 trains, DisCor
   update_many_device(n=8), 4 PPO _minibatch_update of 256, 11 A2C_ACKTR
   updates of 200 across the eigen refresh, 4 GAIL updates; the loss within
   1e-5, each parameter tensor within 5% of the CPU's step in L2 norm, the
   largest element against the CPU's mean step logged), train_td3_vec and
   DisCor through run_sac.train_vec at B = 8 for two 50-step horizons
   (start 64, 744 updates each), train_ppo_vec at B = 8 for one update of
   32 steps, the rgb forms of train_td3_vec and train_ppo_vec for 5 steps,
   and train_ppo(algo="acktr") on make("Move-v1") for 50 steps and one
   update; launch counts: 19 of each batched forward kernel a batched step,
   K7-fwd-b (and with rgb K9-b) a step and a reset, no single-env launch;
   19 of each single-env forward kernel an ACKTR step; env steps/s,
   updates/s, seconds per PPO update, the host seconds of collection and
   updates, the phase's own seconds;
14. vec gradient: `build_batched_rollout_grad` on Move-v1 (horizon 50,
   bench.py's actions tiled over B, `batch_states(..., jitter=1e-3)`) for
   B = 1, 8 and 32: launch counts (950 of each batched substep backward
   kernel and 50 of K7-bwd-b per gradient whatever B, the forward's doubled
   where remat recomputes, no single-env launch), seconds per gradient
   (warm-up, then best of 3), substeps/s x B, the remat policy and the peak
   memory; B = 8 without jitter: every env's gradient row equals env 0's
   and B x row 0 equals `rollout_value_and_grad`'s gradient of the single
   env; 5 steps at B = 4 through the kernels and through the plain
   versions (loss and gradient). PyTorch's cache is emptied before each B;
15. vec backward kernels: the batched backward kernels (K4-b, K7-bwd-b,
   K6-b, K8-bwd-b) at Move-v1 shapes for B = 8 envs, seeded inputs and
   cotangents, against the autograd VJP of their batched plain versions;
   per env against B = 1 launches of the same kernels: K4-b, K7-bwd-b,
   K6-b's dx and K8-bwd-b (d grid4 and d poses) bit for bit, K6-b's
   d grid_v within tolerance (atomics) and, at both B, under the four
   orders; K8-bwd-b once per primitive shape and on a batch without mass,
   each env with its own poses and softness, two calls bit for bit at
   B = 8; the share of cells, warps and K8 backward blocks with mass;
   kernel and plain times at
   B = 8 and B = 32; K1 and K2 timed on the B n particles of the batched
   path, L2-warm and L2-cold. It comes after the gradient because its plain VJPs keep their
   autograd graphs for the device times (the memory they hold is logged);
16. device times: the scatters at B = 1, 8, 32 under the sorted, a stale
   and no order with the share of global adds left (`lane_groups`), the
   gathers at each B, both at B = 1 and 32 also by CUDA events L2-cold and
   L2-warm, and `cell_order`'s own time and device operations per env
   step; each kernel and plain version under torch.profiler (`device_ops`:
   device-side events only, checked against the wrappers' launch counts,
   the median of up to three profiles; a plain version's profiles take
   PLAIN_REPS calls), K8 forward and backward at B = 1, 8 and 32, K1 / K2
   at 320,000 particles and the gathers once more and by CUDA events
   (L2-cold and L2-warm), the
   device's busy share in an rgb env step and a 1-spp frame, in 2 batched
   rgb env steps at B = 1, 8 and 32, in one SAC train_vec iteration at
   B = 32 (explore_batch, a batched step, 32 updates), in one TD3
   train_td3_vec iteration at B = 32 (its actions, a batched step, the
   buffer write, 32 updates), in one PPO update of 32 x 32 samples (with
   the runtime's launch, copy and synchronise calls), in 5 batched
   env steps and in a 2-step batched gradient at B = 1 and B = 32 with the
   device operations per batched substep (B = 32 within 1.2x of B = 1: no
   per-env loop, forward or backward), after everything else (an active
   profiler slows every later launch).
Prints a JSON line of the kernels (`max_abs_err` and `rel_err`: the largest
error against the plain version and the same relative to the scale the
check used; `ms` and `plain_ms`: device time per call from torch.profiler,
or where every profile lost events the L2-warm CUDA-event median less the
events' own time around an empty call (the log says which); for a backward
kernel, the plain version's time is that of its autograd backward alone; `bound_ms`: the least time of the same work
on an H100 at its published peaks, from this run's inputs; `library_ms`:
the device time of K9's min as one `scatter_reduce_` on its int64 volume,
else null: no single PyTorch call computes the other functions), then as
the last line {"ok": true, "device": {...}}.
"""
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import zlib
from types import SimpleNamespace

import numpy as np

DEVICE = "cuda"
SEED = 0
STEPS = 50
KERNEL_REPS = 20
PLAIN_REPS = 5  # calls per profile of a plain version in the device-times phase

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

# Backward kernels vs the autograd VJP of the plain version, both float32 on
# the card, relative to the largest |value| of the plain VJP:
# - stress: the SVD adjoint multiplies rounding by the damped inverse
#   eigengap (up to 1/(2 * 1e-3) at near-repeated singular values);
# - transfers: sums of 27 stencil terms in another order (K6 and the plain
#   version scatter with atomics);
# - grid update: d grid4 divides by the cell mass (tiny at the cloud's edge,
#   so the values span many decades: it is held both to the largest value
#   and to each cell's own; rows beyond tolerance count against FLIP_BUDGET
#   as in the forward); the pose cotangents sum ~1e5 cell terms
#   of both signs; for the box, whose normal is a central difference with
#   d = 1e-4, its derivative amplifies float32 rounding by ~1/d.
BWD_TOL = {"stress_affine_bwd": 1e-4, "p2g_bwd": 1e-5, "grid_mass_bwd": 1e-5,
           "g2p_bwd": 1e-5, "grid_op_bwd": 1e-3}
# The stress kernels where the SVD is hardest (`stress_cases`, Move-v1's own
# C and F) are held to the float64 plain version, relative to its largest
# value, each output (K1's new F and affine, K2's gC and gF) within
# TOL / BWD_TOL or the case's fixed limit below. Float32 itself cannot hold
# 1e-4 there: near a rotation the stress 2 mu (F - R) F^T cancels to
# ~dt |C| of F, so rounding in F - R reaches ~7e-4 of the affine; at
# near-equal singular values the damped inverse eigengap multiplies rounding
# in the gap by up to 1 / eps^2 = 1e6. Each limit is about twice the largest
# error that the float32 plain version, the kernels and their predecessors
# (IEEE divisions and square roots) showed on these cases at four seeds and
# on three Move-v1 rollouts (the readings: PERF.md).
HARD_TOL = {"identity": (1e-4, 1.5e-3, 3e-4, 3e-4), "rotation": (1e-4, 1.5e-3, 3e-4, 3e-4),
            "two equal": (1e-4, 1e-4, 1e-2, 1e-2), "yielding": (1e-4, 1e-4, 5e-4, 5e-4),
            "Move-v1": (1e-4, 1e-4, 3e-4, 3e-4)}
POSE_TOL = {"Box": 1e-2}  # else BWD_TOL["grid_op_bwd"]
# 5 Move-v1 env steps, kernels vs plain versions from the same state and
# actions, both float32: the loss relative, the gradient relative to its
# largest entry (atomics reorder sums; contact amplifies the difference).
GRAD_STEPS = 5
GRAD_TOL = {"loss": 1e-4, "grad": 2e-2}
# Move-v1 from reset, 2 steps of REF_GRAD_ACTIONS: the summed loss and its
# (2, 6) gradient from the reference package (`plasticinelab_tpu`
# PhysicsEnv.rollout_value_and_grad, float32, on the CPU). Bounds: the loss
# to REF_TOL relative, the gradient to REF_GRAD_TOL of its largest entry:
# the port in float64 on the CPU differs from these float32 values by
# 3.2e-3 of the largest entry (float32 rounding through 38 substeps).
REF_GRAD_ACTIONS = ((0.5, -0.3, 0.2, -0.4, 0.1, 0.6), (-0.2, 0.4, -0.1, 0.3, -0.5, 0.2))
REF_GRAD_LOSS = 26.55014419555664
REF_GRAD = ((-0.008081410080194473, -0.011613520793616772, -0.00167021993547678,
             -0.005849147215485573, -0.011308235116302967, -0.0017285578651353717),
            (-0.002290531760081649, -0.002143296180292964, -0.0006147465319372714,
             -0.0016266338061541319, -0.0025938008911907673, -0.00096789380768314))
REF_GRAD_TOL = 1e-2
HORIZON = 50
TRAJ_RUNS = 3
SOLVE_ITERS = 3

# The Move-v1 initial state's packed volumes, computed by the reference
# package (`Renderer._packed_volume`, its scatter path, float32 on the CPU):
# cells with an sdf byte below 255, the sum of the sdf bytes, and the CRC32
# of the little-endian uint32 volume. Equal on the card, or the voxelizer
# is wrong.
REF_VOLUMES = {"frame": dict(unsaturated=33719, sdf_sum=1203810177, crc32=1505687680),
               "obs": dict(unsaturated=4223, sdf_sum=150476495, crc32=2100524766)}
# Move-v1 initial state, `Renderer.probe_rays` of these rays (shape and
# primitives on, ghost off) by the reference package on the CPU: 3 hit the
# plasticine, 3 a sphere, 2 the ground. Bounds: distances 1e-3 absolute
# (float32 march; sums of 8 corner terms in another order may move a
# threshold crossing within the refinement's h/8 = 1.25e-3 bracket),
# normals 1e-2 (the normal of the trilinear field at that point), colours
# 1e-2 (trilinear colour at that point).
PROBE_O = ((0.676, 1.5, 0.752), (0.676, 0.562, 3.0), (0.3, 0.9, 1.2), (0.2, 0.562, 0.7516),
           (1.2, 0.5619, 0.7516), (0.79, 0.562, 2.0), (0.2, 1.0, 0.2), (0.5, 1.2, 4.0))
PROBE_D = ((0.0, -1.0, 0.0), (0.0, 0.0, -1.0),
           (0.5566102266311646, -0.5003570914268494, -0.6631951928138733),
           (1.0, 0.0, 0.0), (-1.0, 0.0, 0.0), (0.0, 0.0, -1.0), (0.0, -1.0, 0.0),
           (-0.051349617540836334, -0.3080976903438568, -0.9499679207801819))
PROBE_CLOSEST = (0.83694315, 2.1467724, 0.57519835, 0.3457144, 0.39428574, 1.2220218,
                 1.002, 3.90136)
PROBE_NORMAL = ((-0.06347261369228363, 0.9979826807975769, -0.0013973878230899572),
                (-0.09832314401865005, 0.022824786603450775, 0.9948927164077759),
                (-0.44960907101631165, 0.5519470572471619, 0.702286422252655),
                (-0.9999960660934448, 0.002793468302115798, 6.556504376931116e-05),
                (0.9999998807907104, -0.0005384280229918659, 6.556503649335355e-05),
                (0.47619137167930603, 0.0027934706304222345, 0.8793372511863708),
                (0.0, 1.0, 0.0), (0.0, 1.0, 0.0))
PROBE_COLOR = ((0.49804688, 0.0, 0.0),) * 3 + ((0.7, 0.7, 0.7),) * 3 + (
    (0.105000004, 0.175, 0.24499999),) * 2
PROBE_TOL = {"closest": 1e-3, "normal": 1e-2, "color": 1e-2}
VEC_B = 8             # envs in the batched kernel checks and the parity check
VEC_BATCHES = (1, 8, 32)
VEC_STEPS = 50        # batched env steps per B
VEC_PARITY_STEPS = 5
VEC_PROFILE_STEPS = 5
VEC_LAUNCH_RATIO = 1.2  # device operations per substep, B = 32 over B = 1
VEC_GRAD_JITTER = 1e-3
VEC_GRAD_SHORT = (4, 5)       # (B, steps) of the batched kernels-vs-plain gradient
VEC_GRAD_PROFILE_STEPS = 2    # horizon of the profiled batched gradient
# B envs without jitter under the same actions, HORIZON steps, all through
# the kernels: the envs' gradient rows against env 0's, and B x row 0
# against the single env's trajectory gradient, relative to the largest
# entry. The runs differ only in the order in which float atomics sum (K3,
# K6, K7 forward scatter; under remat the recomputed grids differ from the
# first pass's in the last bits too), which contact amplifies over the 950
# substeps; the bound is the one 5 steps of kernels vs plain versions are
# held to.
VEC_ROW_TOL = {"loss": 1e-4, "grad": 2e-2}
RENDER_STEPS = 5      # Move-v1 steps before the frame
RGB_STEPS = 50        # rgb-observation env steps
VOX_BATCHES = (8, 32)  # envs of the batched voxelizer checks
VOX_JITTER = 1e-3     # per-env noise of Move-v1's cloud there, world units
RGB_PROFILE_STEPS = 2  # batched rgb env steps profiled per B
SOLVE_ACTION_T = 5    # solve_action's episode length; 2 Adam iterations

# The NN policy's 2-step gradient: Move-v1 from reset, the default
# MLPPolicy (hidden (256, 256), 200 observed particles: dims (1214, 256,
# 256, 6)) with init_params(0), softness 666: the summed loss and d loss /
# d params (get_params order W0, b0, W1, b1, W2, b2) from the reference
# package (its MLPPolicy and the rollout of its SolverNN,
# `optimizer/solver_nn.py:44-57`, one jitted value_and_grad, float32, on the
# CPU): the loss, each layer's gradient norm and largest |entry|, and 16
# fixed entries (flat index, value): per layer its largest entry, the others
# drawn with numpy's default_rng(0) among entries of at least 0.2 of the
# layer's largest. The port's float32 plain versions on the CPU read within
# 1.4e-6 of each layer's largest entry and 7.4e-7 of each norm. Bounds: the
# loss to REF_TOL relative, a norm to REF_GRAD_TOL relative, an entry to
# REF_GRAD_TOL of its layer's largest |entry| (float32 atomics through 38
# substeps, as for REF_GRAD).
NN_STEPS = 2
REF_NN_LOSS = 26.55261993408203
REF_NN_LAYERS = {"W0": (0.07157686493172427, 0.0013063875958323479),
                 "b0": (0.004331694246716746, 0.0013063875958323479),
                 "W1": (0.030193671195802685, 0.0016066281823441386),
                 "b1": (0.010187097618848616, 0.0022692368365824223),
                 "W2": (0.03278559472277781, 0.004311373457312584),
                 "b2": (0.026052467106509623, 0.01568620093166828)}
REF_NN_ENTRIES = ((150525, 0.0013063875958323479), (310280, -0.00026206934126093984),
                  (309824, -0.0002870793978217989), (298880, 0.0004692707152571529),
                  (310907, 0.0013063875958323479), (310963, 0.0005455004866234958),
                  (321035, 0.0016066281823441386), (343547, 0.00036189358797855675),
                  (320149, 0.0004991400055587292), (376615, 0.0022692368365824223),
                  (376808, -0.0006054886616766453), (378041, -0.004311373457312584),
                  (377859, -0.0015406595775857568), (377112, -0.001161701511591673),
                  (378372, -0.01568620093166828), (378368, -0.006076232064515352))
NN_SOLVE_ITERS = 3    # SolverNN.solve_device iterations, horizon HORIZON, Adam, lr 0.1
NN_REPLAY_STEPS = 5   # policy.act steps of the replay
# SAC: one update_many_device(n=SAC_UPDATES) of SAC(1214, 6) on the card
# against the same on the CPU from the same weights, buffer and seam draws,
# both float32. Bounds: the loss to SAC_LOSS_TOL relative; every parameter
# and log_alpha to SAC_PARAM_TOL of one Adam step (lr 3e-4) absolute: Adam
# moves a parameter by about lr whatever its gradient's size, so rounding in
# the gradient shows as a share of a step; float32 against float64 on the CPU
# differ by 1.1% of a step after 8 updates at these shapes.
SAC_B = 8             # envs of the collection runs
SAC_UPDATES = 8
SAC_BATCH = 256
SAC_ROWS = 2048       # transitions in the buffer of the device check
SAC_LOSS_TOL = 1e-5
SAC_PARAM_TOL = 0.05
SAC_START = 64        # start_steps of the state collection run (2 horizons)
SAC_RGB_STEPS = 5     # batched rgb steps, then one update_many_device(n=SAC_B)

# Phase rl: the rest of the RL stack (TD3, OriginalDDPG, DisCor, PPO, ACKTR,
# GAIL) at the learners' default widths on Move-v1's observations (1214) and
# actions (6). Each learner's updates on the card against the same on the
# CPU from the same weights, data and seam draws, both float32: the loss to
# SAC_LOSS_TOL relative; every parameter tensor's difference to
# RL_PARAM_TOL of the step the CPU took (L2 norms of card - CPU and of the
# CPU's change). The largest single element is logged against the CPU's
# mean step per update, not bounded: Adam moves an element whose gradient
# sits near its eps (1e-8) by g / (|g| + eps) of a step, so float32 noise
# in a gradient 1e7 times below its layer's largest moves it by a share of
# a step (`tools/rl_precision.py` shows it for GAIL, in float32 and float64).
RL_UPDATES = 8        # TD3, OriginalDDPG, DisCor updates of the check
RL_PPO_MB = 256       # samples of PPO's checked minibatches
RL_PPO_STEPS = 4      # _minibatch_update calls of the check
RL_KFAC_ROWS = 200    # ACKTR's rollout (run_ppo.train_ppo's default for acktr)
RL_KFAC_UPDATES = 11  # crosses the eigen refresh at Tf = 10
RL_GAIL_UPDATES = 4
RL_PARAM_TOL = 0.05
RL_PPO_T = 32         # train_ppo_vec's rollout_len at SAC_B envs: one update
RL_ACKTR_T = 50       # train_ppo(algo="acktr") on one env: rollout and steps
RL_PROFILE_T = 32     # rollout_len of the profiled PPO update at B = 32

# The card's published peaks (H100 SXM, NVIDIA's data sheet, dense, at
# 700 W): HBM bytes/s and float32 operations/s outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
# Operations per item of each kernel, counted from its source (an add,
# multiply, compare, sqrt, exp or log is one; an fma two; index arithmetic
# not counted): per particle for the stress and transfer kernels, per cell
# with mass for the grid update, per (particle, offset) update that lands
# in the volume for the voxelizer. A grid that a kernel only gathers from under its particles
# (K4, K5, K6, K7 backward), and the cotangent that K8 backward reads only
# at cells with mass, count by the cells read (`Gathered`): what this run's
# data needs, not the whole grid.
# The stress kernels' counts are those of `csrc/stress.cu` run for one
# particle with every float operation counted (K2 recomputes K1's chain
# before its adjoint; SASS has 1,848 and 2,752 instructions per particle).
OPS_PER_ITEM = {"stress_affine": 2093, "stress_affine_bwd": 3141, "p2g": 900,
                "p2g_bwd": 1800, "grid_mass": 150, "grid_mass_bwd": 300, "g2p": 700,
                "g2p_bwd": 1400, "grid_op": 300, "grid_op_bwd": 1500, "voxelize": 13}
# the batched kernels do B times the work of the single-env ones
BATCHED_FWD = {"p2g_batched": "p2g", "grid_mass_batched": "grid_mass", "g2p_batched": "g2p",
               "grid_op_batched": "grid_op"}
BATCHED_BWD = {"p2g_bwd_batched": "p2g_bwd", "grid_mass_bwd_batched": "grid_mass_bwd",
               "g2p_bwd_batched": "g2p_bwd", "grid_op_bwd_batched": "grid_op_bwd"}
BATCHED = {**BATCHED_FWD, **BATCHED_BWD}
OPS_PER_ITEM.update({k: OPS_PER_ITEM[v] for k, v in BATCHED.items()})
OPS_PER_ITEM["voxelize_batched"] = OPS_PER_ITEM["voxelize"]

REPLACES = {
    "stress_affine": "plasticinelab_tpu/engine/pallas_stress.py:201",
    "p2g": "plasticinelab_tpu/engine/pallas_local.py:163",
    "grid_mass": "plasticinelab_tpu/engine/pallas_local.py:943",
    "grid_op": "plasticinelab_tpu/engine/pallas_gridop.py:82",
    "g2p": "plasticinelab_tpu/engine/pallas_local.py:223",
    "stress_affine_bwd": "plasticinelab_tpu/engine/pallas_stress.py:222",
    "p2g_bwd": "plasticinelab_tpu/engine/pallas_local.py:288",
    "grid_mass_bwd": "plasticinelab_tpu/engine/pallas_local.py:970",
    "grid_op_bwd": "plasticinelab_tpu/engine/pallas_gridop.py:97",
    "g2p_bwd": "plasticinelab_tpu/engine/pallas_local.py:388",
    "voxelize": "plasticinelab_tpu/engine/renderer/pallas_voxelize.py:69",
    # the same pallas_call, vmapped over the envs (parallel/rollout.py:148)
    "voxelize_batched": "plasticinelab_tpu/engine/renderer/pallas_voxelize.py:163",
    "p2g_batched": "plasticinelab_tpu/engine/pallas_local.py:767",
    "grid_mass_batched": "plasticinelab_tpu/engine/pallas_local.py:892",
    "grid_op_batched": "plasticinelab_tpu/engine/pallas_gridop.py:234",
    "g2p_batched": "plasticinelab_tpu/engine/pallas_local.py:793",
    "p2g_bwd_batched": "plasticinelab_tpu/engine/pallas_local.py:780",
    "grid_mass_bwd_batched": "plasticinelab_tpu/engine/pallas_local.py:904",
    "grid_op_bwd_batched": "plasticinelab_tpu/engine/pallas_gridop.py:247",
    "g2p_bwd_batched": "plasticinelab_tpu/engine/pallas_local.py:805",
}
SOURCES = {
    "stress_affine": "plasticinelab_tpu_torch/csrc/stress.cu",
    "p2g": "plasticinelab_tpu_torch/csrc/transfer.cu",
    "grid_mass": "plasticinelab_tpu_torch/csrc/transfer.cu",
    "grid_op": "plasticinelab_tpu_torch/csrc/gridop.cu",
    "g2p": "plasticinelab_tpu_torch/csrc/transfer.cu",
    "stress_affine_bwd": "plasticinelab_tpu_torch/csrc/stress.cu",
    "p2g_bwd": "plasticinelab_tpu_torch/csrc/transfer.cu",
    "grid_mass_bwd": "plasticinelab_tpu_torch/csrc/transfer.cu",
    "grid_op_bwd": "plasticinelab_tpu_torch/csrc/gridop.cu",
    "g2p_bwd": "plasticinelab_tpu_torch/csrc/transfer.cu",
    "voxelize": "plasticinelab_tpu_torch/csrc/voxelize.cu",
}
SOURCES.update({k: SOURCES[v] for k, v in BATCHED.items()})
SOURCES["voxelize_batched"] = SOURCES["voxelize"]
# kernels whose device time is read again in the device-times phase, beside
# CUDA events L2-cold and L2-warm: readings that spread across runs of
# unchanged code (K1 at the batched path's 320,000 particles), the gathers
# and K8 forward and backward at B = 1, 8 and 32
SPREAD_KEYS = ("grid_op", "grid_op_batched[B=8]", "grid_op_batched", "grid_op_bwd",
               "grid_op_bwd_batched[B=8]", "grid_op_bwd_batched", "stress_affine[n=320000]",
               "stress_affine_bwd[n=320000]", "g2p", "p2g_bwd", "grid_mass_bwd", "g2p_batched",
               "p2g_bwd_batched", "grid_mass_bwd_batched")
SHAPE_PARAMS = {
    "Sphere": dict(radius=0.06),
    "Capsule": dict(h=0.1, r=0.04),
    "RollingPin": dict(h=0.3, r=0.03),
    "Chopsticks": dict(h=0.15, r=0.02, init_gap=0.06),
    "Cylinder": dict(h=0.06, r=0.05),
    "Torus": dict(tx=0.06, ty=0.025),
    "Box": dict(size=(0.05, 0.04, 0.06)),
}
# Several primitives of mixed shapes (Rope-v1's two Spheres and Cylinder,
# and a Box): the grid update's all-shapes kernels at k > 1, a Sphere beside
# other shapes (a scene of Spheres alone takes the sphere-only kernels).
MIXED_SHAPES = ("Sphere", "Sphere", "Cylinder", "Box")


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


def sass_counts(lib):
    """kernel symbol -> (SASS instructions, MUFU, CALL) of a built library,
    from `cuobjdump -sass` beside nvcc."""
    from plasticinelab_tpu_torch.engine import cuda_build

    tool = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    out, counts = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                                 check=True).stdout, {}
    for line in out.splitlines():
        if "Function : " in line:
            cur = counts.setdefault(line.split("Function : ")[1].strip(), [0, 0, 0])
        elif re.search(r"/\*[0-9a-f]{4,}\*/\s", line):
            op = line.split("*/", 1)[1].split()
            op = op[1] if op[0].startswith("@") else op[0]  # past a predicate
            cur[0] += 1
            cur[1] += op.startswith("MUFU")
            cur[2] += op.startswith("CALL")
    return counts


# The port's kernels, each launched once per launch that its wrapper counts
# (K8 backward sums its pose cotangents in the same launch: one kernel; a K9
# launch runs `voxel_fill_kernel` once, beside its sort and scatter).
PORT_KERNELS = re.compile(r"\b(?:stress_affine_kernel|stress_affine_bwd_kernel|p2g_kernel|"
                          r"p2g_bwd_kernel|g2p_kernel|g2p_bwd_kernel|grid_op_kernel|"
                          r"grid_op_bwd_kernel|voxel_fill_kernel)\b")


def counted_launches():
    """The launches that the port's wrappers have counted so far."""
    from plasticinelab_tpu_torch.engine import cuda_gridop, cuda_stress, cuda_transfer
    from plasticinelab_tpu_torch.engine.renderer import cuda_voxelize

    return sum(sum(m.launches.values())
               for m in (cuda_stress, cuda_transfer, cuda_gridop, cuda_voxelize))


def device_events(prof):
    """The device-side events of a profile: kernels, memsets and copies, not
    the runtime calls that launched them."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def profiled(run, cpu=False):
    """A torch.profiler profile (device activity; with cpu, host activity
    too) of run(), which ends in a synchronisation, and the launches that
    the port's wrappers counted during it."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    before = counted_launches()
    with profile(activities=activities) as prof:
        run()
    return prof, counted_launches() - before


def device_ops(fn, reps=KERNEL_REPS, takes=3):
    """(device ms, device operations) per call of fn(): the summed time and
    the count of the device-side events of reps calls, from torch.profiler
    (`profiled`), the median of up to `takes` profiles (two that agree
    within 5% suffice). Late in a run
    profiles lose events, whole calls of them (PERF.md), which a sum over
    reps calls would under-read. So a profile counts only if its events of
    the port's kernels number the launches that the wrappers counted over
    the same calls and all its events are a multiple of reps (each call
    runs the same work); failing that, if its port's kernels make up at
    least half of the calls whole and its events a multiple of those calls,
    it times the calls it kept. The median outvotes a profile that kept
    every event but read a call at half its time (once, PERF.md).
    (None, None) where no profile passed."""
    import torch

    def run():
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    readings = []
    for attempt in range(takes):
        prof, launched = profiled(run)
        events = device_events(prof)
        ours = sum(bool(PORT_KERNELS.search(e.name)) for e in events)
        calls = reps
        if not (events and ours == launched and len(events) % reps == 0):
            per_call = launched // reps
            calls = ours // per_call if per_call and launched % reps == 0 else 0
            if not (calls >= reps / 2 and ours == calls * per_call and len(events) % calls == 0):
                log(f"    profile {attempt + 1} lost events: {len(events)} device events for "
                    f"{reps} calls, {ours} of the port's kernels for {launched} launches")
                continue
            log(f"    profile {attempt + 1} kept {calls} of {reps} calls whole: timing those")
        readings.append((sum(e.device_time_total for e in events) / 1e3 / calls,
                         len(events) / calls))
        if len(readings) == 2 and abs(readings[0][0] - readings[1][0]) <= 0.05 * readings[0][0]:
            break
    if not readings:
        return None, None
    return sorted(readings)[(len(readings) - 1) // 2]


def device_time(fn, reps=KERNEL_REPS):
    """ms per call of fn() on the device (`device_ops`; None if every
    profile lost events)."""
    return device_ops(fn, reps)[0]


L2_FLUSH_BYTES = 512 << 20  # 10x the H100's 50 MB L2
SLEEP_CYCLES = 400_000      # ~0.2 ms of the device: as long as that read


def cold_time(fn, reps=KERNEL_REPS):
    """(L2-cold, L2-warm) ms per call of fn(), the median of CUDA events
    around each call alone. The call is queued behind a read of
    L2_FLUSH_BYTES (cold: the L2 holds none of its data) or behind a device
    sleep as long (warm: the data of the call before); either way the device
    is still busy when the host has queued the call, so no launch time counts."""
    import torch

    flush = torch.ones(L2_FLUSH_BYTES // 4, device=DEVICE)
    times = {"cold": [], "warm": []}
    fn()
    for _ in range(reps):
        for kind in times:
            flush.sum() if kind == "cold" else torch.cuda._sleep(SLEEP_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            times[kind].append((start, end))
    torch.cuda.synchronize()
    return tuple(float(np.median([s.elapsed_time(e) for s, e in times[k]])) for k in times)


def log_cold_time(key, fn):
    cold, warm = cold_time(fn)
    log(f"  {key:28s} ms/call L2-cold {cold:.4f}  L2-warm {warm:.4f} (CUDA events, median)")


class Gathered:
    """An input grid of which a call needs only `share` of the cells: the
    gathers of K4, K5, K6 and K7 backward read only the cells under their
    particles' stencils (`touched_share`), K8 backward its cotangent only at
    cells with mass (`mass_share`)."""

    def __init__(self, grid, share):
        self.grid, self.share = grid, share


def touched_share(scene, x):
    """The share of grid cells under the 27-cell stencils of particles x
    (n, 3) or (B, n, 3): the cells of non-zero mass."""
    from plasticinelab_tpu_torch.engine import cuda_transfer

    mass = cuda_transfer.grid_mass_plain_batched(scene, x.reshape((-1,) + x.shape[-2:]))
    return float((mass > 0).double().mean())


def mass_share(grid4):
    """The share of cells with mass in grid4 (G^3, 4) or (B, G^3, 4)."""
    return float((grid4[..., 3] > 1e-12).double().mean())


def mixed_scene(scene):
    """scene with the primitives of MIXED_SHAPES, at SHAPE_PARAMS' sizes."""
    from plasticinelab_tpu_torch.config.spec import PrimitiveSpec

    return scene.replace(primitives=tuple(
        PrimitiveSpec(shape=s, friction=0.9, **SHAPE_PARAMS[s]) for s in MIXED_SHAPES))


def pose_tols(scene):
    """Each primitive's tolerance on its pose cotangents."""
    return tuple(POSE_TOL.get(p.shape, BWD_TOL["grid_op_bwd"]) for p in scene.primitives)


def compare_poses(name, got, want, tol):
    """K8 backward's pose cotangents (..., k, 16) against want: within tol
    of the largest; with a tuple, each primitive's rows within its own tol
    of their largest, and each primitive must have a pose gradient."""
    if not isinstance(tol, tuple):
        compare(f"{name} d poses", (got.reshape(-1, 16),), (want.reshape(-1, 16),), tol)
        return
    for i, t in enumerate(tol):
        w = want[..., i, :].reshape(-1, 16)
        compare(f"{name} d poses [primitive {i}]", (got[..., i, :].reshape(-1, 16),), (w,), t)
        if not float(w.abs().max()) > 0:
            raise AssertionError(f"{name}: primitive {i} has no pose gradient")


def mass_shares(label, grid4):
    """Logs the share of cells with mass in grid4 (G^3, 4) or (B, G^3, 4),
    and of warps (32 cells) and of K8 backward blocks with any."""
    import torch

    from plasticinelab_tpu_torch.engine import cuda_gridop

    m = (grid4[..., 3] > 1e-12).reshape(-1, grid4.shape[-2])
    per = cuda_gridop.BWD_BLOCK_CELLS
    blocks = torch.cat([m, m.new_zeros((m.shape[0], -m.shape[1] % per))], dim=1)
    log(f"  {label}: cells with mass {float(m.double().mean()):.5f} ({int(m.sum())} of "
        f"{m.numel()}), warps (32 cells) with any "
        f"{float(m.reshape(m.shape[0], -1, 32).any(-1).double().mean()):.5f}, K8 backward "
        f"blocks ({per} cells) with any "
        f"{float(blocks.reshape(m.shape[0], -1, per).any(-1).double().mean()):.5f}")


def contact_cells(scene, grid4, pose_f, softness):
    """(cells with mass where some primitive's contact condition holds on the
    float SDF, cells with mass next to one of those (6 neighbours) where none
    holds) of one env's grid4 (G^3, 4) at poses pose_f (pos (k, 3), rot
    (k, 4), gap (k,))."""
    import torch

    from plasticinelab_tpu_torch.engine import cuda_gridop
    from plasticinelab_tpu_torch.engine import primitives as prim

    G = scene.simulator.n_grid
    gp = cuda_gridop.grid_coords(G, grid4.device).to(grid4.dtype) * scene.simulator.dx
    hit = torch.zeros(G ** 3, dtype=torch.bool, device=grid4.device)
    for i, p in enumerate(scene.primitives):
        d = prim.sdf(p, pose_f[0][i], pose_f[1][i], pose_f[2][i], gp)
        hit |= (torch.clamp(torch.exp(-d * softness), max=1.0) > 0.1) | (d <= 0)
    mass = grid4[:, 3] > 1e-12
    hit = (hit & mass).reshape(G, G, G)
    near = torch.zeros_like(hit)
    for d in range(3):
        n = hit.shape[d]
        near.narrow(d, 1, n - 1).logical_or_(hit.narrow(d, 0, n - 1))
        near.narrow(d, 0, n - 1).logical_or_(hit.narrow(d, 1, n - 1))
    return hit.reshape(-1), (near & ~hit).reshape(-1) & mass


def bound(name, tensors, items):
    """(bound_ms, bound_by): the least time an H100 needs for a call whose
    inputs and outputs are `tensors` (each read or written once; of a
    `Gathered` grid only its share) and whose work is `items` x
    OPS_PER_ITEM[name] float32 operations."""
    def nbytes(t):
        if isinstance(t, Gathered):
            return t.share * nbytes(t.grid)
        return t.numel() * t.element_size()

    t_bytes = sum(map(nbytes, tensors)) / PEAK_BYTES_S
    t_ops = items * OPS_PER_ITEM[name] / PEAK_F32_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def record(results, key, name, err, kern, plain, inputs, items):
    """Times kernel `name` and its plain version (for a backward kernel: the
    plain version's autograd backward alone) with CUDA events, bounds the
    call from its inputs and outputs, and keeps both calls under
    results[key] for the device times. err: `compare`'s (max_abs, max_rel)."""
    k_wall, p_wall = wall_time(kern), wall_time(plain)
    b_ms, b_by = bound(name, list(inputs) + list(as_tuple(kern())), items)
    max_abs, max_rel = err
    results[key] = dict(max_abs_err=max_abs, rel_err=max_rel, ms=k_wall, plain_ms=p_wall,
                        bound_ms=b_ms, bound_by=b_by, library_ms=None, calls=(kern, plain))
    log(f"  {key:28s} wall ms/call: kernel {k_wall:.4f}  plain {p_wall:.4f}  "
        f"bound {b_ms:.5f} ({b_by})")


def compare(name, got, want, tol, flip_budget=0, per_row=False):
    """(max abs, max rel) error of got vs want (tuples of tensors); rows
    (cells or particles) beyond tol x max|want| count as flips, at most
    flip_budget. per_row: relative to each row's own largest |want| instead,
    for values that span many decades. The relative error is the one the
    check used: of the largest value, or of the row."""
    import torch

    max_abs, max_rel, flips = 0.0, 0.0, 0
    for g, w in zip(got, want):
        g = g.double().reshape(g.shape[0], -1)
        w = w.double().reshape(w.shape[0], -1)
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name}: non-finite kernel output")
        scale = float(w.abs().max()) or 1.0
        if per_row:
            scale = w.abs().amax(dim=1).clamp(min=1e-30 * scale)
        err = (g - w).abs().amax(dim=1)
        bad = err > tol * scale
        flips += int(bad.sum())
        good = ~bad
        if bool(good.any()):
            max_abs = max(max_abs, float(err[good].max()))
            max_rel = max(max_rel, float((err / scale)[good].max()))
    scope = "of its row" if per_row else "of the largest"
    log(f"  {name:28s} max_abs {max_abs:.3e}  max_rel {max_rel:.3e}  "
        f"(tol {tol:.0e} {scope})  flipped rows {flips} (budget {flip_budget})")
    if flips > flip_budget:
        raise AssertionError(f"{name}: {flips} rows beyond tolerance {tol}")
    return max_abs, max_rel


def tensor(a):
    import torch

    return torch.tensor(np.ascontiguousarray(a, np.float32), device=DEVICE)


def move_scene():
    """Move-v1's scene at its own particle count, and its initial cloud."""
    from plasticinelab_tpu_torch.engine.shapes import build_particles
    from plasticinelab_tpu_torch.envs.env import PlasticineEnv

    scene = PlasticineEnv.load_scene("move", 1)
    x_np, _ = build_particles(scene.shapes)
    return scene.with_n_particles(len(x_np)), x_np


ORDERS = ("none", "sorted", "stale", "random")


def scatter_orders(scene, x, v, seed):
    """The four particle orders each scatter kernel is held to, for x and v
    (n, 3) or (B, n, 3): none (the particles as they lie), the `cell_order`
    of x (what an env step computes at its entry), a stale one (the
    `cell_order` of the positions one env step of v earlier) and a random
    permutation per env."""
    import torch

    from plasticinelab_tpu_torch.engine.transfer import cell_order

    sim = scene.simulator
    gen = torch.Generator().manual_seed(seed)
    rand = torch.stack([torch.randperm(x.shape[-2], generator=gen)
                        for _ in range(x.numel() // (3 * x.shape[-2]))])
    rand = rand.reshape(x.shape[:-1]).to(device=x.device, dtype=torch.int32)
    return {"none": None, "sorted": cell_order(scene, x),
            "stale": cell_order(scene, x - sim.substeps * sim.dt * v), "random": rand}


def worst(errs):
    """The largest (max_abs, max_rel) of `compare`'s results."""
    return max(e[0] for e in errs), max(e[1] for e in errs)


def test_poses(k, seed, center):
    """Poses at f and f+1 of k primitives around center: random unit
    rotations, a small rigid motion between the two."""
    r = np.random.default_rng(seed)
    pos = center + r.uniform(-0.03, 0.03, (k, 3))
    rot = r.standard_normal((k, 4))
    rot /= np.linalg.norm(rot, axis=1, keepdims=True)
    gap = np.full(k, 0.06)
    w = r.standard_normal((k, 4)) * 0.003
    rot1 = (rot + w) / np.linalg.norm(rot + w, axis=1, keepdims=True)
    return ((tensor(pos), tensor(rot), tensor(gap)),
            (tensor(pos + r.normal(0, 1e-3, (k, 3))), tensor(rot1), tensor(gap - 1e-4)))


def batch_poses(B, k, seed, center):
    """`test_poses` of B envs, each from its own seed, stacked to a leading B."""
    import torch

    poses = [test_poses(k, seed + b, center) for b in range(B)]
    return (tuple(torch.stack([p[0][j] for p in poses]) for j in range(3)),
            tuple(torch.stack([p[1][j] for p in poses]) for j in range(3)))


def random_grid(rng, G):
    """Every cell massive or empty at random, velocities O(1): the walls and
    the three ground regimes of the 50 tasks (friction 0, < 10, >= 10)."""
    m = rng.uniform(1e-6, 1e-4, G ** 3) * (rng.random(G ** 3) > 0.25)
    vel = rng.standard_normal((G ** 3, 3))
    return tensor(np.concatenate([vel * m[:, None], m[:, None]], axis=1))


def proper_rotations(rng, n):
    """n random rotations (det +1)."""
    q = np.linalg.qr(rng.standard_normal((n, 3, 3)))[0]
    return q * np.sign(np.linalg.det(q))[:, None, None]


def stress_cases(n, seed):
    """name -> (C, F), each (n, 3, 3) float64: the stress kernels' inputs
    where the SVD is hardest, beside the random set of the kernel phase.
    C = 2 N(0, 1) as there, but where named "static" (C = 0: Ft = F)."""
    rng = np.random.default_rng(seed)
    C = rng.standard_normal((n, 3, 3)) * 2.0
    R1, R2 = proper_rotations(rng, n), proper_rotations(rng, n)

    def singular(s):
        return R1 @ (s[:, :, None] * np.eye(3)) @ R2.transpose(0, 2, 1)

    one = np.ones(n)
    eye = np.tile(np.eye(3), (n, 1, 1))
    near = eye + rng.standard_normal((n, 3, 3)) * 0.15
    return {
        "random": (C, near),
        "identity, static": (np.zeros((n, 3, 3)), eye),
        "identity": (C, eye),
        "rotation": (C, R1),
        "two equal": (C, singular(np.stack([1.2 * one, 0.9 * one, 0.9 * one], 1))),
        "below clamp": (C, singular(np.stack([1.1 * one, 0.95 * one, 0.02 * one], 1))),
        "scaled 1e-3": (C, near * 1e-3),
        "scaled 1e3": (C, near * 1e3),
        "yielding": (C, singular(np.exp(rng.uniform(-0.4, 0.4, (n, 3))))),
    }


def move_stress_inputs(steps, seed):
    """C and F of Move-v1's particles after `steps` env steps of seeded
    random actions through the kernels: what the main path feeds K1 and K2."""
    from plasticinelab_tpu_torch.envs import make

    env = make("Move-v1", device=DEVICE)
    env.reset()
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        env.step(rng.uniform(-1, 1, env.action_space.shape))
    st = env.unwrapped.taichi_env.state
    return st.C.clone(), st.F.clone()


def phase_kernels():
    import dataclasses

    import torch

    from plasticinelab_tpu_torch.config.spec import PrimitiveSpec
    from plasticinelab_tpu_torch.engine import cuda_gridop, cuda_stress, cuda_transfer
    from plasticinelab_tpu_torch.engine.state import default_materials

    scene, x_np = move_scene()
    sim = scene.simulator
    n, G = len(x_np), sim.n_grid
    log(f"phase kernels: Move-v1 shapes, n={n} particles, G={G} grid, seed {SEED}")
    rng = np.random.default_rng(SEED)
    t = tensor

    mats = default_materials(scene)
    C = t(rng.standard_normal((n, 3, 3)) * 2.0)
    F = t(np.eye(3) + rng.standard_normal((n, 3, 3)) * 0.15)
    x = t(x_np)
    v = t(rng.standard_normal((n, 3)) * 0.5)
    aff = t(rng.standard_normal((n, 3, 3)) * 0.3)
    grid_v = t(rng.standard_normal((G ** 3, 3)) * 0.5)
    results = {}

    def rec(name, *args):
        record(results, name, name, *args)

    k = lambda: cuda_stress.stress_affine(scene, mats, C, F)  # noqa: E731
    p = lambda: cuda_stress.stress_affine_plain(scene, mats, C, F)  # noqa: E731
    rec("stress_affine", compare("stress_affine", k(), p(), TOL["stress_affine"]), k, p,
           (C, F), n)

    # the scatters under each order; timed with the one an env step computes
    orders = scatter_orders(scene, x, v, SEED)
    k = lambda o=orders["sorted"]: (cuda_transfer.p2g(scene, x, v, aff, o),)  # noqa: E731
    p = lambda: (cuda_transfer.p2g_plain(scene, x, v, aff),)  # noqa: E731
    rec("p2g", worst([compare(f"p2g [order: {o}]", k(orders[o]), p(), TOL["p2g"])
                      for o in ORDERS]), k, p, (x, v, aff, orders["sorted"]), n)

    k = lambda o=orders["sorted"]: (cuda_transfer.grid_mass(scene, x, o),)  # noqa: E731
    p = lambda: (cuda_transfer.grid_mass_plain(scene, x),)  # noqa: E731
    rec("grid_mass", worst([compare(f"grid_mass (p2g MASS_ONLY) [order: {o}]", k(orders[o]), p(),
                                    TOL["grid_mass"]) for o in ORDERS]), k, p,
        (x, orders["sorted"]), n)

    k = lambda: cuda_transfer.g2p(scene, x, grid_v)  # noqa: E731
    p = lambda: cuda_transfer.g2p_plain(scene, x, grid_v)  # noqa: E731
    rec("g2p", compare("g2p", k(), p(), TOL["g2p"]), k, p,
        (x, Gathered(grid_v, touched_share(scene, x))), n)

    # grid update on a realistic grid: P2G of the cloud with O(1) velocities
    grid4 = cuda_transfer.p2g_plain(scene, x, v, sim.p_mass * C)
    center = x_np.mean(axis=0)

    for i, (shape, kw) in enumerate(SHAPE_PARAMS.items()):
        sc = scene.replace(primitives=(PrimitiveSpec(shape=shape, friction=0.9, **kw),))
        pf, pf1 = test_poses(1, 100 + i, center)
        compare(f"grid_op[{shape}]", (cuda_gridop.grid_op(sc, grid4, pf, pf1, 666.0),),
                (cuda_gridop.grid_op_plain(sc, grid4, pf, pf1, 666.0),), TOL["grid_op"],
                FLIP_BUDGET)
    sc = mixed_scene(scene)
    pf, pf1 = test_poses(len(sc.primitives), 107, center)
    compare(f"grid_op[mixed: {', '.join(MIXED_SHAPES)}]",
            (cuda_gridop.grid_op(sc, grid4, pf, pf1, 666.0),),
            (cuda_gridop.grid_op_plain(sc, grid4, pf, pf1, 666.0),), TOL["grid_op"], FLIP_BUDGET)
    pf, pf1 = test_poses(len(scene.primitives), 99, center)
    grid_rand = random_grid(rng, G)
    for gf in (0.0, 1.5, 100.0):
        sc = scene.replace(simulator=dataclasses.replace(sim, ground_friction=gf))
        compare(f"grid_op[walls, ground {gf}]",
                (cuda_gridop.grid_op(sc, grid_rand, pf, pf1, 666.0),),
                (cuda_gridop.grid_op_plain(sc, grid_rand, pf, pf1, 666.0),), TOL["grid_op"],
                FLIP_BUDGET)
    empty = cuda_gridop.grid_op(scene, torch.zeros_like(grid4), pf, pf1, 666.0)
    if not bool((empty == 0).all()):
        raise AssertionError("grid_op on a grid without mass: non-zero velocities")
    log("  grid_op[no mass]             every velocity 0")
    k = lambda: (cuda_gridop.grid_op(scene, grid4, pf, pf1, 666.0),)  # noqa: E731
    p = lambda: (cuda_gridop.grid_op_plain(scene, grid4, pf, pf1, 666.0),)  # noqa: E731
    err = compare("grid_op[Move-v1: 2 Spheres]", k(), p(), TOL["grid_op"], FLIP_BUDGET)
    mass_shares("Move-v1 grid (P2G of the initial cloud)", grid4)
    massive = int((grid4[:, 3] > 1e-12).sum())
    rec("grid_op", err, k, p, (grid4, *pf, *pf1), massive)
    return results


def plain_vjp(fn, inputs, cts):
    """(fn's VJP at inputs for cotangents cts, a call repeating its backward
    alone) through torch.autograd of a plain version."""
    import torch

    ins = [t.clone().requires_grad_(True) for t in inputs]
    out = fn(*ins)
    out = out if isinstance(out, tuple) else (out,)

    def backward():
        grads = torch.autograd.grad(out, ins, cts, retain_graph=True, allow_unused=True)
        return tuple(torch.zeros_like(i) if g is None else g for g, i in zip(grads, ins))

    return backward(), backward


def hold_to_f64(name, got, want32, want64, limits):
    """Fails where an output of got (the kernel's) is further from want64 (the
    float64 plain version's) than its limit, relative to want64's largest
    value; logs the float32 plain version's (want32's) distance beside it.
    Returns got's (max abs, max rel) error vs want32."""
    import torch

    max_abs, max_rel = 0.0, 0.0
    for i, (g, w32, w64, limit) in enumerate(zip(got, want32, want64, limits)):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name}: non-finite kernel output")
        g, w32 = g.double(), w32.double()
        scale = float(w64.abs().max()) or 1.0
        err, own = (float((x - w64).abs().max()) / scale for x in (g, w32))
        e32 = float((g - w32).abs().max())
        log(f"  {name:44s} output {i}: vs float64 {err:.3e}, float32 plain's {own:.3e} "
            f"(limit {limit:.3e}); vs float32 plain {e32 / scale:.3e}")
        if not err <= limit:
            raise AssertionError(f"{name}: output {i} off by {err:.3e} > {limit:.3e}")
        max_abs, max_rel = max(max_abs, e32), max(max_rel, e32 / (float(w32.abs().max()) or 1.0))
    return max_abs, max_rel


def phase_stress_cases():
    """K1 and K2 where the SVD is hardest (`stress_cases` at Move-v1's
    particle count, seeded cotangents) and on Move-v1's own C and F after 25
    env steps tiled to the 320,000 particles of the batched path at B = 32
    (also timed, L2-warm and L2-cold), held to the float64 plain version
    within TOL / BWD_TOL or HARD_TOL. Its backward takes the float32
    eigengap damping there: the same function in float64."""
    from unittest import mock

    import torch

    from plasticinelab_tpu_torch.engine import cuda_stress, svd3
    from plasticinelab_tpu_torch.engine.state import default_materials

    scene, x_np = move_scene()
    n = len(x_np)
    mats = default_materials(scene)
    log(f"phase stress cases: the SVD's hard inputs, n={n}, seed {SEED + 15}")
    cases = {k: (tensor(c), tensor(f)) for k, (c, f) in stress_cases(n, SEED + 15).items()}
    C, F = move_stress_inputs(25, SEED + 16)
    B = VEC_BATCHES[-1]
    cases[f"Move-v1 after 25 steps x {B}"] = (C.repeat(B, 1, 1), F.repeat(B, 1, 1))
    results = {}

    def plain(c, f):
        return cuda_stress.stress_affine_plain(scene, mats, c, f)

    for label, (C, F) in cases.items():
        rng = np.random.default_rng(SEED + 17)
        cts = [tensor(rng.standard_normal(C.shape)) for _ in range(2)]
        with mock.patch.object(svd3, "_GAP_EPS_F64", svd3.gap_mode(torch.float32)[1]):
            want64 = plain(C.double(), F.double())
            grad64 = plain_vjp(plain, [C.double(), F.double()], [c.double() for c in cts])[0]
        limits = HARD_TOL.get(label.split(" after")[0], (TOL["stress_affine"],) * 2
                              + (BWD_TOL["stress_affine_bwd"],) * 2)
        k1 = lambda: cuda_stress.stress_affine(scene, mats, C, F)  # noqa: E731
        err1 = hold_to_f64(f"stress_affine [{label}]", k1(), plain(C, F), want64, limits[:2])
        want, p2 = plain_vjp(plain, [C, F], cts)
        k2 = lambda: cuda_stress.stress_affine_bwd(scene, mats, C, F, *cts)  # noqa: E731
        err2 = hold_to_f64(f"stress_affine_bwd [{label}]", k2(), want, grad64, limits[2:])
        if label.startswith("Move-v1"):
            m = C.shape[0]
            for key, name, err, kern, pl, ins in (
                    ("stress_affine", "stress_affine", err1, k1, lambda: plain(C, F), (C, F)),
                    ("stress_affine_bwd", "stress_affine_bwd", err2, k2, p2, (C, F, *cts))):
                key = f"{key}[Move-v1, n={m}]"
                record(results, key, name, err, kern, pl, ins, m)
                log_cold_time(key, kern)
    torch.cuda.synchronize()
    return results


def phase_backward():
    import dataclasses

    import torch

    from plasticinelab_tpu_torch.config.spec import PrimitiveSpec
    from plasticinelab_tpu_torch.engine import cuda_gridop, cuda_stress, cuda_transfer
    from plasticinelab_tpu_torch.engine.state import default_materials

    scene, x_np = move_scene()
    sim = scene.simulator
    n, G = len(x_np), sim.n_grid
    log(f"phase backward kernels: Move-v1 shapes, n={n}, G={G}, seed {SEED + 1}")
    rng = np.random.default_rng(SEED + 1)
    t = tensor
    mats = default_materials(scene)
    C = t(rng.standard_normal((n, 3, 3)) * 2.0)
    F = t(np.eye(3) + rng.standard_normal((n, 3, 3)) * 0.15)
    x = t(x_np)
    v = t(rng.standard_normal((n, 3)) * 0.5)
    aff = t(rng.standard_normal((n, 3, 3)) * 0.3)
    grid_v = t(rng.standard_normal((G ** 3, 3)) * 0.5)
    ct_nF, ct_aff = t(rng.standard_normal((n, 3, 3))), t(rng.standard_normal((n, 3, 3)))
    ct4, ctm = t(rng.standard_normal((G ** 3, 4))), t(rng.standard_normal(G ** 3))
    ct_v, ct_C, ct_x = (t(rng.standard_normal((n, 3))), t(rng.standard_normal((n, 3, 3))),
                        t(rng.standard_normal((n, 3))))
    ct3 = t(rng.standard_normal((G ** 3, 3)))
    results = {}

    def rec(name, *args):
        record(results, name, name, *args)

    want, p = plain_vjp(lambda c, f: cuda_stress.stress_affine_plain(scene, mats, c, f),
                        [C, F], [ct_nF, ct_aff])
    k = lambda: cuda_stress.stress_affine_bwd(scene, mats, C, F, ct_nF, ct_aff)  # noqa: E731
    rec("stress_affine_bwd", compare("stress_affine_bwd (K2)", k(), want,
                                        BWD_TOL["stress_affine_bwd"]), k, p,
           (C, F, ct_nF, ct_aff), n)

    share = touched_share(scene, x)  # of the grids that the gathers read
    want, p = plain_vjp(lambda a, b, c: cuda_transfer.p2g_plain(scene, a, b, c), [x, v, aff],
                        [ct4])
    k = lambda: cuda_transfer.p2g_bwd(scene, x, v, aff, ct4)  # noqa: E731
    rec("p2g_bwd", compare("p2g_bwd (K4)", k(), want, BWD_TOL["p2g_bwd"]), k, p,
           (x, v, aff, Gathered(ct4, share)), n)

    want, p = plain_vjp(lambda a: cuda_transfer.grid_mass_plain(scene, a), [x], [ctm])
    k = lambda: (cuda_transfer.grid_mass_bwd(scene, x, ctm),)  # noqa: E731
    rec("grid_mass_bwd", compare("grid_mass_bwd (K7 backward)", k(), want,
                                    BWD_TOL["grid_mass_bwd"]), k, p,
        (x, Gathered(ctm, share)), n)

    want, p = plain_vjp(lambda a, g: cuda_transfer.g2p_plain(scene, a, g), [x, grid_v],
                        [ct_v, ct_C, ct_x])
    orders = scatter_orders(scene, x, v, SEED + 1)
    k = lambda o=orders["sorted"]: cuda_transfer.g2p_bwd(  # noqa: E731
        scene, x, grid_v, ct_v, ct_C, ct_x, o)
    rec("g2p_bwd", worst([compare(f"g2p_bwd (K6) [order: {o}]", k(orders[o]), want,
                                  BWD_TOL["g2p_bwd"]) for o in ORDERS]), k, p,
        (x, Gathered(grid_v, share), ct_v, ct_C, ct_x, orders["sorted"]), n)

    def grid_op_check(label, sc, g4, pf, pf1, pose_tol):
        """K8 backward vs the plain VJP: d grid4 rows (flips counted) and
        the (k, 16) pose cotangents (`compare_poses`); two calls bit for
        bit; the case has cells in contact and cells next to them out of
        contact (float SDF)."""
        want, p = plain_vjp(
            lambda g, *ps: cuda_gridop.grid_op_plain(sc, g, ps[:3], ps[3:], 666.0),
            [g4, *pf, *pf1], [ct3])
        want_poses = cuda_gridop.pack_poses(want[1:4], want[4:7])
        poses = cuda_gridop.pack_poses(pf, pf1).contiguous()
        k = lambda: cuda_gridop.grid_op_bwd(sc, g4, poses, 666.0, ct3)  # noqa: E731
        dg4, dposes = k()
        again = k()
        if not (torch.equal(dg4, again[0]) and torch.equal(dposes, again[1])):
            raise AssertionError(f"grid_op_bwd[{label}]: two calls on the same inputs differ")
        hit, near = contact_cells(sc, g4, pf, 666.0)
        log(f"  grid_op_bwd[{label}]: {int(hit.sum())} cells in contact, {int(near.sum())} "
            "next to them out of contact; two calls bit for bit")
        if not (hit.any() and near.any()):
            raise AssertionError(f"grid_op_bwd[{label}]: no contact edge in the case")
        err = compare(f"grid_op_bwd[{label}] d grid4", (dg4,), (want[0],),
                      BWD_TOL["grid_op_bwd"], FLIP_BUDGET)
        compare(f"grid_op_bwd[{label}] d grid4 by row", (dg4,), (want[0],),
                BWD_TOL["grid_op_bwd"], FLIP_BUDGET, per_row=True)
        compare_poses(f"grid_op_bwd[{label}]", dposes, want_poses, pose_tol)
        if not float(want_poses.abs().max()) > 0:
            raise AssertionError(f"grid_op_bwd[{label}]: no pose gradient to compare")
        return (err, k, p, (g4, poses, Gathered(ct3, mass_share(g4))),
                int((g4[:, 3] > 1e-12).sum()), hit)

    grid4 = cuda_transfer.p2g_plain(scene, x, v, sim.p_mass * C)
    center = x_np.mean(axis=0)
    for i, (shape, kw) in enumerate(SHAPE_PARAMS.items()):
        sc = scene.replace(primitives=(PrimitiveSpec(shape=shape, friction=0.9, **kw),))
        pf, pf1 = test_poses(1, 200 + i, center)
        grid_op_check(shape, sc, grid4, pf, pf1, POSE_TOL.get(shape, BWD_TOL["grid_op_bwd"]))
    sc = mixed_scene(scene)
    pf, pf1 = test_poses(len(sc.primitives), 207, center)
    grid_op_check(f"mixed: {', '.join(MIXED_SHAPES)}", sc, grid4, pf, pf1, pose_tols(sc))
    # a Sphere whose contact crosses a boundary between the backward's
    # blocks: rows y = yb - 1 and yb of cells at the same x
    rows = max(1, cuda_gridop.BWD_BLOCK_CELLS // G)
    yb = rows * round(center[1] / sim.dx / rows)
    sc = scene.replace(primitives=(PrimitiveSpec(shape="Sphere", friction=0.9,
                                                 **SHAPE_PARAMS["Sphere"]),))
    pos = np.array([[center[0], yb * sim.dx, center[2]]])
    quat = np.array([[1.0, 0.0, 0.0, 0.0]])
    pf = (t(pos), t(quat), t([0.0]))
    pf1 = (t(pos + [0.0, 1e-3, 0.0]), t(quat), t([0.0]))
    hit = grid_op_check(f"Sphere across block rows y = {yb - 1} | {yb}", sc, grid4, pf, pf1,
                        BWD_TOL["grid_op_bwd"])[-1].reshape(G, G, G)
    if not bool((hit[:, yb - 1].any(dim=1) & hit[:, yb].any(dim=1)).any()):
        raise AssertionError("the block-boundary case has no contact on both sides")
    pf, pf1 = test_poses(len(scene.primitives), 199, center)
    grid_rand = random_grid(rng, G)
    for gf in (0.0, 1.5, 100.0):
        sc = scene.replace(simulator=dataclasses.replace(sim, ground_friction=gf))
        grid_op_check(f"walls, ground {gf}", sc, grid_rand, pf, pf1, BWD_TOL["grid_op_bwd"])
    # a grid without mass: zeros, no NaN
    poses = cuda_gridop.pack_poses(pf, pf1).contiguous()
    dg4, dposes = cuda_gridop.grid_op_bwd(scene, torch.zeros_like(grid4), poses, 666.0, ct3)
    if not (bool((dg4 == 0).all()) and bool((dposes == 0).all())):
        raise AssertionError("grid_op_bwd on a grid without mass: non-zero cotangents")
    log("  grid_op_bwd[no mass]         d grid4 and d poses all 0")
    move = grid_op_check("Move-v1: 2 Spheres", scene, grid4, pf, pf1, BWD_TOL["grid_op_bwd"])
    rec("grid_op_bwd", *move[:-1])
    log_cold_time("grid_op_bwd", move[1])
    return results


def phase_gradient():
    import torch

    from plasticinelab_tpu_torch.engine import cuda_gridop, cuda_stress, cuda_transfer, mpm
    from plasticinelab_tpu_torch.engine.sim import rollout_losses
    from plasticinelab_tpu_torch.envs import make

    mods = (cuda_stress, cuda_transfer, cuda_gridop)
    env = make("Move-v1", device=DEVICE)
    env.reset()
    te = env.unwrapped.taichi_env
    scene, state0 = te.scene, te.state
    sub = scene.simulator.substeps

    # (a) kernels vs plain versions, GRAD_STEPS env steps from the reset state
    log(f"phase gradient: {GRAD_STEPS} Move-v1 steps, kernels vs plain versions")
    acts = tensor(np.random.default_rng(SEED + 2).uniform(-1, 1, (GRAD_STEPS, scene.action_dim)))
    out = {}
    for name, ops, remat in (("kernels", mpm.KERNEL_OPS, "none"),
                             ("plain", mpm.PLAIN_OPS, "env_step")):
        a = acts.clone().requires_grad_(True)
        comps, _ = rollout_losses(scene, te.mats, te.loss_state, state0, a, te.softness,
                                  remat, ops)
        loss = comps[:, 0].sum()
        (g,) = torch.autograd.grad(loss, a)
        out[name] = (float(loss.detach()), g.double())
    (lk, gk), (lp, gp) = out["kernels"], out["plain"]
    rel_l = abs(lk - lp) / abs(lp)
    rel_g = float((gk - gp).abs().max() / gp.abs().max())
    log(f"  loss kernels {lk:.9g}  plain {lp:.9g}  rel {rel_l:.3e} (bound {GRAD_TOL['loss']:.0e})")
    log(f"  d/d actions max |grad| {float(gp.abs().max()):.4e}  max diff rel {rel_g:.3e} "
        f"(bound {GRAD_TOL['grad']:.0e})")
    if not (torch.isfinite(gk).all() and rel_l <= GRAD_TOL["loss"] and rel_g <= GRAD_TOL["grad"]):
        raise AssertionError("kernel and plain trajectory gradients disagree")

    # (b) against the reference package's 2-step values
    loss, grad, _ = te.rollout_value_and_grad(state0, np.asarray(REF_GRAD_ACTIONS), te.softness)
    grad = grad.double().cpu().numpy()
    want = np.asarray(REF_GRAD)
    rel_l = abs(float(loss) - REF_GRAD_LOSS) / abs(REF_GRAD_LOSS)
    rel_g = float(np.abs(grad - want).max() / np.abs(want).max())
    log(f"phase gradient reference: 2 steps, loss port {float(loss):.9g} reference "
        f"{REF_GRAD_LOSS:.9g} rel {rel_l:.3e} (tol {REF_TOL:.0e}); grad max diff rel "
        f"{rel_g:.3e} (tol {REF_GRAD_TOL:.0e})")
    log(f"  port grad {np.array2string(grad, precision=6)}")
    if not (rel_l <= REF_TOL and rel_g <= REF_GRAD_TOL):
        raise AssertionError("the 2-step gradient disagrees with the reference package")

    # (c) the 50-step trajectory gradient at bench.py's actions
    actions = bench_actions(scene)
    log(f"phase gradient trajectory: {HORIZON} steps x {sub} substeps, through the kernels")
    for mod in mods:
        mod.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    loss, grad, final = te.rollout_value_and_grad(state0, actions, te.softness)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    launches = {k: v for mod in mods for k, v in mod.launches.items()}
    peak = torch.cuda.max_memory_allocated()
    log(f"  launches in one trajectory gradient: {launches}")
    expected = {"stress_affine_bwd": HORIZON * sub, "p2g_bwd": HORIZON * sub,
                "grid_op_bwd": HORIZON * sub, "g2p_bwd": HORIZON * sub,
                "grid_mass_bwd": HORIZON}
    for key, want in expected.items():
        if launches[key] != want:
            raise AssertionError(f"{key} ran {launches[key]} times, expected {want}")
    g = grad.double()
    if not (torch.isfinite(loss) and torch.isfinite(g).all() and float(g.abs().max()) > 0):
        raise AssertionError("the trajectory gradient is not finite and non-zero")
    times = []
    for _ in range(TRAJ_RUNS):
        t0 = time.perf_counter()
        _, g2, _ = te.rollout_value_and_grad(state0, actions, te.softness)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    log(f"  loss {float(loss):.9g}  |grad| max {float(g.abs().max()):.6e} mean "
        f"{float(g.abs().mean()):.6e}; remat {te.last_remat}")
    log(f"  seconds per trajectory gradient: best {min(times):.4f}, runs "
        f"{[round(x, 4) for x in times]} (first, with warm-up, {first:.4f}); "
        f"substeps/s fwd+bwd {HORIZON * sub / min(times):.1f}")
    log(f"  peak device memory {peak / 2**30:.3f} GiB above {base / 2**30:.3f} GiB at start; "
        f"{(peak - base) / (HORIZON * sub) / 2**20:.3f} MiB per substep "
        f"(resolve_remat assumes {mpm.substep_bytes(scene) / 2**20:.3f})")
    return launches


def phase_solve():
    import torch

    from plasticinelab_tpu_torch.envs import make
    from plasticinelab_tpu_torch.optimizer.solver import Solver

    env = make("Move-v1", device=DEVICE)
    env.reset()
    te = env.unwrapped.taichi_env
    init = np.random.default_rng(SEED).uniform(-1e-4, 1e-4, (HORIZON, te.scene.action_dim))
    solver = Solver(te, None, None, n_iters=SOLVE_ITERS, horizon=HORIZON, softness=666.0,
                    **{"optim.lr": 0.1, "optim.type": "Adam"})
    best = solver.solve_device(init_actions=init, chunk=SOLVE_ITERS)
    torch.cuda.synchronize()
    losses = solver.iter_losses
    log(f"phase solve: solve_device, Adam, {SOLVE_ITERS} iterations, horizon {HORIZON}: "
        f"losses {losses}, {solver.chunk_seconds[0] / SOLVE_ITERS:.4f} s per iteration")
    if len(losses) != SOLVE_ITERS or not np.isfinite(losses).all() or not np.isfinite(best).all():
        raise AssertionError("solve_device produced non-finite losses or actions")


def phase_nn_gradient():
    """The NN policy's 2-step Move-v1 gradient (`solver_nn.nn_value_and_grad`)
    through the kernels against the plain versions and the reference
    package's values; launch counts prove the kernels' backward ran."""
    import torch

    from plasticinelab_tpu_torch.engine import cuda_gridop, cuda_stress, cuda_transfer, mpm
    from plasticinelab_tpu_torch.engine.nn import MLPPolicy
    from plasticinelab_tpu_torch.envs import make
    from plasticinelab_tpu_torch.optimizer.solver_nn import nn_value_and_grad

    mods = (cuda_stress, cuda_transfer, cuda_gridop)
    env = make("Move-v1", device=DEVICE)
    env.reset()
    te = env.unwrapped.taichi_env
    policy = MLPPolicy(te.scene)
    flat = torch.as_tensor(policy.get_params(policy.init_params(0, device=DEVICE)),
                           dtype=torch.float32, device=DEVICE)
    sub = te.scene.simulator.substeps
    log(f"phase nn gradient: Move-v1, MLPPolicy dims {policy.dims}, init_params(0), "
        f"{NN_STEPS} steps, kernels vs plain versions")
    out = {}
    for name, ops in (("plain", mpm.PLAIN_OPS), ("kernels", mpm.KERNEL_OPS)):
        for mod in mods:
            mod.reset_launches()
        loss, g = nn_value_and_grad(te, policy, flat, te.state, NN_STEPS, te.softness, "none",
                                    ops)
        torch.cuda.synchronize()
        out[name] = (float(loss), g.double().cpu().numpy())
    launches = {k: v for mod in mods for k, v in mod.launches.items() if k.endswith("_bwd")}
    (lk, gk), (lp, gp) = out["kernels"], out["plain"]
    rel_l = abs(lk - lp) / abs(lp)
    rel_g = float(np.abs(gk - gp).max() / np.abs(gp).max())
    log(f"  loss kernels {lk:.9g}  plain {lp:.9g}  rel {rel_l:.3e} (bound {GRAD_TOL['loss']:.0e}); "
        f"d/d params max diff rel {rel_g:.3e} (bound {GRAD_TOL['grad']:.0e})")
    log(f"  backward launches (kernels): {launches}")
    if not (np.isfinite(gk).all() and rel_l <= GRAD_TOL["loss"] and rel_g <= GRAD_TOL["grad"]):
        raise AssertionError("kernel and plain NN gradients disagree")
    for key in ("stress_affine_bwd", "p2g_bwd", "grid_op_bwd", "g2p_bwd", "grid_mass_bwd"):
        want = NN_STEPS * (1 if key == "grid_mass_bwd" else sub)
        if launches[key] != want:
            raise AssertionError(f"{key} ran {launches[key]} times, expected {want}")
    rel_l = abs(lk - REF_NN_LOSS) / REF_NN_LOSS
    log(f"phase nn gradient reference: loss port {lk:.9g} reference {REF_NN_LOSS:.9g} rel "
        f"{rel_l:.3e} (tol {REF_TOL:.0e})")
    bad = [] if rel_l <= REF_TOL else ["loss"]
    layers, o = {}, 0
    for i in range(policy.n_layer):
        for k, n in (("W", policy.dims[i + 1] * policy.dims[i]), ("b", policy.dims[i + 1])):
            layers[f"{k}{i}"] = (o, o + n)
            o += n
    for name, (lo, hi) in layers.items():
        norm, top = REF_NN_LAYERS[name]
        got = float(np.linalg.norm(gk[lo:hi]))
        rel = abs(got - norm) / norm
        entries = [(i, v) for i, v in REF_NN_ENTRIES if lo <= i < hi]
        worst = max(abs(gk[i] - v) for i, v in entries) / top
        log(f"  {name}: |grad| port {got:.6e} reference {norm:.6e} rel {rel:.3e}; "
            f"{len(entries)} entries, largest diff {worst:.3e} of the layer's largest |entry| "
            f"(tol {REF_GRAD_TOL:.0e} each)")
        if not (rel <= REF_GRAD_TOL and worst <= REF_GRAD_TOL):
            bad.append(name)
    if bad:
        raise AssertionError(f"the NN gradient disagrees with the reference package: {bad}")
    return launches


def phase_nn_solve():
    """SolverNN.solve_device on Move-v1 (NN_SOLVE_ITERS Adam iterations,
    horizon HORIZON, lr 0.1 x 0.001): launch counts, finite losses and
    parameters, iteration 0 against a direct rollout of init_params(0),
    seconds per iteration, remat, peak memory; then a replay of
    NN_REPLAY_STEPS steps with policy.act."""
    import torch

    from plasticinelab_tpu_torch.engine import cuda_gridop, cuda_stress, cuda_transfer
    from plasticinelab_tpu_torch.engine.nn import MLPPolicy
    from plasticinelab_tpu_torch.envs import make
    from plasticinelab_tpu_torch.optimizer.solver_nn import SolverNN, nn_rollout_losses

    mods = (cuda_stress, cuda_transfer, cuda_gridop)
    env = make("Move-v1", nn=True, device=DEVICE)
    env.reset()
    te = env.unwrapped.taichi_env
    te.nn = policy = MLPPolicy(te.scene)
    sub = te.scene.simulator.substeps
    solver = SolverNN(te, None, None, n_iters=NN_SOLVE_ITERS, horizon=HORIZON, softness=666.0,
                      **{"optim.lr": 0.1, "optim.type": "Adam"})
    for mod in mods:
        mod.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    best = solver.solve_device(chunk=NN_SOLVE_ITERS)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = {k: v for mod in mods for k, v in mod.launches.items()}
    losses = solver.iter_losses
    secs = solver.chunk_seconds[0] / NN_SOLVE_ITERS
    log(f"phase nn solve: SolverNN.solve_device, Adam, {NN_SOLVE_ITERS} iterations, horizon "
        f"{HORIZON}, remat {solver.last_remat}: losses {losses}, {secs:.4f} s per iteration "
        f"(the first included); peak device memory {peak / 2**30:.3f} GiB above "
        f"{base / 2**30:.3f} GiB")
    log(f"  launches: {launches}")
    for key in ("stress_affine_bwd", "p2g_bwd", "grid_op_bwd", "g2p_bwd", "grid_mass_bwd"):
        want = NN_SOLVE_ITERS * HORIZON * (1 if key == "grid_mass_bwd" else sub)
        if launches[key] != want:
            raise AssertionError(f"{key} ran {launches[key]} times, expected {want}")
    if (len(losses) != NN_SOLVE_ITERS or not np.isfinite(losses).all()
            or not np.isfinite(best).all()):
        raise AssertionError("SolverNN.solve_device produced non-finite losses or parameters")
    flat0 = torch.as_tensor(policy.get_params(policy.init_params(0, device=DEVICE)),
                            dtype=torch.float32, device=DEVICE)
    with torch.no_grad():
        per_step, _ = nn_rollout_losses(te.scene, te.mats, te.loss_state, policy,
                                        policy.unflatten(flat0), te.state, HORIZON, 666.0)
    direct = float(per_step.sum())
    rel = abs(losses[0] - direct) / abs(direct)
    log(f"  iteration 0 {losses[0]:.9g} vs a direct {HORIZON}-step rollout of init_params(0) "
        f"{direct:.9g}: rel {rel:.3e} (bound {GRAD_TOL['loss']:.0e}: atomics reorder sums)")
    if not rel <= GRAD_TOL["loss"]:
        raise AssertionError("the NN solve's first loss is not the rollout's")
    te.set_copy(True)
    ptree = policy.set_params(best, torch.float32, device=DEVICE)
    for _ in range(NN_REPLAY_STEPS):
        with torch.no_grad():
            action = policy.act(ptree, te.state).cpu().numpy()
        te.step(action)
        info = te.compute_loss()
        if not (np.isfinite(action).all() and np.abs(action).max() <= 1.0
                and np.isfinite(te.get_obs()).all() and np.isfinite(info["reward"])):
            raise AssertionError("the NN policy's replay is not finite")
    log(f"  replay {NN_REPLAY_STEPS} steps with policy.act: last action "
        f"{np.array2string(action, precision=4)}, reward {info['reward']:.6g}, "
        f"incremental_iou {info['incremental_iou']:.6g}")
    return {"launches": launches, "seconds": secs}


def replayed(draws):
    """A sampler that hands out `draws` (tensors) in order."""
    it = iter(draws)
    return lambda *_: next(it)


def phase_sac():
    """SAC: one update_many_device on the card against the CPU; train_vec on
    VecPlasticineEnv("Move-v1", batch=SAC_B) for two horizons, state
    observations, and for SAC_RGB_STEPS rgb steps; launch counts of the
    batched forward kernels (and K9-b), rates and the host seconds split."""
    import tempfile

    import torch

    from plasticinelab_tpu_torch.algorithms.common import DeviceReplayBuffer
    from plasticinelab_tpu_torch.algorithms.sac.run_sac import train_vec
    from plasticinelab_tpu_torch.algorithms.sac.sac import SAC
    from plasticinelab_tpu_torch.engine import cuda_gridop, cuda_stress, cuda_transfer
    from plasticinelab_tpu_torch.engine.renderer import cuda_voxelize
    from plasticinelab_tpu_torch.parallel import VecPlasticineEnv

    # (1) the update on the card against the CPU
    D, A = 1214, 6
    rng = np.random.default_rng(SEED + 20)
    data = (rng.normal(0.5, 0.3, (SAC_ROWS, D)), rng.uniform(-1, 1, (SAC_ROWS, A)),
            rng.normal(0.5, 0.3, (SAC_ROWS, D)), rng.standard_normal(SAC_ROWS),
            np.zeros(SAC_ROWS))
    idx = [rng.integers(0, SAC_ROWS, SAC_BATCH) for _ in range(SAC_UPDATES)]
    eps = [rng.standard_normal((SAC_BATCH, A)) for _ in range(2 * SAC_UPDATES)]
    got = {}
    for dev in (DEVICE, "cpu"):
        algo = SAC(D, A, seed=SEED, device=dev)
        buf = DeviceReplayBuffer(D, A, SAC_ROWS, device=dev)
        buf.add_batch(*data)
        algo.indices = replayed([torch.as_tensor(i, device=dev) for i in idx])
        algo.normal = replayed([torch.as_tensor(e, dtype=torch.float32, device=dev) for e in eps])
        t0 = time.perf_counter()
        loss = float(algo.update_many_device(buf, SAC_BATCH, SAC_UPDATES))
        secs = time.perf_counter() - t0
        params = [p.detach().cpu() for m in (algo.policy, algo.q, algo.q_target)
                  for p in m.parameters()] + [algo.log_alpha.detach().cpu()]
        got[dev] = (loss, params, secs, (algo, buf))
    (lc, pc, sc, _), (lh, ph, sh, _) = got[DEVICE], got["cpu"]
    rel = abs(lc - lh) / abs(lh)
    worst = max(float((a - b).abs().max()) for a, b in zip(pc, ph)) / 3e-4
    log(f"phase sac update: SAC(1214, 6) update_many_device(n={SAC_UPDATES}, batch "
        f"{SAC_BATCH}), card vs CPU from the same weights and draws: loss {lc:.9g} vs {lh:.9g} "
        f"rel {rel:.3e} (bound {SAC_LOSS_TOL:.0e}); parameters and log_alpha largest diff "
        f"{worst:.3e} of an Adam step (bound {SAC_PARAM_TOL}); {sc:.4f} s on the card (first "
        f"call), {sh:.4f} s on the CPU")
    if not (np.isfinite(lc) and rel <= SAC_LOSS_TOL and worst <= SAC_PARAM_TOL):
        raise AssertionError("the SAC update on the card disagrees with the CPU's")

    # (2) state collection, two horizons; (3) rgb
    mods = (cuda_stress, cuda_transfer, cuda_gridop, cuda_voxelize)
    out = {}
    with tempfile.TemporaryDirectory() as path:
        for mode, steps, start in (("state", 2 * HORIZON, SAC_START),
                                   ("rgb", SAC_RGB_STEPS, SAC_RGB_STEPS * SAC_B)):
            venv = VecPlasticineEnv("Move-v1", batch=SAC_B, seed=SEED, horizon=HORIZON,
                                    obs_mode=mode, device=DEVICE)
            shape = venv.obs_shape if mode == "rgb" else venv.obs_dim
            algo = SAC(shape, venv.action_dim, seed=SEED, device=DEVICE)
            args = SimpleNamespace(env_name="Move-v1", seed=SEED, num_steps=steps * SAC_B,
                                   obs_mode=mode)
            for mod in mods:
                mod.reset_launches()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            train_vec(None, algo, path, args, venv=venv, start_steps=start)
            peak = torch.cuda.max_memory_allocated()
            launches = {k: v for mod in mods for k, v in mod.launches.items() if v}
            st = algo.vec_stats
            resets = 1 + steps // HORIZON
            want = {"stress_affine": 19 * steps, "p2g_batched": 19 * steps,
                    "grid_op_batched": 19 * steps, "g2p_batched": 19 * steps,
                    "grid_mass_batched": steps + resets}
            if mode == "rgb":
                want["voxelize_batched"] = steps + resets
            log(f"phase sac {mode}: train_vec, VecPlasticineEnv('Move-v1', batch={SAC_B}), "
                f"{steps} batched steps, start_steps {start}: {st['env_steps']} env steps in "
                f"{st['seconds']:.3f} s ({st['env_steps'] / st['seconds']:.3f} env steps/s); "
                f"{st['updates']} updates in {st['update_s']:.3f} host s "
                f"({st['updates'] / max(st['update_s'], 1e-9):.1f} updates/s); collection "
                f"{st['collect_s']:.3f} host s; peak device memory {peak / 2**30:.3f} GiB")
            log(f"  launches: {launches}")
            if launches != want:
                raise AssertionError(f"train_vec ({mode}) launched {launches}, expected {want}")
            updates = SAC_B * (steps - start // SAC_B + 1)
            finite = all(torch.isfinite(p).all() for p in algo.policy.parameters())
            if st["updates"] != updates or not finite:
                raise AssertionError(f"train_vec ({mode}): {st['updates']} updates "
                                     f"(expected {updates}), finite parameters {finite}")
            del venv, algo
            torch.cuda.empty_cache()
    return got[DEVICE][3]


def share(diff, scale):
    """diff / scale, where a scale of 0 admits only a diff of 0."""
    return diff / scale if scale > 0 else (0.0 if diff == 0 else float("inf"))


def card_vs_cpu(name, build, run, modules, updates):
    """build(device) -> learner; run(learner, device) -> loss (float);
    modules(learner) -> the nn.Modules whose parameters are compared. The
    same on the card and on the CPU; returns the card's learner."""
    got = {}
    for dev in (DEVICE, "cpu"):
        algo = build(dev)
        before = [p.detach().cpu().clone() for m in modules(algo) for p in m.parameters()]
        t0 = time.perf_counter()
        loss = float(run(algo, dev))
        secs = time.perf_counter() - t0
        after = [p.detach().cpu().clone() for m in modules(algo) for p in m.parameters()]
        got[dev] = (loss, before, after, secs, algo)
    (lc, _, pc, sc, algo), (lh, bh, ph, sh, _) = got[DEVICE], got["cpu"]
    step = max(float((a - b).abs().max()) for a, b in zip(ph, bh)) / updates
    element = max(float((a - b).abs().max()) for a, b in zip(pc, ph)) / step
    worst = max(share(float((c - h).norm()), float((h - b).norm()))
                for c, h, b in zip(pc, ph, bh))
    rel = abs(lc - lh) / abs(lh)
    log(f"phase rl {name}: card vs CPU from the same weights, data and draws, {updates} "
        f"updates: loss {lc:.9g} vs {lh:.9g} rel {rel:.3e} (bound {SAC_LOSS_TOL:.0e}); "
        f"parameters: worst tensor |card - CPU| / |CPU step| {worst:.3e} (bound "
        f"{RL_PARAM_TOL}), largest element {element:.3e} of the CPU's mean step {step:.3e}; "
        f"{sc:.4f} s on the card (first call), {sh:.4f} s on the CPU")
    if not (np.isfinite(lc) and rel <= SAC_LOSS_TOL and worst <= RL_PARAM_TOL):
        raise AssertionError(f"{name}: the update on the card disagrees with the CPU's")
    return algo


RL_D, RL_A = 1214, 6  # Move-v1's observation and action widths


def rl_inputs():
    """The seeded data and seam draws of phase rl's card-vs-CPU checks."""
    D, A, N, B = RL_D, RL_A, SAC_ROWS, SAC_BATCH
    rng = np.random.default_rng(SEED + 30)
    x = SimpleNamespace()
    x.data = (rng.normal(0.5, 0.3, (N, D)), rng.uniform(-1, 1, (N, A)),
              rng.normal(0.5, 0.3, (N, D)), rng.standard_normal(N), np.zeros(N))
    x.idx = [rng.integers(0, N, B) for _ in range(RL_UPDATES)]
    x.eps = [rng.standard_normal((B, A)) for _ in range(2 * RL_UPDATES)]
    x.mb = (rng.standard_normal((RL_PPO_MB, D)), rng.uniform(-1, 1, (RL_PPO_MB, A)),
            rng.normal(-6.0, 1.0, RL_PPO_MB), rng.standard_normal(RL_PPO_MB),
            rng.standard_normal(RL_PPO_MB), 0.1 * rng.standard_normal(RL_PPO_MB))
    x.kfac_rows = [(rng.standard_normal((RL_KFAC_ROWS, D)),
                    rng.uniform(-1, 1, (RL_KFAC_ROWS, A)), rng.standard_normal(RL_KFAC_ROWS))
                   for _ in range(RL_KFAC_UPDATES)]
    x.kfac_eps = [rng.standard_normal(s) for _ in range(RL_KFAC_UPDATES)
                  for s in ((RL_KFAC_ROWS, A), (RL_KFAC_ROWS,))]
    x.expert = (rng.normal(1.0, 1.0, (B, D)), rng.uniform(-1, 1, (B, A)))
    x.agent = (rng.normal(-1.0, 1.0, (B, D)), rng.uniform(-1, 1, (B, A)))
    x.alphas = [rng.random((B, 1)) for _ in range(RL_GAIL_UPDATES)]
    return x


def gail_learner(x, dev, dtype=None):
    """GAIL(1214, 6) on `dev` whose interpolation weights replay x.alphas."""
    import torch

    from plasticinelab_tpu_torch.algorithms.ppo import GAIL

    g = GAIL(RL_D, RL_A, seed=SEED, device=dev)
    if dtype is not None:
        g.net.to(dtype)
    g.uniform = replayed([torch.as_tensor(u, dtype=dtype or torch.float32, device=dev)
                          for u in x.alphas])
    return g


def rl_checks():
    """Each learner of phase rl on the card against the CPU. Returns the
    card's TD3 and its device buffer."""
    import torch

    from plasticinelab_tpu_torch.algorithms.common import DeviceReplayBuffer, ReplayBuffer
    from plasticinelab_tpu_torch.algorithms.ppo import PPO, A2C_ACKTR
    from plasticinelab_tpu_torch.algorithms.sac.discor import DisCor
    from plasticinelab_tpu_torch.algorithms.td3.ddpg import OriginalDDPG
    from plasticinelab_tpu_torch.algorithms.td3.td3 import TD3

    D, A, N = RL_D, RL_A, SAC_ROWS
    x = rl_inputs()
    bufs = {}

    def device_buffer(dev):
        buf = DeviceReplayBuffer(D, A, N, device=dev)
        buf.add_batch(*x.data)
        bufs[dev] = buf
        return buf

    def seams(algo, dev):
        algo.indices = replayed([torch.as_tensor(i, device=dev) for i in x.idx])
        algo.normal = replayed([torch.as_tensor(e, dtype=torch.float32, device=dev)
                                for e in x.eps])
        return algo

    td3 = card_vs_cpu(
        "TD3(1214, 6) train_many_device", lambda dev: seams(TD3(D, A, seed=SEED, device=dev), dev),
        lambda a, dev: a.train_many_device(device_buffer(dev), SAC_BATCH, RL_UPDATES),
        lambda a: (a.actor, a.critic, a.actor_target, a.critic_target), RL_UPDATES)

    host = ReplayBuffer(D, A, N)
    host.state[:], host.action[:], host.next_state[:] = x.data[0], x.data[1], x.data[2]
    host.reward[:], host.not_done[:], host.size = x.data[3], 1.0 - x.data[4], N

    def ddpg_run(a, dev):
        r = np.random.default_rng(SEED)
        for _ in range(RL_UPDATES):
            loss = a.train(host, SAC_BATCH, r)
        return loss

    card_vs_cpu("OriginalDDPG(1214, 6) train", lambda dev: OriginalDDPG(D, A, seed=SEED,
                                                                        device=dev),
                ddpg_run, lambda a: (a.actor, a.critic, a.actor_target, a.critic_target),
                RL_UPDATES)

    card_vs_cpu("DisCor(1214, 6) update_many_device",
                lambda dev: seams(DisCor(D, A, seed=SEED, device=dev), dev),
                lambda a, dev: a.update_many_device(device_buffer(dev), SAC_BATCH, RL_UPDATES),
                lambda a: (a.policy, a.q, a.q_target, a.err, a.err_target), RL_UPDATES)

    mb = [torch.as_tensor(a, dtype=torch.float32) for a in x.mb]

    def ppo_run(a, dev):
        for _ in range(RL_PPO_STEPS):
            loss, _ = a._minibatch_update(*(t.to(dev) for t in mb))
        return loss

    card_vs_cpu("PPO(1214, 6) _minibatch_update", lambda dev: PPO(D, A, seed=SEED, device=dev),
                ppo_run, lambda a: (a.net,), RL_PPO_STEPS)

    def acktr_build(dev):
        a = A2C_ACKTR(D, A, seed=SEED, device=dev)
        a.normal = replayed([torch.as_tensor(e, dtype=torch.float32, device=dev)
                             for e in x.kfac_eps])
        return a

    def acktr_run(a, dev):
        for o, act, ret in x.kfac_rows:
            loss = a.update({"obs": torch.as_tensor(o, dtype=torch.float32, device=dev),
                             "actions": torch.as_tensor(act, dtype=torch.float32, device=dev),
                             "returns": torch.as_tensor(ret, dtype=torch.float32, device=dev)})
        if a.kfac.steps != RL_KFAC_UPDATES:
            raise AssertionError(f"ACKTR took {a.kfac.steps} K-FAC steps")
        return loss

    card_vs_cpu("A2C_ACKTR(1214, 6) update (eigh at steps 0 and 10)", acktr_build, acktr_run,
                lambda a: (a.net,), RL_KFAC_UPDATES)

    def gail_run(g, dev):
        for _ in range(RL_GAIL_UPDATES):
            loss = g.update(x.expert, x.agent)
        return loss

    card_vs_cpu("GAIL(1214, 6) update", lambda dev: gail_learner(x, dev), gail_run,
                lambda g: (g.net,), RL_GAIL_UPDATES)
    return td3, bufs[DEVICE]


def rl_run(label, run, want, mods):
    """Runs run() with every launch count at 0 just before; fails unless the
    counts (those not 0) equal `want`. Returns run()'s result and its host
    seconds."""
    import torch

    for mod in mods:
        mod.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: v for mod in mods for k, v in mod.launches.items() if v}
    log(f"  {label}: launches {launches}")
    if launches != want:
        raise AssertionError(f"{label} launched {launches}, expected {want}")
    return out, secs


def batched_launches(steps, resets, rgb=False):
    """Launch counts of `steps` batched Move-v1 steps and `resets` resets."""
    want = {k: 19 * steps for k in ("stress_affine", "p2g_batched", "grid_op_batched",
                                    "g2p_batched")}
    want["grid_mass_batched"] = steps + resets
    if rgb:
        want["voxelize_batched"] = steps + resets
    return want


def phase_rl():
    """TD3 / OriginalDDPG / DisCor / PPO / ACKTR / GAIL at full width: each
    learner's updates card vs CPU; train_td3_vec and DisCor's train_vec on
    VecPlasticineEnv("Move-v1", batch=SAC_B) for two horizons, train_ppo_vec
    for one update of RL_PPO_T steps, the rgb forms of TD3 and PPO for
    SAC_RGB_STEPS steps, train_ppo(algo="acktr") on one env for RL_ACKTR_T
    steps; launch counts prove each collection ran through the kernels."""
    import tempfile

    import torch

    from plasticinelab_tpu_torch.algorithms.ppo.run_ppo import train_ppo, train_ppo_vec
    from plasticinelab_tpu_torch.algorithms.sac.discor import DisCor
    from plasticinelab_tpu_torch.algorithms.sac.run_sac import train_vec
    from plasticinelab_tpu_torch.algorithms.td3.run_td3 import train_td3_vec
    from plasticinelab_tpu_torch.algorithms.td3.td3 import TD3
    from plasticinelab_tpu_torch.engine import cuda_gridop, cuda_stress, cuda_transfer
    from plasticinelab_tpu_torch.engine.renderer import cuda_voxelize
    from plasticinelab_tpu_torch.envs import make
    from plasticinelab_tpu_torch.parallel import VecPlasticineEnv

    t_phase = time.perf_counter()
    td3, buf = rl_checks()
    mods = (cuda_stress, cuda_transfer, cuda_gridop, cuda_voxelize)
    B = SAC_B
    with tempfile.TemporaryDirectory() as path:
        for mode, steps, start in (("state", 2 * HORIZON, SAC_START),
                                   ("rgb", SAC_RGB_STEPS, SAC_RGB_STEPS * B)):
            for name in ("TD3", "DisCor") if mode == "state" else ("TD3",):
                venv = VecPlasticineEnv("Move-v1", batch=B, seed=SEED, horizon=HORIZON,
                                        obs_mode=mode, device=DEVICE)
                shape = venv.obs_shape if mode == "rgb" else venv.obs_dim
                args = SimpleNamespace(env_name="Move-v1", seed=SEED, num_steps=steps * B,
                                       obs_mode=mode, algo=name.lower())
                if name == "TD3":
                    algo = TD3(shape, venv.action_dim, seed=SEED, device=DEVICE)
                    run = lambda: train_td3_vec(algo, args, path, venv=venv,  # noqa: E731
                                                start_timesteps=start)
                else:
                    algo = DisCor(shape, venv.action_dim, seed=SEED, device=DEVICE)
                    run = lambda: train_vec(None, algo, path, args, venv=venv,  # noqa: E731
                                            start_steps=start)
                want = batched_launches(steps, 1 + steps // HORIZON, rgb=mode == "rgb")
                rl_run(f"{name} vec {mode}, {steps} batched steps at B={B}", run, want, mods)
                st = algo.vec_stats
                updates = B * (steps - start // B + 1)
                log(f"phase rl {name} {mode}: VecPlasticineEnv('Move-v1', batch={B}), {steps} "
                    f"batched steps, warm-up {start}: {st['env_steps']} env steps in "
                    f"{st['seconds']:.3f} s ({st['env_steps'] / st['seconds']:.3f} env steps/s); "
                    f"{st['updates']} updates in {st['update_s']:.3f} host s "
                    f"({st['updates'] / max(st['update_s'], 1e-9):.1f} updates/s); collection "
                    f"{st['collect_s']:.3f} host s")
                nets = (algo.actor, algo.critic) if name == "TD3" else (algo.policy, algo.err)
                finite = all(bool(torch.isfinite(p).all()) for m in nets for p in m.parameters())
                if st["updates"] != updates or not finite:
                    raise AssertionError(f"{name} vec {mode}: {st['updates']} updates "
                                         f"(expected {updates}), finite parameters {finite}")
                del venv, algo
                torch.cuda.empty_cache()

        for mode, T in (("state", RL_PPO_T), ("rgb", SAC_RGB_STEPS)):
            venv = VecPlasticineEnv("Move-v1", batch=B, seed=SEED, horizon=HORIZON,
                                    obs_mode=mode, device=DEVICE)
            args = SimpleNamespace(env_name="Move-v1", seed=SEED, num_steps=T * B)
            agent, _ = rl_run(
                f"PPO vec {mode}, rollout_len {T} at B={B}",
                lambda: train_ppo_vec(args, path, venv=venv, rollout_len=T),
                batched_launches(T, 1, rgb=mode == "rgb"), mods)
            st = agent.vec_stats
            finite = all(bool(torch.isfinite(p).all()) for p in agent.net.parameters())
            mb = max(T * B // agent.num_mini_batch, 1)
            n_mb = agent.ppo_epoch * len(range(0, T * B - mb + 1, mb))
            log(f"phase rl PPO {mode}: train_ppo_vec, {st['env_steps']} env steps in "
                f"{st['seconds']:.3f} s ({st['env_steps'] / st['seconds']:.3f} env steps/s); "
                f"collection {st['collect_s']:.3f} host s ({st['env_steps'] / st['collect_s']:.3f}"
                f" env steps/s); {st['update_s'] / st['updates']:.3f} s per update "
                f"({n_mb} minibatch steps of {mb})")
            if st["updates"] != 1 or not finite:
                raise AssertionError(f"PPO vec {mode}: {st['updates']} updates, finite {finite}")
            del venv, agent
            torch.cuda.empty_cache()

        env = make("Move-v1", device=DEVICE)
        args = SimpleNamespace(seed=SEED, num_steps=RL_ACKTR_T, vec_envs=0,
                               rollout_len=RL_ACKTR_T)
        want = {k: 19 * RL_ACKTR_T for k in ("stress_affine", "p2g", "grid_op", "g2p")}
        want["grid_mass"] = RL_ACKTR_T + 1 + RL_ACKTR_T // env._max_episode_steps
        agent, secs = rl_run(f"ACKTR on one env, {RL_ACKTR_T} steps",
                             lambda: train_ppo(env, path, None, args, algo="acktr"), want, mods)
        finite = all(bool(torch.isfinite(p).all()) for p in agent.net.parameters())
        log(f"phase rl ACKTR: train_ppo(algo='acktr') on make('Move-v1'), {RL_ACKTR_T} env "
            f"steps and one update in {secs:.3f} s ({RL_ACKTR_T / secs:.3f} env steps/s, the "
            f"update included); K-FAC steps {agent.kfac.steps}")
        if agent.kfac.steps != 1 or not finite:
            raise AssertionError(f"ACKTR: {agent.kfac.steps} K-FAC steps, finite {finite}")
    log(f"phase rl: {time.perf_counter() - t_phase:.1f} s")
    return td3, buf


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


def move_textures_inputs():
    """Move-v1 after reset: (its PhysicsEnv, x float32, colours int32) on
    the card."""
    import torch

    from plasticinelab_tpu_torch.envs import make

    env = make("Move-v1", device=DEVICE)
    env.reset()
    te = env.unwrapped.taichi_env
    colors = torch.as_tensor(te.particle_colors, device=DEVICE)
    return te, te.state.x.float().contiguous(), colors


def grids(te):
    """The frame's and the observation's renderers of Move-v1."""
    from plasticinelab_tpu_torch.engine.renderer import Renderer
    from plasticinelab_tpu_torch.engine.renderer.renderer import obs_scene

    return {"frame": Renderer(te.scene, DEVICE), "obs": Renderer(obs_scene(te.scene, 64, 2), DEVICE)}


def stress_clouds(res, edge, n=10_000):
    """name -> (n, 3) float32 voxel-unit clouds that stress K9 on a grid res
    whose sort takes coarse cells of `edge` cells a side: every particle in
    one voxel (the worst contention, one chunk box); particles in the first
    and last cells and up to 3 cells outside the volume, negative
    coordinates (truncating toward zero) among them; stencils straddling
    coarse-cell edges on all three axes."""
    rng = np.random.default_rng(SEED + 11)
    r, t = np.array(res), edge
    one = np.floor(r / 2) + rng.uniform(0.05, 0.95, (n, 3))
    pick = rng.integers(0, 4, (n, 3))
    edge = np.choose(pick, [rng.uniform(0.0, 1.0, (n, 3)), r - 1 + rng.uniform(0.0, 1.0, (n, 3)),
                            -rng.uniform(0.0, 3.0, (n, 3)), r + rng.uniform(0.0, 3.0, (n, 3))])
    k = rng.integers(1, np.maximum(r // t, 2), (n, 3))
    straddle = k * t + rng.uniform(-1.5, 1.5, (n, 3))
    return {name: np.ascontiguousarray(c, np.float32)
            for name, c in (("one voxel", one), ("edges", edge), ("cell edges", straddle))}


def voxelize_case(results, key, p, colors, r, check_envs=False):
    """K9 on voxel-unit particles p ((n, 3) or (B, n, 3)) of renderer r's
    grid: bit for bit against its plain version and against the one
    `scatter_reduce_` that computes its min (check_envs: and per env
    against B = 1 launches); times the kernel, the plain version and that
    call (its `flat` and `packed` computed before), bounds the call from
    its inputs and output and the updates that land in the volume."""
    import torch

    from plasticinelab_tpu_torch.engine.renderer import cuda_voxelize as cv

    args = (p, colors, r.voxel_res, r.bake_size, r.dist_scale)
    got, want = cv.voxelize(*args), cv.voxelize_plain(*args)
    differ = int((got != want).sum())
    flat, packed = cv.scatter_inputs(*args)
    vol64 = torch.full((got.numel(),), 0xFFFFFFFF, dtype=torch.int64, device=DEVICE)

    def lib():
        return vol64.scatter_reduce_(0, flat, packed, reduce="amin", include_self=True)

    lib()
    differ_lib = int((cv._to_int32_bits(vol64).reshape(got.shape) != got).sum())
    per_env = 0
    if check_envs:
        per_env = sum(int((cv.voxelize(p[b:b + 1], *args[1:])[0] != got[b]).sum())
                      for b in range(p.shape[0]))
    written = int((got != -1).sum())
    log(f"  {key:28s} {tuple(p.shape)} on {r.voxel_res}: cells that differ from the plain "
        f"version {differ}, from scatter_reduce_ {differ_lib}"
        + (f", from B = 1 launches {per_env}" if check_envs else "")
        + f"; {written} cells written, {flat.numel()} updates in the volume")
    if differ or differ_lib or per_env:
        raise AssertionError(f"voxelize {key}: the kernel differs")
    kern = lambda a=args: cv.voxelize(*a)  # noqa: E731
    plain = lambda a=args: cv.voxelize_plain(*a)  # noqa: E731
    k_wall, p_wall, l_wall = wall_time(kern), wall_time(plain), wall_time(lib)
    b_ms, b_by = bound("voxelize", [p, colors, got], flat.numel())
    log(f"  {key:28s} wall ms/call: kernel {k_wall:.4f}  plain {p_wall:.4f}  scatter_reduce_ "
        f"{l_wall:.4f}  bound {b_ms:.5f} ({b_by})")
    results[key] = dict(max_abs_err=0.0, rel_err=0.0, ms=k_wall, plain_ms=p_wall,
                        bound_ms=b_ms, bound_by=b_by, library_ms=l_wall,
                        calls=(kern, plain, lib))


def phase_voxelize():
    """K9 at Move-v1 shapes at both grids and on the stress clouds, one env
    and (privatised) as 32 copies; K9-b at VOX_BATCHES envs. The line's
    entries: the observation grid's (the size of the rgb run's 51 launches)
    and K9-b's at the largest B."""
    import torch

    from plasticinelab_tpu_torch.engine.renderer import cuda_voxelize as cv

    te, x, colors = move_textures_inputs()
    results = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, r in grids(te).items():
        offs = cv.offsets(r.bake_size, r.dist_scale)
        n = x.shape[0]
        modes = {B: cv.launch_shape(r.voxel_res, n, B, sms) for B in (1, 32)}
        log(f"phase voxelize kernel [{name}]: grid {r.voxel_res}, {len(offs)} offsets spanning "
            f"[{offs.min()}, {offs.max()}], dist_scale {r.dist_scale:.6g}; (sort, coarse shift, "
            f"chunk) at B = 1: {modes[1]}, at B = 32: {modes[32]}")
        p = ((x - r.frame_bbox(x)[0]) * r.inv_dx).contiguous()
        key = "voxelize" if name == "obs" else f"voxelize_{name}"
        voxelize_case(results, key, p, colors, r)
        for cloud, pc in stress_clouds(r.voxel_res, 1 << modes[32][1], n).items():
            for B in (1, 32):  # direct, privatised
                pt = tensor(np.broadcast_to(pc, (B,) + pc.shape))
                args = (pt if B > 1 else pt[0], colors, r.voxel_res, r.bake_size, r.dist_scale)
                differ = int((cv.voxelize(*args) != cv.voxelize_plain(*args)).sum())
                log(f"  {cloud:12s} B={B:2d} cells that differ from the plain version: {differ}")
                if differ:
                    raise AssertionError(f"voxelize [{name}] {cloud} B={B}: the kernel differs")
    r = grids(te)["obs"]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 12)
    for B in VOX_BATCHES:
        xb = x + (torch.rand((B,) + x.shape, generator=gen, device=DEVICE) * 2 - 1) * VOX_JITTER
        p = ((xb - r.frame_bbox(xb, host_bbox=False)[:, 0, None]) * r.inv_dx).contiguous()
        key = "voxelize_batched" if B == VOX_BATCHES[-1] else f"voxelize_batched[B={B}]"
        log(f"phase voxelize kernel [obs, B={B}]: Move-v1's cloud, per-env noise "
            f"uniform(-{VOX_JITTER}, {VOX_JITTER})")
        voxelize_case(results, key, p, colors, r, check_envs=True)
    return results


def phase_render_reference():
    import torch

    log("phase render reference: Move-v1 initial state vs the reference package's values")
    te, x, colors = move_textures_inputs()
    for name, r in grids(te).items():
        vol = r.packed_volume(x, colors, r.frame_bbox(x)[0]).cpu().numpy().view(np.uint32)
        sdf = vol >> 24
        got = dict(unsaturated=int((sdf < 255).sum()), sdf_sum=int(sdf.astype(np.int64).sum()),
                   crc32=zlib.crc32(vol.astype("<u4").tobytes()))
        log(f"  volume [{name}] port {got}  reference {REF_VOLUMES[name]}")
        if got != REF_VOLUMES[name]:
            raise AssertionError(f"the {name} volume differs from the reference package's")
    r = te._new_renderer(te.scene)
    s = te.state
    got = r.probe_rays(x, colors, s.prim_pos, s.prim_rot, s.prim_gap, np.asarray(PROBE_O),
                       np.asarray(PROBE_D))
    for key, g, w in zip(("closest", "normal", "color"), got,
                         (PROBE_CLOSEST, PROBE_NORMAL, PROBE_COLOR)):
        err = float(np.abs(g - np.asarray(w, np.float32)).max())
        log(f"  probe_rays {key:8s} max abs diff {err:.3e} (bound {PROBE_TOL[key]:.0e})")
        if not err <= PROBE_TOL[key]:
            raise AssertionError(f"probe_rays {key} differs from the reference package's")
    torch.cuda.synchronize()


def check_frame(img, shape):
    if img.shape != shape or img.dtype != np.uint8:
        raise AssertionError(f"bad frame: {img.shape} {img.dtype}")
    if not 0 < img.mean() < 255:
        raise AssertionError(f"blank frame, mean {img.mean()}")


def phase_render():
    import torch

    from plasticinelab_tpu_torch.engine import cuda_gridop, cuda_stress, cuda_transfer
    from plasticinelab_tpu_torch.engine.renderer import cuda_voxelize, renderer
    from plasticinelab_tpu_torch.envs import make
    from plasticinelab_tpu_torch.optimizer.solver import solve_action

    mods = (cuda_stress, cuda_transfer, cuda_gridop, cuda_voxelize)
    out = {}
    # (a) one full-width frame after RENDER_STEPS steps
    env = make("Move-v1", device=DEVICE)
    env.reset()
    rng = np.random.default_rng(SEED + 3)
    for a in rng.uniform(-1, 1, (RENDER_STEPS, env.action_space.shape[0])):
        env.step(a)
    te = env.unwrapped.taichi_env
    spec = te.scene.renderer
    log(f"phase render: Move-v1 after {RENDER_STEPS} steps, {spec.image_res[0]}x"
        f"{spec.image_res[1]} x {spec.spp} spp, depth {spec.max_ray_depth}, voxel grid "
        f"{spec.voxel_res}")
    for mod in mods:
        mod.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = env.render(mode="rgb_array")
    torch.cuda.synchronize()
    out["frame_s"] = time.perf_counter() - t0
    check_frame(img, (spec.image_res[1], spec.image_res[0], 3))
    log(f"  frame {out['frame_s']:.3f} s (renderer set-up included); mean {img.mean():.4f}; "
        f"voxelize launches {cuda_voxelize.launches['voxelize']}")
    if cuda_voxelize.launches["voxelize"] != 1:
        raise AssertionError("the frame did not voxelize through K9 once")

    # (b) the same frame through the kernel and the plain voxelizer
    r = te._renderer
    imgs = []
    for vox in (cuda_voxelize.voxelize, cuda_voxelize.voxelize_plain):
        r.voxelize, r.uniform = vox, renderer.torch_sampler(DEVICE, SEED + 4)
        t0 = time.perf_counter()
        imgs.append(env.render(mode="rgb_array"))
        torch.cuda.synchronize()
        log(f"  frame through {vox.__name__}: {time.perf_counter() - t0:.3f} s")
    r.voxelize, r.uniform = cuda_voxelize.voxelize, renderer.torch_sampler(DEVICE)
    if not np.array_equal(imgs[0], imgs[1]):
        raise AssertionError(f"kernel and plain voxelizer frames differ in "
                             f"{int((imgs[0] != imgs[1]).any(-1).sum())} pixels")
    log("  kernel and plain voxelizer frames identical")

    # (c) rgb observations: reset + RGB_STEPS steps
    envr = make("Move-v1", device=DEVICE, obs_mode="rgb")
    for mod in mods:
        mod.reset_launches()
    obs, _ = envr.reset()
    stamps = [time.perf_counter()]
    for a in np.random.default_rng(SEED).uniform(-1, 1, (RGB_STEPS, 6)):
        obs, rew, *_ = envr.step(a)
        stamps.append(time.perf_counter())
        check_frame(obs, (64, 64, 3))
        if not np.isfinite(rew):
            raise AssertionError("non-finite reward")
    launches = {k: v for mod in mods for k, v in mod.launches.items()}
    out["rgb_sps"] = RGB_STEPS / (stamps[-1] - stamps[0])
    log(f"phase render rgb observations: reset + {RGB_STEPS} steps, launches {launches}; "
        f"env steps/s {out['rgb_sps']:.3f}")
    if launches["voxelize"] != RGB_STEPS + 1:
        raise AssertionError(f"voxelize ran {launches['voxelize']} times, expected {RGB_STEPS + 1}")
    out["voxelize_launches"] = launches["voxelize"]
    tr = envr.unwrapped.taichi_env
    obs_times = []
    for _ in range(10):
        t0 = time.perf_counter()
        tr.render_obs(64, 2)
        torch.cuda.synchronize()
        obs_times.append(time.perf_counter() - t0)
    out["obs_ms"] = 1e3 * min(obs_times)
    log(f"  render_obs 64x64 x 2 spp: best {out['obs_ms']:.3f} ms, median "
        f"{1e3 * sorted(obs_times)[5]:.3f} ms")
    out["env"], out["rgb_env"] = env, envr

    # (d) solve_action: 2 Adam iterations of a SOLVE_ACTION_T-step episode
    enva = make("Move-v1", device=DEVICE, max_episode_steps=SOLVE_ACTION_T)
    args = SimpleNamespace(num_steps=2 * SOLVE_ACTION_T, softness=666.0, lr=0.1, optim="Adam")
    with tempfile.TemporaryDirectory() as path:
        t0 = time.perf_counter()
        actions = solve_action(enva, path, None, args)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        files = sorted(os.listdir(path))
        for f in files:
            if f.endswith(".npy"):
                check_frame(np.load(os.path.join(path, f)), img.shape)
    log(f"phase render solve_action: {len(files)} images {files}, {secs:.3f} s")
    if len(files) != SOLVE_ACTION_T or not np.isfinite(actions).all():
        raise AssertionError("solve_action did not write one image per step")
    return out


def per_env(name, batched, singles, tol=None):
    """Each env b of a batched call's outputs (tuple, leading B) against
    singles[b], the outputs of a B = 1 launch of the same kernel on env b:
    bit for bit (tol None), or within tol of the largest value; a tuple
    gives each output its own tol."""
    import torch

    tols = tol if isinstance(tol, tuple) else (tol,) * len(batched)
    worst = 0.0
    for b, single in enumerate(singles):
        for g, w, t in zip(batched, as_tuple(single), tols):
            if t is None:
                if not torch.equal(g[b], w):
                    raise AssertionError(f"{name}: env {b} differs from its B = 1 launch")
                continue
            rel = float((g[b].double() - w.double()).abs().max()) / (float(w.abs().max()) or 1.0)
            worst = max(worst, rel)
            if not rel <= t:
                raise AssertionError(f"{name}: env {b} differs from its B = 1 launch by "
                                     f"{rel:.3e} (tol {t:.0e})")
    exact = sum(t is None for t in tols)
    log(f"  {name:28s} per env vs {len(singles)} B = 1 launches: {exact} of {len(tols)} outputs "
        "bit for bit" + ("" if exact == len(tols) else f", the rest max rel {worst:.3e} "
                         f"(tol {max(t for t in tols if t is not None):.0e})"))


def phase_vec_kernels():
    """The batched kernels at Move-v1 shapes for VEC_B and for the largest
    of VEC_BATCHES envs, each env's cloud moved by its own noise, each env
    with its own poses and softness; the B = VEC_B run also against B = 1
    launches. The line's entries are the largest B's."""
    from plasticinelab_tpu_torch.engine import cuda_gridop, cuda_transfer

    scene, x_np = move_scene()
    sim = scene.simulator
    n, G, k = len(x_np), sim.n_grid, len(scene.primitives)
    center = x_np.mean(axis=0)
    results = {}

    def run(B):
        """One batch size; its calls keep their own inputs for the device times."""
        log(f"phase vec kernels: Move-v1 shapes, B={B} envs of n={n} particles, G={G} grid, "
            f"seed {SEED + 5}")
        rng = np.random.default_rng(SEED + 5)
        x = tensor(np.clip(x_np + rng.uniform(-0.01, 0.01, (B, n, 3)), 0.0, 0.95))
        v = tensor(rng.standard_normal((B, n, 3)) * 0.5)
        C = tensor(rng.standard_normal((B, n, 3, 3)) * 2.0)
        aff = tensor(rng.standard_normal((B, n, 3, 3)) * 0.3)
        grid_v = tensor(rng.standard_normal((B, G ** 3, 3)) * 0.5)
        # the grid update on realistic grids: P2G of the clouds, O(1) velocities
        grid4 = cuda_transfer.p2g_plain_batched(scene, x, v, sim.p_mass * C)
        pf, pf1 = batch_poses(B, k, 300, center)
        softness = tensor(np.where(np.arange(B) % 2, 333.0, 666.0))
        env = lambda tree, b: tuple(t[b] for t in tree)  # noqa: E731
        orders = scatter_orders(scene, x, v, SEED + 5)
        srt = orders["sorted"]
        # name -> (kernel(order), plain, what the call reads, items, the B = 1
        # launch on env b, its tolerance: None = bit for bit)
        calls = {
            "p2g_batched": (
                lambda o=srt: (cuda_transfer.p2g_batched(scene, x, v, aff, o),),
                lambda: (cuda_transfer.p2g_plain_batched(scene, x, v, aff),), (x, v, aff, srt),
                B * n, lambda b: cuda_transfer.p2g(scene, x[b], v[b], aff[b], srt[b]), TOL["p2g"]),
            "grid_mass_batched": (
                lambda o=srt: (cuda_transfer.grid_mass_batched(scene, x, o),),
                lambda: (cuda_transfer.grid_mass_plain_batched(scene, x),), (x, srt), B * n,
                lambda b: cuda_transfer.grid_mass(scene, x[b], srt[b]), TOL["grid_mass"]),
            "g2p_batched": (
                lambda: cuda_transfer.g2p_batched(scene, x, grid_v),
                lambda: cuda_transfer.g2p_plain_batched(scene, x, grid_v),
                (x, Gathered(grid_v, touched_share(scene, x))), B * n,
                lambda b: cuda_transfer.g2p(scene, x[b], grid_v[b]), None),
            "grid_op_batched": (
                lambda: (cuda_gridop.grid_op_batched(scene, grid4, pf, pf1, softness),),
                lambda: (cuda_gridop.grid_op_plain_batched(scene, grid4, pf, pf1, softness),),
                (grid4, *pf, *pf1, softness), int((grid4[..., 3] > 1e-12).sum()),
                lambda b: cuda_gridop.grid_op(scene, grid4[b], env(pf, b), env(pf1, b),
                                              float(softness[b])), None),
        }
        for name, (kern, plain, inputs, items, single, env_tol) in calls.items():
            base = BATCHED_FWD[name]
            got, want = as_tuple(kern()), as_tuple(plain())
            err = compare(f"{name} [B={B}]", got, want, TOL[base],
                          FLIP_BUDGET * B if base == "grid_op" else 0)
            if base in ("p2g", "grid_mass"):  # the scatters: under every order
                err = worst([err] + [compare(f"{name} [B={B}, order: {o}]", kern(orders[o]), want,
                                             TOL[base]) for o in ORDERS if o != "sorted"])
            if B == VEC_B:
                per_env(name, got, [single(b) for b in range(B)], env_tol)
            record(results, name if B == VEC_BATCHES[-1] else f"{name}[B={B}]", name, err, kern,
                   plain, inputs, items)
        if B == VEC_B:  # several primitives of mixed shapes
            sc = mixed_scene(scene)
            mf, mf1 = batch_poses(B, len(sc.primitives), 370, center)
            got = cuda_gridop.grid_op_batched(sc, grid4, mf, mf1, softness)
            want = cuda_gridop.grid_op_plain_batched(sc, grid4, mf, mf1, softness)
            label = f"grid_op_batched [mixed: {', '.join(MIXED_SHAPES)}, B={B}]"
            compare(label, (got,), (want,), TOL["grid_op"], FLIP_BUDGET * B)
            per_env(label, (got,), [cuda_gridop.grid_op(sc, grid4[b], env(mf, b), env(mf1, b),
                                                        float(softness[b])) for b in range(B)])

    for B in (VEC_B, VEC_BATCHES[-1]):
        run(B)
    return results


def phase_vec():
    """VecPlasticineEnv("Move-v1") for each B of VEC_BATCHES: reset and
    VEC_STEPS seeded steps, each fetching obs, reward and info to the host
    (the step's one sync); then the parity checks at B = VEC_B."""
    import torch

    from plasticinelab_tpu_torch.engine import cuda_gridop, cuda_stress, cuda_transfer
    from plasticinelab_tpu_torch.envs import make
    from plasticinelab_tpu_torch.parallel import VecPlasticineEnv

    mods = (cuda_stress, cuda_transfer, cuda_gridop)
    out = {"envs": {}, "sps": {}}
    for B in VEC_BATCHES:
        t0 = time.perf_counter()
        ve = VecPlasticineEnv("Move-v1", batch=B, seed=SEED, horizon=VEC_STEPS, device=DEVICE)
        ve.reset()
        torch.cuda.synchronize()
        t_setup = time.perf_counter() - t0
        sub = ve.scene.simulator.substeps
        actions = np.random.default_rng(SEED).uniform(-1, 1, (VEC_STEPS, B, ve.action_dim))
        for mod in mods:
            mod.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        stamps, enqueue = [], []
        for a in actions:
            t0 = time.perf_counter()
            obs, reward, done, info = ve.step(a)
            enqueue.append(time.perf_counter() - t0)  # the host's launches
            host = torch.cat([obs.reshape(-1), reward, info["loss"], info["iou"],
                              info["incremental_iou"]]).cpu().numpy()
            stamps.append(time.perf_counter())
            if not np.isfinite(host).all():
                raise AssertionError(f"B={B}: non-finite observation, reward or info")
        launches = {k: v for mod in mods for k, v in mod.launches.items()}
        peak = torch.cuda.max_memory_allocated()
        log(f"phase vec: VecPlasticineEnv('Move-v1', batch={B}, device='cuda'): set-up "
            f"{t_setup:.3f} s, {VEC_STEPS} steps; launches {launches}")
        expected = {"stress_affine": VEC_STEPS * sub, "p2g_batched": VEC_STEPS * sub,
                    "grid_op_batched": VEC_STEPS * sub, "g2p_batched": VEC_STEPS * sub,
                    "grid_mass_batched": VEC_STEPS}
        expected.update({k: 0 for k in ("p2g", "grid_mass", "g2p", "grid_op")})
        for key, want in expected.items():
            if launches[key] != want:
                raise AssertionError(f"B={B}: {key} ran {launches[key]} times, expected {want}")
        if obs.shape != (B, ve.obs_dim) or not bool(done.all()):
            raise AssertionError(f"B={B}: observation {tuple(obs.shape)}, done {done.tolist()}")
        sps = B * (VEC_STEPS - 1) / (stamps[-1] - stamps[0])
        step_ms = 1e3 * (stamps[-1] - stamps[0]) / (VEC_STEPS - 1)
        enq_ms = 1e3 * float(np.mean(enqueue[1:]))
        log(f"  env steps/s {sps:.3f} (B x steps 2..{VEC_STEPS} over host seconds), batched "
            f"step {step_ms:.3f} ms, of which the host's launches {enq_ms:.3f} ms and the wait "
            f"for the device and the fetch {step_ms - enq_ms:.3f} ms; peak device memory {(peak - base) / 2**30:.4f} GiB above "
            f"{base / 2**30:.3f} GiB at start; mean reward "
            f"{float(reward.mean()):.6g}, incremental_iou {float(info['incremental_iou'].mean()):.6g}")
        out["envs"][B], out["sps"][B], out["launches"] = ve, sps, launches

    # parity: B = VEC_B envs without jitter under the same actions, and the
    # single env
    ve = VecPlasticineEnv("Move-v1", batch=VEC_B, jitter=0.0, device=DEVICE)
    env = make("Move-v1", device=DEVICE)
    ve.reset()
    env.reset()
    for a in np.random.default_rng(SEED + 6).uniform(-1, 1, (VEC_PARITY_STEPS, ve.action_dim)):
        _, _, _, info = ve.step(np.tile(a, (VEC_B, 1)))
        _, _, _, _, single = env.step(a)
    log(f"phase vec parity: B={VEC_B} without jitter, {VEC_PARITY_STEPS} steps of the same "
        f"actions; and make('Move-v1') with them")
    for name in ("x", "v", "C", "F"):
        t = getattr(ve.states, name).double()
        diff, scale = float((t - t[:1]).abs().max()), float(t[0].abs().max())
        log(f"  every env vs env 0: {name} max_abs {diff:.3e} rel {diff / scale:.3e} "
            f"(bound {STEP_TOL[name]:.0e})")
        if not diff <= STEP_TOL[name] * scale:
            raise AssertionError(f"batched envs differ in {name} by {diff}")
    x1 = env.unwrapped.taichi_env.state.x.double()
    diff, scale = float((ve.states.x[0].double() - x1).abs().max()), float(x1.abs().max())
    rel = abs(float(info["loss"][0]) - single["loss"]) / abs(single["loss"])
    log(f"  env 0 vs the single env: x max_abs {diff:.3e} rel {diff / scale:.3e} (bound "
        f"{STEP_TOL['x']:.0e}); loss {float(info['loss'][0]):.9g} vs {single['loss']:.9g} rel "
        f"{rel:.3e} (bound {REF_TOL:.0e})")
    if not (diff <= STEP_TOL["x"] * scale and rel <= REF_TOL):
        raise AssertionError("the batched env's env 0 differs from the single env")
    return out


def recording(sampler):
    """A sampler for Renderer.uniform that keeps the draws it hands out."""
    draws = []

    def uniform(shape):
        draws.append(sampler(shape))
        return draws[-1]

    uniform.draws = draws
    return uniform


def replaying(draws):
    """A sampler for Renderer.uniform that hands out `draws` in order."""
    it = iter(draws)

    def uniform(shape):
        a = next(it)
        if tuple(a.shape) != tuple(shape):
            raise AssertionError(f"replayed draw {tuple(a.shape)} for {tuple(shape)}")
        return a

    return uniform


def phase_vec_rgb():
    """VecPlasticineEnv("Move-v1", obs_mode="rgb") for each B of VEC_BATCHES:
    reset and RGB_STEPS seeded steps, each fetching the frames, reward and
    info; then at B = VEC_B each env's frame against the single env's
    render_obs of its state, the single renders' draws replayed."""
    import torch

    from plasticinelab_tpu_torch.engine import cuda_gridop, cuda_stress, cuda_transfer
    from plasticinelab_tpu_torch.engine.renderer import cuda_voxelize, renderer
    from plasticinelab_tpu_torch.engine.state import SimState, state_fields
    from plasticinelab_tpu_torch.envs import make
    from plasticinelab_tpu_torch.parallel import VecPlasticineEnv

    mods = (cuda_stress, cuda_transfer, cuda_gridop, cuda_voxelize)
    out = {"envs": {}, "sps": {}, "launches": {}}
    for B in VEC_BATCHES:
        t0 = time.perf_counter()
        ve = VecPlasticineEnv("Move-v1", batch=B, seed=SEED, horizon=RGB_STEPS, obs_mode="rgb",
                              device=DEVICE)
        torch.cuda.synchronize()
        t_setup = time.perf_counter() - t0
        sub = ve.scene.simulator.substeps
        for mod in mods:
            mod.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        frames = [ve.reset().cpu().numpy()]
        stamps = [time.perf_counter()]
        rng = np.random.default_rng(SEED)
        for a in rng.uniform(-1, 1, (RGB_STEPS, B, ve.action_dim)):
            obs, reward, done, info = ve.step(a)
            frames.append(obs.cpu().numpy())
            host = torch.cat([reward, info["loss"], info["iou"]]).cpu().numpy()
            stamps.append(time.perf_counter())
            if not np.isfinite(host).all():
                raise AssertionError(f"B={B}: non-finite reward or info")
        peak = torch.cuda.max_memory_allocated()
        launches = {k: v for mod in mods for k, v in mod.launches.items()}
        for f in frames:
            if f.shape != (B, 64, 64, 3) or f.dtype != np.uint8 or not 0 < f.mean() < 255:
                raise AssertionError(f"B={B}: bad frames {f.shape} {f.dtype} mean {f.mean()}")
        sps = B * (RGB_STEPS - 1) / (stamps[-1] - stamps[1])
        log(f"phase vec rgb: VecPlasticineEnv('Move-v1', batch={B}, obs_mode='rgb'): set-up "
            f"{t_setup:.3f} s, reset + {RGB_STEPS} steps; launches {launches}")
        log(f"  rgb vec env steps/s {sps:.3f} (B x steps 2..{RGB_STEPS} over host seconds), "
            f"batched step {1e3 * (stamps[-1] - stamps[1]) / (RGB_STEPS - 1):.3f} ms; peak "
            f"device memory {(peak - base) / 2**30:.4f} GiB above {base / 2**30:.3f} GiB at "
            f"start; frame mean {frames[-1].mean():.4f}; envs' last frames all equal: "
            f"{bool((frames[-1] == frames[-1][:1]).all())}")
        expected = {"voxelize_batched": RGB_STEPS + 1, "voxelize": 0,
                    "p2g_batched": RGB_STEPS * sub, "grid_op_batched": RGB_STEPS * sub}
        for key, want in expected.items():
            if launches[key] != want:
                raise AssertionError(f"B={B}: {key} ran {launches[key]} times, expected {want}")
        out["envs"][B], out["sps"][B] = ve, sps
        out["launches"][B] = launches["voxelize_batched"]

    # each env's frame against the single env's render_obs of its state
    ve = out["envs"][VEC_B]
    env = make("Move-v1", device=DEVICE, obs_mode="rgb")
    te = env.unwrapped.taichi_env
    te.render_obs(64, 2)  # builds its observation renderer
    singles, draws = [], []
    for b in range(VEC_B):
        te.state = SimState(*(t[b] for t in state_fields(ve.states)))
        sampler = recording(renderer.torch_sampler(DEVICE, SEED + 20 + b))
        te._obs_renderer.uniform = sampler
        singles.append(te.render_obs(64, 2))
        draws.append(sampler.draws)
    ve._renderer.uniform = replaying([torch.cat(d) for d in zip(*draws)])
    with torch.no_grad():
        got = ve._observe(ve.states).cpu().numpy()
    differ = [int((got[b] != singles[b]).any(-1).sum()) for b in range(VEC_B)]
    log(f"phase vec rgb parity: B={VEC_B} after {RGB_STEPS} steps, each env's frame against "
        f"the single env's render_obs of its state, draws replayed: pixels that differ "
        f"{differ}; frame means {[round(float(f.mean()), 3) for f in singles]}")
    if any(differ):
        # the float bound, from the same draws
        ve._renderer.uniform = replaying([torch.cat(d) for d in zip(*draws)])
        with torch.no_grad():
            xs = ve.states
            batched = ve._obs_fn(xs.x.float(), ve._colors, xs.prim_pos, xs.prim_rot, xs.prim_gap)
            err = 0.0
            for b in range(VEC_B):
                te.state = SimState(*(t[b] for t in state_fields(xs)))
                te._obs_renderer.uniform = replaying(draws[b])
                single = te._visual_obs_fn(*te._state_args())
                err = max(err, float((batched[b] - single).abs().max()))
        log(f"  float images: max abs difference {err:.3e}")
        raise AssertionError("the batched frames differ from the single env's")
    ve._renderer.uniform = renderer.torch_sampler(DEVICE, SEED + 1)
    return out


def phase_vec_backward():
    """The batched backward kernels at Move-v1 shapes for VEC_B and for the
    largest of VEC_BATCHES envs, each env's cloud moved by its own noise,
    each env with its own poses and softness, seeded cotangents: against the
    autograd VJP of the batched plain versions, and (B = VEC_B) per env
    against B = 1 launches. The line's entries are the largest B's."""
    import torch

    from plasticinelab_tpu_torch.config.spec import PrimitiveSpec
    from plasticinelab_tpu_torch.engine import cuda_gridop, cuda_stress, cuda_transfer
    from plasticinelab_tpu_torch.engine.state import default_materials

    scene, x_np = move_scene()
    sim = scene.simulator
    n, G = len(x_np), sim.n_grid
    center = x_np.mean(axis=0)
    mats = default_materials(scene)
    results = {}

    def grid_op_case(label, sc, B, grid4, ct3, seed, pose_tol, singles):
        """K8-bwd-b of scene sc against the plain VJP (d grid4 rows with
        flips counted, and the pose cotangents, `compare_poses`) and, with
        `singles`, two calls and per env against B = 1 launches bit for
        bit."""
        pf, pf1 = batch_poses(B, len(sc.primitives), seed, center)
        softness = tensor(np.where(np.arange(B) % 2, 333.0, 666.0))
        want, p = plain_vjp(
            lambda g, *ps: cuda_gridop.grid_op_plain_batched(sc, g, ps[:3], ps[3:], softness),
            [grid4, *pf, *pf1], [ct3])
        want_poses = cuda_gridop.pack_poses(want[1:4], want[4:7])
        poses = cuda_gridop.pack_poses(pf, pf1).contiguous()
        k = lambda: cuda_gridop.grid_op_bwd(sc, grid4, poses, softness, ct3)  # noqa: E731
        dg4, dposes = k()
        if singles:
            again = k()
            if not (torch.equal(dg4, again[0]) and torch.equal(dposes, again[1])):
                raise AssertionError(f"grid_op_bwd_batched[{label}]: two calls differ")
        flat = lambda t: t.reshape(-1, t.shape[-1])  # noqa: E731
        err = compare(f"grid_op_bwd_batched[{label}] d grid4", (flat(dg4),), (flat(want[0]),),
                      BWD_TOL["grid_op_bwd"], FLIP_BUDGET * B)
        compare(f"grid_op_bwd_batched[{label}] by row", (flat(dg4),), (flat(want[0]),),
                BWD_TOL["grid_op_bwd"], FLIP_BUDGET * B, per_row=True)
        compare_poses(f"grid_op_bwd_batched[{label}]", dposes, want_poses, pose_tol)
        for b in range(B):  # every env has its own pose gradient
            if not float(want_poses[b].abs().max()) > 0:
                raise AssertionError(f"grid_op_bwd_batched[{label}]: env {b} has no pose gradient")
        if singles:
            log(f"  grid_op_bwd_batched[{label}]: two calls bit for bit")
            per_env(f"grid_op_bwd_batched[{label}]", (dg4, dposes),
                    [cuda_gridop.grid_op_bwd(sc, grid4[b], poses[b], softness[b:b + 1], ct3[b])
                     for b in range(B)])
        return (err, k, p, (grid4, poses, softness, Gathered(ct3, mass_share(grid4))),
                int((grid4[..., 3] > 1e-12).sum()))

    def run(B):
        log(f"phase vec backward kernels: Move-v1 shapes, B={B} envs of n={n} particles, "
            f"G={G} grid, seed {SEED + 7}")
        rng = np.random.default_rng(SEED + 7)
        x = tensor(np.clip(x_np + rng.uniform(-0.01, 0.01, (B, n, 3)), 0.0, 0.95))
        v = tensor(rng.standard_normal((B, n, 3)) * 0.5)
        C = tensor(rng.standard_normal((B, n, 3, 3)) * 2.0)
        aff = tensor(rng.standard_normal((B, n, 3, 3)) * 0.3)
        grid_v = tensor(rng.standard_normal((B, G ** 3, 3)) * 0.5)
        ct4, ctm = tensor(rng.standard_normal((B, G ** 3, 4))), tensor(rng.standard_normal((B, G ** 3)))
        ct_v, ct_C, ct_x = (tensor(rng.standard_normal((B, n, 3))),
                            tensor(rng.standard_normal((B, n, 3, 3))),
                            tensor(rng.standard_normal((B, n, 3))))
        ct3 = tensor(rng.standard_normal((B, G ** 3, 3)))
        first = B == VEC_B

        def rec(name, *args):
            record(results, name if B == VEC_BATCHES[-1] else f"{name}[B={B}]", name, *args)

        share = touched_share(scene, x)  # of the grids that the gathers read
        orders = scatter_orders(scene, x, v, SEED + 7)
        srt = orders["sorted"]
        # name -> (kernel, batched plain version, inputs, cotangents, the B = 1
        # launch on env b, its tolerance per output: None = bit for bit, what
        # the call must read)
        transfers = {
            "p2g_bwd_batched": (
                lambda: cuda_transfer.p2g_bwd(scene, x, v, aff, ct4),
                lambda a, b, c: cuda_transfer.p2g_plain_batched(scene, a, b, c), [x, v, aff],
                [ct4], lambda b: cuda_transfer.p2g_bwd(scene, x[b], v[b], aff[b], ct4[b]), None,
                (x, v, aff, Gathered(ct4, share))),
            "grid_mass_bwd_batched": (
                lambda: (cuda_transfer.grid_mass_bwd(scene, x, ctm),),
                lambda a: cuda_transfer.grid_mass_plain_batched(scene, a), [x], [ctm],
                lambda b: cuda_transfer.grid_mass_bwd(scene, x[b], ctm[b]), None,
                (x, Gathered(ctm, share))),
            "g2p_bwd_batched": (
                lambda o=srt: cuda_transfer.g2p_bwd(scene, x, grid_v, ct_v, ct_C, ct_x, o),
                lambda a, g: cuda_transfer.g2p_plain_batched(scene, a, g), [x, grid_v],
                [ct_v, ct_C, ct_x],
                lambda b: cuda_transfer.g2p_bwd(scene, x[b], grid_v[b], ct_v[b], ct_C[b], ct_x[b],
                                                srt[b]),
                (None, BWD_TOL["g2p_bwd"]), (x, Gathered(grid_v, share), ct_v, ct_C, ct_x, srt)),
        }
        for name, (kern, plain, inputs, cts, single, env_tol, read) in transfers.items():
            want, p = plain_vjp(plain, inputs, cts)
            got = as_tuple(kern())
            flat = lambda t: t.reshape((-1,) + t.shape[2:])  # noqa: E731
            err = compare(f"{name} [B={B}]", tuple(map(flat, got)), tuple(map(flat, want)),
                          BWD_TOL[BATCHED_BWD[name]])
            if name == "g2p_bwd_batched":  # the scatter: under every order
                err = worst([err] + [compare(f"{name} [B={B}, order: {o}]",
                                             tuple(map(flat, kern(orders[o]))),
                                             tuple(map(flat, want)), BWD_TOL["g2p_bwd"])
                                     for o in ORDERS if o != "sorted"])
            if first:
                per_env(name, got, [single(b) for b in range(B)], env_tol)
            rec(name, err, kern, p, read, B * n)

        # K1 and K2 at the batched path's size, the flat B n particles (the
        # same kernels as the single env's: timed and logged, not in the line)
        Cf = C.reshape(B * n, 3, 3)
        Ff = tensor(np.eye(3) + rng.standard_normal((B * n, 3, 3)) * 0.15)
        cts = [tensor(rng.standard_normal((B * n, 3, 3))) for _ in range(2)]
        k1 = lambda: cuda_stress.stress_affine(scene, mats, Cf, Ff)  # noqa: E731
        p1 = lambda: cuda_stress.stress_affine_plain(scene, mats, Cf, Ff)  # noqa: E731
        record(results, f"stress_affine[n={B * n}]", "stress_affine",
               compare(f"stress_affine [n={B * n}]", k1(), p1(), TOL["stress_affine"]), k1, p1,
               (Cf, Ff), B * n)
        log_cold_time(f"stress_affine[n={B * n}]", k1)
        want, p2 = plain_vjp(lambda c, f: cuda_stress.stress_affine_plain(scene, mats, c, f),
                             [Cf, Ff], cts)
        k2 = lambda: cuda_stress.stress_affine_bwd(scene, mats, Cf, Ff, *cts)  # noqa: E731
        record(results, f"stress_affine_bwd[n={B * n}]", "stress_affine_bwd",
               compare(f"stress_affine_bwd [n={B * n}]", k2(), want,
                       BWD_TOL["stress_affine_bwd"]), k2, p2, (Cf, Ff, *cts), B * n)
        log_cold_time(f"stress_affine_bwd[n={B * n}]", k2)

        # the grid update's backward on realistic grids: P2G of the clouds
        grid4 = cuda_transfer.p2g_plain_batched(scene, x, v, sim.p_mass * C)
        if first:
            for i, (shape, kw) in enumerate(SHAPE_PARAMS.items()):
                sc = scene.replace(primitives=(PrimitiveSpec(shape=shape, friction=0.9, **kw),))
                grid_op_case(shape, sc, B, grid4, ct3, 400 + 10 * i,
                             POSE_TOL.get(shape, BWD_TOL["grid_op_bwd"]), True)
            sc = mixed_scene(scene)
            grid_op_case(f"mixed: {', '.join(MIXED_SHAPES)}, B={B}", sc, B, grid4, ct3, 470,
                         pose_tols(sc), True)
        mass_shares(f"Move-v1 grids, B={B}", grid4)
        if first:  # a batch without mass: zeros, no NaN
            pf, pf1 = batch_poses(B, len(scene.primitives), 500, center)
            dg4, dposes = cuda_gridop.grid_op_bwd(
                scene, torch.zeros_like(grid4), cuda_gridop.pack_poses(pf, pf1).contiguous(),
                tensor(np.full(B, 666.0)), ct3)
            if not (bool((dg4 == 0).all()) and bool((dposes == 0).all())):
                raise AssertionError("grid_op_bwd_batched without mass: non-zero cotangents")
            log(f"  grid_op_bwd_batched[no mass, B={B}] d grid4 and d poses all 0")
        move = grid_op_case(f"Move-v1: 2 Spheres, B={B}", scene, B, grid4, ct3, 500,
                            BWD_TOL["grid_op_bwd"], first)
        rec("grid_op_bwd_batched", *move)
        log_cold_time(f"grid_op_bwd_batched[B={B}]", move[1])

    for B in (VEC_B, VEC_BATCHES[-1]):
        run(B)
        torch.cuda.empty_cache()
    log(f"  device memory held for the device times (inputs and the plain VJPs' graphs): "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    return results


def transfer_inputs(scene, x_np, B, seed):
    """Seeded inputs of the transfer kernels for B envs of the cloud x_np,
    each env's cloud moved by its own noise: x, v, affine, grid_v, the
    cotangents of G2P's outputs and of the grids, all with a leading B."""
    n, G = len(x_np), scene.simulator.n_grid
    rng = np.random.default_rng(seed)
    x = tensor(np.clip(x_np + rng.uniform(-0.01, 0.01, (B, n, 3)), 0.0, 0.99))
    return dict(x=x, v=tensor(rng.standard_normal((B, n, 3)) * 0.5),
                aff=tensor(rng.standard_normal((B, n, 3, 3)) * 0.3),
                grid_v=tensor(rng.standard_normal((B, G ** 3, 3)) * 0.5),
                ct_v=tensor(rng.standard_normal((B, n, 3))),
                ct_C=tensor(rng.standard_normal((B, n, 3, 3))),
                ct_x=tensor(rng.standard_normal((B, n, 3))),
                ct4=tensor(rng.standard_normal((B, G ** 3, 4))),
                ctm=tensor(rng.standard_normal((B, G ** 3))))


def scatter_calls(scene, t, order):
    """name -> a call of each scatter kernel (K3, K7 forward, K6) on
    `transfer_inputs` t, walking `order`."""
    from plasticinelab_tpu_torch.engine import cuda_transfer

    return {
        "p2g": lambda: cuda_transfer.p2g_batched(scene, t["x"], t["v"], t["aff"], order),
        "grid_mass": lambda: cuda_transfer.grid_mass_batched(scene, t["x"], order),
        "g2p_bwd": lambda: cuda_transfer.g2p_bwd(scene, t["x"], t["grid_v"], t["ct_v"], t["ct_C"],
                                                 t["ct_x"], order),
    }


def gather_calls(scene, t, env=None):
    """name -> a call of each gather kernel (K5, K4, K7 backward) on
    `transfer_inputs` t, over its B envs, or with `env` a B = 1 launch on
    that env's rows. They take no order: they walk the particles as they
    lie (PERF.md)."""
    from plasticinelab_tpu_torch.engine import cuda_transfer

    u = t if env is None else {k: w[env] for k, w in t.items()}
    return {
        "g2p": lambda: (cuda_transfer.g2p_batched if env is None else cuda_transfer.g2p)(
            scene, u["x"], u["grid_v"]),
        "p2g_bwd": lambda: cuda_transfer.p2g_bwd(scene, u["x"], u["v"], u["aff"], u["ct4"]),
        "grid_mass_bwd": lambda: (cuda_transfer.grid_mass_bwd(scene, u["x"], u["ctm"]),),
    }


def transfer_plain(scene, t):
    """name -> the plain versions' outputs (the VJPs for the backward
    kernels) on `transfer_inputs` t."""
    from plasticinelab_tpu_torch.engine import cuda_transfer as ct

    def vjp(fn, ins, cts):
        return plain_vjp(fn, [t[k] for k in ins], [t[k] for k in cts])[0]

    return {"p2g": (ct.p2g_plain_batched(scene, t["x"], t["v"], t["aff"]),),
            "grid_mass": (ct.grid_mass_plain_batched(scene, t["x"]),),
            "g2p_bwd": vjp(lambda a, g: ct.g2p_plain_batched(scene, a, g), ("x", "grid_v"),
                           ("ct_v", "ct_C", "ct_x")),
            "g2p": ct.g2p_plain_batched(scene, t["x"], t["grid_v"]),
            "p2g_bwd": vjp(lambda a, b, c: ct.p2g_plain_batched(scene, a, b, c),
                           ("x", "v", "aff"), ("ct4",)),
            "grid_mass_bwd": vjp(lambda a: ct.grid_mass_plain_batched(scene, a), ("x",),
                                 ("ctm",))}


def phase_transfer_cases():
    """The transfer kernels on clouds that the main path does not give them:
    one spread over the whole domain, where hardly two particles share a
    base cell (nearly every lane of a scatter adds alone, and the gathers'
    lanes read apart), and one in two corners of the domain, whose base
    cells are clamped at both walls; B = 2 envs of Move-v1's particle count,
    against the plain versions (the VJPs for the backward kernels): the
    scatters (K3, K7 forward, K6) under the four orders, the gathers (K5,
    K4, K7 backward) also per env bit for bit against B = 1 launches."""
    import torch

    from plasticinelab_tpu_torch.engine import cuda_transfer

    scene, x_np = move_scene()
    n, B = len(x_np), 2
    rng = np.random.default_rng(SEED + 10)
    clouds = {
        "wide": rng.uniform(0.0, 0.99, (n, 3)),
        "corners": np.concatenate([rng.uniform(0.0, 0.04, (n // 2, 3)),
                                   rng.uniform(0.93, 0.99, (n - n // 2, 3))]),
    }
    tol = {**TOL, **BWD_TOL}
    log(f"phase transfer cases: B={B} envs of n={n} particles, seed {SEED + 10}")
    flat = lambda u: u.reshape((-1,) + u.shape[2:])  # noqa: E731
    for label, cloud in clouds.items():
        t = transfer_inputs(scene, cloud, B, SEED + 11)
        want = transfer_plain(scene, t)
        for oname, order in scatter_orders(scene, t["x"], t["v"], SEED + 12).items():
            left = float(cuda_transfer.lane_groups(scene, t["x"], order).sum()) / (B * n)
            for name, call in scatter_calls(scene, t, order).items():
                compare(f"{name} [{label}, order: {oname}, adds left {left:.3f}]",
                        tuple(map(flat, as_tuple(call()))), tuple(map(flat, want[name])),
                        tol[name])
        singles = [gather_calls(scene, t, b) for b in range(B)]
        for name, call in gather_calls(scene, t).items():
            got = as_tuple(call())
            compare(f"{name} [{label}]", tuple(map(flat, got)), tuple(map(flat, want[name])),
                    tol[name])
            per_env(f"{name} [{label}]", got, [s[name]() for s in singles])
    torch.cuda.synchronize()


def phase_transfer_times():
    """Device ms per call (torch.profiler) of the transfer kernels at
    Move-v1 shapes for each B of VEC_BATCHES: the scatters (with the memset
    of their zeroed grid) under the order an env step computes, a stale one
    and none, with the share of the global adds that is left after the
    lanes of a warp that share a base cell have been summed (`lane_groups`
    / particles); the gathers, which take no order; at the first and last B
    the gathers and the sorted order's scatters also by CUDA events,
    L2-cold and L2-warm; and what `cell_order` itself costs per env step."""
    from plasticinelab_tpu_torch.engine import cuda_transfer
    from plasticinelab_tpu_torch.engine.transfer import cell_order

    scene, x_np = move_scene()
    n = len(x_np)
    log(f"phase transfer times: Move-v1 shapes, n={n}; device ms per call")
    for B in VEC_BATCHES:
        t = transfer_inputs(scene, x_np, B, SEED + 13)
        orders = scatter_orders(scene, t["x"], t["v"], SEED + 14)
        events = B in (VEC_BATCHES[0], VEC_BATCHES[-1])
        for oname in ("sorted", "stale", "none"):
            order = orders[oname]
            left = float(cuda_transfer.lane_groups(scene, t["x"], order).sum()) / (B * n)
            calls = scatter_calls(scene, t, order)
            times = {name: device_time(call) for name, call in calls.items()}
            log(f"  B={B:2d} order {oname:6s} adds left {left:.4f}: "
                + "  ".join(f"{name} {ms}" for name, ms in times.items()))
            if oname == "sorted" and events:
                for name, call in calls.items():
                    log_cold_time(f"{name}[B={B}, sorted]", call)
        calls = gather_calls(scene, t)
        log(f"  B={B:2d} gathers: "
            + "  ".join(f"{name} {device_time(call)}" for name, call in calls.items()))
        if events:
            for name, call in calls.items():
                log_cold_time(f"{name}[B={B}]", call)
        ms, ops = device_ops(lambda: cell_order(scene, t["x"]))
        log(f"  B={B:2d} cell_order: device {ms} ms, {ops} device operations, "
            f"{wall_time(lambda: cell_order(scene, t['x'])):.4f} ms by CUDA events with the "
            "host's launches, once per env step")


def bench_actions(scene, B=None):
    """bench.py's actions (HORIZON, action_dim); tiled over B envs with B."""
    a = np.random.default_rng(0).uniform(-1e-4, 1e-4, (HORIZON, scene.action_dim))
    return a if B is None else np.tile(a, (B, 1, 1))


def phase_vec_gradient():
    """`build_batched_rollout_grad` on Move-v1 at full width for each B of
    VEC_BATCHES, then the parity checks."""
    import torch

    from plasticinelab_tpu_torch.engine import cuda_gridop, cuda_stress, cuda_transfer, mpm
    from plasticinelab_tpu_torch.engine.sim import rollout_losses_batched
    from plasticinelab_tpu_torch.envs import make
    from plasticinelab_tpu_torch.parallel import batch_states, build_batched_rollout_grad

    mods = (cuda_stress, cuda_transfer, cuda_gridop)
    env = make("Move-v1", device=DEVICE)
    env.reset()
    te = env.unwrapped.taichi_env
    scene, sub = te.scene, te.scene.simulator.substeps
    step = build_batched_rollout_grad(scene, te.mats, te.loss_state, device=DEVICE)
    out = {"step": step, "te": te, "seconds": {}}
    single = ("p2g", "grid_mass", "g2p", "grid_op", "p2g_bwd", "grid_mass_bwd", "g2p_bwd",
              "grid_op_bwd")
    for B in VEC_BATCHES:
        states = batch_states(te.state, B, jitter=VEC_GRAD_JITTER, seed=SEED)
        actions = bench_actions(scene, B)
        for mod in mods:
            mod.reset_launches()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        loss, grad = step(states, actions, te.softness)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        launches = {k: v for mod in mods for k, v in mod.launches.items()}
        peak = torch.cuda.max_memory_allocated()
        remat = step.last_remat
        log(f"phase vec gradient: build_batched_rollout_grad, Move-v1, B={B}, {HORIZON} steps x "
            f"{sub} substeps, jitter {VEC_GRAD_JITTER}, remat {remat}; launches {launches}")
        fwd = HORIZON * (2 if remat == "env_step" else 1)  # the recomputed forward
        expected = {"stress_affine": fwd * sub, "p2g_batched": fwd * sub,
                    "grid_op_batched": fwd * sub, "g2p_batched": fwd * sub,
                    "grid_mass_batched": fwd, "stress_affine_bwd": HORIZON * sub,
                    "p2g_bwd_batched": HORIZON * sub, "grid_op_bwd_batched": HORIZON * sub,
                    "g2p_bwd_batched": HORIZON * sub, "grid_mass_bwd_batched": HORIZON}
        expected.update({k: 0 for k in single})
        for key, want in expected.items():
            if launches[key] != want:
                raise AssertionError(f"B={B}: {key} ran {launches[key]} times, expected {want}")
        g = grad.double()
        if not (grad.shape == (B, HORIZON, scene.action_dim) and torch.isfinite(loss)
                and torch.isfinite(g).all() and float(g.abs().max()) > 0):
            raise AssertionError(f"B={B}: the batched gradient is not finite and non-zero")
        if B > 1 and bool((g[1:] == g[:1]).all()):
            raise AssertionError(f"B={B}: jittered envs gave identical gradient rows")
        times = []
        for _ in range(TRAJ_RUNS):
            t0 = time.perf_counter()
            step(states, actions, te.softness)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        best = min(times)
        log(f"  mean loss {float(loss):.9g}  |grad| max {float(g.abs().max()):.6e}; seconds per "
            f"batched gradient: best {best:.4f}, runs {[round(x, 4) for x in times]} (first, "
            f"with warm-up, {first:.4f}); substeps/s x B fwd+bwd {B * HORIZON * sub / best:.1f}; "
            f"peak device memory {(peak - base) / 2**30:.3f} GiB above {base / 2**30:.3f} GiB at "
            f"start ({(peak - base) / (B * HORIZON * sub) / 2**20:.3f} MiB per env substep; "
            f"resolve_remat assumes {mpm.substep_bytes(scene) / 2**20:.3f} under 'none')")
        out["launches"], out["seconds"][B] = launches, best
        del states, loss, grad, g

    # parity: VEC_B envs without jitter, and the single env, same actions
    torch.cuda.empty_cache()
    states = batch_states(te.state, VEC_B, jitter=0.0)
    loss, grad = step(states, bench_actions(scene, VEC_B), te.softness)
    loss1, grad1, _ = te.rollout_value_and_grad(te.state, bench_actions(scene), te.softness)
    grad, grad1 = grad.double(), grad1.double()
    scale = float(grad1.abs().max())
    rows = float((grad - grad[:1]).abs().max()) * VEC_B / scale
    first_row = float((grad[0] * VEC_B - grad1).abs().max()) / scale
    rel_l = abs(float(loss) - float(loss1)) / abs(float(loss1))
    log(f"phase vec gradient parity: B={VEC_B} without jitter (remat {step.last_remat}), "
        f"{HORIZON} steps: every row vs row 0 max rel {rows:.3e}; B x row 0 vs the single env's "
        f"gradient (remat {te.last_remat}) max rel {first_row:.3e} (bound "
        f"{VEC_ROW_TOL['grad']:.0e}); mean loss {float(loss):.9g} vs {float(loss1):.9g} rel "
        f"{rel_l:.3e} (bound {VEC_ROW_TOL['loss']:.0e})")
    if not (rows <= VEC_ROW_TOL["grad"] and first_row <= VEC_ROW_TOL["grad"]
            and rel_l <= VEC_ROW_TOL["loss"]):
        raise AssertionError("the batched gradient differs from the single env's")
    del states, grad, grad1

    # kernels vs plain versions on a short horizon
    Bs, T = VEC_GRAD_SHORT
    states = batch_states(te.state, Bs, jitter=VEC_GRAD_JITTER, seed=SEED + 8)
    acts = tensor(np.random.default_rng(SEED + 9).uniform(-1, 1, (Bs, T, scene.action_dim)))
    res = {}
    for name, ops, remat in (("kernels", mpm.KERNEL_OPS_BATCHED, "none"),
                             ("plain", mpm.PLAIN_OPS_BATCHED, "env_step")):
        a = acts.clone().requires_grad_(True)
        rows_, _ = rollout_losses_batched(scene, te.mats, te.loss_state, states, a, te.softness,
                                          remat, ops)
        total = rows_.sum(dim=0).mean()
        (g,) = torch.autograd.grad(total, a)
        res[name] = (float(total.detach()), g.double())
    (lk, gk), (lp, gp) = res["kernels"], res["plain"]
    rel_l = abs(lk - lp) / abs(lp)
    rel_g = float((gk - gp).abs().max() / gp.abs().max())
    log(f"phase vec gradient kernels vs plain: B={Bs}, {T} steps: mean loss {lk:.9g} vs "
        f"{lp:.9g} rel {rel_l:.3e} (bound {GRAD_TOL['loss']:.0e}); d/d actions max |grad| "
        f"{float(gp.abs().max()):.4e} max diff rel {rel_g:.3e} (bound {GRAD_TOL['grad']:.0e})")
    if not (torch.isfinite(gk).all() and rel_l <= GRAD_TOL["loss"] and rel_g <= GRAD_TOL["grad"]):
        raise AssertionError("batched kernel and plain trajectory gradients disagree")
    torch.cuda.empty_cache()
    return out


def vec_profile(work):
    """Device busy ms, wall ms, busy share and device operations (kernels,
    memsets, copies) of one call of work(), and the runtime's launch, copy
    and synchronise calls torch.profiler saw; a profile that lost events is
    taken again as in `device_ops`."""
    import torch

    def run():
        work()
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    run()
    wall = (time.perf_counter() - t0) * 1e3
    for attempt in range(3):
        prof, launched = profiled(run, cpu=True)
        dev = device_events(prof)
        ours = sum(bool(PORT_KERNELS.search(e.name)) for e in dev)
        if dev and ours == launched:
            break
        log(f"    profile {attempt + 1} lost events: {ours} of the port's kernels for "
            f"{launched} launches" + ("; the busy time below under-reads" if attempt == 2 else ""))
    busy = sum(e.device_time_total for e in dev) / 1e3
    ops = len(dev)
    events = prof.key_averages()
    calls = {name: sum(e.count for e in events if e.key.startswith(prefixes))
             for name, prefixes in (("launch", ("cudaLaunchKernel", "cuLaunchKernel")),
                                    ("copy", ("cudaMemcpy",)),
                                    ("sync", ("cudaStreamSynchronize",
                                              "cudaDeviceSynchronize")))}
    return busy, wall, busy / wall, ops, calls


def busy_share(fn):
    """(device busy ms, wall ms, busy share) of fn(): the device time of the
    kernels, memsets and copies it ran (torch.profiler) over its own
    unprofiled wall time."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    busy = device_time(fn, reps=1)
    return busy, wall, (busy / wall if busy else None)


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
    with open(os.path.join(os.path.dirname(path), "build.log")) as f:
        for line in f:
            if "Compiling entry function" in line or "registers" in line or "spill" in line:
                log("  ptxas: " + line.strip())
    for kernel, (count, mufu, call) in sass_counts(path).items():
        log(f"  sass {kernel}: {count} instructions, {mufu} MUFU, {call} CALL")

    def timed(phase):
        log(f"[{time.perf_counter() - t0:.1f} s since the build began] {phase.__name__}")
        return phase()

    results = timed(phase_kernels)
    timed(phase_reference)
    launches, _ = timed(phase_slice)
    results.update(timed(phase_backward))
    results.update(timed(phase_stress_cases))
    timed(phase_transfer_cases)
    # the backward kernels' counts come from the trajectory gradient's run
    launches.update({k: v for k, v in timed(phase_gradient).items() if k.endswith("_bwd")})
    timed(phase_solve)
    timed(phase_nn_gradient)
    timed(phase_nn_solve)
    results.update(timed(phase_voxelize))
    timed(phase_render_reference)
    render = timed(phase_render)
    launches["voxelize"] = render["voxelize_launches"]
    results.update(timed(phase_vec_kernels))
    vec = timed(phase_vec)
    launches.update({k: vec["launches"][k] for k in BATCHED_FWD})
    vec_rgb = timed(phase_vec_rgb)
    launches["voxelize_batched"] = vec_rgb["launches"][VEC_BATCHES[-1]]
    sac = timed(phase_sac)
    rl = timed(phase_rl)
    vgrad = timed(phase_vec_gradient)
    results.update(timed(phase_vec_backward))
    launches.update({k: vgrad["launches"][k] for k in BATCHED_BWD})
    # after the slice: an active profiler slows every later launch
    timed(phase_transfer_times)
    log(f"[{time.perf_counter() - t0:.1f} s since the build began] phase device times")
    log("phase device times (ms per call: torch.profiler, or CUDA events where every profile "
        "lost events)")
    _, empty = cold_time(lambda: None)
    log(f"  CUDA events around an empty call: {empty:.4f} ms (L2-warm median), taken off the "
        "event times below")
    calls = {k: r.pop("calls") for k, r in results.items()}
    # the kernels' profiles first: losses began with the plain versions'
    # profiles of tens of thousands of events (PERF.md); then the library
    # calls (K9's scatter_reduce_)
    for which, field in ((0, "ms"), (1, "plain_ms"), (2, "library_ms")):
        reps = PLAIN_REPS if which == 1 else KERNEL_REPS
        for k, r in results.items():
            if which >= len(calls[k]):
                continue
            fn, how = calls[k][which], "profiler"
            ms = device_time(fn, reps)
            if ms is None:
                ms, how = cold_time(fn, reps)[1] - empty, "CUDA events, L2-warm"
            r[field] = ms
            log(f"  {k:28s} {field:8s} {ms:.4f} ({how})")
            if which == 0 and k in SPREAD_KEYS:  # readings that spread across runs
                cold, warm = cold_time(fn)
                log(f"  {k:28s} again {device_time(fn)}; CUDA events L2-cold {cold:.4f} "
                    f"L2-warm {warm:.4f}")
    te = render["rgb_env"].unwrapped.taichi_env
    busy, wall, share = busy_share(lambda: render["rgb_env"].step(np.zeros(6)))
    log(f"  rgb env step: device busy {busy} ms of {wall:.3f} ms wall, busy share {share}")
    busy, wall, share = busy_share(lambda: te.render_obs(64, 2))
    log(f"  render_obs: device busy {busy} ms of {wall:.3f} ms wall, busy share {share}")
    busy, wall, share = busy_share(lambda: render["env"].unwrapped.taichi_env.render(spp=1))
    log(f"  512^2 frame at 1 spp: device busy {busy} ms of {wall:.3f} ms wall, busy share "
        f"{share}")
    for B, ve in vec_rgb["envs"].items():
        zeros = np.zeros((ve.batch, ve.action_dim))
        busy, wall, share, ops, calls = vec_profile(
            lambda: [ve.step(zeros)[0].cpu() for _ in range(RGB_PROFILE_STEPS)])
        log(f"  {RGB_PROFILE_STEPS} batched rgb env steps, B={B}: device busy "
            f"{busy / RGB_PROFILE_STEPS:.3f} ms of {wall / RGB_PROFILE_STEPS:.3f} ms wall per "
            f"step, busy share {share:.4f}; per step: device operations "
            f"{ops / RGB_PROFILE_STEPS:.1f}, runtime calls "
            + ", ".join(f"{k} {v / RGB_PROFILE_STEPS:.1f}" for k, v in calls.items())
            + f"; rgb vec env steps/s {vec_rgb['sps'][B]:.3f} (unprofiled run)")
    from plasticinelab_tpu_torch.algorithms.sac.sac import samplers

    algo, buf = sac
    algo.normal, algo.indices = samplers(DEVICE, SEED)
    B = VEC_BATCHES[-1]
    ve = vec["envs"][B]
    obs = ve.reset()
    busy, wall, share, ops, calls = vec_profile(
        lambda: (ve.step(algo.explore_batch(obs)), algo.update_many_device(buf, SAC_BATCH, B)))
    log(f"  one SAC train_vec iteration, B={B} (explore_batch, a batched env step, {B} "
        f"updates of batch {SAC_BATCH}): device busy {busy:.3f} ms of {wall:.3f} ms wall, busy "
        f"share {share:.4f}; device operations {ops}, runtime calls "
        + ", ".join(f"{k} {v}" for k, v in calls.items()))
    t_rl = time.perf_counter()
    td3, td3_buf = rl
    td3.normal, td3.indices = samplers(DEVICE, SEED)
    zeros_done = torch.zeros((B,), device=DEVICE)

    def td3_iteration():
        acts = td3.select_action_batch(obs)
        acts = torch.clamp(acts + 0.1 * td3.normal(acts.shape), -1, 1)
        nobs, reward, _, _ = ve.step(acts)
        td3_buf.add_batch(obs, acts, nobs, reward, zeros_done)
        td3.train_many_device(td3_buf, SAC_BATCH, B)

    busy, wall, share, ops, calls = vec_profile(td3_iteration)
    log(f"  one TD3 train_td3_vec iteration, B={B} (select_action_batch and its noise, a "
        f"batched env step, the buffer write, {B} updates of batch {SAC_BATCH}): device busy "
        f"{busy:.3f} ms of {wall:.3f} ms wall, busy share {share:.4f}; device operations "
        f"{ops}, runtime calls " + ", ".join(f"{k} {v}" for k, v in calls.items()))
    from plasticinelab_tpu_torch.algorithms.ppo import PPO

    ppo = PPO(1214, 6, seed=SEED, device=DEVICE)
    n = RL_PROFILE_T * B
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    rollouts = {k: torch.randn(shape, generator=gen, device=DEVICE) for k, shape in (
        ("obs", (n, 1214)), ("actions", (n, 6)), ("logp", (n,)), ("returns", (n,)),
        ("values", (n,)))}
    ppo_rng = np.random.default_rng(SEED)
    busy, wall, share, ops, calls = vec_profile(lambda: ppo.update(rollouts, ppo_rng))
    log(f"  one PPO update, B={B} x rollout_len {RL_PROFILE_T} = {n} samples (10 epochs of 32 "
        f"minibatches of {n // 32}): device busy {busy:.3f} ms of {wall:.3f} ms wall, busy "
        f"share {share:.4f}; device operations {ops}, runtime calls "
        + ", ".join(f"{k} {v}" for k, v in calls.items()))
    log(f"  the TD3 and PPO profiles: {time.perf_counter() - t_rl:.1f} s (with phase rl's, "
        "the new phases' time)")
    per_substep = {}
    for B in (VEC_BATCHES[0], VEC_BATCHES[-1]):
        ve = vec["envs"][B]
        zeros = np.zeros((ve.batch, ve.action_dim))
        busy, wall, share, ops, calls = vec_profile(
            lambda: [ve.step(zeros) for _ in range(VEC_PROFILE_STEPS)])
        n_sub = VEC_PROFILE_STEPS * ve.scene.simulator.substeps
        per_substep[B] = ops / n_sub
        log(f"  {VEC_PROFILE_STEPS} batched env steps, B={B}: device busy {busy:.3f} ms of "
            f"{wall:.3f} ms wall, busy share {share:.4f}; per substep: device operations "
            f"{ops / n_sub:.2f}, runtime calls "
            + ", ".join(f"{k} {v / n_sub:.2f}" for k, v in calls.items())
            + f"; env steps/s {vec['sps'][B]:.3f} (unprofiled run)")
    ratio = per_substep[VEC_BATCHES[-1]] / per_substep[VEC_BATCHES[0]]
    log(f"  device operations per substep, B={VEC_BATCHES[-1]} over B={VEC_BATCHES[0]}: "
        f"{ratio:.3f} (bound {VEC_LAUNCH_RATIO})")
    if not (per_substep[VEC_BATCHES[0]] > 0 and ratio <= VEC_LAUNCH_RATIO):
        raise AssertionError("the batched step's launches grow with B")
    from plasticinelab_tpu_torch.parallel import batch_states

    te, n_sub = vgrad["te"], VEC_GRAD_PROFILE_STEPS * vgrad["te"].scene.simulator.substeps
    for B in (VEC_BATCHES[0], VEC_BATCHES[-1]):
        states = batch_states(te.state, B, jitter=VEC_GRAD_JITTER, seed=SEED)
        actions = bench_actions(te.scene, B)[:, :VEC_GRAD_PROFILE_STEPS]
        busy, wall, share, ops, calls = vec_profile(
            lambda: vgrad["step"](states, actions, te.softness))
        per_substep[B] = ops / n_sub
        log(f"  {VEC_GRAD_PROFILE_STEPS}-step batched gradient, B={B} (remat "
            f"{vgrad['step'].last_remat}): device busy {busy:.3f} ms of {wall:.3f} ms wall, "
            f"busy share {share:.4f}; per substep fwd+bwd: device operations {ops / n_sub:.2f}, "
            "runtime calls " + ", ".join(f"{k} {v / n_sub:.2f}" for k, v in calls.items())
            + f"; {HORIZON}-step gradient {vgrad['seconds'][B]:.4f} s (unprofiled run)")
    ratio = per_substep[VEC_BATCHES[-1]] / per_substep[VEC_BATCHES[0]]
    log(f"  device operations per gradient substep, B={VEC_BATCHES[-1]} over "
        f"B={VEC_BATCHES[0]}: {ratio:.3f} (bound {VEC_LAUNCH_RATIO})")
    if not (per_substep[VEC_BATCHES[0]] > 0 and ratio <= VEC_LAUNCH_RATIO):
        raise AssertionError("the batched gradient's launches grow with B")

    log(f"[{time.perf_counter() - t0:.1f} s since the build began] done")
    kernels = [dict(name=k, route="cuda", source=SOURCES[k], replaces=REPLACES[k],
                    launches=launches[k], **results[k]) for k in REPLACES]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
