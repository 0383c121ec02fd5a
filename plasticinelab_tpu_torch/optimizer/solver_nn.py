"""Neural-policy trajectory optimisation: the MLP acts inside the
differentiable rollout.

Counterpart of `plasticinelab_tpu/optimizer/solver_nn.py`; behavioral
reference plb/optimizer/solver_nn.py: the action solver's skeleton, but the
gradient flows loss -> actions -> MLP weights, the learning rate is scaled
by 0.001 and the bounds are removed (solver_nn.py:6-7). The policy
(`engine/nn.py`) acts on the carried state inside each env step, so one
backward pass per iteration returns d loss / d params; the cotangent also
enters each step through the policy's observation (particles and poses).
- `SolverNN.solve` steps the float64 host optimizers of `optim.py`;
- `SolverNN.solve_device` keeps the flat parameters, the moments and the
  best iterate on the env's device and fetches the losses once per chunk.
  Like the reference it has no recovery from a non-finite rollout;
- `solve_nn` is the command-line entry: solve, then replay the best
  parameters and write one rendered image per step.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from ..engine import losses as losses_mod
from ..engine import mpm
from ..engine.nn import MLPPolicy
from ..engine.sim import PhysicsEnv, _scan
from ..engine.state import SimState, state_fields
from .optim import OPTIMS
from .solver import Solver, SolverConfig


def nn_rollout_losses(scene, mats, loss_state, policy: MLPPolicy, params, state0: SimState,
                      horizon: int, softness: float, remat: str = "none",
                      ops: mpm.Ops = mpm.KERNEL_OPS):
    """Roll `state0` for `horizon` env steps, each acting with
    `policy.act(params, state)` on the state it starts from -> (each step's
    loss (horizon,), final state), differentiable in `params` and the
    state (`plasticinelab_tpu/optimizer/solver_nn.py:44-55`). Built on
    `sim._scan`, so remat "env_step" recomputes each env step in the
    backward; the non-reentrant checkpoint routes the gradient to the
    parameters the step closes over."""
    def step(*args):
        state = SimState(*args[:7])  # args[7]: the (0,) placeholder row
        action = policy.act(params, state)
        st, gm = mpm.env_step_with_grid_m(scene, mats, state, action, softness, ops)
        loss = losses_mod.loss_and_components(scene, loss_state, st, gm)["loss"]
        return (*state_fields(st), loss)

    return _scan(step, state0, state0.x.new_zeros((horizon, 0)), remat)


def nn_value_and_grad(env: PhysicsEnv, policy: MLPPolicy, flat: torch.Tensor, state0: SimState,
                      horizon: int, softness: float, remat: str = "none",
                      ops: mpm.Ops = mpm.KERNEL_OPS):
    """(loss summed over `horizon` steps, d loss / d flat) of the policy
    with flat parameters `flat` from `state0`, both detached. The initial
    particle state is differentiated too, and its gradient dropped, so
    that the first substep runs the same backward as every other (as in
    the reference's scan): one launch of each substep backward kernel per
    substep."""
    flat = flat.detach().requires_grad_(True)
    particles = [t.detach().requires_grad_(True) for t in (state0.x, state0.v, state0.C, state0.F)]
    state = dataclasses.replace(state0, **dict(zip("xvCF", particles)))
    with torch.enable_grad():
        per_step, _ = nn_rollout_losses(env.scene, env.mats, env.loss_state, policy,
                                        policy.unflatten(flat), state, horizon, softness,
                                        remat, ops)
        loss = per_step.sum()
        grad = torch.autograd.grad(loss, [flat, *particles])[0]
    return loss.detach(), grad


class SolverNN:
    def __init__(self, env: PhysicsEnv, logger=None, cfg: Optional[SolverConfig] = None,
                 **kwargs):
        helper = Solver(env, None, cfg, **kwargs)  # the action solver's config plumbing
        self.cfg = helper.cfg
        self.cfg.optim.lr *= 0.001
        self.cfg.optim.bounds = (-np.inf, np.inf)
        self.optim_cfg = self.cfg.optim
        self.horizon = self.cfg.horizon
        self.env = env
        self.logger = logger

    def _start(self, policy: MLPPolicy):
        """The flat float64 start: `env.nn_params` where set, else
        `init_params()` (seed 0)."""
        env = self.env
        tree = getattr(env, "nn_params", None) or policy.init_params(dtype=env.dtype,
                                                                     device=env.device)
        return policy.get_params(tree)

    def solve(self, callbacks=()):
        """Optimise the flat parameters with the host optimizer, one fetch
        of loss and gradient per iteration (`solver_nn.py:59-102`). Leaves
        the best parameters in `env.nn_params` (in the env's dtype) and
        returns them flat (float64)."""
        env = self.env
        policy: MLPPolicy = env.nn
        assert policy is not None, "nn must be an element of env .."
        params = self._start(policy)
        optim = OPTIMS[self.optim_cfg.type](params, self.optim_cfg)
        env_state = env.get_state()
        self.total_steps = 0
        self.last_remat = mpm.resolve_remat(env.scene, self.horizon, env.device)

        def forward(sim_state, flat_params):
            policy.set_params(flat_params, env.dtype, device=env.device)  # velocity_weight
            flat = torch.as_tensor(flat_params[:policy.n_params], dtype=env.dtype,
                                   device=env.device)
            env.set_state(sim_state, self.cfg.softness, False)
            if self.logger is not None:
                self.logger.reset()
            loss, grad = nn_value_and_grad(env, policy, flat, env.state, self.horizon,
                                           self.cfg.softness, self.last_remat)
            self.total_steps += self.horizon
            if self.logger is not None:
                info = env.compute_loss()
                self.logger.step(None, None, info["reward"], None, True, info)
            return float(loss), grad.cpu().numpy().astype(np.float64)

        best_params, best_loss = None, 1e10
        for _ in range(self.cfg.n_iters):
            self.params = params
            loss, grad = forward(env_state["state"], params)
            if loss < best_loss:
                best_loss, best_params = loss, params.copy()
            params = optim.step(grad)
            for callback in callbacks:
                callback(self, optim, loss, grad)

        env.set_state(**env_state)
        env.nn_params = policy.set_params(best_params if best_params is not None else params,
                                          env.dtype, device=env.device)
        self.best_loss = best_loss
        return best_params

    def solve_device(self, chunk: int = 10):
        """Device-resident `solve` (`solver_nn.py:104-206`): Adam or
        Momentum over the flat parameter tensor on the env's device, in its
        dtype, with best-so-far tracking and no bounds; the host reads the
        losses once per `chunk` iterations (`iter_losses`,
        `chunk_seconds`). No recovery from a non-finite loss or gradient,
        as in the reference (ROADMAP queue C, known defects). Returns the
        best parameters flat (float64)."""
        env = self.env
        policy: MLPPolicy = env.nn
        assert policy is not None, "nn must be an element of env .."
        cfg, ocfg = self.cfg, self.optim_cfg
        if ocfg.type not in ("Adam", "Momentum"):
            raise ValueError(f"solve_device runs Adam or Momentum, not {ocfg.type!r}")
        dtype, device = env.dtype, env.device
        env_state = env.get_state()
        state0 = env.state
        self.last_remat = mpm.resolve_remat(env.scene, self.horizon, device)

        lr, mom = ocfg.lr, ocfg.momentum
        b1, b2, eps = ocfg.beta_1, ocfg.beta_2, ocfg.epsilon
        params = torch.as_tensor(self._start(policy), dtype=dtype, device=device)
        m, v = torch.zeros_like(params), torch.zeros_like(params)
        best_loss = torch.tensor(1e10, dtype=dtype, device=device)
        best_params = params.clone()
        self.iter_losses, self.chunk_seconds = [], []
        it = 0
        while it < cfg.n_iters:
            n = min(chunk, cfg.n_iters - it)
            t0 = time.perf_counter()
            losses = []
            for _ in range(n):
                loss, grad = nn_value_and_grad(env, policy, params, state0, self.horizon,
                                               cfg.softness, self.last_remat)
                better = loss < best_loss
                best_loss = torch.where(better, loss, best_loss)
                best_params = torch.where(better, params, best_params)
                if ocfg.type == "Adam":
                    m = b1 * m + (1 - b1) * grad
                    v = b2 * v + (1 - b2) * grad * grad
                    m_cap = m / (1 - b1 ** (it + 1))
                    v_cap = v / (1 - b2 ** (it + 1))
                    upd = lr * m_cap / (torch.sqrt(v_cap) + eps)
                else:  # Momentum (optim.py)
                    m = m * mom + grad * (1 - mom)
                    upd = lr * m
                params = params - upd
                losses.append(loss)
                it += 1
            losses = torch.stack(losses).cpu().numpy().astype(np.float64)
            self.chunk_seconds.append(time.perf_counter() - t0)
            self.iter_losses.extend(losses.tolist())
            if self.logger is not None:
                for L in losses:
                    self.logger.reset()
                    self.logger.step(None, None, -L, None, True, {
                        "loss": L, "sdf_loss": 0.0, "density_loss": 0.0,
                        "contact_loss": 0.0, "incremental_iou": 0.0})

        env.set_state(**env_state)
        self.total_steps = cfg.n_iters * self.horizon
        self.best_loss = float(best_loss)
        best = best_params.cpu().numpy().astype(np.float64)
        env.nn_params = policy.set_params(best, dtype, device=device)
        return best


def solve_nn(env, path, logger, args):
    """Command-line entry (`solver_nn.py:209-244`; reference
    solver_nn.py:73-123): attach an `MLPPolicy` to the env where it has
    none, optimise its parameters over one episode (`solve_device`, or
    `solve` with `args.host_loop`), then replay the best parameters and
    write one image per step into `path`: a PNG through cv2 where it is
    importable, else a `.npy` of the (H, W, 3) uint8 frame; prints the
    solve's seconds and best loss and the replay's final incremental IoU.
    args:
    num_steps (rollout steps in all, so n_iters = ceil(num_steps / episode
    length)), softness, lr (scaled by 0.001 inside), optim."""
    os.makedirs(path, exist_ok=True)
    T = env._max_episode_steps
    taichi_env: PhysicsEnv = env.unwrapped.taichi_env
    if taichi_env.nn is None:
        taichi_env.nn = MLPPolicy(taichi_env.scene)
    env.reset()

    solver = SolverNN(
        taichi_env, logger, None,
        n_iters=(args.num_steps + T - 1) // T, softness=args.softness, horizon=T,
        **{"optim.lr": args.lr, "optim.type": args.optim, "init_range": 0.0001},
    )
    t0 = time.perf_counter()
    if getattr(args, "host_loop", False):
        params = solver.solve()
    else:
        params = solver.solve_device()
    secs = time.perf_counter() - t0
    print(f"[solve_nn] {solver.cfg.n_iters} iterations in {secs:.3f} s "
          f"({secs / solver.cfg.n_iters:.4f} s/iteration), best loss {solver.best_loss}")

    # replay the best parameters, one frame per step
    taichi_env.set_copy(True)
    policy = taichi_env.nn
    ptree = policy.set_params(params, taichi_env.dtype, device=taichi_env.device)
    try:
        import cv2
    except ImportError:
        cv2 = None
    for idx in range(T):
        with torch.no_grad():
            action = policy.act(ptree, taichi_env.state).cpu().numpy()
        taichi_env.step(action)
        img = taichi_env.render(mode="rgb_array")
        if cv2 is not None:
            cv2.imwrite(f"{path}/{idx:04d}.png", img[..., ::-1])
        else:
            np.save(f"{path}/{idx:04d}.npy", img)
    info = taichi_env.compute_loss()
    print(f"[solve_nn] replay of the best parameters, {T} steps: incremental IoU "
          f"{info['incremental_iou']}, iou {info['iou']}")
    return params
