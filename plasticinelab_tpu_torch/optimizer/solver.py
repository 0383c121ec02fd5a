"""Trajectory optimisation over action sequences through the differentiable
physics.

Counterpart of `plasticinelab_tpu/optimizer/solver.py` (`Solver.solve`
:53-123, `solve_device` :130-294, `init_actions`); behavioral reference
plb/optimizer/solver.py. Each iteration evaluates the whole rollout loss and
its gradient with respect to the (horizon, action_dim) action matrix
(`sim.rollout_losses`, through the backward kernels on CUDA).
- `solve` steps the float64 host optimizers of `optim.py`, fetching the
  loss and gradient every iteration;
- `solve_device` keeps actions, moments and the best iterate on the device
  and fetches the per-iteration losses once per chunk. Like the reference
  package it recovers from a non-finite rollout: back to the best actions
  seen, fresh moments, half the step.
- `solve_action` is the command-line entry: solve, then replay the best
  actions and write one rendered image per step.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..engine import mpm
from ..engine.sim import PhysicsEnv, rollout_losses
from ..utils import checkpoint as ckpt
from .optim import OPTIMS, OptimizerConfig


@dataclass
class SolverConfig:
    optim: OptimizerConfig = field(default_factory=OptimizerConfig)
    n_iters: int = 100
    softness: float = 666.0
    horizon: int = 50
    init_range: float = 0.0
    init_sampler: str = "uniform"


class Solver:
    def __init__(self, env: PhysicsEnv, logger=None, cfg: Optional[SolverConfig] = None,
                 **kwargs):
        base = cfg or SolverConfig()
        optim_overrides = {
            k[len("optim."):]: v for k, v in kwargs.items() if k.startswith("optim.")
        }
        plain = {k: v for k, v in kwargs.items() if "." not in k}
        if optim_overrides:
            base = SolverConfig(**{**base.__dict__, "optim": OptimizerConfig(
                **{**base.optim.__dict__, **optim_overrides})})
        if plain:
            base = SolverConfig(**{**base.__dict__, **plain})
        self.cfg = base
        self.optim_cfg = self.cfg.optim
        self.env = env
        self.logger = logger

    def solve(self, init_actions=None, callbacks: Sequence[Callable] = (),
              checkpoint_dir: Optional[str] = None, checkpoint_every: int = 10):
        """Optimise the action sequence with the host optimizer, one fetch
        of loss and gradient per iteration. With checkpoint_dir set, the
        solver state (iteration, actions, moments, best so far) is saved
        every checkpoint_every iterations and a later call resumes from the
        latest checkpoint. Returns the best actions (float64)."""
        env = self.env
        if init_actions is None:
            init_actions = self.init_actions(env, self.cfg)
        optim = OPTIMS[self.optim_cfg.type](init_actions, self.optim_cfg)

        start_iter = 0
        best_action, best_loss = None, 1e10
        if checkpoint_dir:
            path = ckpt.latest(checkpoint_dir)
            if path:
                st = ckpt.load(path)
                start_iter = st["iter"]
                optim.parameters[:] = st["parameters"]
                for k, v in st["optim_state"].items():
                    setattr(optim, k, v)
                best_action, best_loss = st["best_action"], st["best_loss"]
                print(f"[solver] resumed from {path} at iter {start_iter}")

        env_state = env.get_state()
        self.total_steps = 0

        def forward(sim_state, actions):
            if self.logger is not None:
                self.logger.reset()
            env.set_state(sim_state, self.cfg.softness, False)
            loss, grad, _ = env.rollout_value_and_grad(env.state, actions, self.cfg.softness)
            self.total_steps += len(actions)
            if self.logger is not None:
                info = env.compute_loss()
                self.logger.step(None, None, info["reward"], None, True, info)
            return float(loss), grad.cpu().numpy().astype(np.float64)

        actions = optim.parameters.copy()
        for it in range(start_iter, self.cfg.n_iters):
            self.params = actions.copy()
            loss, grad = forward(env_state["state"], actions)
            if loss < best_loss:
                best_loss, best_action = loss, actions.copy()
            actions = optim.step(grad)
            for callback in callbacks:
                callback(self, optim, loss, grad)
            if checkpoint_dir and (it + 1) % checkpoint_every == 0:
                ostate = {k: getattr(optim, k)
                          for k in ("momentum_buffer", "v_buffer", "iter", "momentum")
                          if hasattr(optim, k)}
                ckpt.save(os.path.join(checkpoint_dir, f"ckpt_{it + 1}.pkl"),
                          {"iter": it + 1, "parameters": optim.parameters.copy(),
                           "optim_state": ostate, "best_action": best_action,
                           "best_loss": best_loss})

        env.set_state(**env_state)
        self.best_loss = best_loss
        return best_action

    def solve_device(self, init_actions=None, chunk: int = 10,
                     checkpoint_dir: Optional[str] = None):
        """Optimise on the device: rollout gradient, Adam (or Momentum),
        bounds clip and best-so-far tracking stay on the env's device; the
        host reads the per-iteration loss components once per `chunk`
        iterations (`iter_losses`, `iter_ious`, `chunk_seconds`). The update
        is optim.py's in the env's dtype. A non-finite loss or gradient
        restarts from the best actions with fresh moments and half the
        step. Returns the best actions (float64)."""
        env = self.env
        cfg, ocfg = self.cfg, self.optim_cfg
        if ocfg.type not in ("Adam", "Momentum"):
            raise ValueError(f"solve_device runs Adam or Momentum, not {ocfg.type!r}")
        if init_actions is None:
            init_actions = self.init_actions(env, cfg)
        dtype, device = env.dtype, env.device
        env_state = env.get_state()
        state0 = env.state
        remat = mpm.resolve_remat(env.scene, cfg.horizon, device)

        def value_and_grad(actions):
            a = actions.detach().requires_grad_(True)
            with torch.enable_grad():
                comps, _ = rollout_losses(env.scene, env.mats, env.loss_state, state0, a,
                                          cfg.softness, remat)
                # components summed over the horizon; the IoU is the last step's
                out = torch.cat([comps[:, :4].sum(dim=0), comps[-1:, 4]])
                (grad,) = torch.autograd.grad(out[0], a)
            return out.detach(), grad

        def tensor(v):
            return torch.as_tensor(np.asarray(v, np.float64), dtype=dtype, device=device)

        lr, mom = ocfg.lr, ocfg.momentum
        b1, b2, eps = ocfg.beta_1, ocfg.beta_2, ocfg.epsilon
        lo, hi = ocfg.bounds
        actions = tensor(init_actions).clone()
        m, v = torch.zeros_like(actions), torch.zeros_like(actions)
        it = 0
        best_loss, best_actions = tensor(1e10), actions.clone()
        lr_scale = tensor(1.0)
        if checkpoint_dir:
            path = ckpt.latest(checkpoint_dir)
            if path:
                st = ckpt.load(path)
                it = st["iter"]
                actions = tensor(st["parameters"])
                m = tensor(st["optim_state"]["momentum_buffer"])
                v = tensor(st["optim_state"]["v_buffer"])
                best_loss = tensor(st["best_loss"])
                best_actions = tensor(st["best_action"])
                print(f"[solver] resumed from {path} at iter {it}")
        start_iter = it

        self.iter_losses, self.iter_ious, self.chunk_seconds = [], [], []
        while it < cfg.n_iters:
            n = min(chunk, cfg.n_iters - it)
            t0 = time.perf_counter()
            rows = []
            for _ in range(n):
                out, grad = value_and_grad(actions)
                loss = out[0]
                better = loss < best_loss  # False for a NaN loss: best is protected
                best_loss = torch.where(better, loss, best_loss)
                best_actions = torch.where(better, actions, best_actions)
                finite = torch.isfinite(loss) & torch.isfinite(grad).all()
                grad = torch.where(finite, grad, torch.zeros_like(grad))
                if ocfg.type == "Adam":
                    m = b1 * m + (1 - b1) * grad
                    v = b2 * v + (1 - b2) * grad * grad
                    m_cap = m / (1 - b1 ** (it + 1))
                    v_cap = v / (1 - b2 ** (it + 1))
                    upd = lr * lr_scale * m_cap / (torch.sqrt(v_cap) + eps)
                else:  # Momentum (optim.py)
                    m = m * mom + grad * (1 - mom)
                    upd = lr * lr_scale * m
                actions = torch.where(finite, torch.clamp(actions - upd, lo, hi), best_actions)
                m = torch.where(finite, m, torch.zeros_like(m))
                v = torch.where(finite, v, torch.zeros_like(v))
                lr_scale = torch.where(finite, lr_scale, lr_scale * 0.5)
                rows.append(out)
                it += 1
            comps = torch.stack(rows).cpu().numpy().astype(np.float64)  # (n, 5)
            self.chunk_seconds.append(time.perf_counter() - t0)
            self.iter_losses.extend(comps[:, 0].tolist())
            self.iter_ious.extend(comps[:, 4].tolist())
            if self.logger is not None:
                # one logger episode per iteration, like the host loop
                init_iou, target_iou = env._init_iou, env._target_iou
                for L, S, D, C, I in comps:
                    inc = max(min((I - init_iou) / (target_iou - init_iou), 1.0), 0.0)
                    self.logger.reset()
                    self.logger.step(None, None, -L, None, True, {
                        "loss": L, "sdf_loss": S, "density_loss": D,
                        "contact_loss": C, "incremental_iou": inc})
            if checkpoint_dir:
                ckpt.save(os.path.join(checkpoint_dir, f"ckpt_{it}.pkl"),
                          {"iter": it, "parameters": actions.double(),
                           "optim_state": {"momentum_buffer": m.double(),
                                           "v_buffer": v.double(), "iter": it,
                                           "momentum": float(mom)},
                           "best_action": best_actions.double(),
                           "best_loss": float(best_loss)})

        env.set_state(**env_state)
        self.best_loss = float(best_loss)
        self.total_steps = (cfg.n_iters - start_iter) * cfg.horizon
        return best_actions.cpu().numpy().astype(np.float64)

    @staticmethod
    def init_actions(env: PhysicsEnv, cfg: SolverConfig):
        action_dim = env.scene.action_dim
        if cfg.init_sampler == "uniform":
            return np.random.uniform(-cfg.init_range, cfg.init_range,
                                     size=(cfg.horizon, action_dim))
        raise NotImplementedError(cfg.init_sampler)


def solve_action(env, path, logger, args):
    """Command-line entry (reference solver.py:86-101): optimise the actions
    over one episode, then replay the best actions and write one image per
    step into `path`: a PNG through cv2 where it is importable, else a
    `.npy` of the (H, W, 3) uint8 frame. args: num_steps (rollout steps in
    all, so n_iters = ceil(num_steps / episode length)), softness, lr,
    optim, and optionally host_loop: true takes `Solver.solve` (the host
    optimizers), else `Solver.solve_device`."""
    os.makedirs(path, exist_ok=True)
    env.reset()
    taichi_env: PhysicsEnv = env.unwrapped.taichi_env
    T = env._max_episode_steps
    solver = Solver(
        taichi_env, logger, None,
        n_iters=(args.num_steps + T - 1) // T, softness=args.softness, horizon=T,
        **{"optim.lr": args.lr, "optim.type": args.optim, "init_range": 0.0001},
    )
    if getattr(args, "host_loop", False):
        action = solver.solve()
    else:
        action = solver.solve_device()

    try:
        import cv2
    except ImportError:
        cv2 = None
    for idx, act in enumerate(action):
        env.step(act)
        img = env.render(mode="rgb_array")
        if cv2 is not None:
            cv2.imwrite(f"{path}/{idx:04d}.png", img[..., ::-1])
        else:
            np.save(f"{path}/{idx:04d}.npy", img)
    return action

