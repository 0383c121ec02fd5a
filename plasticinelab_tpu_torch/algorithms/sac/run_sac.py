"""SAC training loops (counterpart of
`plasticinelab_tpu/algorithms/sac/run_sac.py`; behavioral reference
plb/algorithms/discor/run_sac.py + agent.py: batch 256, 1M buffer, 2500
warm-up steps, one update per env step, an evaluation every 200 episodes
over 5 episodes, best and final models saved).

`train` runs the reference's one-env host loop (`Agent`) for SAC or, with
`args.algo` "discor", DisCor (`discor.py`); or with
`args.vec_envs` > 1 `train_vec`: B envs of `VecPlasticineEnv` step together
on the card, their observations and rewards stay device tensors into a
`DeviceReplayBuffer`, and each batched step is followed by B updates
(`SAC.update_many_device`). The SAC runs on the env's device.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..common import (DeviceImageReplayBuffer, DeviceReplayBuffer, ImageReplayBuffer, ReplayBuffer,
                      env_reset, env_step)
from .sac import SAC


class Agent:
    def __init__(self, env, test_env, algo: SAC, log_dir, num_steps=500000,
                 batch_size=256, memory_size=1000000, update_interval=1,
                 start_steps=2500, eval_interval=200, num_eval_episodes=5,
                 seed=0, logger=None):
        self._env = env
        self._test_env = test_env
        self._algo = algo
        self.logger = logger
        self._num_steps = num_steps
        self._batch_size = batch_size
        self._update_interval = update_interval
        self._start_steps = start_steps
        self._eval_interval = eval_interval
        self._num_eval_episodes = num_eval_episodes
        self._rng = np.random.default_rng(seed)
        obs_shape = env.observation_space.shape
        if len(obs_shape) == 3:  # visual obs: compact uint8 storage
            self._replay = ImageReplayBuffer(
                obs_shape, env.action_space.shape[0], min(memory_size, 100_000))
        else:
            self._replay = ReplayBuffer(obs_shape[0], env.action_space.shape[0], memory_size)
        self._model_dir = os.path.join(log_dir, "model")
        os.makedirs(self._model_dir, exist_ok=True)
        self._best_eval = -np.inf
        self._steps = 0
        self._episodes = 0

    def run(self):
        while self._steps < self._num_steps:
            self._train_episode()
            if self._episodes % self._eval_interval == 0:
                self._evaluate()
        self._algo.save_models(os.path.join(self._model_dir, "final"))

    def _train_episode(self):
        self._episodes += 1
        state = env_reset(self._env)
        done = False
        t = 0
        if self.logger is not None:
            self.logger.reset()
        while not done and t < self._env._max_episode_steps:
            if self._steps < self._start_steps:
                action = self._env.action_space.sample()
            else:
                action = self._algo.explore(np.asarray(state, np.float32))
            next_state, reward, done, info = env_step(self._env, action)
            t += 1
            self._steps += 1
            done_bool = float(done) if t < self._env._max_episode_steps else 0.0
            self._replay.add(state, action, next_state, reward, done_bool)
            state = next_state
            if self.logger is not None:
                self.logger.step(None, None, reward, None,
                                 t >= self._env._max_episode_steps or done, info)
            if (self._steps >= self._start_steps
                    and self._steps % self._update_interval == 0):
                self._algo.update(self._replay, self._batch_size, self._rng)

    def _evaluate(self):
        total = 0.0
        for _ in range(self._num_eval_episodes):
            state = env_reset(self._test_env)
            done = False
            t = 0
            while not done and t < self._test_env._max_episode_steps:
                action = self._algo.exploit(np.asarray(state, np.float32))
                state, reward, done, info = env_step(self._test_env, action)
                total += reward
                t += 1
        mean_return = total / self._num_eval_episodes
        if mean_return > self._best_eval:
            self._best_eval = mean_return
            self._algo.save_models(os.path.join(self._model_dir, "best"))
        print(f"[SAC eval] steps={self._steps} mean_return={mean_return:.3f}")


def train(env, path, logger, args):
    """SAC on `env` (the port's PlasticineEnv), on its device; with
    `args.algo` "discor", DisCor (SAC with the DisCor error model)."""
    obs_shape = env.observation_space.shape
    if getattr(args, "algo", "sac") == "discor":
        from .discor import DisCor as algo_cls
    else:
        algo_cls = SAC
    algo = algo_cls(
        state_dim=(obs_shape if len(obs_shape) == 3 else obs_shape[0]),
        action_dim=env.action_space.shape[0],
        gamma=0.99, policy_lr=3e-4, q_lr=3e-4, entropy_lr=3e-4,
        target_update_coef=0.005, seed=args.seed,
        device=env.unwrapped.taichi_env.device,
    )
    vec = int(getattr(args, "vec_envs", 0) or 0)
    if vec > 1:
        return train_vec(env, algo, path, args, batch=vec)
    # PLB_SAC_START_STEPS: the warm-up override for short drives
    # (reference default 2500, discor/run_sac.py)
    agent = Agent(
        env=env, test_env=env, algo=algo, log_dir=path,
        num_steps=args.num_steps, batch_size=256, memory_size=1000000,
        update_interval=1,
        start_steps=int(os.environ.get("PLB_SAC_START_STEPS", 2500)),
        eval_interval=200, num_eval_episodes=5, seed=args.seed, logger=logger,
    )
    agent.run()
    return algo


def train_vec(env, algo, path, args, batch=8, horizon=50, venv=None, start_steps=2500):
    """Collect with B batched envs on the card (`VecPlasticineEnv` on
    `algo`'s device) and update once per collected transition: B
    `update_many_device` steps per batched env step, as the reference's
    cadence (discor/agent.py update_interval=1). Observations, actions and
    rewards stay on the device; warm-up actions are numpy draws seeded
    `args.seed`. Host seconds spent collecting and updating, and their
    counts, are kept in `algo.vec_stats` and printed."""
    from ...parallel.rollout import VecPlasticineEnv

    if venv is None:
        venv = VecPlasticineEnv(
            args.env_name, batch=batch, seed=args.seed, horizon=horizon,
            obs_mode=getattr(args, "obs_mode", "state"),
            image_obs_res=getattr(args, "image_obs_res", 64),
            image_obs_spp=getattr(args, "image_obs_spp", 2), device=algo.device)
    batch, horizon = venv.batch, venv.horizon
    if venv.obs_mode == "rgb":
        replay = DeviceImageReplayBuffer(venv.obs_shape, venv.action_dim, device=venv.device)
    else:
        replay = DeviceReplayBuffer(venv.obs_dim, venv.action_dim, device=venv.device)
    rng = np.random.default_rng(args.seed)
    model_dir = os.path.join(path, "model")
    os.makedirs(model_dir, exist_ok=True)

    zeros_done = torch.zeros((batch,), device=venv.device)
    stats = {"collect_s": 0.0, "update_s": 0.0, "env_steps": 0, "updates": 0}
    steps = 0
    t0 = time.perf_counter()
    obs = venv.reset()
    ep_t = 0
    while steps < args.num_steps:
        tc = time.perf_counter()
        if steps < start_steps:
            actions = rng.uniform(-1, 1, (batch, venv.action_dim)).astype(np.float32)
        else:
            actions = algo.explore_batch(obs)
        nobs, reward, done, _ = venv.step(actions)
        ep_t += 1
        replay.add_batch(obs, actions, nobs, reward, zeros_done)
        obs = nobs
        steps += batch
        tu = time.perf_counter()
        stats["collect_s"] += tu - tc
        if steps >= start_steps:
            algo.update_many_device(replay, 256, n=batch)
            stats["updates"] += batch
            stats["update_s"] += time.perf_counter() - tu
        if ep_t >= horizon:
            obs = venv.reset()
            ep_t = 0
    if venv.device.type == "cuda":
        torch.cuda.synchronize(venv.device)
    dt = time.perf_counter() - t0
    stats.update(env_steps=steps, seconds=dt)
    algo.vec_stats = stats
    print(f"[SAC vec] {steps} env steps in {dt:.1f}s ({steps / dt:.1f} steps/s, "
          f"batch={batch}); host seconds collecting {stats['collect_s']:.2f}, "
          f"updating {stats['update_s']:.2f} ({stats['updates']} updates)")
    algo.save_models(os.path.join(model_dir, "final"))
    return algo
