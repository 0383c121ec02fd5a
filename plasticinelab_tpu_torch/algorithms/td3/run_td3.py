"""TD3 / DDPG training loops (counterpart of
`plasticinelab_tpu/algorithms/td3/run_td3.py`; behavioral reference
plb/algorithms/TD3/run_td3.py: 2500 random warm-up steps, one update per
env step after them, an evaluation every 200 episodes over 5 episodes, the
final model saved).

`train_td3` runs the reference's one-env host loop for `--policy` TD3,
OurDDPG or DDPG, or with `vec_envs` > 1 `train_td3_vec`: B envs of
`VecPlasticineEnv` step together on the card, observations, actions and
rewards stay device tensors into a `DeviceReplayBuffer`, and each batched
step is followed by B updates (`TD3.train_many_device`). The learners run
on the env's device.

The reference's DDPG and OriginalDDPG have no `select_action_batch` and no
`train_many_device`: there `--policy OurDDPG|DDPG --vec_envs B` dies with an
AttributeError after the warm-up (`run_td3.py:174`, `:185`). The port
refuses that case at entry.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..common import (DeviceImageReplayBuffer, DeviceReplayBuffer, ImageReplayBuffer, ReplayBuffer,
                      env_reset, env_step)
from .ddpg import DDPG, OriginalDDPG
from .td3 import TD3


def eval_policy(policy, env, seed, eval_episodes=5):
    avg_reward = 0.0
    ep_iou, ep_last_iou = 0.0, 0.0
    for _ in range(eval_episodes):
        state, done = env_reset(env), False
        t = 0
        while not done and t < env._max_episode_steps:
            action = policy.select_action(np.array(state))
            state, reward, done, info = env_step(env, action)
            avg_reward += reward
            ep_iou += info["incremental_iou"]
            t += 1
        ep_last_iou += info["incremental_iou"]
    avg_reward /= eval_episodes
    print("---------------------------------------")
    print(f"Evaluation over {eval_episodes} episodes: {avg_reward:.3f}")
    print("---------------------------------------")
    return avg_reward, ep_iou / eval_episodes, ep_last_iou / eval_episodes


def _refuse_batched(which: str) -> None:
    raise NotImplementedError(
        f"--policy {which} with --vec_envs > 1: the reference's DDPG and OriginalDDPG have no "
        "select_action_batch or train_many_device (plasticinelab_tpu/algorithms/td3/"
        "run_td3.py:174, :185), so the reference fails there after its warm-up; use "
        "--policy TD3 or --vec_envs 0")


def train_td3(env, path, logger, old_args):
    """TD3, OurDDPG or DDPG (`old_args.policy`) on `env`, on its device."""
    which = getattr(old_args, "policy", "TD3")
    vec = int(getattr(old_args, "vec_envs", 0) or 0)
    if vec > 1 and which != "TD3":
        _refuse_batched(which)
    start_timesteps = int(getattr(old_args, "start_timesteps", 2500))
    eval_freq = 200  # episodes
    max_timesteps = old_args.num_steps
    expl_noise = 0.1
    batch_size = 256

    os.makedirs(path, exist_ok=True)
    obs_shape = env.observation_space.shape
    visual = len(obs_shape) == 3
    state_dim = obs_shape if visual else obs_shape[0]
    action_dim = env.action_space.shape[0]
    max_action = float(env.action_space.high[0])
    device = env.unwrapped.taichi_env.device

    # policy dispatch (reference TD3/main.py:99-107: TD3 | OurDDPG | DDPG)
    if which == "TD3":
        policy = TD3(state_dim, action_dim, max_action=max_action, discount=0.99, tau=0.005,
                     policy_noise=0.2 * max_action, noise_clip=0.5 * max_action,
                     policy_freq=2, seed=old_args.seed, device=device)
    elif which in ("OurDDPG", "DDPG"):
        if visual:
            raise ValueError("rgb obs_mode is wired for --policy TD3")
        cls, kw = (DDPG, dict(tau=0.005)) if which == "OurDDPG" else (OriginalDDPG, {})
        policy = cls(state_dim, action_dim, max_action=max_action, discount=0.99,
                     seed=old_args.seed, device=device, **kw)
    else:
        raise ValueError(f"unknown policy {which!r}")
    if vec > 1:
        return train_td3_vec(policy, old_args, path, batch=vec)

    if visual:
        replay_buffer = ImageReplayBuffer(obs_shape, action_dim, 100_000)
    else:
        replay_buffer = ReplayBuffer(state_dim, action_dim)
    rng = np.random.default_rng(old_args.seed)

    state, done = env_reset(env), False
    episode_timesteps = 0
    episode_num = 0
    if logger is not None:
        logger.reset()

    for t in range(int(max_timesteps)):
        episode_timesteps += 1
        if t < start_timesteps:
            action = env.action_space.sample()
        else:
            action = (policy.select_action(np.array(state))
                      + rng.normal(0, max_action * expl_noise, size=action_dim)
                      ).clip(-max_action, max_action)

        next_state, reward, done, info = env_step(env, action)
        done_bool = float(done) if episode_timesteps < env._max_episode_steps else 0.0
        replay_buffer.add(state, action, next_state, reward, done_bool)
        state = next_state
        if logger is not None:
            logger.step(None, None, reward, None,
                        episode_timesteps >= env._max_episode_steps, info)

        if t >= start_timesteps:
            policy.train(replay_buffer, batch_size, rng)

        if done or episode_timesteps >= env._max_episode_steps:
            state, done = env_reset(env), False
            episode_timesteps = 0
            episode_num += 1
            if logger is not None:
                logger.reset()
            if episode_num % eval_freq == 0:
                eval_policy(policy, env, old_args.seed)

    policy.save(os.path.join(path, "model"))
    return policy


def train_td3_vec(policy, old_args, path, batch=8, horizon=50, venv=None,
                  start_timesteps=2500):
    """Collect with B batched envs on the card (`VecPlasticineEnv` on the
    policy's device) and update once per collected transition: B
    `train_many_device` steps per batched env step. Observations, actions
    and rewards stay on the device: the exploration noise (0.1) is drawn
    there through `policy.normal`; warm-up actions are numpy draws seeded
    `old_args.seed`. Host seconds spent collecting and updating, and their
    counts, are kept in `policy.vec_stats` and printed."""
    from ...parallel.rollout import VecPlasticineEnv

    if not hasattr(policy, "train_many_device"):
        _refuse_batched(type(policy).__name__)
    if venv is None:
        venv = VecPlasticineEnv(
            old_args.env_name, batch=batch, seed=old_args.seed, horizon=horizon,
            obs_mode=getattr(old_args, "obs_mode", "state"),
            image_obs_res=getattr(old_args, "image_obs_res", 64),
            image_obs_spp=getattr(old_args, "image_obs_spp", 2), device=policy.device)
    batch, horizon = venv.batch, venv.horizon
    if venv.obs_mode == "rgb":
        replay = DeviceImageReplayBuffer(venv.obs_shape, venv.action_dim, device=venv.device)
    else:
        replay = DeviceReplayBuffer(venv.obs_dim, venv.action_dim, device=venv.device)
    rng = np.random.default_rng(old_args.seed)
    os.makedirs(path, exist_ok=True)

    zeros_done = torch.zeros((batch,), device=venv.device)
    expl_noise = 0.1
    stats = {"collect_s": 0.0, "update_s": 0.0, "env_steps": 0, "updates": 0}
    steps = 0
    t0 = time.perf_counter()
    obs = venv.reset()
    ep_t = 0
    while steps < old_args.num_steps:
        tc = time.perf_counter()
        if steps < start_timesteps:
            actions = rng.uniform(-1, 1, (batch, venv.action_dim)).astype(np.float32)
        else:
            acts = policy.select_action_batch(obs)
            actions = torch.clamp(acts + expl_noise * policy.normal(acts.shape).to(acts), -1, 1)
        nobs, reward, done, _ = venv.step(actions)
        ep_t += 1
        replay.add_batch(obs, actions, nobs, reward, zeros_done)
        obs = nobs
        steps += batch
        tu = time.perf_counter()
        stats["collect_s"] += tu - tc
        if steps >= start_timesteps:
            # reference cadence: one gradient update per env step collected
            policy.train_many_device(replay, 256, n=batch)
            stats["updates"] += batch
            stats["update_s"] += time.perf_counter() - tu
        if ep_t >= horizon:
            obs = venv.reset()
            ep_t = 0
    if venv.device.type == "cuda":
        torch.cuda.synchronize(venv.device)
    dt = time.perf_counter() - t0
    stats.update(env_steps=steps, seconds=dt)
    policy.vec_stats = stats
    print(f"[TD3 vec] {steps} env steps in {dt:.1f}s ({steps / dt:.1f} steps/s, "
          f"batch={batch}); host seconds collecting {stats['collect_s']:.2f}, "
          f"updating {stats['update_s']:.2f} ({stats['updates']} updates)")
    policy.save(os.path.join(path, "model"))
    return policy
