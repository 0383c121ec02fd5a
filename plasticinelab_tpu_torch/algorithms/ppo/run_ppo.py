"""PPO / ACKTR training loops (counterpart of
`plasticinelab_tpu/algorithms/ppo/run_ppo.py`; behavioral reference
plb/algorithms/ppo/run_ppo.py: 2500-step rollouts on the single env,
VecNormalize-style observation and return normalisation (clip 10), GAE(0.95)
with proper time limits, a linear learning-rate decay for PPO).

`train_ppo_vec` collects on `VecPlasticineEnv` on the card: the rollout
buffers, the normalisation statistics (float64) and GAE are device tensors,
so a rollout step fetches nothing to the host, and each update syncs once
for its mean loss. `train_ppo` is the reference's one-env loop, PPO or ACKTR
(`algo="acktr"`), on the env's device.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from ..common import env_reset
from .ppo import PPO


class RunningMeanStd:
    """VecNormalize statistics (openai-baselines semantics): the mean and
    variance of everything seen, merged batch by batch in float64 on
    `device`; the count is a host number."""

    def __init__(self, shape, *, device="cuda"):
        self.device = torch.device(device)
        shape = tuple(shape) if isinstance(shape, (tuple, list)) else (shape,)
        self.mean = torch.zeros(shape, dtype=torch.float64, device=self.device)
        self.var = torch.ones(shape, dtype=torch.float64, device=self.device)
        self.count = 1e-4

    def update(self, x):
        x = torch.as_tensor(x, device=self.device).to(torch.float64)
        x = x.reshape(-1, *self.mean.shape)
        bmean, bvar, bcount = x.mean(0), x.var(0, unbiased=False), x.shape[0]
        delta = bmean - self.mean
        tot = self.count + bcount
        self.mean = self.mean + delta * bcount / tot
        m_a = self.var * self.count
        m_b = bvar * bcount
        self.var = (m_a + m_b + delta ** 2 * self.count * bcount / tot) / tot
        self.count = tot


def _step(env, action):
    out = env.step(action)
    if len(out) == 5:
        obs, r, term, trunc, info = out
        return obs, r, bool(term), bool(trunc), info
    obs, r, done, info = out
    return obs, r, done, done, info


def _normalizer(ob_rms, clip_obs):
    """Observations as the learner takes them: frames scaled to [0, 1]
    (ob_rms None), else (o - mean) / sqrt(var + 1e-8) clipped, in float32."""
    def norm_obs(o):
        o = torch.as_tensor(o, device=ob_rms.device if ob_rms is not None else None)
        if ob_rms is None:
            return o.to(torch.float32) / 255.0
        z = (o.to(torch.float64) - ob_rms.mean) / torch.sqrt(ob_rms.var + 1e-8)
        return torch.clamp(z, -clip_obs, clip_obs).to(torch.float32)
    return norm_obs


def _save(path, name, net, ob_rms):
    torch.save({"params": net.state_dict(),
                "ob_rms": None if ob_rms is None else (ob_rms.mean, ob_rms.var)},
               os.path.join(path, name))


def train_ppo_vec(old_args, path, batch=8, horizon=50, venv=None, rollout_len=256, *,
                  device="cuda"):
    """PPO on B batched envs (`VecPlasticineEnv` on `device`, or `venv`'s):
    rollouts are (T, B) device tensors and GAE runs over the batch. Every
    episode end is a truncation at the horizon (never a termination): the
    mask is 0 there, values bootstrap through it, and no bad-mask reset
    applies (ikostrikov storage.py's time-limit semantics).

    PLB_PPO_EVAL_EVERY = k > 0 runs one mean-action episode over the B envs
    every k updates, appended to PLB_PPO_EPLOG (JSON lines) if set; the
    best-eval parameters are restored and checked at the end and saved as
    `ppo_model_best.pt` beside `ppo_model.pt`."""
    from ...parallel.rollout import VecPlasticineEnv

    num_env_steps = old_args.num_steps
    gamma, gae_lambda = 0.99, 0.95
    clip_obs, clip_rew = 10.0, 10.0

    os.makedirs(path, exist_ok=True)
    if venv is None:
        venv = VecPlasticineEnv(
            old_args.env_name, batch=batch, seed=old_args.seed, horizon=horizon,
            obs_mode=getattr(old_args, "obs_mode", "state"),
            image_obs_res=getattr(old_args, "image_obs_res", 64),
            image_obs_spp=getattr(old_args, "image_obs_spp", 2), device=device)
    batch, horizon, dev = venv.batch, venv.horizon, venv.device
    visual = venv.obs_mode == "rgb"
    obs_sh = tuple(venv.obs_shape) if visual else (venv.obs_dim,)
    agent = PPO(obs_sh if visual else venv.obs_dim, venv.action_dim, seed=old_args.seed,
                device=dev)
    rng = np.random.default_rng(old_args.seed)

    # frames skip VecNormalize (as the single-env rgb path)
    ob_rms = None if visual else RunningMeanStd((venv.obs_dim,), device=dev)
    ret_rms = RunningMeanStd((), device=dev)
    ret_acc = torch.zeros((batch,), dtype=torch.float64, device=dev)
    norm_obs = _normalizer(ob_rms, clip_obs)

    raw = venv.reset()
    if not visual:
        ob_rms.update(raw)
    obs = norm_obs(raw)
    ep_t = 0
    steps_per_update = batch * rollout_len
    num_updates = max(num_env_steps // steps_per_update, 1)
    t0 = time.perf_counter()

    ep_log = os.environ.get("PLB_PPO_EPLOG")
    eval_every = int(os.environ.get("PLB_PPO_EVAL_EVERY", "0"))
    evals = []
    best = {"iou": -1.0, "state": None, "steps": 0}
    stats = {"collect_s": 0.0, "update_s": 0.0, "updates": 0}

    def run_eval():
        eobs = norm_obs(venv.reset())
        ret = torch.zeros((batch,), dtype=torch.float64, device=dev)
        inc = None
        for _ in range(horizon):
            with torch.no_grad():
                mean, _, _ = agent.net(eobs)
            nxt, r, _, info = venv.step(torch.clamp(mean, -1, 1))
            ret += r
            inc = info["incremental_iou"]
            eobs = norm_obs(nxt)
        return float(ret.mean()), float(inc.to(torch.float64).mean())

    T, B = rollout_len, batch
    f32, f64 = dict(dtype=torch.float32, device=dev), dict(dtype=torch.float64, device=dev)
    for update in range(num_updates):
        tc = time.perf_counter()
        agent.set_lr(agent.base_lr * (1 - update / num_updates))
        b_obs = torch.zeros((T, B) + obs_sh, **f32)
        b_act = torch.zeros((T, B, venv.action_dim), **f32)
        b_logp = torch.zeros((T, B), **f32)
        b_val = torch.zeros((T + 1, B), **f64)
        b_rew = torch.zeros((T, B), **f64)
        b_mask = torch.zeros((T, B), **f64)
        for t in range(T):
            actions, logp, value = agent.act_batch(obs)
            raw_next, reward, _, _ = venv.step(torch.clamp(actions, -1, 1))
            ep_t += 1
            if not visual:
                ob_rms.update(raw_next)
            ret_acc = ret_acc * gamma + reward
            ret_rms.update(ret_acc)
            norm_rew = torch.clamp(reward / torch.sqrt(ret_rms.var + 1e-8), -clip_rew, clip_rew)

            b_obs[t], b_act[t], b_logp[t] = obs, actions, logp
            b_val[t], b_rew[t] = value, norm_rew
            b_mask[t] = 0.0 if ep_t >= horizon else 1.0
            if ep_t >= horizon:
                raw_next = venv.reset()
                if not visual:
                    ob_rms.update(raw_next)
                ep_t = 0
                ret_acc = torch.zeros_like(ret_acc)
            obs = norm_obs(raw_next)

        b_val[T] = agent.get_value_batch(obs)
        # GAE over (T, B); every episode end is a truncation, so the mask
        # alone stops it
        returns = torch.zeros((T, B), **f64)
        gae = torch.zeros((B,), **f64)
        for t in reversed(range(T)):
            delta = b_rew[t] + gamma * b_val[t + 1] * b_mask[t] - b_val[t]
            gae = delta + gamma * gae_lambda * b_mask[t] * gae
            returns[t] = gae + b_val[t]

        rollouts = {
            "obs": b_obs.reshape((T * B,) + obs_sh),
            "actions": b_act.reshape(T * B, -1),
            "logp": b_logp.reshape(T * B),
            "returns": returns.reshape(T * B).to(torch.float32),
            "values": b_val[:T].reshape(T * B).to(torch.float32),
        }
        tu = time.perf_counter()
        stats["collect_s"] += tu - tc
        loss = agent.update(rollouts, rng)
        stats["update_s"] += time.perf_counter() - tu
        stats["updates"] += 1
        done_steps = (update + 1) * steps_per_update
        dt = time.perf_counter() - t0
        print(f"[PPO vec] update {update + 1}/{num_updates} loss={loss:.4f} "
              f"({done_steps / dt:.1f} env steps/s, batch={batch})")
        if eval_every and (update + 1) % eval_every == 0:
            er, ei = run_eval()
            evals.append({"steps": done_steps, "eval_return": round(er, 3),
                          "eval_incremental_iou": round(ei, 5)})
            if ei > best["iou"]:
                best.update(iou=ei, steps=done_steps,
                            state={k: v.clone() for k, v in agent.net.state_dict().items()})
            print(f"[PPO vec] eval return={er:.2f} incremental_iou={ei:.5f}")
            if ep_log:
                with open(ep_log, "a") as f:
                    f.write(json.dumps(evals[-1]) + "\n")
            # the eval consumed the venv's episode in flight: start afresh
            raw = venv.reset()
            if not visual:
                ob_rms.update(raw)
            obs = norm_obs(raw)
            ep_t = 0
            ret_acc = torch.zeros_like(ret_acc)

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    stats.update(env_steps=num_updates * steps_per_update, seconds=time.perf_counter() - t0)
    agent.vec_stats = stats
    print(f"[PPO vec] {stats['env_steps']} env steps in {stats['seconds']:.1f}s "
          f"({stats['env_steps'] / stats['seconds']:.1f} steps/s, batch={batch}); host seconds "
          f"collecting {stats['collect_s']:.2f}, updating {stats['update_s']:.2f} "
          f"({stats['updates']} updates)")
    # restore and check the best-eval policy; save it beside the final one
    best_restored = None
    if best["state"] is not None:
        final_state = {k: v.clone() for k, v in agent.net.state_dict().items()}
        agent.net.load_state_dict(best["state"])
        er, ei = run_eval()
        best_restored = {"steps": best["steps"],
                         "best_eval_incremental_iou": round(best["iou"], 5),
                         "restored_eval_return": round(er, 3),
                         "restored_eval_incremental_iou": round(ei, 5)}
        _save(path, "ppo_model_best.pt", agent.net, ob_rms)
        agent.net.load_state_dict(final_state)
    _save(path, "ppo_model.pt", agent.net, ob_rms)
    agent.evals = evals
    agent.best_eval = best_restored
    return agent


def train_ppo(env, path, logger, old_args, algo="ppo"):
    """PPO or ACKTR (`algo="acktr"`) on `env`, on its device; PPO with
    `vec_envs` > 1 runs `train_ppo_vec`. Rollouts of `old_args.rollout_len`
    steps (2500 for PPO, the reference's; 200 for ACKTR)."""
    device = env.unwrapped.taichi_env.device
    vec = int(getattr(old_args, "vec_envs", 0) or 0)
    if vec > 1 and algo == "ppo":
        return train_ppo_vec(old_args, path, batch=vec,
                             rollout_len=int(getattr(old_args, "rollout_len", 256) or 256),
                             device=device)
    num_env_steps = old_args.num_steps
    rollout_len = int(getattr(old_args, "rollout_len", 2500 if algo == "ppo" else 200))
    gamma, gae_lambda = 0.99, 0.95
    clip_obs, clip_rew = 10.0, 10.0

    os.makedirs(path, exist_ok=True)
    obs_shape = env.observation_space.shape
    visual = len(obs_shape) == 3
    obs_dim = obs_shape if visual else obs_shape[0]
    act_dim = env.action_space.shape[0]
    if algo == "acktr":
        if visual:
            raise ValueError("rgb obs_mode is wired for --algo ppo")
        from .kfac import A2C_ACKTR

        agent = A2C_ACKTR(obs_dim, act_dim, seed=old_args.seed, device=device)
    else:
        agent = PPO(obs_dim, act_dim, seed=old_args.seed, device=device)
    rng = np.random.default_rng(old_args.seed)

    # host statistics: the one-env loop's observations arrive on the host
    ob_rms = None if visual else RunningMeanStd((obs_dim,), device="cpu")
    ret_rms = RunningMeanStd((), device="cpu")
    ret_acc = 0.0
    norm = _normalizer(ob_rms, clip_obs)

    def norm_obs(o):
        return norm(np.asarray(o)).numpy()

    raw_obs = env_reset(env)
    if ob_rms is not None:
        ob_rms.update(raw_obs)
    obs = norm_obs(raw_obs)
    episode_t = 0
    num_updates = max(num_env_steps // rollout_len, 1)

    if logger is not None:
        logger.reset()

    t0 = time.perf_counter()
    for update in range(num_updates):
        if algo == "ppo":  # linear decay; K-FAC manages its own step size
            agent.set_lr(agent.base_lr * (1 - update / num_updates))
        buf = {k: [] for k in ("obs", "actions", "logp", "values", "rewards", "masks",
                               "bad_masks")}
        for t in range(rollout_len):
            action, logp, value = agent.act(obs)
            raw_next, reward, term, trunc, info = _step(env, np.clip(action, -1, 1))
            episode_t += 1
            if logger is not None:
                logger.step(None, None, reward, None,
                            term or trunc or episode_t >= env._max_episode_steps, info)

            if ob_rms is not None:
                ob_rms.update(raw_next)
            ret_acc = ret_acc * gamma + reward
            ret_rms.update(np.array([ret_acc]))
            norm_rew = np.clip(reward / np.sqrt(float(ret_rms.var) + 1e-8), -clip_rew, clip_rew)

            done = term or trunc or episode_t >= env._max_episode_steps
            buf["obs"].append(obs)
            buf["actions"].append(action)
            buf["logp"].append(logp)
            buf["values"].append(value)
            buf["rewards"].append(norm_rew)
            buf["masks"].append(0.0 if done else 1.0)
            # bad_mask = 0 only on a true termination; time-limit ends keep
            # their value
            buf["bad_masks"].append(0.0 if term else 1.0)

            if done:
                raw_next = env_reset(env)
                if ob_rms is not None:
                    ob_rms.update(raw_next)
                episode_t = 0
                ret_acc = 0.0
                if logger is not None:
                    logger.reset()
            obs = norm_obs(raw_next)

        # GAE with proper time limits (ikostrikov storage.py)
        last_value = agent.get_value(obs)
        T = rollout_len
        values = np.asarray(buf["values"] + [last_value], np.float64)
        rewards = np.asarray(buf["rewards"], np.float64)
        masks = np.asarray(buf["masks"], np.float64)
        bad_masks = np.asarray(buf["bad_masks"], np.float64)
        returns = np.zeros(T)
        gae = 0.0
        for t in reversed(range(T)):
            delta = rewards[t] + gamma * values[t + 1] * masks[t] - values[t]
            gae = delta + gamma * gae_lambda * masks[t] * gae
            gae = gae * bad_masks[t]  # reset at true terminations
            returns[t] = gae + values[t]

        rollouts = {
            "obs": np.asarray(buf["obs"], np.float32),
            "actions": np.asarray(buf["actions"], np.float32),
            "logp": np.asarray(buf["logp"], np.float32),
            "returns": returns.astype(np.float32),
            "values": values[:-1].astype(np.float32),
        }
        loss = agent.update(rollouts, rng) if algo == "ppo" else agent.update(rollouts)
        done_steps = (update + 1) * rollout_len
        print(f"[{algo.upper()}] update {update + 1}/{num_updates} loss={loss:.4f} "
              f"({done_steps / (time.perf_counter() - t0):.1f} env steps/s)")

    # the actor and the normaliser (reference run_ppo.py:200-211)
    _save(path, "ppo_model.pt", agent.net, ob_rms)
    return agent
