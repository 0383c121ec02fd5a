"""CLI: python -m plasticinelab_tpu_torch.algorithms.solve --algo nn --env_name Move-v1

Counterpart of `plasticinelab_tpu/algorithms/solve.py` with the same flags
and defaults (behavioral reference plb/algorithms/solve.py: 50x200 env
steps for the differentiable solvers, 500k for RL). It runs on the card;
`main(argv, device="cpu")` runs the plain versions on the CPU. Every
`--algo` of the reference is dispatched: `action`, `nn`, `sac` and
`discor` (`sac/run_sac.train`), `td3` (`td3/run_td3.train_td3`, `--policy`
TD3, OurDDPG or DDPG), `ppo` and `acktr` (`ppo/run_ppo.train_ppo`).
`--vec_envs` B > 1 collects with B batched envs for sac, discor, td3 (TD3
only: `--policy OurDDPG|DDPG --vec_envs B` is refused, as the reference
has no batched DDPG) and ppo.
"""
from __future__ import annotations

import argparse
import random

import numpy as np

RL_ALGOS = ["sac", "discor", "td3", "ppo", "acktr"]
DIFF_ALGOS = ["action", "nn"]


def set_random_seed(seed: int):
    random.seed(seed)
    np.random.seed(seed)


def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--algo", type=str, default="action",
                        choices=DIFF_ALGOS + RL_ALGOS)
    parser.add_argument("--env_name", type=str, default="Move-v1")
    parser.add_argument("--path", type=str, default="./tmp")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--sdf_loss", type=float, default=10)
    parser.add_argument("--density_loss", type=float, default=10)
    parser.add_argument("--contact_loss", type=float, default=1)
    parser.add_argument("--soft_contact_loss", action="store_true")
    parser.add_argument("--num_steps", type=int, default=None)
    # differentiable physics parameters
    parser.add_argument("--lr", type=float, default=0.1)
    parser.add_argument("--policy", type=str, default="TD3",
                        choices=["TD3", "OurDDPG", "DDPG"],
                        help="TD3-family variant (reference TD3/main.py)")
    parser.add_argument("--vec_envs", type=int, default=0,
                        help="collect RL data with N batched envs on the device "
                             "(0 = the reference's one-env loop)")
    parser.add_argument("--obs_mode", type=str, default="state",
                        choices=["state", "rgb"],
                        help="rgb = rendered 64x64 image observations "
                             "(the visual-RL extension)")
    parser.add_argument("--image_obs_res", type=int, default=64,
                        help="rgb observation resolution")
    parser.add_argument("--image_obs_spp", type=int, default=2,
                        help="rgb observation samples per pixel")
    parser.add_argument("--softness", type=float, default=666.0)
    parser.add_argument("--optim", type=str, default="Adam",
                        choices=["Adam", "Momentum"])
    parser.add_argument("--host_loop", action="store_true",
                        help="run the solve with the reference-style host loop "
                             "(numpy optimizer each iteration) instead of the "
                             "device-resident loop")
    return parser.parse_args(argv)


def main(argv=None, *, device="cuda"):
    args = get_args(argv)
    from ..envs import make
    from .logger import Logger

    if args.num_steps is None:
        args.num_steps = 50 * 200 if args.algo in DIFF_ALGOS else 500000

    logger = Logger(args.path)
    set_random_seed(args.seed)

    env = make(
        args.env_name, nn=(args.algo == "nn"), sdf_loss=args.sdf_loss,
        density_loss=args.density_loss, contact_loss=args.contact_loss,
        soft_contact_loss=args.soft_contact_loss, obs_mode=args.obs_mode,
        image_obs_res=args.image_obs_res, image_obs_spp=args.image_obs_spp,
        device=device,
    )
    env.unwrapped.seed(args.seed)

    if args.algo == "action":
        from ..optimizer.solver import solve_action

        return solve_action(env, args.path, logger, args)
    if args.algo == "nn":
        from ..optimizer.solver_nn import solve_nn

        return solve_nn(env, args.path, logger, args)
    if args.algo in ("sac", "discor"):
        from .sac.run_sac import train as train_sac

        return train_sac(env, args.path, logger, args)
    if args.algo == "td3":
        from .td3.run_td3 import train_td3

        return train_td3(env, args.path, logger, args)
    from .ppo.run_ppo import train_ppo

    return train_ppo(env, args.path, logger, args, algo=args.algo)


if __name__ == "__main__":
    main()
