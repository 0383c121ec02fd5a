"""Batched envs: B copies of one task stepped, or rolled out and
differentiated, together on one card."""
from .mesh import batch_states, build_batched_rollout_grad
from .rollout import VecPlasticineEnv

__all__ = ["VecPlasticineEnv", "batch_states", "build_batched_rollout_grad"]
