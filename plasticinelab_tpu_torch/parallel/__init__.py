"""Batched envs: B copies of one task stepped together on one card."""
from .rollout import VecPlasticineEnv

__all__ = ["VecPlasticineEnv"]
