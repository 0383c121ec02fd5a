from .a2c import A2C
from .gail import GAIL
from .kfac import A2C_ACKTR, KFACOptimizer
from .ppo import PPO

__all__ = ["A2C", "A2C_ACKTR", "GAIL", "KFACOptimizer", "PPO"]
