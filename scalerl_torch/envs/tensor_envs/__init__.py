from scalerl_torch.envs.tensor_envs.base import TensorEnv, make_tensor_vec_env
from scalerl_torch.envs.tensor_envs.breakout import BreakoutDraws, BreakoutState, TensorBreakout
from scalerl_torch.envs.tensor_envs.cartpole import CartPoleState, TensorCartPole
from scalerl_torch.envs.tensor_envs.catch import CatchDraws, CatchState, TensorCatch
from scalerl_torch.envs.tensor_envs.recall import RecallDraws, RecallState, TensorRecall
from scalerl_torch.envs.tensor_envs.synthetic import (
    SyntheticDraws,
    SyntheticPixelEnv,
    SyntheticState,
)

__all__ = [
    "BreakoutDraws",
    "BreakoutState",
    "CartPoleState",
    "CatchDraws",
    "CatchState",
    "RecallDraws",
    "RecallState",
    "SyntheticDraws",
    "SyntheticPixelEnv",
    "SyntheticState",
    "TensorBreakout",
    "TensorCartPole",
    "TensorCatch",
    "TensorEnv",
    "TensorRecall",
    "make_tensor_vec_env",
]
