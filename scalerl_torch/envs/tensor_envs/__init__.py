from scalerl_torch.envs.tensor_envs.base import TensorEnv
from scalerl_torch.envs.tensor_envs.cartpole import CartPoleState, TensorCartPole
from scalerl_torch.envs.tensor_envs.synthetic import (
    SyntheticDraws,
    SyntheticPixelEnv,
    SyntheticState,
)

__all__ = [
    "CartPoleState",
    "SyntheticDraws",
    "SyntheticPixelEnv",
    "SyntheticState",
    "TensorCartPole",
    "TensorEnv",
]
