from scalerl_torch.envs.tensor_envs.base import TensorEnv
from scalerl_torch.envs.tensor_envs.synthetic import (
    SyntheticDraws,
    SyntheticPixelEnv,
    SyntheticState,
)

__all__ = ["SyntheticDraws", "SyntheticPixelEnv", "SyntheticState", "TensorEnv"]
