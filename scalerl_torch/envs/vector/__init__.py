"""The shared-memory vector env (port of ``scalerl_tpu/envs/vector``)."""

from scalerl_torch.envs.vector.async_vec import (  # noqa: F401
    AlreadyPendingCallError,
    AsyncMultiAgentVecEnv,
    AsyncState,
    ClosedEnvError,
    NoAsyncCallError,
)
from scalerl_torch.envs.vector.spec import (  # noqa: F401
    ExperienceSpec,
    SharedObservationPlane,
)
