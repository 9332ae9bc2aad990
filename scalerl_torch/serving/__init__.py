"""The centralized inference plane: SEED-style batched serving on the card.

Port of ``scalerl_tpu/serving/``: one policy on the device
(:class:`InferenceServer`), thin env shells streaming observations to it
over the fleet's codec (:class:`RemotePolicyClient`), dynamic batching up
a bucket ladder (:class:`DynamicBatcher`), bounded admission with explicit
shedding, generation-tagged parameters for V-trace's behaviour correction
and the staleness gauge, and the SLO-aware front door over N replicas
(:class:`ServingRouter`: circuit breakers, prefix affinity with power of
two choices, at-least-once re-dispatch, rolling rollout).
"""

from scalerl_torch.serving.batcher import (
    DynamicBatcher,
    ServingConfig,
    ServingRequest,
    bucket_for,
    default_buckets,
)
from scalerl_torch.serving.client import (
    PendingReply,
    RemotePolicyClient,
    ServingUnavailable,
)
from scalerl_torch.serving.router import (
    ReplicaHandle,
    ReplicaHealth,
    RouterConfig,
    RouterTierExecutor,
    ServingRouter,
    connect_replica,
)
from scalerl_torch.serving.server import InferenceServer


def local_pair(chaos_site: str = "serve_pipe"):
    """An in-process duplex connection pair ``(client_end, server_end)``
    for same-host serving (the trainer's ``actor_mode="serving"``): both
    ends speak the codec, so the wire matches sockets exactly, and the chaos
    injector can fault the link under the ``serve`` site prefix."""
    import multiprocessing as mp

    from scalerl_torch.fleet.transport import PipeConnection

    a, b = mp.Pipe(duplex=True)
    return (
        PipeConnection(a, chaos_site=chaos_site),
        PipeConnection(b, chaos_site=chaos_site),
    )


__all__ = [
    "DynamicBatcher",
    "InferenceServer",
    "PendingReply",
    "RemotePolicyClient",
    "ReplicaHandle",
    "ReplicaHealth",
    "RouterConfig",
    "RouterTierExecutor",
    "ServingConfig",
    "ServingRequest",
    "ServingRouter",
    "ServingUnavailable",
    "bucket_for",
    "connect_replica",
    "default_buckets",
    "local_pair",
]
