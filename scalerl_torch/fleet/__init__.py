"""The actor fleet: host CPU actors feeding the learner on the card.

Port of ``scalerl_tpu/fleet``: the flat frame codec and its connections,
the connection hub and job executor, the worker/gather/server protocol with
entry handshake, weight caching, batched uploads and elastic membership,
and turn-based episode generation.  Capability parity with
``scalerl/hpc/`` (SURVEY.md §2.1).
"""

from scalerl_torch.fleet.cluster import (
    ClusterExecutor,
    FleetConfig,
    Gather,
    LocalCluster,
    RemoteCluster,
    WorkerServer,
    apply_mass_kill,
    worker_loop,
)
from scalerl_torch.fleet.framing import (
    ProtocolError,
    pack_message,
    pack_message_v1,
    unpack_message,
)
from scalerl_torch.fleet.generation import (
    EpisodeGenerator,
    discounted_returns,
    make_generation_runner,
    masked_softmax,
)
from scalerl_torch.fleet.hub import JobExecutor, QueueHub
from scalerl_torch.fleet.transport import (
    Connection,
    PipeConnection,
    SocketConnection,
    connect_socket,
    listen_socket,
    open_worker_pipes,
    send_recv,
)

__all__ = [
    "ClusterExecutor",
    "FleetConfig",
    "apply_mass_kill",
    "Gather",
    "LocalCluster",
    "RemoteCluster",
    "WorkerServer",
    "worker_loop",
    "ProtocolError",
    "pack_message",
    "pack_message_v1",
    "unpack_message",
    "EpisodeGenerator",
    "discounted_returns",
    "make_generation_runner",
    "masked_softmax",
    "JobExecutor",
    "QueueHub",
    "Connection",
    "PipeConnection",
    "SocketConnection",
    "connect_socket",
    "listen_socket",
    "open_worker_pipes",
    "send_recv",
]
