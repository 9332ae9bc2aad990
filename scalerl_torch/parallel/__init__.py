"""Meshes, sharding rules, the sharded learn step and the mesh families that
compute on shards: ring-attention sequence parallelism over ``sp``, the GPipe
pipeline over ``pp`` and expert parallelism over ``ep``; and the multi-node
rendezvous (port of ``scalerl_tpu/parallel``).

Axis vocabulary, in mesh order: ``dp`` (data), ``pp``, ``fsdp`` (param and
optimizer shards), ``tp`` (tensor, heuristic), ``sp``, ``ep`` and ``mp``
(model, driven by the logical rule table of ``parallel/logical.py``).  A
mesh spans the ranks of the default process group, one device a rank.
"""

from scalerl_torch.parallel.logical import (  # noqa: F401
    LOGICAL_RULES,
    activation_constraint,
    has_mp_params,
    make_shard_and_gather_fns,
    mp_param_sharding,
    mp_param_spec,
)
from scalerl_torch.parallel.mesh import (  # noqa: F401
    AXIS_NAMES,
    Mesh,
    MeshSpec,
    make_mesh,
    mesh_spec_from_args,
    resolve_mesh,
    with_own_groups,
)
from scalerl_torch.parallel.sharding import (  # noqa: F401
    batch_sharding,
    has_scanned_params,
    infer_param_spec,
    param_sharding,
    replicated,
    shard_batch,
    shard_params,
    trajectory_sharding,
)
from scalerl_torch.parallel.train_step import (  # noqa: F401
    enable_offpolicy_mesh,
    fp32_optimizer_state,
    make_parallel_act_fn,
    make_parallel_learn_fn,
    make_pooled_act_fn,
    maybe_enable_mesh_from_args,
)
from scalerl_torch.parallel.expert import (  # noqa: F401
    expert_param_sharding,
    make_expert_parallel_apply,
)
from scalerl_torch.parallel.multihost import initialize_multihost  # noqa: F401
from scalerl_torch.parallel.pipeline import (  # noqa: F401
    hetero_sequential_apply,
    make_hetero_pipeline_apply,
    make_pipeline_apply,
    sequential_apply,
)
from scalerl_torch.parallel.sequence import make_sequence_parallel_apply  # noqa: F401
