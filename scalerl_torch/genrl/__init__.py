"""The token-level sequence-RL plane: the generation engines (paged KV
bookkeeping, the prefix cache, the cohort and continuous-batching engines,
speculative decoding), rollout packing, the synthetic task, and the
disaggregated dataflow (``genrl/disagg.py``) with its durable ledger.

Exports resolve lazily, as in the JAX package: the disaggregated shells run
in spawned generation hosts, which import ``scalerl_torch.genrl.disagg``
without the engines and the model.
"""

from typing import Any

_EXPORTS = {
    "CompletedSequence": "scalerl_torch.genrl.continuous",
    "ContinuousConfig": "scalerl_torch.genrl.continuous",
    "ContinuousEngine": "scalerl_torch.genrl.continuous",
    "GenerationConfig": "scalerl_torch.genrl.engine",
    "GenerationEngine": "scalerl_torch.genrl.engine",
    "GenerationResult": "scalerl_torch.genrl.engine",
    "PageAllocator": "scalerl_torch.genrl.paging",
    "PrefixCache": "scalerl_torch.genrl.prefix_cache",
    "pack_completions": "scalerl_torch.genrl.rollout",
    "pack_sequences": "scalerl_torch.genrl.rollout",
    "sequence_field_shapes": "scalerl_torch.genrl.rollout",
    "PackedLearnerBatch": "scalerl_torch.genrl.rollout",
    "greedy_pack": "scalerl_torch.genrl.rollout",
    "pack_learner_batch": "scalerl_torch.genrl.rollout",
    "packed_field_shapes": "scalerl_torch.genrl.rollout",
    "packed_rows_from_completions": "scalerl_torch.genrl.rollout",
    "packed_rows_from_result": "scalerl_torch.genrl.rollout",
    "TokenRecallTask": "scalerl_torch.genrl.task",
    "CohortEngineShell": "scalerl_torch.genrl.disagg",
    "ContinuousEngineShell": "scalerl_torch.genrl.disagg",
    "DisaggConfig": "scalerl_torch.genrl.disagg",
    "GenerationHost": "scalerl_torch.genrl.disagg",
    "GenerationTierExecutor": "scalerl_torch.genrl.disagg",
    "LocalGenerationFleet": "scalerl_torch.genrl.disagg",
    "SequenceLearner": "scalerl_torch.genrl.disagg",
    "disagg_signal_source": "scalerl_torch.genrl.disagg",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str) -> Any:
    module_name = _EXPORTS.get(name)
    if module_name is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(module_name), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
