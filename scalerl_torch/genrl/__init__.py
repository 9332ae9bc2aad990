"""Generation engines of the sequence-RL plane: paged KV bookkeeping, the
prefix cache, the cohort engine and the continuous-batching engine."""
