"""The power-of-two bucket ladder (copy of ``scalerl_tpu/utils/buckets.py``).

The generation engines pad ragged prompt and response lengths, and the
continuous engine its admitted-prefill batch sizes, up a fixed ladder, so
every dispatch sees one of a few static shapes.  Plain Python.
"""

from __future__ import annotations

from typing import List, Tuple


def default_buckets(max_size: int) -> Tuple[int, ...]:
    """Power-of-two ladder up to (and always including) ``max_size``."""
    buckets: List[int] = []
    b = 1
    while b < max_size:
        buckets.append(b)
        b *= 2
    buckets.append(max_size)
    return tuple(buckets)


def bucket_for(size: int, buckets: Tuple[int, ...]) -> int:
    """Smallest bucket >= size; oversize requests get their own
    next-power-of-two bucket (never an error)."""
    for b in buckets:
        if size <= b:
            return b
    b = buckets[-1] if buckets else 1
    while b < size:
        b *= 2
    return b
