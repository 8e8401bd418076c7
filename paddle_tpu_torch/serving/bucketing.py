"""The prompt-bucket ladder (counterpart of
``paddle_tpu/serving/bucketing.py`` and ``engine.py:361``
``prompt_bucket_for``).

A prompt is right-padded to the smallest bucket that holds it, so
mixed-length traffic pays for its bucket instead of the longest prompt;
the generated tokens land from the bucket's end on.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple


def ladder(buckets: Iterable[int]) -> Tuple[int, ...]:
    """Sorted distinct bucket lengths, each >= 1."""
    out = tuple(sorted({int(b) for b in buckets}))
    if not out or out[0] < 1:
        raise ValueError(f"prompt buckets must be lengths >= 1, got {out}")
    return out


def bucket_for(length: int, buckets: Tuple[int, ...]) -> Optional[int]:
    """Smallest bucket >= ``length``, or None when none holds it."""
    for b in buckets:
        if length <= b:
            return b
    return None
