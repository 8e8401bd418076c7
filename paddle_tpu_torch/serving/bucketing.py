"""Shape buckets (counterpart of ``paddle_tpu/serving/bucketing.py``
and ``utils/padding.py``): the prompt-bucket ladder, the batch-bucket
policy of the wave engine and ``ServedModel``, and the pad-and-slice of
a feed dict (:func:`pad_to_bucket`, :func:`slice_outputs`), on the host
in numpy.

A prompt is right-padded to the smallest bucket that holds it, so
mixed-length traffic pays for its bucket instead of the longest prompt;
the generated tokens land from the bucket's end on. A batch of ``n``
requests runs at the smallest batch bucket >= n, its rows padded by
repeating the last one (always-valid inputs) and sliced back off. The
model server coalesces only requests of one :class:`FeedSignature`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np


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


def pow2_buckets(max_size: int) -> List[int]:
    """[1, 2, 4, ..., max] powers of two, ``max_size`` last
    (``utils/padding.py:140``)."""
    out = []
    b = 1
    while b < max_size:
        out.append(b)
        b *= 2
    out.append(int(max_size))
    return sorted(set(out))


def pad_rows(arr, target: int) -> np.ndarray:
    """Pad ``arr``'s leading dim up to ``target`` rows by repeating the
    last row (``utils/padding.py:42``, mode ``"edge"``); a no-op at or
    over ``target``."""
    arr = np.asarray(arr)
    n = arr.shape[0] if arr.ndim else 0
    if arr.ndim == 0 or n >= target:
        return arr
    if n == 0:
        raise ValueError("cannot pad an empty batch (no row to repeat)")
    return np.concatenate([arr, np.repeat(arr[-1:], target - n, axis=0)])


def slice_rows(arr, n: int) -> np.ndarray:
    """Undo :func:`pad_rows` on a fetch: its first ``n`` rows where it
    has a row axis longer than ``n``; a scalar passes through
    (``utils/padding.py:65``)."""
    a = np.asarray(arr)
    if a.ndim == 0 or a.shape[0] <= n:
        return a
    return a[:n]


def pad_to_bucket(feeds: Dict[str, np.ndarray], bucket: int,
                  batch_names: Optional[Sequence[str]] = None
                  ) -> Tuple[Dict[str, np.ndarray], int]:
    """Every batch-carrying feed padded to ``bucket`` rows by
    :func:`pad_rows` (``bucketing.py:77``) -> (the padded feeds, the
    original row count). ``batch_names`` names the batch feeds; by
    default the leading dim most feeds share is the batch (a vote; a
    tie goes to the smaller dim), and feeds of another leading dim or
    none are left alone."""
    if batch_names is None:
        votes: Dict[int, int] = {}
        for v in feeds.values():
            s = np.shape(v)
            if len(s) >= 1:
                votes[s[0]] = votes.get(s[0], 0) + 1
        if not votes:
            return dict(feeds), bucket
        n = max(sorted(votes), key=lambda k: votes[k])
        batch_names = [k for k, v in feeds.items()
                       if len(np.shape(v)) >= 1 and np.shape(v)[0] == n]
    else:
        n = int(np.shape(feeds[batch_names[0]])[0])
    out = dict(feeds)
    for name in batch_names:
        out[name] = pad_rows(feeds[name], bucket)
    return out, n


def slice_outputs(outs: List[np.ndarray], n: int) -> List[np.ndarray]:
    """The padded rows sliced off every row-shaped output
    (``bucketing.py:104``)."""
    return [slice_rows(o, n) for o in outs]


@dataclass(frozen=True)
class BucketPolicy:
    """Batch-bucket ladder for one model (``bucketing.py:32``):
    ``batch_buckets`` sorted and distinct; ``max_batch`` is the largest
    (an oversized batch is chunked by it)."""

    batch_buckets: Tuple[int, ...] = (1, 2, 4, 8)

    def __post_init__(self):
        if not self.batch_buckets:
            raise ValueError("BucketPolicy needs at least one bucket")
        object.__setattr__(self, "batch_buckets",
                           tuple(sorted({int(b)
                                         for b in self.batch_buckets})))
        if self.batch_buckets[0] < 1:
            raise ValueError("bucket sizes must be >= 1")

    @classmethod
    def pow2(cls, max_batch: int) -> "BucketPolicy":
        return cls(tuple(pow2_buckets(max_batch)))

    @property
    def max_batch(self) -> int:
        return self.batch_buckets[-1]

    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n (callers chunk by max_batch first)."""
        b = bucket_for(n, self.batch_buckets)
        if b is None:
            raise ValueError(
                f"batch of {n} exceeds the largest bucket "
                f"{self.max_batch}; chunk the request first")
        return b

    def chunks(self, n: int) -> List[int]:
        """Split n rows into chunk sizes, each <= max_batch (all but the
        last are exactly max_batch)."""
        out = []
        while n > self.max_batch:
            out.append(self.max_batch)
            n -= self.max_batch
        if n:
            out.append(n)
        return out


@dataclass(frozen=True)
class FeedSignature:
    """Per-example feed signature (``bucketing.py:111``): the (name,
    per-row shape, dtype) set requests must share to coalesce into one
    batch."""

    items: Tuple[Tuple[str, Tuple[int, ...], str], ...] = field(
        default_factory=tuple)

    @classmethod
    def of(cls, feeds: Dict[str, np.ndarray]) -> "FeedSignature":
        items = []
        for name in sorted(feeds):
            a = np.asarray(feeds[name])
            items.append((name, tuple(a.shape[1:]), str(a.dtype)))
        return cls(tuple(items))
