"""Trainer-side hot-rows device cache for a sharded embedding table
(counterpart of ``paddle_tpu/ops/embed_cache.py:97-326``).

A table too large for the card lives on a fleet of row-range shards
(``paddle_tpu_torch/distributed/sharded_table.py``). The trainer keeps a
fixed-capacity ``[capacity + 1, W]`` tensor of the rows it works on, and
one of each row-aligned optimizer state (lazy Adam's ``moment1`` and
``moment2``); row ``capacity`` is the pinned-zero pad slot. Before each
step the host translates the batch's vocab ids to cache slots
(:meth:`HotRowsCache.translate`):

- ids already resident are hits and cost nothing more;
- misses are pulled from their shards (param and moments; rows never
  pushed come back zero) and installed into free slots by the scatter
  kernel (``ops/kernels/embed_cache.py`` ``scatter_rows_families``), in
  place, every family in one launch;
- when the free slots run out, the least recently used rows are evicted,
  and the dirty ones are first read back by the gather kernel
  (``gather_rows_families``, every family in one launch) and pushed to
  their shards, so the moments stay exact across evictions. The current
  batch's rows are pinned (moved to the recent end, never evicted).

Installs and reads are padded to power-of-two buckets (at least 8):
installs with the out-of-range slot ``capacity + 1``, which the scatter
drops, reads with the pad slot, whose rows are sliced off on the host.
So the scatter kernel's drop path runs on every install, and the kernels
see a handful of shapes (what a later CUDA graph needs). The free list
is ``range(capacity - 1, -1, -1)`` popped from its end, as in the JAX
cache, so both give the same slots for the same schedule.

Hits, misses, evictions and occupancy are the reference's families
``paddle_embed_cache_{hits,misses,evictions}_total`` and
``paddle_embed_cache_occupancy_ratio``, labelled by the table
(``param``), counted as the JAX cache counts them (unique ids per
:meth:`~HotRowsCache.translate`; padding never counts); the plain
counters ``lookups`` and ``hit_lookups`` count occurrences.
``installs`` and ``writebacks`` count the calls that installed and that
wrote back. On the card each launches one kernel for all of the families
(in sorted family order, as :meth:`_ensure` pulls and pushes them): an
install makes one host-to-device copy of the padded slots and one of the
stacked [F, bucket, W] rows, a write-back one device-to-host copy, which
waits for the work queued before it.

:func:`enable_sharded_table` puts a model's table Parameter and its Adam
state on such a cache. The JAX package rewrites the program instead
(``:345-437``); the port has no executor yet, so it swaps the
Parameter's storage and the optimizer's state in place.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional

import numpy as np
import torch

from paddle_tpu_torch.observability import metrics as _metrics
from paddle_tpu_torch.ops.kernels import embed_cache as _kernels

MIN_BUCKET = 8

# the reference's families (``paddle_tpu/ops/embed_cache.py:56-71``):
# hits / misses count UNIQUE ids per translate() call
CACHE_HITS = _metrics.counter(
    "paddle_embed_cache_hits_total",
    "Unique ids found resident per translate() call",
    labelnames=("param",))
CACHE_MISSES = _metrics.counter(
    "paddle_embed_cache_misses_total",
    "Unique ids pulled from their owning shard (cold rows)",
    labelnames=("param",))
CACHE_EVICTIONS = _metrics.counter(
    "paddle_embed_cache_evictions_total",
    "LRU evictions (dirty rows write back to their shard first)",
    labelnames=("param",))
CACHE_OCCUPANCY = _metrics.gauge(
    "paddle_embed_cache_occupancy_ratio",
    "Resident rows / capacity after the last translate()",
    labelnames=("param",))


def bucket(n: int) -> int:
    """The power of two (at least 8) that an install or read of ``n`` rows
    is padded to."""
    b = MIN_BUCKET
    while b < n:
        b *= 2
    return b


class HotRowsCache:
    """Fixed-capacity row cache for ONE sharded table.

    ``families`` maps family name -> its ``[capacity + 1, width]`` fp32
    tensor (all on one device, one width); ``param`` is the table itself,
    the others its row-aligned optimizer state (at most
    ``MAX_FAMILIES`` families in all). The cache writes them in place and
    never replaces them."""

    def __init__(self, table: str, height: int, capacity: int, client,
                 families: Dict[str, torch.Tensor], padding_idx: int = -1):
        if capacity < 1 or capacity > height:
            raise ValueError(f"capacity {capacity} not in [1, {height}]")
        if "param" not in families:
            raise ValueError("families must include 'param'")
        for fam, t in families.items():
            if t.dim() != 2 or t.shape[0] != capacity + 1 \
                    or t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError(f"family {fam!r}: want a contiguous "
                                 f"[{capacity + 1}, W] float32 tensor, got "
                                 f"{tuple(t.shape)} {t.dtype}")
        if len({t.device for t in families.values()}) != 1:
            raise ValueError("the families lie on several devices")
        if len({t.shape for t in families.values()}) != 1:
            raise ValueError("the families differ in width")
        if len(families) > _kernels.MAX_FAMILIES:
            raise ValueError(f"at most {_kernels.MAX_FAMILIES} families, got "
                             f"{sorted(families)}")
        self.table = table
        self.height = int(height)
        self.capacity = int(capacity)
        self.pad_slot = int(capacity)
        self.client = client
        self.families = dict(families)
        self._order = sorted(self.families)     # the kernels' family order
        self._stack = [self.families[fam] for fam in self._order]
        self.width = int(self._stack[0].shape[1])
        self.device = families["param"].device
        self.padding_idx = -1 if padding_idx is None else int(padding_idx)
        self._slot_lut = np.full(self.height, -1, dtype=np.int64)
        self._lru: "OrderedDict[int, int]" = OrderedDict()  # vocab -> slot
        self._free = list(range(self.capacity - 1, -1, -1))
        self._dirty: set = set()
        self._hits = CACHE_HITS.labels(param=table)
        self._misses = CACHE_MISSES.labels(param=table)
        self._evictions = CACHE_EVICTIONS.labels(param=table)
        self._occupancy = CACHE_OCCUPANCY.labels(param=table)
        self.lookups = self.hit_lookups = 0
        self.installs = self.writebacks = 0

    # -- device plumbing ---------------------------------------------------

    def _device_set_rows(self, slots: np.ndarray,
                         vals: Dict[str, np.ndarray]) -> None:
        """Install every family's rows (``vals[fam]`` [n, W]) at slots,
        padded to a bucket with the dropped slot ``capacity + 1``: one
        launch."""
        b = bucket(slots.size)
        idx = np.full(b, self.capacity + 1, dtype=np.int32)
        idx[:slots.size] = slots
        v = np.zeros((len(self._order), b, self.width), dtype=np.float32)
        for i, fam in enumerate(self._order):
            v[i, :slots.size] = vals[fam]
        _kernels.scatter_rows_families(
            self._stack, torch.from_numpy(idx).to(self.device),
            torch.from_numpy(v).to(self.device))

    def _device_get_rows(self, slots: np.ndarray) -> Dict[str, np.ndarray]:
        """Every family's rows at slots, padded to a bucket with the pad
        slot (sliced off here): one launch. The copy to the host waits for
        the work queued before it on the stream: the last step's optimizer
        writes."""
        b = bucket(slots.size)
        idx = np.full(b, self.pad_slot, dtype=np.int32)
        idx[:slots.size] = slots
        out = _kernels.gather_rows_families(
            self._stack, torch.from_numpy(idx).to(self.device))
        out = out.cpu().numpy()[:, :slots.size]
        return {fam: out[i] for i, fam in enumerate(self._order)}

    # -- the hot path ------------------------------------------------------

    def translate(self, ids, train: bool = True) -> np.ndarray:
        """Vocab ids (any shape) -> cache slots (same shape and dtype),
        after making every id resident. ``padding_idx`` ids map to the pad
        slot. ``train=True`` marks every touched row dirty."""
        a = np.asarray(ids)
        flat = a.reshape(-1).astype(np.int64)
        pad_mask = (flat == self.padding_idx) if self.padding_idx >= 0 \
            else None
        valid = flat[~pad_mask] if pad_mask is not None else flat
        uniq = np.unique(valid)
        if uniq.size and (uniq[0] < 0 or uniq[-1] >= self.height):
            raise IndexError(f"{self.table}: ids outside [0, {self.height})")
        resident = self._slot_lut[valid] >= 0
        self.lookups += int(valid.size)
        self.hit_lookups += int(resident.sum())
        miss = uniq[self._slot_lut[uniq] < 0] if uniq.size else uniq
        self._hits.inc(int(uniq.size - miss.size))
        if miss.size:
            self._misses.inc(int(miss.size))
            self._ensure(miss, keep=uniq)
        for vid in uniq.tolist():               # one batch, one recency tick
            self._lru.move_to_end(vid)
        if train:
            self._dirty.update(uniq.tolist())
        slots = self._slot_lut[flat]
        if pad_mask is not None:
            slots[pad_mask] = self.pad_slot
        self._occupancy.set(len(self._lru) / self.capacity)
        return slots.reshape(a.shape).astype(a.dtype)

    def _ensure(self, miss: np.ndarray, keep: np.ndarray) -> None:
        if keep.size > self.capacity:
            raise ValueError(
                f"{self.table}: one batch touches {keep.size} unique rows > "
                f"cache capacity {self.capacity}: size the cache above the "
                f"per-step working set")
        # evict oldest first until the misses fit; the batch's own rows are
        # pinned, and dirty victims are written back before their slots
        # are reused
        pinned = set(keep.tolist())
        evict_ids, evict_slots = [], []
        while len(self._free) < miss.size:
            vid, slot = self._lru.popitem(last=False)
            if vid in pinned:
                self._lru[vid] = slot            # back in at the recent end
                continue
            self._slot_lut[vid] = -1
            self._free.append(slot)
            self._evictions.inc()
            if vid in self._dirty:
                self._dirty.discard(vid)
                evict_ids.append(vid)
                evict_slots.append(slot)
        if evict_ids:
            self._writeback(np.asarray(evict_ids, dtype=np.int64),
                            np.asarray(evict_slots, dtype=np.int64))
        pulled = self.client.pull_rows(
            self.table, miss,
            families=[(fam, t.shape[1])
                      for fam, t in sorted(self.families.items())])
        slots = np.asarray([self._free.pop() for _ in range(miss.size)],
                           dtype=np.int64)
        self._device_set_rows(slots, pulled)
        self.installs += 1
        self._slot_lut[miss] = slots
        for vid, slot in zip(miss.tolist(), slots.tolist()):
            self._lru[vid] = slot

    def _writeback(self, vocab_rows: np.ndarray, slots: np.ndarray) -> None:
        values = self._device_get_rows(slots)
        self.writebacks += 1
        self.client.push_rows(self.table, vocab_rows, values)

    def flush(self) -> int:
        """Write every dirty resident row back to its shard; returns the
        rows written."""
        if not self._dirty:
            return 0
        ids = np.asarray(sorted(self._dirty), dtype=np.int64)
        self._writeback(ids, self._slot_lut[ids])
        self._dirty.clear()
        return int(ids.size)

    def drop_all(self) -> int:
        """Flush, then forget every resident row: the next translate pulls
        everything cold."""
        n = self.flush()
        for vid in self._lru:
            self._slot_lut[vid] = -1
        self._free = list(range(self.capacity - 1, -1, -1))
        self._lru.clear()
        self._occupancy.set(0.0)
        return n

    def warmup(self) -> None:
        """Run the install and the read once at every bucket up to the
        capacity, on padding only (installs to the dropped slot, reads of
        the pad slot): the kernels are built and loaded before the first
        step, and nothing resident changes."""
        b, top = bucket(1), bucket(self.capacity)
        while b <= top:
            drop = np.full(b, self.capacity + 1, dtype=np.int64)
            pad = np.full(b, self.pad_slot, dtype=np.int64)
            self._device_set_rows(drop, {
                fam: np.zeros((b, self.width), dtype=np.float32)
                for fam in self._order})
            self._device_get_rows(pad)
            b *= 2

    @property
    def resident(self) -> int:
        return len(self._lru)


# optimizer -> its row-aligned state, the families that ride along rows
# (the beta powers advance once a step and stay with the trainer)
ROW_STATE = {"Adam": ("moment1", "moment2")}


def enable_sharded_table(param: torch.nn.Parameter, optimizer, client,
                         capacity: int, table: Optional[str] = None,
                         padding_idx: int = -1) -> HotRowsCache:
    """Put the table ``param`` [V, W], trained by ``optimizer``, on a
    ``capacity``-row cache over ``client``'s shards, which already hold its
    rows (``client.seed_from_value``; ``table`` is their name there, by
    default the client's only table).

    The Parameter object stays the same; its storage becomes the
    ``[capacity + 1, W]`` cache tensor (zeros), so ``lookup_table`` over it
    takes cache slots and its sparse gradient has ``capacity + 1`` rows.
    The optimizer's state of the Parameter becomes the cache's moment
    tensors with the beta powers at their start values. Only the JAX
    package's ``adam`` has row-aligned state the port can carry
    (``ROW_STATE``); any other optimizer raises. Ends with
    :meth:`HotRowsCache.warmup`."""
    name = type(optimizer).__name__
    if name not in ROW_STATE:
        raise ValueError(f"no row-aligned state known for {name}: a sharded "
                         f"table takes {sorted(ROW_STATE)}")
    group = next((g for g in optimizer.param_groups
                  if any(p is param for p in g["params"])), None)
    if group is None:
        raise ValueError("the optimizer does not train this parameter")
    if param.dim() != 2:
        raise ValueError(f"the table must be [V, W], got {tuple(param.shape)}")
    height, width = param.shape
    if client.spec.height != height:
        raise ValueError(f"client spec height {client.spec.height} != table "
                         f"height {height}")
    if table is None:
        if len(client.tables) != 1:
            raise ValueError(f"name the table: the client holds "
                             f"{client.tables}")
        table = client.tables[0]
    with torch.no_grad():
        param.data = torch.zeros((capacity + 1, width), dtype=torch.float32,
                                 device=param.device)
    families = {"param": param.detach()}
    for fam in ROW_STATE[name]:
        families[fam] = torch.zeros_like(families["param"])
    optimizer.state[param] = {
        **{fam: families[fam] for fam in ROW_STATE[name]},
        "beta1_pow": np.float32(group["beta1"]),
        "beta2_pow": np.float32(group["beta2"])}
    cache = HotRowsCache(table, height, capacity, client, families,
                         padding_idx=padding_idx)
    cache.warmup()
    return cache
