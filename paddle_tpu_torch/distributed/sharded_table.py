"""Sharded embedding tables: a [height, D] table split by contiguous row
range over a fleet of row-store shards, in process (counterpart of
``paddle_tpu/distributed/sharded_table.py``; its wire, the shard server's
serving loop and the client's RPC retries come with the port's RPC layer).

- :class:`ShardSpec` -- the balanced ``[lo, hi)`` bounds (the first
  ``height % num_shards`` shards get one extra row), ``owner_of`` and
  ``route``.
- :func:`encode_rows` / :func:`decode_rows` / :func:`payload_nbytes` --
  the row codecs ``none`` (fp32 as it is), ``bf16`` (round to nearest
  even, as ``ml_dtypes.bfloat16`` rounds; carried as its uint16 bits) and
  ``int8`` (one fp32 scale per row, max-abs / 127), in numpy.
- :class:`TableShardServer` -- one shard's row store: ``load``, ``rows``,
  ``_pull_rows`` (families never pushed come back zero-filled at the
  asked width: lazily created optimizer state) and ``_push_rows``
  (overwrite by local row; a push id already applied is refused).
- :class:`ShardedTableClient` -- the trainer's side over in-process
  shards: ``spec``, ``pull_rows`` and ``push_rows`` (one pull or push per
  owning shard, reassembled in input order), ``create_table``,
  ``seed_from_value`` (always fp32), and the payload bytes per direction
  and shard as plain attributes (``bytes``).

Everything here is host code over numpy arrays; the device side is
``paddle_tpu_torch/ops/embed_cache.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class ShardSpec:
    """Contiguous row-range partition of a [height, D] table over
    ``num_shards`` shards, ``|len(range_i) - len(range_j)| <= 1``."""

    def __init__(self, height: int, num_shards: int):
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        if height < num_shards:
            raise ValueError(
                f"cannot split {height} rows over {num_shards} shards")
        self.height = int(height)
        self.num_shards = int(num_shards)
        base, extra = divmod(self.height, self.num_shards)
        bounds, lo = [], 0
        for i in range(self.num_shards):
            hi = lo + base + (1 if i < extra else 0)
            bounds.append((lo, hi))
            lo = hi
        self.bounds: List[Tuple[int, int]] = bounds
        self._starts = np.asarray([b[0] for b in bounds], dtype=np.int64)

    def owner_of(self, rows) -> np.ndarray:
        """Shard index of each global row id: the shard whose range starts
        at or last before it."""
        r = np.asarray(rows, dtype=np.int64)
        if r.size and (r.min() < 0 or r.max() >= self.height):
            bad = r[(r < 0) | (r >= self.height)][:5]
            raise IndexError(
                f"row ids {bad.tolist()} outside [0, {self.height})")
        return (np.searchsorted(self._starts, r, side="right") - 1).astype(
            np.int64)

    def route(self, rows) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
        """{shard: (positions into the input, local rows)} for the shards
        that own some of ``rows``."""
        r = np.asarray(rows, dtype=np.int64).reshape(-1)
        owners = self.owner_of(r)
        out = {}
        for s in np.unique(owners):
            pos = np.nonzero(owners == s)[0]
            out[int(s)] = (pos, r[pos] - self.bounds[int(s)][0])
        return out

    def __repr__(self):
        return (f"ShardSpec(height={self.height}, "
                f"num_shards={self.num_shards}, bounds={self.bounds})")


# -- row codecs --------------------------------------------------------------

CODECS = ("none", "bf16", "int8")


def _bf16_bits(v: np.ndarray) -> np.ndarray:
    """fp32 -> the uint16 bits of bfloat16, rounded to nearest even; NaN
    stays NaN (quiet), overflow goes to infinity."""
    b = v.view(np.uint32)
    out = ((b + np.uint32(0x7FFF) + ((b >> 16) & np.uint32(1))) >> 16)
    nan = np.isnan(v)
    out[nan] = (b[nan] >> 16) | np.uint32(0x0040)
    return out.astype(np.uint16)


def encode_rows(values: np.ndarray, codec: str) -> tuple:
    """[K, D] float32 -> payload: ``("none", fp32)``, ``("bf16", the
    uint16 bits of bfloat16)`` or ``("int8", codes, one fp32 scale per
    row)``."""
    v = np.ascontiguousarray(values, dtype=np.float32)
    if codec == "none":
        return ("none", v)
    if codec == "bf16":
        return ("bf16", _bf16_bits(v))
    if codec == "int8":
        scale = np.abs(v).max(axis=-1, keepdims=True) / 127.0
        scale = np.where(scale == 0.0, 1.0, scale).astype(np.float32)
        q = np.clip(np.rint(v / scale), -127, 127).astype(np.int8)
        return ("int8", q, scale)
    raise ValueError(f"unknown codec {codec!r}")


def decode_rows(payload: tuple) -> np.ndarray:
    kind = payload[0]
    if kind == "none":
        return np.asarray(payload[1], dtype=np.float32)
    if kind == "bf16":
        bits = np.asarray(payload[1], dtype=np.uint16).astype(np.uint32)
        return (bits << 16).view(np.float32)
    if kind == "int8":
        q, scale = payload[1], payload[2]
        return q.astype(np.float32) * scale
    raise ValueError(f"unknown codec payload kind {kind!r}")


def payload_nbytes(payload: tuple) -> int:
    return sum(p.nbytes for p in payload[1:] if hasattr(p, "nbytes"))


# -- one shard's row store ---------------------------------------------------

class TableShardServer:
    """Row store for one contiguous range of one or more tables: per table,
    family name -> [rows, D_family] float32 (``param`` and the row-aligned
    optimizer state, ``moment1`` and ``moment2`` for lazy Adam). Pushes
    overwrite; a push id applied before is refused (``applied`` holds
    them)."""

    def __init__(self, shard_id: int):
        self.shard_id = int(shard_id)
        self._tables: Dict[str, Dict[str, np.ndarray]] = {}
        self._rows_of: Dict[str, int] = {}
        self.applied: set = set()
        self.pushes_deduped = 0

    def load(self, table: str, values: np.ndarray,
             family: str = "param") -> None:
        """Install this shard's row block of ``table``."""
        v = np.ascontiguousarray(values, dtype=np.float32)
        fams = self._tables.setdefault(table, {})
        have = self._rows_of.setdefault(table, v.shape[0])
        if v.shape[0] != have:
            raise ValueError(f"{table}/{family}: {v.shape[0]} rows, table "
                             f"has {have}")
        fams[family] = v.copy()

    def rows(self, table: str, family: str = "param") -> np.ndarray:
        return self._tables[table][family].copy()

    def create_table(self, table: str, nrows: int) -> None:
        """Declare ``table``'s row count (idempotent), so that pushes can
        create its families."""
        have = self._rows_of.setdefault(table, int(nrows))
        if have != int(nrows):
            raise ValueError(f"{table}: declared {nrows} rows, shard holds "
                             f"{have}")

    def _pull_rows(self, table: str, local_rows: np.ndarray,
                   families: Sequence[Tuple[str, int]], codec: str):
        """{family: encoded [K, D_family]} at local rows; a family (or a
        table) never loaded or pushed comes back as zeros of the asked
        width."""
        rows = np.asarray(local_rows, dtype=np.int64)
        fams = self._tables.get(table, {})
        nrows = self._rows_of.get(table)
        if nrows is not None and rows.size and rows.max() >= nrows:
            raise IndexError(f"{table}: local rows up to {rows.max()} but "
                             f"shard {self.shard_id} holds {nrows}")
        out = {}
        for fam, width in families:
            arr = fams.get(fam)
            vals = (np.zeros((rows.size, width), dtype=np.float32)
                    if arr is None else arr[rows])
            out[fam] = encode_rows(vals, codec)
        return out

    def _push_rows(self, table: str, local_rows: np.ndarray,
                   payloads: Dict[str, tuple], push_id: Optional[str],
                   nrows: Optional[int] = None) -> bool:
        """Overwrite rows; True when applied, False when ``push_id`` was
        applied before. ``nrows`` (the range's row count) lets a push
        create a table's families."""
        if push_id is not None and push_id in self.applied:
            self.pushes_deduped += 1
            return False
        rows = np.asarray(local_rows, dtype=np.int64)
        fams = self._tables.setdefault(table, {})
        if nrows is not None:
            self._rows_of.setdefault(table, int(nrows))
        have = self._rows_of.get(table)
        for fam, payload in payloads.items():
            vals = decode_rows(payload)
            arr = fams.get(fam)
            if arr is None:
                if have is None:
                    raise ValueError(f"{table}: pushed before load() and "
                                     f"row count unknown")
                arr = fams[fam] = np.zeros((have, vals.shape[1]),
                                           dtype=np.float32)
            arr[rows] = vals
        if push_id is not None:
            self.applied.add(push_id)
        return True


# -- the trainer's side ------------------------------------------------------

class ShardedTableClient:
    """Routes global row ids to their shards: one pull and one push per
    owning shard, rows shipped sparse and encoded with ``codec``.
    ``bytes[(direction, shard)]`` counts the payload bytes that crossed
    ("pull" or "push")."""

    def __init__(self, shards: Sequence[TableShardServer], spec: ShardSpec,
                 codec: str = "none"):
        if len(shards) != spec.num_shards:
            raise ValueError(f"{len(shards)} shards for a "
                             f"{spec.num_shards}-shard spec")
        if codec not in CODECS:
            raise ValueError(f"unknown embed exchange codec {codec!r} "
                             f"(want one of {CODECS})")
        self.spec = spec
        self.shards = list(shards)
        self.codec = codec
        self.tables: List[str] = []
        self.bytes: Dict[Tuple[str, int], int] = {
            (d, s): 0 for d in ("pull", "push")
            for s in range(spec.num_shards)}
        self._push_seq = 0

    def pull_rows(self, table: str, rows,
                  families: Sequence[Tuple[str, int]]
                  ) -> Dict[str, np.ndarray]:
        """{family: [K, D_family] float32} of global ``rows``, decoded, in
        input order."""
        r = np.asarray(rows, dtype=np.int64).reshape(-1)
        out = {fam: np.empty((r.size, width), dtype=np.float32)
               for fam, width in families}
        for shard, (pos, local) in self.spec.route(r).items():
            got = self.shards[shard]._pull_rows(table, local,
                                                tuple(families), self.codec)
            for fam, payload in got.items():
                out[fam][pos] = decode_rows(payload)
                self.bytes[("pull", shard)] += payload_nbytes(payload)
        return out

    def push_rows(self, table: str, rows, values: Dict[str, np.ndarray],
                  push_id: Optional[str] = None) -> int:
        """Overwrite global ``rows`` with ``values`` ({family: [K,
        D_family]}) on their shards, one push each, with the id
        ``<push_id>/s<shard>``. Returns the shard pushes applied."""
        r = np.asarray(rows, dtype=np.int64).reshape(-1)
        if push_id is None:
            push_id = f"push-{id(self):x}-{self._push_seq}"
            self._push_seq += 1
        applied = 0
        for shard, (pos, local) in self.spec.route(r).items():
            payloads = {fam: encode_rows(np.asarray(v)[pos], self.codec)
                        for fam, v in values.items()}
            lo, hi = self.spec.bounds[shard]
            if self.shards[shard]._push_rows(table, local, payloads,
                                             f"{push_id}/s{shard}", hi - lo):
                applied += 1
            self.bytes[("push", shard)] += sum(
                payload_nbytes(p) for p in payloads.values())
        return applied

    def create_table(self, table: str) -> None:
        """Declare ``table`` on every shard with its range's row count."""
        for shard, (lo, hi) in enumerate(self.spec.bounds):
            self.shards[shard].create_table(table, hi - lo)
        if table not in self.tables:
            self.tables.append(table)

    def seed_from_value(self, table: str, value: np.ndarray,
                        push_id: Optional[str] = None) -> None:
        """Scatter a full [height, D] seed over the fleet as the ``param``
        family, in fp32 whatever the codec."""
        v = np.asarray(value, dtype=np.float32)
        if v.shape[0] != self.spec.height:
            raise ValueError(f"seed has {v.shape[0]} rows, spec wants "
                             f"{self.spec.height}")
        self.create_table(table)
        codec, self.codec = self.codec, "none"
        try:
            self.push_rows(table, np.arange(v.shape[0]), {"param": v},
                           push_id=push_id or f"seed-{table}")
        finally:
            self.codec = codec


def in_process_fleet(height: int, num_shards: int, codec: str = "none"
                     ) -> ShardedTableClient:
    """A client over ``num_shards`` fresh in-process shards of a
    ``height``-row table."""
    spec = ShardSpec(height, num_shards)
    return ShardedTableClient([TableShardServer(i) for i in range(num_shards)],
                              spec, codec=codec)
