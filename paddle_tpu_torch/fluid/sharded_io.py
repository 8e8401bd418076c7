"""The part of ``paddle_tpu/fluid/sharded_io.py`` that ``fluid/io.py``
needs: the CRC32 of a file, :class:`ChecksumError`, the checkpoint metric
families (the ``plain`` layout only), and :func:`is_sharded_dir`, by which
``io.load_vars`` refuses a per-shard directory (the sharded layout is
ROADMAP A6.9)."""

from __future__ import annotations

import os
import zlib

from paddle_tpu_torch.observability import metrics as _metrics

CKPT_SAVE_SECONDS = _metrics.histogram(
    "paddle_checkpoint_save_seconds",
    "Snapshot-serialization wall time (host-side write phase)",
    labelnames=("layout",))       # plain | sharded
CKPT_RESTORE_SECONDS = _metrics.histogram(
    "paddle_checkpoint_restore_seconds",
    "Checkpoint load wall time", labelnames=("layout",))
CKPT_SAVE_BYTES = _metrics.counter(
    "paddle_checkpoint_save_bytes_total",
    "Bytes of checkpoint data written", labelnames=("layout",))
CKPT_CRC_FAILURES = _metrics.counter(
    "paddle_checkpoint_crc_failures_total",
    "Files that failed their manifest CRC32 on verify/restore")

_SHARD_MANIFEST_PREFIX = "__shards_p"


class ChecksumError(IOError):
    """A file's bytes no longer match the CRC32 its manifest recorded at
    save time — torn write or bit rot. An IOError, as the reference's."""


def _crc32_file(path: str, _bufsize: int = 1 << 20) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            buf = f.read(_bufsize)
            if not buf:
                break
            crc = zlib.crc32(buf, crc)
    return crc & 0xFFFFFFFF


def is_sharded_dir(dirname: str) -> bool:
    if not os.path.isdir(dirname):
        return False
    return any(n.startswith(_SHARD_MANIFEST_PREFIX)
               for n in os.listdir(dirname))
