"""The decoder-LM serving family's geometry record (the port's copy of
``paddle_tpu/analysis/contracts.py:56-196``).

:func:`validate_geometry` normalizes and validates one view's geometry
constants, with the JAX record's defaults and errors: ``cache_len``
(``prompt_len + max_new``), ``spec_k`` (4, verify views), ``page_size``
(4), ``n_pages`` (the contiguous pool's capacity) and ``kv_codec``
(``FLAGS_kv_cache_codec``, paged views). Every view builder
(``fluid/models/transformer.py`` ``decoder_lm``) and the nn.Module
engines' geometry (``models/transformer.py`` ``validate_slots``,
``paged_geometry``) go through it, so the constants cannot drift apart.
Each call counts in ``paddle_analysis_contract_checks_total{check}``.

Not ported yet: the family verifier ``verify_family`` and its rules
(``:199-455``), ROADMAP A6.10.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

DECODER_LM_MODES = ("full", "prefill", "decode", "prefill_slot",
                    "decode_slot", "prefill_paged", "decode_paged",
                    "decode_verify", "decode_verify_paged")

_KV_CODECS = ("none", "bf16", "int8")
_STORE_DTYPES = {"none": "float32", "bf16": "bfloat16", "int8": "int8"}


def declare_metrics():
    """Get-or-create the contract-check counter (the exporters' catalog
    imports this module so a scrape shows it at zero)."""
    from paddle_tpu_torch.observability import metrics as obs_metrics
    return obs_metrics.counter(
        "paddle_analysis_contract_checks_total",
        "cross-view program-contract checks performed (geometry "
        "normalizations and family-verifier rule runs)", ("check",))


@dataclass(frozen=True)
class GeometryRecord:
    """Normalized serving-geometry constants for ONE decoder_lm view
    (``contracts.py:80``). View builders consume this record instead of
    re-deriving the constants."""

    mode: str
    prompt_len: int
    max_new: int
    cache_len: int
    n_slots: Optional[int] = None
    spec_k: Optional[int] = None          # verify views only
    page_size: Optional[int] = None       # paged views only
    n_pages: Optional[int] = None
    max_pages: Optional[int] = None       # pages of one worst-case slot
    kv_codec: Optional[str] = None
    store_dtype: Optional[str] = None

    @property
    def window(self) -> Optional[int]:
        """K+1: the verify window width, when this is a verify view."""
        return None if self.spec_k is None else self.spec_k + 1

    def as_dict(self) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in (
            "mode", "prompt_len", "max_new", "cache_len", "n_slots",
            "spec_k", "page_size", "n_pages", "max_pages", "kv_codec",
            "store_dtype")}

    # fields every view of one family must agree on (prompt_len varies
    # per bucket; spec_k/page fields compare where present)
    SHARED_FIELDS = ("cache_len", "n_slots", "spec_k", "page_size",
                     "n_pages", "kv_codec")


def validate_geometry(mode: str, prompt_len: int, max_new: int,
                      cache_len: Optional[int] = None,
                      n_slots: Optional[int] = None,
                      page_size: Optional[int] = None,
                      n_pages: Optional[int] = None,
                      kv_codec: Optional[str] = None,
                      spec_k: Optional[int] = None) -> GeometryRecord:
    """Validate and normalize one view's geometry constants
    (``contracts.py:121``); raises ``ValueError`` with the JAX record's
    messages."""
    declare_metrics().labels(check="geometry").inc()
    if mode not in DECODER_LM_MODES:
        raise ValueError(f"decoder_lm mode {mode!r} not in "
                         f"{DECODER_LM_MODES}")
    if (mode.endswith("_slot") or mode.endswith("_paged")
            or mode.startswith("decode_verify")) and not n_slots:
        raise ValueError(f"mode {mode!r} needs n_slots")
    prompt_len = int(prompt_len)
    max_new = int(max_new)
    cache_len = int(cache_len) if cache_len else prompt_len + max_new
    if prompt_len > cache_len:
        raise ValueError(f"prompt_len {prompt_len} > cache_len "
                         f"{cache_len}")
    n_slots = int(n_slots) if n_slots else None

    if mode.startswith("decode_verify"):
        # K >= 1 (K = 0 is plain decode), and the K+1 window must fit
        # the generated region it could commit into
        spec_k = int(spec_k) if spec_k else 4
        if spec_k < 1:
            raise ValueError(f"spec_k {spec_k} < 1 — the verify view "
                             f"needs at least one drafted token")
        if spec_k + 1 > cache_len - prompt_len + 1:
            raise ValueError(
                f"spec_k {spec_k}: the K+1={spec_k + 1} verify window "
                f"exceeds the generated region "
                f"(cache_len {cache_len} - prompt_len {prompt_len})")
    else:
        spec_k = int(spec_k) if spec_k else None

    max_pages = store_dtype = None
    if mode.endswith("_paged"):
        from paddle_tpu_torch import flags as _flags
        page_size = int(page_size) if page_size else 4
        if cache_len % page_size:
            raise ValueError(f"page_size {page_size} must divide "
                             f"cache_len {cache_len}")
        max_pages = cache_len // page_size
        n_pages = int(n_pages) if n_pages else int(n_slots) * max_pages
        if n_pages < max_pages:
            raise ValueError(f"n_pages {n_pages} < one slot's span "
                             f"{max_pages} — no request could admit")
        kv_codec = (kv_codec if kv_codec is not None
                    else _flags.get("kv_cache_codec")) or "none"
        if kv_codec not in _KV_CODECS:
            raise ValueError(f"kv_codec {kv_codec!r} not in "
                             f"{_KV_CODECS}")
        store_dtype = _STORE_DTYPES[kv_codec]
    else:
        page_size = n_pages = kv_codec = None

    return GeometryRecord(
        mode=mode, prompt_len=prompt_len, max_new=max_new,
        cache_len=cache_len, n_slots=n_slots, spec_k=spec_k,
        page_size=page_size, n_pages=n_pages, max_pages=max_pages,
        kv_codec=kv_codec, store_dtype=store_dtype)


declare_metrics()
