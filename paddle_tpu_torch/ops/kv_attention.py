"""KV-cache attention and on-device token sampling: the serving ops of
the decoder LM (counterpart of ``paddle_tpu/ops/kv_attention.py``), for
both KV layouts: prefill, decode and the speculative verify window.

Same numerics as the JAX emitters: every dot accumulates in fp32 and is
cast back to the compute dtype, the softmax runs in fp32 over scores
masked with the finite ``NEG``, and the probabilities are cast to the
compute dtype before they meet V.

The contiguous layout keeps each slot's cache as one ``[S, H, D]`` row of
a ``[n, S, H, D]`` fp32 tensor per layer (``n`` the slot pool, or the
batch of a wave); the ops attend over it as it lies, with no gather. The
paged pools are ``[n_pages, page_size, H, D]`` per layer, stored as
fp32, bf16 or int8 codes with one fp32 scale per (position, head);
logical cache position ``j`` of slot ``b`` lives at flat row
``table[b, j // ps] * ps + j % ps``.

Unlike the JAX ops, which return new caches, these update them IN PLACE
(``index_copy_``), as the donated buffers of the JAX executable are in
effect. Both layouts write through flat row indices, and rows outside
the cache are DROPPED: in the paged pool a sentinel row marks a prefix
page shared with another request, or an inactive slot, and writing it
would break the copy-on-write contract of ``serving/kv_pool.py``; the
contiguous cache is the paged rule with one page of ``S`` rows a slot,
so a free slot's ``pos = -1`` or a window running past ``S`` drops
instead of wrapping onto a neighbouring row.

The per-step geometry (which rows each slot writes, which positions it
may attend to, and, paged, which rows it reads) is computed once per
step by :func:`slot_geometry` or :func:`verify_geometry` (a speculative
window of K+1 tokens a slot; a decode step is the window of one) and
shared by every layer; where the caller's index tensors lie on the CPU,
it is computed there and moved to the cache's device in one copy each,
so no layer waits on the device.

The eight op types of the serving programs (``kv_attention_prefill``,
``_prefill_slot``, ``_decode``, ``_verify``, ``_prefill_paged``,
``_decode_paged``, ``_verify_paged``, ``token_sample``) are registered at
the end over the same functions. An op is one layer, and its feeds lie
on the executor's device already, so each emitter computes its index sets
there and drops out-of-pool writes with :meth:`RowWrite.on_device`, which
reads nothing on the host: the rows are redirected onto a row the step
writes with the same value (or onto one row with its own bits), never
filtered.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.registry import first, register_op
from paddle_tpu_torch.ops import attention_block as _ab
from paddle_tpu_torch.ops.kernels import paged_attention as _pk

_MASK32 = 0xFFFFFFFF


def scores_to_probs(s: torch.Tensor, mask: torch.Tensor,
                    dt: torch.dtype) -> torch.Tensor:
    """fp32 scaled scores -> compute-dtype probabilities
    (kv_attention.py:82 ``_scores_to_probs``)."""
    s = s.masked_fill(~mask, _ab.NEG)
    return torch.softmax(s, dim=-1).to(dt)


def causal_prefill(x, wq, wk, wv, wo, h: int):
    """Causal self-attention over X [B,T,M] plus the K/V projections
    [B,T,H,D] the caller caches (kv_attention.py:90)."""
    b, t, m = x.shape
    d = m // h
    dt = x.dtype
    q = _ab.proj(x, wq, h)
    k = _ab.proj(x, wk, h)
    v = _ab.proj(x, wv, h)
    s = _ab.dot("bqhd,bkhd->bhqk", q, k) * (float(d) ** -0.5)
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    p = scores_to_probs(s, causal, dt)
    c = _ab.dot("bhqk,bkhd->bhqd", p, v).to(dt)
    out = _ab.dot("bhqd,hdm->bqm", c, wo.view(h, d, m)).to(dt)
    return out, k, v


def kv_quant(rows: torch.Tensor):
    """rows [..., H, D] fp32 -> (int8 codes, fp32 scales [..., H]):
    symmetric per-(position, head) scaling (kv_attention.py:216)."""
    amax = rows.abs().amax(dim=-1)
    scale = amax.clamp_min(1e-30) / 127.0
    q = torch.clamp(torch.round(rows / scale[..., None]), -127.0, 127.0)
    return q.to(torch.int8), scale.to(torch.float32)


def paged_gather(flat: torch.Tensor, scales: Optional[torch.Tensor],
                 rows: torch.Tensor, h: int, dt: torch.dtype) -> torch.Tensor:
    """Gather K/V rows through page-table row indices: flat [R, H, D]
    storage (fp32 | bf16 | int8 codes), scales [R, H] fp32 or None, rows
    [N] int32 (rows >= R clamp to the last pool row; the mask zeroes
    them). Returns [N, H, D] in ``dt`` (kv_attention.py:227). Always
    through the kernel wrappers: CUDA pools launch the kernels."""
    r, _, dk = flat.shape
    if scales is not None:
        out = _pk.gather_rows_dequant(flat.view(r, h * dk), scales, rows, h)
    else:
        out = _pk.gather_rows(flat.view(r, h * dk), rows)
    return out.view(-1, h, dk).to(dt)


def paged_pools(page_k, page_v, page_ks, page_vs, codec: str):
    """Flat views of the paged pools (kv_attention.py:256): [R, H, D]
    K/V and, for int8, [R, H] scales. Views share storage, so writes
    through them land in the pools."""
    n_pages, ps, h, dk = page_k.shape
    rtot = n_pages * ps
    fks = fvs = None
    if codec == "int8":
        fks, fvs = page_ks.view(rtot, h), page_vs.view(rtot, h)
    return page_k.view(rtot, h, dk), page_v.view(rtot, h, dk), fks, fvs


class RowWrite(NamedTuple):
    """Which computed rows land where: ``vals[src]`` -> pool rows
    ``dst``. With ``keep`` None every entry writes; else an entry whose
    ``keep`` is False writes back the bits its row already holds (the
    drop of :meth:`on_device`)."""
    src: torch.Tensor
    dst: torch.Tensor
    keep: Optional[torch.Tensor] = None

    @classmethod
    def of(cls, rows: torch.Tensor, n_rows: int,
           device: torch.device) -> "RowWrite":
        """Drop the rows outside ``[0, n_rows)`` (scatter mode="drop",
        kv_attention.py:281) by filtering them out. Filtering a CUDA
        tensor waits for the device; the nn.Module views hand CPU index
        tensors (and the program ops take :meth:`on_device`)."""
        rows = rows.reshape(-1).long()
        keep = (rows >= 0) & (rows < n_rows)
        src = torch.nonzero(keep).reshape(-1)
        return cls(src.to(device), rows[keep].to(device))

    @classmethod
    def on_device(cls, rows: torch.Tensor, n_rows: int) -> "RowWrite":
        """The same drop without reading a value on the host (so it runs
        where ``rows`` lies, meta tensors too, with no wait): every entry
        outside ``[0, n_rows)`` is sent to the first kept entry's row with
        that entry's value, so the row is written twice with one value;
        when no entry is kept, all go to one row and write back its own
        bits. A dropped row stays bit-unchanged either way."""
        rows = rows.reshape(-1).long()
        keep = (rows >= 0) & (rows < n_rows)
        first = torch.argmax(keep.to(torch.int32))      # 0 when none
        src = torch.where(keep, torch.arange(rows.numel(),
                                             device=rows.device), first)
        return cls(src, rows.clamp(0, n_rows - 1)[src], keep[src])


def paged_write(flat: torch.Tensor, fscale: Optional[torch.Tensor],
                write: RowWrite, vals: torch.Tensor, codec: str):
    """Scatter K/V rows (and int8 scales) into the flat pools in place
    (kv_attention.py:274). ``vals`` [N, H, D]; ``vals[write.src]`` is
    stored at rows ``write.dst`` (where ``write.keep`` is False, the
    row's own bits)."""
    vals = vals[write.src]
    keep = write.keep
    if codec == "int8":
        codes, scale = kv_quant(vals.to(torch.float32))
        if keep is not None:
            codes = torch.where(keep[:, None, None], codes,
                                flat[write.dst])
            scale = torch.where(keep[:, None], scale, fscale[write.dst])
        flat.index_copy_(0, write.dst, codes)
        fscale.index_copy_(0, write.dst, scale)
    else:
        vals = vals.to(flat.dtype)
        if keep is not None:
            vals = torch.where(keep[:, None, None], vals, flat[write.dst])
        flat.index_copy_(0, write.dst, vals)


class VerifyGeometry(NamedTuple):
    """One decode or verify step's index sets, shared by every layer."""
    rows: Optional[torch.Tensor]  # [B * S] int32 gather rows (sentinels
    #                               >= R); None for the contiguous cache
    valid: torch.Tensor      # [B, K1, S] bool: positions each window
    #                          position attends to (causal in the window)
    write: RowWrite          # the window's K/V rows, [B * K1] flattened


def _window(pos, seq_len, gen_start, active, win_len, k1: int, s_len: int):
    """The window's logical write positions ``wp`` [B, K1] (``pos + i``),
    where a write is allowed ``ok`` [B, K1] (an active slot, ``i <
    win_len``, ``wp < s_len``) and the attention mask ``valid`` [B, K1,
    S]: window position i attends over {j < seq_len} U {gen_start <= j <=
    pos + i} (kv_attention.py:437-452), causal inside the window."""
    pos = pos.reshape(-1).long()
    lens = seq_len.reshape(-1).long()
    gen0 = gen_start.reshape(-1).long()
    act = active.reshape(-1) > 0
    i = torch.arange(int(k1), device=pos.device)
    wp = pos[:, None] + i[None, :]                          # [B, K1]
    ok = act[:, None] & (wp < s_len)
    if win_len is not None:
        ok &= i[None, :] < win_len.reshape(-1, 1).long()
    s = torch.arange(s_len, device=pos.device)
    valid = (s[None, None, :] < lens[:, None, None]) | (
        (s[None, None, :] >= gen0[:, None, None])
        & (s[None, None, :] <= wp[:, :, None]))
    return wp, ok, valid


def verify_geometry(page_table, pos, seq_len, gen_start, active, win_len,
                    k1: int, n_pages: int, page_size: int,
                    device: torch.device,
                    on_device: bool = False) -> VerifyGeometry:
    """The paged verify's geometry (kv_attention.py:510-527) from the
    step's feeds: PageTable [B, MP] int (sentinel n_pages past a slot's
    span), Pos/SeqLen/GenStart/Active/WinLen [B] or [B, 1] int (WinLen
    None: all ``k1`` positions), and the window length ``k1``. Window
    position ``i`` writes logical position ``pos + i`` through the page
    table where the slot is active, ``i < win_len`` and ``pos + i`` lies
    inside the table's span, else the sentinel (the write drops; a free
    slot's pages stay bit-identical); it attends over {j < seq_len} U
    {gen_start <= j <= pos + i}. A decode step is the window of one
    (``k1`` 1, kv_attention.py:346-383). Computed where the feeds lie,
    then moved to ``device``; with ``on_device`` (the program ops, whose
    feeds lie on the pools' device already) the writes drop by
    :meth:`RowWrite.on_device` and nothing moves."""
    table = page_table.long()
    b, mp = table.shape
    ps = int(page_size)
    rtot = int(n_pages) * ps
    wp, ok, valid = _window(pos, seq_len, gen_start, active, win_len, k1,
                            mp * ps)
    wpage = table.gather(1, (wp // ps).clamp(0, mp - 1))
    wrow = torch.where(ok, wpage * ps + wp % ps, torch.full_like(wp, rtot))
    j = torch.arange(ps, device=table.device)
    rows = (table[:, :, None] * ps + j).reshape(-1).to(torch.int32)
    if on_device:
        return VerifyGeometry(rows, valid, RowWrite.on_device(wrow, rtot))
    return VerifyGeometry(rows.to(device), valid.to(device),
                          RowWrite.of(wrow, rtot, device))


def slot_geometry(pos, seq_len, gen_start, active, win_len, k1: int,
                  n: int, cache_len: int, device: torch.device,
                  on_device: bool = False) -> VerifyGeometry:
    """The contiguous cache's decode or verify geometry (kv_attention.py:
    194-206, :437-452) for the ``[n, cache_len, H, D]`` cache whose row
    ``b`` serves batch row ``b``: the feeds as in
    :func:`verify_geometry`, without a page table. Window position ``i``
    writes cache row ``pos + i`` of its slot where the slot is active,
    ``i < win_len`` and ``0 <= pos + i < cache_len``; every other write
    drops (a free slot's ``pos`` is -1), so no write wraps onto another
    slot's row. The flat write row is ``b * cache_len + pos + i``: the
    paged rule with one page of ``cache_len`` rows a slot. Computed where
    the feeds lie, then moved to ``device`` (``on_device``: as in
    :func:`verify_geometry`)."""
    s_len = int(cache_len)
    wp, ok, valid = _window(pos, seq_len, gen_start, active, win_len, k1,
                            s_len)
    rtot = int(n) * s_len
    b = torch.arange(wp.shape[0], device=wp.device)[:, None]
    wrow = torch.where(ok & (wp >= 0), b * s_len + wp,
                       torch.full_like(wp, rtot))
    if on_device:
        return VerifyGeometry(None, valid, RowWrite.on_device(wrow, rtot))
    return VerifyGeometry(None, valid.to(device),
                          RowWrite.of(wrow, rtot, device))


def attend(q, kk, vv, valid, wo, h: int, dt: torch.dtype):
    """Masked attention of q [B,Tq,H,D] over K/V [B,S,H,D] (a contiguous
    cache as it lies, or the paged pool's gathered rows); ``valid``
    broadcasts to [B,1,Tq,S]. Returns [B,Tq,M]. Both layouts attend
    through this one function, so in fp32 they give the same bits."""
    b, _, _, d = q.shape
    m = h * d
    s = _ab.dot("bqhd,bshd->bhqs", q, kk) * (float(d) ** -0.5)
    p = scores_to_probs(s, valid, dt)
    c = _ab.dot("bhqs,bshd->bhqd", p, vv).to(dt)
    return _ab.dot("bhqd,hdm->bqm", c, wo.view(h, d, m)).to(dt)


def verify_paged_layer(x, wq, wk, wv, wo, page_k, page_v, page_ks, page_vs,
                       geom: VerifyGeometry, n_head: int,
                       codec: str) -> torch.Tensor:
    """One layer's paged decode or verify attention for the window X
    [B,K1,M] under a precomputed :class:`VerifyGeometry`: the window's
    K/V rows are written into the pools in place BEFORE the gather (so
    position i reads positions < i of its own window), then every
    position attends through the page gathers. Returns Out [B,K1,M]."""
    h = n_head
    b, k1, m = x.shape
    d = m // h
    dt = x.dtype
    flat_k, flat_v, fks, fvs = paged_pools(page_k, page_v, page_ks,
                                           page_vs, codec)
    q = _ab.proj(x, wq, h)
    k_t = _ab.proj(x, wk, h)
    v_t = _ab.proj(x, wv, h)
    paged_write(flat_k, fks, geom.write, k_t.reshape(-1, h, d), codec)
    paged_write(flat_v, fvs, geom.write, v_t.reshape(-1, h, d), codec)
    kk = paged_gather(flat_k, fks, geom.rows, h, dt).view(b, -1, h, d)
    vv = paged_gather(flat_v, fvs, geom.rows, h, dt).view(b, -1, h, d)
    return attend(q, kk, vv, geom.valid[:, None], wo, h, dt)


def kv_attention_decode_paged(x, wq, wk, wv, wo, page_k, page_v, page_table,
                              pos, seq_len, gen_start, active, n_head: int,
                              codec: str = "none", page_ks=None,
                              page_vs=None) -> torch.Tensor:
    """One-token decode over the paged pool (kv_attention.py:323): X
    [B,1,M], Wq..Wo [M,M], PageK/PageV [n_pages, ps, H, Dk] (+ PageKS/
    PageVS [n_pages, ps, H] for int8), PageTable [B, MP], Pos/SeqLen/
    GenStart/Active [B,1]. The verify window of one: writes the step's
    K/V at Pos where active (pools updated in place) and attends over
    {j < seq_len} U {gen_start <= j <= pos}. Returns Out [B,1,M]."""
    return kv_attention_verify_paged(x, wq, wk, wv, wo, page_k, page_v,
                                     page_table, pos, seq_len, gen_start,
                                     active, None, n_head, codec, page_ks,
                                     page_vs)


def kv_attention_verify_paged(x, wq, wk, wv, wo, page_k, page_v,
                              page_table, pos, seq_len, gen_start, active,
                              win_len, n_head: int, codec: str = "none",
                              page_ks=None, page_vs=None) -> torch.Tensor:
    """Speculative-decoding verify over the paged pool
    (kv_attention.py:462): X [B,K1,M] (each slot's last committed token
    and K drafts), Wq..Wo [M,M], the pools and PageTable as in
    :func:`kv_attention_decode_paged`, Pos/SeqLen/GenStart/Active/WinLen
    [B,1] (Pos the cache row of window position 0, WinLen the valid
    window positions, 1..K1). Writes window position i at Pos + i where
    active, i < WinLen and inside the table's span (pools updated in
    place) and attends it causally over the slot's cache and its window.
    Returns Out [B,K1,M]."""
    n_pages, ps = page_k.shape[:2]
    geom = verify_geometry(page_table, pos, seq_len, gen_start, active,
                           win_len, x.shape[1], n_pages, ps, x.device)
    return verify_paged_layer(x, wq, wk, wv, wo, page_k, page_v, page_ks,
                              page_vs, geom, n_head, codec)


def prefill_paged_layer(x, wq, wk, wv, wo, page_k, page_v, page_ks,
                        page_vs, write: RowWrite, n_head: int,
                        codec: str) -> torch.Tensor:
    """One layer's paged prefill: causal attention over X [B,T,M] whose
    K/V rows land at ``write`` (per flattened prompt position). Returns
    Out [B,T,M]; the pools are updated in place."""
    h = n_head
    flat_k, flat_v, fks, fvs = paged_pools(page_k, page_v, page_ks,
                                           page_vs, codec)
    out, k, v = causal_prefill(x, wq, wk, wv, wo, h)
    dk = flat_k.shape[2]
    paged_write(flat_k, fks, write, k.reshape(-1, h, dk), codec)
    paged_write(flat_v, fvs, write, v.reshape(-1, h, dk), codec)
    return out


def kv_attention_prefill_paged(x, wq, wk, wv, wo, page_k, page_v, rows,
                               n_head: int, codec: str = "none",
                               page_ks=None, page_vs=None) -> torch.Tensor:
    """Causal prefill whose K/V rows scatter into the paged pool at flat
    ``rows`` [B*T] (or [B*T, 1]) per prompt position; sentinel rows (>=
    n_pages * ps) skip prefix-shared pages (kv_attention.py:287).
    Returns Out [B,T,M]; the pools are updated in place."""
    n_pages, ps = page_k.shape[:2]
    write = RowWrite.of(rows, n_pages * ps, x.device)
    return prefill_paged_layer(x, wq, wk, wv, wo, page_k, page_v, page_ks,
                               page_vs, write, n_head, codec)


# -- the contiguous layout (kv_attention.py:112-213, :400-459) -------------

def _flat(cache: torch.Tensor) -> torch.Tensor:
    """[n, S, H, D] -> the [n * S, H, D] view the row writes go through
    (shares storage: writes land in the cache)."""
    n, s, h, d = cache.shape
    return cache.view(n * s, h, d)


def kv_attention_prefill(x, wq, wk, wv, wo, n_head: int, cache_len: int):
    """Causal self-attention over X [B,T,M] (kv_attention.py:117) that
    also returns fresh caches CacheK/CacheV [B, cache_len, H, D] holding
    the K/V projections in ``[:, :T]`` and zeros beyond: the wave
    engine's prefill. Returns (Out [B,T,M], CacheK, CacheV)."""
    out, k, v = causal_prefill(x, wq, wk, wv, wo, n_head)
    pad = (0, 0, 0, 0, 0, int(cache_len) - x.shape[1])
    return out, F.pad(k, pad), F.pad(v, pad)


def slot_write(slot, n: int, cache_len: int, device: torch.device,
               on_device: bool = False) -> RowWrite:
    """The rows a slot prefill writes: the WHOLE ``[cache_len, H, D]`` row
    of each ``Slot`` [B] or [B, 1] (flat rows ``slot * cache_len + j``),
    so a reused slot never leaks its earlier occupant's keys; a slot
    outside ``[0, n)`` writes nothing (``on_device``: dropped by
    :meth:`RowWrite.on_device`)."""
    s_len = int(cache_len)
    slot = slot.reshape(-1, 1).long()
    rows = slot * s_len + torch.arange(s_len, device=slot.device)
    rows = torch.where((slot >= 0) & (slot < int(n)), rows,
                       torch.full_like(rows, int(n) * s_len))
    if on_device:
        return RowWrite.on_device(rows, int(n) * s_len)
    return RowWrite.of(rows, int(n) * s_len, device)


def prefill_slot_layer(x, wq, wk, wv, wo, pool_k, pool_v, write: RowWrite,
                       n_head: int) -> torch.Tensor:
    """One layer's slot prefill: causal attention over X [B,T,M] whose
    K/V, zero-padded to the pool's ``S`` rows, overwrite the rows of
    ``write`` (:func:`slot_write`) in the fp32 pools [n, S, H, D] in
    place. Returns Out [B,T,M]."""
    s_len = pool_k.shape[1]
    out, k, v = kv_attention_prefill(x, wq, wk, wv, wo, n_head, s_len)
    h, d = k.shape[2:]
    paged_write(_flat(pool_k), None, write, k.reshape(-1, h, d), "none")
    paged_write(_flat(pool_v), None, write, v.reshape(-1, h, d), "none")
    return out


def kv_attention_prefill_slot(x, wq, wk, wv, wo, pool_k, pool_v, slot,
                              n_head: int) -> torch.Tensor:
    """Causal prefill whose K/V rows join the pools PoolK/PoolV [n, S, H,
    D] at the per-row slot indices Slot [B, 1] (kv_attention.py:139): each
    slot's whole row is overwritten, zeros beyond T. Returns Out [B,T,M];
    the pools are updated in place."""
    n, s_len = pool_k.shape[:2]
    write = slot_write(slot, n, s_len, x.device)
    return prefill_slot_layer(x, wq, wk, wv, wo, pool_k, pool_v, write,
                              n_head)


def verify_slot_layer(x, wq, wk, wv, wo, cache_k, cache_v,
                      geom: VerifyGeometry, n_head: int) -> torch.Tensor:
    """One layer's contiguous decode or verify attention for the window X
    [B,K1,M] over the fp32 caches [B,S,H,D] under a precomputed
    :func:`slot_geometry`: the window's K/V rows are written in place
    BEFORE the attention (so position i reads positions < i of its own
    window), then every position attends over the cache as it lies, with
    no gather. Returns Out [B,K1,M]."""
    h = n_head
    q = _ab.proj(x, wq, h)
    k_t = _ab.proj(x, wk, h)
    v_t = _ab.proj(x, wv, h)
    d = q.shape[-1]
    paged_write(_flat(cache_k), None, geom.write, k_t.reshape(-1, h, d),
                "none")
    paged_write(_flat(cache_v), None, geom.write, v_t.reshape(-1, h, d),
                "none")
    return attend(q, cache_k, cache_v, geom.valid[:, None], wo, h, x.dtype)


def kv_attention_decode(x, wq, wk, wv, wo, cache_k, cache_v, pos, seq_len,
                        gen_start, active, n_head: int) -> torch.Tensor:
    """One-token decode over the contiguous caches (kv_attention.py:166):
    X [B,1,M], Wq..Wo [M,M], CacheK/CacheV [B,S,H,D] fp32, Pos/SeqLen/
    GenStart/Active [B,1]. The verify window of one: writes the step's
    K/V at Pos where active (caches updated in place; a Pos outside the
    cache writes nothing) and attends over {j < seq_len} U {gen_start <=
    j <= pos}. Returns Out [B,1,M]."""
    return kv_attention_verify(x, wq, wk, wv, wo, cache_k, cache_v, pos,
                               seq_len, gen_start, active, None, n_head)


def kv_attention_verify(x, wq, wk, wv, wo, cache_k, cache_v, pos, seq_len,
                        gen_start, active, win_len,
                        n_head: int) -> torch.Tensor:
    """Speculative-decoding verify over the contiguous caches
    (kv_attention.py:405): X [B,K1,M] (each row's last committed token
    and K drafts), CacheK/CacheV [B,S,H,D] fp32, Pos/SeqLen/GenStart/
    Active/WinLen [B,1] (WinLen None: all K1). Writes window position i
    at row Pos + i where active, i < WinLen and Pos + i < S (caches
    updated in place) and attends it causally over the row's cache and
    its window. Returns Out [B,K1,M]."""
    n, s_len = cache_k.shape[:2]
    geom = slot_geometry(pos, seq_len, gen_start, active, win_len,
                         x.shape[1], n, s_len, x.device)
    return verify_slot_layer(x, wq, wk, wv, wo, cache_k, cache_v, geom,
                             n_head)


def gumbel_noise(seed: torch.Tensor, step: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """[B, V] Gumbel noise from a murmur-finalizer mix of (seed, step,
    vocab index) (kv_attention.py:584-595). The JAX op reads its int64
    feeds as int32 and mixes them as uint32; here the same bits are
    carried in int64 and cut to 32 after every step (a product may
    wrap int64, and its low 32 bits survive the wrap)."""
    dev = seed.device
    seed = seed.reshape(-1).long() & _MASK32
    step = step.reshape(-1).long() & _MASK32
    j = torch.arange(vocab, dtype=torch.int64, device=dev)[None, :]
    x = ((j * 0x9E3779B9) & _MASK32) ^ ((seed * 0x85EBCA6B) & _MASK32)[:, None]
    x = x ^ ((step * 0x27D4EB2F) & _MASK32)[:, None]
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & _MASK32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & _MASK32
    x = x ^ (x >> 16)
    # uniform in (0, 1) from the 24 high bits; never exactly 0 or 1
    u = ((x >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def token_sample(logits, temperature, top_k, seed, step) -> torch.Tensor:
    """Logits [B,V], Temperature [B,1] float, TopK [B,1] int (<= 0: no
    filter; 1: argmax), Seed [B,1] int, StepIdx [B,1] int -> [B,1] int64
    (kv_attention.py:545). Rows with temperature <= 0 or top_k == 1 take
    the argmax; the others sample the temperature-scaled top-k
    distribution by Gumbel-max with :func:`gumbel_noise`."""
    v = logits.shape[-1]
    lg = logits.reshape(-1, v).to(torch.float32)
    temp = temperature.reshape(-1).to(torch.float32)
    topk = top_k.reshape(-1).long()
    greedy = torch.argmax(lg, dim=-1)
    scaled = lg / temp.clamp_min(1e-6)[:, None]
    k = topk.clamp(1, v)
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    kth = sorted_desc.gather(1, (k - 1)[:, None])
    # ties AT the kth value are all kept (as in the JAX op)
    keep = (scaled >= kth) | (topk <= 0)[:, None]
    masked = scaled.masked_fill(~keep, float("-inf"))
    sampled = torch.argmax(masked + gumbel_noise(seed, step, v), dim=-1)
    use_greedy = (temp <= 0.0) | (topk == 1)
    return torch.where(use_greedy, greedy, sampled)[:, None]


# -- the program ops (kv_attention.py:112-600) ------------------------------
#
# The emitters of the eight serving op types over the functions above, with
# the JAX ops' slots and attrs. The caches and pools are read and written
# under one var name (state of the block runner): the emitters update them
# in place and return the same tensors under the ``*Out`` slots. Every index
# set is computed where the feeds lie (the executor's device) and every
# dropped write is dropped there (``on_device``), so no layer waits on the
# device and shape inference runs them on meta tensors.

def _weights(ins):
    return [first(ins, n) for n in ("Wq", "Wk", "Wv", "Wo")]


def _paged_ins(ins, codec: str):
    """PageK, PageV and, for int8, PageKS / PageVS (else None)."""
    pk, pv = first(ins, "PageK"), first(ins, "PageV")
    if codec == "int8":
        return pk, pv, first(ins, "PageKS"), first(ins, "PageVS")
    return pk, pv, None, None


def _paged_outs(out, pk, pv, pks, pvs, codec: str):
    res = {"Out": [out], "PageKOut": [pk], "PageVOut": [pv]}
    if codec == "int8":
        res["PageKSOut"], res["PageVSOut"] = [pks], [pvs]
    return res


def _window_feeds(ins):
    return (first(ins, "Pos"), first(ins, "SeqLen"), first(ins, "GenStart"),
            first(ins, "Active"))


@register_op("kv_attention_prefill", no_grad=True,
             ref="TPU-native serving op: causal attention + KV-cache "
                 "population (kv_attention.py:112)")
def _emit_prefill(ctx, ins, attrs):
    """X [B,T,M], Wq..Wo -> Out [B,T,M] and fresh CacheK / CacheV [B,
    cache_len, H, D] (the K/V in ``[:, :T]``, zeros beyond)."""
    out, ck, cv = kv_attention_prefill(first(ins, "X"), *_weights(ins),
                                       int(attrs["n_head"]),
                                       int(attrs["cache_len"]))
    return {"Out": [out], "CacheK": [ck], "CacheV": [cv]}


@register_op("kv_attention_prefill_slot", no_grad=True,
             ref="TPU-native serving op: causal prefill into a live "
                 "[n_slots, S, H, D] pool at per-row slots "
                 "(kv_attention.py:134)")
def _emit_prefill_slot(ctx, ins, attrs):
    x = first(ins, "X")
    pk, pv = first(ins, "PoolK"), first(ins, "PoolV")
    n, s_len = pk.shape[:2]
    write = slot_write(first(ins, "Slot"), n, s_len, x.device,
                       on_device=True)
    out = prefill_slot_layer(x, *_weights(ins), pk, pv, write,
                             int(attrs["n_head"]))
    return {"Out": [out], "PoolKOut": [pk], "PoolVOut": [pv]}


def _emit_window(ins, attrs, win_len):
    """The contiguous decode and verify ops: the window X [B,K1,M] over
    CacheK / CacheV [B,S,H,D], written in place."""
    x = first(ins, "X")
    ck, cv = first(ins, "CacheK"), first(ins, "CacheV")
    n, s_len = ck.shape[:2]
    geom = slot_geometry(*_window_feeds(ins), win_len, x.shape[1], n, s_len,
                         x.device, on_device=True)
    out = verify_slot_layer(x, *_weights(ins), ck, cv, geom,
                            int(attrs["n_head"]))
    return {"Out": [out], "CacheKOut": [ck], "CacheVOut": [cv]}


@register_op("kv_attention_decode", no_grad=True,
             ref="TPU-native serving op: one-token decode over a static "
                 "KV cache with per-row geometry (kv_attention.py:161)")
def _emit_decode(ctx, ins, attrs):
    return _emit_window(ins, attrs, None)


@register_op("kv_attention_verify", no_grad=True,
             ref="TPU-native serving op: speculative-decode verify over "
                 "the contiguous KV cache (kv_attention.py:400)")
def _emit_verify(ctx, ins, attrs):
    return _emit_window(ins, attrs, first(ins, "WinLen"))


@register_op("kv_attention_prefill_paged", no_grad=True,
             ref="TPU-native serving op: causal prefill into the PAGED "
                 "pool through flat rows, sentinels dropped "
                 "(kv_attention.py:287)")
def _emit_prefill_paged(ctx, ins, attrs):
    x = first(ins, "X")
    codec = str(attrs.get("codec", "none"))
    pk, pv, pks, pvs = _paged_ins(ins, codec)
    n_pages, ps = pk.shape[:2]
    write = RowWrite.on_device(first(ins, "Rows"), n_pages * ps)
    out = prefill_paged_layer(x, *_weights(ins), pk, pv, pks, pvs, write,
                              int(attrs["n_head"]), codec)
    return _paged_outs(out, pk, pv, pks, pvs, codec)


def _emit_paged_window(ins, attrs, win_len):
    """The paged decode and verify ops: the window X [B,K1,M] through the
    page table, the pools written in place, then read by the page
    gathers."""
    x = first(ins, "X")
    codec = str(attrs.get("codec", "none"))
    pk, pv, pks, pvs = _paged_ins(ins, codec)
    n_pages, ps = pk.shape[:2]
    geom = verify_geometry(first(ins, "PageTable"), *_window_feeds(ins),
                           win_len, x.shape[1], n_pages, ps, x.device,
                           on_device=True)
    out = verify_paged_layer(x, *_weights(ins), pk, pv, pks, pvs, geom,
                             int(attrs["n_head"]), codec)
    return _paged_outs(out, pk, pv, pks, pvs, codec)


@register_op("kv_attention_decode_paged", no_grad=True,
             ref="TPU-native serving op: one-token decode over the PAGED "
                 "pool through the page table (kv_attention.py:323)")
def _emit_decode_paged(ctx, ins, attrs):
    return _emit_paged_window(ins, attrs, None)


@register_op("kv_attention_verify_paged", no_grad=True,
             ref="TPU-native serving op: speculative-decode verify over "
                 "the PAGED pool (kv_attention.py:462)")
def _emit_verify_paged(ctx, ins, attrs):
    return _emit_paged_window(ins, attrs, first(ins, "WinLen"))


@register_op("token_sample", no_grad=True,
             ref="TPU-native serving op: greedy argmax or seeded top-k "
                 "Gumbel sampling (kv_attention.py:545)")
def _emit_token_sample(ctx, ins, attrs):
    return {"Out": [token_sample(first(ins, "Logits"),
                                 first(ins, "Temperature"),
                                 first(ins, "TopK"), first(ins, "Seed"),
                                 first(ins, "StepIdx"))]}
