#!/usr/bin/env python3
"""Times some of the port's kernels from a given checkout, so that two
checkouts can be compared on one card in one call.

Run on a machine with one CUDA card and nvcc, once per checkout, in
turns (parent, change, change, parent) inside one command:

    python3 tools/torch_ab_rows.py PATH_TO_CHECKOUT [GROUP ...]

GROUPs (all of them by default): ``fused_ce``, ``embed_pool``, ``flash``,
``forward``, ``gru_bwd_gather``, ``gru_fwd_seqpool``, ``cache``.

It imports ``paddle_tpu_torch`` from that checkout (its kernels build
into the checkout's own ``build/``; both checkouts must share the
wrappers' signatures) and the timing, inputs and shapes from this
checkout's ``chip_smoke.py``: ``time_ms`` (CUDA events, L2 flushed before
each call), ``fce_inputs`` at Transformer-base's head (N 4096, D 512,
V 32000, label smoothing 0.1) in fp32 and bf16, ``EMBED_POOL`` with
``ragged_lens`` for the ``fused_embedding_seq_pool`` op program's shape
(V 5000, D 128, B 128, T 100), and Transformer-base's attention shape (B*H
256, T 128, D 64). It prints one JSON line: the card and the median time
of the fused-CE forward and backward, of the embedding gather + pool, and
of the flash-attention backward in fp32 (full, causal) and bf16 (full)
from ``flash_function_ms``: the whole autograd backward of the checkout's
``flash_attention`` (delta included) and SDPA's backward on the same
inputs (dQ, dK and dV in one call), by CUDA events (``_us``; the host's
time too where the call's host side outlasts its device work) and by
device time from a profiler window (``_device_us``), and by device time
the checkout's ``flash_bwd`` alone (where it has none, its ``flash_dq``
and ``flash_dkv``) and SDPA's longest kernel alone (``sdpa_kernel_``).
The bf16 rows of a checkout whose kernels take fp32 only are null.
Since the forwards' redesign it also times, by events and by device time,
the checkout's flash-attention forward (``flash_fwd``) in fp32 (full,
causal), bf16 (full) and on q in bf16 with k and v in fp32 (null for a
checkout whose kernels refuse mixed dtypes) beside SDPA's forward on the
same inputs (device time; its calls are host-bound), and the LSTM forward
(``lstm_train_fwd``) at ``stacked_dynamic_lstm``'s shape (T 100, B 64,
H 512, ragged, from ``chip_smoke.lstm_inputs``). Since the GRU backward's
redesign it also times, by events and by device time, the GRU backward
(``gru_train_bwd``) at ``machine_translation``'s shape (T 32, B 64, H 512,
ragged, from ``chip_smoke.gru_inputs``; device time by kernel too) and the
dequantizing page gather (``gather_rows_dequant``) at the decode step's
shape (4096 of 4096 pool rows of 512 int8 codes, 8 heads, from
``chip_smoke.decode_rows``; device time after the same L2 flush as the
events, ``chip_smoke.flushed_device_ms``). Since the GRU forward's and the
sequence pool's redesign it also times, by events and by device time, the
GRU forward (``gru_train_fwd``) at the same shape (device time by kernel
too) and the masked sequence pool (``masked_seqpool_fwd``, SQRT) at the
text-conv classifier's pools (B 128, T 100, D 512, ragged, from
``chip_smoke.SEQPOOL`` and ``ragged_lens``; device time after the same L2
flush as the events). Since the cache kernels' redesign (group
``cache``) it also times, by events and by device time after the L2 flush,
the hot-rows cache's gather and scatter at deepfm's cache
(``chip_smoke.CACHE_ROWS``, fp32) with F 1 and F 3 families, at K 8192
distinct slots and at phase 17's most used bucket
(``chip_smoke.CACHE_BUCKET``, padded as the cache pads it): one call of
the checkout's families wrappers, or, in a checkout without them, one
call of its single-family wrapper a family, as its cache made them; and
the page gather (``gather_rows``, fp32) at the decode step's shape.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def smoke():
    """This checkout's ``chip_smoke`` module, by its path."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


GROUPS = ("fused_ce", "embed_pool", "flash", "forward", "gru_bwd_gather",
          "gru_fwd_seqpool", "cache")


def main():
    root = os.path.abspath(sys.argv[1])
    groups = sys.argv[2:] or list(GROUPS)
    if set(groups) - set(GROUPS):
        raise SystemExit(f"torch_ab_rows: groups are {GROUPS}")
    cs = smoke()
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from paddle_tpu_torch.ops.kernels import embed_pool as ep
    from paddle_tpu_torch.ops.kernels import fused_ce as fc
    if not torch.cuda.is_available():
        raise SystemExit("torch_ab_rows: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    out = {"checkout": root, "card": cs.card_line()}
    n, d, v = (cs.BATCH * cs.TRAIN["max_len"], cs.TRAIN["d_model"],
               cs.TRAIN["tgt_vocab"])
    for name, dt in (("fp32", None), ("bf16", torch.bfloat16)):
        if "fused_ce" not in groups:
            break
        x, w, labels, g = cs.fce_inputs(torch, dev, n, d, v, 8, dt)
        _, lse = fc.fused_ce_fwd(x, w, labels, 0.1)
        out[f"fused_ce_fwd_{name}_ms"] = cs.time_ms(
            torch, lambda: fc.fused_ce_fwd(x, w, labels, 0.1), flush, n=20)
        out[f"fused_ce_bwd_{name}_ms"] = cs.time_ms(
            torch, lambda: fc.fused_ce_bwd(x, w, labels, lse, g, 0.1), flush,
            n=20)
    if "embed_pool" in groups:
        rng = np.random.RandomState(16)
        vv, dd, b, t = cs.EMBED_POOL
        table = torch.from_numpy(rng.randn(vv, dd).astype(np.float32)).to(dev)
        ids = torch.from_numpy(rng.randint(0, vv, (b, t))).to(dev)
        lens = torch.from_numpy(cs.ragged_lens(rng, b, t)).to(dev)
        out["embed_pool_us"] = cs.time_ms(
            torch, lambda: ep.fused_embed_seq_pool(table, ids, lens),
            flush) * 1e3
    for group, rows in (("flash", flash_rows), ("forward", forward_rows),
                        ("gru_bwd_gather", gru_gather_rows),
                        ("gru_fwd_seqpool", gru_fwd_seqpool_rows),
                        ("cache", cache_rows)):
        if group in groups:
            out.update(rows(cs, torch, dev, flush))
    print(json.dumps(out), flush=True)


def cache_rows(cs, torch, dev, flush):
    """Rows 12 and 13, the cache's gather and scatter, F 1 and F 3 families
    at K 8192 and at the bucket, and row 14, the page gather at the decode
    step's fp32 shape, in us: by events (``_us``) and by device time after
    the same L2 flush (``_device_us``)."""
    import numpy as np
    from paddle_tpu_torch.ops.kernels import embed_cache as ek
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    families = hasattr(ek, "gather_rows_families")

    def gather(caches, slots):
        if families:
            return ek.gather_rows_families(caches, slots)
        return [ek.gather_rows(c, slots) for c in caches]

    def scatter(caches, slots, rows):
        if families:
            return ek.scatter_rows_families(caches, slots, rows)
        return [ek.scatter_rows(c, slots, x) for c, x in zip(caches, rows)]
    out = {}
    gen = torch.Generator(device=dev).manual_seed(16)
    r, w = cs.CACHE_ROWS
    for k, live in ((cs.CACHE_K, cs.CACHE_K), cs.CACHE_BUCKET):
        for n_fam in (1, cs.CACHE_FAMILIES):
            caches = [torch.randn(r, w, generator=gen, device=dev)
                      for _ in range(n_fam)]
            distinct = torch.randperm(r - 1, generator=gen, device=dev)[
                :live].to(torch.int32)
            g = torch.full((k,), r - 1, dtype=torch.int32, device=dev)
            s = torch.full((k,), r + 1, dtype=torch.int32, device=dev)
            g[:live] = s[:live] = distinct
            rows = torch.randn(n_fam, k, w, generator=gen, device=dev)
            for kind, fn in (("gather", lambda: gather(caches, g)),
                             ("scatter", lambda: scatter(caches, s, rows))):
                key = f"cache_{kind}_K{k}_F{n_fam}"
                out[f"{key}_us"] = 1e3 * cs.time_ms(torch, fn, flush)
                ms = cs.flushed_device_ms(torch, fn, flush)
                out[f"{key}_device_us"] = None if ms is None else 1e3 * ms
    sv = cs.SERVE
    ids = torch.from_numpy(cs.decode_rows(
        np.random.RandomState(0), sv["n_slots"],
        cs.CACHE_LEN // sv["page_size"], sv["n_pages"],
        sv["page_size"])).to(dev)
    pool = torch.randn(sv["n_pages"] * sv["page_size"], cs.LM["d_model"],
                       generator=gen, device=dev)

    def page():
        return pa.gather_rows(pool, ids)
    out["gather_rows_us"] = 1e3 * cs.time_ms(torch, page, flush)
    ms = cs.flushed_device_ms(torch, page, flush)
    out["gather_rows_device_us"] = None if ms is None else 1e3 * ms
    return out


def gru_fwd_seqpool_rows(cs, torch, dev, flush):
    """Row 8, the GRU forward at the translation model's training shape,
    and row 11, the masked sequence pool (SQRT) at the text-conv
    classifier's pools, in us: by events (``_us``) and by device time
    (``_device_us``: the GRU forward's profiler window, by kernel too in
    ``gru_train_fwd_split_us``; the pool's after the same L2 flush as its
    events)."""
    import numpy as np
    from paddle_tpu_torch.ops.kernels import fused_rnn as fr
    from paddle_tpu_torch.ops.kernels import seqpool as sp
    rows = {}
    ins, _, _ = cs.gru_inputs(torch, dev, cs.MT["max_len"], cs.MT_BATCH,
                              cs.MT["hid_dim"], 15)

    def gru():
        return fr.gru_train_fwd(*ins)
    rows["gru_train_fwd_us"] = 1e3 * cs.time_ms(torch, gru, flush, n=20)
    split = cs.kernel_split(torch, gru, n=10)
    rows["gru_train_fwd_device_us"] = 1e3 * sum(split.values())
    rows["gru_train_fwd_split_us"] = {
        cs.short_name(k.replace("(anonymous namespace)::", "")): 1e3 * v
        for k, v in split.items() if v > 1e-3}
    rng = np.random.RandomState(16)
    b, t, d = cs.SEQPOOL
    x = torch.from_numpy(rng.randn(b, t, d).astype(np.float32)).to(dev)
    lens = torch.from_numpy(cs.ragged_lens(rng, b, t)).to(dev)

    def pool():
        return sp.masked_seqpool_fwd(x, lens, "SQRT")
    rows["seqpool_us"] = 1e3 * cs.time_ms(torch, pool, flush)
    ms = cs.flushed_device_ms(torch, pool, flush)
    rows["seqpool_device_us"] = None if ms is None else 1e3 * ms
    return rows


def gru_gather_rows(cs, torch, dev, flush):
    """Row 9, the GRU backward at the translation model's training shape,
    and row 15, the dequantizing page gather at the decode step's, in us:
    by events (``_us``) and by device time (``_device_us``); the GRU
    backward's device time by kernel too (``gru_train_bwd_split_us``)."""
    import numpy as np
    from paddle_tpu_torch.ops.kernels import fused_rnn as fr
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    rows = {}
    ins, cot, _ = cs.gru_inputs(torch, dev, cs.MT["max_len"], cs.MT_BATCH,
                                cs.MT["hid_dim"], 15)
    hidden, _, rh = fr.gru_train_fwd_plain(*ins)

    def gru():
        return fr.gru_train_bwd(*ins, hidden, rh, *cot)
    rows["gru_train_bwd_us"] = 1e3 * cs.time_ms(torch, gru, flush, n=20)
    split = cs.kernel_split(torch, gru, n=10)
    rows["gru_train_bwd_device_us"] = 1e3 * sum(split.values())
    rows["gru_train_bwd_split_us"] = {
        cs.short_name(k.replace("(anonymous namespace)::", "")): 1e3 * v
        for k, v in split.items() if v > 1e-3}
    g = cs.SERVE
    r = g["n_pages"] * g["page_size"]
    ids = torch.from_numpy(cs.decode_rows(
        np.random.RandomState(0), g["n_slots"],
        cs.CACHE_LEN // g["page_size"], g["n_pages"], g["page_size"])).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    codes = torch.randint(-127, 128, (r, cs.LM["d_model"]), generator=gen,
                          device=dev, dtype=torch.int32).to(torch.int8)
    scales = torch.rand(r, cs.LM["n_head"], generator=gen, device=dev) + 1e-3

    def gather():
        return pa.gather_rows_dequant(codes, scales, ids, cs.LM["n_head"])
    rows["gather_rows_dequant_us"] = 1e3 * cs.time_ms(torch, gather, flush)
    ms = cs.flushed_device_ms(torch, gather, flush)
    rows["gather_rows_dequant_device_us"] = None if ms is None else 1e3 * ms
    return rows


def forward_rows(cs, torch, dev, flush):
    """The flash forward at Transformer-base's attention shape and the LSTM
    forward at the stacked LSTM's, in us: by events (``_us``) and by device
    time (``_device_us``); SDPA's forward by device time beside the flash
    rows (``sdpa_fwd_``); null where the checkout refuses the dtypes."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import fused_rnn as fr
    heads, t = cs.TRAIN["n_head"], cs.TRAIN["max_len"]
    d = cs.TRAIN["d_model"] // heads
    gen = torch.Generator(device=dev).manual_seed(6)
    base = [torch.randn(cs.BATCH * heads, t, d, generator=gen, device=dev)
            for _ in range(3)]
    rows = {}
    for name, dts, causal in (
            ("fp32_full", (torch.float32,) * 3, False),
            ("fp32_causal", (torch.float32,) * 3, True),
            ("bf16_full", (torch.bfloat16,) * 3, False),
            ("mixed_q_bf16_full", (torch.bfloat16, torch.float32,
                                   torch.float32), False)):
        q, k, v = (x.to(dt) for x, dt in zip(base, dts))

        def ours():
            return fa.flash_fwd(q, k, v, causal, d ** -0.5)

        def lib():
            return F.scaled_dot_product_attention(
                *(x.view(cs.BATCH, heads, t, d) for x in (q, k, v)),
                is_causal=causal)
        try:
            ours()
        except ValueError:          # a parent that refuses these dtypes
            rows.update({f"flash_fwd_{name}_us": None,
                         f"flash_fwd_{name}_device_us": None})
            continue
        rows[f"flash_fwd_{name}_us"] = 1e3 * cs.time_ms(torch, ours, flush)
        rows[f"flash_fwd_{name}_device_us"] = 1e3 * cs.device_ms(torch, ours)
        if len(set(dts)) == 1:
            rows[f"sdpa_fwd_{name}_device_us"] = 1e3 * cs.device_ms(torch,
                                                                   lib)
    ins, _, _ = cs.lstm_inputs(torch, dev, cs.LSTM["max_len"],
                               cs.LSTM_BATCH, cs.LSTM["hid_dim"], 13)
    rows["lstm_train_fwd_us"] = 1e3 * cs.time_ms(
        torch, lambda: fr.lstm_train_fwd(*ins), flush, n=20)
    rows["lstm_train_fwd_device_us"] = 1e3 * cs.device_ms(
        torch, lambda: fr.lstm_train_fwd(*ins))
    return rows


def flash_rows(cs, torch, dev, flush):
    """The flash backward at Transformer-base's attention shape, per
    variant, from ``chip_smoke.flash_function_ms`` (4 rounds in turns):
    the checkout's autograd backward and SDPA's by events, and by device
    time the autograd backward, SDPA's, the checkout's backward kernel
    alone (``flash_bwd``; where it has none, its ``flash_dq`` and
    ``flash_dkv``) and SDPA's longest kernel alone, in us. A checkout
    whose kernels take fp32 only gets null bf16 rows."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    heads, t = cs.TRAIN["n_head"], cs.TRAIN["max_len"]
    d = cs.TRAIN["d_model"] // heads
    gen = torch.Generator(device=dev).manual_seed(5)
    base = [torch.randn(cs.BATCH * heads, t, d, generator=gen, device=dev)
            for _ in range(4)]
    one = getattr(fa, "flash_bwd", None)
    fp32_only = one is None                # before the one-pass kernel

    def pair(*args):
        return fa.flash_dq(*args), fa.flash_dkv(*args)
    keys = {"function_bwd_{}_us": "function", "sdpa_bwd_{}_us": "library",
            "function_bwd_{}_device_us": "function_device_ms",
            "sdpa_bwd_{}_device_us": "library_device_ms",
            "flash_bwd_{}_device_us": "flash_bwd_device_ms",
            "sdpa_kernel_{}_device_us": "library_kernel_ms"}
    rows = {}
    for name, dt, causal in (("fp32_full", torch.float32, False),
                             ("fp32_causal", torch.float32, True),
                             ("bf16_full", torch.bfloat16, False)):
        if fp32_only and dt != torch.float32:
            rows.update({key.format(name): None for key in keys})
            rows[f"sdpa_kernel_{name}"] = None
            continue
        r = cs.flash_function_ms(torch, fa, tuple(x.to(dt) for x in base),
                                 heads, causal, flush, bwd=one or pair)
        rows.update({key.format(name): 1e3 * r[src]
                     for key, src in keys.items()})
        rows[f"sdpa_kernel_{name}"] = r["library_kernel"]
    return rows


if __name__ == "__main__":
    main()
