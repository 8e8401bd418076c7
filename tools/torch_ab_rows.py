#!/usr/bin/env python3
"""Times some of the port's kernels from a given checkout, so that two
checkouts can be compared on one card in one call.

Run on a machine with one CUDA card and nvcc, once per checkout, in
turns (parent, change, change, parent) inside one command:

    python3 tools/torch_ab_rows.py PATH_TO_CHECKOUT

It imports ``paddle_tpu_torch`` from that checkout (its kernels build
into the checkout's own ``build/``; both checkouts must share the
wrappers' signatures) and the timing, inputs and shapes from this
checkout's ``chip_smoke.py``: ``time_ms`` (CUDA events, L2 flushed before
each call), ``fce_inputs`` at Transformer-base's head (N 4096, D 512,
V 32000, label smoothing 0.1) in fp32 and bf16, and ``EMBED_POOL`` with
``ragged_lens`` for the ``fused_embedding_seq_pool`` op program's shape
(V 5000, D 128, B 128, T 100). It prints one JSON line: the card and the
median time of the fused-CE forward and backward and of the embedding
gather + pool.
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


def main():
    root = os.path.abspath(sys.argv[1])
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
        x, w, labels, g = cs.fce_inputs(torch, dev, n, d, v, 8, dt)
        _, lse = fc.fused_ce_fwd(x, w, labels, 0.1)
        out[f"fused_ce_fwd_{name}_ms"] = cs.time_ms(
            torch, lambda: fc.fused_ce_fwd(x, w, labels, 0.1), flush, n=20)
        out[f"fused_ce_bwd_{name}_ms"] = cs.time_ms(
            torch, lambda: fc.fused_ce_bwd(x, w, labels, lse, g, 0.1), flush,
            n=20)
    rng = np.random.RandomState(16)
    vv, dd, b, t = cs.EMBED_POOL
    table = torch.from_numpy(rng.randn(vv, dd).astype(np.float32)).to(dev)
    ids = torch.from_numpy(rng.randint(0, vv, (b, t))).to(dev)
    lens = torch.from_numpy(cs.ragged_lens(rng, b, t)).to(dev)
    out["embed_pool_us"] = cs.time_ms(
        torch, lambda: ep.fused_embed_seq_pool(table, ids, lens), flush) * 1e3
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
