#!/usr/bin/env python3
"""Sweep the fused-CE backward's vocabulary slab width on one CUDA card.

The backward (``paddle_tpu_torch/ops/kernels/fused_ce.py``
``fused_ce_bwd``) walks the vocabulary in slabs of ``SLAB_COLS`` columns:
per slab one launch writes dz in two layouts, one launch makes dx's and
dW's tiles from it, and a small one sums dW's partial planes. A wider slab
means fewer launches and deeper tiles, and more scratch (dz, and for fp32
its split halves). This script times the backward at each width for fp32
and bf16 at Transformer-base's head (N 4096, D 512, V 32000; the shape of
``chip_smoke.py`` phase 6), with the L2 flushed before each call, and
prints each kernel's share from a ``torch.profiler`` window.

Run from the root of a checkout on a machine with a CUDA card:

    python3 tools/fused_ce_slab_sweep.py [--widths 512,1024,2048,4096]

The last line is one JSON object with every number printed.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402  (time_ms, fce_inputs, card_line)


def kernel_name(key: str) -> str:
    """``fused_ce_dz_kernel`` from the profiler's ``void (anonymous
    namespace)::fused_ce_dz_kernel<...>(...)``."""
    key = key.replace("(anonymous namespace)::", "").replace("void ", "")
    return re.match(r"[\w:]*", key).group(0).split("::")[-1] or key


def scratch_bytes(fc, n, d, vs, elem):
    """dz [N, vs] and dz^T [vs, N] (split in two for fp32) and dW's fp32
    partial planes."""
    halves = 2 if elem == 4 else 1
    dz = 2 * halves * n * vs * elem
    return dz + fc.dw_chunks(n, vs) * d * vs * 4


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.ops.kernels import build
    from paddle_tpu_torch.ops.kernels import fused_ce as fc

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--widths", default="512,1024,2048,4096")
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--d", type=int, default=512)
    ap.add_argument("--v", type=int, default=32000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("fused_ce_slab_sweep: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build(["fused_ce"])
    dev = torch.device("cuda")
    card = chip_smoke.card_line()
    print(card)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    keep = fc.SLAB_COLS
    out = {"card": card, "shape": [args.n, args.d, args.v], "rows": []}
    for dtype in (torch.float32, torch.bfloat16):
        x, w, labels, g = chip_smoke.fce_inputs(torch, dev, args.n, args.d,
                                                args.v, 2, dtype)
        _, lse = fc.fused_ce_fwd(x, w, labels, 0.1)
        for vs in (int(s) for s in args.widths.split(",")):
            fc.SLAB_COLS = vs

            def bwd():
                return fc.fused_ce_bwd(x, w, labels, lse, g, 0.1)
            ms = chip_smoke.time_ms(torch, bwd, flush, n=10, warm=2)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    bwd()
                torch.cuda.synchronize()
            split = {}
            for ev in prof.key_averages():
                if ev.self_device_time_total > 0:
                    name = kernel_name(ev.key)
                    split[name] = split.get(name, 0.0) + \
                        ev.self_device_time_total / 3e3
            row = {"dtype": str(dtype).split(".")[-1], "slab_cols": vs,
                   "bwd_ms": ms, "kernel_ms": split,
                   "scratch_mb": scratch_bytes(fc, args.n, args.d, vs,
                                               x.element_size()) / 1e6}
            out["rows"].append(row)
            print(f"[{card}] {row['dtype']} slab {vs}: backward {ms:.3f} ms, "
                  f"dz and partial-plane scratch {row['scratch_mb']:.1f} MB; "
                  + ", ".join(f"{k} {t:.3f}" for k, t in split.items()),
                  flush=True)
    fc.SLAB_COLS = keep
    print(json.dumps(out))


if __name__ == "__main__":
    main()
