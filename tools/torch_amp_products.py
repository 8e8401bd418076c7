#!/usr/bin/env python3
"""How the AMP products of the PyTorch port sum on one CUDA card.

Prints, beside the card's name and power limit:

1. The smallest input of ``nn_ops.amp_product`` whose fp32 result a bf16
   result cannot hold: x [[1, 1]], y [[1], [2**-8]] (1.00390625 exactly),
   through ``amp_product`` and through a bf16 cuBLAS product.
2. The bf16 cuBLAS products of seeded normal values, [M, K] x [K, N],
   whose bf16 result moves with
   ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
   (the smallest first, by M * K * N, with |delta|), and whether
   ``amp_product`` gives the same bits under both settings.
3. The error of a product of bf16 operands against the fp64 product, as a
   share of the sum of the terms' magnitudes: cuBLAS with an fp32 result
   (the tensor cores), an fp32 product (CUDA cores, TF32 off) and a bf16
   result; the times of the three at the stacked LSTM's AMP product
   shapes (CUDA events).

    python3 tools/torch_amp_products.py
"""

from __future__ import annotations

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SHAPES = ((1, 1), (2, 2), (4, 4), (8, 8))
KS = (4096, 8192, 16384, 32768, 65536)
SEEDS = range(8)
ERROR_SHAPES = ((3200, 2048, 512, 0.03), (512, 3200, 2048, 0.03),
                (64, 2048, 64, 1.0), (64, 256, 64, 1.0))
TIMED_SHAPES = ((6400, 512, 2048), (6400, 2048, 512), (512, 6400, 2048))


def ms_per_call(torch, fn, n=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def main():
    import torch
    from paddle_tpu_torch.ops import nn_ops
    if not torch.cuda.is_available():
        raise SystemExit("torch_amp_products: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda")
    flags = torch.backends.cuda.matmul
    flags.allow_tf32 = False
    default = flags.allow_bf16_reduced_precision_reduction
    print(f"allow_bf16_reduced_precision_reduction defaults to {default}")

    x = torch.tensor([[1.0, 1.0]], device=dev)
    y = torch.tensor([[1.0], [2.0 ** -8]], device=dev)
    print(f"1. [[1, 1]] @ [[1], [2**-8]]: amp_product "
          f"{nn_ops.amp_product(x, y, False).item()!r}, bf16 cuBLAS "
          f"{(x.bfloat16() @ y.bfloat16()).item()!r}")

    moved, same = [], True
    try:
        for m, n in SHAPES:
            for k in KS:
                for seed in SEEDS:
                    gen = torch.Generator().manual_seed(seed)
                    a = torch.randn(m, k, generator=gen).to(dev)
                    b = torch.randn(k, n, generator=gen).to(dev)
                    runs = {}
                    for flag in (True, False):
                        flags.allow_bf16_reduced_precision_reduction = flag
                        runs[flag] = (a.bfloat16() @ b.bfloat16(),
                                      nn_ops.amp_product(a, b, False),
                                      nn_ops.amp_product(a, b, True))
                    delta = (runs[True][0].float()
                             - runs[False][0].float()).abs().max().item()
                    if delta:
                        moved.append((m * k * n, m, k, n, seed, delta))
                    same &= all(torch.equal(runs[True][i], runs[False][i])
                                for i in (1, 2))
    finally:
        flags.allow_bf16_reduced_precision_reduction = default
    moved.sort()
    print(f"2. {len(moved)} of {len(SHAPES) * len(KS) * len(SEEDS)} bf16 "
          f"products moved with the flag; the smallest (M, K, N, seed, "
          f"|delta|): {[row[1:] for row in moved[:10]]}; amp_product the "
          f"same bits under both settings: {same}")

    gen = torch.Generator().manual_seed(0)
    print("3. error against fp64 / sum of |terms| (max), and max |error|:")
    for m, k, n, scale in ERROR_SHAPES:
        a = (torch.randn(m, k, generator=gen) * scale).bfloat16().to(dev)
        b = torch.randn(k, n, generator=gen).bfloat16().to(dev)
        exact = a.double() @ b.double()
        mag = a.double().abs() @ b.double().abs()
        row = []
        for name, got in (
                ("fp32 result", torch.mm(a, b, out_dtype=torch.float32)),
                ("fp32 product", a.float() @ b.float()),
                ("bf16 result", a @ b)):
            err = (got.double() - exact).abs()
            row.append(f"{name} {(err / mag).max().item():.3e} "
                       f"({err.max().item():.3e})")
        print(f"   [{m}, {k}] x [{k}, {n}], |a| ~ {scale}: " + "; ".join(row))
    for m, k, n in TIMED_SHAPES:
        a32 = torch.randn(m, k, device=dev)
        b32 = torch.randn(k, n, device=dev)
        ab, bb = a32.bfloat16(), b32.bfloat16()
        times = {
            "fp32 product": ms_per_call(torch, lambda: a32 @ b32),
            "bf16 result": ms_per_call(torch, lambda: ab @ bb),
            "fp32 result": ms_per_call(
                torch, lambda: torch.mm(ab, bb, out_dtype=torch.float32))}
        print(f"   ms a call at [{m}, {k}] x [{k}, {n}]: "
              + ", ".join(f"{k_} {v:.4f}" for k_, v in times.items()))


if __name__ == "__main__":
    main()
