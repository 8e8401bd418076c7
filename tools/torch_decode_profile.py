#!/usr/bin/env python3
"""Where a decode step of the PyTorch port's paged decoder-LM serving
goes, on one CUDA card.

Builds the slice that ``chip_smoke.py`` serves (Transformer-base width:
vocab 32000, d_model 512, d_inner 2048, 8 heads, 6 layers; 16 slots over
256 pages of 16 rows, cache_len 256; seeded random weights), fills every
slot with a 64-token prompt, and traces ``--steps`` decode steps with
``torch.profiler`` after a few untraced ones. Per codec it prints the
host time per step, the device's busy time per step (the kernels' own
time, summed) and so its idle share, the kernel launches per step, and
the twelve kernels that take the most device time.

    python3 tools/torch_decode_profile.py [--steps 20] [--codecs none,int8]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--codecs", default="none,int8")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as cs
    from paddle_tpu_torch.models import convert
    from paddle_tpu_torch.models.transformer import DecoderLM
    from paddle_tpu_torch.serving.engine import make_slot_model
    if not torch.cuda.is_available():
        raise SystemExit("torch_decode_profile: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    lm = DecoderLM(**cs.LM, cache_len=cs.CACHE_LEN, device=dev)
    lm.load_state_dict(convert.params_from_jax(cs.random_params(1)))
    rng = np.random.RandomState(3)
    for codec in args.codecs.split(","):
        e = make_slot_model(f"profile_{codec}", lm, layout="paged",
                            kv_codec=codec, device=dev, **cs.SERVE)
        e.warmup()
        for _ in range(e.n_slots):
            e.admit(rng.randint(1, cs.LM["vocab"], 64), max_new=128)
        for _ in range(5):
            e.step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.steps):
                e.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [ev for ev in prof.key_averages()
                   if ev.device_type == torch.autograd.DeviceType.CUDA
                   and ev.self_device_time_total > 0]
        busy_us = sum(ev.self_device_time_total for ev in kernels)
        launches = sum(ev.count for ev in kernels)
        step_ms = wall / args.steps * 1e3
        busy_ms = busy_us / args.steps / 1e3
        print(f"[{card}] kv_codec={codec}: {args.steps} decode steps of "
              f"{e.n_slots} slots: host {step_ms:.3f} ms/step (profiler "
              f"on), device busy {busy_ms:.3f} ms/step, idle share "
              f"{1 - busy_ms / step_ms:.3f}, "
              f"{launches / args.steps:.1f} kernel launches/step")
        for ev in sorted(kernels, key=lambda ev: -ev.self_device_time_total
                         )[:12]:
            print(f"  {ev.self_device_time_total / args.steps:9.1f} us/step"
                  f"  {ev.count / args.steps:6.1f}/step  {ev.key[:90]}")
        e.reset()


if __name__ == "__main__":
    main()
