#!/usr/bin/env python3
"""Peak memory, step time and device busy of the port's training executor
at dropout 0.1, for A/B runs of checkouts on one CUDA card.

    python3 tools/torch_dropout_memory.py ROOT [ROOT ...]

Each checkout ROOT (its ``paddle_tpu_torch`` and ``chip_smoke.py``) runs
in a process of its own, in the order given (for an A/B: parent, change,
change, parent), and prints one JSON line with two programs:

- ``noam``: Transformer-base built by ROOT's ``fluid`` builder at
  ``chip_smoke.py`` phase 25's arguments (fused attention and head, the
  Noam schedule, dropout 0.1), batch 32, on ``fluid.Executor()``;
- ``bench``: the committed ``transformer_base_train`` pair, the
  Transformer's bench program of phase 24 (d) (dropout 0.1), batch 32.

For each: 4 steps through ``Executor.run`` after the startup; the peak
memory of the 2nd step (``torch.cuda.max_memory_allocated``), the host
p50 of steps 2-4 (each ending in a synchronize), and device busy and
kernel records a step over a profiler window of one more step
(``chip_smoke.profile_calls``). Compare two checkouts only within one
call: the card's power limit is printed beside the numbers.
"""

import json
import os
import subprocess
import sys
import time

STEPS = 4


def measure(torch, cs, exe, prog, scope, feeds, fetch):
    """Peak bytes of the 2nd step, host ms of steps 2-4, device busy and
    kernel records a step over one profiled step."""
    ms, peak = [], None
    for i, feed in enumerate(feeds[:STEPS]):
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        exe.run(prog, feed=feed, fetch_list=[fetch], scope=scope)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if i == 1:
            peak = int(torch.cuda.max_memory_allocated())

    def step():
        exe.run(prog, feed=feeds[STEPS], fetch_list=[fetch], scope=scope)
        torch.cuda.synchronize()
    prof = cs.profile_calls(torch, step, 1)
    return {"peak_mem_mib_step_2": peak / 2 ** 20, "step_ms": ms[1:],
            "step_p50_ms": sorted(ms[1:])[len(ms[1:]) // 2],
            "device_busy_ms": prof["device_busy_ms_per_step"],
            "kernel_records": prof["launches_per_step"]}


def one(root):
    """The JSON line of checkout ``root``, measured in this process."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    import chip_smoke as cs
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid.models import transformer
    from paddle_tpu_torch.ops.kernels import build
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build(["flash_attention", "fused_ce"])
    dev = torch.device("cuda")
    cfg = dict(cs.TRAIN)
    out = {"root": root, "card": cs.card_line()}

    main, startup = fluid.Program(), fluid.Program()
    scope = fluid.Scope()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, _, _ = transformer.build(**dict(cfg, **cs.BUILDER_NOAM))
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    feeds = [f for f, _ in cs.program_feeds(torch, dev, "transformer", cfg,
                                            cs.BATCH, cs.BUILDER_SEED,
                                            STEPS + 1)]
    out["noam"] = measure(torch, cs, exe, main, scope, feeds, loss.name)
    del main, startup, scope
    torch.cuda.empty_cache()

    main, startup = cs.train_pair("transformer_base_train")
    startup.random_seed = cs.TRAIN_PROGRAM_SEED
    scope = fluid.Scope()
    exe.run(fluid.Program(startup), scope=scope)
    feeds = [f for f, _ in cs.program_feeds(torch, dev, "transformer", cfg,
                                            cs.BATCH, 80, STEPS + 1)]
    out["bench"] = measure(torch, cs, exe, fluid.Program(main), scope,
                           feeds, cs.TRAIN_PROGRAM_LOSS)
    print(json.dumps(out), flush=True)


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        one(sys.argv[2])
        return
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    rc = 0
    for root in sys.argv[1:]:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", root]).returncode
    sys.exit(rc)


if __name__ == "__main__":
    main()
