#!/usr/bin/env python3
"""Host time of the fp32 ResNet-50 training program's step through the
executor of a given checkout, so that two checkouts can be compared on
one card in one call.

Run on a machine with one CUDA card, once per checkout, in turns
(parent, change, change, parent) inside one command:

    python3 tools/torch_program_host_ab.py PATH_TO_CHECKOUT [BATCH ...]

It imports ``paddle_tpu_torch`` from that checkout and the builder
helpers from this checkout's ``chip_smoke.py`` (``build_program``,
``image_feeds``, ``card_line``). For each batch (8 and 128 by default:
8 leaves the host's dispatch exposed, 128 is ``bench.py``'s ResNet-50
row) it builds ``resnet`` (depth 50, 224 px, no rewrite: every op
untagged), runs the startup program at seed 1, takes 5 warm steps and
then 30 timed ones on seeded batches made on the card, each
``Executor.run`` fetching the loss as a tensor: ``dispatch`` is the time
until ``run`` returns (the host's work a step, the card still busy),
``step`` the time until the card is done too. Where the checkout's
emitters read AMP and NHWC tags (``policy_of``, ``nhwc_in``,
``nhwc_out``), it also counts their calls in one more step and times
each on the untagged attributes of the program's first ``conv2d``
(100000 calls): ``tag_reads``, the host's cost of reading the tags a
step. It prints one JSON line: the checkout, the card, and by batch the
medians and every step's times in ms, and ``tag_reads``.
"""

import json
import os
import sys
import time
import timeit

WARM, STEPS = 5, 30
TAG_READERS = ("policy_of", "nhwc_in", "nhwc_out")


def tag_reads(torch, main_prog, step):
    """{reader: (calls in one ``step()``, us a call on an untagged op)}
    for each tag reader the checkout has, or None where it has none."""
    from paddle_tpu_torch.contrib import mixed_precision as mp
    from paddle_tpu_torch.ops import nn_ops
    if not hasattr(mp, "policy_of"):
        return None
    real = {"policy_of": mp.policy_of, "nhwc_in": nn_ops.nhwc_in,
            "nhwc_out": nn_ops.nhwc_out}
    calls = dict.fromkeys(TAG_READERS, 0)

    def counted(name):
        def fn(*a):
            calls[name] += 1
            return real[name](*a)
        return fn
    # the emitters' modules hold the readers by name
    mods = [m for k, m in list(sys.modules.items())
            if k.startswith("paddle_tpu_torch.") and m is not None]
    patched = [(m, name) for m in mods for name in TAG_READERS
               if getattr(m, name, None) is real[name]]
    for m, name in patched:
        setattr(m, name, counted(name))
    try:
        step()
    finally:
        for m, name in patched:
            setattr(m, name, real[name])
    attrs = next(op.attrs for op in main_prog.desc.global_block.ops
                 if op.type == "conv2d")
    x = torch.empty(1, 1, 1, 1)
    args = {"policy_of": ("conv2d", attrs), "nhwc_in": (x, attrs),
            "nhwc_out": (x, attrs)}
    n = 100000
    return {name: (calls[name], timeit.timeit(
        lambda f=real[name], a=args[name]: f(*a), number=n) / n * 1e6)
        for name in TAG_READERS}


def main():
    root = os.path.abspath(sys.argv[1])
    batches = [int(b) for b in sys.argv[2:]] or [8, 128]
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[:0] = [root, here]
    import numpy as np
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch import fluid
    if not fluid.__file__.startswith(root):
        raise SystemExit(f"paddle_tpu_torch came from {fluid.__file__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    out = {"checkout": root, "card": cs.card_line(), "batches": {}}
    for batch in batches:
        main_prog, startup, loss = cs.build_program("resnet", {})
        startup.random_seed = 1
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(startup, scope=scope)
        feeds = [{"data": x, "label": y} for x, y in cs.image_feeds(
            torch, dev, batch, (3, 224, 224), 1000, 7, WARM + STEPS)]
        dispatch, step = [], []
        for i, f in enumerate(feeds):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            exe.run(main_prog, feed=f, fetch_list=[loss], scope=scope,
                    return_numpy=False)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if i >= WARM:
                dispatch.append((t1 - t0) * 1e3)
                step.append((t2 - t0) * 1e3)
        out["batches"][batch] = {
            "dispatch_p50_ms": float(np.median(dispatch)),
            "step_p50_ms": float(np.median(step)),
            "dispatch_ms": dispatch, "step_ms": step,
            "tag_reads": tag_reads(torch, main_prog, lambda: exe.run(
                main_prog, feed=feeds[-1], fetch_list=[loss], scope=scope))}
        del main_prog, startup, scope, exe, feeds
        torch.cuda.empty_cache()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
