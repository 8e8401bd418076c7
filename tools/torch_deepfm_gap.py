#!/usr/bin/env python3
"""Where two runs of deepfm's training program part: the table rows that
differ after the same steps on two sides, and the gradients behind them.

    python3 tools/torch_deepfm_gap.py [--jax] [--seeds 70 71 ...]

The committed ``tests/torch_programs/deepfm_train`` pair (vocab 100000,
26 fields, embedding 16, lazy Adam at lr 1e-3) starts from the port's
startup at ``chip_smoke.TRAIN_PROGRAM_SEED`` and trains
``chip_smoke.TRAIN_PROGRAM_ORACLE_STEPS`` steps of batch 2048 on the
batches of ``chip_smoke.program_feeds`` at each seed, as phase 24 does.
The sides:

- on a CUDA card (the default): the port's ``Executor()`` on the card
  against ``Executor(CPUPlace())``, and the card against itself (a
  second run on the same batches);
- ``--jax`` (no card needed): the JAX executor on the CPU against the
  port's ``Executor(CPUPlace())``, the pair ``tests/
  test_torch_train_programs.py`` holds at a tiny width.

For each seed and pair it prints one JSON line: ``rel``, phase 24's
check of ``deepfm_emb`` (``chip_smoke.weights_agree``: the L2 norm of
the difference over ``rtol |w| + atol sqrt(n)``; above 1 fails); the
elements that differ by more than a tenth of lr, their rows, and for
them the smallest ``|g|`` over the steps of the table's summed gradient
(one side's ``deepfm_emb@GRAD``) over the median ``|g|`` of the touched
elements of that step, and whether the two sides' gradients have
opposite signs at some step; ``near_zero_share``, the share of the
difference's squared norm that lies on elements whose smallest ``|g|``
is under 1e-3 of the median; and ``rel_without_near_zero``, the check
with those elements left out. Lazy Adam moves an element by about
``lr * sign(g)`` at its first update whatever ``|g|``, so an element whose
gradient sums to almost 0 can move by ``lr`` one way on one side and the
other way on the other. ``relu_kinks_by_step`` counts, each step, the
inputs of the deep tower's three relus on which the two sides disagree
about the sign (``kink_max_abs_x_share``, by step: the largest such
``|x|`` over its tensor's largest): such an input lies within the sums' rounding of
0, and the gradient that passes the relu on one side is cut on the
other; ``step1_table_grad_max_rel`` is the first step's largest
difference of the table's gradient over its largest element. Run from
the repository root.
"""

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

NAME = "deepfm_train"
TABLE = "deepfm_emb"
GRAD = TABLE + "@GRAD"
NEAR_ZERO = 1e-3            # |g| under this share of the step's median
# the deep tower's relu inputs (fc 400 x 3, act="relu")
PRE_RELU = ("fc_0.tmp_1", "fc_1.tmp_1", "fc_2.tmp_1")
FETCH = [cs.TRAIN_PROGRAM_LOSS, GRAD, *PRE_RELU]


def port_run(torch, place, start, feeds, persist):
    """The port's steps over ``feeds`` from the ``start`` arrays on
    ``place``: (losses, the table's gradient each step, the persistables
    after the steps, the relu inputs each step), on the host."""
    from paddle_tpu_torch import fluid
    main, _ = cs.train_pair(NAME)
    exe = fluid.Executor(place)
    scope = cs.scope_of(torch, start, exe.device)
    losses, grads, pre = [], [], []
    for f in feeds:
        f = {k: t.to(exe.device) for k, t in f.items()}
        loss, g, *x = exe.run(fluid.Program(main), feed=f, scope=scope,
                              fetch_list=FETCH)
        losses.append(float(np.asarray(loss).reshape(-1)[0]))
        grads.append(np.asarray(g))
        pre.append([np.asarray(v) for v in x])
    return losses, grads, cs.scope_arrays(scope, persist), pre


def jax_run(start, feeds, persist):
    """The JAX executor's steps on the CPU, as ``port_run``."""
    import paddle_tpu.fluid as jfluid
    from paddle_tpu.core import ir as jir
    from paddle_tpu.fluid import framework as jfw
    with open(os.path.join(REPO, "tests", "torch_programs", NAME,
                           "__main__.json"), "rb") as fh:
        desc = jir.ProgramDesc.parse_from_string(fh.read())
    p = jfw.Program()
    p.desc = desc
    p.blocks = [jfw.Block(p, i) for i in range(len(desc.blocks))]
    for b in p.blocks:
        for n, vd in b.desc.vars.items():
            b.vars[n] = jfw.Variable(b, vd)
        b.ops = [jfw.Operator(b, od) for od in b.desc.ops]
    scope = jfluid.Scope()
    for n, a in start.items():
        scope.set_var(n, a.copy())
    exe = jfluid.Executor(jfluid.CPUPlace())
    losses, grads, pre = [], [], []
    for f in feeds:
        loss, g, *x = exe.run(
            p, feed={k: t.cpu().numpy() for k, t in f.items()}, scope=scope,
            fetch_list=FETCH)
        losses.append(float(np.asarray(loss).reshape(-1)[0]))
        grads.append(np.asarray(g))
        pre.append([np.asarray(v) for v in x])
    return (losses, grads, {n: np.asarray(scope.find_var(n))
                            for n in persist}, pre)


def _rel(got, want):
    """``chip_smoke.weights_agree``'s ratio for one tensor, without its
    failure."""
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bound = (cs.CURVE_RTOL * np.linalg.norm(w)
             + cs.TRAIN_PROGRAM_ATOL * np.sqrt(w.size))
    return float(np.linalg.norm(g - w) / bound)


def compare(label, seed, a, b, lr):
    """Print one JSON line: side ``a`` against side ``b`` (each
    ``port_run``'s result), the gradients of ``b`` read as the summed
    gradient."""
    (la, ga, wa, xa), (lb, gb, wb, xb) = a, b
    wa_t, wb_t = wa[TABLE].astype(np.float64), wb[TABLE].astype(np.float64)
    bound = (cs.CURVE_RTOL * np.linalg.norm(wb_t)
             + cs.TRAIN_PROGRAM_ATOL * np.sqrt(wb_t.size))
    diff = np.abs(wa_t - wb_t)
    big = diff > lr / 10
    rows, cols = np.nonzero(big)
    # the smallest |g| over the steps where the element was touched, as a
    # share of that step's median |g| over touched elements
    ratio = np.full(diff.shape, np.inf)
    flipped = np.zeros(diff.shape, bool)
    for g_a, g_b in zip(ga, gb):
        touched = g_b != 0
        med = float(np.median(np.abs(g_b[touched]))) if touched.any() else 1.0
        r = np.where(touched, np.abs(g_b) / med, np.inf)
        ratio = np.minimum(ratio, r)
        flipped |= touched & (np.sign(g_a) != np.sign(g_b))
    near = ratio < NEAR_ZERO
    total = float(np.sum(diff ** 2))
    rest = np.where(near, 0.0, diff)
    # relu kinks: inputs of the deep tower's relus on which the two sides
    # disagree about the sign, by step, with the largest such |x| over
    # the largest |x| of its tensor
    kinks, kink_x = [], []
    for step_a, step_b in zip(xa, xb):
        n, share = 0, 0.0
        for x_a, x_b in zip(step_a, step_b):
            flip = (x_a > 0) != (x_b > 0)
            n += int(flip.sum())
            if flip.any():
                share = max(share, float(np.abs(x_b[flip]).max()
                                         / np.abs(x_b).max()))
        kinks.append(n)
        kink_x.append(share)
    g1 = np.abs(ga[0] - gb[0])
    line = {
        "pair": label, "seed": seed, "losses_a": la, "losses_b": lb,
        "relu_kinks_by_step": kinks, "kink_max_abs_x_share": kink_x,
        "step1_table_grad_max_rel": float(g1.max() / np.abs(gb[0]).max()),
        "rel": float(np.sqrt(total) / bound),
        "max_abs": float(diff.max()),
        "elements_over_lr_tenth": int(big.sum()),
        "rows_over_lr_tenth": int(np.unique(rows).size),
        "of_them_near_zero_grad": int((big & near).sum()),
        "of_them_sign_flipped": int((big & flipped).sum()),
        "their_min_grad_ratio": [float(x) for x in
                                 np.sort(ratio[big])[:8]],
        "their_abs_diff_over_lr": [float(x) for x in
                                   np.sort(diff[big])[::-1][:8] / lr],
        "near_zero_share": float(np.sum(np.where(near, diff, 0.0) ** 2)
                                 / total) if total else 0.0,
        "rel_without_near_zero": float(np.linalg.norm(rest) / bound),
        "near_zero_elements": int(near.sum()),
        "other_persistables_worst_rel": max(
            (_rel(wa[n], wb[n]) for n in wb if n != TABLE and wb[n].size),
            default=0.0),
        "rows_sample": [int(r) for r in np.unique(rows)[:12]]}
    print(json.dumps(line), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--jax", action="store_true",
                    help="the JAX executor against the port, on the CPU")
    ap.add_argument("--seeds", type=int, nargs="+",
                    default=[70, 71, 72, 73, 74, 75, 76])
    args = ap.parse_args()
    import torch
    from paddle_tpu_torch import fluid
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = cs.TRAIN_PROGRAMS[NAME]
    main_desc, startup = cs.train_pair(NAME)
    persist = sorted(n for n, v in main_desc.global_block.vars.items()
                     if v.persistable)
    startup.random_seed = cs.TRAIN_PROGRAM_SEED
    scope0 = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(fluid.Program(startup),
                                         scope=scope0)
    start = cs.scope_arrays(scope0, persist)
    lr = float(spec["cfg"]["lr"])
    cpu = torch.device("cpu")
    if not args.jax:
        print(cs.card_line(), flush=True)
    for seed in args.seeds:
        feeds = [f for f, _ in cs.program_feeds(
            torch, cpu, None, spec["cfg"], spec["batch"], seed,
            cs.TRAIN_PROGRAM_ORACLE_STEPS)]
        port_cpu = port_run(torch, fluid.CPUPlace(), start, feeds, persist)
        if args.jax:
            compare("jax_cpu-port_cpu", seed,
                    jax_run(start, feeds, persist), port_cpu, lr)
            continue
        card = port_run(torch, fluid.CUDAPlace(0), start, feeds, persist)
        compare("port_card-port_cpu", seed, card, port_cpu, lr)
        again = port_run(torch, fluid.CUDAPlace(0), start, feeds, persist)
        compare("port_card-port_card", seed, again, card, lr)


if __name__ == "__main__":
    main()
