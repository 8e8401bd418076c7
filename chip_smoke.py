#!/usr/bin/env python3
"""The PyTorch port's main path on one NVIDIA GPU, end to end.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero without the
final line:

1. Device: the card's name, count and power limit (``nvidia-smi``).
   Without CUDA the script fails.
2. Build: every CUDA source of ``paddle_tpu_torch/csrc`` with ``nvcc``
   for ``sm_90a`` (one process per source, all at once), printing
   ptxas's register and spill report.
3. Kernels: each page-gather kernel at the decode shapes of phase 4
   (4096 pool rows, 4096 gathered rows, 512 wide, sentinel rows
   included) must equal its plain PyTorch version exactly. Each is
   timed with CUDA events (median per launch, L2 flushed before each
   launch as a decode step finds it), beside its plain version, one
   PyTorch library call computing the same function, and its bound:
   the bytes it must move over the card's 3.35 TB/s.
4. Slice: ``decoder_lm`` at Transformer-base width (vocab 32000,
   d_model 512, d_inner 2048, 8 heads, 6 layers; seeded random weights
   carried in through ``params_from_jax``) serves 24 requests through
   ``make_slot_model(...).generate`` over a paged pool (16 slots,
   256 pages of 16 rows, prompt buckets 32/64/128, cache_len 256), for
   ``kv_codec="none"`` and ``"int8"``. The launch counts are zeroed
   just before and read just after. Checks: fp32 greedy and sampled
   streams equal the ``full``-view recompute oracle (fp32, TF32 off;
   a divergence passes only at a near tie, top-2 gap < 1e-3), int8's
   first tokens equal the oracle's and a second int8 run replays the
   first exactly, and every decode step launched its kernel twice per
   layer.
5. Report: a ``{"kernels": [...]}`` line, then, last,
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
SOURCE = "paddle_tpu_torch/csrc/paged_attention.cu"
LM = dict(vocab=32000, d_model=512, d_inner=2048, n_head=8, n_layer=6)
SERVE = dict(n_slots=16, prompt_buckets=(32, 64, 128), page_size=16,
             n_pages=256)
CACHE_LEN = 256                    # largest bucket 128 + max_new 128
N_REQUESTS = 24
SAMPLED = (5, 11, 17, 23)          # request indices served with sampling
SAMPLING = dict(temperature=0.8, top_k=40)
NEAR_TIE = 1e-3


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


# -- phase 3: kernels -------------------------------------------------------

def decode_rows(rng, n_slots, max_pages, n_pages, page_size):
    """A decode step's gather rows: each slot's page table holds a random
    span of distinct pages, then the sentinel ``n_pages``."""
    table = np.full((n_slots, max_pages), n_pages, np.int64)
    free = list(rng.permutation(n_pages))
    for s in range(n_slots):
        span = int(rng.randint(1, max_pages + 1))
        table[s, :span] = [free.pop() for _ in range(span)]
    j = np.arange(page_size)
    return (table[:, :, None] * page_size + j).reshape(-1).astype(np.int32)


def time_ms(torch, fn, flush, n=50, warm=5):
    """Median device time of one call, L2 flushed before each."""
    for _ in range(warm):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    for a, b in ev:
        flush.zero_()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in ev]))


def kernel_phase(torch, dev, card):
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    g = SERVE
    r = g["n_pages"] * g["page_size"]
    width, heads = LM["d_model"], LM["n_head"]
    rng = np.random.RandomState(0)
    rows_np = decode_rows(rng, g["n_slots"], CACHE_LEN // g["page_size"],
                          g["n_pages"], g["page_size"])
    rows = torch.from_numpy(rows_np).to(dev)
    k = rows.shape[0]
    uniq = int(np.unique(np.minimum(rows_np, r - 1)).size)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    idx_bytes = k * 4
    results = {}

    def measure(name, fn, ref, lib, nbytes):
        got, want = fn(), ref()
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            fail(f"{name}: kernel gives {tuple(got.shape)} {got.dtype}, "
                 f"plain version {tuple(want.shape)} {want.dtype}")
        err = float((got.float() - want.float()).abs().max())
        if not torch.equal(got, want):
            fail(f"{name}: kernel differs from its plain version "
                 f"(max abs err {err})")
        if not torch.equal(lib(), want):
            fail(f"{name}: the library yardstick computes another function")
        row = {"max_abs_err": err, "ms": time_ms(torch, fn, flush),
               "plain_ms": time_ms(torch, ref, flush),
               "library_ms": time_ms(torch, lib, flush),
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
               "bound_by": "bytes", "bytes": nbytes, "distinct_rows": uniq}
        print(f"[{card}] {name}: exact; kernel {row['ms'] * 1e3:.2f} us, "
              f"plain {row['plain_ms'] * 1e3:.2f} us, library "
              f"{row['library_ms'] * 1e3:.2f} us, bound "
              f"{row['bound_ms'] * 1e3:.2f} us ({nbytes / 1e6:.2f} MB: "
              f"{uniq} distinct pool rows read)")
        return row

    for label, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        pool = torch.randn(r, width, generator=gen, device=dev).to(dt)
        row_b = width * pool.element_size()
        results[f"gather_rows/{label}"] = measure(
            f"gather_rows {label} [{r}x{width}] -> [{k}x{width}]",
            lambda: pa.gather_rows(pool, rows),
            lambda: pa.gather_rows_ref(pool, rows),
            lambda: pool.index_select(0, rows.clamp_max(r - 1)),
            uniq * row_b + idx_bytes + k * row_b)
    codes = torch.randint(-127, 128, (r, width), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.int8)
    scales = torch.rand(r, heads, generator=gen, device=dev) + 1e-3

    def dequant_lib():
        i = rows.clamp_max(r - 1)
        return (codes.index_select(0, i).float().view(k, heads, -1)
                * scales.index_select(0, i)[:, :, None]).view(k, width)
    results["gather_rows_dequant/int8"] = measure(
        f"gather_rows_dequant int8 [{r}x{width}], {heads} heads -> "
        f"[{k}x{width}] fp32",
        lambda: pa.gather_rows_dequant(codes, scales, rows, heads),
        lambda: pa.gather_rows_dequant_ref(codes, scales, rows, heads),
        dequant_lib, uniq * (width + heads * 4) + idx_bytes + k * width * 4)
    del flush
    return results


# -- phase 4: the slice -----------------------------------------------------

def random_params(seed: int) -> dict:
    """Seeded weights under the JAX scope names of decoder_lm."""
    rng = np.random.RandomState(seed)
    m, i, v = LM["d_model"], LM["d_inner"], LM["vocab"]

    def normal(shape, fan_in):
        return rng.normal(0.0, fan_in ** -0.5, shape).astype(np.float32)
    p = {"lm_emb": normal((v, m), m), "lm_head_w": normal((m, v), m),
         "lm_lnf_scale": np.ones(m, np.float32),
         "lm_lnf_bias": np.zeros(m, np.float32)}
    for layer in range(LM["n_layer"]):
        pre = f"lm_l{layer}_"
        for w in ("wq", "wk", "wv", "wo"):
            p[f"{pre}attn.{w}"] = normal((m, m), m)
        for ln in ("ln1", "ln2"):
            p[f"{pre}{ln}_scale"] = np.ones(m, np.float32)
            p[f"{pre}{ln}_bias"] = np.zeros(m, np.float32)
        p[pre + "ffn1_w"] = normal((m, i), m)
        p[pre + "ffn1_b"] = np.zeros(i, np.float32)
        p[pre + "ffn2_w"] = normal((i, m), i)
        p[pre + "ffn2_b"] = np.zeros(m, np.float32)
    return p


def requests(seed: int):
    """24 prompts (lengths 5..128; requests 0-3 share a 64-token prefix),
    their budgets (32..128), temperatures and top-k, and seeds."""
    rng = np.random.RandomState(seed)
    v = LM["vocab"]
    prefix = rng.randint(1, v, 64)
    prompts, budgets = [], []
    for n in range(N_REQUESTS):
        if n < 4:
            tail = rng.randint(1, v, int(rng.randint(1, 33)))
            prompts.append(np.concatenate([prefix, tail]))
        else:
            prompts.append(rng.randint(1, v, int(rng.randint(5, 129))))
        budgets.append(int(rng.randint(32, 129)))
    temps = [SAMPLING["temperature"] if n in SAMPLED else 0.0
             for n in range(N_REQUESTS)]
    topks = [SAMPLING["top_k"] if n in SAMPLED else 0
             for n in range(N_REQUESTS)]
    seeds = [int(s) for s in rng.randint(0, 2 ** 62, N_REQUESTS)]
    return prompts, budgets, temps, topks, seeds


def serve(torch, engine, reqs, card, label):
    """One ``generate`` over the requests, timing each admission
    (prefill) and decode step on the host clock: both end in the one
    device wait of the call, the read of its tokens."""
    prompts, budgets, temps, topks, seeds = reqs
    prefill_ms, step_ms, shared = {}, [], []
    admit, step = engine.admit, engine.step

    def timed_admit(prompt, **kw):
        t = time.perf_counter()
        out = admit(prompt, **kw)
        bucket = engine.prompt_bucket_for(len(prompt))
        prefill_ms.setdefault(bucket, []).append(
            (time.perf_counter() - t) * 1e3)
        lease = engine.pool.lease(out[0])
        shared.append(lease.n_shared if lease is not None else 0)
        return out

    def timed_step():
        t = time.perf_counter()
        out = step()
        step_ms.append((time.perf_counter() - t) * 1e3)
        return out
    engine.admit, engine.step = timed_admit, timed_step
    steps0, toks0 = engine.decode_steps, engine.tokens_generated
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        streams = engine.generate(prompts, max_new=budgets,
                                  temperature=temps, top_k=topks,
                                  seeds=seeds)
    finally:
        del engine.admit, engine.step
    wall = time.perf_counter() - t0
    steps = engine.decode_steps - steps0
    tokens = engine.tokens_generated - toks0
    for n, s in enumerate(streams):
        if s.shape != (budgets[n],) or s.min() < 0 or s.max() >= LM["vocab"]:
            fail(f"{label}: request {n} gave {s.shape} tokens in "
                 f"[{s.min()}, {s.max()}], want {budgets[n]} in "
                 f"[0, {LM['vocab']})")
    if sum(shared) == 0:
        fail(f"{label}: no admission shared a prefix page")
    stats = {"tokens": tokens, "decode_steps": steps, "wall_s": wall,
             "tokens_per_s": tokens / wall,
             "decode_step_p50_ms": float(np.median(step_ms)),
             "prefill_ms": {b: float(np.median(v))
                            for b, v in sorted(prefill_ms.items())},
             "shared_prefix_pages": int(sum(shared)),
             "peak_mem_bytes": int(torch.cuda.max_memory_allocated())}
    print(f"[{card}] {label}: {tokens} tokens in {wall:.3f} s = "
          f"{stats['tokens_per_s']:.1f} tokens/s; {steps} decode steps, "
          f"p50 {stats['decode_step_p50_ms']:.3f} ms; prefill p50 ms by "
          f"bucket {json.dumps(stats['prefill_ms'])}; "
          f"{stats['shared_prefix_pages']} prefix pages shared; peak "
          f"memory {stats['peak_mem_bytes'] / 2 ** 20:.1f} MiB")
    return streams, stats


def oracle_check(torch, lm, reqs, streams, label, first_only=False):
    """Hold each stream against the ``full`` view recomputed over the
    prompt and the stream itself (teacher forcing: if every token is
    the oracle's choice given the tokens before it, the oracle's own
    generation is the same stream). Returns the near ties accepted."""
    from paddle_tpu_torch.ops import kv_attention as kva
    prompts, _, temps, topks, seeds = reqs
    ties = 0
    for n, (prompt, stream) in enumerate(zip(prompts, streams)):
        seq = np.concatenate([prompt, stream[:-1]])
        logits = lm.full(torch.from_numpy(seq[None]))[0]
        p0 = len(prompt) - 1
        lg = logits[p0:p0 + len(stream)].double()
        steps = torch.arange(len(stream))
        if temps[n] > 0:
            scores = lg / temps[n]
            kth = scores.topk(topks[n], dim=-1).values[:, -1:]
            scores = scores.masked_fill(scores < kth, float("-inf"))
            noise = kva.gumbel_noise(torch.full_like(steps, seeds[n]),
                                     steps, lg.shape[-1])
            scores = scores + noise.to(lg)
        else:
            scores = lg
        want = scores.argmax(-1).cpu().numpy()
        n_check = 1 if first_only else len(stream)
        bad = np.flatnonzero(want[:n_check] != stream[:n_check])
        if bad.size:
            i = int(bad[0])
            top2 = scores[i].topk(2).values
            gap = float(top2[0] - top2[1])
            chosen = float(scores[i, int(stream[i])])
            if gap >= NEAR_TIE or float(top2[0]) - chosen >= NEAR_TIE:
                fail(f"{label}: request {n} token {i} is {stream[i]}, the "
                     f"oracle's is {want[i]} (top-2 gap {gap:.3g})")
            ties += 1
    return ties


def slice_phase(torch, dev, card):
    from paddle_tpu_torch.models import convert
    from paddle_tpu_torch.models.transformer import DecoderLM
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    from paddle_tpu_torch.serving.engine import make_slot_model
    lm = DecoderLM(**LM, cache_len=CACHE_LEN, device=dev)
    lm.load_state_dict(convert.params_from_jax(random_params(1)))
    engines = {codec: make_slot_model(f"decoder_lm_{codec}", lm,
                                      kv_codec=codec, device=dev, **SERVE)
               for codec in ("none", "int8")}
    for e in engines.values():
        e.warmup()
    reqs = requests(2)
    per_layer = 2 * LM["n_layer"]            # K and V in every layer
    pa.reset_launches()
    streams, stats, launches = {}, {}, {}
    for codec, kname in (("none", "gather_rows"),
                         ("int8", "gather_rows_dequant")):
        before = dict(pa.LAUNCHES)
        streams[codec], stats[codec] = serve(
            torch, engines[codec], reqs, card, f"kv_codec={codec}")
        launches[codec] = {k: pa.LAUNCHES[k] - before[k]
                           for k in pa.LAUNCHES}
    main_path_launches = dict(pa.LAUNCHES)
    for codec, kname in (("none", "gather_rows"),
                         ("int8", "gather_rows_dequant")):
        want = per_layer * stats[codec]["decode_steps"]
        if launches[codec][kname] != want:
            fail(f"kv_codec={codec}: {kname} launched "
                 f"{launches[codec][kname]} times, want {want}")
    print(f"[{card}] launches on the main path: {main_path_launches} "
          f"({per_layer} per decode step)")
    ties = oracle_check(torch, lm, reqs, streams["none"], "kv_codec=none")
    print(f"[{card}] kv_codec=none: {N_REQUESTS} streams equal the fp32 "
          f"full-view oracle ({ties} near ties)")
    ties = oracle_check(torch, lm, reqs, streams["int8"], "kv_codec=int8",
                        first_only=True)
    again, _ = serve(torch, engines["int8"], reqs, card,
                     "kv_codec=int8 replay")
    if any(not np.array_equal(a, b) for a, b in zip(streams["int8"], again)):
        fail("kv_codec=int8: a second run gave other streams")
    print(f"[{card}] kv_codec=int8: first tokens equal the oracle's "
          f"({ties} near ties); a second run replays every stream")
    return main_path_launches, per_layer


def main():
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    from paddle_tpu_torch.ops.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = card_line()
    print(f"device: {name} x{count}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    print(card)

    t = time.perf_counter()
    reports = build.build()
    for src, rep in reports.items():
        keep = [ln.strip() for ln in rep.splitlines()
                if "registers" in ln or "spill" in ln
                or "Compiling entry" in ln]
        print(f"built {src} in {time.perf_counter() - t:.1f} s:\n  "
              + "\n  ".join(keep))

    measured = kernel_phase(torch, dev, card)
    launches, per_layer = slice_phase(torch, dev, card)

    kernels = []
    for kname, key, line in (
            ("gather_rows", "gather_rows/fp32", 78),
            ("gather_rows_dequant", "gather_rows_dequant/int8", 140)):
        m = measured[key]
        kernels.append({
            "name": kname, "route": "cuda", "source": SOURCE,
            "replaces": f"paddle_tpu/ops/pallas/paged_attention.py:{line}",
            "launches": launches[kname], "max_abs_err": m["max_abs_err"],
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"],
            "kernel_us": m["ms"] * 1e3, "plain_us": m["plain_ms"] * 1e3,
            "library_us": m["library_ms"] * 1e3,
            "bound_us": m["bound_ms"] * 1e3,
            "launches_per_decode_step": per_layer, "card": card})
    bf16 = measured["gather_rows/bf16"]
    print(json.dumps({"gather_rows_bf16": bf16, "card": card}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    main()
