#!/usr/bin/env python3
"""Times variants of the hot-rows cache's families kernels against each
other on one NVIDIA GPU, in one process.

Run from the root of a checkout, on a machine with one CUDA card and nvcc:

    python3 tools/torch_cache_variants.py

Each variant is a copy of ``paddle_tpu_torch/csrc`` with a few lines of
``embed_cache.cu`` replaced (``VARIANTS``; ``base`` is the source as it
is), built with the flags of ``paddle_tpu_torch/ops/kernels/build.py``
into ``build/cache_variants/<name>/``, all builds at once. Each variant's
library is swapped into the port's wrapper in turn (``embed_cache._lib``),
held bit-equal to the plain versions and timed by device time after the
L2 flush (``chip_smoke.flushed_device_ms``) over four rounds in turns, at
deepfm's cache (``chip_smoke.CACHE_ROWS``, fp32) with F 1 and F 3 families,
at K 8192 distinct slots and at phase 17's most used bucket
(``chip_smoke.CACHE_BUCKET``, padded as the cache pads it). The variants
measure how a thread best gets its row's slot: ``base`` loads it itself
(the warp's lanes read a few neighbouring slots, served by one load
through L1), ``shuffle`` has lane i load the slot of the warp's i-th row
(one coalesced load) and passes each lane its row's slot by a shuffle, as
the dequantizing page gather does; and what the row's index costs:
``div32`` divides in 32 bits where the word's index and the row's words
fit them. It prints one line a variant and shape:
the device time of each round, in us, and whether the outputs held.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

SLOT = ("  return live ? __ldg(slots + k) : 0;\n",
        "  const int kk = live ? static_cast<int>(k) : 0;\n"
        "  const int k0 = __shfl_sync(0xffffffffu, kk, 0);\n"
        "  const int k1 = __reduce_max_sync(0xffffffffu, kk);\n"
        "  const int lane = threadIdx.x & 31;\n"
        "  const int mine = k0 + lane <= k1 ? __ldg(slots + k0 + lane) : 0;\n"
        "  return __shfl_sync(0xffffffffu, mine, (kk - k0) & 31);\n")
DIV32 = ("  return e / words;\n",
         "  return ((e | words) >> 32) == 0\n"
         "      ? static_cast<long long>(static_cast<unsigned>(e) /\n"
         "                               static_cast<unsigned>(words))\n"
         "      : e / words;\n")
# name: [(text of embed_cache.cu, its replacement)]
VARIANTS = {"base": [], "shuffle": [SLOT], "div32": [DIV32]}


def build_variants(build):
    """{name: path of its library}, each built from an edited copy."""
    root = os.path.join(HERE, "build", "cache_variants")
    procs = {}
    for name, edits in VARIANTS.items():
        src = os.path.join(root, name)
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(build.SOURCE_DIR, src)
        path = os.path.join(src, "embed_cache.cu")
        text = open(path).read()
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"torch_cache_variants: {name}: expected "
                                 f"one {old!r} in embed_cache.cu")
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(src, "embed_cache.so")
        procs[name] = (subprocess.Popen(
            [build.nvcc(), *[f for f in build.NVCC_FLAGS
                             if f not in ("-Xptxas", "-v")], "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"torch_cache_variants: {name} did not "
                             f"build:\n{out[-4000:]}")
        libs[name] = lib
    return libs


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_cache_variants: no CUDA device")
    import chip_smoke as cs
    from paddle_tpu_torch.ops.kernels import build
    from paddle_tpu_torch.ops.kernels import embed_cache as ek
    print(cs.card_line())
    paths = build_variants(build)
    real = ek._kernels()
    libs = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(path)
        for fn in ("paddle_cache_gather", "paddle_cache_scatter"):
            getattr(lib, fn).argtypes = getattr(real, fn).argtypes
            getattr(lib, fn).restype = getattr(real, fn).restype
        libs[name] = lib
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    r, w = cs.CACHE_ROWS
    cases = {}
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
            cases[f"K{k}/F{n_fam}"] = (caches, g, s, rows)
    res = {}
    try:
        for _ in range(4):
            for name, lib in libs.items():
                ek._lib = lib
                for key, (caches, g, s, rows) in cases.items():
                    held = torch.equal(
                        ek.gather_rows_families(caches, g),
                        ek.gather_rows_families_ref(caches, g))
                    want = ek.scatter_rows_families_ref(
                        [c.clone() for c in caches], s, rows)
                    ek.scatter_rows_families(caches, s, rows)
                    held = held and all(torch.equal(a, b)
                                        for a, b in zip(caches, want))
                    for kind, fn in (
                            ("gather", lambda: ek.gather_rows_families(
                                caches, g)),
                            ("scatter", lambda: ek.scatter_rows_families(
                                caches, s, rows))):
                        ms = cs.flushed_device_ms(torch, fn, flush)
                        res.setdefault((name, key, kind), []).append(
                            (None if ms is None else round(ms * 1e3, 3),
                             held))
    finally:
        ek._lib = real
    for (name, key, kind), rounds in res.items():
        print(f"{name} {kind} {key}: device us a call, held {rounds}")


if __name__ == "__main__":
    main()
