#!/usr/bin/env python3
"""Times variants of the tensor-core flash-attention forward against each
other on one NVIDIA GPU, in one process.

Run from the root of a checkout, on a machine with one CUDA card and nvcc:

    python3 tools/torch_flash_fwd_variants.py

Each variant is a copy of ``paddle_tpu_torch/csrc`` with a few lines of
``flash_attention.cuh`` replaced (``VARIANTS``; ``base`` is the source as
it is), built with the flags of ``paddle_tpu_torch/ops/kernels/build.py``
into ``build/flash_fwd_variants/<name>/``, all builds at once. Each
variant's library is swapped into the port's wrapper in turn
(``flash_attention._libs``), held against ``flash_fwd_ref`` at
Transformer-base's attention shape (B*H 256, T 128, D 64; fp32 within
``chip_smoke.FLASH_FWD_TOL``, bf16 within ``chip_smoke.low_tol``) and timed
by device time a call (``chip_smoke.device_ms``), full and causal, fp32
and bf16, over two rounds in turns. It prints ptxas's registers and
spills of each variant's forward kernel at head width 64, then one line a
(variant, dtype, causal): the device time of each round and whether the
output held.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

# name: [(text of flash_attention.cuh, its replacement)]
VARIANTS = {
    "base": [],
    # bf16 / fp16 at head width <= 64 capped at three blocks an SM
    "lb3_bf16": [(
        "__global__ void __launch_bounds__(kThreads, D <= 64 ? 2 : 1)\n"
        "flash_fwd_kernel(",
        "__global__ void __launch_bounds__(kThreads, Kd::kTerms == 1 && "
        "D <= 64 ? 3 : D <= 64 ? 2 : 1)\nflash_fwd_kernel(")],
    # all of S's k-steps (and p . v's) as one chunk of fragments
    "gd8": [
        ("  constexpr int kGD = kDSteps < 4 ? kDSteps : 4;",
         "  constexpr int kGD = kDSteps < 8 ? kDSteps : 8;"),
        ("  constexpr int kGK = kKSteps < 4 ? kKSteps : 4;",
         "  constexpr int kGK = kKSteps < 8 ? kKSteps : 8;")],
}


def build_variants(build):
    """{name: path of its library}, each built from an edited copy."""
    root = os.path.join(HERE, "build", "flash_fwd_variants")
    procs = {}
    for name, edits in VARIANTS.items():
        src = os.path.join(root, name)
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(build.SOURCE_DIR, src)
        header = os.path.join(src, "flash_attention.cuh")
        text = open(header).read()
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"torch_flash_fwd_variants: {name}: expected "
                                 f"one {old!r} in flash_attention.cuh")
            text = text.replace(old, new)
        with open(header, "w") as f:
            f.write(text)
        lib = os.path.join(src, "flash_attention.so")
        procs[name] = (subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", lib,
             os.path.join(src, "flash_attention.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"torch_flash_fwd_variants: {name} did not "
                             f"build:\n{out[-4000:]}")
        lines = out.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and "tc16flash_fwd" in line \
                    and "Li64" in line:
                print(name, line.split("flash_fwd_kernel")[-1][:48], "|",
                      " | ".join(x.split(":", 1)[-1].strip()
                                 for x in lines[i + 1:i + 4]
                                 if "Used" in x or "spill" in x))
        libs[name] = lib
    return libs


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_flash_fwd_variants: no CUDA device")
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from paddle_tpu_torch.ops.kernels import build
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    print(cs.card_line())
    paths = build_variants(build)
    real = fa._kernels()
    libs = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(path)
        for fn in ("paddle_flash_fwd", "paddle_flash_dq", "paddle_flash_dkv",
                   "paddle_flash_bwd"):
            getattr(lib, fn).argtypes = getattr(real, fn).argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    base = [torch.randn(256, 128, 64, generator=gen, device=dev)
            for _ in range(3)]
    res = {}
    for _ in range(2):
        for name, lib in libs.items():
            fa._libs["flash_attention"] = lib
            for dt in (torch.float32, torch.bfloat16):
                q, k, v = (x.to(dt) for x in base)
                for causal in (False, True):
                    def fn():
                        return fa.flash_fwd(q, k, v, causal, 0.125)
                    o, _ = fn()
                    want, _ = fa.flash_fwd_ref(q, k, v, causal, 0.125)
                    tol = cs.FLASH_FWD_TOL if dt == torch.float32 \
                        else cs.low_tol(torch, want)
                    held = cs.close(o.float(), want.float(), tol)
                    res.setdefault((name, str(dt).split(".")[1], causal),
                                   []).append(
                        (round(cs.device_ms(torch, fn) * 1e3, 2), held))
    fa._libs["flash_attention"] = real
    for (name, dt, causal), rounds in res.items():
        print(f"{name} {dt} causal={causal}: device us a call, held "
              f"{rounds}")


if __name__ == "__main__":
    main()
