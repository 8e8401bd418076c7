#!/usr/bin/env python3
"""Times variants of the GRU forward's cluster kernel against each other on
one NVIDIA GPU, in one process.

Run from the root of a checkout, on a machine with one CUDA card and nvcc:

    python3 tools/torch_gru_fwd_variants.py

Each variant is a copy of ``paddle_tpu_torch/csrc`` with a few lines of
``fused_rnn.cu``'s ``gru_fwd_cluster_kernel`` replaced (``VARIANTS``;
``base`` is the source as it is), built with the flags of
``paddle_tpu_torch/ops/kernels/build.py`` into
``build/gru_fwd_variants/<name>/``, all builds at once. Each variant's
library is swapped into the port's wrapper in turn (``fused_rnn._lib``),
held against ``gru_train_fwd_plain`` within ``chip_smoke.GRU_FWD_TOL`` at
the translation model's shape (T 32, B 64, H 512, ragged, from
``chip_smoke.gru_inputs``) and timed by the device time of the cluster
kernel alone (a profiler window, ``chip_smoke.kernel_split``) over four
rounds in turns. The variants measure what each barrier window's overlap
is worth: ``late_xc`` loads xproj[t]'s c column after the first barrier's
wait rather than between its arrival and its wait, ``late_xur`` loads
xproj[t + 1]'s u and r columns after the second barrier's wait, and
``late_both`` does both; and what the four warpgroups of a block are
worth: ``two_groups`` runs the block as two warpgroups (256 threads, each
multiplying half the depth's boxes), as the other cluster kernels do. It prints one line a variant: the device time of
each round, in us, and whether the outputs held.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

XC = ("    grid_arrive(count);\n"
      "    if (mine && bl < n_live) xc = x_at(t, b0, 2);\n"
      "    grid_wait(count, target += gridDim.x);\n",
      "    grid_arrive(count);\n"
      "    grid_wait(count, target += gridDim.x);\n"
      "    if (mine && bl < n_live) xc = x_at(t, b0, 2);\n")
XUR = ("    grid_arrive(count);\n"
       "    if (mine && t + 1 < t_len && bl < live[t + 1]) {\n"
       "      xu = x_at(t + 1, b0, 0);\n"
       "      xr = x_at(t + 1, b0, 1);\n"
       "    }\n"
       "    grid_wait(count, target += gridDim.x);\n",
       "    grid_arrive(count);\n"
       "    grid_wait(count, target += gridDim.x);\n"
       "    if (mine && t + 1 < t_len && bl < live[t + 1]) {\n"
       "      xu = x_at(t + 1, b0, 0);\n"
       "      xr = x_at(t + 1, b0, 1);\n"
       "    }\n")
# name: [(text of fused_rnn.cu, its replacement)]
TWO_GROUPS = [("constexpr int kGfWG = 4;", "constexpr int kGfWG = 2;")]
VARIANTS = {"base": [], "late_xc": [XC], "late_xur": [XUR],
            "late_both": [XC, XUR], "two_groups": TWO_GROUPS}


def build_variants(build):
    """{name: path of its library}, each built from an edited copy."""
    root = os.path.join(HERE, "build", "gru_fwd_variants")
    procs = {}
    for name, edits in VARIANTS.items():
        src = os.path.join(root, name)
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(build.SOURCE_DIR, src)
        path = os.path.join(src, "fused_rnn.cu")
        text = open(path).read()
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"torch_gru_fwd_variants: {name}: expected "
                                 f"one {old!r} in fused_rnn.cu")
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(src, "fused_rnn.so")
        procs[name] = (subprocess.Popen(
            [build.nvcc(), *[f for f in build.NVCC_FLAGS
                             if f not in ("-Xptxas", "-v")], "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"torch_gru_fwd_variants: {name} did not "
                             f"build:\n{out[-4000:]}")
        libs[name] = lib
    return libs


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_gru_fwd_variants: no CUDA device")
    import chip_smoke as cs
    from paddle_tpu_torch.ops.kernels import build
    from paddle_tpu_torch.ops.kernels import fused_rnn as fr
    print(cs.card_line())
    paths = build_variants(build)
    real = fr._kernels()
    libs = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(path)
        for fn in ("paddle_gru_train_fwd", "paddle_rnn_max_clusters",
                   "paddle_rnn_scratch_floats"):
            getattr(lib, fn).argtypes = getattr(real, fn).argtypes
            getattr(lib, fn).restype = getattr(real, fn).restype
        libs[name] = lib
    dev = torch.device("cuda")
    t, b, h = cs.MT["max_len"], cs.MT_BATCH, cs.MT["hid_dim"]
    ins, _, _ = cs.gru_inputs(torch, dev, t, b, h, 15)
    want = fr.gru_train_fwd_plain(*ins)
    print(f"at T {t} B {b} H {h}: {fr.rnn_kernel_for('gru_train_fwd', h, dev)}")

    def fn():
        return fr.gru_train_fwd(*ins)
    res = {}
    try:
        for _ in range(4):
            for name, lib in libs.items():
                fr._lib = lib
                held = all(cs.close(a, b, cs.GRU_FWD_TOL)
                           for a, b in zip(fn(), want))
                split = cs.kernel_split(torch, fn, n=10)
                us = 1e3 * sum(v for k, v in split.items()
                               if "gru_fwd" in k)
                res.setdefault(name, []).append((round(us, 2), held))
    finally:
        fr._lib = real
    for name, rounds in res.items():
        print(f"{name}: the cluster kernel's device us a call, held "
              f"{rounds}")


if __name__ == "__main__":
    main()
