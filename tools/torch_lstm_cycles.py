#!/usr/bin/env python3
"""Where a step of the PyTorch port's whole-sequence LSTM and GRU kernels
goes, in SM cycles, on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card and nvcc:

    python3 tools/torch_lstm_cycles.py

The card's machine has no profiler that reads inside a kernel, so this
script instruments a copy of ``paddle_tpu_torch/csrc/fused_rnn.cu``: it
inserts ``clock64()`` marks, taken by thread 0 of block 0 into a device
array indexed by the time step, builds the copy with the flags of
``paddle_tpu_torch/ops/kernels/build.py`` into ``build/lstm_cycles/``, and
calls it through the port's own wrappers at T 100, B 64, H 512 with ragged
lengths (1..T, about half of the (row, step) pairs live) and with full
lengths. It prints the median cycles of one step for

- the forward (the cluster kernel, ``lstm_fwd_cluster_kernel``): the
  staged columns of the state landing, the product on the tensor cores,
  the exchange of its partial gates inside the cluster, the cell and its
  stores, the rest of the step, the grid barrier;
- the forward's grid kernel (``lstm_fwd_kernel``, which the plan picks
  above H 512; here forced by emptying the plan): the product ``h @ w``
  (and inside it: staging the carry from L2, the multiply-add loop, the
  cross-slice sums), the cell and its stores, the grid barrier;
- the backward (the cluster kernel, ``lstm_bwd_cluster_kernel``): the
  staged columns of ``h_prev`` landing, product A on the tensor cores,
  the exchange of its partial gates inside the cluster, the cell and its
  stores, the exchange of gate gradients, phase B (its rows of the
  cluster's partial of ``dgates @ w^T``), the grid barrier, the reduce of
  the clusters' partials of ``Dh``;

and, at the translation model's shape (T 32, B 64, H 512; ragged lengths
1..T from ``chip_smoke.gru_inputs``, and full lengths):

- the GRU backward (the cluster kernel, ``gru_bwd_cluster_kernel``): the
  cell and its stores, the exchange of ``dgc``, phase B (the cluster's
  partial of ``d_rh``) with the rows past their length, the first grid
  barrier (from the arrival, with the next step's u, r products, then the
  wait), the reduce of the clusters' partials of ``d_rh``, ``dgr`` and
  the exchange of ``[dgu, dgr]``, the cluster's partial of Dh, the second
  grid barrier (with the next step's c product and its cluster sync, then
  the wait), the reduce of the clusters' partials of Dh;
- the GRU forward (the cluster kernel, ``gru_fwd_cluster_kernel``): per
  phase, the staged columns (of the state in phase 1, of ``rh[t]`` in
  phase 2) landing, the product on the tensor cores (u and r; c), the
  exchange of its partials inside the cluster, the cell and its stores,
  the grid barrier (from the arrival, with the loads of the next inputs,
  to the end of the wait);

with the same numbers at the first and last steps, where a ragged batch
has most and fewest live rows. The marks are placed by matching lines of
the source (the LSTM's before its GRU section, the GRU's after it), and
the script fails if a line it looks for is gone. The marks
cost a few cycles each; the instrumented kernels are not the port's.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

T, B, H = 100, 64, 512
SLOTS = 16                         # marks a step
MAX_STEPS = 512

MARKS = (
    # (text to find, occurrences, replacement)
    ("namespace cg = cooperative_groups;\n", 1,
     "namespace cg = cooperative_groups;\n"
     "__device__ long long g_dbg[%d];\n__device__ int g_t;\n"
     "#define ME (blockIdx.x == 0 && threadIdx.x == 0)\n"
     "#define MARK(i) if (ME) g_dbg[t * %d + (i)] = clock64();\n"
     "#define MARKT(i) if (ME) g_dbg[g_t * %d + (i)] = clock64();\n"
     % (SLOTS * MAX_STEPS, SLOTS, SLOTS)),
    # forward: top of a step, after the product, around the barrier
    ("    const int n_live = live[t];\n    // the rows still inside", 1,
     "    const int n_live = live[t]; MARK(0) if (ME) g_t = t;\n"
     "    // the rows still inside"),
    ("      tile_product<4 * U>(hin, h, order + r0, min(kBT, n_live - r0), "
     "h, ws,\n                          as, red);", 1,
     "      tile_product<4 * U>(hin, h, order + r0, min(kBT, n_live - r0), "
     "h, ws,\n                          as, red); MARK(1)"),
    ("    grid.sync();", 2, "    MARK(2) grid.sync(); MARK(3)"),
    # the cluster kernels (lstm_fwd_cluster_kernel and
    # lstm_bwd_cluster_kernel, the same marks where they share lines): top
    # of a step, the staged rows landed, product A, its exchange; the
    # forward's cell; the backward's cell, the cluster exchange, phase B;
    # the grid barrier, the backward's reduce of the clusters' partials
    ("    const int n_live = live[t];\n\n    for (int r0 = 0; r0 < n_live; "
     "r0 += kBT) {\n      const int rows", 2,
     "    const int n_live = live[t]; MARK(0)\n\n    for (int r0 = 0; r0 < "
     "n_live; r0 += kBT) {\n      const int rows"),
    ("      // staged\n", 2, "      MARK(1)\n"),
    ("      cluster.sync();                  // every partial of the gates "
     "landed\n", 2,
     "      MARK(2) cluster.sync();          // every partial of the gates "
     "landed\n      MARK(3)\n"),
    ("      if (r0 + kBT < n_live) cluster.sync();   // pa and hs are read "
     "before\n", 1,
     "      MARK(4) if (r0 + kBT < n_live) cluster.sync();   // pa and hs "
     "are read before\n"),
    ("      // cluster exchange:", 1,
     "      MARK(4)\n      // cluster exchange:"),
    ("      cluster.sync();                  // every gate gradient has "
     "landed\n", 1,
     "      cluster.sync();                  // every gate gradient has "
     "landed\n      MARK(5)\n"),
    ("    grid_barrier(count, target += gridDim.x);\n", 2,
     "    MARK(6) grid_barrier(count, target += gridDim.x); MARK(7)\n"),
    ("    // end of a step\n", 1, "    MARK(8)\n"),
    # inside the product (read for the forward only: the backward's two
    # products overwrite each other's marks)
    ("    __syncthreads();\n    if (vec) {", 1,
     "    __syncthreads(); MARKT(4)\n    if (vec) {"),
    ("      copies_done();\n", 1, "      copies_done(); MARKT(5)\n"),
    ("    __syncthreads();\n    const float* arow", 1,
     "    __syncthreads(); MARKT(6)\n    const float* arow"),
    ("#pragma unroll\n  for (int i = 0; i < 8; ++i) {\n    if (i < mine) {\n"
     "      float* out", 1,
     "MARKT(7)\n#pragma unroll\n  for (int i = 0; i < 8; ++i) {\n"
     "    if (i < mine) {\n      float* out"),
)
# gru_bwd_cluster_kernel's marks, in the GRU section: (text, occurrences,
# replacement)
GRU_MARKS = (
    ("    const int n_live = live[t];\n\n    // phase A: the cell on the "
     "recomputed gates", 1,
     "    const int n_live = live[t]; MARK(0)\n\n    // phase A: the cell on "
     "the recomputed gates"),
    ("      // cluster exchange: the block's dgc", 1,
     "      MARK(1)\n      // cluster exchange: the block's dgc"),
    ("      cluster.sync();                  // every dgc has landed\n", 1,
     "      cluster.sync();                  // every dgc has landed\n"
     "      MARK(2)\n"),
    ("    grid_arrive(count);\n    if (next) {\n      asm volatile", 1,
     "    MARK(3) grid_arrive(count);\n    if (next) {\n      asm volatile"),
    ("    grid_wait(count, target += gridDim.x);\n\n    // phase C", 1,
     "    MARK(4) grid_wait(count, target += gridDim.x); MARK(5)\n\n"
     "    // phase C"),
    ("      gru_reduce(part_r, rx, rb, n_live, u0, clusters, bpad, h);\n", 1,
     "      gru_reduce(part_r, rx, rb, n_live, u0, clusters, bpad, h);"
     " MARK(6)\n"),
    ("      cluster.sync();                  // every dgu, dgr has landed\n",
     1, "      cluster.sync();                  // every dgu, dgr has landed\n"
     "      MARK(7)\n"),
    ("    // the next step's c gates", 1,
     "    MARK(8)\n    // the next step's c gates"),
    ("    cluster.sync();                    // the next step's partial gates "
     "landed\n", 1,
     "    MARK(9) cluster.sync();            // the next step's partial gates "
     "landed\n    MARK(10)\n"),
    ("    grid_wait(count, target += gridDim.x);\n\n    // the carry", 1,
     "    grid_wait(count, target += gridDim.x); MARK(11)\n\n    // the carry"),
    ("    // end of a step\n", 1, "    MARK(12)\n"),
)
# gru_fwd_cluster_kernel's marks, in the GRU section too
GRU_FWD_MARKS = (
    ("    const int n_live = live[t];\n\n    // phase 1: u and r", 1,
     "    const int n_live = live[t]; MARK(0)\n\n    // phase 1: u and r"),
    ("      landed();\n      gru_fwd_gates<16>(", 1,
     "      landed(); MARK(1)\n      gru_fwd_gates<16>("),
    ("      cluster.sync();                  // every partial of u, r landed\n",
     1, "      MARK(2) cluster.sync();          // every partial of u, r "
     "landed\n      MARK(3)\n"),
    ("    grid_arrive(count);\n    if (mine && bl < n_live) xc", 1,
     "    MARK(4) grid_arrive(count);\n    if (mine && bl < n_live) xc"),
    ("    grid_wait(count, target += gridDim.x);\n\n    // phase 2: c from", 1,
     "    grid_wait(count, target += gridDim.x); MARK(5)\n\n"
     "    // phase 2: c from"),
    ("      landed();\n      gru_fwd_gates<8>(", 1,
     "      landed(); MARK(6)\n      gru_fwd_gates<8>("),
    ("      cluster.sync();                  // every partial of c landed\n",
     1, "      MARK(7) cluster.sync();          // every partial of c "
     "landed\n      MARK(8)\n"),
    ("    grid_arrive(count);\n    if (mine && t + 1 < t_len", 1,
     "    MARK(9) grid_arrive(count);\n    if (mine && t + 1 < t_len"),
    ("    grid_wait(count, target += gridDim.x);\n  }\n}\n", 1,
     "    grid_wait(count, target += gridDim.x); MARK(10)\n  }\n}\n"),
)
READ_BACK = (
    '\nextern "C" int paddle_lstm_cycles(long long* host) {\n'
    "  return cudaMemcpyFromSymbol(host, g_dbg, sizeof(long long) * %d);\n}\n"
    % (SLOTS * MAX_STEPS))


GRU_SECTION = "\n// ---- GRU "


def marked(text: str, marks) -> str:
    """``text`` with each mark's text replaced, after checking that it
    occurs as often as the mark expects."""
    for find, count, put in marks:
        if text.count(find) != count:
            raise SystemExit(f"torch_lstm_cycles: expected {count} of "
                             f"{find!r} in fused_rnn.cu, found "
                             f"{text.count(find)}")
        text = text.replace(find, put)
    return text


def instrumented(source: str) -> str:
    """The source with the LSTM's marks in its part before the GRU section
    and the GRU kernels' after it."""
    lstm, gru_banner, gru = source.partition(GRU_SECTION)
    return (marked(lstm, MARKS) + gru_banner
            + marked(gru, GRU_MARKS + GRU_FWD_MARKS) + READ_BACK)


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_lstm_cycles: no CUDA device")
    from paddle_tpu_torch.ops.kernels import build, fused_rnn as fr
    out_dir = build.BUILD_DIR.parent / "lstm_cycles"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "fused_rnn_cycles.cu"
    lib_path = out_dir / "fused_rnn_cycles.so"
    src.write_text(instrumented(
        (build.SOURCE_DIR / "fused_rnn.cu").read_text()))
    subprocess.run([build.nvcc(),
                    *[f for f in build.NVCC_FLAGS if f not in ("-Xptxas",
                                                               "-v")],
                    "-o", str(lib_path), str(src)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    fr._kernels()                      # the port's own argtypes, then swap
    for name in ("paddle_lstm_train_fwd", "paddle_lstm_train_bwd",
                 "paddle_gru_train_fwd", "paddle_gru_train_bwd"):
        getattr(lib, name).argtypes = getattr(fr._lib, name).argtypes
        getattr(lib, name).restype = ctypes.c_int
    lib.paddle_lstm_cycles.argtypes = [ctypes.c_void_p]
    fr._lib = lib

    def smi(query):
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
    card = smi("name,power.limit")
    print(card)
    dev = torch.device("cuda")
    rng = np.random.RandomState(13)

    def normal(shape, scale):
        return torch.from_numpy(
            (rng.randn(*shape) * scale).astype(np.float32)).to(dev)
    ragged = rng.randint(1, T + 1, size=B).astype(np.int32)
    ragged[0] = T
    x, w, peep = normal((T, B, 4 * H), 0.4), normal((H, 4 * H), H ** -0.5), \
        normal((1, 3 * H), 0.1)
    h0, c0 = normal((B, H), 0.3), normal((B, H), 0.3)
    cot = (normal((T, B, H), 0.1), normal((T, B, H), 0.1),
           normal((B, H), 1.0), normal((B, H), 1.0))

    def marks():
        torch.cuda.synchronize()
        buf = np.zeros(SLOTS * MAX_STEPS, np.int64)
        err = lib.paddle_lstm_cycles(buf.ctypes.data)
        if err:
            raise SystemExit(f"torch_lstm_cycles: read-back failed ({err})")
        return buf.reshape(MAX_STEPS, SLOTS)[:T]

    def show(label, names, seg):
        print(f"[{card}] {label}: median cycles a step "
              + ", ".join(f"{n} {np.median(seg[:, i]):.0f}"
                          for i, n in enumerate(names))
              + f"; at t = 2 {seg[2].tolist()}, at t = {len(seg) - 3} "
              f"{seg[-3].tolist()}")

    for label, lens_np in (("ragged", ragged), ("full", np.full(B, T,
                                                                np.int32))):
        lens = torch.from_numpy(lens_np).to(dev)
        ins = (x, w, peep, lens, h0, c0)
        for _ in range(3):
            outs = fr.lstm_train_fwd(*ins)
        d = marks()
        step = np.median(d[1:, 0] - d[:-1, 0])
        show(f"forward ({fr.rnn_kernel_for('lstm_train_fwd', H, dev)}), "
             f"{label} lengths ({int(lens_np.sum())} of {T * B} pairs "
             f"live), step {step:.0f}",
             ("staging", "product", "exchange", "cell and stores",
              "the rest", "grid barrier"),
             np.stack([d[:, 1] - d[:, 0], d[:, 2] - d[:, 1],
                       d[:, 3] - d[:, 2], d[:, 4] - d[:, 3],
                       d[:, 6] - d[:, 4], d[:, 7] - d[:, 6]], 1))
        key = (torch.cuda.current_device(), "lstm_train_fwd", H)
        saved, fr._plans[key] = fr._plans[key], None    # the grid kernel
        for _ in range(3):
            fr.lstm_train_fwd(*ins)
        fr._plans[key] = saved
        d = marks()
        step = np.median(d[1:, 0] - d[:-1, 0])
        show(f"forward (grid kernel), {label} lengths, step {step:.0f}",
             ("product", "cell and stores", "barrier"),
             np.stack([d[:, 1] - d[:, 0], d[:, 2] - d[:, 1],
                       d[:, 3] - d[:, 2]], 1))
        show(f"forward product (grid kernel), {label} lengths",
             ("to the first barrier", "staging", "second barrier",
              "multiply-add", "slice sums"),
             np.stack([d[:, 4] - d[:, 0], d[:, 5] - d[:, 4],
                       d[:, 6] - d[:, 5], d[:, 7] - d[:, 6],
                       d[:, 1] - d[:, 7]], 1))
        for _ in range(3):
            fr.lstm_train_bwd(*ins, outs[0], outs[1], *cot)
        d = marks()
        step = np.median(d[:-1, 0] - d[1:, 0])
        show(f"backward ({fr.rnn_kernel_for('lstm_train_bwd', H, dev)}), "
             f"{label} "
             f"lengths, step {step:.0f}",
             ("staging", "product A", "exchange A", "cell and stores",
              "exchange B", "phase B", "grid barrier", "reduce"),
             np.stack([d[:, i + 1] - d[:, i] for i in range(8)], 1))
    gru(torch, fr, dev, marks, show)
    gru_fwd(torch, fr, dev, marks, show)
    print(f"SM clock now / max: {smi('clocks.sm,clocks.max.sm')}")


def gru(torch, fr, dev, marks, show):
    """The GRU backward's cluster kernel, ragged and full lengths, at the
    translation model's shape."""
    import chip_smoke as cs
    t_len, b, h = cs.MT["max_len"], cs.MT_BATCH, cs.MT["hid_dim"]
    ins, cot, _ = cs.gru_inputs(torch, dev, t_len, b, h, 15)
    full = torch.full_like(ins[2], t_len)
    for label, lens in (("ragged", ins[2]), ("full", full)):
        args = (ins[0], ins[1], lens, ins[3])
        hidden, _, rh = fr.gru_train_fwd_plain(*args)
        for _ in range(3):
            fr.gru_train_bwd(*args, hidden, rh, *cot)
        d = marks()[:t_len]
        step = np.median(d[:-1, 0] - d[1:, 0])
        seg = np.stack([d[:, i + 1] - d[:, i] for i in range(12)], 1)
        show(f"GRU backward ({fr.rnn_kernel_for('gru_train_bwd', h, dev)}), "
             f"{label} lengths ({int(lens.sum())} of {t_len * b} pairs "
             f"live), T {t_len}, step {step:.0f}",
             ("cell and stores", "exchange dgc", "phase B", "barrier 1 with "
              "the next u, r gates", "barrier 1 wait", "reduce d_rh",
              "dgr and exchange", "product C", "barrier 2 with the next c "
              "gates", "cluster sync", "barrier 2 wait", "reduce Dh"), seg)


def gru_fwd(torch, fr, dev, marks, show):
    """The GRU forward's cluster kernel, ragged and full lengths, at the
    translation model's shape."""
    import chip_smoke as cs
    t_len, b, h = cs.MT["max_len"], cs.MT_BATCH, cs.MT["hid_dim"]
    ins, _, _ = cs.gru_inputs(torch, dev, t_len, b, h, 15)
    full = torch.full_like(ins[2], t_len)
    for label, lens in (("ragged", ins[2]), ("full", full)):
        args = (ins[0], ins[1], lens, ins[3])
        for _ in range(3):
            fr.gru_train_fwd(*args)
        d = marks()[:t_len]
        step = np.median(d[1:, 0] - d[:-1, 0])
        seg = np.stack([d[:, i + 1] - d[:, i] for i in range(10)], 1)
        show(f"GRU forward ({fr.rnn_kernel_for('gru_train_fwd', h, dev)}), "
             f"{label} lengths ({int(lens.sum())} of {t_len * b} pairs "
             f"live), T {t_len}, step {step:.0f}",
             ("staging 1", "product u, r", "exchange 1", "cell 1 and stores",
              "barrier 1", "staging 2", "product c", "exchange 2",
              "cell 2 and stores", "barrier 2"), seg)


if __name__ == "__main__":
    main()
