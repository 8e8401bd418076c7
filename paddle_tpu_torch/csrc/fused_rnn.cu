// Whole-sequence trainable LSTM and GRU, forward and backward, written for
// Hopper (compiled for sm_90a) behind a plain C interface that ctypes loads.
//
// Replaces the four Pallas TPU kernels of paddle_tpu/ops/pallas/fused_rnn.py:
//   paddle_lstm_train_fwd <- _lstm_train_fwd_call (:167, pallas_call :171,
//                            _lstm_train_fwd_kernel :49)
//   paddle_lstm_train_bwd <- _lstm_train_vjp_bwd  (:224, pallas_call :235,
//                            _lstm_train_bwd_kernel :91)
//   paddle_gru_train_fwd, paddle_gru_train_bwd: the GRU pair, in the
//                            section "GRU" at the end of this file.
//
// The LSTM:
// All tensors are fp32, contiguous and time-major: xproj [T, B, 4H] (gate
// pre-activations x @ Wx + b, gate order i, f, c, o), w [H, 4H] recurrent,
// peep [3H] (W_ic | W_fc | W_oc, zeros without peepholes), lens [B] int32,
// h0, c0 [B, H]; any H, B >= 1, T >= 1. Beside lens the caller
// gives order [B] int32, the rows sorted by falling length, and live [T]
// int32, how many rows are longer than t.
//
// Forward, per step t (_lstm_train_fwd_kernel :60-88):
//   gates = xproj[t] + h @ w
//   i = sigmoid(gates_i + c * W_ic)     f = sigmoid(gates_f + c * W_fc)
//   g = tanh(gates_c)                   c_cand = f * c + i * g
//   o = sigmoid(gates_o + c_cand * W_oc)  h_cand = o * tanh(c_cand)
//   m = t < lens;  the carries h, c keep the old state where m = 0;
//   hidden[t], cell[t] = m * h_cand, m * c_cand (zero past a row's length);
//   h_last, c_last = the carries after step T - 1.
// Backward, in reverse time (_lstm_train_bwd_kernel :109-157): the gates are
// recomputed from xproj[t], h_prev[t], c_prev[t] (the hidden and cell
// sequences shifted by one step behind h0, c0); carries Dh, Dc start at the
// cotangents of h_last, c_last; outputs dx [T, B, 4H] (the gate gradients),
// dw [H, 4H], dpeep [3H], dh0, dc0 [B, H].
//
// What bounds them: arithmetic and a serial chain. One step is a [B, H] x
// [H, 4H] product (134 MFLOP at B 64, H 512), the forward does one a step and
// the backward three (the recompute, Dh = dgates @ w^T, dw += h_prev^T @
// dgates). Step t + 1 cannot start before every unit of h[t] is known, so T
// steps are T grid-wide barriers whatever the arithmetic rate. The grid
// kernels (lstm_fwd_kernel, lstm_bwd_kernel, the GRU's gru_fwd_kernel and
// gru_bwd_kernel) multiply in fp32 outside the tensor cores; at H <= 512 all
// four run on clusters and the tensor cores instead
// (lstm_bwd_cluster_kernel, lstm_fwd_cluster_kernel, gru_bwd_cluster_kernel
// and gru_fwd_cluster_kernel, the sections "LSTM backward on thread-block
// clusters", "LSTM forward on ...", "GRU backward on ..." and "GRU forward
// on ..." below), and both backwards' dw product on the tensor cores at
// every width (rnn_dw_kernel), all at fp32 accuracy through 3xTF32.
//
// Design of the grid kernels (above H 512, or where the cluster kernels do
// not fit). The TPU kernel keeps h, c and the whole of w in one core's VMEM
// and walks a sequential grid over time. On Hopper w (4 MB at H 512) fits no
// SM's shared memory, and the time loop cannot be a grid dimension: blocks
// run in no order. So each kernel is one cooperative launch of G = ceil(H/U)
// persistent blocks (U = 1, 2 or 4 hidden units a block, the least that
// keeps G within one block per SM: 128 blocks of 4 units at H 512), and the
// time loop runs inside every block with one cooperative-groups grid barrier
// a step:
//   forward   block g owns units [gU, gU + U) and, for them, all four gate
//             columns: that [H, 4U] slice of w stays in shared memory for the
//             whole sequence (32 KB at H 512). Each step it multiplies the
//             whole carry h [B, H] by its slice, finishes the cell for its
//             units (its c never leaves the thread that owns it: the c_last
//             buffer is the state) and publishes its units of the new h to a
//             double-buffered [2, B, H] carry in global memory, which the
//             other blocks read after the barrier through L2 (__ldcg: L1 is
//             not coherent across SMs). The carry is not the hidden output:
//             hidden is zero past a row's length, the carry is held there.
//   backward  (lstm_bwd_kernel, the widths the cluster kernel does not take:
//             H above 512 or not a multiple of 4)
//             phase A: the same ownership recomputes the gates of its units
//             from h_prev[t] (an input) and writes its columns of dx[t], an
//             output anyway; Dc stays with its owner (the dc0 buffer is the
//             state). Grid barrier. Phase B: Dh[:, k] = sum_n dgates[:, n] *
//             w[k, n] needs every gate gradient of the step, so the owner of
//             unit k reads all of dx[t] back through L2 against its [4H, U]
//             row slice of w (32 KB more shared memory) and updates its own
//             units of Dh (the dh0 buffer is the state). The next step's
//             phase A needs only the block's own Dh, Dc, so one barrier a
//             step is enough.
//             dpeep needs only a thread's own gate gradients: each owner
//             sums dgi * c_prev, dgf * c_prev and dgo * c_cand over its
//             steps and rows in registers, and the block adds its 64 row
//             shares in order at the end.
//   dw        after the time loop, from dx and the saved hidden sequence, by
//             one more kernel on the same stream (rnn_dw_kernel, wgmma):
//             dw = h_prev_seq^T @ dx is one [H, T*B] x [T*B, 4H] product.
//             Every sum runs in a fixed order with no atomics: two runs give
//             the same bits.
// Inside a block both products share one routine over a staged chunk of the
// left operand (64 rows, up to 512 deep: the whole carry at H 512, 129 KB, so
// that one round of loads is in flight a step): a thread multiplies 8 rows by
// 4 columns of the block's weight slice over one slice of the depth, and the
// slices are added in a fixed order through shared memory. Batches above 64
// rows take further passes over the chunk loop.
//   A row past its length adds nothing: its state is held, its outputs and
// gate gradients are 0. With the rows taken in order of falling length the
// rows inside their length at step t are the first live[t] of `order`, so a
// step stages and multiplies only those (about half of them for lengths
// uniform in 1..T) and writes the zeros of the others without arithmetic. A
// row's last states are written, and its gradient carries are read from the
// cotangents of those states, at its own last step. Ragged edges (H not a
// multiple of U or of the chunk, B not of 64) load as zeros and are never
// written.
// Activations are expf and tanhf at full precision: a hundred steps compound
// an error.
//   Wider than H 512 (transformer-sized recurrent layers, H 1024): with one
// block per SM at most, a block must own U = 8 units (16 past 8 x the SMs),
// and its slices of w no longer fit in shared memory beside the staged
// chunk (the backward's two slices take 256 KB at H 1024, U 8). The kernels
// instantiated for U 8 and 16 therefore keep them in scratch in global
// memory that the wrapper allocates (paddle_rnn_scratch_floats: 16 MB for
// the LSTM forward at H 1024, w itself is 16 MB), each block writing its
// own slices at the start and reading them every step through L1 and L2
// (50 MB): the same products in the same order, from another memory. A
// thread then owns 2 or 4 (row, unit) pairs of a pass where it owned one
// (Owner), and the dpeep shares are summed over 32 or 16 rows. H <= 512
// keeps U <= 4 and its slices in shared memory, as above.
//   Wider than 16 x the SMs (H 2112 on an H100: the ceil(H / 16) blocks of
// 16 units no longer fit one per SM): the same one cooperative launch, on
// one block per SM, each block owning ceil(H / 16 / SMs) such groups of 16
// units ("passes", the kPasses instantiations of U 16). Between the same
// grid barriers a block runs each phase of a step once per pass, for the
// pass's 16 units, exactly as the block of those 16 units runs it at H
// <= 2112; every pass's slices of w (and, for the LSTM backward, its
// threads' running dpeep shares) have their own place in the scratch.
// Up to H 2112 the instantiations are those above and compile as before.
// (A pass loop leaves its body at the indentation it had without one:
// tools/torch_lstm_cycles.py places its marks by matching these lines.)
//
// Each function launches on the caller's stream, allocates nothing, does not
// synchronise, and returns the CUDA error of its launches (0 = success;
// cudaErrorInvalidValue for a shape it does not take or a missing scratch,
// cudaErrorCooperativeLaunchTooLarge where the card cannot hold the grid).

#include <cmath>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kBT = 64;                   // batch rows of one pass
constexpr int kMaxChunk = 512;            // most depth staged at once
constexpr int kRed = kThreads * 32;       // floats of partial sums: 8 x 4 a
                                          // thread at most
constexpr int kMaxSmemU = 4;             // up to 4 units a block, the w
                                         // slices live in shared memory
constexpr int kMaxU = 16;                 // units of a pass above that

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// The depth of one staged chunk of a product of this depth: 128, 256 or 512
// (kMaxChunk), the least that holds it all, so that each of up to 32 depth
// slices is whole float4s and a thread stages one column of float4s. Rows
// are chunk + 4 floats apart: float4 reads of eight rows then cover all 32
// banks.
__host__ __device__ constexpr int chunk_of(int depth) {
  return depth <= 128 ? 128 : depth <= 256 ? 256 : kMaxChunk;
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// One 16-byte global -> shared copy in flight (cp.async), through L2 only:
// the source may have been written by another SM before the last grid
// barrier, and L1 is not coherent. An invalid source writes zeros and reads
// nothing.
__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// How the threads of a block share one product with NOUT output columns: a
// thread holds 8 rows x kCols columns of the 64-row pass (rows rg, rg + 8,
// ..., so that the float4 reads of a quarter-warp's eight rows cover all 32
// banks) over one depth slice of the staged chunk; 8 * kColGroups threads
// cover the pass and kSlices such groups split the depth.
template <int NOUT>
struct Tile {
  static constexpr int kCols = NOUT < 4 ? NOUT : 4;
  static constexpr int kColGroups = NOUT / kCols;
  static constexpr int kPerSlice = 8 * kColGroups;
  static constexpr int kSlices = kThreads / kPerSlice;
};

// acc[i][c] += sum over ks steps of depth of arow[8 i][k] * wk[k][c] for the
// first N8 of a thread's eight rows: no branch inside, so that the loads of
// one step of the loop run ahead of the FMAs of the last.
template <int NOUT, int N8>
__device__ __forceinline__ void multiply(const float* arow, const float* wk,
                                         int ks, int stride,
                                         float (&acc)[8][Tile<NOUT>::kCols]) {
  constexpr int kCols = Tile<NOUT>::kCols;
#pragma unroll 2
  for (int kk = 0; kk < ks; kk += 4) {
    float wv[4][kCols];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (kCols == 4) {
        const float4 w4 =
            *reinterpret_cast<const float4*>(wk + (kk + j) * NOUT);
        wv[j][0] = w4.x;
        wv[j][1] = w4.y;
        wv[j][2] = w4.z;
        wv[j][3] = w4.w;
      } else {
#pragma unroll
        for (int c = 0; c < kCols; ++c) wv[j][c] = wk[(kk + j) * NOUT + c];
      }
    }
#pragma unroll
    for (int i = 0; i < N8; ++i) {
      const float4 a4 =
          *reinterpret_cast<const float4*>(arow + 8 * i * stride + kk);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[i][c] = fmaf(av[j], wv[j][c], acc[i][c]);
    }
  }
}

// sum_k a[row][k] * wsm[k][n] for the 64 rows of a pass and n < NOUT, left
// in red[slice][row][n] as one partial sum per depth slice (reduced() adds
// them). Row r of the pass is row rowmap[r] of `a` in global memory (read
// through L2), `rows` how many of the 64 exist, `depth` the true depth; wsm
// holds round_up(depth, chunk_of(depth)) rows, zero past depth. A whole
// chunk is staged with all its loads in flight before anything is
// multiplied: as asynchronous copies where rows are 16-byte aligned, else
// as plain loads. The product is bound by its shared-memory loads: a
// warp's 128-bit load takes 4 cycles whether its lanes read 32 addresses or
// one, so a thread multiplies an 8 x 4 tile from 8 + 4 such loads per 4
// steps of depth (3 per 32 FMAs; one row and 16 columns a thread, 17 per 64,
// took 1.7x the cycles on an H100), in a loop without branches (multiply():
// with a test per row group inside it the loads could not run ahead of the
// FMAs and it took 2.2x the cycles). Ends with the block synchronised and
// red complete; starts with a barrier, so red and as may have been read just
// before.
template <int NOUT>
__device__ __forceinline__ void tile_product(const float* a, int lda,
                                             const int* __restrict__ rowmap,
                                             int rows, int depth,
                                             const float* wsm, float* as,
                                             float* red) {
  using T = Tile<NOUT>;
  const int tid = threadIdx.x;
  const int slice = tid / T::kPerSlice;
  const int cg = tid % T::kPerSlice / 8, rg = tid % 8;
  const int chunk = chunk_of(depth), stride = chunk + 4;
  const int ks = chunk / T::kSlices;
  // how many of this thread's rows rg + 8 i exist
  const int mine = rows > rg ? (rows - rg + 7) / 8 : 0;
  const bool vec = (lda & 3) == 0 && (depth & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(a) & 15) == 0;
  float acc[8][T::kCols];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < T::kCols; ++c) acc[i][c] = 0.0f;
  for (int kc = 0; kc < depth; kc += chunk) {
    __syncthreads();
    if (vec) {
      // a thread copies one column of float4s: chunk / 4 divides kThreads
      const int c4 = chunk / 4, c = tid % c4 * 4;
      const bool valid = kc + c < depth;
#pragma unroll 4
      for (int r = tid / c4; r < rows; r += kThreads / c4)
        copy16(as + r * stride + c,
               valid ? a + static_cast<size_t>(rowmap[r]) * lda + kc + c : a,
               valid);
      copies_done();
    } else {
      for (int idx = tid; idx < rows * chunk; idx += kThreads) {
        const int r = idx / chunk, c = idx % chunk;
        float v = 0.0f;
        if (kc + c < depth)
          v = __ldcg(a + static_cast<size_t>(rowmap[r]) * lda + kc + c);
        as[r * stride + c] = v;
      }
    }
    __syncthreads();
    const float* arow = as + rg * stride + slice * ks;
    const float* wk = wsm + static_cast<size_t>(kc + slice * ks) * NOUT +
                      cg * T::kCols;
    // whole pairs of row groups: the rows past `rows` of the last one are
    // multiplied as they lie in shared memory and never read
    switch ((rows + 15) / 16) {
      case 1: multiply<NOUT, 2>(arow, wk, ks, stride, acc); break;
      case 2: multiply<NOUT, 4>(arow, wk, ks, stride, acc); break;
      case 3: multiply<NOUT, 6>(arow, wk, ks, stride, acc); break;
      default: multiply<NOUT, 8>(arow, wk, ks, stride, acc); break;
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (i < mine) {
      float* out = red + (slice * kBT + rg + 8 * i) * NOUT + cg * T::kCols;
#pragma unroll
      for (int c = 0; c < T::kCols; ++c) out[c] = acc[i][c];
    }
  }
  __syncthreads();
}

// The depth slices of one output, added in slice order.
template <int NOUT>
__device__ __forceinline__ float reduced(const float* red, int row, int n) {
  float s = red[row * NOUT + n];
#pragma unroll 4
  for (int sl = 1; sl < Tile<NOUT>::kSlices; ++sl)
    s += red[(sl * kBT + row) * NOUT + n];
  return s;
}

// ws[k][u*4 + g] = w[k][g*H + u0 + u]: the four gate columns of the block's
// units, zero past H in either direction.
template <int U>
__device__ __forceinline__ void load_gate_slice(const float* __restrict__ w,
                                                float* ws, int h, int u0) {
  const int hpad = round_up(h, chunk_of(h));
  for (int idx = threadIdx.x; idx < hpad * 4 * U; idx += kThreads) {
    const int k = idx / (4 * U), r = idx % (4 * U);
    const int u = r / 4, g = r % 4, j = u0 + u;
    ws[idx] = (k < h && j < h)
        ? w[static_cast<size_t>(k) * 4 * h + g * h + j] : 0.0f;
  }
}

// The (row, unit) pairs of the cell that a thread owns: unit j = u0 + tid % U
// and rows bl[o] = tid / U + o * kRowStep of a pass of kBT rows, o < kOwn.
// Up to U = 4 a pass has at most kThreads pairs (one a thread, threads past
// kBT * U own none); at U = 8 and 16 a thread owns 2 and 4.
template <int U>
struct Owner {
  static constexpr int kOwn = (kBT * U + kThreads - 1) / kThreads;
  static constexpr int kRowStep = kThreads / U;
  // the row shares a unit's dpeep is summed over at the end
  static constexpr int kShares = kBT < kRowStep ? kBT : kRowStep;
};

// A thread's (row, unit) pairs of the units [u0, u0 + U): unit j, rows bl[o]
// of a pass of kBT rows, owner[o] where that pair exists.
template <int U>
struct Share {
  int j;
  int bl[Owner<U>::kOwn];
  bool owner[Owner<U>::kOwn];
};

template <int U>
__device__ __forceinline__ Share<U> share_of(int u0, int h) {
  using O = Owner<U>;
  Share<U> sh;
  sh.j = u0 + threadIdx.x % U;
#pragma unroll
  for (int o = 0; o < O::kOwn; ++o) {
    sh.bl[o] = threadIdx.x / U + o * O::kRowStep;
    sh.owner[o] = sh.bl[o] < kBT && sh.j < h;
  }
  return sh;
}

// The passes of a block: one (the block's own U units) below kPasses; with
// kPasses, the groups of U units vb = blockIdx.x + p * gridDim.x < ceil(h / U).
template <int U, bool kPasses>
__device__ __forceinline__ int passes_of(int h) {
  if (!kPasses) return 1;
  const int groups = (h + U - 1) / U;
  return (groups - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
}

// The LSTM's peepholes of unit j (0 for the threads that own no pair).
struct Peep {
  float i, f, o;
};

template <int U>
__device__ __forceinline__ Peep peep_of(const float* __restrict__ peep,
                                        int j, int h) {
  Peep pp{0.f, 0.f, 0.f};
  if (threadIdx.x < kBT * U && j < h) {
    pp.i = peep[j];
    pp.f = peep[h + j];
    pp.o = peep[2 * h + j];
  }
  return pp;
}

// Floats of one block's slices of w, per kernel: where they live in shared
// memory they come first, then the staging area of stage_floats.
__host__ __device__ inline int lstm_fwd_slice(int h, int u) {
  return round_up(h, chunk_of(h)) * 4 * u;                       // ws
}
__host__ __device__ inline int lstm_bwd_slice(int h, int u) {
  return round_up(h, chunk_of(h)) * 4 * u +                      // ws
         round_up(4 * h, chunk_of(4 * h)) * u;                   // wr
}
__host__ __device__ inline int gru_fwd_slice(int h, int u) {
  return round_up(h, chunk_of(h)) * 3 * u;                       // ws_ur, ws_c
}
__host__ __device__ inline int gru_bwd_slice(int h, int u) {
  return (round_up(h, chunk_of(h)) +                             // wrc
          round_up(2 * h, chunk_of(2 * h))) * u;                 // wrur
}

// The scratch floats of one pass's group of units: its slices of w and, for
// the LSTM backward, its threads' three running dpeep shares.
__host__ __device__ inline int pass_floats(int slice, bool lstm_bwd) {
  return slice + (lstm_bwd ? 3 * kThreads : 0);
}

// The block's slices of w and its staging area (as, then red): the slices in
// shared memory up to U = 4, in the caller's scratch in global memory above
// (slice floats a block), where they do not fit beside the staging area.
struct Smem {
  float* w;
  float* as;
};

template <int U>
__device__ __forceinline__ Smem carve(float* smem, float* wscratch,
                                      int slice) {
  if (U > kMaxSmemU)
    return {wscratch + static_cast<size_t>(blockIdx.x) * slice, smem};
  return {smem, smem + slice};
}

// The slices of w of pass group vb: the block's own (carve) below kPasses,
// else the group's place in the scratch, `stride` (pass_floats) apart.
template <bool kPasses>
__device__ __forceinline__ float* pass_w(const Smem& sm, float* wscratch,
                                         int vb, int stride) {
  return kPasses ? wscratch + static_cast<size_t>(vb) * stride : sm.w;
}

template <int U, bool kPasses = false>
__global__ void __launch_bounds__(kThreads, 1)
lstm_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ peep, const int* __restrict__ lens,
                const int* __restrict__ order, const int* __restrict__ live,
                const float* __restrict__ h0, const float* __restrict__ c0,
                float* __restrict__ hidden, float* __restrict__ cell,
                float* __restrict__ hlast, float* clast, float* carry,
                float* wscratch, int t_len, int b_len, int h) {
  using O = Owner<U>;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int slice = lstm_fwd_slice(h, U);
  const Smem sm = carve<U>(smem, wscratch, slice);
  float* as = sm.as;                                 // [64][chunk + 4]
  float* red = as + kBT * (chunk_of(h) + 4);         // kRed floats
  const int tid = threadIdx.x;
  const int n_pass = passes_of<U, kPasses>(h);
  for (int p = 0; p < n_pass; ++p) {                 // ws: [hpad][4U]
    const int vb = blockIdx.x + p * gridDim.x;
    load_gate_slice<U>(w, pass_w<kPasses>(sm, wscratch, vb, slice), h,
                       vb * U);
  }

  // this thread's shares of the cell: rows bl[o] of the pass, unit j
  const Share<U> sh0 = share_of<U>(blockIdx.x * U, h);
  const Peep pp0 = peep_of<U>(peep, sh0.j, h);
  const size_t bh = static_cast<size_t>(b_len) * h;

  for (int t = 0; t < t_len; ++t) {
    const float* hin = t == 0 ? h0 : carry + (t & 1) * bh;
    float* hout = carry + ((t + 1) & 1) * bh;
    const float* cin = t == 0 ? c0 : clast;
    for (int p = 0; p < n_pass; ++p) {
    const int vb = blockIdx.x + p * gridDim.x;
    const float* ws = pass_w<kPasses>(sm, wscratch, vb, slice);
    const Share<U> sh = kPasses ? share_of<U>(vb * U, h) : sh0;
    const Peep pp = kPasses ? peep_of<U>(peep, sh.j, h) : pp0;
    const int j = sh.j;
    const int (&bl)[O::kOwn] = sh.bl;
    const bool (&owner)[O::kOwn] = sh.owner;
    const float w_ic = pp.i, w_fc = pp.f, w_oc = pp.o;
    const int n_live = live[t];
    // the rows still inside their length: the first n_live of `order`
    for (int r0 = 0; r0 < n_live; r0 += kBT) {
      bool alive[O::kOwn];
      int b[O::kOwn];
      float xg[O::kOwn][4], c_prev[O::kOwn];
#pragma unroll
      for (int o = 0; o < O::kOwn; ++o) {
        alive[o] = owner[o] && r0 + bl[o] < n_live;
        b[o] = alive[o] ? order[r0 + bl[o]] : 0;
#pragma unroll
        for (int g = 0; g < 4; ++g) xg[o][g] = 0.f;
        c_prev[o] = 0.f;
        if (alive[o]) {  // in flight while the product runs
          const float* xr =
              x + (static_cast<size_t>(t) * b_len + b[o]) * 4 * h + j;
#pragma unroll
          for (int g = 0; g < 4; ++g) xg[o][g] = xr[g * h];
          c_prev[o] = cin[static_cast<size_t>(b[o]) * h + j];
        }
      }
      tile_product<4 * U>(hin, h, order + r0, min(kBT, n_live - r0), h, ws,
                          as, red);
#pragma unroll
      for (int o = 0; o < O::kOwn; ++o) {
        if (!alive[o]) continue;
        const size_t at = static_cast<size_t>(b[o]) * h + j;
        const int n = (tid % U) * 4;
        const float gi = xg[o][0] + reduced<4 * U>(red, bl[o], n + 0);
        const float gf = xg[o][1] + reduced<4 * U>(red, bl[o], n + 1);
        const float gc = xg[o][2] + reduced<4 * U>(red, bl[o], n + 2);
        const float go = xg[o][3] + reduced<4 * U>(red, bl[o], n + 3);
        const float i = sigmoidf(gi + c_prev[o] * w_ic);
        const float f = sigmoidf(gf + c_prev[o] * w_fc);
        const float g = tanhf(gc);
        const float c_new = f * c_prev[o] + i * g;
        const float og = sigmoidf(go + c_new * w_oc);
        const float h_new = og * tanhf(c_new);
        hout[at] = h_new;
        clast[at] = c_new;
        hidden[static_cast<size_t>(t) * bh + at] = h_new;
        cell[static_cast<size_t>(t) * bh + at] = c_new;
        if (t + 1 == t_len || t + 1 == lens[b[o]]) hlast[at] = h_new;
      }
    }
    // the rows past their length: zero outputs, the state stays as it is
#pragma unroll
    for (int o = 0; o < O::kOwn; ++o) {
      if (!owner[o]) continue;
      for (int r = n_live + bl[o]; r < b_len; r += kBT) {
        const size_t at = static_cast<size_t>(order[r]) * h + j;
        hidden[static_cast<size_t>(t) * bh + at] = 0.0f;
        cell[static_cast<size_t>(t) * bh + at] = 0.0f;
        if (t == 0) {                  // a row of length 0 keeps h0, c0
          hlast[at] = h0[at];
          clast[at] = c0[at];
        }
      }
    }
    }  // passes
    grid.sync();
  }
}

template <int U, bool kPasses = false>
__global__ void __launch_bounds__(kThreads, 1)
lstm_bwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ peep, const int* __restrict__ lens,
                const int* __restrict__ order, const int* __restrict__ live,
                const float* __restrict__ h0, const float* __restrict__ c0,
                const float* __restrict__ hidden,
                const float* __restrict__ cell,
                const float* __restrict__ dhid,
                const float* __restrict__ dcell,
                const float* __restrict__ dhlast,
                const float* __restrict__ dclast, float* dx,
                float* __restrict__ dpeep, float* dh0, float* dc0,
                float* wscratch, int t_len, int b_len, int h) {
  using O = Owner<U>;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int hpad = round_up(h, chunk_of(h));
  const int npad = round_up(4 * h, chunk_of(4 * h));
  const int slice = lstm_bwd_slice(h, U);
  const int stride = pass_floats(slice, true);
  const Smem sm = carve<U>(smem, wscratch, slice);
  float* as = sm.as;                                 // [64][chunk + 4]
  float* red = as + kBT * (chunk_of(4 * h) + 4);     // kRed floats
  const int tid = threadIdx.x;
  const int n_pass = passes_of<U, kPasses>(h);
  for (int p = 0; p < n_pass; ++p) {
    const int vb = blockIdx.x + p * gridDim.x, u0 = vb * U;
    float* ws = pass_w<kPasses>(sm, wscratch, vb, stride);  // [hpad][4U]
    float* wr = ws + hpad * 4 * U;                          // [npad][U]
    load_gate_slice<U>(w, ws, h, u0);
    // wr[n][u] = w[u0 + u][n]: the rows of the block's units
    for (int idx = tid; idx < npad * U; idx += kThreads) {
      const int u = idx / npad, n = idx % npad, k = u0 + u;
      wr[n * U + u] = (n < 4 * h && k < h)
          ? w[static_cast<size_t>(k) * 4 * h + n] : 0.0f;
    }
    if (kPasses) {                  // the pass's running dpeep shares
      float* dps = ws + slice;
      dps[tid] = dps[kThreads + tid] = dps[2 * kThreads + tid] = 0.f;
    }
  }

  const Share<U> sh0 = share_of<U>(blockIdx.x * U, h);
  const Peep pp0 = peep_of<U>(peep, sh0.j, h);
  const size_t bh = static_cast<size_t>(b_len) * h;
  float dp_i = 0.f, dp_f = 0.f, dp_o = 0.f;   // this thread's share of dpeep

  for (int t = t_len - 1; t >= 0; --t) {
    const float* hp_seq = t == 0 ? h0 : hidden + (t - 1) * bh;
    const float* cp_seq = t == 0 ? c0 : cell + (t - 1) * bh;
    float* dxt = dx + static_cast<size_t>(t) * b_len * 4 * h;
    const int n_live = live[t];

    // phase A: the gates again and the gate gradients of the block's units,
    // for the rows inside their length (the first n_live of `order`)
    for (int p = 0; p < n_pass; ++p) {
    const int vb = blockIdx.x + p * gridDim.x;
    const float* ws = pass_w<kPasses>(sm, wscratch, vb, stride);
    const Share<U> sh = kPasses ? share_of<U>(vb * U, h) : sh0;
    const Peep pp = kPasses ? peep_of<U>(peep, sh.j, h) : pp0;
    const int j = sh.j;
    const int (&bl)[O::kOwn] = sh.bl;
    const bool (&owner)[O::kOwn] = sh.owner;
    const float w_ic = pp.i, w_fc = pp.f, w_oc = pp.o;
    float* dps = const_cast<float*>(ws) + slice;
    if (kPasses) {
      dp_i = dps[tid];
      dp_f = dps[kThreads + tid];
      dp_o = dps[2 * kThreads + tid];
    }
    for (int r0 = 0; r0 < n_live; r0 += kBT) {
      bool alive[O::kOwn];
      int b[O::kOwn];
      float xg[O::kOwn][4], c_prev[O::kOwn], gh[O::kOwn], gcell[O::kOwn];
#pragma unroll
      for (int o = 0; o < O::kOwn; ++o) {
        alive[o] = owner[o] && r0 + bl[o] < n_live;
        b[o] = alive[o] ? order[r0 + bl[o]] : 0;
#pragma unroll
        for (int g = 0; g < 4; ++g) xg[o][g] = 0.f;
        c_prev[o] = gh[o] = gcell[o] = 0.f;
        if (alive[o]) {
          const size_t at = static_cast<size_t>(b[o]) * h + j;
          const float* xr =
              x + (static_cast<size_t>(t) * b_len + b[o]) * 4 * h + j;
#pragma unroll
          for (int g = 0; g < 4; ++g) xg[o][g] = xr[g * h];
          c_prev[o] = cp_seq[at];
          // a row's carries start at the cotangents of its last states
          const bool last = t + 1 == t_len || t + 1 == lens[b[o]];
          gh[o] = (last ? dhlast : dh0)[at] +
                  dhid[static_cast<size_t>(t) * bh + at];
          gcell[o] = (last ? dclast : dc0)[at] +
                     dcell[static_cast<size_t>(t) * bh + at];
        }
      }
      tile_product<4 * U>(hp_seq, h, order + r0, min(kBT, n_live - r0), h, ws,
                          as, red);
#pragma unroll
      for (int o = 0; o < O::kOwn; ++o) {
        if (!alive[o]) continue;
        const size_t at = static_cast<size_t>(b[o]) * h + j;
        const int n = (tid % U) * 4;
        const float gi = xg[o][0] + reduced<4 * U>(red, bl[o], n + 0);
        const float gf = xg[o][1] + reduced<4 * U>(red, bl[o], n + 1);
        const float gc = xg[o][2] + reduced<4 * U>(red, bl[o], n + 2);
        const float go = xg[o][3] + reduced<4 * U>(red, bl[o], n + 3);
        const float cp = c_prev[o];
        const float i = sigmoidf(gi + cp * w_ic);
        const float f = sigmoidf(gf + cp * w_fc);
        const float g = tanhf(gc);
        const float c_cand = f * cp + i * g;
        const float og = sigmoidf(go + c_cand * w_oc);
        const float tanh_c = tanhf(c_cand);
        const float dgo = gh[o] * tanh_c * og * (1.0f - og);
        const float dc_cand =
            gcell[o] + gh[o] * og * (1.0f - tanh_c * tanh_c) + dgo * w_oc;
        const float dgi = dc_cand * g * i * (1.0f - i);
        const float dgf = dc_cand * cp * f * (1.0f - f);
        const float dgg = dc_cand * i * (1.0f - g * g);
        float* dxr = dxt + static_cast<size_t>(b[o]) * 4 * h + j;
        dxr[0] = dgi;
        dxr[h] = dgf;
        dxr[2 * h] = dgg;
        dxr[3 * h] = dgo;
        dc0[at] = dc_cand * f + dgi * w_ic + dgf * w_fc;
        dp_i = fmaf(dgi, cp, dp_i);
        dp_f = fmaf(dgf, cp, dp_f);
        dp_o = fmaf(dgo, c_cand, dp_o);
      }
    }
    // the rows past their length: no gate gradient, the carries stay
#pragma unroll
    for (int o = 0; o < O::kOwn; ++o) {
      if (!owner[o]) continue;
      for (int r = n_live + bl[o]; r < b_len; r += kBT) {
        const int b = order[r];
        float* dxr = dxt + static_cast<size_t>(b) * 4 * h + j;
        dxr[0] = dxr[h] = dxr[2 * h] = dxr[3 * h] = 0.0f;
        if (t == 0) {                  // a row of length 0 hands them on
          const size_t at = static_cast<size_t>(b) * h + j;
          dh0[at] = dhlast[at];
          dc0[at] = dclast[at];
        }
      }
    }
    if (kPasses) {
      dps[tid] = dp_i;
      dps[kThreads + tid] = dp_f;
      dps[2 * kThreads + tid] = dp_o;
    }
    }  // passes
    grid.sync();

    // phase B: Dh of the block's units from every gate gradient of the step
    for (int p = 0; p < n_pass; ++p) {
    const int vb = blockIdx.x + p * gridDim.x;
    const float* wr =
        pass_w<kPasses>(sm, wscratch, vb, stride) + hpad * 4 * U;
    const Share<U> sh = kPasses ? share_of<U>(vb * U, h) : sh0;
    const int j = sh.j;
    const int (&bl)[O::kOwn] = sh.bl;
    const bool (&owner)[O::kOwn] = sh.owner;
    for (int r0 = 0; r0 < n_live; r0 += kBT) {
      tile_product<U>(dxt, 4 * h, order + r0, min(kBT, n_live - r0), 4 * h,
                      wr, as, red);
#pragma unroll
      for (int o = 0; o < O::kOwn; ++o)
        if (owner[o] && r0 + bl[o] < n_live)
          dh0[static_cast<size_t>(order[r0 + bl[o]]) * h + j] =
              reduced<U>(red, bl[o], tid % U);
    }
    }  // passes
  }

  // dpeep of the block's units: the row shares, added in share order
  for (int p = 0; p < n_pass; ++p) {
    const int vb = blockIdx.x + p * gridDim.x, u0 = vb * U;
    if (kPasses) {
      const float* dps = pass_w<kPasses>(sm, wscratch, vb, stride) + slice;
      dp_i = dps[tid];
      dp_f = dps[kThreads + tid];
      dp_o = dps[2 * kThreads + tid];
    }
    __syncthreads();
    if (tid < O::kShares * U) {
      const int r = tid / U, u = tid % U;
      red[(0 * O::kShares + r) * U + u] = dp_i;
      red[(1 * O::kShares + r) * U + u] = dp_f;
      red[(2 * O::kShares + r) * U + u] = dp_o;
    }
    __syncthreads();
    if (tid < 3 * U && u0 + tid % U < h) {
      const int which = tid / U, u = tid % U;
      float s = 0.0f;
      for (int r = 0; r < O::kShares; ++r)
        s += red[(which * O::kShares + r) * U + u];
      dpeep[which * h + u0 + u] = s;
    }
  }
}

// The product before the GRU grid kernel's time loop: c[m][n] = sum_k
// a(m, k) * b[k][n] for m < m_len, n < n_len, k < k_len (c and b with row
// strides ldc, ldb), over 128 x 64 output tiles, 8 x 4 a thread, both
// operands staged through shared memory 16 deep, every sum in a fixed order
// and no atomics: two runs give the same bits. a(m, k) = S[m][k], where row
// p of S is a0[p] for p < split and a1[p - split] after (rows lda apart), so
// that h0 followed by the hidden sequence reads as the hidden sequence one
// step behind: the GRU's gate pre-activations h_prev_seq @ w of every step
// at once. One launch computes up to two such products of the same m_len,
// k_len and strides (blockIdx.z picks one): the GRU's two halves,
// [h_prev_seq | rh] against [w_ur | w_c], run side by side instead of one
// after the other.
constexpr int kGemmM = 128, kGemmN = 64, kGemmK = 16;

struct GemmPart {
  const float* a0;
  const float* a1;
  int split;
  const float* b;
  float* c;
  int n_len;
};

__global__ void __launch_bounds__(kThreads)
rnn_gemm_kernel(GemmPart part0, GemmPart part1, int lda, int ldb, int ldc,
                int m_len, int k_len) {
  const GemmPart g = blockIdx.z == 0 ? part0 : part1;
  const int m0 = blockIdx.x * kGemmM, n0 = blockIdx.y * kGemmN;
  if (n0 >= g.n_len) return;            // the narrower part's spare tiles
  const float* __restrict__ a0 = g.a0;
  const float* __restrict__ a1 = g.a1;
  const float* __restrict__ b = g.b;
  const int split = g.split, n_len = g.n_len;
  // rows 4 floats longer than the tile: S's rows land on other banks
  __shared__ __align__(16) float a_s[kGemmK][kGemmM + 4];
  __shared__ __align__(16) float b_s[kGemmK][kGemmN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.0f;
  float ra[8], rb[4];

  // element (kk, mm) of the A tile that element idx of a thread's loads
  // is: consecutive threads read consecutive addresses of S
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int idx = tid + i * kThreads, kk = idx % kGemmK;
      const int k = k0 + kk, m = m0 + idx / kGemmK;
      const float* row = m < split ? a0 + static_cast<size_t>(m) * lda
                                   : a1 + static_cast<size_t>(m - split) * lda;
      ra[i] = (k < k_len && m < m_len) ? row[k] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * kThreads, k = k0 + idx / kGemmN;
      const int n = n0 + idx % kGemmN;
      rb[i] = (k < k_len && n < n_len)
          ? b[static_cast<size_t>(k) * ldb + n] : 0.0f;
    }
  };

  fetch(0);
  for (int k0 = 0; k0 < k_len; k0 += kGemmK) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int idx = tid + i * kThreads;
      a_s[idx % kGemmK][idx / kGemmK] = ra[i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * kThreads;
      b_s[idx / kGemmN][idx % kGemmN] = rb[i];
    }
    __syncthreads();
    if (k0 + kGemmK < k_len) fetch(k0 + kGemmK);   // in flight meanwhile
#pragma unroll
    for (int rr = 0; rr < kGemmK; ++rr) {
      const float4 a_lo = *reinterpret_cast<const float4*>(&a_s[rr][ty * 8]);
      const float4 a_hi =
          *reinterpret_cast<const float4*>(&a_s[rr][ty * 8 + 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&b_s[rr][tx * 4]);
      const float av[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w,
                           a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          acc[i][jj] = fmaf(av[i], bv[jj], acc[i][jj]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty * 8 + i;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int n = n0 + tx * 4 + jj;
      if (m < m_len && n < n_len) g.c[static_cast<size_t>(m) * ldc + n] =
          acc[i][jj];
    }
  }
}

// One rnn_gemm_kernel launch on stream s of one product, or of two
// (part1.c not null) side by side.
void rnn_gemm(GemmPart part0, GemmPart part1, int lda, int ldb, int ldc,
              int m_len, int k_len, cudaStream_t s) {
  const int parts = part1.c == nullptr ? 1 : 2;
  const int n_len = parts == 2 && part1.n_len > part0.n_len ? part1.n_len
                                                            : part0.n_len;
  const dim3 grid((m_len + kGemmM - 1) / kGemmM,
                  (n_len + kGemmN - 1) / kGemmN, parts);
  rnn_gemm_kernel<<<grid, kThreads, 0, s>>>(part0, part1, lda, ldb, ldc,
                                            m_len, k_len);
}

// What a kernel of `kind` runs with at width h on this card: U units a block
// (ceil(h / U) blocks, at most one per SM: the least U of 1, 2, 4 whose
// slices of w fit in shared memory beside the staging area, else the least
// of 8, 16, with the slices in global scratch; above 16 x the SMs, U 16 in
// passes on one block per SM), its dynamic shared memory, and the floats of
// global scratch it needs (0: none).
enum Kind { kLstmFwd = 0, kLstmBwd = 1, kGruFwd = 2, kGruBwd = 3 };

int slice_floats(int kind, int h, int u) {
  switch (kind) {
    case kLstmFwd: return lstm_fwd_slice(h, u);
    case kLstmBwd: return lstm_bwd_slice(h, u);
    case kGruFwd: return gru_fwd_slice(h, u);
    default: return gru_bwd_slice(h, u);
  }
}

// as, then red: the staged chunk of a product's left operand, whose depth is
// H (forward), 4H (LSTM backward) or 2H (GRU backward), and its partial sums
int stage_floats(int kind, int h) {
  const int depth = kind == kLstmBwd ? 4 * h : kind == kGruBwd ? 2 * h : h;
  return kBT * (chunk_of(depth) + 4) + kRed;
}

struct Plan {
  int u = 0;
  int sms = 0;
  int blocks = 0;
  bool passes = false;
  size_t smem = 0;
  long long scratch = 0;
};

cudaError_t plan_for(int kind, int h, Plan* p) {
  int dev = 0, coop = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&p->sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const size_t stage = sizeof(float) * stage_floats(kind, h);
  for (int u = 1; u <= kMaxU; u *= 2) {
    const int blocks = (h + u - 1) / u;
    if (blocks > p->sms) continue;
    const size_t slices = sizeof(float) *
                          static_cast<size_t>(slice_floats(kind, h, u));
    p->u = u;
    p->blocks = blocks;
    if (u <= kMaxSmemU) {
      if (slices + stage > static_cast<size_t>(optin)) continue;
      p->smem = slices + stage;
      p->scratch = 0;
    } else {
      p->smem = stage;
      p->scratch = static_cast<long long>(blocks) * slice_floats(kind, h, u);
    }
    return cudaSuccess;
  }
  // wider than 16 units on every SM: groups of 16 units in passes
  if (stage > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  const long long groups = (h + kMaxU - 1) / kMaxU;
  p->u = kMaxU;
  p->blocks = p->sms;
  p->passes = true;
  p->smem = stage;
  p->scratch = groups * pass_floats(slice_floats(kind, h, kMaxU),
                                    kind == kLstmBwd);
  return cudaSuccess;
}

// One cooperative launch of `kernel` on the plan's blocks, after checking
// that the card holds them all at once.
template <typename Kernel>
cudaError_t launch_grid(Kernel kernel, const Plan& plan, void** args,
                        cudaStream_t s) {
  const size_t smem_bytes = plan.smem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem_bytes);
  if (err != cudaSuccess) return err;
  if (plan.blocks > per_sm * plan.sms)
    return cudaErrorCooperativeLaunchTooLarge;
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                     dim3(plan.blocks), dim3(kThreads), args,
                                     smem_bytes, s);
}

// The launch of kernel template K at the plan's U (1, 2, 4, 8 or 16, or 16
// in passes).
#define PADDLE_RNN_LAUNCH(K, plan, h, args, s)                      \
  ((plan).passes    ? launch_grid(K<16, true>, plan, args, s)      \
   : (plan).u == 1  ? launch_grid(K<1>, plan, args, s)             \
   : (plan).u == 2  ? launch_grid(K<2>, plan, args, s)             \
   : (plan).u == 4  ? launch_grid(K<4>, plan, args, s)             \
   : (plan).u == 8  ? launch_grid(K<8>, plan, args, s)             \
                    : launch_grid(K<16>, plan, args, s))

// The plan of a launch, checked against the scratch the caller passed.
cudaError_t checked_plan(int kind, int t_len, int b_len, int h,
                         const float* wscratch, Plan* p) {
  if (t_len < 1 || b_len < 1 || h < 1) return cudaErrorInvalidValue;
  cudaError_t err = plan_for(kind, h, p);
  if (err != cudaSuccess) return err;
  if (p->scratch > 0 && wscratch == nullptr) return cudaErrorInvalidValue;
  return cudaSuccess;
}


// ---- LSTM backward on thread-block clusters and tensor cores ---------------
//
// lstm_bwd_cluster_kernel computes what lstm_bwd_kernel computes, at H <= 512
// and H a multiple of 4, for any T and B. What held lstm_bwd_kernel back was
// traffic more than arithmetic: every step each of its 128 blocks staged all
// of h_prev[t] (128 KB) from L2 for phase A and read all of dx[t] (512 KB)
// back for phase B, 80 MB a step through L2, and its products ran outside
// the tensor cores. Here:
//   * Clusters of C = 2 blocks (kCC). Block g owns units [4g, 4g + 4) for
//     the cell as before (U = 4, 16 gate columns), ceil(H / 4) blocks
//     rounded up to whole clusters; a cluster owns the 4C units of its
//     blocks, 16C gate columns. At one block an SM the H100's GPCs hold
//     66 clusters of 2 but only 30 of 4 and 15 of 8, and H 512 takes 128
//     blocks: 2 is the one size that fits every width up to 512. The
//     wrapper's lstm_plan checks that every cluster fits at once
//     (cudaOccupancyMaxActiveClusters).
//   * Both products split the depth across the cluster. Block rank q holds
//     W_q = w[q kh .. q kh + kh)[the cluster's 16C columns] (kh = ceil(H /
//     C) rounded up to 64, rows past H zero), split into TF32 hi and lo, in
//     shared memory for the whole sequence: as W_q^T for phase A and as
//     W_q for phase B.
//   * Phase A: each block stages columns [q kh, q kh + kh) of the live rows
//     of h_prev[t] (cp.async, issued a pass ahead: h_prev is an input), so
//     the cluster reads h_prev from L2 once, and multiplies them by W_q on
//     the tensor cores: a [64, 16C] partial of the cluster's gates. Each
//     block sends the partial of every peer's 16 columns into that peer's
//     shared memory (distributed shared memory); the owner adds the C
//     partials in rank order and runs the cell.
//   * Phase B: each block sends its 16 columns of dgates, split into TF32
//     hi and lo, into every block of the cluster, and multiplies them by
//     W_q^T: columns [q kh, q kh + kh) of a [64, H] partial of Dh = dgates @
//     w^T over the cluster's columns, written to global memory. After the
//     grid barrier each block adds the ceil(H / 4) / C clusters' partials of
//     its own units in a fixed order. No block reads all of dx[t]: per
//     step a block stages 64 x kh floats, sends 2 x 16C x 64 and writes
//     64 x kh.
//   * The products are wgmma (TF32, two warpgroups) at fp32 accuracy through
//     3xTF32: a = hi + lo, a product hi*hi + (hi*lo + lo*hi), each term in
//     its own accumulators. Phase A's left operand (h_prev) comes from
//     registers, split where it is loaded; its right one, and both of phase
//     B's, from shared memory in the 128-byte-swizzled K-major layout
//     wgmma reads (W_q^T, W_q, the exchanged gate gradients). The two
//     warpgroups split phase A's depth; each of the three terms has its
//     own accumulators.
//   * One grid barrier a step, hand-written (an arrival counter:
//     red.release and an ld.acquire spin that traps after 2^35 cycles), on
//     a cooperative launch of the cluster grid (cudaLaunchKernelEx with
//     both attributes), whose blocks the card holds at once. The counter
//     is never reset: a launch takes the value it starts from (`base`) and
//     adds T x blocks, and the wrapper keeps one counter and its value a
//     stream, so no launch zeroes it.
// Batches above 64 rows take passes of 64 rows, two cluster barriers each.
// Every sum runs in a fixed order: two runs give the same bits.

constexpr int kCC = 2;              // blocks of a cluster
constexpr int kCU = 4;              // units of a block
constexpr int kCN = 4 * kCU;        // its gate columns
constexpr int kCMaxH = 512;         // widest H of the cluster kernel
constexpr int kGN = 3 * kCU * kCC;  // the GRU cluster's gate columns (24)
constexpr int kGfWG = 4;            // warpgroups of the GRU forward's block
constexpr int kGfThreads = 128 * kGfWG;

// the rows of w that a block of a cluster holds: ceil(H / C) rounded up to
// the 64 rows of a wgmma tile
__host__ __device__ constexpr int lstm_cluster_kh(int h) {
  return round_up((h + kCC - 1) / kCC, 64);
}

// bytes of the cluster kernels' shared memory regions, by kind (the
// forwards have no W_q and no gate gradients; the GRU backward has no W_q,
// which it keeps in registers, and stages rh beside h_prev; the GRU
// forward stages h_prev and rh in turn in one buffer)
struct ClusterSmem {
  int wt, wq, dg, hs, rs, pa, rx;  // W_q^T, W_q, the gate gradients: hi and
                                   // lo each; the staged rows, partials
  __host__ __device__ ClusterSmem(int h, int kind) {
    const int kh = lstm_cluster_kh(h);
    const bool fwd = kind == kLstmFwd || kind == kGruFwd;
    const bool gru = kind == kGruFwd || kind == kGruBwd;
    wt = (gru ? kGN : kCN * kCC) * kh * 4;              // [16C or 24][kh]
    wq = fwd || gru ? 0 : wt;                           // [kh][16C]
    dg = fwd ? 0 : kBT * kCN * kCC * 4;                 // [64][32]
    hs = kBT * (kh + 4) * 4;                            // [64][kh + 4]
    rs = kind == kGruBwd ? hs : 0;                      // rh, the same
    pa = kCC * (kind == kGruFwd ? kGfWG : 2) * kBT *    // [C][parts][64][n]
         (gru ? 3 * kCU : kCN) * 4;
    rx = kind == kGruBwd ? kCU * kBT * 4 : 0;           // [4][64]
  }
  __host__ __device__ size_t bytes() const {          // + 1024: alignment
    return 1024 + 2 * (static_cast<size_t>(wt) + wq + dg) + hs + rs + pa +
           rx;
  }
};

__device__ __forceinline__ uint32_t tf32_bits(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(a));
  return r;
}

// a = hi + lo, both TF32 (|a - hi - lo| <= 2^-22 |a|)
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_bits(a);
  lo = tf32_bits(a - __uint_as_float(hi));
}

// Element (r, k) of a [rows][K] operand that wgmma reads K-major with the
// 128-byte swizzle: K / 32 boxes of rows x 128 bytes (1024-byte aligned),
// the 16-byte chunks of row r XORed with r % 8.
__device__ __forceinline__ int sw_at(int rows, int r, int k) {
  return (k >> 5) * rows * 32 + r * 32 + ((((k >> 2) & 7) ^ (r & 7)) << 2) +
         (k & 3);
}

// the wgmma descriptor of such a box from row 0 at p: start address, leading
// offset 16 B (unused), 1024 B between groups of 8 rows, 128-byte swizzle
__device__ __forceinline__ uint64_t sw_desc(const float* p) {
  const uint64_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n"
               "wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// the accumulators are settled after the wait: no read of them moves above it
template <int N>
__device__ __forceinline__ void settle(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// a wgmma's register operand stays live (and unchanged) up to here: no
// other value takes its registers while the wgmma may still read them
template <int S>
__device__ __forceinline__ void hold(uint32_t (&a)[S][4]) {
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[s][e])::"memory");
}

// d += A (64 rows) x B (N rows)^T over 8 of depth, both from K-major
// swizzled boxes (descriptors a, b); N = 32 or 64
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// d += A (64 rows, from registers: the m16n8k8 TF32 fragment of each warp's
// 16 rows) x B (N rows of a K-major swizzled box, descriptor b)^T over 8 of
// depth; N = 8, 16, 32 or 64 (4, 8, 16 or 32 accumulators a thread)
__device__ __forceinline__ void wgmma_rs(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[8],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;"
      "\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// big += Ahi Bhi; small += Ahi Blo + Alo Bhi over 8 of depth
template <int R>
__device__ __forceinline__ void wgmma_3x(float (&big)[R], float (&small)[R],
                                         const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4],
                                         uint64_t bh, uint64_t bl) {
  wgmma_rs(big, ah, bh);
  wgmma_rs(small, ah, bl);
  wgmma_rs(small, al, bh);
}

// The grid barrier: every block's thread 0 adds one to *count and waits
// until it reaches `target` (the count the launch started from plus the
// barrier's number times the blocks; compared modulo 2^32, so the count
// may wrap); writes before it are visible to every block after it. Split
// in two, so that a block can work on what does not depend on the other
// blocks between its arrival and its wait.
__device__ __forceinline__ void grid_arrive(unsigned* count) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(count)
                 : "memory");
  }
}

__device__ __forceinline__ void grid_wait(unsigned* count, unsigned target) {
  if (threadIdx.x == 0) {
    const long long t0 = clock64();
    unsigned seen = 0;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(seen)
                   : "l"(count)
                   : "memory");
      if (static_cast<int>(seen - target) < 0 &&
          clock64() - t0 > (1ll << 35))
        __trap();
    } while (static_cast<int>(seen - target) < 0);
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ void grid_barrier(unsigned* count,
                                             unsigned target) {
  grid_arrive(count);
  grid_wait(count, target);
}

// Where a cluster's partial of Dh for (row position pos, hidden unit k)
// lies in its step's buffer: eight units of a row (32 bytes, one sector)
// for each cluster in turn, so that phase B writes, and the reduce reads,
// whole sectors.
__device__ __forceinline__ size_t part_at(int pos, int k, int cl,
                                          int clusters, int h) {
  return ((static_cast<size_t>(pos) * ((h + 7) / 8) + k / 8) * clusters +
          cl) * 8 + (k & 7);
}

// Phase B of the cluster kernel with both operands in shared memory: the
// pass's gate gradients dg [64, 16C] (A) times W_q [kh, 16C]^T (B) over the
// cluster's kxn columns, for N columns from column n0 of the block's depth.
// Writes rows < rows of the partial of Dh into the step's buffer pt.
template <int N>
__device__ __forceinline__ void product_b_ss(
    const float* dg_hi, const float* dg_lo, const float* wq_hi,
    const float* wq_lo, int kxn, int kh, int n0, float* pt, int r0, int rows,
    int k0q, int cl, int clusters, int h) {
  constexpr int kR = N / 2;
  const int lane = threadIdx.x % 32, wq = threadIdx.x / 32 % 4;
  const int g8 = lane / 4, tig = lane % 4;
  float big[kR], sa[kR], sb[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) big[i] = sa[i] = sb[i] = 0.f;
  wg_fence();
  for (int kb = 0; kb < kxn; kb += 32) {
    const size_t abox = static_cast<size_t>(kb >> 5) * kBT * 32;
    const size_t bbox = static_cast<size_t>(kb >> 5) * kh * 32 +
                        static_cast<size_t>(n0) * 32;
    const uint64_t ah = sw_desc(dg_hi + abox), al = sw_desc(dg_lo + abox);
    const uint64_t bh = sw_desc(wq_hi + bbox), bl = sw_desc(wq_lo + bbox);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      wgmma_ss(big, ah + 2 * s, bh + 2 * s);
      wgmma_ss(sa, ah + 2 * s, bl + 2 * s);
      wgmma_ss(sb, al + 2 * s, bh + 2 * s);
    }
  }
  wg_commit_wait();
  settle(big);
  settle(sa);
  settle(sb);
#pragma unroll
  for (int jn = 0; jn < N / 8; ++jn)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = 16 * wq + g8 + 8 * hh;
      const int k = k0q + n0 + 8 * jn + 2 * tig;
      if (row < rows && k < h) {
        const int i = 4 * jn + 2 * hh;
        __stcg(reinterpret_cast<float2*>(
                   pt + part_at(r0 + row, k, cl, clusters, h)),
               make_float2(big[i] + sa[i] + sb[i],
                           big[i + 1] + sa[i + 1] + sb[i + 1]));
      }
    }
}

__global__ void __launch_bounds__(kThreads, 1)
lstm_bwd_cluster_kernel(const float* __restrict__ x,
                        const float* __restrict__ w,
                        const float* __restrict__ peep,
                        const int* __restrict__ lens,
                        const int* __restrict__ order,
                        const int* __restrict__ live,
                        const float* __restrict__ h0,
                        const float* __restrict__ c0,
                        const float* __restrict__ hidden,
                        const float* __restrict__ cell,
                        const float* __restrict__ dhid,
                        const float* __restrict__ dcell,
                        const float* __restrict__ dhlast,
                        const float* __restrict__ dclast, float* dx,
                        float* __restrict__ dpeep, float* dh0, float* dc0,
                        float* part, unsigned* count, unsigned base,
                        int t_len, int b_len, int h) {
  constexpr int kXN = kCN * kCC;             // the cluster's gate columns
  constexpr int kHalves = 2;                 // partial gates from a peer
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ char smem_raw[];
  const ClusterSmem lay(h, kLstmBwd);
  const int kh = lstm_cluster_kh(h), hst = kh + 4;
  float* wt_hi = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* wt_lo = wt_hi + lay.wt / 4;         // W_q^T [16C][kh], sw_at
  float* wq_hi = wt_lo + lay.wt / 4;         // W_q [kh][16C], sw_at
  float* wq_lo = wq_hi + lay.wq / 4;
  float* dg_hi = wq_lo + lay.wq / 4;         // gate gradients [64][16C]
  float* dg_lo = dg_hi + lay.dg / 4;
  float* hs = dg_lo + lay.dg / 4;            // [64][kh + 4] fp32
  float* pa = hs + lay.hs / 4;               // [C][halves][64][16] fp32
  const int tid = threadIdx.x, lane = tid % 32;
  // the warpgroup (uniform to the compiler, or it serializes the wgmmas)
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0), wq = tid / 32 % 4;
  const int g8 = lane / 4, tig = lane % 4;
  const int q = static_cast<int>(cluster.block_rank());
  const int clusters = gridDim.x / kCC, cl = blockIdx.x / kCC;
  const int u0 = blockIdx.x * kCU, k0q = q * kh;

  // W_q^T: element (n, k), n = q' * 16 + u * 4 + gate of the cluster's
  // columns, is w[q kh + k][gate * H + (cl C + q') * 4 + u]
  for (int idx = tid; idx < kXN * kh; idx += kThreads) {
    const int n = idx / kh, k = idx % kh, kk = k0q + k;
    const int j = (cl * kCC + n / kCN) * kCU + n % kCN / 4;
    uint32_t hi = 0, lo = 0;
    if (kk < h && j < h)
      split_tf32(w[static_cast<size_t>(kk) * 4 * h + (n % 4) * h + j], hi, lo);
    wt_hi[sw_at(kXN, n, k)] = __uint_as_float(hi);
    wt_lo[sw_at(kXN, n, k)] = __uint_as_float(lo);
    wq_hi[sw_at(kh, k, n)] = __uint_as_float(hi);
    wq_lo[sw_at(kh, k, n)] = __uint_as_float(lo);
  }
  for (int idx = tid; idx < lay.hs / 4; idx += kThreads) hs[idx] = 0.0f;
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();                     // the zeros before any staged row

  // stage columns [q kh, q kh + kh) of the pass's rows of h_prev into hs
  auto stage = [&](int tt, int rr) {
    const float* hp = tt == 0 ? h0 : hidden + static_cast<size_t>(tt - 1) *
                                              b_len * h;
    const int rows = min(kBT, live[tt] - rr), c4 = kh / 4;
    for (int idx = tid; idx < rows * c4; idx += kThreads) {
      const int i = idx / c4, c = idx % c4 * 4, k = k0q + c;
      const bool valid = k < h;
      copy16(hs + i * hst + c,
             valid ? hp + static_cast<size_t>(order[rr + i]) * h + k : hp,
             valid);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  int first = t_len - 1;
  while (first > 0 && live[first] == 0) --first;
  if (live[first] > 0) stage(first, 0);
  cluster.sync();

  // this thread's (row, unit) pair of a pass: row tid / 4, unit j
  const int bl = tid / kCU, ju = tid % kCU, j = u0 + ju;
  const bool unit = j < h;
  float w_ic = 0.f, w_fc = 0.f, w_oc = 0.f;
  if (unit) {
    w_ic = peep[j];
    w_fc = peep[h + j];
    w_oc = peep[2 * h + j];
  }
  const size_t bh = static_cast<size_t>(b_len) * h;
  const size_t pstride = static_cast<size_t>(clusters) * b_len * h;
  float dp_i = 0.f, dp_f = 0.f, dp_o = 0.f;
  unsigned target = base;

  for (int t = t_len - 1; t >= 0; --t) {
    const float* cp_seq = t == 0 ? c0 : cell + (t - 1) * bh;
    float* dxt = dx + static_cast<size_t>(t) * b_len * 4 * h;
    float* pt = part + (t & 1) * pstride;    // this step's partials of Dh
    const int n_live = live[t];

    for (int r0 = 0; r0 < n_live; r0 += kBT) {
      const int rows = min(kBT, n_live - r0);
      // the cell's inputs, in flight while the staged rows land
      // (all loaded at once and used only in the cell, after product A)
      const bool alive = unit && bl < rows;
      const int b = alive ? order[r0 + bl] : 0;
      const size_t at = static_cast<size_t>(b) * h + j;
      float xg[4] = {0.f, 0.f, 0.f, 0.f}, cp = 0.f;
      float in_h[3] = {0.f, 0.f, 0.f}, in_c[3] = {0.f, 0.f, 0.f};
      int len_b = 0;
      if (alive) {
        const float* xr =
            x + (static_cast<size_t>(t) * b_len + b) * 4 * h + j;
#pragma unroll
        for (int g = 0; g < 4; ++g) xg[g] = xr[g * h];
        cp = cp_seq[at];
        len_b = lens[b];
        in_h[0] = dhlast[at];
        in_h[1] = dh0[at];
        in_h[2] = dhid[static_cast<size_t>(t) * bh + at];
        in_c[0] = dclast[at];
        in_c[1] = dc0[at];
        in_c[2] = dcell[static_cast<size_t>(t) * bh + at];
      }
      asm volatile("cp.async.wait_group 0;" ::: "memory");
      __syncthreads();
      // staged

      // product A: the cluster's gates over this block's depth, [64, 16C];
      // warpgroup wg takes half the depth (all 16C columns, each half sent
      // as its own partial)
      {
        const int kb0 = wg * kh / 2, kb1 = kb0 + kh / 2;
        constexpr int kR = kXN / 2;
        float big[kR], sa[kR], sb[kR];
#pragma unroll
        for (int i = 0; i < kR; ++i) big[i] = sa[i] = sb[i] = 0.f;
        const int r = 16 * wq + g8;
        for (int kb = kb0; kb < kb1; kb += 32) {     // one box of depth
          uint32_t ah[4][4], al[4][4];
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const int k = kb + 8 * s + tig;
            split_tf32(hs[r * hst + k], ah[s][0], al[s][0]);
            split_tf32(hs[(r + 8) * hst + k], ah[s][1], al[s][1]);
            split_tf32(hs[r * hst + k + 4], ah[s][2], al[s][2]);
            split_tf32(hs[(r + 8) * hst + k + 4], ah[s][3], al[s][3]);
          }
          const size_t box = static_cast<size_t>(kb >> 5) * kXN * 32;
          const uint64_t dh = sw_desc(wt_hi + box), dl = sw_desc(wt_lo + box);
          wg_fence();
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            wgmma_rs(big, ah[s], dh + 2 * s);
            wgmma_rs(sa, ah[s], dl + 2 * s);
            wgmma_rs(sb, al[s], dh + 2 * s);
          }
          wg_commit_wait();
          settle(big);
          settle(sa);
          settle(sb);
        }
        // each owner's 16 columns into its pa[q][half]
#pragma unroll
        for (int jn = 0; jn < kXN / 8; ++jn) {
          const int n = 8 * jn + 2 * tig, owner = n / kCN;
          float* dst = cluster.map_shared_rank(pa, owner) +
                       (q * kHalves + wg) * kBT * kCN + n % kCN;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = r + 8 * hh, i = 4 * jn + 2 * hh;
            if (row < rows)
              *reinterpret_cast<float2*>(dst + row * kCN) = make_float2(
                  big[i] + sa[i] + sb[i], big[i + 1] + sa[i + 1] + sb[i + 1]);
          }
        }
      }
      cluster.sync();                  // every partial of the gates landed
      if (r0 + kBT < n_live) stage(t, r0 + kBT);   // the next pass's rows

      // the cell of this thread's pair
      float4 dg = make_float4(0.f, 0.f, 0.f, 0.f);
      if (alive) {
        // a row's carries start at the cotangents of its last states
        const bool last = t + 1 == t_len || t + 1 == len_b;
        const float gh = (last ? in_h[0] : in_h[1]) + in_h[2];
        const float gcell = (last ? in_c[0] : in_c[1]) + in_c[2];
        float gate[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float s = 0.f;
          for (int p = 0; p < kCC * kHalves; ++p)
            s += pa[(p * kBT + bl) * kCN + ju * 4 + g];
          gate[g] = xg[g] + s;
        }
        const float i = sigmoidf(gate[0] + cp * w_ic);
        const float f = sigmoidf(gate[1] + cp * w_fc);
        const float g = tanhf(gate[2]);
        const float c_cand = f * cp + i * g;
        const float og = sigmoidf(gate[3] + c_cand * w_oc);
        const float tanh_c = tanhf(c_cand);
        const float dgo = gh * tanh_c * og * (1.0f - og);
        const float dc_cand =
            gcell + gh * og * (1.0f - tanh_c * tanh_c) + dgo * w_oc;
        const float dgi = dc_cand * g * i * (1.0f - i);
        const float dgf = dc_cand * cp * f * (1.0f - f);
        const float dgg = dc_cand * i * (1.0f - g * g);
        float* dxr = dxt + static_cast<size_t>(b) * 4 * h + j;
        dxr[0] = dgi;
        dxr[h] = dgf;
        dxr[2 * h] = dgg;
        dxr[3 * h] = dgo;
        dc0[at] = dc_cand * f + dgi * w_ic + dgf * w_fc;
        dp_i = fmaf(dgi, cp, dp_i);
        dp_f = fmaf(dgf, cp, dp_f);
        dp_o = fmaf(dgo, c_cand, dp_o);
        dg = make_float4(dgi, dgf, dgg, dgo);
      }
      // cluster exchange: the block's 16 columns of dgates, hi and lo, into
      // every block's gate gradients
      {
        uint32_t hi[4], lo[4];
        split_tf32(dg.x, hi[0], lo[0]);
        split_tf32(dg.y, hi[1], lo[1]);
        split_tf32(dg.z, hi[2], lo[2]);
        split_tf32(dg.w, hi[3], lo[3]);
        const int at_dg = sw_at(kBT, bl, q * kCN + ju * 4);
#pragma unroll
        for (int p = 0; p < kCC; ++p) {
          *reinterpret_cast<uint4*>(cluster.map_shared_rank(dg_hi, p) +
                                    at_dg) =
              make_uint4(hi[0], hi[1], hi[2], hi[3]);
          *reinterpret_cast<uint4*>(cluster.map_shared_rank(dg_lo, p) +
                                    at_dg) =
              make_uint4(lo[0], lo[1], lo[2], lo[3]);
        }
      }
      asm volatile("fence.proxy.async.shared::cluster;" ::: "memory");
      cluster.sync();                  // every gate gradient has landed
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");

      // phase B: the gate gradients [64, 16C] times W_q^T [16C, kh]: columns
      // [q kh, q kh + kh) of the cluster's partial of Dh for the pass's
      // rows, both operands in shared memory; warpgroup wg takes columns
      // [wg kh / 2, ..), in chunks of at most 64
      const int nw = kh / 2;
      for (int c = 0; c < nw; c += 64) {
        const int n0 = wg * nw + c;
        if (nw - c >= 64)
          product_b_ss<64>(dg_hi, dg_lo, wq_hi, wq_lo, kXN, kh, n0, pt, r0,
                           rows, k0q, cl, clusters, h);
        else
          product_b_ss<32>(dg_hi, dg_lo, wq_hi, wq_lo, kXN, kh, n0, pt, r0,
                           rows, k0q, cl, clusters, h);
      }
    }
    // the rows past their length: no gate gradient, the carries stay
    if (unit) {
      for (int r = n_live + bl; r < b_len; r += kBT) {
        const int b = order[r];
        float* dxr = dxt + static_cast<size_t>(b) * 4 * h + j;
        dxr[0] = dxr[h] = dxr[2 * h] = dxr[3 * h] = 0.0f;
        if (t == 0) {                  // a row of length 0 hands them on
          const size_t at = static_cast<size_t>(b) * h + j;
          dh0[at] = dhlast[at];
          dc0[at] = dclast[at];
        }
      }
    }
    if (t > 0 && n_live > 0) stage(t - 1, 0);   // the next step's rows
    grid_barrier(count, target += gridDim.x);

    // reduce: Dh of the cluster's units from the clusters' partials. Rank q
    // adds clusters [q per, (q + 1) per) for every unit of its cluster (kS
    // threads an item, their sums added in order), and sends each owner
    // its four units' sums; the owner adds the C ranks' sums in order.
    {
      constexpr int kS = kThreads / (kBT * kCC);
      static_assert(kS == 2, "two threads an item");
      const int per = (clusters + kCC - 1) / kCC, cq0 = q * per;
      const int cq1 = min(clusters, cq0 + per), sub = (per + kS - 1) / kS;
      float* rx = dg_hi;                       // [C ranks][64][4], free now
      for (int rb = 0; rb < n_live; rb += kBT) {
        for (int it = tid; it < kBT * kCC * kS; it += kThreads) {
          const int item = it / kS, part = it % kS;
          const int row = item / kCC, p = item % kCC, r = rb + row;
          const int u = (cl * kCC + p) * kCU;  // the owner's first unit
          const int c0 = cq0 + part * sub, c1 = min(cq1, c0 + sub);
          float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
          if (r < n_live && u < h) {
            const float* src = pt + part_at(r, u, 0, clusters, h);
            for (int c = c0; c < c1; c += 16) {
              float4 v[16];
#pragma unroll
              for (int i = 0; i < 16; ++i)
                v[i] = c + i < c1 ? __ldcg(reinterpret_cast<const float4*>(
                                        src + static_cast<size_t>(c + i) * 8))
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
              for (int i = 0; i < 16; ++i)
                if (c + i < c1) {
                  const bool first = c + i == c0;
                  sum.x = first ? v[i].x : sum.x + v[i].x;
                  sum.y = first ? v[i].y : sum.y + v[i].y;
                  sum.z = first ? v[i].z : sum.z + v[i].z;
                  sum.w = first ? v[i].w : sum.w + v[i].w;
                }
            }
          }
          {                    // the two halves (a + b is b + a exactly)
            const float4 o = make_float4(
                __shfl_xor_sync(0xffffffffu, sum.x, 1),
                __shfl_xor_sync(0xffffffffu, sum.y, 1),
                __shfl_xor_sync(0xffffffffu, sum.z, 1),
                __shfl_xor_sync(0xffffffffu, sum.w, 1));
            sum = make_float4(sum.x + o.x, sum.y + o.y, sum.z + o.z,
                              sum.w + o.w);
          }
          if (part == 0 && r < n_live)
            *reinterpret_cast<float4*>(cluster.map_shared_rank(rx, p) +
                                       (q * kBT + row) * kCU) = sum;
        }
        cluster.sync();                        // every rank's sums landed
        const int r = rb + bl;
        if (r < n_live && unit) {
          float dh = rx[bl * kCU + ju];
          for (int p = 1; p < kCC; ++p) dh += rx[(p * kBT + bl) * kCU + ju];
          dh0[static_cast<size_t>(order[r]) * h + j] = dh;
        }
        if (rb + kBT < n_live) cluster.sync(); // rx is read before reuse
      }
    }
    // end of a step
  }

  // dpeep of the block's units: the 64 row shares, added in row order
  __syncthreads();
  pa[(0 * kBT + bl) * kCU + ju] = dp_i;
  pa[(1 * kBT + bl) * kCU + ju] = dp_f;
  pa[(2 * kBT + bl) * kCU + ju] = dp_o;
  __syncthreads();
  if (tid < 3 * kCU && u0 + tid % kCU < h) {
    const int which = tid / kCU, u = tid % kCU;
    float s = 0.0f;
    for (int r = 0; r < kBT; ++r) s += pa[(which * kBT + r) * kCU + u];
    dpeep[which * h + u0 + u] = s;
  }
  cluster.sync();                      // no peer reads this block's memory
}

// ---- LSTM forward on thread-block clusters and tensor cores ----------------
//
// lstm_fwd_cluster_kernel computes what lstm_fwd_kernel computes, at the
// widths of the cluster backward (H <= 512, H a multiple of 4), for any T and
// B. Its step is the backward's phase A (lstm_bwd_cluster_kernel above): on
// clusters of C = 2 blocks (kCC), block g owning units [4g, 4g + 4) for the
// cell, block rank q holding W_q^T = w[q kh .. q kh + kh)[the cluster's 16C
// gate columns]^T, split into TF32 hi and lo, in shared memory for the whole
// sequence. Each step each block stages columns [q kh, q kh + kh) of the live
// rows of the state h (cp.async through L2: the carry was written by other
// SMs before the last grid barrier), so the cluster reads the state once
// where each of lstm_fwd_kernel's blocks read all of it (16 MB a step across
// its 128 blocks at B 64, H 512), multiplies them by W_q on the tensor cores
// (wgmma, 3xTF32, the two warpgroups splitting the depth) and sends each
// peer the partial of its 16 columns through distributed shared memory; the
// owner adds the C x 2 partials in rank order to xproj[t] and runs the cell.
// No carry buffer: a row inside its length at step t was inside it at step
// t - 1, so its state is hidden[t - 1] (h0 at t = 0) and its cell state
// cell[t - 1] (c0), which the owner of the pair wrote itself. One grid
// barrier a step (the hand-written counter of the backward, the same
// stream's counter). The state of step t exists only after step t - 1's
// barrier, so nothing of it can be loaded ahead; the cell's inputs
// (xproj[t], the cell state) load while the staged rows land. (Taking the
// product box by box as the staged boxes land, or in twice the chains of
// accumulators, gained nothing on the card: the staging and the product
// add up whatever their overlap. tools/torch_lstm_cycles.py splits a step.)
// The steps past each row's length are zeroed before the recurrence.
// Batches above 64 rows take passes of 64 rows. Every sum runs in a fixed
// order: two runs give the same bits.
__global__ void __launch_bounds__(kThreads, 1)
lstm_fwd_cluster_kernel(const float* __restrict__ x,
                        const float* __restrict__ w,
                        const float* __restrict__ peep,
                        const int* __restrict__ lens,
                        const int* __restrict__ order,
                        const int* __restrict__ live,
                        const float* __restrict__ h0,
                        const float* __restrict__ c0, float* hidden,
                        float* cell, float* __restrict__ hlast,
                        float* __restrict__ clast, unsigned* count,
                        unsigned base, int t_len, int b_len, int h) {
  constexpr int kXN = kCN * kCC;             // the cluster's gate columns
  constexpr int kHalves = 2;                 // partial gates from a peer
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ char smem_raw[];
  const ClusterSmem lay(h, kLstmFwd);
  const int kh = lstm_cluster_kh(h), hst = kh + 4;
  float* wt_hi = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* wt_lo = wt_hi + lay.wt / 4;         // W_q^T [16C][kh], sw_at
  float* hs = wt_lo + lay.wt / 4;            // [64][kh + 4] fp32
  float* pa = hs + lay.hs / 4;               // [C][halves][64][16] fp32
  const int tid = threadIdx.x, lane = tid % 32;
  // the warpgroup (uniform to the compiler, or it serializes the wgmmas)
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0), wq = tid / 32 % 4;
  const int g8 = lane / 4, tig = lane % 4;
  const int q = static_cast<int>(cluster.block_rank());
  const int cl = blockIdx.x / kCC;
  const int u0 = blockIdx.x * kCU, k0q = q * kh;

  // W_q^T: element (n, k), n = q' * 16 + u * 4 + gate of the cluster's
  // columns, is w[q kh + k][gate * H + (cl C + q') * 4 + u]
  for (int idx = tid; idx < kXN * kh; idx += kThreads) {
    const int n = idx / kh, k = idx % kh, kk = k0q + k;
    const int j = (cl * kCC + n / kCN) * kCU + n % kCN / 4;
    uint32_t hi = 0, lo = 0;
    if (kk < h && j < h)
      split_tf32(w[static_cast<size_t>(kk) * 4 * h + (n % 4) * h + j], hi, lo);
    wt_hi[sw_at(kXN, n, k)] = __uint_as_float(hi);
    wt_lo[sw_at(kXN, n, k)] = __uint_as_float(lo);
  }
  for (int idx = tid; idx < lay.hs / 4; idx += kThreads) hs[idx] = 0.0f;
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();                     // the zeros before any staged row
  cluster.sync();                      // every block's memory is in place

  // this thread's (row, unit) pair of a pass: row tid / 4, unit j
  const int bl = tid / kCU, ju = tid % kCU, j = u0 + ju;
  const bool unit = j < h;
  float w_ic = 0.f, w_fc = 0.f, w_oc = 0.f;
  if (unit) {
    w_ic = peep[j];
    w_fc = peep[h + j];
    w_oc = peep[2 * h + j];
  }
  const size_t bh = static_cast<size_t>(b_len) * h;
  unsigned target = base;
  // the steps past each row's length: zero outputs, written before the
  // recurrence (which never reads them); a row of length 0 keeps h0, c0
  if (unit) {
    for (int r = bl; r < b_len; r += kBT) {
      const int b = order[r], len_b = lens[b];
      const size_t at = static_cast<size_t>(b) * h + j;
      for (int t = len_b > 0 ? len_b : 0; t < t_len; ++t) {
        hidden[static_cast<size_t>(t) * bh + at] = 0.0f;
        cell[static_cast<size_t>(t) * bh + at] = 0.0f;
      }
      if (len_b <= 0) {
        hlast[at] = h0[at];
        clast[at] = c0[at];
      }
    }
  }
  for (int t = 0; t < t_len; ++t) {
    const float* hp = t == 0 ? h0 : hidden + (t - 1) * bh;
    const float* cp_seq = t == 0 ? c0 : cell + (t - 1) * bh;
    const int n_live = live[t];

    for (int r0 = 0; r0 < n_live; r0 += kBT) {
      const int rows = min(kBT, n_live - r0), c4 = kh / 4;
      // columns [q kh, q kh + kh) of the pass's rows of the state
      for (int idx = tid; idx < rows * c4; idx += kThreads) {
        const int i = idx / c4, c = idx % c4 * 4, k = k0q + c;
        const bool valid = k < h;
        copy16(hs + i * hst + c,
               valid ? hp + static_cast<size_t>(order[r0 + i]) * h + k : hp,
               valid);
      }
      asm volatile("cp.async.commit_group;" ::: "memory");
      // the cell's inputs, in flight while the staged rows land
      const bool alive = unit && bl < rows;
      const int b = alive ? order[r0 + bl] : 0;
      const size_t at = static_cast<size_t>(b) * h + j;
      float xg[4] = {0.f, 0.f, 0.f, 0.f}, cp = 0.f;
      int len_b = 0;
      if (alive) {
        const float* xr =
            x + (static_cast<size_t>(t) * b_len + b) * 4 * h + j;
#pragma unroll
        for (int g = 0; g < 4; ++g) xg[g] = xr[g * h];
        cp = cp_seq[at];
        len_b = lens[b];
      }
      asm volatile("cp.async.wait_group 0;" ::: "memory");
      __syncthreads();
      // staged

      // the cluster's gates over this block's depth, [64, 16C]; warpgroup
      // wg takes half the depth (all 16C columns, each half sent as its own
      // partial)
      {
        const int kb0 = wg * kh / 2, kb1 = kb0 + kh / 2;
        constexpr int kR = kXN / 2;
        float big[kR], sa[kR], sb[kR];
#pragma unroll
        for (int i = 0; i < kR; ++i) big[i] = sa[i] = sb[i] = 0.f;
        const int r = 16 * wq + g8;
        for (int kb = kb0; kb < kb1; kb += 32) {     // one box of depth
          uint32_t ah[4][4], al[4][4];
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const int k = kb + 8 * s + tig;
            split_tf32(hs[r * hst + k], ah[s][0], al[s][0]);
            split_tf32(hs[(r + 8) * hst + k], ah[s][1], al[s][1]);
            split_tf32(hs[r * hst + k + 4], ah[s][2], al[s][2]);
            split_tf32(hs[(r + 8) * hst + k + 4], ah[s][3], al[s][3]);
          }
          const size_t box = static_cast<size_t>(kb >> 5) * kXN * 32;
          const uint64_t dh = sw_desc(wt_hi + box), dl = sw_desc(wt_lo + box);
          wg_fence();
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            wgmma_rs(big, ah[s], dh + 2 * s);
            wgmma_rs(sa, ah[s], dl + 2 * s);
            wgmma_rs(sb, al[s], dh + 2 * s);
          }
          wg_commit_wait();
          hold(ah);
          hold(al);
          settle(big);
          settle(sa);
          settle(sb);
        }
        // each owner's 16 columns into its pa[q][half]
#pragma unroll
        for (int jn = 0; jn < kXN / 8; ++jn) {
          const int n = 8 * jn + 2 * tig, owner = n / kCN;
          float* dst = cluster.map_shared_rank(pa, owner) +
                       (q * kHalves + wg) * kBT * kCN + n % kCN;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = r + 8 * hh, i = 4 * jn + 2 * hh;
            if (row < rows)
              *reinterpret_cast<float2*>(dst + row * kCN) = make_float2(
                  big[i] + sa[i] + sb[i], big[i + 1] + sa[i + 1] + sb[i + 1]);
          }
        }
      }
      cluster.sync();                  // every partial of the gates landed

      // the cell of this thread's pair
      if (alive) {
        float gate[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float sum = 0.f;
          for (int p = 0; p < kCC * kHalves; ++p)
            sum += pa[(p * kBT + bl) * kCN + ju * 4 + g];
          gate[g] = xg[g] + sum;
        }
        const float i = sigmoidf(gate[0] + cp * w_ic);
        const float f = sigmoidf(gate[1] + cp * w_fc);
        const float g = tanhf(gate[2]);
        const float c_new = f * cp + i * g;
        const float og = sigmoidf(gate[3] + c_new * w_oc);
        const float h_new = og * tanhf(c_new);
        hidden[static_cast<size_t>(t) * bh + at] = h_new;
        cell[static_cast<size_t>(t) * bh + at] = c_new;
        if (t + 1 == t_len || t + 1 == len_b) {
          hlast[at] = h_new;
          clast[at] = c_new;
        }
      }
      if (r0 + kBT < n_live) cluster.sync();   // pa and hs are read before
                                               // the next pass reuses them
    }
    grid_barrier(count, target += gridDim.x);
  }
}

// The weight gradients on the tensor cores (wgmma m64n64k8, 3xTF32): dw
// [H, N] = S^T @ dx over the T*B rows, where dx is [T*B, N] and S the left
// operand of a range of dw's columns: the LSTM's h_prev_seq for all of dw
// [H, 4H]; the GRU's h_prev_seq for dw[:, :2H] and rh for dw[:, 2H:] (two
// parts, one launch). Computed as its transpose dw^T [N, H] = dx^T @ S:
// 128 x 64 tiles of dw^T (a part's tiles, then the next part's: 128 blocks
// at the LSTM's H 512), each warpgroup 64 x 64, depth tiles of 32 rows.
// Both tiles land in shared memory as they lie (cp.async, three stages in
// flight: the loads of S, read from L2 or memory behind dx's stream, were
// the kernel's longest wait when they went through registers). dx^T is the
// left operand: each warp reads its fragments from dx's tile, split into
// TF32 halves as it reads them. S's tile is split and stored transposed in
// the 128-byte-swizzled K-major layout wgmma reads. Every sum in one fixed
// order, no atomics. Row p of a part's S is a0[p] for p < split and
// a1[p - split] after (h0 then the hidden sequence: h_prev_seq); rows
// 16-byte aligned take cp.async, others plain loads.
constexpr int kDwM = 128, kDwN = 64, kDwK = 32;      // dw^T tile, depth
constexpr int kDwLdA = kDwM + 8;                      // 32 banks a fragment
constexpr int kDwLdS = kDwN + 8;                      // h_prev's staged rows
constexpr int kDwRing = 3;                            // stages
constexpr int kDwA = kDwK * kDwLdA;                   // floats of dx a stage
constexpr int kDwS = kDwK * kDwLdS;                   // floats of h_prev
constexpr int kDwB = kDwN * kDwK;                     // floats a half of S^T
constexpr int kDwSmem =
    1024 +
    (2 * kDwB + kDwRing * (kDwA + kDwS)) * static_cast<int>(sizeof(float));

// the left operand of dw's columns [n0, n1)
struct DwPart {
  const float* a0;
  const float* a1;
  int split;
  int n0, n1;
};

__global__ void __launch_bounds__(kThreads, 1)
rnn_dw_kernel(DwPart part0, DwPart part1, int tiles0,
              const float* __restrict__ dx, float* __restrict__ dw,
              int n_len, int k_len, int h) {
  extern __shared__ char dw_raw[];
  float* sb = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(dw_raw) + 1023) & ~uintptr_t(1023));
  float* ring = sb + 2 * kDwB;                 // [3][32][128 + 8] dx tiles
  float* sring = ring + kDwRing * kDwA;        // [3][32][64 + 4] S tiles
  const bool second = static_cast<int>(blockIdx.x) >= tiles0;
  const DwPart pt = second ? part1 : part0;
  const float* __restrict__ a0 = pt.a0;
  const float* __restrict__ a1 = pt.a1;
  const int split = pt.split, n_end = pt.n1;
  const int n0 = pt.n0 + (blockIdx.x - (second ? tiles0 : 0)) * kDwM;
  const int m0 = blockIdx.y * kDwN;
  const int tid = threadIdx.x, lane = tid % 32;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0), wq = tid / 32 % 4;
  const int g8 = lane / 4, tig = lane % 4;
  const int tiles = (k_len + kDwK - 1) / kDwK;
  const bool vec = (h & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(dx) |
                     reinterpret_cast<uintptr_t>(part0.a0) |
                     reinterpret_cast<uintptr_t>(part0.a1) |
                     reinterpret_cast<uintptr_t>(part1.a0) |
                     reinterpret_cast<uintptr_t>(part1.a1)) & 15) == 0;
  // 16 bytes of a row from src into dst where they are valid (zeros past
  // the row's end or the last row)
  auto put4 = [&](float* dst, const float* src, int valid) {
    if (vec) {
      copy16(dst, valid == 4 ? src : dx, valid == 4);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[e] = e < valid ? src[e] : 0.0f;
    }
  };
  // tile kt of dx (32 rows of 128 columns) and of S (32 rows of 64
  // columns) into ring stage kt % 3
  auto stage = [&](int kt) {
    const int k0 = kt * kDwK;
    float* da = ring + (kt % kDwRing) * kDwA;
    float* ds = sring + (kt % kDwRing) * kDwS;
#pragma unroll
    for (int i = 0; i < kDwK * kDwM / 4 / kThreads; ++i) {
      const int idx = tid + i * kThreads, kk = idx / (kDwM / 4);
      const int c = idx % (kDwM / 4) * 4, p = k0 + kk, n = n0 + c;
      put4(da + kk * kDwLdA + c, dx + static_cast<size_t>(p) * n_len + n,
           p < k_len ? max(0, min(4, n_end - n)) : 0);
    }
#pragma unroll
    for (int i = 0; i < kDwK * kDwN / 4 / kThreads; ++i) {
      const int idx = tid + i * kThreads, kk = idx / (kDwN / 4);
      const int c = idx % (kDwN / 4) * 4, p = k0 + kk, m = m0 + c;
      const float* row =
          p < split ? a0 + static_cast<size_t>(p) * h
                    : a1 + static_cast<size_t>(p - split) * h;
      put4(ds + kk * kDwLdS + c, row + m,
           p < k_len ? max(0, min(4, h - m)) : 0);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

  float big[32], small[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) big[i] = small[i] = 0.f;
  stage(0);
  if (tiles > 1) stage(1);
  const int row = 64 * wg + 16 * wq + g8;      // this thread's dw^T rows
  for (int kt = 0; kt < tiles; ++kt) {
    if (kt + 1 < tiles)                        // tile kt has landed
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    else
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();                           // and tile kt-1 is consumed
    if (kt + 2 < tiles) stage(kt + 2);         // the stage tile kt-1 left
    // S's tile, split and transposed: a warp 8 columns by 4 rows,
    // so that the swizzled stores hit 32 banks
    const float* s_s = sring + (kt % kDwRing) * kDwS;
#pragma unroll
    for (int i = 0; i < kDwK * kDwN / kThreads; ++i) {
      const int idx = tid + i * kThreads, wi = idx / 32, li = idx % 32;
      const int mm = wi % 8 * 8 + li % 8, kk = wi / 8 * 4 + li / 8;
      uint32_t hi, lo;
      split_tf32(s_s[kk * kDwLdS + mm], hi, lo);
      sb[sw_at(kDwN, mm, kk)] = __uint_as_float(hi);
      sb[kDwB + sw_at(kDwN, mm, kk)] = __uint_as_float(lo);
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    const float* a_s = ring + (kt % kDwRing) * kDwA;
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int k = 8 * s + tig;
      split_tf32(a_s[k * kDwLdA + row], ah[s][0], al[s][0]);
      split_tf32(a_s[k * kDwLdA + row + 8], ah[s][1], al[s][1]);
      split_tf32(a_s[(k + 4) * kDwLdA + row], ah[s][2], al[s][2]);
      split_tf32(a_s[(k + 4) * kDwLdA + row + 8], ah[s][3], al[s][3]);
    }
    __syncthreads();                           // S^T stored by every thread
    const uint64_t dh = sw_desc(sb), dl = sw_desc(sb + kDwB);
    wg_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s)
      wgmma_3x(big, small, ah[s], al[s], dh + 2 * s, dl + 2 * s);
    wg_commit_wait();
    hold(ah);
    hold(al);
    settle(big);
    settle(small);
  }
  // dw[m][n] = dw^T[n][m]: accumulator (row 8 hh, column 8 jn + 2 tig + e)
#pragma unroll
  for (int jn = 0; jn < 8; ++jn)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + row + 8 * hh, m = m0 + 8 * jn + 2 * tig + e;
        const int i = 4 * jn + 2 * hh + e;
        if (n < n_end && m < h)
          dw[static_cast<size_t>(m) * n_len + n] = big[i] + small[i];
      }
}

// dw [H, n_len] from dx [T*B, n_len]: part0's columns, then part1's (n1 ==
// n0: none)
cudaError_t rnn_dw(DwPart part0, DwPart part1, const float* dx, float* dw,
                   int n_len, int t_len, int b_len, int h, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      rnn_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDwSmem);
  if (err != cudaSuccess) return err;
  const int tiles0 = (part0.n1 - part0.n0 + kDwM - 1) / kDwM;
  const int tiles1 = (part1.n1 - part1.n0 + kDwM - 1) / kDwM;
  const dim3 grid(tiles0 + tiles1, (h + kDwN - 1) / kDwN);
  rnn_dw_kernel<<<grid, kThreads, kDwSmem, s>>>(part0, part1, tiles0, dx, dw,
                                                n_len, t_len * b_len, h);
  return cudaGetLastError();
}

__global__ void __launch_bounds__(kThreads, 1)
gru_bwd_cluster_kernel(const float* __restrict__ x,
                       const float* __restrict__ w,
                       const int* __restrict__ lens,
                       const int* __restrict__ order,
                       const int* __restrict__ live,
                       const float* __restrict__ h0,
                       const float* __restrict__ hidden,
                       const float* __restrict__ rh,
                       const float* __restrict__ dhid,
                       const float* __restrict__ dhlast, float* dx,
                       float* dh0, float* part, unsigned* count,
                       unsigned base, int t_len, int b_len, int h);
__global__ void __launch_bounds__(kGfThreads, 1)
gru_fwd_cluster_kernel(const float* __restrict__ x,
                       const float* __restrict__ w,
                       const int* __restrict__ lens,
                       const int* __restrict__ order,
                       const int* __restrict__ live,
                       const float* __restrict__ h0, float* hidden,
                       float* __restrict__ hlast, float* rh, unsigned* count,
                       unsigned base, int t_len, int b_len, int h);

// the cluster kernel of `kind`
const void* cluster_kernel(int kind) {
  switch (kind) {
    case kLstmFwd:
      return reinterpret_cast<const void*>(lstm_fwd_cluster_kernel);
    case kLstmBwd:
      return reinterpret_cast<const void*>(lstm_bwd_cluster_kernel);
    case kGruFwd:
      return reinterpret_cast<const void*>(gru_fwd_cluster_kernel);
    default:
      return reinterpret_cast<const void*>(gru_bwd_cluster_kernel);
  }
}

// the launch configuration of the cluster kernel of `kind` on `blocks`
// blocks at width h
cudaError_t cluster_config(int kind, int h, int blocks,
                           cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attrs, bool coop) {
  const size_t smem = ClusterSmem(h, kind).bytes();
  cudaError_t err = cudaFuncSetAttribute(
      cluster_kernel(kind), cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = kCC;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeCooperative;
  attrs[1].val.cooperative = 1;
  cfg->gridDim = dim3(blocks);
  cfg->blockDim = dim3(kind == kGruFwd ? kGfThreads : kThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = nullptr;
  cfg->attrs = attrs;
  cfg->numAttrs = coop ? 2 : 1;
  return cudaSuccess;
}

// clusters of the cluster kernel of `kind` the card holds at once at width
// h (0: none)
cudaError_t max_clusters(int kind, int h, int* n) {
  *n = 0;
  if (ClusterSmem(h, kind).bytes() > 232448) return cudaSuccess;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attrs[2];
  cudaError_t err = cluster_config(kind, h, kCC, &cfg, attrs, false);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(n, cluster_kernel(kind), &cfg);
}

cudaError_t launch_cluster(int kind, int blocks, int h, void** args,
                           cudaStream_t s) {
  if (blocks % kCC != 0) return cudaErrorInvalidValue;
  int fit = 0;
  cudaError_t err = max_clusters(kind, h, &fit);
  if (err != cudaSuccess) return err;
  if (blocks > fit * kCC) return cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attrs[2];
  err = cluster_config(kind, h, blocks, &cfg, attrs, true);
  if (err != cudaSuccess) return err;
  cfg.stream = s;
  return cudaLaunchKernelExC(&cfg, cluster_kernel(kind), args);
}

// the checks of a cluster launch: shape, blocks, the barrier's counter, and
// the rows the 16-byte copies stage (h0, hidden) 16-byte aligned
bool cluster_args_ok(int t_len, int b_len, int h, int blocks,
                     const void* count, const float* h0,
                     const float* hidden) {
  return t_len >= 1 && b_len >= 1 && h >= 1 && h <= kCMaxH && h % 4 == 0 &&
         blocks >= 1 && static_cast<long long>(blocks) * kCU >= h &&
         count != nullptr &&
         ((reinterpret_cast<uintptr_t>(h0) |
           reinterpret_cast<uintptr_t>(hidden)) & 15) == 0;
}

}  // namespace

// The floats of global scratch (for the blocks' slices of w) that a kernel
// of this kind needs at width h on the current card: 0 where the slices fit
// in shared memory; a negative CUDA error where no launch is possible.
extern "C" long long paddle_rnn_scratch_floats(int kind, int h) {
  if (kind < kLstmFwd || kind > kGruBwd || h < 1)
    return -static_cast<long long>(cudaErrorInvalidValue);
  Plan p;
  const cudaError_t err = plan_for(kind, h, &p);
  return err == cudaSuccess ? p.scratch : -static_cast<long long>(err);
}

// blocks 0: lstm_fwd_kernel on plan_for's grid, carry [2, B, H] fp32
// scratch (and wscratch where the plan needs it); else
// lstm_fwd_cluster_kernel on `blocks` blocks (whole clusters of 2, 4 units
// each, H <= 512 and a multiple of 4, h0 and hidden 16-byte aligned), count
// the grid barrier's counter at `base` when the launch starts (it ends at
// base + T x blocks, modulo 2^32).
extern "C" int paddle_lstm_train_fwd(const float* x, const float* w,
                                     const float* peep, const int* lens,
                                     const int* order, const int* live,
                                     const float* h0, const float* c0,
                                     float* hidden, float* cell, float* hlast,
                                     float* clast, float* carry,
                                     float* wscratch, unsigned* count,
                                     unsigned base, int t_len, int b_len,
                                     int h, int blocks, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (blocks == 0) {
    Plan p;
    cudaError_t err = checked_plan(kLstmFwd, t_len, b_len, h, wscratch, &p);
    if (err != cudaSuccess) return err;
    if (carry == nullptr) return cudaErrorInvalidValue;
    void* args[] = {&x, &w, &peep, &lens, &order, &live, &h0, &c0, &hidden,
                    &cell, &hlast, &clast, &carry, &wscratch, &t_len, &b_len,
                    &h};
    return PADDLE_RNN_LAUNCH(lstm_fwd_kernel, p, h, args, s);
  }
  if (!cluster_args_ok(t_len, b_len, h, blocks, count, h0, hidden))
    return cudaErrorInvalidValue;
  void* args[] = {&x, &w, &peep, &lens, &order, &live, &h0, &c0, &hidden,
                  &cell, &hlast, &clast, &count, &base, &t_len, &b_len, &h};
  return launch_cluster(kLstmFwd, blocks, h, args, s);
}

// clusters of 2 blocks of the cluster kernel of `kind` (every Kind has
// one) that the card holds at once at width h (0: none fit); a negative
// CUDA error
extern "C" int paddle_rnn_max_clusters(int kind, int h) {
  if (h < 1 || h > kCMaxH || kind < kLstmFwd || kind > kGruBwd)
    return -static_cast<int>(cudaErrorInvalidValue);
  int n = 0;
  const cudaError_t err = max_clusters(kind, h, &n);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}


// blocks 0: lstm_bwd_kernel on plan_for's grid (wscratch where the plan
// needs it); else lstm_bwd_cluster_kernel on `blocks` blocks (whole
// clusters of 2, 4 units each, H <= 512 and a multiple of 4, h0 and hidden
// 16-byte aligned) with part [2, blocks / 2, B, H] fp32 scratch and
// count, the grid barrier's counter, at `base` when the launch starts (one
// barrier a step: it ends at base + T x blocks, modulo 2^32). Then dw on
// the tensor cores.
extern "C" int paddle_lstm_train_bwd(
    const float* x, const float* w, const float* peep, const int* lens,
    const int* order, const int* live, const float* h0, const float* c0,
    const float* hidden, const float* cell,
    const float* dhid, const float* dcell, const float* dhlast,
    const float* dclast, float* dx, float* dw, float* dpeep, float* dh0,
    float* dc0, float* wscratch, float* part, unsigned* count,
    unsigned base, int t_len, int b_len, int h, int blocks, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (blocks == 0) {
    Plan p;
    err = checked_plan(kLstmBwd, t_len, b_len, h, wscratch, &p);
    if (err != cudaSuccess) return err;
    void* args[] = {&x, &w, &peep, &lens, &order, &live, &h0, &c0, &hidden,
                    &cell, &dhid, &dcell, &dhlast, &dclast, &dx, &dpeep,
                    &dh0, &dc0, &wscratch, &t_len, &b_len, &h};
    err = PADDLE_RNN_LAUNCH(lstm_bwd_kernel, p, h, args, s);
  } else {
    if (!cluster_args_ok(t_len, b_len, h, blocks, count, h0, hidden) ||
        part == nullptr)
      return cudaErrorInvalidValue;
    void* args[] = {&x, &w, &peep, &lens, &order, &live, &h0, &c0, &hidden,
                    &cell, &dhid, &dcell, &dhlast, &dclast, &dx, &dpeep,
                    &dh0, &dc0, &part, &count, &base, &t_len, &b_len,
                    &h};
    err = launch_cluster(kLstmBwd, blocks, h, args, s);
  }
  if (err != cudaSuccess) return err;
  // dw [H, 4H] = h_prev_seq^T @ dx over the T*B rows
  const DwPart seq = {h0, hidden, b_len, 0, 4 * h};
  return rnn_dw(seq, {h0, hidden, b_len, 4 * h, 4 * h}, dx, dw, 4 * h, t_len,
                b_len, h, s);
}

// ---- GRU ------------------------------------------------------------------
//
// Whole-sequence trainable GRU (gru_op.cc layout), replacing
//   paddle_gru_train_fwd <- _gru_train_fwd_call (:376, pallas_call :379,
//                           _gru_train_fwd_kernel :287)
//   paddle_gru_train_bwd <- _gru_train_vjp_bwd  (:416, pallas_call :424,
//                           _gru_train_bwd_kernel :317)
// of paddle_tpu/ops/pallas/fused_rnn.py. Time-major fp32: xproj [T, B, 3H]
// (gate pre-activations with the bias, gate order u, r, c), w [H, 3H]
// (w_ur = w[:, :2H], w_c = w[:, 2H:]), lens, order, live and h0 [B, H] as
// for the LSTM; any H up to 16 x the SMs, B >= 1, T >= 1.
//
// Forward, per step t (_gru_train_fwd_kernel :296-314):
//   u, r = sigmoid(xproj[t][:, :2H] + h @ w_ur)
//   c = tanh(xproj[t][:, 2H:] + (r * h) @ w_c)
//   h_cand = (1 - u) * h + u * c;  m = t < lens
//   hidden[t] = m * h_cand;  the state keeps h where m = 0;
//   h_last = the state after step T - 1.
// It also writes rh [T, B, H] = m * r * h_prev, a residual for the backward
// (the left operand of the candidate's product and of dw[:, 2H:]).
// Backward, in reverse time from Dh = dh_last (_gru_train_bwd_kernel
// :330-373): Gh = m * (Dh + dhid[t]); du = Gh * (c - h_prev); dc = Gh * u;
// dgc = dc * (1 - c^2); d_rh = dgc @ w_c^T; dgr = d_rh * h_prev * r(1 - r);
// dgu = du * u(1 - u); dx[t] = [dgu, dgr, dgc];
// Dh <- (1 - m) Dh + Gh (1 - u) + d_rh * r + [dgu, dgr] @ w_ur^T;
// dw = [h_prev_seq^T @ dx[:, :2H], rh^T @ dx[:, 2H:]]; dh0 = Dh after step 0.
//
// What bounds them: as for the LSTM, fp32 arithmetic (a [B, H] x [H, 3H]
// product a step forward, 100.7 MFLOP at B 64, H 512; three such a step
// backward with the recompute and dw) and a serial chain of grid barriers.
// A GRU step has two dependent products: (r * h) @ w_c needs r of every
// unit, so the forward takes two barriers a step where the LSTM takes one.
//
// Design of the grid kernels (above H 512, at H not a multiple of 4, or
// where the cluster kernels' clusters do not all fit), on the LSTM's
// skeleton (cooperative launch of ceil(H/U) blocks of U units, the block's
// slice of w in shared memory for the whole sequence, tile_product over the
// rows still inside their length):
//   forward   phase 1: the block's u and r columns ([H, 2U] of w_ur) times
//             the state h; r * h_prev of its units goes to rh[t] (in global
//             memory: the other blocks need it), u to hidden[t] (read back by
//             the same thread in phase 2). Grid barrier. Phase 2: all of
//             rh[t] times the block's w_c columns ([H, U]); c, h_new into
//             hidden[t]. Grid barrier. The state is hidden[t - 1] itself: a
//             row inside its length at t was inside it at t - 1, where
//             hidden holds its state, and the rows past their length are
//             never read again (no separate carry buffer).
//   backward  the gates' pre-activations of every step need no other step,
//             so one product before the loop computes them all at once
//             ([T*B, H] x [H, 2H] over h_prev_seq and [T*B, H] x [H, H] over
//             rh, by rnn_gemm into dx, which the loop then overwrites): the
//             loop does no recompute product. Per step, phase A: the block's
//             u, c, Gh, dgu, dgc (no product). Barrier. Phase B: d_rh of its
//             units from all of dgc (dx[t][:, 2H:] read back through L2
//             against its [H, U] rows of w_c), then dgr. Barrier. Phase C:
//             Dh of its units from all of [dgu, dgr] against its [2H, U]
//             rows of w_ur; it feeds the next step's phase A, which reads
//             only the block's own Dh: two barriers a step. The Dh state
//             lives in the dh0 buffer, each element with the thread that
//             owns it.
// Both backwards compute dw after the loop on the tensor cores (rnn_dw_kernel:
// h_prev_seq against dx[:, :2H], rh against dx[:, 2H:], one launch).
// Rows past their length get zero outputs and gate gradients; a row's last
// state is written, and its gradient carry read from dh_last, at its own
// last step.
//
// ---- GRU backward on thread-block clusters and tensor cores ---------------
//
// gru_bwd_cluster_kernel computes what gru_bwd_kernel computes, at H <= 512
// and H a multiple of 4, for any T and B, with no product before its loop.
// What held gru_bwd_kernel back: two SIMT products over every (row, step)
// pair outside the loop (the pre-activations and dw, about half of the
// pairs dead at the training shape), and per step each of its 128 blocks
// reading all of dgc[t] and all of [dgu, dgr] back through L2 (48 MB a step)
// for fp32 SIMT products, behind two cooperative grid syncs. Here, as in
// lstm_bwd_cluster_kernel (clusters of C = 2 blocks, block g owning units
// [4g, 4g + 4) for the cell, rank q the depth rows [q kh, q kh + kh) of the
// cluster's gate columns of w):
//   * Phase A, the recompute, on the tensor cores: the gates' products need
//     h_prev[t] (for u, r) and rh[t] (for c), both inputs, so each block
//     stages columns [q kh, q kh + kh) of both for the pass's live rows
//     (cp.async, issued as soon as the last product read the buffers) and
//     multiplies them by W_q^T = w[q kh .. q kh + kh)[the cluster's 24 gate
//     columns]^T, split into TF32 hi and lo in shared memory for the whole
//     sequence (u and r: N 16
//     against h_prev, c: N 8 against rh; the two warpgroups split the
//     depth). Each partial goes to its owner through distributed shared
//     memory; the owner adds the C x 2 partials in order, runs the cell,
//     writes dgu and dgc (and r, in dgr's place, until phase C), and keeps
//     Gh (1 - u) in the dh0 buffer, the carry's state.
//   * Phase B: d_rh = dgc @ w_c^T needs every unit's dgc. Each block sends
//     its units' dgc, split hi / lo, into both blocks of the cluster; each
//     multiplies them by its rows of w_c, W_q (in registers for the whole
//     sequence: the transposed product P^T = W_q dg^T, W_q as wgmma's A from
//     registers, dg as B from shared memory), and writes rows [q kh, q kh +
//     kh) of the cluster's partial to global memory. Grid barrier. Each
//     block adds the clusters' partials of its own units in cluster order
//     (gru_reduce: no cluster exchange): d_rh, then dgr and Gh (1 - u) +
//     d_rh r.
//   * Phase C: [dgu, dgr] @ w_ur^T, the same way (k-steps u and r of W_q),
//     its partials summed after the second grid barrier into the carry.
//   Two grid barriers a step (d_rh needs every dgc; the next step's cell
//   needs every [dgu, dgr]), the hand-written arrival counter of the LSTM's
//   cluster kernels on the same stream's counter: a launch adds 2T x blocks.
//   The recompute needs no other block, so a block runs the next step's
//   between its arrival at a barrier and its wait (the u, r product at the
//   first, the c product at the second; the rows of the step after staged
//   as soon as these have read them): the products hide in the barriers'
//   latency. A batch's later passes of 64 rows recompute in line.
//   Partials cross L2 (each block writes 64 x kh floats and reads 64 x 4 x
//   clusters a phase); no block reads another cluster's gate gradients.
// Batches above 64 rows take passes of 64 rows. Every sum runs in a fixed
// order: two runs give the same bits.

namespace {

// ws_ur[k][2u + g] = w[k][g H + u0 + u] (g = 0: u, 1: r) and
// ws_c[k][u] = w[k][2H + u0 + u], zero past H.
template <int U, bool kPasses = false>
__global__ void __launch_bounds__(kThreads, 1)
gru_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const int* __restrict__ lens, const int* __restrict__ order,
               const int* __restrict__ live, const float* __restrict__ h0,
               float* hidden, float* __restrict__ hlast, float* rh,
               float* wscratch, int t_len, int b_len, int h) {
  using O = Owner<U>;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int hpad = round_up(h, chunk_of(h));
  const int slice = gru_fwd_slice(h, U);
  const Smem sm = carve<U>(smem, wscratch, slice);
  float* as = sm.as;                                 // [64][chunk + 4]
  float* red = as + kBT * (chunk_of(h) + 4);         // kRed floats
  const int tid = threadIdx.x;
  const size_t h3 = 3 * static_cast<size_t>(h);
  const int n_pass = passes_of<U, kPasses>(h);
  for (int p = 0; p < n_pass; ++p) {
    const int vb = blockIdx.x + p * gridDim.x, u0 = vb * U;
    float* ws_ur = pass_w<kPasses>(sm, wscratch, vb, slice);  // [hpad][2U]
    float* ws_c = ws_ur + hpad * 2 * U;                        // [hpad][U]
    for (int idx = tid; idx < hpad * U; idx += kThreads) {
      const int k = idx / U, j = u0 + idx % U;
      const bool in = k < h && j < h;
      const float* wk = w + k * h3;
      ws_ur[2 * idx] = in ? wk[j] : 0.0f;
      ws_ur[2 * idx + 1] = in ? wk[h + j] : 0.0f;
      ws_c[idx] = in ? wk[2 * h + j] : 0.0f;
    }
  }

  // this thread's shares: rows bl[o] of a pass, unit j
  const Share<U> sh0 = share_of<U>(blockIdx.x * U, h);
  const size_t bh = static_cast<size_t>(b_len) * h;

  for (int t = 0; t < t_len; ++t) {
    const float* hin = t == 0 ? h0 : hidden + (t - 1) * bh;
    float* hid_t = hidden + t * bh;
    float* rh_t = rh + t * bh;
    const float* x_t = x + t * b_len * h3;
    const int n_live = live[t];
    // phase 1: u, r of the block's units; r * h_prev published
    for (int p = 0; p < n_pass; ++p) {
    const int vb = blockIdx.x + p * gridDim.x;
    const float* ws_ur = pass_w<kPasses>(sm, wscratch, vb, slice);
    const Share<U> sh = kPasses ? share_of<U>(vb * U, h) : sh0;
    const int j = sh.j;
    const int (&bl)[O::kOwn] = sh.bl;
    const bool (&owner)[O::kOwn] = sh.owner;
    for (int r0 = 0; r0 < n_live; r0 += kBT) {
      bool alive[O::kOwn];
      int b[O::kOwn];
      float xu[O::kOwn], xr[O::kOwn], hp[O::kOwn];
#pragma unroll
      for (int o = 0; o < O::kOwn; ++o) {
        alive[o] = owner[o] && r0 + bl[o] < n_live;
        b[o] = alive[o] ? order[r0 + bl[o]] : 0;
        xu[o] = xr[o] = hp[o] = 0.f;
        if (alive[o]) {       // in flight while the product runs
          xu[o] = x_t[b[o] * h3 + j];
          xr[o] = x_t[b[o] * h3 + h + j];
          hp[o] = hin[static_cast<size_t>(b[o]) * h + j];
        }
      }
      tile_product<2 * U>(hin, h, order + r0, min(kBT, n_live - r0), h,
                          ws_ur, as, red);
#pragma unroll
      for (int o = 0; o < O::kOwn; ++o) {
        if (!alive[o]) continue;
        const size_t at = static_cast<size_t>(b[o]) * h + j;
        const int n = (tid % U) * 2;
        const float u = sigmoidf(xu[o] + reduced<2 * U>(red, bl[o], n));
        const float r = sigmoidf(xr[o] + reduced<2 * U>(red, bl[o], n + 1));
        rh_t[at] = r * hp[o];
        hid_t[at] = u;
      }
    }
    // the rows past their length: zero outputs, the state stays
#pragma unroll
    for (int o = 0; o < O::kOwn; ++o) {
      if (!owner[o]) continue;
      for (int r = n_live + bl[o]; r < b_len; r += kBT) {
        const size_t at = static_cast<size_t>(order[r]) * h + j;
        hid_t[at] = 0.0f;
        rh_t[at] = 0.0f;
        if (t == 0) hlast[at] = h0[at];  // a row of length 0 keeps h0
      }
    }
    }  // passes
    grid.sync();

    // phase 2: the candidate from all of rh[t], the new state
    for (int p = 0; p < n_pass; ++p) {
    const int vb = blockIdx.x + p * gridDim.x;
    const float* ws_c = pass_w<kPasses>(sm, wscratch, vb, slice) +
                        hpad * 2 * U;
    const Share<U> sh = kPasses ? share_of<U>(vb * U, h) : sh0;
    const int j = sh.j;
    const int (&bl)[O::kOwn] = sh.bl;
    const bool (&owner)[O::kOwn] = sh.owner;
    for (int r0 = 0; r0 < n_live; r0 += kBT) {
      bool alive[O::kOwn];
      int b[O::kOwn];
      float xc[O::kOwn], ug[O::kOwn], hp[O::kOwn];
#pragma unroll
      for (int o = 0; o < O::kOwn; ++o) {
        alive[o] = owner[o] && r0 + bl[o] < n_live;
        b[o] = alive[o] ? order[r0 + bl[o]] : 0;
        xc[o] = ug[o] = hp[o] = 0.f;
        if (alive[o]) {
          const size_t at = static_cast<size_t>(b[o]) * h + j;
          xc[o] = x_t[b[o] * h3 + 2 * h + j];
          ug[o] = hid_t[at];
          hp[o] = hin[at];
        }
      }
      tile_product<U>(rh_t, h, order + r0, min(kBT, n_live - r0), h, ws_c,
                      as, red);
#pragma unroll
      for (int o = 0; o < O::kOwn; ++o) {
        if (!alive[o]) continue;
        const size_t at = static_cast<size_t>(b[o]) * h + j;
        const float c = tanhf(xc[o] + reduced<U>(red, bl[o], tid % U));
        const float h_new = (1.0f - ug[o]) * hp[o] + ug[o] * c;
        hid_t[at] = h_new;
        if (t + 1 == t_len || t + 1 == lens[b[o]]) hlast[at] = h_new;
      }
    }
    }  // passes
    grid.sync();
  }
}

// wrc[n][u] = w[u0 + u][2H + n] (n < H) and wrur[n][u] = w[u0 + u][n]
// (n < 2H): the rows of the block's units, zero past the depth.
template <int U, bool kPasses = false>
__global__ void __launch_bounds__(kThreads, 1)
gru_bwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const int* __restrict__ lens, const int* __restrict__ order,
               const int* __restrict__ live, const float* __restrict__ h0,
               const float* __restrict__ hidden,
               const float* __restrict__ dhid,
               const float* __restrict__ dhlast, float* dx, float* dh0,
               float* wscratch, int t_len, int b_len, int h) {
  using O = Owner<U>;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int cpad = round_up(h, chunk_of(h));
  const int urpad = round_up(2 * h, chunk_of(2 * h));
  const int slice = gru_bwd_slice(h, U);
  const Smem sm = carve<U>(smem, wscratch, slice);
  float* as = sm.as;                                 // [64][chunk + 4]
  float* red = as + kBT * (chunk_of(2 * h) + 4);     // kRed floats
  const int tid = threadIdx.x;
  const size_t h3 = 3 * static_cast<size_t>(h);
  const int n_pass = passes_of<U, kPasses>(h);
  for (int p = 0; p < n_pass; ++p) {
    const int vb = blockIdx.x + p * gridDim.x, u0 = vb * U;
    float* wrc = pass_w<kPasses>(sm, wscratch, vb, slice);  // [cpad][U]
    float* wrur = wrc + cpad * U;                           // [urpad][U]
    for (int idx = tid; idx < cpad * U; idx += kThreads) {
      const int u = idx / cpad, n = idx % cpad, k = u0 + u;
      wrc[n * U + u] = (n < h && k < h) ? w[k * h3 + 2 * h + n] : 0.0f;
    }
    for (int idx = tid; idx < urpad * U; idx += kThreads) {
      const int u = idx / urpad, n = idx % urpad, k = u0 + u;
      wrur[n * U + u] = (n < 2 * h && k < h) ? w[k * h3 + n] : 0.0f;
    }
  }

  const Share<U> sh0 = share_of<U>(blockIdx.x * U, h);
  const size_t bh = static_cast<size_t>(b_len) * h;

  for (int t = t_len - 1; t >= 0; --t) {
    const float* hp_seq = t == 0 ? h0 : hidden + (t - 1) * bh;
    const float* x_t = x + t * b_len * h3;
    float* dxt = dx + t * b_len * h3;    // holds the pre-activations until
                                         // this step overwrites them
    const int n_live = live[t];

    // phase A: the block's u, c and their gate gradients
    for (int p = 0; p < n_pass; ++p) {
    const int vb = blockIdx.x + p * gridDim.x;
    const Share<U> sh = kPasses ? share_of<U>(vb * U, h) : sh0;
    const int j = sh.j;
    const int (&bl)[O::kOwn] = sh.bl;
    const bool (&owner)[O::kOwn] = sh.owner;
#pragma unroll
    for (int o = 0; o < O::kOwn; ++o) {
      if (!owner[o]) continue;
      for (int r = bl[o]; r < n_live; r += kBT) {
        const int b = order[r];
        const size_t at = static_cast<size_t>(b) * h + j;
        const float* xb = x_t + b * h3 + j;
        float* db = dxt + b * h3 + j;
        const float u = sigmoidf(xb[0] + db[0]);
        const float c = tanhf(xb[2 * h] + db[2 * h]);
        const float hp = hp_seq[at];
        // a row's carry starts at the cotangent of its last state
        const bool last = t + 1 == t_len || t + 1 == lens[b];
        const float gh = (last ? dhlast : dh0)[at] + dhid[t * bh + at];
        const float du = gh * (c - hp);
        const float dgc = gh * u * (1.0f - c * c);
        db[0] = du * u * (1.0f - u);
        db[2 * h] = dgc;
        dh0[at] = gh * (1.0f - u);
      }
      // the rows past their length: no gate gradient, the carry stays
      for (int r = n_live + bl[o]; r < b_len; r += kBT) {
        const int b = order[r];
        float* db = dxt + b * h3 + j;
        db[0] = db[h] = db[2 * h] = 0.0f;
        if (t == 0) {                  // a row of length 0 hands it on
          const size_t at = static_cast<size_t>(b) * h + j;
          dh0[at] = dhlast[at];
        }
      }
    }
    }  // passes
    grid.sync();

    // phase B: d_rh of the block's units from every dgc of the step
    for (int p = 0; p < n_pass; ++p) {
    const int vb = blockIdx.x + p * gridDim.x;
    const float* wrc = pass_w<kPasses>(sm, wscratch, vb, slice);
    const Share<U> sh = kPasses ? share_of<U>(vb * U, h) : sh0;
    const int j = sh.j;
    const int (&bl)[O::kOwn] = sh.bl;
    const bool (&owner)[O::kOwn] = sh.owner;
    for (int r0 = 0; r0 < n_live; r0 += kBT) {
      bool alive[O::kOwn];
      int b[O::kOwn];
      float zr[O::kOwn], hp[O::kOwn];
#pragma unroll
      for (int o = 0; o < O::kOwn; ++o) {
        alive[o] = owner[o] && r0 + bl[o] < n_live;
        b[o] = alive[o] ? order[r0 + bl[o]] : 0;
        zr[o] = hp[o] = 0.f;
        if (alive[o]) {
          zr[o] = x_t[b[o] * h3 + h + j] + dxt[b[o] * h3 + h + j];
          hp[o] = hp_seq[static_cast<size_t>(b[o]) * h + j];
        }
      }
      tile_product<U>(dxt + 2 * h, 3 * h, order + r0, min(kBT, n_live - r0),
                      h, wrc, as, red);
#pragma unroll
      for (int o = 0; o < O::kOwn; ++o) {
        if (!alive[o]) continue;
        const size_t at = static_cast<size_t>(b[o]) * h + j;
        const float d_rh = reduced<U>(red, bl[o], tid % U);
        const float r = sigmoidf(zr[o]);
        dxt[b[o] * h3 + h + j] = d_rh * hp[o] * r * (1.0f - r);
        dh0[at] += d_rh * r;
      }
    }
    }  // passes
    grid.sync();

    // phase C: the rest of Dh from every [dgu, dgr] of the step
    for (int p = 0; p < n_pass; ++p) {
    const int vb = blockIdx.x + p * gridDim.x;
    const float* wrur = pass_w<kPasses>(sm, wscratch, vb, slice) + cpad * U;
    const Share<U> sh = kPasses ? share_of<U>(vb * U, h) : sh0;
    const int j = sh.j;
    const int (&bl)[O::kOwn] = sh.bl;
    const bool (&owner)[O::kOwn] = sh.owner;
    for (int r0 = 0; r0 < n_live; r0 += kBT) {
      tile_product<U>(dxt, 3 * h, order + r0, min(kBT, n_live - r0), 2 * h,
                      wrur, as, red);
#pragma unroll
      for (int o = 0; o < O::kOwn; ++o)
        if (owner[o] && r0 + bl[o] < n_live)
          dh0[static_cast<size_t>(order[r0 + bl[o]]) * h + j] +=
              reduced<U>(red, bl[o], tid % U);
    }
    }  // passes
  }
}

// Phases B and C of gru_bwd_cluster_kernel: P^T = W_q (A, registers: tile
// wg + 2 i of its kh depth rows, k-step s = gate u, r or c) times the pass's
// gate gradients dg [64][32]^T (B, shared memory) over k-steps [S0, S1),
// 3xTF32; rows k < h, columns r0 + pos < lim of the cluster's partial go to
// pt[k][cl][pos] (bpad positions a row of clusters).
template <int S0, int S1>
__device__ __forceinline__ void gru_product_t(
    uint32_t (&wah)[2][3][4], uint32_t (&wal)[2][3][4], const float* dg_hi,
    const float* dg_lo, float* pt, int tiles, int wg, int k0q, int r0,
    int lim, int cl, int clusters, int bpad, int h) {
  const int lane = threadIdx.x % 32, wq = threadIdx.x / 32 % 4;
  const int g8 = lane / 4, tig = lane % 4;
  const uint64_t bh = sw_desc(dg_hi), bl = sw_desc(dg_lo);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int mt = wg + 2 * i;
    if (mt >= tiles) break;
    float big[32], small[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) big[e] = small[e] = 0.f;
    wg_fence();
#pragma unroll
    for (int s = S0; s < S1; ++s)
      wgmma_3x(big, small, wah[i][s], wal[i][s], bh + 2 * s, bl + 2 * s);
    wg_commit_wait();
    hold(wah[i]);
    hold(wal[i]);
    settle(big);
    settle(small);
#pragma unroll
    for (int jn = 0; jn < 8; ++jn)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int k = k0q + 64 * mt + 16 * wq + g8 + 8 * hh;
        const int pos = r0 + 8 * jn + 2 * tig, e = 4 * jn + 2 * hh;
        if (k >= h || pos >= lim) continue;
        float* dst = pt + (static_cast<size_t>(k) * clusters + cl) * bpad + pos;
        if (pos + 1 < lim)
          __stcg(reinterpret_cast<float2*>(dst),
                 make_float2(big[e] + small[e], big[e + 1] + small[e + 1]));
        else
          __stcg(dst, big[e] + small[e]);
      }
  }
}

// The clusters' partials pt[k][cl][pos] of rows [rb, rb + 64) (those below
// n_live) of the block's own 4 units, added in cluster order: four threads
// an item (4 rows of a unit) each a quarter of the clusters, the quarters
// added in a fixed order by two shuffles; the sums land in rx[u][row]. Ends
// with the block synchronised; starts its stores with a barrier, so rx may
// have been read just before.
__device__ __forceinline__ void gru_reduce(const float* pt, float* rx, int rb,
                                           int n_live, int u0, int clusters,
                                           int bpad, int h) {
  const int item = threadIdx.x / 4, quarter = threadIdx.x % 4;
  const int u = item / 16, pos = rb + 4 * (item % 16);  // 4 units x 16 x 4
  const int per = (clusters + 3) / 4, c0 = quarter * per;
  const int c1 = min(clusters, c0 + per);
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  if (pos < n_live && u0 + u < h) {
    const float* src = pt + static_cast<size_t>(u0 + u) * clusters * bpad +
                       pos;
    for (int c = c0; c < c1; c += 16) {
      float4 p[16];
#pragma unroll
      for (int i = 0; i < 16; ++i)
        p[i] = c + i < c1 ? __ldcg(reinterpret_cast<const float4*>(
                                src + static_cast<size_t>(c + i) * bpad))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (c + i < c1)
          sum = make_float4(sum.x + p[i].x, sum.y + p[i].y, sum.z + p[i].z,
                            sum.w + p[i].w);
    }
  }
#pragma unroll
  for (int m = 1; m <= 2; m *= 2) {    // (q0 + q1) + (q2 + q3): a + b is b + a
    const float4 o = make_float4(__shfl_xor_sync(0xffffffffu, sum.x, m),
                                 __shfl_xor_sync(0xffffffffu, sum.y, m),
                                 __shfl_xor_sync(0xffffffffu, sum.z, m),
                                 __shfl_xor_sync(0xffffffffu, sum.w, m));
    sum = make_float4(sum.x + o.x, sum.y + o.y, sum.z + o.z, sum.w + o.w);
  }
  __syncthreads();                             // rx's last readers are done
  if (quarter == 0 && pos < n_live)
    *reinterpret_cast<float4*>(rx + u * kBT + pos - rb) = sum;
  __syncthreads();
}

// The recompute of gru_bwd_cluster_kernel, one product: the pass's staged
// rows (h_prev for the u and r gates, kR 8: N 16; rh for the c gate, kR 4:
// N 8) over warpgroup wg's half of the block's depth, times the cluster's
// columns of W_q^T from row n0 of its boxes, 3xTF32; each owner's columns
// of the partial go into its pa[q][wg] (gate0: the first gate's column).
template <int kR>
__device__ __forceinline__ void gru_gates(cg::cluster_group& cluster,
                                          const float* staged,
                                          const float* wt_hi,
                                          const float* wt_lo, int n0,
                                          int gate0, float* pa, int rows,
                                          int q, int wg, int kh) {
  constexpr int kUC = 3 * kCU;
  const int lane = threadIdx.x % 32, wq = threadIdx.x / 32 % 4;
  const int g8 = lane / 4, tig = lane % 4, hst = kh + 4;
  const int kb0 = wg * kh / 2, kb1 = kb0 + kh / 2, r = 16 * wq + g8;
  float big[kR], sa[kR], sb[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) big[i] = sa[i] = sb[i] = 0.f;
  for (int kb = kb0; kb < kb1; kb += 32) {     // one box of depth
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int k = kb + 8 * s + tig;
      split_tf32(staged[r * hst + k], ah[s][0], al[s][0]);
      split_tf32(staged[(r + 8) * hst + k], ah[s][1], al[s][1]);
      split_tf32(staged[r * hst + k + 4], ah[s][2], al[s][2]);
      split_tf32(staged[(r + 8) * hst + k + 4], ah[s][3], al[s][3]);
    }
    const size_t box = static_cast<size_t>(kb >> 5) * kGN * 32 + n0 * 32;
    const uint64_t dh = sw_desc(wt_hi + box), dl = sw_desc(wt_lo + box);
    wg_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      wgmma_rs(big, ah[s], dh + 2 * s);
      wgmma_rs(sa, ah[s], dl + 2 * s);
      wgmma_rs(sb, al[s], dh + 2 * s);
    }
    wg_commit_wait();
    hold(ah);
    hold(al);
    settle(big);
    settle(sa);
    settle(sb);
  }
  // column 8 jn + 2 tig + e is gate gate0 + jn of unit v = 2 tig + e of
  // the cluster (owner v / 4)
  const int v = 2 * tig;
  float* dst = cluster.map_shared_rank(pa, v / kCU) +
               (q * 2 + wg) * kBT * kUC + v % kCU;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r + 8 * hh;
    if (row >= rows) continue;
#pragma unroll
    for (int jn = 0; jn < kR / 4; ++jn) {
      const int i = 4 * jn + 2 * hh;
      *reinterpret_cast<float2*>(dst + row * kUC + (gate0 + jn) * kCU) =
          make_float2(big[i] + sa[i] + sb[i],
                      big[i + 1] + sa[i + 1] + sb[i + 1]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
gru_bwd_cluster_kernel(const float* __restrict__ x,
                       const float* __restrict__ w,
                       const int* __restrict__ lens,
                       const int* __restrict__ order,
                       const int* __restrict__ live,
                       const float* __restrict__ h0,
                       const float* __restrict__ hidden,
                       const float* __restrict__ rh,
                       const float* __restrict__ dhid,
                       const float* __restrict__ dhlast, float* dx,
                       float* dh0, float* part, unsigned* count,
                       unsigned base, int t_len, int b_len, int h) {
  constexpr int kHalves = 2;                 // partial gates from a peer
  constexpr int kUC = 3 * kCU;               // a block's gate columns
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ char smem_raw[];
  const ClusterSmem lay(h, kGruBwd);
  const int kh = lstm_cluster_kh(h), hst = kh + 4, tiles = kh / 64;
  float* wt_hi = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* wt_lo = wt_hi + lay.wt / 4;         // W_q^T [24][kh], sw_at
  float* dg_hi = wt_lo + lay.wt / 4;         // gate gradients [64][32]:
  float* dg_lo = dg_hi + lay.dg / 4;         // u 0-7, r 8-15, c 16-23
  float* hs = dg_lo + lay.dg / 4;            // h_prev [64][kh + 4] fp32
  float* rs = hs + lay.hs / 4;               // rh [64][kh + 4] fp32
  float* pa = rs + lay.rs / 4;               // [C][halves][64][12] fp32
  float* rx = pa + lay.pa / 4;               // [4][64] fp32
  const int tid = threadIdx.x, lane = tid % 32;
  // the warpgroup (uniform to the compiler, or it serializes the wgmmas)
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0), wq = tid / 32 % 4;
  const int g8 = lane / 4, tig = lane % 4;
  const int q = static_cast<int>(cluster.block_rank());
  const int clusters = gridDim.x / kCC, cl = blockIdx.x / kCC;
  const int u0 = blockIdx.x * kCU, k0q = q * kh;
  const size_t h3 = 3 * static_cast<size_t>(h);

  // W_q^T: row n = gate * 8 + v (gates u, r, c; v = q' * 4 + u, unit
  // cl * 8 + v), element (n, k) = w[q kh + k][gate * H + cl * 8 + v]
  for (int idx = tid; idx < kGN * kh; idx += kThreads) {
    const int n = idx / kh, k = idx % kh, kk = k0q + k;
    const int j = cl * kCC * kCU + n % 8;
    uint32_t hi = 0, lo = 0;
    if (kk < h && j < h) split_tf32(w[kk * h3 + (n / 8) * h + j], hi, lo);
    wt_hi[sw_at(kGN, n, k)] = __uint_as_float(hi);
    wt_lo[sw_at(kGN, n, k)] = __uint_as_float(lo);
  }
  // W_q as phases B and C's A operand, for the whole sequence: tile wg + 2 i
  // of the depth rows, k-step s = gate, the m16n8k8 fragment of each warp
  uint32_t wah[2][3][4], wal[2][3][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int s = 0; s < 3; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = k0q + 64 * (wg + 2 * i) + 16 * wq + g8 + 8 * (e & 1);
        const int j = cl * kCC * kCU + tig + 4 * (e >> 1);
        const bool in = wg + 2 * i < tiles && k < h && j < h;
        split_tf32(in ? w[k * h3 + s * h + j] : 0.f, wah[i][s][e],
                   wal[i][s][e]);
      }
  for (int idx = tid; idx < (lay.hs + lay.rs) / 4; idx += kThreads)
    hs[idx] = 0.0f;
  for (int idx = tid; idx < lay.dg / 2; idx += kThreads) dg_hi[idx] = 0.0f;
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();                     // the zeros before any staged row

  // stage columns [q kh, q kh + kh) of the pass's rows of h_prev into hs
  // (buffers & 1) and of rh into rs (buffers & 2), each thread's row ids
  // loaded four at a time
  auto stage = [&](int tt, int rr, int buffers) {
    const size_t off = static_cast<size_t>(tt) * b_len * h;
    const float* hp = tt == 0 ? h0 : hidden + off - static_cast<size_t>(b_len) * h;
    const float* rp = rh + off;
    const int c4 = kh / 4, n = min(kBT, live[tt] - rr) * c4;
    for (int idx0 = tid; idx0 < n; idx0 += 4 * kThreads) {
      int b4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = idx0 + e * kThreads;
        b4[e] = idx < n ? order[rr + idx / c4] : 0;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = idx0 + e * kThreads;
        if (idx >= n) break;
        const int i = idx / c4, c = idx % c4 * 4, k = k0q + c;
        const bool valid = k < h;
        const size_t at = static_cast<size_t>(b4[e]) * h + k;
        if (buffers & 1) copy16(hs + i * hst + c, valid ? hp + at : hp, valid);
        if (buffers & 2) copy16(rs + i * hst + c, valid ? rp + at : rp, valid);
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  // the recompute's two products of a staged pass into the owners' pa
  auto gates_ur = [&](int rows) {
    gru_gates<8>(cluster, hs, wt_hi, wt_lo, 0, 0, pa, rows, q, wg, kh);
  };
  auto gates_c = [&](int rows) {
    gru_gates<4>(cluster, rs, wt_hi, wt_lo, 16, 2, pa, rows, q, wg, kh);
  };
  int first = t_len - 1;
  while (first > 0 && live[first] == 0) --first;
  // after step tt's last read of the buffers: stage step tt - 1's first rows
  auto stage_after = [&](int tt, int buffers) {
    if (tt >= 1 && tt <= first) stage(tt - 1, 0, buffers);
  };

  // this thread's (row, unit) pair of a pass: row tid / 4, unit j, and the
  // cell's inputs of its pair (the carry read only where `carry`)
  const int bl = tid / kCU, ju = tid % kCU, j = u0 + ju;
  const bool unit = j < h;
  const size_t bh = static_cast<size_t>(b_len) * h;
  float cx[3] = {0.f, 0.f, 0.f}, chp = 0.f, cdl = 0.f, cdh = 0.f,
        ccarry = 0.f;
  int cb = 0, clen = 0;
  bool calive = false;
  auto load_cell = [&](int tt, int r0, bool carry) {
    calive = unit && bl < min(kBT, live[tt] - r0);
    cb = calive ? order[r0 + bl] : 0;
    if (!calive) return;
    const size_t at = static_cast<size_t>(cb) * h + j;
    const float* xb = x + (static_cast<size_t>(tt) * b_len + cb) * h3 + j;
    cx[0] = xb[0];
    cx[1] = xb[h];
    cx[2] = xb[2 * h];
    chp = (tt == 0 ? h0 : hidden + (tt - 1) * bh)[at];
    clen = lens[cb];
    cdl = dhlast[at];
    cdh = dhid[static_cast<size_t>(tt) * bh + at];
    if (carry) ccarry = dh0[at];
  };

  // the first step's first rows, before the loop; later steps' while the
  // grid barriers of the step before settle
  if (live[first] > 0) {
    load_cell(first, 0, true);
    stage(first, 0, 3);
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();
    gates_ur(min(kBT, live[first]));
    gates_c(min(kBT, live[first]));
    __syncthreads();                   // hs, rs are read before restaging
    if (live[first] <= kBT) stage_after(first, 3);
  }
  cluster.sync();                      // every block's memory is in place

  const int bpad = round_up(b_len, 4);
  float* part_r = part;                      // d_rh's partials [H][cl][bpad]
  float* part_h = part + static_cast<size_t>(h) * clusters * bpad;  // Dh's
  const int at_u = sw_at(kBT, bl, q * kCU + ju);
  const int at_r = sw_at(kBT, bl, 8 + q * kCU + ju);
  const int at_c = sw_at(kBT, bl, 16 + q * kCU + ju);
  unsigned target = base;

  for (int t = t_len - 1; t >= 0; --t) {
    const float* hp_seq = t == 0 ? h0 : hidden + (t - 1) * bh;
    float* dxt = dx + static_cast<size_t>(t) * b_len * h3;
    const int n_live = live[t];

    // phase A: the cell on the recomputed gates, dgu and dgc; phase B: the
    // cluster's partials of d_rh
    for (int r0 = 0; r0 < n_live; r0 += kBT) {
      const int rows = min(kBT, n_live - r0);
      if (r0 > 0) {                    // a later pass: its gates in line
        load_cell(t, r0, true);
        stage(t, r0, 3);
        asm volatile("cp.async.wait_group 0;" ::: "memory");
        __syncthreads();
        gates_ur(rows);
        gates_c(rows);
        cluster.sync();                // every partial of the gates landed
        if (r0 + kBT >= n_live) stage_after(t, 3);
      }
      // the cell of this thread's pair
      float dgc = 0.f;
      if (calive) {
        float z[3];
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          float sum = 0.f;
          for (int p = 0; p < kCC * kHalves; ++p)
            sum += pa[(p * kBT + bl) * kUC + g * kCU + ju];
          z[g] = sum;
        }
        const float u = sigmoidf(cx[0] + z[0]);
        const float rg = sigmoidf(cx[1] + z[1]);
        const float c = tanhf(cx[2] + z[2]);
        // a row's carry starts at the cotangent of its last state
        const bool last = t + 1 == t_len || t + 1 == clen;
        const float gh = (last ? cdl : ccarry) + cdh;
        const float du = gh * (c - chp);
        dgc = gh * u * (1.0f - c * c);
        float* db = dxt + cb * h3 + j;
        db[0] = du * u * (1.0f - u);
        db[h] = rg;                    // r, in dgr's place until phase C
        db[2 * h] = dgc;
        dh0[static_cast<size_t>(cb) * h + j] = gh * (1.0f - u);
      }
      // cluster exchange: the block's dgc, hi and lo, into every block's
      // gate gradients
      {
        uint32_t hi, lo;
        split_tf32(dgc, hi, lo);
#pragma unroll
        for (int p = 0; p < kCC; ++p) {
          cluster.map_shared_rank(dg_hi, p)[at_c] = __uint_as_float(hi);
          cluster.map_shared_rank(dg_lo, p)[at_c] = __uint_as_float(lo);
        }
      }
      asm volatile("fence.proxy.async.shared::cluster;" ::: "memory");
      cluster.sync();                  // every dgc has landed
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      // phase B: rows [q kh, q kh + kh) of the cluster's partial of
      // dgc @ w_c^T for the pass's rows
      gru_product_t<2, 3>(wah, wal, dg_hi, dg_lo, part_r, tiles, wg, k0q, r0,
                          r0 + rows, cl, clusters, bpad, h);
    }
    // the rows past their length: no gate gradient, the carry stays
    if (unit) {
      for (int r = n_live + bl; r < b_len; r += kBT) {
        const int b = order[r];
        float* db = dxt + b * h3 + j;
        db[0] = db[h] = db[2 * h] = 0.0f;
        if (t == 0) {                  // a row of length 0 hands it on
          const size_t at = static_cast<size_t>(b) * h + j;
          dh0[at] = dhlast[at];
        }
      }
    }
    // the next step's first rows (staged since the last read of hs, rs):
    // their u, r gates while the first barrier settles
    const bool next = t >= 1 && t <= first;
    const int next_rows = next ? min(kBT, live[t - 1]) : 0;
    grid_arrive(count);
    if (next) {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
      __syncthreads();
      gates_ur(next_rows);
    }
    grid_wait(count, target += gridDim.x);

    // phase C: d_rh from the clusters' partials, dgr, and the cluster's
    // partials of [dgu, dgr] @ w_ur^T
    for (int rb = 0; rb < n_live; rb += kBT) {
      const int r = rb + bl;
      const bool alive = unit && r < n_live;
      float* db = dxt;
      size_t at = 0;
      float rg = 0.f, dgu = 0.f, hpv = 0.f, carry = 0.f;
      if (alive) {                     // in flight while the partials add
        at = static_cast<size_t>(order[r]) * h + j;
        db = dxt + order[r] * h3 + j;
        rg = db[h];
        dgu = db[0];
        hpv = hp_seq[at];
        carry = dh0[at];
      }
      gru_reduce(part_r, rx, rb, n_live, u0, clusters, bpad, h);
      float dgr = 0.f;
      if (alive) {
        const float d_rh = rx[ju * kBT + bl];
        dgr = d_rh * hpv * rg * (1.0f - rg);
        db[h] = dgr;
        dh0[at] = carry + d_rh * rg;
      }
      {
        uint32_t uh, ul, rhi, rlo;
        split_tf32(dgu, uh, ul);
        split_tf32(dgr, rhi, rlo);
#pragma unroll
        for (int p = 0; p < kCC; ++p) {
          float* dh = cluster.map_shared_rank(dg_hi, p);
          float* dl = cluster.map_shared_rank(dg_lo, p);
          dh[at_u] = __uint_as_float(uh);
          dl[at_u] = __uint_as_float(ul);
          dh[at_r] = __uint_as_float(rhi);
          dl[at_r] = __uint_as_float(rlo);
        }
      }
      asm volatile("fence.proxy.async.shared::cluster;" ::: "memory");
      cluster.sync();                  // every dgu, dgr has landed
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      gru_product_t<0, 2>(wah, wal, dg_hi, dg_lo, part_h, tiles, wg, k0q, rb,
                          min(n_live, rb + kBT), cl, clusters, bpad, h);
    }
    // the next step's c gates, then the step after's first rows staged
    // (after the partials of d_rh have been read: the two contend for L2)
    // and the next cell's inputs loaded, while the second barrier settles
    grid_arrive(count);
    if (next) {
      gates_c(next_rows);
      __syncthreads();                 // hs, rs are read before restaging
      if (live[t - 1] <= kBT) stage_after(t - 1, 3);
      load_cell(t - 1, 0, false);
    }
    cluster.sync();                    // the next step's partial gates landed
    grid_wait(count, target += gridDim.x);

    // the carry: the clusters' partials of [dgu, dgr] @ w_ur^T added in
    for (int rb = 0; rb < n_live; rb += kBT) {
      const int r = rb + bl;
      const bool alive = unit && r < n_live;
      size_t at = 0;
      float carry = 0.f;
      if (alive) {
        at = static_cast<size_t>(order[r]) * h + j;
        carry = dh0[at];
      }
      gru_reduce(part_h, rx, rb, n_live, u0, clusters, bpad, h);
      if (alive) {
        carry += rx[ju * kBT + bl];
        dh0[at] = carry;
        if (rb == 0) ccarry = carry;   // the next cell's, pass 0
      }
    }
    // end of a step
  }
  cluster.sync();                      // no peer reads this block's memory
}

// W_q^T of gru_fwd_cluster_kernel, split into TF32 hi and lo, a box of 32 of
// depth at a time: 48 rows, the u and r columns' hi (rows 0-15) then lo
// (16-31), the c column's hi (32-39) then lo (40-47), K-major with the
// 128-byte swizzle (sw_at); row n = gate * 8 + v of gru_bwd_cluster_kernel's
// W_q^T is row gf_hi_row(n) (hi) and gf_lo_row(n) (lo) here.
constexpr int kGfRows = 2 * kGN;
__host__ __device__ constexpr int gf_hi_row(int n) {
  return n < 16 ? n : 16 + n;
}
__host__ __device__ constexpr int gf_lo_row(int n) {
  return n < 16 ? 16 + n : 24 + n;
}

// One product of gru_fwd_cluster_kernel: the pass's staged rows (the state
// for u and r, kC 16 columns from W row row0 = 0; rh[t] for c, kC 8 from
// row 32) over warpgroup wg's quarter of the block's depth (boxes of 32, in
// order), 3xTF32 in two wgmma a k-step: A_hi x [B_hi | B_lo] (N 2 kC) and
// A_lo x B_hi (N kC), where gru_gates takes three. Each owner's columns of
// the partial, hi hi + hi lo + lo hi, go into its pa[q][wg].
template <int kC>
__device__ __forceinline__ void gru_fwd_gates(cg::cluster_group& cluster,
                                              const float* staged,
                                              const float* wt, int row0,
                                              int gate0, float* pa, int rows,
                                              int q, int wg, int kh) {
  constexpr int kUC = 3 * kCU;
  constexpr int kJ = kC / 8;                   // column groups of 8
  const int lane = threadIdx.x % 32, wq = threadIdx.x / 32 % 4;
  const int g8 = lane / 4, tig = lane % 4, hst = kh + 4;
  const int boxes = kh / 32, r = 16 * wq + g8;
  const int kb0 = wg * boxes / kGfWG * 32;
  const int kb1 = (wg + 1) * boxes / kGfWG * 32;
  float hb[kC], lh[kC / 2];                    // hi x [hi | lo], lo x hi
#pragma unroll
  for (int i = 0; i < kC; ++i) hb[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kC / 2; ++i) lh[i] = 0.f;
  for (int kb = kb0; kb < kb1; kb += 32) {     // one box of depth
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int k = kb + 8 * s + tig;
      split_tf32(staged[r * hst + k], ah[s][0], al[s][0]);
      split_tf32(staged[(r + 8) * hst + k], ah[s][1], al[s][1]);
      split_tf32(staged[r * hst + k + 4], ah[s][2], al[s][2]);
      split_tf32(staged[(r + 8) * hst + k + 4], ah[s][3], al[s][3]);
    }
    const uint64_t d = sw_desc(wt + static_cast<size_t>(kb >> 5) * kGfRows *
                                        32 + row0 * 32);
    wg_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      wgmma_rs(hb, ah[s], d + 2 * s);
      wgmma_rs(lh, al[s], d + 2 * s);
    }
    wg_commit_wait();
    hold(ah);
    hold(al);
    settle(hb);
    settle(lh);
  }
  // column 8 jn + 2 tig + e (jn < kJ) is gate gate0 + jn of unit v = 2 tig
  // + e of the cluster (owner v / 4); its hi x lo term is column group jn +
  // kJ of hb
  const int v = 2 * tig;
  float* dst = cluster.map_shared_rank(pa, v / kCU) +
               (q * kGfWG + wg) * kBT * kUC + v % kCU;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r + 8 * hh;
    if (row >= rows) continue;
#pragma unroll
    for (int jn = 0; jn < kJ; ++jn) {
      const int i = 4 * jn + 2 * hh, o = 4 * (jn + kJ) + 2 * hh;
      *reinterpret_cast<float2*>(dst + row * kUC + (gate0 + jn) * kCU) =
          make_float2(hb[i] + hb[o] + lh[i], hb[i + 1] + hb[o + 1] +
                                                 lh[i + 1]);
    }
  }
}

// ---- GRU forward on thread-block clusters and tensor cores ----------------
//
// gru_fwd_cluster_kernel computes what gru_fwd_kernel computes, at the
// widths of the other cluster kernels (H <= 512, H a multiple of 4), for any
// T and B. What held gru_fwd_kernel back: per step each of its 128 blocks
// staged all of the state, then all of rh[t], from L2 (~16 MB a phase across
// the grid at B 64, H 512) for fp32 SIMT products, behind two cooperative
// grid syncs, and u made a round trip through hidden[t] between them. Here,
// on the LSTM forward's skeleton (lstm_fwd_cluster_kernel) and with the GRU
// backward's W_q^T (gru_bwd_cluster_kernel): clusters of C = 2 blocks
// (kCC), block g owning units [4g, 4g + 4) for the cell, block rank q
// holding W_q^T = w[q kh .. q kh + kh)[the cluster's 24 gate columns]^T,
// split into TF32 hi and lo, in shared memory for the whole sequence (u and
// r: 2 gates x 4 units x 2 blocks = 16 columns; c: 8 columns, wgmma's least
// N; 49 KB at H 512).
//   * Phase 1: each block stages columns [q kh, q kh + kh) of the live rows
//     of the state (cp.async through L2; no carry buffer: a row inside its
//     length at step t was inside it at t - 1, so its state is hidden[t - 1],
//     or h0), so the cluster reads the state once, multiplies them by the u
//     and r columns of W_q on the tensor cores (wgmma, 3xTF32 in two
//     instructions a k-step: gru_fwd_gates)
//     and sends each owner its units' partials through distributed shared
//     memory; the owner adds the C x 4 partials in rank order to xproj[t],
//     computes u and r, keeps u in
//     a register (a batch's later passes of 64 rows keep it in hidden[t]
//     until phase 2) and writes rh[t] = r h_prev, which phase 2 and the
//     backward read. Grid barrier.
//   * Phase 2: rh[t]'s columns staged the same way, times the c columns of
//     W_q; the owner adds the partials to xproj[t]'s c column and writes
//     hidden[t] = (1 - u) h_prev + u c. Grid barrier.
//   Two grid barriers a step (c needs every unit's r h_prev, the next step
//   every unit's new state), on the hand-written counter of the other
//   cluster kernels, the same stream's counter: a launch adds 2T x blocks.
//   Between a barrier's arrival and its wait a block has only the loads of
//   inputs to overlap: xproj[t]'s c column at the first, xproj[t + 1]'s u
//   and r columns at the second (the staged state and rh[t] exist only
//   after the barrier before them). A block runs four warpgroups (512
//   threads; the other cluster kernels two), each multiplying a quarter of
//   the depth's boxes, which stages the rows with more copies in flight;
//   a quarter of the threads own the cell's (row, unit) pairs. The first
//   pass's state and length stay in registers from step to step. The steps
//   past each row's length are zeroed before the recurrence. Batches above
//   64 rows take passes of 64 rows. Every sum runs in a fixed order: two
//   runs give the same bits.
__global__ void __launch_bounds__(kGfThreads, 1)
gru_fwd_cluster_kernel(const float* __restrict__ x,
                       const float* __restrict__ w,
                       const int* __restrict__ lens,
                       const int* __restrict__ order,
                       const int* __restrict__ live,
                       const float* __restrict__ h0, float* hidden,
                       float* __restrict__ hlast, float* rh, unsigned* count,
                       unsigned base, int t_len, int b_len, int h) {
  constexpr int kUC = 3 * kCU;               // a block's gate columns
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ char smem_raw[];
  const ClusterSmem lay(h, kGruFwd);
  const int kh = lstm_cluster_kh(h), hst = kh + 4;
  float* wt = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* hs = wt + lay.wt / 2;               // the staged rows [64][kh + 4]
  float* pa = hs + lay.hs / 4;               // [C][4 parts][64][12] fp32
  const int tid = threadIdx.x;
  // the warpgroup (uniform to the compiler, or it serializes the wgmmas)
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int q = static_cast<int>(cluster.block_rank());
  const int cl = blockIdx.x / kCC;
  const int u0 = blockIdx.x * kCU, k0q = q * kh;
  const size_t h3 = 3 * static_cast<size_t>(h);

  // W_q^T [48][kh] (gru_fwd_gates): row n = gate * 8 + v (gates u, r, c;
  // v = q' * 4 + u, unit cl * 8 + v) of w[q kh + k][gate * H + cl * 8 + v]
  // at rows gf_hi_row(n) and gf_lo_row(n)
  for (int idx = tid; idx < kGN * kh; idx += kGfThreads) {
    const int n = idx / kh, k = idx % kh, kk = k0q + k;
    const int j = cl * kCC * kCU + n % 8;
    uint32_t hi = 0, lo = 0;
    if (kk < h && j < h) split_tf32(w[kk * h3 + (n / 8) * h + j], hi, lo);
    wt[sw_at(kGfRows, gf_hi_row(n), k)] = __uint_as_float(hi);
    wt[sw_at(kGfRows, gf_lo_row(n), k)] = __uint_as_float(lo);
  }
  for (int idx = tid; idx < lay.hs / 4; idx += kGfThreads) hs[idx] = 0.0f;
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();                     // the zeros before any staged row
  cluster.sync();                      // every block's memory is in place

  // stage columns [q kh, q kh + kh) of rows order[r0 .. r0 + rows) of src
  // into hs (landed(): they are in place)
  auto stage = [&](const float* src, int r0, int rows) {
    const int c4 = kh / 4;
    for (int idx = tid; idx < rows * c4; idx += kGfThreads) {
      const int i = idx / c4, c = idx % c4 * 4, k = k0q + c;
      const bool valid = k < h;
      copy16(hs + i * hst + c,
             valid ? src + static_cast<size_t>(order[r0 + i]) * h + k : src,
             valid);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  auto landed = [&]() {
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();
  };
  // the partials of gate g of this thread's pair, added in rank order
  auto gate_sum = [&](int bl, int g, int ju) {
    float sum = 0.f;
    for (int p = 0; p < kCC * kGfWG; ++p)
      sum += pa[(p * kBT + bl) * kUC + g * kCU + ju];
    return sum;
  };

  // this thread's (row, unit) pair of a pass: row tid / 4, unit j (the
  // threads past the pass's 64 rows own none)
  const int bl = tid / kCU, ju = tid % kCU, j = u0 + ju;
  const bool unit = j < h && bl < kBT;
  const size_t bh = static_cast<size_t>(b_len) * h;
  auto x_at = [&](int tt, int b, int gate) {
    return x[(static_cast<size_t>(tt) * b_len + b) * h3 + gate * h + j];
  };
  // the steps past each row's length: zero outputs, written before the
  // recurrence (which never reads them); a row of length 0 keeps h0
  if (unit) {
    for (int r = bl; r < b_len; r += kBT) {
      const int b = order[r], len_b = lens[b];
      const size_t at = static_cast<size_t>(b) * h + j;
      for (int t = len_b > 0 ? len_b : 0; t < t_len; ++t) {
        hidden[static_cast<size_t>(t) * bh + at] = 0.0f;
        rh[static_cast<size_t>(t) * bh + at] = 0.0f;
      }
      if (len_b <= 0) hlast[at] = h0[at];
    }
  }
  // the first pass's pair: its row, length and state stay in registers,
  // its inputs load across the barriers
  const bool mine = unit && bl < b_len;
  const int b0 = mine ? order[bl] : 0;
  const int len0 = mine ? lens[b0] : 0;
  const size_t at0 = static_cast<size_t>(b0) * h + j;
  float h_reg = mine ? h0[at0] : 0.f, u_reg = 0.f;
  float xu = 0.f, xr = 0.f, xc = 0.f;
  if (mine && bl < live[0]) {
    xu = x_at(0, b0, 0);
    xr = x_at(0, b0, 1);
  }
  unsigned target = base;

  for (int t = 0; t < t_len; ++t) {
    const float* hp = t == 0 ? h0 : hidden + (t - 1) * bh;
    float* hid_t = hidden + t * bh;
    float* rh_t = rh + t * bh;
    const int n_live = live[t];

    // phase 1: u and r of the pass's rows, rh[t]
    for (int r0 = 0; r0 < n_live; r0 += kBT) {
      const int rows = min(kBT, n_live - r0);
      stage(hp, r0, rows);
      // a later pass's inputs, in flight while the staged rows land
      const bool alive = unit && bl < rows;
      const int b = r0 == 0 ? b0 : alive ? order[r0 + bl] : 0;
      const size_t at = static_cast<size_t>(b) * h + j;
      float pu = xu, pr = xr, hpv = h_reg;
      if (r0 > 0 && alive) {
        pu = x_at(t, b, 0);
        pr = x_at(t, b, 1);
        hpv = hp[at];
      }
      landed();
      gru_fwd_gates<16>(cluster, hs, wt, 0, 0, pa, rows, q, wg, kh);
      cluster.sync();                  // every partial of u, r landed
      if (alive) {
        const float u = sigmoidf(pu + gate_sum(bl, 0, ju));
        const float r = sigmoidf(pr + gate_sum(bl, 1, ju));
        rh_t[at] = r * hpv;
        if (r0 == 0)
          u_reg = u;
        else
          hid_t[at] = u;               // until phase 2 of this pass
      }
      if (r0 + kBT < n_live) cluster.sync();   // pa and hs are read before
                                               // the next pass reuses them
    }
    grid_arrive(count);
    if (mine && bl < n_live) xc = x_at(t, b0, 2);
    grid_wait(count, target += gridDim.x);

    // phase 2: c from the pass's rows of rh[t], the new state
    for (int r0 = 0; r0 < n_live; r0 += kBT) {
      const int rows = min(kBT, n_live - r0);
      stage(rh_t, r0, rows);
      const bool alive = unit && bl < rows;
      const int b = r0 == 0 ? b0 : alive ? order[r0 + bl] : 0;
      const size_t at = static_cast<size_t>(b) * h + j;
      float pc = xc, ug = u_reg, hpv = h_reg;
      int len_b = len0;
      if (r0 > 0 && alive) {
        pc = x_at(t, b, 2);
        ug = hid_t[at];
        hpv = hp[at];
        len_b = lens[b];
      }
      landed();
      gru_fwd_gates<8>(cluster, hs, wt, 32, 2, pa, rows, q, wg, kh);
      cluster.sync();                  // every partial of c landed
      if (alive) {
        const float c = tanhf(pc + gate_sum(bl, 2, ju));
        const float h_new = (1.0f - ug) * hpv + ug * c;
        hid_t[at] = h_new;
        if (r0 == 0) h_reg = h_new;
        if (t + 1 == t_len || t + 1 == len_b) hlast[at] = h_new;
      }
      if (r0 + kBT < n_live) cluster.sync();
    }
    grid_arrive(count);
    if (mine && t + 1 < t_len && bl < live[t + 1]) {
      xu = x_at(t + 1, b0, 0);
      xr = x_at(t + 1, b0, 1);
    }
    grid_wait(count, target += gridDim.x);
  }
}

}  // namespace

// blocks 0: gru_fwd_kernel on plan_for's grid (wscratch where the plan
// needs it); else gru_fwd_cluster_kernel on `blocks` blocks (whole clusters
// of 2, 4 units each, H <= 512 and a multiple of 4, h0, hidden and rh
// 16-byte aligned), count the grid barrier's counter at `base` when the
// launch starts (two barriers a step: it ends at base + 2T x blocks, modulo
// 2^32).
extern "C" int paddle_gru_train_fwd(const float* x, const float* w,
                                    const int* lens, const int* order,
                                    const int* live, const float* h0,
                                    float* hidden, float* hlast, float* rh,
                                    float* wscratch, unsigned* count,
                                    unsigned base, int t_len, int b_len,
                                    int h, int blocks, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (blocks == 0) {
    Plan p;
    cudaError_t err = checked_plan(kGruFwd, t_len, b_len, h, wscratch, &p);
    if (err != cudaSuccess) return err;
    void* args[] = {&x, &w, &lens, &order, &live, &h0, &hidden, &hlast, &rh,
                    &wscratch, &t_len, &b_len, &h};
    return PADDLE_RNN_LAUNCH(gru_fwd_kernel, p, h, args, s);
  }
  if (!cluster_args_ok(t_len, b_len, h, blocks, count, h0, hidden) ||
      (reinterpret_cast<uintptr_t>(rh) & 15) != 0)
    return cudaErrorInvalidValue;
  void* args[] = {&x, &w, &lens, &order, &live, &h0, &hidden, &hlast, &rh,
                  &count, &base, &t_len, &b_len, &h};
  return launch_cluster(kGruFwd, blocks, h, args, s);
}

// blocks 0: rnn_gemm (the gate pre-activations) and gru_bwd_kernel on
// plan_for's grid (wscratch where the plan needs it); else
// gru_bwd_cluster_kernel on `blocks` blocks (whole clusters of 2, 4 units
// each, H <= 512 and a multiple of 4, h0, hidden and rh 16-byte aligned)
// with part [2, H, blocks / 2, round_up(B, 4)] fp32 scratch and count, the
// grid barrier's counter, at `base` when the launch starts (two barriers a
// step: it ends at base + 2T x blocks, modulo 2^32). Then dw on the tensor
// cores.
extern "C" int paddle_gru_train_bwd(
    const float* x, const float* w, const int* lens, const int* order,
    const int* live, const float* h0, const float* hidden, const float* rh,
    const float* dhid, const float* dhlast, float* dx, float* dw, float* dh0,
    float* wscratch, float* part, unsigned* count, unsigned base, int t_len,
    int b_len, int h, int blocks, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (blocks == 0) {
    Plan p;
    err = checked_plan(kGruBwd, t_len, b_len, h, wscratch, &p);
    if (err != cudaSuccess) return err;
    // the gate pre-activations of every step: [h_prev_seq @ w_ur, rh @ w_c]
    const int rows = t_len * b_len;
    rnn_gemm({h0, hidden, b_len, w, dx, 2 * h},
             {rh, rh, rows, w + 2 * h, dx + 2 * h, h}, h, 3 * h, 3 * h, rows,
             h, s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    void* args[] = {&x, &w, &lens, &order, &live, &h0, &hidden, &dhid,
                    &dhlast, &dx, &dh0, &wscratch, &t_len, &b_len, &h};
    err = PADDLE_RNN_LAUNCH(gru_bwd_kernel, p, h, args, s);
  } else {
    if (!cluster_args_ok(t_len, b_len, h, blocks, count, h0, hidden) ||
        part == nullptr || (reinterpret_cast<uintptr_t>(rh) & 15) != 0)
      return cudaErrorInvalidValue;
    void* args[] = {&x, &w, &lens, &order, &live, &h0, &hidden, &rh,
                    &dhid, &dhlast, &dx, &dh0, &part, &count, &base,
                    &t_len, &b_len, &h};
    err = launch_cluster(kGruBwd, blocks, h, args, s);
  }
  if (err != cudaSuccess) return err;
  // dw = [h_prev_seq^T @ dx[:, :2H], rh^T @ dx[:, 2H:]] over the T*B rows
  return rnn_dw({h0, hidden, b_len, 0, 2 * h}, {rh, rh, 0, 2 * h, 3 * h}, dx,
                dw, 3 * h, t_len, b_len, h, s);
}
