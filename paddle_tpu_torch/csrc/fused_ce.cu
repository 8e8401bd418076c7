// Fused vocabulary projection + label-smoothed softmax cross entropy, the
// forward pass and its two backward passes, written for Hopper (compiled for
// sm_90a) behind a plain C interface that ctypes loads.
//
// Replaces the two Pallas TPU kernels of paddle_tpu/ops/pallas/fused_ce.py:
//   paddle_fused_ce_fwd  <- _fwd     (:173, pallas_call :185, _fwd_kernel :47)
//   paddle_fused_ce_dx   <- _vjp_bwd (:222, pallas_call :234, _bwd_kernel :101), dx
//   paddle_fused_ce_dw   <- the same TPU kernel, dW
//
// Inputs are fp32 and contiguous: x [N, D] row-major, w [D, V] row-major,
// labels [N] int32; any D (wider than 512 in chunks, below). With z = x @ w
// the forward writes, per row,
//   lse  = max z + log(sum exp(z - max z))
//   loss = lse - (1 - eps) * z[label] - eps * sum(z) / V   (0 where label ==
//          ignore_index)
// (_fwd_kernel :82-86), and the backward takes lse and a per-row cotangent g
// and writes dx = dz @ w^T and dW = x^T @ dz with
//   dz = (exp(z - lse) - (label == col ? 1 - eps : 0) - eps / V) * g
// (_dlogits :90-98; 0 on ignored rows). The [N, V] logits and dlogits never
// reach device memory: every kernel recomputes its tiles of z from x and w.
//
// What bounds them: arithmetic. At Transformer-base's head (N 4096, D 512,
// V 32000) the forward does 2*N*D*V = 134.2 GFLOP over 74 MB of inputs, and
// each backward kernel 268.4 GFLOP (the z recompute and its own product).
// TF32 is off for parity, so the peak is fp32 outside the tensor cores
// (67 TFLOP/s on an H100 SXM): 2.0 ms and 4.0 ms at least.
//
// Design. The TPU kernel walks vocab blocks in order on one core, carrying
// (max, sumexp, sum z, z_label) and the dx accumulator in VMEM across grid
// steps, and writes per-row-block dW partials that are summed outside. On
// Hopper the blocks run in parallel and in no order, so every kernel here
// gives each block one fixed operand tile P of 32 rows (of x, or of w^T)
// kept in shared memory, and streams tiles Q of 64 rows of the other operand
// through shared memory in increasing order inside the block:
//   forward  P = 32 rows of x,   Q = 64 vocab columns of w; a block runs the
//            online log-sum-exp over its share of the vocabulary (the vocab
//            is split across blockIdx.y when the row tiles alone would leave
//            SMs idle) and a second small kernel merges the shares per row;
//   dx       P = 32 rows of x,   Q = 64 vocab columns of w, all of them;
//   dW       P = 32 vocab columns of w, Q = 64 rows of x, all of them.
// The backward is deterministic and needs no atomics: a dx block owns its
// rows and a dW block its columns, and each sums in a fixed order. It pays
// for that with a second recompute of z (4 * N*D*V FLOPs for the two
// kernels against the 3 * N*D*V a single fused pass needs). Each step:
//   1. scores: S[p][q] = sum_d P[d][p] Q[d][q]; threads 0-127 and 128-255
//      each take half of d (4 x 4 outputs a thread) and the halves are added
//      in that order, so all three kernels compute bit-identical z;
//   2. the forward folds S into its running row statistics (eight threads a
//      row, shuffles over those eight); the backward forms dz into shared
//      memory;
//   3. the backward adds dz @ Q to a [32, D] accumulator held in registers
//      (4 rows x D/32 columns a thread, 64 registers at D 512).
// P is stored [d][p] with rows padded to 36 floats (16-byte float4 reads of
// four p at once), Q [d][q] with rows of 65 floats (odd stride: the column
// reads of step 3 hit 32 distinct banks). Shared memory at D 512 is 220 KB,
// one block per SM. Blocks of one grid walk the vocabulary (or the rows) in
// the same order, so the w (or x) tiles they stream are L2 hits. A Q tile
// arrives as one cp.async per element, the whole tile in flight at once (a
// loop of plain loads kept a few in flight a thread and made the forward
// 2x slower); it is not overlapped with the compute, for which there is no
// room for a second buffer at D 512. This is fp32 SIMT with no wgmma and no
// TMA: the simple, exact first version.
// Ragged edges (N, V not multiples of the tiles, any D <= 512) load as zeros
// and are masked out of the statistics and of dz, and never written.
//   D > 512 (transformer_big's d_model 1024): a P tile of 32 x D no longer
// fits beside Q, nor the [32, D] dx accumulator in registers. The depth is
// then taken in chunks of 512 in increasing order (chunked_scores): each
// chunk of P and of Q is staged anew and each thread carries its two
// half-sums over the chunks in registers, the same order in all three
// kernels, so their z still agree bit for bit. The dx and dW kernels give
// each block one 512-wide chunk of their output (a second grid dimension):
// every block recomputes z over the whole of D, then stages the Q tile of
// its own chunk for the product. That costs one more recompute of z per
// output chunk; it is exact and deterministic. D <= 512 keeps the path
// above.
//
// Each function launches on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() of its launches (0 = success;
// cudaErrorInvalidValue for a shape it does not take).

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kP = 32;          // rows of the fixed operand tile
constexpr int kQ = 64;          // rows of a streamed operand tile
constexpr int kLP = kP + 4;     // sP row stride: [d][p], 16-byte aligned
constexpr int kLQ = kQ + 1;     // sQ row stride: [d][q], odd
constexpr int kLS = kQ + 1;     // sS row stride: [p][q]
constexpr int kLG = kP + 4;     // sG row stride: [q][p], 16-byte aligned
constexpr int kChunkD = 512;    // the widest D held whole in shared memory
constexpr float kNeg = -1e30f;  // the TPU kernel's initial running max

// sP[dd][p] <- the fixed tile over depth [d0, d0 + dc) of the row width d:
// rows p0.. of x (kPRows) or columns p0.. of w
template <bool kPRows>
__device__ __forceinline__ void load_p(float* __restrict__ sP,
                                       const float* __restrict__ x,
                                       const float* __restrict__ w, int p0,
                                       int n, int d, int d0, int dc, int v) {
  for (int i = threadIdx.x; i < kP * dc; i += kThreads) {
    if (kPRows) {
      const int p = i / dc, dd = i - p * dc;
      sP[dd * kLP + p] =
          p0 + p < n ? __ldg(x + static_cast<size_t>(p0 + p) * d + d0 + dd)
                     : 0.f;
    } else {
      const int dd = i / kP, p = i % kP;
      sP[dd * kLP + p] =
          p0 + p < v ? __ldg(w + static_cast<size_t>(d0 + dd) * v + p0 + p)
                     : 0.f;
    }
  }
}

// one 4-byte global -> shared copy in flight (cp.async); an invalid source
// writes a zero and reads nothing
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// sQ[dd][q] <- the streamed tile over depth [d0, d0 + dc) of the row width
// d: columns q0.. of w (kPRows) or rows q0.. of x. Every element is its own
// asynchronous copy, so a thread has its whole share of the tile in flight
// at once instead of a few loads at a time; the caller's barrier follows
// copies_done().
template <bool kPRows>
__device__ __forceinline__ void load_q(float* __restrict__ sQ,
                                       const float* __restrict__ x,
                                       const float* __restrict__ w, int q0,
                                       int n, int d, int d0, int dc, int v) {
  if (kPRows) {  // rows of 64 columns, coalesced along q
    const int q = threadIdx.x % kQ;
    const bool ok = q0 + q < v;
    const float* src = w + static_cast<size_t>(d0) * v + (ok ? q0 + q : 0);
    for (int dd = threadIdx.x / kQ; dd < dc; dd += kThreads / kQ)
      copy4(sQ + dd * kLQ + q, src + static_cast<size_t>(dd) * v, ok);
  } else {       // rows of x, coalesced along d
    for (int q = 0; q < kQ; ++q) {
      const bool ok = q0 + q < n;
      const float* src = x + (ok ? static_cast<size_t>(q0 + q) * d : 0) + d0;
      for (int dd = threadIdx.x; dd < dc; dd += kThreads)
        copy4(sQ + dd * kLQ + q, src + dd, ok);
    }
  }
  copies_done();
}

// acc[i][e] += sum_dd sP[dd][p] * sQ[dd][q] over this thread's half of the
// staged depth d: threads 0-127 take the first half, 128-255 the second,
// p = 4 tp + i, q = tq + 16 e.
__device__ __forceinline__ void scores_add(float (&acc)[4][4],
                                           const float* __restrict__ sP,
                                           const float* __restrict__ sQ,
                                           int d) {
  const int half = threadIdx.x / 128, u = threadIdx.x % 128;
  const int tp = u / 16, tq = u % 16;
  const int dh = (d + 1) / 2;
  const int d0 = half * dh, d1 = min(d, d0 + dh);
#pragma unroll 4
  for (int k = d0; k < d1; ++k) {
    const float4 pv = *reinterpret_cast<const float4*>(sP + k * kLP + 4 * tp);
    const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
    float qv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) qv[e] = sQ[k * kLQ + tq + 16 * e];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = fmaf(pr[i], qv[e], acc[i][e]);
  }
}

// sS[p][q] <- the first half's sums plus the second's, in that order. Every
// thread must call it; it ends in a barrier.
__device__ __forceinline__ void scores_out(float* __restrict__ sS,
                                           const float (&acc)[4][4]) {
  const int half = threadIdx.x / 128, u = threadIdx.x % 128;
  const int tp = u / 16, tq = u % 16;
  if (half == 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sS[(4 * tp + i) * kLS + tq + 16 * e] = acc[i][e];
  }
  __syncthreads();
  if (half == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float* s = sS + (4 * tp + i) * kLS + tq + 16 * e;
        *s = acc[i][e] + *s;
      }
  }
  __syncthreads();
}

// sS[p][q] = sum_dd sP[dd][p] * sQ[dd][q] over one staged depth d (<= 512).
// Every thread must call it; it ends in a barrier.
__device__ __forceinline__ void scores(float* __restrict__ sS,
                                       const float* __restrict__ sP,
                                       const float* __restrict__ sQ, int d) {
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  scores_add(acc, sP, sQ, d);
  scores_out(sS, acc);
}

// The same scores for D > 512: the depth in chunks of 512 in increasing
// order, both tiles of each chunk staged anew (P does not fit whole), each
// thread's half-sums carried over the chunks in registers. All three kernels
// take this path for the same D, so their z agree bit for bit. Starts and
// ends with a barrier.
template <bool kPRows>
__device__ __forceinline__ void chunked_scores(
    float* __restrict__ sS, float* __restrict__ sP, float* __restrict__ sQ,
    const float* __restrict__ x, const float* __restrict__ w, int p0, int q0,
    int n, int d, int v) {
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  for (int d0 = 0; d0 < d; d0 += kChunkD) {
    const int dc = min(kChunkD, d - d0);
    __syncthreads();  // the last reads of sP, sQ and sS are done
    load_p<kPRows>(sP, x, w, p0, n, d, d0, dc, v);
    load_q<kPRows>(sQ, x, w, q0, n, d, d0, dc, v);
    __syncthreads();
    scores_add(acc, sP, sQ, dc);
  }
  scores_out(sS, acc);
}

// reductions over the eight lanes that share one score row
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int off = 4; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = 4; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__host__ __device__ constexpr int fwd_smem_floats(int d) {
  return d * kLP + d * kLQ + kP * kLS;
}

// ---------------------------------------------------------------------------
// forward, grid (ceil(N / 32), splits): the running (max, sumexp, sum z,
// z_label) of each row over vocab chunks [s * cps, (s + 1) * cps) of 64
// columns, written to part [4][splits][N]. kChunked: D > 512, the scores
// by chunked_scores.
template <bool kChunked>
__global__ void __launch_bounds__(kThreads, 1)
fused_ce_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const int* __restrict__ labels, float* __restrict__ part,
                    int n, int d, int v, int cps) {
  extern __shared__ float smem[];
  const int ds = kChunked ? kChunkD : d;  // depth of the staged tiles
  float* sP = smem;
  float* sQ = sP + ds * kLP;
  float* sS = sQ + ds * kLQ;
  const int p0 = blockIdx.x * kP, s = blockIdx.y, splits = gridDim.y;
  if (!kChunked) load_p<true>(sP, x, w, p0, n, d, 0, d, v);
  const int p = threadIdx.x / 8, sub = threadIdx.x % 8;
  const int row = p0 + p;
  const int lab = row < n ? labels[row] : -1;
  float m = kNeg, l = 0.f, zs = 0.f, zl = 0.f;
  const int n_chunks = (v + kQ - 1) / kQ;
  const int cb = s * cps, ce = min(n_chunks, cb + cps);
  for (int c = cb; c < ce; ++c) {
    const int q0 = c * kQ;
    if (kChunked) {
      chunked_scores<true>(sS, sP, sQ, x, w, p0, q0, n, d, v);
    } else {
      __syncthreads();  // the previous chunk's reads of sQ and sS are done
      load_q<true>(sQ, x, w, q0, n, d, 0, d, v);
      __syncthreads();
      scores(sS, sP, sQ, d);
    }
    float z[8];
    float cmax = -INFINITY;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int q = sub + 8 * k;
      z[k] = sS[p * kLS + q];
      if (q0 + q < v) cmax = fmaxf(cmax, z[k]);
    }
    const float m_new = fmaxf(m, group_max(cmax));
    float se = 0.f, zsum = 0.f, zlab = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int col = q0 + sub + 8 * k;
      if (col < v) {
        se += expf(z[k] - m_new);
        zsum += z[k];
        if (col == lab) zlab += z[k];
      }
    }
    l = l * expf(m - m_new) + group_sum(se);
    m = m_new;
    zs += group_sum(zsum);
    zl += group_sum(zlab);
  }
  if (sub == 0 && row < n) {
    const size_t plane = static_cast<size_t>(splits) * n;
    const size_t at = static_cast<size_t>(s) * n + row;
    part[at] = m;
    part[plane + at] = l;
    part[2 * plane + at] = zs;
    part[3 * plane + at] = zl;
  }
}

// one thread a row: merge the splits' statistics (log-sum-exp combine) into
// lse and the label-smoothed loss (_fwd_kernel :80-87)
__global__ void fused_ce_combine_kernel(const float* __restrict__ part,
                                        const int* __restrict__ labels,
                                        float* __restrict__ loss,
                                        float* __restrict__ lse, int n,
                                        int splits, float on, float eps,
                                        float vocab, int ignore) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const size_t plane = static_cast<size_t>(splits) * n;
  float mx = kNeg;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, part[s * n + r]);
  float l = 0.f, zs = 0.f, zl = 0.f;
  for (int s = 0; s < splits; ++s) {
    const size_t at = static_cast<size_t>(s) * n + r;
    l += part[plane + at] * expf(part[at] - mx);
    zs += part[2 * plane + at];
    zl += part[3 * plane + at];
  }
  const float lse_r = mx + logf(fmaxf(l, 1e-30f));
  const float lo = lse_r - on * zl - eps * zs / vocab;
  loss[r] = labels[r] == ignore ? 0.f : lo;
  lse[r] = lse_r;
}

__host__ __device__ constexpr int bwd_smem_floats(int nj) {
  return 128 * nj * (kLP + kLQ) + kP * kLS + kQ * kLG + 3 * kQ;
}

// ---------------------------------------------------------------------------
// backward. kPRows: dx, grid ceil(N / 32), P = x rows, Q = w columns over
// the whole vocabulary; else dW, grid ceil(V / 32), P = w columns, Q = x rows
// over all N. NJ = ceil(D / 128): a thread accumulates 4 P rows x 4 NJ
// columns d = lane + 32 j. kChunked (D > 512, NJ 4): the grid's second
// dimension cuts the output's D into chunks of 512, one a block; every block
// computes z over the whole of D (chunked_scores), then stages the Q tile of
// its own output chunk for the product.
template <bool kPRows, int NJ, bool kChunked>
__global__ void __launch_bounds__(kThreads, 1)
fused_ce_bwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const int* __restrict__ labels,
                    const float* __restrict__ lse, const float* __restrict__ g,
                    float* __restrict__ out, int n, int d, int v, float on,
                    float off, int ignore) {
  constexpr int kJ = 4 * NJ, kDPad = 128 * NJ;
  // the block's output columns (dx) or rows (dW): [o0, o0 + od)
  const int o0 = kChunked ? blockIdx.y * kChunkD : 0;
  const int od = kChunked ? min(kChunkD, d - o0) : d;
  extern __shared__ float smem[];
  float* sP = smem;                  // [kDPad][kLP]
  float* sQ = sP + kDPad * kLP;      // [kDPad][kLQ]; rows >= d stay zero
  float* sS = sQ + kDPad * kLQ;      // [kP][kLS] scores
  float* sG = sS + kP * kLS;         // [kQ][kLG] dz, transposed
  float* sLse = sG + kQ * kLG;       // per-row lse, g and label of the
  float* sGr = sLse + kQ;            // rows this step touches
  int* sLab = reinterpret_cast<int*>(sGr + kQ);
  const int p0 = blockIdx.x * kP;
  const int wp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (!kChunked) load_p<kPRows>(sP, x, w, p0, n, d, 0, d, v);
  // rows past the depth stay zero (a chunked block's columns past od read
  // what an earlier chunk left and are never written)
  for (int i = (kChunked ? kDPad : d) * kLQ + threadIdx.x; i < kDPad * kLQ;
       i += kThreads)
    sQ[i] = 0.f;
  auto load_rows = [&](int r0, int count) {
    if (threadIdx.x < count) {
      const int r = r0 + threadIdx.x;
      sLse[threadIdx.x] = r < n ? lse[r] : 0.f;
      sGr[threadIdx.x] = r < n ? g[r] : 0.f;
      sLab[threadIdx.x] = r < n ? labels[r] : ignore;
    }
  };
  if (kPRows) load_rows(p0, kP);

  float acc[4][kJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kJ; ++j) acc[i][j] = 0.f;
  const int steps = kPRows ? (v + kQ - 1) / kQ : (n + kQ - 1) / kQ;
  for (int st = 0; st < steps; ++st) {
    const int q0 = st * kQ;
    __syncthreads();  // the previous step's reads of sQ, sG and the rows
    if (kChunked) {
      if (!kPRows) load_rows(q0, kQ);
      chunked_scores<kPRows>(sS, sP, sQ, x, w, p0, q0, n, d, v);
      if (o0 + kChunkD < d) {  // sQ holds the last chunk, not the block's
        load_q<kPRows>(sQ, x, w, q0, n, d, o0, od, v);
        __syncthreads();
      }
    } else {
      load_q<kPRows>(sQ, x, w, q0, n, d, 0, d, v);
      if (!kPRows) load_rows(q0, kQ);
      __syncthreads();
      scores(sS, sP, sQ, d);
    }
    {  // dz (_dlogits): thread -> p = t / 8, q = t % 8 + 8 k
      const int p = threadIdx.x / 8, sub = threadIdx.x % 8;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int q = sub + 8 * k;
        const int row = kPRows ? p0 + p : q0 + q;
        const int col = kPRows ? q0 + q : p0 + p;
        const int ri = kPRows ? p : q;
        float dz = 0.f;
        if (row < n && col < v && sLab[ri] != ignore) {
          const float pr = expf(sS[p * kLS + q] - sLse[ri]);
          const float t = (col == sLab[ri] ? on : 0.f) + off;
          dz = (pr - t) * sGr[ri];
        }
        sG[q * kLG + p] = dz;
      }
    }
    __syncthreads();
    // acc[i][j] += sum_q dz[q][4 wp + i] * Q[lane + 32 j][q]
#pragma unroll 2
    for (int q = 0; q < kQ; ++q) {
      const float4 gv = *reinterpret_cast<const float4*>(sG + q * kLG + 4 * wp);
      const float gr[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const float qv = sQ[(lane + 32 * j) * kLQ + q];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(gr[i], qv, acc[i][j]);
      }
    }
  }

  if (kPRows) {  // dx rows, coalesced along d
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = p0 + 4 * wp + i;
      if (r >= n) continue;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int dd = lane + 32 * j;
        if (dd < od) out[static_cast<size_t>(r) * d + o0 + dd] = acc[i][j];
      }
    }
  } else {  // dW columns, staged through shared memory to write rows of 32
    constexpr int kLB = kP + 1;
    float* buf = sQ;  // [kDPad][kLB]
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kJ; ++j)
        buf[(lane + 32 * j) * kLB + 4 * wp + i] = acc[i][j];
    __syncthreads();
    for (int i = threadIdx.x; i < od * kP; i += kThreads) {
      const int dd = i / kP, p = i % kP;
      if (p0 + p < v)
        out[static_cast<size_t>(o0 + dd) * v + p0 + p] = buf[dd * kLB + p];
    }
  }
}

// above 48 KB a kernel needs the opt-in, once per instantiation
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <bool kPRows, int NJ, bool kChunked = false>
cudaError_t launch_bwd(const float* x, const float* w, const int* labels,
                       const float* lse, const float* g, float* out, int n,
                       int d, int v, float on, float off, int ignore,
                       cudaStream_t s) {
  const size_t smem = sizeof(float) * bwd_smem_floats(NJ);
  auto kernel = fused_ce_bwd_kernel<kPRows, NJ, kChunked>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int tiles = kPRows ? (n + kP - 1) / kP : (v + kP - 1) / kP;
  const dim3 grid(tiles, kChunked ? (d + kChunkD - 1) / kChunkD : 1);
  kernel<<<grid, kThreads, smem, s>>>(x, w, labels, lse, g, out, n, d, v, on,
                                      off, ignore);
  return cudaGetLastError();
}

template <bool kPRows>
cudaError_t dispatch_bwd(const float* x, const float* w, const int* labels,
                         const float* lse, const float* g, float* out, int n,
                         int d, int v, float on, float off, int ignore,
                         void* stream) {
  if (n <= 0 || v <= 0 || d <= 0 || (d + kChunkD - 1) / kChunkD > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d > kChunkD)
    return launch_bwd<kPRows, 4, true>(x, w, labels, lse, g, out, n, d, v, on,
                                       off, ignore, s);
  switch ((d + 127) / 128) {
    case 1: return launch_bwd<kPRows, 1>(x, w, labels, lse, g, out, n, d, v, on, off, ignore, s);
    case 2: return launch_bwd<kPRows, 2>(x, w, labels, lse, g, out, n, d, v, on, off, ignore, s);
    case 3: return launch_bwd<kPRows, 3>(x, w, labels, lse, g, out, n, d, v, on, off, ignore, s);
    case 4: return launch_bwd<kPRows, 4>(x, w, labels, lse, g, out, n, d, v, on, off, ignore, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// splits: how many blocks share one row tile's vocabulary (1 <= splits <=
// 65535); part: scratch of 4 * splits * n floats
extern "C" int paddle_fused_ce_fwd(const float* x, const float* w,
                                   const int* labels, float* part,
                                   float* loss, float* lse, int n, int d,
                                   int v, int splits, float on, float eps,
                                   float vocab, int ignore, void* stream) {
  if (n <= 0 || v <= 0 || d <= 0 || splits < 1 || splits > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool chunked = d > kChunkD;
  const size_t smem =
      sizeof(float) * fwd_smem_floats(chunked ? kChunkD : d);
  auto kernel = chunked ? fused_ce_fwd_kernel<true>
                        : fused_ce_fwd_kernel<false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int n_chunks = (v + kQ - 1) / kQ;
  const int cps = (n_chunks + splits - 1) / splits;
  const dim3 grid((n + kP - 1) / kP, splits);
  kernel<<<grid, kThreads, smem, s>>>(x, w, labels, part, n, d, v, cps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fused_ce_combine_kernel<<<(n + 255) / 256, 256, 0, s>>>(
      part, labels, loss, lse, n, splits, on, eps, vocab, ignore);
  return cudaGetLastError();
}

extern "C" int paddle_fused_ce_dx(const float* x, const float* w,
                                  const int* labels, const float* lse,
                                  const float* g, float* dx, int n, int d,
                                  int v, float on, float off, int ignore,
                                  void* stream) {
  return dispatch_bwd<true>(x, w, labels, lse, g, dx, n, d, v, on, off,
                            ignore, stream);
}

extern "C" int paddle_fused_ce_dw(const float* x, const float* w,
                                  const int* labels, const float* lse,
                                  const float* g, float* dw, int n, int d,
                                  int v, float on, float off, int ignore,
                                  void* stream) {
  return dispatch_bwd<false>(x, w, labels, lse, g, dw, n, d, v, on, off,
                             ignore, stream);
}
