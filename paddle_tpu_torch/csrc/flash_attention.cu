// Flash attention for training: the forward pass and its two backward
// passes, written for Hopper (compiled for sm_90a) behind a plain C
// interface that ctypes loads.
//
// Replaces the three Pallas TPU kernels of
// paddle_tpu/ops/pallas/flash_attention.py:
//   paddle_flash_fwd  <- _flash_fwd      (:174, pallas_call :189, _fwd_kernel :85)
//   paddle_flash_dq   <- _flash_bwd_impl (:455, pallas_call :481, _dq_kernel :342)
//   paddle_flash_dkv  <- _flash_bwd_impl (:455, pallas_call :504, _dkv_kernel :396)
//
// All three take fp32 [BH, T, D] tensors (row-major, contiguous; D = 32, 64,
// 128, 256 or a multiple of 256: the wrapper zero-pads other head widths up
// to the next of these, which is exact since the scale is passed in) and keep
// the TPU kernels' conventions: scores s = (q . k) * scale;
// causal mask qpos >= kpos with qpos = (tk - tq) + query index, masked score
// -1e30; attention-weight dropout (upscale_in_train) multiplies the softmax
// numerator and dP only, with the keep bit from the same murmur-finalizer
// hash of (seed, bh, qpos, kpos) as hash_keep_mask (:53), so the three
// passes and the plain PyTorch versions drop the same positions. The
// forward writes o = acc / max(l, 1e-30) and lse = m + log(max(l, 1e-30))
// (:136-140); the backward takes lse, delta = rowsum(o * dO) (computed by the
// caller, as :471 does) and an optional dLSE (null when absent).
//
// What bounds them: arithmetic. At the training shapes (BH 256, T 128,
// D 64) the forward does 4*BH*T*T*D = 1.07 GFLOP over 33.6 MB moved, 32
// FLOP a byte; dQ does 6*... and dK/dV 8*.... TF32 is off for parity, so
// the peak is fp32 outside the tensor cores (67 TFLOP/s on an H100 SXM):
// 16 / 24 / 32 us at least, against 10 / 15 / 18 us for the bytes.
//
// Design: the TPU grid walks the key (or query) blocks of one output tile
// in order on one core and carries the running (m, l, acc) in VMEM scratch
// across grid steps. On Hopper the blocks run in parallel and in no order,
// so each block owns one output tile and walks the other sequence in a loop
// inside the block, in increasing order as the TPU grid does; nothing
// carries between blocks and no atomics are needed (dQ tiles own their
// query rows, dK/dV tiles their key rows). A block is 256 threads as a
// 16 x 16 grid over a 64 x 64 score tile: thread (ty, tx) owns rows
// ty + 16i and columns tx + 16j (i, j < 4), so a row's 16 owners sit in
// one half-warp and its max and sum reduce with four xor shuffles. At
// D 256 the tiles are 32 x 32 (i, j < 2), so that four staged [32][257]
// tiles (137 KB for dK/dV) fit in shared memory and the [2][16] rows of
// o, dq, dk and dv a thread accumulates fit in registers (Tile). The
// tiles of q, k, v and dO are staged in shared memory with rows padded to
// D + 1 floats (the column-strided reads of k and v hit 16 distinct banks);
// the probability tile goes through shared memory between the two
// products. This is fp32 SIMT with no wgmma and no TMA: the simple, exact
// first version. Ragged edges (T not a multiple of the tile) are masked: rows
// past T load as zeros and are never written, columns past tk get
// probability 0. Causal tiles wholly above the diagonal are skipped
// (_block_visible, :29).
//
// Head widths above 256 (kWide) run in chunks of 256 columns, as
// fused_ce.cu takes its depth in chunks of 512. Each block owns one 256-wide
// chunk of its output tile (o, dq, or dk and dv: grid z) and recomputes the
// scores s = q . k, and dp = dO . v, over the whole width, staging the
// chunks of q, k (dO, v) one after the other and accumulating in the same
// order in every block and all three kernels, so every block of a query
// tile computes bit-identical scores, max, sum and lse. Then it stages the
// chunk it owns of v (k; q and dO) for the output product.
//
// Each function launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() of its launch (0 =
// success; cudaErrorInvalidValue for a head width it does not take).

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;    // 16 x 16
constexpr float kNeg = -1e30f;   // _NEG: masked score and initial max

// The tiles of head width D: RI query rows (and RI key columns of a score
// tile) a thread, B = 16 RI rows a tile. 64-row tiles up to D 128; at D 256
// tiles of 32 rows, so that the staged tiles fit in shared memory (dQ and
// dK/dV stage four [B][D + 1] tiles) and the accumulators in registers.
template <int D>
struct Tile {
  static constexpr int RI = D > 128 ? 2 : 4;
  static constexpr int B = 16 * RI;
  static constexpr int LP = B + 1;  // padded row of a score tile
};

struct Dropout {
  uint32_t seed;     // the int32 seed's bits
  uint32_t thresh;   // keep iff hash >= thresh = min(int(p * 2^32), 2^32 - 1)
  float upscale;     // float32(1 / (1 - p))
  int on;
};

// hash_keep_mask (flash_attention.py:53) for one (qpos, kpos): the keep
// factor, upscale or 0. uint32 arithmetic wraps as the jnp uint32 does.
__device__ __forceinline__ float keep_factor(const Dropout& dr, uint32_t bh,
                                             int qpos, int kpos) {
  uint32_t x = (static_cast<uint32_t>(qpos) * 0x9E3779B9u) ^
               (static_cast<uint32_t>(kpos) * 0x85EBCA6Bu);
  x ^= dr.seed + bh * 0x27D4EB2Fu;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x >= dr.thresh ? dr.upscale : 0.0f;
}

// rows [row0, row0 + kRows) of an [n_rows, D] matrix whose rows lie ld
// floats apart into a [kRows][D + 1] shared tile, rows past n_rows as zeros;
// 16-byte global loads.
template <int D, int kRows>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          int row0, int n_rows, int ld) {
  constexpr int kVec = D / 4;
  for (int i = threadIdx.x; i < kRows * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows) {
      val = *reinterpret_cast<const float4*>(
          src + static_cast<size_t>(row0 + r) * ld + c);
    }
    float* d = dst + r * (D + 1) + c;
    d[0] = val.x;
    d[1] = val.y;
    d[2] = val.z;
    d[3] = val.w;
  }
}

template <int RI>
__device__ __forceinline__ void zero(float (&a)[RI][RI]) {
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < RI; ++j) a[i][j] = 0.f;
}

// a[i][j] += sum_d x[ty + 16i][d] * y[tx + 16j][d] over two [B][D + 1] tiles,
// d in increasing order
template <int D, int RI = Tile<D>::RI>
__device__ __forceinline__ void tile_dot(float (&a)[RI][RI],
                                         const float* __restrict__ x,
                                         const float* __restrict__ y,
                                         int ty, int tx) {
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float xv[RI], yv[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) xv[i] = x[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < RI; ++j) yv[j] = y[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) a[i][j] = fmaf(xv[i], yv[j], a[i][j]);
  }
}

// reduce over the 16 lanes of a half-warp (one score row's owners)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// key tiles of bk rows [0, n) that a query tile ending (exclusive) at q_end
// can see
__device__ __forceinline__ int visible_key_tiles(int tk, int causal,
                                                 int q_off, int q_end,
                                                 int bk) {
  const int n = (tk + bk - 1) / bk;
  if (!causal) return n;
  const int last = q_off + q_end;  // keys < last are visible to some row
  const int v = last > 0 ? (last + bk - 1) / bk : 0;
  return v < n ? v : n;
}

// ---------------------------------------------------------------------------
// forward: grid (BH, ceil(tq / B), nc); o [BH, tq, nc * D], lse [BH, tq].
// kWide: nc chunks of D = 256 columns, this block's output chunk blockIdx.z;
// otherwise nc = 1.
template <int D, bool kWide>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int tq, int tk, int causal,
                 float scale, Dropout dr, int nc) {
  constexpr int LD = D + 1, DJ = D / 16;
  constexpr int RI = Tile<D>::RI, BQ = Tile<D>::B, BK = Tile<D>::B;
  constexpr int LP = Tile<D>::LP;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * LD;  // [BQ][LP], numerator weights p * keep
  const int bh = blockIdx.x, q0 = blockIdx.y * BQ;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q_off = tk - tq;
  const int n_ch = kWide ? nc : 1, ch = kWide ? blockIdx.z : 0;
  const int ld = n_ch * D;
  const size_t qbase = static_cast<size_t>(bh) * tq * ld;
  const size_t kbase = static_cast<size_t>(bh) * tk * ld;
  if (!kWide) load_tile<D, BQ>(sQ, q + qbase, q0, tq, ld);

  float m[RI], l[RI], acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }
  const int q_end = min(q0 + BQ, tq);
  const int n_kt = visible_key_tiles(tk, causal, q_off, q_end, BK);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    float s[RI][RI];
    for (int c = 0; c < n_ch; ++c) {
      __syncthreads();  // the previous tile's (chunk's) reads are done
      if (kWide) load_tile<D, BQ>(sQ, q + qbase + c * D, q0, tq, ld);
      load_tile<D, BK>(sK, k + kbase + c * D, k0, tk, ld);
      if (c == n_ch - 1) load_tile<D, BK>(sV, v + kbase + ch * D, k0, tk, ld);
      __syncthreads();
      if (c == 0) zero(s);
      tile_dot<D>(s, sQ, sK, ty, tx);
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qpos = q_off + q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float sv = s[i][j] * scale;
        if (causal && qpos < kpos) sv = kNeg;
        s[i][j] = kpos < tk ? sv : -INFINITY;  // ragged edge: p = 0
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        const float pv = dr.on ? p * keep_factor(dr, bh, qpos,
                                                 k0 + tx + 16 * j)
                               : p;
        sP[(ty + 16 * i) * LP + tx + 16 * j] = pv;
      }
      l[i] = l[i] * alpha + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[RI], vv[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = sP[(ty + 16 * i) * LP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = sV[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= tq) continue;
    const float safe_l = fmaxf(l[i], 1e-30f);
    float* orow = o + qbase + static_cast<size_t>(qi) * ld + ch * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) orow[tx + 16 * j] = acc[i][j] / safe_l;
    if (tx == 0 && ch == 0)
      lse[static_cast<size_t>(bh) * tq + qi] = m[i] + logf(safe_l);
  }
}

// ---------------------------------------------------------------------------
// dQ: grid (BH, ceil(tq / B), nc); dq [BH, tq, nc * D]
template <int D, bool kWide>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const float* __restrict__ dlse, float* __restrict__ dq,
                int tq, int tk, int causal, float scale, Dropout dr, int nc) {
  constexpr int LD = D + 1, DJ = D / 16;
  constexpr int RI = Tile<D>::RI, BQ = Tile<D>::B, BK = Tile<D>::B;
  constexpr int LP = Tile<D>::LP;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sG = sQ + BQ * LD;  // dO
  float* sK = sG + BQ * LD;
  float* sV = sK + BK * LD;
  float* sS = sV + BK * LD;  // [BQ][LP], dS
  const int bh = blockIdx.x, q0 = blockIdx.y * BQ;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q_off = tk - tq;
  const int n_ch = kWide ? nc : 1, ch = kWide ? blockIdx.z : 0;
  const int ld = n_ch * D;
  const size_t qbase = static_cast<size_t>(bh) * tq * ld;
  const size_t kbase = static_cast<size_t>(bh) * tk * ld;
  const size_t rbase = static_cast<size_t>(bh) * tq;
  if (!kWide) {
    load_tile<D, BQ>(sQ, q + qbase, q0, tq, ld);
    load_tile<D, BQ>(sG, dout + qbase, q0, tq, ld);
  }

  float row_lse[RI], corr[RI], acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qi = q0 + ty + 16 * i;
    row_lse[i] = qi < tq ? lse[rbase + qi] : 0.f;
    // ds = p * (dp - delta + dlse) (:385-386)
    corr[i] = qi < tq ? delta[rbase + qi] - (dlse ? dlse[rbase + qi] : 0.f)
                      : 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }
  const int n_kt = visible_key_tiles(tk, causal, q_off, min(q0 + BQ, tq), BK);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    float s[RI][RI], dp[RI][RI];
    for (int c = 0; c < n_ch; ++c) {
      __syncthreads();
      if (kWide) {
        load_tile<D, BQ>(sQ, q + qbase + c * D, q0, tq, ld);
        load_tile<D, BQ>(sG, dout + qbase + c * D, q0, tq, ld);
      }
      load_tile<D, BK>(sK, k + kbase + c * D, k0, tk, ld);
      load_tile<D, BK>(sV, v + kbase + c * D, k0, tk, ld);
      __syncthreads();
      if (c == 0) {
        zero(s);
        zero(dp);
      }
      tile_dot<D>(s, sQ, sK, ty, tx);
      tile_dot<D>(dp, sG, sV, ty, tx);
    }
    if (kWide && ch != n_ch - 1) {  // the chunk of k this block's dq takes
      __syncthreads();
      load_tile<D, BK>(sK, k + kbase + ch * D, k0, tk, ld);
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qpos = q_off + q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float sv = s[i][j] * scale;
        if (causal && qpos < kpos) sv = kNeg;
        const float p = kpos < tk ? expf(sv - row_lse[i]) : 0.f;
        const float dpv = dr.on ? dp[i][j] * keep_factor(dr, bh, qpos, kpos)
                                : dp[i][j];
        sS[(ty + 16 * i) * LP + tx + 16 * j] = p * (dpv - corr[i]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float dsv[RI], kv[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) dsv[i] = sS[(ty + 16 * i) * LP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = sK[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= tq) continue;
    float* row = dq + qbase + static_cast<size_t>(qi) * ld + ch * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) row[tx + 16 * j] = acc[i][j] * scale;
  }
}

// ---------------------------------------------------------------------------
// dK, dV: grid (BH, ceil(tk / B), nc); dk, dv [BH, tk, nc * D]
template <int D, bool kWide>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const float* __restrict__ dlse, float* __restrict__ dk,
                 float* __restrict__ dv, int tq, int tk, int causal,
                 float scale, Dropout dr, int nc) {
  constexpr int LD = D + 1, DJ = D / 16;
  constexpr int RI = Tile<D>::RI, BQ = Tile<D>::B, BK = Tile<D>::B;
  constexpr int LP = Tile<D>::LP;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BK * LD;
  float* sQ = sV + BK * LD;
  float* sG = sQ + BQ * LD;   // dO
  float* sP = sG + BQ * LD;   // [BQ][LP], p * keep
  float* sS = sP + BQ * LP;   // [BQ][LP], dS
  float* sL = sS + BQ * LP;   // [BQ] lse
  float* sC = sL + BQ;        // [BQ] delta - dlse
  const int bh = blockIdx.x, k0 = blockIdx.y * BK;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q_off = tk - tq;
  const int n_ch = kWide ? nc : 1, ch = kWide ? blockIdx.z : 0;
  const int ld = n_ch * D;
  const size_t qbase = static_cast<size_t>(bh) * tq * ld;
  const size_t kbase = static_cast<size_t>(bh) * tk * ld;
  const size_t rbase = static_cast<size_t>(bh) * tq;
  if (!kWide) {
    load_tile<D, BK>(sK, k + kbase, k0, tk, ld);
    load_tile<D, BK>(sV, v + kbase, k0, tk, ld);
  }

  float acc_k[RI][DJ], acc_v[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;
  const int n_qt = (tq + BQ - 1) / BQ;
  for (int qt = 0; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    // query tile qt sees this key tile iff its last query reaches it (:421)
    if (causal && k0 >= q_off + min(q0 + BQ, tq)) continue;
    // score tile in (query row, key column) order
    float s[RI][RI], dp[RI][RI];
    for (int c = 0; c < n_ch; ++c) {
      __syncthreads();
      load_tile<D, BQ>(sQ, q + qbase + c * D, q0, tq, ld);
      load_tile<D, BQ>(sG, dout + qbase + c * D, q0, tq, ld);
      if (kWide) {
        load_tile<D, BK>(sK, k + kbase + c * D, k0, tk, ld);
        load_tile<D, BK>(sV, v + kbase + c * D, k0, tk, ld);
      }
      if (c == 0 && threadIdx.x < BQ) {
        const int qi = q0 + threadIdx.x;
        sL[threadIdx.x] = qi < tq ? lse[rbase + qi] : 0.f;
        sC[threadIdx.x] = qi < tq ? delta[rbase + qi] -
                                        (dlse ? dlse[rbase + qi] : 0.f)
                                  : 0.f;
      }
      __syncthreads();
      if (c == 0) {
        zero(s);
        zero(dp);
      }
      tile_dot<D>(s, sQ, sK, ty, tx);
      tile_dot<D>(dp, sG, sV, ty, tx);
    }
    if (kWide && ch != n_ch - 1) {  // the chunks of q and dO this block takes
      __syncthreads();
      load_tile<D, BQ>(sQ, q + qbase + ch * D, q0, tq, ld);
      load_tile<D, BQ>(sG, dout + qbase + ch * D, q0, tq, ld);
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 16 * i;
      const int qi = q0 + r, qpos = q_off + qi;
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float sv = s[i][j] * scale;
        if (causal && qpos < kpos) sv = kNeg;
        const float p = (qi < tq && kpos < tk) ? expf(sv - sL[r]) : 0.f;
        const float keep = dr.on ? keep_factor(dr, bh, qpos, kpos) : 1.f;
        sP[r * LP + tx + 16 * j] = p * keep;
        sS[r * LP + tx + 16 * j] = p * (dp[i][j] * keep - sC[r]);
      }
    }
    __syncthreads();
    // dV[c] += sum_r (p keep)[r][c] dO[r];  dK[c] += sum_r dS[r][c] Q[r]
#pragma unroll 4
    for (int r = 0; r < BQ; ++r) {
      float pv[RI], sv[RI], gv[DJ], qv[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        pv[i] = sP[r * LP + ty + 16 * i];
        sv[i] = sS[r * LP + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        gv[j] = sG[r * LD + tx + 16 * j];
        qv[j] = sQ[r * LD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          acc_v[i][j] = fmaf(pv[i], gv[j], acc_v[i][j]);
          acc_k[i][j] = fmaf(sv[i], qv[j], acc_k[i][j]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= tk) continue;
    float* krow = dk + kbase + static_cast<size_t>(kj) * ld + ch * D;
    float* vrow = dv + kbase + static_cast<size_t>(kj) * ld + ch * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      krow[tx + 16 * j] = acc_k[i][j] * scale;
      vrow[tx + 16 * j] = acc_v[i][j];
    }
  }
}

template <int D>
constexpr size_t fwd_smem() {
  constexpr int B = Tile<D>::B;
  return sizeof(float) * (3 * B * (D + 1) + B * Tile<D>::LP);
}
template <int D>
constexpr size_t dq_smem() {
  constexpr int B = Tile<D>::B;
  return sizeof(float) * (4 * B * (D + 1) + B * Tile<D>::LP);
}
template <int D>
constexpr size_t dkv_smem() {
  constexpr int B = Tile<D>::B;
  return sizeof(float) * (4 * B * (D + 1) + 2 * B * Tile<D>::LP + 2 * B);
}

// above 48 KB a kernel needs the opt-in, once per instantiation
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

Dropout make_dropout(int on, unsigned seed, unsigned thresh, float upscale) {
  Dropout dr;
  dr.seed = seed;
  dr.thresh = thresh;
  dr.upscale = upscale;
  dr.on = on;
  return dr;
}

template <int D, bool kWide>
cudaError_t launch_fwd(const float* q, const float* k, const float* v,
                       float* o, float* lse, int bh, int tq, int tk, int nc,
                       int causal, float scale, Dropout dr, cudaStream_t s) {
  const size_t smem = fwd_smem<D>();
  cudaError_t err = allow_smem(flash_fwd_kernel<D, kWide>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (tq + Tile<D>::B - 1) / Tile<D>::B, nc);
  flash_fwd_kernel<D, kWide><<<grid, kThreads, smem, s>>>(
      q, k, v, o, lse, tq, tk, causal, scale, dr, nc);
  return cudaGetLastError();
}

template <int D, bool kWide>
cudaError_t launch_dq(const float* q, const float* k, const float* v,
                      const float* g, const float* lse, const float* delta,
                      const float* dlse, float* dq, int bh, int tq, int tk,
                      int nc, int causal, float scale, Dropout dr,
                      cudaStream_t s) {
  const size_t smem = dq_smem<D>();
  cudaError_t err = allow_smem(flash_dq_kernel<D, kWide>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (tq + Tile<D>::B - 1) / Tile<D>::B, nc);
  flash_dq_kernel<D, kWide><<<grid, kThreads, smem, s>>>(
      q, k, v, g, lse, delta, dlse, dq, tq, tk, causal, scale, dr, nc);
  return cudaGetLastError();
}

template <int D, bool kWide>
cudaError_t launch_dkv(const float* q, const float* k, const float* v,
                       const float* g, const float* lse, const float* delta,
                       const float* dlse, float* dk, float* dv, int bh,
                       int tq, int tk, int nc, int causal, float scale,
                       Dropout dr, cudaStream_t s) {
  const size_t smem = dkv_smem<D>();
  cudaError_t err = allow_smem(flash_dkv_kernel<D, kWide>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (tk + Tile<D>::B - 1) / Tile<D>::B, nc);
  flash_dkv_kernel<D, kWide><<<grid, kThreads, smem, s>>>(
      q, k, v, g, lse, delta, dlse, dk, dv, tq, tk, causal, scale, dr, nc);
  return cudaGetLastError();
}

// the smallest tiles (32 rows, D 256) bound the grid's second dimension,
// the 256-wide chunks of a head width its third
bool shapes_ok(int bh, int tq, int tk, int d) {
  return bh > 0 && tq > 0 && tk > 0 && (tq + 31) / 32 <= 65535 &&
         (tk + 31) / 32 <= 65535 && (d <= 256 || d / 256 <= 65535);
}

}  // namespace

// d: 32, 64, 128, 256 (one instantiation each) or a multiple of 256 (the
// D 256 tiles over d / 256 chunks)
#define PADDLE_FLASH_DISPATCH(launch, ...)                                  \
  switch (d) {                                                              \
    case 32: return launch<32, false>(__VA_ARGS__, 1, causal, scale, dr, s);  \
    case 64: return launch<64, false>(__VA_ARGS__, 1, causal, scale, dr, s);  \
    case 128: return launch<128, false>(__VA_ARGS__, 1, causal, scale, dr, s); \
    case 256: return launch<256, false>(__VA_ARGS__, 1, causal, scale, dr, s); \
    default:                                                                \
      if (d > 256 && d % 256 == 0)                                          \
        return launch<256, true>(__VA_ARGS__, d / 256, causal, scale, dr, s); \
      return cudaErrorInvalidValue;                                         \
  }

extern "C" int paddle_flash_fwd(const float* q, const float* k,
                                const float* v, float* o, float* lse,
                                int bh, int tq, int tk, int d, int causal,
                                float scale, int dropout, unsigned seed,
                                unsigned thresh, float upscale,
                                void* stream) {
  if (!shapes_ok(bh, tq, tk, d)) return cudaErrorInvalidValue;
  const Dropout dr = make_dropout(dropout, seed, thresh, upscale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PADDLE_FLASH_DISPATCH(launch_fwd, q, k, v, o, lse, bh, tq, tk)
}

extern "C" int paddle_flash_dq(const float* q, const float* k,
                               const float* v, const float* dout,
                               const float* lse, const float* delta,
                               const float* dlse, float* dq, int bh, int tq,
                               int tk, int d, int causal, float scale,
                               int dropout, unsigned seed, unsigned thresh,
                               float upscale, void* stream) {
  if (!shapes_ok(bh, tq, tk, d)) return cudaErrorInvalidValue;
  const Dropout dr = make_dropout(dropout, seed, thresh, upscale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PADDLE_FLASH_DISPATCH(launch_dq, q, k, v, dout, lse, delta, dlse, dq, bh,
                        tq, tk)
}

extern "C" int paddle_flash_dkv(const float* q, const float* k,
                                const float* v, const float* dout,
                                const float* lse, const float* delta,
                                const float* dlse, float* dk, float* dv,
                                int bh, int tq, int tk, int d, int causal,
                                float scale, int dropout, unsigned seed,
                                unsigned thresh, float upscale,
                                void* stream) {
  if (!shapes_ok(bh, tq, tk, d)) return cudaErrorInvalidValue;
  const Dropout dr = make_dropout(dropout, seed, thresh, upscale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PADDLE_FLASH_DISPATCH(launch_dkv, q, k, v, dout, lse, delta, dlse, dk, dv,
                        bh, tq, tk)
}
