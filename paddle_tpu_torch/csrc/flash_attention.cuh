// Flash attention for training: the forward pass and its backward pass,
// written for Hopper (compiled for sm_90a) behind a plain C interface that
// ctypes loads. This header holds the kernels; two libraries instantiate
// them (PADDLE_FLASH_ENTRY_POINTS): flash_attention.cu, the kernels of q,
// k, v and dO of one storage type, and flash_attention_mixed.cu, the fp32
// kernels that round to a narrower type (Rounds) for operands of mixed
// dtypes, which the wrapper widens. Two sources build side by side, so the
// mixed instantiations do not lengthen the main path's build.
//
// Replaces the three Pallas TPU kernels of
// paddle_tpu/ops/pallas/flash_attention.py:
//   paddle_flash_fwd  <- _flash_fwd      (:174, pallas_call :189, _fwd_kernel :85)
//   paddle_flash_bwd  <- _flash_bwd_impl (:455, pallas_calls :481 and :504,
//                        _dq_kernel :342 and _dkv_kernel :396), one launch
//   paddle_flash_dq,  <- the same two calls one by one, for the lengths and
//   paddle_flash_dkv     head widths paddle_flash_bwd does not take
//
// q, k, v and dO are [BH, T, D] (row-major, contiguous) of one storage type,
// fp32, bf16 or fp16; lse, delta and dlse are fp32. Conventions of the TPU
// kernels: scores s = (q . k) * scale summed in fp32 from the operands as
// stored; causal mask qpos >= kpos with qpos = (tk - tq) + query index,
// masked score -1e30; attention-weight dropout (upscale_in_train) multiplies
// the softmax numerator and dP only, with the keep bit from the same
// murmur-finalizer hash of (seed, bh, qpos, kpos) as hash_keep_mask (:53), so
// every kernel and the plain PyTorch versions drop the same positions. The
// forward writes o = acc / max(l, 1e-30) and lse = m + log(max(l, 1e-30))
// (:136-140), p times the keep factor rounded to the storage type before p .
// v (:133-134); the backward takes lse, delta = rowsum(o * dO) (computed by
// the caller, as :471 does) and an optional dLSE (null when absent), rounds
// dS and p times the keep factor to the storage type before their products
// (:387-389, :436-447) and sums in fp32. Outputs are in the storage type.
// Of mixed dtypes (the widened calls), the fp32 kernels round to the
// reference's types instead: Rounds.
//
// paddle_flash_fwd at head widths 32, 64 and 128 (flash_fwd_kernel in
// namespace tc, the section "The forward on the tensor cores" below): what
// bounds it at the training shapes (BH 256, T 128, D 64): bytes. It does
// 4*BH*T*T*D = 1.07 GFLOP, 6.5 us at 3xTF32 (1.09 us in bf16), and must
// read q, k and v and write o and lse, 33.6 MB (16.9 MB in bf16): 10.1 us
// (5.05 us). Design (PR 10's engine, turned around): a block is one
// warpgroup owning 64 queries of one head (grid (BH, ceil(tq / 64)); causal
// query tiles are dispatched heaviest first) and walks the key tiles of 64
// in increasing order, skipping those above the causal diagonal. S = q K^T
// is wgmma m64n64 with A from q's tile in shared memory (read into
// fragments, split for TF32 as read) and B from K's tile, which is K-major
// as it lies; the online max, sum and rescale work on the accumulator in
// registers (a row's 64 columns lie in the 4 threads of a quad, which
// reduce with two shuffles); O += P V is wgmma m64nD with A straight from
// the S accumulator and B from V^T, which TF32 wgmma must read K-major:
// each key step stages V transposed, for TF32 with each group of 8 keys in
// the order 0, 2, 4, 6, 1, 3, 5, 7 (the accumulator holds columns 2t and 2t
// + 1 where a TF32 A fragment wants depths t and t + 4). O stays in
// registers and is written once, with lse. fp32 runs 3xTF32 (hi / lo, the
// small products first), bf16 and fp16 natively; the next key step's K and
// V land by cp.async while the current one computes. Shared memory at fp32
// D 64: 112 KB, two blocks an SM. No dQ planes, so no key-length limit.
// Head width 256 and the 256-wide chunks above run flash_fwd_kernel (SIMT,
// below): a 64 x 256 fp32 accumulator a warpgroup and its split operands
// fit neither the registers nor the shared memory of the tensor-core
// block.
//
// The forward above width 128 and paddle_flash_dq / paddle_flash_dkv: fp32
// SIMT. The TPU grid walks the key (or query) blocks
// of one output tile in order on one core and carries the running (m, l,
// acc) in VMEM scratch across grid steps. On Hopper the blocks run in
// parallel and in no order, so each block owns one output tile and walks the
// other sequence in a loop inside the block, in increasing order as the TPU
// grid does; nothing carries between blocks and no atomics are needed (dQ
// tiles own their query rows, dK/dV tiles their key rows). A block is 256
// threads as a 16 x 16 grid over a 64 x 64 score tile: thread (ty, tx) owns
// rows ty + 16i and columns tx + 16j (i, j < 4), so a row's 16 owners sit in
// one half-warp and its max and sum reduce with four xor shuffles. At D 256
// the tiles are 32 x 32 (i, j < 2), so that four staged [32][257] tiles (137
// KB for dK/dV) fit in shared memory and the [2][16] rows of o, dq, dk and
// dv a thread accumulates fit in registers (Tile). The tiles of q, k, v and
// dO are staged in shared memory as fp32 with rows padded to D + 1 floats
// (the column-strided reads of k and v hit 16 distinct banks); the
// probability tile goes through shared memory between the two products.
// Ragged edges (T not a multiple of the tile) are masked: rows past T load
// as zeros and are never written, columns past tk get probability 0. Causal
// tiles wholly above the diagonal are skipped (_block_visible, :29). Head
// widths above 256 (kWide) run in chunks of 256 columns: each block owns one
// 256-wide chunk of its output tile (grid z) and recomputes the scores, and
// dp, over the whole width, staging the chunks one after the other and
// summing in the same order in every block and all three kernels, so every
// block of a query tile computes bit-identical scores, max, sum and lse.
//
// paddle_flash_bwd (flash_bwd_kernel, the section "The backward on the
// tensor cores" below): head widths 32, 64 and 128, key lengths up to 512.
// What bounds it: bytes. At the training shapes, non-causal, it does 10
// FLOPs per (query, key) pair and head-dim element (S, dP, dV, dK, dQ),
// 2.68 GFLOP: 16.3 us at 3xTF32 (495 TFLOP/s / 3) and 40.1 us in fp32 SIMT.
// It must read q, k, v and dO and write dq, dk and dv, 58.7 MB, and the
// rows (lse, delta) 0.26 MB: 17.6 us at 3.35 TB/s. The two kernels it
// replaces compute S and dP twice and read q, k, v and dO twice (11 [BH, T,
// D] matrices moved where one pass needs 7).
// Design. A block is one warpgroup (128 threads) owning 64 keys of one head
// (grid (BH, C), C = ceil(tk / 64) key tiles). It loads its K and V tiles
// once (cp.async) and walks the query steps of 32 in order, skipping the
// steps above the causal diagonal; the next step's q and dO land by
// cp.async behind the current step. For each step: S^T = K q^T and dP^T =
// V dO^T ([64 keys][32 queries], wgmma m64n32), P and dS in registers (lse,
// the causal mask, the keep factor), then dV += (P keep)^T dO and dK +=
// dS^T q (m64nD, accumulated in registers over the steps) and dQ^T = K^T
// dS^T ([D][32], m64n32) over the block's keys. Every product is wgmma
// with A from registers and B from shared memory: fp32 through 3xTF32
// (each operand split hi = tf32(a), lo = tf32(a - hi); the two small
// products first, then hi * hi, into one fp32 accumulator), bf16 and fp16
// natively. TF32 wgmma reads shared-memory operands K-major only, so each
// step stages q and dO both as they lie (K-major over D, for S^T and dP^T)
// and transposed (K-major over the queries, for dK and dV), split for
// TF32; dS goes to shared memory K-major over the keys (dQ^T's B). A
// operands come from registers: K, V and K^T read from the block's tiles
// (split as they are read), P and dS straight from the S^T and dP^T
// accumulators -- for TF32 the accumulator holds columns 2t and 2t + 1
// where the A fragment wants depths t and t + 4, so the transposed q and
// dO tiles keep each group of 8 queries in that order (queries 0, 2, 4, 6
// at depths 0-3, 1, 3, 5, 7 at 4-7). dQ sums over the key tiles: each
// block writes its share of a step's dQ (fp32) to its plane of a scratch
// [C, BH, Tq, D] and counts itself done on the head's counter; the last
// block of the head sums every row over the planes in key-tile order (only
// those whose keys the row's step sees) and sets the counter back to 0. No
// block waits for another, so a block with few causal steps leaves its SM
// early. A block that holds every key (tk <= 64) writes dq directly. The
// planes are C times dQ's size, so they grow with the square of the length
// (BH 256, D 64: 268 MB at T 512 and 1.07 GB at T 1024, against dq's 34 and
// 67 MB), and the last block holds up to 8 of a row's planes in registers:
// the kernel takes up to 8 key tiles (tk <= 512), and longer keys run
// paddle_flash_dq + paddle_flash_dkv, whose memory is linear in T. Every
// sum runs in one fixed order (the counter only picks which block does
// the summing): two runs give the same bits. Shared memory at fp32, D 64:
// 112 KB, two blocks an SM.
//
// Each function launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() of its launch (0 =
// success; cudaErrorInvalidValue for a shape, width or type it does not
// take).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

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

// the storage types: fp32, bf16 and fp16 values and their fp32 sums
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <class T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// x rounded to T (the TPU kernels' .astype before a product); exact for fp32
template <class T>
__device__ __forceinline__ float rnd(float x) {
  return to_f(from_f<T>(x));
}

// The types a kernel rounds to before its products, as the reference rounds
// them: P, p times the keep factor (to v's dtype before p . v in the
// forward, to dO's before dV in the backward); Q, dS before dK (q's dtype);
// K, dS before dQ (k's dtype). A kernel of one storage type T rounds all
// three to T (Same<T>). q, k, v and dO of mixed dtypes reach the fp32
// kernels widened (exactly) by the wrapper, with the narrower types here.
template <class P_, class Q_, class K_>
struct Rounds {
  using P = P_;
  using Q = Q_;
  using K = K_;
};
template <class T>
using Same = Rounds<T, T, T>;

// four neighbouring values (16 bytes of fp32, 8 of bf16 / fp16) as fp32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <class T>
__device__ __forceinline__ float4 load4(const T* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const T* h = reinterpret_cast<const T*>(&u);
  return make_float4(to_f(h[0]), to_f(h[1]), to_f(h[2]), to_f(h[3]));
}

// rows [row0, row0 + kRows) of an [n_rows, D] matrix whose rows lie ld
// values apart into a [kRows][D + 1] fp32 shared tile, rows past n_rows as
// zeros; 16-byte (fp32) or 8-byte (bf16, fp16) global loads.
template <int D, int kRows, class T>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const T* __restrict__ src,
                                          int row0, int n_rows, int ld) {
  constexpr int kVec = D / 4;
  for (int i = threadIdx.x; i < kRows * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows) {
      val = load4(src + static_cast<size_t>(row0 + r) * ld + c);
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
// otherwise nc = 1. T is the storage type: p times the keep factor is
// rounded to it before the p . v product (:133-134).
template <class T, int D, bool kWide, class R>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
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
        sP[(ty + 16 * i) * LP + tx + 16 * j] = rnd<typename R::P>(pv);
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
    T* orow = o + qbase + static_cast<size_t>(qi) * ld + ch * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      orow[tx + 16 * j] = from_f<T>(acc[i][j] / safe_l);
    if (tx == 0 && ch == 0)
      lse[static_cast<size_t>(bh) * tq + qi] = m[i] + logf(safe_l);
  }
}

// ---------------------------------------------------------------------------
// dQ: grid (BH, ceil(tq / B), nc); dq [BH, tq, nc * D]; dS rounded to T
// before the dS . K product (:387-389)
template <class T, int D, bool kWide, class R>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const float* __restrict__ dlse, T* __restrict__ dq,
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
        sS[(ty + 16 * i) * LP + tx + 16 * j] =
            rnd<typename R::K>(p * (dpv - corr[i]));
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
    T* row = dq + qbase + static_cast<size_t>(qi) * ld + ch * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) row[tx + 16 * j] = from_f<T>(acc[i][j] * scale);
  }
}

// ---------------------------------------------------------------------------
// dK, dV: grid (BH, ceil(tk / B), nc); dk, dv [BH, tk, nc * D]; p times
// the keep factor and dS rounded to T before their products (:436-447)
template <class T, int D, bool kWide, class R>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const float* __restrict__ dlse, T* __restrict__ dk,
                 T* __restrict__ dv, int tq, int tk, int causal,
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
        sP[r * LP + tx + 16 * j] = rnd<typename R::P>(p * keep);
        sS[r * LP + tx + 16 * j] =
            rnd<typename R::Q>(p * (dp[i][j] * keep - sC[r]));
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
    T* krow = dk + kbase + static_cast<size_t>(kj) * ld + ch * D;
    T* vrow = dv + kbase + static_cast<size_t>(kj) * ld + ch * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      krow[tx + 16 * j] = from_f<T>(acc_k[i][j] * scale);
      vrow[tx + 16 * j] = from_f<T>(acc_v[i][j]);
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

template <class T, int D, bool kWide, class R>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       float* lse, int bh, int tq, int tk, int nc,
                       int causal, float scale, Dropout dr, cudaStream_t s) {
  const size_t smem = fwd_smem<D>();
  cudaError_t err = allow_smem(flash_fwd_kernel<T, D, kWide, R>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (tq + Tile<D>::B - 1) / Tile<D>::B, nc);
  flash_fwd_kernel<T, D, kWide, R><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, tq, tk, causal,
      scale, dr, nc);
  return cudaGetLastError();
}

template <class T, int D, bool kWide, class R>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* g, const float* lse, const float* delta,
                      const float* dlse, void* dq, int bh, int tq, int tk,
                      int nc, int causal, float scale, Dropout dr,
                      cudaStream_t s) {
  const size_t smem = dq_smem<D>();
  cudaError_t err = allow_smem(flash_dq_kernel<T, D, kWide, R>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (tq + Tile<D>::B - 1) / Tile<D>::B, nc);
  flash_dq_kernel<T, D, kWide, R><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g), lse, delta, dlse,
      static_cast<T*>(dq), tq, tk, causal, scale, dr, nc);
  return cudaGetLastError();
}

template <class T, int D, bool kWide, class R>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* g, const float* lse, const float* delta,
                       const float* dlse, void* dk, void* dv, int bh,
                       int tq, int tk, int nc, int causal, float scale,
                       Dropout dr, cudaStream_t s) {
  const size_t smem = dkv_smem<D>();
  cudaError_t err = allow_smem(flash_dkv_kernel<T, D, kWide, R>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (tk + Tile<D>::B - 1) / Tile<D>::B, nc);
  flash_dkv_kernel<T, D, kWide, R><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g), lse, delta, dlse,
      static_cast<T*>(dk), static_cast<T*>(dv), tq, tk, causal, scale, dr,
      nc);
  return cudaGetLastError();
}

// the smallest tiles (32 rows, D 256) bound the grid's second dimension,
// the 256-wide chunks of a head width its third
bool shapes_ok(int bh, int tq, int tk, int d) {
  return bh > 0 && tq > 0 && tk > 0 && (tq + 31) / 32 <= 65535 &&
         (tk + 31) / 32 <= 65535 && (d <= 256 || d / 256 <= 65535);
}

// ---------------------------------------------------------------------------
// The tensor-core kernels: flash_fwd_kernel, the forward, and
// flash_bwd_kernel, dQ, dK and dV in one launch (the designs are in the note
// at the head of this file).

namespace tc {

constexpr int kBK = 64;        // keys a block (backward) or a key tile
                               // (forward): the M of one warpgroup's wgmma
                               // or the N of S
constexpr int kBQ = 32;        // queries a step (backward)
constexpr int kFQ = 64;        // queries a block (forward)
constexpr int kThreads = 128;  // one warpgroup
constexpr int kMaxC = 8;       // key tiles (dQ partial planes, held in
                               // registers by the sum): tk <= 512

// The operand kinds: how a value is split for the tensor cores, the depth
// of one wgmma k-step (32 bytes), and the wgmma itself.
struct F32 {                   // fp32 through 3xTF32
  using T = float;
  static constexpr int kTerms = 2, kStep = 8;
};
struct BF16 {
  using T = __nv_bfloat16;
  static constexpr int kTerms = 1, kStep = 16;
};
struct FP16 {
  using T = __half;
  static constexpr int kTerms = 1, kStep = 16;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float tf32(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(a));
  return __uint_as_float(r);
}

// a = hi + lo, both TF32 (|a - hi - lo| <= 2^-22 |a|); for bf16 / fp16 the
// value itself
__device__ __forceinline__ void split(float a, float& hi, float& lo) {
  hi = tf32(a);
  lo = tf32(a - hi);
}
template <class T>
__device__ __forceinline__ void split(float a, T& hi, T&) {
  hi = from_f<T>(a);
}

// x rounded to R where R is not the kernel's storage type T (a mixed call's
// narrower dtype); the storage type's own rounding happens where the value
// becomes an operand (split, pack)
template <class R, class T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (std::is_same<R, T>::value) return x;
  else return rnd<R>(x);
}

// two values of an operand type packed into a register (bf16 / fp16 A
// fragments: the lower k in the low half)
__device__ __forceinline__ uint32_t pack(__nv_bfloat16 a, __nv_bfloat16 b) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(a)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(b)) << 16);
}
__device__ __forceinline__ uint32_t pack(__half a, __half b) {
  return static_cast<uint32_t>(__half_as_ushort(a)) |
         (static_cast<uint32_t>(__half_as_ushort(b)) << 16);
}
__device__ __forceinline__ float bits_to_f(unsigned short b, __nv_bfloat16) {
  return __bfloat162float(__ushort_as_bfloat16(b));
}
__device__ __forceinline__ float bits_to_f(unsigned short b, __half) {
  return __half2float(__ushort_as_half(b));
}

// An operand that wgmma reads from shared memory, K-major ([R][Kd], the
// depth Kd contiguous), with the 128-byte swizzle (rows of 128 bytes) or,
// where a row of the depth is 64 bytes, the 64-byte swizzle: Kd / kBE boxes
// of R rows, the 16-byte chunks of row r XORed with r % 8 (r / 2 % 4).
template <class T, int R, int Kd>
struct Op {
  static constexpr int kRB = Kd * static_cast<int>(sizeof(T)) < 128
                                 ? Kd * static_cast<int>(sizeof(T))
                                 : 128;                 // bytes a box row
  static constexpr int kBE = kRB / static_cast<int>(sizeof(T));
  static constexpr int kE = 16 / static_cast<int>(sizeof(T));
  static constexpr int kElems = R * Kd;                 // a term
  static_assert(kRB == 64 || kRB == 128, "box rows of 64 or 128 bytes");
  __device__ static __forceinline__ int at(int r, int k) {
    const int x = kRB == 128 ? (r & 7) : ((r >> 1) & 3);
    return (k / kBE) * R * kBE + r * kBE + ((((k % kBE) / kE) ^ x) * kE) +
           k % kE;
  }
  // the descriptor of k-step s (32 bytes of depth) from row 0: start
  // address, leading offset 16 B (unused), 8 rows between row groups
  __device__ static __forceinline__ uint64_t desc(const T* base, int s) {
    constexpr int kSteps = kRB / 32;
    const uint64_t a = smem_u32(base + (s / kSteps) * R * kBE);
    return ((((a & 0x3FFFF) >> 4) + 2 * (s % kSteps)) & 0x3FFF) |
           (1ull << 16) | (static_cast<uint64_t>(8 * kRB / 16) << 32) |
           (static_cast<uint64_t>(kRB == 128 ? 1 : 2) << 62);
  }
};

// Element (r, k) of a row-major [64][D] tile of K or V, its 16-byte groups
// XORed with r % 8: the A fragments read from it hit distinct banks.
template <class T, int D>
__device__ __forceinline__ int kv_at(int r, int k) {
  constexpr int kE = 16 / static_cast<int>(sizeof(T));
  constexpr int kG = D / kE;
  constexpr int kX = kG < 8 ? kG : 8;
  return r * D + (((k / kE) ^ (r % kX)) * kE) + k % kE;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
// one 16-byte global -> shared copy in flight, through L2 only; an invalid
// source writes zeros and reads nothing
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// 16 bytes of values as fp32, and kVE values of an operand type as 16 bytes
__device__ __forceinline__ void unpack16(uint4 u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
template <class H>
__device__ __forceinline__ void unpack16(uint4 u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = bits_to_f(static_cast<unsigned short>(w[i] & 0xFFFF), H{});
    f[2 * i + 1] = bits_to_f(static_cast<unsigned short>(w[i] >> 16), H{});
  }
}
__device__ __forceinline__ uint4 pack16(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}
template <class H>
__device__ __forceinline__ uint4 pack16(const H (&v)[8]) {
  return make_uint4(pack(v[0], v[1]), pack(v[2], v[3]), pack(v[4], v[5]),
                    pack(v[6], v[7]));
}

// four fp32 sums into four neighbouring outputs (16 or 8 bytes)
__device__ __forceinline__ void store4(float* out, const float (&a)[4]) {
  *reinterpret_cast<float4*>(out) = make_float4(a[0], a[1], a[2], a[3]);
}
template <class H>
__device__ __forceinline__ void store4(H* out, const float (&a)[4]) {
  *reinterpret_cast<uint2*>(out) =
      make_uint2(pack(from_f<H>(a[0]), from_f<H>(a[1])),
                 pack(from_f<H>(a[2]), from_f<H>(a[3])));
}

// the accumulators are settled after a wait: no read of them moves above it
template <int N>
__device__ __forceinline__ void settle(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// a wgmma's register operands stay unchanged up to here
template <int S>
__device__ __forceinline__ void hold(uint32_t (&a)[S][4]) {
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[s][e])::"memory");
}

#define FB_R16                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define FB_O16(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define FB_R32                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define FB_O32(d)                                                          \
  FB_O16(d), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),          \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),     \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),     \
      "+f"(d[30]), "+f"(d[31])
#define FB_R64                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"
#define FB_O64(d)                                                          \
  FB_O32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),          \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),     \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),     \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),     \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),     \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),     \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d[N / 2] += A (64 rows, registers) x B (N rows of a K-major operand,
// descriptor b)^T over one k-step; N = 32, 64 or 128
#define FB_WGMMA(KIND, NR, SHAPE, TYPES, TAIL, R, O, A0, A1, A2, A3, B, P)    \
  __device__ __forceinline__ void mma(KIND, float (&d)[NR],                   \
                                      const uint32_t (&a)[4], uint64_t b) {   \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"              \
                 "wgmma.mma_async.sync.aligned." SHAPE ".f32." TYPES " " R    \
                 ", {" A0 ", " A1 ", " A2 ", " A3 "}, " B ", p, 1, 1" TAIL    \
                 ";\n}\n"                                                    \
                 : O(d)                                                      \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),       \
                   "r"(1));                                                  \
  }
#define FB_WGMMA_ALL(KIND, K, TYPES, TAIL)                                   \
  FB_WGMMA(KIND, 16, "m64n32" K, TYPES, TAIL, FB_R16, FB_O16, "%16", "%17",  \
           "%18", "%19", "%20", "%21")                                       \
  FB_WGMMA(KIND, 32, "m64n64" K, TYPES, TAIL, FB_R32, FB_O32, "%32", "%33",  \
           "%34", "%35", "%36", "%37")                                       \
  FB_WGMMA(KIND, 64, "m64n128" K, TYPES, TAIL, FB_R64, FB_O64, "%64", "%65", \
           "%66", "%67", "%68", "%69")
FB_WGMMA_ALL(F32, "k8", "tf32.tf32", "")
FB_WGMMA_ALL(BF16, "k16", "bf16.bf16", ", 0")
FB_WGMMA_ALL(FP16, "k16", "f16.f16", ", 0")

// one k-step of a product with A from registers: 3xTF32 (the two small
// terms first, CUTLASS's order) or one bf16 / fp16 product
template <class Kd, int NR>
__device__ __forceinline__ void mma3(float (&d)[NR], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint64_t bh,
                                     uint64_t bl) {
  if constexpr (Kd::kTerms == 2) {
    mma(Kd{}, d, ah, bl);
    mma(Kd{}, d, al, bh);
  }
  mma(Kd{}, d, ah, bh);
}

// The A fragment of k-step s of a [64][Kd] operand whose element (r, k) is
// at(r, k) in shared memory (rows 16 w + g .. of warp w), split into hi, lo
// (TF32: elements (r, k), (r + 8, k), (r, k + 4), (r + 8, k + 4), k = 8 s +
// t; bf16 / fp16: pairs at k = 16 s + 2 t and + 8). Rows >= rows_valid
// read as zeros.
template <class Kd, class At>
__device__ __forceinline__ void frag(const typename Kd::T* src, At at, int s,
                                     int r, int t, bool valid,
                                     uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  using T = typename Kd::T;
  if constexpr (Kd::kTerms == 2) {
    const int k = 8 * s + t;
    const int rr[4] = {r, r + 8, r, r + 8}, kk[4] = {k, k, k + 4, k + 4};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float h = 0.f, l = 0.f;
      if (valid) split(to_f(src[at(rr[e], kk[e])]), h, l);
      hi[e] = __float_as_uint(h);
      lo[e] = __float_as_uint(l);
    }
  } else {
    const int k = 16 * s + 2 * t;
    const int rr[4] = {r, r + 8, r, r + 8}, kk[4] = {k, k, k + 8, k + 8};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const T zero = from_f<T>(0.f);
      hi[e] = valid ? pack(src[at(rr[e], kk[e])], src[at(rr[e], kk[e] + 1)])
                    : pack(zero, zero);
      lo[e] = 0;
    }
  }
}

// The A fragments of k-step s of a product over the accumulator's columns,
// straight from an accumulator d[N] of a [64][2N] tile (the backward's
// [64 keys][32 queries] S^T and dP^T, the forward's [64 queries][64 keys]
// S): TF32 with each group of 8 columns in the order 0, 2,
// 4, 6, 1, 3, 5, 7 (the order the transposed q, dO and V tiles keep), bf16
// / fp16 as they lie; the values rounded to the operand type (the .astype
// before the product).
template <class Kd, int N>
__device__ __forceinline__ void acc_frag(const float (&d)[N], int s,
                                         uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  using T = typename Kd::T;
  if constexpr (Kd::kTerms == 2) {
    const int src[4] = {4 * s, 4 * s + 2, 4 * s + 1, 4 * s + 3};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float h, l;
      split(d[src[e]], h, l);
      hi[e] = __float_as_uint(h);
      lo[e] = __float_as_uint(l);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      hi[e] = pack(from_f<T>(d[8 * s + 2 * e]), from_f<T>(d[8 * s + 2 * e + 1]));
      lo[e] = 0;
    }
  }
}

// bytes of shared memory: the staged operands, then the K and V tiles
template <class Kd, int D>
struct Smem {
  using T = typename Kd::T;
  using OQ = Op<T, kBQ, D>;     // q, dO: [32 queries][D]
  using OT = Op<T, D, kBQ>;     // q^T, dO^T: [D][32 queries]
  using OS = Op<T, kBQ, kBK>;   // dS: [32 queries][64 keys]
  static constexpr int kLdX = D + 4;  // the step's dQ partial [32][D + 4]
  static constexpr int kQ = Kd::kTerms * OQ::kElems * sizeof(T);
  static constexpr int kT = Kd::kTerms * OT::kElems * sizeof(T);
  static constexpr int kS0 = Kd::kTerms * OS::kElems * sizeof(T);
  static constexpr int kX = kBQ * kLdX * 4;
  static constexpr int kS = kS0 > kX ? kS0 : kX;
  static constexpr int kKV = kBK * D * sizeof(T);
  // the next step's q and dO as they lie: in the lo halves of sQ and sG
  // for TF32, else a region of their own
  static constexpr int kRaw = Kd::kTerms == 2 ? 0 : 2 * kBQ * D * sizeof(T);
  static constexpr int kBytes = 2 * kQ + 2 * kT + kS + 2 * kKV + kRaw;
};

// Grid (BH, C), C = ceil(tk / 64): block (bh, r) owns keys [64 r, 64 r +
// 64) of head bh (the first key tiles, which the most causal steps see,
// are dispatched first); dqp holds the C planes of dQ partials and count[bh] the
// blocks of the head done (both null when C is 1; count all 0 at entry,
// and the kernel leaves it so). Shared memory (1024-aligned): sQ, sG (q and
// dO, K-major over D), sQT, sGT (their transposes, K-major over the
// queries), sS (dS, K-major over the keys), sK, sV (row-major, unsplit),
// then for bf16 / fp16 the next step's q and dO as they lie (TF32 keeps
// them in the lo halves of sQ and sG, free once S^T and dP^T are done).
// TF32 operands keep hi then lo.
template <class Kd, int D, class R>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 2 : 1)
flash_bwd_kernel(const typename Kd::T* __restrict__ q,
                 const typename Kd::T* __restrict__ k,
                 const typename Kd::T* __restrict__ v,
                 const typename Kd::T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const float* __restrict__ dlse, typename Kd::T* __restrict__ dq,
                 typename Kd::T* __restrict__ dk,
                 typename Kd::T* __restrict__ dv, float* __restrict__ dqp,
                 unsigned* __restrict__ count, int tq, int tk, int causal,
                 float scale, Dropout dr) {
  using T = typename Kd::T;
  using L = Smem<Kd, D>;
  using OQ = typename L::OQ;
  using OT = typename L::OT;
  using OS = typename L::OS;
  constexpr int kTerms = Kd::kTerms;
  constexpr int kDSteps = D / Kd::kStep;     // k-steps over the head width
  constexpr int kQSteps = kBQ / Kd::kStep;   // over the queries of a step
  constexpr int kKSteps = kBK / Kd::kStep;   // over the keys of a block
  constexpr int kG = kTerms == 2 ? 2 : 4;    // k-steps a chunk of fragments
  constexpr int kGD = kG < kDSteps ? kG : kDSteps;
  constexpr int kGQ = kG;                    // the same for dQ^T's K^T
  constexpr int kMT = D > 64 ? D / 64 : 1;   // M tiles of dQ^T
  constexpr int kVE = 16 / static_cast<int>(sizeof(T));  // a 16-byte vector
  constexpr int kNV = D / kVE;               // vectors a row
  extern __shared__ char raw[];
  char* base = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  T* sQ = reinterpret_cast<T*>(base);
  T* sG = sQ + kTerms * OQ::kElems;
  T* sQT = sG + kTerms * OQ::kElems;
  T* sGT = sQT + kTerms * OT::kElems;
  T* sS = sGT + kTerms * OT::kElems;
  float* sX = reinterpret_cast<float*>(sS);  // after dQ^T: the partial
  T* sK = reinterpret_cast<T*>(reinterpret_cast<char*>(sS) + L::kS);
  T* sV = sK + kBK * D;
  T* rawQ = kTerms == 2 ? sQ + OQ::kElems : sV + kBK * D;
  T* rawG = kTerms == 2 ? sG + OQ::kElems : rawQ + kBQ * D;

  const int tid = threadIdx.x, lane = tid % 32;
  const int w = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int g8 = lane / 4, t4 = lane % 4;
  const int rank = blockIdx.y, n_rank = gridDim.y, bh = blockIdx.x;
  const int k0 = rank * kBK, q_off = tk - tq;
  const size_t kbase = static_cast<size_t>(bh) * tk * D;
  const size_t qbase = static_cast<size_t>(bh) * tq * D;
  const size_t rbase = static_cast<size_t>(bh) * tq;
  const int row = 16 * w + g8;               // this thread's first A row

  // this block's K and V tiles, rows past tk as zeros (cp.async)
  for (int i = tid; i < kBK * kNV; i += kThreads) {
    const int r = i / kNV, c = (i % kNV) * kVE;
    const bool in = k0 + r < tk;
    const size_t at = in ? kbase + static_cast<size_t>(k0 + r) * D + c : 0;
    copy16(sK + kv_at<T, D>(r, c), k + at, in);
    copy16(sV + kv_at<T, D>(r, c), v + at, in);
  }
  auto at_kv = [](int r, int c) { return kv_at<T, D>(r, c); };
  auto at_kt = [](int r, int c) { return kv_at<T, D>(c, r); };  // K^T

  float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

  const int n_qt = (tq + kBQ - 1) / kBQ;
  const size_t plane = static_cast<size_t>(gridDim.x) * tq * D;
  constexpr int kIt = kBQ * kNV / kThreads;  // staged vectors a thread
  // where (c, d0), a 16-byte vector of q or dO, lies in rawQ, rawG: for
  // TF32 the odd rows' vectors XORed by 4, so that the staging's reads of
  // rows 2i, 2i + 1, 8 + 2i, ... hit every bank
  auto raw_at = [](int c, int d0) {
    return kTerms == 2 ? c * D + (((d0 / 4) ^ (4 * (c & 1))) * 4)
                       : c * D + d0;
  };
  // q and dO of step qt as they lie into rawQ, rawG (cp.async)
  auto prefetch = [&](int qt) {
    const int q0 = qt * kBQ;
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int i = tid + it * kThreads, c = i / kNV, d0 = (i % kNV) * kVE;
      const bool in = q0 + c < tq;
      const size_t at = in ? qbase + static_cast<size_t>(q0 + c) * D + d0 : 0;
      copy16(rawQ + raw_at(c, d0), q + at, in);
      copy16(rawG + raw_at(c, d0), dout + at, in);
    }
    copies_commit();
  };
  // the first step that sees this block's keys (_block_visible, :29); the
  // later ones all do
  int qt0 = 0;
  while (causal && qt0 < n_qt && k0 >= q_off + min((qt0 + 1) * kBQ, tq))
    ++qt0;
  if (qt0 < n_qt) prefetch(qt0);
  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * kBQ;
    // lse and delta - dlse of this thread's query columns
    float lse_c[8], corr_c[8];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = q0 + 8 * j + 2 * t4 + e;
        const bool in = qi < tq;
        lse_c[2 * j + e] = in ? lse[rbase + qi] : 0.f;
        corr_c[2 * j + e] =
            in ? delta[rbase + qi] - (dlse ? dlse[rbase + qi] : 0.f) : 0.f;
      }
    copies_wait();
    __syncthreads();  // the step's q and dO have landed
    // q and dO, natural and transposed, split for TF32
    if constexpr (kTerms == 2) {
      // a thread takes 4 queries (one parity of a group of 8, which the
      // transposed tiles keep at depths 4m .. 4m + 3) x one 4-wide vector
      // of D, so that both layouts take 16-byte stores
      constexpr int kRuns = (2 * D + kThreads - 1) / kThreads;
      float qf[kRuns][4][4], gf[kRuns][4][4];
#pragma unroll
      for (int u = 0; u < kRuns; ++u) {
        const int b = tid + u * kThreads, m = b % 8, d0 = 4 * (b / 8);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = 8 * (m / 2) + m % 2 + 2 * i;
          uint4 qx = make_uint4(0, 0, 0, 0), gx = qx;
          if (b < 2 * D) {
            qx = *reinterpret_cast<const uint4*>(rawQ + raw_at(c, d0));
            gx = *reinterpret_cast<const uint4*>(rawG + raw_at(c, d0));
          }
          unpack16(qx, qf[u][i]);
          unpack16(gx, gf[u][i]);
        }
      }
      __syncthreads();  // the raw tiles lie in the lo halves
      // one operand's 4 x 4 values, split, into its natural (K-major over
      // D) and transposed (K-major over the queries) tiles
      auto put = [&](const float (&x)[4][4], T* nat, T* tr, int m, int d0) {
        float hi[4][4], lo[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) split(x[i][e], hi[i][e], lo[i][e]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int at = OQ::at(8 * (m / 2) + m % 2 + 2 * i, d0);
          *reinterpret_cast<uint4*>(nat + at) = pack16(hi[i]);
          *reinterpret_cast<uint4*>(nat + OQ::kElems + at) = pack16(lo[i]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int at = OT::at(d0 + e, 4 * m);
          const float th[4] = {hi[0][e], hi[1][e], hi[2][e], hi[3][e]};
          const float tl[4] = {lo[0][e], lo[1][e], lo[2][e], lo[3][e]};
          *reinterpret_cast<uint4*>(tr + at) = pack16(th);
          *reinterpret_cast<uint4*>(tr + OT::kElems + at) = pack16(tl);
        }
      };
#pragma unroll
      for (int u = 0; u < kRuns; ++u) {
        const int b = tid + u * kThreads, m = b % 8, d0 = 4 * (b / 8);
        if (b >= 2 * D) continue;
        put(qf[u], sQ, sQT, m, d0);
        put(gf[u], sG, sGT, m, d0);
      }
    } else {
      // a warp takes 8 queries x 4 vectors
#pragma unroll
      for (int it = 0; it < kIt; ++it) {
        const int i = tid + it * kThreads, wi = i / 32, li = i % 32;
        const int c = li / 4 + 8 * (wi / (kNV / 4));
        const int d0 = (li % 4 + 4 * (wi % (kNV / 4))) * kVE;
        float qf[kVE], gf[kVE];
        T qh[kVE], gh[kVE];
        unpack16<T>(*reinterpret_cast<const uint4*>(rawQ + raw_at(c, d0)), qf);
        unpack16<T>(*reinterpret_cast<const uint4*>(rawG + raw_at(c, d0)), gf);
#pragma unroll
        for (int e = 0; e < kVE; ++e) {
          qh[e] = from_f<T>(qf[e]);
          gh[e] = from_f<T>(gf[e]);
          const int tpos = OT::at(d0 + e, c);
          sQT[tpos] = qh[e];
          sGT[tpos] = gh[e];
        }
        const int npos = OQ::at(c, d0);
        *reinterpret_cast<uint4*>(sQ + npos) = pack16(qh);
        *reinterpret_cast<uint4*>(sG + npos) = pack16(gh);
      }
    }
    fence_async();
    __syncthreads();

    // S^T = K q^T and dP^T = V dO^T: [64 keys][32 queries]
    float s[16], dp[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
    for (int c0 = 0; c0 < kDSteps; c0 += kGD) {
      uint32_t kh[kGD][4], kl[kGD][4], vh[kGD][4], vl[kGD][4];
#pragma unroll
      for (int g = 0; g < kGD; ++g) {
        frag<Kd>(sK, at_kv, c0 + g, row, t4, true, kh[g], kl[g]);
        frag<Kd>(sV, at_kv, c0 + g, row, t4, true, vh[g], vl[g]);
      }
      wg_fence();
#pragma unroll
      for (int g = 0; g < kGD; ++g) {
        const int st = c0 + g;
        mma3<Kd>(s, kh[g], kl[g], OQ::desc(sQ, st),
                 OQ::desc(sQ + OQ::kElems, st));
        mma3<Kd>(dp, vh[g], vl[g], OQ::desc(sG, st),
                 OQ::desc(sG + OQ::kElems, st));
      }
      wg_commit();
      wg_wait();
      hold(kh);
      hold(kl);
      hold(vh);
      hold(vl);
      settle(s);
      settle(dp);
    }
    if (qt + 1 < n_qt) {  // the next step's q and dO, behind this one
      __syncthreads();    // every warp's products have read sQ and sG
      prefetch(qt + 1);
    }

    // P times the keep factor (into s) and dS = P (dP keep - delta + dlse)
    // (into dp); dS into sS as dQ^T's B operand, [32 queries][64 keys]
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          const int kpos = k0 + row + 8 * h;
          const int qi = q0 + 8 * j + 2 * t4 + e, qpos = q_off + qi;
          float sv = s[i] * scale;
          if (causal && qpos < kpos) sv = kNeg;
          const float p =
              (qi < tq && kpos < tk) ? __expf(sv - lse_c[2 * j + e]) : 0.f;
          const float keep = dr.on ? keep_factor(dr, bh, qpos, kpos) : 1.f;
          s[i] = round_to<typename R::P, T>(p * keep);
          const float ds = p * (dp[i] * keep - corr_c[2 * j + e]);
          dp[i] = round_to<typename R::Q, T>(ds);
          const int pos = OS::at(8 * j + 2 * t4 + e, row + 8 * h);
          T hi, lo;
          split(round_to<typename R::K, T>(ds), hi, lo);
          sS[pos] = hi;
          if constexpr (kTerms == 2) sS[OS::kElems + pos] = lo;
        }
    fence_async();

    // dV += (P keep)^T dO and dK += dS^T q: [64 keys][D], A straight from
    // the registers
    float acc_q[kMT][16];
    {
      uint32_t ph[kQSteps][4], pl[kQSteps][4], dh[kQSteps][4], dl[kQSteps][4];
#pragma unroll
      for (int st = 0; st < kQSteps; ++st) {
        acc_frag<Kd>(s, st, ph[st], pl[st]);
        acc_frag<Kd>(dp, st, dh[st], dl[st]);
      }
      wg_fence();
#pragma unroll
      for (int st = 0; st < kQSteps; ++st) {
        mma3<Kd>(acc_v, ph[st], pl[st], OT::desc(sGT, st),
                 OT::desc(sGT + OT::kElems, st));
        mma3<Kd>(acc_k, dh[st], dl[st], OT::desc(sQT, st),
                 OT::desc(sQT + OT::kElems, st));
      }
      wg_commit();
      __syncthreads();  // every thread's dS is in sS
      wg_wait();
      hold(ph);
      hold(pl);
      hold(dh);
      hold(dl);
      settle(acc_v);
      settle(acc_k);
    }

    // dQ^T = K^T dS^T: [D][32 queries] over this block's 64 keys
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int i = 0; i < 16; ++i) acc_q[mt][i] = 0.f;
#pragma unroll
    for (int c0 = 0; c0 < kKSteps; c0 += kGQ) {
      uint32_t th[kMT][kGQ][4], tl[kMT][kGQ][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int g = 0; g < kGQ; ++g)
          frag<Kd>(sK, at_kt, c0 + g, 64 * mt + row, t4, 64 * mt + row < D,
                   th[mt][g], tl[mt][g]);
      wg_fence();
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int g = 0; g < kGQ; ++g)
          mma3<Kd>(acc_q[mt], th[mt][g], tl[mt][g], OS::desc(sS, c0 + g),
                   OS::desc(sS + OS::kElems, c0 + g));
      wg_commit();
      wg_wait();
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        hold(th[mt]);
        hold(tl[mt]);
        settle(acc_q[mt]);
      }
    }
    // this block's share of dQ for the step, through sX (the dQ^T product
    // has read sS): into dq itself when the block holds every key, else
    // into its plane of the fp32 partials; 16-byte rows
    __syncthreads();
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int d = 64 * mt + row + 8 * h;
          if (d >= D) continue;
#pragma unroll
          for (int e = 0; e < 2; ++e)
            sX[(8 * j + 2 * t4 + e) * L::kLdX + d] =
                acc_q[mt][4 * j + 2 * h + e] * scale;
        }
    __syncthreads();
    for (int g = tid; g < kBQ * D / 4; g += kThreads) {
      const int c = g / (D / 4), d4 = (g % (D / 4)) * 4;
      if (q0 + c >= tq) continue;
      const float4 x =
          *reinterpret_cast<const float4*>(sX + c * L::kLdX + d4);
      const size_t at = qbase + static_cast<size_t>(q0 + c) * D + d4;
      if (n_rank == 1) {
        const float a[4] = {x.x, x.y, x.z, x.w};
        store4(dq + at, a);
      } else {
        *reinterpret_cast<float4*>(dqp + rank * plane + at) = x;
      }
    }
  }

  // dQ over the key tiles: the last block of the head to finish sums the
  // planes in key-tile order (only those whose keys a row's step sees) and
  // sets the head's count back to 0 for the next launch
  if (n_rank > 1) {
    __threadfence();  // this block's partials, before its count
    __syncthreads();
    int* last = reinterpret_cast<int*>(sS);
    if (tid == 0)
      *last = atomicAdd(count + bh, 1u) == static_cast<unsigned>(n_rank - 1);
    __syncthreads();
    if (*last) {
      __threadfence();
      const int n4 = tq * D / 4;
      constexpr int kU = 4;  // groups a thread has in flight
      for (int g0 = tid; g0 < n4; g0 += kU * kThreads) {
        float4 part[kU][kMaxC];
        size_t at[kU];
        int n_vis[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int g = g0 + u * kThreads;
          const int qi = g / (D / 4), d4 = (g % (D / 4)) * 4;
          const int q_end = min((qi / kBQ + 1) * kBQ, tq);
          n_vis[u] = g >= n4 ? 0
                     : causal ? min(n_rank, (q_off + q_end + kBK - 1) / kBK)
                              : n_rank;
          at[u] = qbase + static_cast<size_t>(qi) * D + d4;
#pragma unroll
          for (int rr = 0; rr < kMaxC; ++rr)
            if (rr < n_vis[u])
              part[u][rr] = __ldcg(
                  reinterpret_cast<const float4*>(dqp + rr * plane + at[u]));
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          if (n_vis[u] == 0) continue;
          float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int rr = 0; rr < kMaxC; ++rr)
            if (rr < n_vis[u]) {
              a[0] += part[u][rr].x;
              a[1] += part[u][rr].y;
              a[2] += part[u][rr].z;
              a[3] += part[u][rr].w;
            }
          store4(dq + at[u], a);
        }
      }
      if (tid == 0) count[bh] = 0;
    }
  }

  // dK = scale dS^T q and dV over every step: rows of this block's keys
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = k0 + row + 8 * h;
      if (key >= tk) continue;
      const size_t at = kbase + static_cast<size_t>(key) * D + 8 * j + 2 * t4;
      const int i = 4 * j + 2 * h;
      dk[at] = from_f<T>(acc_k[i] * scale);
      dk[at + 1] = from_f<T>(acc_k[i + 1] * scale);
      dv[at] = from_f<T>(acc_v[i]);
      dv[at + 1] = from_f<T>(acc_v[i + 1]);
    }
}

// ---------------------------------------------------------------------------
// The forward on the tensor cores.

// bytes of shared memory: the K and V^T tiles of a key step, split for
// TF32, then the block's q, and the next step's K and V as they lie
template <class Kd, int D>
struct FwdSmem {
  using T = typename Kd::T;
  using OK = Op<T, kBK, D>;     // K: [64 keys][D], K-major over D
  using OV = Op<T, D, kBK>;     // V^T: [D][64 keys], K-major over the keys
  static constexpr int kRaw = kBK * D * sizeof(T);   // a [64][D] tile
  static constexpr int kK = Kd::kTerms * OK::kElems * sizeof(T);
  static constexpr int kV = Kd::kTerms * OV::kElems * sizeof(T);
  static constexpr int kBytes = kK + kV + 3 * kRaw;
};

// two fp32 sums into two neighbouring outputs
__device__ __forceinline__ void store2(float* out, float a, float b) {
  *reinterpret_cast<float2*>(out) = make_float2(a, b);
}
template <class H>
__device__ __forceinline__ void store2(H* out, float a, float b) {
  *reinterpret_cast<uint32_t*>(out) = pack(from_f<H>(a), from_f<H>(b));
}

// Grid (BH, ceil(tq / 64)): block (bh, y) owns queries [64 r, 64 r + 64) of
// head bh, r = y, or for causal attention r = last - y (the query tiles
// that see the most keys are dispatched first). R::P is the type p times
// the keep factor is rounded to before p . v. Shared memory (1024-aligned):
// sK (K split, K-major over D), sV (V^T split, K-major over the keys, TF32
// in the order 0, 2, 4, 6, 1, 3, 5, 7 of each group of 8 keys), sQ (the
// block's q as it lies, read into A fragments and split per product), rK,
// rV (the next key step's K and V as they lie, by cp.async).
template <class Kd, int D, class R>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 2 : 1)
flash_fwd_kernel(const typename Kd::T* __restrict__ q,
                 const typename Kd::T* __restrict__ k,
                 const typename Kd::T* __restrict__ v,
                 typename Kd::T* __restrict__ o, float* __restrict__ lse,
                 int tq, int tk, int causal, float scale, Dropout dr) {
  using T = typename Kd::T;
  using L = FwdSmem<Kd, D>;
  using OK = typename L::OK;
  using OV = typename L::OV;
  constexpr int kTerms = Kd::kTerms;
  constexpr int kDSteps = D / Kd::kStep;     // S's k-steps over the width
  constexpr int kKSteps = kBK / Kd::kStep;   // p . v's over a key tile
  constexpr int kGD = kDSteps < 4 ? kDSteps : 4;   // k-steps a chunk of
  constexpr int kGK = kKSteps < 4 ? kKSteps : 4;   // fragments
  constexpr int kVE = 16 / static_cast<int>(sizeof(T));  // a 16-byte vector
  constexpr int kNV = D / kVE;               // vectors a row
  extern __shared__ char raw[];
  char* base = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  T* sK = reinterpret_cast<T*>(base);
  T* sV = reinterpret_cast<T*>(base + L::kK);
  T* sQ = reinterpret_cast<T*>(base + L::kK + L::kV);
  T* rK = sQ + kBK * D;
  T* rV = rK + kBK * D;

  const int tid = threadIdx.x, lane = tid % 32;
  const int w = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int g8 = lane / 4, t4 = lane % 4;
  const int bh = blockIdx.x;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * kFQ, q_off = tk - tq;
  const size_t qbase = static_cast<size_t>(bh) * tq * D;
  const size_t kbase = static_cast<size_t>(bh) * tk * D;
  const int row = 16 * w + g8;               // this thread's first row
  auto at_kv = [](int r, int c) { return kv_at<T, D>(r, c); };

  // rows [r0, r0 + 64) of an [n][D] matrix into a raw tile (cp.async),
  // rows past n as zeros
  auto fetch = [&](T* dst, const T* src, int r0, int n) {
    for (int i = tid; i < kBK * kNV; i += kThreads) {
      const int r = i / kNV, c = (i % kNV) * kVE;
      const bool in = r0 + r < n;
      copy16(dst + kv_at<T, D>(r, c),
             src + (in ? static_cast<size_t>(r0 + r) * D + c : 0), in);
    }
  };
  const int n_kt = visible_key_tiles(tk, causal, q_off, min(q0 + kFQ, tq),
                                     kBK);
  fetch(sQ, q + qbase, q0, tq);
  fetch(rK, k + kbase, 0, tk);
  fetch(rV, v + kbase, 0, tk);
  copies_commit();

  float acc[D / 2], m_r[2] = {kNeg, kNeg}, l_r[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    copies_wait();
    __syncthreads();  // the step's K and V have landed; the last step's
                      // products have read sK and sV
    // K as it lies and V transposed, split for TF32
    for (int i = tid; i < kBK * kNV; i += kThreads) {
      const int r = i / kNV, c = (i % kNV) * kVE;
      const uint4 x = *reinterpret_cast<const uint4*>(rK + kv_at<T, D>(r, c));
      const int at = OK::at(r, c);
      if constexpr (kTerms == 2) {
        float f[4], hi[4], lo[4];
        unpack16(x, f);
#pragma unroll
        for (int e = 0; e < 4; ++e) split(f[e], hi[e], lo[e]);
        *reinterpret_cast<uint4*>(sK + at) = pack16(hi);
        *reinterpret_cast<uint4*>(sK + OK::kElems + at) = pack16(lo);
      } else {
        *reinterpret_cast<uint4*>(sK + at) = x;
      }
    }
    if constexpr (kTerms == 2) {
      // a thread takes 4 keys (one parity of a group of 8, which V^T keeps
      // at depths 4m .. 4m + 3) x one 4-wide vector of D: 16-byte stores
      for (int b = tid; b < 16 * kNV; b += kThreads) {
        const int m = b % 16, d0 = 4 * (b / 16);
        float hi[4][4], lo[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = 8 * (m / 2) + m % 2 + 2 * i;
          float f[4];
          unpack16(*reinterpret_cast<const uint4*>(rV + kv_at<T, D>(c, d0)),
                   f);
#pragma unroll
          for (int e = 0; e < 4; ++e) split(f[e], hi[i][e], lo[i][e]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int at = OV::at(d0 + e, 4 * m);
          const float th[4] = {hi[0][e], hi[1][e], hi[2][e], hi[3][e]};
          const float tl[4] = {lo[0][e], lo[1][e], lo[2][e], lo[3][e]};
          *reinterpret_cast<uint4*>(sV + at) = pack16(th);
          *reinterpret_cast<uint4*>(sV + OV::kElems + at) = pack16(tl);
        }
      }
    } else {
      // a thread takes a pair of keys x one 8-wide vector of D: the pair of
      // each column into one 4-byte word of V^T
      for (int b = tid; b < (kBK / 2) * kNV; b += kThreads) {
        const int kp = b % (kBK / 2), d0 = kVE * (b / (kBK / 2));
        const uint4 x0 =
            *reinterpret_cast<const uint4*>(rV + kv_at<T, D>(2 * kp, d0));
        const uint4 x1 =
            *reinterpret_cast<const uint4*>(rV + kv_at<T, D>(2 * kp + 1, d0));
        const T* h0 = reinterpret_cast<const T*>(&x0);
        const T* h1 = reinterpret_cast<const T*>(&x1);
#pragma unroll
        for (int e = 0; e < kVE; ++e)
          *reinterpret_cast<uint32_t*>(sV + OV::at(d0 + e, 2 * kp)) =
              pack(h0[e], h1[e]);
      }
    }
    fence_async();
    __syncthreads();  // sK and sV are whole; rK and rV are free
    if (kt + 1 < n_kt) {  // the next step's K and V, behind this one
      fetch(rK, k + kbase, k0 + kBK, tk);
      fetch(rV, v + kbase, k0 + kBK, tk);
      copies_commit();
    }

    // S = q K^T: [64 queries][64 keys], A from q's tile, split as read
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
    for (int c0 = 0; c0 < kDSteps; c0 += kGD) {
      uint32_t qh[kGD][4], ql[kGD][4];
#pragma unroll
      for (int g = 0; g < kGD; ++g)
        frag<Kd>(sQ, at_kv, c0 + g, row, t4, true, qh[g], ql[g]);
      wg_fence();
#pragma unroll
      for (int g = 0; g < kGD; ++g)
        mma3<Kd>(s, qh[g], ql[g], OK::desc(sK, c0 + g),
                 OK::desc(sK + OK::kElems, c0 + g));
      wg_commit();
      wg_wait();
      hold(qh);
      hold(ql);
      settle(s);
    }

    // the online softmax of rows row and row + 8 (a row's 64 columns lie in
    // the 4 threads of a quad): max, rescale, p (into s) times the keep
    // factor, rounded to R::P
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qpos = q_off + q0 + row + 8 * h;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e, kpos = k0 + 8 * j + 2 * t4 + e;
          float sv = s[i] * scale;
          if (causal && qpos < kpos) sv = kNeg;
          s[i] = kpos < tk ? sv : -INFINITY;   // ragged edge: p = 0
          mx = fmaxf(mx, s[i]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[h], mx);
      alpha[h] = expf(m_r[h] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          const float p = expf(s[i] - m_new);
          rs += p;
          const float pv =
              dr.on ? p * keep_factor(dr, bh, qpos, k0 + 8 * j + 2 * t4 + e)
                    : p;
          s[i] = round_to<typename R::P, T>(pv);
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l_r[h] = l_r[h] * alpha[h] + rs;
      m_r[h] = m_new;
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i / 2) % 2];

    // O += P V: [64 queries][D], A straight from the registers
#pragma unroll
    for (int c0 = 0; c0 < kKSteps; c0 += kGK) {
      uint32_t ph[kGK][4], pl[kGK][4];
#pragma unroll
      for (int g = 0; g < kGK; ++g) acc_frag<Kd>(s, c0 + g, ph[g], pl[g]);
      wg_fence();
#pragma unroll
      for (int g = 0; g < kGK; ++g)
        mma3<Kd>(acc, ph[g], pl[g], OV::desc(sV, c0 + g),
                 OV::desc(sV + OV::kElems, c0 + g));
      wg_commit();
      wg_wait();
      hold(ph);
      hold(pl);
      settle(acc);
    }
  }

  // o = acc / max(l, 1e-30) and lse = m + log(max(l, 1e-30)) (:136-140)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = q0 + row + 8 * h;
    if (qi >= tq) continue;
    const float safe_l = fmaxf(l_r[h], 1e-30f);
    T* orow = o + qbase + static_cast<size_t>(qi) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2(orow + 8 * j, acc[4 * j + 2 * h] / safe_l,
             acc[4 * j + 2 * h + 1] / safe_l);
    if (t4 == 0)
      lse[static_cast<size_t>(bh) * tq + qi] = m_r[h] + logf(safe_l);
  }
}

template <class Kd, class R, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       float* lse, int bh, int tq, int tk, int causal,
                       float scale, Dropout dr, cudaStream_t s) {
  using T = typename Kd::T;
  const size_t smem = FwdSmem<Kd, D>::kBytes + 1024;  // + alignment
  auto kern = flash_fwd_kernel<Kd, D, R>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (tq + kFQ - 1) / kFQ);
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, tq, tk, causal,
      scale, dr);
  return cudaGetLastError();
}

template <class Kd, class R>
cudaError_t launch_fwd_d(int d, const void* q, const void* k, const void* v,
                         void* o, float* lse, int bh, int tq, int tk,
                         int causal, float scale, Dropout dr,
                         cudaStream_t s) {
  switch (d) {
    case 32:
      return launch_fwd<Kd, R, 32>(q, k, v, o, lse, bh, tq, tk, causal, scale,
                                   dr, s);
    case 64:
      return launch_fwd<Kd, R, 64>(q, k, v, o, lse, bh, tq, tk, causal, scale,
                                   dr, s);
    case 128:
      return launch_fwd<Kd, R, 128>(q, k, v, o, lse, bh, tq, tk, causal,
                                    scale, dr, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <class Kd, class R, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* g, const float* lse, const float* delta,
                       const float* dlse, void* dq, void* dk, void* dv,
                       float* dqp, unsigned* count, int bh, int tq, int tk,
                       int causal, float scale, Dropout dr, cudaStream_t s) {
  using T = typename Kd::T;
  const size_t smem = Smem<Kd, D>::kBytes + 1024;  // + alignment
  auto kern = flash_bwd_kernel<Kd, D, R>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (tk + kBK - 1) / kBK);
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g), lse, delta, dlse,
      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), dqp,
      count, tq, tk, causal, scale, dr);
  return cudaGetLastError();
}

template <class Kd, class R>
cudaError_t launch_bwd_d(int d, const void* q, const void* k, const void* v,
                         const void* g, const float* lse, const float* delta,
                         const float* dlse, void* dq, void* dk, void* dv,
                         float* dqp, unsigned* count, int bh, int tq, int tk,
                         int causal, float scale, Dropout dr,
                         cudaStream_t s) {
  switch (d) {
    case 32:
      return launch_bwd<Kd, R, 32>(q, k, v, g, lse, delta, dlse, dq, dk, dv,
                                   dqp, count, bh, tq, tk, causal, scale, dr,
                                   s);
    case 64:
      return launch_bwd<Kd, R, 64>(q, k, v, g, lse, delta, dlse, dq, dk, dv,
                                   dqp, count, bh, tq, tk, causal, scale, dr,
                                   s);
    case 128:
      return launch_bwd<Kd, R, 128>(q, k, v, g, lse, delta, dlse, dq, dk, dv,
                                    dqp, count, bh, tq, tk, causal, scale, dr,
                                    s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace

// A call's rounding codes (Rounds): rounds = p + 3 q + 9 k, each 0 (fp32:
// none), 1 (bf16) or 2 (fp16). A library of the storage types' kernels
// (kMixed false) takes rounds 0; the library of mixed calls (kMixed true)
// takes the fp32 kernels (dtype 0) with rounds non-zero.
struct Codes {
  int p, q, k;
};
template <bool kMixed>
bool codes_of(int rounds, int dtype, Codes* c) {
  if (kMixed ? (rounds <= 0 || rounds >= 27 || dtype != 0) : rounds != 0)
    return false;
  *c = Codes{rounds % 3, rounds / 3 % 3, rounds / 9 % 3};
  return true;
}
using BF = __nv_bfloat16;
using HF = __half;

// The SIMT kernels: d 32, 64, 128, 256 (one instantiation each; the
// forward runs 32-128 on the tensor cores) or a multiple of 256 (the D 256
// tiles over d / 256 chunks)
#define PADDLE_FLASH_WIDE(launch, T, R, ...)                                 \
  if (d == 256)                                                              \
    return launch<T, 256, false, R>(__VA_ARGS__, 1, causal, scale, dr, s);   \
  if (d > 256 && d % 256 == 0)                                               \
    return launch<T, 256, true, R>(__VA_ARGS__, d / 256, causal, scale, dr,  \
                                   s);                                       \
  return cudaErrorInvalidValue;
#define PADDLE_FLASH_WIDTHS(launch, T, R, ...)                               \
  switch (d) {                                                               \
    case 32:                                                                 \
      return launch<T, 32, false, R>(__VA_ARGS__, 1, causal, scale, dr, s);  \
    case 64:                                                                 \
      return launch<T, 64, false, R>(__VA_ARGS__, 1, causal, scale, dr, s);  \
    case 128:                                                                \
      return launch<T, 128, false, R>(__VA_ARGS__, 1, causal, scale, dr, s); \
    default:                                                                 \
      PADDLE_FLASH_WIDE(launch, T, R, __VA_ARGS__)                           \
  }
// the storage type's kernels (one rounding: Same), dtype 0 fp32, 1 bf16,
// 2 fp16
#define PADDLE_FLASH_DISPATCH(WIDTHS, launch, ...)                           \
  switch (dtype) {                                                           \
    case 0: WIDTHS(launch, float, Same<float>, __VA_ARGS__)                  \
    case 1: WIDTHS(launch, BF, Same<BF>, __VA_ARGS__)                        \
    case 2: WIDTHS(launch, HF, Same<HF>, __VA_ARGS__)                        \
    default: return cudaErrorInvalidValue;                                   \
  }

// The entry points, one function of each per library (kMixed). The
// forward: d 32, 64, 128 (the tensor-core kernel), 256 or a multiple of
// 256 (the SIMT kernel in 256-wide chunks).
template <bool kMixed>
int flash_fwd_entry(const void* q, const void* k, const void* v, void* o,
                    float* lse, int bh, int tq, int tk, int d, int dtype,
                    int causal, float scale, int dropout, unsigned seed,
                    unsigned thresh, float upscale, int rounds,
                    void* stream) {
  Codes c;
  if (!shapes_ok(bh, tq, tk, d) || !codes_of<kMixed>(rounds, dtype, &c))
    return cudaErrorInvalidValue;
  const Dropout dr = make_dropout(dropout, seed, thresh, upscale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using PB = Rounds<BF, float, float>;   // p rounded to v's bf16 / fp16
  using PH = Rounds<HF, float, float>;
  if constexpr (kMixed) {
    if (d <= 128) {
      if (c.p == 1) return tc::launch_fwd_d<tc::F32, PB>(
          d, q, k, v, o, lse, bh, tq, tk, causal, scale, dr, s);
      if (c.p == 2) return tc::launch_fwd_d<tc::F32, PH>(
          d, q, k, v, o, lse, bh, tq, tk, causal, scale, dr, s);
      return cudaErrorInvalidValue;
    }
    switch (c.p) {
      case 1: PADDLE_FLASH_WIDE(launch_fwd, float, PB, q, k, v, o, lse, bh,
                                tq, tk)
      case 2: PADDLE_FLASH_WIDE(launch_fwd, float, PH, q, k, v, o, lse, bh,
                                tq, tk)
      default: return cudaErrorInvalidValue;
    }
  } else {
    if (d <= 128) {
      switch (dtype) {
        case 0: return tc::launch_fwd_d<tc::F32, Same<float>>(
            d, q, k, v, o, lse, bh, tq, tk, causal, scale, dr, s);
        case 1: return tc::launch_fwd_d<tc::BF16, Same<BF>>(
            d, q, k, v, o, lse, bh, tq, tk, causal, scale, dr, s);
        case 2: return tc::launch_fwd_d<tc::FP16, Same<HF>>(
            d, q, k, v, o, lse, bh, tq, tk, causal, scale, dr, s);
        default: return cudaErrorInvalidValue;
      }
    }
    PADDLE_FLASH_DISPATCH(PADDLE_FLASH_WIDE, launch_fwd, q, k, v, o, lse, bh,
                          tq, tk)
  }
}

// dQ, the SIMT kernel at every width: rounds k (k's dtype)
template <bool kMixed>
int flash_dq_entry(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   const float* dlse, void* dq, int bh, int tq, int tk, int d,
                   int dtype, int causal, float scale, int dropout,
                   unsigned seed, unsigned thresh, float upscale, int rounds,
                   void* stream) {
  Codes c;
  if (!shapes_ok(bh, tq, tk, d) || !codes_of<kMixed>(rounds, dtype, &c))
    return cudaErrorInvalidValue;
  const Dropout dr = make_dropout(dropout, seed, thresh, upscale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using KB = Rounds<float, float, BF>;   // dS rounded to k's bf16 / fp16
  using KH = Rounds<float, float, HF>;
  if constexpr (kMixed) {
    switch (c.k) {
      case 1: PADDLE_FLASH_WIDTHS(launch_dq, float, KB, q, k, v, dout, lse,
                                  delta, dlse, dq, bh, tq, tk)
      case 2: PADDLE_FLASH_WIDTHS(launch_dq, float, KH, q, k, v, dout, lse,
                                  delta, dlse, dq, bh, tq, tk)
      default: return cudaErrorInvalidValue;
    }
  } else {
    PADDLE_FLASH_DISPATCH(PADDLE_FLASH_WIDTHS, launch_dq, q, k, v, dout, lse,
                          delta, dlse, dq, bh, tq, tk)
  }
}

// dK and dV, the SIMT kernel at every width: rounds p (dO's dtype) equal to
// q (q's)
template <bool kMixed>
int flash_dkv_entry(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    const float* dlse, void* dk, void* dv, int bh, int tq,
                    int tk, int d, int dtype, int causal, float scale,
                    int dropout, unsigned seed, unsigned thresh,
                    float upscale, int rounds, void* stream) {
  Codes c;
  if (!shapes_ok(bh, tq, tk, d) || !codes_of<kMixed>(rounds, dtype, &c) ||
      c.p != c.q)
    return cudaErrorInvalidValue;
  const Dropout dr = make_dropout(dropout, seed, thresh, upscale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using QB = Rounds<BF, BF, float>;      // p keep and dS rounded to q's (and
  using QH = Rounds<HF, HF, float>;      // dO's) bf16 / fp16
  if constexpr (kMixed) {
    switch (c.q) {
      case 1: PADDLE_FLASH_WIDTHS(launch_dkv, float, QB, q, k, v, dout, lse,
                                  delta, dlse, dk, dv, bh, tq, tk)
      case 2: PADDLE_FLASH_WIDTHS(launch_dkv, float, QH, q, k, v, dout, lse,
                                  delta, dlse, dk, dv, bh, tq, tk)
      default: return cudaErrorInvalidValue;
    }
  } else {
    PADDLE_FLASH_DISPATCH(PADDLE_FLASH_WIDTHS, launch_dkv, q, k, v, dout,
                          lse, delta, dlse, dk, dv, bh, tq, tk)
  }
}

// dQ, dK and dV in one launch on the tensor cores: d 32, 64 or 128; tk <=
// 512 (up to 8 key tiles of 64); rounds p equal to q, and the non-zero
// codes of q and k equal
template <bool kMixed>
int flash_bwd_entry(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    const float* dlse, void* dq, void* dk, void* dv,
                    float* dqp, unsigned* count, int bh, int tq, int tk,
                    int d, int dtype, int causal, float scale, int dropout,
                    unsigned seed, unsigned thresh, float upscale,
                    int rounds, void* stream) {
  Codes c;
  if (bh < 1 || tq < 1 || tk < 1 || tk > tc::kMaxC * tc::kBK ||
      (tk > tc::kBK && (dqp == nullptr || count == nullptr)) ||
      !codes_of<kMixed>(rounds, dtype, &c) || c.p != c.q ||
      (c.q != 0 && c.k != 0 && c.q != c.k))
    return cudaErrorInvalidValue;
  const Dropout dr = make_dropout(dropout, seed, thresh, upscale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PADDLE_BWD(KD, R)                                                     \
  return tc::launch_bwd_d<tc::KD, R>(d, q, k, v, dout, lse, delta, dlse, dq, \
                                     dk, dv, dqp, count, bh, tq, tk, causal, \
                                     scale, dr, s)
  if constexpr (kMixed) {
    using KB = Rounds<float, float, BF>;   // dS for dQ rounded to k's dtype
    using KH = Rounds<float, float, HF>;
    using QB = Rounds<BF, BF, float>;      // p keep and dS for dK to q's
    using QH = Rounds<HF, HF, float>;
    switch (c.q * 3 + c.k) {
      case 1: PADDLE_BWD(F32, KB);
      case 2: PADDLE_BWD(F32, KH);
      case 3: PADDLE_BWD(F32, QB);
      case 4: PADDLE_BWD(F32, Same<BF>);
      case 6: PADDLE_BWD(F32, QH);
      case 8: PADDLE_BWD(F32, Same<HF>);
      default: return cudaErrorInvalidValue;
    }
  } else {
    switch (dtype) {
      case 0: PADDLE_BWD(F32, Same<float>);
      case 1: PADDLE_BWD(BF16, Same<BF>);
      case 2: PADDLE_BWD(FP16, Same<HF>);
      default: return cudaErrorInvalidValue;
    }
  }
#undef PADDLE_BWD
}

// The C interface of a library: kMixed false in flash_attention.cu, true in
// flash_attention_mixed.cu.
#define PADDLE_FLASH_ENTRY_POINTS(kMixed)                                    \
  extern "C" int paddle_flash_fwd(                                           \
      const void* q, const void* k, const void* v, void* o, float* lse,      \
      int bh, int tq, int tk, int d, int dtype, int causal, float scale,     \
      int dropout, unsigned seed, unsigned thresh, float upscale,            \
      int rounds, void* stream) {                                            \
    return flash_fwd_entry<kMixed>(q, k, v, o, lse, bh, tq, tk, d, dtype,    \
                                   causal, scale, dropout, seed, thresh,     \
                                   upscale, rounds, stream);                 \
  }                                                                          \
  extern "C" int paddle_flash_dq(                                            \
      const void* q, const void* k, const void* v, const void* dout,         \
      const float* lse, const float* delta, const float* dlse, void* dq,     \
      int bh, int tq, int tk, int d, int dtype, int causal, float scale,     \
      int dropout, unsigned seed, unsigned thresh, float upscale,            \
      int rounds, void* stream) {                                            \
    return flash_dq_entry<kMixed>(q, k, v, dout, lse, delta, dlse, dq, bh,   \
                                  tq, tk, d, dtype, causal, scale, dropout,  \
                                  seed, thresh, upscale, rounds, stream);    \
  }                                                                          \
  extern "C" int paddle_flash_dkv(                                           \
      const void* q, const void* k, const void* v, const void* dout,         \
      const float* lse, const float* delta, const float* dlse, void* dk,     \
      void* dv, int bh, int tq, int tk, int d, int dtype, int causal,        \
      float scale, int dropout, unsigned seed, unsigned thresh,              \
      float upscale, int rounds, void* stream) {                             \
    return flash_dkv_entry<kMixed>(q, k, v, dout, lse, delta, dlse, dk, dv,  \
                                   bh, tq, tk, d, dtype, causal, scale,      \
                                   dropout, seed, thresh, upscale, rounds,   \
                                   stream);                                  \
  }                                                                          \
  extern "C" int paddle_flash_bwd(                                           \
      const void* q, const void* k, const void* v, const void* dout,         \
      const float* lse, const float* delta, const float* dlse, void* dq,     \
      void* dk, void* dv, float* dqp, unsigned* count, int bh, int tq,       \
      int tk, int d, int dtype, int causal, float scale, int dropout,        \
      unsigned seed, unsigned thresh, float upscale, int rounds,             \
      void* stream) {                                                        \
    return flash_bwd_entry<kMixed>(q, k, v, dout, lse, delta, dlse, dq, dk,  \
                                   dv, dqp, count, bh, tq, tk, d, dtype,     \
                                   causal, scale, dropout, seed, thresh,     \
                                   upscale, rounds, stream);                 \
  }
