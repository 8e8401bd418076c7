// Fused vocabulary projection + label-smoothed softmax cross entropy, the
// forward pass and its backward pass, written for Hopper's tensor cores
// (compiled for sm_90a: TMA, mbarriers and wgmma) behind a plain C interface
// that ctypes loads.
//
// Replaces the two Pallas TPU kernels of paddle_tpu/ops/pallas/fused_ce.py:
//   paddle_fused_ce_fwd  <- _fwd     (:173, pallas_call :185, _fwd_kernel :47)
//   paddle_fused_ce_bwd  <- _vjp_bwd (:222, pallas_call :234, _bwd_kernel :101)
//
// x [N, D] and w [D, V] share one dtype: fp32, bf16 or fp16 (a mixed pair
// reaches the kernels widened to fp32 by the wrapper, and the backward then
// rounds dz to x's type: dz_round); labels [N] int32. With z = x @ w summed
// in fp32 the forward writes, per row,
//   lse  = max z + log(sum exp(z - max z))
//   loss = lse - (1 - eps) * z[label] - eps * sum(z) / V   (0 where label ==
//          ignore_index)
// (_fwd_kernel :82-86), and the backward takes lse and a per-row cotangent g
// and writes dx = dz @ w^T and dW = x^T @ dz with
//   dz = (exp(z - lse) - (label == col ? 1 - eps : 0) - eps / V) * g
// (_dlogits :90-98; 0 on ignored rows), dz rounded to the operands' dtype for
// the two products (:122-125), both summed in fp32 and returned in the
// operands' dtype. The [N, V] logits never reach device memory.
//
// What bounds them: the tensor cores. At Transformer-base's head (N 4096,
// D 512, V 32000) the forward's product is 2*N*D*V = 134.2 GFLOP over 74 MB
// of inputs; the backward recomputes z once and does two more products of
// the same size, 402.7 GFLOP. bf16 and fp16 run at 989 TFLOP/s on an H100
// SXM: 0.14 and 0.41 ms at least. fp32 is held to fp32's accuracy through
// 3xTF32: each operand a = hi + lo with hi = tf32(a), lo = tf32(a - hi)
// (|a - hi - lo| <= 2^-22 |a|), and a product is hi*hi + (hi*lo + lo*hi),
// three TF32 products at 495 TFLOP/s, 165 TFLOP/s of fp32 products: 0.81 and
// 2.44 ms at least (fp32 outside the tensor cores, 67 TFLOP/s, cannot go
// below 2.0 and 6.0 ms).
//
// Design. Every product runs on one tile engine (run_tiles): a block of two
// consumer warpgroups and one producer warp computes 128 x 128 fp32
// accumulator tiles (64 rows a warpgroup, wgmma m64n128, 64 registers a
// thread) of A [M, K] times B [N, K]^T, both K-major in device memory. The
// producer's one thread streams 128-row boxes of A and B, one 128-byte
// swizzled row of depth per stage (32 fp32 or 64 bf16 / fp16 values), into
// a 192 KB ring of shared memory with TMA (cp.async.bulk.tensor), each stage
// completing on an mbarrier; the consumers issue four wgmma k-steps a stage
// (three TF32 wgmmas a k-step for fp32, the two small terms into their own
// accumulator, added to the large one after the last stage) and keep one
// stage's group in flight while the next is issued. A block may walk several
// tiles; the ring runs on across them, so the next tile's loads overlap this
// tile's epilogue.
//   TF32 wgmma reads shared-memory operands K-major only, TMA needs 16-byte
// aligned strides, and fp32 needs its hi / lo halves, so each call first
// runs fused_ce_prep_kernel over its operands: it writes K-major copies
// (transposed where the product needs it), split for fp32, with rows padded
// to 16 bytes. TMA reads past the true depth, rows and columns as zeros, so the
// main loops never see a ragged edge; the epilogues mask rows >= N and
// columns >= V.
//   forward  A = x [N, D], B = w^T [V, D]. A block owns 128 rows and walks
//            its share of the vocabulary in 128-wide tiles (the vocabulary is
//            split across blockIdx.y when the row tiles alone leave SMs
//            idle), folding each tile into running (max, sumexp, sum z,
//            z_label) per row and thread; the four threads of a row merge at
//            the end (quad shuffles) and a small kernel merges the splits.
//   backward walks the vocabulary in slabs of Vs columns (the wrapper's
//            SLAB_COLS), in order; for each slab, three launches:
//            K1 (dz_kernel): z of the slab, A = x, B = w^T; dz rounded to the
//               operand type into dz [N, Vs] and dz^T [Vs, N] (the layouts K2
//               and K3 read K-major; a lane pair swaps one value so that
//               both layouts are written two neighbours at a time);
//            K2 + K3 (grad_kernel, one launch): K2 tiles dx += dz @ w_slab^T
//               (A = dz, B = w [D, V] from column v0): a read-modify-write
//               of an fp32 [N, D] accumulator in slab order, written in x's
//               dtype after the last slab; K3 tiles dW[:, slab] = x^T @ dz
//               (A = x^T [D, N], B = dz^T), with N split into chunks of Vs
//               so that every tile of the launch does the same work, each
//               chunk's partial into its own plane of an fp32 scratch;
//            dw_sum_kernel: the planes summed in order into dW in w's dtype.
//            One recompute of z: 6*N*D*V FLOPs against the 8*N*D*V of one
//            recompute for dx and one for dW. Every output element is summed
//            in one fixed order: two calls give the same bits.
//
// Each function launches on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() of its launches (0 = success;
// cudaErrorInvalidValue for a shape or type it does not take).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <initializer_list>
#include <type_traits>
#include <utility>

namespace {

constexpr int kConsumerWarps = 8;                    // two warpgroups
constexpr int kThreads = 32 * (kConsumerWarps + 1);  // + the producer warp
constexpr int kTile = 128;                           // rows of A and of B
constexpr int kRowBytes = 128;                       // one stage of depth
constexpr int kBoxBytes = kTile * kRowBytes;         // 16 KB
constexpr int kRingBytes = 192 * 1024;
constexpr int kSmemBytes = kRingBytes + 1024 + 1024;  // + alignment, barriers
constexpr float kNeg = -1e30f;  // the TPU kernel's initial running max

// the operand types: how the prep kernel copies a value (split for fp32),
// how dz is stored as an operand (put2: two neighbours, i even) and how a
// sum is written out
__device__ __forceinline__ float tf32_rna(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(a));
  return __uint_as_float(r);
}

struct Tf32x3 {
  using T = float;
  static constexpr int kTerms = 2;  // hi and lo boxes of each operand
  static constexpr CUtensorMapDataType kMapType =
      CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  static __device__ __forceinline__ void copy(T* hi, T* lo, size_t i, T v) {
    const float h = tf32_rna(v);
    hi[i] = h;
    lo[i] = tf32_rna(v - h);
  }
  static __device__ __forceinline__ void put2(T* hi, T* lo, size_t i,
                                              float a, float b) {
    const float ha = tf32_rna(a), hb = tf32_rna(b);
    *reinterpret_cast<float2*>(hi + i) = make_float2(ha, hb);
    *reinterpret_cast<float2*>(lo + i) =
        make_float2(tf32_rna(a - ha), tf32_rna(b - hb));
  }
  static __device__ __forceinline__ T out(float v) { return v; }
};

struct Bf16 {
  using T = __nv_bfloat16;
  static constexpr int kTerms = 1;
  static constexpr CUtensorMapDataType kMapType =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static __device__ __forceinline__ void copy(T* hi, T*, size_t i, T v) {
    hi[i] = v;
  }
  static __device__ __forceinline__ void put2(T* hi, T*, size_t i, float a,
                                              float b) {
    *reinterpret_cast<__nv_bfloat162*>(hi + i) = __floats2bfloat162_rn(a, b);
  }
  static __device__ __forceinline__ T out(float v) {
    return __float2bfloat16_rn(v);
  }
};

struct Fp16 {
  using T = __half;
  static constexpr int kTerms = 1;
  static constexpr CUtensorMapDataType kMapType =
      CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  static __device__ __forceinline__ void copy(T* hi, T*, size_t i, T v) {
    hi[i] = v;
  }
  static __device__ __forceinline__ void put2(T* hi, T*, size_t i, float a,
                                              float b) {
    *reinterpret_cast<__half2*>(hi + i) = __floats2half2_rn(a, b);
  }
  static __device__ __forceinline__ T out(float v) {
    return __float2half_rn(v);
  }
};

// values of depth a stage holds, the bytes of a stage, and the stages
template <class K>
constexpr int kDepth = kRowBytes / static_cast<int>(sizeof(typename K::T));
template <class K>
constexpr int kStageBytes = 2 * K::kTerms * kBoxBytes;
template <class K>
constexpr int kStages = kRingBytes / kStageBytes<K>;

// ---------------------------------------------------------------------------
// PTX: mbarriers, TMA, wgmma

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// until the phase of parity `parity` has completed; a wait of 2^35 cycles
// (some 17 s: a lost arrival) traps, so that a fault surfaces as a launch
// error instead of a hung card
__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 35)) __trap();
  }
}

// box (depth c0.., rows c1..) of the tensor map into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// the wgmma descriptor of a K-major box with 128-byte swizzle (1024-byte
// aligned): start address, leading offset 16 B (unused), stride 1024 B
// between groups of 8 rows
__device__ __forceinline__ uint64_t desc(const void* p) {
  return ((static_cast<uint64_t>(smem_u32(p)) & 0x3FFFF) >> 4) |
         (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// the accumulator's registers are settled here (the compiler moves no read
// of them above the preceding wait)
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define FCE_ACC_REGS                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"
#define FCE_ACC_OPS(d)                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),      \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),      \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),      \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),      \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),      \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),      \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d[64] += A (64 rows) x B (128 rows)^T over one k-step (32 bytes of depth)
template <class K>
__device__ __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void mma<Tf32x3>(float (&d)[64], uint64_t a,
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " FCE_ACC_REGS
      ", %64, %65, p, 1, 1;\n}\n"
      : FCE_ACC_OPS(d)
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void mma<Bf16>(float (&d)[64], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FCE_ACC_REGS
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : FCE_ACC_OPS(d)
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void mma<Fp16>(float (&d)[64], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 " FCE_ACC_REGS
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : FCE_ACC_OPS(d)
      : "l"(a), "l"(b), "r"(1));
}

// ---------------------------------------------------------------------------
// the tile engine

// an operand's tensor maps: hi, and lo for fp32
struct Operand {
  const CUtensorMap* hi;
  const CUtensorMap* lo;
};

// one 128 x 128 output tile: rows m0.. of A, rows n0.. of B, `steps` stages
// of depth from ka in A and kb in B; `tag` is the epilogue's
struct Work {
  Operand a, b;
  int m0, n0, ka, kb, steps, tag;
};

// this thread's place in a tile: acc[4j + 2h + e] is row r0 + 8h, column
// c0 + 8j + e of the 128 x 128 tile
struct Frag {
  int r0, c0;
};

__device__ __forceinline__ Frag frag() {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return {64 * (warp / 4) + 16 * (warp % 4) + lane / 4, 2 * (lane % 4)};
}

__device__ __forceinline__ bool is_producer() {
  return threadIdx.x / 32 == kConsumerWarps;
}

// `count` tiles, work_at(i) the i-th; the consumers call epi(work, acc) on
// each finished tile. The producer warp returns as soon as it has issued its
// loads: an epilogue must not use __syncthreads.
template <class K, class WorkAt, class Epi>
__device__ __forceinline__ void run_tiles(char* smem_raw, int count,
                                          WorkAt work_at, Epi epi) {
  constexpr int kStage = kStageBytes<K>, kN = kStages<K>;
  char* ring = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kN * kStage);
  uint64_t* empty = full + kN;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kN; ++s) {
      bar_init(full + s, 1);
      bar_init(empty + s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  auto box = [&](int s, int op, int term) {
    return ring + s * kStage + (op * K::kTerms + term) * kBoxBytes;
  };

  if (is_producer()) {
    if (threadIdx.x % 32 == 0) {
      int s = 0, phase = 0;
      for (int i = 0; i < count; ++i) {
        const Work w = work_at(i);
        for (int st = 0; st < w.steps; ++st) {
          bar_wait(empty + s, phase ^ 1);
          bar_expect(full + s, kStage);
          const int da = w.ka + st * kDepth<K>, db = w.kb + st * kDepth<K>;
          tma_load(box(s, 0, 0), w.a.hi, full + s, da, w.m0);
          tma_load(box(s, 1, 0), w.b.hi, full + s, db, w.n0);
          if constexpr (K::kTerms == 2) {
            tma_load(box(s, 0, 1), w.a.lo, full + s, da, w.m0);
            tma_load(box(s, 1, 1), w.b.lo, full + s, db, w.n0);
          }
          if (++s == kN) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  float acc[64], small[64];  // small: fp32's two small terms only
  int s = 0, phase = 0;
  for (int i = 0; i < count; ++i) {
    const Work w = work_at(i);
#pragma unroll
    for (int r = 0; r < 64; ++r) acc[r] = 0.f;
    if constexpr (K::kTerms == 2) {
#pragma unroll
      for (int r = 0; r < 64; ++r) small[r] = 0.f;
    }
    int held = -1;  // the stage whose group may still be in flight
    for (int st = 0; st < w.steps; ++st) {
      bar_wait(full + s, phase);
      __syncwarp();  // wgmma is warp-aligned: the spin may have diverged
      wgmma_fence();
      const int a_off = wg * 64 * kRowBytes;
      const uint64_t ah = desc(box(s, 0, 0) + a_off), bh = desc(box(s, 1, 0));
#pragma unroll
      for (int k = 0; k < 4; ++k) {  // 32 bytes of depth a k-step
        mma<K>(acc, ah + 2 * k, bh + 2 * k);
        if constexpr (K::kTerms == 2) {
          const uint64_t al = desc(box(s, 0, 1) + a_off);
          const uint64_t bl = desc(box(s, 1, 1));
          mma<K>(small, ah + 2 * k, bl + 2 * k);
          mma<K>(small, al + 2 * k, bh + 2 * k);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (held >= 0 && lane == 0) bar_arrive(empty + held);
      held = s;
      if (++s == kN) {
        s = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    if (held >= 0 && lane == 0) bar_arrive(empty + held);
    fence_regs(acc);
    if constexpr (K::kTerms == 2) {
      fence_regs(small);
#pragma unroll
      for (int r = 0; r < 64; ++r) acc[r] += small[r];
    }
    epi(w, acc);
  }
}

// ---------------------------------------------------------------------------
// prep: the K-major operand copies. dst[r][c] (or dst[c][r], kT) = src[r][c]
// for src [rows, cols] contiguous, dst rows of `ld` values; fp32 split into
// hi and lo. 32 x 32 tiles through shared memory, both sides coalesced.
template <class K, bool kT>
__global__ void __launch_bounds__(256)
fused_ce_prep_kernel(const typename K::T* __restrict__ src, int rows,
                     int cols, typename K::T* __restrict__ hi,
                     typename K::T* __restrict__ lo, int ld) {
  using T = typename K::T;
  __shared__ __align__(16) unsigned char raw[32 * 33 * sizeof(T)];
  T(*tile)[33] = reinterpret_cast<T(*)[33]>(raw);
  const int c0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int i = ty; i < 32; i += 8) {
    const int r = r0 + i, c = c0 + tx;
    if (r < rows && c < cols)
      tile[i][tx] = src[static_cast<size_t>(r) * cols + c];
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    if (kT) {  // dst row c0 + i, column r0 + tx
      const int c = c0 + i, r = r0 + tx;
      if (r < rows && c < cols)
        K::copy(hi, lo, static_cast<size_t>(c) * ld + r, tile[tx][i]);
    } else {
      const int r = r0 + i, c = c0 + tx;
      if (r < rows && c < cols)
        K::copy(hi, lo, static_cast<size_t>(r) * ld + c, tile[i][tx]);
    }
  }
}

// ---------------------------------------------------------------------------
// forward, grid (ceil(N / 128), splits): the running (max, sumexp, sum z,
// z_label) of each row over vocab tiles [s * cps, (s + 1) * cps) of 128,
// written to part [4][splits][N]
struct FwdArgs {
  CUtensorMap x_hi, x_lo, wt_hi, wt_lo;  // x [N, D], w^T [V, D]
  const int* labels;
  float* part;
  int n, v, steps, cps, tiles_v;
};

template <class K>
__global__ void __launch_bounds__(kThreads, 1)
fused_ce_fwd_kernel(const __grid_constant__ FwdArgs args) {
  extern __shared__ char smem[];
  const int m0 = blockIdx.x * kTile, split = blockIdx.y;
  const int t0 = split * args.cps;
  const int count = max(0, min(args.tiles_v, t0 + args.cps) - t0);
  const Frag f = frag();
  int lab[2];
  float m[2], l[2], zs[2], zl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + f.r0 + 8 * h;
    lab[h] = !is_producer() && row < args.n ? args.labels[row] : -1;
    m[h] = kNeg;
    l[h] = zs[h] = zl[h] = 0.f;
  }
  const Operand a{&args.x_hi, &args.x_lo}, b{&args.wt_hi, &args.wt_lo};
  run_tiles<K>(
      smem, count,
      [&](int i) {
        return Work{a, b, m0, (t0 + i) * kTile, 0, 0, args.steps, 0};
      },
      [&](const Work& w, float(&acc)[64]) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float tmax = -INFINITY;
#pragma unroll
          for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (w.n0 + f.c0 + 8 * j + e < args.v)
                tmax = fmaxf(tmax, acc[4 * j + 2 * h + e]);
          const float mn = fmaxf(m[h], tmax);
          float se = 0.f, sz = 0.f;
#pragma unroll
          for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = w.n0 + f.c0 + 8 * j + e;
              const float z = acc[4 * j + 2 * h + e];
              if (col < args.v) {
                se += expf(z - mn);
                sz += z;
                if (col == lab[h]) zl[h] += z;
              }
            }
          l[h] = l[h] * expf(m[h] - mn) + se;
          m[h] = mn;
          zs[h] += sz;
        }
      });
  if (is_producer()) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {  // the four threads of a row
      const float mo = __shfl_xor_sync(0xffffffffu, m[h], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[h], off);
      const float mn = fmaxf(m[h], mo);
      l[h] = l[h] * expf(m[h] - mn) + lo * expf(mo - mn);
      m[h] = mn;
      zs[h] += __shfl_xor_sync(0xffffffffu, zs[h], off);
      zl[h] += __shfl_xor_sync(0xffffffffu, zl[h], off);
    }
    const int row = m0 + f.r0 + 8 * h;
    if (threadIdx.x % 4 == 0 && row < args.n) {
      const size_t plane = static_cast<size_t>(gridDim.y) * args.n;
      const size_t at = static_cast<size_t>(split) * args.n + row;
      args.part[at] = m[h];
      args.part[plane + at] = l[h];
      args.part[2 * plane + at] = zs[h];
      args.part[3 * plane + at] = zl[h];
    }
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

// ---------------------------------------------------------------------------
// backward K1: dz of the slab's columns [v0, v0 + vs_eff) into dz [N, vs]
// and dz^T [vs, ldn] (either may be null), in the operand type; columns
// past V hold 0. Persistent: block b takes tiles b, b + grid, ... of the
// tiles_n x tiles_v tiles, the row tile fastest (the blocks of a wave share
// their w^T tiles).
template <class K>
struct DzArgs {
  using T = typename K::T;
  CUtensorMap x_hi, x_lo, wt_hi, wt_lo;
  const int* labels;
  const float* lse;
  const float* g;
  T *dz_hi, *dz_lo, *dzt_hi, *dzt_lo;
  int n, v, v0, vs, ldn, steps, ignore, tiles_n, tiles_v;
  float on, off;
};

// dz as the JAX function rounds it for an x narrower than the operands'
// fp32 path (mixed x and w), R 1 / 2: to bf16 / fp16, back in fp32
// exactly; R 0: as it is
template <int R>
__device__ __forceinline__ float round_dz(float v) {
  if (R == 1) return __bfloat162float(__float2bfloat16_rn(v));
  if (R == 2) return __half2float(__float2half_rn(v));
  return v;
}

// how many of `tiles` tiles block blockIdx.x of a persistent grid takes
__device__ __forceinline__ int my_tiles(int tiles) {
  return (tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
}

template <class K, int R = 0>
__global__ void __launch_bounds__(kThreads, 1)
fused_ce_dz_kernel(const __grid_constant__ DzArgs<K> args) {
  extern __shared__ char smem[];
  const Frag f = frag();
  const Operand a{&args.x_hi, &args.x_lo}, b{&args.wt_hi, &args.wt_lo};
  run_tiles<K>(
      smem, my_tiles(args.tiles_n * args.tiles_v),
      [&](int i) {
        const int t = blockIdx.x + i * gridDim.x;
        return Work{a, b, (t % args.tiles_n) * kTile,
                    args.v0 + (t / args.tiles_n) * kTile, 0, 0, args.steps, 0};
      },
      [&](const Work& w, float(&acc)[64]) {
        // rows r0 (lane / 4 even) and r0 + 1 of the partner lane ^ 4 pair
        // up for dz^T: each sends the other one of its two columns, so that
        // each holds one column of both rows (two neighbours of dz^T)
        const bool odd = (threadIdx.x / 4) % 2;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = w.m0 + f.r0 + 8 * h;
          const bool live = row < args.n;
          const int lab = live ? args.labels[row] : args.ignore;
          const float lse = live ? args.lse[row] : 0.f;
          const float g = live ? args.g[row] : 0.f;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int col = w.n0 + f.c0 + 8 * j, jj = col - args.v0;
            float dz[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              dz[e] = 0.f;
              if (col + e < args.v && lab != args.ignore) {
                const float t = (col + e == lab ? args.on : 0.f) + args.off;
                dz[e] = round_dz<R>(
                    (expf(acc[4 * j + 2 * h + e] - lse) - t) * g);
              }
            }
            if (args.dz_hi && live)
              K::put2(args.dz_hi, args.dz_lo,
                      static_cast<size_t>(row) * args.vs + jj, dz[0], dz[1]);
            if (args.dzt_hi) {
              const float other =
                  __shfl_xor_sync(0xffffffffu, dz[odd ? 0 : 1], 4);
              const int r = odd ? row - 1 : row;  // the pair's first row
              if (r < args.n)  // r + 1 < ldn: ldn pads n to 16 bytes
                K::put2(args.dzt_hi, args.dzt_lo,
                        static_cast<size_t>(jj + odd) * args.ldn + r,
                        odd ? other : dz[0], odd ? dz[1] : other);
            }
          }
        }
      });
}

// backward K2 + K3, one persistent launch over the slab [v0, v0 + vs_eff)
// (tiles dealt round robin as in K1): tiles [0, k3_tiles) are K3's,
// part[s][d][j] = sum over the rows of chunk s of x[row][d] dz[row][j]; the
// rest K2's, dx += dz @ w_slab^T into dx_acc, written to dx in the output
// type on the last slab. Every tile is vs deep.
template <class K>
struct GradArgs {
  using T = typename K::T;
  CUtensorMap dz_hi, dz_lo, w_hi, w_lo;      // K2: dz [N, vs], w [D, V]
  CUtensorMap xt_hi, xt_lo, dzt_hi, dzt_lo;  // K3: x^T [D, N], dz^T [vs, N]
  float* dx_acc;
  T* dx;
  float* part;
  int n, d, v0, vs, vs_eff, first, last, tiles_d, k3_tiles, k3_tiles_v,
      k2_tiles;
};

template <class K>
__global__ void __launch_bounds__(kThreads, 1)
fused_ce_grad_kernel(const __grid_constant__ GradArgs<K> args) {
  extern __shared__ char smem[];
  constexpr int kD = kDepth<K>;
  const Frag f = frag();
  const Operand xt{&args.xt_hi, &args.xt_lo}, dzt{&args.dzt_hi, &args.dzt_lo};
  const Operand dz{&args.dz_hi, &args.dz_lo}, w{&args.w_hi, &args.w_lo};
  run_tiles<K>(
      smem, my_tiles(args.k3_tiles + args.k2_tiles),
      [&](int i) {
        const int t = blockIdx.x + i * gridDim.x;
        if (t < args.k3_tiles) {  // tag: the chunk of N
          const int td = t % args.tiles_d;
          const int tv = (t / args.tiles_d) % args.k3_tiles_v;
          const int s = t / (args.tiles_d * args.k3_tiles_v);
          const int k0 = s * args.vs, kn = min(args.vs, args.n - k0);
          return Work{xt, dzt, td * kTile, tv * kTile, k0, k0,
                      (kn + kD - 1) / kD, s};
        }
        const int u = t - args.k3_tiles;  // tag -1: a K2 tile
        return Work{dz, w, (u / args.tiles_d) * kTile,
                    (u % args.tiles_d) * kTile, 0, args.v0,
                    (args.vs_eff + kD - 1) / kD, -1};
      },
      [&](const Work& wk, float(&acc)[64]) {
        if (wk.tag >= 0) {
          float* plane =
              args.part + static_cast<size_t>(wk.tag) * args.d * args.vs;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int dd = wk.m0 + f.r0 + 8 * h;
            if (dd >= args.d) continue;
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              const int jj = wk.n0 + f.c0 + 8 * j;
              // column jj + 1 may lie past vs_eff, inside the plane's row
              // of vs: dw_sum_kernel never reads it
              if (jj < args.vs_eff)
                *reinterpret_cast<float2*>(
                    plane + static_cast<size_t>(dd) * args.vs + jj) =
                    make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
            }
          }
          return;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = wk.m0 + f.r0 + 8 * h;
          if (row >= args.n) continue;
#pragma unroll
          for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = wk.n0 + f.c0 + 8 * j + e;
              if (col >= args.d) continue;
              const size_t at = static_cast<size_t>(row) * args.d + col;
              const float sum =
                  (args.first ? 0.f : args.dx_acc[at]) + acc[4 * j + 2 * h + e];
              if (args.last)
                args.dx[at] = K::out(sum);
              else
                args.dx_acc[at] = sum;
            }
        }
      });
}

// dW[:, v0 + j] = sum over s in order of part[s][:, j], in w's type
template <class K>
__global__ void fused_ce_dw_sum_kernel(const float* __restrict__ part,
                                       typename K::T* __restrict__ dw, int d,
                                       int v, int v0, int vs, int vs_eff,
                                       int splits) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(d) * vs_eff) return;
  const int dd = static_cast<int>(i / vs_eff), j = static_cast<int>(i % vs_eff);
  float sum = 0.f;
  for (int s = 0; s < splits; ++s)
    sum += part[(static_cast<size_t>(s) * d + dd) * vs + j];
  dw[static_cast<size_t>(dd) * v + v0 + j] = K::out(sum);
}

// ---------------------------------------------------------------------------
// host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the map of a K-major operand [rows, cols] with rows of `ld` values, read
// in boxes of 128 rows x one stage of depth, 128-byte swizzle, zeros past
// the edges; a null base gives an unused (zeroed) map
template <class K>
bool make_map(CUtensorMap* map, const void* base, int rows, int cols,
              int ld) {
  std::memset(map, 0, sizeof(*map));
  if (base == nullptr) return true;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) *
                                 sizeof(typename K::T)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kDepth<K>),
                             static_cast<cuuint32_t>(kTile)};
  const cuuint32_t step[2] = {1, 1};
  return enc(map, K::kMapType, 2, const_cast<void*>(base), dims, strides,
             box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// fp32 operands come as (hi, lo) pairs: both given or both null; the 16-bit
// types have no lo
template <class K>
bool pairs_ok(std::initializer_list<std::pair<const void*, const void*>> ps) {
  for (const auto& p : ps)
    if (K::kTerms == 2 ? (p.first == nullptr) != (p.second == nullptr)
                       : p.second != nullptr)
      return false;
  return true;
}

template <typename Kern>
cudaError_t allow_smem(Kern kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
}

template <class K>
int prep(const void* src, int rows, int cols, void* hi, void* lo, int ld,
         int transpose, cudaStream_t s) {
  using T = typename K::T;
  if (rows <= 0 || cols <= 0 || (rows + 31) / 32 > 65535 ||
      ld < (transpose ? rows : cols) || (K::kTerms == 2 && lo == nullptr))
    return cudaErrorInvalidValue;
  const dim3 grid((cols + 31) / 32, (rows + 31) / 32), block(32, 8);
  auto kernel = transpose ? fused_ce_prep_kernel<K, true>
                          : fused_ce_prep_kernel<K, false>;
  kernel<<<grid, block, 0, s>>>(static_cast<const T*>(src), rows, cols,
                                static_cast<T*>(hi), static_cast<T*>(lo), ld);
  return cudaGetLastError();
}

template <class K>
int fwd(const void* xh, const void* xl, int ldx, const void* wth,
        const void* wtl, int ldwt, const int* labels, float* part,
        float* loss, float* lse, int n, int d, int v, int splits, float on,
        float eps, float vocab, int ignore, cudaStream_t s) {
  if (n <= 0 || d <= 0 || v <= 0 || splits < 1 || splits > 65535 ||
      xh == nullptr || wth == nullptr || !pairs_ok<K>({{xh, xl}, {wth, wtl}}))
    return cudaErrorInvalidValue;
  FwdArgs args;
  if (!make_map<K>(&args.x_hi, xh, n, d, ldx) ||
      !make_map<K>(&args.x_lo, xl, n, d, ldx) ||
      !make_map<K>(&args.wt_hi, wth, v, d, ldwt) ||
      !make_map<K>(&args.wt_lo, wtl, v, d, ldwt))
    return cudaErrorInvalidValue;
  args.labels = labels;
  args.part = part;
  args.n = n;
  args.v = v;
  args.steps = (d + kDepth<K> - 1) / kDepth<K>;
  args.tiles_v = (v + kTile - 1) / kTile;
  args.cps = (args.tiles_v + splits - 1) / splits;
  cudaError_t err = allow_smem(fused_ce_fwd_kernel<K>);
  if (err != cudaSuccess) return err;
  fused_ce_fwd_kernel<K><<<dim3((n + kTile - 1) / kTile, splits), kThreads,
                           kSmemBytes, s>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fused_ce_combine_kernel<<<(n + 255) / 256, 256, 0, s>>>(
      part, labels, loss, lse, n, splits, on, eps, vocab, ignore);
  return cudaGetLastError();
}

template <class K>
int bwd(const void* xh, const void* xl, int ldx, const void* wth,
        const void* wtl, int ldwt, const void* wh, const void* wl, int ldw,
        const void* xth, const void* xtl, int ldxt, const int* labels,
        const float* lse, const float* g, void* dzh, void* dzl, void* dzth,
        void* dztl, int ldn, float* part, float* dx_acc, void* dx, void* dw,
        int n, int d, int v, int vs, int sms, float on, float off,
        int ignore, int dz_round, cudaStream_t s) {
  using T = typename K::T;
  const bool want_dx = dx != nullptr, want_dw = dw != nullptr;
  if (!pairs_ok<K>({{xh, xl}, {wth, wtl}, {wh, wl}, {xth, xtl}, {dzh, dzl},
                    {dzth, dztl}}))
    return cudaErrorInvalidValue;
  if (n <= 0 || d <= 0 || v <= 0 || vs <= 0 || vs % kTile != 0 || sms < 1 ||
      (!want_dx && !want_dw) || (want_dx && (dzh == nullptr || wh == nullptr ||
                                             dx_acc == nullptr)) ||
      (want_dw && (dzth == nullptr || xth == nullptr || part == nullptr)))
    return cudaErrorInvalidValue;
  DzArgs<K> dz;
  GradArgs<K> gr;
  if (!make_map<K>(&dz.x_hi, xh, n, d, ldx) ||
      !make_map<K>(&dz.x_lo, xl, n, d, ldx) ||
      !make_map<K>(&dz.wt_hi, wth, v, d, ldwt) ||
      !make_map<K>(&dz.wt_lo, wtl, v, d, ldwt) ||
      !make_map<K>(&gr.dz_hi, want_dx ? dzh : nullptr, n, vs, vs) ||
      !make_map<K>(&gr.dz_lo, want_dx ? dzl : nullptr, n, vs, vs) ||
      !make_map<K>(&gr.w_hi, wh, d, v, ldw) ||
      !make_map<K>(&gr.w_lo, wl, d, v, ldw) ||
      !make_map<K>(&gr.xt_hi, xth, d, n, ldxt) ||
      !make_map<K>(&gr.xt_lo, xtl, d, n, ldxt) ||
      !make_map<K>(&gr.dzt_hi, want_dw ? dzth : nullptr, vs, n, ldn) ||
      !make_map<K>(&gr.dzt_lo, want_dw ? dztl : nullptr, vs, n, ldn))
    return cudaErrorInvalidValue;
  dz.labels = labels;
  dz.lse = lse;
  dz.g = g;
  dz.dz_hi = want_dx ? static_cast<T*>(dzh) : nullptr;
  dz.dz_lo = want_dx ? static_cast<T*>(dzl) : nullptr;
  dz.dzt_hi = want_dw ? static_cast<T*>(dzth) : nullptr;
  dz.dzt_lo = want_dw ? static_cast<T*>(dztl) : nullptr;
  dz.n = n;
  dz.v = v;
  dz.vs = vs;
  dz.ldn = ldn;
  dz.steps = (d + kDepth<K> - 1) / kDepth<K>;
  dz.ignore = ignore;
  dz.on = on;
  dz.off = off;
  const int splits = (n + vs - 1) / vs;  // K3's chunks of N
  gr.dx_acc = dx_acc;
  gr.dx = static_cast<T*>(dx);
  gr.part = part;
  gr.n = n;
  gr.d = d;
  gr.vs = vs;
  gr.tiles_d = (d + kTile - 1) / kTile;
  auto dz_kernel = fused_ce_dz_kernel<K>;
  if constexpr (std::is_same<K, Tf32x3>::value) {
    if (dz_round == 1) dz_kernel = fused_ce_dz_kernel<K, 1>;
    if (dz_round == 2) dz_kernel = fused_ce_dz_kernel<K, 2>;
  }
  cudaError_t err = allow_smem(dz_kernel);
  if (err == cudaSuccess) err = allow_smem(fused_ce_grad_kernel<K>);
  if (err != cudaSuccess) return err;
  const int tiles_n = (n + kTile - 1) / kTile;
  for (int v0 = 0; v0 < v; v0 += vs) {
    const int vs_eff = std::min(vs, v - v0);
    const int tiles_v = (vs_eff + kTile - 1) / kTile;
    dz.v0 = v0;
    dz.tiles_n = tiles_n;
    dz.tiles_v = tiles_v;
    dz_kernel<<<std::min(tiles_n * tiles_v, sms), kThreads, kSmemBytes,
                s>>>(dz);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    gr.v0 = v0;
    gr.vs_eff = vs_eff;
    gr.first = v0 == 0;
    gr.last = v0 + vs >= v;
    gr.k3_tiles_v = tiles_v;
    gr.k3_tiles = want_dw ? gr.tiles_d * tiles_v * splits : 0;
    gr.k2_tiles = want_dx ? tiles_n * gr.tiles_d : 0;
    fused_ce_grad_kernel<K><<<std::min(gr.k3_tiles + gr.k2_tiles, sms),
                              kThreads, kSmemBytes, s>>>(gr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if (want_dw) {
      const size_t total = static_cast<size_t>(d) * vs_eff;
      fused_ce_dw_sum_kernel<K><<<static_cast<unsigned>((total + 255) / 256),
                                  256, 0, s>>>(part, static_cast<T*>(dw), d,
                                               v, v0, vs, vs_eff, splits);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

}  // namespace

// kind: 0 fp32 (3xTF32), 1 bf16, 2 fp16. Operands are K-major copies made by
// paddle_fused_ce_prep: `hi` (and `lo` for fp32, else null) with rows of
// `ld` values, ld * the element size a multiple of 16 bytes.

// dst = src [rows, cols] (transpose: src^T [cols, rows]) with rows of ld
// values; fp32 split into hi and lo
extern "C" int paddle_fused_ce_prep(int kind, const void* src, int rows,
                                    int cols, void* hi, void* lo, int ld,
                                    int transpose, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0: return prep<Tf32x3>(src, rows, cols, hi, lo, ld, transpose, s);
    case 1: return prep<Bf16>(src, rows, cols, hi, lo, ld, transpose, s);
    case 2: return prep<Fp16>(src, rows, cols, hi, lo, ld, transpose, s);
    default: return cudaErrorInvalidValue;
  }
}

// x [N, D], w^T [V, D]; splits: how many blocks share one row tile's
// vocabulary (1..65535); part: scratch of 4 * splits * n floats
extern "C" int paddle_fused_ce_fwd(int kind, const void* xh, const void* xl,
                                   int ldx, const void* wth, const void* wtl,
                                   int ldwt, const int* labels, float* part,
                                   float* loss, float* lse, int n, int d,
                                   int v, int splits, float on, float eps,
                                   float vocab, int ignore, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0: return fwd<Tf32x3>(xh, xl, ldx, wth, wtl, ldwt, labels, part, loss, lse, n, d, v, splits, on, eps, vocab, ignore, s);
    case 1: return fwd<Bf16>(xh, xl, ldx, wth, wtl, ldwt, labels, part, loss, lse, n, d, v, splits, on, eps, vocab, ignore, s);
    case 2: return fwd<Fp16>(xh, xl, ldx, wth, wtl, ldwt, labels, part, loss, lse, n, d, v, splits, on, eps, vocab, ignore, s);
    default: return cudaErrorInvalidValue;
  }
}

// x [N, D] and w^T [V, D] (K1); w [D, V] (K2, null without dx); x^T [D, N]
// (K3, null without dW). Scratch: dz [N, vs] (with dx) and dz^T [vs, ldn]
// (with dW) in the operand type, part [ceil(N / vs), D, vs] fp32 (with dW),
// dx_acc [N, D] fp32 (with dx; may be dx itself for fp32). dx [N, D] and
// dw [D, V] in the operand type, either null; vs a multiple of 128; sms: the
// blocks of a persistent launch (one an SM). dz_round (fp32 only, for an x
// of a narrower type than w): 1 / 2 rounds dz to bf16 / fp16 before the two
// gradient products, 0 leaves it fp32.
extern "C" int paddle_fused_ce_bwd(
    int kind, const void* xh, const void* xl, int ldx, const void* wth,
    const void* wtl, int ldwt, const void* wh, const void* wl, int ldw,
    const void* xth, const void* xtl, int ldxt, const int* labels,
    const float* lse, const float* g, void* dzh, void* dzl, void* dzth,
    void* dztl, int ldn, float* part, float* dx_acc, void* dx, void* dw,
    int n, int d, int v, int vs, int sms, float on, float off, int ignore,
    int dz_round, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dz_round < 0 || dz_round > 2 || (dz_round && kind != 0))
    return cudaErrorInvalidValue;
  switch (kind) {
    case 0: return bwd<Tf32x3>(xh, xl, ldx, wth, wtl, ldwt, wh, wl, ldw, xth, xtl, ldxt, labels, lse, g, dzh, dzl, dzth, dztl, ldn, part, dx_acc, dx, dw, n, d, v, vs, sms, on, off, ignore, dz_round, s);
    case 1: return bwd<Bf16>(xh, xl, ldx, wth, wtl, ldwt, wh, wl, ldw, xth, xtl, ldxt, labels, lse, g, dzh, dzl, dzth, dztl, ldn, part, dx_acc, dx, dw, n, d, v, vs, sms, on, off, ignore, 0, s);
    case 2: return bwd<Fp16>(xh, xl, ldx, wth, wtl, ldwt, wh, wl, ldw, xth, xtl, ldxt, labels, lse, g, dzh, dzl, dzth, dztl, ldn, part, dx_acc, dx, dw, n, d, v, vs, sms, on, off, ignore, 0, s);
    default: return cudaErrorInvalidValue;
  }
}
