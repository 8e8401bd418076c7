// Masked sequence pool (SUM, AVERAGE, SQRT) over a padded batch, written for
// Hopper (compiled for sm_90a) behind a plain C interface that ctypes loads.
//
// Replaces the Pallas TPU kernel of paddle_tpu/ops/pallas/seqpool.py:
//   paddle_seqpool <- masked_seqpool (:48; _masked_seqpool_impl :79,
//                     pallas_call :94, _seqpool_kernel :23)
//
// x [B, T, D] (row-major, contiguous) and lens [B] int32 give out [B, D]:
//   out[b] = sum_{t < n} x[b, t]             (mode 0, SUM)
//            / max(n, 1)                     (mode 1, AVERAGE)
//            / sqrt(max(n, 1))               (mode 2, SQRT)
// with n = lens[b]: the rows summed are t < min(n, T), the divisor takes n as
// it is (the TPU kernel's tpos < n mask and jnp.maximum(n, 1.0)). The sum is
// fp32 (fp64 for double) over chunks of t, each in increasing t, the chunks'
// sums in chunk order (Design, below); the divisions are IEEE (no fast
// math), as jnp's. x may be fp32, fp64, fp16 or bf16, or int64 for SUM
// (pool_elem.cuh: what each accumulates in and returns); the TPU kernel
// takes fp32 only, the JAX op's refer branch every dtype.
// The TPU kernel's MAX branch is not here: no caller routes MAX to it
// (paddle_tpu/ops/sequence_ops.py:69) and it has no VJP, so MAX, LAST and
// FIRST stay in torch. The backward is elementwise and stays in torch too.
//
// What bounds it: bytes. It reads the live rows of x once and writes [B, D]:
// at the text-conv classifier's pools (B 128, T 100, D 512, about half the
// rows live) some 14 MB, 4.4 us at 3.35 TB/s; one add a float read.
//
// Design. The TPU kernel DMAs a whole [8, T, D] block into VMEM and masks the
// padded rows on chip. Here, on embed_pool's plan (embed_pool.cu), a block of
// W warps (the wrapper's plan: W = min(8, ceil(T / 12)), so that no warp
// walks more than ~13 steps at T 100) owns one output row b and one stripe
// of 32 column units, its lanes lying across D: an fp32 x whose width is
// whole float4s and which is 16-byte aligned is read a float4 a lane (a
// stripe of 128 floats: D 512 is 4 stripes), every other x one element a
// lane. Warp k takes the contiguous chunk [k c, (k + 1) c) of t, c =
// ceil(T / W), cut at min(lens[b], T), and reads only those rows (a padded
// row costs no byte): up to 16 loads of its chunk in flight at once, then
// added in increasing t. The W partial sums go through shared memory and
// warp 0 adds them in warp order: the result is deterministic, two runs give
// the same bits, and it is an fp32 (fp64, int64) sum of the same terms in
// another order than the plain version's. The grid is (B, stripes): (128,
// 4) blocks of 8 warps at the classifier's pools, where the earlier design
// (one block of 128 threads a row and 128 column units, each thread walking
// t alone, 8 loads deep) gave 128 blocks of 4 warps on 132 SMs and left the
// longest row to set the time.
//   Float8 (e4m3fn, e5m2, e4m3fnuz, e5m2fnuz) rounds every partial sum to its
// type, in t order (pool_elem.cuh), so its instantiations take W = 1: one
// warp walks the whole row in t order, as embed_pool's do.
//
// paddle_seqpool launches on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() of its launch (0 = success;
// cudaErrorInvalidValue for a shape or mode it does not take).

#include <cmath>
#include <cstdint>

#include "pool_elem.cuh"

namespace {

constexpr int kMaxWarps = 8;
constexpr int kInFlight = 16;              // loads issued before the adds

__device__ __forceinline__ float root(float v) { return sqrtf(v); }
__device__ __forceinline__ double root(double v) { return ::sqrt(v); }

// column unit c of row b (d column units of E); blockDim.x = 32 * warps
template <typename E, int kMode>
__global__ void __launch_bounds__(32 * kMaxWarps)
seqpool_kernel(const E* __restrict__ x, const int* __restrict__ lens,
               E* __restrict__ out, int t_len, int d) {
  using P = Elem<E>;
  using Acc = typename P::Acc;
  __shared__ Acc part[kMaxWarps][32];
  const int b = blockIdx.x, warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = blockIdx.y * 32 + lane;
  const bool col = c < d;
  const int n = lens[b];
  const int chunk = (t_len + warps - 1) / warps;
  const int t_begin = warp * chunk;
  const int t_end = min(min(t_len, t_begin + chunk), max(n, 0));
  const E* xc = x + static_cast<size_t>(b) * t_len * d + c;
  Acc acc{};
  for (int t0 = t_begin; t0 < t_end; t0 += kInFlight) {
    E v[kInFlight];
#pragma unroll
    for (int k = 0; k < kInFlight; ++k)
      if (col && t0 + k < t_end)
        v[k] = P::load(xc + static_cast<size_t>(t0 + k) * d);
#pragma unroll
    for (int k = 0; k < kInFlight; ++k)
      if (col && t0 + k < t_end) acc = P::add(acc, P::widen(v[k]));
  }
  if (warps > 1) {
    part[warp][lane] = acc;
    __syncthreads();
    if (warp != 0) return;
    acc = part[0][lane];
    for (int k = 1; k < warps; ++k) acc = P::add(acc, part[k][lane]);
  }
  if (!col) return;
  E* o = out + static_cast<size_t>(b) * d + c;
  if constexpr (kMode == 0) {
    *o = P::sum_out(acc);
  } else {
    using Real = typename P::Real;
    Real denom = P::rounded(static_cast<Real>(n));
    denom = denom < Real(1) ? Real(1) : denom;
    if constexpr (kMode == 2) denom = P::rounded(root(denom));
    *o = P::mean_out(acc, denom);
  }
}

// the pointers and sizes of one call
struct Call {
  const void* x;
  const int* lens;
  void* out;
  int b_len, t_len, mode, warps;
  cudaStream_t s;
};

template <typename E>
int launch(const Call& c, int d) {
  if ((d + 31) / 32 > 65535 || c.warps < 1 || c.warps > kMaxWarps ||
      (Ordered<E>::value && c.warps != 1))
    return cudaErrorInvalidValue;
  const dim3 grid(c.b_len, (d + 31) / 32);
  const int threads = 32 * c.warps;
  const E* x = static_cast<const E*>(c.x);
  E* o = static_cast<E*>(c.out);
  if (c.mode == 0) {
    seqpool_kernel<E, 0><<<grid, threads, 0, c.s>>>(x, c.lens, o, c.t_len, d);
  } else if constexpr (Elem<E>::kDivides) {
    if (c.mode == 1)
      seqpool_kernel<E, 1><<<grid, threads, 0, c.s>>>(x, c.lens, o, c.t_len,
                                                       d);
    else
      seqpool_kernel<E, 2><<<grid, threads, 0, c.s>>>(x, c.lens, o, c.t_len,
                                                       d);
  } else {
    return cudaErrorInvalidValue;       // integers: SUM only
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: a PoolDtype code (pool_elem.cuh); out has x's type; warps: the
// warps that share one row (1 for float8, which sums in t order)
extern "C" int paddle_seqpool(const void* x, const int* lens, void* out,
                              int b_len, int t_len, int d, int mode,
                              int dtype, int warps, void* stream) {
  if (b_len < 1 || t_len < 0 || d < 1 || mode < 0 || mode > 2)
    return cudaErrorInvalidValue;
  const Call c{x,    lens, out,   b_len,
               t_len, mode, warps, static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case kF32:
      if (d % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
          (reinterpret_cast<uintptr_t>(out) & 15) == 0)
        return launch<float4>(c, d / 4);
      return launch<float>(c, d);
    case kF64:
      return launch<double>(c, d);
    case kF16:
      return launch<__half>(c, d);
    case kBF16:
      return launch<__nv_bfloat16>(c, d);
    case kF8E4M3:
      return launch<F8<__NV_E4M3>>(c, d);
    case kF8E5M2:
      return launch<F8<__NV_E5M2>>(c, d);
    case kF8E4M3Fnuz:
      return launch<Fnuz<4, 3>>(c, d);
    case kF8E5M2Fnuz:
      return launch<Fnuz<5, 2>>(c, d);
    case kI64:
      return launch<long long>(c, d);
    default:
      return cudaErrorInvalidValue;
  }
}
