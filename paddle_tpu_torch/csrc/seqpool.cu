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
// fp32 in increasing t (fp64 for double); the divisions are IEEE (no fast
// math), as jnp's. x may be fp32, fp64, fp16 or bf16, or int64 for SUM
// (pool_elem.cuh: what each accumulates in and returns); the TPU kernel
// takes fp32 only, the JAX op's refer branch every dtype.
// The TPU kernel's MAX branch is not here: no caller routes MAX to it
// (paddle_tpu/ops/sequence_ops.py:69) and it has no VJP, so MAX, LAST and
// FIRST stay in torch. The backward is elementwise and stays in torch too.
//
// What bounds it: bytes. It reads the live rows of x once and writes [B, D]:
// at the text-conv classifier's pools (B 128, T 100, D 512, about half the
// rows live) some 13 MB, 4 us at 3.35 TB/s; one add a float read.
//
// Design. The TPU kernel DMAs a whole [8, T, D] block into VMEM and masks the
// padded rows on chip. Here a block of 128 threads owns one row b and a slice
// of 128 columns, and each thread walks t < n in order over its column,
// reading only the live rows: a padded row costs no byte. An fp32 x whose
// width is whole float4s and which is 16-byte aligned is read a float4 a
// column (512 floats a block); every other x one element a column. The loop
// is unrolled 8 deep so that eight loads of a thread are in flight at once
// (the latency of device memory, not its rate, bounds a thread that waits on
// each load); the adds stay in increasing t. Grid (B, ceil(D / 128)) in
// columns.
//
// paddle_seqpool launches on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() of its launch (0 = success;
// cudaErrorInvalidValue for a shape or mode it does not take).

#include <cmath>
#include <cstdint>

#include "pool_elem.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

__device__ __forceinline__ float root(float v) { return sqrtf(v); }
__device__ __forceinline__ double root(double v) { return ::sqrt(v); }

// column c of row b (d columns of E): sum over t < live in order
template <typename E, int kMode>
__global__ void __launch_bounds__(kThreads)
seqpool_kernel(const E* __restrict__ x, const int* __restrict__ lens,
               E* __restrict__ out, int t_len, int d) {
  using P = Elem<E>;
  const int b = blockIdx.x;
  const int c = blockIdx.y * kThreads + threadIdx.x;
  if (c >= d) return;
  const int n = lens[b];
  const int live = min(max(n, 0), t_len);
  const E* xb = x + static_cast<size_t>(b) * t_len * d + c;
  typename P::Acc acc{};
  int t = 0;
  for (; t + kUnroll <= live; t += kUnroll) {
    E v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      v[k] = P::load(xb + static_cast<size_t>(t + k) * d);
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) acc = P::add(acc, P::widen(v[k]));
  }
  for (; t < live; ++t)
    acc = P::add(acc, P::widen(P::load(xb + static_cast<size_t>(t) * d)));
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

template <typename E>
int launch(const void* x, const int* lens, void* out, int b_len, int t_len,
           int d, int mode, cudaStream_t s) {
  if ((d + kThreads - 1) / kThreads > 65535) return cudaErrorInvalidValue;
  const dim3 grid(b_len, (d + kThreads - 1) / kThreads);
  const E* xe = static_cast<const E*>(x);
  E* o = static_cast<E*>(out);
  if (mode == 0) {
    seqpool_kernel<E, 0><<<grid, kThreads, 0, s>>>(xe, lens, o, t_len, d);
  } else if constexpr (Elem<E>::kDivides) {
    if (mode == 1)
      seqpool_kernel<E, 1><<<grid, kThreads, 0, s>>>(xe, lens, o, t_len, d);
    else
      seqpool_kernel<E, 2><<<grid, kThreads, 0, s>>>(xe, lens, o, t_len, d);
  } else {
    return cudaErrorInvalidValue;       // integers: SUM only
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: a PoolDtype code (pool_elem.cuh); out has x's type
extern "C" int paddle_seqpool(const void* x, const int* lens, void* out,
                              int b_len, int t_len, int d, int mode,
                              int dtype, void* stream) {
  if (b_len < 1 || t_len < 0 || d < 1 || mode < 0 || mode > 2)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      if (d % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
          (reinterpret_cast<uintptr_t>(out) & 15) == 0)
        return launch<float4>(x, lens, out, b_len, t_len, d / 4, mode, s);
      return launch<float>(x, lens, out, b_len, t_len, d, mode, s);
    case kF64:
      return launch<double>(x, lens, out, b_len, t_len, d, mode, s);
    case kF16:
      return launch<__half>(x, lens, out, b_len, t_len, d, mode, s);
    case kBF16:
      return launch<__nv_bfloat16>(x, lens, out, b_len, t_len, d, mode, s);
    case kF8E4M3:
      return launch<F8<__NV_E4M3>>(x, lens, out, b_len, t_len, d, mode, s);
    case kF8E5M2:
      return launch<F8<__NV_E5M2>>(x, lens, out, b_len, t_len, d, mode, s);
    case kF8E4M3Fnuz:
      return launch<Fnuz<4, 3>>(x, lens, out, b_len, t_len, d, mode, s);
    case kF8E5M2Fnuz:
      return launch<Fnuz<5, 2>>(x, lens, out, b_len, t_len, d, mode, s);
    case kI64:
      return launch<long long>(x, lens, out, b_len, t_len, d, mode, s);
    default:
      return cudaErrorInvalidValue;
  }
}
