// Element types of the pooling kernels (seqpool.cu, embed_pool.cu): how an
// element widens into its accumulator, and how a sum narrows back into the
// type that the plain PyTorch versions return for the same dtype.
//
//   element          accumulator   a pool gives
//   float4 (fp32 x4) float4        float4
//   float            float         float
//   double           double        double
//   __half           float         __half (rounded once)
//   __nv_bfloat16    float         __nv_bfloat16 (rounded once)
//   long long        long long     long long, SUM only
//   F8<E4M3>, F8<E5M2> float, rounded float8 (each partial sum rounded)
//
// Float8 (e4m3fn, e5m2) is summed in fp32 with every partial sum rounded to
// the float8 type, in t order: that is what the reference's float8 sum
// computes (XLA on the CPU accumulates in the element type), and an fp32 sum
// rounded once differs from it in about half of the elements. Its AVERAGE and
// SQRT divide by the length rounded to float8 (and its root rounded again),
// the quotient rounded once.
// Integers and bool reach the kernels widened to long long by the wrappers,
// as torch.sum widens them (unsigned ones as their bits, so that the sum is
// exact modulo 2^64); their AVERAGE and SQRT are the wrappers' true
// division of that sum by the length cast to x's own type, as the reference
// computes it. For the floats the divisor of AVERAGE and SQRT is max(n, 1)
// with n rounded to the element type first, and its square root rounded
// again, as the plain versions (and the JAX op's lens.astype(x.dtype))
// compute it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

// dtype codes shared with the Python wrappers
enum PoolDtype {
  kF32 = 0, kF64 = 1, kF16 = 2, kBF16 = 3, kI64 = 4, kF8E4M3 = 5, kF8E5M2 = 6
};

// A float8 element: its storage byte, tagged with its interpretation.
template <__nv_fp8_interpretation_t kKind>
struct F8 {
  __nv_fp8_storage_t bits;
};

template <typename E>
struct Elem;

// Elem<E>::load(p): one element through the read-only cache.

template <>
struct Elem<float4> {
  using Acc = float4;
  using Real = float;
  static constexpr bool kDivides = true;
  static __device__ __forceinline__ float4 load(const float4* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ float4 widen(float4 v) { return v; }
  static __device__ __forceinline__ float4 add(float4 a, float4 b) {
    return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  }
  static __device__ __forceinline__ float4 sum_out(float4 a) { return a; }
  static __device__ __forceinline__ float4 mean_out(float4 a, float c) {
    return make_float4(a.x / c, a.y / c, a.z / c, a.w / c);
  }
  static __device__ __forceinline__ float rounded(float c) { return c; }
};

template <>
struct Elem<float> {
  using Acc = float;
  using Real = float;
  static constexpr bool kDivides = true;
  static __device__ __forceinline__ float load(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ float widen(float v) { return v; }
  static __device__ __forceinline__ float add(float a, float b) {
    return a + b;
  }
  static __device__ __forceinline__ float sum_out(float a) { return a; }
  static __device__ __forceinline__ float mean_out(float a, float c) {
    return a / c;
  }
  static __device__ __forceinline__ float rounded(float c) { return c; }
};

template <>
struct Elem<double> {
  using Acc = double;
  using Real = double;
  static constexpr bool kDivides = true;
  static __device__ __forceinline__ double load(const double* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ double widen(double v) { return v; }
  static __device__ __forceinline__ double add(double a, double b) {
    return a + b;
  }
  static __device__ __forceinline__ double sum_out(double a) { return a; }
  static __device__ __forceinline__ double mean_out(double a, double c) {
    return a / c;
  }
  static __device__ __forceinline__ double rounded(double c) { return c; }
};

template <>
struct Elem<__half> {
  using Acc = float;
  using Real = float;
  static constexpr bool kDivides = true;
  static __device__ __forceinline__ __half load(const __half* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ float widen(__half v) {
    return __half2float(v);
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return a + b;
  }
  static __device__ __forceinline__ __half sum_out(float a) {
    return __float2half_rn(a);
  }
  static __device__ __forceinline__ __half mean_out(float a, float c) {
    return __float2half_rn(a / c);
  }
  static __device__ __forceinline__ float rounded(float c) {
    return __half2float(__float2half_rn(c));
  }
};

template <>
struct Elem<__nv_bfloat16> {
  using Acc = float;
  using Real = float;
  static constexpr bool kDivides = true;
  static __device__ __forceinline__ __nv_bfloat16 load(const __nv_bfloat16* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ float widen(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return a + b;
  }
  static __device__ __forceinline__ __nv_bfloat16 sum_out(float a) {
    return __float2bfloat16_rn(a);
  }
  static __device__ __forceinline__ __nv_bfloat16 mean_out(float a, float c) {
    return __float2bfloat16_rn(a / c);
  }
  static __device__ __forceinline__ float rounded(float c) {
    return __bfloat162float(__float2bfloat16_rn(c));
  }
};

template <>
struct Elem<long long> {
  using Acc = long long;
  static constexpr bool kDivides = false;
  static __device__ __forceinline__ long long load(const long long* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ long long widen(long long v) { return v; }
  static __device__ __forceinline__ long long add(long long a, long long b) {
    return a + b;
  }
  static __device__ __forceinline__ long long sum_out(long long a) {
    return a;
  }
};

template <__nv_fp8_interpretation_t kKind>
struct Elem<F8<kKind>> {
  using E = F8<kKind>;
  using Acc = float;
  using Real = float;
  static constexpr bool kDivides = true;
  static __device__ __forceinline__ E load(const E* p) {
    return E{__ldg(&p->bits)};
  }
  static __device__ __forceinline__ float value(__nv_fp8_storage_t b) {
    return __half2float(__half(__nv_cvt_fp8_to_halfraw(b, kKind)));
  }
  static __device__ __forceinline__ __nv_fp8_storage_t bits(float v) {
    return __nv_cvt_float_to_fp8(v, __NV_NOSAT, kKind);
  }
  static __device__ __forceinline__ float widen(E v) { return value(v.bits); }
  static __device__ __forceinline__ float add(float a, float b) {
    return value(bits(a + b));
  }
  static __device__ __forceinline__ E sum_out(float a) { return E{bits(a)}; }
  static __device__ __forceinline__ E mean_out(float a, float c) {
    return E{bits(a / c)};
  }
  static __device__ __forceinline__ float rounded(float c) {
    return value(bits(c));
  }
};
