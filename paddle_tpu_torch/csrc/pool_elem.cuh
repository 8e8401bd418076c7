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
//   Fnuz<4, 3>, Fnuz<5, 2> the same, for float8 e4m3fnuz and e5m2fnuz
//
// Float8 (e4m3fn, e5m2, e4m3fnuz, e5m2fnuz) is summed in fp32 with every partial sum rounded to
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
  kF32 = 0, kF64 = 1, kF16 = 2, kBF16 = 3, kI64 = 4, kF8E4M3 = 5, kF8E5M2 = 6,
  kF8E4M3Fnuz = 7, kF8E5M2Fnuz = 8
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

// Float8 with E exponent and M mantissa bits, exponent bias 2^(E - 1), no
// infinities and no negative zero: e4m3fnuz (Fnuz<4, 3>, largest 240) and
// e5m2fnuz (Fnuz<5, 2>, largest 57344). 0x80 is the one NaN. cuda_fp8.h has
// no conversions for them; these round as torch's (and ml_dtypes', the
// reference's) CPU conversion does: to nearest on the type's grid, ties to
// even; a value that rounds past the largest finite one, an infinity or a
// NaN gives the NaN; a value that rounds to zero gives +0.
template <int E, int M>
struct Fnuz {
  unsigned char bits;
};

template <int E, int M>
struct Elem<Fnuz<E, M>> {
  using X = Fnuz<E, M>;
  using Acc = float;
  using Real = float;
  static constexpr bool kDivides = true;
  static constexpr int kBias = 1 << (E - 1);
  static constexpr int kTopExp = (1 << E) - 1;  // every exponent is finite
  static __device__ __forceinline__ X load(const X* p) {
    return X{__ldg(&p->bits)};
  }
  static __device__ __forceinline__ float value(unsigned char b) {
    if (b == 0x80) return __int_as_float(0x7fc00000);
    const int e = (b >> M) & kTopExp, m = b & ((1 << M) - 1);
    const float mag = e == 0 ? ldexpf(static_cast<float>(m), 1 - kBias - M)
                             : ldexpf(static_cast<float>(m + (1 << M)),
                                      e - kBias - M);
    return (b & 0x80) ? -mag : mag;
  }
  static __device__ __forceinline__ unsigned char bits(float v) {
    if (!isfinite(v)) return 0x80;
    const float a = fabsf(v);
    if (a == 0.f) return 0;
    int e;
    frexpf(a, &e);
    e -= 1;                                 // a in [2^e, 2^(e + 1))
    const bool sub = e < 1 - kBias;         // below the least normal
    const int step = (sub ? 1 - kBias : e) - M;  // the grid: 2^step
    const int q = static_cast<int>(rintf(ldexpf(a, -step)));  // <= 2^(M+1)
    if (q == 0) return 0;
    int be, bm;
    if (sub) {           // q <= 2^M; 2^M is the least normal
      be = q >> M;
      bm = q & ((1 << M) - 1);
    } else if (q == (2 << M)) {  // rounded up into the next binade
      be = e + 1 + kBias;
      bm = 0;
    } else {
      be = e + kBias;
      bm = q - (1 << M);
    }
    if (be > kTopExp) return 0x80;
    return static_cast<unsigned char>((v < 0.f ? 0x80 : 0) | (be << M) | bm);
  }
  static __device__ __forceinline__ float widen(X v) { return value(v.bits); }
  static __device__ __forceinline__ float add(float a, float b) {
    return value(bits(a + b));
  }
  static __device__ __forceinline__ X sum_out(float a) { return X{bits(a)}; }
  static __device__ __forceinline__ X mean_out(float a, float c) {
    return X{bits(a / c)};
  }
  static __device__ __forceinline__ float rounded(float c) {
    return value(bits(c));
  }
};

// Float8 sums round every partial sum, so their order is part of the
// result: the kernels walk such a pool in t order on one warp (W = 1).
template <typename E>
struct Ordered {
  static constexpr bool value = false;
};
template <__nv_fp8_interpretation_t K>
struct Ordered<F8<K>> {
  static constexpr bool value = true;
};
template <int E, int M>
struct Ordered<Fnuz<E, M>> {
  static constexpr bool value = true;
};
