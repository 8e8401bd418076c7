// Embedding gather + masked sum pool, written for Hopper (compiled for
// sm_90a) behind a plain C interface that ctypes loads.
//
// Replaces the Pallas TPU kernel of paddle_tpu/ops/pallas/embed_pool.py:
//   paddle_embed_pool <- fused_embed_seq_pool (:72; _embed_pool_impl :78,
//                        pallas_call :100, _embed_pool_kernel :35)
//
// w [V, D] (row-major, contiguous), ids [B, T] and lens [B] (null: every t
// counts), each int32 or int64 as the caller holds them, give
//   out[b] = sum_{t < lens[b]} w[clip(ids[b, t], 0, V - 1)]      [B, D],
// summed in increasing t; the [B, T, D] gathered rows never exist. w may be
// fp32, fp64, fp16, bf16 or int64; the sum is fp32 (fp64 for double, int64
// for integers) and out has w's type (pool_elem.cuh). The TPU kernel takes
// fp32 only, the JAX op's composed branch every dtype. The clip is the TPU
// kernel's (:81): an id below 0 reads row 0, one above V - 1 row V - 1 (the
// JAX op's composed branch, w[ids], would wrap a negative id instead). There
// is no backward kernel: training takes the row-sparse gradient of the op
// (paddle_tpu/ops/grad_ops.py:72-85), built in torch.
//
// What bounds it: bytes, and the latency of scattered rows. It must read
// each distinct row of w that a live position (b, t < lens[b]) names once
// (a row named again comes from L2), the live ids and lens, and write
// [B, D]: at the op program's shape (V 5000, D 128, B 128, T 100, about half
// the positions live, ids uniform over the table) about 3.8k distinct rows,
// some 2 MB, about 0.6 us at 3.35 TB/s.
//
// Design. The TPU kernel walks (b, t) in order on one core and double-buffers
// one row DMA ahead of the accumulate. Here a block of W warps (the wrapper's
// plan: W = min(8, ceil(T / 12)), so that no warp walks more than ~13 ids at
// T 100) owns one output row b and one stripe of 32 column units of it, its
// lanes lying across D in float4s (a 512-byte row of D 128 is one 16-byte
// load a lane and one stripe); a table of another type, or of a width that
// is not whole float4s, or not 16-byte aligned, is read one element a lane,
// in stripes of 32 elements. The grid is (B, stripes): 128 blocks of 8 warps
// at the op program's shape, where one warp a row and 4 warps a block gave 32
// blocks on 132 SMs and left the longest row to set the time.
//   Warp k of the block takes the contiguous chunk [k c, (k + 1) c) of t,
// c = ceil(T / W), cut at lens[b]. It reads its chunk's ids with one
// coalesced load (a lane an id, 32 at most a load) issued beside the load
// of lens[b], and hands them round with __shfl_sync, so that no row load
// waits behind an id load: up to 16 rows of the chunk are in flight at once,
// then added in increasing t. (The chunks depend on T only: a row's time is
// the latency of one id load and one round of row loads either way, and
// the ids need not wait for the length.) The W partial sums go through
// shared memory and warp 0 adds them in warp order: the result is
// deterministic, two runs give the same bits, and it is an fp32 (fp64,
// int64) sum of the same terms in another order than the plain version's.
//   Float8 (e4m3fn, e5m2, e4m3fnuz, e5m2fnuz) rounds every partial sum to its
// type, in t order (pool_elem.cuh), so its instantiations take W = 1: one warp
// walks the whole row in t order, its ids still loaded 32 ahead.
//
// paddle_embed_pool launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() of its launch (0 = success;
// cudaErrorInvalidValue for a shape or plan it does not take).

#include <cstdint>

#include "pool_elem.cuh"

namespace {

constexpr int kMaxWarps = 8;
constexpr int kInFlight = 16;              // row loads issued before the adds

// an id clipped into [0, V): int32 or int64 ids
template <typename I>
__device__ __forceinline__ int clip_id(I id, int v) {
  return static_cast<int>(min(max(id, static_cast<I>(0)),
                              static_cast<I>(v - 1)));
}

// d column units of E a row; blockDim.x = 32 * warps; lens int32 or, with
// lens64, int64
template <typename E, typename I>
__global__ void __launch_bounds__(32 * kMaxWarps)
embed_pool_kernel(const E* __restrict__ w, const I* __restrict__ ids,
                  const void* __restrict__ lens, int lens64,
                  E* __restrict__ out, int t_len, int v, int d) {
  using P = Elem<E>;
  using Acc = typename P::Acc;
  __shared__ Acc part[kMaxWarps][32];
  const int b = blockIdx.x, warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = blockIdx.y * 32 + lane;
  const bool col = c < d;
  // the warp's chunk of t depends on T alone, so that its first ids load
  // beside the row's length rather than after it
  const int chunk = (t_len + warps - 1) / warps;
  const int t_begin = warp * chunk, t_stop = min(t_len, t_begin + chunk);
  const I* idb = ids + static_cast<size_t>(b) * t_len;
  I first = 0;
  if (t_begin + lane < t_stop) first = __ldg(idb + t_begin + lane);
  long long len = t_len;
  if (lens)
    len = lens64 ? __ldg(static_cast<const long long*>(lens) + b)
                 : __ldg(static_cast<const int*>(lens) + b);
  const int t_end = min(t_stop, static_cast<int>(min(max(len, 0ll),
      static_cast<long long>(t_len))));
  const E* wc = w + c;
  Acc acc{};
  for (int t0 = t_begin; t0 < t_end; t0 += 32) {
    const int cnt = min(32, t_end - t0);
    const I raw = t0 == t_begin ? first
        : (lane < cnt ? __ldg(idb + t0 + lane) : static_cast<I>(0));
    const int my_id = lane < cnt ? clip_id(raw, v) : 0;
    for (int k = 0; k < cnt; k += kInFlight) {
      E r[kInFlight];
#pragma unroll
      for (int j = 0; j < kInFlight; ++j) {
        const int id = __shfl_sync(0xffffffffu, my_id, (k + j) & 31);
        if (col && k + j < cnt)
          r[j] = P::load(wc + static_cast<size_t>(id) * d);
      }
#pragma unroll
      for (int j = 0; j < kInFlight; ++j)
        if (col && k + j < cnt) acc = P::add(acc, P::widen(r[j]));
    }
  }
  E* ob = out + static_cast<size_t>(b) * d;
  if (warps == 1) {
    if (col) ob[c] = P::sum_out(acc);
    return;
  }
  part[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && col) {
    Acc sum = part[0][lane];
    for (int k = 1; k < warps; ++k) sum = P::add(sum, part[k][lane]);
    ob[c] = P::sum_out(sum);
  }
}

// the pointers and sizes of one call
struct Call {
  const void* w;
  const void* ids;
  int ids64;
  const void* lens;
  int lens64;
  void* out;
  int b_len, t_len, v, warps;
  cudaStream_t s;
};

template <typename E>
int launch(const Call& c, int d) {
  if (c.warps < 1 || c.warps > kMaxWarps ||
      (Ordered<E>::value && c.warps != 1))
    return cudaErrorInvalidValue;
  const dim3 grid(c.b_len, (d + 31) / 32);
  const E* w = static_cast<const E*>(c.w);
  E* out = static_cast<E*>(c.out);
  if (c.ids64)
    embed_pool_kernel<E, long long><<<grid, 32 * c.warps, 0, c.s>>>(
        w, static_cast<const long long*>(c.ids), c.lens, c.lens64, out,
        c.t_len, c.v, d);
  else
    embed_pool_kernel<E, int><<<grid, 32 * c.warps, 0, c.s>>>(
        w, static_cast<const int*>(c.ids), c.lens, c.lens64, out, c.t_len,
        c.v, d);
  return cudaGetLastError();
}

}  // namespace

// dtype: a PoolDtype code (pool_elem.cuh); out has w's type; ids64 /
// lens64: the ids / lengths are int64 (else int32); warps: the warps that
// share one row (1 for float8, which sums in t order)
extern "C" int paddle_embed_pool(const void* w, const void* ids, int ids64,
                                 const void* lens, int lens64, void* out,
                                 int b_len, int t_len, int v, int d,
                                 int dtype, int warps, void* stream) {
  if (b_len < 1 || t_len < 0 || v < 1 || d < 1) return cudaErrorInvalidValue;
  const Call c{w,     ids,   ids64, lens, lens64, out,
               b_len, t_len, v,     warps, static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case kF32:
      if (d % 4 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0 &&
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
