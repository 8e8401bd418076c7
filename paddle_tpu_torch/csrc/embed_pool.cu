// Embedding gather + masked sum pool, written for Hopper (compiled for
// sm_90a) behind a plain C interface that ctypes loads.
//
// Replaces the Pallas TPU kernel of paddle_tpu/ops/pallas/embed_pool.py:
//   paddle_embed_pool <- fused_embed_seq_pool (:72; _embed_pool_impl :78,
//                        pallas_call :100, _embed_pool_kernel :35)
//
// w [V, D] (row-major, contiguous), ids [B, T] int32 and lens [B] int32
// (null: every t counts) give
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
// one row DMA ahead of the accumulate. Here one warp owns one output row b
// and its lanes lie across D in float4s (a 512-byte row of D 128 is one
// 16-byte load a lane); rows wider than 128 floats take more float4s a lane.
// A table of another type, or of a width that is not whole float4s, or not
// 16-byte aligned, is read one element a lane. The loop over t is unrolled 8
// deep: the warp reads 8 ids, then issues the 8 row loads before it adds
// any, so eight scattered rows are in flight at once where the TPU kept one.
// The adds stay in increasing t. Every D is taken. Blocks of 4 warps, grid
// ceil(B / 4).
//
// paddle_embed_pool launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() of its launch (0 = success;
// cudaErrorInvalidValue for a shape it does not take).

#include <cstdint>

#include "pool_elem.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kUnroll = 8;

__device__ __forceinline__ int clip_id(int id, int v) {
  return min(max(id, 0), v - 1);
}

// d columns of E a row
template <typename E>
__global__ void __launch_bounds__(32 * kWarps)
embed_pool_kernel(const E* __restrict__ w, const int* __restrict__ ids,
                  const int* __restrict__ lens, E* __restrict__ out,
                  int b_len, int t_len, int v, int d) {
  using P = Elem<E>;
  const int b = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (b >= b_len) return;
  const int n = lens ? min(max(lens[b], 0), t_len) : t_len;
  const int* idb = ids + static_cast<size_t>(b) * t_len;
  E* ob = out + static_cast<size_t>(b) * d;
  for (int c = lane; c < d; c += 32) {
    typename P::Acc acc{};
    int t = 0;
    for (; t + kUnroll <= n; t += kUnroll) {
      E r[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k)
        r[k] = P::load(w + static_cast<size_t>(clip_id(__ldg(idb + t + k), v))
                               * d + c);
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) acc = P::add(acc, P::widen(r[k]));
    }
    for (; t < n; ++t)
      acc = P::add(acc, P::widen(P::load(
          w + static_cast<size_t>(clip_id(__ldg(idb + t), v)) * d + c)));
    ob[c] = P::sum_out(acc);
  }
}

template <typename E>
int launch(const void* w, const int* ids, const int* lens, void* out,
           int b_len, int t_len, int v, int d, cudaStream_t s) {
  const int grid = (b_len + kWarps - 1) / kWarps;
  embed_pool_kernel<E><<<grid, 32 * kWarps, 0, s>>>(
      static_cast<const E*>(w), ids, lens, static_cast<E*>(out), b_len, t_len,
      v, d);
  return cudaGetLastError();
}

}  // namespace

// dtype: a PoolDtype code (pool_elem.cuh); out has w's type
extern "C" int paddle_embed_pool(const void* w, const int* ids,
                                 const int* lens, void* out, int b_len,
                                 int t_len, int v, int d, int dtype,
                                 void* stream) {
  if (b_len < 1 || t_len < 0 || v < 1 || d < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      if (d % 4 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0 &&
          (reinterpret_cast<uintptr_t>(out) & 15) == 0)
        return launch<float4>(w, ids, lens, out, b_len, t_len, v, d / 4, s);
      return launch<float>(w, ids, lens, out, b_len, t_len, v, d, s);
    case kF64:
      return launch<double>(w, ids, lens, out, b_len, t_len, v, d, s);
    case kF16:
      return launch<__half>(w, ids, lens, out, b_len, t_len, v, d, s);
    case kBF16:
      return launch<__nv_bfloat16>(w, ids, lens, out, b_len, t_len, v, d, s);
    case kF8E4M3:
      return launch<F8<__NV_E4M3>>(w, ids, lens, out, b_len, t_len, v, d, s);
    case kF8E5M2:
      return launch<F8<__NV_E5M2>>(w, ids, lens, out, b_len, t_len, v, d, s);
    case kF8E4M3Fnuz:
      return launch<Fnuz<4, 3>>(w, ids, lens, out, b_len, t_len, v, d, s);
    case kF8E5M2Fnuz:
      return launch<Fnuz<5, 2>>(w, ids, lens, out, b_len, t_len, v, d, s);
    case kI64:
      return launch<long long>(w, ids, lens, out, b_len, t_len, v, d, s);
    default:
      return cudaErrorInvalidValue;
  }
}
