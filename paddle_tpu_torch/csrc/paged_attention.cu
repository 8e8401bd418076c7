// Paged-KV row gathers for the serving decode step, written for Hopper
// (compiled for sm_90a) behind a plain C interface that ctypes loads.
//
// Replaces the two Pallas TPU kernels of
// paddle_tpu/ops/pallas/paged_attention.py:
//   paddle_gather_rows          <- gather_rows          (:78, _gather_kernel :48)
//   paddle_gather_rows_dequant  <- gather_rows_dequant  (:140,
//                                  _gather_dequant_kernel :103)
//
// What bounds them: device-memory bytes. gather_rows does no arithmetic and
// gather_rows_dequant one fp32 multiply per element, so the least time is
// (distinct pool rows read + row indices + output rows written) over the
// card's 3.35 TB/s. For one decode step's K (or V) gather at 4096 rows of
// 512 values that is at most ~16.8 MB (fp32, ~5.0 us) or ~10.6 MB (int8
// codes and fp32 scales read, fp32 written, ~3.2 us).
//
// Design: the TPU kernel moved one row per DMA, with the row ids
// scalar-prefetched into SMEM and a 2-slot DMA rotation to hide each row's
// latency. None of that carries over. On Hopper, latency is hidden by many
// loads in flight across many warps, and bandwidth is reached only with
// coalesced wide accesses. So a block covers a few output rows
// (threadIdx.y), each row's threads (threadIdx.x) read neighbouring 16-byte
// vectors of it, and every warp issues full 512-byte transactions. Each
// thread loads its own row id (the block's ids hit L1) and clamps it into
// [0, n_rows - 1]: page-table sentinels point at rows >= n_rows, and the
// attention mask zeroes whatever those rows hold. Nothing is carried
// between blocks. Rows whose byte width is not a multiple of 16 (or whose
// base is not 16-byte aligned) take the widest word that the width and the
// bases allow, 8 or 4 bytes (the hot-rows cache's 68-byte rows: 17 words),
// else single bytes.
//
// paddle_gather_rows is also the port of the hot-rows cache's gather
// (paddle_tpu/ops/pallas/embed_cache.py gather_rows, :58, pallas_call :79:
// cache[min(slot, R - 1)], the same function on the slots >= 0 that the
// cache issues; paddle_tpu_torch/ops/kernels/embed_cache.py launches it).
//
// Both functions launch on the caller's stream, allocate nothing, do not
// synchronise, and return cudaGetLastError() of the launch (0 = success).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ long long clamp_row(int r, long long n_rows) {
  long long v = r;
  return v < 0 ? 0 : (v >= n_rows ? n_rows - 1 : v);
}

// out[k, :] = pool[clamp(rows[k]), :], copied as words of type V.
template <typename V>
__global__ void gather_rows_kernel(const V* __restrict__ pool,
                                   long long n_rows, long long vecs_per_row,
                                   const int* __restrict__ rows,
                                   long long n_out, V* __restrict__ out) {
  const long long k = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (k >= n_out) return;
  const long long r = clamp_row(rows[k], n_rows);
  const V* src = pool + r * vecs_per_row;
  V* dst = out + k * vecs_per_row;
  for (long long v = threadIdx.x; v < vecs_per_row; v += blockDim.x) {
    dst[v] = src[v];
  }
}

// out[k, c] = float(codes[r, c]) * scales[r, c / head_dim], r = clamp(rows[k]).
// Each thread takes 16 codes (one 16-byte load) that lie inside one head,
// reads that head's scale once, and writes 16 floats as four float4 stores.
__global__ void gather_rows_dequant_vec16(
    const int8_t* __restrict__ codes, const float* __restrict__ scales,
    long long n_rows, int width, int heads, int head_dim,
    const int* __restrict__ rows, long long n_out, float* __restrict__ out) {
  const long long k = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (k >= n_out) return;
  const long long r = clamp_row(rows[k], n_rows);
  const int groups = width / 16;
  const int8_t* src = codes + r * width;
  const float* scl = scales + r * heads;
  float* dst = out + k * width;
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const int c0 = g * 16;
    const float s = scl[c0 / head_dim];
    const int4 raw = *reinterpret_cast<const int4*>(src + c0);
    const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
    float4* d4 = reinterpret_cast<float4*>(dst + c0);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      d4[q] = make_float4(__fmul_rn(static_cast<float>(b[4 * q + 0]), s),
                          __fmul_rn(static_cast<float>(b[4 * q + 1]), s),
                          __fmul_rn(static_cast<float>(b[4 * q + 2]), s),
                          __fmul_rn(static_cast<float>(b[4 * q + 3]), s));
    }
  }
}

// Scalar path: one element per thread step, any head width.
__global__ void gather_rows_dequant_scalar(
    const int8_t* __restrict__ codes, const float* __restrict__ scales,
    long long n_rows, int width, int heads, int head_dim,
    const int* __restrict__ rows, long long n_out, float* __restrict__ out) {
  const long long k = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (k >= n_out) return;
  const long long r = clamp_row(rows[k], n_rows);
  const int8_t* src = codes + r * width;
  const float* scl = scales + r * heads;
  float* dst = out + k * width;
  for (int c = threadIdx.x; c < width; c += blockDim.x) {
    dst[c] = __fmul_rn(static_cast<float>(src[c]), scl[c / head_dim]);
  }
}

// Block shape for rows of `units` vectors: x covers one row (a whole number
// of warps, at most kThreads), y stacks rows so a block has kThreads threads.
dim3 block_for(long long units) {
  long long x = (units + 31) / 32 * 32;
  if (x > kThreads) x = kThreads;
  if (x < 32) x = 32;
  return dim3(static_cast<unsigned>(x), static_cast<unsigned>(kThreads / x));
}

template <typename V>
void launch_gather(const void* pool, long long n_rows, long long row_bytes,
                   const int* rows, long long n_out, void* out,
                   cudaStream_t stream) {
  const long long vecs = row_bytes / static_cast<long long>(sizeof(V));
  const dim3 block = block_for(vecs);
  const dim3 grid(static_cast<unsigned>((n_out + block.y - 1) / block.y));
  gather_rows_kernel<V><<<grid, block, 0, stream>>>(
      static_cast<const V*>(pool), n_rows, vecs, rows, n_out,
      static_cast<V*>(out));
}

bool aligned(const void* p, long long a) {
  return reinterpret_cast<std::uintptr_t>(p) % a == 0;
}

}  // namespace

extern "C" int paddle_gather_rows(const void* pool, long long n_rows,
                                  long long row_bytes, const int* rows,
                                  long long n_out, void* out, void* stream) {
  if (n_out <= 0 || row_bytes <= 0) return cudaSuccess;
  if (n_rows <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (row_bytes % 16 == 0 && aligned(pool, 16) && aligned(out, 16)) {
    launch_gather<uint4>(pool, n_rows, row_bytes, rows, n_out, out, s);
  } else if (row_bytes % 8 == 0 && aligned(pool, 8) && aligned(out, 8)) {
    launch_gather<uint2>(pool, n_rows, row_bytes, rows, n_out, out, s);
  } else if (row_bytes % 4 == 0 && aligned(pool, 4) && aligned(out, 4)) {
    launch_gather<uint32_t>(pool, n_rows, row_bytes, rows, n_out, out, s);
  } else {
    launch_gather<uint8_t>(pool, n_rows, row_bytes, rows, n_out, out, s);
  }
  return cudaGetLastError();
}

extern "C" int paddle_gather_rows_dequant(const int8_t* codes,
                                          const float* scales,
                                          long long n_rows, int width,
                                          int heads, const int* rows,
                                          long long n_out, float* out,
                                          void* stream) {
  if (n_out <= 0 || width <= 0) return cudaSuccess;
  if (n_rows <= 0 || heads <= 0 || width % heads) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int head_dim = width / heads;
  if (head_dim % 16 == 0 && aligned(codes, 16) && aligned(out, 16)) {
    const dim3 block = block_for(width / 16);
    const dim3 grid(static_cast<unsigned>((n_out + block.y - 1) / block.y));
    gather_rows_dequant_vec16<<<grid, block, 0, s>>>(
        codes, scales, n_rows, width, heads, head_dim, rows, n_out, out);
  } else {
    const dim3 block = block_for(width);
    const dim3 grid(static_cast<unsigned>((n_out + block.y - 1) / block.y));
    gather_rows_dequant_scalar<<<grid, block, 0, s>>>(
        codes, scales, n_rows, width, heads, head_dim, rows, n_out, out);
  }
  return cudaGetLastError();
}
