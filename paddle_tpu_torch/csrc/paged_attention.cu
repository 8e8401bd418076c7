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
// bases allow, 8 or 4 bytes, else single bytes. gather_rows_dequant has a design of its own (at
// gather_rows_dequant_kernel: two rows a warp, every load in flight
// before the first store), and a scalar kernel for head widths that are
// not a multiple of 4.
//
// The hot-rows cache's gather (paddle_tpu/ops/pallas/embed_cache.py
// gather_rows, :58) computes the same function on the slots >= 0 that the
// cache issues, but has a kernel of its own, which moves every family of
// the cache in one launch (paddle_tpu_torch/csrc/embed_cache.cu).
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

// out[k, c] = float(codes[r, c]) * scales[r, c / head_dim], r = clamp(rows[k]),
// for head widths that are a multiple of 4 (codes 4-byte and out 16-byte
// aligned). At the decode step's shape (4096 rows of 512 codes and 8
// scales) the kernel is a chain of three dependent memory round trips (row
// id, then codes and scale, then the 8.4 MB of fp32 stores), so it is
// built to have every row's loads in flight before any store and to keep
// the stores wide and coalesced:
//   * a warp takes kDqRows rows at a time: lane i < kDqRows loads row id i
//     (one coalesced load) and the ids reach the other lanes by shuffles;
//   * then, for every row and every 128 codes of it, each lane issues its
//     4-byte load of 4 codes (a warp: 128 contiguous bytes) and the scale of
//     their head, all before the first store;
//   * then each lane stores its 4 dequantized values of each as one float4,
//     a warp 512 contiguous bytes a store;
//   * the grid is one wave at most (the SMs times the blocks an SM holds,
//     asked once per device), warps striding over the rows.
// Rows past the pool take the last row; nothing is carried between warps.
// rows a warp has in flight: two (at the decode shape four rows a warp
// and eight were slower on an H100: fewer warps issue the stores)
constexpr int kDqRows = 2;
constexpr int kDqCols = 512;               // codes of a row a warp loads at once

__global__ void __launch_bounds__(kThreads)
gather_rows_dequant_kernel(const int8_t* __restrict__ codes,
                           const float* __restrict__ scales,
                           long long n_rows, int width, int heads,
                           int head_dim, const int* __restrict__ rows,
                           long long n_out, float* __restrict__ out) {
  constexpr int kQ = kDqCols / 128;        // 4 codes a lane, 128 a warp
  const int lane = threadIdx.x % 32;
  const long long warps =
      static_cast<long long>(gridDim.x) * (kThreads / 32);
  const long long warp =
      static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  for (long long k0 = warp * kDqRows; k0 < n_out; k0 += warps * kDqRows) {
    long long mine = 0;
    if (lane < kDqRows && k0 + lane < n_out)
      mine = clamp_row(rows[k0 + lane], n_rows);
    long long r[kDqRows];
#pragma unroll
    for (int i = 0; i < kDqRows; ++i) r[i] = __shfl_sync(0xffffffffu, mine, i);
    for (int c0 = 0; c0 < width; c0 += kDqCols) {
      int raw[kDqRows][kQ];
      float sc[kDqRows][kQ];
#pragma unroll
      for (int i = 0; i < kDqRows; ++i)
#pragma unroll
        for (int qq = 0; qq < kQ; ++qq) {
          const int c = c0 + 128 * qq + 4 * lane;
          raw[i][qq] = 0;
          sc[i][qq] = 0.f;
          if (k0 + i < n_out && c < width) {
            raw[i][qq] = __ldg(reinterpret_cast<const int*>(
                codes + r[i] * width + c));
            sc[i][qq] = __ldg(scales + r[i] * heads + c / head_dim);
          }
        }
#pragma unroll
      for (int i = 0; i < kDqRows; ++i)
#pragma unroll
        for (int qq = 0; qq < kQ; ++qq) {
          const int c = c0 + 128 * qq + 4 * lane;
          if (k0 + i >= n_out || c >= width) continue;
          const int8_t* b = reinterpret_cast<const int8_t*>(&raw[i][qq]);
          const float s = sc[i][qq];
          *reinterpret_cast<float4*>(out + (k0 + i) * width + c) =
              make_float4(__fmul_rn(static_cast<float>(b[0]), s),
                          __fmul_rn(static_cast<float>(b[1]), s),
                          __fmul_rn(static_cast<float>(b[2]), s),
                          __fmul_rn(static_cast<float>(b[3]), s));
        }
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

// The blocks of gather_rows_dequant_kernel that the current card holds at
// once (its SMs times the blocks an SM holds), asked once per device.
cudaError_t dequant_wave(int* wave) {
  static int cached[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && cached[dev] > 0) {
    *wave = cached[dev];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, gather_rows_dequant_kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  *wave = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < 64) cached[dev] = *wave;
  return cudaSuccess;
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
  if (head_dim % 4 == 0 && aligned(codes, 4) && aligned(out, 16)) {
    int wave = 0;
    const cudaError_t err = dequant_wave(&wave);
    if (err != cudaSuccess) return err;
    const long long per_block = (kThreads / 32) * kDqRows;
    const long long need = (n_out + per_block - 1) / per_block;
    const unsigned grid = static_cast<unsigned>(need < wave ? need : wave);
    gather_rows_dequant_kernel<<<grid, kThreads, 0, s>>>(
        codes, scales, n_rows, width, heads, head_dim, rows, n_out, out);
  } else {
    const dim3 block = block_for(width);
    const dim3 grid(static_cast<unsigned>((n_out + block.y - 1) / block.y));
    gather_rows_dequant_scalar<<<grid, block, 0, s>>>(
        codes, scales, n_rows, width, heads, head_dim, rows, n_out, out);
  }
  return cudaGetLastError();
}
