// The install of the hot-rows embedding cache: rows scattered into their
// slots of the cache tensor, in place, written for Hopper (compiled for
// sm_90a) behind a plain C interface that ctypes loads.
//
// Replaces the Pallas TPU kernel of paddle_tpu/ops/pallas/embed_cache.py:
//   paddle_scatter_rows <- scatter_rows (:110, pallas_call :133,
//                          _scatter_kernel :89)
// Its pair, gather_rows (:58, pallas_call :79), is paged_attention.cu's
// paddle_gather_rows: for the slots the cache issues (>= 0) both read
// cache[min(slot, R - 1)], so the port keeps one gather kernel.
//
// cache [R, W] (row-major, contiguous, any element type: the kernel copies
// bytes), slots [K] int32, rows [K, W]: cache[slots[k]] = rows[k] for every
// k with 0 <= slots[k] < R; every other slot is dropped, as the TPU kernel
// drops slots >= R (its docstring, :111-114; its guard is slot < cap, and a
// negative slot would write row 0 there). The cache pads each install to a
// power-of-two bucket with slot R + 1, so the drop path runs on every
// install. Duplicate in-range slots within one call are outside the
// contract: the TPU kernel writes them in k order, while XLA's
// .at[].set and index_copy_ leave their order unspecified. The cache never
// issues duplicates (its install slots are distinct pops of its free list),
// so the kernel pays for no sort and the last writer of such a slot is
// whichever block runs last.
//
// What bounds it: bytes. It reads the K slots and the K rows and writes the
// rows it keeps: for deepfm's cache (W 17 floats, 68-byte rows) at K 8192
// about 1.1 MB, 0.3 us at 3.35 TB/s.
//
// Design. The TPU kernel moved one row per DMA, HBM to HBM, with the slots
// scalar-prefetched into SMEM and the cache aliased to the output
// (input_output_aliases={2: 0}). Here the write goes through the cache
// tensor's own pointer: nothing is copied or allocated. A block covers a few
// rows (threadIdx.y), each row's threads (threadIdx.x) copy neighbouring
// words of it, in the widest word that the row's byte width and both bases
// allow: 16, 8 or 4 bytes, else single bytes. deepfm's 68-byte rows take
// the 4-byte path: 17 words, one warp a row. Each thread loads its own slot
// (the block's slots hit L1). Nothing is carried between blocks.
//
// paddle_scatter_rows launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() of its launch (0 =
// success).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// cache[slots[k], :] = rows[k, :] for 0 <= slots[k] < n_rows, as words V
template <typename V>
__global__ void scatter_rows_kernel(V* __restrict__ cache, long long n_rows,
                                    long long words_per_row,
                                    const int* __restrict__ slots,
                                    long long n_in,
                                    const V* __restrict__ rows) {
  const long long k = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (k >= n_in) return;
  const long long slot = slots[k];
  if (slot < 0 || slot >= n_rows) return;          // dropped
  const V* src = rows + k * words_per_row;
  V* dst = cache + slot * words_per_row;
  for (long long v = threadIdx.x; v < words_per_row; v += blockDim.x) {
    dst[v] = src[v];
  }
}

// x covers one row (a whole number of warps, at most kThreads), y stacks
// rows so that a block has kThreads threads
dim3 block_for(long long words) {
  long long x = (words + 31) / 32 * 32;
  if (x > kThreads) x = kThreads;
  if (x < 32) x = 32;
  return dim3(static_cast<unsigned>(x), static_cast<unsigned>(kThreads / x));
}

template <typename V>
void launch_scatter(void* cache, long long n_rows, long long row_bytes,
                    const int* slots, long long n_in, const void* rows,
                    cudaStream_t s) {
  const long long words = row_bytes / static_cast<long long>(sizeof(V));
  const dim3 block = block_for(words);
  const dim3 grid(static_cast<unsigned>((n_in + block.y - 1) / block.y));
  scatter_rows_kernel<V><<<grid, block, 0, s>>>(
      static_cast<V*>(cache), n_rows, words, slots, n_in,
      static_cast<const V*>(rows));
}

bool fits(long long row_bytes, const void* a, const void* b, long long w) {
  return row_bytes % w == 0 && reinterpret_cast<std::uintptr_t>(a) % w == 0 &&
         reinterpret_cast<std::uintptr_t>(b) % w == 0;
}

}  // namespace

extern "C" int paddle_scatter_rows(void* cache, long long n_rows,
                                   long long row_bytes, const int* slots,
                                   long long n_in, const void* rows,
                                   void* stream) {
  if (n_in <= 0 || row_bytes <= 0 || n_rows <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fits(row_bytes, cache, rows, 16)) {
    launch_scatter<uint4>(cache, n_rows, row_bytes, slots, n_in, rows, s);
  } else if (fits(row_bytes, cache, rows, 8)) {
    launch_scatter<uint2>(cache, n_rows, row_bytes, slots, n_in, rows, s);
  } else if (fits(row_bytes, cache, rows, 4)) {
    launch_scatter<uint32_t>(cache, n_rows, row_bytes, slots, n_in, rows, s);
  } else {
    launch_scatter<uint8_t>(cache, n_rows, row_bytes, slots, n_in, rows, s);
  }
  return cudaGetLastError();
}
