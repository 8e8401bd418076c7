// The hot-rows embedding cache's row gather and in-place row scatter, over
// all of the cache's families (the table and its row-aligned optimizer
// state) in one launch, written for Hopper (compiled for sm_90a) behind a
// plain C interface that ctypes loads.
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas/embed_cache.py,
// which the JAX cache calls once per family:
//   paddle_cache_gather  <- gather_rows  (:58, pallas_call :79,
//                           _gather_kernel :38)
//   paddle_cache_scatter <- scatter_rows (:110, pallas_call :133,
//                           _scatter_kernel :88)
//
// F families (1 <= F <= 4), each [R, W] (row-major, contiguous, one element
// type: the kernels copy bytes), share one slot list [K] int32; rows go in
// or come out as one [F, K, W] buffer:
//   gather:  out[f, k] = cache_f[clamp(slots[k], 0, R - 1)];
//   scatter: cache_f[slots[k]] = rows[f, k] for 0 <= slots[k] < R, in
//            place; every other slot is dropped.
// On the slots >= 0 that the cache issues, each is the TPU kernel's function
// on each family. On a negative slot the JAX package's tiers disagree; the
// gather clamps it to row 0 and the scatter drops it, as the TPU kernel's
// docstring (:111-114) says. The cache pads each install to a power-of-two
// bucket with slot R + 1 and each read with its pad slot R - 1, so the drop
// and the clamp run on every call. Duplicate in-range scatter slots are
// outside the contract (the TPU kernel writes them in k order; XLA's
// .at[].set and index_copy_ leave their order unspecified); the cache never
// issues them, so the kernel pays for no sort.
//
// What bounds them: bytes. Each reads the K slots and F x K rows and writes
// F x K rows (the scatter only those it keeps): for deepfm's cache (W 17
// floats, 68-byte rows, F 3) at K 8192, 3.4 MB, 1.0 us at 3.35 TB/s. At
// these sizes the time is the launch and a chain of dependent memory round
// trips, not the bytes.
//
// Design. The TPU kernels moved one row per DMA, HBM to HBM, with the slots
// scalar-prefetched into SMEM; the JAX cache runs one pallas_call per
// family, so an install or a write-back is F such chains in a row. Here:
//   * one launch moves a row of every family per slot: the F base pointers
//     travel by value in the kernel's parameters (Families), so nothing is
//     allocated on the device;
//   * the (row, word) plane [K, W / word] is flattened, so a warp covers 32
//     consecutive words: every lane is busy at deepfm's 17-word rows, and
//     the gather's stores and the scatter's reads of rows are coalesced
//     runs;
//   * each thread reads its row's slot once and uses it for all F
//     families, with every family's load in flight before the first store:
//     an install or a write-back is one dependency chain (slot, then the F
//     rows, then the F stores; the scatter's row loads do not wait for the
//     slot), not F chains one after another;
//   * words are the widest that the row's byte width and every base allow:
//     16, 8 or 4 bytes, else single bytes;
//   * the grid is one wave at most (the SMs times the blocks an SM holds,
//     asked once per device), threads striding over the plane.
// Nothing is carried between threads. The cache's tensors are written only
// by the scatter, whose reads are of `rows` and `slots` alone.
//
// Every function launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() of its launch (0 =
// success).

#include <cstdint>
#include <initializer_list>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxFamilies = 4;

// the families' base pointers, passed by value
struct Families {
  char* base[kMaxFamilies];
};

// the row of word e of the plane
__device__ __forceinline__ long long row_of(long long e, long long words) {
  return e / words;
}

// the slot of row k (all lanes of the warp call it together)
__device__ __forceinline__ int slot_of(const int* __restrict__ slots,
                                       long long k, bool live) {
  return live ? __ldg(slots + k) : 0;
}

// out[f, k, v] = cache_f[clamp(slots[k]), v] for f < F, as words V
template <typename V, int F>
__global__ void __launch_bounds__(kThreads)
cache_gather_kernel(Families caches, long long n_rows, long long words,
                    const int* __restrict__ slots, long long n_slots,
                    V* __restrict__ out) {
  const long long total = n_slots * words;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  // e0 is the first word of the thread's warp: the loop is warp-uniform
  for (long long e0 = static_cast<long long>(blockIdx.x) * kThreads +
                      (threadIdx.x & ~31u);
       e0 < total; e0 += stride) {
    const long long e = e0 + (threadIdx.x & 31u);
    const bool live = e < total;
    const long long k = live ? row_of(e, words) : 0;
    const int s = slot_of(slots, k, live);
    if (!live) continue;
    const long long r = s < 0 ? 0 : (s >= n_rows ? n_rows - 1 : s);
    const long long at = r * words + (e - k * words);
    V word[F];
#pragma unroll
    for (int f = 0; f < F; ++f)
      word[f] = __ldg(reinterpret_cast<const V*>(caches.base[f]) + at);
#pragma unroll
    for (int f = 0; f < F; ++f) out[f * total + e] = word[f];
  }
}

// cache_f[slots[k], v] = rows[f, k, v] for f < F and 0 <= slots[k] < n_rows,
// as words V
template <typename V, int F>
__global__ void __launch_bounds__(kThreads)
cache_scatter_kernel(Families caches, long long n_rows, long long words,
                     const int* __restrict__ slots, long long n_slots,
                     const V* __restrict__ rows) {
  const long long total = n_slots * words;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long e0 = static_cast<long long>(blockIdx.x) * kThreads +
                      (threadIdx.x & ~31u);
       e0 < total; e0 += stride) {
    const long long e = e0 + (threadIdx.x & 31u);
    const bool live = e < total;
    const long long k = live ? row_of(e, words) : 0;
    const int s = slot_of(slots, k, live);
    if (!live) continue;
    V word[F];
#pragma unroll
    for (int f = 0; f < F; ++f) word[f] = __ldg(rows + f * total + e);
    if (s < 0 || s >= n_rows) continue;              // dropped
    const long long at = static_cast<long long>(s) * words + (e - k * words);
#pragma unroll
    for (int f = 0; f < F; ++f)
      reinterpret_cast<V*>(caches.base[f])[at] = word[f];
  }
}

// The blocks that the current card holds at once (its SMs times the blocks
// an SM holds of the widest instantiations), asked once per device.
cudaError_t wave(int* blocks) {
  static int cached[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && cached[dev] > 0) {
    *blocks = cached[dev];
    return cudaSuccess;
  }
  int sms = 0, gather = 0, scatter = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &gather, cache_gather_kernel<uint4, kMaxFamilies>, kThreads, 0);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &scatter, cache_scatter_kernel<uint4, kMaxFamilies>, kThreads, 0);
  if (err != cudaSuccess) return err;
  const int per_sm = gather < scatter ? gather : scatter;
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < 64) cached[dev] = *blocks;
  return cudaSuccess;
}

// The word width (bytes) and the grid of a call.
struct Plan {
  int word;
  unsigned blocks;
};

cudaError_t plan(const void* const* bases, int n_families, const void* rows,
                 long long row_bytes, long long n_slots, Plan* p) {
  p->word = 1;
  for (int w : {16, 8, 4}) {
    bool fits = row_bytes % w == 0 &&
                reinterpret_cast<std::uintptr_t>(rows) % w == 0;
    for (int f = 0; f < n_families; ++f)
      fits = fits && reinterpret_cast<std::uintptr_t>(bases[f]) % w == 0;
    if (fits) {
      p->word = w;
      break;
    }
  }
  int limit = 0;
  cudaError_t err = wave(&limit);
  if (err != cudaSuccess) return err;
  const long long total = n_slots * (row_bytes / p->word);
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > limit) blocks = limit;
  p->blocks = static_cast<unsigned>(blocks);
  return cudaSuccess;
}

Families families_of(const void* const* bases, int n_families) {
  Families fam = {};
  for (int f = 0; f < n_families; ++f)
    fam.base[f] = static_cast<char*>(const_cast<void*>(bases[f]));
  return fam;
}

template <typename V>
void gather_as(int n_families, const Families& fam, long long n_rows,
               long long words, const int* slots, long long n_slots,
               void* out, unsigned blocks, cudaStream_t s) {
  V* o = static_cast<V*>(out);
  switch (n_families) {
    case 1: cache_gather_kernel<V, 1><<<blocks, kThreads, 0, s>>>(
        fam, n_rows, words, slots, n_slots, o); break;
    case 2: cache_gather_kernel<V, 2><<<blocks, kThreads, 0, s>>>(
        fam, n_rows, words, slots, n_slots, o); break;
    case 3: cache_gather_kernel<V, 3><<<blocks, kThreads, 0, s>>>(
        fam, n_rows, words, slots, n_slots, o); break;
    default: cache_gather_kernel<V, 4><<<blocks, kThreads, 0, s>>>(
        fam, n_rows, words, slots, n_slots, o); break;
  }
}

template <typename V>
void scatter_as(int n_families, const Families& fam, long long n_rows,
                long long words, const int* slots, long long n_slots,
                const void* rows, unsigned blocks, cudaStream_t s) {
  const V* r = static_cast<const V*>(rows);
  switch (n_families) {
    case 1: cache_scatter_kernel<V, 1><<<blocks, kThreads, 0, s>>>(
        fam, n_rows, words, slots, n_slots, r); break;
    case 2: cache_scatter_kernel<V, 2><<<blocks, kThreads, 0, s>>>(
        fam, n_rows, words, slots, n_slots, r); break;
    case 3: cache_scatter_kernel<V, 3><<<blocks, kThreads, 0, s>>>(
        fam, n_rows, words, slots, n_slots, r); break;
    default: cache_scatter_kernel<V, 4><<<blocks, kThreads, 0, s>>>(
        fam, n_rows, words, slots, n_slots, r); break;
  }
}

bool bad_families(int n_families) {
  return n_families < 1 || n_families > kMaxFamilies;
}

}  // namespace

extern "C" int paddle_cache_gather(const void* const* caches, int n_families,
                                   long long n_rows, long long row_bytes,
                                   const int* slots, long long n_slots,
                                   void* out, void* stream) {
  if (bad_families(n_families)) return cudaErrorInvalidValue;
  if (n_slots <= 0 || row_bytes <= 0) return cudaSuccess;
  if (n_rows <= 0) return cudaErrorInvalidValue;
  Plan p;
  cudaError_t err = plan(caches, n_families, out, row_bytes, n_slots, &p);
  if (err != cudaSuccess) return err;
  const Families fam = families_of(caches, n_families);
  const long long words = row_bytes / p.word;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p.word) {
    case 16: gather_as<uint4>(n_families, fam, n_rows, words, slots, n_slots,
                              out, p.blocks, s); break;
    case 8: gather_as<uint2>(n_families, fam, n_rows, words, slots, n_slots,
                             out, p.blocks, s); break;
    case 4: gather_as<uint32_t>(n_families, fam, n_rows, words, slots,
                                n_slots, out, p.blocks, s); break;
    default: gather_as<uint8_t>(n_families, fam, n_rows, words, slots,
                                n_slots, out, p.blocks, s); break;
  }
  return cudaGetLastError();
}

extern "C" int paddle_cache_scatter(void* const* caches, int n_families,
                                    long long n_rows, long long row_bytes,
                                    const int* slots, long long n_slots,
                                    const void* rows, void* stream) {
  if (bad_families(n_families)) return cudaErrorInvalidValue;
  if (n_slots <= 0 || row_bytes <= 0 || n_rows <= 0) return cudaSuccess;
  Plan p;
  cudaError_t err = plan(caches, n_families, rows, row_bytes, n_slots, &p);
  if (err != cudaSuccess) return err;
  const Families fam = families_of(caches, n_families);
  const long long words = row_bytes / p.word;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p.word) {
    case 16: scatter_as<uint4>(n_families, fam, n_rows, words, slots,
                               n_slots, rows, p.blocks, s); break;
    case 8: scatter_as<uint2>(n_families, fam, n_rows, words, slots, n_slots,
                              rows, p.blocks, s); break;
    case 4: scatter_as<uint32_t>(n_families, fam, n_rows, words, slots,
                                 n_slots, rows, p.blocks, s); break;
    default: scatter_as<uint8_t>(n_families, fam, n_rows, words, slots,
                                 n_slots, rows, p.blocks, s); break;
  }
  return cudaGetLastError();
}
