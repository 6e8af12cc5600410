// Sorted-probe x sorted-build merge rank for Hopper (sm_90a).
//
// Replaces the TPU kernel trino_tpu/ops/merge_pallas.py:99
// (merge_unique_sorted; pallas_call at :159, kernel body _kernel at :53).
//
// What it computes: for each key of an ascending int32 probe, the index of
// the equal key in an ascending int32 build (the first one, when the build
// repeats it), or -1. Dead build rows are an INT32_MAX tail. The window and
// clamp arithmetic is the reference's, so the result equals it bit for bit
// on every input, the INT32_MAX edge included:
//   - the build is treated as padded with INT32_MAX up to
//     nb_pad = (ceil(nb / block_build) + 2) * block_build (a virtual pad:
//     index >= nb reads as INT32_MAX, nothing is copied);
//   - a probe tile of BLOCK_PROBE keys covers the build window
//     [wstart, wstart + nwin * block_build), wstart = lower_bound(first key)
//     rounded down to 128, nwin = ceil((upper_bound(last key) - wstart) /
//     block_build), clamped to (nb_pad - wstart) / block_build;
//   - rank = wstart + (window keys < probe key); match = any window key ==
//     probe key.
//
// Design: one thread block per tile of 1024 sorted probe keys, 256 threads,
// 4 keys a thread (neighbouring threads on neighbouring keys, so the probe
// loads and the output stores are coalesced). Two threads find the tile's
// window by binary search over the build in device memory. The block then
// stages the window through shared memory in chunks of min(block_build,
// 8192) keys (at most 32 KB), and each thread ranks its keys in the staged
// chunk with a lower-bound search, adding the chunk's count of smaller keys
// and OR-ing the equality flag.
//
// Bound on an H100: bytes. The function must read the probe and the build
// once and write the output once, 4 * (2 * np + nb) bytes over 3.35 TB/s;
// its compare work (log2(chunk) shared-memory steps a key) is far below the
// card's integer rate. Each probe tile reads only the build window its key
// range spans, so a build key is read about once when the probe is denser
// than the build. At the SF1 join shapes (a few hundred to a few thousand
// keys) the kernel moves kilobytes and the launch cost bounds it. Not done
// yet: cp.async/TMA double buffering of the chunks, and merge-path
// partitioning for windows much wider than a chunk.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockProbe = 1024;
constexpr int kThreads = 256;
constexpr int kKeysPerThread = kBlockProbe / kThreads;
constexpr int kChunkMax = 8192;  // 32 KB of int32 in shared memory
constexpr int32_t kPad = 0x7fffffff;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

// first index in the padded build with value >= key (the pad is INT32_MAX,
// never below a key, so the search over the real build is enough)
__device__ int64_t lower_bound_padded(const int32_t* b, int64_t nb, int32_t key) {
  int64_t lo = 0, hi = nb;
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    if (b[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// first index in the padded build with value > key
__device__ int64_t upper_bound_padded(const int32_t* b, int64_t nb, int64_t nb_pad,
                                      int32_t key) {
  if (key == kPad) return nb_pad;
  int64_t lo = 0, hi = nb;
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    if (b[mid] <= key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
merge_unique_sorted_kernel(const int32_t* __restrict__ build, int64_t nb, int64_t nb_pad,
                           const int32_t* __restrict__ probe, int64_t np,
                           int32_t* __restrict__ out, int block_build, int chunk) {
  extern __shared__ int32_t sbuild[];
  __shared__ int64_t s_starts, s_ends;

  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * kBlockProbe;
  const int64_t tile_last = min64(tile0 + kBlockProbe - 1, np - 1);
  if (threadIdx.x == 0) s_starts = lower_bound_padded(build, nb, probe[tile0]);
  if (threadIdx.x == 32) s_ends = upper_bound_padded(build, nb, nb_pad, probe[tile_last]);
  __syncthreads();
  const int64_t wstart = (s_starts / 128) * 128;
  int64_t nwin = (s_ends - wstart + block_build - 1) / block_build;
  const int64_t nwin_cap = (nb_pad - wstart) / block_build;
  if (nwin > nwin_cap) nwin = nwin_cap;
  const int64_t wend = wstart + nwin * block_build;

  int32_t key[kKeysPerThread];
  int64_t lt[kKeysPerThread];
  bool eq[kKeysPerThread];
#pragma unroll
  for (int k = 0; k < kKeysPerThread; ++k) {
    const int64_t i = tile0 + k * kThreads + threadIdx.x;
    key[k] = i < np ? probe[i] : probe[tile_last];
    lt[k] = 0;
    eq[k] = false;
  }

  for (int64_t c0 = wstart; c0 < wend; c0 += chunk) {
    const int len = static_cast<int>(min64(chunk, wend - c0));
    for (int j = threadIdx.x; j < len; j += kThreads) {
      const int64_t g = c0 + j;
      sbuild[j] = g < nb ? build[g] : kPad;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kKeysPerThread; ++k) {
      int lo = 0, hi = len;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (sbuild[mid] < key[k]) lo = mid + 1; else hi = mid;
      }
      lt[k] += lo;
      eq[k] = eq[k] || (lo < len && sbuild[lo] == key[k]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < kKeysPerThread; ++k) {
    const int64_t i = tile0 + k * kThreads + threadIdx.x;
    if (i < np) out[i] = eq[k] ? static_cast<int32_t>(wstart + lt[k]) : -1;
  }
}

}  // namespace

// C entry point, loaded with ctypes. Launches on ``stream`` (PyTorch's
// current stream), does not synchronise, allocates nothing; returns
// cudaGetLastError() after the launch. np > 0 and nb > 0 are the caller's
// to guarantee; block_build is a positive multiple of 128.
extern "C" int merge_unique_sorted_launch(const int32_t* build, int64_t nb,
                                          const int32_t* probe, int64_t np,
                                          int32_t* out, int block_build, void* stream) {
  const int64_t nb_pad = ((nb + block_build - 1) / block_build + 2) * block_build;
  const int chunk = block_build < kChunkMax ? block_build : kChunkMax;
  const int64_t grid = (np + kBlockProbe - 1) / kBlockProbe;
  merge_unique_sorted_kernel<<<static_cast<unsigned>(grid), kThreads,
                               chunk * sizeof(int32_t),
                               static_cast<cudaStream_t>(stream)>>>(
      build, nb, nb_pad, probe, np, out, block_build, chunk);
  return static_cast<int>(cudaGetLastError());
}
