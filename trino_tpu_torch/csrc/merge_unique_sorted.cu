// Sorted-probe x sorted-build merge rank for Hopper (sm_90a).
//
// Replaces the TPU kernel trino_tpu/ops/merge_pallas.py:99
// (merge_unique_sorted; pallas_call at :159, kernel body _kernel at :53).
//
// What it computes: for each key of an ascending int32 probe, with the
// ascending int32 build (nb > 0 keys) virtually padded by one INT32_MAX at
// index nb,
//   lb  = lower_bound(padded build, key)        (0 <= lb <= nb)
//   out = padded[lb] == key ? lb : -1.
// This closed form equals the reference kernel's windowed arithmetic on
// every input (its 128-aligned window starts, block_build windows and
// nb_pad clamp never change an answer), the INT32_MAX edge included: dead
// build rows are an INT32_MAX tail, and a probe key of INT32_MAX matches
// the first of them, or the pad at nb when there is none. So the result
// does not depend on block_build or on how the work is tiled.
//
// What bounds it on an H100: bytes. Each probe key is read once and each
// output written once (8 bytes a key); the build is read once, and only
// the span each probe tile covers. The compare work is a few shared-memory
// steps a key, far below the card's integer rate, but it is issued by
// every thread of every block, so instructions a key count too. Each block
// is a chain of dependent loads (the span's ends, the span, the probe
// tile), so latency limits a plain tiling well before bandwidth does: the
// design shortens that chain, moves no build key the tile does not need,
// and keeps 8 blocks a SM in flight.
//
// Design, per block of 256 threads and a tile of 2048 probe keys:
//   1. The tile's probe keys go to shared memory with 16-byte cp.async,
//      in flight while the span is searched.
//   2. The span's ends, lb(first key) and lb(last key), come from a warp
//      each: every step the 32 lanes load 32 evenly spaced splitters and a
//      __ballot_sync picks the sub-range (5 dependent loads at 4M keys).
//   3. The span [lb(first) rounded down to 4, lb(last) + 1) is staged in
//      chunks of kChunk keys through a two-stage ring: a TMA 1-D bulk copy
//      (cp.async.bulk completing on an mbarrier) for the 16-byte aligned
//      body, plain loads for the ragged tail and the virtual INT32_MAX at
//      nb. Chunk k+1 lands while chunk k is compared.
//   4. A span of one chunk (a probe at least as dense as the build, the
//      usual join): each thread ranks its contiguous run of 8 sorted keys
//      in registers, one binary search for the first and a gallop forward
//      for each next, and stores the 8 results as two 16-byte vectors. A
//      span of several chunks (a build much denser than the probe): per
//      chunk, the keys whose lower bound lies in it are split into one
//      contiguous run a thread, ranked the same way. Results go straight to
//      device memory; the keys in shared memory are only read, so one
//      barrier a chunk (to free its ring slot) is all the block waits for.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 8;                      // keys a thread
constexpr int kTile = kThreads * kRun;       // probe keys a block
constexpr int kChunk = 2048;                 // build keys a ring stage (8 KB)
constexpr int kStages = 2;
constexpr size_t kSmemBytes = (kTile + kStages * kChunk) * sizeof(int32_t);
constexpr int32_t kPad = 0x7fffffff;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void tma_load_1d(void* dst, const void* src, uint32_t bytes,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

// lower_bound(build[0, nb), key) by one warp: each step the lanes load 32
// evenly spaced splitters of the candidate range and the ballot of
// "splitter < key" (a prefix, the build being sorted) narrows it 32-fold.
// Every lane returns the same index.
__device__ int64_t warp_lower_bound(const int32_t* __restrict__ build, int64_t nb,
                                    int32_t key) {
  const int lane = threadIdx.x & 31;
  int64_t lo = 0, hi = nb;  // answer in [lo, hi]; positions lo..hi-1 unknown
  while (hi - lo > 32) {
    const int64_t step = (hi - lo + 31) >> 5;
    const int64_t pos = lo + (lane + 1) * step - 1;
    const bool less = pos < hi && __ldg(build + pos) < key;
    const int64_t c = __popc(__ballot_sync(0xffffffffu, less));
    const int64_t nhi = lo + (c + 1) * step - 1;
    lo += c * step;
    if (nhi < hi) hi = nhi;
  }
  const bool less = lo + lane < hi && __ldg(build + lo + lane) < key;
  return lo + __popc(__ballot_sync(0xffffffffu, less));
}

// first index in s[lo, hi) with s[i] >= key, else hi
__device__ __forceinline__ int smem_lower_bound(const int32_t* s, int lo, int hi, int32_t key) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// the same from a known lower limit, galloping first: O(log gap) steps
__device__ __forceinline__ int smem_gallop(const int32_t* s, int lo, int len, int32_t key) {
  int hi = lo, step = 1;
  while (hi < len && s[hi] < key) {
    lo = hi + 1;
    hi = lo + step < len ? lo + step : len;
    step <<= 1;
  }
  return smem_lower_bound(s, lo, hi, key);
}

// 8 blocks a SM (2,048 threads, 32 registers each; 24 KB of shared memory)
__global__ void __launch_bounds__(kThreads, 8)
merge_unique_sorted_kernel(const int32_t* __restrict__ build, int64_t nb,
                           const int32_t* __restrict__ probe, int64_t np,
                           int32_t* __restrict__ out) {
  extern __shared__ __align__(128) int32_t smem[];
  int32_t* keys = smem;                 // the probe tile
  int32_t* ring = smem + kTile;         // kStages chunks of the build span
  __shared__ uint64_t bars[kStages];
  __shared__ int64_t s_lb[2];

  const int tid = threadIdx.x;
  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int n = static_cast<int>(np - tile0 < kTile ? np - tile0 : kTile);
  const bool vec_probe = n == kTile && (reinterpret_cast<uintptr_t>(probe) & 15) == 0;
  const bool vec_out = n == kTile && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const bool tma_ok = (reinterpret_cast<uintptr_t>(build) & 15) == 0;

  // 1. probe tile -> shared memory, asynchronously
  if (vec_probe) {
    for (int j = tid * 4; j < kTile; j += kThreads * 4) cp_async_16(keys + j, probe + tile0 + j);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  } else {
    const int32_t last = probe[tile0 + n - 1];
    for (int j = tid; j < kTile; j += kThreads) keys[j] = j < n ? probe[tile0 + j] : last;
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&bars[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // 2. the span's ends, one warp each
  if (tid < 64) {
    const int32_t key = __ldg(probe + tile0 + (tid < 32 ? 0 : n - 1));
    const int64_t lb = warp_lower_bound(build, nb, key);
    if ((tid & 31) == 0) s_lb[tid >> 5] = lb;
  }
  __syncthreads();
  const int64_t span0 = s_lb[0] & ~int64_t{3};  // 16-byte aligned start
  const int64_t span1 = s_lb[1] + 1;            // <= nb + 1: the virtual pad
  const int nchunks = static_cast<int>((span1 - span0 + kChunk - 1) / kChunk);

  // 3. stage chunk c into ring slot c % kStages: one thread starts the TMA
  // copy of the aligned body; the ragged tail and the pad go plainly.
  // Called after a barrier that frees the slot; the plain writes are read
  // only after the next barrier.
  auto stage = [&](int c) {
    int32_t* dst = ring + (c % kStages) * kChunk;
    const int64_t c0 = span0 + static_cast<int64_t>(c) * kChunk;
    const int64_t c1 = c0 + kChunk < span1 ? c0 + kChunk : span1;
    const int64_t real_end = c1 < nb ? c1 : nb;
    const int64_t body = tma_ok && real_end > c0 ? ((real_end - c0) & ~int64_t{3}) : 0;
    if (tid == 0) {
      // order the slot's earlier generic-proxy reads and writes before the
      // async-proxy (TMA) writes into it
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive_expect_tx(&bars[c % kStages], static_cast<uint32_t>(body * 4));
      if (body > 0) tma_load_1d(dst, build + c0, static_cast<uint32_t>(body * 4), &bars[c % kStages]);
    }
    for (int64_t j = body + tid; j < c1 - c0; j += kThreads) {
      dst[j] = c0 + j < nb ? __ldg(build + c0 + j) : kPad;
    }
  };
  for (int c = 0; c < kStages && c < nchunks; ++c) stage(c);
  if (vec_probe) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // 4. rank, writing each result straight to `out` (the keys in shared
  // memory are only read, so no thread waits for another's writes)
  if (nchunks == 1) {
    // the whole span in one chunk: each thread's kRun contiguous keys go
    // through registers, read as 16-byte vectors (a scalar read at stride
    // kRun would be an 8-way bank conflict); one binary search, then a
    // gallop forward a key
    mbar_wait(&bars[0], 0);
    const int len = static_cast<int>(span1 - span0);
    const int4* run = reinterpret_cast<const int4*>(keys + tid * kRun);
    int32_t k[kRun];
#pragma unroll
    for (int v = 0; v < kRun / 4; ++v) {
      const int4 q = run[v];
      k[4 * v] = q.x; k[4 * v + 1] = q.y; k[4 * v + 2] = q.z; k[4 * v + 3] = q.w;
    }
    int pos = 0;
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      pos = i == 0 ? smem_lower_bound(ring, 0, len, k[i]) : smem_gallop(ring, pos, len, k[i]);
      k[i] = ring[pos] == k[i] ? static_cast<int32_t>(span0 + pos) : -1;
    }
    const int j0 = tid * kRun;
    if (vec_out) {
      int4* o = reinterpret_cast<int4*>(out + tile0 + j0);
#pragma unroll
      for (int v = 0; v < kRun / 4; ++v) o[v] = make_int4(k[4 * v], k[4 * v + 1], k[4 * v + 2], k[4 * v + 3]);
    } else {
#pragma unroll
      for (int i = 0; i < kRun; ++i) if (j0 + i < n) out[tile0 + j0 + i] = k[i];
    }
    return;
  }
  // A span of several chunks (a build denser than the probe): in each
  // chunk the unresolved keys whose lower bound lies there (those up to its
  // last element) are found by one search that every thread makes alike
  // (a broadcast read, free of bank conflicts), then split into one
  // contiguous run a thread: a binary search for the run's first key, a
  // gallop forward for the rest.
  int k_lo = 0;  // keys before k_lo are resolved
  for (int c = 0; c < nchunks; ++c) {
    mbar_wait(&bars[c % kStages], (c / kStages) & 1);
    const int32_t* s = ring + (c % kStages) * kChunk;
    const int64_t c0 = span0 + static_cast<int64_t>(c) * kChunk;
    const int len = static_cast<int>(span1 - c0 < kChunk ? span1 - c0 : kChunk);
    int k_hi = n;
    if (c + 1 < nchunks) {
      const int32_t chunk_last = s[len - 1];
      int hi = n;
      k_hi = k_lo;
      while (k_hi < hi) {
        const int mid = (k_hi + hi) >> 1;
        if (keys[mid] <= chunk_last) k_hi = mid + 1; else hi = mid;
      }
    }
    const int per = (k_hi - k_lo + kThreads - 1) / kThreads;
    int j = k_lo + tid * per;
    const int j_end = j + per < k_hi ? j + per : k_hi;
    if (j < j_end) {
      int32_t key = keys[j];
      int pos = smem_lower_bound(s, 0, len, key);
      while (true) {
        out[tile0 + j] = s[pos] == key ? static_cast<int32_t>(c0 + pos) : -1;
        if (++j == j_end) break;
        key = keys[j];
        pos = smem_gallop(s, pos, len, key);
      }
    }
    k_lo = k_hi;
    if (c + 1 < nchunks) {
      // slot c % kStages is free again; the barrier also publishes the
      // plain tail writes of the chunk staged one iteration earlier
      __syncthreads();
      if (c + kStages < nchunks) stage(c + kStages);
    }
  }
}

}  // namespace

// C entry point, loaded with ctypes. Launches on ``stream`` (PyTorch's
// current stream), does not synchronise, allocates nothing; returns
// cudaGetLastError() after the launch. np > 0 and nb > 0 are the caller's
// to guarantee.
extern "C" int merge_unique_sorted_launch(const int32_t* build, int64_t nb,
                                          const int32_t* probe, int64_t np,
                                          int32_t* out, void* stream) {
  const int64_t grid = (np + kTile - 1) / kTile;
  static_assert(kSmemBytes <= 48 * 1024, "above 48 KB needs cudaFuncSetAttribute");
  merge_unique_sorted_kernel<<<static_cast<unsigned>(grid), kThreads, kSmemBytes,
                               static_cast<cudaStream_t>(stream)>>>(build, nb, probe, np, out);
  return static_cast<int>(cudaGetLastError());
}
