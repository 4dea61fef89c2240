// Kernel 1: Gear candidates + greedy cut selection + strip SHA-256.
//
// Replaces dfs_tpu/ops/sha256_strip.py:strip_chunk_states (Pallas body
// _strip_fused_kernel). Layouts (S lanes, bps blocks per lane):
//   words_t  [bps*16, S] u32  BE word w of block t of lane s at [t*16+w, s]
//   real_blocks [S]      i32  blocks present in lane s (0 = padding lane)
//   cutflag  [bps, S]    i32  1 after the last block of a chunk
//   since    [bps, S]    i32  chunk length in blocks at a cut, else 0
//   states   [bps*8, S]  u32  post-block chain state word i at [t*8+i, s]
// cutflag and since are exact on every row. states are exact on a lane's
// live rows (t <= its last cut, which is real_blocks - 1) and 0 on the
// rest, which no consumer reads.
//
// Two kernels, one launch of the wrapper:
//  1. selection, one CTA of 256 threads per group of up to 8 neighbouring
//     lanes (8: one 32-byte sector of every word row; fewer where two
//     bitmaps of bps bits a lane would not fit shared memory, down to one
//     lane of 2^19 blocks), in two phases through shared memory:
//     a. candidates, in parallel: the threads hash the Gear windows (words
//        8..15) of the group's blocks, neighbouring threads on one block
//        of neighbouring lanes so every load is one sector, looking the 32
//        bytes up in a 256-entry table built from `seed`; a candidate sets
//        its bit in the lane's bitmap;
//     b. cut to cut: warp j jumps, for lane j, from each chunk start p to
//        min(first candidate >= p + min_b - 1, p + max_b - 1, rb - 1), 32
//        bitmap words per step (ballot + __ffs); then the CTA writes every
//        row of cutflag and since;
//  2. SHA-256, one chain per chunk of those cuts (strip_chunks.cuh, shared
//     with kernel 5), which also writes the dead rows' zeros: the narrow
//     layout at the default geometry, the wide one for lanes past 65,536
//     blocks or lists past its 16-bit ranks (up to 2^20 blocks; the
//     selection's two bitmaps bound kernel 1 below that, at 925,184).
// What bounds it: the longest chunk's chain of dependent compressions (at
// most max_b blocks; ~1000 at the default parameters on a 64 MiB region,
// 131,072 for an 8 MiB chunk) at the ALU issue rate of one SM scheduler,
// not bytes or throughput.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "strip_chunks.cuh"

namespace {

// lowbias32 finalizer (constants shared with the anchor hash)
__device__ __forceinline__ uint32_t fmix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

constexpr int kLanes = 8;               // lanes per selection CTA, at most
constexpr int kThreads = 32 * kLanes;   // one warp per lane
constexpr int kSelectStatic = 1152;     // its static shared memory, rounded up

// Shared memory of a selection CTA of `lanes` lanes: two bitmaps each.
inline size_t select_shared_bytes(int lanes, int bps) {
  return 2 * static_cast<size_t>(lanes) * ((bps + 31) / 32) * 4;
}

// Chunks a lane can have: every chunk but the lane's last is at least
// min(min_b, max_b) blocks long.
inline int list_capacity(int bps, int min_b, int max_b) {
  int m = min_b < max_b ? min_b : max_b;
  if (m < 1) m = 1;
  return (bps + m - 1) / m + 1;
}

// The first set bit of `bits` in [lo, lim] (INT_MAX if none), found by a
// whole warp 32 words at a time. Every lane of the warp must call it.
__device__ int first_set(const uint32_t* bits, int lo, int lim) {
  const int lane = threadIdx.x & 31;
  const int w_lo = lo >> 5, w_hi = lim >> 5;
  for (int w0 = w_lo; lo <= lim && w0 <= w_hi; w0 += 32) {
    const int wi = w0 + lane;
    uint32_t b = 0;
    if (wi <= w_hi) {
      b = bits[wi];
      if (wi == w_lo) b &= ~0u << (lo & 31);
      if (wi == w_hi) b &= 0xFFFFFFFFu >> (31 - (lim & 31));
    }
    const uint32_t any = __ballot_sync(0xFFFFFFFFu, b != 0);
    if (any) {
      const int src = __ffs(any) - 1;
      const uint32_t hit = __shfl_sync(0xFFFFFFFFu, b, src);
      return ((w0 + src) << 5) + __ffs(hit) - 1;
    }
  }
  return INT_MAX;
}

// kWide: `lanes` (1..8) lanes a CTA; else always kLanes.
template <bool kWide>
__global__ void __launch_bounds__(kThreads) select_cuts_kernel(
    const uint32_t* __restrict__ words_t, const int32_t* __restrict__ rbs,
    int32_t* __restrict__ cutflag, int32_t* __restrict__ since_out, int bps,
    int S, uint32_t seed, uint32_t mask, int min_b, int max_b, int lanes) {
  extern __shared__ uint32_t smem[];
  __shared__ uint32_t gear[256];
  __shared__ int rb_of[kLanes], scan_end[kLanes];
  const int n_lanes = kWide ? lanes : kLanes;
  const int n_words = (bps + 31) / 32;
  uint32_t* cand = smem;                       // [n_lanes][n_words]
  uint32_t* cuts = smem + n_lanes * n_words;   // [n_lanes][n_words]
  const int s0 = blockIdx.x * n_lanes;
  const size_t S64 = static_cast<size_t>(S);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int b = threadIdx.x; b < 256; b += blockDim.x)
    gear[b] = fmix(seed ^ (static_cast<uint32_t>(b) * 0x9E3779B1u));
  for (int i = threadIdx.x; i < 2 * n_lanes * n_words; i += blockDim.x)
    smem[i] = 0;
  if (threadIdx.x < n_lanes) {
    const int s = s0 + threadIdx.x;
    const int rb = s < S ? rbs[s] : 0;
    rb_of[threadIdx.x] = rb;
    scan_end[threadIdx.x] = max(0, min(rb, bps));   // blocks that can cut
  }
  __syncthreads();

  // a. candidates: byte j of the window (stream order) weighs 2^(31-j)
  for (int idx = threadIdx.x; idx < n_lanes * bps; idx += blockDim.x) {
    const int j = idx % n_lanes, t = idx / n_lanes;
    if (t >= scan_end[j]) continue;
    const uint32_t* src = words_t + (static_cast<size_t>(t) * 16 + 8) * S64
                          + s0 + j;
    uint32_t h = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint32_t x = __ldg(src + k * S64);
#pragma unroll
      for (int b = 0; b < 4; ++b)
        h += gear[(x >> (24 - 8 * b)) & 0xFFu] << (31 - (4 * k + b));
    }
    if ((h & mask) == 0)
      atomicOr(&cand[j * n_words + (t >> 5)], 1u << (t & 31));
  }
  __syncthreads();

  // b. cut to cut (warp j, lane j of the group): the greedy rule cuts at
  // the first t >= p with (cand && t-p+1 >= min_b) || t-p+1 >= max_b ||
  // t == rb-1
  if (warp < n_lanes) {
    const int j = warp;
    const int rb = rb_of[j], end = scan_end[j];
    int p = 0;
    while (p < end) {
      const int forced = min(p + max(max_b, 1) - 1, rb - 1);
      const int lim = min(forced, bps - 1);
      const int cut = min(first_set(cand + j * n_words,
                                    p + max(min_b, 1) - 1, lim), forced);
      if (cut > bps - 1) break;     // rb > bps: the lane runs on uncut
      if (lane == 0) {
        cuts[j * n_words + (cut >> 5)] |= 1u << (cut & 31);
        const size_t o = static_cast<size_t>(cut) * S64 + s0 + j;
        cutflag[o] = 1;
        since_out[o] = cut - p + 1;
      }
      p = cut + 1;
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < n_lanes * bps; idx += blockDim.x) {
    const int j = idx % n_lanes, t = idx / n_lanes;
    if (s0 + j < S && !((cuts[j * n_words + (t >> 5)] >> (t & 31)) & 1u)) {
      const size_t o = static_cast<size_t>(t) * S64 + s0 + j;
      cutflag[o] = 0;
      since_out[o] = 0;
    }
  }
}

}  // namespace

// sel_lanes: lanes a selection CTA (8 with the narrow chain layout);
// wide: the chain kernel's wide layout, whose lists take `scratch`, 3 * s *
// list_capacity words.
extern "C" int dfs_strip_chunk_states(const void* words_t,
                                      const void* real_blocks, void* cutflag,
                                      void* since, void* states, int bps,
                                      int s, unsigned int seed,
                                      unsigned int mask, int min_b, int max_b,
                                      int sel_lanes, int wide, void* scratch,
                                      void* stream) {
  if (bps > 0 && s > 0) {
    if (sel_lanes < 1 || sel_lanes > kLanes || (!wide && sel_lanes != kLanes))
      return static_cast<int>(cudaErrorInvalidValue);
    const size_t shared = select_shared_bytes(sel_lanes, bps);
    if (shared + kSelectStatic > static_cast<size_t>(kMaxShared))
      return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = wide ? select_cuts_kernel<true> : select_cuts_kernel<false>;
    cudaError_t err = cudaSuccess;
    if (shared > static_cast<size_t>(kDefaultShared))
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    kernel<<<(s + sel_lanes - 1) / sel_lanes, kThreads, shared, st>>>(
        static_cast<const uint32_t*>(words_t),
        static_cast<const int32_t*>(real_blocks),
        static_cast<int32_t*>(cutflag), static_cast<int32_t*>(since), bps, s,
        seed, mask, min_b, max_b, sel_lanes);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(launch_chunk_chains(
        static_cast<const uint32_t*>(words_t),
        static_cast<const int32_t*>(cutflag), static_cast<uint32_t*>(states),
        bps, s, list_capacity(bps, min_b, max_b), wide != 0,
        static_cast<uint32_t*>(scratch), st));
  }
  return static_cast<int>(cudaGetLastError());
}
