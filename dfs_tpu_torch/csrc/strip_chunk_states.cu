// Kernel 1: fused Gear candidates + greedy cut selection + strip SHA-256.
//
// Replaces dfs_tpu/ops/sha256_strip.py:strip_chunk_states (Pallas body
// _strip_fused_kernel). Layouts (S lanes, bps blocks per lane):
//   words_t  [bps*16, S] u32  BE word w of block t of lane s at [t*16+w, s]
//   real_blocks [S]      i32  blocks present in lane s (0 = padding lane)
//   cutflag  [bps, S]    i32  1 after the last block of a chunk
//   since    [bps, S]    i32  chunk length in blocks at a cut, else 0
//   states   [bps*8, S]  u32  post-block chain state word i at [t*8+i, s]
//
// One thread per lane: the Gear hash, the selection carry and the SHA-256
// state live in registers while the thread walks its lane's blocks in
// order. Threads of a warp hold neighbouring lanes, so every load of a
// block word and every store of a state word is coalesced. The walk is
// sequential per lane and only S threads exist, so the kernel is bound by
// the latency of its dependent integer chain, not by bytes or throughput.
// The compression is shared with kernel 5 (sha256_compress.cuh).

#include <cstdint>
#include <cuda_runtime.h>

#include "sha256_compress.cuh"

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

__global__ void strip_chunk_states_kernel(
    const uint32_t* __restrict__ words_t, const int32_t* __restrict__ rbs,
    int32_t* __restrict__ cutflag, int32_t* __restrict__ since_out,
    uint32_t* __restrict__ states, int bps, int S, uint32_t seed,
    uint32_t mask, int min_b, int max_b) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const int rb = rbs[s];
  const size_t S64 = static_cast<size_t>(S);
  uint32_t st[8];
  sha256_init(st);
  int since = 0;

  for (int t = 0; t < bps; ++t) {
    uint32_t w[16];
    const uint32_t* src = words_t + static_cast<size_t>(t) * 16 * S64 + s;
#pragma unroll
    for (int i = 0; i < 16; ++i) w[i] = src[i * S64];

    // Gear window hash over the block's last 32 bytes (words 8..15, BE):
    // byte j (stream order) weighs 2^(31-j)
    uint32_t h = 0;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const uint32_t byte = (w[8 + j / 4] >> (8 * (3 - j % 4))) & 0xFFu;
      h += fmix(seed ^ (byte * 0x9E3779B1u)) << (31 - j);
    }
    const bool cand = (h & mask) == 0;

    // greedy selection step
    const int since1 = since + 1;
    const bool in_range = t < rb;
    const bool is_last = t == rb - 1;
    const bool cut =
        ((cand && since1 >= min_b) || since1 >= max_b || is_last) && in_range;
    cutflag[static_cast<size_t>(t) * S64 + s] = cut ? 1 : 0;
    since_out[static_cast<size_t>(t) * S64 + s] = cut ? since1 : 0;
    since = cut ? 0 : (in_range ? since1 : since);

    sha256_compress(st, w);

    uint32_t* dst = states + static_cast<size_t>(t) * 8 * S64 + s;
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[i * S64] = st[i];
    if (cut) sha256_init(st);
  }
}

}  // namespace

extern "C" int dfs_strip_chunk_states(const void* words_t,
                                      const void* real_blocks, void* cutflag,
                                      void* since, void* states, int bps,
                                      int s, unsigned int seed,
                                      unsigned int mask, int min_b, int max_b,
                                      void* stream) {
  if (bps > 0 && s > 0) {
    const int threads = 32;   // one warp per block: spread lanes over SMs
    strip_chunk_states_kernel<<<(s + threads - 1) / threads, threads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(words_t),
        static_cast<const int32_t*>(real_blocks),
        static_cast<int32_t*>(cutflag), static_cast<int32_t*>(since),
        static_cast<uint32_t*>(states), bps, s, seed, mask, min_b, max_b);
  }
  return static_cast<int>(cudaGetLastError());
}
