// Kernel 5: the SHA-256 strip scan with the chunk cuts given.
//
// Replaces dfs_tpu/ops/sha256_strip.py:strip_states (Pallas body
// _strip_kernel). Layouts (S lanes, bps blocks per lane):
//   words_t  [bps*16, S] u32  BE word w of block t of lane s at [t*16+w, s]
//   cutflag  [bps, S]    i32  nonzero after the last block of a chunk
//   states   [bps*8, S]  u32  post-block chain state word i at [t*8+i, s]
// Every lane chains its blocks in order, stores the state after each
// block, and restarts from H0 after a flagged block. Padding lanes (no
// flag anywhere) chain all bps blocks like any other lane.
//
// It is kernel 1 without the Gear and selection work: one thread per lane
// with the 8-word state in registers, a loop over the lane's blocks, loads
// and stores coalesced across a warp by the lane-minor layout. The chain is
// sequential per lane and only S threads exist, so the latency of the
// dependent compression chain bounds it, not bytes or throughput.

#include <cstdint>
#include <cuda_runtime.h>

#include "sha256_compress.cuh"

namespace {

__global__ void strip_states_kernel(const uint32_t* __restrict__ words_t,
                                    const int32_t* __restrict__ cutflag,
                                    uint32_t* __restrict__ states, int bps,
                                    int S) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const size_t S64 = static_cast<size_t>(S);
  uint32_t st[8];
  sha256_init(st);

  for (int t = 0; t < bps; ++t) {
    uint32_t w[16];
    const uint32_t* src = words_t + static_cast<size_t>(t) * 16 * S64 + s;
#pragma unroll
    for (int i = 0; i < 16; ++i) w[i] = src[i * S64];
    const bool cut = cutflag[static_cast<size_t>(t) * S64 + s] != 0;

    sha256_compress(st, w);

    uint32_t* dst = states + static_cast<size_t>(t) * 8 * S64 + s;
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[i * S64] = st[i];
    if (cut) sha256_init(st);
  }
}

}  // namespace

extern "C" int dfs_strip_states(const void* words_t, const void* cutflag,
                                void* states, int bps, int s, void* stream) {
  if (bps > 0 && s > 0) {
    const int threads = 32;   // one warp per block: spread lanes over SMs
    strip_states_kernel<<<(s + threads - 1) / threads, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(words_t),
        static_cast<const int32_t*>(cutflag),
        static_cast<uint32_t*>(states), bps, s);
  }
  return static_cast<int>(cudaGetLastError());
}
