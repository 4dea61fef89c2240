// Kernel 6: batched SHA-256 of pre-padded messages.
//
// Replaces no Pallas kernel: dfs_tpu computes this stage with XLA
// (dfs_tpu/ops/sha256_jax.py:_sha256_blocks_impl, a masked lax.scan over
// the blocks), and a plain PyTorch twin of that scan costs thousands of
// small launches per block step. It carries the rolling sharded step
// (parallel/sharded_cdc.py make_sharded_step) and sha256_batch_hex; the v1
// "cdc-cuda" path hashes its spans with kernel 7 (sha256_spans.cu), which
// shares this kernel's compression core.
//
//   words    [B, L, 16] u32  message b's block l, BE word values, FIPS
//                            padding already applied
//   nblocks  [B]        i32  real blocks of message b: it advances through
//                            blocks l < nblocks and keeps its state after
//                            that (0 or less: the state stays H0)
//   out      [B, 8]     u32  the chain state after its last real block
//
// What bounds it on this card: the chain of dependent compressions of the
// longest message, not bytes or operations, at the batch sizes the callers
// use. The design (sha256_chain.cuh): 32 messages a CTA, one thread of the
// consumer warp a message running only the rounds, its producer warp
// loading the next block (four 16-byte loads) and computing its message
// schedule into shared memory meanwhile.

#include <cstdint>
#include <cuda_runtime.h>

#include "sha256_chain.cuh"

namespace {

// Message `row`'s pre-padded blocks, four 16-byte loads a block.
struct WordsSource {
  const uint4* p;
  uint4 v[4];

  __device__ __forceinline__ void fetch(int l) {
    const uint4* q = p + 4 * l;
    v[0] = __ldg(q); v[1] = __ldg(q + 1); v[2] = __ldg(q + 2);
    v[3] = __ldg(q + 3);
  }

  __device__ __forceinline__ void words(int, uint32_t w[16]) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[4 * i] = v[i].x; w[4 * i + 1] = v[i].y;
      w[4 * i + 2] = v[i].z; w[4 * i + 3] = v[i].w;
    }
  }
};

__global__ void __launch_bounds__(kPairThreads)
sha256_blocks_kernel(const uint4* __restrict__ words,
                     const int32_t* __restrict__ nblocks,
                     uint32_t* __restrict__ out, int rows, int blocks) {
  __shared__ uint4 wk[2 * kWkHalf];
  const int row = blockIdx.x * 32 + (threadIdx.x & 31);
  const int n = row < rows ? min(max(nblocks[row], 0), blocks) : 0;
  WordsSource src{words + static_cast<size_t>(row < rows ? row : 0) *
                              blocks * 4};
  uint32_t st[8];
  chain_pair(src, n, wk, st);
  if (threadIdx.x < 32 && row < rows) {
#pragma unroll
    for (int i = 0; i < 8; ++i) out[static_cast<size_t>(row) * 8 + i] = st[i];
  }
}

}  // namespace

extern "C" int dfs_sha256_blocks(const void* words, const void* nblocks,
                                 void* out, int rows, int blocks,
                                 void* stream) {
  if (rows > 0) {
    sha256_blocks_kernel<<<(rows + 31) / 32, kPairThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(words),
        static_cast<const int32_t*>(nblocks), static_cast<uint32_t*>(out),
        rows, blocks);
  }
  return static_cast<int>(cudaGetLastError());
}
