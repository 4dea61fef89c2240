// Kernel 6: batched SHA-256 of pre-padded messages.
//
// Replaces no Pallas kernel: dfs_tpu computes this stage with XLA
// (dfs_tpu/ops/sha256_jax.py:_sha256_blocks_impl, a masked lax.scan over
// the blocks), and a plain PyTorch twin of that scan costs thousands of
// small launches per block step. It carries the v1 "cdc-cuda" path
// (ops/pack.py digest_gathered, CudaCdcFragmenter.digest_many) and the
// rolling sharded step (parallel/sharded_cdc.py make_sharded_step).
//
//   words    [B, L, 16] u32  message b's block l, BE word values, FIPS
//                            padding already applied
//   nblocks  [B]        i32  real blocks of message b: it advances through
//                            blocks l < nblocks and keeps its state after
//                            that (0 or less: the state stays H0)
//   out      [B, 8]     u32  the chain state after its last real block
//
// One thread per message, the 16-word schedule ring and the state in
// registers, the next block's four 16-byte loads issued before the current
// block's 64 rounds. What bounds it on this card: the chain of dependent
// compressions of the longest message (about 1,536 cycles each), not bytes
// or operations, at the batch sizes the callers use (16 to 512 rows).

#include <cstdint>
#include <cuda_runtime.h>

#include "sha256_compress.cuh"

namespace {

constexpr int kThreads = 64;

__device__ __forceinline__ void compress_regs(uint32_t st[8],
                                              uint32_t w[16]) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], hh = st[7];
#pragma unroll
  for (int r = 0; r < 64; ++r) {
    uint32_t wr;
    if (r < 16) {
      wr = w[r];
    } else {
      const uint32_t w15 = w[(r - 15) & 15], w2 = w[(r - 2) & 15];
      const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
      wr = w[r & 15] + s0 + w[(r - 7) & 15] + s1;
      w[r & 15] = wr;
    }
    const uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t t1 = hh + S1 + ch + kK[r] + wr;
    const uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    hh = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + S0 + maj;
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += hh;
}

__global__ void __launch_bounds__(kThreads)
sha256_blocks_kernel(const uint4* __restrict__ words,
                     const int32_t* __restrict__ nblocks,
                     uint32_t* __restrict__ out, int rows, int blocks) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= rows) return;
  uint32_t st[8];
  sha256_init(st);
  const int n = min(max(nblocks[row], 0), blocks);
  const uint4* p = words + static_cast<size_t>(row) * blocks * 4;
  uint4 v0, v1, v2, v3;
  if (n > 0) {
    v0 = p[0]; v1 = p[1]; v2 = p[2]; v3 = p[3];
  }
  for (int l = 0; l < n; ++l) {
    uint32_t w[16] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w,
                      v2.x, v2.y, v2.z, v2.w, v3.x, v3.y, v3.z, v3.w};
    if (l + 1 < n) {
      const uint4* q = p + 4 * (l + 1);
      v0 = q[0]; v1 = q[1]; v2 = q[2]; v3 = q[3];
    }
    compress_regs(st, w);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) out[static_cast<size_t>(row) * 8 + i] = st[i];
}

}  // namespace

extern "C" int dfs_sha256_blocks(const void* words, const void* nblocks,
                                 void* out, int rows, int blocks,
                                 void* stream) {
  if (rows > 0) {
    const int grid = (rows + kThreads - 1) / kThreads;
    sha256_blocks_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(words),
        static_cast<const int32_t*>(nblocks), static_cast<uint32_t*>(out),
        rows, blocks);
  }
  return static_cast<int>(cudaGetLastError());
}
