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

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__constant__ uint32_t kK[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu,
    0x59f111f1u, 0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u,
    0x243185beu, 0x550c7dc3u, 0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u,
    0xc19bf174u, 0xe49b69c1u, 0xefbe4786u, 0x0fc19dc6u, 0x240ca1ccu,
    0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau, 0x983e5152u,
    0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
    0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu,
    0x53380d13u, 0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u,
    0xa2bfe8a1u, 0xa81a664bu, 0xc24b8b70u, 0xc76c51a3u, 0xd192e819u,
    0xd6990624u, 0xf40e3585u, 0x106aa070u, 0x19a4c116u, 0x1e376c08u,
    0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au, 0x5b9cca4fu,
    0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
    0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u};

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

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
  const uint32_t H0[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u,
                          0xa54ff53au, 0x510e527fu, 0x9b05688cu,
                          0x1f83d9abu, 0x5be0cd19u};
  const int rb = rbs[s];
  const size_t S64 = static_cast<size_t>(S);
  uint32_t st[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) st[i] = H0[i];
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

    // SHA-256 compression, message schedule in a 16-word ring
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

    uint32_t* dst = states + static_cast<size_t>(t) * 8 * S64 + s;
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[i * S64] = st[i];
    if (cut) {
#pragma unroll
      for (int i = 0; i < 8; ++i) st[i] = H0[i];
    }
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
