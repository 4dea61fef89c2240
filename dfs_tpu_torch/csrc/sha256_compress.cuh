// SHA-256 compression for the strip-scan kernels (strip_chunk_states.cu,
// strip_states.cu, through strip_chunks.cuh), in two halves that two warps
// run: sha256_schedule_wk expands a block's 16 message words into the 64
// words W+K in shared memory, and sha256_rounds_wk runs the 64 rounds and
// the feed-forward on an 8-word chain state in registers. Each kernel
// source is its own translation unit and library, so the constants below
// are per library.

#pragma once

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

// The initial hash value H0: every chunk's chain starts from it.
__device__ __forceinline__ void sha256_init(uint32_t st[8]) {
  st[0] = 0x6a09e667u; st[1] = 0xbb67ae85u; st[2] = 0x3c6ef372u;
  st[3] = 0xa54ff53au; st[4] = 0x510e527fu; st[5] = 0x9b05688cu;
  st[6] = 0x1f83d9abu; st[7] = 0x5be0cd19u;
}

// The message schedule of one block plus the round constants: W[r] + K[r]
// for r = 4q .. 4q+3 written to wk[q * 32] (the layout sha256_rounds_wk
// reads). w holds the block's 16 big-endian words and is overwritten by the
// schedule, kept as a 16-word ring.
__device__ __forceinline__ void sha256_schedule_wk(uint32_t w[16],
                                                   uint4* wk) {
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    uint32_t v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = 4 * q + u;
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
      v[u] = wr + kK[r];
    }
    wk[q * 32] = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// The 64 rounds plus the feed-forward with the schedule given: W[r] + K[r]
// for r = 4q .. 4q+3 at wk[q * 32] (the 32 lanes of a warp interleaved, so
// a warp's 16-byte loads hit distinct banks).
__device__ __forceinline__ void sha256_rounds_wk(uint32_t st[8],
                                                 const uint4* wk) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], hh = st[7];
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const uint4 v = wk[q * 32];
    const uint32_t vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
      const uint32_t ch = (e & f) ^ (~e & g);
      const uint32_t t1 = hh + S1 + ch + vv[u];
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
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += hh;
}

}  // namespace
