// One SHA-256 chain per message, for kernel 6 (sha256_blocks.cu) and
// kernel 7 (sha256_spans.cu): a CTA of two warps hashes 32 messages.
//
// SHA-256 is sequential within a message, so a launch takes at least its
// longest message's chain of compressions. On this card one chain's time
// is set by the instructions its warp issues a round and by the path of
// dependent ones through it. The design keeps both short:
//  - the message schedule and whatever builds a block's 16 words (the
//    loads, the byte shifts of an unaligned span, the FIPS padding) run in
//    a producer warp (warp 1), which issues on another scheduler than the
//    consumer warp (warp 0; warp w issues on sub-partition w % 4). The
//    producer writes block l+1's W[t]+K[t] into one half of a shared double
//    buffer while the consumer runs block l's 64 rounds from the other
//    half; one named barrier a block hands the halves over. The consumer
//    issues the rounds alone: 6 rotations, 4 LOP3 and 3 three-input adds
//    a round;
//  - h + W[t] + K[t], and d + h + W[t] + K[t], are summed one round ahead
//    (h of round t+1 is g of round t, its d is c), so e -> e' is three
//    dependent instructions (a rotation, the Sigma's LOP3, one add), as is
//    a -> a'.
// scripts/bench_sha256_chain.py measures the cycles of a compression and
// the variants this design was chosen over.
// Lanes of one warp step through max(blocks) of their messages; a lane past
// its last block idles. Callers that know the lengths sort them longest
// first, so a warp's lengths are close and the longest chains start first.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "sha256_compress.cuh"

namespace {

constexpr int kPairThreads = 64;        // consumer warp 0, producer warp 1
constexpr int kWkHalf = 16 * 32;        // uint4 of one W+K buffer half

__device__ __forceinline__ void pair_barrier() {
  asm volatile("bar.sync 1, %0;" ::"n"(kPairThreads) : "memory");
}

// The schedule of one block plus the round constants, W[r] + K[r] for
// r = 4q .. 4q+3 at wk[q * 32] (sha256_schedule_wk's layout). w: the
// block's 16 big-endian words, overwritten.
__device__ __forceinline__ void schedule_wk(uint32_t w[16], uint4* wk) {
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

// The 64 rounds and the feed-forward from W[r] + K[r] at wk[q * 32].
__device__ __forceinline__ void rounds_wk(uint32_t st[8], const uint4* wk) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
  uint4 v = wk[0];
  uint32_t hw = h + v.x;                    // h + W[0] + K[0]
  uint32_t dhw = d + hw;                    // d + h + W[0] + K[0]
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const uint4 nv = q < 15 ? wk[(q + 1) * 32] : v;
    const uint32_t vv[5] = {v.x, v.y, v.z, v.w, nv.x};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      // e -> e' and a -> a' are three dependent instructions each: a
      // rotation, the LOP3 of the Sigma, one add
      const uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
      const uint32_t ch = (e & f) ^ (~e & g);
      const uint32_t en = S1 + (ch + dhw);          // d + T1
      const uint32_t t1 = S1 + (ch + hw);
      const uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
      const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
      const uint32_t an = S0 + (t1 + maj);          // T1 + T2
      hw = g + vv[u + 1];                   // the next round's h + W + K
      dhw = c + hw;                         // ... and its d + h + W + K
      h = g;
      g = f;
      f = e;
      e = en;
      d = c;
      c = b;
      b = a;
      a = an;
    }
    v = nv;
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

// The chains of one CTA: message `lane` of its 32, of n blocks (0: the
// state stays H0). Source supplies the blocks to the producer warp:
// fetch(l) issues block l's loads, words(l, w) then gives its 16
// big-endian words (padding applied). Returns the final state in the
// consumer warp (warp 0); the producer's st is unspecified.
template <class Source>
__device__ __forceinline__ void chain_pair(Source& src, int n, uint4* wk,
                                           uint32_t st[8]) {
  const int lane = threadIdx.x & 31;
  const int steps = __reduce_max_sync(0xFFFFFFFFu, n);
  if (threadIdx.x >= 32) {                              // producer
    if (n > 0) src.fetch(0);
    for (int l = 0; l < steps; ++l) {
      uint32_t w[16];
      if (l < n) src.words(l, w);
      if (l + 1 < n) src.fetch(l + 1);
      if (l < n) schedule_wk(w, wk + (l & 1) * kWkHalf + lane);
      pair_barrier();
    }
  } else {                                              // consumer
    sha256_init(st);
    for (int l = 0; l < steps; ++l) {
      pair_barrier();
      if (l < n) rounds_wk(st, wk + (l & 1) * kWkHalf + lane);
    }
  }
}

}  // namespace
