// Kernel 7: SHA-256 of byte spans of one device-resident array, in one
// launch for any number of spans.
//
// Replaces no Pallas kernel: dfs_tpu computes this stage with XLA
// (dfs_tpu/ops/pack_jax.py:28 digest_gathered: per power-of-two length
// bucket, gather each span's bytes with a [B, l64] index matrix, apply
// the FIPS 180-4 padding arithmetically, pack big-endian words, run the
// batched scan). Here the gather, the padding and the packing happen in
// the kernel, so a whole chunk table is one launch with no temporaries.
//
//   data    [M] u8   the resident bytes
//   spans   [3, N] i32  starts, lengths (0 <= len < 2^31: up to 2^25 + 1
//                       blocks, counted in 64 bits), and the order: thread t
//                       hashes span order[t] and writes its row, so the
//                       output stays in input order
//   out     [N, 8] u32  the SHA-256 state of each padded span
//
// What bounds it on this card: the chain of dependent compressions of the
// longest span (a 64 KiB chunk is 1,025 blocks), not bytes or operations.
// The design (sha256_chain.cuh): 32 spans a CTA, the rounds alone in the
// consumer warp; the producer warp builds each block. The wrapper orders
// the spans longest first, so the longest chains start in the first wave
// and a warp's 32 lanes carry lengths close to each other. A span starts
// at any byte: the producer issues only aligned 16-byte loads (the five
// that cover the block's 64 bytes, and only those that hold a byte of the
// span), then shifts the words into place and byte-swaps them with one
// PRMT each, and builds the 0x80 byte, the zeros and the big-endian bit
// length of the last one or two blocks in registers. A 16-byte piece that
// is not wholly inside the array (its first or last piece) is read byte
// by byte, so nothing outside [data, data + M) is read.

#include <cstdint>
#include <cuda_runtime.h>

#include "sha256_chain.cuh"

namespace {

// The bytes of the aligned 16-byte piece at c that lie in [lo, hi), zeros
// elsewhere (the slow path for the array's edges).
__device__ __noinline__ uint4 load_edge(uintptr_t c, uintptr_t lo,
                                        uintptr_t hi) {
  uint32_t v[4] = {0u, 0u, 0u, 0u};
  for (int j = 0; j < 16; ++j) {
    const uintptr_t p = c + j;
    if (p >= lo && p < hi)
      v[j >> 2] |= static_cast<uint32_t>(
                       *reinterpret_cast<const uint8_t*>(p))
                   << (8 * (j & 3));
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// One span's padded blocks, built from aligned loads.
struct SpanSource {
  uintptr_t a0;       // the span's first byte
  uintptr_t lo, hi;   // the array
  int len;
  int last;           // its last block: (len + 8) / 64, taken in 64 bits
  uint32_t sel;       // PRMT selector: BE word from a byte offset (a0 & 3)
  uint32_t q;         // word offset within the 16-byte piece: (a0 >> 2) & 3
  uint4 raw[5];

  __device__ __forceinline__ void fetch(int l) {
    const uintptr_t a = a0 + 64 * static_cast<uintptr_t>(l);
    const uintptr_t base = a & ~static_cast<uintptr_t>(15);
    const uintptr_t span_end = a0 + static_cast<uintptr_t>(len);
    const uintptr_t end = span_end < a + 64 ? span_end : a + 64;
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const uintptr_t c = base + 16 * i;
      if (c >= end) {
        raw[i] = make_uint4(0u, 0u, 0u, 0u);
      } else if (c >= lo && c + 16 <= hi) {
        raw[i] = __ldg(reinterpret_cast<const uint4*>(c));
      } else {
        raw[i] = load_edge(c, lo, hi);
      }
    }
  }

  __device__ __forceinline__ void words(int l, uint32_t w[16]) const {
    uint32_t d[20];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      d[4 * i] = raw[i].x; d[4 * i + 1] = raw[i].y;
      d[4 * i + 2] = raw[i].z; d[4 * i + 3] = raw[i].w;
    }
    // the 17 words from word q on, by two selects on q's bits
    uint32_t t[19];
#pragma unroll
    for (int k = 0; k < 19; ++k) t[k] = (q & 1) ? d[k + 1] : d[k];
    uint32_t s[17];
#pragma unroll
    for (int k = 0; k < 17; ++k) s[k] = (q & 2) ? t[k + 2] : t[k];
#pragma unroll
    for (int k = 0; k < 16; ++k) w[k] = __byte_perm(s[k], s[k + 1], sel);
    // span bytes left here (64 * l passes 2^31 in a span's last block)
    const long long left = static_cast<long long>(len) - 64LL * l;
    if (left < 64) {                          // the FIPS padding
      const int rel = static_cast<int>(left);  // >= -8
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int r = rel - 4 * k;
        if (r < 4) {
          const uint32_t keep = r > 0 ? w[k] & (0xFFFFFFFFu << (32 - 8 * r))
                                      : 0u;
          w[k] = r >= 0 ? keep | (0x80u << (24 - 8 * r)) : 0u;
        }
      }
      if (l == last) {
        w[14] = static_cast<uint32_t>(len) >> 29;
        w[15] = static_cast<uint32_t>(len) << 3;
      }
    }
  }
};

__global__ void __launch_bounds__(kPairThreads)
sha256_spans_kernel(const uint8_t* __restrict__ data, long long m,
                    const int32_t* __restrict__ spans,
                    uint32_t* __restrict__ out, int n_spans) {
  __shared__ uint4 wk[2 * kWkHalf];
  const int t = blockIdx.x * 32 + (threadIdx.x & 31);
  const int span = t < n_spans ? spans[2 * n_spans + t] : 0;
  SpanSource src;
  src.lo = reinterpret_cast<uintptr_t>(data);
  src.hi = src.lo + static_cast<uintptr_t>(m);
  src.a0 = src.lo + static_cast<uintptr_t>(t < n_spans ? spans[span] : 0);
  src.len = t < n_spans ? spans[n_spans + span] : 0;
  src.last = static_cast<int>((static_cast<long long>(src.len) + 8) / 64);
  const uint32_t b = static_cast<uint32_t>(src.a0 & 3);
  src.sel = (b + 3) | (b + 2) << 4 | (b + 1) << 8 | b << 12;
  src.q = static_cast<uint32_t>(src.a0 >> 2) & 3;
  uint32_t st[8];
  chain_pair(src, t < n_spans ? src.last + 1 : 0, wk, st);
  if (threadIdx.x < 32 && t < n_spans) {
#pragma unroll
    for (int i = 0; i < 8; ++i) out[static_cast<size_t>(span) * 8 + i] = st[i];
  }
}

}  // namespace

extern "C" int dfs_sha256_spans(const void* data, long long m,
                                const void* spans, void* out, int n_spans,
                                void* stream) {
  if (n_spans > 0) {
    sha256_spans_kernel<<<(n_spans + 31) / 32, kPairThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(data), m,
        static_cast<const int32_t*>(spans), static_cast<uint32_t*>(out),
        n_spans);
  }
  return static_cast<int>(cudaGetLastError());
}
