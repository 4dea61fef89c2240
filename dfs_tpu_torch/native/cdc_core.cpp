// Native CPU core of the port's host strategies, a copy of dfs_tpu's
// native/cdc_core.cpp: SHA-256 (one message and a batch), the sequential
// Gear CDC cut selection of the `cdc` strategy, and the anchored two-level
// CDC spans of the `cdc-anchored` host engine (a window of a stream, and a
// whole stream). Loaded with ctypes by dfs_tpu_torch/native/__init__.py,
// which builds it with g++ into dfs_tpu_torch/_build/ at first use.

#include <cstdint>
#include <cstring>
#include <cstddef>
#include <new>

namespace {

constexpr uint32_t K[64] = {
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

inline uint32_t rotr(uint32_t x, int n) {
  return (x >> n) | (x << (32 - n));
}

// lowbias32 finalizer — must match dfs_tpu_torch/ops/cdc_anchored.py and
// ops/cdc_v2.fmix32_np exactly.
inline uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  return x ^ (x >> 16);
}

void compress(uint32_t state[8], const uint8_t* block) {
  uint32_t w[64];
  for (int t = 0; t < 16; ++t) {
    w[t] = (uint32_t(block[4 * t]) << 24) | (uint32_t(block[4 * t + 1]) << 16) |
           (uint32_t(block[4 * t + 2]) << 8) | uint32_t(block[4 * t + 3]);
  }
  for (int t = 16; t < 64; ++t) {
    uint32_t s0 = rotr(w[t - 15], 7) ^ rotr(w[t - 15], 18) ^ (w[t - 15] >> 3);
    uint32_t s1 = rotr(w[t - 2], 17) ^ rotr(w[t - 2], 19) ^ (w[t - 2] >> 10);
    w[t] = w[t - 16] + s0 + w[t - 7] + s1;
  }
  uint32_t a = state[0], b = state[1], c = state[2], d = state[3];
  uint32_t e = state[4], f = state[5], g = state[6], h = state[7];
  for (int t = 0; t < 64; ++t) {
    uint32_t s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    uint32_t ch = (e & f) ^ (~e & g);
    uint32_t t1 = h + s1 + ch + K[t] + w[t];
    uint32_t s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    uint32_t t2 = s0 + maj;
    h = g; g = f; f = e; e = d + t1; d = c; c = b; b = a; a = t1 + t2;
  }
  state[0] += a; state[1] += b; state[2] += c; state[3] += d;
  state[4] += e; state[5] += f; state[6] += g; state[7] += h;
}

}  // namespace

extern "C" {

// SHA-256 of one message; out = 32 raw bytes.
void dfs_sha256(const uint8_t* data, uint64_t len, uint8_t* out) {
  uint32_t st[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
                    0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u};
  uint64_t full = len / 64;
  for (uint64_t i = 0; i < full; ++i) compress(st, data + 64 * i);
  uint8_t tail[128];
  uint64_t rem = len - 64 * full;
  std::memset(tail, 0, sizeof(tail));
  std::memcpy(tail, data + 64 * full, rem);
  tail[rem] = 0x80;
  uint64_t tail_blocks = (rem + 9 <= 64) ? 1 : 2;
  uint64_t bits = len * 8;
  for (int i = 0; i < 8; ++i)
    tail[tail_blocks * 64 - 1 - i] = uint8_t(bits >> (8 * i));
  compress(st, tail);
  if (tail_blocks == 2) compress(st, tail + 64);
  for (int i = 0; i < 8; ++i) {
    out[4 * i] = uint8_t(st[i] >> 24);
    out[4 * i + 1] = uint8_t(st[i] >> 16);
    out[4 * i + 2] = uint8_t(st[i] >> 8);
    out[4 * i + 3] = uint8_t(st[i]);
  }
}

// Batch: messages concatenated in `data`, offsets[i]..offsets[i+1] per
// message (offsets has n+1 entries); out = n * 32 bytes.
void dfs_sha256_batch(const uint8_t* data, const uint64_t* offsets,
                      uint64_t n, uint8_t* out) {
  for (uint64_t i = 0; i < n; ++i)
    dfs_sha256(data + offsets[i], offsets[i + 1] - offsets[i], out + 32 * i);
}

// Sequential Gear CDC cut selection (the algorithm of
// dfs_tpu_torch/ops/boundary.py over the bitmap of
// dfs_tpu_torch/fragmenter/cdc_cpu.py): writes exclusive cut offsets into `cuts`
// (capacity cuts_cap), returns the number written, or -1 on overflow.
// table: 256 uint32 Gear entries; boundary iff (h & mask)==0 at
// length>=min_size; forced cut at max_size.
int64_t dfs_gear_cuts(const uint8_t* data, uint64_t len,
                      const uint32_t* table, uint32_t mask,
                      uint64_t min_size, uint64_t max_size,
                      uint64_t* cuts, uint64_t cuts_cap) {
  uint32_t h = 0;
  uint64_t start = 0, n_cuts = 0;
  for (uint64_t i = 0; i < len; ++i) {
    h = (h << 1) + table[data[i]];
    uint64_t chunk_len = i - start + 1;
    bool cut = (chunk_len >= min_size && (h & mask) == 0) ||
               chunk_len >= max_size;
    if (cut) {
      if (n_cuts == cuts_cap) return -1;
      cuts[n_cuts++] = i + 1;
      start = i + 1;
    }
  }
  if (start < len) {
    if (n_cuts == cuts_cap) return -1;
    cuts[n_cuts++] = len;
  }
  return int64_t(n_cuts);
}

// Anchored two-level CDC spans for ONE WINDOW of a longer stream —
// region edition of dfs_anchored_spans, mirroring the device walk's
// contract (dfs_tpu_torch/ops/cdc_anchored.region_chunks): `lookback` holds
// the 8 stream bytes before data[0] (zeros at true stream start; the
// window base must be tile-aligned in the stream so first-per-tile
// anchor quantization matches the whole-stream result); `start0` is the
// carry position inside the window (bytes before it belong to segments
// a previous window already emitted); `final` != 0 iff the stream ends
// at data[len-1] — otherwise the unfinished tail segment is withheld so
// its bytes carry into the next window. Writes region-local (offset,
// length) pairs; sets *consumed to the bound segments were emitted up
// to (== len when final). Returns the pair count, or -1 on
// overflow/alloc failure.
int64_t dfs_anchored_spans_region(const uint8_t* data, uint64_t len,
                                  const uint8_t* lookback, uint64_t start0,
                                  int final_region, uint32_t anchor_seed,
                                  uint32_t seg_mask, uint64_t seg_min,
                                  uint64_t seg_max, uint64_t tile_bytes,
                                  uint32_t chunk_seed, uint32_t avg_mask,
                                  uint64_t min_blocks, uint64_t max_blocks,
                                  uint64_t* spans, uint64_t span_cap,
                                  uint64_t* consumed) {
  *consumed = start0;
  if (len == 0) return 0;

  // ---- pass A: first TWO qualifying anchors per tile (-1 = none),
  // interleaved [first, second] per tile — mirrors the device pass-A
  // two-plane output (dfs_tpu_torch/ops/cdc_anchored.anchor_tiles) ----
  uint64_t n_tiles = (len + tile_bytes - 1) / tile_bytes;
  int64_t* tile_anchor = new (std::nothrow) int64_t[2 * n_tiles];
  if (!tile_anchor) return -1;
  for (uint64_t t = 0; t < 2 * n_tiles; ++t) tile_anchor[t] = -1;
  uint64_t reg = 0;  // bytes[p-7..p], data[p] in the top byte (LE window)
  for (int i = 0; i < 8; ++i)
    reg = (reg >> 8) | (uint64_t(lookback[i]) << 56);
  for (uint64_t p = 0; p < len; ++p) {
    reg = (reg >> 8) | (uint64_t(data[p]) << 56);
    uint32_t b = uint32_t(reg >> 32);
    uint32_t a = uint32_t(reg);
    uint32_t h = fmix32(fmix32(b) + anchor_seed + a);
    if ((h & seg_mask) == 0) {
      uint64_t t = p / tile_bytes;
      if (tile_anchor[2 * t] < 0) tile_anchor[2 * t] = int64_t(p);
      else if (tile_anchor[2 * t + 1] < 0) tile_anchor[2 * t + 1] = int64_t(p);
    }
  }

  // ---- G table for the aligned windowed Gear (arithmetic form) ----
  uint32_t G[256];
  for (uint32_t v = 0; v < 256; ++v)
    G[v] = fmix32(chunk_seed ^ (v * 0x9E3779B1u));

  // ---- segment walk + per-segment aligned chunking ----
  uint64_t n_spans = 0, start = start0;
  bool ok = true;
  while (ok) {
    uint64_t bound;
    if (len - start <= seg_max) {
      if (!final_region) break;  // tail carries into the next window
      bound = len;               // final segment
    } else {
      // last kept anchor a with start+seg_min <= a+1 <= start+seg_max;
      // within a tile the second kept anchor is the larger, so it is
      // checked first
      uint64_t lo = start + seg_min - 1, hi = start + seg_max - 1;
      int64_t found = -1;
      for (uint64_t t = hi / tile_bytes + 1; t-- > lo / tile_bytes;) {
        for (int j = 1; j >= 0 && found < 0; --j) {
          int64_t a = tile_anchor[2 * t + j];
          if (a >= int64_t(lo) && a <= int64_t(hi)) found = a;
        }
        if (found >= 0) break;
      }
      bound = found >= 0 ? uint64_t(found) + 1 : start + seg_max;
    }

    // aligned chunking of segment [start, bound), grid re-anchored
    uint64_t seg_len = bound - start;
    uint64_t nb = (seg_len + 63) / 64;         // incl. trailing partial
    uint64_t full = seg_len / 64;              // candidate-eligible blocks
    uint64_t since = 0, prev = 0;
    for (uint64_t t = 0; t < nb; ++t) {
      ++since;
      bool cand = false;
      if (t < full) {
        const uint8_t* blk = data + start + 64 * t;
        uint32_t h = 0;
        for (int k = 0; k < 32; ++k) h += G[blk[63 - k]] << k;
        cand = (h & avg_mask) == 0;
      }
      bool cut = (cand && since >= min_blocks) || since >= max_blocks ||
                 t == nb - 1;
      if (cut) {
        if (n_spans == span_cap) { ok = false; break; }
        uint64_t end = (t + 1) * 64 < seg_len ? (t + 1) * 64 : seg_len;
        spans[2 * n_spans] = start + prev * 64;
        spans[2 * n_spans + 1] = end - prev * 64;
        ++n_spans;
        prev = t + 1;
        since = 0;
      }
    }
    if (!ok) break;
    start = bound;
    if (bound == len) break;
  }
  delete[] tile_anchor;
  *consumed = start;
  return ok ? int64_t(n_spans) : -1;
}

// Whole-stream spans — bit-identical to the NumPy oracle
// (dfs_tpu_torch/ops/cdc_anchored.chunk_spans_anchored_np). One final region
// starting from a zero lookback.
int64_t dfs_anchored_spans(const uint8_t* data, uint64_t len,
                           uint32_t anchor_seed, uint32_t seg_mask,
                           uint64_t seg_min, uint64_t seg_max,
                           uint64_t tile_bytes, uint32_t chunk_seed,
                           uint32_t avg_mask, uint64_t min_blocks,
                           uint64_t max_blocks, uint64_t* spans,
                           uint64_t span_cap) {
  uint8_t zeros[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  uint64_t consumed = 0;
  return dfs_anchored_spans_region(
      data, len, zeros, 0, 1, anchor_seed, seg_mask, seg_min, seg_max,
      tile_bytes, chunk_seed, avg_mask, min_blocks, max_blocks, spans,
      span_cap, &consumed);
}

}  // extern "C"
