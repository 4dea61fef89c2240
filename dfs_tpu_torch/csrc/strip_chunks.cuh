// Chunk-parallel strip SHA-256, shared by kernel 1 (strip_chunk_states.cu)
// and kernel 5 (strip_states.cu): chunk_chains_kernel computes the states
// of every chunk that a cutflag column (nonzero = last block of a chunk)
// cuts out of its lane, one chain per chunk.
//
// SHA-256 is sequential within a chunk, so a launch takes at least its
// longest chunk's chain of compressions, and on this card one chain is
// bound by the ALU issue rate of the SM sub-partition (scheduler) that runs
// it: a round is about 12 ALU instructions (SHF, LOP3, IADD3), and one
// warp's ALU instructions issue at most every other cycle. A chunk's
// blocks also sit anywhere in the lane-minor layout, so each block costs
// 16 loads and 8 stores that touch 24 separate 32-byte sectors. The design
// keeps both off the chain:
//  - three warps per CTA, on three schedulers (warp w runs on
//    sub-partition w % 4): a consumer warp runs only the 64 rounds of its
//    chunks' blocks, reading W[t]+K[t] from shared memory; a producer warp
//    prefetches the next block's 16 words and computes its message
//    schedule into the other half of a double buffer; a storer warp writes
//    the state the consumer left in shared memory one block earlier. One
//    named barrier per block hands both buffers over;
//  - the CTA's slots (one chain per thread of each warp, up to 32) take
//    its chunks longest first, each into the slot with the least work so
//    far, so a slot chains several short chunks in turn while the longest
//    runs alone; only as many slots are used as the CTA's work needs to
//    finish with its longest chunk, because the scattered loads and stores
//    of the chains in flight slow every block of the SM;
//  - about one CTA per SM (lanes_per_cta).
// A lane's rows after its last flagged block (its dead rows) are read by
// no consumer of the states and are stored as 0.
//
// Two layouts of the CTA's chunk tables, one template each:
//  - narrow (lanes of up to 65,536 blocks whose lists fit, the default
//    geometry): the tables in shared memory, a chunk packed as (lane << 16
//    | last block), 16-bit ranks, at most kMaxChunks chunks a CTA, ranked
//    exactly longest first;
//  - wide (lanes of up to 2^20 blocks, 64 MiB: restic's and Borg's 8 MiB
//    chunks, dfs_tpu's 32 MiB lanes): only the flag bitmaps in shared
//    memory (a lane of 2^19 blocks is 64 KiB), the tables in a device
//    scratch the wrapper sizes at 3 words a list entry, a chunk packed as
//    (lane << 20 | last block) with 32-bit ranks, ranked longest first by
//    length class (floor(log2 blocks)), so a CTA of 2^19 one-block chunks
//    ranks in linear time. A chunk's table entries are read only when a
//    slot moves to its next chunk, so their home costs the chains nothing.
//
// Layouts (S lanes, bps blocks per lane):
//   words_t  [bps*16, S] u32  BE word w of block t of lane s at [t*16+w, s]
//   cutflag  [bps, S]    i32  nonzero after the last block of a chunk
//   states   [bps*8, S]  u32  post-block chain state word i at [t*8+i, s]
//   scratch  [3*S*cap]   u32  wide only: the CTA of lanes s0 .. s0+n-1
//                             keeps its lists at [3*s0*cap, 3*(s0+n)*cap)

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "sha256_compress.cuh"

namespace {

constexpr int kSlots = 32;                 // chains in flight per CTA
constexpr int kChainThreads = 3 * 32;      // consumer, producer, storer
constexpr int kDefaultShared = 48 * 1024;  // dynamic, without opt-in
constexpr int kMaxShared = 232448;         // 227 KB, the opt-in limit
constexpr int kMaxChunks = 65534;          // narrow, per CTA: 16-bit ranks
constexpr int kWkBytes = 2 * 16 * 32 * 16;    // W+K double buffer
constexpr int kStBytes = 2 * 2 * 32 * 16;     // state double buffer
constexpr int kClasses = 32;                  // wide: length classes
constexpr int kMaxWideBlocks = 1 << 20;       // wide: 20-bit block field
constexpr int kMaxWideLanes = 1 << 12;        // wide: 12-bit lane field
constexpr int kChainStatic = 16;              // static shared, rounded up

template <bool kWide>
struct Layout {
  using Rank = uint16_t;
  static constexpr int kShift = 16;
  static constexpr uint32_t kLast = 0xFFFFu;
  static constexpr uint32_t kNone = 0xFFFFu;   // end of a slot's list
};

template <>
struct Layout<true> {
  using Rank = uint32_t;
  static constexpr int kShift = 20;
  static constexpr uint32_t kLast = 0xFFFFFu;
  static constexpr uint32_t kNone = 0xFFFFFFFFu;
};

// Shared memory of a chain CTA: the W+K and state double buffers, per slot
// (first chunk, work), per lane (count, base, live end) and a flag bitmap
// of bps bits; narrow: per chunk a packed word, its 16-bit entry of the
// rank order and its successor in its slot; wide: two counters a length
// class.
__host__ __device__ inline size_t chain_shared_bytes(int lanes, int cap,
                                                     int bps, bool wide) {
  const size_t chunks = static_cast<size_t>(lanes) * cap;
  const size_t fixed = kWkBytes + kStBytes + kSlots * 8 +
                       static_cast<size_t>(lanes) * (12 + (bps + 31) / 32 * 4);
  return wide ? fixed + 2 * kClasses * 4
              : fixed + chunks * 4 + 2 * ((chunks * 2 + 3) / 4 * 4);
}

struct Chunk {
  int j, start, last;   // lane within the CTA, first and last block
};

// Chunk g of the CTA (in lane-major stream order).
template <bool kWide>
__device__ __forceinline__ Chunk chunk_at(int g, const uint32_t* chunks,
                                          const int* base) {
  using L = Layout<kWide>;
  const uint32_t p = chunks[g];
  Chunk c;
  c.j = static_cast<int>(p >> L::kShift);
  c.last = static_cast<int>(p & L::kLast);
  c.start = g > base[c.j] ? static_cast<int>(chunks[g - 1] & L::kLast) + 1
                          : 0;
  return c;
}

// A slot's position: block t of the chunk c with rank r, while live.
struct Cursor {
  Chunk c;
  uint32_t r;
  int t;
  bool live;
};

template <bool kWide>
struct Lists {               // the CTA's chunk tables
  using Rank = typename Layout<kWide>::Rank;
  const uint32_t* chunks;
  const int* base;
  const Rank* order;         // rank -> chunk
  const Rank* next;          // rank -> next rank of the same slot
};

template <bool kWide>
__device__ __forceinline__ Cursor cursor_at(uint32_t r,
                                            const Lists<kWide>& l) {
  Cursor u;
  u.r = r;
  u.live = r != Layout<kWide>::kNone;
  if (u.live) {
    u.c = chunk_at<kWide>(l.order[r], l.chunks, l.base);
    u.t = u.c.start;
  }
  return u;
}

template <bool kWide>
__device__ __forceinline__ Cursor advance(Cursor u, const Lists<kWide>& l) {
  if (u.live && ++u.t > u.c.last) u = cursor_at(l.next[u.r], l);
  return u;
}

__device__ __forceinline__ void load_words(
    const uint32_t* __restrict__ words_t, size_t S, int s_lo,
    const Cursor& u, uint32_t w[16]) {
  const uint32_t* src = words_t + static_cast<size_t>(u.t) * 16 * S + s_lo +
                        u.c.j;
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = __ldg(src + i * S);
}

__device__ __forceinline__ void chain_barrier() {
  asm volatile("bar.sync 1, %0;" ::"n"(kChainThreads) : "memory");
}

// One CTA per `lanes` consecutive lanes, at most `cap` chunks a lane.
template <bool kWide>
__global__ void __launch_bounds__(kChainThreads) chunk_chains_kernel(
    const uint32_t* __restrict__ words_t, const int32_t* __restrict__ cutflag,
    uint32_t* __restrict__ states, int bps, int S, int lanes, int cap,
    uint32_t* __restrict__ scratch) {
  using L = Layout<kWide>;
  using Rank = typename L::Rank;
  extern __shared__ __align__(16) unsigned char chain_smem[];
  const int n_words = (bps + 31) / 32;
  const int s_lo = blockIdx.x * lanes;
  const int n_lanes = min(lanes, S - s_lo);
  uint4* wk = reinterpret_cast<uint4*>(chain_smem);        // [2][16][32]
  uint4* sb = wk + 2 * 16 * 32;                            // [2][2][32]
  uint32_t* head = reinterpret_cast<uint32_t*>(sb + 2 * 2 * 32);  // [kSlots]
  int* work = reinterpret_cast<int*>(head + kSlots);       // [kSlots]
  int* cnt = work + kSlots;                                // [lanes]
  int* base = cnt + lanes;                                 // [lanes]
  int* live_end = base + lanes;                            // [lanes]
  uint32_t* flags = reinterpret_cast<uint32_t*>(live_end + lanes);
  uint32_t* chunks;                                        // [n_cap]
  Rank* order;                                             // [n_cap]
  Rank* next;                                              // [n_cap]
  int* cls = nullptr;          // wide: [2][kClasses] counts, then cursors
  if constexpr (kWide) {
    const size_t n_cap = static_cast<size_t>(n_lanes) * cap;
    chunks = scratch + static_cast<size_t>(s_lo) * 3 * cap;
    order = chunks + n_cap;
    next = order + n_cap;
    cls = reinterpret_cast<int*>(flags + lanes * n_words);
  } else {
    const size_t n_cap = static_cast<size_t>(lanes) * cap;
    chunks = flags + lanes * n_words;
    order = reinterpret_cast<Rank*>(chunks + n_cap);
    next = order + (n_cap + 1) / 2 * 2;
  }
  __shared__ int n_chunks;

  const size_t S64 = static_cast<size_t>(S);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;

  // the flag rows of the CTA's lanes (neighbouring threads on neighbouring
  // lanes of one row) into per-lane bitmaps
  for (int i = threadIdx.x; i < n_lanes * n_words; i += blockDim.x)
    flags[i] = 0;
  if constexpr (kWide)
    for (int i = threadIdx.x; i < 2 * kClasses; i += blockDim.x) cls[i] = 0;
  __syncthreads();
#pragma unroll 4
  for (int idx = threadIdx.x; idx < n_lanes * bps; idx += blockDim.x) {
    const int j = idx % n_lanes, t = idx / n_lanes;
    if (cutflag[static_cast<size_t>(t) * S64 + s_lo + j] != 0)
      atomicOr(&flags[j * n_words + (t >> 5)], 1u << (t & 31));
  }
  __syncthreads();

  // the chunk list, lane by lane in stream order: count each lane's
  // flags, then place its chunks at its base, 32 bitmap words per step
  // (a warp prefix sum of popcounts gives each word's offset)
  for (int j = warp; j < n_lanes; j += n_warps) {
    int c = 0;
    for (int w = lane; w < n_words; w += 32)
      c += __popc(flags[j * n_words + w]);
    c = __reduce_add_sync(0xFFFFFFFFu, c);
    if (lane == 0) cnt[j] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int b = 0;
    for (int j = 0; j < n_lanes; ++j) {
      base[j] = b;
      b += cnt[j];
    }
    n_chunks = b;
  }
  __syncthreads();
  for (int j = warp; j < n_lanes; j += n_warps) {
    int k = base[j];
    for (int w0 = 0; w0 < n_words; w0 += 32) {
      const int wi = w0 + lane;
      uint32_t b = wi < n_words ? flags[j * n_words + wi] : 0u;
      const int c = __popc(b);
      int incl = c;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(0xFFFFFFFFu, incl, off);
        if (lane >= off) incl += v;
      }
      for (int i = k + incl - c; b; b &= b - 1)
        chunks[i++] = (static_cast<uint32_t>(j) << L::kShift) |
                      static_cast<uint32_t>((wi << 5) + __ffs(b) - 1);
      k += __shfl_sync(0xFFFFFFFFu, incl, 31);
    }
    __syncwarp();
    if (lane == 0)
      live_end[j] = cnt[j] ? static_cast<int>(chunks[k - 1] & L::kLast) + 1
                           : 0;
  }
  __syncthreads();

  // rank the chunks, longest first (narrow: exactly, ties by position;
  // wide: by length class, in any order within a class); zero the dead
  // rows
  const int n = n_chunks;
  if constexpr (kWide) {
    for (int g = threadIdx.x; g < n; g += blockDim.x) {
      const Chunk cg = chunk_at<kWide>(g, chunks, base);
      atomicAdd(&cls[31 - __clz(cg.last - cg.start + 1)], 1);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int b = 0;
      for (int k = kClasses - 1; k >= 0; --k) {
        cls[kClasses + k] = b;
        b += cls[k];
      }
    }
    __syncthreads();
    for (int g = threadIdx.x; g < n; g += blockDim.x) {
      const Chunk cg = chunk_at<kWide>(g, chunks, base);
      const int k = 31 - __clz(cg.last - cg.start + 1);
      order[atomicAdd(&cls[kClasses + k], 1)] = static_cast<Rank>(g);
    }
  } else {
    for (int g = threadIdx.x; g < n; g += blockDim.x) {
      const Chunk cg = chunk_at<kWide>(g, chunks, base);
      const int lg = cg.last - cg.start;
      int r = 0;
      for (int h = 0; h < n; ++h) {
        const Chunk ch = chunk_at<kWide>(h, chunks, base);
        const int lh = ch.last - ch.start;
        r += (lh > lg) || (lh == lg && h < g);
      }
      order[r] = static_cast<Rank>(g);
    }
  }
  for (int idx = threadIdx.x; idx < n_lanes * bps; idx += blockDim.x) {
    const int j = idx % n_lanes, t = idx / n_lanes;
    if (t >= live_end[j]) {
      uint32_t* dst = states + static_cast<size_t>(t) * 8 * S64 + s_lo + j;
#pragma unroll
      for (int i = 0; i < 8; ++i) dst[i * S64] = 0u;
    }
  }
  __syncthreads();

  // deal the chunks, longest first, each to the slot with the least work
  // so far (warp 0: lane i keeps slot i's work and its list's tail), over
  // just enough slots that the CTA's work W packs under its longest chunk
  // L: W / L + 2 of them. Fewer chains in flight make every block faster,
  // since their scattered loads and stores share the SM's memory pipe
  // with the consumer's shared-memory reads.
  if (warp == 0) {
    int total = 0, longest = 1;
    for (int r = lane; r < n; r += 32) {
      const Chunk c = chunk_at<kWide>(order[r], chunks, base);
      total += c.last - c.start + 1;
      longest = max(longest, c.last - c.start + 1);
    }
    total = __reduce_add_sync(0xFFFFFFFFu, total);
    longest = __reduce_max_sync(0xFFFFFFFFu, longest);
    const int in_use = min(kSlots, total / longest + 2);
    int load = 0, last = -1;
    head[lane] = L::kNone;
    for (int r = 0; r < n; ++r) {
      const Chunk c = chunk_at<kWide>(order[r], chunks, base);
      const unsigned key = lane < in_use
                               ? (static_cast<unsigned>(load) << 5) | lane
                               : 0xFFFFFFFFu;
      if (__reduce_min_sync(0xFFFFFFFFu, key) == key) {
        if (last < 0)
          head[lane] = r;
        else
          next[last] = static_cast<Rank>(r);
        last = r;
        load += c.last - c.start + 1;
      }
    }
    if (last >= 0) next[last] = static_cast<Rank>(L::kNone);
    work[lane] = load;
  }
  __syncthreads();

  // the chains: thread i of each warp serves slot i; the three walk the
  // slot's chunks in the same order and meet at the barrier once a block
  const int steps = __reduce_max_sync(0xFFFFFFFFu, work[lane]);
  const Lists<kWide> l{chunks, base, order, next};
  Cursor cur = cursor_at(head[lane], l);
  if (warp == 1) {                                   // producer
    uint32_t w[16], nw[16];
    Cursor nxt = advance(cur, l);
    if (cur.live) load_words(words_t, S64, s_lo, cur, w);
    for (int step = 0; step < steps; ++step) {
      if (nxt.live) load_words(words_t, S64, s_lo, nxt, nw);
      if (cur.live) sha256_schedule_wk(w, wk + (step & 1) * 16 * 32 + lane);
      chain_barrier();
#pragma unroll
      for (int i = 0; i < 16; ++i) w[i] = nw[i];
      cur = nxt;
      nxt = advance(nxt, l);
    }
    chain_barrier();
  } else if (warp == 0) {                            // consumer
    uint32_t st[8];
    for (int step = 0; step < steps; ++step) {
      chain_barrier();
      if (cur.live) {
        if (cur.t == cur.c.start) sha256_init(st);
        sha256_rounds_wk(st, wk + (step & 1) * 16 * 32 + lane);
        uint4* out = sb + (step & 1) * 2 * 32 + lane;
        out[0] = make_uint4(st[0], st[1], st[2], st[3]);
        out[32] = make_uint4(st[4], st[5], st[6], st[7]);
      }
      cur = advance(cur, l);
    }
    chain_barrier();
  } else if (warp == 2) {                            // storer
    Cursor prv;
    prv.live = false;
    for (int step = 0; step <= steps; ++step) {
      chain_barrier();
      if (prv.live) {
        const uint4* in = sb + ((step - 1) & 1) * 2 * 32 + lane;
        const uint4 lo = in[0], hi = in[32];
        uint32_t* dst = states + static_cast<size_t>(prv.t) * 8 * S64 +
                        s_lo + prv.c.j;
        dst[0] = lo.x; dst[S64] = lo.y; dst[2 * S64] = lo.z;
        dst[3 * S64] = lo.w; dst[4 * S64] = hi.x; dst[5 * S64] = hi.y;
        dst[6 * S64] = hi.z; dst[7 * S64] = hi.w;
      }
      prv = cur;
      cur = advance(cur, l);
    }
  }
}

// Lanes per chain CTA: about one CTA per SM, as far as shared memory and
// the layout's fields let (0: not even one lane fits).
inline int lanes_per_cta(int S, int cap, int bps, int sms, bool wide) {
  int lanes = (S + sms - 1) / sms;
  if (wide && lanes > kMaxWideLanes) lanes = kMaxWideLanes;
  while (lanes > 0 &&
         (chain_shared_bytes(lanes, cap, bps, wide) +
                  (wide ? kChainStatic : 0) >
              static_cast<size_t>(kMaxShared) ||
          (!wide && static_cast<long long>(lanes) * cap > kMaxChunks)))
    --lanes;
  return lanes;
}

// Enqueue chunk_chains_kernel over all S lanes (at most cap chunks a lane)
// on the current device. Wide: scratch holds 3 * S * cap words.
inline cudaError_t launch_chunk_chains(const uint32_t* words_t,
                                       const int32_t* cutflag,
                                       uint32_t* states, int bps, int S,
                                       int cap, bool wide, uint32_t* scratch,
                                       cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int lanes = lanes_per_cta(S, cap, bps, sms > 0 ? sms : 1, wide);
  if (lanes < 1 || bps > (wide ? kMaxWideBlocks : 65536) || cap < 1 ||
      (wide && scratch == nullptr))
    return cudaErrorInvalidValue;
  const size_t shared = chain_shared_bytes(lanes, cap, bps, wide);
  auto kernel = wide ? chunk_chains_kernel<true> : chunk_chains_kernel<false>;
  if (shared > static_cast<size_t>(kDefaultShared)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(shared));
    if (err != cudaSuccess) return err;
  }
  kernel<<<(S + lanes - 1) / lanes, kChainThreads, shared, stream>>>(
      words_t, cutflag, states, bps, S, lanes, cap, scratch);
  return cudaGetLastError();
}

}  // namespace
