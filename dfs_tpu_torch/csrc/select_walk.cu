// Kernel 4: the segment-selection walk.
//
// Replaces dfs_tpu/ops/select_pallas.py:make_select_fn_pallas (Pallas body
// kernel; XLA twin ops/cdc_anchored.py:make_select_fn). tiles is
// [2, m_tiles] i32: the first and second kept anchor byte position of each
// tile (2^30 = none), each inside its own tile, the first below the
// second. scal = (start0, n, final) lives in device memory so a walk
// chained on a device carry never waits for the host. Per step, from
// start s (s >= 0):
//   lo = s + seg_min, hi = s + seg_max
//   bound = max kept anchor p in [lo-1, hi-1], plus 1; else hi
//   once n - s <= seg_max the bound is n and the walk is done; a non-final
//   region does not emit that tail segment.
// bounds [cap] i32 is padded with -1.
//
// The TPU kernel scans the 65-tile window of both planes at every step.
// Here a step reads one record. seg_min and seg_max are multiples of the
// tile, so the window's tiles t0 .. tx (tx = t0 + halo, halo = (seg_max -
// seg_min) / tile) hold exactly the bytes around [lo-1, hi-1]; anchors are
// sorted, so the window max is pred(x), the largest kept anchor <= x =
// hi-1 (x clamped to the table's last byte: nothing lies past it),
// whenever pred(x) >= lo-1. With q the largest anchor of the halo tiles
// before tile tx (or of more tiles before it: anything older is below
// lo-1 and fails the test the same way):
//   pred(x) = max(e0 <= x ? e0 : q, e1 <= x ? e1 : q)   from record tx
//
// Two kernels, one launch of the wrapper:
//  1. records, over the whole card: CTA b turns tiles [2048 b, 2048 b +
//     2048) into the planes e0, e1, q of `rec` (3 x m_pad i32, padded with
//     none); q is a prefix max over the CTA's tiles started from the max
//     of the `halo` tiles before them;
//  2. the walk, one warp: the records stream into a ring of 4 chunks of
//     4096 tiles in shared memory through bulk asynchronous copies (TMA),
//     each chunk issued two chunks ahead of the walk and awaited on its
//     mbarrier before the walk may reach it; the walk takes a burst of
//     steps between two such checks, each one shared-memory load and nine
//     dependent integer instructions. A burst is min(8, chunk bytes /
//     seg_max) steps, at least 1: 8 at the default seg_max of 128 KiB,
//     fewer for the larger seg_max that large chunk sizes bring, one step
//     a check once seg_max reaches a chunk's 2 MiB. A check enters every
//     chunk up to the farthest byte the burst reads, so one step may
//     enter several chunks.
// What bounds it on this card: latency. The ~550 steps of a 64 MiB region
// form one dependent chain; the records' bytes (1 MiB in, 1.5 MiB out,
// 1.5 MiB streamed into one SM) and operations are small beside it. A
// single-CTA version that built the records on the walk's own SM (16
// producer warps, one barrier a chunk) was bound by that building instead.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

extern __shared__ __align__(128) unsigned char walk_smem[];

namespace {

constexpr int kNone = 1 << 30;

// ---- kernel 1: records ----
constexpr int kRecThreads = 256;
constexpr int kRecPerThread = 8;
constexpr int kRecTiles = kRecThreads * kRecPerThread;   // a CTA's tiles

__device__ __forceinline__ int anchor_max(int e0, int e1) {
  return max(e0 < kNone ? e0 : -1, e1 < kNone ? e1 : -1);
}

__global__ void __launch_bounds__(kRecThreads)
select_records_kernel(const int32_t* __restrict__ tiles, int m_tiles,
                      int32_t* __restrict__ rec, int m_pad, int halo) {
  __shared__ __align__(16) int v_s[kRecTiles];
  __shared__ int warp_max[kRecThreads / 32];
  __shared__ int halo_max;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int base = blockIdx.x * kRecTiles;
#pragma unroll
  for (int r = 0; r < kRecPerThread; ++r) {
    const int t = base + r * kRecThreads + tid;
    const int e0 = t < m_tiles ? __ldg(tiles + t) : kNone;
    const int e1 = t < m_tiles ? __ldg(tiles + m_tiles + t) : kNone;
    rec[t] = e0;
    rec[m_pad + t] = e1;
    v_s[r * kRecThreads + tid] = anchor_max(e0, e1);
  }
  if (warp == 0) {
    int h = -1;
    for (int k = lane; k < halo; k += 32) {
      const int t = base - halo + k;
      if (t >= 0 && t < m_tiles)
        h = max(h, anchor_max(__ldg(tiles + t), __ldg(tiles + m_tiles + t)));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      h = max(h, __shfl_xor_sync(0xffffffffu, h, off));
    if (lane == 0) halo_max = h;
  }
  __syncthreads();
  int v[kRecPerThread];
  int run = -1;
#pragma unroll
  for (int j = 0; j < kRecPerThread; j += 4) {
    const int4 a =
        *reinterpret_cast<const int4*>(&v_s[tid * kRecPerThread + j]);
    v[j] = a.x;
    v[j + 1] = a.y;
    v[j + 2] = a.z;
    v[j + 3] = a.w;
  }
#pragma unroll
  for (int j = 0; j < kRecPerThread; ++j) run = max(run, v[j]);
  int incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl = max(incl, o);
  }
  int q = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) q = -1;
  if (lane == 31) warp_max[warp] = incl;
  __syncthreads();
  q = max(q, halo_max);
#pragma unroll
  for (int w = 0; w < kRecThreads / 32; ++w)
    if (w < warp) q = max(q, warp_max[w]);
  int4* dst = reinterpret_cast<int4*>(rec + 2 * static_cast<size_t>(m_pad) +
                                      base + tid * kRecPerThread);
#pragma unroll
  for (int j = 0; j < kRecPerThread; j += 4) {
    int4 out;
    out.x = q;
    q = max(q, v[j]);
    out.y = q;
    q = max(q, v[j + 1]);
    out.z = q;
    q = max(q, v[j + 2]);
    out.w = q;
    q = max(q, v[j + 3]);
    dst[j / 4] = out;
  }
}

// ---- kernel 2: the walk ----
constexpr int kChunkShift = 12;
constexpr int kChunk = 1 << kChunkShift;        // tiles a chunk
constexpr int kSlots = 4;                       // chunks in the ring
constexpr int kMaxBurst = 8;                    // steps between checks
constexpr int kRingTiles = kSlots * kChunk;
constexpr int kPlaneBytes = kRingTiles * 4;

// Dynamic shared memory of the walk: the ring's three planes (e0, e1, q;
// chunk k in slot k % kSlots), then one mbarrier a slot.
constexpr int kBarOffset = 3 * kPlaneBytes;
constexpr int kWalkShared = kBarOffset + kSlots * 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t slot_bar(int k) {
  return smem_u32(walk_smem + kBarOffset + (k % kSlots) * 8);
}

__device__ __forceinline__ void wait_chunk(int k) {
  const uint32_t bar = slot_bar(k);
  const uint32_t parity = (k / kSlots) & 1;
  uint32_t ok = 0;
  while (!ok)
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2; selp.u32 %0, 1, 0, p; }"
        : "=r"(ok)
        : "r"(bar), "r"(parity)
        : "memory");
}

// One thread: copy chunk k of the three record planes into its slot.
__device__ __forceinline__ void issue_chunk(const int32_t* rec, int m_pad,
                                            int k) {
  const int slot = k % kSlots;
  const uint32_t bar = slot_bar(k);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(3 * kChunk * 4) : "memory");
#pragma unroll
  for (int p = 0; p < 3; ++p)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];"
        ::"r"(smem_u32(walk_smem + p * kPlaneBytes + slot * kChunk * 4)),
          "l"(rec + static_cast<size_t>(p) * m_pad +
              static_cast<size_t>(k) * kChunk),
          "r"(kChunk * 4), "r"(bar)
        : "memory");
}

// The record at shared address a: e0, e1 and q from the three planes. An
// asm statement, so that it is issued where it stands (before the check
// that its chunk has arrived) and the planes are immediate offsets.
__device__ __forceinline__ void load_record(uint32_t a, int& e0, int& e1,
                                            int& q) {
  asm volatile(
      "ld.shared.b32 %0, [%3];\n\t"
      "ld.shared.b32 %1, [%3+%4];\n\t"
      "ld.shared.b32 %2, [%3+%5];"
      : "=r"(e0), "=r"(e1), "=r"(q)
      : "r"(a), "n"(kPlaneBytes), "n"(2 * kPlaneBytes));
}

__global__ void __launch_bounds__(32, 1)
select_walk_kernel(const int32_t* __restrict__ rec, int m_pad, int m_tiles,
                   const int32_t* __restrict__ scal,
                   int32_t* __restrict__ bounds, int cap, int seg_min,
                   int seg_max, int tile_shift) {
  const int lane = threadIdx.x;
  const int n_chunks = m_pad >> kChunkShift;
  if (lane == 0) {
    for (int k = 0; k < kSlots; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   ::"r"(slot_bar(k)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int k = 0; k < min(kSlots, n_chunks); ++k) issue_chunk(rec, m_pad, k);
  }
  __syncwarp();
  int start = scal[0];
  const int n = scal[1];
  const bool final_region = scal[2] != 0;
  const int x_max = m_tiles > 0 ? (m_tiles << tile_shift) - 1 : 0;
  const int chunk_bytes = kChunk << tile_shift;
  // a tile's byte offset in a ring plane, straight from x; the ring's
  // shared address held in a register (the compiler would otherwise
  // rebuild it from the CTA's cluster id at every step)
  const int off_shift = tile_shift - 2;
  const int off_mask = (kRingTiles - 1) << 2;
  uint32_t ring = smem_u32(walk_smem);
  asm volatile("" : "+r"(ring));
  // A burst's steps read x .. x + reach: each moves x by at most seg_max.
  // burst * seg_max <= chunk_bytes where burst > 1, so a check enters at
  // most one chunk, and the burst then reads only the chunk entered and
  // the one before it; with burst 1 it reads only the chunk of x.
  const int burst = max(1, min(kMaxBurst, chunk_bytes / seg_max));
  const int reach = (burst - 1) * seg_max;
  // Enter chunk cur + 1: wait for it, then refill the slot of chunk
  // cur - 1, which no step reads again, with the chunk kSlots after that.
  int cur = -1, limit = 0;         // steps read x < limit without waiting
  auto enter_next = [&]() {
    ++cur;
    limit += chunk_bytes;
    wait_chunk(cur);
    if (cur >= 2 && cur - 2 + kSlots < n_chunks) {
      __syncwarp();
      if (lane == 0) {
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        issue_chunk(rec, m_pad, cur - 2 + kSlots);
      }
    }
  };
  int x = min(start + seg_max - 1, x_max);
  int i = 0;
  // One step from the record at x; true when the walk is done.
  auto finish = [&](int e0, int e1, int q) {
    const bool fin = n - start <= seg_max;
    const int lo1 = fin ? INT_MAX : start + seg_min - 1;
    const int alt = fin ? n : start + seg_max;
    const int pred = max(e0 <= x ? e0 : q, e1 <= x ? e1 : q);
    const bool hit = pred >= lo1;
    const int b = hit ? pred + 1 : alt;
    if (lane == 0) bounds[i] = fin && !final_region ? -1 : b;
    start = b;
    // the next x from both candidates at once
    x = hit ? min(pred + seg_max, x_max) : min(alt + seg_max - 1, x_max);
    ++i;
    return fin || i >= cap;
  };
  auto step = [&]() {
    int e0, e1, q;
    load_record(ring + ((x >> off_shift) & off_mask), e0, e1, q);
    return finish(e0, e1, q);
  };
  // One burst an iteration, with no check between its steps: the chunks
  // they read are entered first. The first record is read before that
  // check (which so stays off the chain) and again after a rare entry.
  // The loop is compiled twice, so that the default geometry's burst of 8
  // is written out with no branch on the burst inside it.
  auto walk = [&](auto written_out) {
    for (;;) {
      const uint32_t a = ring + ((x >> off_shift) & off_mask);
      int e0, e1, q;
      load_record(a, e0, e1, q);
      if (min(x + reach, x_max) >= limit) {
        while (min(x + reach, x_max) >= limit) enter_next();
        load_record(a, e0, e1, q);
      }
      if constexpr (decltype(written_out)::value) {
        static_assert(kMaxBurst == 8, "the burst below is written out");
        if (finish(e0, e1, q) || step() || step() || step() || step() ||
            step() || step() || step())
          return;
      } else {
        bool done = finish(e0, e1, q);
        for (int j = 1; j < burst && !done; ++j) done = step();
        if (done) return;
      }
    }
  };
  if (burst == kMaxBurst)
    walk(std::true_type{});
  else
    walk(std::false_type{});
  for (int j = i + lane; j < cap; j += 32) bounds[j] = -1;
  // the copies still in flight land before the CTA's shared memory goes
  const int last = min(n_chunks - 1, max(kSlots - 1, cur - 2 + kSlots));
  for (int k = cur + 1; k <= last; ++k) wait_chunk(k);
}

}  // namespace

// The i32 count of the records scratch for a table of m_tiles tiles:
// three planes of m_pad, m_tiles rounded up to whole chunks.
static int record_pad(int m_tiles) {
  return max(1, (m_tiles + kChunk - 1) / kChunk) * kChunk;
}

extern "C" int dfs_select_walk_records(int m_tiles) {
  return 3 * record_pad(m_tiles);
}

// rec: scratch of dfs_select_walk_records(m_tiles) i32.
extern "C" int dfs_select_walk(const void* tiles, int m_tiles,
                               const void* scal, void* bounds, int cap,
                               int seg_min, int seg_max, int tile_shift,
                               void* rec, void* stream) {
  if (cap <= 0) return static_cast<int>(cudaGetLastError());
  if (m_tiles < 0 || tile_shift < 2 || seg_max <= 0 || seg_min > seg_max)
    return static_cast<int>(cudaErrorInvalidValue);
  const int m_pad = record_pad(m_tiles);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  select_records_kernel<<<m_pad / kRecTiles, kRecThreads, 0, st>>>(
      static_cast<const int32_t*>(tiles), m_tiles,
      static_cast<int32_t*>(rec), m_pad, (seg_max - seg_min) >> tile_shift);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(select_walk_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kWalkShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  select_walk_kernel<<<1, 32, kWalkShared, st>>>(
      static_cast<const int32_t*>(rec), m_pad, m_tiles,
      static_cast<const int32_t*>(scal), static_cast<int32_t*>(bounds), cap,
      seg_min, seg_max, tile_shift);
  return static_cast<int>(cudaGetLastError());
}
