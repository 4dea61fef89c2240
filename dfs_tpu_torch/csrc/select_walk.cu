// Kernel 4: the segment-selection walk.
//
// Replaces dfs_tpu/ops/select_pallas.py:make_select_fn_pallas (Pallas body
// kernel; XLA twin ops/cdc_anchored.py:make_select_fn). tiles is
// [2, m_tiles] i32: the first and second kept anchor byte position of each
// tile (2^30 = none). scal = (start0, n, final) lives in device memory so a
// walk chained on a device carry never waits for the host. Per step:
//   lo = start + seg_min, hi = start + seg_max, t0 = (lo - 1) / tile_bytes
//   bound = max kept anchor p in [lo-1, hi-1] over tiles t0..t0+win-1 of
//           both planes, plus 1; else hi
//   once n - start <= seg_max the bound is n and the walk is done; a
//   non-final region does not emit that tail segment.
// bounds [cap] i32 is padded with -1.
//
// One block of one warp: each step the 32 threads scan the 2*win window
// entries and warp max-reduce; thread 0 stores the bound. The steps form
// one dependent chain, so the walk is latency bound.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void select_walk_kernel(const int32_t* __restrict__ tiles,
                                   int m_tiles,
                                   const int32_t* __restrict__ scal,
                                   int32_t* __restrict__ bounds, int cap,
                                   int win, int seg_min, int seg_max,
                                   int tile_bytes) {
  const int lane = threadIdx.x;
  int start = scal[0];
  const int n = scal[1];
  const bool final_region = scal[2] != 0;
  bool done = false;
  int i = 0;
  while (i < cap) {
    const int lo = start + seg_min;
    const int hi = start + seg_max;
    const int t0 = (lo - 1) / tile_bytes;
    int best = -1;
    for (int k = lane; k < win; k += 32) {
      const int t = t0 + k;
      if (t < m_tiles) {
        const int v0 = tiles[t];
        const int v1 = tiles[m_tiles + t];
        if (v0 >= lo - 1 && v0 <= hi - 1) best = max(best, v0);
        if (v1 >= lo - 1 && v1 <= hi - 1) best = max(best, v1);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      best = max(best, __shfl_xor_sync(0xffffffffu, best, off));
    int b = best >= 0 ? best + 1 : hi;
    const bool fin = n - start <= seg_max;
    if (fin) b = n;
    const int out = (done || (fin && !final_region)) ? -1 : b;
    if (lane == 0) bounds[i] = out;
    if (out >= 0) start = b;
    done = done || fin;
    ++i;
    if (done) break;
  }
  for (int j = i + lane; j < cap; j += 32) bounds[j] = -1;
}

}  // namespace

extern "C" int dfs_select_walk(const void* tiles, int m_tiles,
                               const void* scal, void* bounds, int cap,
                               int win, int seg_min, int seg_max,
                               int tile_bytes, void* stream) {
  if (cap > 0) {
    select_walk_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(tiles), m_tiles,
        static_cast<const int32_t*>(scal), static_cast<int32_t*>(bounds), cap,
        win, seg_min, seg_max, tile_bytes);
  }
  return static_cast<int>(cudaGetLastError());
}
