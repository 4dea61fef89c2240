// Kernel 2: segment repack — one lane per segment, byte-phase funnel shift.
//
// Replaces dfs_tpu/ops/repack.py:repack_lanes (Pallas body
// _make_kernel.kernel). out[s, i] = (words[o+i] >> sh) | (words[o+i+1] <<
// (32 - sh)) with o = w_off[s] (clamped like the twin's dynamic_slice to
// the last window that fits) and sh = sh8[s] in {0, 8, 16, 24}.
//
// Grid over (word chunk, lane), one output word per thread: neighbouring
// threads read neighbouring words and write neighbouring words, so both
// sides coalesce and the one-word look-ahead hits L1. Bound by bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void repack_lanes_kernel(const uint32_t* __restrict__ words,
                                    long long m_total,
                                    const int32_t* __restrict__ w_off,
                                    const uint32_t* __restrict__ sh8,
                                    uint32_t* __restrict__ out,
                                    int lane_words) {
  const int s = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lane_words) return;
  long long o = w_off[s];
  const long long hi = m_total - lane_words - 1;
  o = o < 0 ? 0 : (o > hi ? hi : o);
  const uint32_t lo_w = words[o + i];
  const uint32_t hi_w = words[o + i + 1];
  out[static_cast<size_t>(s) * lane_words + i] =
      __funnelshift_r(lo_w, hi_w, sh8[s]);
}

}  // namespace

extern "C" int dfs_repack_lanes(const void* words, long long m_total,
                                const void* w_off, const void* sh8, void* out,
                                int s_pad, int lane_words, void* stream) {
  if (s_pad > 0 && lane_words > 0) {
    const int threads = 256;
    dim3 grid((lane_words + threads - 1) / threads, s_pad);
    repack_lanes_kernel<<<grid, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(words), m_total,
        static_cast<const int32_t*>(w_off),
        static_cast<const uint32_t*>(sh8), static_cast<uint32_t*>(out),
        lane_words);
  }
  return static_cast<int>(cudaGetLastError());
}
