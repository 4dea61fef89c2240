// Kernel 3: byte swap + transpose, [rows, cols] u32 LE -> [cols, rows] BE.
//
// Replaces dfs_tpu/ops/layout.py:bswap_transpose (Pallas body _kernel):
// out[c, r] = bswap32(x[r, c]).
//
// Shared-memory tiled transpose: a 32x32 tile (one word of padding per
// row, so the column reads hit 32 different banks), 32x8 threads, each
// thread moving four words. Reads run along input rows and writes along
// output rows, so both are coalesced; __byte_perm does the swap. Bound by
// bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kRowsPerPass = 8;

__global__ void bswap_transpose_kernel(const uint32_t* __restrict__ x,
                                       uint32_t* __restrict__ out, int rows,
                                       int cols) {
  __shared__ uint32_t tile[kTile][kTile + 1];
  const int c0 = blockIdx.x * kTile;
  const int r0 = blockIdx.y * kTile;
  for (int j = threadIdx.y; j < kTile; j += kRowsPerPass) {
    const int r = r0 + j, c = c0 + threadIdx.x;
    if (r < rows && c < cols)
      tile[j][threadIdx.x] = x[static_cast<size_t>(r) * cols + c];
  }
  __syncthreads();
  for (int j = threadIdx.y; j < kTile; j += kRowsPerPass) {
    const int c = c0 + j, r = r0 + threadIdx.x;
    if (c < cols && r < rows)
      out[static_cast<size_t>(c) * rows + r] =
          __byte_perm(tile[threadIdx.x][j], 0, 0x0123);
  }
}

}  // namespace

extern "C" int dfs_bswap_transpose(const void* x, void* out, int rows,
                                   int cols, void* stream) {
  if (rows > 0 && cols > 0) {
    dim3 block(kTile, kRowsPerPass);
    dim3 grid((cols + kTile - 1) / kTile, (rows + kTile - 1) / kTile);
    bswap_transpose_kernel<<<grid, block, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), rows,
        cols);
  }
  return static_cast<int>(cudaGetLastError());
}
