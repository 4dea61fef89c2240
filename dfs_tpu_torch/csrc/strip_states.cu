// Kernel 5: the SHA-256 strip scan with the chunk cuts given.
//
// Replaces dfs_tpu/ops/sha256_strip.py:strip_states (Pallas body
// _strip_kernel). Layouts (S lanes, bps blocks per lane):
//   words_t  [bps*16, S] u32  BE word w of block t of lane s at [t*16+w, s]
//   cutflag  [bps, S]    i32  nonzero after the last block of a chunk
//   states   [bps*8, S]  u32  post-block chain state word i at [t*8+i, s]
// A lane chains its blocks in order, stores the state after each block and
// restarts from H0 after a flagged block. states are exact on the lane's
// live rows (t <= its last flagged block) and 0 on the rest, which no
// consumer reads; a lane with no flag has no live row.
//
// It is kernel 1's SHA-256 kernel alone: chunk_chains_kernel
// (strip_chunks.cuh) reads each lane's chunk list from the flag column and
// chains every chunk in its own consumer thread, a producer warp computing
// the message schedule beside it. What bounds it: the longest chunk's
// chain of dependent compressions at the ALU issue rate of one SM
// scheduler, not bytes or throughput. Any lane count; lanes of up to 2^20
// blocks in the wide layout, whose lists (in a scratch of 3 * s * bps
// words, a list entry for every row a lane could flag) need no count of
// the flags before the launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "strip_chunks.cuh"

extern "C" int dfs_strip_states(const void* words_t, const void* cutflag,
                                void* states, int bps, int s, int wide,
                                void* scratch, void* stream) {
  if (bps > 0 && s > 0)
    return static_cast<int>(launch_chunk_chains(
        static_cast<const uint32_t*>(words_t),
        static_cast<const int32_t*>(cutflag), static_cast<uint32_t*>(states),
        bps, s, bps, wide != 0, static_cast<uint32_t*>(scratch),
        static_cast<cudaStream_t>(stream)));
  return static_cast<int>(cudaGetLastError());
}
