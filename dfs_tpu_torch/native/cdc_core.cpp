// Native CPU core of the port's `cdc` strategy: sequential Gear CDC cut
// selection, a copy of dfs_tpu's native/cdc_core.cpp entry point of the
// same name. Loaded with ctypes by dfs_tpu_torch/native/__init__.py, which
// builds it with g++ into dfs_tpu_torch/_build/ at first use.

#include <cstdint>

extern "C" {

// Sequential Gear CDC cut selection (the algorithm of
// dfs_tpu_torch/ops/boundary.py over the bitmap of
// dfs_tpu_torch/fragmenter/cdc_cpu.py): writes exclusive cut offsets
// into `cuts` (capacity cuts_cap), returns the number written, or -1 on
// overflow.
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

}  // extern "C"
