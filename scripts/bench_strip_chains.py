#!/usr/bin/env python3
"""Design measurements of the strip SHA-256 chain kernel, and of the
select walk, on an NVIDIA card.

Times ``chunk_chains_kernel`` (``dfs_tpu_torch/csrc/strip_chunks.cuh``, the
SHA-256 part of kernels 1 and 5) as shipped and in variants built from the
same header by text substitution, on one 64 MiB region's shape (640 lanes
of 2048 blocks, 543 of them holding 1536-2048 blocks; random words, seed
1) with the cuts that kernel 1 selects at the default parameters:

- ``shipped``: producer warp (block loads + message schedule), consumer
  warp (rounds only), storer warp; slots in use sized to the CTA's work;
- ``schedule_on_chain``: the producer only prefetches the block's words;
  the consumer computes the schedule itself before the rounds;
- ``slots_32`` / ``slots_8``: a fixed number of slots in use per CTA;
- ``no_block_loads`` / ``no_state_stores``: the scattered loads or stores
  left out (wrong states; they show what those accesses cost).

Also times kernels 1 and 5 through their wrappers. Then kernel 4
(``dfs_tpu_torch/csrc/select_walk.cu``) on one 64 MiB region's anchor
tiles (``chip_smoke.py``'s region, seed 20261016), as shipped and in
variants built by text substitution, and, in a build that reads
``clock64`` around the walk, in cycles per step:

- ``burst_1`` / ``burst_4``: the chunk check before every step, or every
  4 steps, through the loop that large ``seg_max`` takes, instead of the
  written-out burst of 8;
- ``ring_base_per_step``: the ring's shared address left to the compiler,
  which rebuilds it from the CTA's cluster id at every step.

Every time is per launch, back to back (``chip_smoke.cuda_ms``).

Each line of output is one JSON object; the first names the card and its
power limit.

    python scripts/bench_strip_chains.py     # from the repository root
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "dfs_tpu_torch" / "csrc"

ENTRY = """
extern "C" int run(const void* w, const void* cf, void* st, int bps, int s,
                   void* stream) {
  return (int)launch_chunk_chains((const uint32_t*)w, (const int32_t*)cf,
                                  (uint32_t*)st, bps, s, bps, false,
                                  nullptr, (cudaStream_t)stream);
}
"""

SLOTS = """      const unsigned key = lane < in_use
                               ? (static_cast<unsigned>(load) << 5) | lane
                               : 0xFFFFFFFFu;"""
SCHEDULE = ("      if (cur.live) sha256_schedule_wk(w, wk + (step & 1) * "
            "16 * 32 + lane);")
ROUNDS = "        sha256_rounds_wk(st, wk + (step & 1) * 16 * 32 + lane);"
LOADS = "  for (int i = 0; i < 16; ++i) w[i] = __ldg(src + i * S);"
STORES = """        dst[0] = lo.x; dst[S64] = lo.y; dst[2 * S64] = lo.z;
        dst[3 * S64] = lo.w; dst[4 * S64] = hi.x; dst[5 * S64] = hi.y;
        dst[6 * S64] = hi.z; dst[7 * S64] = hi.w;"""


def variants(header: str) -> dict[str, str]:
    for part in (SLOTS, SCHEDULE, ROUNDS, LOADS, STORES):
        if part not in header:
            raise SystemExit(f"bench_strip_chains: header changed: {part!r}")

    def slots(m):
        return header.replace(SLOTS, (
            f"      const unsigned key = lane < {m} ? (static_cast<unsigned>"
            "(load) << 5) | lane : 0xFFFFFFFFu;"))

    raw_words = ("      if (cur.live) { uint4* d = wk + (step & 1) * 16 * 32 +"
                 " lane; for (int q = 0; q < 4; ++q) d[q * 32] = make_uint4("
                 "w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]); }")
    own_schedule = (
        "        { uint4* b = wk + (step & 1) * 16 * 32 + lane; "
        "uint32_t x[16]; for (int q = 0; q < 4; ++q) { const uint4 v = "
        "b[q * 32]; x[4 * q] = v.x; x[4 * q + 1] = v.y; x[4 * q + 2] = v.z;"
        " x[4 * q + 3] = v.w; } sha256_schedule_wk(x, b); "
        "sha256_rounds_wk(st, b); }")
    return {
        "shipped": header,
        "schedule_on_chain": header.replace(SCHEDULE, raw_words)
                                   .replace(ROUNDS, own_schedule),
        "slots_32": slots(32),
        "slots_8": slots(8),
        "no_block_loads": header.replace(
            LOADS, "  for (int i = 0; i < 16; ++i) w[i] = u.t * 16 + i;"),
        "no_state_stores": header.replace(
            STORES, "        if (lo.x == 0x12345u) dst[0] = hi.y;"),
    }


def build(out: Path, variants: dict[str, dict[str, str]], entry: str,
          argtypes: list) -> dict[str, ctypes.CDLL]:
    """Compile each variant's ``k.cu`` (beside the other files of its
    ``{file name: text}``) in parallel; returns {variant: CDLL} with
    ``entry``'s argtypes set."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    procs = {}
    for name, files in variants.items():
        d = out / name
        d.mkdir(parents=True)
        for fname, text in files.items():
            (d / fname).write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
             "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-w", "-o",
             str(d / "k.so"), str(d / "k.cu")])
    libs = {}
    for name, proc in procs.items():
        if proc.wait() != 0:
            raise SystemExit(f"bench_strip_chains: {name} did not build")
        lib = ctypes.CDLL(str(out / name / "k.so"))
        getattr(lib, entry).argtypes = argtypes
        libs[name] = lib
    return libs


SELECT_BURST = ("  const int burst = max(1, min(kMaxBurst, chunk_bytes / "
                "seg_max));")
SELECT_RING = '  asm volatile("" : "+r"(ring));\n'
SELECT_WALK = "  // One burst an iteration"
SELECT_TAIL = "  for (int j = i + lane; j < cap; j += 32) bounds[j] = -1;"


def select_variants(src: str) -> dict[str, str]:
    """Kernel 4's variants, and of each a build that stores the walk's
    clock64 cycles and steps into the last two bounds."""
    for part in (SELECT_BURST, SELECT_RING, SELECT_WALK, SELECT_TAIL):
        if part not in src:
            raise SystemExit(f"bench_strip_chains: select_walk.cu changed: "
                             f"{part!r}")

    def burst(k):
        return src.replace(SELECT_BURST, f"  const int burst = {k};")

    plain = {"shipped": src, "burst_1": burst(1), "burst_4": burst(4),
             "ring_base_per_step": src.replace(SELECT_RING, "")}
    clocked = {
        f"{name}_clocked": text.replace(
            SELECT_WALK, "  const long long t_walk = clock64();\n"
            + SELECT_WALK).replace(
            SELECT_TAIL, "  const int walk_cycles = (int)(clock64() - "
            "t_walk);\n" + SELECT_TAIL + "\n  __syncwarp();\n  if (lane == "
            "0) { bounds[cap - 1] = walk_cycles; bounds[cap - 2] = i; }")
        for name, text in plain.items()}
    return {**plain, **clocked}


def bench_select(dev) -> None:
    import numpy as np
    import torch

    from chip_smoke import REGION_BYTES, SEED, cuda_ms
    from dfs_tpu_torch import kernels
    from dfs_tpu_torch.ops import cdc_anchored as A
    from dfs_tpu_torch.ops.select import (TILE_SHIFT, record_words,
                                          select_walk_plain)

    params = A.AnchoredCdcParams()
    region = np.random.default_rng(SEED).integers(0, 256, size=REGION_BYTES,
                                                  dtype=np.uint8)
    words = A.words_tensor(A.region_buffer(region, np.zeros(8, np.uint8),
                                           params)).to(dev)
    shape = A.make_chain_fn(params, words.shape[0], 128, "tight").shape
    tiles = A.anchor_tiles(words, params, shape["m_words"])
    cap, m_tiles = shape["cap"], tiles.shape[1]
    scal = torch.tensor([0, REGION_BYTES, 1], dtype=torch.int32, device=dev)
    want = select_walk_plain(tiles, scal, cap, params.seg_min,
                             params.seg_max)
    records = torch.empty(record_words(m_tiles), dtype=torch.int32,
                          device=dev)
    bounds = torch.empty(cap, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory(prefix=".bench_select_",
                                     dir=ROOT) as tmp:
        libs = build(Path(tmp), {
            name: {"k.cu": text} for name, text in select_variants(
                (CSRC / "select_walk.cu").read_text()).items()},
            "dfs_select_walk", kernels.KERNELS["select_walk"][2])
        for name, lib in libs.items():
            def call(lib=lib):
                rc = lib.dfs_select_walk(
                    tiles.data_ptr(), m_tiles, scal.data_ptr(),
                    bounds.data_ptr(), cap, params.seg_min, params.seg_max,
                    TILE_SHIFT, records.data_ptr(), stream)
                if rc:
                    raise SystemExit(f"bench_strip_chains: {name}: "
                                     f"cudaError {rc}")
            call()
            torch.cuda.synchronize()
            row = {"select_variant": name, "ms": cuda_ms(call, 100)}
            if name.endswith("_clocked"):
                steps = int(bounds[cap - 2])
                row.update(steps=steps, cycles_per_step=int(
                    bounds[cap - 1]) / steps)
            else:
                row["exact"] = torch.equal(bounds, want)
            print(json.dumps(row), flush=True)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("bench_strip_chains: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import cuda_ms
    from dfs_tpu_torch.ops.cdc_v2 import AlignedCdcParams
    from dfs_tpu_torch.ops.sha256_strip import (strip_chunk_states,
                                                strip_states)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"card": card}), flush=True)
    cp = AlignedCdcParams()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(1)
    s, bps = 640, cp.strip_blocks
    words = rng.integers(0, 2**32, size=(bps * 16, s), dtype=np.uint32)
    wt = torch.from_numpy(words.view(np.int32)).view(torch.uint32).to(dev)
    rb = np.zeros(s, np.int32)
    rb[:543] = rng.integers(1536, 2049, size=543)
    rb_t = torch.from_numpy(rb).to(dev)
    args = (wt, rb_t, cp.seed, cp.mask, cp.min_blocks, cp.max_blocks)
    cf, since, states = strip_chunk_states(*args)
    torch.cuda.synchronize()
    print(json.dumps({"lanes": s, "bps": bps, "chunks": int(cf.sum()),
                      "longest_chunk_blocks": int(since.max()),
                      "strip_chunk_states_ms": cuda_ms(
                          lambda: strip_chunk_states(*args), 20),
                      "strip_states_ms": cuda_ms(
                          lambda: strip_states(wt, cf), 20)}), flush=True)
    out = torch.empty_like(states)
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory(prefix=".bench_strip_",
                                     dir=ROOT) as tmp:
        sha = (CSRC / "sha256_compress.cuh").read_text()
        libs = build(Path(tmp), {
            name: {"sha256_compress.cuh": sha, "strip_chunks.cuh": text,
                   "k.cu": '#include "strip_chunks.cuh"\n' + ENTRY}
            for name, text in variants(
                (CSRC / "strip_chunks.cuh").read_text()).items()},
            "run", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
            + [ctypes.c_void_p])
        for name, lib in libs.items():
            def call(lib=lib):
                rc = lib.run(wt.data_ptr(), cf.data_ptr(), out.data_ptr(),
                             bps, s, stream)
                if rc:
                    raise SystemExit(f"bench_strip_chains: {name}: "
                                     f"cudaError {rc}")
            out.zero_()
            call()
            torch.cuda.synchronize()
            print(json.dumps({
                "variant": name, "ms": cuda_ms(call, 20),
                "states_equal_k1": torch.equal(out.view(torch.int32),
                                               states.view(torch.int32))}),
                  flush=True)
    bench_select(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
