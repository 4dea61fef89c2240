#!/usr/bin/env python3
"""Design measurements of the strip SHA-256 chain kernel on an NVIDIA card.

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

Also times kernels 1 and 5 through their wrappers. Each line of output is
one JSON object; the first names the card and its power limit.

    python scripts/bench_strip_chains.py     # from the repository root
"""

from __future__ import annotations

import ctypes
import json
import shutil
import statistics
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
                                  (uint32_t*)st, bps, s, bps,
                                  (cudaStream_t)stream);
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


def build(out: Path, texts: dict[str, str]) -> dict[str, ctypes.CDLL]:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    procs = {}
    for name, text in texts.items():
        d = out / name
        d.mkdir(parents=True)
        shutil.copy(CSRC / "sha256_compress.cuh", d)
        (d / "strip_chunks.cuh").write_text(text)
        (d / "k.cu").write_text('#include "strip_chunks.cuh"\n' + ENTRY)
        procs[name] = subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
             "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-w", "-o",
             str(d / "k.so"), str(d / "k.cu")])
    libs = {}
    for name, proc in procs.items():
        if proc.wait() != 0:
            raise SystemExit(f"bench_strip_chains: {name} did not build")
        lib = ctypes.CDLL(str(out / name / "k.so"))
        lib.run.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
        libs[name] = lib
    return libs


def cuda_ms(fn, reps: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("bench_strip_chains: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
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
                          lambda: strip_chunk_states(*args)),
                      "strip_states_ms": cuda_ms(
                          lambda: strip_states(wt, cf))}), flush=True)
    out = torch.empty_like(states)
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory(prefix=".bench_strip_",
                                     dir=ROOT) as tmp:
        libs = build(Path(tmp), variants(
            (CSRC / "strip_chunks.cuh").read_text()))
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
                "variant": name, "ms": cuda_ms(call),
                "states_equal_k1": torch.equal(out.view(torch.int32),
                                               states.view(torch.int32))}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
