#!/usr/bin/env python3
"""Design measurements of the SHA-256 chain core of kernels 6 and 7
(``dfs_tpu_torch/csrc/sha256_chain.cuh``) on an NVIDIA card.

Builds kernel 6 (``sha256_blocks.cu``) as shipped and in variants made
from the same sources by text substitution, each also in a build whose
consumer warp reads ``clock64`` around its chain and stores the cycles and
the blocks in row 0's state (so that build's outputs are not compared):

- ``shipped``: rounds alone in the consumer warp, h + W + K and d + h +
  W + K summed one round ahead; schedule in the producer;
- ``imad_adds``: every add of the rounds an IMAD (``x * one + y`` with
  ``one`` a device variable), on the FMA pipe instead of the ALU;
- ``schedule_on_chain``: the producer only loads the block's words; the
  consumer computes the schedule itself before the rounds (the one-thread
  design of the kernel before this core, with the same rounds);
- ``rounds_loop_8``: the rounds as a loop of 8 rounds an iteration
  instead of all 64 written out (a loop body that fits the instruction
  cache);
- ``depth_4``: e' = d + T1 added after T1 (four dependent instructions
  from e to e', and from a to a'), without d + h + W + K summed ahead.

Each is timed at 16 messages x 64 blocks and 128 x 256 (per launch, back
to back: ``chip_smoke.cuda_ms``) and, clocked, read in cycles per
compression at 16 x 64. Also prints the ptxas report of the shipped
kernels 6 and 7 and the SASS instruction mix of each (``cuobjdump``).

Each line of output is one JSON object; the first names the card and its
power limit.

    python scripts/bench_sha256_chain.py     # from the repository root
"""

from __future__ import annotations

import collections
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "dfs_tpu_torch" / "csrc"

PRODUCER = ("      if (l < n) schedule_wk(w, wk + (l & 1) * kWkHalf + lane);"
            "\n")
CONSUMER = """    sha256_init(st);
    for (int l = 0; l < steps; ++l) {
      pair_barrier();
      if (l < n) rounds_wk(st, wk + (l & 1) * kWkHalf + lane);
    }
"""
CLOCKED = """    sha256_init(st);
    const long long t_chain = clock64();
    for (int l = 0; l < steps; ++l) {
      pair_barrier();
      if (l < n) rounds_wk(st, wk + (l & 1) * kWkHalf + lane);
    }
    const long long t_end = clock64();
    if (lane == 0) {
      st[6] = static_cast<uint32_t>(t_end - t_chain);
      st[7] = static_cast<uint32_t>(steps);
    }
"""
ROUNDS = "      if (l < n) rounds_wk(st, wk + (l & 1) * kWkHalf + lane);\n"
DEPTH3 = """      const uint32_t en = S1 + (ch + dhw);          // d + T1
      const uint32_t t1 = S1 + (ch + hw);
      const uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
      const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
      const uint32_t an = S0 + (t1 + maj);          // T1 + T2
      hw = g + vv[u + 1];                   // the next round's h + W + K
      dhw = c + hw;                         // ... and its d + h + W + K
"""
DEPTH4 = """      const uint32_t t1 = S1 + (ch + hw);
      const uint32_t en = d + t1;
      const uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
      const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
      const uint32_t an = t1 + (S0 + maj);
      hw = g + vv[u + 1];
      dhw = c + hw;
"""
# every add of the rounds an IMAD on the FMA pipe (x * one + y, `one` a
# device variable equal to 1 that the compiler cannot fold)
IMAD = """      const uint32_t en = fma1(S1, fma1(ch, dhw));
      const uint32_t t1 = fma1(S1, fma1(ch, hw));
      const uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
      const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
      const uint32_t an = fma1(S0, fma1(t1, maj));
      hw = fma1(g, vv[u + 1]);
      dhw = fma1(c, hw);
"""
FMA1 = """__device__ uint32_t bench_one = 1u;
__device__ __forceinline__ uint32_t fma1(uint32_t x, uint32_t y) {
  return x * bench_one + y;
}

// The 64 rounds"""
ROUNDS_LOOP = ("  uint32_t dhw = d + hw;                    // d + h + W[0] + K[0]\n"
               "#pragma unroll\n")
OPCODES = ("SHF", "LOP3", "IADD3", "IMAD", "PRMT", "SEL", "LDS", "STS",
           "LDG", "BAR")


def variants(chain: str) -> dict[str, str]:
    for part in (PRODUCER, CONSUMER, ROUNDS, ROUNDS_LOOP, DEPTH3,
                 "// The 64 rounds"):
        if part not in chain:
            raise SystemExit(f"bench_sha256_chain: header changed: {part!r}")
    raw = ("      if (l < n) { uint4* d = wk + (l & 1) * kWkHalf + lane; "
           "for (int q = 0; q < 4; ++q) d[q * 32] = make_uint4(w[4 * q], "
           "w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]); }\n")
    own = ("      if (l < n) { uint4* b = wk + (l & 1) * kWkHalf + lane; "
           "uint32_t x[16]; for (int q = 0; q < 4; ++q) { const uint4 v = "
           "b[q * 32]; x[4 * q] = v.x; x[4 * q + 1] = v.y; x[4 * q + 2] = "
           "v.z; x[4 * q + 3] = v.w; } schedule_wk(x, b); rounds_wk(st, b); }\n")
    edits = {"shipped": lambda t: t,
             "imad_adds": lambda t: t.replace(DEPTH3, IMAD).replace(
                 "// The 64 rounds", FMA1),
             "schedule_on_chain": lambda t: t.replace(PRODUCER, raw)
             .replace(ROUNDS, own),
             "rounds_loop_8": lambda t: t.replace(
                 ROUNDS_LOOP, ROUNDS_LOOP.replace("unroll", "unroll 2")),
             "depth_4": lambda t: t.replace(DEPTH3, DEPTH4)}
    clocked = chain.replace(CONSUMER, CLOCKED)
    out = {}
    for name, edit in edits.items():
        out[name] = edit(chain)
        out[f"{name}_clocked"] = edit(clocked)
    return out


def sass_mix(lib: Path, kernel: str) -> dict:
    """Instruction counts by opcode in ``kernel``'s SASS (static: the
    unrolled rounds of one block appear once)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=120).stdout
    body, inside = [], False
    for line in text.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside:
            body.append(line)
    counts = collections.Counter()
    for line in body:
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)",
                      line)
        if m:
            counts[m.group(1)] += 1
    return {k: counts.get(k, 0) for k in OPCODES} | {
        "total": sum(counts.values())}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("bench_sha256_chain: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    from bench_strip_chains import build
    from chip_smoke import CHAIN_CYCLES_PER_COMPRESSION, BOOST_HZ, cuda_ms
    from dfs_tpu_torch import kernels
    from dfs_tpu_torch.ops import sha256 as S

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"card": card}), flush=True)
    kernels.build_all()
    out_dir = kernels._build_dir()
    for name in ("sha256_blocks", "sha256_spans"):
        print(json.dumps({
            "kernel": name,
            "ptxas": [ln.split("info    : ", 1)[-1] for ln in
                      kernels.build_log.get(name, "").splitlines()
                      if "registers" in ln or "spill" in ln],
            "sass": sass_mix(out_dir / f"lib{name}.so",
                             f"{name}_kernel")}), flush=True)

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(4)
    shapes = {}
    for rows, blocks in ((16, 64), (128, 256)):
        w = S.u32_tensor(rng.integers(0, 2**32, size=(rows, blocks, 16),
                                      dtype=np.uint64).astype(np.uint32),
                         dev)
        n = torch.full((rows,), blocks, dtype=torch.int32, device=dev)
        shapes[(rows, blocks)] = (w, n, S.sha256_blocks_plain(w, n)
                                  if rows == 16 else S.sha256_blocks(w, n))
    stream = torch.cuda.current_stream().cuda_stream
    chain = (CSRC / "sha256_chain.cuh").read_text()
    with tempfile.TemporaryDirectory(prefix=".bench_sha_", dir=ROOT) as tmp:
        libs = build(Path(tmp), {
            name: {"sha256_compress.cuh":
                   (CSRC / "sha256_compress.cuh").read_text(),
                   "sha256_chain.cuh": text,
                   "k.cu": (CSRC / "sha256_blocks.cu").read_text()}
            for name, text in variants(chain).items()},
            "dfs_sha256_blocks", kernels.KERNELS["sha256_blocks"][2])
        for name, lib in libs.items():
            row = {"variant": name}
            for (rows, blocks), (w, n, want) in shapes.items():
                out = torch.empty((rows, 8), dtype=torch.uint32, device=dev)

                def call(lib=lib, w=w, n=n, out=out, rows=rows,
                         blocks=blocks):
                    rc = lib.dfs_sha256_blocks(w.data_ptr(), n.data_ptr(),
                                               out.data_ptr(), rows, blocks,
                                               stream)
                    if rc:
                        raise SystemExit(f"bench_sha256_chain: {name}: "
                                         f"cudaError {rc}")
                call()
                torch.cuda.synchronize()
                key = f"{rows}x{blocks}"
                if name.endswith("_clocked"):
                    if rows == 16:
                        got = out[0].view(torch.int32).cpu().numpy()
                        row["cycles_per_compression"] = int(got[6]) / int(
                            got[7])
                else:
                    row[f"exact_{key}"] = torch.equal(
                        out.view(torch.int32), want.view(torch.int32))
                    row[f"ms_{key}"] = cuda_ms(call, 100 if rows == 16
                                               else 20)
                    row[f"chain_floor_ms_{key}"] = (
                        blocks * CHAIN_CYCLES_PER_COMPRESSION / BOOST_HZ
                        * 1e3)
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
