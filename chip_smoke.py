#!/usr/bin/env python3
"""Smoke test of dfs_tpu_torch on one NVIDIA card: builds the CUDA
kernels, holds each against its plain PyTorch version at the shapes the
main path gives it, times it, then drives the main path end to end — a
LocalNode streaming a 256 MiB upload through the anchored CDC + SHA-256
chain at the default parameters (64 MiB windows, two in flight) — and
checks the result against the NumPy oracle, hashlib and a download.

    python3 chip_smoke.py            # from the repository root; one card

Each phase prints one JSON line. Before the last line come the card's
``nvidia-smi`` name and power limit and the ``{"kernels": [...]}`` table;
the last line is ``{"ok": true, "device": {...}}``. Any failed check
exits non-zero. Without CUDA it exits 2 and prints no result. It imports
nothing of JAX or of the dfs_tpu package.
"""

from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

SEED = 20261016
BODY_BYTES = 256 * 1024 * 1024
BLOCK_BYTES = 1024 * 1024
REGION_BYTES = 64 * 1024 * 1024

# H100 SXM peaks (NVIDIA data sheet, at the full 700 W power limit): HBM
# bandwidth, and the 32-bit non-tensor rate used for integer ALU work (a
# lower bound on time: the card's INT32 throughput is not higher)
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
# 32-bit integer operations per block-lane in kernel 1: Gear window (32
# bytes x ~14), selection (~10), SHA-256 schedule (48 x 13) and rounds
# (64 x 23) plus the feed-forward (8)
K1_OPS_PER_BLOCK = 32 * 14 + 10 + 48 * 13 + 64 * 23 + 8

REPLACES = {
    "strip_chunk_states": "dfs_tpu/ops/sha256_strip.py:264",
    "repack_lanes": "dfs_tpu/ops/repack.py:144",
    "bswap_transpose": "dfs_tpu/ops/layout.py:39",
    "select_walk": "dfs_tpu/ops/select_pallas.py:62",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_err(a, b) -> int:
    """Largest elementwise |a - b| over u32/i32 tensors (as integers)."""
    import torch

    from dfs_tpu_torch.utils import u32

    def wide(t):
        return u32.widen(t) if t.dtype == torch.uint32 else t.to(torch.int64)

    check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((wide(a) - wide(b)).abs().max()) if a.numel() else 0


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import numpy as np

    from dfs_tpu_torch import kernels
    from dfs_tpu_torch.node import LocalNode
    from dfs_tpu_torch.ops import cdc_anchored as A
    from dfs_tpu_torch.ops.layout import (bswap_transpose,
                                          bswap_transpose_plain)
    from dfs_tpu_torch.ops.repack import repack_lanes, repack_lanes_plain
    from dfs_tpu_torch.ops.select import select_walk, select_walk_plain
    from dfs_tpu_torch.ops.sha256_strip import (strip_chunk_states,
                                                strip_chunk_states_plain)

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi unavailable"
    emit({"phase": "card", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    kernels.build_all()
    regs = {k: " ".join(ln.split("info    : ", 1)[-1] for ln in v.splitlines()
                        if "registers" in ln or "spill" in ln)
            for k, v in kernels.build_log.items()}
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "ptxas": regs})

    # ---- one 64 MiB region at the default parameters, through the
    # port's own plain anchor pass and descriptors ----
    params = A.AnchoredCdcParams()
    cp = params.chunk
    rng = np.random.default_rng(SEED)
    region = rng.integers(0, 256, size=REGION_BYTES, dtype=np.uint8)
    words = A.words_tensor(A.region_buffer(region, np.zeros(8, np.uint8),
                                           params)).to(dev)
    shape = A.make_chain_fn(params, words.shape[0], 128, "tight").shape
    m_words, cap, s_pad = shape["m_words"], shape["cap"], shape["s_pad"]
    lane_words = cp.strip_blocks * 16
    tiles = A.anchor_tiles(words, params, m_words)
    scal = torch.tensor([0, REGION_BYTES, 1], dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    rows = []

    def kernel_row(name, err, ms, plain_ms, in_bytes, ops, note):
        bound_bytes_ms = in_bytes / PEAK_BYTES_S * 1e3
        bound_ops_ms = ops / PEAK_OPS_S * 1e3
        row = {"name": name, "route": "cuda",
               "source": f"dfs_tpu_torch/csrc/{kernels.KERNELS[name][0]}",
               "replaces": REPLACES[name], "launches": None,
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": max(bound_bytes_ms, bound_ops_ms),
               "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms
               else "operations", "library_ms": None}
        emit({"phase": f"kernel:{name}", **row, "bytes": in_bytes,
              "ops": ops, "parity": note, "exact": err == 0})
        check(err == 0, f"{name} disagrees with its plain version "
              f"(max abs err {err})")
        rows.append(row)

    # K4: the select walk
    b_k = select_walk(tiles, scal, cap, params.seg_min, params.seg_max)
    b_p = select_walk_plain(tiles, scal, cap, params.seg_min, params.seg_max)
    steps = int((b_k >= 0).sum()) + 1
    win = (params.seg_max - params.seg_min) // A.TILE_BYTES + 1
    kernel_row("select_walk", max_abs_err(b_k, b_p),
               cuda_ms(lambda: select_walk(tiles, scal, cap, params.seg_min,
                                           params.seg_max)),
               cuda_ms(lambda: select_walk_plain(
                   tiles, scal, cap, params.seg_min, params.seg_max),
                   reps=3, warmup=1),
               nbytes(tiles, scal, b_k), steps * 2 * win * 4,
               f"full shape: tiles [2, {tiles.shape[1]}], cap {cap}")

    (starts, seg_lens, w_off, sh8, real_blocks, tail_len, consumed,
     nseg) = A.descriptors(b_k, scal[0], s_pad)

    # K2: repack
    p_k = repack_lanes(words, w_off, sh8, lane_words)
    p_p = repack_lanes_plain(words, w_off, sh8, lane_words)
    kernel_row("repack_lanes", max_abs_err(p_k, p_p),
               cuda_ms(lambda: repack_lanes(words, w_off, sh8, lane_words)),
               cuda_ms(lambda: repack_lanes_plain(words, w_off, sh8,
                                                  lane_words), reps=5),
               nbytes(words, w_off, sh8, p_k), 0,
               f"full shape: [{s_pad}, {lane_words}]")
    del p_p

    # K3: bswap + transpose
    t_k = bswap_transpose(p_k)
    t_p = bswap_transpose_plain(p_k)
    kernel_row("bswap_transpose", max_abs_err(t_k, t_p),
               cuda_ms(lambda: bswap_transpose(p_k)),
               cuda_ms(lambda: bswap_transpose_plain(p_k), reps=5),
               nbytes(p_k, t_k), 0,
               f"full shape: [{s_pad}, {lane_words}] -> transposed")
    del t_p

    # K1: fused Gear + selection + SHA-256, full shape both ways (the
    # plain version walks the 2048 blocks in Python: one timed run)
    args = (t_k, real_blocks, cp.seed, cp.mask, cp.min_blocks, cp.max_blocks)
    out_k = strip_chunk_states(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out_p = strip_chunk_states_plain(*args)
    end.record()
    end.synchronize()
    k1_plain_ms = start.elapsed_time(end)
    err = max(max_abs_err(a, b) for a, b in zip(out_k, out_p))
    live_blocks = int(real_blocks.sum())
    kernel_row("strip_chunk_states", err,
               cuda_ms(lambda: strip_chunk_states(*args), reps=10),
               k1_plain_ms, nbytes(t_k, real_blocks, *out_k),
               live_blocks * K1_OPS_PER_BLOCK,
               f"full shape: {s_pad} lanes x {cp.strip_blocks} blocks "
               f"({live_blocks} live)")
    del out_p

    # where one region's time goes, stage by stage (device time)
    chain = A.make_chain_fn(params, words.shape[0], 128, "tight")
    cf32, since, srows = A.scan_half(words, w_off, sh8, real_blocks, cp,
                                     s_pad)
    stages = {
        "anchor_tiles": lambda: A.anchor_tiles(words, params, m_words),
        "select_walk": lambda: select_walk(tiles, scal, cap, params.seg_min,
                                           params.seg_max),
        "descriptors": lambda: A.descriptors(b_k, scal[0], s_pad),
        "scan_half": lambda: A.scan_half(words, w_off, sh8, real_blocks, cp,
                                         s_pad),
        "compact_half": lambda: A.compact_half(
            cf32, since, srows, words, w_off, sh8, real_blocks, tail_len,
            starts, seg_lens, bps=cp.strip_blocks, s_pad=s_pad,
            c_max=shape["c_max"], t_tile=shape["t_tile"],
            k_max=shape["k_max"]),
        "whole_chain": lambda: chain(words, 0, REGION_BYTES, True),
    }
    emit({"phase": "chain_stages", "region_bytes": REGION_BYTES,
          "lanes": s_pad, "segments": int(nseg),
          "ms": {k: cuda_ms(fn, reps=5, warmup=1)
                 for k, fn in stages.items()}})
    del stages, cf32, since, srows, t_k, p_k, out_k, words, tiles

    # ---- the main path: LocalNode streaming upload on the card ----
    body_np = rng.integers(0, 256, size=BODY_BYTES, dtype=np.uint8)
    body = body_np.tobytes()
    blocks = [body[i:i + BLOCK_BYTES] for i in range(0, BODY_BYTES,
                                                     BLOCK_BYTES)]
    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=root) as d:
        node = LocalNode(d, device="cuda")
        frag = node.fragmenter
        check(frag.region_bytes == REGION_BYTES and frag.max_inflight == 2,
              "default fragmenter geometry")
        frag.chunk(body[:REGION_BYTES * 2])            # warm-up walk
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        table = frag.chunk(body)
        frag_s = time.perf_counter() - t0

        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        m, st = node.upload_stream(iter(blocks), name="smoke.bin")
        upload_s = time.perf_counter() - t0
        launches = kernels.launch_counts()

        windows = -(-(BODY_BYTES - REGION_BYTES) // frag.stride) + 1
        got = [(c.offset, c.length, c.digest) for c in m.chunks]
        oracle = A.chunk_file_anchored_np(body_np, params)
        check(got == oracle, "upload chunk table != numpy oracle")
        check([(c.offset, c.length, c.digest) for c in table] == oracle,
              "fragmenter.chunk table != numpy oracle")
        check(m.file_id == hashlib.sha256(body).hexdigest(),
              "fileId != sha256(body)")
        check(node.download(m.file_id) == body, "download not identical")
        _, st2 = node.upload_stream(iter(blocks), name="smoke.bin")
        check(st2["transferredBytes"] == 0, "re-upload transferred bytes")
        edited = bytearray(body)
        for off, ins in ((200_000_005, b"\x01"), (100_000_003, b"\x02" * 77),
                         (10_000_001, b"\x03" * 7)):
            edited[off:off] = ins
        m3, st3 = node.upload(bytes(edited), name="smoke-edit.bin")
        dedup = st3["dedupSkippedBytes"] / len(edited)
        check(dedup > 0.9, f"edited copy deduped only {dedup:.3f}")
        check(node.download(m3.file_id) == bytes(edited),
              "edited download not identical")
        for name, n in launches.items():
            check(n > 0, f"kernel {name} never launched on the main path")
        emit({"phase": "e2e", "bytes": BODY_BYTES, "block_bytes": BLOCK_BYTES,
              "windows": windows, "chunks": len(m.chunks),
              "unique_chunks": st["uniqueChunks"],
              "fragment_s": frag_s,
              "fragment_gib_s": BODY_BYTES / frag_s / 2**30,
              "upload_s": upload_s,
              "upload_gib_s": BODY_BYTES / upload_s / 2**30,
              "launches": launches, "oracle_equal": True,
              "file_id_ok": True, "download_identical": True,
              "reupload_transferred": st2["transferredBytes"],
              "edit_dedup_fraction": dedup,
              "fsyncs": node.store.chunks.fsync_count()})
        node.close()

    for row in rows:
        row["launches"] = launches[row["name"]]
    print(card, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
