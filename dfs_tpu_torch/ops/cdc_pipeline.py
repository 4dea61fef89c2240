"""The device pipeline of aligned CDC v2: bytes -> chunk table, one
dispatch per segment — dfs_tpu's ``ops/cdc_pipeline.py``.

  raw segment (LE words)  --K3-->  words_t [bps*16, S] BE, padded to s_pad
                          --K1-->  cutflag, states  (Gear candidates,
                                   greedy cuts, strip SHA-256 in one pass)
                          --plain torch--> cut positions [c_max] (stream
                                   order), lengths, digests [c_max, 8]

and only metadata (count, positions, digests) returns to the host. A
segment is a whole number of strips; chunking restarts at every strip, so
segments are independent and a long stream loops over fixed-shape
segments in bounded memory.

- ``scan_half``: kernel 3 (``ops.layout.bswap_transpose``) on the
  ``[s_real, bps*16]`` LE words, the lanes padded to ``s_pad``, then
  kernel 1 (``ops.sha256_strip.strip_chunk_states``);
- ``compact_half`` (plain torch, int64-masked u32, as dfs_tpu's was
  XLA): the tile-wise ``k_max`` peel of the cut positions, the lengths from
  consecutive positions, the gather of the cut rows' states (live rows,
  which kernel 1 stores exactly) and the FIPS finalize.

The final chunk of the stream may end in a partial block: the strip scan
hashed a zero-padded block there, so :func:`segment_chunks` re-hashes it
on the host.
"""

from __future__ import annotations

import functools
import hashlib

import numpy as np
import torch

from dfs_tpu_torch import resolve_device
from dfs_tpu_torch.ops import sha256
from dfs_tpu_torch.ops.cdc_v2 import (BLOCK, AlignedCdcParams, cut_capacity,
                                      cut_positions, digests_to_hex)
from dfs_tpu_torch.ops.layout import bswap_transpose
from dfs_tpu_torch.ops.sha256_strip import strip_chunk_states
from dfs_tpu_torch.utils import u32
from dfs_tpu_torch.utils.hashing import next_pow2

__all__ = ["cut_capacity", "digests_to_hex", "make_segment_fn",
           "segment_chunks"]


def scan_half(words_le: torch.Tensor, real_blocks: torch.Tensor,
              params: AlignedCdcParams, s_real: int, s_pad: int):
    """(words_le [s_real * bps*16] u32, real_blocks [s_pad] i32) ->
    (cutflag [bps, s_pad] i32, states [bps*8, s_pad] u32): kernels 3 and
    1."""
    bps = params.strip_blocks
    words_t = bswap_transpose(words_le.reshape(s_real, bps * 16))
    if s_pad != s_real:
        w = words_t.view(torch.int32)
        words_t = torch.cat([w, w.new_zeros((bps * 16, s_pad - s_real))],
                            dim=1).view(torch.uint32)
    cf32, _, states = strip_chunk_states(
        words_t, real_blocks, params.seed, params.mask, params.min_blocks,
        params.max_blocks)
    return cf32, states


def compact_half(cf32: torch.Tensor, states: torch.Tensor, *, bps: int,
                 c_max: int, t_tile: int, k_max: int):
    """(count i32, q [c_max] i32 (``lane * bps + t``, -1 past the count),
    digests [c_max, 8] u32 (rows past the count are garbage))."""
    dev = cf32.device
    count = cf32.sum().to(torch.int32)
    q = cut_positions(cf32, t_tile, k_max, c_max)
    # every strip restarts chunking and every real strip ends in a forced
    # cut, so consecutive positions give exact lengths (the first cut of a
    # strip follows the previous strip's last block, s * bps - 1)
    prev = torch.cat([q.new_full((1,), -1), q[:-1]])
    lens = (q - prev) * BLOCK
    qc = q.clamp(min=0)
    t, s = qc % bps, qc // bps
    rows = t[:, None] * 8 + torch.arange(8, device=dev)[None, :]
    cut_states = u32.widen(states.view(torch.int32)[rows, s[:, None]])
    digests = torch.stack(sha256.compress(
        [cut_states[:, i] for i in range(8)], sha256.pad_block(lens)), 1)
    return count, q.to(torch.int32), u32.narrow(digests)


@functools.cache
def make_segment_fn(params: AlignedCdcParams, s_real: int, s_pad: int):
    """``run(words_le [s_real * bps*16] u32, real_blocks [s_pad] i32) ->
    (count, q, digests)`` on the inputs' device, nothing synced."""
    bps = params.strip_blocks
    c_max = cut_capacity(s_pad, params)
    # compaction tiles never span a strip (t_tile | bps), so in-strip cuts
    # are >= min_blocks apart: a tile holds at most t_tile // min_blocks + 2
    # cuts (+1 partial leading gap, +1 forced strip-final)
    t_tile = 128 if bps % 128 == 0 else bps
    k_max = t_tile // params.min_blocks + 2

    def run(words_le, real_blocks):
        cf32, states = scan_half(words_le, real_blocks, params, s_real, s_pad)
        return compact_half(cf32, states, bps=bps, c_max=c_max,
                            t_tile=t_tile, k_max=k_max)

    run.shape = {"s_real": s_real, "s_pad": s_pad, "c_max": c_max,
                 "t_tile": t_tile, "k_max": k_max}
    return run


def segment_chunks(data: np.ndarray, params: AlignedCdcParams,
                   lane_multiple: int = 128, device=None
                   ) -> list[tuple[int, int, str]]:
    """Chunk one segment (``data`` [n] u8) on ``device`` -> [(offset,
    length, sha256hex)], segment-relative. The strip count is rounded up
    to a power of two (few shapes), the lanes to ``lane_multiple``."""
    dev = resolve_device(device)
    n = int(data.shape[0])
    if n == 0:
        return []
    sl = params.strip_len
    bps = params.strip_blocks
    s_real = next_pow2(-(-n // sl))
    s_pad = max(lane_multiple, s_real)
    if n != s_real * sl:
        raw = np.zeros((s_real * sl,), dtype=np.uint8)
        raw[:n] = data
    else:
        raw = np.ascontiguousarray(data)
    nb = -(-n // BLOCK)                                # incl. partial block
    real_blocks = np.zeros((s_pad,), np.int32)
    real_blocks[:nb // bps] = bps
    if nb % bps:
        real_blocks[nb // bps] = nb % bps

    run = make_segment_fn(params, s_real, s_pad)
    words_le = sha256.u32_tensor(raw.view("<u4"), dev)
    count, q, dig = run(words_le, torch.from_numpy(real_blocks).to(dev))
    count = int(count)
    q = q[:count].cpu().numpy().astype(np.int64)
    dig = dig[:count].cpu().view(torch.int32).numpy().view(np.uint32)
    if count and (q < 0).any():
        raise AssertionError(
            "cut compaction overflowed a tile (k_max too small)")
    ends = np.minimum((q + 1) * BLOCK, n)              # byte end per cut
    starts = np.concatenate([[0], ends[:-1]])
    out = [(int(o), int(e - o), h)
           for o, e, h in zip(starts, ends, digests_to_hex(dig))]
    if n % BLOCK:                                      # partial final block
        o, ln, _ = out[-1]
        out[-1] = (o, ln, hashlib.sha256(raw[o:o + ln].tobytes()).hexdigest())
    return out
