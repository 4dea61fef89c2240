"""Aligned CDC v2: the 64-byte-grid chunking that runs inside each anchored
segment (lane).

A cut candidate after block ``t`` is decided by a Gear-style windowed hash
over the last 32 bytes of that block only::

    h_t = sum_{k=0}^{31} G[byte[64*t + 63 - k]] << k   (mod 2**32)
    candidate(t)  iff  h_t & mask == 0,   G[b] = fmix32(seed ^ b*PRIME)

Selection per lane (greedy, in block units): walking blocks ``t`` with
``since`` = blocks accumulated so far including ``t``, cut after ``t`` iff
``(candidate(t) and since >= min_blocks)`` or ``since == max_blocks`` or
``t`` is the lane's last block.

This module holds the parameters, the NumPy oracles (the exact semantics),
the host helpers the chain shares, and the plain PyTorch versions of the
candidate and selection passes over the lane-minor layout
``words_t [bps*16, S]`` (``words_t[t*16 + w, s]`` = big-endian word ``w``
of block ``t`` of lane ``s``). The fused CUDA kernel that does both passes
and the SHA-256 scan in one sweep is ``ops.sha256_strip``.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from dfs_tpu_torch.utils import u32

_PRIME = np.uint32(0x9E3779B1)  # 2^32 / golden ratio, odd
_M1 = np.uint32(0x7FEB352D)     # lowbias32 finalizer constants
_M2 = np.uint32(0x846CA68B)

BLOCK = 64  # bytes per block: SHA-256 block size == cut quantum


@dataclasses.dataclass(frozen=True)
class AlignedCdcParams:
    """min/avg/max are in *blocks* (64 B units). Defaults: min 2 KiB, avg
    8 KiB, max 64 KiB, 128 KiB lanes."""
    min_blocks: int = 32
    avg_blocks: int = 128
    max_blocks: int = 1024
    strip_blocks: int = 2048   # 128 KiB per lane
    seed: int = 0x9D5D0CB2

    def __post_init__(self):
        if self.avg_blocks & (self.avg_blocks - 1):
            raise ValueError("avg_blocks must be a power of two (mask)")
        if not (1 <= self.min_blocks <= self.avg_blocks <= self.max_blocks
                <= self.strip_blocks):
            raise ValueError("need 1 <= min <= avg <= max <= strip blocks")

    @property
    def mask(self) -> int:
        return self.avg_blocks - 1

    @property
    def strip_len(self) -> int:
        return self.strip_blocks * BLOCK


# ---------------------------------------------------------------------------
# NumPy oracle (exact semantics)
# ---------------------------------------------------------------------------

def fmix32_np(x: np.ndarray) -> np.ndarray:
    """lowbias32 integer finalizer, vectorized uint32 (NumPy)."""
    x = np.asarray(x, dtype=np.uint32)
    x = x ^ (x >> np.uint32(16))
    x = (x * _M1).astype(np.uint32)
    x = x ^ (x >> np.uint32(15))
    x = (x * _M2).astype(np.uint32)
    return x ^ (x >> np.uint32(16))


def g_table(seed: int) -> np.ndarray:
    """The 256 Gear values G[b] as a table."""
    b = np.arange(256, dtype=np.uint32)
    return fmix32_np(np.uint32(seed) ^ (b * _PRIME))


def block_hashes_np(data: np.ndarray, params: AlignedCdcParams) -> np.ndarray:
    """h_t for every *complete* 64-byte block of ``data`` ([N] uint8)."""
    nb = data.shape[0] // BLOCK
    if nb == 0:
        return np.zeros((0,), dtype=np.uint32)
    g = g_table(params.seed)[data[:nb * BLOCK].reshape(nb, BLOCK)]
    h = np.zeros((nb,), dtype=np.uint32)
    for k in range(32):
        h += g[:, 63 - k] << np.uint32(k)
    return h


def candidates_np(data: np.ndarray, params: AlignedCdcParams) -> np.ndarray:
    """Candidate bitmap over complete blocks."""
    return (block_hashes_np(data, params) & np.uint32(params.mask)) == 0


def select_cuts_blocks(cand_pos: np.ndarray, n_blocks: int,
                       params: AlignedCdcParams) -> np.ndarray:
    """Greedy cut selection for ONE lane, in block units. cand_pos: sorted
    candidate block indices; n_blocks: blocks in the lane (a trailing
    partial block included). Returns exclusive cut block offsets; the last
    element == n_blocks."""
    cuts: list[int] = []
    start = 0
    while start < n_blocks:
        lo = start + params.min_blocks - 1   # earliest admissible cut block
        hi = start + params.max_blocks - 1   # forced cut block
        j = int(np.searchsorted(cand_pos, lo, side="left"))
        if j < cand_pos.shape[0] and cand_pos[j] <= hi:
            cut = int(cand_pos[j])
        else:
            cut = min(hi, n_blocks - 1)
        cuts.append(cut + 1)
        start = cut + 1
    return np.asarray(cuts, dtype=np.int64)


def chunk_spans_np(data: np.ndarray,
                   params: AlignedCdcParams) -> list[tuple[int, int]]:
    """Whole-stream [(offset, length)] spans of the aligned strategy: the
    stream cut into strips of ``strip_len`` bytes, each chunked alone."""
    n = data.shape[0]
    if n == 0:
        return []
    cand = candidates_np(data, params)
    spans: list[tuple[int, int]] = []
    sl = params.strip_len
    for s0 in range(0, n, sl):
        s1 = min(s0 + sl, n)
        nb = -(-(s1 - s0) // BLOCK)  # a trailing partial block included
        pos = np.flatnonzero(cand[s0 // BLOCK: s0 // BLOCK + (s1 - s0)
                                  // BLOCK])
        prev = 0
        for c in select_cuts_blocks(pos, nb, params).tolist():
            off = s0 + prev * BLOCK
            end = min(s0 + c * BLOCK, s1)
            spans.append((off, end - off))
            prev = c
    return spans


def chunk_file_np(data: np.ndarray, params: AlignedCdcParams
                  ) -> list[tuple[int, int, str]]:
    """The aligned oracle chunker: [(offset, length, sha256hex)]."""
    mv = memoryview(np.ascontiguousarray(data))
    return [(o, ln, hashlib.sha256(mv[o:o + ln]).hexdigest())
            for o, ln in chunk_spans_np(data, params)]


def host_to_strips(data: np.ndarray, params: AlignedCdcParams,
                   lane_multiple: int = 128
                   ) -> tuple[np.ndarray, int, int]:
    """[N] u8 -> (words_t [strip_blocks*16, S] u32 BE, S, N): the stream
    zero-padded to whole strips and S to a multiple of ``lane_multiple``,
    transposed on the host (the tests' reference layout)."""
    n = data.shape[0]
    sl = params.strip_len
    s_real = max(1, -(-n // sl))
    s_pad = -(-s_real // lane_multiple) * lane_multiple
    buf = np.zeros((s_pad * sl,), dtype=np.uint8)
    buf[:n] = data
    words = buf.view(">u4").astype(np.uint32)
    words_t = np.ascontiguousarray(
        words.reshape(s_pad, params.strip_blocks * 16).T)
    return words_t, s_pad, n


def cut_positions(cf32: torch.Tensor, t_tile: int, k_max: int, c_max: int
                  ) -> torch.Tensor:
    """Stream-order cut positions ``q = lane * bps + t`` ([c_max] int64, -1
    past the count) from the flags [bps, S]: per ``t_tile``-block tile of
    a lane, the k-th lowest set bit is peeled off with masked
    min-reductions (k < ``k_max``), then scattered to its rank; a rank at
    or past ``c_max`` is dropped (``.at[].set(mode="drop")``)."""
    dev = cf32.device
    i64 = torch.int64
    flat = cf32.T.reshape(-1, t_tile) != 0
    nt = flat.shape[0]
    iota = torch.arange(t_tile, dtype=i64, device=dev)[None, :]
    cnt = flat.sum(dim=1)
    base = torch.cumsum(cnt, 0) - cnt
    poss = []
    cur = flat
    for _ in range(k_max):
        pos = torch.where(cur, iota, t_tile).amin(dim=1)
        poss.append(pos)
        cur = cur & (iota != pos[:, None])
    pos_mat = torch.stack(poss, dim=1)
    gidx = torch.where(pos_mat < t_tile,
                       base[:, None] + torch.arange(k_max, device=dev)[None],
                       c_max)
    vals = torch.arange(nt, dtype=i64, device=dev)[:, None] * t_tile + pos_mat
    return torch.full((c_max + 1,), -1, dtype=i64, device=dev).scatter_(
        0, gidx.clamp(max=c_max).reshape(-1), vals.reshape(-1))[:c_max]


def file_id_from_digests(digests: list[str]) -> str:
    """sha256 over concatenated raw chunk digests (empty: sha256(b''))."""
    h = hashlib.sha256()
    for d in digests:
        h.update(bytes.fromhex(d))
    return h.hexdigest()


def cut_capacity(s: int, params: AlignedCdcParams) -> int:
    """Static bound on cuts over ``s`` lanes: each lane yields at most
    ceil(bps / min_blocks) cuts plus the forced lane-final cut."""
    per_strip = -(-params.strip_blocks // params.min_blocks) + 1
    return s * per_strip


def digests_to_hex(dig: np.ndarray) -> list[str]:
    """[C, 8] uint32 -> lowercase hex, one string per row."""
    be = np.ascontiguousarray(np.asarray(dig, dtype=np.uint32).astype(">u4"))
    hx = be.tobytes().hex()
    return [hx[i * 64:(i + 1) * 64] for i in range(be.shape[0])]


# ---------------------------------------------------------------------------
# plain PyTorch passes over words_t [bps*16, S]
# ---------------------------------------------------------------------------

def gear_table(seed: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """G[b] for b in 0..255 as int64 u32 values (computed, not copied from
    the NumPy table — the two must agree, which the tests check)."""
    b = torch.arange(256, dtype=torch.int64, device=device)
    return u32.fmix32(int(seed) ^ u32.mul(b, int(_PRIME)), int(_M1), int(_M2))


def gear_candidates(words_t: torch.Tensor, seed: int,
                    mask: int) -> torch.Tensor:
    """Candidate bitmap [bps, S] bool from the lane-minor BE words
    [bps*16, S]: the 32-byte window of block t is words 8..15 of block t."""
    bps = words_t.shape[0] // 16
    s = words_t.shape[1]
    w = u32.widen(words_t).reshape(bps, 16, s)[:, 8:16, :]   # [bps, 8, S]
    g = gear_table(seed, words_t.device)
    h = torch.zeros((bps, s), dtype=torch.int64, device=words_t.device)
    # byte j of the window (stream order) is byte j%4 (big-endian) of word
    # j//4; its shift weight is 31 - j
    for j in range(32):
        byte = (w[:, j // 4, :] >> (8 * (3 - j % 4))) & 0xFF
        h = h + u32.shl(g[byte], 31 - j)
    return (h & mask) == 0


def select_cuts(cand: torch.Tensor, real_blocks: torch.Tensor,
                min_blocks: int, max_blocks: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Lane-parallel greedy selection. cand [bps, S] bool; real_blocks [S]
    int — blocks present per lane (0 = padding lane). Returns (cutflag
    [bps, S] bool, since [bps, S] int32 — the cut chunk's length in blocks
    at cut positions, 0 elsewhere).

    The greedy rule cuts a chunk starting at block p at the first t >= p
    with t < rb and ((cand[t] and t-p+1 >= min_blocks) or t-p+1 >=
    max_blocks or t == rb-1). Taken cut to cut, as kernel 1's selection
    does: from each lane's next candidate at or after every block (a
    reversed running minimum), every lane jumps to its next cut at once,
    so the steps are the most chunks a lane has, not ``bps``."""
    bps, s = cand.shape
    dev = cand.device
    i64 = torch.int64
    rb = real_blocks.to(i64)
    rows = torch.arange(bps, dtype=i64, device=dev)[:, None]
    first = torch.where(cand, rows, bps).flip(0).cummin(0).values.flip(0)
    first = torch.cat([first, first.new_full((1, s), bps)])    # [bps+1, S]
    lane = torch.arange(s, dtype=i64, device=dev)
    lo_off, hi_off = max(min_blocks, 1) - 1, max(max_blocks, 1) - 1
    cutflag = torch.zeros((bps, s), dtype=torch.bool, device=dev)
    since = torch.zeros((bps, s), dtype=torch.int32, device=dev)
    p = torch.zeros((s,), dtype=i64, device=dev)
    end = rb.clamp(0, bps)                       # blocks that can cut
    live = p < end
    while bool(live.any()):
        cand_t = first[(p + lo_off).clamp(max=bps), lane]
        cut = torch.minimum(cand_t, torch.minimum(p + hi_off, rb - 1))
        live = live & (cut < bps)                # rb > bps: runs on uncut
        t, j = cut[live], lane[live]
        cutflag[t, j] = True
        since[t, j] = (cut - p + 1)[live].to(torch.int32)
        p = torch.where(live, cut + 1, p)
        live = live & (p < end)
    return cutflag, since
