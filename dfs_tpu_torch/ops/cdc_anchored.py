"""Anchored two-level CDC: the region chain that turns one staged window of
the stream into its chunk table.

1. **Byte-granular anchors.** An 8-byte windowed hash at every byte
   position p (bytes before the stream read as zero)::

       b_p = LE32(bytes[p-3 .. p])     a_p = LE32(bytes[p-7 .. p-4])
       h_p = fmix32(fmix32(b_p) + seed + a_p)
       anchor(p)  iff  h_p & seg_mask == 0

   Only the first TWO anchors of each absolute ``TILE_BYTES`` tile are
   kept (the tile table holds two i32 per tile).
2. **Segment selection**: a segment ends at the LAST kept anchor within
   ``[start + seg_min, start + seg_max]``, else it is forced at
   ``start + seg_max``.
3. **Within a segment** the aligned 64-byte grid (``ops.cdc_v2``) runs
   anchored at the segment start: each segment is repacked into its own
   lane, then candidates -> selection -> strip SHA-256, and the compaction
   gathers each cut's state and finalizes its digest. A lane's last chunk
   usually ends in a partial block; its digest is redone from the chain
   state before the tail block plus one or two real FIPS blocks.

The chain for one region (:func:`make_chain_fn`), in order:

- anchor tiles (:func:`anchor_tiles`, plain torch);
- segment selection (kernel 4, ``ops.select``);
- lane descriptors (:func:`descriptors`, plain torch);
- ``scan_half``: repack (kernel 2, ``ops.repack``), LE->BE transpose
  (kernel 3, ``ops.layout``), fused Gear + selection + SHA-256 (kernel 1,
  ``ops.sha256_strip``);
- ``compact_half``: cut compaction, FIPS finalize and lane-tail digests
  (plain torch).

The last two are pass B (:func:`make_segment_fn`), which the sharded
window walk also runs, on lane tables built host-side
(:func:`lane_tables_np`).

Everything runs on the device of the region buffer and enqueues without a
host sync; :func:`region_collect` is the only sync point. The NumPy oracle
(``anchor_hash_np`` ... ``chunk_file_anchored_np``) states the semantics
and the tests hold the chain to it.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib

import numpy as np
import torch

from dfs_tpu_torch import resolve_device
from dfs_tpu_torch.ops import sha256
from dfs_tpu_torch.ops.cdc_v2 import (_M1, _M2, BLOCK, AlignedCdcParams,
                                      candidates_np, cut_capacity,
                                      cut_positions, digests_to_hex,
                                      fmix32_np, select_cuts_blocks)
from dfs_tpu_torch.ops.layout import bswap_transpose
from dfs_tpu_torch.ops.repack import repack_lanes
from dfs_tpu_torch.ops.select import TILE_BYTES, NO_ANCHOR, select_walk
from dfs_tpu_torch.ops.sha256_strip import strip_chunk_states
from dfs_tpu_torch.utils import u32
from dfs_tpu_torch.utils.hashing import next_pow2


@dataclasses.dataclass(frozen=True)
class AnchoredCdcParams:
    """Two-level parameters: byte-granular segment anchoring over the
    aligned chunk grid. ``seg_mask`` fires with probability 2^-13 per byte
    (mean anchor gap 8 KiB); ``seg_max`` must equal
    ``chunk.strip_blocks * 64`` — a segment is one lane."""
    chunk: AlignedCdcParams = dataclasses.field(
        default_factory=AlignedCdcParams)
    seg_min: int = 96 * 1024
    seg_max: int = 128 * 1024
    seg_mask: int = 8191
    seed: int = 0x51ED270B

    def __post_init__(self):
        if self.seg_max != self.chunk.strip_blocks * BLOCK:
            raise ValueError("seg_max must equal one lane "
                             f"({self.chunk.strip_blocks * BLOCK} B)")
        if not 0 < self.seg_min <= self.seg_max:
            raise ValueError("need 0 < seg_min <= seg_max")
        if self.seg_mask & (self.seg_mask + 1):
            raise ValueError("seg_mask must be 2^k - 1")
        if TILE_BYTES > self.seg_min:
            raise ValueError("anchor tile must not exceed seg_min")
        if self.seg_min % TILE_BYTES or self.seg_max % TILE_BYTES:
            raise ValueError("seg_min/seg_max must be multiples of "
                             f"{TILE_BYTES} (device selection window)")


class CutCapacityOverflow(RuntimeError):
    """More cuts (or segments) than the tight provisioning — the caller
    retries the window at the full worst-case bound."""


# ---------------------------------------------------------------------------
# NumPy oracle
# ---------------------------------------------------------------------------

def anchor_hash_np(data: np.ndarray, params: AnchoredCdcParams) -> np.ndarray:
    """h_p for every byte position p of ``data`` [n] u8."""
    n = data.shape[0]
    padded = np.zeros((n + 8,), dtype=np.uint8)
    padded[8:] = data
    le = padded.astype(np.uint32)
    # b_p = LE32(bytes[p-3..p]) built at padded index p+8
    b = (le[5:n + 5] | (le[6:n + 6] << np.uint32(8))
         | (le[7:n + 7] << np.uint32(16)) | (le[8:n + 8] << np.uint32(24)))
    a = (le[1:n + 1] | (le[2:n + 2] << np.uint32(8))
         | (le[3:n + 3] << np.uint32(16)) | (le[4:n + 4] << np.uint32(24)))
    return fmix32_np(fmix32_np(b) + np.uint32(params.seed) + a)


def _first_two_per_tile(pos: np.ndarray) -> np.ndarray:
    """Keep the first TWO entries of each TILE_BYTES tile from sorted byte
    positions (the quantization rule)."""
    if pos.size == 0:
        return pos.astype(np.int64)
    tile = pos // TILE_BYTES
    first = np.ones_like(pos, dtype=bool)
    first[1:] = tile[1:] != tile[:-1]
    second = np.zeros_like(first)
    second[1:] = first[:-1] & (tile[1:] == tile[:-1])
    return pos[first | second].astype(np.int64)


def kept_anchors_np(data: np.ndarray,
                    params: AnchoredCdcParams) -> np.ndarray:
    """Sorted kept anchor positions: first two qualifying bytes per tile."""
    if data.shape[0] == 0:
        return np.zeros((0,), dtype=np.int64)
    hit = (anchor_hash_np(data, params)
           & np.uint32(params.seg_mask)) == 0
    return _first_two_per_tile(np.flatnonzero(hit))


def select_segments(anchors: np.ndarray, n: int,
                    params: AnchoredCdcParams, start0: int = 0,
                    final: bool = True) -> np.ndarray:
    """Exclusive segment boundaries over ``n`` bytes (the last == n when
    ``final``). Boundary value p+1 = the segment ends after byte p. A
    non-final region withholds its unfinished tail segment."""
    bounds: list[int] = []
    start = int(start0)
    ap = np.asarray(anchors, dtype=np.int64)
    while n - start > params.seg_max:
        lo = start + params.seg_min            # min admissible boundary
        hi = start + params.seg_max            # forced boundary
        # anchors p with lo <= p+1 <= hi  <=>  lo-1 <= p <= hi-1
        j = int(np.searchsorted(ap, hi - 1, side="right")) - 1
        b = int(ap[j]) + 1 if j >= 0 and ap[j] >= lo - 1 else hi
        bounds.append(b)
        start = b
    if final:
        bounds.append(n)
    return np.asarray(bounds, dtype=np.int64)


def _segment_spans_np(data: np.ndarray, start: int, b: int,
                      cp: AlignedCdcParams) -> list[tuple[int, int]]:
    """Aligned chunking of segment [start, b), grid re-anchored at start."""
    seg = data[start:b]
    ln = seg.shape[0]
    nb = -(-ln // BLOCK)
    pos = np.flatnonzero(candidates_np(seg, cp))
    cuts = select_cuts_blocks(pos, nb, cp)
    spans: list[tuple[int, int]] = []
    prev = 0
    for c in cuts.tolist():
        end = min(c * BLOCK, ln)
        spans.append((start + prev * BLOCK, end - prev * BLOCK))
        prev = c
    return spans


def chunk_spans_anchored_np(data: np.ndarray, params: AnchoredCdcParams
                            ) -> list[tuple[int, int]]:
    """[(offset, length)] chunks of a whole stream."""
    n = data.shape[0]
    if n == 0:
        return []
    bounds = select_segments(kept_anchors_np(data, params), n, params)
    spans: list[tuple[int, int]] = []
    start = 0
    for b in bounds.tolist():
        spans.extend(_segment_spans_np(data, start, b, params.chunk))
        start = b
    return spans


def region_spans_np(data: np.ndarray, lookback: np.ndarray, start0: int,
                    final: bool, params: AnchoredCdcParams
                    ) -> tuple[list[tuple[int, int]], int]:
    """Host oracle of one region's spans: region-local (offset, length)
    spans + the consumed bound. ``lookback`` = the 8 stream bytes before
    the region (zeros at stream start); the region base must be
    TILE_BYTES-aligned in the stream; a non-final region withholds its
    unfinished tail segment."""
    n = int(data.shape[0])
    if n == 0:
        return [], int(start0)
    ext = np.concatenate([np.asarray(lookback, np.uint8).reshape(8),
                          np.asarray(data)])
    hit = (anchor_hash_np(ext, params) & np.uint32(params.seg_mask)) == 0
    anchors = _first_two_per_tile(np.flatnonzero(hit[8:]))  # region-local
    bounds = select_segments(anchors, n, params, start0=int(start0),
                             final=bool(final))
    spans: list[tuple[int, int]] = []
    start = int(start0)
    for b in bounds.tolist():
        spans.extend(_segment_spans_np(data, start, b, params.chunk))
        start = b
    return spans, start


def chunk_file_anchored_np(data: np.ndarray, params: AnchoredCdcParams
                           ) -> list[tuple[int, int, str]]:
    """The whole-stream oracle: [(offset, length, sha256hex)]."""
    mv = memoryview(np.ascontiguousarray(data))
    return [(o, ln, hashlib.sha256(mv[o:o + ln]).hexdigest())
            for o, ln in chunk_spans_anchored_np(data, params)]


# ---------------------------------------------------------------------------
# device stages (plain torch; kernels 1-4 are called through their wrappers)
# ---------------------------------------------------------------------------

def anchor_tiles(words_full: torch.Tensor, params: AnchoredCdcParams,
                 m_words: int) -> torch.Tensor:
    """words_full [>= 2 + m_words] u32 (the region buffer: 2 lookback words,
    then the region; trailing slack ignored) -> [2, m_words*4/TILE_BYTES]
    i32: the first two kept anchor byte positions per tile (row 0 < row 1
    where present, 2**30 = none), region-local."""
    words = u32.widen(words_full[:2 + m_words])
    dev = words.device
    v, vp = words[1:], words[:-1]          # region words -1 .. m-1
    b1 = torch.full((m_words,), NO_ANCHOR, dtype=torch.int64, device=dev)
    b2 = b1.clone()
    seed, m1, m2 = int(params.seed), int(_M1), int(_M2)
    pos4 = torch.arange(m_words, dtype=torch.int64, device=dev) * 4
    for r in range(4):
        # b for byte phase r of every word: LE32 of the 4 bytes ending at
        # byte 4*i + r (one extra leading word so that a = b one word back)
        b_all = v if r == 3 else (vp >> (8 * (r + 1))) | u32.shl(
            v, 8 * (3 - r))
        b, a = b_all[1:], b_all[:-1]
        h = u32.fmix32(u32.add(u32.fmix32(b, m1, m2), seed, a), m1, m2)
        x = torch.where((h & params.seg_mask) == 0, pos4 + r, NO_ANCHOR)
        # running two smallest hit positions per word (b1 < b2)
        b2 = torch.minimum(b2, torch.maximum(b1, x))
        b1 = torch.minimum(b1, x)
    # per tile: the min comes from b1; the runner-up is the min after the
    # argmin word's entry is replaced by its own second
    tile_w = TILE_BYTES // 4
    w1 = b1.reshape(-1, tile_w)
    w2 = b2.reshape(-1, tile_w)
    t1 = w1.amin(dim=1)
    t2 = torch.where(w1 == t1[:, None], w2, w1).amin(dim=1)
    return torch.stack([t1, t2]).to(torch.int32)


def descriptors(bounds: torch.Tensor, start0: torch.Tensor, s_pad: int):
    """(bounds [cap] i32 — select output, start0 i32 scalar) -> (starts,
    seg_lens, w_off, sh8 (u32), real_blocks, tail_len — each [s_pad] —
    consumed, nseg). ``consumed``/``nseg`` cover the FULL boundary list;
    the lane tables may truncate it under tight provisioning."""
    cap = bounds.shape[0]
    b = bounds.to(torch.int64)
    valid = b >= 0
    st0 = start0.reshape(1).to(torch.int64)
    starts = torch.where(valid, torch.cat([st0, b[:-1]]), 0)
    seg_lens = torch.where(valid, b - starts, 0)
    consumed = torch.where(valid, b, st0).amax()
    nseg = valid.sum()
    if s_pad >= cap:
        pad = torch.zeros((s_pad - cap,), dtype=torch.int64, device=b.device)
        starts_p = torch.cat([starts, pad])
        seg_lens_p = torch.cat([seg_lens, pad])
    else:
        starts_p, seg_lens_p = starts[:s_pad], seg_lens[:s_pad]
    i32 = torch.int32
    w_off = starts_p // 4 + 2                     # +2: the lookback words
    sh8 = u32.narrow((starts_p % 4) * 8)
    real_blocks = (seg_lens_p + BLOCK - 1) // BLOCK
    tail_len = seg_lens_p % BLOCK
    return (starts_p.to(i32), seg_lens_p.to(i32), w_off.to(i32), sh8,
            real_blocks.to(i32), tail_len.to(i32), consumed.to(i32),
            nseg.to(i32))


def lane_tables_np(bounds, start0: int, s_pad: int):
    """Host-side pass-B lane tables for ONE region from its segment bounds:
    the NumPy mirror of :func:`descriptors`' encoding (word floor + 2
    lookback words, ``8*(start%4)`` funnel shift, ceil-div block counts,
    tail lengths), padded to ``s_pad`` lanes. Returns ``(starts, seg_lens,
    w_off, sh8, real_blocks, tail_len)``, each ``[s_pad]`` (``sh8`` u32,
    the rest i32)."""
    bounds = np.asarray(bounds, dtype=np.int64)
    nseg = int(bounds.shape[0])
    if nseg > s_pad:
        raise ValueError(f"{nseg} segments > lane table {s_pad}")
    starts = np.zeros((s_pad,), np.int32)
    seg_lens = np.zeros((s_pad,), np.int32)
    w_off = np.zeros((s_pad,), np.int32)
    sh8 = np.zeros((s_pad,), np.uint32)
    real_blocks = np.zeros((s_pad,), np.int32)
    tail_len = np.zeros((s_pad,), np.int32)
    if nseg:
        st = np.concatenate([[int(start0)], bounds[:-1]])
        lens = bounds - st
        starts[:nseg] = st
        seg_lens[:nseg] = lens
        w_off[:nseg] = st // 4 + 2       # +2: the 8 lookback bytes
        sh8[:nseg] = (st % 4) * 8
        real_blocks[:nseg] = -(-lens // BLOCK)
        tail_len[:nseg] = lens % BLOCK
    return starts, seg_lens, w_off, sh8, real_blocks, tail_len


def _tight_segment_lanes(params: AnchoredCdcParams, m_words: int,
                         lane_multiple: int) -> int:
    """Lane count for cap_mode='tight': ~1.1x the EXPECTED segment count
    (expected segment length = seg_max minus one mean anchor gap), rounded
    to ``lane_multiple``, capped at the worst case. Denser content trips
    the exact segment count and the window is redone at 'full'."""
    full = m_words * 4 // params.seg_min + 1
    avg_seg = max(params.seg_min, params.seg_max - (params.seg_mask + 1))
    expected = max(1, m_words * 4 // avg_seg)
    tight = -(-(expected * 11 // 10) // lane_multiple) * lane_multiple
    return min(tight, -(-full // lane_multiple) * lane_multiple)


def scan_half(words, w_off, sh8, real_blocks, cp: AlignedCdcParams,
              s_pad: int):
    """Repack (K2) -> LE->BE transpose (K3) -> fused Gear + selection +
    SHA-256 (K1); states relaid to [bps*S, 8] rows."""
    packed = repack_lanes(words, w_off, sh8, cp.strip_blocks * 16)
    words_t = bswap_transpose(packed)                   # [bps*16, s_pad] BE
    cf32, since, states = strip_chunk_states(
        words_t, real_blocks, cp.seed, cp.mask, cp.min_blocks, cp.max_blocks)
    return cf32, since, sha256.cut_state_rows(states, s_pad)


def compact_half(cf32, since, state_rows, words, w_off, sh8, real_blocks,
                 tail_len, starts, seg_lens, *, bps: int, s_pad: int,
                 c_max: int, t_tile: int, k_max: int):
    """Cut compaction + digests: (count i32, q [c_max] i32 (lane*bps + t,
    -1 pad), offs [c_max] i32, lens [c_max] i32, digests [c_max, 8] u32);
    rows past count are garbage. A tile of ``t_tile`` blocks of one lane
    holds at most ``k_max`` cuts."""
    dev = cf32.device
    i64 = torch.int64
    count = cf32.sum().to(torch.int32)
    q = cut_positions(cf32, t_tile, k_max, c_max)

    qc = q.clamp(min=0)
    t, s = qc % bps, qc // bps
    since_flat = since.reshape(-1).to(i64)
    rb = real_blocks.to(i64)
    tl = tail_len.to(i64)
    rows_i32 = state_rows.view(torch.int32)
    blocks = since_flat[t * s_pad + s]
    is_tail = (t == rb[s] - 1) & (tl[s] > 0)
    lens = blocks * BLOCK - torch.where(is_tail, BLOCK - tl[s], 0)
    cut_states = u32.widen(rows_i32[t * s_pad + s])            # [c_max, 8]

    # ---- lane-tail digests: the strip scan compressed a zero-padded
    # partial block; redo the final block(s) with real FIPS padding ----
    lane = torch.arange(s_pad, dtype=i64, device=dev)
    last_t = (rb - 1).clamp(min=0)
    tail_since = since_flat[last_t * s_pad + lane]
    prev = u32.widen(rows_i32[((last_t - 1) * s_pad + lane).clamp(min=0)])
    h0 = sha256.h0_tensor(dev)[None, :]
    state0 = torch.where((tail_since <= 1)[:, None], h0, prev)  # [s_pad, 8]
    # tail block content (LE) regathered from the region buffer, 17 words
    # (start clamped like a dynamic_slice), masked beyond tail_len, 0x80
    # appended
    m_total = words.shape[0]
    o = (w_off.to(i64) + last_t * 16).clamp(0, m_total - 17)
    x = u32.widen(words.view(torch.int32)[
        o[:, None] + torch.arange(17, device=dev)[None, :]])
    sh = u32.widen(sh8)[:, None]
    # sh == 0 shifts the next word out entirely (shl truncates to 32 bits)
    tw = (x[:, :-1] >> sh) | u32.shl(x[:, 1:], 32 - sh)
    byte0 = torch.arange(16, dtype=i64, device=dev)[None, :] * 4
    keep = (tl[:, None] - byte0).clamp(0, 4)
    tw = tw & torch.where(keep >= 4, u32.M32, (1 << (8 * keep)) - 1)
    in_word = (tl[:, None] // 4) == torch.arange(16, device=dev)[None, :]
    tw = tw | torch.where(in_word, (0x80 << (8 * (tl % 4)))[:, None], 0)
    twb = u32.bswap32(tw)                                       # BE words

    tail_bytes = ((tail_since - 1) * BLOCK + tl) & u32.M32
    bits_lo = (tail_bytes * 8) & u32.M32
    bits_hi = tail_bytes >> 29
    fits = tl <= 55             # the length fits in the tail block
    w_fit = twb.clone()
    w_fit[:, 14] = torch.where(fits, bits_hi, twb[:, 14])
    w_fit[:, 15] = torch.where(fits, bits_lo, twb[:, 15])
    # batch 1: the tail block with its length (fits) and without (overflow)
    st_in = torch.cat([state0, state0])
    w_in = torch.cat([w_fit, twb])
    out1 = torch.stack(sha256.compress([st_in[:, i] for i in range(8)],
                                       [w_in[:, i] for i in range(16)]), 1)
    d_fit, st2 = out1[:s_pad], out1[s_pad:]
    # batch 2: the synthetic pad block of every cut chunk, and the pure
    # length block after an overflowing tail
    w_pad = torch.stack(sha256.pad_block(lens), 1)              # [c_max, 16]
    zero = torch.zeros_like(bits_lo)
    w_len = torch.stack([zero] * 14 + [bits_hi, bits_lo], 1)
    st_in = torch.cat([cut_states, st2])
    w_in = torch.cat([w_pad, w_len])
    out2 = torch.stack(sha256.compress([st_in[:, i] for i in range(8)],
                                       [w_in[:, i] for i in range(16)]), 1)
    digests, d_ovf = out2[:c_max], out2[c_max:]
    tail_digest = torch.where(fits[:, None], d_fit, d_ovf)     # [s_pad, 8]
    digests = torch.where(is_tail[:, None], tail_digest[s], digests)

    # region-local byte spans
    st64, sl64 = starts.to(i64), seg_lens.to(i64)
    ends = st64[s] + torch.minimum((t + 1) * BLOCK, sl64[s])
    offs = ends - lens
    i32 = torch.int32
    return (count, q.to(i32), offs.to(i32), lens.to(i32),
            u32.narrow(digests))


@functools.cache
def make_segment_fn(params: AnchoredCdcParams, m_words: int, s_pad: int,
                    cap_mode: str = "full"):
    """Pass B of one region on ``s_pad`` segment lanes: ``run(words, w_off,
    sh8, real_blocks, tail_len, starts, seg_lens) -> (count, q, offs,
    lens, digests)`` — :func:`scan_half` then :func:`compact_half`, on the
    buffer's device, nothing synced. ``m_words`` (region words) sizes the
    cut capacity: the worst case at 'full', ~1.25x the expected cut count
    at 'tight'. The counterpart of dfs_tpu's ``make_anchored_segment_fn``;
    the sharded window step runs it at 'full' on host lane tables."""
    cp = params.chunk
    bps = cp.strip_blocks
    # cuts <= blocks/min + one forced lane-final cut per lane, and the
    # per-lane bound; tight: 1.25x the expected count
    c_max = min(cut_capacity(s_pad, cp),
                (m_words // 16 + s_pad) // cp.min_blocks + s_pad)
    if cap_mode == "tight":
        c_max = min(c_max, (m_words // 16 // cp.avg_blocks + s_pad) * 5 // 4)
    # compaction tiles never span a lane, so in-lane cuts are >= min_blocks
    # apart: a tile holds at most t_tile // min_blocks + 2 cuts (+1 partial
    # leading gap, +1 forced lane-final)
    t_tile = 128 if bps % 128 == 0 else bps
    k_max = t_tile // cp.min_blocks + 2

    def run(words, w_off, sh8, real_blocks, tail_len, starts, seg_lens):
        cf32, since, rows = scan_half(words, w_off, sh8, real_blocks, cp,
                                      s_pad)
        return compact_half(cf32, since, rows, words, w_off, sh8,
                            real_blocks, tail_len, starts, seg_lens,
                            bps=bps, s_pad=s_pad, c_max=c_max,
                            t_tile=t_tile, k_max=k_max)

    run.shape = {"c_max": c_max, "t_tile": t_tile, "k_max": k_max}
    return run


@functools.cache
def make_chain_fn(params: AnchoredCdcParams, total_words: int,
                  lane_multiple: int, cap_mode: str):
    """The whole region chain for region buffers of ``total_words`` words:
    ``run(words, start0, n, final) -> (consumed, seg_overflow, count, q,
    offs, lens, digests)``, all tensors on the buffer's device, nothing
    synced.

    cap_mode='tight' provisions the segment lanes at ~1.1x the expected
    segment count and the cut capacity at ~1.25x the expected cut count.
    The select walk always runs at the full bound, so ``consumed`` (the
    carry the pipelined walk chains on) stays exact even when the lane
    tables truncate; ``seg_overflow`` is nonzero iff the region has more
    segments than lanes, and :func:`region_collect` then raises
    :class:`CutCapacityOverflow` so the caller redoes the window at
    'full'."""
    m_words = recover_m_words(total_words, params)
    cap = m_words * 4 // params.seg_min + 1
    tight = cap_mode == "tight"
    if tight:
        s_pad = _tight_segment_lanes(params, m_words, lane_multiple)
    else:
        s_pad = -(-cap // lane_multiple) * lane_multiple
    segment = make_segment_fn(params, m_words, s_pad, cap_mode)

    def run(words, start0, n: int, final: bool):
        dev = words.device
        if not isinstance(start0, torch.Tensor):
            start0 = _dev_i32([int(start0)], dev)[0]
        scal = torch.cat([start0.reshape(1).to(torch.int32),
                          _dev_i32([int(n), int(bool(final))], dev)])
        tiles = anchor_tiles(words, params, m_words)
        bounds = select_walk(tiles, scal, cap, params.seg_min, params.seg_max)
        (starts, seg_lens, w_off, sh8, real_blocks, tail_len, consumed,
         nseg) = descriptors(bounds, scal[0], s_pad)
        seg_overflow = (nseg > s_pad).to(torch.int32) if tight \
            else torch.zeros((), dtype=torch.int32, device=dev)
        return (consumed, seg_overflow,
                *segment(words, w_off, sh8, real_blocks, tail_len, starts,
                         seg_lens))

    run.shape = {"m_words": m_words, "cap": cap, "s_pad": s_pad,
                 "bps": params.chunk.strip_blocks, **segment.shape}
    return run


def _dev_i32(vals: list[int], device: torch.device) -> torch.Tensor:
    """Small int32 host values on ``device`` without a stream sync (a
    pinned staging copy enqueued on the current stream)."""
    t = torch.tensor(vals, dtype=torch.int32)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


# ---------------------------------------------------------------------------
# host side: region buffer -> dispatch -> collect
# ---------------------------------------------------------------------------

def region_buffer_size(n: int, params: AnchoredCdcParams,
                       m_words: int | None = None) -> int:
    """Byte size of the staging buffer for an ``n``-byte region: 8
    lookback bytes, the region padded to a power-of-two number of tiles,
    one lane plus one funnel word of slack, rounded up to 4096 bytes (the
    layout the JAX package stages, kept so both chunk identically)."""
    if m_words is None:
        m_words = next_pow2(-(-n // TILE_BYTES)) * (TILE_BYTES // 4)
    raw = 8 + m_words * 4 + params.seg_max + 4
    return -(-raw // 4096) * 4096


def recover_m_words(total_words: int, params: AnchoredCdcParams) -> int:
    """Invert :func:`region_buffer_size`: region words from the buffer's
    word length, floored to whole tiles (zero tiles past the data never
    change selection)."""
    tile_w = TILE_BYTES // 4
    return (total_words - 2
            - (params.seg_max + 4) // 4) // tile_w * tile_w


def region_buffer(data: np.ndarray, lookback: np.ndarray,
                  params: AnchoredCdcParams, m_words: int | None = None,
                  out: np.ndarray | None = None) -> np.ndarray:
    """Host staging buffer for one region, [8 lookback bytes][region][zero
    slack], returned as its little-endian u32 view. ``out`` (a u8 buffer of
    exactly the right size) is filled in place."""
    n = int(data.shape[0])
    total = region_buffer_size(n, params, m_words=m_words)
    if out is None:
        buf = np.zeros((total,), dtype=np.uint8)
    else:
        if out.shape[0] != total or out.dtype != np.uint8:
            raise ValueError("recycled buffer has the wrong shape")
        buf = out
        buf[8 + n:] = 0
    buf[:8] = lookback
    buf[8:8 + n] = data
    return buf.view("<u4")


def words_tensor(buf: np.ndarray) -> torch.Tensor:
    """A region buffer's u32 view as a CPU uint32 tensor (no copy)."""
    return torch.from_numpy(np.asarray(buf).view(np.int32)).view(torch.uint32)


def region_dispatch(words: torch.Tensor, n: int, start0, final: bool,
                    params: AnchoredCdcParams, lane_multiple: int = 128,
                    cap_mode: str = "tight"):
    """Enqueue the chain on a device-resident region buffer (``words``,
    uint32). ``start0`` may be an int or a device scalar: a device scalar
    keeps a multi-region walk free of host syncs. Returns the 7 output
    tensors; nothing blocks."""
    chain = make_chain_fn(params, int(words.shape[0]), lane_multiple,
                          cap_mode)
    return chain(words, start0, n, final)


def region_collect(out) -> tuple[list[tuple[int, int, str]], int]:
    """Pull a :func:`region_dispatch` result to the host and format it:
    ([(region_offset, length, sha256hex)], consumed). The chain's only
    sync point."""
    consumed, seg_of, count, q, offs, lens, dig = (t.cpu() for t in out)
    if int(seg_of):
        raise CutCapacityOverflow("segment lanes overflowed tight "
                                  "provisioning")
    count = int(count)
    if count > q.shape[0]:
        raise CutCapacityOverflow(f"{count} cuts > capacity {q.shape[0]}")
    if count and bool((q[:count] < 0).any()):
        raise AssertionError("anchored cut compaction overflowed a tile")
    hexes = digests_to_hex(dig[:count].view(torch.int32).numpy().view(
        np.uint32))
    return [(int(o), int(ln), h) for o, ln, h in
            zip(offs[:count].tolist(), lens[:count].tolist(), hexes)], \
        int(consumed)


def region_chunks(data: np.ndarray, lookback: np.ndarray, start0: int,
                  final: bool, params: AnchoredCdcParams,
                  lane_multiple: int = 128, cap_mode: str = "tight",
                  device=None) -> tuple[list[tuple[int, int, str]], int]:
    """Chunk one stream region on ``device``: ([(region_offset, length,
    sha256hex)], consumed). ``lookback`` = the 8 stream bytes before the
    region; ``start0`` = carry position inside it; ``final`` = the stream
    ends at data[-1] (else the tail segment is withheld). A tight
    provisioning overflow is redone once at the full bound."""
    dev = resolve_device(device)
    n = int(data.shape[0])
    if n == 0:
        return [], 0
    words = words_tensor(region_buffer(data, lookback, params)).to(dev)
    out = region_dispatch(words, n, start0, final, params,
                          lane_multiple=lane_multiple, cap_mode=cap_mode)
    try:
        return region_collect(out)
    except CutCapacityOverflow:
        out = region_dispatch(words, n, start0, final, params,
                              lane_multiple=lane_multiple, cap_mode="full")
        return region_collect(out)


def batch_chunks_anchored(data: np.ndarray, params: AnchoredCdcParams,
                          lane_multiple: int = 128, device=None
                          ) -> list[tuple[int, int, str]]:
    """Whole-stream convenience wrapper over :func:`region_chunks`."""
    chunks, _ = region_chunks(np.asarray(data), np.zeros((8,), np.uint8), 0,
                              True, params, lane_multiple=lane_multiple,
                              device=device)
    return chunks
