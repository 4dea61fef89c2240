"""The anchored two-level chunker, the content address and the static
placement, as plain NumPy and hashlib.

This is a frozen copy of the semantics the port implements
(``chunk_file_anchored_np`` and the parameter mapping of a node's
``--min/avg/max-chunk``), kept apart from the program so that the
benchmark's comparison cannot change with it:

1. an 8-byte windowed hash at every byte position p (bytes before the
   stream read as zero): ``h_p = fmix32(fmix32(b_p) + seed + a_p)`` with
   ``b_p = LE32(bytes[p-3..p])`` and ``a_p = LE32(bytes[p-7..p-4])``;
   p is an anchor iff ``h_p & seg_mask == 0``, and only the first two
   anchors of each 512-byte tile are kept;
2. a segment ends after the last kept anchor within ``[start + seg_min,
   start + seg_max]``, else at ``start + seg_max``;
3. inside a segment, on its own 64-byte grid, a block t is a cut candidate
   iff ``sum_k G[byte[64t + 63 - k]] << k  (k < 32, mod 2^32)`` has its low
   ``log2(avg_blocks)`` bits zero; the cut follows the first candidate at
   ``min_blocks`` or more, else ``max_blocks``, else the segment's end;
4. every chunk's address is its SHA-256; a file's is the SHA-256 of its
   bytes; a chunk lives on the ``rf`` nodes that follow
   ``int(digest[:16], 16) mod N`` on the ring of node ids.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

BLOCK = 64                     # bytes per block: the SHA-256 block size
TILE_BYTES = 512               # anchors are kept two per tile
STRIP_BLOCKS_DEFAULT = 2048    # a 128 KiB lane, grown to hold a max chunk
SEG_MASK = 8191                # anchor probability 2^-13 a byte
SEG_SEED = 0x51ED270B
GEAR_SEED = 0x9D5D0CB2
_PRIME = np.uint32(0x9E3779B1)
_M1 = np.uint32(0x7FEB352D)
_M2 = np.uint32(0x846CA68B)
# the anchor hash is taken over pieces of this many bytes (the result does
# not depend on it; it bounds the temporaries)
_HASH_PIECE = 8 * 1024 * 1024


@dataclasses.dataclass(frozen=True)
class Params:
    min_blocks: int
    avg_blocks: int
    max_blocks: int
    strip_blocks: int
    seg_min: int
    seg_max: int
    seg_mask: int = SEG_MASK
    seed: int = SEG_SEED
    gear_seed: int = GEAR_SEED


def params_for(min_chunk: int, avg_chunk: int, max_chunk: int) -> Params:
    """The anchored parameters of a node started with ``--min-chunk``,
    ``--avg-chunk`` and ``--max-chunk`` (bytes): sizes quantized to 64-byte
    blocks, the lane grown to hold one max-size chunk, ``seg_max`` one lane
    and ``seg_min`` three quarters of it, tile-aligned."""
    if avg_chunk & (avg_chunk - 1) or not 0 < min_chunk <= avg_chunk \
            <= max_chunk:
        raise ValueError("need 0 < min <= avg <= max, avg a power of two")
    max_blocks = max(1, max_chunk // BLOCK)
    strip = STRIP_BLOCKS_DEFAULT
    while strip < max_blocks:
        strip *= 2
    seg_max = strip * BLOCK
    seg_min = max(TILE_BYTES, (3 * seg_max // 4) // TILE_BYTES * TILE_BYTES)
    return Params(min_blocks=max(1, min_chunk // BLOCK),
                  avg_blocks=max(1, avg_chunk // BLOCK),
                  max_blocks=max_blocks, strip_blocks=strip,
                  seg_min=seg_min, seg_max=seg_max)


def fmix32(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.uint32)
    x = x ^ (x >> np.uint32(16))
    x = (x * _M1).astype(np.uint32)
    x = x ^ (x >> np.uint32(15))
    x = (x * _M2).astype(np.uint32)
    return x ^ (x >> np.uint32(16))


def anchor_hits(data: np.ndarray, p: Params) -> np.ndarray:
    """Sorted byte positions p whose windowed hash is an anchor."""
    n = data.shape[0]
    padded = np.zeros((n + 8,), dtype=np.uint8)
    padded[8:] = data
    out = []
    for lo in range(0, n, _HASH_PIECE):
        hi = min(n, lo + _HASH_PIECE)
        le = padded[lo:hi + 8].astype(np.uint32)
        m = hi - lo
        # padded index q + 8 holds byte q
        b = (le[5:m + 5] | (le[6:m + 6] << np.uint32(8))
             | (le[7:m + 7] << np.uint32(16)) | (le[8:m + 8] << np.uint32(24)))
        a = (le[1:m + 1] | (le[2:m + 2] << np.uint32(8))
             | (le[3:m + 3] << np.uint32(16)) | (le[4:m + 4] << np.uint32(24)))
        h = fmix32(fmix32(b) + np.uint32(p.seed) + a)
        out.append(np.flatnonzero((h & np.uint32(p.seg_mask)) == 0) + lo)
    return np.concatenate(out) if out else np.zeros((0,), np.int64)


def kept_anchors(data: np.ndarray, p: Params) -> np.ndarray:
    """The first two anchors of each tile."""
    pos = anchor_hits(data, p).astype(np.int64)
    if pos.size == 0:
        return pos
    tile = pos // TILE_BYTES
    first = np.ones_like(pos, dtype=bool)
    first[1:] = tile[1:] != tile[:-1]
    second = np.zeros_like(first)
    second[1:] = first[:-1] & (tile[1:] == tile[:-1])
    return pos[first | second]


def segment_bounds(anchors: np.ndarray, n: int, p: Params) -> list[int]:
    """Exclusive segment ends over ``n`` bytes; the last is ``n``."""
    bounds, start = [], 0
    while n - start > p.seg_max:
        lo, hi = start + p.seg_min, start + p.seg_max
        j = int(np.searchsorted(anchors, hi - 1, side="right")) - 1
        b = int(anchors[j]) + 1 if j >= 0 and anchors[j] >= lo - 1 else hi
        bounds.append(b)
        start = b
    bounds.append(n)
    return bounds


def gear_table(seed: int) -> np.ndarray:
    b = np.arange(256, dtype=np.uint32)
    return fmix32(np.uint32(seed) ^ (b * _PRIME))


def candidate_blocks(seg: np.ndarray, p: Params) -> np.ndarray:
    """Sorted indices of the complete blocks of ``seg`` that are cut
    candidates."""
    nb = seg.shape[0] // BLOCK
    if nb == 0:
        return np.zeros((0,), np.int64)
    g = gear_table(p.gear_seed)[seg[:nb * BLOCK].reshape(nb, BLOCK)]
    h = np.zeros((nb,), dtype=np.uint32)
    for k in range(32):
        h += g[:, 63 - k] << np.uint32(k)
    return np.flatnonzero((h & np.uint32(p.avg_blocks - 1)) == 0)


def block_cuts(cand: np.ndarray, n_blocks: int, p: Params) -> list[int]:
    """Exclusive cut offsets in blocks of one segment; the last is
    ``n_blocks`` (a trailing partial block counts as a block)."""
    cuts, start = [], 0
    while start < n_blocks:
        lo = start + p.min_blocks - 1
        hi = start + p.max_blocks - 1
        j = int(np.searchsorted(cand, lo, side="left"))
        if j < cand.shape[0] and cand[j] <= hi:
            cut = int(cand[j])
        else:
            cut = min(hi, n_blocks - 1)
        cuts.append(cut + 1)
        start = cut + 1
    return cuts


def chunk_spans(data: np.ndarray, p: Params) -> list[tuple[int, int]]:
    """[(offset, length)] of every chunk of a whole stream."""
    n = int(data.shape[0])
    if n == 0:
        return []
    spans, start = [], 0
    for b in segment_bounds(kept_anchors(data, p), n, p):
        seg = data[start:b]
        prev = 0
        for c in block_cuts(candidate_blocks(seg, p),
                            -(-seg.shape[0] // BLOCK), p):
            end = min(c * BLOCK, seg.shape[0])
            spans.append((start + prev * BLOCK, end - prev * BLOCK))
            prev = c
        start = b
    return spans


def chunk_table(data, p: Params) -> list[tuple[int, int, str]]:
    """[(offset, length, sha256 hex)] of every chunk of ``data``."""
    arr = np.ascontiguousarray(np.frombuffer(data, np.uint8)
                               if not isinstance(data, np.ndarray) else data)
    mv = memoryview(arr)
    return [(o, ln, hashlib.sha256(mv[o:o + ln]).hexdigest())
            for o, ln in chunk_spans(arr, p)]


def file_id(data) -> str:
    return hashlib.sha256(data).hexdigest()


def replica_set(digest: str, node_ids: list[int], rf: int) -> list[int]:
    """The ``rf`` nodes that hold a chunk: cyclic from the digest's leading
    64 bits mod the node count."""
    rf = min(rf, len(node_ids))
    start = int(digest[:16], 16) % len(node_ids)
    return [node_ids[(start + j) % len(node_ids)] for j in range(rf)]
