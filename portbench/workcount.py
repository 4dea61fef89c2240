"""The least work that chunking and hashing an input needs, and the H100's
peaks to hold it against (``kernels.chunkhash_roofline``).

Counted from the input and its chunk table, whatever implements it:

- bytes: the input read once and the chunk table written once (an 8-byte
  offset, an 8-byte length and a 32-byte digest a chunk);
- the anchor hash at every byte: the two little-endian words slid on by
  one byte (a shift, a shift and an or each), two ``fmix32`` (three
  shift-xors and two multiplies, 8 operations each), the two adds of the
  seed and the second word, and the mask test (2): 26 operations a byte;
- the Gear hash of every complete 64-byte block: 32 bytes of a table
  load, a shift and an add, and the mask test: 98 operations a block;
- SHA-256 as FIPS 180-4 defines the compression, a rotate counted as one
  operation: the schedule's 48 words of two sigmas (3 shifts or rotates
  and 2 xors each) and 3 adds (624), 64 rounds of two Sigmas (5 each), Ch
  (4), Maj (5) and 7 adds (1,664), the 8 adds of the feed-forward: 2,296
  operations a block, times every chunk's padded blocks
  (``(length + 9 + 63) // 64``).

Peaks of one H100 SXM at its full 700 W: HBM 3.35 TB/s (NVIDIA's data
sheet). INT32 132 SMs x 64 INT32 lanes x 1.98 GHz = 16.73 T operations/s:
derived, not published (the CUDA C++ Programming Guide's throughput table
for compute capability 9.0 gives 64 32-bit adds, logic ops and shifts an
SM a clock; the 1.98 GHz boost clock is the H100 architecture white
paper's). State a share against these with the card's power limit beside
it.
"""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12
BOOST_HZ = 1.98e9
PEAK_INT32_OPS_S = 132 * 64 * BOOST_HZ

BLOCK = 64
TABLE_ROW_BYTES = 8 + 8 + 32
ANCHOR_OPS_PER_BYTE = 3 + 3 + 2 * 8 + 2 + 2
GEAR_OPS_PER_BLOCK = 32 * 3 + 2
SHA256_SCHEDULE_OPS = 48 * (5 + 5 + 3)
SHA256_ROUND_OPS = 5 + 4 + 5 + 5 + 7
SHA256_OPS_PER_BLOCK = SHA256_SCHEDULE_OPS + 64 * SHA256_ROUND_OPS + 8


def padded_blocks(length: int) -> int:
    """SHA-256 blocks of a message of ``length`` bytes after FIPS padding
    (a 0x80 byte and the 8-byte bit length)."""
    return (length + 9 + BLOCK - 1) // BLOCK


def work(n_bytes: int, lengths: list[int]) -> dict:
    """Operations and bytes that chunking and hashing ``n_bytes`` into
    chunks of ``lengths`` need, and the least time on one H100."""
    if sum(lengths) != n_bytes:
        raise ValueError("the chunk lengths do not cover the input")
    sha_blocks = sum(padded_blocks(ln) for ln in lengths)
    ops = (ANCHOR_OPS_PER_BYTE * n_bytes
           + GEAR_OPS_PER_BLOCK * (n_bytes // BLOCK)
           + SHA256_OPS_PER_BLOCK * sha_blocks)
    nbytes = n_bytes + TABLE_ROW_BYTES * len(lengths)
    t_ops, t_bytes = ops / PEAK_INT32_OPS_S, nbytes / PEAK_BYTES_S
    return {"ops": ops, "bytes": nbytes, "sha256_blocks": sha_blocks,
            "bound_s": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
