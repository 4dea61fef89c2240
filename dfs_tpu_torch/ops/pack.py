"""Chunk packing and hashing from a device-resident byte array — dfs_tpu's
``ops/pack_jax.py``.

The stream's bytes are on the device once; for each length bucket
:func:`digest_gathered` gathers every chunk's bytes with a ``[B, l64]``
index matrix (starts + iota), applies the FIPS 180-4 padding
arithmetically (0x80 at ``pos == len``, zeros after, the big-endian bit
length in the block the length dictates), packs the bytes big-endian into
u32 words (plain torch, as dfs_tpu's was XLA) and hashes the batch with
kernel 6 (``ops.sha256.sha256_blocks``). Only ``starts`` and ``lens`` cross
from the host per bucket. :func:`pack_gathered` is that packing alone: with
``sha256_blocks_plain`` it is kernel 7's plain version
(``ops.sha256.sha256_spans_plain``). The port's v1 path hashes its spans
with kernel 7 itself, one launch for every span.

The bit length is the full 64 bits (:func:`length_words`), as FIPS 180-4,
hashlib and kernel 7 write it; dfs_tpu's ``digest_gathered`` writes only
its low 32, so the two differ on a span of 2^29 bytes or more.
"""

from __future__ import annotations

import numpy as np
import torch

from dfs_tpu_torch.ops.gear import gear_bitmap_tile, table_tensor
from dfs_tpu_torch.ops.sha256 import sha256_blocks
from dfs_tpu_torch.utils import u32


def length_words(ln):
    """The FIPS 180-4 length words of ``ln``-byte messages: (word 14, word
    15) of the last block, the high and low halves of the big-endian bit
    length ``8 * ln``. ``ln``: an int or an int64 tensor."""
    return ln >> 29, (ln << 3) & u32.M32


def digest_gathered(data: torch.Tensor, starts: torch.Tensor,
                    lens: torch.Tensor, l64: int) -> torch.Tensor:
    """data [M] u8 (resident); starts/lens [B] i32 (``lens == -1`` marks a
    batch-padding row, whose output the caller drops); ``l64`` the padded
    row length in bytes, a multiple of 64 with ``l64 >= max(lens) + 9``.
    Returns the [B, 8] u32 digest states."""
    return sha256_blocks(*pack_gathered(data, starts, lens, l64))


def pack_gathered(data: torch.Tensor, starts: torch.Tensor,
                  lens: torch.Tensor, l64: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The gather, padding and packing of :func:`digest_gathered`: ->
    (words [B, l64 // 64, 16] u32 BE, nblocks [B] i32), kernel 6's
    inputs."""
    dev = data.device
    i64 = torch.int64
    st = starts.to(i64)[:, None]
    ln = lens.to(i64)[:, None]
    pos = torch.arange(l64, dtype=i64, device=dev)[None, :]
    idx = torch.minimum(st + pos, torch.tensor(data.shape[0] - 1, device=dev))
    raw = data[idx].to(i64)
    byte = torch.where(pos < ln, raw, 0) | torch.where(pos == ln, 0x80, 0)
    b = byte.reshape(byte.shape[0], l64 // 4, 4)
    w = (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]
    nb = torch.div(ln + 8, 64, rounding_mode="floor") + 1         # [B, 1]
    # a -1 padding row keeps dfs_tpu's words (its output is dropped)
    bits_hi, bits_lo = length_words(ln & u32.M32)
    bits_hi = torch.where(ln < 0, 0, bits_hi)
    widx = torch.arange(l64 // 4, dtype=i64, device=dev)[None, :]
    words = torch.where(widx == nb * 16 - 1, bits_lo,
                        torch.where(widx == nb * 16 - 2, bits_hi, w))
    return (u32.narrow(words).reshape(words.shape[0], l64 // 64, 16)
            .contiguous(), nb[:, 0].to(torch.int32))


def make_resident_tile_fn(table: np.ndarray, mask: int, tile: int, device):
    """``fn(data, offset, prev_g) -> (bitmap [tile], tail_g [31])``: the Gear
    bitmap of ``data[offset:offset + tile]`` of a resident array (the start
    clamped so the slice fits, as a ``dynamic_slice`` clamps), no per-tile
    transfer."""
    tab = table_tensor(table, device)

    def fn(data: torch.Tensor, offset: int, prev_g: torch.Tensor):
        off = max(0, min(int(offset), data.shape[0] - tile))
        return gear_bitmap_tile(data[off:off + tile], prev_g, tab, mask)

    return fn
