"""The Gear rolling-hash candidate bitmap in plain PyTorch — dfs_tpu's
``ops/gear_jax.py`` (XLA there, not Pallas).

The sequential recurrence ``h_i = (h_{i-1} << 1) + G[b_i]  (mod 2**32)``
depends on exactly the last 32 bytes, so::

    h_i = sum_{k=0}^{31} G[b_{i-k}] << k   (mod 2**32)

and the bitmap (``h_i & mask == 0``) is 32 shifted adds over the gathered
Gear values, bit-exact against the sequential CPU hash. A tile needs the
Gear values of the 31 bytes before it (the halo; zeros at the stream's
start). Values are u32 carried in int64 (``utils.u32``); tensors at the
interfaces are ``uint8`` bytes and ``uint32`` Gear values. Greedy cut
selection runs on the host (``ops.boundary``).
"""

from __future__ import annotations

import numpy as np
import torch

from dfs_tpu_torch.config import GEAR_HALO as HALO
from dfs_tpu_torch.config import GEAR_WINDOW as WINDOW
from dfs_tpu_torch.utils import u32


def table_tensor(table: np.ndarray, device) -> torch.Tensor:
    """The 256 Gear values as an int64 u32 tensor on ``device``."""
    return torch.from_numpy(np.asarray(table, dtype=np.uint32).astype(
        np.int64)).to(device)


def _wide(x: torch.Tensor) -> torch.Tensor:
    return u32.widen(x) if x.dtype in (torch.uint32, torch.int32) \
        else x.to(torch.int64)


def gear_values(data: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Per-byte Gear lookup: data [..., N] u8, table [256] -> int64 u32."""
    return _wide(table)[data.to(torch.int64)]


def window_hashes(gp: torch.Tensor, n: int) -> torch.Tensor:
    """The hash of each of the last ``n`` positions of ``gp`` [..., HALO +
    n] (int64 u32 Gear values, the halo first)."""
    h = torch.zeros(gp.shape[:-1] + (n,), dtype=torch.int64,
                    device=gp.device)
    for k in range(WINDOW):
        h += u32.shl(gp[..., HALO - k:HALO - k + n], k)
    return h & u32.M32


def gear_hashes_dense(data: torch.Tensor, prev_g: torch.Tensor,
                      table: torch.Tensor) -> torch.Tensor:
    """The full u32 hash per position of ``data`` [N] u8 given the halo
    ``prev_g`` [31] (the tests hold it to the sequential hash)."""
    g = gear_values(data, table)
    gp = torch.cat([_wide(prev_g).to(g.device), g])
    return u32.narrow(window_hashes(gp, data.shape[0]))


def gear_bitmap_tile(data: torch.Tensor, prev_g: torch.Tensor,
                     table: torch.Tensor, mask: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Candidate bitmap of one tile: (bitmap [N] bool, tail_g [31] u32, the
    halo of the next tile). ``data`` [N] u8 with N >= 31; ``prev_g`` [31]
    Gear values of the bytes before the tile."""
    n = data.shape[0]
    g = gear_values(data, table)
    gp = torch.cat([_wide(prev_g).to(g.device), g])
    return (window_hashes(gp, n) & mask) == 0, u32.narrow(gp[-HALO:])


def make_gear_tile_fn(table: np.ndarray, mask: int, tile: int, device):
    """``fn(data u8 [tile], prev_g [31]) -> (bitmap, tail_g)`` on
    ``device``, the table put there once (dfs_tpu's jitted tile kernel)."""
    tab = table_tensor(table, device)

    def fn(data: torch.Tensor, prev_g: torch.Tensor):
        if data.shape != (tile,):
            raise ValueError(f"tile of {tuple(data.shape)}, expected "
                             f"({tile},)")
        return gear_bitmap_tile(data, prev_g, tab, mask)

    return fn
