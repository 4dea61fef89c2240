"""The ``cdc`` host strategy: Gear rolling-hash content-defined chunking
on the CPU, a copy of dfs_tpu's ``fragmenter/cdc_cpu.py``. No kernel runs
here, in dfs_tpu as in the port.

- :func:`cdc_cuts_ref` — the specification: a plain Python sequential
  rolling hash and greedy cut walk.
- :func:`gear_bitmap_carry` / :func:`gear_bitmap_numpy` — the windowed
  Gear candidate bitmap in NumPy (a stream tile needs the 31-entry halo of
  the tile before); with ``ops.boundary.select_cuts`` the NumPy oracle.
- :class:`CpuCdcFragmenter` — cuts from the native sequential engine
  (``native/cdc_core.cpp``, built with g++ at first use; a failed build
  raises), digests from hashlib; ``manifest_stream`` is the bounded-memory
  streaming walk of ``fragmenter/stream.py``.
"""

from __future__ import annotations

import numpy as np

from dfs_tpu_torch.config import GEAR_HALO as HALO
from dfs_tpu_torch.config import GEAR_WINDOW as WINDOW
from dfs_tpu_torch.config import CDCParams
from dfs_tpu_torch.fragmenter.base import MaterializingFragmenter
from dfs_tpu_torch.meta.manifest import ChunkRef
from dfs_tpu_torch.ops.boundary import cuts_to_spans
from dfs_tpu_torch.utils.hashing import gear_table, sha256_many_hex


def gear_hashes_seq(data: bytes, table: np.ndarray) -> np.ndarray:
    """The sequential rolling hash h_i = (h_{i-1} << 1) + G[b_i] mod 2**32
    at every byte (a test oracle: an O(n) Python loop)."""
    h = 0
    out = np.empty(len(data), dtype=np.uint32)
    for i, b in enumerate(data):
        h = ((h << 1) + int(table[b])) & 0xFFFFFFFF
        out[i] = h
    return out


def cdc_cuts_ref(data: bytes, params: CDCParams,
                 table: np.ndarray | None = None) -> list[int]:
    """Specification chunker: sequential scan, cut after the first
    candidate at length >= min_size, force a cut at max_size. Returns the
    exclusive cuts."""
    table = gear_table(params.seed) if table is None else table
    mask = params.mask
    h = 0
    cuts: list[int] = []
    start = 0
    for i, b in enumerate(data):
        h = ((h << 1) + int(table[b])) & 0xFFFFFFFF
        length = i - start + 1
        if length >= params.min_size and (h & mask) == 0:
            cuts.append(i + 1)
            start = i + 1
        elif length >= params.max_size:
            cuts.append(i + 1)
            start = i + 1
    if start < len(data):
        cuts.append(len(data))
    return cuts


def gear_bitmap_carry(data: np.ndarray, table: np.ndarray, mask: int,
                      prev_g: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Windowed Gear candidate bitmap of ``data`` ([N] uint8) given the
    31-entry halo ``prev_g`` of the stream before it (zeros at the
    stream's start). Returns (bitmap, the halo for the next tile)."""
    n = data.shape[0]
    g = table[data.astype(np.int32)]
    gp = np.concatenate([prev_g, g])
    h = np.zeros(n, dtype=np.uint32)
    for k in range(WINDOW):
        h += gp[HALO - k: HALO - k + n] << np.uint32(k)
    return (h & np.uint32(mask)) == 0, gp[-HALO:]


def gear_bitmap_numpy(data: np.ndarray, table: np.ndarray, mask: int,
                      prev_g: np.ndarray | None = None) -> np.ndarray:
    """Bitmap-only wrapper of :func:`gear_bitmap_carry`."""
    if prev_g is None:
        prev_g = np.zeros(HALO, dtype=np.uint32)
    return gear_bitmap_carry(data, table, mask, prev_g)[0]


class CpuCdcFragmenter(MaterializingFragmenter):
    name = "cdc"

    def __init__(self, params: CDCParams | None = None) -> None:
        self.params = params or CDCParams()
        self.table = gear_table(self.params.seed)

    def describe(self) -> dict:
        p = self.params
        return {"kind": "cdc", "min_size": p.min_size,
                "avg_size": p.avg_size, "max_size": p.max_size,
                "seed": p.seed}

    def bitmap_tile(self, arr: np.ndarray,
                    prev_g: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Streaming tile kernel: (bitmap, new 31-entry Gear halo)."""
        return gear_bitmap_carry(arr, self.table, self.params.mask, prev_g)

    def manifest_stream(self, blocks, name: str, store=None):
        from dfs_tpu_torch.fragmenter.stream import manifest_from_stream

        return manifest_from_stream(blocks, self.params, self.bitmap_tile,
                                    name, self.name, store)

    def cuts(self, data: bytes | np.ndarray) -> np.ndarray:
        from dfs_tpu_torch.native import native_gear_cuts

        return native_gear_cuts(data, self.table, self.params.mask,
                                self.params.min_size, self.params.max_size)

    def chunk(self, data: bytes) -> list[ChunkRef]:
        spans = cuts_to_spans(self.cuts(data))
        pieces = [data[o:o + ln] for o, ln in spans]
        digests = sha256_many_hex(pieces)
        return [ChunkRef(index=i, offset=o, length=ln, digest=dg)
                for i, ((o, ln), dg) in enumerate(zip(spans, digests))]
