"""The v1 rolling pipeline on the card — dfs_tpu's ``fragmenter/cdc_tpu.py``
(``cdc-tpu``), kept as a byte-granular compatibility path: the same chunks
as the host ``cdc`` strategy, computed on the device.

1. The stream is padded to a power-of-two multiple of the 32 MiB tile and
   put on the device once.
2. Each tile's Gear candidate bitmap is computed on the device from the
   resident array (``ops.pack.make_resident_tile_fn``, plain torch),
   threading the 31-value halo; the bitmap comes back to the host.
3. Greedy cut selection runs on the host (``ops.boundary``).
4. Every chunk is hashed from the resident array by one launch of kernel
   7 (``ops.sha256.sha256_spans``: the gather, the FIPS padding and the
   packing in the kernel), where dfs_tpu gathers and packs each
   power-of-two length bucket (``digest_gathered``) for its batched scan.

``manifest_stream`` is the bounded-memory walk of ``fragmenter/stream.py``
with the device bitmap for whole tiles and kernel 7 for the digests
(``hash_fn``: each flush of ``hash_batch`` payloads is cut, in order, into
parts of at most ``split_bytes``, under 2^31 so that every start fits
kernel 7's int32 table; each part is one host-to-device copy and one
launch). ``device`` None means the card (raising without one); "cpu" runs
the plain versions.
"""

from __future__ import annotations

import numpy as np
import torch

from dfs_tpu_torch import resolve_device
from dfs_tpu_torch.config import GEAR_HALO as HALO
from dfs_tpu_torch.config import CDCParams
from dfs_tpu_torch.fragmenter.base import MaterializingFragmenter
from dfs_tpu_torch.meta.manifest import ChunkRef, Manifest
from dfs_tpu_torch.ops.boundary import cuts_to_spans, select_cuts
from dfs_tpu_torch.ops.gear import make_gear_tile_fn
from dfs_tpu_torch.ops.pack import make_resident_tile_fn
from dfs_tpu_torch.ops.sha256 import sha256_spans, state_to_hex
from dfs_tpu_torch.utils.hashing import gear_table, next_pow2

_DEFAULT_TILE = 32 * 1024 * 1024  # 32 MiB per device dispatch
_SPLIT_BYTES = 2**31 - 1          # bytes of one kernel 7 call of a flush


class CudaCdcFragmenter(MaterializingFragmenter):
    name = "cdc-cuda"

    def __init__(self, params: CDCParams | None = None,
                 tile_size: int = _DEFAULT_TILE, hash_batch: int = 512,
                 device=None, split_bytes: int = _SPLIT_BYTES) -> None:
        self.params = params or CDCParams()
        self.device = resolve_device(device)
        self.table = gear_table(self.params.seed)
        self.tile_size = int(tile_size)
        if self.tile_size & (self.tile_size - 1):
            raise ValueError("tile_size must be a power of two (keeps the "
                             "resident array a whole number of tiles)")
        self.hash_batch = int(hash_batch)
        self.split_bytes = int(split_bytes)
        if not 0 < self.split_bytes < 2**31:
            raise ValueError("split_bytes must be in [1, 2**31)")
        # device offsets stay below 2**31, as in dfs_tpu: longer streams
        # take the streaming path
        self._max_resident = 2**31 - self.tile_size
        self._tile_fn = make_gear_tile_fn(self.table, self.params.mask,
                                          self.tile_size, self.device)
        self._resident_tile_fn = make_resident_tile_fn(
            self.table, self.params.mask, self.tile_size, self.device)

    def _device_put_padded(self, arr: np.ndarray) -> torch.Tensor:
        """The stream on the device in one transfer, padded to the next
        power-of-two multiple of the tile."""
        n = arr.shape[0]
        m = next_pow2(max(self.tile_size, n))
        padded = np.zeros((m,), dtype=np.uint8)
        padded[:n] = arr
        return torch.from_numpy(padded).to(self.device)

    # ---- the device bitmap over the resident array, host selection ----

    def _cuts_resident(self, dev: torch.Tensor, n: int) -> np.ndarray:
        prev_g = torch.zeros((HALO,), dtype=torch.int64, device=self.device)
        pieces = []
        for off in range(0, n, self.tile_size):
            bitmap, prev_g = self._resident_tile_fn(dev, off, prev_g)
            pieces.append(bitmap)
        bitmap_all = torch.cat(pieces).cpu().numpy()[:n]
        return select_cuts(bitmap_all, n, self.params.min_size,
                           self.params.max_size)

    def cuts(self, data: bytes | np.ndarray) -> np.ndarray:
        arr = np.frombuffer(data, dtype=np.uint8) if isinstance(
            data, (bytes, bytearray, memoryview)) else data
        if arr.shape[0] == 0:
            return np.zeros((0,), dtype=np.int64)
        return self._cuts_resident(self._device_put_padded(arr),
                                   arr.shape[0])

    # ---- hashing: kernel 7, one launch for every span ----

    def digest_spans_resident(self, dev: torch.Tensor,
                              spans: list[tuple[int, int]]) -> list[str]:
        """The hex digests of ``(offset, length)`` spans of the resident
        array, in one kernel 7 launch."""
        table = np.asarray(spans, dtype=np.int64).reshape(-1, 2)
        return state_to_hex(sha256_spans(dev, table[:, 0], table[:, 1]))

    def chunk(self, data: bytes) -> list[ChunkRef]:
        arr = np.frombuffer(data, dtype=np.uint8)
        n = arr.shape[0]
        if n == 0:
            return []
        if n >= self._max_resident:
            return list(self.manifest_stream([arr], name="").chunks)
        dev = self._device_put_padded(arr)
        spans = cuts_to_spans(self._cuts_resident(dev, n))
        digests = self.digest_spans_resident(dev, spans)
        return [ChunkRef(index=i, offset=o, length=ln, digest=dg)
                for i, ((o, ln), dg) in enumerate(zip(spans, digests))]

    # ---- streaming ----

    def bitmap_tile(self, arr: np.ndarray,
                    prev_g: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Whole tiles go to the device kernel; a short tile takes the
        host kernel (the same bitmap from the same real bytes)."""
        if arr.shape[0] == self.tile_size:
            bitmap, tail = self._tile_fn(
                torch.from_numpy(np.array(arr)).to(self.device),
                torch.from_numpy(np.asarray(prev_g, dtype=np.uint32)
                                 .astype(np.int64)).to(self.device))
            return (bitmap.cpu().numpy(),
                    tail.cpu().view(torch.int32).numpy().view(np.uint32))
        from dfs_tpu_torch.fragmenter.cdc_cpu import gear_bitmap_carry

        return gear_bitmap_carry(arr, self.table, self.params.mask,
                                 np.asarray(prev_g, dtype=np.uint32))

    def digest_many(self, payloads: list[bytes]) -> list[str]:
        """Hash host byte strings, in order: cut into parts of at most
        ``split_bytes`` (a longer payload is a part of its own), each part
        joined into one buffer, one host-to-device copy and one kernel 7
        launch."""
        lens = np.fromiter((len(p) for p in payloads), dtype=np.int64,
                           count=len(payloads))
        out: list[str] = []
        i = 0
        while i < len(payloads):
            ends = np.cumsum(lens[i:])
            j = i + max(1, int(np.searchsorted(ends, self.split_bytes,
                                               side="right")))
            starts = np.zeros((j - i,), dtype=np.int64)
            np.cumsum(lens[i:j - 1], out=starts[1:])
            joined = np.concatenate([np.frombuffer(p, dtype=np.uint8)
                                     for p in payloads[i:j]])
            dev = torch.from_numpy(joined).to(self.device)
            out.extend(state_to_hex(sha256_spans(dev, starts, lens[i:j])))
            del dev, joined
            i = j
        return out

    def manifest_stream(self, blocks, name: str, store=None) -> Manifest:
        from dfs_tpu_torch.fragmenter.stream import (manifest_from_stream,
                                                     reblock)

        return manifest_from_stream(
            reblock(blocks, self.tile_size), self.params, self.bitmap_tile,
            name, self.name, store, hash_batch=self.hash_batch,
            hash_fn=self.digest_many)
