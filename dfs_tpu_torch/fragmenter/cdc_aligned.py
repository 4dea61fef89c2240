"""Aligned-CDC fragmenters (v2) — dfs_tpu's ``fragmenter/cdc_aligned.py``.

Cuts land on 64-byte block boundaries decided by a windowed Gear hash,
strips of 128 KiB chunk independently, and the candidates -> selection ->
SHA-256 pipeline runs in one device dispatch per segment
(``ops.cdc_pipeline``: kernels 3 and 1, then the plain compaction), with
only metadata returning to the host. The 64-byte grid is anchored to
absolute stream offsets, so an insertion that is not a multiple of 64
bytes shifts everything after it off the grid: the strategy for
append/overwrite workloads; the anchored strategy realigns the grid.

- :class:`AlignedCpuFragmenter` (``cdc-aligned``) — the NumPy oracle
  (``ops.cdc_v2.chunk_file_np``).
- :class:`AlignedCudaFragmenter` (``cdc-aligned-cuda``; dfs_tpu's
  ``cdc-aligned-tpu``) — the device pipeline on ``device`` (None: the
  card, raising without one; "cpu": the plain versions), big files looped
  over fixed-shape segments.

File ids are ``sha256(digest_0 || digest_1 || ...)`` over the raw chunk
digests (``ops.cdc_v2.file_id_from_digests``), as in dfs_tpu. Neither
engine is resume-describable.
"""

from __future__ import annotations

from collections.abc import Iterable, Iterator

import numpy as np

from dfs_tpu_torch import resolve_device
from dfs_tpu_torch.fragmenter.base import Fragmenter
from dfs_tpu_torch.meta.manifest import ChunkRef, Manifest
from dfs_tpu_torch.ops.cdc_v2 import (AlignedCdcParams, chunk_file_np,
                                      file_id_from_digests)

# strips per segment (the dispatch unit) and the small-segment threshold
# below which the NumPy oracle chunks on the host, as in dfs_tpu
_SEG_STRIPS = 512            # 64 MiB segments with default 128 KiB strips
_CPU_CUTOFF = 4 * 1024 * 1024


def _to_u8(data) -> np.ndarray:
    if isinstance(data, np.ndarray):
        return data
    return np.frombuffer(data, dtype=np.uint8)


def _refs(spans: list[tuple[int, int, str]], base: int,
          start_index: int) -> list[ChunkRef]:
    return [ChunkRef(index=start_index + i, offset=base + o, length=ln,
                     digest=dg) for i, (o, ln, dg) in enumerate(spans)]


class _AlignedBase(Fragmenter):
    """Segment streaming and the fileId from the chunk-digest chain."""

    seg_strips: int = _SEG_STRIPS

    def __init__(self, params: AlignedCdcParams | None = None) -> None:
        self.params = params or AlignedCdcParams()

    def stream_span(self) -> int | None:
        # one segment is buffered before its chunks are reported
        return self.seg_strips * self.params.strip_len

    def _segments(self, blocks: Iterable[bytes]) -> Iterator[np.ndarray]:
        """Re-block a byte-block stream into segment-sized u8 arrays (whole
        strips each, except the final one)."""
        seg_bytes = self.seg_strips * self.params.strip_len
        buf = bytearray()
        for b in blocks:
            buf += b
            while len(buf) >= seg_bytes:
                yield np.frombuffer(bytes(buf[:seg_bytes]), dtype=np.uint8)
                del buf[:seg_bytes]
        if buf:
            yield np.frombuffer(bytes(buf), dtype=np.uint8)

    def _chunk_segment(self, seg: np.ndarray) -> list[tuple[int, int, str]]:
        raise NotImplementedError

    def chunk(self, data: bytes) -> list[ChunkRef]:
        arr = _to_u8(data)
        seg_bytes = self.seg_strips * self.params.strip_len
        out: list[ChunkRef] = []
        for base in range(0, int(arr.shape[0]), seg_bytes):
            out.extend(_refs(self._chunk_segment(arr[base:base + seg_bytes]),
                             base, len(out)))
        return out

    def chunks_stream(self, blocks, store=None):
        """One batch per segment; segments chunk independently, so the
        table equals :meth:`chunk`'s for any blocking."""
        base = idx = 0
        for seg in self._segments(blocks):
            spans = self._chunk_segment(seg)
            if store is not None:
                for o, ln, dg in spans:
                    store(dg, seg[o:o + ln].tobytes())
            if spans:
                yield _refs(spans, base, idx)
            idx += len(spans)
            base += int(seg.shape[0])

    def manifest_stream(self, blocks, name: str, store=None) -> Manifest:
        chunks = [c for b in self.chunks_stream(blocks, store=store)
                  for c in b]
        size = chunks[-1].offset + chunks[-1].length if chunks else 0
        return Manifest(
            file_id=file_id_from_digests([c.digest for c in chunks]),
            name=name, size=size, fragmenter=self.name, chunks=tuple(chunks))


class AlignedCpuFragmenter(_AlignedBase):
    """The NumPy aligned CDC oracle."""

    name = "cdc-aligned"

    def _chunk_segment(self, seg: np.ndarray) -> list[tuple[int, int, str]]:
        return chunk_file_np(seg, self.params)


class AlignedCudaFragmenter(_AlignedBase):
    """The device pipeline (``ops.cdc_pipeline``), segment-looped; segments
    of ``cpu_cutoff`` bytes or fewer take the NumPy oracle, as in dfs_tpu."""

    name = "cdc-aligned-cuda"

    def __init__(self, params: AlignedCdcParams | None = None,
                 seg_strips: int = _SEG_STRIPS,
                 cpu_cutoff: int = _CPU_CUTOFF,
                 lane_multiple: int = 128, device=None) -> None:
        super().__init__(params)
        self.device = resolve_device(device)
        self.seg_strips = int(seg_strips)
        self.cpu_cutoff = int(cpu_cutoff)
        self.lane_multiple = int(lane_multiple)

    def _chunk_segment(self, seg: np.ndarray) -> list[tuple[int, int, str]]:
        if seg.shape[0] <= self.cpu_cutoff:
            return chunk_file_np(seg, self.params)
        from dfs_tpu_torch.ops.cdc_pipeline import segment_chunks

        return segment_chunks(seg, self.params,
                              lane_multiple=self.lane_multiple,
                              device=self.device)
