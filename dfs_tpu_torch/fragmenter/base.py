"""The Fragmenter interface: a strategy that splits a byte stream into
content-addressed chunks. The node calls ``manifest`` / ``manifest_stream``
and gets chunk metadata back; everything downstream (CAS, manifest,
download, dedup) is strategy-agnostic."""

from __future__ import annotations

import abc

from dfs_tpu_torch.meta.manifest import ChunkRef, Manifest
from dfs_tpu_torch.ops.cdc_v2 import file_id_from_digests


class Fragmenter(abc.ABC):
    """Splits a byte stream into content-addressed chunks."""

    name: str = "abstract"

    @abc.abstractmethod
    def chunk(self, data: bytes) -> list[ChunkRef]:
        """The chunk list covering ``data`` exactly, in order, with
        per-chunk sha256 digests."""

    @abc.abstractmethod
    def chunks_stream(self, blocks, store=None):
        """Generator of ChunkRef batches in stream order, yielded as the
        block stream is consumed; ``store(digest, payload)`` is called for
        every chunk."""

    @abc.abstractmethod
    def stream_span(self) -> int | None:
        """Upper bound on how far chunks_stream's reporting can lag the
        bytes it has consumed (None = unbounded)."""

    def manifest(self, data: bytes, name: str,
                 file_id: str | None = None) -> Manifest:
        """The manifest for ``data``. Without ``file_id`` the id is derived
        from the chunk digests, as :meth:`manifest_stream` derives it (a
        node that needs fileId = sha256(body) passes it)."""
        chunks = tuple(self.chunk(data))
        return Manifest(
            file_id=file_id or file_id_from_digests(
                [c.digest for c in chunks]),
            name=name, size=len(data), fragmenter=self.name, chunks=chunks)

    def manifest_stream(self, blocks, name: str, store=None) -> Manifest:
        """Drain :meth:`chunks_stream`: size = last chunk end, file_id
        derived from the digests."""
        chunks: list[ChunkRef] = []
        for batch in self.chunks_stream(blocks, store=store):
            chunks.extend(batch)
        size = chunks[-1].offset + chunks[-1].length if chunks else 0
        return Manifest(
            file_id=file_id_from_digests([c.digest for c in chunks]),
            name=name, size=size, fragmenter=self.name,
            chunks=tuple(chunks))
