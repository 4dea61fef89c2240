"""Streaming rolling CDC with bounded memory — a copy of dfs_tpu's
``fragmenter/stream.py``. The stream is processed block by block: a
block's Gear bitmap needs only the 31-entry halo carried from the block
before, and greedy cut selection finalizes a chunk as soon as a candidate
at ``min_size`` or more appears or ``max_size`` bytes are buffered, so the
resident state is at most ``max_size`` plus one block."""

from __future__ import annotations

from typing import Callable, Iterable, Iterator

import numpy as np

from dfs_tpu_torch.config import GEAR_HALO, CDCParams
from dfs_tpu_torch.meta.manifest import ChunkRef, Manifest
from dfs_tpu_torch.utils.hashing import sha256_many_hex, sha256_new

# bitmap_fn(tile_u8, prev_g_u32[31]) -> (bitmap_bool[N], new_prev_g_u32[31])
BitmapFn = Callable[[np.ndarray, np.ndarray], tuple[np.ndarray, np.ndarray]]


class StreamChunker:
    """Incremental cut selection over a candidate-bitmap stream."""

    def __init__(self, params: CDCParams, bitmap_fn: BitmapFn) -> None:
        self.p = params
        self.bitmap_fn = bitmap_fn
        self.prev_g = np.zeros(GEAR_HALO, dtype=np.uint32)
        self.buf = bytearray()      # bytes of [start, processed)
        self.start = 0              # absolute offset of current chunk start
        self.processed = 0          # absolute bytes consumed
        self.cands: list[int] = []  # absolute candidate positions > start
        self._ci = 0                # consumed prefix of self.cands

    def feed(self, data: bytes | np.ndarray) -> Iterator[tuple[int, bytes]]:
        """Consume a block; yield finalized (offset, payload) spans."""
        arr = np.frombuffer(data, dtype=np.uint8) if not isinstance(
            data, np.ndarray) else data
        if arr.shape[0] == 0:
            return
        bitmap, self.prev_g = self.bitmap_fn(arr, self.prev_g)
        base = self.processed
        self.cands.extend((base + np.flatnonzero(bitmap)).tolist())
        self.buf.extend(arr.tobytes())
        self.processed += arr.shape[0]
        yield from self._drain()

    def finish(self) -> Iterator[tuple[int, bytes]]:
        yield from self._drain()
        if self.start < self.processed:
            yield self.start, bytes(self.buf)
            self.start = self.processed
            self.buf.clear()

    def _drain(self) -> Iterator[tuple[int, bytes]]:
        p = self.p
        while True:
            lo = self.start + p.min_size - 1
            hi = self.start + p.max_size - 1
            # skip candidates before the admissible window
            while self._ci < len(self.cands) and self.cands[self._ci] < lo:
                self._ci += 1
            cut = None
            if self._ci < len(self.cands) and self.cands[self._ci] <= hi:
                cut = self.cands[self._ci]          # first candidate wins
            elif hi <= self.processed - 1:
                cut = hi                            # forced cut at max_size
            if cut is None:
                break
            length = cut + 1 - self.start
            yield self.start, bytes(self.buf[:length])
            del self.buf[:length]
            self.start = cut + 1
            if self._ci > 4096:                     # prune consumed prefix
                self.cands = self.cands[self._ci:]
                self._ci = 0


def reblock(blocks: Iterable[bytes], tile: int) -> Iterator[np.ndarray]:
    """Re-slice an arbitrary block stream into exact ``tile``-size arrays
    (the last may be short)."""
    pending = bytearray()
    for b in blocks:
        pending.extend(b)
        while len(pending) >= tile:
            yield np.frombuffer(bytes(pending[:tile]), dtype=np.uint8)
            del pending[:tile]
    if pending:
        yield np.frombuffer(bytes(pending), dtype=np.uint8)


def iter_file_blocks(path, block_size: int = 8 * 1024 * 1024
                     ) -> Iterator[bytes]:
    with open(path, "rb") as f:
        while True:
            b = f.read(block_size)
            if not b:
                return
            yield b


def manifest_from_stream(blocks: Iterable[bytes], params: CDCParams,
                         bitmap_fn: BitmapFn, name: str,
                         fragmenter_name: str,
                         store: Callable[[str, bytes], None] | None = None,
                         hash_batch: int = 256,
                         hash_fn: Callable[[list[bytes]], list[str]]
                         = sha256_many_hex) -> Manifest:
    """One pass over the stream: file_id (sha256 of the whole stream),
    chunk spans and per-chunk digests, each chunk handed to ``store`` when
    given, without materializing the stream."""
    chunker = StreamChunker(params, bitmap_fn)
    whole = sha256_new()
    refs: list[ChunkRef] = []
    pending: list[tuple[int, bytes]] = []
    size = 0

    def flush() -> None:
        digests = hash_fn([b for _, b in pending])
        for (off, payload), dg in zip(pending, digests):
            refs.append(ChunkRef(index=len(refs), offset=off,
                                 length=len(payload), digest=dg))
            if store is not None:
                store(dg, payload)
        pending.clear()

    def consume(spans: Iterator[tuple[int, bytes]]) -> None:
        for off, payload in spans:
            pending.append((off, payload))
            if len(pending) >= hash_batch:
                flush()

    for block in blocks:
        whole.update(block)
        size += len(block)
        consume(chunker.feed(block))
    consume(chunker.finish())
    flush()

    return Manifest(file_id=whole.hexdigest(), name=name, size=size,
                    fragmenter=fragmenter_name, chunks=tuple(refs))
