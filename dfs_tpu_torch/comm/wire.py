"""Storage-plane wire format, byte for byte dfs_tpu's (``comm/wire.py``,
``docs/wire.md``): a port node and a dfs_tpu node read each other's
frames. A frame is::

    magic   u32  0x44465301  ("DFS\\x01")
    hdr_len u32  big-endian
    body_len u64 big-endian
    header  hdr_len bytes of UTF-8 JSON (op, params, chunk table ...)
    body    body_len raw bytes (chunk data, concatenated)

The header is ``json.dumps(header, separators=(",", ":"))``. Chunk
batches put (digest, length) pairs in the header and concatenate the raw
bytes in the body. Receivers ignore header fields they do not know.

Two optional envelope fields ride any request, as in dfs_tpu:

- ``trace`` — ``{"t": <trace32hex>, "s": <span16hex>, "f": <sender node
  id>}``, the caller's ``rpc.<op>`` span: the receiver's ``peer.<op>``
  span parents to it, which is what stitches one trace across nodes of
  either package (:mod:`dfs_tpu_torch.obs`). Absent or malformed, the
  frame is served like one from an untraced caller.
- ``deadline`` — the sender's remaining end-to-end budget in seconds: a
  port node sends it under a deadline, and drops a frame whose budget ran
  out before its op reaches the CAS.

The ``get_trace`` op (``{"traceId"}`` -> ``{"spans"}``) returns the
receiver's finished spans of one trace for the stitcher. The membership and
diagnosis ops carry dfs_tpu's fields:

- ``get_ring`` ``{}`` -> ``{"ring", "previous", "migrating"}``;
- ``propose_ring`` ``{"ring"}`` -> ``{"epoch", "installed"}``;
- ``get_census`` ``{"prefixes"?}`` -> ``{"census"}``;
- ``get_doctor`` ``{}`` -> ``{"doctor"}``.

A placement-bearing op refused for a ring mismatch answers ``{"ok":
false, "error", "ringEpoch", "ring"}``.

Both directions are zero-copy as in dfs_tpu: a body may be a sequence of
buffers written one by one to the transport (never joined), and the
receive side is an :class:`asyncio.BufferedProtocol` that reads each
frame once into its own buffer and hands out read-only views of it.
"""

from __future__ import annotations

import asyncio
import json
import struct
from typing import Sequence, Union

MAGIC = 0x44465301
_PREFIX = struct.Struct(">IIQ")
PREFIX_LEN = _PREFIX.size
MAX_HEADER = 64 * 1024 * 1024
MAX_BODY = 8 * 1024 * 1024 * 1024

# one payload buffer; a frame body is one of these or a sequence of them
Buffer = Union[bytes, bytearray, memoryview]


class WireError(RuntimeError):
    pass


def as_buffers(body: Buffer | Sequence[Buffer]) -> list[Buffer]:
    if isinstance(body, (bytes, bytearray, memoryview)):
        return [body]
    return list(body)


def buffers_nbytes(body: Buffer | Sequence[Buffer]) -> int:
    if isinstance(body, (bytes, bytearray, memoryview)):
        return len(body)
    return sum(len(b) for b in body)


def encode_frame(header: dict, body: Buffer | Sequence[Buffer] = b""
                 ) -> tuple[bytes, list[Buffer], int]:
    """-> (prefix+header bytes, body buffer list, total frame length)."""
    h = json.dumps(header, separators=(",", ":")).encode()
    bufs = as_buffers(body)
    body_len = sum(len(b) for b in bufs)
    head = _PREFIX.pack(MAGIC, len(h), body_len) + h
    return head, bufs, len(head) + body_len


def frame_size(header: dict, body_len: int) -> int:
    """Exact on-wire size of a frame with this header and body length."""
    h = json.dumps(header, separators=(",", ":")).encode()
    return PREFIX_LEN + len(h) + body_len


def _decode_header(raw: Buffer) -> dict:
    """Parse a frame header; any malformation is a :class:`WireError`."""
    try:
        header = json.loads(bytes(raw))
    except (ValueError, UnicodeDecodeError) as e:
        raise WireError(f"bad frame header: {e}") from e
    if not isinstance(header, dict):
        raise WireError("bad frame header: want a JSON object, got "
                        f"{type(header).__name__}")
    return header


async def send_msg(writer: asyncio.StreamWriter, header: dict,
                   body: Buffer | Sequence[Buffer] = b"") -> int:
    """Write one frame to a stream; returns its on-wire byte count. The
    body's buffers are written one by one (never joined)."""
    head, bufs, total = encode_frame(header, body)
    writer.write(head)
    for b in bufs:
        if len(b):
            writer.write(b)
    await writer.drain()
    return total


async def read_msg(reader: asyncio.StreamReader) -> tuple[dict, bytes]:
    """Read one frame from a stream: ``(header, body)``. A closed stream,
    a bad magic, an oversized frame or a malformed header is a
    :class:`WireError`."""
    try:
        prefix = await reader.readexactly(_PREFIX.size)
    except asyncio.IncompleteReadError as e:
        raise WireError("connection closed mid-frame") from e
    magic, hdr_len, body_len = _PREFIX.unpack(prefix)
    if magic != MAGIC:
        raise WireError(f"bad magic {magic:#x}")
    if hdr_len > MAX_HEADER or body_len > MAX_BODY:
        raise WireError("frame too large")
    try:
        header = _decode_header(await reader.readexactly(hdr_len))
        body = await reader.readexactly(body_len) if body_len else b""
    except asyncio.IncompleteReadError as e:
        raise WireError("connection closed mid-frame") from e
    return header, body


def pack_chunks(chunks: Sequence[tuple[str, Buffer]]
                ) -> tuple[list[dict], list[Buffer]]:
    """[(digest, data)] -> (header chunk table, body buffer list). The
    buffers are the caller's own and must not change until the send
    completes."""
    table = [{"digest": d, "length": len(b)} for d, b in chunks]
    return table, [b for _, b in chunks]


def unpack_chunks(table: list[dict], body: Buffer
                  ) -> list[tuple[str, memoryview]]:
    """Chunk table + body -> [(digest, read-only view of its payload)]."""
    mv = body if isinstance(body, memoryview) else memoryview(body)
    if not mv.readonly:
        mv = mv.toreadonly()
    out: list[tuple[str, memoryview]] = []
    off = 0
    for entry in table:
        try:
            ln = int(entry["length"])
            digest = entry["digest"]
        except (TypeError, ValueError, KeyError) as e:
            raise WireError(f"malformed chunk table entry: {e!r}") from e
        if ln < 0 or off + ln > len(mv):
            raise WireError("chunk table overruns body")
        out.append((digest, mv[off:off + ln]))
        off += ln
    if off != len(mv):
        raise WireError("body has trailing bytes")
    return out


class _FrameReceiver(asyncio.BufferedProtocol):
    """Receive machine shared by both sides: the transport ``recv_into``s
    a 16-byte prefix, then ONE ``bytearray(hdr_len + body_len)`` per frame.
    ``_on_frame(header, body_view, frame_len)`` fires per frame;
    ``_on_broken(exc)`` once when the connection dies. Writes honour
    ``pause_writing`` through ``_drain``."""

    def __init__(self) -> None:
        self._transport: asyncio.Transport | None = None
        self._prefix = bytearray(PREFIX_LEN)
        self._pmv = memoryview(self._prefix)
        self._frame: bytearray | None = None
        self._fmv: memoryview | None = None
        self._hdr_len = 0
        self._got = 0
        self._broken: Exception | None = None
        self._send_paused = False
        self._drain_waiters: list[asyncio.Future] = []

    def connection_made(self, transport) -> None:
        self._transport = transport

    def get_buffer(self, sizehint: int) -> memoryview:
        if self._frame is None:
            return self._pmv[self._got:]
        return self._fmv[self._got:]

    def buffer_updated(self, nbytes: int) -> None:
        if self._broken is not None:
            return
        self._got += nbytes
        if self._frame is None:
            if self._got < PREFIX_LEN:
                return
            magic, hdr_len, body_len = _PREFIX.unpack(self._prefix)
            if magic != MAGIC:
                self._die(WireError(f"bad magic {magic:#x}"))
                return
            if hdr_len > MAX_HEADER or body_len > MAX_BODY:
                # checked before the allocation
                self._die(WireError("frame too large"))
                return
            self._hdr_len = hdr_len
            self._got = 0
            if hdr_len + body_len == 0:
                self._deliver(bytearray())
                return
            self._frame = bytearray(hdr_len + body_len)
            self._fmv = memoryview(self._frame)
            return
        if self._got >= len(self._frame):
            frame, self._frame, self._fmv = self._frame, None, None
            self._got = 0
            self._deliver(frame)

    def _deliver(self, frame: bytearray) -> None:
        fv = memoryview(frame).toreadonly()
        try:
            header = _decode_header(fv[:self._hdr_len])
        except WireError as e:
            self._die(e)
            return
        self._on_frame(header, fv[self._hdr_len:], PREFIX_LEN + len(frame))

    def eof_received(self) -> bool:
        self._fail(WireError("connection closed mid-frame")
                   if (self._frame is not None or self._got)
                   else ConnectionResetError("connection closed"))
        return False

    def connection_lost(self, exc: Exception | None) -> None:
        self._fail(exc if exc is not None
                   else ConnectionResetError("connection lost"))
        self._send_paused = False
        self._wake_drains()

    def pause_writing(self) -> None:
        self._send_paused = True

    def resume_writing(self) -> None:
        self._send_paused = False
        self._wake_drains()

    def _wake_drains(self) -> None:
        for fut in self._drain_waiters:
            if not fut.done():
                fut.set_result(None)
        self._drain_waiters.clear()

    def _die(self, exc: Exception) -> None:
        """Protocol violation: the stream cannot be resynchronized, so
        the connection is dropped at once."""
        self._fail(exc)
        if self._transport is not None:
            self._transport.close()

    def _fail(self, exc: Exception) -> None:
        if self._broken is None:
            self._broken = exc
            self._on_broken(exc)

    def _write_frame(self, header: dict,
                     body: Buffer | Sequence[Buffer] = b"") -> int:
        head, bufs, total = encode_frame(header, body)
        self._write_encoded(head, bufs)
        return total

    def _write_encoded(self, head: bytes, bufs: Sequence[Buffer]) -> None:
        if self._broken is not None:
            raise self._broken
        if self._transport is None or self._transport.is_closing():
            raise ConnectionResetError("connection is closed")
        self._transport.write(head)
        for b in bufs:
            if len(b):
                self._transport.write(b)

    async def _drain(self) -> None:
        if self._broken is not None:
            raise self._broken
        if not self._send_paused:
            return
        fut = asyncio.get_running_loop().create_future()
        self._drain_waiters.append(fut)
        await fut
        if self._broken is not None:
            raise self._broken

    def close(self) -> None:
        if self._transport is not None:
            self._transport.close()

    @property
    def closed(self) -> bool:
        return (self._broken is not None or self._transport is None
                or self._transport.is_closing())

    def _on_frame(self, header: dict, body: memoryview,
                  frame_len: int) -> None:
        raise NotImplementedError

    def _on_broken(self, exc: Exception) -> None:
        raise NotImplementedError


class FrameConnection(_FrameReceiver):
    """Client side: one pooled connection carrying strictly
    request -> reply frames, one request outstanding at a time."""

    def __init__(self) -> None:
        super().__init__()
        self._waiter: asyncio.Future | None = None

    @classmethod
    async def connect(cls, host: str, port: int) -> "FrameConnection":
        _, conn = await asyncio.get_running_loop().create_connection(
            cls, host, port)
        return conn

    async def send(self, header: dict,
                   body: Buffer | Sequence[Buffer] = b"") -> int:
        """Write one request frame (returns its on-wire size)."""
        if self._waiter is not None:
            raise RuntimeError("request already in flight on this "
                               "connection")
        # registered before the drain: the reply may arrive meanwhile
        self._waiter = asyncio.get_running_loop().create_future()
        try:
            n = self._write_frame(header, body)
            await self._drain()
        except BaseException:
            self._waiter = None
            raise
        return n

    async def reply(self) -> tuple[dict, memoryview, int]:
        """-> (header, read-only body view, frame byte count)."""
        fut = self._waiter
        if fut is None:
            raise RuntimeError("no request in flight")
        try:
            return await fut
        finally:
            self._waiter = None

    def send_torn(self, header: dict,
                  body: Buffer | Sequence[Buffer] = b"",
                  keep: float = 0.5) -> None:
        """The chaos seam of torn frames: write only the first ``keep``
        fraction of the whole frame (prefix and header included), then
        close, so the receiver sees a frame cut mid-prefix, mid-header or
        mid-body. At most total-1 bytes go out: a torn frame never
        arrives whole. The connection is unusable afterwards."""
        head, bufs, total = encode_frame(header, body)
        budget = min(max(0, int(total * keep)), total - 1)
        cut: list[Buffer] = []
        for b in [head, *bufs]:
            if budget <= 0:
                break
            take = b[:budget] if len(b) > budget else b
            cut.append(take)
            budget -= len(take)
        self._write_encoded(cut[0] if cut else b"", cut[1:])
        self.close()

    def _on_frame(self, header: dict, body: memoryview,
                  frame_len: int) -> None:
        fut = self._waiter
        if fut is None or fut.done():
            self._die(WireError("unsolicited frame"))
            return
        fut.set_result((header, body, frame_len))

    def _on_broken(self, exc: Exception) -> None:
        fut = self._waiter
        if fut is not None and not fut.done():
            fut.set_exception(exc)


class FrameServerProtocol(_FrameReceiver):
    """Server side: frames are served one at a time per connection —
    reading pauses while a frame is in service. ``handler(conn, header,
    body_view, frame_len)`` is awaited per frame and replies through
    ``conn.send_encoded`` + ``await conn.drain()``; a handler exception
    tears the connection down."""

    def __init__(self, handler, on_connect=None, on_close=None) -> None:
        super().__init__()
        self._handler = handler
        self._on_connect = on_connect
        self._on_close = on_close
        self._task: asyncio.Task | None = None

    def connection_made(self, transport) -> None:
        super().connection_made(transport)
        if self._on_connect is not None:
            self._on_connect(self)

    def _on_frame(self, header: dict, body: memoryview,
                  frame_len: int) -> None:
        self._transport.pause_reading()
        self._task = asyncio.get_running_loop().create_task(
            self._handler(self, header, body, frame_len))
        self._task.add_done_callback(self._served)

    def _served(self, task: asyncio.Task) -> None:
        self._task = None
        if not task.cancelled() and task.exception() is not None:
            self._die(WireError(f"handler failed: {task.exception()!r}"))
            return
        if self._broken is None and self._transport is not None \
                and not self._transport.is_closing():
            self._transport.resume_reading()

    def send_frame(self, header: dict,
                   body: Buffer | Sequence[Buffer] = b"") -> int:
        """Lay out and write one reply frame; returns its byte count."""
        return self._write_frame(header, body)

    def send_encoded(self, head: bytes, bufs: Sequence[Buffer]) -> None:
        self._write_encoded(head, bufs)

    async def drain(self) -> None:
        await self._drain()

    def _on_broken(self, exc: Exception) -> None:
        # an in-service frame is not cancelled: a peer hanging up must not
        # abort a half-applied op
        if self._on_close is not None:
            self._on_close(self)
