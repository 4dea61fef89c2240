"""gRPC over cleartext HTTP/2 (h2c, prior knowledge), both ends, with no
gRPC or HTTP/2 library: the subset of RFC 9113 and of the gRPC HTTP/2
mapping that the sidecar's contract (``docs/sidecar_wire.md``) needs.
grpcio's clients and servers, dfs_tpu's C++ client and this module's own
client all speak it.

Frames: the preface; SETTINGS both ways with the ACK; PING answered with
an ACK; GOAWAY; RST_STREAM; DATA and HEADERS with their PADDED and
PRIORITY flags and CONTINUATION frames on receive; frames no larger than
the peer's ``SETTINGS_MAX_FRAME_SIZE``. Header blocks go through
:mod:`dfs_tpu_torch.sidecar.hpack`; a Huffman-coded string is a
connection error, answered with ``GOAWAY(COMPRESSION_ERROR)`` and a
message naming it.

Flow control, both windows, both directions. On receive, connection-level
credit goes back as soon as a frame is buffered; stream-level credit goes
back as the stream's consumer takes each message (and, while no complete
message waits, for the bytes of the message being assembled, so a message
larger than the window still arrives). A stream's buffered bytes therefore
stay below its window plus one message: a walk that stalls holds its own
client back, and the other streams of the connection keep moving.

gRPC messages: a 1-byte compressed flag and a 4-byte big-endian length,
spanning DATA frames or several to a frame, at most 1 GiB; a compressed
flag is refused with status 13. Statuses ride ``grpc-status`` and
``grpc-message`` trailers, in the Trailers-Only form for an error before
any response. A raising handler answers 2 with grpcio's messages
("Exception calling application: ...", "Exception iterating responses:
..."), an unknown method 12 "Method not found!", an expired
``grpc-timeout`` 4.

:class:`GrpcServer` runs an asyncio loop in a thread of its own: socket
reads, frame dispatch and writes stay on the loop, and each call's
handler runs on a bounded worker pool, fed by its stream's message queue.
A stream reset by the client (RST_STREAM), its deadline or a lost
connection cancels it: its request iterator raises
:class:`StreamCancelled`, the handler's generator is closed, and the next
call on the connection is served.

:class:`ClientCall` is the blocking client of one call on a connection of
its own: a sender thread streams the request under both windows while
the caller's thread reads the response; a non-zero ``grpc-status`` raises
:class:`GrpcError`.
"""

from __future__ import annotations

import asyncio
import collections
import concurrent.futures
import socket
import struct
import threading
import time
import urllib.parse
from typing import Iterable, Iterator

from dfs_tpu_torch.sidecar.hpack import Decoder, Encoder, HpackError
from dfs_tpu_torch.utils.logging import get_logger

PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

# frame types
DATA, HEADERS, PRIORITY, RST_STREAM, SETTINGS = 0x0, 0x1, 0x2, 0x3, 0x4
PUSH_PROMISE, PING, GOAWAY, WINDOW_UPDATE, CONTINUATION = (
    0x5, 0x6, 0x7, 0x8, 0x9)
# flags
END_STREAM = ACK = 0x1
END_HEADERS, PADDED, PRIORITY_FLAG = 0x4, 0x8, 0x20
# settings
S_MAX_CONCURRENT_STREAMS, S_INITIAL_WINDOW_SIZE, S_MAX_FRAME_SIZE = (
    0x3, 0x4, 0x5)
# error codes
NO_ERROR, PROTOCOL_ERROR, FLOW_CONTROL_ERROR = 0x0, 0x1, 0x3
FRAME_SIZE_ERROR, REFUSED_STREAM, CANCEL = 0x6, 0x7, 0x8
COMPRESSION_ERROR = 0x9
# gRPC status codes
OK, CANCELLED, UNKNOWN, DEADLINE_EXCEEDED = 0, 1, 2, 4
RESOURCE_EXHAUSTED, UNIMPLEMENTED, INTERNAL, UNAVAILABLE = 8, 12, 13, 14

DEFAULT_WINDOW = 65535
DEFAULT_MAX_FRAME = 16384
MAX_MESSAGE = 1 << 30           # grpc.max_{send,receive}_message_length
RECV_MAX_FRAME = 1 << 20        # the largest frame this end accepts
STREAM_WINDOW = 1 << 20         # what this end grants each stream
CONN_WINDOW = 16 << 20          # ... and each connection

UNARY_UNARY, STREAM_UNARY, STREAM_STREAM = "unary", "stream_unary", "duplex"

_HDR = struct.Struct(">I")


class GrpcError(RuntimeError):
    """A call that ended with a non-zero ``grpc-status``."""

    def __init__(self, code: int, details: str) -> None:
        super().__init__(f"grpc status {code}: {details}")
        self.code = code
        self.details = details


class StreamCancelled(Exception):
    """The call was reset, timed out or lost its connection."""


class _ConnectionError(Exception):
    def __init__(self, code: int, message: str) -> None:
        super().__init__(message)
        self.code = code


def frame(ftype: int, flags: int, stream: int, payload=b"") -> bytes:
    n = len(payload)
    return (bytes((n >> 16 & 0xFF, n >> 8 & 0xFF, n & 0xFF, ftype, flags))
            + _HDR.pack(stream & 0x7FFFFFFF) + bytes(payload))


def frame_header(n: int, ftype: int, flags: int, stream: int) -> bytes:
    return bytes((n >> 16 & 0xFF, n >> 8 & 0xFF, n & 0xFF, ftype, flags)) \
        + _HDR.pack(stream & 0x7FFFFFFF)


def parse_header(h: bytes) -> tuple[int, int, int, int]:
    """(length, type, flags, stream id) of a 9-byte frame header."""
    return ((h[0] << 16) | (h[1] << 8) | h[2], h[3], h[4],
            _HDR.unpack_from(h, 5)[0] & 0x7FFFFFFF)


def settings_frame(values: dict[int, int]) -> bytes:
    return frame(SETTINGS, 0, 0, b"".join(struct.pack(">HI", k, v)
                                          for k, v in values.items()))


def window_update(stream: int, inc: int) -> bytes:
    return frame(WINDOW_UPDATE, 0, stream, _HDR.pack(inc & 0x7FFFFFFF))


def rst_stream(stream: int, code: int) -> bytes:
    return frame(RST_STREAM, 0, stream, _HDR.pack(code))


def goaway(last_stream: int, code: int, debug: str = "") -> bytes:
    return frame(GOAWAY, 0, 0, _HDR.pack(last_stream) + _HDR.pack(code)
                 + debug.encode())


def headers_frames(stream: int, block: bytes, max_frame: int,
                   end_stream: bool) -> bytes:
    """HEADERS (+ CONTINUATION) frames carrying ``block``."""
    first, rest = block[:max_frame], block[max_frame:]
    flags = (END_STREAM if end_stream else 0) | (0 if rest else END_HEADERS)
    out = [frame(HEADERS, flags, stream, first)]
    while rest:
        part, rest = rest[:max_frame], rest[max_frame:]
        out.append(frame(CONTINUATION, 0 if rest else END_HEADERS, stream,
                         part))
    return b"".join(out)


def strip_padding(ftype: int, flags: int, payload: bytes) -> bytes:
    """The frame's content without its pad length, padding and (HEADERS)
    priority fields."""
    if not flags & PADDED and not (ftype == HEADERS
                                   and flags & PRIORITY_FLAG):
        return payload
    begin, end = 0, len(payload)
    if flags & PADDED:
        if end == 0:
            raise _ConnectionError(PROTOCOL_ERROR, "padded frame without "
                                   "a pad length")
        pad = payload[0]
        begin = 1
        end -= pad
    if ftype == HEADERS and flags & PRIORITY_FLAG:
        begin += 5
    if end < begin:
        raise _ConnectionError(PROTOCOL_ERROR, "padding exceeds the frame")
    return payload[begin:end]


def message_prefix(n: int) -> bytes:
    if n > MAX_MESSAGE:
        raise GrpcError(RESOURCE_EXHAUSTED, f"Sent message larger than max "
                        f"({n} vs. {MAX_MESSAGE})")
    return b"\x00" + _HDR.pack(n)


def encode_timeout(seconds: float) -> str:
    """``grpc-timeout``: at most 8 digits and a unit."""
    ms = max(1, int(seconds * 1000))
    if ms < 10 ** 8:
        return f"{ms}m"
    return f"{min(int(seconds), 10 ** 8 - 1)}S"


def parse_timeout(value: str | None) -> float | None:
    if not value:
        return None
    unit = {"H": 3600.0, "M": 60.0, "S": 1.0, "m": 1e-3, "u": 1e-6,
            "n": 1e-9}.get(value[-1])
    if unit is None or not value[:-1].isdigit():
        return None
    return int(value[:-1]) * unit


def encode_grpc_message(text: str) -> str:
    """Percent-encoding of ``grpc-message`` (bytes outside 0x20-0x7E and
    ``%``), as the gRPC HTTP/2 mapping defines it."""
    return "".join(c if 0x20 <= ord(c) <= 0x7E and c != "%" else
                   "".join(f"%{b:02X}" for b in c.encode())
                   for c in text)


def decode_grpc_message(text: str) -> str:
    return urllib.parse.unquote(text, errors="replace")


class MessageReader:
    """Assembles length-prefixed gRPC messages from DATA payloads."""

    def __init__(self, limit: int = MAX_MESSAGE) -> None:
        self.limit = limit
        self._hdr = bytearray()
        self._body: bytearray | None = None
        self._need = 0

    @property
    def pending(self) -> int:
        """Bytes of the message being assembled."""
        return len(self._hdr) + (len(self._body) if self._body is not None
                                 else 0)

    def feed(self, data) -> list[bytes]:
        out: list[bytes] = []
        mv = memoryview(data)
        pos, n = 0, len(mv)
        while pos < n:
            if self._body is None:
                take = min(5 - len(self._hdr), n - pos)
                self._hdr += mv[pos:pos + take]
                pos += take
                if len(self._hdr) < 5:
                    break
                flag, size = self._hdr[0], _HDR.unpack_from(self._hdr, 1)[0]
                self._hdr.clear()
                if flag:
                    raise GrpcError(INTERNAL, "compressed gRPC messages "
                                    "are not supported (no grpc-encoding "
                                    "was negotiated)")
                if size > self.limit:
                    raise GrpcError(RESOURCE_EXHAUSTED, f"Received message "
                                    f"larger than max ({size} vs. "
                                    f"{self.limit})")
                if size == 0:
                    out.append(b"")
                    continue
                self._body = bytearray()
                self._need = size
            take = min(self._need - len(self._body), n - pos)
            self._body += mv[pos:pos + take]
            pos += take
            if len(self._body) == self._need:
                out.append(bytes(self._body))
                self._body = None
        return out


# ---------------------------------------------------------------------- #
# server
# ---------------------------------------------------------------------- #

class _Stream:
    """One call on the server. ``held``, the windows and the flags other
    than ``cancelled`` belong to the loop thread; the message queue is
    shared with the worker under ``cond``."""

    def __init__(self, conn: "_ServerConn", sid: int, method,
                 send_window: int) -> None:
        self.conn = conn
        self.id = sid
        self.method = method
        self.cond = threading.Condition()
        self.queue: collections.deque[bytes] = collections.deque()
        self.queued_bytes = 0
        self.reader = MessageReader()
        self.ended = False           # the client half-closed
        self.cancelled = False
        self.error: GrpcError | None = None
        self.held = 0                # received, not yet credited
        self.send_window = send_window
        self.headers_sent = False
        self.closed_local = False    # END_STREAM (or RST) sent
        self.timer: asyncio.TimerHandle | None = None

    @property
    def buffered(self) -> int:
        return self.queued_bytes + self.reader.pending

    def push(self, msgs: list[bytes], end: bool = False,
             error: GrpcError | None = None) -> bool:
        """Queue messages (loop thread); True when none waits."""
        with self.cond:
            for m in msgs:
                self.queue.append(m)
                self.queued_bytes += len(m) + 5
            if end:
                self.ended = True
            if error is not None and self.error is None:
                self.error = error
            self.cond.notify_all()
            return not self.queue

    def cancel(self) -> None:
        with self.cond:
            self.cancelled = True
            self.cond.notify_all()

    def messages(self) -> Iterator[bytes]:
        """The request messages, for the worker thread; raises
        StreamCancelled once the call is cancelled."""
        while True:
            with self.cond:
                while not (self.queue or self.ended or self.cancelled
                           or self.error is not None):
                    self.cond.wait()
                if self.cancelled:
                    raise StreamCancelled()
                if self.queue:
                    msg = self.queue.popleft()
                    self.queued_bytes -= len(msg) + 5
                elif self.error is not None:
                    raise self.error
                else:
                    return
            self.conn.call_soon(self.conn.taken, self, len(msg) + 5)
            yield msg


class _ServerConn:
    def __init__(self, server: "GrpcServer", reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter) -> None:
        self.server = server
        self.loop = server._loop
        self.reader = reader
        self.writer = writer
        self.decoder = Decoder()
        self.encoder = Encoder()
        self.streams: dict[int, _Stream] = {}
        self.last_sid = 0
        self.send_window = DEFAULT_WINDOW
        self.peer_initial = DEFAULT_WINDOW
        self.peer_max_frame = DEFAULT_MAX_FRAME
        self.dead = False
        self.refusing = False       # the peer's GOAWAY: no new streams
        self.task: asyncio.Task | None = None
        self._wfut: asyncio.Future = self.loop.create_future()
        self._rbuf = bytearray()
        self._rpos = 0

    # -- plumbing ---------------------------------------------------------

    def call_soon(self, fn, *args) -> None:
        if not self.dead:
            try:
                self.loop.call_soon_threadsafe(fn, *args)
            except RuntimeError:          # the loop is closed
                pass

    def write(self, data) -> None:
        if not self.dead:
            self.writer.write(data)

    def wake(self) -> None:
        """Wake every sender waiting for window."""
        if not self._wfut.done():
            self._wfut.set_result(None)
        self._wfut = self.loop.create_future()

    def _forget(self, st: _Stream) -> None:
        if st.closed_local and (st.ended or st.cancelled):
            self.streams.pop(st.id, None)

    # -- frame loop -------------------------------------------------------

    async def _read(self, n: int) -> bytes:
        """The next ``n`` bytes. Reads go through a buffer of this
        connection's (StreamReader.readexactly moves its whole buffer on
        every call, which costs more than the frames at large windows)."""
        buf = self._rbuf
        while len(buf) - self._rpos < n:
            if self._rpos:
                del buf[:self._rpos]          # only a partial frame moves
                self._rpos = 0
            chunk = await self.reader.read(2 * RECV_MAX_FRAME)
            if not chunk:
                raise asyncio.IncompleteReadError(b"", n)
            buf += chunk
        out = bytes(buf[self._rpos:self._rpos + n])
        self._rpos += n
        return out

    async def serve(self) -> None:
        try:
            if await self._read(len(PREFACE)) != PREFACE:
                return
            self.write(settings_frame({
                S_MAX_CONCURRENT_STREAMS: 100,
                S_INITIAL_WINDOW_SIZE: STREAM_WINDOW,
                S_MAX_FRAME_SIZE: RECV_MAX_FRAME}))
            self.write(window_update(0, CONN_WINDOW - DEFAULT_WINDOW))
            block: bytearray | None = None     # an unfinished header block
            block_sid = block_flags = 0
            while True:
                length, ftype, flags, sid = parse_header(
                    await self._read(9))
                if length > RECV_MAX_FRAME:
                    raise _ConnectionError(FRAME_SIZE_ERROR,
                                           f"frame of {length} bytes")
                payload = await self._read(length) if length else b""
                if block is not None:
                    if ftype != CONTINUATION or sid != block_sid:
                        raise _ConnectionError(PROTOCOL_ERROR, "expected "
                                               "CONTINUATION")
                    block += payload
                    if flags & END_HEADERS:
                        self.on_headers(block_sid, block_flags, bytes(block))
                        block = None
                    continue
                if ftype == DATA:
                    self.on_data(sid, flags, payload)
                elif ftype == HEADERS:
                    content = strip_padding(ftype, flags, payload)
                    if flags & END_HEADERS:
                        self.on_headers(sid, flags, content)
                    else:
                        block, block_sid, block_flags = (
                            bytearray(content), sid, flags)
                elif ftype == SETTINGS:
                    if not flags & ACK:
                        self.on_settings(payload)
                elif ftype == PING:
                    if not flags & ACK:
                        self.write(frame(PING, ACK, 0, payload))
                elif ftype == WINDOW_UPDATE:
                    self.on_window_update(sid, payload)
                elif ftype == RST_STREAM:
                    st = self.streams.pop(sid, None)
                    if st is not None:
                        st.closed_local = True
                        st.cancel()
                        if st.timer is not None:
                            st.timer.cancel()
                        self.wake()
                elif ftype == GOAWAY:
                    self.refusing = True
                elif ftype == CONTINUATION:
                    raise _ConnectionError(PROTOCOL_ERROR,
                                           "CONTINUATION without HEADERS")
                # PRIORITY, PUSH_PROMISE, unknown types: ignored
                if self.writer.transport.get_write_buffer_size() > 1 << 20:
                    await self.writer.drain()
        except _ConnectionError as e:
            self._goaway(e.code, str(e))
        except HpackError as e:
            self._goaway(COMPRESSION_ERROR, f"HPACK: {e}")
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        finally:
            self.close()

    def _goaway(self, code: int, message: str) -> None:
        self.server.log.warning("sidecar connection error %d: %s", code,
                                message)
        self.write(goaway(self.last_sid, code, message))

    def close(self) -> None:
        if self.dead:
            return
        self.dead = True
        for st in list(self.streams.values()):
            st.cancel()
            if st.timer is not None:
                st.timer.cancel()
        self.streams.clear()
        if not self._wfut.done():
            self._wfut.set_result(None)
        self.writer.close()
        self.server._conns.discard(self)

    # -- frame handlers (loop thread) --------------------------------------

    def on_settings(self, payload: bytes) -> None:
        if len(payload) % 6:
            raise _ConnectionError(FRAME_SIZE_ERROR, "SETTINGS length")
        for off in range(0, len(payload), 6):
            key, value = struct.unpack_from(">HI", payload, off)
            if key == S_INITIAL_WINDOW_SIZE:
                if value > 0x7FFFFFFF:
                    raise _ConnectionError(FLOW_CONTROL_ERROR,
                                           "initial window too large")
                delta = value - self.peer_initial
                self.peer_initial = value
                for st in self.streams.values():
                    st.send_window += delta
            elif key == S_MAX_FRAME_SIZE:
                if not DEFAULT_MAX_FRAME <= value <= 0xFFFFFF:
                    raise _ConnectionError(PROTOCOL_ERROR,
                                           "bad SETTINGS_MAX_FRAME_SIZE")
                self.peer_max_frame = value
            # HEADER_TABLE_SIZE: this encoder never indexes; others: no-op
        self.write(frame(SETTINGS, ACK, 0))
        self.wake()

    def on_window_update(self, sid: int, payload: bytes) -> None:
        if len(payload) != 4:
            raise _ConnectionError(FRAME_SIZE_ERROR, "WINDOW_UPDATE length")
        inc = _HDR.unpack(payload)[0] & 0x7FFFFFFF
        if sid == 0:
            self.send_window += inc
        elif sid in self.streams:
            self.streams[sid].send_window += inc
        self.wake()

    def on_headers(self, sid: int, flags: int, block: bytes) -> None:
        headers = self.decoder.decode(block)   # always: the table is shared
        st = self.streams.get(sid)
        if st is not None:                       # request trailers
            if flags & END_STREAM:
                st.push([], end=True)
                self._forget(st)
            return
        if sid % 2 == 0 or sid <= self.last_sid:
            raise _ConnectionError(PROTOCOL_ERROR, f"bad stream id {sid}")
        self.last_sid = sid
        if self.refusing or self.server._closing:
            self.write(rst_stream(sid, REFUSED_STREAM))
            return
        h = dict(headers)
        method = self.server.methods.get(h.get(":path", ""))
        st = _Stream(self, sid, method, self.peer_initial)
        self.streams[sid] = st
        if flags & END_STREAM:
            st.ended = True
        if method is None:
            self.trailers(st, UNIMPLEMENTED, "Method not found!")
            return
        timeout = parse_timeout(h.get("grpc-timeout"))
        if timeout is not None:
            st.timer = self.loop.call_later(timeout, self.expire, st)
        self.server._submit(st)

    def on_data(self, sid: int, flags: int, payload: bytes) -> None:
        if payload:              # connection credit: as soon as buffered
            self.write(window_update(0, len(payload)))
        st = self.streams.get(sid)
        if st is None:
            return
        data = strip_padding(DATA, flags, payload)
        end = bool(flags & END_STREAM)
        if st.closed_local or st.cancelled:
            # the answer is out: let the sender finish unhindered
            if payload and not end:
                self.write(window_update(sid, len(payload)))
            if end:
                st.ended = True
                self._forget(st)
            return
        if len(payload) > len(data):                 # padding
            self.write(window_update(sid, len(payload) - len(data)))
        st.held += len(data)
        try:
            msgs = st.reader.feed(data)
            err = None
        except GrpcError as e:
            msgs, err = [], e
        idle = st.push(msgs, end=end, error=err)
        self.server._note_buffered(st.buffered)
        if idle and st.held and not end:
            # nothing waits for the consumer: the bytes belong to the
            # message being assembled
            self.write(window_update(sid, st.held))
            st.held = 0

    def taken(self, st: _Stream, n: int) -> None:
        """The worker took an ``n``-byte message: credit the stream."""
        if st.closed_local or st.cancelled or st.ended or self.dead:
            return
        with st.cond:
            idle = not st.queue
        credit = st.held if idle else min(st.held, n)
        if credit:
            st.held -= credit
            self.write(window_update(st.id, credit))

    def expire(self, st: _Stream) -> None:
        if not st.closed_local:
            self.trailers(st, DEADLINE_EXCEEDED, "Deadline Exceeded")
        st.cancel()
        self._forget(st)
        self.wake()

    # -- responses ----------------------------------------------------------

    def _response_headers(self, st: _Stream) -> None:
        if not st.headers_sent:
            st.headers_sent = True
            self.write(headers_frames(st.id, self.encoder.encode([
                (":status", "200"), ("content-type", "application/grpc")]),
                self.peer_max_frame, False))

    def trailers(self, st: _Stream, code: int, message: str) -> None:
        if st.closed_local or self.dead:
            return
        fields = [("grpc-status", str(code)),
                  ("grpc-message", encode_grpc_message(message))]
        if not st.headers_sent:                  # Trailers-Only
            st.headers_sent = True
            fields = [(":status", "200"),
                      ("content-type", "application/grpc")] + fields
        self.write(headers_frames(st.id, self.encoder.encode(fields),
                                  self.peer_max_frame, True))
        st.closed_local = True
        if st.timer is not None:
            st.timer.cancel()
        if not st.ended and st.held:
            self.write(window_update(st.id, st.held))
            st.held = 0
        self._forget(st)

    async def send_message(self, st: _Stream, payload: bytes) -> None:
        if st.cancelled or st.closed_local or self.dead:
            raise StreamCancelled()
        self._response_headers(st)
        for buf in (message_prefix(len(payload)), payload):
            mv = memoryview(buf)
            pos = 0
            while pos < len(mv):
                n = min(len(mv) - pos, self.peer_max_frame, self.send_window,
                        st.send_window)
                if n <= 0:
                    await asyncio.shield(self._wfut)
                    if st.cancelled or st.closed_local or self.dead:
                        raise StreamCancelled()
                    continue
                self.write(frame_header(n, DATA, 0, st.id))
                self.write(mv[pos:pos + n])
                self.send_window -= n
                st.send_window -= n
                pos += n
        await self.writer.drain()


class GrpcServer:
    """gRPC server over h2c. ``methods`` maps ``/service/Method`` to
    ``(kind, handler)``: ``UNARY_UNARY`` handler(bytes) -> bytes,
    ``STREAM_UNARY`` handler(iterator of bytes) -> bytes,
    ``STREAM_STREAM`` handler(iterator of bytes) -> iterator of bytes.
    Requests and responses are raw bytes (identity serialization)."""

    def __init__(self, methods: dict, port: int = 0,
                 host: str = "127.0.0.1", max_workers: int = 4) -> None:
        self.methods = dict(methods)
        self.log = get_logger("sidecar")
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="sidecar-call")
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._loop.run_forever,
                                        name="sidecar-h2", daemon=True)
        self._conns: set[_ServerConn] = set()
        self._closing = False
        self._started = False
        self._stopped = False
        self.peak_buffered = 0      # largest buffered bytes of one stream
        # bind now, as grpcio's add_insecure_port does: the port is known
        # before start()
        self._sock = socket.create_server((host, port), reuse_port=False)
        self.port = self._sock.getsockname()[1]
        self._server: asyncio.base_events.Server | None = None

    def start(self) -> None:
        self._thread.start()
        self._started = True

        async def listen():
            self._server = await asyncio.start_server(
                self._on_conn, sock=self._sock, limit=2 * RECV_MAX_FRAME)

        asyncio.run_coroutine_threadsafe(listen(), self._loop).result(30)

    async def _on_conn(self, reader, writer) -> None:
        sock = writer.get_extra_info("socket")
        if sock is not None:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn = _ServerConn(self, reader, writer)
        conn.task = asyncio.current_task()
        self._conns.add(conn)
        await conn.serve()

    def _note_buffered(self, n: int) -> None:
        if n > self.peak_buffered:
            self.peak_buffered = n

    def buffered(self) -> list[int]:
        """Bytes each open stream holds (messages queued for its handler
        and the one being assembled)."""
        async def get():
            return [st.buffered for c in self._conns
                    for st in c.streams.values()]

        return asyncio.run_coroutine_threadsafe(get(), self._loop).result(10)

    def _submit(self, st: _Stream) -> None:
        self._pool.submit(self._run, st)

    # -- the worker -------------------------------------------------------

    def _send(self, st: _Stream, payload: bytes) -> None:
        fut = asyncio.run_coroutine_threadsafe(
            st.conn.send_message(st, payload), self._loop)
        while True:
            try:
                return fut.result(timeout=0.5)
            except concurrent.futures.TimeoutError:
                if st.cancelled or self._stopped:
                    fut.cancel()
                    raise StreamCancelled() from None

    def _finish(self, st: _Stream, code: int, message: str) -> None:
        st.conn.call_soon(st.conn.trailers, st, code, message)

    def _run(self, st: _Stream) -> None:
        kind, fn = st.method
        gen = None
        try:
            if st.cancelled:
                return
            if kind == STREAM_STREAM:
                gen = fn(st.messages())
                while True:
                    try:
                        msg = next(gen)
                    except StopIteration:
                        break
                    except (StreamCancelled, GrpcError):
                        raise
                    except Exception as e:  # noqa: BLE001 - status 2
                        raise GrpcError(UNKNOWN, f"Exception iterating "
                                        f"responses: {e}") from e
                    self._send(st, msg)
            else:
                if kind == UNARY_UNARY:
                    msgs = list(st.messages())
                    if len(msgs) != 1:
                        raise GrpcError(INTERNAL, f"a unary call carries "
                                        f"one request, not {len(msgs)}")
                    arg = msgs[0]
                else:
                    arg = st.messages()
                try:
                    resp = fn(arg)
                except (StreamCancelled, GrpcError):
                    raise
                except Exception as e:  # noqa: BLE001 - status 2
                    raise GrpcError(UNKNOWN, f"Exception calling "
                                    f"application: {e}") from e
                self._send(st, resp)
            self._finish(st, OK, "")
        except StreamCancelled:
            pass
        except GrpcError as e:
            if e.code == UNKNOWN:
                self.log.warning("sidecar call %s failed: %s",
                                 st.id, e.details)
            self._finish(st, e.code, e.details)
        except Exception as e:  # noqa: BLE001 - a lost connection
            self.log.warning("sidecar call %s aborted: %s", st.id, e)
            st.cancel()
        finally:
            if gen is not None:
                gen.close()

    # -- shutdown -----------------------------------------------------------

    def stop(self, grace: float = 0.5) -> None:
        """Refuse new calls, give running ones ``grace`` seconds, then
        cancel the rest and close every connection."""
        if self._stopped:
            return
        if not self._started:
            self._sock.close()
            self._stopped = True
            self._pool.shutdown(wait=False)
            return

        async def shutdown():
            self._closing = True
            if self._server is not None:
                self._server.close()
            for c in list(self._conns):
                c.write(goaway(c.last_sid, NO_ERROR))
            end = time.monotonic() + grace
            while time.monotonic() < end and any(
                    c.streams for c in self._conns):
                await asyncio.sleep(0.02)
            tasks = [c.task for c in self._conns if c.task is not None]
            for c in list(self._conns):
                c.close()
            if tasks:
                await asyncio.wait(tasks, timeout=5)

        try:
            asyncio.run_coroutine_threadsafe(shutdown(), self._loop).result(
                grace + 30)
        finally:
            self._stopped = True
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._thread.join(30)
            self._pool.shutdown(wait=False, cancel_futures=True)
            if not self._thread.is_alive():
                self._loop.close()


# ---------------------------------------------------------------------- #
# client
# ---------------------------------------------------------------------- #

class ClientCall:
    """One call on a connection of its own: ``responses()`` yields the
    response messages while a sender thread streams ``requests`` under
    both flow-control windows; the trailers' non-zero ``grpc-status``
    raises :class:`GrpcError` after the last message, a deadline raises
    it with status 4. Leaving ``responses()`` early resets the stream
    (RST_STREAM CANCEL) and closes the connection."""

    def __init__(self, host: str, port: int, path: str,
                 requests: Iterable[bytes], timeout_s: float) -> None:
        self.deadline = time.monotonic() + timeout_s
        try:
            self.sock = socket.create_connection(
                (host, port), timeout=min(timeout_s, 30.0))
        except OSError as e:
            raise GrpcError(UNAVAILABLE, f"failed to connect to "
                            f"{host}:{port}: {e}") from None
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.rfile = self.sock.makefile("rb", buffering=1 << 20)
        self.wlock = threading.Lock()
        self.cond = threading.Condition()
        self.conn_window = DEFAULT_WINDOW
        self.stream_window = DEFAULT_WINDOW
        self.peer_initial = DEFAULT_WINDOW
        self.peer_max_frame = DEFAULT_MAX_FRAME
        self.decoder = Decoder()
        self.reader = MessageReader()
        self.closed = False
        self.done = False            # END_STREAM from the server
        self.send_error: BaseException | None = None
        self.headers: dict[str, str] | None = None
        self.trailers: dict[str, str] = {}
        self._write(PREFACE + settings_frame({
            S_INITIAL_WINDOW_SIZE: CONN_WINDOW,
            S_MAX_FRAME_SIZE: RECV_MAX_FRAME})
            + window_update(0, CONN_WINDOW - DEFAULT_WINDOW)
            + headers_frames(1, Encoder().encode([
                (":method", "POST"), (":scheme", "http"), (":path", path),
                (":authority", f"{host}:{port}"),
                ("content-type", "application/grpc"), ("te", "trailers"),
                ("grpc-timeout", encode_timeout(timeout_s))]),
                DEFAULT_MAX_FRAME, False))
        self._sender = threading.Thread(target=self._send_all,
                                        args=(requests,), daemon=True,
                                        name="sidecar-client-send")
        self._sender.start()

    # -- sending (the sender thread) ----------------------------------------

    def _write(self, data) -> None:
        with self.wlock:
            self.sock.sendall(data)

    def _send_all(self, requests: Iterable[bytes]) -> None:
        try:
            for msg in requests:
                if self.closed:
                    return
                self._send_data((message_prefix(len(msg)), msg))
            if not self.closed:
                self._write(frame(DATA, END_STREAM, 1))
        except BaseException as e:  # noqa: BLE001 - re-raised by the reader
            if not self.closed:
                self.send_error = e
                self._abort()

    def _send_data(self, bufs) -> None:
        for buf in bufs:
            mv = memoryview(buf).cast("B")
            pos = 0
            while pos < len(mv):
                with self.cond:
                    while True:
                        if self.closed:
                            raise StreamCancelled()
                        n = min(len(mv) - pos, self.peer_max_frame,
                                self.conn_window, self.stream_window)
                        if n > 0:
                            break
                        left = self.deadline - time.monotonic()
                        if left <= 0:
                            raise GrpcError(DEADLINE_EXCEEDED,
                                            "Deadline Exceeded")
                        self.cond.wait(min(left, 1.0))
                    self.conn_window -= n
                    self.stream_window -= n
                with self.wlock:
                    self.sock.sendall(frame_header(n, DATA, 0, 1))
                    self.sock.sendall(mv[pos:pos + n])
                pos += n

    def _abort(self) -> None:
        """Reset the stream and close the connection (any thread)."""
        with self.cond:
            if self.closed:
                return
            self.closed = True
            self.cond.notify_all()
        try:
            if not self.done:
                self._write(rst_stream(1, CANCEL))
        except OSError:
            pass
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.rfile.close()
        self.sock.close()

    # -- receiving (the caller's thread) ------------------------------------

    def _read(self, n: int) -> bytes:
        left = self.deadline - time.monotonic()
        if left <= 0:
            raise GrpcError(DEADLINE_EXCEEDED, "Deadline Exceeded")
        self.sock.settimeout(left)
        try:
            data = self.rfile.read(n)
        except socket.timeout:
            raise GrpcError(DEADLINE_EXCEEDED, "Deadline Exceeded") \
                from None
        except (OSError, ValueError) as e:
            if self.send_error is not None:
                raise self.send_error from None
            raise GrpcError(UNAVAILABLE, f"connection lost: {e}") from None
        if len(data) < n:
            if self.send_error is not None:
                raise self.send_error
            raise GrpcError(UNAVAILABLE, "connection closed by the server")
        return data

    def _read_frame(self, out: collections.deque) -> None:
        length, ftype, flags, sid = parse_header(self._read(9))
        payload = self._read(length) if length else b""
        if ftype == DATA:
            if length:
                self._write(window_update(0, length)
                            + (window_update(1, length)
                               if sid == 1 and not flags & END_STREAM
                               else b""))
            if sid != 1:
                return
            out.extend(self.reader.feed(strip_padding(DATA, flags,
                                                      payload)))
            if flags & END_STREAM:
                self.done = True
        elif ftype == HEADERS:
            block = strip_padding(HEADERS, flags, payload)
            end = flags
            while not end & END_HEADERS:
                length, ftype, end, sid2 = parse_header(self._read(9))
                if ftype != CONTINUATION or sid2 != sid:
                    raise GrpcError(INTERNAL, "expected CONTINUATION")
                block += self._read(length)
            fields = dict(self.decoder.decode(block))
            if sid != 1:
                return
            if self.headers is None:
                self.headers = fields
                if fields.get(":status") != "200":
                    raise GrpcError(UNKNOWN, f"HTTP status "
                                    f"{fields.get(':status')}")
            if flags & END_STREAM:
                self.trailers = fields
                self.done = True
        elif ftype == SETTINGS:
            if not flags & ACK:
                # the ACK first: a peer applies its new limits (a larger
                # frame size) only once acknowledged, so no frame sent
                # under them may precede the ACK
                self._write(frame(SETTINGS, ACK, 0))
                with self.cond:
                    for off in range(0, len(payload) - 5, 6):
                        key, value = struct.unpack_from(">HI", payload, off)
                        if key == S_INITIAL_WINDOW_SIZE:
                            self.stream_window += value - self.peer_initial
                            self.peer_initial = value
                        elif key == S_MAX_FRAME_SIZE:
                            self.peer_max_frame = value
                    self.cond.notify_all()
        elif ftype == WINDOW_UPDATE:
            inc = _HDR.unpack(payload)[0] & 0x7FFFFFFF
            with self.cond:
                if sid == 0:
                    self.conn_window += inc
                elif sid == 1:
                    self.stream_window += inc
                self.cond.notify_all()
        elif ftype == PING:
            if not flags & ACK:
                self._write(frame(PING, ACK, 0, payload))
        elif ftype == RST_STREAM and sid == 1:
            code = _HDR.unpack(payload)[0]
            if self.send_error is not None:
                raise self.send_error
            raise GrpcError({CANCEL: CANCELLED, REFUSED_STREAM: UNAVAILABLE}
                            .get(code, INTERNAL),
                            f"stream reset by the server (error code "
                            f"{code})")
        elif ftype == GOAWAY:
            last = _HDR.unpack_from(payload, 0)[0] & 0x7FFFFFFF
            code = _HDR.unpack_from(payload, 4)[0]
            if last < 1 or code != NO_ERROR:
                raise GrpcError(UNAVAILABLE, f"GOAWAY (error code {code}): "
                                f"{payload[8:].decode(errors='replace')}")

    def responses(self) -> Iterator[bytes]:
        out: collections.deque[bytes] = collections.deque()
        try:
            while True:
                while out:
                    yield out.popleft()
                if self.done:
                    break
                self._read_frame(out)
            status = self.trailers.get("grpc-status")
            if status is None:
                raise GrpcError(INTERNAL, "the call ended without a "
                                "grpc-status")
            if status != "0":
                raise GrpcError(int(status), decode_grpc_message(
                    self.trailers.get("grpc-message", "")))
            if self.send_error is not None:
                raise self.send_error
        finally:
            self._abort()
            self._sender.join(timeout=5)


def call(host: str, port: int, path: str, requests: Iterable[bytes],
         timeout_s: float) -> Iterator[bytes]:
    """The response messages of one call (module docstring)."""
    return ClientCall(host, port, path, requests, timeout_s).responses()


def unary(host: str, port: int, path: str, requests: Iterable[bytes],
          timeout_s: float) -> bytes:
    """The single response message of a unary-response call."""
    msgs = list(call(host, port, path, requests, timeout_s))
    if len(msgs) != 1:
        raise GrpcError(INTERNAL, f"expected one response, got {len(msgs)}")
    return msgs[0]

