"""The stream-based wire surface of the port against dfs_tpu's on the CPU:
``send_msg`` / ``read_msg`` / ``frame_size`` (frames cross both ways, byte
for byte, with a body given as a list of buffers), the malformed frames of
``tests/test_wire.py``'s ``read_msg`` fuzz (each a ``WireError`` from the
port's reader), ``FrameServerProtocol.send_frame``, ``NodeClient.scrub``
against an in-process port node, and the config properties
``PeerAddr.http_base`` / ``ClusterConfig.n_nodes``. Every await sits under
``asyncio.wait_for``: no case can wait for ever."""

import asyncio
import struct

import pytest

from dfs_tpu.cli.client import NodeClient as RefNodeClient
from dfs_tpu.comm import read_msg as ref_read_msg
from dfs_tpu.comm import send_msg as ref_send_msg
from dfs_tpu.comm import wire as ref_wire
from dfs_tpu.config import ClusterConfig as RefClusterConfig
from dfs_tpu.config import PeerAddr as RefPeerAddr

from dfs_tpu_torch.cli.client import NodeClient
from dfs_tpu_torch.comm import read_msg, send_msg
from dfs_tpu_torch.comm import wire
from dfs_tpu_torch.config import ClusterConfig, PeerAddr

from test_torch_cluster import make_cluster, start_nodes, stop_nodes

LIMIT_S = 10.0
_PREFIX = struct.Struct(">IIQ")
HEADERS = [{"op": "health"},
           {"op": "store_chunks", "fileId": "f" * 64,
            "chunks": [{"digest": "a" * 64, "length": 3},
                       {"digest": "b" * 64, "length": 0}],
            "trace": {"t": "1" * 32, "s": "2" * 16, "f": 3}},
           {"op": "get_trace", "traceId": "é ünïcode", "deadline": 0.25}]
BODIES = [b"", [b"abc", bytearray(b""), memoryview(b"defgh")],
          [bytes(range(256)) * 17, b"\x00"]]


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, timeout=3 * LIMIT_S))


class _Sink:
    """A StreamWriter stand-in that keeps every write, in order."""

    def __init__(self) -> None:
        self.parts: list[bytes] = []

    def write(self, b) -> None:
        self.parts.append(bytes(b))

    async def drain(self) -> None:
        return None

    def data(self) -> bytes:
        return b"".join(self.parts)


def _reader(raw: bytes) -> asyncio.StreamReader:
    r = asyncio.StreamReader()
    r.feed_data(raw)
    r.feed_eof()
    return r


@pytest.mark.parametrize("case", range(len(HEADERS)))
def test_send_msg_frames_are_byte_identical_and_cross_both_ways(case):
    header, body = HEADERS[case], BODIES[case]

    async def go():
        ours, ref = _Sink(), _Sink()
        n_ours = await asyncio.wait_for(send_msg(ours, header, body),
                                        LIMIT_S)
        n_ref = await asyncio.wait_for(ref_send_msg(ref, header, body),
                                       LIMIT_S)
        assert ours.data() == ref.data() and n_ours == n_ref \
            == len(ours.data())
        # buffers written one by one: no empty write, never joined
        assert ours.parts == ref.parts
        joined = b"".join(bytes(b) for b in wire.as_buffers(body))
        for write, read in ((ours, ref_read_msg), (ref, read_msg)):
            h, b = await asyncio.wait_for(read(_reader(write.data())),
                                          LIMIT_S)
            assert h == header and bytes(b) == joined
        assert wire.frame_size(header, len(joined)) \
            == ref_wire.frame_size(header, len(joined)) == n_ours

    _run(go())


def test_read_msg_resynchronizes_on_back_to_back_frames():
    async def go():
        sink = _Sink()
        for header, body in zip(HEADERS, BODIES):
            await asyncio.wait_for(ref_send_msg(sink, header, body),
                                   LIMIT_S)
        r = _reader(sink.data())
        for header, body in zip(HEADERS, BODIES):
            h, b = await asyncio.wait_for(read_msg(r), LIMIT_S)
            assert h == header
            assert b == b"".join(bytes(x) for x in wire.as_buffers(body))
        with pytest.raises(wire.WireError):
            await asyncio.wait_for(read_msg(r), LIMIT_S)

    _run(go())


def _frame(header: dict, body: bytes = b"") -> bytes:
    head, bufs, _ = wire.encode_frame(header, body)
    return head + b"".join(bytes(b) for b in bufs)


GOOD = _frame({"op": "health"}, b"payload")
# the cases of tests/test_wire.py's read_msg fuzz
BAD_FRAMES = [
    ("truncated prefix", GOOD[:7]),
    ("truncated header", GOOD[:_PREFIX.size + 3]),
    ("truncated body", GOOD[:-3]),
    ("bad magic", b"\x00\x00\x00\x00" + GOOD[4:]),
    ("oversize hdr_len",
     _PREFIX.pack(wire.MAGIC, wire.MAX_HEADER + 1, 0) + b"x"),
    ("oversize body_len",
     _PREFIX.pack(wire.MAGIC, 2, wire.MAX_BODY + 1) + b"{}"),
    ("garbage json header",
     _PREFIX.pack(wire.MAGIC, 9, 0) + b"not-json!"),
    ("non-object json header",
     _PREFIX.pack(wire.MAGIC, 4, 0) + b"1234"),
    ("empty frame", _PREFIX.pack(wire.MAGIC, 0, 0)),
]


@pytest.mark.parametrize("name,raw", BAD_FRAMES,
                         ids=[n for n, _ in BAD_FRAMES])
def test_read_msg_rejects_malformed_as_dfs_tpu_does(name, raw):
    async def go():
        with pytest.raises(wire.WireError) as ours:
            await asyncio.wait_for(read_msg(_reader(raw)), LIMIT_S)
        with pytest.raises(ref_wire.WireError) as ref:
            await asyncio.wait_for(ref_read_msg(_reader(raw)), LIMIT_S)
        assert str(ours.value).split(":")[0] == str(ref.value).split(":")[0]

    _run(go())


def test_frame_server_send_frame_replies_byte_identical():
    """A port FrameServerProtocol answering with ``send_frame``; dfs_tpu's
    stream reader reads the reply, and the bytes are what dfs_tpu's
    ``send_msg`` lays out."""
    reply = ({"ok": True, "digests": ["c" * 64]}, [b"xy", b"", b"z" * 99])

    async def handler(conn, header, body, frame_len):
        assert header == {"op": "health"} and bytes(body) == b"payload"
        n = conn.send_frame(*reply)
        await conn.drain()
        sent.append(n)

    async def go():
        loop = asyncio.get_running_loop()
        server = await loop.create_server(
            lambda: wire.FrameServerProtocol(handler), "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        try:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection("127.0.0.1", port), LIMIT_S)
            await asyncio.wait_for(
                ref_send_msg(writer, {"op": "health"}, b"payload"), LIMIT_S)
            h, b = await asyncio.wait_for(ref_read_msg(reader), LIMIT_S)
            writer.close()
            await asyncio.wait_for(writer.wait_closed(), LIMIT_S)
        finally:
            server.close()
            await asyncio.wait_for(server.wait_closed(), LIMIT_S)
        assert h == reply[0] and b == b"xy" + b"z" * 99
        ref = _Sink()
        n_ref = await ref_send_msg(ref, *reply)
        assert sent == [n_ref] == [len(ref.data())]

    sent: list[int] = []
    _run(go())


def test_node_client_scrub_against_a_port_node(tmp_path):
    cluster = make_cluster(n=1, rf=1)
    port = cluster.peer(1).port

    async def go():
        nodes = await start_nodes(cluster, tmp_path)
        try:
            ours = await asyncio.wait_for(asyncio.to_thread(
                NodeClient(port=port, timeout_s=LIMIT_S).upload,
                b"scrub me" * 999, "s.bin"), LIMIT_S)
            assert ours["fileId"]
            got = await asyncio.wait_for(asyncio.to_thread(
                NodeClient(port=port, timeout_s=LIMIT_S).scrub), LIMIT_S)
            ref = await asyncio.wait_for(asyncio.to_thread(
                RefNodeClient(port=port, timeout_s=LIMIT_S).scrub), LIMIT_S)
        finally:
            await asyncio.wait_for(stop_nodes(nodes), LIMIT_S)
        assert got.keys() == ref.keys()
        assert got["corrupt"] == ref["corrupt"] == 0
        assert got["scanned"] == ref["scanned"] > 0

    _run(go())


def test_config_properties_match_dfs_tpu():
    peers = [(1, "127.0.0.1", 7101, 7201), (2, "node-b.local", 7102, 7202),
             (10, "10.0.0.9", 5010, 6010)]
    ours = ClusterConfig(peers=tuple(PeerAddr(*p) for p in peers))
    ref = RefClusterConfig(peers=tuple(RefPeerAddr(*p) for p in peers))
    assert ours.n_nodes == ref.n_nodes == 3
    assert [p.http_base for p in ours.peers] \
        == [p.http_base for p in ref.peers] \
        == ["http://127.0.0.1:7101", "http://node-b.local:7102",
            "http://10.0.0.9:5010"]
