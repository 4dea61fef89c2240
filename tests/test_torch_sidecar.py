"""The port's chunk+hash sidecar on the CPU: its HPACK against the bytes
grpcio 1.76 sends, the port's client against the port's server (``cdc``
at tiny sizes, as ``tests/test_sidecar.py`` runs dfs_tpu's, and the
anchored engine with ``device="cpu"``), interop with grpcio both ways
(dfs_tpu's client and server), the port's C++ client against the port's
server, nodes of both kinds delegating to the port's sidecar, the bounds
of the teeing node and of the server's per-stream buffer, cancellation,
and the ``sidecar`` subcommand."""

from __future__ import annotations

import asyncio
import itertools
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from dfs_tpu_torch.config import CDCParams
from dfs_tpu_torch.fragmenter.cdc_anchored import (AnchoredCpuFragmenter,
                                                   AnchoredCudaFragmenter)
from dfs_tpu_torch.fragmenter.cdc_cpu import CpuCdcFragmenter
from dfs_tpu_torch.ops.cdc_anchored import (AnchoredCdcParams,
                                            chunk_file_anchored_np)
from dfs_tpu_torch.ops.cdc_v2 import AlignedCdcParams, file_id_from_digests
from dfs_tpu_torch.sidecar import (SidecarClient, SidecarError,
                                   SidecarFragmenter, SidecarServer)
from dfs_tpu_torch.sidecar import h2, hpack

ROOT = Path(__file__).resolve().parent.parent
CDC = CDCParams(min_size=64, avg_size=256, max_size=1024)
SMALL = AnchoredCdcParams(
    chunk=AlignedCdcParams(min_blocks=2, avg_blocks=4, max_blocks=16,
                           strip_blocks=64),
    seg_min=2048, seg_max=4096, seg_mask=2047)


def corpus(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, size=n,
                                                dtype=np.uint8).tobytes()


def triples(chunks) -> list:
    return [(c["offset"], c["length"], c["digest"]) if isinstance(c, dict)
            else (c.offset, c.length, c.digest) for c in chunks]


def blocks_of(data: bytes, bs: int):
    return (data[i:i + bs] for i in range(0, len(data), bs))


def anchored_server(region_bytes: int = 16384) -> SidecarServer:
    """A sidecar whose walk streams (the anchored NumPy engine at tiny
    windows, so a small payload spans many of them)."""
    srv = SidecarServer(port=0, fragmenter="cdc", cdc_params=CDC)
    srv.fragmenter = AnchoredCpuFragmenter(SMALL, region_bytes=region_bytes)
    srv.start()
    return srv


@pytest.fixture(scope="module")
def sidecar():
    srv = SidecarServer(port=0, fragmenter="cdc", cdc_params=CDC)
    srv.start()
    yield srv
    srv.stop()


@pytest.fixture(scope="module")
def streaming():
    srv = anchored_server()
    yield srv
    srv.stop()


# ------------------------------------------------------------------ #
# HPACK, against the blocks grpcio 1.76 sent on one connection
# ------------------------------------------------------------------ #

GRPCIO_REQ1 = bytes.fromhex(
    "40053a70617468132f6466732e536964656361722f4865616c7468400a3a617574"
    "686f726974790f3132372e302e302e313a33373031358386400c636f6e74656e74"
    "2d74797065106170706c69636174696f6e2f677270634002746508747261696c65"
    "72734014677270632d6163636570742d656e636f64696e67176964656e74697479"
    "2c206465666c6174652c20677a6970400c677270632d74696d656f757405313530"
    "306d400a757365722d6167656e7430677270632d707974686f6e2f312e37362e30"
    "20677270632d632f35312e302e3020286c696e75783b2063687474703229")
GRPCIO_REQ2 = bytes.fromhex("c4c38386c2c1c0bfbe")
GRPCIO_SERVER = [bytes.fromhex(h) for h in (
    "88400c636f6e74656e742d74797065106170706c69636174696f6e2f6772706340"
    "14677270632d6163636570742d656e636f64696e67176964656e746974792c2064"
    "65666c6174652c20677a6970",
    "400b677270632d7374617475730130000c677270632d6d65737361676500",
    "88c0400b677270632d7374617475730132000c677270632d6d6573736167652045"
    "7863657074696f6e2063616c6c696e67206170706c69636174696f6e3a2078",
    "88c1400b677270632d737461747573023132000c677270632d6d65737361676511"
    "4d6574686f64206e6f7420666f756e6421")]


def test_hpack_decodes_grpcio_blocks():
    """Request 1 indexes every new field; request 2 is nine indices, seven
    into the dynamic table. The server's blocks (ok headers, ok trailers,
    a raising handler, an unknown method) resolve content-type through
    the dynamic table at 64, then at 65."""
    d = hpack.Decoder()
    r1 = d.decode(GRPCIO_REQ1)
    r2 = d.decode(GRPCIO_REQ2)
    assert dict(r1)[":path"] == "/dfs.Sidecar/Health"
    assert r2 == r1 and len(d.table) == 7
    assert dict(r1)["grpc-timeout"] == "1500m"
    assert h2.parse_timeout("1500m") == 1.5

    s = hpack.Decoder()
    blocks = [dict(s.decode(b)) for b in GRPCIO_SERVER]
    assert blocks[0][":status"] == "200"
    assert blocks[0]["content-type"] == "application/grpc"
    assert blocks[1] == {"grpc-status": "0", "grpc-message": ""}
    assert GRPCIO_SERVER[2][1] == 0x80 | 64 \
        and GRPCIO_SERVER[3][1] == 0x80 | 65
    for b, (code, msg) in zip(blocks[2:], [
            ("2", "Exception calling application: x"),
            ("12", "Method not found!")]):
        assert b["content-type"] == "application/grpc"
        assert (b["grpc-status"], b["grpc-message"]) == (code, msg)


@pytest.mark.parametrize("headers", [
    [(":method", "POST"), (":scheme", "http"), (":status", "200")],
    [(":path", "/dfs.Sidecar/ChunkHashDuplex"), ("te", "trailers"),
     ("content-type", "application/grpc"), ("grpc-timeout", "600000m")],
    [("x-long", "v" * 300), ("n" * 200, ""), ("grpc-message", "é %")],
])
def test_hpack_encode_decode_round_trip(headers):
    block = hpack.Encoder().encode(headers)
    assert hpack.Decoder().decode(block) == headers
    # the encoder never touches the dynamic table: every block stands alone
    d = hpack.Decoder()
    assert d.decode(block) == d.decode(block) and not d.table


def test_hpack_evicts_at_a_small_table_size():
    def lit(name: str, value: str) -> bytes:       # incremental indexing
        return (b"\x40" + hpack.encode_int(len(name), 7) + name.encode()
                + hpack.encode_int(len(value), 7) + value.encode())

    d = hpack.Decoder(max_table_size=100)
    # each entry costs 32 + 2 + 3 = 37 bytes: two fit in 100, three do not
    d.decode(lit("aa", "111") + lit("bb", "222"))
    assert list(d.table) == [("bb", "222"), ("aa", "111")] and d.size == 74
    d.decode(lit("cc", "333"))
    assert list(d.table) == [("cc", "333"), ("bb", "222")]
    assert d.decode(b"\xbe\xbf") == [("cc", "333"), ("bb", "222")]
    # a size update to 40 keeps the newest entry alone; above the
    # advertised limit it is refused; an index past the table too
    d.decode(hpack.encode_int(40, 5, 0x20))
    assert list(d.table) == [("cc", "333")]
    with pytest.raises(hpack.HpackError, match="above the limit"):
        d.decode(hpack.encode_int(101, 5, 0x20))
    with pytest.raises(hpack.HpackError, match="past the dynamic table"):
        d.decode(b"\xbf")


def test_huffman_string_is_a_compression_error(sidecar):
    """A Huffman-flagged string raises in the decoder; the server answers
    GOAWAY(COMPRESSION_ERROR) with a message naming it."""
    with pytest.raises(hpack.HpackError, match="Huffman"):
        hpack.Decoder().decode(b"\x04\x81\x60")
    with socket.create_connection(("127.0.0.1", sidecar.port),
                                  timeout=10) as s:
        block = b"\x83\x86\x04\x81\x60"          # :path as a Huffman string
        s.sendall(h2.PREFACE + h2.settings_frame({})
                  + h2.headers_frames(1, block, 16384, True))
        raw = b""
        while chunk := s.recv(65536):
            raw += chunk
    frames = []
    while len(raw) >= 9:
        ln, ftype, _, _ = h2.parse_header(raw[:9])
        frames.append((ftype, raw[9:9 + ln]))
        raw = raw[9 + ln:]
    away = [p for t, p in frames if t == h2.GOAWAY]
    assert away and int.from_bytes(away[0][4:8], "big") \
        == h2.COMPRESSION_ERROR
    assert b"Huffman" in away[0][8:]


# ------------------------------------------------------------------ #
# the port's client against the port's server
# ------------------------------------------------------------------ #

def test_health_and_tables_on_cdc(sidecar):
    c = SidecarClient(sidecar.port)
    h = c.health()
    assert h["ok"] and h["fragmenter"] == "cdc" and h["window"] == 0
    assert h["describe"]["kind"] == "cdc"
    data = corpus(30_000, 1)
    resp = c.chunk_hash(data)
    want = CpuCdcFragmenter(CDC).chunk(data)
    assert resp["size"] == len(data) and triples(resp["chunks"]) \
        == triples(want)
    assert resp["fileId"] == file_id_from_digests([w.digest for w in want])
    empty = c.chunk_hash(b"")
    assert empty["chunks"] == [] and empty["size"] == 0


@pytest.mark.parametrize("method", ["stream", "duplex"])
def test_stream_and_duplex_match_unary_any_blocking(sidecar, method):
    c = SidecarClient(sidecar.port)
    data = corpus(200_000, 2)
    want = c.chunk_hash(data)
    for bs in (1000, 8192, 65536):
        if method == "stream":
            got = c.chunk_hash_stream(blocks_of(data, bs))
            assert got["chunks"] == want["chunks"]
            assert got["size"] == len(data)
        else:
            msgs = list(c.chunk_hash_duplex(blocks_of(data, bs)))
            assert msgs[-1] == {"done": True, "size": len(data),
                                "fileId": want["fileId"],
                                "fragmenter": "cdc"}
            assert [x for m in msgs[:-1] for x in m["chunks"]] \
                == want["chunks"]


def test_stream_generator_is_consumed_lazily(sidecar):
    data = corpus(120_000, 3)
    pulled = []

    def gen():
        for i in range(0, len(data), 4096):
            pulled.append(i)
            yield data[i:i + 4096]

    resp = SidecarClient(sidecar.port).chunk_hash_stream(gen())
    assert len(pulled) == -(-len(data) // 4096)
    assert sum(c["length"] for c in resp["chunks"]) == len(data)


def test_duplex_batches_are_incremental(streaming):
    c = SidecarClient(streaming.port)
    data = corpus(150_000, 4)
    want = c.chunk_hash_stream(blocks_of(data, 7000))
    msgs = list(c.chunk_hash_duplex(blocks_of(data, 7000)))
    assert msgs[-1]["done"] and msgs[-1]["fileId"] == want["fileId"]
    assert [x for m in msgs[:-1] for x in m["chunks"]] == want["chunks"]
    assert len(msgs) > 3, "duplex replies were not incremental"
    assert triples(want["chunks"]) == chunk_file_anchored_np(
        np.frombuffer(data, np.uint8), SMALL)


def test_anchored_engine_on_the_cpu_device():
    """The port's anchored walk (the plain versions, ``device="cpu"``) at
    the tiny geometry (128 KiB windows, 4 KiB lanes; one window, the plain
    chain is slow on the CPU) behind the sidecar: Health's window is the
    walk's stream_span; streamed and duplex tables equal the NumPy
    oracle."""
    srv = SidecarServer(port=0, fragmenter="cdc-anchored-cuda",
                        device="cpu")
    srv.fragmenter = AnchoredCudaFragmenter(
        SMALL, region_bytes=128 * 1024, cpu_cutoff=0, lane_multiple=8,
        device="cpu")
    srv.start()
    try:
        c = SidecarClient(srv.port)
        h = c.health()
        assert h["fragmenter"] == "cdc-anchored-cuda"
        assert h["window"] == srv.fragmenter.stream_span() == 3 * 128 * 1024
        assert h["describe"] == AnchoredCpuFragmenter(SMALL).describe()
        data = corpus(120_000, 5)
        want = chunk_file_anchored_np(np.frombuffer(data, np.uint8), SMALL)
        assert triples(c.chunk_hash_stream(blocks_of(data, 50_000))
                       ["chunks"]) == want
        msgs = list(c.chunk_hash_duplex(blocks_of(data, 50_000)))
        assert triples(x for m in msgs[:-1] for x in m["chunks"]) == want
    finally:
        srv.stop()


def test_sidecar_fragmenter_adapter(sidecar):
    frag = SidecarFragmenter(sidecar.port)
    data = corpus(50_000, 6)
    assert triples(frag.chunk(data)) \
        == triples(CpuCdcFragmenter(CDC).chunk(data))
    m = frag.manifest(data, name="f", file_id="ab" * 32)
    assert m.file_id == "ab" * 32 and m.size == len(data)
    assert frag.name == "sidecar:cdc"
    assert frag.describe() == CpuCdcFragmenter(CDC).describe()
    frag.close()


def test_errors_and_deadlines(sidecar):
    """An unknown method answers 12, a raising fragmenter 2 with grpcio's
    text, an expired deadline 4, a closed port 14."""
    with pytest.raises(SidecarError) as e:
        h2.unary("127.0.0.1", sidecar.port, "/dfs.Sidecar/Nope", [b""], 10)
    assert (e.value.code, e.value.details) == (12, "Method not found!")
    gate = threading.Event()

    class Slow(CpuCdcFragmenter):
        def chunk(self, data):
            if data == b"boom":
                raise ValueError("boom")
            gate.wait(10)
            return super().chunk(data)

    frag0, sidecar.fragmenter = sidecar.fragmenter, Slow(CDC)
    try:
        with pytest.raises(SidecarError) as e:
            SidecarClient(sidecar.port).chunk_hash(b"boom")
        assert (e.value.code, e.value.details) == \
            (2, "Exception calling application: boom")
        with pytest.raises(SidecarError) as e:
            SidecarClient(sidecar.port, timeout_s=0.3).chunk_hash(b"x")
        assert e.value.code == 4
    finally:
        gate.set()
        sidecar.fragmenter = frag0
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    dead = s.getsockname()[1]
    s.close()
    with pytest.raises(SidecarError) as e:
        SidecarClient(dead).health()
    assert e.value.code == 14


# ------------------------------------------------------------------ #
# interop with grpcio, both ways
# ------------------------------------------------------------------ #

@pytest.fixture
def grpc():
    return pytest.importorskip("grpc")


def test_dfs_tpu_client_against_port_server(grpc, sidecar):
    """dfs_tpu's grpcio SidecarClient: all four methods equal dfs_tpu's
    in-process fragmenter byte for byte, two duplex calls multiplexed on
    one channel, an unknown method and a raising fragmenter answered as
    dfs_tpu's own server answers them."""
    from dfs_tpu.config import CDCParams as RefCDC
    from dfs_tpu.fragmenter.cdc_cpu import CpuCdcFragmenter as RefCdc
    from dfs_tpu.sidecar.service import SidecarClient as RefClient
    from dfs_tpu.sidecar.service import SidecarServer as RefServer

    data = corpus(200_000, 7)
    ref_frag = RefCdc(RefCDC(64, 256, 1024))
    want = triples(ref_frag.chunk(data))
    ref_srv = RefServer(port=0, fragmenter="cdc",
                        cdc_params=RefCDC(64, 256, 1024))
    ref_srv.start()
    answers = {}
    try:
        for name, port in (("port", sidecar.port), ("ref", ref_srv.port)):
            rc = RefClient(port)
            h = rc.health()
            unary = rc.chunk_hash(data)
            stream = rc.chunk_hash_stream(blocks_of(data, 7000))
            out = {}

            def dup(k, rc=rc, out=out):
                out[k] = list(rc.chunk_hash_duplex(blocks_of(data, 5000)))

            ts = [threading.Thread(target=dup, args=(k,)) for k in range(2)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(30)
                assert not t.is_alive()
            nope = rc._channel.unary_unary(
                "/dfs.Sidecar/Nope", request_serializer=lambda x: x,
                response_deserializer=lambda x: x)
            try:
                nope(b"", timeout=10)
            except grpc.RpcError as e:
                unknown = (e.code(), e.details())
            srv = sidecar if name == "port" else ref_srv
            frag0, srv.fragmenter = srv.fragmenter, None   # .chunk raises
            try:
                rc.chunk_hash(b"abc")
            except grpc.RpcError as e:
                raised = (e.code(), e.details())
            finally:
                srv.fragmenter = frag0
            answers[name] = (h, unary, stream, out[0], out[1], unknown,
                             raised)
            rc.close()
    finally:
        ref_srv.stop()
    port, ref = answers["port"], answers["ref"]
    assert port == ref
    h, unary, stream, d0, d1, unknown, raised = port
    assert triples(unary["chunks"]) == want and stream == unary
    assert d0 == d1 and triples(x for m in d0[:-1] for x in m["chunks"]) \
        == want
    assert unknown == (grpc.StatusCode.UNIMPLEMENTED, "Method not found!")
    assert raised[0] == grpc.StatusCode.UNKNOWN
    assert raised[1].startswith("Exception calling application: ")


@pytest.mark.parametrize("kind", ["cdc", "cdc-anchored"])
def test_port_client_against_dfs_tpu_server(grpc, kind):
    """The port's SidecarClient against dfs_tpu's grpcio server: all four
    methods, tables equal dfs_tpu's in-process fragmenter byte for byte;
    an unknown method answers 12."""
    from dfs_tpu.config import CDCParams as RefCDC
    from dfs_tpu.sidecar.service import SidecarServer as RefServer

    ref = RefServer(port=0, fragmenter=kind,
                    cdc_params=RefCDC(64, 256, 1024))
    ref.start()
    try:
        c = SidecarClient(ref.port)
        data = corpus(300_000, 8)
        want = triples(ref.fragmenter.chunk(data))
        h = c.health()
        assert h["fragmenter"] == kind
        assert h["window"] == (ref.fragmenter.stream_span() or 0)
        assert h["describe"] == ref.fragmenter.describe()
        unary = c.chunk_hash(data)
        assert triples(unary["chunks"]) == want
        assert c.chunk_hash_stream(blocks_of(data, 65536)) == unary
        msgs = list(c.chunk_hash_duplex(blocks_of(data, 65536)))
        assert triples(x for m in msgs[:-1] for x in m["chunks"]) == want
        assert msgs[-1]["fileId"] == unary["fileId"]
        with pytest.raises(SidecarError) as e:
            h2.unary("127.0.0.1", ref.port, "/dfs.Sidecar/Nope", [b""], 10)
        assert (e.value.code, e.value.details) == (12, "Method not found!")
    finally:
        ref.stop()


# ------------------------------------------------------------------ #
# the C++ client
# ------------------------------------------------------------------ #

@pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")
@pytest.mark.parametrize("method", ["ChunkHashStream", "ChunkHash",
                                    "ChunkHashDuplex", "Health"])
def test_cpp_client_against_port_server(tmp_path, method, streaming):
    """The port's copy of the C++ client (POSIX sockets only), built from
    the repository, over a payload many times the 64 KiB initial windows:
    every method's table equals the NumPy oracle; the duplex runs under
    the 2 x window cap."""
    from dfs_tpu_torch.native import build_sidecar_client

    binary = build_sidecar_client()
    data = corpus(1_500_000, 9)
    payload = tmp_path / "p.bin"
    payload.write_bytes(data)
    out = subprocess.run([str(binary), "127.0.0.1", str(streaming.port),
                          str(payload), method], capture_output=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr.decode()
    lines = [json.loads(ln) for ln in out.stdout.splitlines() if ln.strip()]
    if method == "Health":
        assert lines[0]["window"] == streaming.fragmenter.stream_span() > 0
        return
    want = chunk_file_anchored_np(np.frombuffer(data, np.uint8), SMALL)
    assert triples(x for ln in lines for x in ln.get("chunks", [])) == want
    if method == "ChunkHashDuplex":
        assert len(lines) > 3 and lines[-1]["done"]
        assert lines[-1]["fileId"] == file_id_from_digests(
            [w[2] for w in want])


# ------------------------------------------------------------------ #
# delegation, bounds, cancellation
# ------------------------------------------------------------------ #

def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


@pytest.mark.parametrize("kind", ["port", "dfs_tpu"])
def test_node_uploads_through_port_sidecar(tmp_path, kind, streaming):
    """A node of either package with ``sidecar_port`` uploads chunked and
    with a Content-Length body through the port's sidecar: manifests equal
    the in-process tables, downloads are identical, and the node's tee
    stays within 2 x window + 2 blocks."""
    if kind == "port":
        from dfs_tpu_torch import config as cfgmod
        from dfs_tpu_torch.node.runtime import StorageNodeServer
        extra = {"device": "cpu"}
    else:
        from dfs_tpu import config as cfgmod
        from dfs_tpu.node.runtime import StorageNodeServer
        extra = {}
    ports = _free_ports(2)
    cfg = cfgmod.NodeConfig(
        node_id=1, cluster=cfgmod.ClusterConfig.localhost(1, *ports, 1),
        data_root=tmp_path, sidecar_port=streaming.port, health_probe_s=0,
        **extra)
    data = corpus(600_000, 10)
    block = 40_000
    want = chunk_file_anchored_np(np.frombuffer(data, np.uint8), SMALL)

    async def blocks():
        for i in range(0, len(data), block):
            yield data[i:i + block]

    async def run():
        node = StorageNodeServer(cfg)
        assert node.fragmenter.name == "sidecar:cdc-anchored"
        node._STREAM_FLUSH_BYTES = 128 * 1024
        await node.start()
        try:
            m1, _ = await node.upload_stream(blocks(), "s.bin")
            peak = node.fragmenter.last_peak_buffer
            m2, _ = await node.upload(data, "u.bin")
            for m in (m1, m2):
                assert triples(m.chunks) == want
                assert (await node.download(m.file_id))[1] == data
            return peak, node.fragmenter.stream_window
        finally:
            await node.stop()

    peak, window = asyncio.run(asyncio.wait_for(run(), timeout=60))
    assert window == streaming.fragmenter.stream_span()
    assert 0 < peak <= 2 * window + 2 * block


def test_server_buffer_is_bounded_while_the_walk_is_held(sidecar):
    """A walk that stalls after its first block holds its own client
    back: the server's buffered bytes for the stream stay below the
    stream window plus a block, and the client's generator is pulled only
    that far; released, the call completes with the right table."""
    gate = threading.Event()
    block = 1 << 20
    data = corpus(12 * block, 11)
    pulled = []

    class Held(CpuCdcFragmenter):
        def manifest_stream(self, blocks, name, store=None):
            it = iter(blocks)
            first = next(it)
            gate.wait(30)
            return super().manifest_stream(itertools.chain([first], it),
                                           name, store)

    def gen():
        for i in range(0, len(data), block):
            pulled.append(i)
            yield data[i:i + block]

    frag0, sidecar.fragmenter = sidecar.fragmenter, Held(CDCParams())
    result = {}
    t = threading.Thread(target=lambda: result.setdefault(
        "r", SidecarClient(sidecar.port).chunk_hash_stream(gen())))
    try:
        t.start()
        time.sleep(0.5)
        held = sidecar.buffered()
        assert held and max(held) <= h2.STREAM_WINDOW + block + 5
        assert len(pulled) <= (h2.STREAM_WINDOW + 3 * block) // block + 2
    finally:
        gate.set()
        t.join(60)
        sidecar.fragmenter = frag0
    assert not t.is_alive()
    assert triples(result["r"]["chunks"]) == triples(
        CpuCdcFragmenter(CDCParams()).chunk(data))


def test_concurrent_calls_beyond_the_worker_pool(streaming):
    """Twelve calls at once on a server of four workers, with a short
    interpreter switch interval: the calls past the pool wait (their
    request bytes held back by flow control) and every table is right."""
    data = corpus(200_000, 14)
    want = chunk_file_anchored_np(np.frombuffer(data, np.uint8), SMALL)
    got: dict[int, list] = {}

    def call(k: int) -> None:
        c = SidecarClient(streaming.port, timeout_s=60)
        if k % 2:
            msgs = list(c.chunk_hash_duplex(blocks_of(data, 3000 + k)))
            got[k] = [x for m in msgs[:-1] for x in m["chunks"]]
        else:
            got[k] = c.chunk_hash_stream(blocks_of(data, 3000 + k))["chunks"]

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ts = [threading.Thread(target=call, args=(k,)) for k in range(12)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert len(got) == 12 and all(triples(v) == want for v in got.values())
    assert streaming.buffered() == []


def test_cancelled_duplex_frees_the_stream(grpc, streaming):
    """A duplex left after its first batch (the port's client: RST_STREAM
    and a closed connection; grpcio's: RST_STREAM on a channel that stays
    open) ends the server's worker and closes the walk's generator; the
    next call is served, on grpcio's channel the same connection."""
    from dfs_tpu.sidecar.service import SidecarClient as RefClient

    closed = []
    frag0 = streaming.fragmenter

    class Watched(AnchoredCpuFragmenter):
        def chunks_stream(self, blocks, store=None):
            try:
                yield from super().chunks_stream(blocks, store)
            finally:
                closed.append(True)

    streaming.fragmenter = Watched(SMALL, region_bytes=16384)
    data = corpus(400_000, 12)

    def endless():
        while True:
            yield from blocks_of(data, 8192)

    try:
        c = SidecarClient(streaming.port)
        rc = RefClient(streaming.port)
        for client in (c, rc):
            n0 = len(closed)
            if client is c:
                replies = c.chunk_hash_duplex(endless())
                assert next(replies)["chunks"]
                replies.close()
            else:
                call = rc._chunk_hash_duplex(endless(), timeout=30)
                assert json.loads(next(call))["chunks"]
                call.cancel()
            end = time.monotonic() + 10
            while (len(closed) == n0 or streaming.buffered()) \
                    and time.monotonic() < end:
                time.sleep(0.05)
            assert len(closed) == n0 + 1 and streaming.buffered() == []
            assert client.health()["ok"]
            assert triples(client.chunk_hash(data[:50_000])["chunks"]) \
                == chunk_file_anchored_np(
                    np.frombuffer(data[:50_000], np.uint8), SMALL)
        rc.close()
    finally:
        streaming.fragmenter = frag0


# ------------------------------------------------------------------ #
# the subcommand
# ------------------------------------------------------------------ #

def test_sidecar_subcommand_serves_and_stops_on_sigterm(tmp_path):
    port = _free_ports(1)[0]
    proc = subprocess.Popen(
        [sys.executable, "-m", "dfs_tpu_torch.cli.main", "sidecar",
         "--sidecar-port", str(port), "--fragmenter", "cdc",
         "--device", "cpu", "--min-chunk", "64", "--avg-chunk", "256",
         "--max-chunk", "1024"], cwd=tmp_path, stdout=subprocess.PIPE,
        text=True, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    try:
        line = proc.stdout.readline()
        assert line == (f"sidecar listening on 127.0.0.1:{port} "
                        "(fragmenter=cdc)\n")
        c = SidecarClient(port)
        assert c.health()["describe"] == CpuCdcFragmenter(CDC).describe()
        data = corpus(20_000, 13)
        assert triples(c.chunk_hash(data)["chunks"]) \
            == triples(CpuCdcFragmenter(CDC).chunk(data))
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=10) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
