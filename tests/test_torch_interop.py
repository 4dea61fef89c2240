"""A mixed cluster: one dfs_tpu node (its CPU anchored engine) and two
nodes of the port in one rf-2 cluster, on the CPU. They share the wire,
the ring and the on-disk layout, so an upload through either kind gives
the same fileId and chunk digests and either kind serves the other's
files; the frame encoder and the ring fingerprint are held equal
directly. With four port nodes, erasure-coded files cross both ways. An
expired wire deadline is dropped by either kind, and the serving tier's
cache and single-flight count the same on one read sequence. A traced
upload through either kind stitches one trace across both, and the
frames a traced client sends are byte-identical up to the random ids.
dfs_tpu's SmartClient and the port's each run the single-hop upload and
the striped download against a port cluster, a dfs_tpu cluster and a
mixed one, with the same chunk tables and identical bytes."""

import asyncio
import hashlib
import json
import socket
import urllib.request

import numpy as np
import pytest

from dfs_tpu.cli.client import NodeClient as RefClient
from dfs_tpu.comm import wire as ref_wire
from dfs_tpu.config import CDCParams as RefCDC
from dfs_tpu.config import ClusterConfig as RefCluster
from dfs_tpu.config import NodeConfig as RefNodeConfig
from dfs_tpu.config import PeerAddr as RefPeer
from dfs_tpu.node import placement as ref_placement
from dfs_tpu.node.runtime import StorageNodeServer as RefServer
from dfs_tpu.ring import RingMap as RefRing

from dfs_tpu_torch.cli.client import NodeClient
from dfs_tpu_torch.comm import wire
from dfs_tpu_torch.config import CDCParams, ClusterConfig, NodeConfig, \
    PeerAddr
from dfs_tpu_torch.fragmenter.base import _anchored_params
from dfs_tpu_torch.node import placement
from dfs_tpu_torch.node.runtime import StorageNodeServer
from dfs_tpu_torch.ops.cdc_anchored import chunk_file_anchored_np
from dfs_tpu_torch.ring import RingMap

SIZES = dict(min_size=64, avg_size=256, max_size=1024)


def corpus(n, seed):
    return np.random.default_rng(seed).integers(0, 256, size=n,
                                                dtype=np.uint8).tobytes()


def _free_ports(n):
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def test_mixed_cluster_agrees_and_serves_both_ways(tmp_path):
    ports = _free_ports(6)
    addrs = [(i + 1, ports[2 * i], ports[2 * i + 1]) for i in range(3)]
    ref_cluster = RefCluster(peers=tuple(
        RefPeer(node_id=i, host="127.0.0.1", port=p, internal_port=q)
        for i, p, q in addrs), replication_factor=2)
    cluster = ClusterConfig(peers=tuple(
        PeerAddr(node_id=i, host="127.0.0.1", port=p, internal_port=q)
        for i, p, q in addrs), replication_factor=2)
    a, b = corpus(50_000, seed=11), corpus(45_000, seed=12)

    async def http(fn, *args):
        return await asyncio.to_thread(fn, *args)

    async def go():
        ref = RefServer(RefNodeConfig(
            node_id=1, cluster=ref_cluster, data_root=tmp_path,
            fragmenter="cdc-anchored", cdc=RefCDC(**SIZES),
            health_probe_s=0))
        ports_ = [StorageNodeServer(NodeConfig(
            node_id=i, cluster=cluster, data_root=tmp_path,
            cdc=CDCParams(**SIZES), health_probe_s=0, device="cpu"))
            for i in (2, 3)]
        nodes = [ref, *ports_]
        for n in nodes:
            await n.start()
        try:
            c_ref = RefClient(port=addrs[0][1], timeout_s=30)
            c_port = NodeClient(port=addrs[1][1], timeout_s=30)
            c_port3 = NodeClient(port=addrs[2][1], timeout_s=30)
            ia = await http(c_ref.upload, a, "a.bin")      # dfs_tpu node
            ib = await http(c_port.upload, b, "b.bin")     # port node
            assert ia["fileId"] == hashlib.sha256(a).hexdigest()
            assert ib["fileId"] == hashlib.sha256(b).hexdigest()
            assert ia["minCopies"] == ib["minCopies"] == 2
            params = _anchored_params(CDCParams(**SIZES))
            for body, info in ((a, ia), (b, ib)):
                want = chunk_file_anchored_np(np.frombuffer(body, np.uint8),
                                              params)
                for c in (c_ref, c_port, c_port3):
                    doc = await http(c.manifest, info["fileId"])
                    assert [(x["offset"], x["length"], x["digest"])
                            for x in doc["chunks"]] == want
            # each kind downloads the other's upload
            assert await http(c_port.download, ia["fileId"]) == a
            assert await http(c_port3.download, ia["fileId"]) == a
            assert await http(c_ref.download, ib["fileId"]) == b
            # the same bytes through a port node: same id, nothing moves
            again = await http(c_port3.upload, a, "a.bin")
            assert again["fileId"] == ia["fileId"]
            assert again["transferredBytes"] == 0
            # repair and anti-entropy across kinds find nothing to do
            assert await ref.repair_once() == 0
            assert await ports_[0].repair_once() == 0
        finally:
            for n in nodes:
                await n.stop()

    asyncio.run(asyncio.wait_for(go(), timeout=60))


def test_mixed_cluster_ec_reads_with_two_holders_down(tmp_path):
    """One dfs_tpu node and four port nodes, k=3 over 5 (each stripe's 5
    shards on 5 distinct nodes): an EC file uploaded through a port node
    and one uploaded through the dfs_tpu node; both kinds compute the
    same stripe placement for each; then two port nodes stop and each
    kind reads the other's file byte-identically, by decode."""
    from dfs_tpu.node.runtime import ec_placement_map as ref_pl

    from dfs_tpu_torch.node.runtime import ec_placement_map

    ports = _free_ports(10)
    addrs = [(i + 1, ports[2 * i], ports[2 * i + 1]) for i in range(5)]
    ref_cluster = RefCluster(peers=tuple(
        RefPeer(node_id=i, host="127.0.0.1", port=p, internal_port=q)
        for i, p, q in addrs), replication_factor=2)
    cluster = ClusterConfig(peers=tuple(
        PeerAddr(node_id=i, host="127.0.0.1", port=p, internal_port=q)
        for i, p, q in addrs), replication_factor=2)
    a, b = corpus(30_000, seed=13), corpus(25_000, seed=14)
    ids = [1, 2, 3, 4, 5]

    async def http(fn, *args):
        return await asyncio.to_thread(fn, *args)

    async def go():
        ref = RefServer(RefNodeConfig(
            node_id=1, cluster=ref_cluster, data_root=tmp_path,
            fragmenter="cdc-anchored", cdc=RefCDC(**SIZES),
            health_probe_s=0))
        mine = {i: StorageNodeServer(NodeConfig(
            node_id=i, cluster=cluster, data_root=tmp_path,
            cdc=CDCParams(**SIZES), health_probe_s=0, device="cpu"))
            for i in (2, 3, 4, 5)}
        for n in (ref, *mine.values()):
            await n.start()
        try:
            c_ref = RefClient(port=addrs[0][1], timeout_s=30)
            ia = await http(NodeClient(port=addrs[1][1],
                                       timeout_s=30).upload, a, "a.bin", 3)
            ib = await http(c_ref.upload, b, "b.bin", 3)
            assert ia["ecParityBytes"] > 0 and ib["ecParityBytes"] > 0
            for info in (ia, ib):
                fid = info["fileId"]
                rm = ref.store.manifests.load(fid)
                pm = mine[5].store.manifests.load(fid)
                assert rm.to_json() == pm.to_json()
                assert dict(ec_placement_map(pm, ids)) \
                    == dict(ref_pl(rm, ids)) \
                    == dict(ec_placement_map(pm, mine[5].ring.current)) \
                    == dict(ref_pl(rm, ref.ring.current))
            for i in (3, 4):
                await mine.pop(i).stop()
            assert await http(c_ref.download, ia["fileId"]) == a
            assert await http(NodeClient(port=addrs[4][1],
                                         timeout_s=30).download,
                              ib["fileId"]) == b
            assert ref.counters.snapshot().get("ec_decodes", 0) > 0
            assert mine[5].counters.snapshot().get("ec_decodes", 0) > 0
        finally:
            for n in (ref, *mine.values()):
                await n.stop()

    asyncio.run(asyncio.wait_for(go(), timeout=60))


FRAMES = [
    ({"op": "health"}, b""),
    ({"op": "store_chunks", "fileId": "", "chunks": [
        {"digest": "ab" * 32, "length": 3}]}, [b"xyz"]),
    ({"op": "get_chunks", "digests": ["00" * 32, "ff" * 32],
      "repoch": 0, "rfp": "0123456789abcdef"}, b""),
    ({"ok": True, "manifest": '{"a": "é\\"q"}', "mtime": 1.5},
     [bytearray(b"ab"), memoryview(b"cde")]),
    ({"ok": False, "error": "unknown op 'x'", "n": None, "f": [1.0, -2]},
     b"\x00" * 1000),
    ({"op": "get_trace", "traceId": "0123456789abcdef" * 2,
      "trace": {"t": "0123456789abcdef" * 2, "s": "fedcba9876543210",
                "f": 3}, "deadline": 2.5}, b""),
    ({"ok": True, "spans": [{"t": "ab" * 16, "s": "cd" * 8, "p": None,
                             "name": "peer.store_chunks", "node": 2,
                             "t0": 1790000000.123456, "d": 0.25,
                             "peer": 1, "bytes": 4096}]}, b""),
    # the membership and diagnosis ops, requests and replies
    ({"op": "get_ring"}, b""),
    ({"ok": True, "ring": RingMap.hashed({1: 1.0, 2: 0.5}, 3).to_dict(),
      "previous": RingMap.static([1, 2], 2).to_dict(), "migrating": True},
     b""),
    ({"op": "propose_ring",
      "ring": RingMap.hashed({1: 1.0, 4: 0.25}, 7, 16).to_dict()}, b""),
    ({"ok": True, "epoch": 7, "installed": False}, b""),
    ({"ok": False, "error": "ring epoch mismatch (have 2, got 1)",
      "ringEpoch": 2, "ring": RingMap.hashed({1: 1.0}, 2).to_dict()}, b""),
    ({"op": "get_census", "prefixes": ["00", "a7"]}, b""),
    ({"ok": True, "census": {"buckets": {"a7": [2, 8192,
                                                 12345678901234567]},
                             "chunks": 2, "bytes": 8192, "nodeId": 3,
                             "disk": {"totalBytes": 10, "freeBytes": 4},
                             "cacheTemperature": []}}, b""),
    ({"op": "get_doctor"}, b""),
    ({"ok": True, "doctor": {"nodeId": 2, "now": 1790000000.5,
                             "ring": {"epoch": 1, "migrating": False,
                                      "sinceProgressS": None}}}, b""),
]


@pytest.mark.parametrize("header,body", FRAMES)
def test_frames_are_byte_identical(header, body):
    head, bufs, total = wire.encode_frame(dict(header), body)
    rhead, rbufs, rtotal = ref_wire.encode_frame(dict(header), body)
    assert head == rhead and total == rtotal
    assert b"".join(bytes(x) for x in bufs) \
        == b"".join(bytes(x) for x in rbufs)
    table, pb = wire.pack_chunks([("ab" * 32, b"xyz"), ("cd" * 32, b"")])
    assert (table, pb) == ref_wire.pack_chunks(
        [("ab" * 32, b"xyz"), ("cd" * 32, b"")])


def test_new_op_replies_are_the_same_frames(tmp_path):
    """get_ring, propose_ring and get_census answered by a dfs_tpu node
    and a port node over one data root and one ring are the same frame
    bytes; get_doctor answers with the same document keys."""
    ports = _free_ports(6)
    addrs = [(i + 1, ports[2 * i], ports[2 * i + 1]) for i in range(3)]
    ref = RefServer(RefNodeConfig(
        node_id=1, cluster=RefCluster(peers=tuple(
            RefPeer(node_id=i, host="127.0.0.1", port=p, internal_port=q)
            for i, p, q in addrs), replication_factor=2),
        data_root=tmp_path, fragmenter="cdc", cdc=RefCDC(**SIZES)))
    ours = StorageNodeServer(NodeConfig(
        node_id=1, cluster=ClusterConfig(peers=tuple(
            PeerAddr(node_id=i, host="127.0.0.1", port=p, internal_port=q)
            for i, p, q in addrs), replication_factor=2),
        data_root=tmp_path, cdc=CDCParams(**SIZES), device="cpu"))
    body = corpus(4096, seed=5)
    ours.store.chunks.put(hashlib.sha256(body).hexdigest(), body)
    nxt = RingMap.hashed({1: 1.0, 2: 1.0, 3: 0.5}, 1, 16).to_dict()

    async def go():
        got = []
        for n in (ours, ref):
            n.ring.on_change = None
            # statvfs moves under a shared disk: one fixed answer for both
            n._disk_usage = lambda: {"totalBytes": 10, "freeBytes": 4}
            frames = []
            for header in ({"op": "get_ring"},
                           {"op": "propose_ring", "ring": nxt},
                           {"op": "propose_ring", "ring": nxt},
                           {"op": "get_ring"},
                           {"op": "get_census"},
                           {"op": "get_census", "prefixes": ["zz"]},
                           {"op": "get_census",
                            "prefixes": [hashlib.sha256(body).hexdigest()
                                         [:2]]}):
                resp, rb = await n._dispatch(dict(header), b"")
                frames.append(wire.encode_frame(resp, rb)[0])
            doc, _ = await n._dispatch({"op": "get_doctor"}, b"")
            got.append((frames, set(doc["doctor"])))
        return got

    (ours_frames, ours_keys), (ref_frames, ref_keys) = \
        asyncio.run(go())
    assert ours_frames == ref_frames
    assert ours_keys == ref_keys


def test_traced_frames_are_byte_identical_up_to_the_ids():
    """The header a client of each kind sends from inside a traced
    request: the random trace and span ids masked, the frames are the
    same bytes (the ``trace`` field's keys, order and sender id
    included)."""
    from dfs_tpu.config import ObsConfig as RefObsConfig
    from dfs_tpu.obs import Observability as RefObs

    from dfs_tpu_torch.config import ObsConfig
    from dfs_tpu_torch.obs import Observability

    frames = []
    for o in (Observability(ObsConfig(), node_id=3),
              RefObs(RefObsConfig(), node_id=3)):
        with o.request_span("http./upload"):
            with o.span("rpc.store_chunks", peer=2):
                tr = o.wire_trace()
        assert list(tr) == ["t", "s", "f"] and tr["f"] == 3
        tr.update(t="T" * len(tr["t"]), s="S" * len(tr["s"]))
        frames.append({"op": "store_chunks", "fileId": "",
                       "chunks": [{"digest": "ab" * 32, "length": 3}],
                       "repoch": 0, "rfp": "0123456789abcdef",
                       "trace": tr, "deadline": 1.25})
    assert frames[0] == frames[1]
    head, bufs, _ = wire.encode_frame(frames[0], [b"xyz"])
    rhead, rbufs, _ = ref_wire.encode_frame(frames[1], [b"xyz"])
    assert head == rhead


def test_mixed_cluster_trace_stitches_both_ways(tmp_path):
    """One dfs_tpu node and two port nodes, rf 2: an upload traced at the
    dfs_tpu node stitches, through its /trace, the port nodes' peer spans
    under its rpc spans; an upload traced at a port node stitches the
    dfs_tpu node's spans through the port's /trace, and each kind renders
    the other's stitch the same."""
    from dfs_tpu.obs import new_trace_id
    from dfs_tpu.obs.stitch import render_tree as ref_render

    from dfs_tpu_torch.obs.stitch import render_tree

    ports = _free_ports(6)
    addrs = [(i + 1, ports[2 * i], ports[2 * i + 1]) for i in range(3)]
    ref_cluster = RefCluster(peers=tuple(
        RefPeer(node_id=i, host="127.0.0.1", port=p, internal_port=q)
        for i, p, q in addrs), replication_factor=2)
    cluster = ClusterConfig(peers=tuple(
        PeerAddr(node_id=i, host="127.0.0.1", port=p, internal_port=q)
        for i, p, q in addrs), replication_factor=2)

    async def http(fn, *args, **kw):
        return await asyncio.to_thread(fn, *args, **kw)

    def check(spans, coordinator):
        ids = {s["s"] for s in spans}
        assert [s["name"] for s in spans if s["p"] not in ids] \
            == ["http./upload"]
        assert {s["node"] for s in spans} == {1, 2, 3}
        peers = [s for s in spans if s["name"] == "peer.store_chunks"]
        assert {s["node"] for s in peers} == {1, 2, 3} - {coordinator}
        for s in peers:
            parent = next(x for x in spans if x["s"] == s["p"])
            assert parent["name"] == "rpc.store_chunks"
            assert parent["node"] == coordinator
        assert render_tree(spans) == ref_render(spans)

    async def go():
        ref = RefServer(RefNodeConfig(
            node_id=1, cluster=ref_cluster, data_root=tmp_path,
            fragmenter="cdc-anchored", cdc=RefCDC(**SIZES),
            health_probe_s=0))
        ports_ = [StorageNodeServer(NodeConfig(
            node_id=i, cluster=cluster, data_root=tmp_path,
            cdc=CDCParams(**SIZES), health_probe_s=0, device="cpu"))
            for i in (2, 3)]
        nodes = [ref, *ports_]
        for n in nodes:
            await n.start()
        try:
            c_ref = RefClient(port=addrs[0][1], timeout_s=30)
            c_port = NodeClient(port=addrs[1][1], timeout_s=30)
            t1, t2 = new_trace_id(), new_trace_id()
            await http(c_ref.upload, corpus(40_000, seed=21), "a.bin",
                       trace_id=t1)
            await http(c_port.upload, corpus(40_000, seed=22), "b.bin",
                       trace_id=t2)
            check((await http(c_ref.trace, t1))["spans"], 1)
            check((await http(c_port.trace, t2))["spans"], 2)
            # the other kind's /trace stitches the same spans
            def by_id(doc):
                return sorted(doc["spans"], key=lambda x: x["s"])

            assert by_id(await http(c_port.trace, t1)) \
                == by_id(await http(c_ref.trace, t1))
        finally:
            for n in nodes:
                await n.stop()

    asyncio.run(asyncio.wait_for(go(), timeout=60))


@pytest.mark.parametrize("ids", [[1], [1, 2, 3], [1, 2, 3, 4, 5],
                                 [3, 10, 7, 12]])
def test_ring_fingerprint_and_owners_match(ids):
    mine, ref = RingMap.static(ids), RefRing.static(ids)
    assert mine.fingerprint == ref.fingerprint
    assert mine.to_dict() == ref.to_dict()
    rng = np.random.default_rng(len(ids))
    for _ in range(50):
        d = rng.bytes(32).hex()
        for rf in (1, 2, 3):
            assert mine.owners(d, rf) == ref.owners(d, rf)
        assert mine.handoff_order([ids[-1]]) == ref.handoff_order([ids[-1]])
        assert placement.replica_set(d, sorted(ids), 2) \
            == ref_placement.replica_set(d, sorted(ids), 2)
    for pinned in ([ids[0]], [ids[-1], ids[0]]):
        assert placement.handoff_order(pinned, sorted(ids)) \
            == ref_placement.handoff_order(pinned, sorted(ids))


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_data_root_with_deltas_opens_in_the_other_package(tmp_path, writer):
    """A node store whose similarity plane wrote deltas (a chain of
    generations, each a small edit of the last) opens in the other
    package's NodeStore without a plane: the same digests, every chunk
    reconstructed byte-identical, the base pins honoured, and GC of the
    other package keeps a live delta's base chain."""
    from dfs_tpu.config import SimConfig as RefSimConfig
    from dfs_tpu.meta.manifest import ChunkRef as RefChunkRef
    from dfs_tpu.meta.manifest import Manifest as RefManifest
    from dfs_tpu.sim import SimPlane as RefSimPlane
    from dfs_tpu.store.cas import NodeStore as RefNodeStore

    from dfs_tpu_torch.config import SimConfig
    from dfs_tpu_torch.meta.manifest import ChunkRef, Manifest
    from dfs_tpu_torch.sim import SimPlane
    from dfs_tpu_torch.store.cas import NodeStore

    if writer == "reference":
        w = RefNodeStore(tmp_path, node_id=1)
        w.chunks.sim = RefSimPlane(RefSimConfig(enabled=True,
                                                min_chunk_bytes=64),
                                   w.root / "sim")
        r_cls, mk, cref = NodeStore, Manifest, ChunkRef
    else:
        w = NodeStore(tmp_path, node_id=1)
        w.chunks.sim = SimPlane(SimConfig(enabled=True, min_chunk_bytes=64),
                                w.root / "sim", device="cpu")
        r_cls, mk, cref = RefNodeStore, RefManifest, RefChunkRef
    gens = [corpus(16_384, seed=40)]
    for i in range(3):
        g = bytearray(gens[-1])
        g[1000 + 3000 * i:1004 + 3000 * i] = b"EDIT"
        gens.append(bytes(g))
    digests = [hashlib.sha256(g).hexdigest() for g in gens]
    for d, g in zip(digests, gens):
        assert w.chunks.put(d, g)
    assert w.chunks.delta_count() >= 2
    w.chunks.sim.close()
    assert (w.root / "chunks" / "deltas").is_dir()
    assert (w.root / "sim" / "bands.log").is_file()

    r = r_cls(tmp_path, node_id=1)
    assert sorted(r.chunks.digests()) == sorted(digests)
    for d, g in zip(digests, gens):
        assert r.chunks.get(d) == g and r.chunks.has(d)
        assert r.chunks.delta_base(d) == w.chunks.delta_base(d)
    base = digests[0]
    assert r.chunks.delta_pinned(base) and r.chunks.delete(base) is False
    # the newest generation alone stays referenced: GC keeps its chain
    last = gens[-1]
    r.manifests.save(mk(file_id=hashlib.sha256(last).hexdigest(),
                        name="g", size=len(last), fragmenter="fixed",
                        chunks=(cref(index=0, offset=0, length=len(last),
                                     digest=digests[-1]),)))
    chain = {digests[-1]}
    cur = digests[-1]
    while (nb := r.chunks.delta_base(cur)) is not None:
        chain.add(nb)
        cur = nb
    assert sorted(r.gc(min_age_s=0.0)) == sorted(set(digests) - chain)
    assert r.chunks.get(digests[-1]) == last


def test_expired_wire_deadline_is_dropped_both_ways(tmp_path):
    """A frame whose ``deadline`` field says the budget is gone, sent by
    dfs_tpu's RPC client to a port node and by the port's client to a
    dfs_tpu node, is dropped at the receiver's dispatch and counted in
    its ``deadline_drops``; a live budget is served."""
    from dfs_tpu.comm.rpc import RpcRemoteError as RefRemoteError

    from dfs_tpu_torch.comm.rpc import RpcRemoteError

    ports = _free_ports(4)
    addrs = [(i + 1, ports[2 * i], ports[2 * i + 1]) for i in range(2)]
    ref_cluster = RefCluster(peers=tuple(
        RefPeer(node_id=i, host="127.0.0.1", port=p, internal_port=q)
        for i, p, q in addrs), replication_factor=2)
    cluster = ClusterConfig(peers=tuple(
        PeerAddr(node_id=i, host="127.0.0.1", port=p, internal_port=q)
        for i, p, q in addrs), replication_factor=2)

    async def go():
        ref = RefServer(RefNodeConfig(
            node_id=1, cluster=ref_cluster, data_root=tmp_path,
            fragmenter="cdc-anchored", cdc=RefCDC(**SIZES),
            health_probe_s=0))
        port = StorageNodeServer(NodeConfig(
            node_id=2, cluster=cluster, data_root=tmp_path,
            cdc=CDCParams(**SIZES), health_probe_s=0, device="cpu"))
        for n in (ref, port):
            await n.start()
        try:
            for client, peer, node, err in (
                    (ref.client, ref_cluster.peer(2), port,
                     RefRemoteError),
                    (port.client, cluster.peer(1), ref, RpcRemoteError)):
                for budget in (0.0, -2.5):
                    with pytest.raises(err, match="deadline expired"):
                        await client.call(peer, {"op": "get_chunk",
                                                 "digest": "0" * 64,
                                                 "deadline": budget})
                resp, _ = await client.call(peer, {"op": "health",
                                                   "deadline": 30.0})
                assert resp["ok"]
                assert node.counters.snapshot()["deadline_drops"] == 2
        finally:
            for n in (ref, port):
                await n.stop()

    asyncio.run(asyncio.wait_for(go(), timeout=60))


def test_serve_counters_match_on_one_data_root(tmp_path):
    """The same read sequence over HTTP on one data root, first by a
    dfs_tpu node, then by a port node, each with the same
    ServeConfig(cache_bytes=...) smaller than the file: equal /metrics
    serve.cache and serve.flight counters."""
    from dfs_tpu.config import ServeConfig as RefServeConfig

    from dfs_tpu_torch.config import ServeConfig

    body = corpus(60_000, seed=21)
    budget = 24 * 1024

    def cluster_of(kind):
        p, q = _free_ports(2)
        if kind == "ref":
            return RefCluster(peers=(RefPeer(node_id=1, host="127.0.0.1",
                                             port=p, internal_port=q),),
                              replication_factor=1)
        return ClusterConfig(peers=(PeerAddr(node_id=1, host="127.0.0.1",
                                             port=p, internal_port=q),),
                             replication_factor=1)

    async def reads(node, port, fid):
        c = (RefClient if isinstance(node, RefServer) else NodeClient)(
            port=port, timeout_s=30)
        assert await asyncio.to_thread(c.download, fid) == body
        assert await asyncio.to_thread(c.download, fid) == body
        def get(path, headers=None):
            req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                         headers=headers or {})
            with urllib.request.urlopen(req, timeout=30) as r:
                return r.status, r.read()

        for lo, hi in ((0, 999), (30_000, 45_000), (0, 999)):
            st, part = await asyncio.to_thread(
                get, f"/download?fileId={fid}",
                {"Range": f"bytes={lo}-{hi}"})
            assert st == 206 and part == body[lo:hi + 1]
        assert await asyncio.to_thread(c.download, fid) == body
        return json.loads((await asyncio.to_thread(get, "/metrics"))[1])[
            "serve"]

    async def go():
        rc = cluster_of("ref")
        ref = RefServer(RefNodeConfig(
            node_id=1, cluster=rc, data_root=tmp_path,
            fragmenter="cdc-anchored", cdc=RefCDC(**SIZES),
            health_probe_s=0, serve=RefServeConfig(cache_bytes=budget)))
        await ref.start()
        try:
            fid = (await asyncio.to_thread(
                RefClient(port=rc.peers[0].port, timeout_s=30).upload,
                body, "s.bin"))["fileId"]
            want = await reads(ref, rc.peers[0].port, fid)
        finally:
            await ref.stop()
        pc = cluster_of("port")
        port = StorageNodeServer(NodeConfig(
            node_id=1, cluster=pc, data_root=tmp_path,
            cdc=CDCParams(**SIZES), health_probe_s=0, device="cpu",
            serve=ServeConfig(cache_bytes=budget)))
        await port.start()
        try:
            got = await reads(port, pc.peers[0].port, fid)
        finally:
            await port.stop()
        assert want["cache"]["evictions"] > 0 and want["cache"]["hits"] > 0

        def counters(s):
            cache = {k: v for k, v in s["cache"].items()
                     if k != "temperature"}
            hot = sorted((e["digest"], e["hits"], e["bytes"])
                         for e in s["cache"]["temperature"])
            return cache, hot, s["flight"]

        assert counters(got) == counters(want)

    asyncio.run(asyncio.wait_for(go(), timeout=60))


def _mixed(n, tmp_path, ref_kw, port_kw, ref_ids=(1,)):
    """dfs_tpu nodes at ``ref_ids``, port nodes elsewhere, one cluster
    over ``n`` localhost nodes (rf 2, or 1 for a single node)."""
    ports = _free_ports(2 * n)
    addrs = [(i + 1, ports[2 * i], ports[2 * i + 1]) for i in range(n)]
    ref_cluster = RefCluster(peers=tuple(
        RefPeer(node_id=i, host="127.0.0.1", port=p, internal_port=q)
        for i, p, q in addrs), replication_factor=min(2, n))
    cluster = ClusterConfig(peers=tuple(
        PeerAddr(node_id=i, host="127.0.0.1", port=p, internal_port=q)
        for i, p, q in addrs), replication_factor=min(2, n))
    nodes = {}
    for i, _, _ in addrs:
        if i in ref_ids:
            nodes[i] = RefServer(RefNodeConfig(
                node_id=i, cluster=ref_cluster, data_root=tmp_path,
                fragmenter="cdc-anchored", cdc=RefCDC(**SIZES),
                health_probe_s=0, **ref_kw))
        else:
            nodes[i] = StorageNodeServer(NodeConfig(
                node_id=i, cluster=cluster, data_root=tmp_path,
                cdc=CDCParams(**SIZES), health_probe_s=0, device="cpu",
                **port_kw))
    return nodes


def _ref_index(**kw):
    from dfs_tpu.config import IndexConfig as RefIndexConfig

    return RefIndexConfig(enabled=True, filter_sync_s=0, **kw)


def _index(**kw):
    from dfs_tpu_torch.config import IndexConfig

    return IndexConfig(enabled=True, filter_sync_s=0, **kw)


def test_mixed_cluster_index_gossip_and_probe_skip(tmp_path):
    """One dfs_tpu node and two port nodes, all with the index plane:
    every node replicates both kinds' filters (get_filter, then
    filter_delta), a re-upload through either kind moves nothing and
    skips the probe round, fresh data through either kind skips probe
    RPCs altogether, and get_filters answers the same table from either
    kind."""
    nodes = _mixed(3, tmp_path, {"index": _ref_index()},
                   {"index": _index()})
    a, b = corpus(40_000, seed=51), corpus(35_000, seed=52)

    async def go():
        for n in nodes.values():
            await n.start()
        ref, p2 = nodes[1], nodes[2]
        try:
            ma, sa = await ref.upload(a, "a.bin")
            mb, sb = await p2.upload(b, "b.bin")
            for _ in range(2):             # a full sync, then deltas
                for n in nodes.values():
                    assert await n._filter_sync_once() == 2
            assert p2.index.peer_filters.deltas >= 2
            assert ref.index.peer_filters.deltas >= 2
            for node, body, first in ((p2, a, sa), (ref, b, sb)):
                _, st = await node.upload(body, "again.bin")
                assert st["transferredBytes"] == 0
                assert st["dedupSkippedBytes"] >= first["transferredBytes"]
                ix = node.index_stats()
                assert ix["filterTrusted"] > 0 and ix["filterFp"] == 0
            for i, node in ((7, p2), (8, ref)):
                skipped = node.index_stats()["probeRpcsSkipped"]
                await node.upload(corpus(20_000, seed=50 + i), "new.bin")
                assert node.index_stats()["probeRpcsSkipped"] > skipped
            tables = []
            for client, peer in ((p2.client, ref.cfg.cluster.peer(3)),
                                 (ref.client, p2.cfg.cluster.peer(3))):
                got = await client.get_filters(peer)
                tables.append([(m["nodeId"], m["gen"], m["version"],
                                bytes(blob)) for m, blob in got])
            assert [t[0] for t in tables[0]] == [3, 1, 2]
            assert tables[0] == tables[1]
            for n in nodes.values():
                _, body = await n.download(mb.file_id)
                assert bytes(body) == b
        finally:
            for n in nodes.values():
                await n.stop()

    asyncio.run(asyncio.wait_for(go(), timeout=60))


@pytest.mark.parametrize("writer", ["port", "dfs_tpu"])
def test_index_and_ledger_open_in_the_other_package(tmp_path, writer):
    """A node with the index and tiering planes writes ``index/`` and
    ``tier/ledger.json``; the other package's node opens the same data
    root without a rebuild, with the same present set and ledger."""
    from dfs_tpu.config import TierConfig as RefTierConfig

    from dfs_tpu_torch.config import TierConfig

    body = corpus(40_000, seed=53)
    kinds = {"dfs_tpu": (1,), "port": ()}

    def node_of(kind):
        return _mixed(1, tmp_path,
                      {"index": _ref_index(memtable_entries=256),
                       "tier": RefTierConfig(enabled=True)},
                      {"index": _index(memtable_entries=256),
                       "tier": TierConfig(enabled=True)},
                      ref_ids=kinds[kind])[1]

    async def go():
        first = node_of(writer)
        await first.start()
        try:
            m, _ = await first.upload(body, "f.bin")
            _, got = await first.download(m.file_id)
            assert bytes(got) == body
            want_present = sorted(first.index.lsi.present_digests())
            assert len(first.tier.ledger) == len(m.chunks)
        finally:
            await first.stop()
        # the snapshot written at stop, as the second package reads it
        want_ledger = json.loads((tmp_path / "node-1" / "tier"
                                  / "ledger.json").read_bytes())["entries"]
        assert len(want_ledger) == len(m.chunks)
        second = node_of("dfs_tpu" if writer == "port" else "port")
        await second.start()
        try:
            assert second.index.lsi.stats()["rebuilds"] == 0
            assert sorted(second.index.lsi.present_digests()) \
                == want_present
            assert {d.hex() for d in want_present} \
                == set(second.store.chunks.digests())
            assert second.tier.ledger._map == want_ledger
            _, got = await second.download(m.file_id)
            assert bytes(got) == body
        finally:
            await second.stop()

    asyncio.run(asyncio.wait_for(go(), timeout=60))


@pytest.mark.parametrize("demoter", ["dfs_tpu", "port"])
def test_file_demoted_by_one_kind_reads_and_promotes_on_the_other(
        tmp_path, demoter):
    """A mixed 3-node cluster with tiering at k = 1: a scan on one kind
    demotes the cold file (both kinds agree on the cold manifest); the
    other kind reads it back and, read past promote_reads, promotes it."""
    from dfs_tpu.config import TierConfig as RefTierConfig

    from dfs_tpu_torch.config import TierConfig

    knobs = dict(enabled=True, hot_fraction=0.5, min_idle_s=0.0, ec_k=1,
                 half_life_s=86400.0, promote_reads=2.0)
    nodes = _mixed(3, tmp_path, {"tier": RefTierConfig(**knobs)},
                   {"tier": TierConfig(**knobs)})
    hot, cold = corpus(30_000, seed=54), corpus(30_000, seed=55)
    scanner, reader = (nodes[1], nodes[2]) if demoter == "dfs_tpu" \
        else (nodes[2], nodes[1])

    async def go():
        for n in nodes.values():
            await n.start()
        try:
            hm, _ = await scanner.upload(hot, "hot.bin")
            cm, _ = await scanner.upload(cold, "cold.bin")
            for _ in range(2):
                _, got = await scanner.download(hm.file_id)
            out = await scanner.tier_scan_once()
            assert out["demoted"] == 1, out
            docs = {n.store.manifests.load(cm.file_id).to_json()
                    for n in nodes.values()}
            assert len(docs) == 1 and '"tier":"cold"' in docs.pop()
            # the check precedes a read's own feed and the heat decays:
            # the fourth read of the file crosses promote_reads = 2
            for _ in range(4):
                _, got = await reader.download(cm.file_id)
                assert bytes(got) == cold
            for _ in range(200):
                m = reader.store.manifests.load(cm.file_id)
                if m.tier is None and not reader._tier_promoting:
                    break
                await asyncio.sleep(0.05)
            assert reader.store.manifests.load(cm.file_id).tier is None
            assert reader.tier_stats()["promotedFiles"] == 1
            for n in nodes.values():
                _, got = await n.download(cm.file_id)
                assert bytes(got) == cold
        finally:
            for n in nodes.values():
                await n.stop()

    asyncio.run(asyncio.wait_for(go(), timeout=60))


def _mixed_ring_cluster(tmp_path, n=4):
    """Node 1 of dfs_tpu and port nodes 2..n, rf 2, a hashed ring over
    1-3 (node 4 a standby), credits off, census sampler off."""
    from dfs_tpu.config import CensusConfig as RefCensus
    from dfs_tpu.config import RingConfig as RefRingConfig

    from dfs_tpu_torch.config import CensusConfig, RingConfig

    ports = _free_ports(2 * n)
    addrs = [(i + 1, ports[2 * i], ports[2 * i + 1]) for i in range(n)]
    ref = RefServer(RefNodeConfig(
        node_id=1, cluster=RefCluster(peers=tuple(
            RefPeer(node_id=i, host="127.0.0.1", port=p, internal_port=q)
            for i, p, q in addrs), replication_factor=2),
        data_root=tmp_path, fragmenter="cdc-anchored", cdc=RefCDC(**SIZES),
        health_probe_s=0, census=RefCensus(history_interval_s=0),
        ring=RefRingConfig(vnodes=64, members="1,2,3",
                           rebalance_credit_bytes=0)))
    cluster = ClusterConfig(peers=tuple(
        PeerAddr(node_id=i, host="127.0.0.1", port=p, internal_port=q)
        for i, p, q in addrs), replication_factor=2)
    nodes = {1: ref}
    for i in range(2, n + 1):
        nodes[i] = StorageNodeServer(NodeConfig(
            node_id=i, cluster=cluster, data_root=tmp_path,
            cdc=CDCParams(**SIZES), health_probe_s=0, device="cpu",
            census=CensusConfig(history_interval_s=0),
            ring=RingConfig(vnodes=64, members="1,2,3",
                            rebalance_credit_bytes=0)))
    return nodes, addrs


async def _mixed_converge(nodes, timeout=30.0):
    import time as _time

    end = _time.monotonic() + timeout
    while _time.monotonic() < end:
        for n in nodes.values():
            await n.repair_once()
        if not any(n.ring.migrating for n in nodes.values()):
            return
    raise AssertionError({i: n.ring.rebalance_stats()
                          for i, n in nodes.items()})


def _post_ring(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/ring",
                                 data=json.dumps(body).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _get_json(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return json.loads(r.read())


def test_mixed_cluster_membership_change_both_ways(tmp_path):
    """A ``POST /ring add`` at the dfs_tpu node is adopted by every port
    node and the cluster rebalances; a ``drain`` at a port node is adopted
    by the dfs_tpu node; after each, every node holds one epoch and one
    fingerprint, every file reads identical from every node, and the
    census is clean from a coordinator of either kind."""
    nodes, addrs = _mixed_ring_cluster(tmp_path)
    files = [corpus(30_000, seed=60 + i) for i in range(3)]

    async def http(fn, *args):
        return await asyncio.to_thread(fn, *args)

    async def one_view(epoch):
        fps = {n.ring.current.fingerprint for n in nodes.values()}
        assert len(fps) == 1
        assert {n.ring.epoch for n in nodes.values()} == {epoch}

    async def clean(coord):
        rep = await http(_get_json, addrs[coord - 1][1], "/census")
        for k in ("underReplicatedTotal", "overReplicatedTotal",
                  "orphanedTotal", "inFlightTotal", "peersFailed"):
            assert rep[k] == 0, (coord, k, rep)

    async def go():
        for n in nodes.values():
            await n.start()
        try:
            await asyncio.sleep(0.05)
            ids = []
            for i, body in enumerate(files):
                c = NodeClient(port=addrs[i % 3][1], timeout_s=30)
                ids.append((await http(c.upload, body, f"m{i}"))["fileId"])
            out = await http(_post_ring, addrs[0][1],
                             {"action": "add", "nodeId": 4, "weight": 1.0})
            assert out["epoch"] == 1 and all(out["pushed"].values())
            await _mixed_converge(nodes)
            await one_view(1)
            assert nodes[4].store.chunks.count() > 0
            for nid, _, port in addrs:
                c = NodeClient(port=addrs[nid - 1][1], timeout_s=30)
                for fid, body in zip(ids, files):
                    assert await http(c.download, fid) == body
            await clean(2)       # a port coordinator
            await clean(1)       # the dfs_tpu coordinator
            out = await http(_post_ring, addrs[2][1],
                             {"action": "drain", "nodeId": 4})
            assert out["epoch"] == 2 and all(out["pushed"].values())
            await _mixed_converge(nodes)
            for n in nodes.values():
                await n.repair_once()
            await one_view(2)
            assert nodes[4].store.chunks.count() == 0
            await clean(1)
            await clean(3)
            for fid, body in zip(ids, files):
                c = NodeClient(port=addrs[0][1], timeout_s=30)
                assert await http(c.download, fid) == body
        finally:
            for n in nodes.values():
                await n.stop()

    asyncio.run(asyncio.wait_for(go(), timeout=120))


def test_mixed_cluster_stale_side_converges_on_first_placement(tmp_path):
    """An epoch installed on one node only (no push) spreads through the
    placement-bearing RPCs either way: a port node's upload teaches the
    dfs_tpu node, and the dfs_tpu node's upload teaches the port nodes."""
    nodes, addrs = _mixed_ring_cluster(tmp_path, n=3)

    async def go():
        for n in nodes.values():
            await n.start()
        try:
            await asyncio.sleep(0.05)
            for n in nodes.values():
                n.ring.on_change = None
            for epoch, first in ((1, 2), (2, 1)):
                src = nodes[first]
                w = {1: 1.0, 2: 1.0, 3: 1.0 - 0.25 * epoch}
                src.ring.install(src.ring.propose_next(w), source="test")
                body = corpus(20_000, seed=70 + epoch)
                m, _ = await src.upload(body, f"s{epoch}")
                assert {n.ring.epoch for n in nodes.values()} == {epoch}
                assert len({n.ring.current.fingerprint
                            for n in nodes.values()}) == 1
                for n in nodes.values():
                    assert bytes((await n.download(m.file_id))[1]) == body
        finally:
            for n in nodes.values():
                await n.stop()

    asyncio.run(asyncio.wait_for(go(), timeout=60))


@pytest.mark.parametrize("client", ["dfs_tpu", "port"])
@pytest.mark.parametrize("ref_ids", [(), (1, 2, 3), (1,)],
                         ids=["port_cluster", "dfs_tpu_cluster", "mixed"])
def test_smart_clients_cross_both_ways(tmp_path, client, ref_ids):
    """A smart upload at node 1 commits through that node's kind, a second
    client at node 2 re-uploads through the filters without sending a
    byte, every node's legacy read and the smart read give the same bytes,
    and the committed table is the oracle's; the legacy upload's file
    reads back through the smart path too."""
    from dfs_tpu.client import SmartClient as RefSmart
    from dfs_tpu.config import ClientConfig as RefClientConfig

    from dfs_tpu_torch.client import SmartClient
    from dfs_tpu_torch.config import ClientConfig

    nodes = _mixed(3, tmp_path, {"index": _ref_index()},
                   {"index": _index()}, ref_ids=ref_ids)
    body, plain = corpus(60_000, seed=81), corpus(30_000, seed=82)

    def make(nid):
        port = nodes[nid].cfg.cluster.peer(nid).port
        if client == "dfs_tpu":
            return RefSmart(port=port, cfg=RefClientConfig(fallback=False))
        return SmartClient(port=port, cfg=ClientConfig(fallback=False),
                           device="cpu")

    async def go():
        for n in nodes.values():
            await n.start()
        try:
            c1 = make(1)
            info = await asyncio.to_thread(c1.upload, body, "s.bin")
            assert info["dataPlane"] == "smart"
            assert info["fileId"] == hashlib.sha256(body).hexdigest()
            assert c1.counters["transferredBytes"] == 2 * len(body)
            for n in nodes.values():
                await n._filter_sync_once()
            c2 = make(2)
            again = await asyncio.to_thread(c2.upload, body, "s2.bin")
            assert again["fileId"] == info["fileId"]
            assert c2.counters["transferredBytes"] == 0
            want = chunk_file_anchored_np(np.frombuffer(body, np.uint8),
                                          _anchored_params(CDCParams(**SIZES)))
            for nid, n in nodes.items():
                doc = json.loads(n.store.manifests.load(
                    info["fileId"]).to_json())
                assert [(x["offset"], x["length"], x["digest"])
                        for x in doc["chunks"]] == want
                _, got = await n.download(info["fileId"])
                assert bytes(got) == body
            assert await asyncio.to_thread(c2.download,
                                           info["fileId"]) == body
            m, _ = await nodes[3].upload(plain, "plain.bin")
            assert await asyncio.to_thread(c1.download, m.file_id) == plain
            assert c1.counters["smartDownloads"] == 1
            assert c1.counters["fallbacks"] == c2.counters["fallbacks"] == 0
        finally:
            for n in nodes.values():
                await n.stop()

    asyncio.run(asyncio.wait_for(go(), timeout=60))
