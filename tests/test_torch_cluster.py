"""A 3-node cluster of the port (dfs_tpu_torch.node.runtime), rf 2, on the
CPU: each node a real asyncio server pair on localhost ports in this
process, driven over HTTP. Chunk tables are held against the port's NumPy
oracle and dfs_tpu's, placement against the ring, and the failure paths
(handoff, quorum, tombstones) against what dfs_tpu's runtime does."""

import asyncio
import hashlib
import os
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from dfs_tpu.ops.cdc_anchored import chunk_file_anchored_np as ref_oracle
from dfs_tpu.fragmenter.base import _anchored_params as ref_params

from dfs_tpu_torch.cli.client import NodeClient
from dfs_tpu_torch.config import (CDCParams, ClusterConfig, NodeConfig,
                                  PeerAddr)
from dfs_tpu_torch.fragmenter.base import _anchored_params
from dfs_tpu_torch.fragmenter.cdc_anchored import AnchoredCudaFragmenter
from dfs_tpu_torch.node.placement import replica_set
from dfs_tpu_torch.node.runtime import StorageNodeServer
from dfs_tpu_torch.ops.cdc_anchored import (AnchoredCdcParams,
                                            chunk_file_anchored_np)
from dfs_tpu_torch.ops.cdc_v2 import AlignedCdcParams

ROOT = Path(__file__).resolve().parent.parent
CDC = CDCParams(min_size=64, avg_size=256, max_size=1024)
# the chain's own geometry for the test that runs it on the CPU
SMALL = AnchoredCdcParams(
    chunk=AlignedCdcParams(min_blocks=2, avg_blocks=4, max_blocks=16,
                           strip_blocks=64),
    seg_min=2048, seg_max=4096, seg_mask=2047)


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


def make_cluster(n=3, rf=2):
    ports = _free_ports(2 * n)
    return ClusterConfig(peers=tuple(
        PeerAddr(node_id=i + 1, host="127.0.0.1", port=ports[2 * i],
                 internal_port=ports[2 * i + 1]) for i in range(n)),
        replication_factor=rf)


def node_cfg(cluster, root, node_id):
    return NodeConfig(node_id=node_id, cluster=cluster, data_root=root,
                      cdc=CDC, health_probe_s=0, device="cpu")


async def start_nodes(cluster, root, ids=None):
    nodes = {}
    for p in cluster.peers:
        if ids is None or p.node_id in ids:
            n = StorageNodeServer(node_cfg(cluster, root, p.node_id))
            await n.start()
            nodes[p.node_id] = n
    return nodes


async def stop_nodes(nodes):
    for n in nodes.values():
        await n.stop()


def client(cluster, node_id):
    return NodeClient(port=cluster.peer(node_id).port, timeout_s=30)


async def http(fn, *args, **kw):
    """A blocking NodeClient call, off the loop the nodes serve on."""
    return await asyncio.to_thread(fn, *args, **kw)


def table(manifest_doc):
    return [(c["offset"], c["length"], c["digest"])
            for c in manifest_doc["chunks"]]


def holders(root, cluster, digest):
    return {p.node_id for p in cluster.peers
            if (root / f"node-{p.node_id}" / "chunks" / digest[:2]
                / digest).is_file()}


def owners(cluster, digest):
    return set(replica_set(digest, cluster.sorted_ids(),
                           cluster.replication_factor))


def run(coro):
    asyncio.run(asyncio.wait_for(coro, timeout=60))


@pytest.mark.parametrize("mode", ["plain", "chunked"])
def test_upload_download_every_node_and_placement(tmp_path, mode):
    body = corpus(60_000, seed=1)
    cluster = make_cluster()

    async def go():
        nodes = await start_nodes(cluster, tmp_path)
        try:
            c1 = client(cluster, 1)
            if mode == "plain":
                info = await http(c1.upload, body, "blob.bin")
            else:
                blocks = [body[i:i + 7000]
                          for i in range(0, len(body), 7000)]
                info = await http(c1.upload_stream, blocks, "blob.bin")
            fid = info["fileId"]
            assert fid == hashlib.sha256(body).hexdigest()
            assert info["minCopies"] == 2 and not info["degraded"]
            doc = await http(client(cluster, 2).manifest, fid)
            got = table(doc)
            # the port's oracle and dfs_tpu's agree with the upload
            assert got == chunk_file_anchored_np(
                np.frombuffer(body, np.uint8), _anchored_params(CDC))
            assert got == [tuple(t) for t in ref_oracle(
                np.frombuffer(body, np.uint8), ref_params(CDC))]
            for nid in (1, 2, 3):
                assert await http(client(cluster, nid).download,
                                  fid) == body
            for _, _, d in got:
                assert holders(tmp_path, cluster, d) == owners(cluster, d)
            again = await http(client(cluster, 3).upload, body, "b.bin")
            assert again["transferredBytes"] == 0
            assert again["dedupSkippedBytes"] > 0
            m = await http(c1.metrics)
            assert m["frag"]["device"] == "cpu"
            assert m["durability"] == {"mode": "fsync",
                                       "fsyncs": m["durability"]["fsyncs"]}
            assert m["durability"]["fsyncs"] > 0
            assert m["ring"]["mode"] == "static"
        finally:
            await stop_nodes(nodes)

    run(go())


def test_handoff_while_an_owner_is_down_then_repair(tmp_path):
    body = corpus(40_000, seed=2)
    cluster = make_cluster()

    async def go():
        nodes = await start_nodes(cluster, tmp_path, ids={1, 2})
        try:
            info = await http(client(cluster, 1).upload, body, "h.bin")
            fid = info["fileId"]
            assert info["handoffChunks"] > 0 and info["degraded"]
            assert info["minCopies"] >= 2
            nodes.update(await start_nodes(cluster, tmp_path, ids={3}))
            for _ in range(2):          # pushes, then the relocations
                for nid in (1, 2, 3):
                    await nodes[nid].repair_once()
            m = nodes[1].store.manifests.load(fid)
            for c in m.chunks:
                assert holders(tmp_path, cluster, c.digest) \
                    == owners(cluster, c.digest)
            assert nodes[3].store.manifests.load(fid) is not None
            assert await http(client(cluster, 3).download, fid) == body
        finally:
            await stop_nodes(nodes)

    run(go())


def test_upload_below_quorum_fails_and_leaves_no_manifest(tmp_path):
    body = corpus(30_000, seed=3)
    cluster = make_cluster()

    async def go():
        nodes = await start_nodes(cluster, tmp_path, ids={1})
        try:
            with pytest.raises(RuntimeError, match="HTTP 500"):
                await http(client(cluster, 1).upload, body, "q.bin")
            assert nodes[1].store.manifests.ids() == []
            assert await http(client(cluster, 1).list_files) == []
        finally:
            await stop_nodes(nodes)

    run(go())


def test_delete_converges_through_tombstones(tmp_path):
    body = corpus(30_000, seed=4)
    cluster = make_cluster()

    async def go():
        nodes = await start_nodes(cluster, tmp_path)
        try:
            fid = (await http(client(cluster, 1).upload, body,
                              "d.bin"))["fileId"]
            await nodes.pop(3).stop()           # sleeps through the delete
            assert await http(client(cluster, 1).delete, fid) == "Deleted"
            for nid in (1, 2):
                with pytest.raises(RuntimeError, match="HTTP 404"):
                    await http(client(cluster, nid).download, fid)
            nodes.update(await start_nodes(cluster, tmp_path, ids={3}))
            assert nodes[3].store.manifests.load(fid) is not None
            await nodes[3].repair_once()
            assert nodes[3].store.manifests.is_tombstoned(fid)
            with pytest.raises(RuntimeError, match="HTTP 404"):
                await http(client(cluster, 3).download, fid)
            for nid in (1, 2, 3):
                assert nodes[nid].store.chunks.digests() == []
            # a fresh upload of the same bytes resurrects the file id
            again = await http(client(cluster, 2).upload, body, "d.bin")
            assert again["fileId"] == fid
            assert await http(client(cluster, 3).download, fid) == body
        finally:
            await stop_nodes(nodes)

    run(go())


def _raw(port, method, path, headers=None, body=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _no_length_post(port):
    """POST /upload with neither Content-Length nor chunked framing."""
    with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
        s.sendall(b"POST /upload?name=x HTTP/1.1\r\nHost: x\r\n\r\n")
        return int(s.recv(4096).split(b" ", 2)[1])


def test_http_ranges_and_error_probes(tmp_path):
    body = corpus(50_000, seed=5)
    cluster = make_cluster()
    name = "my café.txt"

    async def go():
        nodes = await start_nodes(cluster, tmp_path)
        try:
            port = cluster.peer(2).port
            st, _, out = await http(
                _raw, port, "POST", "/upload?name=my%20caf%C3%A9.txt",
                body=body)
            assert st == 201
            fid = __import__("json").loads(out)["fileId"]
            dl = f"/download?fileId={fid}"
            cases = [
                ("GET", dl, {"Range": "bytes=1000-1999"}, 206,
                 body[1000:2000], f"bytes 1000-1999/{len(body)}"),
                ("GET", dl, {"Range": "bytes=-50"}, 206, body[-50:],
                 f"bytes {len(body) - 50}-{len(body) - 1}/{len(body)}"),
                ("GET", dl, {"Range": "bytes=49990-"}, 206, body[49990:],
                 None),
                ("GET", dl, {"Range": "bytes=9999999-"}, 416, b"",
                 f"bytes */{len(body)}"),
                ("GET", dl, {"Range": "bytes=5-2"}, 200, body, None),
                ("GET", dl, {"Range": "bytes=1-2,5-6"}, 400, None, None),
                ("GET", "/download", None, 400, None, None),
                ("GET", "/download?fileId=nothex", None, 400, None, None),
                ("GET", "/download?fileId=" + "0" * 64, None, 404, None,
                 None),
                ("GET", "/manifest?fileId=" + "0" * 64, None, 404, None,
                 None),
                ("POST", "/upload?ec=2", {"Content-Length": "1"}, 400,
                 None, None),
                ("GET", "/metrics?format=prom", None, 200, None, None),
                ("GET", "/trace?traceId=nothex", None, 400, None, None),
                ("GET", "/chaos", None, 404, None, None),
                ("GET", "/census", None, 200, None, None),
                ("GET", "/doctor", None, 200, None, None),
                ("DELETE", "/files?fileId=" + "0" * 64, None, 404, None,
                 None),
            ]
            for method, path, hdrs, want, payload, crange in cases:
                st, h, out = await http(
                    _raw, port if method != "POST" else cluster.peer(1).port,
                    method, path, hdrs, b"x" if method == "POST" else None)
                assert st == want, (method, path, hdrs, st, out[:200])
                if payload is not None:
                    assert out == payload, (path, hdrs)
                if crange is not None:
                    assert h["Content-Range"] == crange
            st, h, out = await http(_raw, cluster.peer(3).port, "GET", dl)
            assert st == 200 and out == body
            assert name.encode("utf-8").decode("latin-1") \
                in h["Content-Disposition"]
            assert await asyncio.to_thread(_no_length_post, port) == 411
            st, _, out = await http(_raw, port, "POST", "/scrub", None, b"")
            assert st == 200 and b'"corrupt": 0' in out
            st, _, out = await http(_raw, port, "POST", "/repair", None, b"")
            assert st == 200 and b'"repaired": 0' in out
        finally:
            await stop_nodes(nodes)

    run(go())


def test_concurrent_uploads_through_the_chain_on_one_fragmenter(tmp_path):
    """Two uploads chunked at once by one node's fragmenter, each in its
    own worker thread (the card's case, on the plain versions)."""
    bodies = [corpus(40_000, seed=s) for s in (6, 7)]
    cluster = make_cluster()

    async def go():
        nodes = await start_nodes(cluster, tmp_path)
        try:
            nodes[1].fragmenter = AnchoredCudaFragmenter(
                SMALL, region_bytes=16384, cpu_cutoff=0, lane_multiple=8,
                device="cpu")
            c1 = client(cluster, 1)
            infos = await asyncio.gather(
                http(c1.upload, bodies[0], "a.bin"),
                http(c1.upload_stream,
                     [bodies[1][i:i + 8192]
                      for i in range(0, len(bodies[1]), 8192)], "b.bin"))
            for body, info in zip(bodies, infos):
                assert info["fileId"] == hashlib.sha256(body).hexdigest()
                doc = await http(c1.manifest, info["fileId"])
                assert table(doc) == chunk_file_anchored_np(
                    np.frombuffer(body, np.uint8), SMALL)
                assert await http(client(cluster, 3).download,
                                  info["fileId"]) == body
        finally:
            await stop_nodes(nodes)

    run(go())


def test_serve_entry_point_needs_cuda_or_device_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    ports = _free_ports(2)
    cmd = [sys.executable, "-m", "dfs_tpu_torch.cli.main", "serve",
           "--node-id", "1", "--nodes", "1", "--replication-factor", "1",
           "--base-port", str(ports[0]), "--base-internal-port",
           str(ports[1]), "--data-root", str(tmp_path / "data"),
           "--repair-interval", "0"]
    import torch

    if not torch.cuda.is_available():
        r = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                           text=True, timeout=120)
        assert r.returncode != 0
        assert "CUDA" in r.stderr
        assert not (tmp_path / "data").exists()
    proc = subprocess.Popen(cmd + ["--device", "cpu"], cwd=tmp_path,
                            env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    try:
        c = NodeClient(port=ports[0], timeout_s=5)
        deadline = time.monotonic() + 60
        while True:
            try:
                assert c.status() == "OK"
                break
            except (OSError, RuntimeError):
                assert proc.poll() is None, proc.stderr.read()
                assert time.monotonic() < deadline
                time.sleep(0.2)
        body = corpus(20_000, seed=8)
        fid = c.upload(body, "s.bin")["fileId"]
        assert c.download(fid) == body
        assert c.metrics()["frag"]["device"] == "cpu"
    finally:
        proc.kill()
        proc.wait(timeout=30)
        proc.stderr.close()
