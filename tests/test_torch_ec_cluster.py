"""Erasure-coded storage in a port cluster (dfs_tpu_torch.node.runtime) on
the CPU: in-process nodes on localhost, k=3 over 5 nodes with the tiny
chunk geometry of test_torch_cluster.py. The layout is held against
dfs_tpu's (the reference's placement, stripe grouping and NumPy parity),
and the degraded paths against what dfs_tpu's runtime does: reads with
two nodes stopped, repair of a destroyed shard by decode, handoff, the
small-cluster refusal, anti-entropy, delete and delete_chunks, and
repair's stray pass, which never deletes an EC shard."""

import hashlib
import json

import numpy as np
import pytest

from dfs_tpu.meta.manifest import ec_stripe_groups as ref_groups
from dfs_tpu.meta.manifest import Manifest as RefManifest
from dfs_tpu.node.placement import ec_shard_node as ref_shard_node
from dfs_tpu.node.runtime import ec_placement_map as ref_placement_map
from dfs_tpu.ops.ec import encode_pq_np as ref_encode

from dfs_tpu_torch.meta.manifest import (ChunkRef, EcInfo, Manifest,
                                         StripeRef)
from dfs_tpu_torch.node.runtime import (UploadError, ec_placement_map,
                                        ec_shard_items)
from dfs_tpu_torch.ring import static_ec_shard_node, static_replica_set

from tests.test_torch_cluster import (_raw, client, corpus, http,
                                      make_cluster, run, start_nodes,
                                      stop_nodes)


def holders_of(nodes, digest):
    return {i for i, n in nodes.items() if n.store.chunks.has(digest)}


def check_layout(manifest_doc, body, k, ids):
    """The manifest's EC layout against dfs_tpu's: stripes grouped by its
    rule, P/Q = sha256 of its NumPy parity over the zero-padded shards.
    Returns the reference manifest."""
    ref = RefManifest.from_json(json.dumps(manifest_doc))
    assert ref.ec is not None and ref.ec.k == k
    groups = ref_groups(ref.chunks, k)
    assert len(groups) == len(ref.ec.stripes)
    for grp, st in zip(groups, ref.ec.stripes):
        sh = np.zeros((len(grp), st.shard_len), dtype=np.uint8)
        for j, c in enumerate(grp):
            sh[j, :c.length] = np.frombuffer(
                body[c.offset:c.offset + c.length], dtype=np.uint8)
        p, q = ref_encode(sh)
        assert hashlib.sha256(p.tobytes()).hexdigest() == st.p
        assert hashlib.sha256(q.tobytes()).hexdigest() == st.q
    return ref


def test_ec_upload_layout_repair_and_two_down_read(tmp_path):
    """One 5-node cluster, one k=3 file through HTTP: the 400s, the
    layout and placement, announce and anti-entropy, delete_chunks,
    repair of a wiped node by decode, then a read with two nodes
    stopped."""
    body = corpus(40_000, seed=31)
    cluster = make_cluster(5)
    ids = cluster.sorted_ids()

    async def go():
        nodes = await start_nodes(cluster, tmp_path)
        try:
            port = cluster.peer(1).port
            for path, hdrs in (
                    ("/upload?ec=0", {"Content-Length": "1"}),
                    ("/upload?ec=x", {"Content-Length": "1"}),
                    ("/upload?ec=%C2%B2", {"Content-Length": "1"}),
                    ("/upload?ec=256", {"Content-Length": "1"}),
                    ("/upload?ec=4", {"Content-Length": "1"}),
                    ("/upload?ec=3", {"Transfer-Encoding": "chunked"})):
                st, _, out = await http(_raw, port, "POST", path, hdrs,
                                        b"1\r\nx\r\n0\r\n\r\n"
                                        if "Transfer-Encoding" in hdrs
                                        else b"x")
                assert st == 400, (path, st, out[:200])
            info = await http(client(cluster, 1).upload, body, "ec.bin", 3)
            fid = info["fileId"]
            assert fid == hashlib.sha256(body).hexdigest()
            doc = await http(client(cluster, 2).manifest, fid)
            ref = check_layout(doc, body, 3, ids)
            assert info["ecParityBytes"] == sum(
                2 * st.shard_len for st in ref.ec.stripes)
            assert info["minCopies"] == 1 and not info["degraded"]
            m = nodes[1].store.manifests.load(fid)
            # every shard on its stripe holder, the holders distinct
            pl = ec_placement_map(m, ids)
            assert dict(pl) == dict(ref_placement_map(ref, ids))
            for s, grp in enumerate(ref_groups(ref.chunks, 3)):
                hs = [ref_shard_node(fid, s, j, ids)
                      for j in range(len(grp) + 2)]
                assert len(set(hs)) == len(grp) + 2
                assert hs == [static_ec_shard_node(fid, s, j, ids)
                              for j in range(len(grp) + 2)]
            for d, _ in ec_shard_items(m):
                assert set(pl[d]) <= holders_of(nodes, d), d
            m1 = nodes[1].metrics()["frag"]["ecEncode"]
            assert m1 == {"device": "cpu", "calls": 1,
                          "stripes": len(ref.ec.stripes)}

            # announce carried the layout; anti-entropy restores it
            for n in nodes.values():
                assert n.store.manifests.load(fid).ec == m.ec
            (tmp_path / "node-5" / "manifests" / f"{fid}.json").unlink()
            assert nodes[5].store.manifests.load(fid) is None
            assert await nodes[5]._manifest_antientropy() == 1
            assert nodes[5].store.manifests.load(fid).ec == m.ec

            # delete_chunks refuses exactly the shards pinned to the node
            pinned4 = [d for d, h in pl.items() if 4 in h]
            other = next(d for d, h in pl.items() if 4 not in h)
            nodes[4].store.chunks.put(other, await nodes[1]._fetch_chunk(
                other, dict(ec_shard_items(m))[other]))
            resp, _ = await nodes[4]._dispatch(
                {"op": "delete_chunks", "digests": [pinned4[0], other]}, b"")
            assert resp["refused"] == [pinned4[0]]
            assert resp["removed"] == [other]

            # a wiped node regenerates its shards by decode
            lost = nodes[2].store.chunks.digests()
            assert lost
            for d in lost:
                nodes[2].store.chunks.delete(d)
            assert await nodes[2].repair_once() >= len(lost)
            assert all(nodes[2].store.chunks.has(d) for d in lost)
            assert nodes[2].counters.snapshot().get("ec_decodes", 0) > 0
            assert nodes[2].counters.snapshot().get("relocated_chunks",
                                                     0) == 0

            # two nodes down: a survivor reads it whole, by decode
            for i in (2, 3):
                await nodes.pop(i).stop()
            got = await http(client(cluster, 5).download, fid)
            assert got == body
            assert nodes[5].counters.snapshot().get("ec_decodes", 0) > 0
        finally:
            await stop_nodes(nodes)

    run(go())


def test_ec_delete_reclaims_parity(tmp_path):
    body = corpus(20_000, seed=32)
    cluster = make_cluster(5)

    async def go():
        nodes = await start_nodes(cluster, tmp_path)
        try:
            m, _ = await nodes[1].upload(body, "gone.bin", ec_k=3)
            parity = [st.p for st in m.ec.stripes] \
                + [st.q for st in m.ec.stripes]
            assert all(holders_of(nodes, d) for d in parity)
            assert await nodes[3].delete(m.file_id)
            for n in nodes.values():
                await n.repair_once()
            for d, _ in ec_shard_items(m):
                assert not holders_of(nodes, d), d
        finally:
            await stop_nodes(nodes)

    run(go())


def test_ec_rejects_small_cluster_and_k1_mirrors(tmp_path):
    body = corpus(10_000, seed=33)
    cluster = make_cluster(4)

    async def go():
        nodes = await start_nodes(cluster, tmp_path)
        try:
            with pytest.raises(UploadError) as ei:
                await nodes[1].upload(body, "toobig.bin", ec_k=3)
            assert ei.value.status == 400
            with pytest.raises(UploadError, match="<= 255") as ei:
                await _raise_k_limit(nodes[1], body)
            assert ei.value.status == 400
            m, st = await nodes[1].upload(body, "k1.bin", ec_k=1)
            assert m.ec is not None and m.ec.k == 1
            # k=1: P == Q == the shard, placed once
            for s in m.ec.stripes:
                assert s.p == s.q
            assert st["ecParityBytes"] == sum(2 * s.shard_len
                                              for s in m.ec.stripes)
            _, got = await nodes[2].download(m.file_id)
            assert got == body
        finally:
            await stop_nodes(nodes)

    run(go())


async def _raise_k_limit(node, body):
    """k > 255 on a ring large enough for it: the GF(256) limit, not the
    member count, refuses it."""
    from dfs_tpu_torch.ring import RingMap

    real = node.ring.current
    node.ring.current = RingMap.static(range(1, 300))
    try:
        await node.upload(body, "k.bin", ec_k=256)
    finally:
        node.ring.current = real


def test_ec_handoff_shard_readable_without_sweep(tmp_path):
    """A shard whose pinned holder was down at upload lands on the next
    node of ``handoff_order`` (k=2 on 5 nodes); the reader walks the same
    order, so it finds it without the has_chunks sweep or a decode."""
    body = corpus(30_000, seed=34)
    cluster = make_cluster(5)
    ids = cluster.sorted_ids()

    async def go():
        nodes = await start_nodes(cluster, tmp_path)
        try:
            await nodes.pop(2).stop()
            m, st = await nodes[1].upload(body, "ho.bin", ec_k=2)
            assert st["handoffChunks"] > 0
            pl = ec_placement_map(m, ids)
            handed = [d for d, h in pl.items() if tuple(h) == (2,)]
            assert handed and all(holders_of(nodes, d) for d in handed)
            reader = nodes[4]
            sweeps = 0
            orig = reader.client.has_chunks

            async def spy(*a, **kw):
                nonlocal sweeps
                sweeps += 1
                return await orig(*a, **kw)

            reader.client.has_chunks = spy
            _, got = await reader.download(m.file_id)
            assert got == body
            assert sweeps == 0
            assert reader.counters.snapshot().get("ec_decodes", 0) == 0
        finally:
            await stop_nodes(nodes)

    run(go())


def test_repair_keeps_an_ec_shard_that_is_also_a_stray(tmp_path):
    """3 nodes, rf 2: a 64-byte one-chunk file d on its owners [2, 3];
    node 1 also holds d as the data shard of a k=1 EC manifest. Repair on
    node 1 must keep d (it is an EC shard, pinned to node 1), as dfs_tpu
    keeps it; relocating it as a stray would strip the stripe's
    redundancy."""
    cluster = make_cluster(3)
    ids = cluster.sorted_ids()
    rng = np.random.default_rng(35)
    while True:
        body = rng.integers(0, 256, size=64, dtype=np.uint8).tobytes()
        d = hashlib.sha256(body).hexdigest()
        if static_replica_set(d, ids, 2) == [2, 3]:
            break
    salt = 0
    while True:
        ec_fid = hashlib.sha256(b"ec-%d" % salt).hexdigest()
        if static_ec_shard_node(ec_fid, 0, 0, ids) == 1:
            break
        salt += 1

    async def go():
        nodes = await start_nodes(cluster, tmp_path)
        try:
            m, _ = await nodes[2].upload(body, "plain.bin")
            assert [c.digest for c in m.chunks] == [d]
            assert holders_of(nodes, d) == {2, 3}
            # P = Q = d at k = 1 on a 64-byte shard
            ecm = Manifest(file_id=ec_fid, name="ec.bin", size=64,
                           fragmenter=m.fragmenter,
                           chunks=(ChunkRef(0, 0, 64, d),),
                           ec=EcInfo(k=1, stripes=(StripeRef(d, d, 64),)))
            nodes[1].store.chunks.put(d, body)
            nodes[1].store.manifests.save(ecm)
            await nodes[1].repair_once()
            assert nodes[1].store.chunks.has(d)
            assert nodes[1].counters.snapshot().get("relocated_chunks",
                                                     0) == 0
        finally:
            await stop_nodes(nodes)

    run(go())
