"""The hot/cold tiering plane of the port (dfs_tpu_torch.tier) against
dfs_tpu's on the same inputs, on the CPU: the temperature ledger (decay,
LRU bound, snapshot file, per-file temperature) under an injected clock,
``classify`` on seeded random entries, and ``ByteRate``. Then in-process
port nodes: the default-off node (no plane, no directory, the same
``/metrics`` sections as dfs_tpu's), the demote-then-promote round trip at
k = 3 over 5 nodes with the cold parity held against dfs_tpu's
``encode_pq_np``, scrub healing the index in both directions, and the
``/tier`` routes (GET, POST, 503 while a scan runs, 404 without the
plane)."""

import asyncio
import json
import math

import numpy as np
import pytest

from dfs_tpu.config import CDCParams as RefCDC
from dfs_tpu.config import ClusterConfig as RefCluster
from dfs_tpu.config import NodeConfig as RefNodeConfig
from dfs_tpu.config import PeerAddr as RefPeer
from dfs_tpu.node.runtime import StorageNodeServer as RefServer
from dfs_tpu.ring.manager import ByteRate as RefByteRate
from dfs_tpu.tier import TemperatureLedger as RefLedger
from dfs_tpu.tier import classify as ref_classify

from dfs_tpu_torch.config import IndexConfig, NodeConfig, TierConfig
from dfs_tpu_torch.ring.manager import ByteRate
from dfs_tpu_torch.tier import TemperatureLedger, classify
from dfs_tpu_torch.utils.hashing import sha256_hex

from tests.test_torch_cluster import (CDC, _raw, corpus, http,
                                      make_cluster)
from tests.test_torch_ec_cluster import check_layout
from tests.test_torch_index import _run, _start, _stop

TIER = TierConfig(enabled=True, hot_fraction=0.5, min_idle_s=0.0, ec_k=3,
                  half_life_s=86400.0, promote_reads=2.0)


def _digests(n, seed):
    rng = np.random.default_rng(seed)
    return [sha256_hex(rng.bytes(16)) for _ in range(n)]


# ------------------------------------------------------------------ #
# ledger, classify, ByteRate against dfs_tpu's
# ------------------------------------------------------------------ #

def _both(entries, half_life):
    return (TemperatureLedger(entries, half_life, boot_at=5.0),
            RefLedger(entries, half_life, boot_at=5.0))


def test_ledger_decay_and_lru_equal_under_injected_clock():
    mine, ref = _both(300, 100.0)
    rng = np.random.default_rng(1)
    ds = _digests(400, seed=1)
    now = 10.0
    for _ in range(3000):
        now += float(rng.exponential(3.0))
        d = ds[int(rng.zipf(1.3)) % len(ds)]
        reads = float(rng.integers(1, 4))
        mine.note_read(d, reads=reads, now=now)
        ref.note_read(d, reads=reads, now=now)
    assert len(mine) == len(ref) == 300
    assert mine._map == ref._map            # same entries, same LRU order
    assert list(mine._map) == list(ref._map)
    for d in ds:
        for t in (now, now + 50.0, now + 1000.0):
            assert mine.heat(d, now=t) == ref.heat(d, now=t)
        assert mine.last_access(d) == ref.last_access(d)
    for i in range(0, 400, 37):
        group = ds[i:i + 9]
        assert mine.file_temperature(group, now=now + 7.0) \
            == ref.file_temperature(group, now=now + 7.0)
    # decay: one read halves per half-life
    one, _ = _both(16, 100.0)
    one.note_read(ds[0], now=0.0)
    assert one.heat(ds[0], now=200.0) == pytest.approx(0.25)


def test_ledger_snapshot_file_equal_and_read_both_ways(tmp_path):
    mine, ref = _both(64, 100.0)
    for i, d in enumerate(_digests(80, seed=2)):
        mine.note_read(d, reads=float(i % 5 + 1), now=50.0 + i)
        ref.note_read(d, reads=float(i % 5 + 1), now=50.0 + i)
    mine.snapshot_to(tmp_path / "p")
    ref.snapshot_to(tmp_path / "r")
    assert (tmp_path / "p" / "ledger.json").read_bytes() \
        == (tmp_path / "r" / "ledger.json").read_bytes()
    a = RefLedger.restore(tmp_path / "p", 64, 100.0)
    b = TemperatureLedger.restore(tmp_path / "r", 64, 100.0)
    assert a._map == b._map and len(a) == 64
    (tmp_path / "p" / "ledger.json").write_bytes(b"{torn")
    assert len(TemperatureLedger.restore(tmp_path / "p", 64, 100.0)) == 0


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_classify_equal_on_seeded_entries(seed):
    rng = np.random.default_rng(seed)
    entries = [{"fileId": sha256_hex(bytes([seed, i])),
                "bytes": int(rng.integers(1, 1 << 20)),
                "heat": float(rng.choice([0.0, 0.5, 1.0, 3.0])
                              if rng.random() < 0.5 else rng.random() * 4),
                "lastAccess": float(rng.integers(0, 1000))}
               for i in range(200)]
    for hot in (0.0, 0.1, 0.5, 1.0):
        for idle in (0.0, 300.0):
            for total in (None, sum(e["bytes"] for e in entries) * 1.5):
                got = classify(entries, hot, idle, now=1000.0,
                               total_bytes=total)
                assert got == ref_classify(entries, hot, idle, now=1000.0,
                                           total_bytes=total)
    assert classify(entries, 0.5, 0.0) == ref_classify(entries, 0.5, 0.0)


def test_byterate_stalls_equal():
    """The demotion credit bucket: the same requests stall the same."""
    async def go():
        out = []
        for cls in (ByteRate, RefByteRate):
            b = cls(1 << 20)
            out.append([await b.acquire(n)
                        for n in (1 << 19, 1 << 19, 1 << 18, 0)])
            assert await cls(0).acquire(1 << 30) == 0.0
        return out

    mine, ref = asyncio.run(go())
    assert len(mine) == len(ref) == 4
    assert mine[:2] == ref[:2] == [0.0, 0.0]
    assert math.isclose(mine[2], ref[2], rel_tol=0.2, abs_tol=0.02)


# ------------------------------------------------------------------ #
# in-process port nodes
# ------------------------------------------------------------------ #

def test_default_off_builds_no_plane_and_metrics_match(tmp_path):
    """IndexConfig() and TierConfig() build no plane and no directory, a
    manifest has no tier key, and /metrics index/tier equal dfs_tpu's."""
    assert IndexConfig() == IndexConfig(enabled=False)
    assert TierConfig() == TierConfig(enabled=False)
    cluster = make_cluster(1, rf=1)
    ref = RefServer(RefNodeConfig(
        node_id=1, data_root=tmp_path / "ref", fragmenter="cdc",
        cdc=RefCDC(min_size=2048, avg_size=8192, max_size=65536),
        cluster=RefCluster(peers=(RefPeer(node_id=1, host="127.0.0.1",
                                          port=1, internal_port=2),),
                           replication_factor=1)))

    async def go():
        nodes = await _start(cluster, tmp_path)
        n = nodes[1]
        try:
            assert n.index is None and n.tier is None
            assert n.store.chunks.index is None
            assert n._filter_sync_task is None and n._tier_task is None
            m, _ = await n.upload(corpus(20_000, seed=6), "f.bin")
            _, body = await n.download(m.file_id)
            assert bytes(body) == corpus(20_000, seed=6)
            met = n.metrics()
            assert met["index"] == ref.index_stats()
            assert met["tier"] == ref.tier_stats() == {"enabled": False}
            assert "lsi" not in met["index"]
            for sub in ("index", "tier"):
                assert not (n.store.root / sub).exists()
            raw = (n.store.root / "manifests"
                   / f"{m.file_id}.json").read_bytes()
            assert b'"tier"' not in raw
        finally:
            await _stop(nodes)

    _run(go())


def test_demote_then_promote_roundtrip(tmp_path):
    """Five port nodes, k = 3, index and tiering on: of two files the one
    read stays hot, the other demotes (parity == dfs_tpu's encode_pq_np,
    every node sees the cold manifest, surplus replicas reclaimed, the
    index tier bit flipped), reads back with two nodes stopped, and once
    read past promote_reads promotes back to replicated."""
    cluster = make_cluster(5, rf=2)
    ids = cluster.sorted_ids()
    hot_body, cold_body = corpus(30_000, seed=61), corpus(30_000, seed=62)
    ix = IndexConfig(enabled=True, filter_sync_s=0)

    async def go():
        nodes = await _start(cluster, tmp_path, index=ix, tier=TIER)
        n1 = nodes[1]
        try:
            hm, _ = await n1.upload(hot_body, "hot.bin")
            cm, _ = await n1.upload(cold_body, "cold.bin")
            for _ in range(2):
                _, body = await nodes[3].download(hm.file_id)
                assert bytes(body) == hot_body
            before = sum(n.store.chunks.total_bytes()
                         for n in nodes.values())
            out = await n1.tier_scan_once()
            assert out["scanned"] == 2 and out["demoted"] == 1, out
            after = sum(n.store.chunks.total_bytes()
                        for n in nodes.values())
            assert after < before
            for n in nodes.values():
                assert n.store.manifests.load(hm.file_id).tier is None
                cold = n.store.manifests.load(cm.file_id)
                assert cold.tier == "cold" and cold.ec.k == 3
            doc = json.loads(n1.store.manifests.load(cm.file_id).to_json())
            check_layout(doc, cold_body, 3, ids)
            # the tier bit, on the node that holds a data shard
            holder = next(n for n in nodes.values()
                          if n.store.chunks.has(cm.chunks[0].digest))
            raw = bytes.fromhex(cm.chunks[0].digest)
            assert holder.index.lsi._memtable.get(raw) == 2
            st = n1.tier_stats()
            assert st["demotedFiles"] == 1 and st["reclaimedBytes"] > 0
            assert st["parityBytes"] > 0
            assert n1.metrics()["frag"]["ecEncode"]["device"] == "cpu"
            assert (await n1.tier_scan_once())["demoted"] == 0
            # cold reads: through the EC layout, with two nodes stopped
            for i in (3, 4):
                await nodes.pop(i).stop()
            _, body = await nodes[5].download(cm.file_id)
            assert bytes(body) == cold_body
            # heat it past promote_reads on node 1: the check precedes a
            # read's own feed and the heat decays, so (as in dfs_tpu's
            # test) four reads
            for _ in range(4):
                _, body = await n1.download(cm.file_id)
                assert bytes(body) == cold_body
            for _ in range(200):
                m = n1.store.manifests.load(cm.file_id)
                if m.tier is None and not n1._tier_promoting:
                    break
                await asyncio.sleep(0.05)
            m = n1.store.manifests.load(cm.file_id)
            assert m.tier is None and m.ec is None, "no promotion"
            assert n1.tier_stats()["promotedFiles"] == 1
            assert n1.index.lsi._memtable.get(raw, 1) == 1
            _, body = await nodes[2].download(cm.file_id)
            assert bytes(body) == cold_body
        finally:
            await _stop(nodes)

    _run(go())


def test_scrub_heals_index_vs_walk_divergence(tmp_path):
    """Scrub heals both directions: a digest on disk the index lost turns
    present again; a phantom the index vouches for is expunged."""
    cluster = make_cluster(1, rf=1)

    async def go():
        nodes = await _start(cluster, tmp_path,
                             index=IndexConfig(enabled=True))
        node = nodes[1]
        try:
            m, _ = await node.upload(corpus(30_000, seed=63), "s.bin")
            d0 = m.chunks[0].digest
            phantom = sha256_hex(b"never-stored-anywhere")
            node.index.note_delete(d0)
            node.index.note_put(phantom)
            out = await node.scrub_once()
            assert out["healedMissing"] >= 1 and out["healedPhantom"] == 1
            assert node.index.lsi.lookup(d0)
            assert not node.index.lsi.lookup(phantom)
            assert node.counters.snapshot()["index_healed_phantom"] == 1
            out2 = await node.scrub_once()
            assert out2["healedMissing"] == out2["healedPhantom"] == 0
        finally:
            await _stop(nodes)

    _run(go())


def test_tier_http_surfaces(tmp_path):
    """/tier: GET mirrors /metrics tier, POST runs a scan, a scan already
    running answers 503 + Retry-After, and a node without the plane 404s
    with the hint."""
    cluster = make_cluster(5, rf=2)
    off = make_cluster(1, rf=1)

    async def go():
        nodes = await _start(cluster, tmp_path, tier=TIER)
        try:
            port = cluster.peer(1).port
            st, _, body = await http(_raw, port, "GET", "/tier")
            assert st == 200
            doc = json.loads(body)
            assert doc["enabled"] is True and doc["ecK"] == 3
            st, _, body = await http(_raw, port, "POST", "/tier",
                                     {"Content-Length": "0"}, b"")
            assert st == 200
            assert set(json.loads(body)) >= {"scanned", "cold", "demoted",
                                             "finished", "skipped"}
            gate = nodes[1].tier.gate
            await gate.acquire()           # a scan in flight
            try:
                st, hdrs, _ = await http(_raw, port, "POST", "/tier",
                                         {"Content-Length": "0"}, b"")
            finally:
                gate.release()
            assert st == 503 and "retry-after" in {k.lower() for k in hdrs}
            assert nodes[1].metrics()["tier"]["admission"]["shed"] == 1
        finally:
            await _stop(nodes)
        nodes = await _start(off, tmp_path / "off")
        try:
            for method in ("GET", "POST"):
                st, _, body = await http(_raw, off.peer(1).port, method,
                                         "/tier", {"Content-Length": "0"},
                                         b"")
                assert st == 404 and b"--tier" in body
        finally:
            await _stop(nodes)

    _run(go())
