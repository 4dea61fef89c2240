"""The dedup/index plane of the port (dfs_tpu_torch.index) against
dfs_tpu's on the same inputs, on the CPU: the blocked bloom's bytes, the
local filter's snapshot and delta documents, the delta validation that
forces a resync, and the LSI's on-disk directory (WAL, runs, CURRENT),
which each package opens after the other wrote it — torn WAL tail and
corrupt run included. Then the CAS seam and in-process port nodes:
the has() fast path with its stat backstop, filter gossip and the
re-upload that skips probe RPCs, a poisoned filter healed before the
ack, and repair's probe trim."""

import asyncio
import os

import numpy as np
import pytest

from dfs_tpu.config import IndexConfig as RefIndexConfig
from dfs_tpu.index import IndexPlane as RefIndexPlane
from dfs_tpu.index.filter import BlockedBloomFilter as RefBloom
from dfs_tpu.index.filter import LocalFilter as RefLocalFilter
from dfs_tpu.index.filter import PeerFilterSet as RefPeerFilters
from dfs_tpu.index.lsi import DigestIndex as RefDigestIndex
from dfs_tpu.store.cas import ChunkStore as RefChunkStore

from dfs_tpu_torch.config import IndexConfig, NodeConfig
from dfs_tpu_torch.index import IndexPlane
from dfs_tpu_torch.index.filter import (BlockedBloomFilter, LocalFilter,
                                        PeerFilterSet)
from dfs_tpu_torch.index.lsi import DigestIndex
from dfs_tpu_torch.node.runtime import StorageNodeServer
from dfs_tpu_torch.store.cas import ChunkStore
from dfs_tpu_torch.utils.hashing import sha256_hex

from tests.test_torch_cluster import CDC, corpus, make_cluster


def _digests(n, seed):
    rng = np.random.default_rng(seed)
    return [sha256_hex(rng.bytes(16)) for _ in range(n)]


# ------------------------------------------------------------------ #
# filters
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("capacity,bits", [(1, 1), (1000, 10),
                                           (4096, 4), (70000, 16)])
def test_bloom_bytes_identical(capacity, bits):
    """The same digests set the same bits: the wire ships raw filter
    bytes, so both packages must read each other's filters."""
    ds = _digests(3 * capacity // 2 + 5, seed=capacity)
    mine, ref = BlockedBloomFilter(capacity, bits), RefBloom(capacity, bits)
    assert (mine.nblocks, mine.k) == (ref.nblocks, ref.k)
    for d in ds:
        mine.add(d)
        ref.add(d)
    assert bytes(mine.buf) == bytes(ref.buf)
    probes = ds[::3] + _digests(500, seed=capacity + 1)
    assert [mine.contains(d) for d in probes] \
        == [ref.contains(d) for d in probes]
    # each reads the other's buffer
    assert all(BlockedBloomFilter(capacity, bits,
                                  buf=bytearray(ref.buf)).contains(d)
               for d in ds)


def test_local_filter_snapshot_and_delta_documents_equal():
    """The same add sequence gives equal snapshot metas (the generation is
    random by design) and bytes, and equal delta documents, through the
    add-log bound and a rebuild."""
    mine = LocalFilter(bits_per_key=10, min_capacity=2048)
    ref = RefLocalFilter(bits_per_key=10, min_capacity=2048)
    ds = _digests(20000, seed=3)

    def same():
        (ma, ba), (ra, bb) = mine.snapshot(), ref.snapshot()
        ma, ra = dict(ma), dict(ra)
        ma.pop("gen")
        ra.pop("gen")
        assert ma == ra and ba == bb
        for since in (0, 5, 3000, mine.version - 7, mine.version,
                      mine.version + 1):
            dm = mine.delta(mine.generation, since)
            dr = ref.delta(ref.generation, since)
            dm.pop("gen")
            dr.pop("gen")
            assert dm == dr, since
        assert mine.delta(mine.generation + 1, 0)["resync"]
        assert {k: v for k, v in mine.stats().items() if k != "generation"} \
            == {k: v for k, v in ref.stats().items() if k != "generation"}

    for d in ds[:100]:
        mine.add(d)
        ref.add(d)
    same()
    for d in ds[100:]:               # past the add-log and delta caps
        mine.add(d)
        ref.add(d)
    same()
    live = [bytes.fromhex(d) for d in ds[:5000]]
    mine.rebuild(live)
    ref.rebuild(live)
    same()


@pytest.mark.parametrize("adds", [["zz"], "notalist", [12345],
                                  ["g" * 64]])
def test_corrupt_delta_forces_resync(adds):
    """A malformed delta is refused by both packages' replica sets (the
    caller then resyncs the full filter), and the replica is untouched."""
    src = LocalFilter(bits_per_key=10, min_capacity=1024)
    for d in _digests(50, seed=4):
        src.add(d)
    meta, body = src.snapshot()
    verdicts = []
    for cls in (PeerFilterSet, RefPeerFilters):
        ps = cls()
        ps.apply_full(2, meta, body)
        before = bytes(ps.state(2)["bloom"].buf)
        verdicts.append(ps.apply_delta(2, meta["gen"],
                                       meta["version"] + 1, adds))
        assert bytes(ps.state(2)["bloom"].buf) == before
        assert ps.state(2)["version"] == meta["version"]
        # a generation the replica does not hold is refused as well
        assert not ps.apply_delta(2, meta["gen"] + 1, meta["version"], [])
    assert verdicts == [False, False]


# ------------------------------------------------------------------ #
# the LSI's directory, both ways
# ------------------------------------------------------------------ #

def _drive(idx, seed):
    """One seeded put/delete/tier sequence at a tiny memtable: several
    flushes and compactions. Returns every digest touched."""
    rng = np.random.default_rng(seed)
    ds = _digests(1400, seed=seed)
    for i, d in enumerate(ds):
        idx.note_put(d)
        if i > 50 and rng.random() < 0.2:
            idx.note_delete(ds[int(rng.integers(0, i))])
        if i > 50 and rng.random() < 0.1:
            idx.note_tier(ds[int(rng.integers(0, i))],
                          bool(rng.random() < 0.7))
    return ds


def _states(idx):
    """digest -> state byte, newest record winning (runs, then the
    memtable): the tier bit included."""
    merged = {}
    for run in idx._runs:
        merged.update(run.records())
    merged.update(idx._memtable)
    return merged


def _files(root):
    return {p.name: p.read_bytes() for p in sorted(root.iterdir())}


@pytest.mark.parametrize("writer", ["port", "dfs_tpu"])
def test_lsi_directory_identical_and_opens_both_ways(tmp_path, writer):
    kw = dict(memtable_entries=256, compact_runs=2, bloom_bits_per_key=10)
    dirs = {"port": tmp_path / "p", "dfs_tpu": tmp_path / "r"}
    touched = None
    for name, cls in (("port", DigestIndex), ("dfs_tpu", RefDigestIndex)):
        idx = cls(dirs[name], **kw)
        idx.open_or_rebuild(lambda: [])
        touched = _drive(idx, seed=7)
        assert idx.stats()["compactions"] >= 1
        idx.close()
    # the same sequence writes the same files, byte for byte
    assert _files(dirs["port"]) == _files(dirs["dfs_tpu"])
    reader = RefDigestIndex if writer == "port" else DigestIndex
    other = reader(dirs[writer], **kw)
    again = (DigestIndex if writer == "port" else RefDigestIndex)(
        tmp_path / "again", **kw)
    info = other.open_or_rebuild(lambda: pytest.fail("rebuilt"))
    assert not info["rebuilt"]
    again.open_or_rebuild(lambda: [])
    _drive(again, seed=7)
    assert [other.lookup(d) for d in touched] \
        == [again.lookup(d) for d in touched]
    assert sorted(other.present_digests()) == sorted(again.present_digests())
    assert _states(other) == _states(again)
    other.close()
    again.close()


def test_lsi_torn_wal_tail_truncated_both_ways(tmp_path):
    """A torn record at the WAL's end (a kill -9 mid-append) is cut at
    the first bad CRC; both packages then answer the same."""
    idx = DigestIndex(tmp_path / "ix", memtable_entries=4096)
    idx.open_or_rebuild(lambda: [])
    ds = _digests(300, seed=9)
    for d in ds:
        idx.note_put(d)
    idx.note_delete(ds[0])
    idx.close()
    wal = next(p for p in (tmp_path / "ix").iterdir()
               if p.name.startswith("wal-"))
    with open(wal, "ab") as f:
        f.write(b"\x01" + bytes.fromhex(ds[1]) + b"\x00\x00")   # torn
    for cls in (RefDigestIndex, DigestIndex):
        idx = cls(tmp_path / "ix", memtable_entries=4096)
        info = idx.open_or_rebuild(lambda: pytest.fail("rebuilt"))
        assert not info["rebuilt"]
        assert not idx.lookup(ds[0])
        assert all(idx.lookup(d) for d in ds[1:])
        idx.close()


def test_lsi_corrupt_run_rebuilds_from_cas_walk(tmp_path):
    """A run whose checksum fails degrades to a rebuild from the CAS walk
    (the chunk files are the truth), in the port as in dfs_tpu."""
    results = []
    for cls in (DigestIndex, RefDigestIndex):
        root = tmp_path / cls.__module__.split(".")[0]
        idx = cls(root, memtable_entries=256, compact_runs=8)
        idx.open_or_rebuild(lambda: [])
        ds = _digests(700, seed=10)
        for d in ds:
            idx.note_put(d)
        idx.close()
        run = next(p for p in root.iterdir() if p.name.startswith("run-"))
        raw = bytearray(run.read_bytes())
        raw[40] ^= 0xFF
        run.write_bytes(bytes(raw))
        walk = ds[:100]
        idx = cls(root, memtable_entries=256, compact_runs=8)
        info = idx.open_or_rebuild(lambda: walk)
        assert info["rebuilt"] and info["entries"] == len(walk)
        results.append(sorted(idx.present_digests()))
        assert idx.lookup(walk[0]) and not idx.lookup(ds[500])
        idx.close()
    assert results[0] == results[1]


# ------------------------------------------------------------------ #
# the CAS seam
# ------------------------------------------------------------------ #

def test_chunkstore_feed_and_has_fast_path(tmp_path):
    """put/delete feed the plane, has() trusts index positives and
    stat-backstops negatives (healing the index), as in dfs_tpu; a store
    fed by the port leaves an index dfs_tpu's store reads the same."""
    store = ChunkStore(tmp_path / "chunks")
    plane = IndexPlane(IndexConfig(enabled=True), tmp_path)
    plane.open_or_rebuild(store.digests)
    store.index = plane
    payload = b"chunk-payload" * 100
    d = sha256_hex(payload)
    assert store.put(d, payload)
    assert plane.lookup(d)
    assert store.has(d)
    sneak = b"sneaky" * 50
    ds = sha256_hex(sneak)
    store.index = None
    assert store.put(ds, sneak)
    store.index = plane
    assert not plane.lookup(ds)
    assert store.has(ds)                  # the stat backstop...
    assert plane.lookup(ds)               # ...healed the index
    # a dedup hit on a forgotten chunk heals too
    plane.note_delete(ds)
    assert not store.put(ds, sneak) and plane.lookup(ds)
    assert store.delete(d)
    assert not plane.lookup(d) and not store.has(d)
    plane.close()
    ref_store = RefChunkStore(tmp_path / "chunks")
    ref_plane = RefIndexPlane(RefIndexConfig(enabled=True), tmp_path)
    assert not ref_plane.open_or_rebuild(ref_store.digests)["rebuilt"]
    ref_store.index = ref_plane
    assert ref_store.has(ds) and not ref_plane.lookup(d)
    ref_plane.close()


def test_concurrent_puts_and_deletes_leave_no_phantom(tmp_path):
    """Workers racing puts and deletes of the same digests (the CAS tier's
    threads) leave an index that claims nothing the disk lacks: every
    record is taken under the ordering mutex with its link or unlink."""
    import sys
    import threading

    store = ChunkStore(tmp_path / "chunks")
    plane = IndexPlane(IndexConfig(enabled=True, memtable_entries=256,
                                   compact_runs=2), tmp_path)
    plane.open_or_rebuild(store.digests)
    store.index = plane
    payloads = [b"race-%d" % i * 40 for i in range(64)]
    digests = [sha256_hex(b) for b in payloads]
    errors = []

    def work(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(400):
                i = int(rng.integers(0, len(payloads)))
                if rng.random() < 0.55:
                    store.put(digests[i], payloads[i])
                else:
                    store.delete(digests[i])
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in threads)
    on_disk = set(store.digests())
    assert {d.hex() for d in plane.lsi.present_digests()} == on_disk
    assert all(plane.lookup(d) == (d in on_disk) for d in digests)
    plane.close()


# ------------------------------------------------------------------ #
# in-process port nodes
# ------------------------------------------------------------------ #

async def _start(cluster, root, **kw):
    nodes = {}
    for p in cluster.peers:
        n = StorageNodeServer(NodeConfig(
            node_id=p.node_id, cluster=cluster, data_root=root, cdc=CDC,
            health_probe_s=0, device="cpu", **kw))
        await n.start()
        nodes[p.node_id] = n
    return nodes


async def _stop(nodes):
    for n in nodes.values():
        await n.stop()


def _probe_rpcs(node):
    return sum(row[0] for _, op, row in node.client.rpc_stats.rows()
               if op == "has_chunks")


def _run(coro):
    asyncio.run(asyncio.wait_for(coro, timeout=60))


def test_cluster_filter_gossip_and_reupload_probe_skip(tmp_path):
    """Filters replicate through the sync round (deltas once a replica
    exists); a re-upload credits every remote copy from the filters (no
    transfer), probing only in the pre-ack verification round; fresh data
    then skips probe RPCs altogether (every digest ruled out)."""
    ix = IndexConfig(enabled=True, memtable_entries=1024, filter_sync_s=0)
    cluster = make_cluster(3, rf=2)
    data = corpus(60_000, seed=41)

    async def go():
        nodes = await _start(cluster, tmp_path, index=ix)
        try:
            m, s1 = await nodes[1].upload(data, "a.bin")
            assert s1["transferredBytes"] > 0
            for n in nodes.values():
                assert await n._filter_sync_once() == 2
            for n in nodes.values():       # replicas exist: deltas now
                assert await n._filter_sync_once() == 2
            assert nodes[1].index.peer_filters.deltas >= 2
            before = _probe_rpcs(nodes[1])
            _, s2 = await nodes[1].upload(data, "again.bin")
            assert s2["transferredBytes"] == 0
            assert s2["dedupSkippedBytes"] == s1["transferredBytes"]
            assert s2["minCopies"] >= 2
            st = nodes[1].index_stats()
            assert st["filterTrusted"] > 0 and st["filterFp"] == 0
            assert st["probesSkipped"] >= st["filterTrusted"]
            assert _probe_rpcs(nodes[1]) - before <= 2   # verify only
            rpcs, skipped = _probe_rpcs(nodes[1]), st["probeRpcsSkipped"]
            await nodes[1].upload(corpus(30_000, seed=42), "b.bin")
            assert _probe_rpcs(nodes[1]) == rpcs
            assert nodes[1].index_stats()["probeRpcsSkipped"] > skipped
            for n in nodes.values():
                _, body = await n.download(m.file_id)
                assert bytes(body) == data
            # the batched fetch: a node's own filter, then its replicas
            got = await nodes[2].client.get_filters(cluster.peer(1))
            assert [meta["nodeId"] for meta, _ in got] == [1, 2, 3]
            own = nodes[1].index.local_filter.snapshot()[1]
            assert bytes(got[0][1]) == own
            assert set(nodes[1].metrics()["index"]["peerFilters"]
                       ["peers"]) == {"2", "3"}
        finally:
            await _stop(nodes)

    _run(go())


def test_poisoned_filter_fp_detected_and_healed_before_ack(tmp_path):
    """A forced false positive (node 1's replica of node 2's filter holds
    digests node 2 lacks) fails the pre-ack verification, is counted, and
    is healed by a real transfer before the ack."""
    ix = IndexConfig(enabled=True, filter_sync_s=0)
    cluster = make_cluster(2, rf=2)

    async def go():
        nodes = await _start(cluster, tmp_path, index=ix)
        try:
            await nodes[1].upload(b"seed" * 3000, "seed.bin")
            for n in nodes.values():
                await n._filter_sync_once()
            data = corpus(30_000, seed=43)
            manifest = nodes[1].fragmenter.manifest(
                data, name="x", file_id=sha256_hex(data))
            for c in manifest.chunks:
                nodes[1].index.peer_filters.state(2)["bloom"].add(c.digest)
            m, stats = await nodes[1].upload(data, "x.bin")
            assert nodes[1].index_stats()["filterFp"] > 0
            for c in m.chunks:
                assert nodes[2].store.chunks.has(c.digest)
            _, body = await nodes[2].download(m.file_id)
            assert bytes(body) == data
            assert stats["transferredBytes"] > 0
        finally:
            await _stop(nodes)

    _run(go())


def test_repair_probe_trim_never_trusts_positives(tmp_path):
    """Repair uses a peer's filter only to skip the probe of what it rules
    out; a stale positive is still probed, so a lost chunk is pushed."""
    ix = IndexConfig(enabled=True, filter_sync_s=0)
    cluster = make_cluster(2, rf=2)

    async def go():
        nodes = await _start(cluster, tmp_path, index=ix)
        try:
            m, _ = await nodes[1].upload(corpus(30_000, seed=44), "r.bin")
            for n in nodes.values():
                await n._filter_sync_once()
            lost = m.chunks[0].digest
            assert nodes[2].store.chunks.delete(lost)
            assert not nodes[2].store.chunks.has(lost)
            await nodes[1].repair_once()
            assert nodes[2].store.chunks.has(lost)
            assert nodes[1].index_stats()["filterFp"] >= 1
        finally:
            await _stop(nodes)

    _run(go())


def test_boot_opens_index_before_sweep_and_reopens_clean(tmp_path):
    """A node restarted on its data root opens its index (no rebuild) and
    its answers match the CAS walk; a damaged CURRENT rebuilds from the
    walk at boot."""
    ix = IndexConfig(enabled=True, memtable_entries=256, filter_sync_s=0)
    cluster = make_cluster(1, rf=1)

    async def go():
        nodes = await _start(cluster, tmp_path, index=ix)
        m, _ = await nodes[1].upload(corpus(40_000, seed=45), "f.bin")
        await _stop(nodes)
        for damage in (False, True):
            if damage:
                (tmp_path / "node-1" / "index" / "CURRENT").write_text("{")
            nodes = await _start(cluster, tmp_path, index=ix)
            try:
                n = nodes[1]
                walk = set(n.store.chunks.digests())
                assert {d.hex() for d in n.index.lsi.present_digests()} \
                    == walk == {c.digest for c in m.chunks}
                assert n.index_stats()["lsi"]["rebuilds"] == int(damage)
                out = await n.scrub_once()
                assert out["healedMissing"] == out["healedPhantom"] == 0
            finally:
                await _stop(nodes)

    _run(go())
