"""The serving tier of the port (dfs_tpu_torch.serve, utils/deadline.py,
obs.RpcStats) against dfs_tpu's on the same inputs, and the tier wired
into the port's node on the CPU: hot reads coalesce, readahead stays
byte-identical, single-flight failure and cancellation, delete drops
cached entries, 503 + Retry-After from the gates and from deadlines, the
wire deadline, hedged reads under a slow replica, and the default config
leaving every component off."""

import asyncio
import socket
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from dfs_tpu.config import ServeConfig as RefServeConfig
from dfs_tpu.obs import RpcStats as RefRpcStats
from dfs_tpu.serve import ServingTier as RefServingTier
from dfs_tpu.serve import admission as ref_admission
from dfs_tpu.serve import cache as ref_cache
from dfs_tpu.serve import hedge as ref_hedge
from dfs_tpu.serve import prefetch as ref_prefetch
from dfs_tpu.serve import singleflight as ref_singleflight
from dfs_tpu.utils import deadline as ref_deadline

from dfs_tpu_torch.config import (CDCParams, ClusterConfig, NodeConfig,
                                  PeerAddr, ServeConfig)
from dfs_tpu_torch.node.runtime import StorageNodeServer
from dfs_tpu_torch.obs import RpcStats
from dfs_tpu_torch.serve import ServingTier
from dfs_tpu_torch.serve import admission, cache, hedge, prefetch, \
    singleflight
from dfs_tpu_torch.utils import deadline

CDC = CDCParams(min_size=64, avg_size=256, max_size=1024)
SERVE_ON = ServeConfig(cache_bytes=32 * 1024 * 1024, readahead_batches=2)


def corpus(n, seed):
    return np.random.default_rng(seed).integers(0, 256, size=n,
                                                dtype=np.uint8).tobytes()


# ------------------------------------------------------------------ #
# each module against dfs_tpu's
# ------------------------------------------------------------------ #

def test_chunk_cache_matches_reference(monkeypatch):
    """One put/get/drop/clear sequence through both SIEVE caches: equal
    membership, stats and temperature after every step, including a
    visited entry that survives the cold entries of a scan."""
    clock = iter(range(1, 10_000))
    monkeypatch.setattr(cache.time, "time", lambda: float(next(clock)))
    ours, ref = cache.ChunkCache(40), ref_cache.ChunkCache(40)

    def step(op, *args):
        a = getattr(ours, op)(*args)
        b = getattr(ref, op)(*args)
        if isinstance(a, memoryview) or isinstance(b, memoryview):
            a, b = (None if x is None else bytes(x) for x in (a, b))
        assert a == b, (op, args)
        assert list(ours._map) == list(ref._map)
        assert ours.stats() == ref.stats()
        hot = [{k: v for k, v in e.items() if k != "lastAccess"}
               for e in ours.temperature()]
        assert hot == [{k: v for k, v in e.items() if k != "lastAccess"}
                       for e in ref.temperature()]
        assert len(ours) == len(ref) and ours.bytes_used == ref.bytes_used

    val = {k: bytes([i]) * 10 for i, k in enumerate("abcdefghij")}
    for k in "abcd":
        step("put", k, val[k])
    step("get", "a")                       # visited
    step("put", "a", val["a"])             # already present
    step("put", "e", val["e"])             # evicts b, a survives
    assert "a" in ours._map and "b" not in ours._map
    for k in "fgh":                        # a cold scan
        step("put", k, memoryview(val[k]))
    assert "a" in ours._map
    step("get", "zz")                      # miss
    step("get", "a")
    step("get", "h")
    step("drop", "h")
    step("drop", "h")
    step("put", "big", b"x" * 41)          # larger than the budget
    step("put", "i", val["i"])
    step("clear")
    step("put", "j", val["j"])


def test_single_flight_matches_reference():
    async def run(mod):
        sf = mod.SingleFlight()
        log = []

        async def slow(v):
            await asyncio.sleep(0.01)
            return v

        async def fail():
            await asyncio.sleep(0.01)
            raise ValueError("origin down")

        got = await asyncio.gather(*(sf.do("k", lambda: slow(7))
                                     for _ in range(5)))
        log.append((got, sf.stats()))
        outs = await asyncio.gather(*(sf.do("f", fail) for _ in range(3)),
                                    return_exceptions=True)
        log.append(([type(o).__name__ for o in outs], sf.stats()))
        log.append((await sf.do("f", lambda: slow(1)), sf.stats()))
        leader, _ = sf.claim("x")
        joined, fut = sf.claim("x")
        waiter = asyncio.ensure_future(sf.wait(fut))
        sf.reject("x", RuntimeError("gone"))
        with pytest.raises(RuntimeError):
            await waiter
        log.append((leader, joined, sf.stats()))
        return log

    assert asyncio.run(run(singleflight)) == asyncio.run(
        run(ref_singleflight))


def test_admission_gate_matches_reference():
    """One asyncio schedule through both gates: equal grants, sheds,
    deadline sheds, disconnects and stats."""

    async def run(mod, dl):
        g = mod.AdmissionGate("download", slots=2, queue_depth=2,
                              retry_after_s=3.0)
        log = []

        async def take(tag, **kw):
            try:
                await g.acquire(**kw)
                log.append((tag, "granted"))
            except mod.ShedError as e:
                log.append((tag, "shed", str(e), e.retry_after_s))
            except mod.ClientDisconnected:
                log.append((tag, "gone"))

        tasks = [asyncio.ensure_future(take(i)) for i in range(6)]
        await asyncio.sleep(0.01)
        log.append(("s1", g.stats()))
        g.release()
        g.release()
        await asyncio.gather(*tasks)
        log.append(("s2", g.stats()))
        tok = dl.activate(-1.0)             # expired on arrival
        try:
            await take("late")
        finally:
            dl.restore(tok)
        tok = dl.activate(0.05)             # expires while queued
        try:
            await take("queued")
        finally:
            dl.restore(tok)
        gone = asyncio.get_running_loop().create_future()

        async def hung_up():
            return await gone

        t = asyncio.ensure_future(take("dead",
                                       disconnected=lambda: hung_up()))
        await asyncio.sleep(0.01)
        gone.set_result(b"")
        await t
        g.release()
        g.release()
        log.append(("s3", g.stats()))
        off = mod.AdmissionGate("upload", slots=0, queue_depth=0)
        for _ in range(3):
            await off.acquire()
        log.append(("off", off.stats(), off.enabled))
        return log

    assert asyncio.run(run(admission, deadline)) == asyncio.run(
        run(ref_admission, ref_deadline))


def test_hedge_policy_matches_reference(monkeypatch):
    now = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: now[0])
    ours = hedge.HedgePolicy(0.04, 0.3, 2.0)
    ref = ref_hedge.HedgePolicy(0.04, 0.3, 2.0)
    for m in (None, 0.001, 0.02, 0.05, 0.2, 5.0):
        assert ours.delay_s(m) == ref.delay_s(m)
    takes = []
    for dt in (0.0, 0.0, 0.0, 0.1, 0.5, 0.0, 3.0, 0.0, 0.0, 0.0, 61.0):
        now[0] += dt
        a, b = ours.take(), ref.take()
        takes.append(a)
        assert a == b
        if a:
            ours.note_fired()
            ref.note_fired()
            if len(takes) % 2:
                ours.note_won()
                ref.note_won()
        assert ours.stats() == ref.stats()
    assert True in takes and False in takes


def test_batch_prefetcher_order_matches_reference():
    async def run(mod):
        calls, got = [], []

        async def fetch(b):
            calls.append(b)
            # bare yields, not timers: their order depends only on the
            # loop's ready queue, so both modules see one schedule however
            # loaded the host is
            for _ in range(5 - b % 5):
                await asyncio.sleep(0)
            return b * 10

        batches = list(range(8))
        pre = mod.BatchPrefetcher(batches, fetch, 2, start=1)
        pre.prime()
        calls.append("primed")
        for i in range(1, 6):
            got.append(await pre.get(i))
            calls.append(("got", i))
        await pre.close()
        return calls, got

    assert asyncio.run(run(prefetch)) == asyncio.run(run(ref_prefetch))


@pytest.mark.parametrize("value", [None, "", "0", "1.5", " 2 ", "-3",
                                   "soon", "nan", "inf", "1e3", "0x10"])
def test_deadline_parse_header_matches_reference(value):
    assert deadline.parse_header(value) == ref_deadline.parse_header(value)


@pytest.mark.parametrize("field", [None, True, 0, 2, 0.25, -1.0, "1",
                                   float("nan"), float("inf"), [1]])
def test_deadline_parse_wire_matches_reference(field):
    assert deadline.parse_wire(field) == ref_deadline.parse_wire(field)


def test_deadline_context_matches_reference():
    for mod in (deadline, ref_deadline):
        assert mod.remaining() is None and not mod.expired()
        tok = mod.activate(1e9)             # clamped to MAX_DEADLINE_S
        assert 3599 < mod.remaining() <= mod.MAX_DEADLINE_S
        inner = mod.clear()
        assert mod.remaining() is None
        mod.restore(inner)
        mod.restore(tok)
        tok = mod.activate(0)
        assert mod.expired()
        mod.restore(tok)
        assert not mod.expired()


@pytest.mark.parametrize("kw", [
    {}, {"cache_bytes": -1}, {"readahead_batches": -1},
    {"queue_depth": -1}, {"default_deadline_s": -0.5},
    {"hedge_floor_s": -0.1}, {"hedge_floor_s": 0.6, "hedge_cap_s": 0.5},
    {"hedge_budget_per_s": -1.0},
    {"cache_bytes": 1 << 20, "download_slots": 4, "hedge_budget_per_s": 5.0,
     "hedge_floor_s": 0.5, "hedge_cap_s": 0.5}])
def test_serve_config_validation_matches_reference(kw):
    def outcome(cls):
        try:
            return cls(**kw)
        except ValueError as e:
            return str(e)

    ours, ref = outcome(ServeConfig), outcome(RefServeConfig)
    if isinstance(ref, str):
        assert ours == ref
    else:
        import dataclasses
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


@pytest.mark.parametrize("kw", [{}, dict(
    cache_bytes=1 << 20, readahead_batches=2, download_slots=2,
    upload_slots=3, internal_slots=4, queue_depth=6, retry_after_s=2.0,
    default_deadline_s=5.0, hedge_floor_s=0.04, hedge_cap_s=0.3,
    hedge_budget_per_s=50.0)], ids=["default", "everything_on"])
def test_serving_tier_stats_match_reference(kw):
    ours = ServingTier(ServeConfig(**kw))
    ref = RefServingTier(RefServeConfig(**kw))
    assert ours.stats() == ref.stats()
    assert ours.read_path_enabled == ref.read_path_enabled
    assert ours.drop_cached(["a", "b"]) == ref.drop_cached(["a", "b"])


def test_rpc_stats_match_reference():
    ours, ref = RpcStats(), RefRpcStats()
    for s in (ours, ref):
        s.record(2, "get_chunks", 0.5, bytes_out=10, bytes_in=1000)
        s.record(2, "get_chunks", 0.3, error=True)
        s.record(3, "get_chunks", 0.1, bytes_in=50)
        s.record(3, "get_chunk", 0.02)
        s.retry(2, "get_chunks")
    assert ours.rows() == ref.rows()
    for op in ("get_chunks", "get_chunk", "store_chunks"):
        assert ours.recent_best_mean(op) == ref.recent_best_mean(op)


# ------------------------------------------------------------------ #
# the tier on the port's node
# ------------------------------------------------------------------ #

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


def make_cluster(n, rf=2):
    ports = _free_ports(2 * n)
    return ClusterConfig(peers=tuple(
        PeerAddr(node_id=i + 1, host="127.0.0.1", port=ports[2 * i],
                 internal_port=ports[2 * i + 1]) for i in range(n)),
        replication_factor=rf)


async def start_nodes(cluster, root, serve=None, slow=()):
    """Every node of ``cluster`` (``serve`` a ServeConfig for all or a
    dict node id -> ServeConfig). Nodes in ``slow`` answer every inbound
    frame after ``node.slow_s`` seconds (0 until a test sets it)."""
    nodes = {}
    for p in cluster.peers:
        s = serve.get(p.node_id, ServeConfig()) \
            if isinstance(serve, dict) else (serve or ServeConfig())
        n = StorageNodeServer(NodeConfig(
            node_id=p.node_id, cluster=cluster, data_root=root, cdc=CDC,
            health_probe_s=0, device="cpu", serve=s))
        if p.node_id in slow:
            n.slow_s = 0.0
            orig = n._serve_internal_frame

            async def slow_frame(*a, _n=n, _orig=orig):
                if _n.slow_s:
                    await asyncio.sleep(_n.slow_s)
                return await _orig(*a)

            n._serve_internal_frame = slow_frame
        await n.start()
        nodes[p.node_id] = n
    return nodes


async def stop_nodes(nodes):
    for n in nodes.values():
        await n.stop()


def run(coro):
    asyncio.run(asyncio.wait_for(coro, timeout=60))


async def read_all(node, fid):
    _, gen = await node.download_stream(fid)
    return b"".join([bytes(p) async for p in gen])


def test_concurrent_hot_reads_coalesce_to_one_origin_read(tmp_path):
    data = corpus(60_000, 1)

    async def go():
        nodes = await start_nodes(make_cluster(1, rf=1), tmp_path, SERVE_ON)
        try:
            n = nodes[1]
            m, _ = await n.upload(data, "hot.bin")
            store = n.store.chunks
            reads = 0
            orig_get = store.get

            def counting_get(d):
                nonlocal reads
                reads += 1
                return orig_get(d)

            store.get = counting_get
            outs = await asyncio.gather(*(read_all(n, m.file_id)
                                          for _ in range(32)))
            assert all(o == data for o in outs)
            unique = len({c.digest for c in m.chunks})
            assert reads == unique
            assert n.serve.flight.stats()["coalesced"] > 0
            reads = 0
            assert await read_all(n, m.file_id) == data
            assert reads == 0
            assert n.metrics()["serve"]["cache"]["hits"] > 0
        finally:
            await stop_nodes(nodes)

    run(go())


def test_streamed_download_with_readahead_byte_identical(tmp_path):
    data = corpus(120_000, 2)

    async def go():
        nodes = await start_nodes(make_cluster(3), tmp_path, SERVE_ON)
        try:
            m, _ = await nodes[1].upload(data, "ra.bin")
            nodes[2]._FETCH_BATCH_BYTES = 8 * 1024      # many batches
            assert await read_all(nodes[2], m.file_id) == data
            assert nodes[2].counters.snapshot()["downloads"] == 1
        finally:
            await stop_nodes(nodes)

    run(go())


def test_failed_origin_fetch_does_not_poison_retry(tmp_path):
    data = corpus(30_000, 3)

    async def go():
        nodes = await start_nodes(make_cluster(1, rf=1), tmp_path, SERVE_ON)
        try:
            n = nodes[1]
            m, _ = await n.upload(data, "flaky.bin")
            victim = m.chunks[0].digest
            p = Path(n.store.chunks._path_str(victim))
            raw = p.read_bytes()
            p.write_bytes(bytes([raw[0] ^ 0xFF]) + raw[1:])
            outs = await asyncio.gather(*(read_all(n, m.file_id)
                                          for _ in range(4)),
                                        return_exceptions=True)
            assert all(isinstance(o, Exception) for o in outs)
            n.store.chunks.put(victim, raw, verify=False)
            assert await read_all(n, m.file_id) == data
        finally:
            await stop_nodes(nodes)

    run(go())


def test_waiter_survives_cancelled_leader(tmp_path):
    data = corpus(30_000, 4)

    async def go():
        nodes = await start_nodes(make_cluster(1, rf=1), tmp_path, SERVE_ON)
        try:
            n = nodes[1]
            m, _ = await n.upload(data, "x.bin")
            orig = n._fetch_verified_direct

            async def slow(*a, **kw):
                await asyncio.sleep(0.1)
                return await orig(*a, **kw)

            n._fetch_verified_direct = slow
            leader = asyncio.ensure_future(read_all(n, m.file_id))
            await asyncio.sleep(0.02)
            waiter = asyncio.ensure_future(read_all(n, m.file_id))
            await asyncio.sleep(0.02)
            leader.cancel()
            await asyncio.gather(leader, return_exceptions=True)
            assert await waiter == data
        finally:
            await stop_nodes(nodes)

    run(go())


def test_delete_drops_cached_entries(tmp_path):
    data = corpus(40_000, 5)

    async def go():
        nodes = await start_nodes(make_cluster(2, rf=1), tmp_path, SERVE_ON)
        try:
            m, _ = await nodes[1].upload(data, "temp.bin")
            for n in nodes.values():
                assert await read_all(n, m.file_id) == data
                assert len(n.serve.cache) > 0
            assert await nodes[1].delete(m.file_id)
            for n in nodes.values():
                assert len(n.serve.cache) == 0
                assert n.serve.cache.bytes_used == 0
        finally:
            await stop_nodes(nodes)

    run(go())


def _get(url, headers=None):
    req = urllib.request.Request(url, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=20) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _post(url, data):
    req = urllib.request.Request(url, data=data, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=20) as r:
            return r.status, dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers)


@pytest.mark.parametrize("route", ["download", "upload"])
def test_http_sheds_503_when_gate_full(tmp_path, route):
    data = corpus(20_000, 6)
    serve = ServeConfig(download_slots=1, upload_slots=1, queue_depth=0,
                        retry_after_s=2.5)

    async def go():
        cluster = make_cluster(1, rf=1)
        nodes = await start_nodes(cluster, tmp_path, serve)
        port = cluster.peer(1).port
        n = nodes[1]
        try:
            m, _ = await n.upload(data, "shed.bin")
            gate = getattr(n.serve.admission, route)
            await gate.acquire()            # hold the only slot
            if route == "download":
                url = f"http://127.0.0.1:{port}/download?fileId={m.file_id}"
                st, h, _ = await asyncio.to_thread(_get, url)
            else:
                url = f"http://127.0.0.1:{port}/upload?name=x.bin"
                st, h = await asyncio.to_thread(_post, url, data[:999])
            assert st == 503 and h.get("Retry-After") == "3"
            gate.release()
            if route == "download":
                st, _, body = await asyncio.to_thread(_get, url)
                assert st == 200 and body == data
            else:
                st, _ = await asyncio.to_thread(_post, url, data[:999])
                assert st == 201
            snap = n.metrics()
            assert snap["http_shed"] == 1
            assert snap["serve"]["admission"][route]["shed"] == 1
            assert gate.stats()["active"] == 0
        finally:
            await stop_nodes(nodes)

    run(go())


def test_http_client_hanging_up_while_queued_frees_its_place(tmp_path):
    """A download queued behind a full gate whose client hangs up leaves
    the queue at once (the port's own disconnect probe on its asyncio
    streams server) and never takes the slot."""
    data = corpus(20_000, 15)

    async def go():
        cluster = make_cluster(1, rf=1)
        nodes = await start_nodes(cluster, tmp_path, ServeConfig(
            download_slots=1, queue_depth=4))
        n = nodes[1]
        gate = n.serve.admission.download
        addr = cluster.peer(1)
        try:
            m, _ = await n.upload(data, "q.bin")
            await gate.acquire()                 # hold the only slot
            reader, writer = await asyncio.open_connection(addr.host,
                                                           addr.port)
            writer.write((f"GET /download?fileId={m.file_id} HTTP/1.1\r\n"
                          "Host: x\r\n\r\n").encode())
            await writer.drain()
            for _ in range(200):
                if gate.stats()["waiting"] == 1:
                    break
                await asyncio.sleep(0.01)
            assert gate.stats()["waiting"] == 1
            writer.close()                       # the client hangs up
            for _ in range(200):
                if gate.stats()["disconnects"] == 1:
                    break
                await asyncio.sleep(0.01)
            s = gate.stats()
            assert s["disconnects"] == 1 and s["waiting"] == 0
            assert n.counters.snapshot()["http_client_gone"] == 1
            gate.release()
            assert gate.stats()["active"] == 0   # nobody took the slot
        finally:
            await stop_nodes(nodes)

    run(go())


def test_default_config_serving_tier_fully_off(tmp_path):
    """ServeConfig(): no cache, no hedge policy, every gate off, no
    deadline field on the wire, and /metrics serve in dfs_tpu's default
    shape."""
    data = corpus(40_000, 7)

    async def go():
        cluster = make_cluster(2)
        nodes = await start_nodes(cluster, tmp_path)
        try:
            n = nodes[1]
            assert n.serve.cache is None and not n.serve.read_path_enabled
            assert n.serve.hedge is None and n.client._flight is None
            adm = n.serve.admission
            assert not (adm.download.enabled or adm.upload.enabled
                        or adm.internal.enabled)
            sent = []
            orig = n.client._call_once

            async def spy(peer, header, *a):
                sent.append(header)      # the wire header, as sent
                return await orig(peer, header, *a)

            n.client._call_once = spy
            m, _ = await n.upload(data, "plain.bin")
            _, got = await n.download(m.file_id)
            assert got == data
            assert sent and not any("deadline" in h for h in sent)
            assert n.serve.flight.stats()["leads"] == 0
            assert n.metrics()["serve"] == RefServingTier(
                RefServeConfig()).stats()
            assert n.metrics()["serve"]["cache"] == {"enabled": False}
        finally:
            await stop_nodes(nodes)

    run(go())


def test_dispatch_drops_expired_and_wire_carries_remaining(tmp_path):
    async def go():
        cluster = make_cluster(2)
        nodes = await start_nodes(cluster, tmp_path)
        try:
            n1, n2 = nodes[1], nodes[2]
            sent = []
            orig = n1.client._call_once

            async def spy(peer, header, *a):
                sent.append(header)      # the wire header, as sent
                return await orig(peer, header, *a)

            n1.client._call_once = spy
            tok = deadline.activate(30.0)
            try:
                resp, _ = await n1.client.call(cluster.peer(2),
                                               {"op": "health"})
            finally:
                deadline.restore(tok)
            assert resp["ok"] and 29 < sent[-1]["deadline"] <= 30
            tok = deadline.activate(-1.0)
            try:
                resp, _ = await n2._dispatch({"op": "get_chunk",
                                              "digest": "0" * 64}, b"")
            finally:
                deadline.restore(tok)
            assert resp == {"ok": False, "error": "deadline expired"}
            assert n2.counters.snapshot()["deadline_drops"] == 1
            # an expired budget off the wire: the receiver drops it
            from dfs_tpu_torch.comm.rpc import RpcRemoteError
            with pytest.raises(RpcRemoteError, match="deadline expired"):
                await orig(cluster.peer(2), {"op": "health",
                                             "deadline": 0.0}, b"", None,
                           {"out": 0, "in": 0})
            assert n2.counters.snapshot()["deadline_drops"] == 2
            # the client refuses to send expired work
            from dfs_tpu_torch.comm.rpc import DeadlineExpired
            tok = deadline.activate(-1.0)
            try:
                with pytest.raises(DeadlineExpired):
                    await n1.client.call(cluster.peer(2), {"op": "health"})
            finally:
                deadline.restore(tok)
            assert n1.client.rpc_stats.rows()[-1][2][1] >= 1
        finally:
            await stop_nodes(nodes)

    run(go())


def test_http_deadline_header_sheds_expired_request(tmp_path):
    data = corpus(20_000, 8)

    async def go():
        cluster = make_cluster(1, rf=1)
        nodes = await start_nodes(cluster, tmp_path,
                                  ServeConfig(download_slots=2))
        n = nodes[1]
        port = cluster.peer(1).port
        try:
            m, _ = await n.upload(data, "f.bin")
            url = f"http://127.0.0.1:{port}/download?fileId={m.file_id}"
            before = n.counters.snapshot().get("downloads", 0)
            st, h, _ = await asyncio.to_thread(
                _get, url, {"X-Dfs-Deadline": "0"})
            assert st == 503 and "Retry-After" in h
            adm = n.serve.admission.download.stats()
            assert adm["deadlineShed"] == 1 and adm["shed"] == 0
            assert n.counters.snapshot().get("downloads", 0) == before
            for hdr in ({}, {"X-Dfs-Deadline": "soon"}):
                st, _, body = await asyncio.to_thread(_get, url, hdr)
                assert st == 200 and body == data
        finally:
            await stop_nodes(nodes)

    run(go())


def test_streamed_download_stops_at_mid_stream_deadline(tmp_path):
    data = corpus(60_000, 9)

    async def go():
        cluster = make_cluster(1, rf=1)
        nodes = await start_nodes(cluster, tmp_path)
        n = nodes[1]
        try:
            m, _ = await n.upload(data, "f.bin")
            n._FETCH_BATCH_BYTES = 4096        # ~15 batches
            orig = n._fetch_verified_direct

            async def slow(*a, **kw):           # a slow disk: 60 ms a batch
                await asyncio.sleep(0.06)
                return await orig(*a, **kw)

            n._fetch_verified_direct = slow
            addr = cluster.peer(1)
            reader, writer = await asyncio.open_connection(addr.host,
                                                           addr.port)
            writer.write((f"GET /download?fileId={m.file_id} HTTP/1.1\r\n"
                          "Host: x\r\nX-Dfs-Deadline: 0.3\r\n"
                          "Connection: close\r\n\r\n").encode())
            await writer.drain()
            out = await reader.read(-1)
            writer.close()
            head, _, body = out.partition(b"\r\n\r\n")
            assert head.startswith(b"HTTP/1.1 200")
            assert len(body) < len(data)
            assert n.counters.snapshot()["deadline_drops"] >= 1
        finally:
            await stop_nodes(nodes)

    run(go())


HEDGED = ServeConfig(hedge_budget_per_s=50.0, hedge_floor_s=0.05,
                     hedge_cap_s=0.3)


def test_hedged_read_beats_slow_replica(tmp_path):
    """3 nodes, rf 2, node 3 answering every frame 500 ms late: node 2's
    remote chunks are the {3, 1}-owned ones, so a hedged read from node 2
    races node 1 and wins."""
    data = corpus(60_000, 10)

    async def go():
        cluster = make_cluster(3)
        nodes = await start_nodes(cluster, tmp_path, {2: HEDGED},
                                  slow={3})
        try:
            m, _ = await nodes[1].upload(data, "t.bin")
            _, body = await nodes[2].download(m.file_id)     # warm
            assert bytes(body) == data
            nodes[3].slow_s = 0.5
            lats = []
            for _ in range(2):
                t0 = time.monotonic()
                _, body = await nodes[2].download(m.file_id)
                assert bytes(body) == data
                lats.append(time.monotonic() - t0)
            nodes[3].slow_s = 0.0
            hs = nodes[2].serve.hedge.stats()
            assert hs["fired"] >= 1 and hs["won"] >= 1
            assert min(lats) < 0.4, lats      # unhedged: > 0.5 s
            assert nodes[1].serve.hedge is None
            assert nodes[2].metrics()["serve"]["hedge"]["won"] >= 1
        finally:
            await stop_nodes(nodes)

    run(go())


def test_hedge_budget_empty_waits_primary_out(tmp_path):
    data = corpus(60_000, 11)

    async def go():
        cluster = make_cluster(3)
        nodes = await start_nodes(cluster, tmp_path, {2: ServeConfig(
            hedge_budget_per_s=0.000001, hedge_floor_s=0.01,
            hedge_cap_s=0.1)}, slow={3})
        try:
            m, _ = await nodes[1].upload(data, "t.bin")
            h = nodes[2].serve.hedge
            h._tokens = 0.0
            nodes[3].slow_s = 0.15
            _, body = await nodes[2].download(m.file_id)
            nodes[3].slow_s = 0.0
            assert bytes(body) == data
            hs = h.stats()
            assert hs["fired"] == 0 and hs["denied"] >= 1
        finally:
            await stop_nodes(nodes)

    run(go())


def test_hedged_fetch_cancellation_reaps_racers(tmp_path):
    data = corpus(60_000, 12)

    async def go():
        cluster = make_cluster(3)
        nodes = await start_nodes(cluster, tmp_path, {2: HEDGED},
                                  slow={1, 3})
        try:
            m, _ = await nodes[1].upload(data, "t.bin")
            await nodes[2].download(m.file_id)               # warm
            nodes[1].slow_s = nodes[3].slow_s = 0.4
            before = set(asyncio.all_tasks())
            dl = asyncio.create_task(nodes[2].download(m.file_id))
            await asyncio.sleep(0.15)       # the hedge fired, both racing
            assert nodes[2].serve.hedge.stats()["fired"] >= 1
            dl.cancel()
            with pytest.raises(asyncio.CancelledError):
                await dl
            await asyncio.sleep(0.05)
            # frames in service on nodes 1 and 3 run on; node 2's racers
            # must not
            leaked = [t for t in asyncio.all_tasks() - before
                      if not t.done() and t is not asyncio.current_task()
                      and "slow_frame" not in t.get_coro().__qualname__]
            assert not leaked, leaked
            nodes[1].slow_s = nodes[3].slow_s = 0.0
        finally:
            await stop_nodes(nodes)

    run(go())


def test_hedged_store_lands_on_backup(tmp_path):
    """The write side: node 1's replication train to a slow owner is
    raced by a train to the next ring holder; the upload acks with the
    backup's copies and queues them for repair."""
    data = corpus(30_000, 13)

    async def go():
        cluster = make_cluster(4)
        nodes = await start_nodes(cluster, tmp_path, {1: HEDGED},
                                  slow={3})
        try:
            await nodes[1].upload(corpus(2_000, 14), "warm.bin")
            nodes[3].slow_s = 0.5
            t0 = time.monotonic()
            m, st = await nodes[1].upload(data, "w.bin")
            took = time.monotonic() - t0
            nodes[3].slow_s = 0.0
            hs = nodes[1].serve.hedge.stats()
            assert hs["fired"] >= 1 and hs["won"] >= 1, hs
            assert st["minCopies"] >= 2 and took < 2.0
            assert nodes[1].under_replicated
            assert await read_all(nodes[4], m.file_id) == data
        finally:
            await stop_nodes(nodes)

    run(go())
