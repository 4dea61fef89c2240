"""The census plane of the port against dfs_tpu's: ``ChunkStore.inventory``
over one data root, the census expectation, bucket diff and report (a
drilled-down divergence and the ``max_listed`` cap included), the metrics
history under one fake clock, the doctor's fifteen rules on synthetic
snapshots, and the rendered texts; then an in-process 3-node port cluster
on the CPU: a clean census, a partial one with a node stopped, the doctor's
``dead_peer``, ``/metrics/history`` and the ``disk_pressure`` crossing."""

import asyncio
import copy
import json
import socket
import urllib.request

import numpy as np
import pytest

from dfs_tpu.meta.manifest import Manifest as RefManifest
from dfs_tpu.obs import census as ref_census
from dfs_tpu.obs import doctor as ref_doctor
from dfs_tpu.obs.history import MetricsHistory as RefHistory
from dfs_tpu.ring import RingMap as RefRing
from dfs_tpu.store.cas import ChunkStore as RefStore

from dfs_tpu_torch.cli.main import main as cli_main
from dfs_tpu_torch.config import (CDCParams, CensusConfig, ClusterConfig,
                                  NodeConfig, PeerAddr)
from dfs_tpu_torch.meta.manifest import (ChunkRef, EcInfo, Manifest,
                                         StripeRef)
from dfs_tpu_torch.node.runtime import StorageNodeServer
from dfs_tpu_torch.obs import census, doctor
from dfs_tpu_torch.obs.history import MetricsHistory
from dfs_tpu_torch.ring import RingMap
from dfs_tpu_torch.store.cas import ChunkStore
from dfs_tpu_torch.utils.hashing import sha256_hex

CDC = CDCParams(min_size=64, avg_size=256, max_size=1024)
RNG_SEED = 20261018


def _blob(rng, n):
    return rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()


# ---------------------------------------------------------------------- #
# the inventory
# ---------------------------------------------------------------------- #

def test_inventory_equals_dfs_tpu_over_one_data_root(tmp_path):
    rng = np.random.default_rng(RNG_SEED)
    ours = ChunkStore(tmp_path)
    digests = []
    for _ in range(300):
        b = _blob(rng, int(rng.integers(1, 3000)))
        d = sha256_hex(b)
        ours.put(d, b)
        digests.append(d)
    ours.delete(digests[0])
    # strays the census must skip: a crash-leaked temp, a foreign name
    sub = tmp_path / digests[1][:2]
    (sub / ".tmp-leak").write_bytes(b"x")
    (sub / "not-a-digest").write_bytes(b"y")
    ref = RefStore(tmp_path)
    got, want = ours.inventory(), ref.inventory()
    assert got == want
    assert got["chunks"] == 299 and len(got["buckets"]) > 100
    prefixes = sorted({d[:2] for d in digests[:40]})
    for cap in (1, 4096):
        assert ours.inventory(prefixes, list_cap=cap) == \
            ref.inventory(prefixes, list_cap=cap)
    assert ours.bytes_total() == ref.bytes_total() == got["bytes"]
    assert ours.count() == 299
    b = _blob(rng, 100)
    ours.put(sha256_hex(b), b)
    assert ours.bytes_total() == got["bytes"] + 100
    ours.delete(sha256_hex(b))
    assert ours.bytes_total() == got["bytes"]


# ---------------------------------------------------------------------- #
# expectation, diff, report
# ---------------------------------------------------------------------- #

def _manifests(rng):
    """Replicated files (one digest shared between two), and one EC file
    of 2 stripes at k = 2: the port's objects and dfs_tpu's, from one
    JSON."""
    out = []
    shared = None
    for f in range(6):
        chunks, off = [], 0
        for i in range(int(rng.integers(3, 9))):
            ln = int(rng.integers(100, 5000))
            d = sha256_hex(_blob(rng, 32))
            if f == 1 and i == 0:
                d, ln = shared
            if f == 0 and i == 0:
                shared = (d, ln)
            chunks.append(ChunkRef(index=i, offset=off, length=ln,
                                   digest=d))
            off += ln
        out.append(Manifest(file_id=sha256_hex(_blob(rng, 32)),
                            name=f"f{f}", size=off, fragmenter="cdc",
                            chunks=tuple(chunks)))
    chunks = tuple(ChunkRef(index=i, offset=i * 1000, length=1000,
                            digest=sha256_hex(_blob(rng, 32)))
                   for i in range(4))
    ec = EcInfo(k=2, stripes=tuple(
        StripeRef(p=sha256_hex(_blob(rng, 32)),
                  q=sha256_hex(_blob(rng, 32)), shard_len=1000)
        for _ in range(2)))
    out.append(Manifest(file_id=sha256_hex(_blob(rng, 32)), name="ec",
                        size=4000, fragmenter="cdc", chunks=chunks, ec=ec))
    return out, [RefManifest.from_json(m.to_json()) for m in out]


def _observed(expected, rng):
    """Holdings per node from the expectation, with a lost copy, an
    orphan and an extra copy planted."""
    held: dict[int, set[str]] = {}
    for d, nodes in expected.items():
        for n in nodes:
            held.setdefault(n, set()).add(d)
    victim = sorted(expected)[3]
    held[expected[victim][0]].discard(victim)
    held.setdefault(3, set()).add(sha256_hex(b"orphan"))
    extra = sorted(expected)[5]
    spare = [n for n in (1, 2, 3, 4) if n not in expected[extra]][0]
    held[spare].add(extra)
    return held


def _inventories(mod, held, lengths, dead=()):
    lens = dict(lengths)
    lens[sha256_hex(b"orphan")] = 77
    inv = {}
    for n in (1, 2, 3, 4):
        if n in dead:
            inv[n] = None
            continue
        table = mod.summarize_expected({d: (n,) for d in held.get(n, ())},
                                       lens)
        inv[n] = {"buckets": table.get(n, {}),
                  "chunks": len(held.get(n, ())),
                  "bytes": sum(lens[d] for d in held.get(n, ()))}
    return inv


@pytest.mark.parametrize("window", ["static", "hash", "migrating"])
def test_census_functions_equal_dfs_tpu(window):
    rng = np.random.default_rng(RNG_SEED + 1)
    ms, ref_ms = _manifests(rng)
    if window == "static":
        cur, prev = RingMap.static([1, 2, 3, 4]), None
    else:
        cur = RingMap.hashed({1: 1.0, 2: 1.0, 3: 1.0, 4: 1.0}, 2, 32)
        prev = RingMap.hashed({1: 1.0, 2: 1.0, 3: 1.0, 4: 0.3}, 1, 32) \
            if window == "migrating" else None
    r_cur = RefRing.from_dict(cur.to_dict())
    r_prev = RefRing.from_dict(prev.to_dict()) if prev else None
    got = census.expected_state_ring(ms, cur, prev, 2)
    want = ref_census.expected_state_ring(ref_ms, r_cur, r_prev, 2)
    assert got == want
    if window == "static":
        assert census.expected_state(ms, [1, 2, 3, 4], 2) == \
            ref_census.expected_state(ref_ms, [1, 2, 3, 4], 2)
    expected, cur_exp, lengths, _ = got
    exp_by_node = census.summarize_expected(expected, lengths)
    assert exp_by_node == ref_census.summarize_expected(expected, lengths)
    held = _observed(cur_exp, rng)
    for dead in ((), (4,)):
        inv = _inventories(census, held, lengths, dead)
        assert inv == _inventories(ref_census, held, lengths, dead)
        drilled = {}
        for n, one in inv.items():
            if one is None:
                continue
            mism = census.diff_buckets(exp_by_node.get(n, {}),
                                       one["buckets"])
            assert mism == ref_census.diff_buckets(
                exp_by_node.get(n, {}), one["buckets"])
            if mism:
                drilled[n] = {p: sorted(d for d in held.get(n, ())
                                        if d[:2] == p)
                              for p in mism[:census.DRILL_BUCKET_CAP]}
        assert drilled, "the planted divergence drills"
        for max_listed in (1, 64):
            rep = census.build_report(expected, lengths, inv, drilled,
                                      max_listed, cur_exp)
            ref_rep = ref_census.build_report(expected, lengths, inv,
                                              drilled, max_listed, cur_exp)
            assert json.dumps(rep, sort_keys=True) == \
                json.dumps(ref_rep, sort_keys=True)
            if window != "migrating" and not dead:
                assert rep["underReplicatedTotal"] >= 1
                assert rep["orphanedTotal"] == 1
                assert rep["overReplicatedTotal"] >= 1
            rep["capacity"] = {"nodes": {"1": {"casBytes": 10,
                                               "casChunks": 1,
                                               "diskFreeBytes": 5 << 30,
                                               "diskTotalBytes": 9 << 30},
                                         "2": None},
                               "clusterCasBytes": 10, "clusterChunks": 1,
                               "logicalBytes": 20, "uniqueBytes": 10,
                               "dedupRatio": 2.0}
            rep["peersFailed"] = len(dead)
            assert census.render_census(rep) == \
                ref_census.render_census(rep)
            assert census.render_df(rep) == ref_census.render_df(rep)


# ---------------------------------------------------------------------- #
# metrics history
# ---------------------------------------------------------------------- #

def test_history_equals_dfs_tpu_under_one_clock():
    ours = MetricsHistory(10.0, 12, 3, 5)
    ref = RefHistory(10.0, 12, 3, 5)
    rng = np.random.default_rng(RNG_SEED + 2)
    t = 1_000_000.0
    for i in range(400):
        t += float(rng.uniform(0.5, 9.0))
        for name in ("capacity.casBytes", "counter.uploads", "cas.pending"):
            v = float(i * 1000 + rng.integers(0, 500))
            ours.observe(name, v, t)
            ref.observe(name, v, t)
    assert ours.names() == ref.names()
    for name in ours.names() + ["missing"]:
        assert ours.snapshot(name) == ref.snapshot(name)
        assert ours.last(name) == ref.last(name)
        assert ours.trend(name) == ref.trend(name)
        assert ours.trend(name, window_s=60.0) == \
            ref.trend(name, window_s=60.0)
    assert ours.stats() == ref.stats()
    assert ours.trend("capacity.casBytes") > 0


# ---------------------------------------------------------------------- #
# the doctor
# ---------------------------------------------------------------------- #

NOW = 1_700_000_000.0


def _healthy(nid):
    return {"nodeId": nid, "now": NOW, "receivedAt": NOW,
            "configHash": "c" * 64, "peersAlive": {},
            "underReplicated": 0, "admission": {}, "ingestStalls": {},
            "cache": {"enabled": False}, "hedge": {"enabled": False},
            "sentinel": {"enabled": False}, "rpcClient": {},
            "disk": {"freeBytes": 1 << 40, "totalBytes": 1 << 41},
            "capacity": {"enabled": False}, "census": None,
            "index": {"enabled": False}, "tier": {"enabled": False},
            "ring": {"epoch": 1, "migrating": False}}


def _fire(rule):
    """Snapshots of 3 nodes that fire exactly ``rule``."""
    s = {n: _healthy(n) for n in (1, 2, 3)}
    if rule == "dead_peer":
        s[3] = None
        s[1]["peersAlive"] = {"3": False}
    elif rule == "slow_peer":
        for n in (1, 2):
            s[n]["rpcClient"] = {
                "3:get_chunks": {"count": 40, "seconds": 20.0},
                f"{3 - n}:get_chunks": {"count": 40, "seconds": 0.4,
                                        "recentCount": 40,
                                        "recentSeconds": 0.4}}
        s[3]["rpcClient"] = {"1:get_chunks": {"count": 10,
                                              "seconds": 0.1}}
    elif rule == "shed_storm":
        s[2]["admission"] = {"upload": {"shed": 50, "shedRecent": 7}}
    elif rule == "credit_starvation":
        s[1]["ingestStalls"] = {"creditS": 4.5}
    elif rule == "cache_thrash":
        s[2]["cache"] = {"enabled": True, "hits": 100, "misses": 2000,
                         "evictions": 1500, "inserts": 2000}
    elif rule == "clock_skew":
        s[3]["now"] = NOW + 9.0
    elif rule == "config_drift":
        s[2]["configHash"] = "d" * 64
    elif rule == "loop_lag":
        s[1]["sentinel"] = {"enabled": True, "recentMaxLagS": 0.9,
                            "lagThresholdS": 0.25, "incidents": 3}
    elif rule == "capacity_trend":
        s[2]["capacity"] = {"enabled": True, "growthBytesPerS": 1 << 30}
        s[2]["disk"] = {"freeBytes": 100 << 30, "totalBytes": 200 << 30}
    elif rule == "underreplication":
        s[1]["census"] = {"at": NOW - 5, "underReplicated": 4}
    elif rule == "epoch_mismatch":
        s[3]["ring"] = {"epoch": 0, "migrating": False}
    elif rule == "rebalance_stuck":
        s[2]["ring"] = {"epoch": 1, "migrating": True,
                        "sinceProgressS": 500.0, "bytesMoved": 123}
    elif rule == "index_stale":
        s[1]["index"] = {"enabled": True, "syncS": 1.0,
                         "peerAgeS": {"2": 90.0, "3": 1.0}}
    elif rule == "tier_stall":
        s[3]["tier"] = {"enabled": True, "scanIntervalS": 10.0,
                        "sinceProgressS": 600.0, "errors": 2, "scans": 1}
    elif rule == "hedge_storm":
        s[2]["hedge"] = {"enabled": True, "budgetPerS": 0.1,
                         "firedRecent": 9, "deniedRecent": 0,
                         "windowCap": 256}
    return s


RULES = ["dead_peer", "slow_peer", "shed_storm", "credit_starvation",
         "cache_thrash", "clock_skew", "config_drift", "loop_lag",
         "capacity_trend", "underreplication", "epoch_mismatch",
         "rebalance_stuck", "index_stale", "tier_stall", "hedge_storm"]


@pytest.mark.parametrize("rule", RULES)
def test_doctor_rule_fires_as_in_dfs_tpu(rule):
    snaps = _fire(rule)
    got = doctor.diagnose(copy.deepcopy(snaps), NOW)
    assert got == ref_doctor.diagnose(copy.deepcopy(snaps), NOW)
    assert [f["rule"] for f in got] == [rule], got
    report = {"coordinator": 1, "now": NOW,
              "peersFailed": int(snaps[3] is None),
              "nodes": {str(k): v for k, v in snaps.items()},
              "findings": got}
    assert doctor.render_report(report) == ref_doctor.render_report(report)


def test_doctor_healthy_and_malformed_equal_dfs_tpu():
    healthy = {n: _healthy(n) for n in (1, 2)}
    assert doctor.diagnose(healthy, NOW) == []
    rep = {"coordinator": 1, "now": NOW, "peersFailed": 0,
           "nodes": {}, "findings": []}
    assert doctor.render_report(rep) == ref_doctor.render_report(rep)
    bad = {1: {**_healthy(1), "ring": "garbage", "admission": [1]}}
    assert doctor.diagnose(copy.deepcopy(bad), NOW) == \
        ref_doctor.diagnose(copy.deepcopy(bad), NOW)
    assert len(RULES) == 15


# ---------------------------------------------------------------------- #
# an in-process port cluster
# ---------------------------------------------------------------------- #

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


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return r.status, json.loads(r.read())


def test_census_doctor_history_on_a_port_cluster(tmp_path):
    ports = _free_ports(6)
    cluster = ClusterConfig(peers=tuple(
        PeerAddr(node_id=i + 1, host="127.0.0.1", port=ports[2 * i],
                 internal_port=ports[2 * i + 1]) for i in range(3)),
        replication_factor=2)
    rng = np.random.default_rng(RNG_SEED + 3)

    async def go():
        nodes = {}
        for nid in (1, 2, 3):
            n = StorageNodeServer(NodeConfig(
                node_id=nid, cluster=cluster, data_root=tmp_path, cdc=CDC,
                health_probe_s=0, device="cpu",
                census=CensusConfig(history_interval_s=0.05,
                                    history_slots=16)))
            await n.start()
            nodes[nid] = n
        try:
            for i in range(3):
                await nodes[i + 1].upload(_blob(rng, 30_000), f"c{i}")
            st, rep = await asyncio.to_thread(_get, ports[0], "/census")
            assert st == 200
            for k in ("underReplicatedTotal", "overReplicatedTotal",
                      "orphanedTotal", "inFlightTotal", "peersFailed"):
                assert rep[k] == 0, (k, rep)
            assert rep["replicationHistogram"] == {
                "2": rep["digests"]}
            cap = rep["capacity"]
            assert cap["clusterChunks"] == 2 * rep["digests"]
            assert nodes[1].metrics()["census"]["lastCensus"][
                "underReplicated"] == 0
            from dfs_tpu_torch.obs.prom import render_node_metrics
            assert "dfs_census_under_replicated 0" in \
                render_node_metrics(nodes[1])
            # the subcommands: exit 0 on a clean, answering cluster
            for argv in (["census"], ["census", "--json"], ["df"],
                         ["doctor", "--local"], ["doctor", "--json"]):
                assert await asyncio.to_thread(
                    cli_main, ["--port", str(ports[0]), *argv]) == 0, argv
            await asyncio.sleep(0.2)
            st, hist = await asyncio.to_thread(_get, ports[0],
                                               "/metrics/history")
            assert "capacity.casBytes" in hist["series"]
            st, one = await asyncio.to_thread(
                _get, ports[0], "/metrics/history?name=capacity.casChunks")
            assert one["enabled"] and one["resolutions"]
            st, doc = await asyncio.to_thread(_get, ports[0], "/doctor")
            assert doc["peersFailed"] == 0 and not [
                f for f in doc["findings"] if f["severity"] != "info"]
            # one node down: a partial census, no flood of findings
            await nodes[3].stop()
            nodes[3].client.close()
            del nodes[3]
            st, rep = await asyncio.to_thread(_get, ports[0], "/census")
            assert rep["peersFailed"] == 1
            assert await asyncio.to_thread(
                cli_main, ["--port", str(ports[0]), "census"]) == 1
            assert await asyncio.to_thread(
                cli_main, ["--port", str(ports[0]), "doctor"]) == 1
            assert rep["underReplicatedTotal"] == 0
            assert rep["capacity"]["nodes"]["3"] is None
            st, doc = await asyncio.to_thread(_get, ports[2], "/doctor")
            dead = [f for f in doc["findings"] if f["rule"] == "dead_peer"]
            assert dead and dead[0]["peers"] == [3]
            # the disk_pressure crossing: journaled once below 5% free,
            # re-armed only at 10%
            n1 = nodes[1]
            for task in (n1._history_task,):
                task.cancel()
            frees = [40, 30, 20, 80, 200, 40, 30]
            for free in frees:
                n1._disk_usage = lambda f=free: {"totalBytes": 1000,
                                                 "freeBytes": f}
                await n1._history_sample_once()
            await asyncio.to_thread(n1.obs.journal.flush)
            evs = (await asyncio.to_thread(n1.obs.journal.tail, 0.0,
                                           4096))["events"]
            assert [e["freeBytes"] for e in evs
                    if e["type"] == "disk_pressure"] == [40, 40]
        finally:
            for n in nodes.values():
                await n.stop()

    asyncio.run(go())
