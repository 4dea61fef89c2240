"""The port's chaos plane (dfs_tpu_torch.chaos) against dfs_tpu's: the same
fault schedule for the same (ChaosConfig, node id), the same registry and
validation, no injector by default, and on in-process port clusters on the
CPU the faults dfs_tpu's tests inject (ENOSPC, a one-way partition, torn
frames), every one of the 11 crash points reached on its path, and one
real SIGKILL at ``upload.before_manifest`` followed by a clean restart."""

from __future__ import annotations

import asyncio
import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from dfs_tpu.chaos import CRASH_POINTS as REF_CRASH_POINTS
from dfs_tpu.chaos import MUTABLE_KNOBS as REF_MUTABLE_KNOBS
from dfs_tpu.chaos import ChaosInjector as RefInjector
from dfs_tpu.config import ChaosConfig as RefChaosConfig

from dfs_tpu_torch.chaos import (CRASH_POINTS, MUTABLE_KNOBS, ChaosError,
                                 ChaosInjector)
from dfs_tpu_torch.config import (CDCParams, ChaosConfig, NodeConfig,
                                  SimConfig, TierConfig)
from dfs_tpu_torch.meta.manifest import Manifest
from dfs_tpu_torch.node.runtime import StorageNodeServer, UploadError
from dfs_tpu_torch.obs.journal import read_events

from tests.test_torch_cluster import (CDC, _raw, client, corpus, http,
                                      make_cluster)

REPO = Path(__file__).resolve().parent.parent


class _Events:
    """An obs stand-in that keeps what the injector journals."""

    def __init__(self) -> None:
        self.seen: list[tuple[str, dict]] = []

    def event(self, etype: str, **fields) -> None:
        self.seen.append((etype, fields))


def _script(inj, n: int = 96) -> list:
    """One scripted call sequence: rolls, partition checks, truncation
    decisions, outbound-call faults and store-hook calls, in a fixed
    order; each step's outcome (a value or the error it raised)."""
    hook = inj.store_hook()
    out = []

    async def go() -> None:
        for i in range(n):
            step = i % 5
            peer = i % 4 + 1
            try:
                if step == 0:
                    out.append(("roll", inj.roll()))
                elif step == 1:
                    inj.check_partition(peer, "store_chunks")
                    out.append(("part", True))
                elif step == 2:
                    out.append(("trunc", inj.truncate_now(peer, "get_chunk")))
                elif step == 3:
                    await inj.before_rpc(peer, "has_chunks")
                    out.append(("rpc", True))
                else:
                    hook("put" if i % 2 else "get", f"{i:064x}")
                    out.append(("disk", True))
            except OSError as e:
                out.append((step, type(e).__name__, e.errno))

    asyncio.run(go())
    return out


SCHEDULES = [
    (13, 1, {"rpc_drop_rate": 0.3, "rpc_truncate_rate": 0.25,
             "disk_error_rate": 0.2}),
    (13, 4, {"rpc_drop_rate": 0.3, "rpc_truncate_rate": 0.25,
             "disk_error_rate": 0.2, "partition": "2,3"}),
    (20261017, 2, {"rpc_drop_rate": 0.5, "disk_full": True}),
    (0, 5, {"rpc_truncate_rate": 1.0, "disk_error_rate": 0.05,
            "partition": "1"}),
]


@pytest.mark.parametrize("seed,node_id,knobs", SCHEDULES)
def test_fault_schedule_matches_dfs_tpu(seed, node_id, knobs):
    """The same (config, node id) gives the same decisions, the same
    journaled events and the same stats() as dfs_tpu's injector."""
    ev_p, ev_r = _Events(), _Events()
    port = ChaosInjector(ChaosConfig(enabled=True, seed=seed, **knobs),
                         node_id, obs=ev_p)
    ref = RefInjector(RefChaosConfig(enabled=True, seed=seed, **knobs),
                      node_id, obs=ev_r)
    got, want = _script(port), _script(ref)
    assert got == want
    assert ev_p.seen == ev_r.seen and ev_p.seen
    assert port.stats() == ref.stats()
    # a runtime knob swap journals and reports the same
    assert port.set(serve_delay_s=0.5, partition="") \
        == ref.set(serve_delay_s=0.5, partition="")
    assert ev_p.seen[-1] == ev_r.seen[-1] == (
        "chaos_set", {"knobs": {"partition": "", "serve_delay_s": 0.5}})
    assert _script(port, 40) == _script(ref, 40)


def test_registry_knobs_and_config_match_dfs_tpu():
    assert CRASH_POINTS == REF_CRASH_POINTS and len(CRASH_POINTS) == 11
    assert MUTABLE_KNOBS == REF_MUTABLE_KNOBS
    assert dataclasses.asdict(ChaosConfig()) \
        == dataclasses.asdict(RefChaosConfig())
    assert issubclass(ChaosError, OSError)


@pytest.mark.parametrize("bad", [
    {"rpc_drop_rate": 1.5}, {"rpc_delay_s": -1},
    {"partition": "2,not-a-node"}, {"partition": 5},
    {"rpc_delay_peers": "x"}, {"disk_error_rate": -0.1},
    {"rpc_truncate_rate": 2.0}, {"serve_delay_s": -0.5},
    {"disk_delay_s": -1.0}])
def test_config_validation_rejects_what_dfs_tpu_rejects(bad):
    with pytest.raises(ValueError):
        RefChaosConfig(**bad)
    with pytest.raises(ValueError):
        ChaosConfig(**bad)


@pytest.mark.parametrize("kind", ["Port", "Ref"])
def test_injector_knob_validation(kind):
    """dfs_tpu's test_injector_knob_validation, on both injectors."""
    Inj, Cfg = ((ChaosInjector, ChaosConfig) if kind == "Port"
                else (RefInjector, RefChaosConfig))
    inj = Inj(Cfg(enabled=True), 1)
    with pytest.raises(ValueError):
        inj.set(nonsense_knob=1)
    with pytest.raises(ValueError):
        inj.set(seed=7)                  # boot-only
    with pytest.raises(ValueError):
        inj.set(crash_point="not.a.registered.point")
    with pytest.raises(ValueError):
        Inj(Cfg(enabled=True, crash_point="bogus.point"), 1)
    for point in sorted(CRASH_POINTS):
        inj.set(crash_point=point)
    inj.set(crash_point="")


# ------------------------------------------------------------------ #
# nodes
# ------------------------------------------------------------------ #

async def _start(cluster, root, chaos=None, **kw):
    """Port nodes on the CPU; ``chaos`` maps node id -> ChaosConfig."""
    nodes = {}
    for p in cluster.peers:
        n = StorageNodeServer(NodeConfig(
            node_id=p.node_id, cluster=cluster, data_root=root, cdc=CDC,
            health_probe_s=0, device="cpu",
            chaos=(chaos or {}).get(p.node_id, ChaosConfig()), **kw))
        await n.start()
        nodes[p.node_id] = n
    return nodes


async def _stop(nodes):
    for n in nodes.values():
        await n.stop()


def _run(coro):
    asyncio.run(asyncio.wait_for(coro, timeout=60))


async def _events(node) -> list[dict]:
    await asyncio.to_thread(node.obs.journal.flush)
    return (await asyncio.to_thread(node.obs.journal.tail, 0.0, 4096)
            )["events"]


def test_default_node_has_no_injector(tmp_path):
    """ChaosConfig() builds no injector, no store hook and no client
    seam; /chaos answers dfs_tpu's 404 and /metrics chaos is disabled."""
    assert ChaosConfig() == ChaosConfig(enabled=False)
    cluster = make_cluster(1, rf=1)

    async def go():
        nodes = await _start(cluster, tmp_path)
        n = nodes[1]
        try:
            assert n.chaos is None and n.store.chunks.fault is None
            assert n.client._chaos is None
            assert n.chaos_stats() == {"enabled": False}
            port = cluster.peer(1).port
            for method in ("GET", "POST"):
                st, _, out = await http(_raw, port, method, "/chaos",
                                        None, b"{}")
                assert (st, out) == (404, b"Chaos disabled (boot with "
                                          b"--chaos)")
            st, _, out = await http(_raw, port, "GET", "/metrics")
            assert json.loads(out)["chaos"] == {"enabled": False}
        finally:
            await _stop(nodes)

    _run(go())


def test_enospc_answers_507_and_reads_keep_serving(tmp_path):
    """disk_full on node 2: an upload there answers 507 and journals
    disk_pressure after the trace-stamped chaos_inject; node 2 still
    serves an earlier file, and uploads at node 1 ack by handoff."""
    cluster = make_cluster(3, rf=2)
    pre, doomed, other = (corpus(30_000, seed=s) for s in (71, 72, 73))

    async def go():
        nodes = await _start(cluster, tmp_path,
                             chaos={2: ChaosConfig(enabled=True, seed=13)})
        try:
            m, _ = await nodes[1].upload(pre, "pre.bin")
            p2 = cluster.peer(2).port
            st, _, out = await http(_raw, p2, "POST", "/chaos", None,
                                    b'{"disk_full": true}')
            assert st == 200 and json.loads(out)["diskFull"] is True
            st, _, out = await http(_raw, p2, "POST", "/upload?name=d.bin",
                                    None, doomed)
            assert st == 507, (st, out)
            assert out.startswith(b"Insufficient storage")
            _, body = await nodes[2].download(m.file_id)
            assert bytes(body) == pre
            m3, s3 = await nodes[1].upload(other, "o.bin")
            assert s3["minCopies"] >= 2
            _, body = await nodes[3].download(m3.file_id)
            assert bytes(body) == other
            evs = await _events(nodes[2])
            kinds = [e["type"] for e in evs]
            assert "disk_pressure" in kinds and "chaos_set" in kinds
            inj = [e for e in evs if e["type"] == "chaos_inject"]
            assert inj and all(e["kind"] == "disk_full" for e in inj)
            assert any("trace" in e for e in inj)
            assert nodes[2].chaos.stats()["injected"]["disk_full"] >= 1
        finally:
            await _stop(nodes)

    _run(go())


def test_partition_acks_by_handoff_and_heals_by_repair(tmp_path):
    """1 -/-> 2: every upload at node 1 acks with two copies (handoff),
    the cut journals trace-stamped chaos_inject events; healed, repair
    puts every chunk on its owners and every file reads back identical
    from every node."""
    cluster = make_cluster(3, rf=2)

    async def go():
        nodes = await _start(
            cluster, tmp_path,
            chaos={1: ChaosConfig(enabled=True, seed=13, partition="2")})
        try:
            acked = []
            c1 = client(cluster, 1)
            for i in range(4):
                data = corpus(25_000, seed=80 + i)
                st = await http(c1.upload, data, f"p{i}.bin")
                assert st["minCopies"] >= 2 and st["handoffChunks"] > 0
                acked.append((nodes[1].store.manifests.load(st["fileId"]),
                              data))
            evs = await _events(nodes[1])
            # the boot ring catch-up's get_ring is background work, not a
            # request, and carries no trace
            cut = [e for e in evs if e["type"] == "chaos_inject"
                   and e["kind"] == "partition" and e["op"] != "get_ring"]
            assert cut and all(e["peer"] == 2 and "trace" in e
                               for e in cut)
            nodes[1].chaos.set(partition="")
            for _ in range(3):
                for n in nodes.values():
                    await n.repair_once()
            assert not nodes[1].under_replicated
            for m, data in acked:
                for c in m.chunks:
                    for owner in nodes[1].ring.current.owners(c.digest, 2):
                        assert nodes[owner].store.chunks.has(c.digest)
                for n in nodes.values():
                    _, body = await n.download(m.file_id)
                    assert bytes(body) == data
        finally:
            await _stop(nodes)

    _run(go())


def test_torn_frames_and_drops_lose_no_acked_write(tmp_path):
    """Drops and torn frames on node 1's client: what acks reads back
    identical from the other nodes, and the receivers keep serving."""
    cluster = make_cluster(3, rf=2)

    async def go():
        nodes = await _start(cluster, tmp_path, chaos={
            1: ChaosConfig(enabled=True, seed=9, rpc_drop_rate=0.2,
                           rpc_truncate_rate=0.2)})
        try:
            acked = []
            for i in range(6):
                data = corpus(20_000, seed=90 + i)
                try:
                    m, _ = await nodes[1].upload(data, f"t{i}.bin")
                    acked.append((m.file_id, data))
                except UploadError:
                    pass          # an unacked upload may be lost
            inj = nodes[1].chaos.stats()["injected"]
            assert inj.get("rpc_truncate", 0) > 0
            assert inj.get("rpc_drop", 0) > 0
            assert acked
            nodes[1].chaos.set(rpc_drop_rate=0.0, rpc_truncate_rate=0.0)
            for fid, data in acked:
                for i in (2, 3):
                    _, body = await nodes[i].download(fid)
                    assert bytes(body) == data
        finally:
            await _stop(nodes)

    _run(go())


class _Killed(BaseException):
    """Raised by the patched kill: nothing on the paths catches it."""


def _arm(node, point: str, hits: list) -> None:
    def kill() -> None:
        hits.append(point)
        raise _Killed(point)

    node.chaos._kill = kill
    node.chaos.set(crash_point=point)


async def _expect_kill(node, point, hits, coro) -> None:
    _arm(node, point, hits)
    with pytest.raises(_Killed):
        await coro
    assert hits[-1] == point
    node.chaos.set(crash_point="")


def test_every_crash_point_reaches_maybe_crash(tmp_path):
    """The 11 registered points, each armed in turn on a node whose kill
    is patched to raise: the upload path (``place.*``, ``upload.*``), a
    ``--tier`` demotion scan (``demote.*``) on 3 nodes at k = 1, and the
    ``--sim`` paths (``sim.*``) on one node."""
    hits: list[str] = []
    cluster = make_cluster(3, rf=2)
    tier = TierConfig(enabled=True, ec_k=1, hot_fraction=0.0,
                      min_idle_s=0.0, half_life_s=86400.0)

    async def upload_path():
        nodes = await _start(cluster, tmp_path / "t", tier=tier, chaos={
            i: ChaosConfig(enabled=True, seed=13) for i in (1, 2, 3)})
        n1 = nodes[1]
        try:
            for i, point in enumerate(sorted(
                    p for p in CRASH_POINTS
                    if p.startswith(("place.", "upload.")))):
                await _expect_kill(n1, point, hits, n1.upload(
                    corpus(9_000, seed=100 + i), f"c{i}.bin"))
            m, _ = await n1.upload(corpus(30_000, seed=110), "cold.bin")
            for point in ("demote.after_parity_write",
                          "demote.after_tier_flip"):
                await _expect_kill(n1, point, hits, n1.tier_scan_once())
            assert n1.store.manifests.load(m.file_id).tier == "cold"
            # the next scan's finish pass reclaims the surplus replicas
            await _expect_kill(n1, "demote.before_replica_delete", hits,
                               n1.tier_scan_once())
        finally:
            await _stop(nodes)

    one = make_cluster(1, rf=1)
    sim = SimConfig(enabled=True, min_chunk_bytes=1024,
                    rematerialize_reads=1)
    big = CDCParams(min_size=2048, avg_size=8192, max_size=65536)

    async def sim_path():
        n = StorageNodeServer(NodeConfig(
            node_id=1, cluster=one, data_root=tmp_path / "s", cdc=big,
            health_probe_s=0, device="cpu", sim=sim,
            chaos=ChaosConfig(enabled=True, seed=13)))
        await n.start()
        try:
            rng = np.random.default_rng(121)
            base = rng.integers(0, 256, 120_000, np.uint8).tobytes()

            def near(at: int, b: bytes) -> bytes:
                return base[:at] + b + base[at + len(b):]

            m1, _ = await n.upload(base, "f1.bin")
            m2, _ = await n.upload(near(60_000, b"@"), "f2.bin")
            assert n.store.chunks.delta_count() >= 1
            # the first read of the delta re-materializes it
            await _expect_kill(n, "sim.after_rematerialize", hits,
                               n.download(m2.file_id))
            await _expect_kill(n, "sim.after_delta_write", hits,
                               n.upload(near(30_000, b"#"), "f3.bin"))
            # deleting f1 leaves its chunks for the GC
            await _expect_kill(n, "sim.before_base_gc", hits,
                               n.delete(m1.file_id))
            await _expect_kill(n, "sim.band_compact", hits,
                               asyncio.to_thread(n.sim.bands.compact))
        finally:
            await n.stop()

    _run(upload_path())
    _run(sim_path())
    assert sorted(hits) == sorted(CRASH_POINTS)


# ------------------------------------------------------------------ #
# one real SIGKILL
# ------------------------------------------------------------------ #

def _get(port, path, timeout=30.0):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=timeout) as r:
        return r.status, r.read()


def _serve(tmp, ports, data_root, extra=()):
    return subprocess.Popen(
        [sys.executable, "-m", "dfs_tpu_torch.cli.main", "serve",
         "--node-id", "1", "--nodes", "1", "--replication-factor", "1",
         "--base-port", str(ports[0]), "--base-internal-port",
         str(ports[1]), "--data-root", str(data_root), "--device", "cpu",
         "--repair-interval", "0", "--probe-interval", "0", *extra],
        cwd=tmp, env={**os.environ, "PYTHONPATH": str(REPO)},
        stdout=(tmp / "node.log").open("ab"), stderr=subprocess.STDOUT)


def _wait_up(port, proc, timeout=60.0):
    t0 = time.monotonic()
    while True:
        assert proc.poll() is None, "node died during start-up"
        try:
            if _get(port, "/status", timeout=2)[0] == 200:
                return
        except OSError:
            pass
        assert time.monotonic() - t0 < timeout, "node never came up"
        time.sleep(0.2)


def test_sigkill_before_manifest_then_clean_restart(tmp_path):
    """A ``serve --chaos`` process acks one file, is armed at
    ``upload.before_manifest`` through POST /chaos, dies by SIGKILL on the
    next upload without an ack; a clean restart serves the acked file
    identical, journals boot_sweep, and no manifest names a missing
    chunk."""
    from tests.test_torch_cluster import _free_ports

    ports = _free_ports(2)
    root = tmp_path / "data"
    acked = corpus(30_000, seed=131)
    proc = _serve(tmp_path, ports, root, ("--chaos", "--chaos-seed", "13"))
    try:
        _wait_up(ports[0], proc)
        st, _, out = _raw(ports[0], "POST", "/upload?name=ok.bin",
                          body=acked)
        assert st == 201
        fid = json.loads(out)["fileId"]
        st, _, _ = _raw(ports[0], "POST", "/chaos",
                        body=b'{"crash_point": "upload.before_manifest"}')
        assert st == 200
        got_ack = False
        try:
            st, _, _ = _raw(ports[0], "POST", "/upload?name=doomed.bin",
                            body=corpus(30_000, seed=132))
            got_ack = st == 201
        except OSError:
            pass                          # the connection died with it
        assert proc.wait(timeout=30) == -signal.SIGKILL
        assert not got_ack
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    t_kill = time.time()
    proc = _serve(tmp_path, ports, root)
    try:
        _wait_up(ports[0], proc)
        st, body = _get(ports[0], f"/download?fileId={fid}")
        assert st == 200 and body == acked
        st, body = _get(ports[0], "/files")
        assert [f["fileId"] for f in json.loads(body)] == [fid]
    finally:
        proc.terminate()
        proc.wait(timeout=10)
    node = root / "node-1"
    evs, _ = read_events(node / "journal", since=t_kill)
    assert [e for e in evs if e["type"] == "boot_sweep"]
    for p in (node / "manifests").glob("*.json"):
        m = Manifest.from_json(p.read_text())
        for d in m.all_digests():
            assert (node / "chunks" / d[:2] / d).is_file()
