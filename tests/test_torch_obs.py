"""The port's observability core (dfs_tpu_torch.obs, utils.trace) against
dfs_tpu's: the trace carriers parse alike, the flight-recorder journal is
one format both ways, stitching renders the same text, tail retention and
the sentinel behave as dfs_tpu's tests ask, the OpenMetrics page has
dfs_tpu's families and labels after the same upload, a traced upload on a
3-node port cluster stitches through ``/trace``, a default node traces,
journals and samples like dfs_tpu's, and ``device_trace`` on the CPU
writes a Chrome trace holding the span names."""

from __future__ import annotations

import asyncio
import dataclasses
import json
import types
from pathlib import Path

import pytest

from dfs_tpu import obs as ref_obs
from dfs_tpu.config import CDCParams as RefCDC
from dfs_tpu.config import CensusConfig as RefCensus
from dfs_tpu.config import ClusterConfig as RefCluster
from dfs_tpu.config import NodeConfig as RefNodeConfig
from dfs_tpu.config import ObsConfig as RefObsConfig
from dfs_tpu.config import PeerAddr as RefPeer
from dfs_tpu.obs import journal as ref_journal
from dfs_tpu.obs import stitch as ref_stitch

from dfs_tpu_torch import obs
from dfs_tpu_torch.config import ObsConfig
from dfs_tpu_torch.obs import Observability
from dfs_tpu_torch.obs import journal as port_journal
from dfs_tpu_torch.obs import stitch as port_stitch
from dfs_tpu_torch.utils import trace as port_trace

from tests.test_torch_cluster import (CDC, _raw, client, corpus, http,
                                      make_cluster)
from tests.test_torch_index import _run, _start, _stop

T, S = "0123456789abcdef" * 2, "fedcba9876543210"


@pytest.mark.parametrize("value", [
    None, "", "  ", f"{T}-{S}", f" {T}-{S} ", f"{T.upper()}-{S}",
    f"{T}{S}", f"{T}-{S}-x", f"{T[:-1]}-{S}", f"{T}-{S}0",
    f"0x{T[2:]}-{S}", f"{T}-+{S[1:]}", "-", f"{T}-", f"-{S}",
    f"{T[:-2]}_1-{S}"])
def test_parse_http_trace_matches_dfs_tpu(value):
    assert obs.parse_http_trace(value) == ref_obs.parse_http_trace(value)


@pytest.mark.parametrize("field", [
    None, {}, [], "x", {"t": T, "s": S}, {"t": T, "s": S, "f": 3},
    {"t": T, "s": S, "f": True}, {"t": T, "s": S, "f": "3"},
    {"t": T, "s": S, "f": 2.0}, {"t": T.upper(), "s": S},
    {"t": T, "s": S[:-1]}, {"t": T}, {"s": S}, {"t": 5, "s": S},
    {"t": T, "s": S, "extra": 1}])
def test_parse_wire_trace_matches_dfs_tpu(field):
    assert obs.parse_wire_trace(field) == ref_obs.parse_wire_trace(field)


def test_ids_and_config_match_dfs_tpu():
    assert (obs.TRACE_HEX, obs.SPAN_HEX) \
        == (ref_obs.TRACE_HEX, ref_obs.SPAN_HEX)
    for _ in range(8):
        assert ref_obs.is_id(obs.new_trace_id(), ref_obs.TRACE_HEX)
        assert ref_obs.is_id(obs.new_span_id(), ref_obs.SPAN_HEX)
    assert dataclasses.asdict(ObsConfig()) \
        == dataclasses.asdict(RefObsConfig())


@pytest.mark.parametrize("bad", [
    {"trace_ring": -1}, {"slow_span_s": 0}, {"tail_keep": -1},
    {"journal_bytes": -1}, {"journal_segment_bytes": 0},
    {"sentinel_interval_s": -1}, {"sentinel_lag_s": 0}])
def test_obs_config_rejects_what_dfs_tpu_rejects(bad):
    with pytest.raises(ValueError):
        RefObsConfig(**bad)
    with pytest.raises(ValueError):
        ObsConfig(**bad)


# ------------------------------------------------------------------ #
# the journal: one format, both ways
# ------------------------------------------------------------------ #

def _fake_clock(start: float = 1_790_000_000.0):
    t = [start]

    def now() -> float:
        t[0] += 0.001
        return round(t[0], 3)

    import time as _time
    return types.SimpleNamespace(time=now, monotonic=_time.monotonic,
                                 sleep=_time.sleep)


def _emit_all(mod, root: Path, monkeypatch, budget: int, segment: int):
    monkeypatch.setattr(mod, "time", _fake_clock())
    j = mod.Journal(root, node_id=3, total_bytes=budget,
                    segment_bytes=segment)
    for i in range(60):
        j.emit("chaos_inject" if i % 3 else "rpc_retry",
               {"i": i, "peer": i % 5, "pad": "x" * (i % 11)},
               trace=T if i % 2 else None)
        if i % 7 == 6:
            j.flush()              # batch boundaries land the same
    j.flush()
    j.close()
    return j.stats()


@pytest.mark.parametrize("budget,segment", [(16 << 20, 2 << 20),
                                            (1200, 300), (400, 4096)])
def test_journal_segments_identical_and_read_both_ways(tmp_path,
                                                       monkeypatch,
                                                       budget, segment):
    """The same emits under the same clock give the same segment files
    (names, bytes, what the budget kept) in either package, and each
    package's read_events reads both directories alike."""
    st_p = _emit_all(port_journal, tmp_path / "p", monkeypatch, budget,
                     segment)
    st_r = _emit_all(ref_journal, tmp_path / "r", monkeypatch, budget,
                     segment)
    assert st_p == st_r

    def files(d):
        return [(p.name, p.read_bytes()) for p in sorted(d.iterdir())]

    assert files(tmp_path / "p") == files(tmp_path / "r")
    for d in (tmp_path / "p", tmp_path / "r"):
        got = port_journal.read_events(d, limit=4096)
        assert got == ref_journal.read_events(d, limit=4096)
        assert got[0] and got[1] == 0
    # a torn final record written by either is skipped by both
    seg = sorted((tmp_path / "p").iterdir())[-1]
    seg.write_bytes(seg.read_bytes() + b'{"ts": 1, "type": "torn')
    assert port_journal.read_events(tmp_path / "p", limit=4096) \
        == ref_journal.read_events(tmp_path / "p", limit=4096)


# ------------------------------------------------------------------ #
# stitching, tail retention, the sentinel
# ------------------------------------------------------------------ #

def _spans():
    def sp(s, p, name, node, t0, d, **kw):
        return {"t": T, "s": s, "p": p, "name": name, "node": node,
                "t0": t0, "d": d, **kw}

    return [
        [sp("a" * 16, "c" * 16, "http./upload", 1, 10.0, 2.5,
            bytes=367),
         sp("b" * 16, "a" * 16, "upload.fragment", 1, 10.1, 0.4),
         sp("d" * 16, "a" * 16, "rpc.store_chunks", 1, 10.6, 1.7,
            peer=2, bytes=5 << 20)],
        [sp("e" * 16, "d" * 16, "peer.store_chunks", 2, 10.61, 1.6,
            peer=1, bytes=5 << 20),
         sp("f" * 16, "e" * 16, "cas.put_many", 2, 10.7, 1.5,
            err="OSError"),
         # a duplicate of node 1's rpc span with an error: it wins
         sp("d" * 16, "a" * 16, "rpc.store_chunks", 1, 10.6, 1.7,
            peer=2, err="ChaosError")],
        [sp("9" * 16, "8" * 16, "peer.has_chunks", 3, 10.2, 0.01),
         sp("7" * 16, "7" * 16, "self.parent", 3, 10.3, 0.02),
         sp("5" * 16, "6" * 16, "cycle.a", 3, 10.4, 0.03),
         sp("6" * 16, "5" * 16, "cycle.b", 3, 10.5, 0.04)],
        None,
    ]


@pytest.mark.parametrize("slow", [1.0, 0.01, 100.0])
def test_merge_and_render_match_dfs_tpu(slow):
    lists = _spans()
    merged = port_stitch.merge_spans(lists)
    assert merged == ref_stitch.merge_spans(lists)
    assert port_stitch.render_tree(merged, slow) \
        == ref_stitch.render_tree(merged, slow)
    # the peer answer order does not change the result
    rev = port_stitch.merge_spans(list(reversed(lists)))
    assert sorted(map(json.dumps, rev)) == sorted(map(json.dumps, merged))
    assert port_stitch.render_tree([]) == ref_stitch.render_tree([])


def test_tail_keeps_slow_trace():
    """dfs_tpu's test: with slow_span_s tiny every span pins its trace,
    and the trace outlives the ring's churn."""
    o = Observability(ObsConfig(trace_ring=4, tail_keep=16,
                                slow_span_s=1e-9), node_id=1)
    with o.request_span("http./upload"):
        pass
    tid = o._ring[-1][0]
    assert ObsConfig().slow_span_s == 1.0
    for _ in range(10):
        with o.request_span("http./status"):
            pass
    assert [s["name"] for s in o.spans_for(tid)] == ["http./upload"]
    # an errored trace is pinned whole, its earlier spans included
    o2 = Observability(ObsConfig(trace_ring=8, tail_keep=16), node_id=1)
    with pytest.raises(ValueError):
        with o2.request_span("http./download"):
            with o2.span("download.gather"):
                pass
            with o2.span("cas.get"):
                raise ValueError("disk ate it")
    tid = o2._ring[-1][0]
    for _ in range(50):
        with o2.request_span("http./status"):
            pass
    assert {s["name"] for s in o2.spans_for(tid)} \
        == {"http./download", "download.gather", "cas.get"}
    assert o2.stats()["tailSpans"] == 3


def test_sentinel_journals_loop_lag_after_a_blocked_loop(tmp_path):
    from dfs_tpu_torch.obs.sentinel import Sentinel

    journal = port_journal.Journal(tmp_path / "j", node_id=1)
    o = Observability(ObsConfig(trace_ring=8), node_id=1, journal=journal)
    sent = Sentinel(o, interval_s=0.02, lag_s=0.1)

    async def run():
        import time as _time

        sent.start()
        await asyncio.sleep(0.05)
        _time.sleep(0.3)                # a blocking call on the loop
        await asyncio.sleep(0.1)
        sent.stop()

    asyncio.run(run())
    st = sent.stats()
    assert st["incidents"] >= 1 and st["maxLagS"] >= 0.1
    journal.flush()
    journal.close()
    events, _ = ref_journal.read_events(tmp_path / "j")
    lag = [e for e in events if e["type"] == "loop_lag"]
    assert lag and lag[0]["lagS"] >= 0.1


# ------------------------------------------------------------------ #
# nodes
# ------------------------------------------------------------------ #

def _families(page: str) -> dict:
    """family -> (type, {sample name: frozenset of label keys})."""
    fams: dict = {}
    cur = None
    for line in page.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, mtype = line.split(" ")
            cur = fams.setdefault(name, [mtype, {}])
        elif line and not line.startswith("#"):
            sample = line.split(" # ")[0]
            name, _, rest = sample.partition("{")
            keys = frozenset(kv.split("=")[0]
                             for kv in rest.rsplit("}", 1)[0].split(",")
                             if "=" in kv) if rest else frozenset()
            cur[1].setdefault(name.split(" ")[0], set()).add(keys)
    return {k: (v[0], {n: frozenset(s) for n, s in v[1].items()})
            for k, v in fams.items()}


def _latency_names(page: str) -> set:
    return {line.split('name="', 1)[1].split('"', 1)[0]
            for line in page.splitlines()
            if line.startswith("dfs_latency_seconds_count")}


def test_prom_families_and_labels_match_dfs_tpu(tmp_path):
    """The same upload on one node of each kind: the OpenMetrics pages
    carry the same families with the same label sets, the same latency
    histograms, and end in # EOF; both are OpenMetrics-typed."""
    from dfs_tpu.node.runtime import StorageNodeServer as RefServer

    cluster = make_cluster(1, rf=1)
    rport = make_cluster(1, rf=1).peer(1)
    ref = RefServer(RefNodeConfig(
        node_id=1, data_root=tmp_path / "ref", fragmenter="cdc-anchored",
        cdc=RefCDC(min_size=64, avg_size=256, max_size=1024),
        health_probe_s=0, census=RefCensus(history_interval_s=0),
        cluster=RefCluster(peers=(RefPeer(
            node_id=1, host="127.0.0.1", port=rport.port,
            internal_port=rport.internal_port),), replication_factor=1)))
    body = corpus(40_000, seed=141)

    async def go():
        nodes = await _start(cluster, tmp_path)
        await ref.start()
        try:
            pages = []
            for port in (cluster.peer(1).port, rport.port):
                st, _, _ = await http(_raw, port, "POST",
                                      "/upload?name=f.bin", None, body)
                assert st == 201
                st, h, out = await http(_raw, port, "GET",
                                        "/metrics?format=prom")
                assert st == 200
                assert h["Content-Type"].startswith(
                    "application/openmetrics-text; version=1.0.0")
                pages.append(out.decode())
            mine, theirs = pages
            assert mine.endswith("# EOF\n") and theirs.endswith("# EOF\n")
            assert _families(mine) == _families(theirs)
            assert _latency_names(mine) == _latency_names(theirs)
            assert "http./upload" in _latency_names(mine)
        finally:
            await ref.stop()
            await _stop(nodes)

    _run(go())


def test_default_node_traces_journals_and_samples(tmp_path):
    """NodeConfig() builds the span ring, the journal and the sentinel
    at dfs_tpu's defaults; /metrics has obs and chaos, /trace, /events
    and /metrics?format=prom answer 200."""
    cluster = make_cluster(1, rf=1)

    async def go():
        nodes = await _start(cluster, tmp_path)
        n = nodes[1]
        try:
            assert n.cfg.obs == ObsConfig()
            assert n.obs.enabled and n.obs.journal is not None
            assert n.sentinel is not None and n.obs.sentinel is n.sentinel
            assert (n.store.root / "journal").is_dir()
            port = cluster.peer(1).port
            met = json.loads((await http(_raw, port, "GET",
                                         "/metrics"))[2])
            o = met["obs"]
            assert (o["traceRing"], o["tailKeep"], o["slowSpanS"]) \
                == (2048, 256, 1.0)
            assert o["journal"]["enabled"] and o["sentinel"]["enabled"]
            assert o["journal"]["bytes"] == 16 << 20
            assert met["chaos"] == {"enabled": False}
            for path in (f"/trace?traceId={T}", "/events?limit=8",
                         "/metrics?format=prom"):
                st, _, out = await http(_raw, port, "GET", path)
                assert st == 200, (path, out[:200])
            st, _, out = await http(_raw, port, "GET", "/events")
            kinds = [e["type"] for e in json.loads(out)["events"]]
            assert kinds[:2] == ["boot_sweep", "boot"]
            for path, want in (("/trace?traceId=nothex", 400),
                               ("/events?limit=0", 400),
                               ("/events?since=x", 400)):
                assert (await http(_raw, port, "GET", path))[0] == want
        finally:
            await _stop(nodes)
        # stop() joined the journal writer and the sentinel
        assert not n.obs.journal._writer.is_alive()
        assert n.sentinel._task is None

    _run(go())


def test_traced_upload_stitches_across_a_port_cluster(tmp_path):
    """An upload tagged with X-Dfs-Trace at node 1, stitched at node 3:
    spans from every node, the upload's phases and both ends of each
    store RPC, every parent present but the client's; the journal's
    events of the request carry its trace id."""
    cluster = make_cluster(3, rf=2)
    body = corpus(60_000, seed=151)
    tid = obs.new_trace_id()

    async def go():
        nodes = await _start(cluster, tmp_path)
        try:
            info = await http(client(cluster, 1).upload, body, "t.bin",
                              trace_id=tid)
            doc = await http(client(cluster, 3).trace, tid)
            spans = doc["spans"]
            assert doc["peersFailed"] == 0 and doc["peersQueried"] == 2
            assert {s["node"] for s in spans} == {1, 2, 3}
            names = {s["name"] for s in spans}
            assert {"http./upload", "upload.hash_file", "upload.fragment",
                    "upload.replicate", "rpc.store_chunks",
                    "peer.store_chunks", "cas.put_many"} <= names
            ids = {s["s"] for s in spans}
            orphans = [s for s in spans if s["p"] not in ids]
            assert [s["name"] for s in orphans] == ["http./upload"]
            for s in spans:
                if s["name"] == "peer.store_chunks":
                    parent = next(x for x in spans if x["s"] == s["p"])
                    assert parent["name"] == "rpc.store_chunks"
                    assert parent["node"] == 1 and s["node"] == parent["peer"]
            text = port_stitch.render_tree(spans)
            assert text == ref_stitch.render_tree(spans)
            assert f"trace {tid}" in text
            # the tracing rides X-Dfs-Trace into /metrics exemplars too
            page = await http(client(cluster, 1).metrics_prom)
            assert f'trace_id="{tid}"' in page
            assert info["fileId"]
        finally:
            await _stop(nodes)

    _run(go())


def test_device_trace_on_the_cpu_holds_the_span_names(tmp_path):
    """device_trace captures with torch.profiler and exports a Chrome
    trace; spans opened under it (utils.trace.span and Observability's)
    appear as ranges, and none are opened outside a capture."""
    import torch

    o = Observability(ObsConfig(), node_id=1)
    assert port_trace.annotate("x") is None
    with port_trace.device_trace(str(tmp_path)) as prof:
        assert prof is not None
        with port_trace.span("upload.fragment"):
            torch.ones(64).sum()
        with o.request_span("http./upload"):
            with o.span("upload.replicate", latency=True):
                torch.ones(8) * 2
    assert not port_trace._PROFILING
    doc = json.loads((tmp_path / "trace.json").read_text())
    names = {e.get("name") for e in doc["traceEvents"]}
    assert {"upload.fragment", "http./upload", "upload.replicate"} <= names


def test_kernels_within_counts_kernels_inside_the_range(tmp_path):
    """The trace reader: a kernel counts for its name when it starts
    inside a range of the given name (CPU or device twin), by substring
    of its CUDA function name."""
    doc = {"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": "upload.fragment",
         "ts": 100.0, "dur": 50.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "upload.fragment",
         "ts": 300.0, "dur": 10.0},
        {"ph": "X", "cat": "user_annotation", "name": "other",
         "ts": 0.0, "dur": 1000.0},
        {"ph": "X", "cat": "kernel", "name": "repack_lanes_kernel(unsigned)",
         "ts": 120.0, "dur": 1.0},
        {"ph": "X", "cat": "kernel", "name": "_Z18select_walk_kernelPKi",
         "ts": 305.0, "dur": 1.0},
        {"ph": "X", "cat": "kernel", "name": "repack_lanes_kernel",
         "ts": 400.0, "dur": 1.0},
        {"ph": "i", "cat": "kernel", "name": "bswap_transpose_kernel",
         "ts": 120.0},
        {"ph": "X", "cat": "cpu_op", "name": "bswap_transpose_kernel",
         "ts": 130.0, "dur": 1.0}]}
    f = tmp_path / "trace.json"
    f.write_text(json.dumps(doc))
    from dfs_tpu_torch import kernels

    got = port_trace.kernels_within(str(f), "upload.fragment",
                                    kernels.DEVICE_FUNCS)
    assert got == {"strip_chunk_states": 0, "repack_lanes": 1,
                   "bswap_transpose": 0, "select_walk": 1,
                   "strip_states": 0, "sha256_blocks": 0,
                   "sha256_spans": 0}
