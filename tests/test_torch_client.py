"""The port's resumable uploads, single-hop commit and smart client against
dfs_tpu's, on the CPU (``device="cpu"``) at the port tests' tiny chunk
geometry: ``ClientConfig`` validation; ``fragmenter_from_description``
tables; ``/dataplane``, ``/chunking``, ``/missing``, ``/upload_resume``
and ``/commit`` on twin clusters (one of each kind, same frames, same
answers); the counterparts of dfs_tpu's resume and smart-client tests run
on both kinds with their deterministic counters compared; ``stats()``
keys; the ``menu`` loop and the ``upload --resume/--smart`` and
``download --smart`` commands against dfs_tpu's."""

from __future__ import annotations

import asyncio
import builtins
import dataclasses
import hashlib
import http.client
import importlib
import json
import socket
import types

import numpy as np
import pytest

from dfs_tpu import config as ref_config
from dfs_tpu.cli import client as ref_client_mod
from dfs_tpu.client import SmartClient as RefSmart
from dfs_tpu.client import SmartClientError as RefSmartError
from dfs_tpu.fragmenter import base as ref_base
from dfs_tpu.fragmenter.cdc_anchored import AnchoredCpuFragmenter
from dfs_tpu.node import runtime as ref_runtime

from dfs_tpu_torch import config as port_config
from dfs_tpu_torch.cli import client as port_client_mod
from dfs_tpu_torch.client import SmartClient, SmartClientError
from dfs_tpu_torch.fragmenter.base import (_anchored_params,
                                           fragmenter_from_description)
from dfs_tpu_torch.node import runtime as port_runtime
from dfs_tpu_torch.ops.cdc_anchored import chunk_file_anchored_np

SIZES = dict(min_size=64, avg_size=256, max_size=1024)
# the modules (dfs_tpu.cli re-exports a function named main)
ref_main = importlib.import_module("dfs_tpu.cli.main")
port_main = importlib.import_module("dfs_tpu_torch.cli.main")

REF = types.SimpleNamespace(
    name="dfs_tpu", cfg=ref_config, Server=ref_runtime.StorageNodeServer,
    UploadError=ref_runtime.UploadError, Smart=RefSmart,
    SmartError=RefSmartError, NodeClient=ref_client_mod.NodeClient,
    node_kw=dict(fragmenter="cdc-anchored"), client_kw={},
    main=ref_main.main)
PORT = types.SimpleNamespace(
    name="port", cfg=port_config, Server=port_runtime.StorageNodeServer,
    UploadError=port_runtime.UploadError, Smart=SmartClient,
    SmartError=SmartClientError, NodeClient=port_client_mod.NodeClient,
    node_kw=dict(device="cpu"), client_kw=dict(device="cpu"),
    main=port_main.main)


def corpus(n, seed):
    return np.random.default_rng(seed).integers(0, 256, size=n,
                                                dtype=np.uint8).tobytes()


def table_of(body):
    return chunk_file_anchored_np(np.frombuffer(body, np.uint8),
                                  _anchored_params(
                                      port_config.CDCParams(**SIZES)))


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _nodes(kit, n, root, rf=2, index=False, **kw):
    """``n`` unstarted nodes of one kind in one cluster on fresh ports."""
    ports = _free_ports(2 * n)
    cluster = kit.cfg.ClusterConfig(peers=tuple(
        kit.cfg.PeerAddr(node_id=i + 1, host="127.0.0.1",
                         port=ports[2 * i], internal_port=ports[2 * i + 1])
        for i in range(n)), replication_factor=min(rf, n))
    ix = kit.cfg.IndexConfig(enabled=True, memtable_entries=1024,
                             filter_sync_s=0) if index else \
        kit.cfg.IndexConfig()
    return {i: kit.Server(kit.cfg.NodeConfig(
        node_id=i, cluster=cluster, data_root=root / kit.name,
        cdc=kit.cfg.CDCParams(**SIZES), health_probe_s=0,
        census=kit.cfg.CensusConfig(history_interval_s=0), index=ix,
        **kit.node_kw, **kw)) for i in range(1, n + 1)}


def run_on(kit, n, root, scenario, rf=2, index=False):
    """Start ``n`` nodes of ``kit``'s kind, run ``scenario(kit, nodes)``
    (a coroutine function), stop them; its result."""
    nodes = _nodes(kit, n, root, rf=rf, index=index)

    async def go():
        for node in nodes.values():
            await node.start()
        try:
            return await scenario(kit, nodes)
        finally:
            for node in nodes.values():
                await node.stop()

    return asyncio.run(asyncio.wait_for(go(), timeout=60))


def both(root, n, scenario, rf=2, index=False):
    """The scenario's result on dfs_tpu nodes and on port nodes."""
    return (run_on(REF, n, root, scenario, rf, index),
            run_on(PORT, n, root, scenario, rf, index))


def smart(kit, nodes, nid=1, **cfg_kw):
    cfg_kw.setdefault("fallback", False)
    return kit.Smart(host="127.0.0.1", port=nodes[nid].cfg.cluster.peer(
        nid).port, cfg=kit.cfg.ClientConfig(**cfg_kw), **kit.client_kw)


async def th(fn, *args, **kw):
    return await asyncio.to_thread(fn, *args, **kw)


# ------------------------------------------------------------------ #
# ClientConfig and fragmenter_from_description
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("kw", [
    {}, dict(window=1, stripe=1, hedge_budget_per_s=5.0),
    dict(window=0), dict(stripe=0), dict(hedge_budget_per_s=-1.0),
    dict(hedge_floor_s=-0.1), dict(hedge_cap_s=-1.0),
    dict(hedge_floor_s=2.0, hedge_cap_s=1.0), dict(filter_max_age_s=-1.0),
    dict(echo_cache_entries=-1)])
def test_client_config_validates_as_dfs_tpu(kw):
    def outcome(cls):
        try:
            return dataclasses.asdict(cls(**kw))
        except ValueError as e:
            return f"ValueError: {e}"

    assert outcome(port_config.ClientConfig) == \
        outcome(ref_config.ClientConfig)


DESCS = [AnchoredCpuFragmenter(_anchored_params(
    ref_config.CDCParams(**s))).describe()
    for s in (SIZES, dict(min_size=256, avg_size=1024, max_size=4096))]


@pytest.mark.parametrize("d", range(len(DESCS)))
@pytest.mark.parametrize("n", [0, 1, 100, 3000, 70_000])
def test_fragmenter_from_description_tables_equal(d, n):
    desc = DESCS[d]
    body = corpus(n, seed=n + d)
    want = [(c.offset, c.length, c.digest) for c in
            ref_base.fragmenter_from_description(desc).chunk(body)]
    frag = fragmenter_from_description(desc, device="cpu")
    assert frag.describe() == desc
    assert [(c.offset, c.length, c.digest) for c in frag.chunk(body)] \
        == want


# fixed and cdc are described kinds since the host strategies were
# ported (tests/test_torch_fragmenter_cpu.py round-trips them); the kinds
# of the strategies still to port are refused
@pytest.mark.parametrize("desc", [{"kind": "cdc-aligned"},
                                  {"kind": "cdc-tpu", "min_size": 64,
                                   "avg_size": 256, "max_size": 1024,
                                   "seed": 0},
                                  {"kind": "rolling"}, {}])
def test_fragmenter_from_description_refuses_other_kinds(desc):
    with pytest.raises(ValueError, match="undescribable"):
        fragmenter_from_description(desc, device="cpu")


# ------------------------------------------------------------------ #
# the five routes, frame by frame, on a node of each kind
# ------------------------------------------------------------------ #

def _http(port, method, path, body=None, length=True):
    """(status, body text) of one request; ``length=False`` sends a body
    without Content-Length."""
    if length:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        try:
            conn.request(method, path, body=body)
            r = conn.getresponse()
            return r.status, r.read().decode("latin-1")
        finally:
            conn.close()
    with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
        s.sendall(f"{method} {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
        raw = b""
        while chunk := s.recv(65536):
            raw += chunk
    head, _, text = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), text.decode("latin-1")


def frame(meta, payloads=b"", trailing=b""):
    meta = json.dumps(meta).encode()
    return len(meta).to_bytes(4, "big") + meta + payloads + trailing


BODY = corpus(40_000, seed=71)
TABLE = table_of(BODY)
FID = hashlib.sha256(BODY).hexdigest()
GHOST = hashlib.sha256(b"held by nobody").hexdigest()


def _resume_frames():
    tbl = [list(t) for t in TABLE]
    order = list(dict.fromkeys(d for _, _, d in TABLE))
    by_d = {d: BODY[o:o + ln] for o, ln, d in reversed(TABLE)}
    all_payloads = b"".join(by_d[d] for d in order)
    bad = bytearray(all_payloads)
    bad[0] ^= 1
    half = order[:len(order) // 2]
    gap = [[o + (1 if i == 3 else 0), ln, d] for i, (o, ln, d)
           in enumerate(tbl)]
    return [
        ("good", frame({"fileId": FID, "size": len(BODY), "chunks": tbl,
                        "provided": order}, all_payloads)),
        ("again_nothing_provided", frame({"fileId": FID,
                                          "size": len(BODY),
                                          "chunks": tbl, "provided": []})),
        ("hash_mismatch", frame({"fileId": FID, "size": len(BODY),
                                 "chunks": tbl, "provided": order},
                                bytes(bad))),
        ("not_tiling_gap", frame({"fileId": FID, "size": len(BODY),
                                  "chunks": gap, "provided": []})),
        ("not_tiling_size", frame({"fileId": FID, "size": len(BODY) + 1,
                                   "chunks": tbl, "provided": []})),
        ("malformed_json", b"\x00\x00\x00\x05{nope"),
        ("missing_key", frame({"fileId": FID, "size": len(BODY),
                               "chunks": tbl})),
        ("trailing", frame({"fileId": FID, "size": len(BODY),
                            "chunks": tbl, "provided": half},
                           b"".join(by_d[d] for d in half), b"xx")),
        ("bad_file_id", frame({"fileId": "XYZ", "size": len(BODY),
                               "chunks": tbl, "provided": []})),
        ("absent_chunk", frame({"fileId": GHOST, "size": 10,
                                "chunks": [[0, 10, GHOST]],
                                "provided": []})),
    ]


def _commit_frames():
    tbl = [list(t) for t in TABLE]
    return [
        ("phantom", frame({"fileId": GHOST, "size": 10,
                           "chunks": [[0, 10, GHOST]]})),
        ("pure_dedup", frame({"fileId": FID, "size": len(BODY),
                              "chunks": tbl})),
        ("trailing", frame({"fileId": FID, "size": len(BODY),
                            "chunks": tbl}, trailing=b"\x00")),
        ("malformed", b"\x00\x00\x00\x02[]"),
        ("not_tiling", frame({"fileId": FID, "size": 5,
                              "chunks": tbl})),
        ("bad_file_id", frame({"fileId": FID[:-1], "size": len(BODY),
                               "chunks": tbl})),
    ]


async def _frames_scenario(kit, nodes):
    port = nodes[1].cfg.cluster.peer(1).port
    out = []

    async def req(label, method, path, body=None, length=True):
        st, text = await th(_http, port, method, path, body, length)
        out.append((label, st, text))

    await req("chunking", "GET", "/chunking")
    digests = [d for _, _, d in TABLE[:5]] + ["not-a-digest", GHOST]
    await req("missing_before", "POST", "/missing",
              json.dumps(digests).encode())
    await req("missing_not_list", "POST", "/missing", b'{"a": 1}')
    await req("missing_bad_json", "POST", "/missing", b"[1, 2")
    await req("missing_no_length", "POST", "/missing", length=False)
    for label, body in _resume_frames():
        await req(f"resume:{label}", "POST", "/upload_resume?name=r.bin",
                  body)
    await req("resume_no_length", "POST", "/upload_resume", length=False)
    await req("missing_after", "POST", "/missing",
              json.dumps(digests).encode())
    for label, body in _commit_frames():
        await req(f"commit:{label}", "POST", "/commit?name=c.bin", body)
    await req("commit_no_length", "POST", "/commit", length=False)
    await req("ghost_manifest", "GET", f"/manifest?fileId={GHOST}")
    await req("download", "GET", f"/download?fileId={FID}")
    dp = json.loads((await th(_http, port, "GET", "/dataplane"))[1])
    for p in dp["peers"]:
        p["port"] = p["internalPort"] = 0
    dp["chunking"]["fragmenter"] = "engine"
    if dp["filters"]["enabled"]:
        # a random generation per filter; the peers' ages are clocks
        dp["filters"]["generation"] = "random"
        dp["filters"]["peerAges"] = sorted(dp["filters"]["peerAges"])
    out.append(("dataplane", 200, dp))
    m = json.loads((await th(_http, port, "GET", "/metrics"))[1])
    out.append(("metrics", {k: m.get(k) for k in (
        "uploads_resumed", "uploads_committed", "commit_probe_failures",
        "probe_failures")}))
    out.append(("commit_verify_recorded",
                "upload.commit_verify" in m["latency"]))
    return out


@pytest.mark.parametrize("index", [False, True])
def test_routes_answer_as_dfs_tpu(tmp_path, index):
    ref, port = both(tmp_path, 2, _frames_scenario, index=index)
    ref_by, port_by = {r[0]: r for r in ref}, {r[0]: r for r in port}
    assert list(ref_by) == list(port_by)
    for label in ref_by:
        if label == "chunking":
            # the engine's name differs (cdc-anchored vs its CUDA twin)
            a, b = json.loads(ref_by[label][2]), json.loads(
                port_by[label][2])
            assert a["describe"] == b["describe"] and a["fragmenter"] \
                == "cdc-anchored" and b["fragmenter"] == "cdc-anchored-cuda"
            continue
        assert port_by[label] == ref_by[label], label
    got = {r[0]: r[1] for r in port}
    assert got["resume:good"] == 201 and got["commit:pure_dedup"] == 201
    assert got["resume:absent_chunk"] == got["commit:phantom"] == 409
    assert got["ghost_manifest"] == 404
    assert got["resume_no_length"] == got["commit_no_length"] == 411
    assert port_by["download"][2].encode("latin-1") == BODY
    assert port_by["metrics"][1]["uploads_resumed"] == 2
    assert port_by["metrics"][1]["uploads_committed"] == 1
    assert port_by["commit_verify_recorded"][1]


# ------------------------------------------------------------------ #
# dfs_tpu's resume and smart-client tests, on both kinds
# ------------------------------------------------------------------ #

async def _interrupted_resume(kit, nodes):
    data = corpus(120_000, seed=3)
    table = table_of(data)
    half = table[:len(table) // 2]
    for o, ln, d in half:
        for n in nodes.values():
            n.store.chunks.put(d, data[o:o + ln])
    fid = hashlib.sha256(data).hexdigest()
    assert nodes[2].store.manifests.load(fid) is None
    assert all(n.list_files() == [] for n in nodes.values())
    c = kit.NodeClient(port=nodes[1].cfg.cluster.peer(1).port,
                       timeout_s=30)
    info = await th(c.upload_resume, data, "resume.bin",
                    **({"device": "cpu"} if kit is PORT else {}))
    # only the missing half's payloads crossed the wire (plus the table)
    half_bytes = sum(ln for _, ln, _ in half)
    assert info["bytes"] == len(data) - half_bytes
    assert info["dedupSkippedBytes"] > 0
    _, got = await nodes[3].download(fid)
    assert bytes(got) == data
    # a plain re-upload after the resume moves nothing
    _, st = await nodes[2].upload(data, "again.bin")
    return {k: info[k] for k in ("fileId", "chunks", "clientBytesSent",
                                 "bytes", "transferredBytes",
                                 "dedupSkippedBytes", "minCopies")} | {
        "again": st["transferredBytes"]}


def test_interrupted_upload_resumes(tmp_path):
    ref, port = both(tmp_path, 3, _interrupted_resume)
    assert port == ref and port["again"] == 0


async def _byte_identity(kit, nodes):
    c = smart(kit, nodes)
    data = corpus(250_000, seed=4)
    info = await th(c.upload, data, "a.bin")
    assert info["dataPlane"] == "smart"
    assert info["fileId"] == hashlib.sha256(data).hexdigest()
    assert c.counters["transferredBytes"] == 2 * len(data)
    assert await th(c.download, info["fileId"]) == data
    assert c.counters["smartDownloads"] == 1
    assert c.counters["chunksVerified"] >= info["chunks"]
    for n in nodes.values():
        _, body = await n.download(info["fileId"])
        assert bytes(body) == data
    st = c.stats()
    assert st["smart"] and st["fallbacks"] == 0
    m = json.loads(nodes[1].store.manifests.load(info["fileId"]).to_json())
    return {"table": [(x["offset"], x["length"], x["digest"])
                      for x in m["chunks"]],
            "stats": {k: v for k, v in st.items() if k not in (
                "echoCache",)},
            "reply": {k: info[k] for k in info}}


def test_smart_upload_download_byte_identity(tmp_path):
    ref, port = both(tmp_path, 3, _byte_identity, index=True)
    assert port["table"] == ref["table"] == table_of(corpus(250_000, 4))
    assert port["stats"] == ref["stats"]
    assert port["reply"] == ref["reply"]


async def _dedup_via_filters(kit, nodes):
    data = corpus(250_000, seed=5)
    c1 = smart(kit, nodes)
    info = await th(c1.upload, data, "a.bin")
    for n in nodes.values():
        await n._filter_sync_once()
    c2 = smart(kit, nodes, nid=2)
    info2 = await th(c2.upload, data, "a.bin")
    assert info2["fileId"] == info["fileId"]
    assert c2.counters["transferredBytes"] == 0
    assert c2.counters["dedupSkippedBytes"] == 2 * len(data)
    assert c2.counters["verifyRpcs"] >= 1
    assert c2.counters["filterFp"] == 0
    return c2.counters, info2["clientBytesSent"]


def test_smart_reupload_dedups_via_filters(tmp_path):
    ref, port = both(tmp_path, 3, _dedup_via_filters, index=True)
    assert port == ref


async def _stale_filter(kit, nodes):
    c = smart(kit, nodes)
    await th(c.upload, corpus(50_000, seed=6), "s")
    assert c._filters
    for st in c._filters.values():
        buf = st["bloom"].buf
        for i in range(len(buf)):
            buf[i] = 0xFF
    fresh = corpus(200_000, seed=7)
    info = await th(c.upload, fresh, "fresh.bin")
    assert info["dataPlane"] == "smart"
    assert c.counters["verifyRpcs"] >= 1 and c.counters["filterFp"] > 0
    assert c.counters["transferredBytes"] >= len(fresh)
    for n in nodes.values():
        _, body = await n.download(info["fileId"])
        assert bytes(body) == fresh
    assert await th(c.download, info["fileId"]) == fresh
    after_fp = dict(c.counters)
    for st in c._filters.values():
        st["baseAgeS"] = 10_000.0
    probes = c.counters["probeRpcs"]
    fresh2 = corpus(120_000, seed=8)
    info2 = await th(c.upload, fresh2, "f2.bin")
    assert c.counters["probeRpcs"] > probes
    assert await th(c.download, info2["fileId"]) == fresh2
    return after_fp, dict(c.counters)


def test_stale_corrupt_filter_degrades_to_probes_never_loses_bytes(
        tmp_path):
    ref, port = both(tmp_path, 3, _stale_filter, index=True)
    assert port == ref


async def _echo_cache(kit, nodes):
    c = smart(kit, nodes, echo_cache_entries=4096)
    data = corpus(150_000, seed=9)
    info = await th(c.upload, data, "a.bin")
    v, p = c.counters["verifyRpcs"], c.counters["probeRpcs"]
    info2 = await th(c.upload, data, "b.bin")
    assert info2["fileId"] == info["fileId"]
    assert c.counters["verifyRpcs"] == v and c.counters["probeRpcs"] == p
    assert c.counters["transferredBytes"] == 2 * len(data)
    assert c.counters["dedupSkippedBytes"] >= 2 * len(data)
    c._echo.note_epoch(c._ringview.epoch + 1)
    assert c._echo.stats()["entries"] == 0
    return c.stats()


def test_echo_cache_skips_verify_round_on_reupload(tmp_path):
    ref, port = both(tmp_path, 3, _echo_cache, index=True)
    assert port == ref


def _raise_404(method, path, *a, **kw):
    raise RuntimeError("HTTP 404: Not Found")


async def _old_server(kit, nodes):
    c = smart(kit, nodes, fallback=True)
    orig = c.legacy._request

    def no_dataplane(method, path, *a, **kw):
        if path == "/dataplane":
            raise RuntimeError("HTTP 404: Not Found")
        return orig(method, path, *a, **kw)

    c.legacy._request = no_dataplane
    data = corpus(100_000, seed=10)
    info = await th(c.upload, data, "a.bin")
    assert info["dataPlane"] == "legacy"
    assert await th(c.download, info["fileId"]) == data
    assert c._boot is False
    # fallback=False: the same 404 raises instead
    c2 = smart(kit, nodes)
    c2.legacy._request = _raise_404
    with pytest.raises(kit.SmartError):
        await th(c2.upload, b"x" * 10_000, "a")
    return c.stats(), info["fileId"]


def test_old_server_pins_legacy_and_no_fallback_raises(tmp_path):
    ref, port = both(tmp_path, 2, _old_server)
    assert port == ref


async def _ec_manifest(kit, nodes):
    data = corpus(120_000, seed=11)
    m, _ = await nodes[1].upload(data, "e.bin", ec_k=2)
    c = smart(kit, nodes, fallback=True)
    assert await th(c.download, m.file_id) == data
    assert c.counters["legacyDownloads"] == 1
    assert c.counters["fallbacks"] == 1
    return c.stats()


def test_ec_manifest_downloads_via_legacy_path(tmp_path):
    ref, port = both(tmp_path, 4, _ec_manifest)
    assert port == ref


async def _commit_cases(kit, nodes):
    from dfs_tpu_torch.utils.hashing import sha256_hex

    out = {}
    body = corpus(30_000, seed=12)
    dg = sha256_hex(body)
    fid = sha256_hex(b"claimed-stream")
    with pytest.raises(kit.UploadError) as ei:
        await nodes[1].commit_manifest([(0, len(body), dg)], "ghost.bin",
                                       fid, len(body))
    out["phantom"] = (ei.value.status, str(ei.value))
    with pytest.raises(KeyError):
        await nodes[1].download(fid)
    # one copy, below quorum 2: healed before the ack
    body = corpus(40_000, seed=13)
    dg = sha256_hex(body)
    nodes[1].store.chunks.put(dg, body)
    _, stats = await nodes[1].commit_manifest([(0, len(body), dg)],
                                              "heal.bin", dg, len(body))
    assert stats["minCopies"] >= 2
    _, got = await nodes[2].download(dg)
    assert bytes(got) == body
    out["heal"] = stats
    # every chunk present: a pure dedup commit
    data = corpus(80_000, seed=14)
    m, _ = await nodes[1].upload(data, "orig.bin")
    table = [(c.offset, c.length, c.digest) for c in m.chunks]
    _, stats = await nodes[1].commit_manifest(table, "alias.bin",
                                              m.file_id, len(data))
    assert stats["transferredBytes"] == 0
    assert stats["dedupSkippedBytes"] == len(data)
    out["dedup"] = stats
    return out


def test_commit_409_heal_and_pure_dedup(tmp_path):
    ref, port = both(tmp_path, 2, _commit_cases)
    assert port == ref and port["phantom"][0] == 409


def test_stats_keys_equal_dfs_tpu():
    for kw in ({}, dict(hedge_budget_per_s=5.0, echo_cache_entries=0)):
        a = RefSmart(cfg=ref_config.ClientConfig(**kw))
        b = SmartClient(cfg=port_config.ClientConfig(**kw), device="cpu")
        for c in (a, b):
            c._boot = False          # no server: the legacy-pinned shape
        assert b.stats() == a.stats()


# ------------------------------------------------------------------ #
# the CLI: menu, upload --resume/--smart, download --smart
# ------------------------------------------------------------------ #

def _cli(kit, argv, answers, capsys):
    """Run ``kit.main(argv)`` with ``input`` answering from ``answers``
    (EOF after the last): (exit code, stdout, stderr)."""
    it = iter(answers)

    def fake_input(prompt=""):
        try:
            return next(it)
        except StopIteration:
            raise EOFError from None

    orig = builtins.input
    builtins.input = fake_input
    try:
        rc = kit.main(argv)
    finally:
        builtins.input = orig
    out = capsys.readouterr()
    return rc, out.out, out.err


def _cli_scenario(files_dir, capsys, monkeypatch, workdir):
    async def scenario(kit, nodes):
        port = str(nodes[1].cfg.cluster.peer(1).port)
        wd = workdir / kit.name
        wd.mkdir()
        monkeypatch.chdir(wd)
        dev = ["--device", "cpu"] if kit is PORT else []
        res = {}
        # the menu: status, list, upload, download, an invalid option, a
        # bad file number, then end of input
        res["menu"] = await th(_cli, kit, ["--port", port, "menu"], [
            "1", "", "2", port, "3", "", str(files_dir), "1", "4", "",
            "1", "9", "3", "", str(files_dir), "x", "2", ""], capsys)
        f = files_dir / "b.bin"
        res["resume"] = await th(_cli, kit, ["--port", port, "upload",
                                             "--resume", *dev, str(f)],
                                 [], capsys)
        res["smart_up"] = await th(_cli, kit, [
            "--port", port, "upload", "--smart", *dev, str(f)], [],
            capsys)
        fid = hashlib.sha256(f.read_bytes()).hexdigest()
        res["smart_down"] = await th(_cli, kit, [
            "--port", port, "download", "--smart", fid, "--out", "dl"], [],
            capsys)
        assert (wd / "dl" / "b.bin").read_bytes() == f.read_bytes()
        for label, extra in (("smart_ec", ["--smart", "--ec", "2"]),
                             ("smart_resume", ["--smart", "--resume"]),
                             ("resume_ec", ["--resume", "--ec", "2"])):
            res[label] = await th(_cli, kit, [
                "--port", port, "upload", *extra, *dev, str(f)], [],
                capsys)
        return res
    return scenario


def test_cli_menu_resume_and_smart_as_dfs_tpu(tmp_path, capsys,
                                               monkeypatch):
    files = tmp_path / "files"
    files.mkdir()
    (files / "a.bin").write_bytes(corpus(30_000, seed=15))
    (files / "b.bin").write_bytes(corpus(45_000, seed=16))
    work = tmp_path / "work"
    work.mkdir()
    scenario = _cli_scenario(files, capsys, monkeypatch, work)
    ref, port = both(tmp_path, 2, scenario)
    title = "=== Distributed File Storage (CUDA) ==="
    rc, out, err = port["menu"]
    assert rc == 0 and title in out
    assert out.replace(title, "=== Distributed File Storage (TPU) ===") \
        == ref["menu"][1] and err == ref["menu"][2]
    assert "Invalid option" in out and "Error: invalid literal" in out
    assert "Saved 30000 bytes to downloads/a.bin" in out
    for label in ("resume", "smart_up", "smart_down", "smart_ec",
                  "smart_resume", "resume_ec"):
        assert port[label] == ref[label], label
    assert port["smart_up"][1].startswith("Uploaded (smart): ")
    assert port["smart_down"][1].startswith("dataPlane=smart")
    assert port["smart_ec"][0] == port["smart_resume"][0] \
        == port["resume_ec"][0] == 2
