"""The port stands alone: no file of dfs_tpu_torch (nor chip_smoke.py)
imports JAX, grpc or anything of dfs_tpu, a process that uses the port —
the chunk+hash sidecar and its client, the
single-device and the sharded walk, and a node served over HTTP with the
similarity plane, the serving tier, the index and tiering, chaos, a
traced request stitched and journaled, the ring, census, history and
doctor routes, a smart-client upload and download, a resumed upload, a
device-trace capture, and every host strategy with the device strategies'
plain versions (aligned, v1, the rolling sharded walk) — never loads any
of them, and without CUDA the entry
points (the client's chunking included) raise instead of running on the
CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "dfs_tpu_torch"


def _forbidden(module: str) -> bool:
    # exact names or their submodules: dfs_tpu_torch itself also starts
    # with "dfs_tpu"
    return any(module == m or module.startswith(m + ".")
               for m in ("jax", "jaxlib", "dfs_tpu", "grpc"))


def test_no_file_imports_jax_or_dfs_tpu():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{f.relative_to(ROOT)}: {n}" for n in names
                    if _forbidden(n)]
    assert not bad, bad


_SCRIPT = r"""
import sys, tempfile
import numpy as np
from dfs_tpu_torch.node import LocalNode
from dfs_tpu_torch.ops.cdc_anchored import AnchoredCdcParams
from dfs_tpu_torch.ops.cdc_v2 import AlignedCdcParams
from dfs_tpu_torch.config import FragmenterConfig
import dfs_tpu_torch.convert, dfs_tpu_torch.kernels  # noqa: F401
import dfs_tpu_torch.parallel.sharded_cdc  # noqa: F401
p = AnchoredCdcParams(chunk=AlignedCdcParams(min_blocks=2, avg_blocks=4,
                      max_blocks=16, strip_blocks=64),
                      seg_min=2048, seg_max=4096, seg_mask=2047)
body = np.random.default_rng(0).integers(0, 256, 20000, np.uint8).tobytes()
with tempfile.TemporaryDirectory() as d:
    n = LocalNode(d, device="cpu", params=p, region_bytes=16384,
                  cpu_cutoff=0, lane_multiple=8)
    m, _ = n.upload(body)
    assert n.download(m.file_id) == body
    # the window-batched walk on two CPU slots
    n2 = LocalNode(d, node_id=2, device="cpu", params=p,
                   frag=FragmenterConfig(devices=2, region_bytes=16384))
    m2, _ = n2.upload_stream(iter([body[:7000], body[7000:]]))
    assert m2.chunks == m.chunks and n2.download(m2.file_id) == body
    # the node as users run it: a started StorageNodeServer over HTTP
    import asyncio, socket
    from pathlib import Path
    import dfs_tpu_torch.api.http, dfs_tpu_torch.cli.main  # noqa: F401
    import dfs_tpu_torch.obs, dfs_tpu_torch.serve  # noqa: F401
    import dfs_tpu_torch.chaos, dfs_tpu_torch.obs.journal  # noqa: F401
    import dfs_tpu_torch.obs.prom, dfs_tpu_torch.obs.sentinel  # noqa: F401
    import dfs_tpu_torch.obs.stitch  # noqa: F401
    import dfs_tpu_torch.obs.census, dfs_tpu_torch.obs.doctor  # noqa: F401
    import dfs_tpu_torch.obs.history, dfs_tpu_torch.ring.manager  # noqa: F401
    from dfs_tpu_torch.obs import new_trace_id
    from dfs_tpu_torch.utils.trace import device_trace
    from dfs_tpu_torch.utils import deadline
    from dfs_tpu_torch.cli.client import NodeClient
    from dfs_tpu_torch.config import (CensusConfig, ChaosConfig,
                                      ClusterConfig, IndexConfig,
                                      NodeConfig, RingConfig, ServeConfig,
                                      SimConfig, TierConfig)
    from dfs_tpu_torch.node.runtime import StorageNodeServer
    socks = [socket.socket() for _ in range(2)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    cluster = ClusterConfig.localhost(1, ports[0], ports[1], 1)

    async def serve():
        # with the similarity plane: a near-duplicate stores a delta
        srv = StorageNodeServer(NodeConfig(
            node_id=1, cluster=cluster, data_root=Path(d) / "srv",
            health_probe_s=0, device="cpu",
            sim=SimConfig(enabled=True, min_chunk_bytes=1024),
            serve=ServeConfig(cache_bytes=1 << 20, readahead_batches=2,
                              download_slots=2, hedge_budget_per_s=5.0),
            index=IndexConfig(enabled=True), tier=TierConfig(enabled=True),
            chaos=ChaosConfig(enabled=True, seed=13),
            ring=RingConfig(vnodes=16),
            census=CensusConfig(history_interval_s=0.05)))
        await srv.start()
        try:
            c = NodeClient(port=ports[0], timeout_s=30)
            fid = (await asyncio.to_thread(c.upload, body, "b"))["fileId"]
            assert await asyncio.to_thread(c.download, fid) == body
            near = body[:9000] + b"!" + body[9001:]
            fid2 = (await asyncio.to_thread(c.upload, near, "n"))["fileId"]
            assert await asyncio.to_thread(c.download, fid2) == near
            assert srv.sim_stats()["deltasWritten"] >= 1
            assert await asyncio.to_thread(c.download, fid) == body
            assert srv.serve.cache.stats()["hits"] > 0
            assert deadline.parse_header("1.5") == 1.5
            assert srv.index_stats()["lsi"]["memtableEntries"] > 0
            assert (await srv.tier_scan_once())["skipped"]  # 1 node
            tid = new_trace_id()
            fid3 = (await asyncio.to_thread(c.upload, near[::-1], "r",
                                            trace_id=tid))["fileId"]
            spans = (await asyncio.to_thread(c.trace, tid))["spans"]
            assert "upload.fragment" in {s["name"] for s in spans}
            assert (await asyncio.to_thread(c.events))["events"]
            assert "# EOF" in await asyncio.to_thread(c.metrics_prom)
            assert (await asyncio.to_thread(c.census))[
                "underReplicatedTotal"] == 0
            assert (await asyncio.to_thread(c.doctor))["peersFailed"] == 0
            assert (await asyncio.to_thread(c.ring_status))["mode"] == "hash"
            await asyncio.sleep(0.2)
            assert "capacity.casBytes" in (
                await asyncio.to_thread(c.history))["series"]
            srv.chaos.set(serve_delay_s=0.0)
            # the smart client and the resumed upload, chunking on the CPU
            from dfs_tpu_torch.client import SmartClient
            from dfs_tpu_torch.config import ClientConfig
            sc = SmartClient(port=ports[0], cfg=ClientConfig(fallback=False),
                             device="cpu")
            info = await asyncio.to_thread(sc.upload, near[5:], "s")
            assert info["dataPlane"] == "smart"
            assert await asyncio.to_thread(sc.download,
                                           info["fileId"]) == near[5:]
            got = await asyncio.to_thread(c.upload_resume, body[3:], "u",
                                          None, "cpu")
            assert await asyncio.to_thread(c.download,
                                           got["fileId"]) == body[3:]
            with device_trace(str(Path(d) / "prof")):
                assert await asyncio.to_thread(c.download, fid3)
        finally:
            await srv.stop()

    asyncio.run(serve())
    # the sidecar (its own HTTP/2 stack) and a round trip through it
    from dfs_tpu_torch.sidecar import SidecarClient, SidecarServer
    sc_srv = SidecarServer(port=0, fragmenter="cdc")
    sc_srv.start()
    try:
        sc = SidecarClient(sc_srv.port)
        assert sc.health()["fragmenter"] == "cdc"
        table = sc.chunk_hash_stream(iter([body[:9000], body[9000:]]))
        assert sum(x["length"] for x in table["chunks"]) == len(body)
        assert list(sc.chunk_hash_duplex(iter([body])))[-1]["done"]
    finally:
        sc_srv.stop()
# every host engine and the device engines' plain versions on a small body
import warnings
from dfs_tpu_torch.config import CDCParams
from dfs_tpu_torch.fragmenter.base import get_fragmenter
import dfs_tpu_torch.fragmenter.cdc_aligned, dfs_tpu_torch.fragmenter.cdc_cuda
import dfs_tpu_torch.fragmenter.cdc_sharded, dfs_tpu_torch.ops.cdc_pipeline
import dfs_tpu_torch.ops.gear, dfs_tpu_torch.ops.pack
import dfs_tpu_torch.parallel.multihost  # noqa: F401
small = body[:40000]
tables = []
with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    for kind, frag in (("cdc-aligned", None), ("cdc-aligned-cuda", None),
                       ("cdc-anchored", None), ("cdc-cuda", None),
                       ("cdc", FragmenterConfig(devices=2))):
        f = get_fragmenter(kind, cdc_params=CDCParams(64, 256, 1024),
                           frag=frag, device="cpu")
        m = f.manifest_stream(iter([small[:5000], small[5000:]]), "s")
        assert sum(c.length for c in m.chunks) == len(small), kind
        tables.append([(c.offset, c.length, c.digest) for c in m.chunks])
assert tables[0] == tables[1] and tables[3] == tables[4]
bad = sorted(k for k in sys.modules
             if k in ("jax", "jaxlib", "dfs_tpu", "grpc")
             or k.startswith(("jax.", "jaxlib.", "dfs_tpu.", "grpc.")))
print("LOADED", bad)
sys.exit(1 if bad else 0)
"""


def test_port_process_never_loads_jax_or_dfs_tpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "LOADED []" in r.stdout


def test_entry_points_raise_without_cuda(tmp_path):
    from dfs_tpu_torch import resolve_device
    from dfs_tpu_torch.fragmenter.base import get_fragmenter
    from dfs_tpu_torch.fragmenter.cdc_anchored import AnchoredCudaFragmenter
    from dfs_tpu_torch.node import LocalNode

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        LocalNode(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        AnchoredCudaFragmenter()
    with pytest.raises(RuntimeError, match="CUDA"):
        get_fragmenter("auto")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    _client_entry_points_raise_without_cuda(tmp_path)


def _client_entry_points_raise_without_cuda(tmp_path):
    """The client's chunking defaults to the card too: against a running
    CPU node, ``fragmenter_from_description``, ``SmartClient.upload``,
    ``NodeClient.upload_resume`` and ``upload --smart/--resume`` (without
    ``--device cpu``) raise or exit non-zero with the CUDA message, and
    none of them answers with a legacy upload; a smart download, which
    never chunks, runs without a card."""
    import asyncio
    import contextlib
    import io
    import socket

    from dfs_tpu_torch.cli.client import NodeClient
    from dfs_tpu_torch.cli.main import main
    from dfs_tpu_torch.client import SmartClient
    from dfs_tpu_torch.config import ClusterConfig, NodeConfig
    from dfs_tpu_torch.fragmenter.base import fragmenter_from_description
    from dfs_tpu_torch.node.runtime import StorageNodeServer

    socks = [socket.socket() for _ in range(2)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    f = tmp_path / "f.bin"
    f.write_bytes(b"q" * 5000)

    async def go():
        srv = StorageNodeServer(NodeConfig(
            node_id=1, cluster=ClusterConfig.localhost(1, ports[0],
                                                       ports[1], 1),
            data_root=tmp_path / "srv", health_probe_s=0, device="cpu"))
        await srv.start()
        try:
            c = NodeClient(port=ports[0], timeout_s=30)
            desc = (await asyncio.to_thread(c.chunking))["describe"]
            with pytest.raises(RuntimeError, match="CUDA"):
                fragmenter_from_description(desc)
            sc = SmartClient(port=ports[0])
            for _ in range(2):           # the second call raises too
                with pytest.raises(RuntimeError, match="CUDA"):
                    await asyncio.to_thread(sc.upload, b"x" * 5000, "x")
            assert sc.counters["fallbacks"] == 0
            assert sc.counters["legacyUploads"] == 0
            with pytest.raises(RuntimeError, match="CUDA"):
                await asyncio.to_thread(c.upload_resume, b"x" * 5000, "x")
            for flag in ("--smart", "--resume"):
                err = io.StringIO()
                with contextlib.redirect_stderr(err):
                    rc = await asyncio.to_thread(
                        main, ["--port", str(ports[0]), "upload", flag,
                               str(f)])
                assert rc != 0 and "CUDA" in err.getvalue()
            assert srv.list_files() == []
            # a striped read never chunks: it needs no card
            fid = (await asyncio.to_thread(c.upload, b"r" * 5000,
                                           "r"))["fileId"]
            sc = SmartClient(port=ports[0])
            assert await asyncio.to_thread(sc.download, fid) == b"r" * 5000
            assert sc.counters["smartDownloads"] == 1
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = await asyncio.to_thread(
                    main, ["--port", str(ports[0]), "download", "--smart",
                           fid, "--out", str(tmp_path / "dl")])
            assert rc == 0 and "dataPlane=smart" in out.getvalue()
            assert (tmp_path / "dl" / "r").read_bytes() == b"r" * 5000
        finally:
            await srv.stop()

    asyncio.run(asyncio.wait_for(go(), timeout=60))


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    """A missing nvcc is an error, never a silent fallback."""
    from dfs_tpu_torch import kernels

    monkeypatch.setattr(kernels, "_BUILD_ROOT", tmp_path)
    monkeypatch.setattr(kernels, "_libs", {})
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build_all()
