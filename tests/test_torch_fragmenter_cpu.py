"""The port's host strategies, ``fixed`` and ``cdc``, against dfs_tpu's on
the same seeded inputs: chunk tables, the streaming walk, the native cut
engine against the NumPy oracle and the specification, the Gear table,
``describe()`` round trips through both packages'
``fragmenter_from_description`` (``cdc-anchored`` too), the factory and
``serve``'s flags, a port SmartClient chunking for a dfs_tpu ``cdc`` node,
and the config fingerprint a mixed cluster's doctor compares."""

from __future__ import annotations

import asyncio
import hashlib
import socket
from pathlib import Path

import numpy as np
import pytest

from dfs_tpu import config as ref_config
from dfs_tpu.fragmenter import base as ref_base
from dfs_tpu.fragmenter import cdc_cpu as ref_cdc
from dfs_tpu.fragmenter.fixed import FixedFragmenter as RefFixed
from dfs_tpu.node import runtime as ref_runtime
from dfs_tpu.utils import hashing as ref_hashing

from dfs_tpu_torch import config as port_config
from dfs_tpu_torch.fragmenter import base
from dfs_tpu_torch.fragmenter.cdc_anchored import AnchoredCpuFragmenter
from dfs_tpu_torch.fragmenter.cdc_cpu import (CpuCdcFragmenter, cdc_cuts_ref,
                                              gear_bitmap_carry,
                                              gear_bitmap_numpy)
from dfs_tpu_torch.fragmenter.fixed import FixedFragmenter
from dfs_tpu_torch.native import native_gear_cuts
from dfs_tpu_torch.node import runtime as port_runtime
from dfs_tpu_torch.ops.boundary import select_cuts
from dfs_tpu_torch.ops.cdc_anchored import AnchoredCdcParams
from dfs_tpu_torch.ops.cdc_v2 import AlignedCdcParams
from dfs_tpu_torch.utils.hashing import gear_table

SIZES = [dict(min_size=64, avg_size=256, max_size=1024),
         dict(min_size=2048, avg_size=8192, max_size=65536, seed=7)]


def corpus(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, size=n,
                                                dtype=np.uint8).tobytes()


def triples(chunks) -> list:
    return [(c.offset, c.length, c.digest) for c in chunks]


@pytest.mark.parametrize("n", [0, 1, 7, 100_003])
@pytest.mark.parametrize("parts", [1, 3, 5])
def test_fixed_tables_equal_dfs_tpu(parts, n):
    data = corpus(n, n + parts)
    f = FixedFragmenter(parts)
    assert triples(f.chunk(data)) == triples(RefFixed(parts).chunk(data))
    got = [c for b in f.chunks_stream(iter([data[:n // 2], data[n // 2:]]))
           for c in b]
    assert triples(got) == triples(f.chunk(data))
    assert f.stream_span() is None and f.describe() == \
        RefFixed(parts).describe()


@pytest.mark.parametrize("n", [0, 1, 5000, 300_000])
@pytest.mark.parametrize("s", range(len(SIZES)))
def test_cdc_tables_equal_dfs_tpu(s, n):
    port = CpuCdcFragmenter(port_config.CDCParams(**SIZES[s]))
    ref = ref_cdc.CpuCdcFragmenter(ref_config.CDCParams(**SIZES[s]))
    data = corpus(n, 100 + n + s)
    assert triples(port.chunk(data)) == triples(ref.chunk(data))
    blocks = [data[i:i + 9999] for i in range(0, len(data), 9999)]
    stored = {}
    m = port.manifest_stream(iter(blocks), "f", store=stored.__setitem__)
    r = ref.manifest_stream(iter(blocks), "f")
    assert (m.file_id, m.size, triples(m.chunks)) == \
        (r.file_id, r.size, triples(r.chunks))
    assert b"".join(stored[c.digest] for c in m.chunks) == data
    assert triples(c for b in port.chunks_stream(iter(blocks)) for c in b) \
        == triples(r.chunks)
    assert port.stream_span() is None
    assert port.describe() == ref.describe()


@pytest.mark.parametrize("s", range(len(SIZES)))
def test_native_cuts_equal_the_oracles(s):
    """The native sequential engine == the NumPy bitmap + greedy
    selection == the specification (both packages' for the last)."""
    p = port_config.CDCParams(**SIZES[s])
    data = corpus(40_000 if s == 0 else 400_000, 7 + s)
    arr = np.frombuffer(data, np.uint8)
    table = gear_table(p.seed)
    assert np.array_equal(table, ref_hashing.gear_table(p.seed))
    native = native_gear_cuts(data, table, p.mask, p.min_size, p.max_size)
    numpy_cuts = select_cuts(gear_bitmap_numpy(arr, table, p.mask),
                             len(data), p.min_size, p.max_size)
    assert np.array_equal(native, numpy_cuts)
    if s == 0:                     # the pure-Python spec, small input
        ref_p = ref_config.CDCParams(**SIZES[s])
        assert native.tolist() == cdc_cuts_ref(data, p) \
            == ref_cdc.cdc_cuts_ref(data, ref_p)
    # the streamed bitmap carries its halo across tiles
    halo = np.zeros(31, np.uint32)
    parts = []
    for i in range(0, len(arr), 4099):
        bm, halo = gear_bitmap_carry(arr[i:i + 4099], table, p.mask, halo)
        parts.append(bm)
    assert np.array_equal(np.concatenate(parts),
                          gear_bitmap_numpy(arr, table, p.mask))


ANCHORED = AnchoredCdcParams(
    chunk=AlignedCdcParams(min_blocks=2, avg_blocks=4, max_blocks=16,
                           strip_blocks=64),
    seg_min=2048, seg_max=4096, seg_mask=2047)


@pytest.mark.parametrize("kind", ["fixed", "cdc", "cdc-anchored"])
def test_describe_round_trips_between_packages(kind):
    """A description from either package rebuilds, in the other, an engine
    whose table is the describing engine's."""
    if kind == "fixed":
        port, ref = FixedFragmenter(4), RefFixed(4)
    elif kind == "cdc":
        port = CpuCdcFragmenter(port_config.CDCParams(**SIZES[0]))
        ref = ref_cdc.CpuCdcFragmenter(ref_config.CDCParams(**SIZES[0]))
    else:
        port = AnchoredCpuFragmenter(ANCHORED)
        ref = ref_base.fragmenter_from_description(port.describe())
    assert port.describe() == ref.describe()
    data = corpus(70_000, 21)
    want = triples(ref.chunk(data))
    back_port = base.fragmenter_from_description(ref.describe(),
                                                 device="cpu")
    back_ref = ref_base.fragmenter_from_description(port.describe())
    assert back_port.describe() == ref.describe()
    assert triples(back_port.chunk(data)) == triples(back_ref.chunk(data)) \
        == want
    assert type(base.params_from_description(ref.describe())).__name__ == \
        {"fixed": "int", "cdc": "CDCParams",
         "cdc-anchored": "AnchoredCdcParams"}[kind]


def test_factory_and_serve_flags():
    assert isinstance(base.get_fragmenter("fixed", fixed_parts=3),
                      FixedFragmenter)
    assert base.get_fragmenter("fixed", fixed_parts=3).parts == 3
    f = base.get_fragmenter("cdc", cdc_params=port_config.CDCParams(
        **SIZES[1]))
    assert isinstance(f, CpuCdcFragmenter) and f.params.seed == 7
    from dfs_tpu_torch.fragmenter.cdc_aligned import AlignedCpuFragmenter
    from dfs_tpu_torch.fragmenter.cdc_sharded import ShardedCdcFragmenter

    assert isinstance(base.get_fragmenter(
        "cdc", frag=port_config.FragmenterConfig(devices=2), device="cpu"),
        ShardedCdcFragmenter)
    assert isinstance(base.get_fragmenter("cdc-aligned"),
                      AlignedCpuFragmenter)
    with pytest.raises(ValueError, match="unknown fragmenter"):
        base.get_fragmenter("cdc-rolling")
    from dfs_tpu_torch.cli.main import build_parser, node_config

    ap = build_parser()
    cfg = node_config(ap.parse_args([
        "serve", "--node-id", "2", "--fragmenter", "fixed",
        "--fixed-parts", "3", "--sidecar-port", "50151"]))
    assert (cfg.fragmenter, cfg.fixed_parts, cfg.sidecar_port) == \
        ("fixed", 3, 50151)
    assert node_config(ap.parse_args(["serve", "--node-id", "1"])) \
        .sidecar_port is None
    with pytest.raises(SystemExit):            # download takes no --device
        ap.parse_args(["download", "--device", "cpu", "x"])
    assert ap.parse_args(["upload", "--device", "cpu", "f"]).device == "cpu"


def test_config_fingerprint_equal_to_dfs_tpu():
    """With ``sidecar_port``, ``fixed_parts`` and CDCParams' seed in the
    port's NodeConfig, a default node of each package hashes the same
    config, so a mixed cluster's doctor finds no ``config_drift``; a
    policy difference still shows."""
    def pair(**kw):
        ref = ref_config.NodeConfig(
            node_id=1, cluster=ref_config.ClusterConfig.localhost(3),
            data_root=Path("a"), **kw)
        port = port_config.NodeConfig(
            node_id=2, cluster=port_config.ClusterConfig.localhost(3),
            data_root=Path("b"), device="cpu", sidecar_port=50151, **kw)
        return (ref_runtime._config_fingerprint(ref),
                port_runtime._config_fingerprint(port))

    a, b = pair()
    assert a == b
    a, b = pair(fragmenter="cdc", fixed_parts=3)
    assert a == b
    assert pair(write_quorum=1)[0] != a


def test_port_smart_client_chunks_for_a_dfs_tpu_cdc_node(tmp_path):
    """A dfs_tpu node running ``cdc``: the port's SmartClient rebuilds its
    engine from ``/dataplane`` (no device needed) and uploads on the smart
    data plane, not the legacy path."""
    from dfs_tpu.node.runtime import StorageNodeServer

    from dfs_tpu_torch.client import SmartClient

    socks = [socket.socket() for _ in range(2)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    cfg = ref_config.NodeConfig(
        node_id=1, cluster=ref_config.ClusterConfig.localhost(1, *ports, 1),
        data_root=tmp_path, fragmenter="cdc",
        cdc=ref_config.CDCParams(**SIZES[0]), health_probe_s=0,
        write_quorum=1)
    data = corpus(60_000, 31)

    async def run():
        node = StorageNodeServer(cfg)
        await node.start()
        try:
            c = SmartClient(port=ports[0],
                            cfg=port_config.ClientConfig(fallback=False))
            info = await asyncio.to_thread(c.upload, data, "s.bin")
            got = await asyncio.to_thread(c.download, info["fileId"])
            m = node.store.manifests.load(info["fileId"])
            return info, got, m
        finally:
            await node.stop()

    info, got, m = asyncio.run(asyncio.wait_for(run(), timeout=60))
    assert info["dataPlane"] != "legacy" and got == data
    assert triples(m.chunks) == triples(ref_cdc.CpuCdcFragmenter(
        ref_config.CDCParams(**SIZES[0])).chunk(data))


DFS_TPU_NAMES = ["auto", "fixed", "cdc", "cdc-tpu", "cdc-aligned",
                 "cdc-aligned-tpu", "cdc-anchored", "cdc-anchored-tpu"]


def test_serve_and_sidecar_take_every_dfs_tpu_name():
    """Both subcommands' ``--fragmenter`` choices hold dfs_tpu's (its
    parser's own choices) and the port's -cuda names."""
    from dfs_tpu.cli.main import build_parser as ref_parser

    from dfs_tpu_torch.cli.main import build_parser

    def choices(ap, sub):
        sp = next(a for a in ap._actions if a.dest == "cmd" or
                  getattr(a, "choices", None) and sub in (a.choices or {}))
        act = next(a for a in sp.choices[sub]._actions
                   if a.dest == "fragmenter")
        return set(act.choices)

    for sub in ("serve", "sidecar"):
        ref = choices(ref_parser(), sub)
        assert ref == set(DFS_TPU_NAMES)
        assert choices(build_parser(), sub) >= ref | {
            "cdc-cuda", "cdc-aligned-cuda", "cdc-anchored-cuda"}


@pytest.mark.parametrize("kind", DFS_TPU_NAMES)
def test_every_dfs_tpu_name_chunks_like_dfs_tpu(kind):
    """The factory's engine for each of dfs_tpu's names, built from the
    same node sizes, against dfs_tpu's engine of that name: chunk() and
    the streamed manifest (table, size, fileId). dfs_tpu's ``auto`` probes
    for a TPU, so it is held to dfs_tpu's ``cdc-anchored`` (its CPU
    choice); the -tpu engines here take their small-input host paths,
    and tests/test_torch_v1.py and test_torch_aligned.py hold the device
    paths to dfs_tpu's. ``cdc-tpu``'s chunk() stages a whole 32 MiB tile,
    so only its streamed manifest is compared here."""
    import warnings

    data = corpus(70_000, 41)
    blocks = [data[i:i + 9999] for i in range(0, len(data), 9999)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        port = base.get_fragmenter(
            kind, cdc_params=port_config.CDCParams(**SIZES[1]),
            device="cpu", fixed_parts=4)
        ref = ref_base.get_fragmenter(
            "cdc-anchored" if kind == "auto" else kind,
            cdc_params=ref_config.CDCParams(**SIZES[1]), fixed_parts=4)
    if kind != "cdc-tpu":
        assert triples(port.chunk(data)) == triples(ref.chunk(data))
    m = port.manifest_stream(iter(blocks), "f")
    r = ref.manifest_stream(iter(blocks), "f")
    assert (m.file_id, m.size, triples(m.chunks)) == \
        (r.file_id, r.size, triples(r.chunks))
    assert port.name == ref.name.replace("-tpu", "-cuda") or \
        (kind == "auto" and port.name == "cdc-anchored-cuda")


def test_native_anchored_engine_equals_the_oracles():
    """The C++ spans (whole stream and window by window) == the NumPy
    oracle == dfs_tpu's native core; the host engine's table and stream ==
    dfs_tpu's; the batched native SHA-256 == hashlib."""
    from dfs_tpu.fragmenter.cdc_anchored import AnchoredCpuFragmenter as Ref
    from dfs_tpu.native import native_anchored_spans as ref_spans

    from dfs_tpu_torch.native import (native_anchored_spans,
                                      native_anchored_spans_region,
                                      native_sha256_many)
    from dfs_tpu_torch.ops.cdc_anchored import (chunk_spans_anchored_np,
                                                region_spans_np)

    data = corpus(50_000, 43)
    arr = np.frombuffer(data, np.uint8)
    spans = native_anchored_spans(arr, ANCHORED)
    assert spans.tolist() == [list(x) for x in
                              chunk_spans_anchored_np(arr, ANCHORED)]
    ref = Ref(ref_base.fragmenter_from_description(
        AnchoredCpuFragmenter(ANCHORED).describe()).params,
        region_bytes=16384)
    want = ref_spans(arr, ref.params)
    if want is not None:                 # dfs_tpu's build may be absent
        assert np.array_equal(spans, want)
    lb = arr[16384 - 8:16384]
    got = native_anchored_spans_region(arr[16384:32768], lb, 1000, False,
                                       ANCHORED)
    exp = region_spans_np(arr[16384:32768], lb, 1000, False, ANCHORED)
    assert (got[0].tolist(), got[1]) == ([list(x) for x in exp[0]], exp[1])
    port = AnchoredCpuFragmenter(ANCHORED, region_bytes=16384)
    blocks = [data[i:i + 7000] for i in range(0, len(data), 7000)]
    assert triples(port.chunk(data)) == triples(ref.chunk(data))
    assert triples(c for b in port.chunks_stream(iter(blocks)) for c in b) \
        == triples(ref.chunk(data))
    msgs = [data[:n] for n in (0, 55, 56, 64, 120, 1000)]
    assert native_sha256_many(msgs) == \
        [hashlib.sha256(m).hexdigest() for m in msgs]


def test_undescribable_node_answers_chunking_null(tmp_path):
    """A node running an aligned engine (not resume-describable) ingests,
    and its ``/dataplane`` carries ``chunking: null`` as dfs_tpu's does
    (its ``/chunking`` route answers 404 from the same NotImplementedError
    path)."""
    from dfs_tpu_torch.fragmenter.cdc_aligned import AlignedCudaFragmenter

    socks = [socket.socket() for _ in range(2)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    cfg = port_config.NodeConfig(
        node_id=1, cluster=port_config.ClusterConfig.localhost(1, *ports, 1),
        data_root=tmp_path, fragmenter="cdc-aligned-tpu", health_probe_s=0,
        device="cpu")
    data = corpus(30_000, 47)

    async def run():
        node = port_runtime.StorageNodeServer(cfg)
        await node.start()
        try:
            async def blocks():
                for off in range(0, len(data), 8192):
                    yield data[off:off + 8192]

            m, _ = await node.upload_stream(blocks(), "a.bin")
            _, got = await node.download(m.file_id)
            return node.fragmenter, node.dataplane_info(), m, bytes(got)
        finally:
            await node.stop()

    frag, info, m, got = asyncio.run(asyncio.wait_for(run(), timeout=60))
    assert isinstance(frag, AlignedCudaFragmenter) and got == data
    assert info["chunking"] is None
    assert m.fragmenter == "cdc-aligned-cuda"
    assert m.file_id == hashlib.sha256(data).hexdigest()
