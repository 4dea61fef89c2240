"""The port's similarity plane (dfs_tpu_torch.sim and the delta seam of its
CAS) against dfs_tpu's on the same numpy inputs, on the CPU: sketches
against ``sketch_np`` and JAX's ``make_sketch_step`` on 4 CPU devices,
lane constants and band keys, DSD1 blobs and ``bands.log`` records made
by either package and read by the other, the CAS cases of
tests/test_sim.py on the port's ChunkStore, and the plane wired into a
node. Every comparison is exact."""

import asyncio
import os
import socket
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from dfs_tpu.config import SimConfig as RefSimConfig
from dfs_tpu.sim import bands as ref_bands
from dfs_tpu.sim import delta as ref_delta
from dfs_tpu.sim import sketch as ref_sketch

from dfs_tpu_torch.config import (CDCParams, ClusterConfig, NodeConfig,
                                  PeerAddr, SimConfig)
from dfs_tpu_torch.meta.manifest import ChunkRef, Manifest
from dfs_tpu_torch.sim import SimPlane
from dfs_tpu_torch.sim.bands import _REC, BandIndex
from dfs_tpu_torch.sim.delta import (HEADER_BYTES, apply_delta, is_delta,
                                     make_delta, parse_header)
from dfs_tpu_torch.sim.sketch import (EMPTY_LANE, SimSketcher, SketchPlan,
                                      band_keys, lane_constants, sketch_np,
                                      sketch_rows)
from dfs_tpu_torch.store.cas import ChunkStore, NodeStore
from dfs_tpu_torch.utils.hashing import sha256_hex

WINDOW = 4096        # the window tests/test_sim.py sketches at
SIZES = [0, 1, 7, 100, 5000, WINDOW, WINDOW + 1, 3 * WINDOW - 7]
RAGGED = [100, WINDOW, 2 * WINDOW + 5, 300, WINDOW - 1, 0, 5 * WINDOW, 2048,
          WINDOW, 77, 4000, WINDOW // 2, 1]
# store-level knobs, as tests/test_sim.py: tiny chunks are eligible
SIM_NOW = SimConfig(enabled=True, min_chunk_bytes=64)


def _mutate(data: bytes, at: int, ins: bytes) -> bytes:
    return data[:at] + ins + data[at + 1:]


def _rand(n: int, rng) -> bytes:
    return rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()


def _oracle(data: bytes, q: int = 8) -> np.ndarray:
    a, b = ref_sketch.lane_constants(16)
    return ref_sketch.sketch_np(data, 16, q, a, b)


@pytest.fixture(scope="module")
def ref_mesh_sketcher():
    """dfs_tpu's sketcher through its make_sketch_step on 4 CPU devices."""
    return ref_sketch.SimSketcher(RefSimConfig(enabled=True, devices=4),
                                  window_bytes=WINDOW)


# ------------------------------------------------------------------ #
# sketches
# ------------------------------------------------------------------ #

def test_lane_constants_and_band_keys_match_reference():
    for n, seed in ((16, 0x5349), (7, 0x5349), (64, 12345)):
        a, b = lane_constants(n, seed)
        ra, rb = ref_sketch.lane_constants(n, seed)
        assert a.dtype == np.uint32 and np.array_equal(a, ra)
        assert np.array_equal(b, rb) and (a % 2 == 1).all()
    rng = np.random.default_rng(230)
    a, b = lane_constants(16)
    for _ in range(20):
        s = rng.integers(0, 2**32, size=16, dtype=np.uint32)
        for bands in (1, 2, 4, 8, 16):
            assert band_keys(s, bands) == ref_sketch.band_keys(s, bands)
        d = _rand(int(rng.integers(0, 3000)), rng)
        assert np.array_equal(sketch_np(d, 16, 8, a, b), _oracle(d))
    empty = np.full(16, EMPTY_LANE, np.uint32)
    assert band_keys(empty, 4) == ref_sketch.band_keys(empty, 4) == []
    assert EMPTY_LANE == ref_sketch.EMPTY_LANE
    assert SimConfig() == SimConfig(enabled=False)
    assert {f: getattr(SimConfig(), f)
            for f in SimConfig.__dataclass_fields__} == \
        {f: getattr(RefSimConfig(), f)
         for f in RefSimConfig.__dataclass_fields__}


@pytest.mark.parametrize("bad", [dict(sketch_size=0), dict(bands=3),
                                 dict(shingle_bytes=65),
                                 dict(shingle_bytes=0),
                                 dict(max_candidates=0),
                                 dict(min_chunk_bytes=-1),
                                 dict(min_savings_frac=0.0),
                                 dict(max_delta_depth=0), dict(devices=-1),
                                 dict(rematerialize_reads=-1)])
def test_sim_config_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError):
        RefSimConfig(**bad)
    with pytest.raises(ValueError):
        SimConfig(**bad)


@pytest.mark.parametrize("size", SIZES)
def test_sketch_matches_oracle_and_jax(size, ref_mesh_sketcher):
    """One chunk through the port's sketcher on one CPU slot and on 4
    (the sharded step) == dfs_tpu's oracle == JAX's make_sketch_step on 4
    CPU devices: empty, shorter than a shingle, sub-window, exact-window
    and longer than the window (the oracle path in both packages)."""
    data = _rand(size, np.random.default_rng(210))
    want = _oracle(data)
    assert np.array_equal(ref_mesh_sketcher.sketch_many([data])[0], want)
    for devices in (0, 4):
        skt = SimSketcher(SimConfig(enabled=True, devices=devices),
                          window_bytes=WINDOW, device="cpu")
        got = skt.sketch_many([data])
        assert got.dtype == np.uint32 and np.array_equal(got[0], want)
        assert np.array_equal(skt.sketch_one(data), want)
    if size < 8:
        assert (want == EMPTY_LANE).all()


def test_sketch_batch_mixes_ragged_and_spans_slots(ref_mesh_sketcher):
    """The mixed batch of tests/test_sim.py: rows of many padded widths,
    chunks longer than the window interleaved, on one slot and 4 slots,
    every lane equal to the oracle and to JAX's mesh, in order."""
    rng = np.random.default_rng(211)
    datas = [_rand(s, rng) for s in RAGGED]
    want = np.stack([_oracle(d) for d in datas])
    assert np.array_equal(ref_mesh_sketcher.sketch_many(datas), want)
    for devices in (0, 1, 4):
        skt = SimSketcher(SimConfig(enabled=True, devices=devices),
                          window_bytes=WINDOW, device="cpu")
        assert np.array_equal(skt.sketch_many(datas), want)
    # bytearray and memoryview payloads (what replication hands the CAS)
    views = [bytearray(d) if i % 2 else memoryview(d)
             for i, d in enumerate(datas)]
    assert np.array_equal(skt.sketch_many(views), want)
    assert skt.sketch_many([]).shape == (0, 16)


@pytest.mark.parametrize("q", [1, 8, 64])
def test_sketch_rows_and_sharded_step_match_jax_step(q):
    """sketch_rows and the port's make_sketch_step on a 4-slot CPU mesh
    against JAX's make_sketch_step on 4 CPU devices, at shingle widths 1,
    8 and 64, on zero-padded rows of every length class."""
    from dfs_tpu.parallel.mesh import make_mesh as ref_make_mesh
    from dfs_tpu.parallel.sharded_cdc import make_sketch_step as ref_step

    from dfs_tpu_torch.parallel.mesh import make_mesh
    from dfs_tpu_torch.parallel.sharded_cdc import (make_sketch_step,
                                                    shard_sketch_inputs)

    rng = np.random.default_rng(212 + q)
    lens = np.array([0, 1, q - 1, q, q + 1, 100, 2000, WINDOW], np.int32)
    blocks = np.zeros((len(lens), WINDOW), np.uint8)
    for i, ln in enumerate(lens):
        blocks[i, :ln] = rng.integers(0, 256, size=ln, dtype=np.uint8)
    a, b = lane_constants(16)
    want = np.asarray(ref_step(ref_make_mesh(4, dp=4), a, b, q, WINDOW,
                               ref_sketch._MULT)(blocks, lens))
    for i, ln in enumerate(lens):
        assert np.array_equal(want[i], _oracle(blocks[i, :ln].tobytes(), q))
    got = sketch_rows(torch.from_numpy(blocks), torch.from_numpy(lens), a,
                      b, q)
    assert got.dtype == torch.uint32
    assert np.array_equal(got.view(torch.int32).numpy().view(np.uint32),
                          want)
    mesh = make_mesh(4, device="cpu")
    got4 = make_sketch_step(mesh, a, b, q)(*shard_sketch_inputs(
        mesh, blocks, lens))
    assert np.array_equal(got4.view(torch.int32).numpy().view(np.uint32),
                          want)
    with pytest.raises(ValueError, match="does not split"):
        shard_sketch_inputs(mesh, blocks[:6], lens[:6])


def test_sketch_plan_buckets_rows_without_padding_every_row():
    """Rows are grouped by the EC bucket rule (zero padding under 25%),
    never narrower than a shingle; the packed buffer holds each row at its
    place and the positions computed stay within 25% of the live ones."""
    rng = np.random.default_rng(213)
    lens = [int(x) for x in rng.integers(2048, 65536, size=300)] + [0, 3]
    plan = SketchPlan(lens, 8)
    assert sorted(plan.order) == list(range(len(lens)))
    assert all(w >= 8 for w, _, _, _ in plan.groups)
    assert plan.positions <= 1.25 * plan.live_positions + 8 * 2
    datas = [_rand(n, rng) for n in lens]
    host = plan.pack(datas)
    assert list(host[:4 * len(lens)].view(np.int32)) == \
        [lens[i] for i in plan.order]
    for width, n, row0, off in plan.groups:
        blk = host[off:off + n * width].reshape(n, width)
        for r, i in enumerate(plan.order[row0:row0 + n]):
            assert blk[r, :lens[i]].tobytes() == datas[i]
            assert not blk[r, lens[i]:].any()


def test_sketcher_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        SimSketcher(SimConfig(enabled=True))


# ------------------------------------------------------------------ #
# DSD1 and bands.log cross both ways
# ------------------------------------------------------------------ #

def test_delta_blobs_identical_and_apply_across_packages():
    rng = np.random.default_rng(214)
    base = _rand(20_000, rng)
    targets = [base, _mutate(base, 9999, b"EDIT"),
               base[:5000] + b"INSERTED" + base[5000:], base[3000:17000],
               base[10000:] + base[:10000], _rand(20_000, rng), b"",
               b"short"]
    d0 = sha256_hex(base)
    for t in targets:
        blob = make_delta(d0, base, t)
        assert blob == ref_delta.make_delta(d0, base, t)
        assert is_delta(blob) and parse_header(blob) == (d0, len(t))
        assert apply_delta(blob, base) == t
        assert ref_delta.apply_delta(blob, base) == t
    assert HEADER_BYTES == ref_delta.HEADER_BYTES
    blob = make_delta(d0, base, _mutate(base, 9999, b"EDIT"))
    assert len(blob) < len(base) // 4
    with pytest.raises(ValueError):
        parse_header(b"XXXX" + blob[4:])
    with pytest.raises(ValueError):
        apply_delta(blob[:HEADER_BYTES + 3], base)
    with pytest.raises(ValueError):
        apply_delta(blob + b"\x07", base)
    bad = bytearray(make_delta(d0, base, base))
    struct.pack_into(">II", bad, HEADER_BYTES + 1, len(base) - 4, 4096)
    with pytest.raises(ValueError):
        apply_delta(bytes(bad), base)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_band_log_replays_in_the_other_package(tmp_path, writer):
    """A bands.log written by either package (records byte-identical)
    replays in the other, a torn tail truncated at the first bad record;
    compaction leaves a log the other replays in the same order."""
    w_cls, r_cls = (BandIndex, ref_bands.BandIndex) if writer == "port" \
        else (ref_bands.BandIndex, BandIndex)
    assert _REC.format == ref_bands._REC.format
    idx = w_cls(tmp_path)
    idx.add("aa" * 32, [1, 2])
    idx.add("bb" * 32, [2, 3])
    idx.close()
    log = (tmp_path / "bands.log").read_bytes()
    twin = tmp_path / "twin"
    other = (ref_bands.BandIndex if writer == "port" else BandIndex)(twin)
    other.add("aa" * 32, [1, 2])
    other.add("bb" * 32, [2, 3])
    other.close()
    assert (twin / "bands.log").read_bytes() == log
    with open(tmp_path / "bands.log", "ab") as fh:
        fh.write(b"\x00" * 17)
    idx2 = r_cls(tmp_path)
    assert idx2.replayed == 4 and idx2.truncated == 17
    assert idx2.lookup([2]) == ["bb" * 32, "aa" * 32]
    idx2.add("cc" * 32, [3])
    idx2.close()
    idx3 = w_cls(tmp_path)
    assert idx3.lookup([3]) == ["cc" * 32, "bb" * 32]
    idx3.close()
    comp = tmp_path / "compact"
    idx4 = w_cls(comp, per_key=2, compact_factor=2,
                  compact_min_bytes=8 * _REC.size)
    for i in range(40):
        idx4.add(f"{i:02d}" * 32, [7])
    assert idx4.compactions >= 1
    idx4.close()
    idx5 = r_cls(comp, per_key=2)
    assert idx5.lookup([7]) == ["39" * 32, "38" * 32]
    assert idx5.replayed <= 6
    idx5.close()


def test_band_index_bounds_candidates(tmp_path):
    idx = BandIndex(tmp_path, per_key=2)
    for i in range(5):
        idx.add(f"{i:02d}" * 32, [7])
    assert idx.lookup([7]) == ["04" * 32, "03" * 32]
    assert idx.lookup([7], exclude="04" * 32) == ["03" * 32]
    idx.close()
    blob = bytearray((tmp_path / "bands.log").read_bytes())
    blob[50] ^= 0xFF                            # damage record 1
    (tmp_path / "bands.log").write_bytes(blob)
    idx2 = BandIndex(tmp_path)
    assert idx2.replayed == 1 and idx2.lookup([7]) == ["00" * 32]
    idx2.close()


# ------------------------------------------------------------------ #
# the CAS delta seam (the cases of tests/test_sim.py)
# ------------------------------------------------------------------ #

def _sim_store(root: Path, cfg: SimConfig = SIM_NOW) -> ChunkStore:
    cs = ChunkStore(root / "chunks")
    cs.sim = SimPlane(cfg, root / "sim", device="cpu")
    return cs


def _put(cs, data: bytes) -> str:
    d = sha256_hex(data)
    cs.put(d, data)
    return d


def test_store_delta_write_read_verify(tmp_path):
    cs = _sim_store(tmp_path)
    rng = np.random.default_rng(215)
    base = _rand(16_384, rng)
    near = _mutate(base, 8000, b"!")
    d0, d1 = _put(cs, base), _put(cs, near)
    assert cs.delta_base(d1) == d0 and cs.delta_count() == 1
    assert cs.get(d1) == near and cs.get(d0) == base
    blob = Path(cs._delta_path_str(d1)).read_bytes()
    assert is_delta(blob) and len(blob) < len(near) // 2
    assert blob == ref_delta.make_delta(d0, base, near)
    assert cs.has(d1) and d1 in cs.digests() and cs.count() == 2
    assert cs.total_bytes() == len(base) + len(blob)
    assert cs.put(d1, near) is False            # present as a delta
    st = cs.sim.stats()
    assert st["deltasWritten"] == 1 and st["deltaBytes"] == len(blob)
    assert st["rawBytesDeferred"] == len(near) and st["sketched"] == 2
    assert st["sketchDegraded"] is False
    cs.sim.close()


def test_store_delta_accepts_bytearray_payload(tmp_path):
    cs = _sim_store(tmp_path)
    rng = np.random.default_rng(219)
    base = _rand(16_384, rng)
    near = _mutate(base, 8000, b"!")
    d0, d1 = sha256_hex(base), sha256_hex(near)
    cs.put(d0, bytearray(base))
    cs.put(d1, bytearray(near))
    assert cs.delta_base(d1) == d0 and cs.delta_count() == 1
    assert cs.get(d0) == base and cs.get(d1) == near
    cs.sim.close()


def test_store_put_batch_sketches_once_per_batch(tmp_path):
    """put_batch sketches the batch's new eligible chunks in one call and
    stores the same as put() one by one would."""
    cs = _sim_store(tmp_path)
    rng = np.random.default_rng(222)
    base = _rand(16_384, rng)
    items = [(sha256_hex(b), b) for b in
             (base, _rand(40, rng), _mutate(base, 77, b"?"))]
    calls = []
    orig = cs.sim.sketcher.sketch_many
    cs.sim.sketcher.sketch_many = lambda ds: calls.append(len(ds)) or orig(ds)
    assert cs.put_batch(items + items[:1], verify=True) == \
        [True, True, True, False]
    assert calls == [2]                  # 40 B is below min_chunk_bytes
    assert cs.delta_base(items[2][0]) == items[0][0]
    cs.sim.close()


def test_store_pins_base_until_dependents_die(tmp_path):
    cs = _sim_store(tmp_path)
    rng = np.random.default_rng(216)
    base = _rand(16_384, rng)
    d0 = _put(cs, base)
    d1 = _put(cs, _mutate(base, 100, b"x"))
    assert cs.delta_base(d1) == d0 and cs.delta_pinned(d0)
    assert cs.delete(d0) is False
    assert cs.get(d1) is not None
    assert cs.delete(d1) is True
    assert not cs.delta_pinned(d0)
    assert cs.delete(d0) is True
    assert cs.delta_count() == 0 and cs.count() == 0
    cs.sim.close()


def test_gc_releases_pin_when_referencing_file_deleted(tmp_path):
    ns = NodeStore(tmp_path, node_id=1)
    plane = ns.chunks.sim = SimPlane(SIM_NOW, ns.root / "sim", device="cpu")
    rng = np.random.default_rng(217)
    base = _rand(16_384, rng)
    near = _mutate(base, 5000, b"~")
    d0, d1 = _put(ns.chunks, base), _put(ns.chunks, near)
    assert ns.chunks.delta_base(d1) == d0

    def mk(name: str, data: bytes, digest: str) -> Manifest:
        return Manifest(file_id=sha256_hex(data), name=name, size=len(data),
                        fragmenter="fixed",
                        chunks=(ChunkRef(index=0, offset=0,
                                         length=len(data), digest=digest),))

    m1, m2 = mk("f1", base, d0), mk("f2", near, d1)
    ns.manifests.save(m1)
    ns.manifests.save(m2)
    assert ns.gc(min_age_s=0.0) == []
    ns.manifests.delete(m2.file_id)
    assert ns.gc(min_age_s=0.0) == [d1]
    assert not ns.chunks.delta_pinned(d0) and ns.chunks.get(d0) == base
    ns.manifests.delete(m1.file_id)
    assert ns.gc(min_age_s=0.0) == [d0]
    assert ns.chunks.delta_count() == 0
    # the live set expands through base chains
    base2 = _rand(16_384, rng)
    near2 = _mutate(base2, 900, b"^")
    e0, e1 = _put(ns.chunks, base2), _put(ns.chunks, near2)
    assert ns.chunks.delta_base(e1) == e0
    m3 = mk("f3", near2, e1)
    ns.manifests.save(m3)
    assert ns.gc(min_age_s=0.0) == []
    assert ns.gc(min_age_s=3600.0) == []         # young: spared anyway
    assert ns.chunks.get(e1) == near2
    ns.manifests.delete(m3.file_id)
    assert sorted(ns.gc(min_age_s=0.0)) == sorted([e0, e1])
    assert ns.chunks.delta_count() == 0
    plane.close()


def test_store_depth_cap_and_rematerialize(tmp_path):
    cfg = SimConfig(enabled=True, min_chunk_bytes=64, max_delta_depth=2,
                    rematerialize_reads=2)
    cs = _sim_store(tmp_path, cfg)
    rng = np.random.default_rng(218)
    gen = [_rand(16_384, rng)]
    for i in range(4):
        gen.append(_mutate(gen[-1], 2000 + i, bytes([i])))
    ds = [_put(cs, g) for g in gen]
    depths = [cs.delta_depth(d) for d in ds]
    assert max(depths) <= 2 and depths[0] == 0
    assert any(x > 0 for x in depths)
    for d, g in zip(ds, gen):
        assert cs.get(d) == g
    cs.sim.close()
    cs2 = _sim_store(tmp_path / "re", cfg)
    base = _rand(16_384, rng)
    near = _mutate(base, 4444, b"#")
    d0, d1 = _put(cs2, base), _put(cs2, near)
    assert cs2.delta_base(d1) == d0
    assert cs2.get(d1) == near and cs2.delta_base(d1) == d0
    assert cs2.get(d1) == near                  # read 2: re-materialized
    assert cs2.delta_base(d1) is None
    assert os.path.isfile(cs2._path_str(d1))
    assert not os.path.isfile(cs2._delta_path_str(d1))
    assert cs2.get(d1) == near and not cs2.delta_pinned(d0)
    assert cs2.delete(d0)
    assert cs2.sim.stats()["rematerialized"] == 1
    cs2.sim.close()


def test_store_restart_primes_pins_without_plane(tmp_path):
    cs = _sim_store(tmp_path)
    rng = np.random.default_rng(219)
    base = _rand(16_384, rng)
    near = _mutate(base, 700, b"*")
    d0, d1 = _put(cs, base), _put(cs, near)
    cs.sim.close()
    cs2 = ChunkStore(tmp_path / "chunks")
    assert cs2.delta_base(d1) == d0 and cs2.get(d1) == near
    assert cs2.delete(d0) is False
    assert cs2.delete(d1) and cs2.delete(d0)


def test_store_corrupt_delta_treated_as_corrupt_chunk(tmp_path):
    cs = _sim_store(tmp_path)
    rng = np.random.default_rng(220)
    base = _rand(16_384, rng)
    d0 = _put(cs, base)
    d1 = _put(cs, _mutate(base, 3000, b"&"))
    p = Path(cs._delta_path_str(d1))
    blob = bytearray(p.read_bytes())
    blob[HEADER_BYTES:] = b"\x09" * 8
    p.write_bytes(blob)
    assert cs.get(d1) is None
    assert not cs.delta_pinned(d0) and not cs.has(d1)
    cs.sim.close()


def test_default_off_store_identity(tmp_path):
    cs = ChunkStore(tmp_path / "chunks")
    data = b"identity" * 4000
    d = _put(cs, data)
    assert cs.get(d) == data
    assert not (tmp_path / "chunks" / "deltas").exists()
    assert [p.name for p in sorted((tmp_path / "chunks").iterdir())] \
        == [d[:2]]
    assert cs.delta_count() == 0 and cs.delta_base(d) is None


# ------------------------------------------------------------------ #
# the plane in a node
# ------------------------------------------------------------------ #

def _one_node(root: Path, **kw) -> NodeConfig:
    socks = [socket.socket() for _ in range(2)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    cluster = ClusterConfig(peers=(PeerAddr(node_id=1, host="127.0.0.1",
                                            port=ports[0],
                                            internal_port=ports[1]),),
                            replication_factor=1)
    return NodeConfig(node_id=1, cluster=cluster, data_root=root,
                      cdc=CDCParams(min_size=2048, avg_size=8192,
                                    max_size=65536),
                      health_probe_s=0, device="cpu", **kw)


def test_node_sim_plane_wiring(tmp_path):
    """A node with the plane: a near-duplicate upload writes a delta, both
    downloads are identical, ``/metrics`` ``sim`` mirrors the config,
    scrub passes over the delta and ``delete_chunks`` refuses a pinned
    base. A default node reports {"enabled": false} and writes no sim/ or
    deltas/."""
    from dfs_tpu_torch.node.runtime import StorageNodeServer

    async def run() -> None:
        node = StorageNodeServer(_one_node(
            tmp_path, sim=SimConfig(enabled=True, min_chunk_bytes=1024)))
        await node.start()
        try:
            rng = np.random.default_rng(221)
            data = _rand(120_000, rng)
            near = _mutate(data, 60_000, b"@")
            m1, _ = await node.upload(data, "f1.bin")
            m2, _ = await node.upload(near, "f2.bin")
            _, b1 = await node.download(m1.file_id)
            _, b2 = await node.download(m2.file_id)
            assert bytes(b1) == data and bytes(b2) == near
            st = node.metrics()["sim"]
            assert st["enabled"] is True and st["device"] == "cpu"
            assert st["sketched"] > 0 and st["deltasWritten"] >= 1
            assert st["deltaChunks"] >= 1 and st["minChunkBytes"] == 1024
            assert st["deltaReads"] >= 1
            scrub = await node.scrub_once()
            assert scrub["corrupt"] == 0 and scrub["deltaMissingBase"] == 0
            assert scrub["scanned"] == node.store.chunks.count()
            # a pinned base no manifest owns: delete_chunks refuses it
            ch = node.store.chunks
            base = _rand(16_384, rng)
            dep = _mutate(base, 50, b"%")
            db, dd = _put(ch, base), _put(ch, dep)
            assert ch.delta_base(dd) == db
            hdr, _ = await node._dispatch({"op": "delete_chunks",
                                           "digests": [db]}, b"")
            assert hdr["refused"] == [db] and hdr["removed"] == []
            # the dependent first: its delete releases the pin
            hdr, _ = await node._dispatch({"op": "delete_chunks",
                                           "digests": [dd, db]}, b"")
            assert hdr["removed"] == [dd, db] and hdr["refused"] == []
        finally:
            await node.stop()

    asyncio.run(asyncio.wait_for(run(), timeout=120))

    async def run_off() -> None:
        node = StorageNodeServer(_one_node(tmp_path / "off"))
        await node.start()
        try:
            assert node.sim is None
            assert node.metrics()["sim"] == {"enabled": False}
            m, _ = await node.upload(b"plain" * 9000, "f.bin")
            _, body = await node.download(m.file_id)
            assert bytes(body) == b"plain" * 9000
            assert not (node.store.root / "sim").exists()
            assert not (node.store.root / "chunks" / "deltas").exists()
        finally:
            await node.stop()

    asyncio.run(asyncio.wait_for(run_off(), timeout=120))


def test_scrub_queues_the_missing_base_of_a_delta(tmp_path):
    """A delta whose base is gone reads as absent; scrub queues the base
    for repair instead of calling the delta corrupt."""
    from dfs_tpu_torch.node.runtime import StorageNodeServer

    async def run() -> None:
        node = StorageNodeServer(_one_node(
            tmp_path, sim=SimConfig(enabled=True, min_chunk_bytes=64)))
        try:
            ch = node.store.chunks
            rng = np.random.default_rng(223)
            base = _rand(16_384, rng)
            db, dd = _put(ch, base), _put(ch, _mutate(base, 9, b"+"))
            assert ch.delta_base(dd) == db
            os.unlink(ch._path_str(db))        # the base lost on disk
            res = await node.scrub_once()
            assert res["deltaMissingBase"] == 1 and res["corrupt"] == 0
            assert db in node.under_replicated
            assert ch.delta_base(dd) == db     # kept for the repair
        finally:
            await node.stop()

    asyncio.run(asyncio.wait_for(run(), timeout=60))
