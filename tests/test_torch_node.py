"""LocalNode (the port's single-node upload/download core) on the CPU, and
data-root interoperability with dfs_tpu's store in both directions."""

import hashlib

import numpy as np
import pytest

from dfs_tpu.fragmenter.cdc_anchored import AnchoredCpuFragmenter as RefCpu
from dfs_tpu.meta.manifest import Manifest as RefManifest
from dfs_tpu.ops.cdc_anchored import AnchoredCdcParams as RefParams
from dfs_tpu.ops.cdc_v2 import AlignedCdcParams as RefChunk
from dfs_tpu.store.cas import NodeStore as RefNodeStore

from dfs_tpu_torch.convert import params_from_reference
from dfs_tpu_torch.node import ChunkCorrupt, LocalNode

REF_SMALL = RefParams(
    chunk=RefChunk(min_blocks=2, avg_blocks=4, max_blocks=16,
                   strip_blocks=64),
    seg_min=2048, seg_max=4096, seg_mask=2047)
SMALL = params_from_reference(RefCpu(REF_SMALL).describe())


def corpus(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=n,
                                                dtype=np.uint8).tobytes()


def node(root, **kw):
    """A CPU node with SMALL chunking; the chain runs for every body unless
    cpu_cutoff says otherwise."""
    kw.setdefault("region_bytes", 16384)
    kw.setdefault("cpu_cutoff", 0)
    return LocalNode(root, device="cpu", params=SMALL, lane_multiple=8, **kw)


def test_upload_download_roundtrip_and_file_id(tmp_path):
    n = node(tmp_path)
    body = corpus(40000, seed=1)
    m, stats = n.upload(body, name="a.bin")
    assert m.file_id == hashlib.sha256(body).hexdigest()
    assert m.fragmenter == "cdc-anchored-cuda"
    assert stats["transferredBytes"] == len(body)       # random: no dups
    assert stats["dedupSkippedBytes"] == 0
    assert n.download(m.file_id) == body
    # the streamed path chunks identically and acks the same fileId
    blocks = [body[i:i + 4096] for i in range(0, len(body), 4096)]
    m2, stats2 = n.upload_stream(iter(blocks), name="a.bin")
    assert m2.file_id == m.file_id and m2.chunks == m.chunks
    assert stats2["transferredBytes"] == 0
    assert [x.file_id for x in n.list()] == [m.file_id]
    on_disk = (tmp_path / "node-1" / "chunks" / m.chunks[0].digest[:2]
               / m.chunks[0].digest)
    assert on_disk.read_bytes() == body[:m.chunks[0].length]


def test_reupload_transfers_nothing_and_edit_dedups(tmp_path):
    n = node(tmp_path, cpu_cutoff=1 << 21)     # whole bodies: oracle path
    body = corpus(200000, seed=2)
    m, _ = n.upload(body)
    _, again = n.upload(body)
    assert again["transferredBytes"] == 0
    assert again["dedupSkippedBytes"] == sum(
        c.length for c in {c.digest: c for c in m.chunks}.values())
    # three unaligned insertions: only the segments they land in change
    edited = bytearray(body)
    for off, ins in ((150001, b"x" * 7), (90003, b"yy"), (30005, b"z" * 77)):
        edited[off:off] = ins
    m3, st = n.upload(bytes(edited))
    assert st["dedupSkippedBytes"] / len(edited) > 0.85, st
    assert n.download(m3.file_id) == bytes(edited)


def test_duplicate_chunks_within_a_file_are_placed_once(tmp_path):
    n = node(tmp_path, cpu_cutoff=1 << 21)
    part = corpus(30000, seed=3)
    body = part * 3
    m, st = n.upload(body)
    assert st["uniqueChunks"] < len(m.chunks)
    assert st["transferredBytes"] + st["dedupSkippedBytes"] == sum(
        c.length for c in {c.digest: c for c in m.chunks}.values())
    assert n.download(m.file_id) == body


def test_empty_file_roundtrip(tmp_path):
    n = node(tmp_path)
    m, st = n.upload(b"", name="empty")
    assert m.file_id == hashlib.sha256(b"").hexdigest() and not m.chunks
    assert st["transferredBytes"] == 0 and st["bytes"] == 0
    m2, _ = n.upload_stream(iter([]), name="empty")
    assert m2.file_id == m.file_id and m2.size == 0
    assert n.download(m.file_id) == b""


def test_corrupted_chunk_is_caught_on_download(tmp_path):
    n = node(tmp_path, cpu_cutoff=1 << 21)
    body = corpus(50000, seed=4)
    m, _ = n.upload(body)
    c = m.chunks[len(m.chunks) // 2]
    p = tmp_path / "node-1" / "chunks" / c.digest[:2] / c.digest
    raw = bytearray(p.read_bytes())
    raw[0] ^= 0xFF
    p.write_bytes(bytes(raw))
    with pytest.raises(ChunkCorrupt):
        n.download(m.file_id)
    p.unlink()
    with pytest.raises(ChunkCorrupt):
        n.download(m.file_id)
    with pytest.raises(FileNotFoundError):
        n.download("0" * 64)


def test_reference_data_root_opens_in_the_port(tmp_path):
    """A root written by dfs_tpu.store.cas.NodeStore (dfs_tpu's anchored
    manifest) downloads through the port, and re-uploading the same bytes
    through the port's engine dedups completely: same chunks, same
    digests, same layout."""
    body = corpus(60000, seed=5)
    ref = RefNodeStore(tmp_path, 1, fsync=True)
    frag = RefCpu(REF_SMALL)
    rm = frag.manifest(body, name="r.bin",
                       file_id=hashlib.sha256(body).hexdigest())
    for c in rm.chunks:
        ref.chunks.put(c.digest, body[c.offset:c.offset + c.length])
    ref.manifests.save(rm)

    n = node(tmp_path)
    assert n.download(rm.file_id) == body
    m, st = n.upload(body, name="r.bin")
    assert st["transferredBytes"] == 0
    assert [(c.offset, c.length, c.digest) for c in m.chunks] == \
        [(c.offset, c.length, c.digest) for c in rm.chunks]


def test_port_data_root_opens_in_the_reference(tmp_path):
    n = node(tmp_path)
    body = corpus(45000, seed=6)
    m, _ = n.upload(body, name="p.bin")
    ref = RefNodeStore(tmp_path, 1)
    rm = ref.manifests.load(m.file_id)
    assert isinstance(rm, RefManifest)
    assert rm.to_json() == m.to_json()
    got = b"".join(ref.chunks.get(c.digest) for c in rm.chunks)
    assert got == body
    assert ref.manifests.ids() == [m.file_id]
    # both stores read the same catalog off the same root
    assert n.store.chunks.digests() == ref.chunks.digests()
    assert n.store.chunks.count() == ref.chunks.count() == len(m.chunks)
    assert n.store.chunks.total_bytes() == ref.chunks.total_bytes() \
        == len(body)
