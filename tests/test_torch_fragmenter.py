"""The port's pipelined window walk against dfs_tpu's AnchoredCpuFragmenter:
windows a few seg_max wide (many carries), cpu_cutoff=0 so every window
runs the chain (plain versions on the CPU). Exact equality throughout."""

import numpy as np
import pytest

from dfs_tpu.fragmenter.cdc_anchored import AnchoredCpuFragmenter as RefCpu
from dfs_tpu.ops.cdc_anchored import AnchoredCdcParams as RefParams
from dfs_tpu.ops.cdc_anchored import chunk_file_anchored_np as ref_oracle
from dfs_tpu.ops.cdc_v2 import AlignedCdcParams as RefChunk

import dfs_tpu_torch.ops.cdc_anchored as A
from dfs_tpu_torch.convert import params_from_reference
from dfs_tpu_torch.fragmenter.cdc_anchored import (AnchoredCpuFragmenter,
                                                   AnchoredCudaFragmenter)

REF_SMALL = RefParams(
    chunk=RefChunk(min_blocks=2, avg_blocks=4, max_blocks=16,
                   strip_blocks=64),
    seg_min=2048, seg_max=4096, seg_mask=2047)
REF = RefCpu(REF_SMALL)
SMALL = params_from_reference(REF.describe())
WINDOW = 16384                      # 4 * seg_max: a carry every window


def corpus(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=n,
                                                dtype=np.uint8)


def frag(**kw) -> AnchoredCudaFragmenter:
    kw.setdefault("region_bytes", WINDOW)
    return AnchoredCudaFragmenter(SMALL, cpu_cutoff=0, lane_multiple=8,
                                  device="cpu", **kw)


def _table(chunks):
    return [(c.offset, c.length, c.digest) for c in chunks]


def test_params_from_reference_round_trip():
    assert frag().describe() == REF.describe()
    assert SMALL.chunk.strip_blocks * 64 == SMALL.seg_max
    with pytest.raises(ValueError):
        params_from_reference({"kind": "cdc"})


def test_chunk_matches_reference_fragmenter():
    data = corpus(50000, seed=40).tobytes()
    got = frag().chunk(data)
    assert _table(got) == _table(REF.chunk(data))
    assert [c.index for c in got] == list(range(len(got)))
    assert sum(c.length for c in got) == len(data)


def test_stream_any_blocking_matches_chunk():
    data = corpus(45000, seed=42).tobytes()
    want = _table(REF.chunk(data))
    rng = np.random.default_rng(0)
    for _ in range(2):
        cuts = np.sort(rng.integers(0, len(data), size=int(rng.integers(
            3, 40))))
        edges = [0, *cuts.tolist(), len(data)]
        blocks = [data[a:b] for a, b in zip(edges, edges[1:])]
        stored = {}
        batches = list(frag().chunks_stream(
            blocks, store=lambda dg, b: stored.setdefault(dg, b)))
        got = [c for b in batches for c in b]
        assert len(batches) > 1          # yielded as windows complete
        assert _table(got) == want
        assert b"".join(stored[c.digest] for c in got) == data


def test_stream_block_lands_exactly_on_window_end():
    """A block that ends exactly on a window end mid-stream must not
    finalize the walk early."""
    data = corpus(40000, seed=44).tobytes()
    blocks = [data[:WINDOW], data[WINDOW:]]
    got = frag().manifest_stream(blocks, name="f").chunks
    assert _table(got) == _table(REF.chunk(data))


def test_three_way_region_streaming_equality():
    """One-shot (one region) == small-window walk == streamed, all equal
    to the reference whole-stream oracle."""
    arr = corpus(60000, seed=43)
    data = arr.tobytes()
    want = ref_oracle(arr, REF_SMALL)
    one_shot = frag(region_bytes=1 << 30).chunk(data)
    tiny = frag().chunk(data)
    blocks = [data[i:i + 7333] for i in range(0, len(data), 7333)]
    streamed = frag().manifest_stream(blocks, name="f").chunks
    for got in (one_shot, tiny, list(streamed)):
        assert _table(got) == want


def test_manifest_json_matches_reference_except_engine_name():
    data = corpus(30000, seed=45).tobytes()
    blocks = [data[i:i + 5000] for i in range(0, len(data), 5000)]
    ref = REF.manifest_stream(iter(blocks), name="f.bin").to_json()
    got = frag().manifest_stream(iter(blocks), name="f.bin").to_json()
    assert '"fragmenter":"cdc-anchored-cuda"' in got
    assert got.replace('"fragmenter":"cdc-anchored-cuda"',
                       '"fragmenter":"cdc-anchored"') == ref


def test_port_cpu_engine_matches_reference():
    """The port's NumPy-oracle engine: chunk() and its host window walk."""
    data = corpus(50000, seed=46).tobytes()
    want = _table(REF.chunk(data))
    cpu = AnchoredCpuFragmenter(SMALL, region_bytes=WINDOW)
    assert _table(cpu.chunk(data)) == want
    blocks = [data[i:i + 3000] for i in range(0, len(data), 3000)]
    assert _table(c for b in cpu.chunks_stream(blocks) for c in b) == want


def test_lane_overflow_in_pipelined_walk(monkeypatch):
    """Window k's lane tables truncate under tight provisioning, but its
    device carry stays exact, so the windows already dispatched on it stay
    valid and only window k is redone at the full bound."""
    monkeypatch.setattr(A, "_tight_segment_lanes",
                        lambda params, m_words, lane_multiple: 8)
    A.make_chain_fn.cache_clear()
    try:
        import dfs_tpu_torch.fragmenter.cdc_anchored as F

        calls: list[str] = []
        orig = F.region_chunks

        def spy(*a, **kw):
            calls.append(kw.get("cap_mode", "tight"))
            return orig(*a, **kw)

        monkeypatch.setattr(F, "region_chunks", spy)
        data = corpus(120000, seed=5).tobytes()
        got = frag(region_bytes=65536, max_inflight=3).chunk(data)
        assert "full" in calls, "walk never hit the lane-overflow retry"
        assert _table(got) == ref_oracle(np.frombuffer(data, np.uint8),
                                         REF_SMALL)
    finally:
        A.make_chain_fn.cache_clear()


def test_small_stream_takes_oracle_path_under_cutoff():
    data = corpus(20000, seed=47).tobytes()
    f = AnchoredCudaFragmenter(SMALL, region_bytes=WINDOW, device="cpu")
    assert f.cpu_cutoff >= len(data)
    assert _table(f.chunk(data)) == _table(REF.chunk(data))
    assert f.stream_span() == WINDOW * 3


def test_staging_pool_hands_each_buffer_to_one_walk_at_a_time():
    """Concurrent uploads share one fragmenter's staging pool: under a
    short switch interval and more threads than cores, no buffer is ever
    held by two takers at once and none is lost."""
    import sys
    import threading

    f = AnchoredCudaFragmenter(device="cpu")
    held: set[int] = set()
    mu = threading.Lock()
    clashes = []

    def worker():
        for _ in range(300):
            buf = f._pool_take(64)
            with mu:
                if id(buf) in held:
                    clashes.append(id(buf))
                held.add(id(buf))
            with mu:
                held.discard(id(buf))
            f._pool_give(buf, None)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert clashes == []
    pooled = f._buf_pool[64]
    assert len(pooled) == len({id(b) for b in pooled}) <= 16
