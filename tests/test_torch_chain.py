"""The port's region chain against the JAX package: the raw chain outputs
against ``region_dispatch`` on ``__graft_entry__.entry()``'s arguments, and
chunk tables against ``dfs_tpu``'s whole-stream oracle on the cases of
tests/test_cdc_anchored.py (SMALL params, lane_multiple=8). All exact."""

import hashlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dfs_tpu.fragmenter.cdc_anchored import AnchoredCpuFragmenter as RefCpu
from dfs_tpu.ops.cdc_anchored import AnchoredCdcParams as RefParams
from dfs_tpu.ops.cdc_anchored import chunk_file_anchored_np as ref_oracle
from dfs_tpu.ops.cdc_v2 import AlignedCdcParams as RefChunk

import dfs_tpu_torch.ops.cdc_anchored as A
from dfs_tpu_torch.convert import params_from_reference

REF_SMALL = RefParams(
    chunk=RefChunk(min_blocks=2, avg_blocks=4, max_blocks=16,
                   strip_blocks=64),              # 4 KiB lanes
    seg_min=2048, seg_max=4096, seg_mask=2047)
SMALL = params_from_reference(RefCpu(REF_SMALL).describe())


def corpus(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=n,
                                                dtype=np.uint8)


def _port(data):
    return A.batch_chunks_anchored(data, SMALL, lane_multiple=8,
                                   device="cpu")


def test_raw_chain_outputs_match_jax_region_dispatch():
    """(consumed, seg_overflow, count, q, offs, lens, digests) of the
    port's chain == the JAX chain on __graft_entry__.entry()'s arguments
    (128 KiB region, 4 KiB lanes, lane_multiple=128)."""
    import jax

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import __graft_entry__

    fn, args = __graft_entry__.entry()
    ref = [np.asarray(x) for x in jax.jit(fn)(*args)]
    words = A.words_tensor(np.asarray(args[0]))
    got = [t.numpy() for t in A.region_dispatch(
        words, 128 * 1024, int(args[1]), True, SMALL, lane_multiple=128)]
    count = int(ref[2])
    assert count > 0
    assert int(got[0]) == int(ref[0]) == 128 * 1024      # consumed
    assert int(got[1]) == int(ref[1]) == 0               # seg_overflow
    assert int(got[2]) == count
    for i in (3, 4, 5):                                  # q, offs, lens
        np.testing.assert_array_equal(got[i][:count], ref[i][:count])
    np.testing.assert_array_equal(got[6][:count].view(np.uint32),
                                  ref[6][:count])


@pytest.mark.parametrize("n", [1, 63, 4096, 5000, 100001, 300000])
def test_chain_matches_reference_oracle(n):
    data = corpus(n, seed=n + 100)
    want = ref_oracle(data, REF_SMALL)
    assert A.chunk_file_anchored_np(data, SMALL) == want     # port oracle
    assert _port(data) == want


def test_chain_low_entropy():
    # all zeros: the anchor hash is constant; repeating pattern: dense
    for data in (np.zeros((100000,), dtype=np.uint8),
                 np.tile(corpus(256, seed=6), 400)):
        assert _port(data) == ref_oracle(data, REF_SMALL)


def test_chain_tail_digests():
    # segment tails end in partial blocks, including tails >= 56 mod 64
    for seed in range(3):
        data = corpus(37777 + seed * 1111, seed=seed + 20)
        got = _port(data)
        assert got == ref_oracle(data, REF_SMALL)
        for o, ln, dg in got:
            assert dg == hashlib.sha256(data[o:o + ln].tobytes()).hexdigest()


def _spy_dispatch(monkeypatch) -> list:
    calls: list[str] = []
    orig = A.region_dispatch

    def spy(*a, **kw):
        calls.append(kw.get("cap_mode", "tight"))
        return orig(*a, **kw)

    monkeypatch.setattr(A, "region_dispatch", spy)
    return calls


def test_tight_cut_capacity_overflow_redispatches(monkeypatch):
    """Content cutting at min_blocks everywhere overflows the tight cut
    capacity; the exact count must trip the full-bound redo."""
    from dfs_tpu.ops.cdc_v2 import candidates_np

    dense = next(v for v in range(256)
                 if candidates_np(np.full(64, v, np.uint8),
                                  REF_SMALL.chunk).any())
    data = np.full(100000, dense, dtype=np.uint8)
    calls = _spy_dispatch(monkeypatch)
    got = _port(data)
    assert "full" in calls, "dense content never hit the retry path"
    assert got == ref_oracle(data, REF_SMALL)


def test_tight_segment_lane_overflow_redispatches(monkeypatch):
    """Lanes provisioned far below the real segment count: the exact
    on-device segment count must trip the full-bound redo."""
    monkeypatch.setattr(A, "_tight_segment_lanes",
                        lambda params, m_words, lane_multiple: 8)
    A.make_chain_fn.cache_clear()
    try:
        data = corpus(100000, seed=3)
        calls = _spy_dispatch(monkeypatch)
        got = _port(data)
        assert "full" in calls, "lane overflow never hit the retry path"
        assert got == ref_oracle(data, REF_SMALL)
    finally:
        A.make_chain_fn.cache_clear()


def test_anchor_tiles_match_kept_anchors():
    """The plain anchor pass keeps exactly the oracle's first two anchors
    per tile (region-local, with lookback)."""
    from dfs_tpu.ops.cdc_anchored import kept_anchors_np

    data = corpus(200000, seed=2)
    buf = A.region_buffer(data, np.zeros((8,), np.uint8), SMALL)
    m_words = A.recover_m_words(buf.shape[0], SMALL)
    tiles = A.anchor_tiles(A.words_tensor(buf), SMALL, m_words).numpy()
    got = np.sort(tiles[tiles < 2**30].astype(np.int64))
    np.testing.assert_array_equal(got, kept_anchors_np(data, REF_SMALL))


def test_region_entry_points_need_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        A.batch_chunks_anchored(corpus(10), SMALL)
