"""The live-row contract of kernels 1 and 5 (``ops.sha256_strip``): the
kernels store the chain states of a lane's live rows (t <= its last
flagged block) and 0 on the others. These CPU tests pin which rows are
live on hand-made lanes, and show that no consumer reads a dead row: the
chain's compaction gives the same outputs from states whose dead rows are
zeroed. The kernels themselves are held to it on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

from dfs_tpu_torch.ops import cdc_anchored as A
from dfs_tpu_torch.ops import sha256
from dfs_tpu_torch.ops.cdc_v2 import AlignedCdcParams, select_cuts
from dfs_tpu_torch.ops.layout import bswap_transpose
from dfs_tpu_torch.ops.repack import repack_lanes
from dfs_tpu_torch.ops.select import select_walk
from dfs_tpu_torch.ops.sha256_strip import (MAX_SHARED, chain_shared_bytes,
                                            check_geometry, list_capacity,
                                            live_state_rows, narrow_fits,
                                            plan_strip, select_shared_bytes,
                                            strip_chunk_states,
                                            zero_dead_states)

BPS = 16

# (candidate blocks, real_blocks, min_blocks, max_blocks) -> the cuts the
# greedy selection makes, and the live rows: a prefix of that length
LANES = {
    "padding_lane": ([3, 7], 0, 2, 16, [], 0),
    "dead_tail_after_rb": ([], 10, 2, 16, [9], 10),
    "cut_at_last_row": ([], BPS, 2, BPS, [BPS - 1], BPS),
    "min_blocks_1": (list(range(BPS)), BPS, 1, BPS, list(range(BPS)), BPS),
    "max_blocks_run": ([], 12, 2, 4, [3, 7, 11], 12),
    "min_gate_then_tail": ([0, 1, 5, 6], 13, 2, 16, [1, 5, 12], 13),
}


def _column(cuts):
    col = torch.zeros((BPS, 1), dtype=torch.int32)
    col[cuts, 0] = 1
    return col


@pytest.mark.parametrize("case", sorted(LANES))
def test_live_rows_of_a_selected_lane(case):
    cand_pos, rb, min_b, max_b, cuts, n_live = LANES[case]
    cand = torch.zeros((BPS, 1), dtype=torch.bool)
    cand[cand_pos, 0] = True
    cutflag, _ = select_cuts(cand, torch.tensor([rb], dtype=torch.int32),
                             min_b, max_b)
    assert torch.equal(cutflag.to(torch.int32), _column(cuts))
    live = live_state_rows(cutflag)
    assert live[:, 0].tolist() == [t < n_live for t in range(BPS)]


def test_live_rows_of_given_flags_end_at_the_last_flag():
    """Kernel 5 takes any flags: live rows end at the last one, whatever
    comes before it."""
    cf = torch.zeros((BPS, 4), dtype=torch.int32)
    cf[[2, 4], 0] = 1          # dead rows 5..15
    cf[BPS - 1, 1] = 7         # any nonzero value flags
    cf[0, 3] = 1               # one live row; lane 2 has none
    want = torch.zeros((BPS, 4), dtype=torch.bool)
    want[:5, 0] = want[:, 1] = want[:1, 3] = True
    assert torch.equal(live_state_rows(cf), want)


def test_zero_dead_states_zeroes_exactly_the_dead_rows():
    rng = np.random.default_rng(3)
    cuts = [LANES[k][4] for k in sorted(LANES)]
    cf = torch.cat([_column(c) for c in cuts], dim=1)
    s = cf.shape[1]
    raw = rng.integers(1, 2**32, size=(BPS * 8, s), dtype=np.uint32)
    states = torch.from_numpy(raw.view(np.int32)).view(torch.uint32)
    out = zero_dead_states(states, cf)
    assert out.dtype == torch.uint32 and out.shape == states.shape
    got = out.view(torch.int32).numpy().view(np.uint32).reshape(BPS, 8, s)
    live = live_state_rows(cf).numpy()
    ref = raw.reshape(BPS, 8, s)
    for t in range(BPS):
        for j in range(s):
            want = ref[t, :, j] if live[t, j] else np.zeros(8, np.uint32)
            np.testing.assert_array_equal(got[t, :, j], want)


def test_shared_memory_geometry_is_checked():
    """The kernels keep bitmaps, W+K buffers and (narrow layout) chunk
    lists in shared memory: the default geometry takes the narrow layout,
    a lane or list past it the wide one, and the wrappers raise on a
    geometry that fits neither."""
    assert list_capacity(2048, 32, 1024) == 65
    assert list_capacity(2048, 1, 1024) == 2049
    assert list_capacity(64, 4, 2) == 33          # max_b < min_b
    assert select_shared_bytes(2048) == 2 * 8 * 64 * 4
    fixed = 16384 + 2048 + 256       # W+K and state buffers, slot lists
    assert chain_shared_bytes(5, 65, 2048) == \
        fixed + 5 * (12 + 64 * 4) + 325 * 4 + 2 * 652
    assert chain_shared_bytes(1, 2048, 2048) == \
        fixed + 12 + 256 + 2048 * 8
    assert chain_shared_bytes(1, 2048, 2048, wide=True) == \
        fixed + 12 + 256 + 2 * 32 * 4
    check_geometry("k1", 2048, list_capacity(2048, 32, 1024), select=True)
    check_geometry("k5", 2048, 2048)
    check_geometry("k5", 24000, 24000)
    assert narrow_fits(2048, 65, select=True) and narrow_fits(24000, 24000)
    # past the narrow layout: its shared memory, its 16-bit ranks
    assert chain_shared_bytes(1, 40000, 40000) > MAX_SHARED
    assert not narrow_fits(40000, 40000)
    assert not narrow_fits(65536, list_capacity(65536, 2, 1024), True)
    assert plan_strip("k5", 40000, 40000).wide
    assert plan_strip("k1", 65536, list_capacity(65536, 2, 1024),
                      select=True).wide
    with pytest.raises(ValueError, match="narrow"):
        plan_strip("k5", 40000, 40000, layout="narrow")
    # past the wide layout: its 20-bit block field (kernel 5), one lane's
    # two selection bitmaps (kernel 1)
    check_geometry("k5", 2**20, 2**20)
    with pytest.raises(ValueError, match="block fields"):
        check_geometry("k5", 2**20 + 1, 2**20 + 1)
    with pytest.raises(ValueError, match="shared memory"):
        check_geometry("k1", 2**20, 17, select=True)


# the __graft_entry__.entry() geometry: 128 KiB region, 4 KiB lanes,
# lane_multiple 128
GRAFT = A.AnchoredCdcParams(
    chunk=AlignedCdcParams(min_blocks=2, avg_blocks=4, max_blocks=16,
                           strip_blocks=64),
    seg_min=2048, seg_max=4096, seg_mask=2047)


@pytest.mark.parametrize("cap_mode", ["tight", "full"])
def test_compaction_reads_no_dead_row(cap_mode):
    """scan_half's plain states, with every dead row zeroed as the kernels
    store them, give compact_half exactly the outputs of the unzeroed
    states — padding lanes and dead lane tails included."""
    n = 128 * 1024
    data = np.random.default_rng(0).integers(0, 256, size=n, dtype=np.uint8)
    words = A.words_tensor(A.region_buffer(data, np.zeros((8,), np.uint8),
                                           GRAFT))
    chain = A.make_chain_fn(GRAFT, words.shape[0], 128, cap_mode)
    sh = chain.shape
    cp = GRAFT.chunk
    s_pad = sh["s_pad"]
    tiles = A.anchor_tiles(words, GRAFT, sh["m_words"])
    scal = torch.tensor([0, n, 1], dtype=torch.int32)
    bounds = select_walk(tiles, scal, sh["cap"], GRAFT.seg_min,
                         GRAFT.seg_max)
    (starts, seg_lens, w_off, sh8, rb, tail_len, _,
     nseg) = A.descriptors(bounds, scal[0], s_pad)
    assert 0 < int(nseg) < s_pad                     # padding lanes

    cf32, since, rows = A.scan_half(words, w_off, sh8, rb, cp, s_pad)
    words_t = bswap_transpose(repack_lanes(words, w_off, sh8,
                                           cp.strip_blocks * 16))
    cf, _, states = strip_chunk_states(words_t, rb, cp.seed, cp.mask,
                                       cp.min_blocks, cp.max_blocks)
    assert torch.equal(cf, cf32)
    zeroed = zero_dead_states(states, cf)
    assert not torch.equal(zeroed.view(torch.int32), states.view(torch.int32))
    assert torch.equal(sha256.cut_state_rows(states, s_pad).view(torch.int32),
                       rows.view(torch.int32))

    kw = dict(bps=cp.strip_blocks, s_pad=s_pad, c_max=sh["c_max"],
              t_tile=sh["t_tile"], k_max=sh["k_max"])
    want = A.compact_half(cf32, since, rows, words, w_off, sh8, rb, tail_len,
                          starts, seg_lens, **kw)
    got = A.compact_half(cf32, since, sha256.cut_state_rows(zeroed, s_pad),
                         words, w_off, sh8, rb, tail_len, starts, seg_lens,
                         **kw)
    assert int(want[0]) > 0
    for a, b in zip(got, want):
        if a.dtype == torch.uint32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)
