"""Every chunk sizing dfs_tpu takes, at the port's small scale: kernels 1
and 5 plan lanes of up to 2^19 blocks (restic's and Borg's 8 MiB chunks,
the 32 MiB lanes of dfs_tpu's default region) and raise one step past
their limits; the anchored oracle the card is held to equals dfs_tpu's at
restic's sizing; the cut-to-cut selection equals dfs_tpu's at long lanes;
kernel 7's plain version writes the 64-bit bit length hashlib does; and
``digest_many`` cuts a flush into kernel 7 calls, in order. The kernels
themselves run on the card (tests/test_torch_cuda.py, chip_smoke.py's
``large_chunks`` phase)."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfs_tpu.config import CDCParams as RefCDCParams
from dfs_tpu.fragmenter.base import _anchored_params as ref_anchored_params
from dfs_tpu.ops.cdc_anchored import chunk_file_anchored_np as ref_oracle
from dfs_tpu.ops.cdc_v2 import AlignedCdcParams as RefChunk
from dfs_tpu.ops.cdc_v2 import select_cuts_device as ref_select_cuts

from dfs_tpu_torch.config import CDCParams
from dfs_tpu_torch.fragmenter import cdc_cuda
from dfs_tpu_torch.fragmenter.base import _anchored_params
from dfs_tpu_torch.fragmenter.cdc_cuda import CudaCdcFragmenter
from dfs_tpu_torch.ops import sha256 as S
from dfs_tpu_torch.ops.cdc_anchored import chunk_file_anchored_np
from dfs_tpu_torch.ops.cdc_v2 import select_cuts
from dfs_tpu_torch.ops.pack import length_words
from dfs_tpu_torch.ops.sha256_strip import (MAX_SHARED, check_geometry,
                                            list_capacity, plan_strip,
                                            wide_select_lanes)

KIB, MIB = 1024, 1024 * 1024

# (min, avg, max) chunk bytes -> the lane's blocks, and kernel 1's and
# kernel 5's layouts (wide, selection lanes)
SIZINGS = {
    "default": ((2 * KIB, 8 * KIB, 64 * KIB), 2048, (False, 8), False),
    "2m": ((256 * KIB, 512 * KIB, 2 * MIB), 32768, (False, 8), True),
    "restic": ((512 * KIB, MIB, 8 * MIB), 131072, (True, 7), True),
    "borg": ((512 * KIB, 2 * MIB, 8 * MIB), 131072, (True, 7), True),
    "32m": ((4 * MIB, 8 * MIB, 32 * MIB), 2**19, (True, 1), True),
}


@pytest.mark.parametrize("name", sorted(SIZINGS))
def test_kernels_plan_every_sizing_dfs_tpu_takes(name):
    """The port derives dfs_tpu's anchored parameters from a node's sizes,
    and kernels 1 and 5 take the lane they give: the default geometry in
    the narrow layout, the rest where it does not fit in the wide one."""
    sizes, bps, (k1_wide, k1_lanes), k5_wide = SIZINGS[name]
    p = _anchored_params(CDCParams(*sizes))
    ref = ref_anchored_params(RefCDCParams(*sizes))
    assert (p.seg_min, p.seg_max, p.seg_mask, p.seed) == \
        (ref.seg_min, ref.seg_max, ref.seg_mask, ref.seed)
    c = p.chunk
    assert (c.min_blocks, c.avg_blocks, c.max_blocks, c.strip_blocks,
            c.seed) == (ref.chunk.min_blocks, ref.chunk.avg_blocks,
                        ref.chunk.max_blocks, ref.chunk.strip_blocks,
                        ref.chunk.seed)
    assert c.strip_blocks == bps and p.seg_max == bps * 64
    cap = list_capacity(bps, c.min_blocks, c.max_blocks)
    k1 = plan_strip("k1", bps, cap, select=True)
    k5 = plan_strip("k5", bps, bps)
    assert (k1.wide, k1.select_lanes, k1.cap) == (k1_wide, k1_lanes, cap)
    assert k5.wide == k5_wide and k5.cap == bps
    # the wide layout's lists: three words an entry, per lane
    assert k5.scratch_words(128) == (3 * 128 * bps if k5_wide else 0)


def test_geometry_raises_one_step_past_its_limits():
    """A 64 MiB lane (the next strip after 32 MiB) is past kernel 1's
    selection CTA; kernel 5 takes it, and raises past its 20-bit block
    fields."""
    bps = 2**20
    assert wide_select_lanes(2**19) == 1 and wide_select_lanes(bps) == 0
    with pytest.raises(ValueError, match="shared memory"):
        plan_strip("k1", bps, list_capacity(bps, 65536, bps), select=True)
    assert plan_strip("k5", bps, bps).wide
    with pytest.raises(ValueError, match="block fields"):
        check_geometry("k5", 2 * bps, 2 * bps)
    # kernel 1's largest lane: one selection lane's two bitmaps fill the
    # CTA's shared memory
    top = (MAX_SHARED - 1152) // 8 * 32
    check_geometry("k1", top, 2, select=True)
    with pytest.raises(ValueError, match="shared memory"):
        check_geometry("k1", top + 32, 2, select=True)
    with pytest.raises(ValueError, match="selection lanes"):
        plan_strip("k1", 2**19, 17, select=True, layout="wide",
                   select_lanes=2)


def test_anchored_oracle_equals_dfs_tpu_at_restic_sizing():
    """The oracle chip_smoke.py holds the card to: the port's copy of
    ``chunk_file_anchored_np`` equals dfs_tpu's on a seeded 24 MiB body at
    restic's sizing (8 MiB lanes, 6 MiB seg_min), byte for byte."""
    sizes = SIZINGS["restic"][0]
    data = np.random.default_rng(20261020).integers(0, 256, size=24 * MIB,
                                                    dtype=np.uint8)
    got = chunk_file_anchored_np(data, _anchored_params(CDCParams(*sizes)))
    want = ref_oracle(data, ref_anchored_params(RefCDCParams(*sizes)))
    assert got == want
    assert len(got) > 10 and sum(ln for _, ln, _ in got) == data.shape[0]
    assert max(ln for _, ln, _ in got) <= 8 * MIB


@pytest.mark.parametrize("bps,min_b,avg_b,max_b", [(4096, 512, 1024, 2048),
                                                   (4096, 1, 64, 4096),
                                                   (3000, 64, 256, 1000)])
def test_select_cuts_matches_dfs_tpu_on_long_lanes(bps, min_b, avg_b, max_b):
    """The cut-to-cut selection against dfs_tpu's block-by-block scan on
    long lanes: dense and sparse candidates, a lane with none, real
    blocks 0, 1, bps - 1, bps and past bps (the lane runs on uncut)."""
    params = RefChunk(min_blocks=min_b, avg_blocks=avg_b, max_blocks=max_b,
                      strip_blocks=bps)
    rng = np.random.default_rng(bps + min_b)
    s = 9
    cand = rng.random((bps, s)) < np.array(
        [0.5, 0.01, 0.001, 0.0, 0.2, 0.05, 0.3, 0.002, 0.1])[None, :]
    rb = np.array([bps, bps - 1, 1, bps, 0, bps + 7, 17, bps // 3, bps],
                  np.int32)
    got = select_cuts(torch.from_numpy(cand), torch.from_numpy(rb), min_b,
                      max_b)
    want = ref_select_cuts(jnp.asarray(cand), jnp.asarray(rb), params)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("ln", [0, 1, 55, 56, 2**29 - 1, 2**29, 2**31 - 1,
                                2**32 + 5])
def test_length_words_are_the_fips_bit_length(ln):
    """Words 14 and 15 of a message's last block: the big-endian 64-bit
    bit length that FIPS 180-4 and hashlib append (a span of 2^29 bytes or
    more has a high word), from an int and from an int64 tensor."""
    want = np.frombuffer((8 * ln).to_bytes(8, "big"), ">u4").tolist()
    assert list(length_words(ln)) == want
    hi, lo = length_words(torch.tensor([ln], dtype=torch.int64))
    assert [int(hi), int(lo)] == want


def test_plain_span_digests_match_hashlib():
    """Kernel 7's plain version (``pack_gathered`` + the plain SHA-256)
    against hashlib on spans at every padding boundary and offset."""
    data = np.random.default_rng(4).integers(0, 256, size=9000,
                                             dtype=np.uint8)
    lens = [0, 1, 3, 55, 56, 57, 63, 64, 65, 119, 120, 127, 128, 1000, 4095]
    starts = [(i * 577) % (9000 - 4100) + i % 16 for i in range(len(lens))]
    got = S.state_to_hex(S.sha256_spans(torch.from_numpy(data), starts,
                                        lens))
    assert got == [hashlib.sha256(data[s:s + n].tobytes()).hexdigest()
                   for s, n in zip(starts, lens)]


@pytest.mark.parametrize("split", [1, 1000, 2500, 2**31 - 1])
def test_digest_many_splits_a_flush_in_order(monkeypatch, split):
    """A flush cut into kernel 7 calls of at most ``split_bytes`` (a longer
    payload alone), each call one joined buffer: the digests are
    hashlib's, in order, and the calls are exactly the greedy parts."""
    rng = np.random.default_rng(split % 1000)
    sizes = [0, 900, 300, 1700, 0, 2100, 1, 999, 1001, 64, 1024, 500]
    payloads = [rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
                for n in sizes]
    calls = []
    real = cdc_cuda.sha256_spans

    def spy(data, starts, lens):
        calls.append(int(np.asarray(lens).sum()))
        assert data.shape[0] == calls[-1]
        return real(data, starts, lens)

    monkeypatch.setattr(cdc_cuda, "sha256_spans", spy)
    frag = CudaCdcFragmenter(device="cpu", split_bytes=split)
    assert frag.digest_many(payloads) == \
        [hashlib.sha256(p).hexdigest() for p in payloads]
    parts, cur = [], None
    for n in sizes:
        if cur is not None and cur + n <= split:
            cur += n
        else:
            if cur is not None:
                parts.append(cur)
            cur = n
    parts.append(cur)
    assert calls == parts
    assert frag.digest_many([]) == []
    with pytest.raises(ValueError):
        CudaCdcFragmenter(device="cpu", split_bytes=2**31)


def test_streamed_manifest_is_the_same_with_split_flushes():
    """``manifest_stream`` (the path that flushes ``hash_batch`` payloads
    to ``digest_many``) gives the same manifest when every flush is cut
    into many kernel 7 calls."""
    sizes = dict(min_size=64, avg_size=256, max_size=1024)
    data = np.random.default_rng(9).integers(0, 256, size=40_000,
                                             dtype=np.uint8).tobytes()
    blocks = [data[i:i + 8192] for i in range(0, len(data), 8192)]

    def manifest(split):
        frag = CudaCdcFragmenter(CDCParams(**sizes), tile_size=16384,
                                 hash_batch=32, device="cpu",
                                 split_bytes=split)
        return frag.manifest_stream(iter(blocks), name="x")

    a, b = manifest(2**31 - 1), manifest(2000)
    assert a.chunks == b.chunks and a.file_id == b.file_id
    assert a.file_id == hashlib.sha256(data).hexdigest()
