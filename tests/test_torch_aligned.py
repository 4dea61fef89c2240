"""The port's aligned CDC v2 path against dfs_tpu's on the CPU: the host
oracles (``chunk_spans_np``, ``chunk_file_np``, ``host_to_strips``), the
segment pipeline (kernels 3 and 1 through their plain versions, then the
plain compaction) against dfs_tpu's ``make_segment_fn`` (its XLA branch)
and ``segment_chunks``, and both fragmenters against dfs_tpu's of the same
name, fileIds included. Every comparison is exact."""

import hashlib

import numpy as np
import pytest
import torch

from dfs_tpu import config as ref_config
from dfs_tpu.fragmenter import base as ref_base
from dfs_tpu.fragmenter.cdc_aligned import (
    AlignedCpuFragmenter as RefCpu, AlignedTpuFragmenter as RefTpu)
from dfs_tpu.ops import cdc_pipeline as ref_pipe
from dfs_tpu.ops import cdc_v2 as ref_v2

from dfs_tpu_torch.config import CDCParams
from dfs_tpu_torch.fragmenter.base import get_fragmenter
from dfs_tpu_torch.fragmenter.cdc_aligned import (AlignedCpuFragmenter,
                                                  AlignedCudaFragmenter)
from dfs_tpu_torch.ops import cdc_pipeline as P
from dfs_tpu_torch.ops import cdc_v2 as V
from dfs_tpu_torch.ops.sha256 import u32_tensor

SMALL = V.AlignedCdcParams(min_blocks=2, avg_blocks=4, max_blocks=16,
                           strip_blocks=32)          # 2 KiB strips
REF_SMALL = ref_v2.AlignedCdcParams(min_blocks=2, avg_blocks=4,
                                    max_blocks=16, strip_blocks=32)
LANES = 8


def corpus(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=n,
                                                dtype=np.uint8)


def _table(chunks):
    return [(c.offset, c.length, c.digest) for c in chunks]


@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 2048, 2049, 5000, 16384])
def test_oracles_equal_dfs_tpu(n):
    data = corpus(n, seed=n)
    assert V.chunk_spans_np(data, SMALL) == ref_v2.chunk_spans_np(
        data, REF_SMALL)
    assert V.chunk_file_np(data, SMALL) == ref_v2.chunk_file_np(
        data, REF_SMALL)
    got, want = (V.host_to_strips(data, SMALL, LANES),
                 ref_v2.host_to_strips(data, REF_SMALL, LANES))
    assert np.array_equal(got[0], want[0]) and got[1:] == want[1:]
    assert SMALL.strip_len == REF_SMALL.strip_len == 2048


@pytest.mark.parametrize("n", [1, 63, 64, 65, 2048, 2049, 9000, 16384])
def test_segment_chunks_equal_dfs_tpu(n):
    """Whole strips, a partial final block (re-hashed on the host), a
    partial strip, and strip counts that round up to the next power of
    two."""
    data = corpus(n, seed=100 + n)
    got = P.segment_chunks(data, SMALL, lane_multiple=LANES, device="cpu")
    assert got == V.chunk_file_np(data, SMALL)
    assert got == ref_pipe.segment_chunks(data, REF_SMALL,
                                          lane_multiple=LANES)
    for o, ln, dg in got:
        assert dg == hashlib.sha256(data[o:o + ln].tobytes()).hexdigest()


def test_segment_fn_raw_outputs_equal_dfs_tpu():
    """count, stream-order positions and digests of one segment straight
    from the two pipelines, before any host formatting; the strip count
    padded to the lane multiple; an all-zero strip (forced cuts only)."""
    s_real, s_pad = 4, LANES
    raw = corpus(s_real * SMALL.strip_len, seed=3)
    raw[SMALL.strip_len:2 * SMALL.strip_len] = 0
    real_blocks = np.zeros((s_pad,), np.int32)
    real_blocks[:s_real] = SMALL.strip_blocks
    real_blocks[s_real - 1] = SMALL.strip_blocks - 5     # a short last strip
    run = P.make_segment_fn(SMALL, s_real, s_pad)
    count, q, dig = run(u32_tensor(raw.view("<u4"), "cpu"),
                        torch.from_numpy(real_blocks))
    rcount, rq, rdig = ref_pipe.make_segment_fn(REF_SMALL, s_real, s_pad)(
        raw.view("<u4"), real_blocks)
    c = int(count)
    assert c == int(rcount) and c == int(np.asarray(rq >= 0).sum())
    assert np.array_equal(q.numpy()[:c], np.asarray(rq)[:c])
    assert np.array_equal(q.numpy()[c:], np.full(q.shape[0] - c, -1))
    assert np.array_equal(dig.view(torch.int32).numpy().view(np.uint32)[:c],
                          np.asarray(rdig)[:c])
    assert run.shape["c_max"] == V.cut_capacity(s_pad, SMALL)
    assert int(q[c - 1]) == s_real * SMALL.strip_blocks - 6


def _cuda(**kw) -> AlignedCudaFragmenter:
    return AlignedCudaFragmenter(SMALL, cpu_cutoff=0, lane_multiple=LANES,
                                 device="cpu", **kw)


def test_fragmenters_equal_dfs_tpu():
    """chunk(), manifest() and manifest_stream() of both engines against
    dfs_tpu's same-named engines; several segments (seg_strips 2), the
    payloads stored reassemble the stream; fileId from the digest
    chain."""
    data = corpus(5 * SMALL.strip_len + 321, seed=8).tobytes()
    blocks = [data[i:i + 3000] for i in range(0, len(data), 3000)]
    ref_tpu = RefTpu(REF_SMALL, seg_strips=2, cpu_cutoff=0,
                     lane_multiple=LANES)
    want = _table(ref_tpu.chunk(data))
    assert _table(RefCpu(REF_SMALL).chunk(data)) == want
    for port, ref in ((AlignedCpuFragmenter(SMALL), RefCpu(REF_SMALL)),
                      (_cuda(seg_strips=2), ref_tpu)):
        assert _table(port.chunk(data)) == want
        m, r = port.manifest(data, "f"), ref.manifest(data, "f")
        assert (m.file_id, m.size, _table(m.chunks)) == \
            (r.file_id, r.size, want)
        assert m.file_id == V.file_id_from_digests([c[2] for c in want])
        stored = {}
        ms = port.manifest_stream(iter(blocks), "f",
                                  store=stored.__setitem__)
        rs = ref.manifest_stream(iter(blocks), "f")
        assert (ms.file_id, ms.size, _table(ms.chunks)) == \
            (rs.file_id, rs.size, want)
        assert b"".join(stored[c.digest] for c in ms.chunks) == data
        assert m.fragmenter == port.name
    assert _cuda().chunk(b"") == [] and _cuda().manifest(b"x", "t").size == 1


def test_factory_names_and_byte_params():
    """cdc-aligned and cdc-aligned-tpu/-cuda from node byte sizes, the
    strip grown to hold one max-size chunk, as dfs_tpu maps them; neither
    engine is resume-describable."""
    for size_kw in (dict(min_size=1024, avg_size=4096, max_size=32768),
                    dict(min_size=2048, avg_size=8192,
                         max_size=256 * 1024)):
        for kind, cls in (("cdc-aligned", AlignedCpuFragmenter),
                          ("cdc-aligned-tpu", AlignedCudaFragmenter),
                          ("cdc-aligned-cuda", AlignedCudaFragmenter)):
            f = get_fragmenter(kind, cdc_params=CDCParams(**size_kw),
                               device="cpu")
            r = ref_base.get_fragmenter(
                kind.replace("-cuda", "-tpu"),
                cdc_params=ref_config.CDCParams(**size_kw))
            assert isinstance(f, cls)
            assert f.params == V.AlignedCdcParams(**{
                k: getattr(r.params, k) for k in
                ("min_blocks", "avg_blocks", "max_blocks", "strip_blocks",
                 "seed")})
            with pytest.raises(NotImplementedError):
                f.describe()


def test_device_engine_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        AlignedCudaFragmenter()
    with pytest.raises(RuntimeError, match="CUDA"):
        get_fragmenter("cdc-aligned-tpu")
