"""The port's v1 ``cdc-cuda`` path against dfs_tpu's ``cdc-tpu`` on the
CPU: kernel 6's plain version (batched SHA-256) against hashlib and
``_sha256_blocks_impl``, ``pad_messages``, the Gear bitmap of
``ops/gear.py`` against ``ops/gear_jax.py`` and the sequential hash,
``digest_gathered`` against ``ops/pack_jax.py``, kernel 7's plain version
(``sha256_spans_plain``: spans of a resident array) against dfs_tpu's
``digest_gathered`` + ``sha256_blocks`` and hashlib, and the fragmenter
against ``TpuCdcFragmenter``. Every comparison is exact."""

import hashlib
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfs_tpu import config as ref_config
from dfs_tpu.fragmenter.cdc_cpu import gear_hashes_seq
from dfs_tpu.fragmenter.cdc_tpu import TpuCdcFragmenter
from dfs_tpu.ops import gear_jax as ref_gear
from dfs_tpu.ops import pack_jax as ref_pack
from dfs_tpu.ops import sha256_jax as ref_sha

from dfs_tpu_torch import resolve_device
from dfs_tpu_torch.config import CDCParams
from dfs_tpu_torch.fragmenter.base import get_fragmenter
from dfs_tpu_torch.fragmenter.cdc_cpu import CpuCdcFragmenter
from dfs_tpu_torch.fragmenter.cdc_cuda import CudaCdcFragmenter
from dfs_tpu_torch.ops import gear, pack
from dfs_tpu_torch.ops import sha256 as S
from dfs_tpu_torch.utils.hashing import gear_table

SIZES = dict(min_size=64, avg_size=256, max_size=1024)
TILE = 1 << 14          # 16 KiB tiles: several per body, one jit shape


def _u32(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.uint32)
                            .view(np.int32)).view(torch.uint32)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy().view(np.uint32)


def _table(chunks):
    return [(c.offset, c.length, c.digest) for c in chunks]


BOUNDARY = [0, 1, 55, 56, 63, 64, 119, 120, 128, 1000]


def test_batched_sha256_boundaries_against_hashlib(rng):
    """The SHA-256 length boundaries (one and two padding blocks) and
    multi-block messages; rows and blocks rounded to powers of two."""
    msgs = [rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
            for n in BOUNDARY]
    assert S.sha256_batch_hex(msgs, device="cpu") == \
        [hashlib.sha256(m).hexdigest() for m in msgs]
    assert S.sha256_batch_hex([], device="cpu") == []


def test_pad_messages_and_blocks_equal_dfs_tpu(rng):
    """pad_messages' arrays, then the plain scan against dfs_tpu's
    _sha256_blocks_impl on the same words, with nblocks 0 and -1 rows (H0),
    a row past the block axis and random words."""
    msgs = [rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
            for n in (0, 55, 56, 64, 119, 120)]
    words, counts = S.pad_messages(msgs, n_blocks=4, batch=8)
    ref_words, ref_counts = ref_sha.pad_messages(msgs, n_blocks=4, batch=8)
    assert words.dtype == ref_words.dtype and words.shape == (8, 4, 16)
    assert np.array_equal(words, ref_words)
    assert np.array_equal(counts, ref_counts)
    words[6] = rng.integers(0, 2**32, size=(4, 16), dtype=np.uint64)
    words[7] = rng.integers(0, 2**32, size=(4, 16), dtype=np.uint64)
    counts = counts.copy()
    counts[6], counts[7] = -1, 9           # padding row; past the axis
    got = _np(S.sha256_blocks(_u32(words), torch.from_numpy(counts)))
    want = np.asarray(ref_sha._sha256_blocks_impl(jnp.asarray(words),
                                                  jnp.asarray(counts)))
    assert np.array_equal(got, want)
    assert np.array_equal(got[6], ref_sha._H0)
    assert S.state_to_hex(got)[:6] == \
        [hashlib.sha256(m).hexdigest() for m in msgs]
    assert S.state_to_hex(got) == ref_sha.state_to_hex(want)


def test_gear_bitmap_equals_dfs_tpu_and_the_sequential_hash(rng):
    table = gear_table(CDCParams(**SIZES).seed)
    mask = CDCParams(**SIZES).mask
    data = rng.integers(0, 256, size=4096, dtype=np.uint8)
    tab = gear.table_tensor(table, "cpu")
    zero = torch.zeros(31, dtype=torch.int64)
    dense = _np(gear.gear_hashes_dense(torch.from_numpy(data), zero, tab))
    assert np.array_equal(dense, gear_hashes_seq(data.tobytes(), table))
    ref_dense = ref_gear.gear_hashes_dense(
        jnp.asarray(data), jnp.zeros(31, jnp.uint32), jnp.asarray(table))
    assert np.array_equal(dense, np.asarray(ref_dense))
    # a tile with a nonzero halo, and the halo it hands on
    prev = table[data[1000:1031]].astype(np.uint32)
    bm, tail = gear.gear_bitmap_tile(torch.from_numpy(data[1031:2055]),
                                     _u32(prev), tab, mask)
    rbm, rtail = ref_gear.gear_bitmap_tile(
        jnp.asarray(data[1031:2055]), jnp.asarray(prev), jnp.asarray(table),
        jnp.uint32(mask))
    assert np.array_equal(bm.numpy(), np.asarray(rbm))
    assert np.array_equal(_np(tail), np.asarray(rtail))


def test_digest_gathered_equals_dfs_tpu(rng):
    """Rows gathered from a resident array: the length boundaries of one
    and two padding blocks, a chunk ending at the array's end and -1
    padding rows (whose output dfs_tpu drops), at one row length."""
    data = rng.integers(0, 256, size=3000, dtype=np.uint8)
    spans = [(0, 0), (7, 55), (100, 56), (200, 63), (300, 64), (400, 119),
             (600, 120), (3000 - 200, 200)]
    starts = np.array([s for s, _ in spans] + [0, 0], np.int32)
    lens = np.array([ln for _, ln in spans] + [-1, -1], np.int32)
    l64 = 256
    got = _np(pack.digest_gathered(torch.from_numpy(data),
                                   torch.from_numpy(starts),
                                   torch.from_numpy(lens), l64))
    want = np.asarray(ref_pack.digest_gathered(
        jnp.asarray(data), jnp.asarray(starts), jnp.asarray(lens), l64=l64))
    assert np.array_equal(got, want)
    assert S.state_to_hex(got[:len(spans)]) == [
        hashlib.sha256(data[s:s + ln].tobytes()).hexdigest()
        for s, ln in spans]


SPAN_LENS = [0, 1, 55, 56, 63, 64, 119, 120]


def _ref_spans(data: np.ndarray, starts, lens) -> np.ndarray:
    """dfs_tpu's digest_gathered (its packing and sha256_blocks) at the
    padded row length of the longest span."""
    l64 = (max(lens) + 8) // 64 * 64 + 64
    return np.asarray(ref_pack.digest_gathered(
        jnp.asarray(data), jnp.asarray(np.asarray(starts, np.int32)),
        jnp.asarray(np.asarray(lens, np.int32)), l64=l64))


def _hashlib_states(data: np.ndarray, starts, lens) -> list[str]:
    return [hashlib.sha256(data[s:s + ln].tobytes()).hexdigest()
            for s, ln in zip(starts, lens)]


def test_sha256_spans_plain_every_offset_equals_dfs_tpu(rng):
    """Kernel 7's plain version at every start offset mod 16 and the
    length boundaries of one and two padding blocks, a span ending at the
    array's last byte, N = 1 and N = 0; input order kept whatever the
    lengths' order."""
    data = rng.integers(0, 256, size=16 * 1024 + 13, dtype=np.uint8)
    starts = [1024 * off + 128 * k + off for off in range(16)
              for k in range(len(SPAN_LENS))]
    lens = SPAN_LENS * 16
    starts.append(data.shape[0] - 77)       # ends at the last byte
    lens.append(77)
    got = _np(S.sha256_spans(torch.from_numpy(data), starts, lens))
    assert np.array_equal(got, _ref_spans(data, starts, lens))
    assert S.state_to_hex(got) == _hashlib_states(data, starts, lens)
    assert sorted({s % 16 for s in starts[:-1]}) == list(range(16))
    one = _np(S.sha256_spans_plain(torch.from_numpy(data), [5], [120]))
    assert S.state_to_hex(one) == _hashlib_states(data, [5], [120])
    none = S.sha256_spans_plain(torch.from_numpy(data), [], [])
    assert none.shape == (0, 8) and none.dtype == torch.uint32


def test_sha256_spans_plain_1025_blocks_equals_dfs_tpu(rng):
    """The longest chunk of the default parameters: 64 KiB of data, 1,025
    blocks once padded, at an odd offset, beside a short span."""
    data = rng.integers(0, 256, size=65_600 + 64, dtype=np.uint8)
    starts, lens = [13, 7], [1025 * 64 - 9, 3]
    assert (lens[0] + 8) // 64 + 1 == 1025
    got = _np(S.sha256_spans_plain(torch.from_numpy(data), starts, lens))
    assert np.array_equal(got, _ref_spans(data, starts, lens))
    assert S.state_to_hex(got) == _hashlib_states(data, starts, lens)


def test_span_table_orders_longest_first_and_rejects_bad_spans():
    table = S.span_table([0, 10, 20, 30, 40], [3, 9, 0, 9, 120], 200)
    assert table.dtype == np.int32 and table.shape == (3, 5)
    assert table[0].tolist() == [0, 10, 20, 30, 40]
    assert table[1].tolist() == [3, 9, 0, 9, 120]
    assert table[2].tolist() == [4, 1, 3, 0, 2]    # stable among equals
    data = torch.zeros(200, dtype=torch.uint8)
    for starts, lens in (([0, 5], [4, -1]), ([-1], [3]), ([190], [11])):
        with pytest.raises(ValueError):
            S.sha256_spans(data, starts, lens)
        with pytest.raises(ValueError):
            S.sha256_spans_plain(data, starts, lens)
    with pytest.raises(ValueError):
        S.span_table([0, 1], [1], 10)
    # starts and lengths are i32, and so is all the kernel takes: a span
    # may end past 2^31, and one may be 2^31 - 1 bytes long
    for starts, lens in (([2**31], [5]), ([0], [2**31]),
                         ([1, 2**31 + 7], [1, 1])):
        with pytest.raises(ValueError, match="int32"):
            S.span_table(starts, lens, 2**32 + 8)
    table = S.span_table([2**31 - 2, 0], [5, 2**31 - 1], 2**32)
    assert table.tolist() == [[2**31 - 2, 0], [5, 2**31 - 1], [1, 0]]


def _port() -> CudaCdcFragmenter:
    return CudaCdcFragmenter(CDCParams(**SIZES), tile_size=TILE,
                             device="cpu")


def test_fragmenter_equals_tpu_cdc_fragmenter(rng):
    """chunk(), manifest() and the streamed manifest (whole tiles on the
    device kernel, the ragged tail on the host, kernel 6 digests) against
    dfs_tpu's TpuCdcFragmenter, fileIds included."""
    data = rng.integers(0, 256, size=3 * TILE + 777,
                        dtype=np.uint8).tobytes()
    port = _port()
    ref = TpuCdcFragmenter(ref_config.CDCParams(**SIZES), tile_size=TILE)
    want = _table(ref.chunk(data))
    assert _table(port.chunk(data)) == want
    assert _table(CpuCdcFragmenter(CDCParams(**SIZES)).chunk(data)) == want
    m, r = port.manifest(data, "f"), ref.manifest(data, "f")
    assert (m.file_id, m.size, m.fragmenter) == \
        (r.file_id, r.size, "cdc-cuda")
    blocks = [data[i:i + 5000] for i in range(0, len(data), 5000)]
    stored = {}
    ms = port.manifest_stream(iter(blocks), "f", store=stored.__setitem__)
    rs = ref.manifest_stream(iter(blocks), "f")
    assert (ms.file_id, ms.size, _table(ms.chunks)) == \
        (rs.file_id, rs.size, _table(rs.chunks))
    assert b"".join(stored[c.digest] for c in ms.chunks) == data
    assert port.chunk(b"") == [] and port.cuts(b"").shape == (0,)


def test_digest_many_buckets_match_hashlib(rng):
    """One flush of payloads of many lengths (the empty one, the padding
    boundaries, several blocks), more of them than ``hash_batch``: joined
    into one buffer and hashed in one kernel 7 call, in input order."""
    port = CudaCdcFragmenter(CDCParams(**SIZES), tile_size=TILE,
                             hash_batch=16, device="cpu")
    lens = [0, 1, 55, 56, 64, 700] + [int(n) for n in
                                      rng.integers(1, 300, size=40)]
    payloads = [rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
                for n in lens]
    assert port.digest_many(payloads) == \
        [hashlib.sha256(p).hexdigest() for p in payloads]


def test_factory_names_and_deprecation():
    for kind in ("cdc-tpu", "cdc-cuda"):
        with pytest.warns(DeprecationWarning, match="compatibility path"):
            f = get_fragmenter(kind, cdc_params=CDCParams(**SIZES),
                               device="cpu")
        assert isinstance(f, CudaCdcFragmenter) and f.name == "cdc-cuda"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with pytest.raises(NotImplementedError):
            get_fragmenter("cdc-tpu", device="cpu").describe()
    with pytest.raises(ValueError, match="power of two"):
        CudaCdcFragmenter(tile_size=3000, device="cpu")


def test_device_paths_raise_without_cuda():
    """No fallback: asked for the card (the default), the v1 engine and
    kernel 6's wrapper need CUDA."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        CudaCdcFragmenter()
    with pytest.raises(RuntimeError, match="CUDA"):
        S.sha256_batch_hex([b"x"])
    with pytest.raises(RuntimeError, match="CUDA"):
        S.sha256_spans(torch.zeros(8, dtype=torch.uint8,
                                   device=resolve_device(None)), [0], [1])
    # a tensor off the CPU never reaches the plain version
    with pytest.raises(ValueError, match="CUDA"):
        S.sha256_spans(torch.zeros(8, dtype=torch.uint8, device="meta"),
                       [0], [1])
