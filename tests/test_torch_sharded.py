"""The port's multi-device anchored path against the JAX package, on CPU
slots: kernel 5's plain version against ``strip_states_xla`` on every
lane, the sharded passes against dfs_tpu's ``shard_map`` steps on the
8-device virtual CPU mesh (raw arrays), the parity checks, and the
window-batched walk and node against dfs_tpu's host engine. All exact."""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfs_tpu.fragmenter.cdc_anchored import AnchoredCpuFragmenter as RefCpu
from dfs_tpu.ops.cdc_anchored import AnchoredCdcParams as RefParams
from dfs_tpu.ops.cdc_v2 import AlignedCdcParams as RefChunk

from dfs_tpu_torch.config import FragmenterConfig
from dfs_tpu_torch.convert import params_from_reference
from dfs_tpu_torch.fragmenter.cdc_anchored import AnchoredCudaFragmenter
from dfs_tpu_torch.fragmenter.cdc_anchored_sharded import \
    ShardedAnchoredCudaFragmenter
from dfs_tpu_torch.node import LocalNode
from dfs_tpu_torch.parallel import sharded_cdc as S
from dfs_tpu_torch.parallel.mesh import make_mesh

# the anchored_sharded_parity_check geometry: 4 KiB lanes, 2-4 KiB
# segments; windows of 4 seg_max (tests/test_sharded_ingest.py's AREGION)
REF_SMALL = RefParams(
    chunk=RefChunk(min_blocks=2, avg_blocks=4, max_blocks=16,
                   strip_blocks=64),
    seg_min=2048, seg_max=4096, seg_mask=2047)
SMALL = params_from_reference(RefCpu(REF_SMALL).describe())
AREGION = 4 * 4096


def _u32(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.uint32)
                            .view(np.int32)).view(torch.uint32)


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.uint32:
        return t.contiguous().view(torch.int32).numpy().view(np.uint32)
    return t.numpy()


def _blocks(data: bytes, n: int):
    return [data[i:i + n] for i in range(0, len(data), n)]


def _table(chunks):
    return [(c.offset, c.length, c.digest) for c in chunks]


def _walk() -> ShardedAnchoredCudaFragmenter:
    return ShardedAnchoredCudaFragmenter(
        SMALL, FragmenterConfig(devices=4, region_bytes=AREGION),
        device="cpu")


def test_plain_strip_states_matches_xla_on_every_lane():
    """Kernel 5's plain version (and its wrapper on CPU tensors) against
    strip_states_xla with the cuts of mixed-occupancy lanes — full,
    partial, single-block and padding lanes (no cut at all) — compared on
    every lane, padding lanes included."""
    from dfs_tpu.ops.cdc_v2 import gear_candidates_device, select_cuts_device
    from dfs_tpu.ops.sha256_strip import strip_states_xla

    from dfs_tpu_torch.ops.sha256_strip import (strip_states,
                                                strip_states_plain)

    cp = RefChunk(min_blocks=1, avg_blocks=2, max_blocks=3, strip_blocks=4)
    s = 128
    rng = np.random.default_rng(11)
    words = rng.integers(0, 2**32, size=(cp.strip_blocks * 16, s),
                         dtype=np.uint32)
    rb = np.zeros((s,), np.int32)
    rb[:100] = cp.strip_blocks
    rb[100:110] = rng.integers(1, cp.strip_blocks, size=10)
    rb[110] = 1
    cand = gear_candidates_device(jax.device_put(words), cp)
    cutflag, _ = select_cuts_device(cand, jax.device_put(rb), cp)
    cf = np.array(cutflag.astype(jnp.int32))
    assert cf[:, 111:].sum() == 0 and cf[:, :111].any(axis=0).all()
    want = np.asarray(strip_states_xla(jax.device_put(words),
                                       jnp.asarray(cf)))
    cf_t = torch.from_numpy(cf)
    np.testing.assert_array_equal(_np(strip_states_plain(_u32(words), cf_t)),
                                  want)
    np.testing.assert_array_equal(_np(strip_states(_u32(words), cf_t)), want)


def test_strip_states_wrapper_rejects_non_cpu_tensors():
    from dfs_tpu_torch.ops.sha256_strip import strip_states

    words = torch.zeros((16, 4), dtype=torch.uint32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        strip_states(words, torch.zeros((1, 4), dtype=torch.int32,
                                        device="meta"))


def test_lane_tables_np_matches_reference():
    from dfs_tpu.ops.cdc_anchored import lane_tables_np as ref_tables

    from dfs_tpu_torch.ops.cdc_anchored import lane_tables_np

    bounds = np.array([2100, 5000, 8191, 12288], np.int64)
    for start0, s_pad in ((0, 4), (333, 8)):
        for got, want in zip(lane_tables_np(bounds, start0, s_pad),
                             ref_tables(bounds, start0, s_pad)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="segments"):
        lane_tables_np(bounds, 0, 3)


def test_sharded_passes_match_jax_steps():
    """Pass A and pass B, raw arrays, on 8 slots against dfs_tpu's
    make_anchored_anchor_step / make_anchored_step on the 8-device
    virtual mesh at the parity-check geometry: tiles, cutflags, since,
    states (every lane) and the count."""
    from dfs_tpu.ops.cdc_anchored import region_buffer as ref_buffer
    from dfs_tpu.parallel import sharded_cdc as R
    from dfs_tpu.parallel.mesh import make_mesh as ref_mesh

    n_dev, m_local = 8, 512                    # 4 tiles per device
    m_words = m_local * n_dev
    data = np.random.default_rng(11).integers(0, 256, size=m_words * 4,
                                              dtype=np.uint8)
    words = np.asarray(ref_buffer(data, np.zeros((8,), np.uint8), REF_SMALL,
                                  m_words=m_words))
    rmesh, mesh = ref_mesh(8), make_mesh(8, device="cpu")

    want = np.asarray(R.make_anchored_anchor_step(rmesh, REF_SMALL, m_local)(
        R.shard_anchor_inputs(rmesh, words, m_local)))
    got = S.make_anchored_anchor_step(mesh, SMALL, m_local)(
        S.shard_anchor_inputs(mesh, words, m_local))
    assert (want < 2**30).sum() > 0
    np.testing.assert_array_equal(_np(got), want)

    lanes = R.host_lane_descriptors(data, REF_SMALL, n_dev)
    for g, w in zip(S.host_lane_descriptors(data, SMALL, n_dev), lanes):
        np.testing.assert_array_equal(g, w)
    _, _, _, w_off, sh8, rb, s_real = lanes
    assert 0 < s_real < w_off.shape[0]         # padding lanes present
    want = R.make_anchored_step(rmesh, REF_SMALL)(
        *R.shard_anchored_inputs(rmesh, words, w_off, sh8, rb))
    got = S.make_anchored_step(mesh, SMALL)(
        *S.shard_anchored_inputs(mesh, words, w_off, sh8, rb))
    for g, w in zip(got[:3], want[:3]):          # cutflag, since, states
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    assert int(got[3]) == int(want[3]) > 0


def test_anchored_parity_check_at_8_slots():
    rec = S.anchored_sharded_parity_check(make_mesh(8, device="cpu"), 8)
    assert rec["n_devices"] == 8 and rec["tiles_per_device"] == 4
    assert rec["chunks"] > rec["segments"] > 1


def test_aligned_step_matches_dryrun_oracle():
    """The aligned step on 8 slots against __graft_entry__._dryrun_aligned's
    oracle (per-strip NumPy selection, count == population)."""
    S.aligned_sharded_parity_check(make_mesh(8, device="cpu"), 8)
    with pytest.raises(ValueError, match="slots"):
        S.aligned_sharded_parity_check(make_mesh(4, device="cpu"), 8)


@pytest.mark.parametrize("size", [0, 1, 100, 5000, AREGION, AREGION + 1,
                                  3 * AREGION - 7, 4 * AREGION,
                                  6 * AREGION + 12345])
def test_sharded_walk_byte_identical(size):
    """manifest_stream through the window-batched walk on 4 CPU slots ==
    dfs_tpu's host engine: same spans, digests, file id and size, for
    empty, one-chunk, sub-window, exact-window, multi-batch and
    ragged-tail streams; the stored payloads rebuild the stream."""
    data = np.random.default_rng(4321).integers(0, 256, size=size,
                                                dtype=np.uint8).tobytes()
    ref = RefCpu(REF_SMALL, region_bytes=AREGION).manifest_stream(
        _blocks(data, 1 << 13), name="x")
    stored: dict[str, bytes] = {}
    got = _walk().manifest_stream(_blocks(data, 1 << 13), name="x",
                                  store=lambda d, b: stored.setdefault(d, b))
    assert _table(got.chunks) == _table(ref.chunks)
    assert got.file_id == ref.file_id and got.size == ref.size
    assert b"".join(stored[c.digest] for c in got.chunks) == data


def test_sharded_walk_carry_crosses_slot_boundary():
    """A nonzero carry out of window 0 (slot 0) into window 1 (slot 1),
    derived by dfs_tpu's region oracle; serial staging, and a second batch
    on fewer slots than the mesh."""
    from dfs_tpu.ops.cdc_anchored import region_spans_np

    data = np.random.default_rng(4321).integers(0, 256, size=3 * AREGION,
                                                dtype=np.uint8)
    _, consumed0 = region_spans_np(data[:AREGION], np.zeros((8,), np.uint8),
                                   0, False, REF_SMALL)
    walk = ShardedAnchoredCudaFragmenter(
        SMALL, FragmenterConfig(devices=2, region_bytes=AREGION,
                                staging_buffers=1), device="cpu")
    assert consumed0 - walk.stride > 0
    want = RefCpu(REF_SMALL, region_bytes=AREGION).chunk(data.tobytes())
    got = walk.manifest_stream(_blocks(data.tobytes(), 5000), name="x")
    assert _table(got.chunks) == _table(want)


def test_sharded_walk_config():
    walk = _walk()
    assert walk.describe() == RefCpu(REF_SMALL).describe()
    assert walk.mesh.shape == {"dp": 4, "sp": 1}
    assert walk.stream_span() == AREGION * (4 * 3 + 1)
    # the default window splits 64 MiB over the slots, tile-aligned
    assert ShardedAnchoredCudaFragmenter(
        SMALL, FragmenterConfig(devices=4), device="cpu").region_bytes \
        == 16 * 2**20
    with pytest.raises(ValueError, match="two segments"):
        ShardedAnchoredCudaFragmenter(
            SMALL, FragmenterConfig(devices=4, region_bytes=4096),
            device="cpu")
    for bad in ({"devices": -1}, {"region_bytes": -1},
                {"staging_buffers": 0}):
        with pytest.raises(ValueError):
            FragmenterConfig(**bad)


def test_mesh_layouts():
    mesh = make_mesh(8, device="cpu")
    assert mesh.shape == {"dp": 2, "sp": 4} and mesh.size == 8
    assert make_mesh(8, dp=8, device="cpu").shape == {"dp": 8, "sp": 1}
    assert make_mesh(3, device="cpu").shape == {"dp": 1, "sp": 3}
    listed = make_mesh(device=["cpu"] * 4)
    assert listed.size == 4 and listed.streams == (None,) * 4
    with pytest.raises(ValueError, match="divide"):
        make_mesh(6, dp=4, device="cpu")
    with pytest.raises(ValueError, match="slots"):
        make_mesh(5, device=["cpu"] * 4)


def test_node_with_four_slots_on_cpu(tmp_path):
    """LocalNode with FragmenterConfig(devices=4): streamed upload through
    the window-batched walk, fileId == sha256, chunk table == dfs_tpu's
    engine, download identical, and a whole-body re-upload (the walk's
    chunk()) sends nothing."""
    node = LocalNode(tmp_path, device="cpu", params=SMALL,
                     frag=FragmenterConfig(devices=4, region_bytes=AREGION))
    assert isinstance(node.fragmenter, ShardedAnchoredCudaFragmenter)
    body = np.random.default_rng(9).integers(0, 256, size=3 * AREGION + 999,
                                             dtype=np.uint8).tobytes()
    m, st = node.upload_stream(iter(_blocks(body, 4096)), name="b.bin")
    assert m.file_id == hashlib.sha256(body).hexdigest()
    assert _table(m.chunks) == _table(RefCpu(REF_SMALL).chunk(body))
    assert st["transferredBytes"] == len(body)
    assert node.download(m.file_id) == body
    m2, st2 = node.upload(body, name="b.bin")
    assert m2.chunks == m.chunks and st2["transferredBytes"] == 0
    node.close()
    with pytest.raises(TypeError):
        LocalNode(tmp_path, device="cpu", params=SMALL,
                  frag=FragmenterConfig(devices=2), cpu_cutoff=0)
    single = LocalNode(tmp_path, device="cpu", params=SMALL,
                       frag=FragmenterConfig(devices=1))
    assert isinstance(single.fragmenter, AnchoredCudaFragmenter)
    single.close()


def test_too_few_cuda_devices_raise(monkeypatch):
    """No silent fallback: without CUDA, or with fewer cards than
    configured, the mesh, the walk and the node raise."""
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 CUDA devices, 1 visible"):
        make_mesh(2)
    with pytest.raises(ValueError, match="4 CUDA devices, 1 visible"):
        ShardedAnchoredCudaFragmenter(SMALL, FragmenterConfig(devices=4))
    with pytest.raises(ValueError, match="visible"):
        make_mesh(device=["cuda:0", "cuda:1"])
