"""The port's rolling multi-device walk against dfs_tpu's on the CPU: the
sharded steps on CPU slots (``make_sharded_step`` with kernel 6's plain
version, ``make_sharded_bitmap_step`` with the stream's carry) against
dfs_tpu's ``shard_map`` steps on the 8-device virtual CPU mesh, the halo
crossing slot and region borders at dp 1 and 2; ``ShardedCdcFragmenter``
against dfs_tpu's; and a node that ingests through it. Every comparison is
exact."""

import asyncio
import hashlib
import socket

import numpy as np
import pytest
import torch

from dfs_tpu import config as ref_config
from dfs_tpu.fragmenter.cdc_sharded import \
    ShardedCdcFragmenter as RefSharded
from dfs_tpu.ops.sha256_jax import pad_messages as ref_pad
from dfs_tpu.parallel import sharded_cdc as ref_S
from dfs_tpu.parallel.mesh import make_mesh as ref_mesh

from dfs_tpu_torch.config import (CDCParams, ClusterConfig,
                                  FragmenterConfig, NodeConfig)
from dfs_tpu_torch.fragmenter.base import get_fragmenter
from dfs_tpu_torch.fragmenter.cdc_cpu import (CpuCdcFragmenter,
                                              gear_bitmap_numpy)
from dfs_tpu_torch.fragmenter.cdc_sharded import ShardedCdcFragmenter
from dfs_tpu_torch.ops.sha256 import pad_messages, state_to_hex
from dfs_tpu_torch.parallel import sharded_cdc as S
from dfs_tpu_torch.parallel.mesh import make_mesh
from dfs_tpu_torch.utils.hashing import gear_table

SIZES = dict(min_size=64, avg_size=256, max_size=1024)
PARAMS = CDCParams(**SIZES)
REF_PARAMS = ref_config.CDCParams(**SIZES)
REGION = 4 * 4096        # dfs_tpu's test_sharded_ingest.py REGION


def _table(chunks):
    return [(c.offset, c.length, c.digest) for c in chunks]


@pytest.mark.parametrize("dp", [1, 2])
def test_sharded_step_equals_dfs_tpu(rng, dp):
    """8 slots as dp x (8 / dp): every row's stream tiled over sp (the
    halo crossing 7 or 3 slot borders a row), 16 messages hashed over the
    slots; bitmap, states and count equal dfs_tpu's step on the same
    arrays, the bitmap the whole-row NumPy bitmap, the states hashlib."""
    table = gear_table(PARAMS.seed)
    data = rng.integers(0, 256, size=(2, 4096), dtype=np.uint8)
    msgs = [rng.integers(0, 256, size=int(n), dtype=np.uint8).tobytes()
            for n in rng.integers(1, 300, size=16)]
    words, nblocks = pad_messages(msgs, n_blocks=8, batch=16)
    rw, rn = ref_pad(msgs, n_blocks=8, batch=16)
    assert np.array_equal(words, rw) and np.array_equal(nblocks, rn)

    mesh = make_mesh(8, dp=dp, device="cpu")
    bitmap, states, count = S.make_sharded_step(mesh, table, PARAMS.mask)(
        *S.shard_inputs(mesh, data, words, nblocks))
    rmesh = ref_mesh(8, dp=dp)
    rb, rs, rc = ref_S.make_sharded_step(rmesh, table, REF_PARAMS.mask)(
        *ref_S.shard_inputs(rmesh, data, rw, rn))
    assert np.array_equal(bitmap.numpy(), np.asarray(rb))
    assert np.array_equal(states.view(torch.int32).numpy().view(np.uint32),
                          np.asarray(rs))
    assert int(count) == int(rc) == int(bitmap.sum())
    for row in range(2):
        assert np.array_equal(bitmap[row].numpy(), gear_bitmap_numpy(
            data[row], table, PARAMS.mask))
    assert state_to_hex(states) == [hashlib.sha256(m).hexdigest()
                                    for m in msgs]


def test_rolling_parity_check_on_cpu_slots(rng):
    data = rng.integers(0, 256, size=(2, 2048), dtype=np.uint8)
    rec = S.rolling_sharded_parity_check(
        make_mesh(4, device="cpu"), PARAMS, data, [b"", b"x" * 100])
    assert rec["rows"] == 2 and rec["candidates"] > 0


def test_carry_bitmap_step_equals_dfs_tpu(rng):
    """The carry-in bitmap region by region, with a nonzero carry entering
    region 2, == the whole-stream NumPy bitmap and dfs_tpu's step."""
    table = gear_table(PARAMS.seed)
    mesh = make_mesh(4, dp=1, device="cpu")
    step = S.make_sharded_bitmap_step(mesh, table, PARAMS.mask)
    rmesh = ref_mesh(4, dp=1)
    rstep = ref_S.make_sharded_bitmap_step(rmesh, table, REF_PARAMS.mask)
    data = rng.integers(0, 256, size=2 * REGION, dtype=np.uint8)
    whole = gear_bitmap_numpy(data, table, PARAMS.mask)
    head = np.zeros((1, 31), dtype=np.uint32)
    for r in range(2):
        region = data[r * REGION:(r + 1) * REGION]
        got = step(*S.shard_bitmap_inputs(mesh, region[None, :], head))
        want = np.asarray(rstep(*ref_S.shard_bitmap_inputs(
            rmesh, region[None, :], head)))
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(got[0].numpy(),
                              whole[r * REGION:(r + 1) * REGION])
        head = table[region[-31:]].astype(np.uint32)[None, :]


def _frag(devices: int = 4) -> ShardedCdcFragmenter:
    return ShardedCdcFragmenter(
        PARAMS, FragmenterConfig(devices=devices, region_bytes=REGION),
        device="cpu")


@pytest.mark.parametrize("size", [0, 1, 5000, REGION, REGION + 1,
                                  3 * REGION + 123])
def test_sharded_stream_equals_dfs_tpu(rng, size):
    """The streamed manifest (regions of 4 slot spans, the ragged final
    region on the host kernel) == dfs_tpu's ShardedCdcFragmenter == the
    host engine, fileIds included; payloads stored reassemble the
    stream."""
    data = rng.integers(0, 256, size=size, dtype=np.uint8).tobytes()
    blocks = [data[i:i + 3333] for i in range(0, len(data), 3333)]
    stored = {}
    m = _frag().manifest_stream(iter(blocks), "s", store=stored.__setitem__)
    r = RefSharded(REF_PARAMS, ref_config.FragmenterConfig(
        devices=4, region_bytes=REGION)).manifest_stream(iter(blocks), "s")
    c = CpuCdcFragmenter(PARAMS).manifest_stream(iter(blocks), "s")
    assert (m.file_id, m.size, _table(m.chunks)) == \
        (r.file_id, r.size, _table(r.chunks)) == \
        (c.file_id, c.size, _table(c.chunks))
    assert b"".join(stored[x.digest] for x in m.chunks) == data


def test_factory_and_region_policy():
    f = get_fragmenter("cdc", cdc_params=PARAMS,
                       frag=FragmenterConfig(devices=4), device="cpu")
    r = RefSharded(REF_PARAMS, ref_config.FragmenterConfig(devices=4))
    assert isinstance(f, ShardedCdcFragmenter) and f.mesh.size == 4
    assert (f.name, f.describe(), f.region_bytes) == \
        ("cdc", CpuCdcFragmenter(PARAMS).describe(), r.region_bytes)
    assert _frag(3).region_bytes == RefSharded(
        REF_PARAMS, ref_config.FragmenterConfig(
            devices=3, region_bytes=REGION)).region_bytes
    assert isinstance(get_fragmenter("cdc", cdc_params=PARAMS,
                                     frag=FragmenterConfig(devices=1)),
                      CpuCdcFragmenter)


def test_fewer_devices_than_configured_raise():
    """Deviation from dfs_tpu, which degrades to the host kernel: asked
    for more cards than are visible, the walk raises when it is made."""
    if torch.cuda.device_count() >= 4:
        pytest.skip("four CUDA devices are present")
    with pytest.raises((RuntimeError, ValueError)):
        get_fragmenter("cdc", frag=FragmenterConfig(devices=4))


def test_node_streaming_upload_via_sharded_cdc(tmp_path, rng):
    """An in-process CPU node with ``fragmenter="cdc"`` and four device
    slots ingests a chunked stream through the sharded step and reads it
    back identical; its table equals the host engine's."""
    from dfs_tpu_torch.node.runtime import StorageNodeServer

    socks = [socket.socket() for _ in range(2)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    data = rng.integers(0, 256, size=3 * REGION + 123,
                        dtype=np.uint8).tobytes()
    cfg = NodeConfig(node_id=1,
                     cluster=ClusterConfig.localhost(1, *ports, 1),
                     data_root=tmp_path, fragmenter="cdc", cdc=PARAMS,
                     frag=FragmenterConfig(devices=4, region_bytes=REGION),
                     health_probe_s=0, device="cpu")

    async def run():
        node = StorageNodeServer(cfg)
        assert isinstance(node.fragmenter, ShardedCdcFragmenter)
        await node.start()
        try:
            async def blocks():
                for off in range(0, len(data), 8192):
                    yield data[off:off + 8192]

            manifest, _ = await node.upload_stream(blocks(), "s.bin")
            _, got = await node.download(manifest.file_id)
            return manifest, bytes(got)
        finally:
            await node.stop()

    manifest, got = asyncio.run(asyncio.wait_for(run(), timeout=60))
    assert got == data
    assert _table(manifest.chunks) == _table(
        CpuCdcFragmenter(PARAMS).chunk(data))
    assert manifest.file_id == hashlib.sha256(data).hexdigest()
