"""The CUDA kernels on the card: each against its plain version, and the
chain, the walks (single-device and sharded) and the node against the
NumPy oracle. Marked ``cuda``;
without a card every test skips. On a machine with one (``--noconftest``:
the suite's conftest imports JAX, which the port needs nowhere):

    python -m pytest --noconftest tests/test_torch_cuda.py -q -p no:xdist
"""

import hashlib

import numpy as np
import pytest
import torch

from dfs_tpu_torch.ops import cdc_anchored as A
from dfs_tpu_torch.ops.cdc_v2 import AlignedCdcParams
from dfs_tpu_torch.utils import u32

pytestmark = pytest.mark.cuda

SMALL = A.AnchoredCdcParams(
    chunk=AlignedCdcParams(min_blocks=2, avg_blocks=4, max_blocks=16,
                           strip_blocks=64),
    seg_min=2048, seg_max=4096, seg_mask=2047)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def corpus(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=n,
                                                dtype=np.uint8)


def _same(a, b):
    if a.dtype == torch.uint32:
        a, b = u32.widen(a), u32.widen(b)
    assert torch.equal(a.cpu(), b.cpu())


def _region(dev, n=300000, seed=1):
    data = corpus(n, seed)
    words = A.words_tensor(A.region_buffer(data, np.zeros(8, np.uint8),
                                           SMALL)).to(dev)
    shape = A.make_chain_fn(SMALL, words.shape[0], 8, "tight").shape
    tiles = A.anchor_tiles(words, SMALL, shape["m_words"])
    scal = torch.tensor([0, n, 1], dtype=torch.int32, device=dev)
    return words, shape, tiles, scal


def test_kernels_match_plain_versions(dev):
    from dfs_tpu_torch import kernels
    from dfs_tpu_torch.ops.layout import (bswap_transpose,
                                          bswap_transpose_plain)
    from dfs_tpu_torch.ops.repack import repack_lanes, repack_lanes_plain
    from dfs_tpu_torch.ops.select import select_walk, select_walk_plain
    from dfs_tpu_torch.ops.sha256_strip import (live_state_rows,
                                                strip_chunk_states,
                                                strip_chunk_states_plain,
                                                strip_states,
                                                strip_states_plain,
                                                zero_dead_states)

    words, shape, tiles, scal = _region(dev)
    before = kernels.launch_counts()
    cap, s_pad = shape["cap"], shape["s_pad"]
    b = select_walk(tiles, scal, cap, SMALL.seg_min, SMALL.seg_max)
    _same(b, select_walk_plain(tiles, scal, cap, SMALL.seg_min,
                               SMALL.seg_max))
    _, _, w_off, sh8, rb, _, _, _ = A.descriptors(b, scal[0], s_pad)
    lw = SMALL.chunk.strip_blocks * 16
    packed = repack_lanes(words, w_off, sh8, lw)
    _same(packed, repack_lanes_plain(words, w_off, sh8, lw))
    wt = bswap_transpose(packed)
    _same(wt, bswap_transpose_plain(packed))
    cp = SMALL.chunk
    args = (wt, rb, cp.seed, cp.mask, cp.min_blocks, cp.max_blocks)
    k1 = strip_chunk_states(*args)
    p1 = strip_chunk_states_plain(*args)
    # cutflag and since exact everywhere; states on live rows, 0 elsewhere
    _same(k1[0], p1[0])
    _same(k1[1], p1[1])
    _same(k1[2], zero_dead_states(p1[2], p1[0]))
    assert not live_state_rows(k1[0]).all()       # padding lanes exist
    # kernel 5 with kernel 1's cuts: its plain version on live rows, and
    # K1's states bit for bit (the shared chain code)
    k5 = strip_states(wt, k1[0])
    _same(k5, zero_dead_states(strip_states_plain(wt, k1[0]), k1[0]))
    _same(k5, k1[2])
    after = kernels.launch_counts()
    # one launch each of the five chain kernels, none of kernels 6 and 7
    chain = {"select_walk", "repack_lanes", "bswap_transpose",
             "strip_chunk_states", "strip_states"}
    assert all(after[k] == before[k] + (k in chain) for k in after)


def test_k4_select_walk_on_adversarial_cases(dev):
    """K4 against its plain version on every case of
    tests/test_torch_select.py (no anchors, anchors at lo - 1 and hi - 1,
    plane-1-only windows, windows past the table, n <= seg_max, start0 !=
    0, three of the kernel's chunks, and the seg_max of 512 KiB and 4 MiB
    that large chunk sizes bring), and at the full 64 MiB shape ([2,
    131072], cap 683) with no anchors and with the edge walk from a
    carried start on a non-final region."""
    from test_torch_select import (ALL_CASES, SEGMENTS, edge_positions,
                                   select_cap, tiles_from_positions)

    from dfs_tpu_torch import kernels
    from dfs_tpu_torch.ops.select import (NO_ANCHOR, select_walk,
                                          select_walk_plain)

    seg_min, seg_max = SEGMENTS["prod"]
    m_full = 131072
    full = [("full-no-anchors", "prod",
             np.full((2, m_full), NO_ANCHOR, np.int32), 64 * 2**20, 0, True),
            ("full-edges", "prod", tiles_from_positions(edge_positions(
                seg_min, seg_max, 4321, 64 * 2**20 - 77), m_full),
             64 * 2**20 - 77, 4321, False)]
    before = kernels.launch_counts()["select_walk"]
    for label, kind, tiles, n, start0, final in ALL_CASES + full:
        lo, hi = SEGMENTS[kind]
        cap = select_cap(kind, tiles.shape[1])
        scal = torch.tensor([start0, n, int(final)], dtype=torch.int32)
        want = select_walk_plain(torch.from_numpy(tiles), scal, cap, lo, hi)
        got = select_walk(torch.from_numpy(tiles).to(dev), scal.to(dev), cap,
                          lo, hi)
        assert torch.equal(got.cpu(), want), label
    assert kernels.launch_counts()["select_walk"] == \
        before + len(ALL_CASES) + len(full)


def _u32(x: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.uint32)
                            .view(np.int32)).view(torch.uint32).to(dev)


@pytest.mark.parametrize("geom", [(2, 4, 16, 256, True),
                                  (1, 2, 8, 128, True),
                                  (2, 4096, 4096, 4096, False)])
def test_strip_kernels_on_adversarial_lanes(dev, geom):
    """K1 and K5 against their plain versions (live rows exact, dead rows
    0) on lanes that reach every edge of the selection: a lane with no
    candidate (chunks of max_blocks), rb = bps, bps - 1, 1 and 0, and
    min_blocks = 1 (the longest chunk list); K5 also on hand-made flags
    over an odd lane count. The 4096-block geometry searches more than
    1024 blocks for a candidate (several warp steps); its plain states
    would walk 4096 blocks in Python, so there K1's states are held to
    K5's and cutflag and since to the plain selection."""
    from dfs_tpu_torch import kernels
    from dfs_tpu_torch.ops.cdc_v2 import (gear_candidates, gear_table,
                                          select_cuts)
    from dfs_tpu_torch.ops.sha256_strip import (live_state_rows,
                                                strip_chunk_states,
                                                strip_chunk_states_plain,
                                                strip_states,
                                                strip_states_plain,
                                                zero_dead_states)

    min_b, avg_b, max_b, bps, plain_states = geom
    cp = AlignedCdcParams(min_blocks=min_b, avg_blocks=avg_b,
                          max_blocks=max_b, strip_blocks=bps)
    s = 40
    rng = np.random.default_rng(bps + min_b)
    words = rng.integers(0, 2**32, size=(bps * 16, s), dtype=np.uint32)
    # lane 3: every byte v with G[v] & mask != 0, so no block is a
    # candidate and every chunk but the last is max_blocks long
    g = gear_table(cp.seed).numpy()
    v = int(np.flatnonzero(g & cp.mask)[0])
    words[:, 3] = v * 0x01010101
    rb = rng.integers(1, bps + 1, size=s).astype(np.int32)
    rb[:6] = [bps, bps - 1, 1, bps, 0, 0]
    rb_t = torch.from_numpy(rb).to(dev)
    wt = _u32(words, dev)
    args = (wt, rb_t, cp.seed, cp.mask, cp.min_blocks, cp.max_blocks)
    before = kernels.launch_counts()
    k1 = strip_chunk_states(*args)
    if plain_states:
        p1 = strip_chunk_states_plain(*args)
        _same(k1[2], zero_dead_states(p1[2], p1[0]))
    else:
        cf, since = select_cuts(gear_candidates(wt, cp.seed, cp.mask), rb_t,
                                cp.min_blocks, cp.max_blocks)
        p1 = (cf.to(torch.int32), since)
    _same(k1[0], p1[0])
    _same(k1[1], p1[1])
    assert int(k1[1][:, 3].max()) == max_b
    live = live_state_rows(k1[0])
    assert not live[:, 4:6].any() and live[:, 0].all()
    _same(strip_states(wt, k1[0]), k1[2])
    if plain_states:
        # K5 on given flags, odd lane count: sparse flags, some lanes none
        s5 = 37
        cf = (rng.random((bps, s5)) < 0.05).astype(np.int32)
        cf[:, 7] = 0
        cf[:, 8] = 1
        cf[bps // 2:, 9] = 0
        cf_t = torch.from_numpy(cf).to(dev)
        wt5 = _u32(words[:, :s5], dev)
        _same(strip_states(wt5, cf_t),
              zero_dead_states(strip_states_plain(wt5, cf_t), cf_t))
    after = kernels.launch_counts()
    assert after["strip_chunk_states"] == before["strip_chunk_states"] + 1
    assert after["strip_states"] == \
        before["strip_states"] + (2 if plain_states else 1)


@pytest.mark.parametrize("geom", [(1, 2, 8, 64, 1, 45),
                                  (2, 4, 16, 64, 3, 300),
                                  (8, 16, 64, 256, 8, 45),
                                  (4, 8, 32, 96, 5, 300)])
def test_strip_kernels_wide_layout_matches_narrow_and_plain(dev, geom):
    """K1 and K5 with the wide (large-lane) layout forced at a small
    geometry, selection CTAs of 1 to 8 lanes, chain CTAs of one lane (45
    lanes) and of several (300 lanes, more than the card's SMs): every
    output equal to the narrow layout's, and states equal to the plain
    versions' on live rows (dead rows 0). min_blocks 1 gives a list entry
    for every block (the length-class ranking at its densest); K5 also on
    hand-made flags."""
    from dfs_tpu_torch import kernels
    from dfs_tpu_torch.ops.sha256_strip import (plan_strip,
                                                strip_chunk_states,
                                                strip_chunk_states_plain,
                                                strip_states,
                                                strip_states_plain,
                                                zero_dead_states)

    min_b, avg_b, max_b, bps, sel, s = geom
    cp = AlignedCdcParams(min_blocks=min_b, avg_blocks=avg_b,
                          max_blocks=max_b, strip_blocks=bps)
    rng = np.random.default_rng(bps * 10 + sel)
    wt = _u32(rng.integers(0, 2**32, size=(bps * 16, s), dtype=np.uint32),
              dev)
    rb = rng.integers(0, bps + 1, size=s).astype(np.int32)
    rb[:3] = [bps, 1, 0]
    args = (wt, torch.from_numpy(rb).to(dev), cp.seed, cp.mask, min_b, max_b)
    assert plan_strip("k1", bps, bps, True, "wide", sel).select_lanes == sel
    before = kernels.launch_counts()
    narrow = strip_chunk_states(*args, layout="narrow")
    wide = strip_chunk_states(*args, layout="wide", select_lanes=sel)
    for a, b in zip(narrow, wide):
        _same(a, b)
    plain = strip_chunk_states_plain(*args)
    _same(wide[0], plain[0])
    _same(wide[1], plain[1])
    _same(wide[2], zero_dead_states(plain[2], plain[0]))
    cf = (rng.random((bps, s)) < 0.2).astype(np.int32)
    cf[:, 5] = 1
    cf[:, 6] = 0
    cf_t = torch.from_numpy(cf).to(dev)
    k5 = strip_states(wt, cf_t, layout="wide")
    _same(k5, strip_states(wt, cf_t, layout="narrow"))
    _same(k5, zero_dead_states(strip_states_plain(wt, cf_t), cf_t))
    _same(strip_states(wt, wide[0], layout="wide"), wide[2])
    after = kernels.launch_counts()
    assert after["strip_chunk_states"] == before["strip_chunk_states"] + 2
    assert after["strip_states"] == before["strip_states"] + 3


def test_strip_states_at_the_wide_layouts_block_limit(dev):
    """K5 on two lanes of 2^20 blocks (64 MiB each: the wide layout's
    20-bit block field full), flags every 4,099 blocks and on the last
    row: the digest finished from each chunk's last state (one more
    compression of its FIPS padding block) equals hashlib's, for the
    first, a middle and the last chunk of each lane; rows after a lane's
    last flag are 0."""
    from dfs_tpu_torch.ops import sha256
    from dfs_tpu_torch.ops.sha256_strip import plan_strip, strip_states

    bps, s, every = 2**20, 2, 4099
    assert plan_strip("k5", bps, bps).wide
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261021)
    wt = torch.randint(0, 256, (bps * 16 * s * 4,), dtype=torch.uint8,
                       device=dev, generator=gen).view(torch.int32).view(
                           bps * 16, s).view(torch.uint32)
    cf = torch.zeros((bps, s), dtype=torch.int32, device=dev)
    cf[every - 1::every, :] = 1
    cf[bps - 1, 0] = 1                 # lane 1 stops at its last flag
    states = strip_states(wt, cf)
    torch.cuda.synchronize()
    flags = [np.flatnonzero(cf[:, j].cpu().numpy()) for j in range(s)]
    rows = u32.widen(states).reshape(bps, 8, s)
    for j in range(s):
        lane = (wt[:, j].contiguous().cpu().view(torch.int32).numpy()
                .view(np.uint32).astype(">u4").tobytes())
        ends = flags[j]
        for k in (0, len(ends) // 2, len(ends) - 1):
            t0 = ends[k - 1] + 1 if k else 0
            t1 = int(ends[k])
            st = rows[t1, :, j][None, :]
            ln = torch.tensor([(t1 - t0 + 1) * 64], device=dev)
            dig = torch.stack(sha256.compress(
                [st[:, i] for i in range(8)], sha256.pad_block(ln)), 1)
            assert sha256.state_to_hex(u32.narrow(dig))[0] == \
                hashlib.sha256(lane[t0 * 64:(t1 + 1) * 64]).hexdigest()
        assert not bool(rows[int(ends[-1]) + 1:, :, j].any())


def test_chain_and_walk_match_oracle_on_card(dev):
    from dfs_tpu_torch.fragmenter.cdc_anchored import AnchoredCudaFragmenter

    for n in (1, 5000, 300000):
        data = corpus(n, seed=n)
        assert A.batch_chunks_anchored(data, SMALL, lane_multiple=8,
                                       device=dev) == \
            A.chunk_file_anchored_np(data, SMALL)
    data = corpus(200000, seed=7)
    f = AnchoredCudaFragmenter(SMALL, region_bytes=16384, cpu_cutoff=0,
                               lane_multiple=8, device=dev)
    want = A.chunk_file_anchored_np(data, SMALL)
    assert [(c.offset, c.length, c.digest) for c in f.chunk(data.tobytes())
            ] == want
    blocks = [data[i:i + 7333].tobytes() for i in range(0, len(data), 7333)]
    got = [c for bt in f.chunks_stream(blocks) for c in bt]
    assert [(c.offset, c.length, c.digest) for c in got] == want


def test_device_trace_frames_the_kernels_on_card(dev, tmp_path):
    """A fragmenter walk inside device_trace and an upload.fragment span:
    the exported trace holds the launches of K1-K4 inside the range."""
    from dfs_tpu_torch import kernels
    from dfs_tpu_torch.fragmenter.cdc_anchored import AnchoredCudaFragmenter
    from dfs_tpu_torch.utils.trace import (device_trace, kernels_within,
                                           span)

    data = corpus(200000, seed=17)
    f = AnchoredCudaFragmenter(SMALL, region_bytes=16384, cpu_cutoff=0,
                               lane_multiple=8, device=dev)
    f.chunk(data.tobytes())                   # built and warm
    with device_trace(str(tmp_path)):
        with span("upload.fragment"):
            got = f.chunk(data.tobytes())
    assert [(c.offset, c.length, c.digest) for c in got] \
        == A.chunk_file_anchored_np(data, SMALL)
    inside = kernels_within(
        str(tmp_path / "trace.json"), "upload.fragment",
        {k: kernels.DEVICE_FUNCS[k] for k in (
            "strip_chunk_states", "repack_lanes", "bswap_transpose",
            "select_walk")})
    assert all(n > 0 for n in inside.values()), inside


def test_node_roundtrip_on_card(dev, tmp_path):
    from dfs_tpu_torch.node import LocalNode

    node = LocalNode(tmp_path, device=dev, params=SMALL, region_bytes=16384,
                     cpu_cutoff=0, lane_multiple=8)
    body = corpus(100000, seed=9).tobytes()
    m, st = node.upload_stream(iter([body[i:i + 4096]
                                     for i in range(0, len(body), 4096)]))
    assert m.file_id == hashlib.sha256(body).hexdigest()
    assert node.download(m.file_id) == body
    _, st2 = node.upload(body)
    assert st2["transferredBytes"] == 0


def test_concurrent_walks_on_one_fragmenter(dev):
    """A node chunks concurrent uploads with one fragmenter, each walk in
    its own worker thread on the card: four at once, whole and streamed,
    each equal to the oracle."""
    from concurrent.futures import ThreadPoolExecutor

    from dfs_tpu_torch import kernels
    from dfs_tpu_torch.fragmenter.cdc_anchored import AnchoredCudaFragmenter

    f = AnchoredCudaFragmenter(SMALL, region_bytes=16384, cpu_cutoff=0,
                               lane_multiple=8, device=dev)
    bodies = [corpus(150000 + 7919 * k, seed=20 + k) for k in range(4)]

    def walk(k):
        data = bodies[k]
        if k % 2:
            return [c for bt in f.chunks_stream(
                [data[i:i + 5000].tobytes()
                 for i in range(0, len(data), 5000)]) for c in bt]
        return f.chunk(data.tobytes())

    before = kernels.launch_counts()["strip_chunk_states"]
    with ThreadPoolExecutor(4) as pool:
        got = list(pool.map(walk, range(4)))
    for data, chunks in zip(bodies, got):
        assert [(c.offset, c.length, c.digest) for c in chunks] \
            == A.chunk_file_anchored_np(data, SMALL)
    assert kernels.launch_counts()["strip_chunk_states"] > before


def test_sharded_path_on_two_slots_of_one_card(dev):
    """The multi-device anchored path on a 2-slot mesh of one card (each
    slot its own stream): both parity checks, and the window-batched walk
    streamed against the oracle."""
    from dfs_tpu_torch import kernels
    from dfs_tpu_torch.config import FragmenterConfig
    from dfs_tpu_torch.fragmenter.cdc_anchored_sharded import \
        ShardedAnchoredCudaFragmenter
    from dfs_tpu_torch.parallel import sharded_cdc as S
    from dfs_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(2, device=[dev, dev])
    assert all(st is not None for st in mesh.streams)
    before = kernels.launch_counts()["strip_states"]
    S.anchored_sharded_parity_check(mesh, 2)
    S.aligned_sharded_parity_check(mesh, 2)
    assert kernels.launch_counts()["strip_states"] == before + 4
    walk = ShardedAnchoredCudaFragmenter(
        SMALL, FragmenterConfig(devices=2, region_bytes=16384),
        device=[dev, dev])
    data = corpus(150000, seed=11)
    blocks = [data[i:i + 7333].tobytes() for i in range(0, len(data), 7333)]
    got = [c for bt in walk.chunks_stream(blocks) for c in bt]
    assert [(c.offset, c.length, c.digest) for c in got] == \
        A.chunk_file_anchored_np(data, SMALL)


def test_ec_codec_on_card(dev):
    """The EC codec in torch on the card against the NumPy oracle: one
    stripe, the batched encode the node runs (mixed widths and lengths),
    the batched decode in every erasure case, and the sharded step on 4
    slots of the card."""
    from dfs_tpu_torch.ops import ec as E
    from dfs_tpu_torch.parallel.mesh import make_mesh
    from dfs_tpu_torch.parallel.sharded_cdc import (make_ec_step,
                                                    shard_ec_inputs)

    rng = np.random.default_rng(5)
    sh = rng.integers(0, 256, size=(5, 4096), dtype=np.uint8)
    for a, b in zip(E.encode_pq(sh, device=dev), E.encode_pq_np(sh)):
        assert np.array_equal(a, b)
    stripes, padded = [], []
    for s in range(200):
        k = int(rng.integers(1, 5))
        shards = [rng.integers(0, 256, size=int(rng.integers(1, 9000)),
                               dtype=np.uint8).tobytes() for _ in range(k)]
        pad = -(-max(len(b) for b in shards) // 4) * 4
        arr = np.zeros((k, pad), dtype=np.uint8)
        for j, b in enumerate(shards):
            arr[j, :len(b)] = np.frombuffer(b, dtype=np.uint8)
        stripes.append((shards, pad))
        padded.append(arr)
    want = [E.encode_pq_np(a) for a in padded]
    for (gp, gq), (wp, wq) in zip(E.encode_stripes(stripes, device=dev),
                                  want):
        assert np.array_equal(gp, wp) and np.array_equal(gq, wq)
    for lose in ((True, False), (False, True)):
        batch = [([None] + list(a[1:]), p if lose[0] else None,
                  q if lose[1] else None) for a, (p, q) in zip(padded, want)]
        for a, r, rn in zip(padded, E.recover_stripes(batch, device=dev),
                            E.recover_stripes_np(batch)):
            assert all(np.array_equal(x, y) and np.array_equal(x, z)
                       for x, y, z in zip(r, rn, a))
    two = [([None] + list(a[1:-1]) + [None], p, q)
           for a, (p, q) in zip(padded, want) if len(a) >= 2]
    for r, rn in zip(E.recover_stripes(two, device=dev),
                     E.recover_stripes_np(two)):
        assert all(np.array_equal(x, y) for x, y in zip(r, rn))
    words = rng.integers(0, 256, size=(16, 3, 1024), dtype=np.uint8)
    mesh = make_mesh(4, device=[dev] * 4)
    p, q, n = make_ec_step(mesh, 3)(shard_ec_inputs(
        mesh, words.view(np.uint32)))
    p = p.view(torch.int32).cpu().numpy().view(np.uint8)
    q = q.view(torch.int32).cpu().numpy().view(np.uint8)
    for s in range(16):
        wp, wq = E.encode_pq_np(words[s])
        assert np.array_equal(p[s], wp) and np.array_equal(q[s], wq)
    assert int(n) == 2 * 16 * 1024


def test_ec_upload_encodes_on_card(dev, tmp_path):
    """A k=3 upload through five in-process nodes that chunk on the card:
    the encode runs on the card, the parity equals the oracle's, and a
    survivor reads the file back with two nodes stopped."""
    import asyncio
    import socket

    from dfs_tpu_torch.config import (CDCParams, ClusterConfig, NodeConfig,
                                      PeerAddr)
    from dfs_tpu_torch.meta.manifest import ec_stripe_groups
    from dfs_tpu_torch.node.runtime import StorageNodeServer
    from dfs_tpu_torch.ops.ec import encode_pq_np

    socks = [socket.socket() for _ in range(10)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    cluster = ClusterConfig(peers=tuple(
        PeerAddr(node_id=i + 1, host="127.0.0.1", port=ports[2 * i],
                 internal_port=ports[2 * i + 1]) for i in range(5)),
        replication_factor=2)
    body = corpus(60000, seed=12).tobytes()

    async def go():
        nodes = {i: StorageNodeServer(NodeConfig(
            node_id=i, cluster=cluster, data_root=tmp_path,
            cdc=CDCParams(min_size=64, avg_size=256, max_size=1024),
            health_probe_s=0, device=str(dev))) for i in range(1, 6)}
        for n in nodes.values():
            await n.start()
        try:
            m, st = await nodes[1].upload(body, "ec.bin", ec_k=3)
            assert m.file_id == hashlib.sha256(body).hexdigest()
            enc = nodes[1].metrics()["frag"]["ecEncode"]
            assert enc["device"] == str(dev) and enc["calls"] == 1
            for grp, s in zip(ec_stripe_groups(m.chunks, 3), m.ec.stripes):
                arr = np.zeros((len(grp), s.shard_len), dtype=np.uint8)
                for j, c in enumerate(grp):
                    arr[j, :c.length] = np.frombuffer(
                        body[c.offset:c.offset + c.length], dtype=np.uint8)
                p, q = encode_pq_np(arr)
                assert hashlib.sha256(p.tobytes()).hexdigest() == s.p
                assert hashlib.sha256(q.tobytes()).hexdigest() == s.q
            for i in (2, 3):
                await nodes.pop(i).stop()
            _, got = await nodes[5].download(m.file_id)
            assert bytes(got) == body
            assert nodes[5].counters.snapshot().get("ec_decodes", 0) > 0
        finally:
            for n in nodes.values():
                await n.stop()

    asyncio.run(asyncio.wait_for(go(), timeout=120))


def test_sim_sketcher_on_card(dev):
    """The min-hash sketcher on the card against the NumPy oracle: a batch
    of every length class (chunks longer than the window take the oracle),
    at shingle widths 1, 8 and 64, on one slot and on 4 slots of the card
    (make_sketch_step)."""
    from dfs_tpu_torch.config import SimConfig
    from dfs_tpu_torch.parallel.mesh import make_mesh
    from dfs_tpu_torch.parallel.sharded_cdc import sketch_rows_fn
    from dfs_tpu_torch.sim.sketch import SimSketcher, SketchPlan, sketch_np

    rng = np.random.default_rng(6)
    sizes = [0, 1, 7, 8, 9, 100, 2048, 4095, 9800, 65535, 65536, 65537,
             200_000] + [int(x) for x in rng.integers(2048, 65536, 200)]
    datas = [corpus(n, seed=i).tobytes() for i, n in enumerate(sizes)]
    for q in (1, 8, 64):
        skt = SimSketcher(SimConfig(enabled=True, shingle_bytes=q),
                          device=dev)
        assert skt.device == dev
        want = np.stack([sketch_np(d, 16, q, skt.lanes_a, skt.lanes_b)
                         for d in datas])
        assert np.array_equal(skt.sketch_many(datas), want)
        fits = [d for d in datas if len(d) <= skt.window]
        plan = SketchPlan([len(d) for d in fits], q)
        packed = torch.from_numpy(plan.pack(fits)).to(dev)
        mesh = make_mesh(4, device=[dev] * 4)
        got = plan.sketch(packed, sketch_rows_fn(mesh, skt.lanes_a,
                                                 skt.lanes_b, q))
        got = got.view(torch.int32).cpu().numpy().view(np.uint32)
        idx = [i for i, d in enumerate(datas) if len(d) <= skt.window]
        assert np.array_equal(got, want[np.asarray(idx)[plan.order]])


def test_serving_tier_cluster_on_card(dev, tmp_path):
    """Two nodes chunking on the card with the serving tier on (cache,
    readahead 2): an upload reads back byte-identical from both, the
    second read of each from the cache."""
    import asyncio
    import socket

    from dfs_tpu_torch.config import (CDCParams, ClusterConfig, NodeConfig,
                                      PeerAddr, ServeConfig)
    from dfs_tpu_torch.node.runtime import StorageNodeServer

    socks = [socket.socket() for _ in range(4)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    cluster = ClusterConfig(peers=tuple(
        PeerAddr(node_id=i + 1, host="127.0.0.1", port=ports[2 * i],
                 internal_port=ports[2 * i + 1]) for i in range(2)),
        replication_factor=2)
    body = corpus(1_500_000, seed=8).tobytes()
    serve = ServeConfig(cache_bytes=64 * 1024 * 1024, readahead_batches=2)

    async def go():
        nodes = {i: StorageNodeServer(NodeConfig(
            node_id=i, cluster=cluster, data_root=tmp_path,
            cdc=CDCParams(min_size=64, avg_size=256, max_size=1024),
            health_probe_s=0, device=str(dev), serve=serve))
            for i in (1, 2)}
        for n in nodes.values():
            await n.start()
        try:
            for n in nodes.values():
                n._FETCH_BATCH_BYTES = 256 * 1024     # readahead engages
            m, _ = await nodes[1].upload(body, "serve.bin")
            assert m.file_id == hashlib.sha256(body).hexdigest()
            assert nodes[1].metrics()["frag"]["device"] == str(dev)
            for n in nodes.values():
                for _ in range(2):
                    _, got = await n.download(m.file_id)
                    assert bytes(got) == body
                s = n.metrics()["serve"]
                assert s["cache"]["hits"] > 0 and s["readaheadBatches"] == 2
        finally:
            for n in nodes.values():
                await n.stop()

    asyncio.run(asyncio.wait_for(go(), timeout=120))


def test_smart_client_chunks_on_card(dev, tmp_path):
    """A default-device SmartClient (no ``device``: the card) uploads 3 MiB
    through two CPU nodes at the default chunk sizes: kernels 1-4 launch
    in this process, the committed table equals the oracle, and the
    striped download is identical."""
    import asyncio
    import json
    import socket

    from dfs_tpu_torch import kernels
    from dfs_tpu_torch.client import SmartClient
    from dfs_tpu_torch.config import (ClientConfig, ClusterConfig,
                                      NodeConfig, PeerAddr)
    from dfs_tpu_torch.node.runtime import StorageNodeServer

    socks = [socket.socket() for _ in range(4)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    cluster = ClusterConfig(peers=tuple(
        PeerAddr(node_id=i + 1, host="127.0.0.1", port=ports[2 * i],
                 internal_port=ports[2 * i + 1]) for i in range(2)),
        replication_factor=2)
    body_np = corpus(3 * 1024 * 1024, seed=17)
    body = body_np.tobytes()
    want = A.chunk_file_anchored_np(body_np, A.AnchoredCdcParams())

    async def go():
        nodes = {i: StorageNodeServer(NodeConfig(
            node_id=i, cluster=cluster, data_root=tmp_path,
            health_probe_s=0, device="cpu")) for i in (1, 2)}
        for n in nodes.values():
            await n.start()
        try:
            c = SmartClient(port=ports[0], cfg=ClientConfig(fallback=False))
            kernels.reset_launch_counts()
            info = await asyncio.to_thread(c.upload, body, "card.bin")
            counts = kernels.launch_counts()
            assert info["dataPlane"] == "smart"
            for k in ("strip_chunk_states", "repack_lanes",
                      "bswap_transpose", "select_walk"):
                assert counts[k] > 0, counts
            doc = json.loads(nodes[2].store.manifests.load(
                info["fileId"]).to_json())
            assert [(x["offset"], x["length"], x["digest"])
                    for x in doc["chunks"]] == want
            assert await asyncio.to_thread(c.download,
                                           info["fileId"]) == body
        finally:
            for n in nodes.values():
                await n.stop()

    asyncio.run(asyncio.wait_for(go(), timeout=120))


def test_tier_demotion_encodes_on_card(dev, tmp_path):
    """Five nodes chunking on the card with the index and tiering planes
    on: a scan demotes the unread file to k=3 EC, its P+Q encoded on the
    card (ecEncode names the card, parity equals the oracle's), and the
    cold file reads back with two nodes stopped."""
    import asyncio
    import socket

    from dfs_tpu_torch.config import (CDCParams, ClusterConfig, IndexConfig,
                                      NodeConfig, PeerAddr, TierConfig)
    from dfs_tpu_torch.meta.manifest import ec_stripe_groups
    from dfs_tpu_torch.node.runtime import StorageNodeServer
    from dfs_tpu_torch.ops.ec import encode_pq_np

    socks = [socket.socket() for _ in range(10)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    cluster = ClusterConfig(peers=tuple(
        PeerAddr(node_id=i + 1, host="127.0.0.1", port=ports[2 * i],
                 internal_port=ports[2 * i + 1]) for i in range(5)),
        replication_factor=2)
    hot, cold = corpus(60000, seed=13).tobytes(), \
        corpus(60000, seed=14).tobytes()
    tier = TierConfig(enabled=True, hot_fraction=0.5, min_idle_s=0.0,
                      ec_k=3, half_life_s=86400.0)

    async def go():
        nodes = {i: StorageNodeServer(NodeConfig(
            node_id=i, cluster=cluster, data_root=tmp_path,
            cdc=CDCParams(min_size=64, avg_size=256, max_size=1024),
            health_probe_s=0, device=str(dev),
            index=IndexConfig(enabled=True, filter_sync_s=0), tier=tier))
            for i in range(1, 6)}
        for n in nodes.values():
            await n.start()
        try:
            hm, _ = await nodes[1].upload(hot, "hot.bin")
            cm, _ = await nodes[1].upload(cold, "cold.bin")
            _, got = await nodes[1].download(hm.file_id)
            assert bytes(got) == hot
            out = await nodes[1].tier_scan_once()
            assert out["demoted"] == 1, out
            enc = nodes[1].metrics()["frag"]["ecEncode"]
            assert enc["device"] == str(dev) and enc["calls"] == 1
            m = nodes[1].store.manifests.load(cm.file_id)
            assert m.tier == "cold"
            for grp, s in zip(ec_stripe_groups(m.chunks, 3), m.ec.stripes):
                arr = np.zeros((len(grp), s.shard_len), dtype=np.uint8)
                for j, c in enumerate(grp):
                    arr[j, :c.length] = np.frombuffer(
                        cold[c.offset:c.offset + c.length], dtype=np.uint8)
                p, q = encode_pq_np(arr)
                assert hashlib.sha256(p.tobytes()).hexdigest() == s.p
                assert hashlib.sha256(q.tobytes()).hexdigest() == s.q
            for i in (3, 4):
                await nodes.pop(i).stop()
            _, got = await nodes[5].download(cm.file_id)
            assert bytes(got) == cold
        finally:
            for n in nodes.values():
                await n.stop()

    asyncio.run(asyncio.wait_for(go(), timeout=120))


def test_sidecar_on_card(dev):
    """The sidecar as users run it, on the card: ``auto`` at the default
    parameters; a 3 MiB body (one window of the device walk) through
    ChunkHashStream and ChunkHashDuplex equals the oracle, Health's window
    is the walk's stream_span, and K1-K4 launch."""
    from dfs_tpu_torch import kernels
    from dfs_tpu_torch.sidecar import SidecarClient, SidecarServer

    srv = SidecarServer(port=0, fragmenter="auto", device=dev)
    srv.start()
    try:
        c = SidecarClient(srv.port)
        h = c.health()
        assert h["fragmenter"] == "cdc-anchored-cuda"
        assert h["window"] == srv.fragmenter.stream_span()
        data = corpus(3 * 1024 * 1024, seed=41)
        want = A.chunk_file_anchored_np(data, srv.fragmenter.params)
        body = data.tobytes()
        kernels.reset_launch_counts()
        got = c.chunk_hash_stream(body[i:i + (1 << 20)]
                                  for i in range(0, len(body), 1 << 20))
        msgs = list(c.chunk_hash_duplex(iter([body])))
        counts = kernels.launch_counts()
        for table in (got["chunks"],
                      [x for m in msgs[:-1] for x in m["chunks"]]):
            assert [(x["offset"], x["length"], x["digest"])
                    for x in table] == want
        for k in ("strip_chunk_states", "repack_lanes", "bswap_transpose",
                  "select_walk"):
            assert counts[k] >= 2, counts
    finally:
        srv.stop()


def test_sha256_blocks_kernel_on_card(dev):
    """Kernel 6 against its plain version on random words with rows of 0,
    -1 and more blocks than the axis holds, and the batched digests
    against hashlib at the length boundaries."""
    from dfs_tpu_torch import kernels
    from dfs_tpu_torch.ops import sha256 as S

    rng = np.random.default_rng(6)
    words = rng.integers(0, 2**32, size=(70, 9, 16),
                         dtype=np.uint64).astype(np.uint32)
    nb = rng.integers(0, 10, size=70).astype(np.int32)
    nb[:3] = (0, -1, 12)
    w, n = S.u32_tensor(words, dev), torch.from_numpy(nb).to(dev)
    before = kernels.launch_counts()["sha256_blocks"]
    _same(S.sha256_blocks(w, n), S.sha256_blocks_plain(w, n))
    msgs = [corpus(k, seed=k).tobytes() for k in
            (0, 1, 55, 56, 63, 64, 119, 120, 5000)]
    assert S.sha256_batch_hex(msgs, device=dev) == \
        [hashlib.sha256(m).hexdigest() for m in msgs]
    assert kernels.launch_counts()["sha256_blocks"] == before + 2


def test_sha256_spans_kernel_on_card(dev):
    """Kernel 7 against its plain version and hashlib: every start offset
    mod 16 at the padding boundaries, a 1,025-block span, spans ending at
    the array's last byte, an array whose own start is not 16-byte aligned
    (a view), and N = 0; one launch a call (none for N = 0). Kernel 6's
    outputs on the same spans, packed, are unchanged."""
    from dfs_tpu_torch import kernels
    from dfs_tpu_torch.ops import sha256 as S
    from dfs_tpu_torch.ops.pack import pack_gathered

    lens = [0, 1, 55, 56, 63, 64, 119, 120]
    data = corpus(70_000, seed=7)
    starts = [1024 * off + 128 * k + off for off in range(16)
              for k in range(len(lens))]
    lens = lens * 16
    m = data.shape[0]
    starts += [13, m - 77, m - 1, m - 64, m]
    lens += [1025 * 64 - 9, 77, 1, 64, 0]
    whole = torch.from_numpy(data).to(dev)
    for arr, shift in ((whole, 0), (whole[3:], 3)):
        st = [max(0, s - shift) for s in starts]
        ln = [min(n, arr.shape[0] - s) for s, n in zip(st, lens)]
        before = kernels.launch_counts()
        got = S.sha256_spans(arr, st, ln)
        assert kernels.launch_counts()["sha256_spans"] == \
            before["sha256_spans"] + 1
        torch.cuda.synchronize()
        want = [hashlib.sha256(data[shift + s:shift + s + n].tobytes())
                .hexdigest() for s, n in zip(st, ln)]
        assert S.state_to_hex(got) == want
        short = [i for i, n in enumerate(ln) if n < 200]
        _same(S.sha256_spans(arr, [st[i] for i in short],
                             [ln[i] for i in short]),
              S.sha256_spans_plain(arr, [st[i] for i in short],
                                   [ln[i] for i in short]))
        w, nb = pack_gathered(arr, torch.tensor(st[:40], device=dev),
                              torch.tensor(ln[:40], device=dev), 192)
        _same(S.sha256_blocks(w, nb), got[:40])
    n0 = kernels.launch_counts()["sha256_spans"]
    assert S.sha256_spans(whole, [], []).shape == (0, 8)
    assert kernels.launch_counts()["sha256_spans"] == n0
    with pytest.raises(ValueError):
        S.sha256_spans(whole, [0], [-1])


def test_aligned_v1_and_rolling_paths_on_card(dev):
    """The aligned pipeline (kernels 3 and 1), the v1 engine (kernel 7)
    and the rolling walk over 4 slots of the card against the NumPy
    oracles."""
    import warnings

    from dfs_tpu_torch import kernels
    from dfs_tpu_torch.config import CDCParams, FragmenterConfig
    from dfs_tpu_torch.fragmenter.base import get_fragmenter
    from dfs_tpu_torch.fragmenter.cdc_aligned import AlignedCudaFragmenter
    from dfs_tpu_torch.fragmenter.cdc_cpu import CpuCdcFragmenter
    from dfs_tpu_torch.fragmenter.cdc_cuda import CudaCdcFragmenter
    from dfs_tpu_torch.ops.cdc_v2 import chunk_file_np

    aparams = AlignedCdcParams(min_blocks=2, avg_blocks=4, max_blocks=16,
                               strip_blocks=64)
    data = corpus(400_000, seed=9)
    kernels.reset_launch_counts()
    frag = AlignedCudaFragmenter(aparams, seg_strips=16, cpu_cutoff=0,
                                 device=dev)
    assert [(c.offset, c.length, c.digest) for c in frag.chunk(
        data.tobytes())] == chunk_file_np(data, aparams)
    counts = kernels.launch_counts()
    assert counts["strip_chunk_states"] >= 2 and \
        counts["bswap_transpose"] >= 2
    body = data.tobytes()
    cp = CDCParams(64, 256, 1024)
    want = [(c.offset, c.length, c.digest)
            for c in CpuCdcFragmenter(cp).chunk(body)]
    v1 = CudaCdcFragmenter(cp, tile_size=1 << 16, device=dev)
    assert [(c.offset, c.length, c.digest) for c in v1.chunk(body)] == want
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        assert isinstance(get_fragmenter("cdc-tpu", device=dev),
                          CudaCdcFragmenter)
    rolling = get_fragmenter("cdc", cdc_params=cp, frag=FragmenterConfig(
        devices=4, region_bytes=1 << 16), device=[dev] * 4)
    m = rolling.manifest_stream(iter([body[:100_000], body[100_000:]]), "r")
    assert [(c.offset, c.length, c.digest) for c in m.chunks] == want
    assert kernels.launch_counts()["sha256_spans"] > 0
