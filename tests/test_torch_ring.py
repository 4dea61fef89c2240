"""The elastic ring of the port against dfs_tpu's: the hashed ring's maps,
fingerprints and owners, ``from_dict``'s refusals, the manager's epoch
order, dual-read window and ``ring.json`` (each package resumes the
other's), then in-process port clusters on the CPU: a live add and drain
that converge with a clean census, a restart from the data root mid-window,
a stale node converging with one retry, ``POST /ring`` refusals with
dfs_tpu's text, and the planes that stand still while the ring
migrates."""

import asyncio
import json
import socket
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from dfs_tpu.config import ClusterConfig as RefCluster
from dfs_tpu.config import NodeConfig as RefNodeConfig
from dfs_tpu.config import RingConfig as RefRingConfig
from dfs_tpu.ring import RingMap as RefRing
from dfs_tpu.ring.manager import RingManager as RefManager

from dfs_tpu_torch.cli.main import main as cli_main
from dfs_tpu_torch.config import (CDCParams, CensusConfig, ClusterConfig,
                                  NodeConfig, PeerAddr, RingConfig,
                                  TierConfig)
from dfs_tpu_torch.node.runtime import StorageNodeServer
from dfs_tpu_torch.ring import RingMap, RingMember, digest_point
from dfs_tpu_torch.ring.manager import RingManager
from dfs_tpu_torch.utils.hashing import sha256_hex

CDC = CDCParams(min_size=64, avg_size=256, max_size=1024)
CENSUS_OFF = CensusConfig(history_interval_s=0)
BASE = {1: 1.0, 2: 1.0, 3: 1.0}
# each membership change of the lifecycle, as the weights after it
CHANGES = {"add": {**BASE, 4: 1.0}, "drain": {**BASE, 4: 0.0},
           "remove": {1: 1.0, 3: 1.0}, "reweight": {**BASE, 2: 0.5}}


def _digests(n, tag="ring"):
    rng = np.random.default_rng(20261018)
    return [sha256_hex(rng.bytes(16) + f"{tag}{i}".encode())
            for i in range(n)]


# ---------------------------------------------------------------------- #
# the ring map
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("change", sorted(CHANGES))
def test_hashed_ring_equals_dfs_tpu(change):
    """For the same weights and vnodes: to_dict, fingerprint, owners of
    2,000 seeded digests at rf 1-3, EC stripes and handoff walks."""
    for epoch, weights in ((0, BASE), (1, CHANGES[change])):
        ours = RingMap.hashed(weights, epoch=epoch, vnodes=64)
        ref = RefRing.hashed(weights, epoch=epoch, vnodes=64)
        assert json.dumps(ours.to_dict()) == json.dumps(ref.to_dict())
        assert ours.fingerprint == ref.fingerprint
        assert ours.active_ids() == ref.active_ids()
        for d in _digests(2000):
            for rf in (1, 2, 3):
                assert ours.owners(d, rf) == ref.owners(d, rf)
        fid = _digests(1, "file")[0]
        width = len(ours.active_ids())
        for s in range(8):
            assert ours.ec_stripe_nodes(fid, s, width) == \
                ref.ec_stripe_nodes(fid, s, width)
        for pinned in ([2], [3, 1], []):
            assert ours.handoff_order(pinned) == ref.handoff_order(pinned)


def test_static_ring_equals_dfs_tpu():
    ours, ref = RingMap.static([3, 1, 2, 5]), RefRing.static([3, 1, 2, 5])
    assert ours.to_dict() == ref.to_dict()
    assert ours.fingerprint == ref.fingerprint
    for d in _digests(500):
        assert ours.owners(d, 2) == ref.owners(d, 2)
    assert ours.handoff_order([2]) == ref.handoff_order([2])


@pytest.mark.parametrize("n", [3, 4, 5])
def test_hash_ring_balance_at_64_vnodes(n):
    """Owned-fraction spread stays under 10 points at 64 vnodes."""
    ring = RingMap.hashed({i: 1.0 for i in range(1, n + 1)}, epoch=1,
                          vnodes=64)
    counts = dict.fromkeys(range(1, n + 1), 0)
    pts = _digests(4000)
    for d in pts:
        counts[ring.owners(d, 1)[0]] += 1
    fr = sorted(v / len(pts) for v in counts.values())
    assert fr[-1] - fr[0] < 0.10, fr


def _moved_fraction(old, new, rf=2, npts=3000):
    moved = total = 0
    for d in _digests(npts):
        a, b = set(old.owners(d, rf)), set(new.owners(d, rf))
        moved += len(b - a)
        total += len(b)
    return moved / total


def test_minimal_movement_on_add_remove_reweight():
    r3 = RingMap.hashed(BASE, 1, 64)
    r4 = RingMap.hashed({**BASE, 4: 1.0}, 2, 64)
    assert _moved_fraction(r3, r4) <= 1 / 4 + 0.06
    assert _moved_fraction(r4, r3) <= 1 / 4 + 0.06
    # drain places like removal and keeps the member listed
    rd = RingMap.hashed({**BASE, 4: 0.0}, 3, 64)
    for d in _digests(300):
        assert rd.owners(d, 2) == r3.owners(d, 2)
        assert 4 not in rd.owners(d, 3)
    assert rd.active_ids() == [1, 2, 3]
    frac = _moved_fraction(r3, RingMap.hashed({**BASE, 1: 0.5}, 4, 64))
    assert 0.0 < frac <= 0.25, frac


def test_tiny_weight_member_still_owns_space():
    ring = RingMap.hashed({1: 1.0, 2: 1.0, 3: 0.005}, epoch=1, vnodes=64)
    assert ring.active_ids() == [1, 2, 3]
    for d in _digests(200):
        assert len(ring.owners(d, 2)) == 2
    assert len(ring.ec_stripe_nodes(_digests(1)[0], 0, 3)) == 3
    d = _digests(1)[0]
    assert ring.owners_at(digest_point(d), 2) == \
        RefRing.hashed({1: 1.0, 2: 1.0, 3: 0.005}, 1, 64).owners_at(
            digest_point(d), 2)


BAD_MAPS = [
    "nope", None, [], {"members": []}, {"epoch": "x"},
    {"epoch": -1, "members": []},
    {"epoch": 1, "vnodes": -2, "members": []},
    {"epoch": 1, "members": [{"weight": 1.0}]},
    {"epoch": 1, "members": [{"nodeId": 1}, {"nodeId": 1}]},
    {"epoch": 1, "members": [{"nodeId": -3}]},
    {"epoch": 1, "vnodes": 8, "members": [{"nodeId": 1, "weight": 2000}]},
    {"epoch": 1, "vnodes": 0, "members": [{"nodeId": 1, "weight": 2.0}]},
    {"epoch": 1, "vnodes": 8, "members": [{"nodeId": 1, "weight": "w"}]},
    {"epoch": 2, "vnodes": 8, "members": [{"nodeId": 1, "weight": 0.5},
                                          {"nodeId": 2}]},
]


@pytest.mark.parametrize("bad", BAD_MAPS, ids=range(len(BAD_MAPS)))
def test_from_dict_refuses_what_dfs_tpu_refuses(bad):
    """Each input is refused by both or parsed to the same map by both."""
    try:
        ref = RefRing.from_dict(bad)
    except ValueError:
        with pytest.raises(ValueError):
            RingMap.from_dict(bad)
        return
    assert RingMap.from_dict(bad).to_dict() == ref.to_dict()


@pytest.mark.parametrize("members", ["", "3,1,2", "1,x", "1,,2"])
def test_ring_config_validation_equals_dfs_tpu(members):
    try:
        want = RefRingConfig(members=members).member_ids()
    except ValueError:
        with pytest.raises(ValueError):
            RingConfig(members=members)
        return
    assert RingConfig(members=members).member_ids() == want


# ---------------------------------------------------------------------- #
# the manager
# ---------------------------------------------------------------------- #

def _managers(tmp_path, n=4, members="1,2,3", node_id=1, vnodes=64):
    """(port manager, dfs_tpu manager) over two roots, same config."""
    ours = RingManager(NodeConfig(
        node_id=node_id, cluster=ClusterConfig.localhost(n),
        data_root=tmp_path, ring=RingConfig(vnodes=vnodes,
                                            members=members)),
        tmp_path / "ours")
    ref = RefManager(RefNodeConfig(
        node_id=node_id, cluster=RefCluster.localhost(n),
        data_root=tmp_path, ring=RefRingConfig(vnodes=vnodes,
                                               members=members)),
        tmp_path / "ref")
    return ours, ref


def _same_state(a, b):
    assert a.current.to_dict() == b.current.to_dict()
    assert a.current.fingerprint == b.current.fingerprint
    assert (a.previous is None) == (b.previous is None)
    if a.previous is not None:
        assert a.previous.to_dict() == b.previous.to_dict()
    assert a.migrating == b.migrating


def test_propose_install_adopt_match_dfs_tpu(tmp_path):
    """Two admins race at one epoch: installs and adopts answer and land
    as dfs_tpu's, whichever order the maps arrive in."""
    ours, ref = _managers(tmp_path / "a")
    ours2, ref2 = _managers(tmp_path / "b", node_id=2)
    _same_state(ours, ref)
    add, rew = CHANGES["add"], CHANGES["reweight"]
    m_add, r_add = ours.propose_next(add), ref.propose_next(add)
    m_rew, r_rew = ours2.propose_next(rew), ref2.propose_next(rew)
    assert m_add.to_dict() == r_add.to_dict()
    assert m_add.fingerprint == r_add.fingerprint
    assert m_rew.fingerprint == r_rew.fingerprint != m_add.fingerprint
    assert ours.install(m_add) == ref.install(r_add) is True
    assert ours2.install(m_rew) == ref2.install(r_rew) is True
    # gossip both ways: one side adopts, both end on the same winner
    got = (ours.adopt(m_rew.to_dict()), ours2.adopt(m_add.to_dict()))
    want = (ref.adopt(r_rew.to_dict()), ref2.adopt(r_add.to_dict()))
    assert got == want and got[0] != got[1]
    for a, b in ((ours, ref), (ours2, ref2), (ours, ours2)):
        _same_state(a, b)
    # at or below the current map: a no-op on both
    assert ours.install(m_add) is ref.install(r_add) is False
    # an epoch+1 over an open window keeps the oldest previous map
    nxt = ours.propose_next({1: 1.0, 2: 1.0})
    assert nxt.epoch == 2
    assert ours.install(nxt) == ref.install(RefRing.from_dict(
        nxt.to_dict())) is True
    _same_state(ours, ref)
    assert ours.previous.epoch == 0
    # refusals: no active member, an unknown peer
    for bad in ({"epoch": 9, "vnodes": 8,
                 "members": [{"nodeId": 1, "weight": 0.0}]},
                {"epoch": 9, "vnodes": 8, "members": [{"nodeId": 7}]}):
        with pytest.raises(ValueError):
            ref.adopt(bad)
        with pytest.raises(ValueError):
            ours.adopt(bad)
    ours.finish_migration()
    ref.finish_migration()
    _same_state(ours, ref)


def test_static_cluster_promotes_to_hash_like_dfs_tpu(tmp_path):
    ours, ref = _managers(tmp_path, members="", vnodes=0)
    _same_state(ours, ref)
    assert ours.current.vnodes == 0
    w = {1: 1.0, 2: 1.0, 3: 1.0}
    assert ours.propose_next(w).to_dict() == ref.propose_next(w).to_dict()
    assert ours.propose_next(w).vnodes == 64


def test_read_candidates_in_a_window_equal_dfs_tpu(tmp_path):
    ours, ref = _managers(tmp_path)
    d_list = _digests(400)
    for d in d_list:     # outside a window: the replica set
        assert ours.read_candidates(d, 2) == ref.read_candidates(d, 2) \
            == ours.replica_set(d, 2)
        assert ours.prev_owners(d, 2) == []
    ours.install(ours.propose_next(CHANGES["add"]))
    ref.install(ref.propose_next(CHANGES["add"]))
    moved = 0
    for d in d_list:
        for rf in (1, 2):
            assert ours.read_candidates(d, rf) == ref.read_candidates(d, rf)
            assert ours.prev_owners(d, rf) == ref.prev_owners(d, rf)
            for nid in (1, 2, 3, 4):
                got = ours.is_prev_only(d, nid, rf)
                assert got == ref.is_prev_only(d, nid, rf)
                moved += got
    assert moved > 0
    assert ours.handoff_order([2]) == ref.handoff_order([2])


@pytest.mark.parametrize("writer", ["port", "dfs_tpu"])
def test_ring_json_resumes_across_packages(tmp_path, writer):
    """ring.json written by either manager (an open window, then a closed
    one) is resumed by the other."""
    cfg = NodeConfig(node_id=1, cluster=ClusterConfig.localhost(4),
                     data_root=tmp_path, ring=RingConfig(vnodes=64,
                                                         members="1,2,3"))
    ref_cfg = RefNodeConfig(node_id=1, cluster=RefCluster.localhost(4),
                            data_root=tmp_path,
                            ring=RefRingConfig(vnodes=64, members="1,2,3"))
    mk_w, mk_r = ((lambda: RingManager(cfg, tmp_path)),
                  (lambda: RefManager(ref_cfg, tmp_path)))
    if writer == "dfs_tpu":
        mk_w, mk_r = mk_r, mk_w
    w = mk_w()
    assert w.install(w.propose_next(CHANGES["add"]))
    r = mk_r()
    _same_state(r, w)
    assert r.epoch == 1 and r.migrating and r.previous.epoch == 0
    w.finish_migration()
    r = mk_r()
    _same_state(r, w)
    assert r.epoch == 1 and not r.migrating
    raw = json.loads((tmp_path / "ring.json").read_bytes())
    assert raw["current"] == w.current.to_dict()


# ---------------------------------------------------------------------- #
# in-process port clusters
# ---------------------------------------------------------------------- #

def _free_ports(n):
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def _mk_cluster(n, rf=2):
    ports = _free_ports(2 * n)
    return ClusterConfig(peers=tuple(
        PeerAddr(node_id=i + 1, host="127.0.0.1", port=ports[2 * i],
                 internal_port=ports[2 * i + 1]) for i in range(n)),
        replication_factor=rf)


def _cfg(cluster, root, nid, **kw):
    kw.setdefault("census", CENSUS_OFF)
    return NodeConfig(node_id=nid, cluster=cluster, data_root=root,
                      cdc=CDC, health_probe_s=0, device="cpu", **kw)


async def _start(cluster, root, ids=None, **kw):
    nodes = {}
    for p in cluster.peers:
        if ids is None or p.node_id in ids:
            n = StorageNodeServer(_cfg(cluster, root, p.node_id, **kw))
            await n.start()
            nodes[p.node_id] = n
    return nodes


async def _stop(nodes):
    for n in nodes.values():
        await n.stop()


async def _settle(nodes):
    """Let the spawned boot catch-ups and rebalance kicks finish."""
    for _ in range(200):
        if not any(n._ring_tasks for n in nodes.values()):
            return
        await asyncio.sleep(0.01)


async def _converge(nodes, timeout=30.0):
    """Repair cycles until every node's migration window closed."""
    await _settle(nodes)
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        for n in nodes.values():
            await n.repair_once()
        if not any(n.ring.migrating for n in nodes.values()):
            return
    raise AssertionError("migration never converged: " + str(
        {i: n.ring.rebalance_stats() for i, n in nodes.items()}))


def _corpus(n, seed):
    return np.random.default_rng(seed).integers(0, 256, size=n,
                                                dtype=np.uint8).tobytes()


def _run(coro):
    asyncio.run(coro)


def test_live_add_and_drain_converge_with_a_clean_census(tmp_path):
    """3 -> 4 -> 3: node 4 (a standby) joins under credits, every file
    reads identical from every node, the census is clean, and a drain
    empties node 4 again."""
    payloads = [_corpus(n, 40 + n) for n in (20_000, 35_000, 50_000)]
    cluster = _mk_cluster(4)

    async def go():
        nodes = await _start(cluster, tmp_path, ring=RingConfig(
            vnodes=64, members="1,2,3", rebalance_credit_bytes=1 << 20))
        try:
            await _settle(nodes)
            ms = [(await nodes[i % 3 + 1].upload(p, f"f{i}"))[0]
                  for i, p in enumerate(payloads)]
            assert nodes[4].store.chunks.count() == 0
            out = await nodes[1].ring_admin("add", node_id=4)
            # one shared disk: the derived weight is 1.0
            assert out["epoch"] == 1 and all(out["pushed"].values())
            assert out["ring"]["members"][-1] == {
                "nodeId": 4, "weight": 1.0, "vnodesSeed": 0}
            assert all(n.ring.epoch == 1 and n.ring.migrating
                       for n in nodes.values())
            await _converge(nodes)
            assert nodes[4].store.chunks.count() > 0
            moved = [n.ring.rebalance_stats() for n in nodes.values()]
            assert sum(r["bytesMoved"] for r in moved) > 0
            assert all(r["lastSeconds"] is not None for r in moved)
            for node in nodes.values():
                for m, p in zip(ms, payloads):
                    assert bytes((await node.download(m.file_id))[1]) == p
            rep = await nodes[1].census_report()
            for k in ("underReplicatedTotal", "overReplicatedTotal",
                      "orphanedTotal", "inFlightTotal", "peersFailed"):
                assert rep[k] == 0, (k, rep)
            assert (await nodes[2].ring_admin("drain", node_id=4))[
                "epoch"] == 2
            await _converge(nodes)
            for n in nodes.values():
                await n.repair_once()     # relocation after confirmation
            rep = await nodes[3].census_report()
            for k in ("underReplicatedTotal", "overReplicatedTotal",
                      "orphanedTotal", "inFlightTotal"):
                assert rep[k] == 0, (k, rep)
            assert nodes[4].store.chunks.count() == 0
            for m, p in zip(ms, payloads):
                assert bytes((await nodes[2].download(m.file_id))[1]) == p
            st = await nodes[1].ring_status()
            assert st["peersFailed"] == 0 and all(
                v["epoch"] == 2 for v in st["peers"].values())
        finally:
            await _stop(nodes)

    _run(go())


def test_read_mid_window_from_a_new_owner(tmp_path):
    """Regression: a node that owns a chunk only in the new epoch reads it
    mid-window from its previous owner (a dualReadHit), and repair run
    anywhere in the window never deletes the only copy as a stray."""
    data = _corpus(40_000, 7)
    cluster = _mk_cluster(2, rf=1)

    async def go():
        nodes = await _start(cluster, tmp_path,
                             ring=RingConfig(vnodes=64, members="1"))
        try:
            await _settle(nodes)
            m, _ = await nodes[1].upload(data, "move-me")
            flip = RingMap.hashed({2: 1.0}, epoch=1, vnodes=64)
            for n in nodes.values():
                n.ring.on_change = None        # keep the window open
                assert n.ring.install(flip, source="test")
            assert nodes[2].store.chunks.count() == 0
            _, got = await nodes[2].download(m.file_id)
            assert bytes(got) == data
            assert nodes[2].ring.rebalance_stats()["dualReadHits"] > 0
            # delete_chunks is refused wholesale while the ring migrates
            resp, _ = await nodes[2].client.call(
                cluster.peer(1), {"op": "delete_chunks",
                                  "digests": [m.chunks[0].digest]})
            assert resp["removed"] == [] and resp["refused"]
            await _converge(nodes)
            assert nodes[1].store.chunks.count() == 0
            _, got = await nodes[1].download(m.file_id)
            assert bytes(got) == data
        finally:
            await _stop(nodes)

    _run(go())


def test_restart_from_the_data_root_mid_window_resumes(tmp_path):
    """Node 4 is stopped right after the add and rebuilt on its data
    root: it resumes the epoch and the open window from ring.json and the
    cluster finishes the migration."""
    payload = _corpus(60_000, 11)
    cluster = _mk_cluster(4)

    async def go():
        kw = dict(ring=RingConfig(vnodes=64, members="1,2,3",
                                  rebalance_credit_bytes=0))
        nodes = await _start(cluster, tmp_path, **kw)
        try:
            await _settle(nodes)
            m, _ = await nodes[1].upload(payload, "f")
            for n in nodes.values():
                n.ring.on_change = None         # no walk before the stop
            await nodes[1].ring_admin("add", node_id=4, weight=1.0)
            await nodes[4].stop()
            n4 = StorageNodeServer(_cfg(cluster, tmp_path, 4, **kw))
            assert n4.ring.epoch == 1 and n4.ring.migrating
            await n4.start()
            nodes[4] = n4
            await _converge(nodes)
            assert n4.store.chunks.count() > 0
            assert bytes((await n4.download(m.file_id))[1]) == payload
        finally:
            await _stop(nodes)

    _run(go())


def test_stale_node_converges_with_exactly_one_retry(tmp_path):
    """A bumped node's placement meets stale peers: each refuses once,
    gets the new map by propose_ring, and the refused op is retried
    exactly once; a stale reader adopts the map from the refusal."""
    data = _corpus(30_000, 3)
    cluster = _mk_cluster(3)
    calls: list[tuple[int, str]] = []

    async def go():
        nodes = await _start(cluster, tmp_path, ring=RingConfig(vnodes=64))
        try:
            await _settle(nodes)
            n1 = nodes[1]
            orig = n1.client._call_retrying

            async def counting(peer, header, *a, **kw):
                calls.append((peer.node_id, header.get("op")))
                return await orig(peer, header, *a, **kw)

            n1.client._call_retrying = counting
            n1.ring.on_change = None       # no rebalance walk in between
            n1.ring.install(n1.ring.propose_next(BASE), source="test")
            m, _ = await n1.upload(data, "fresh")
            assert nodes[2].ring.epoch == nodes[3].ring.epoch == 1
            for peer in (2, 3):
                ops = [op for nid, op in calls if nid == peer]
                assert ops.count("propose_ring") == 1
                first = ops.index("propose_ring")
                # the refused op once before the push, retried once after
                assert first == 1 and ops[0] == ops[2] == "has_chunks"
            assert n1.ring.rebalance_stats()["epochMismatches"] == 2
            # a stale reader: roll node 2 back, read through it
            nodes[2].ring.current = RingMap.hashed(BASE, 0, 64)
            nodes[2].ring.previous = None
            assert bytes((await nodes[2].download(m.file_id))[1]) == data
            assert nodes[2].ring.epoch == 1
        finally:
            await _stop(nodes)

    _run(go())


def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


BAD_CHANGES = [
    {"action": "explode", "nodeId": 2},
    {"action": "add", "nodeId": 9},
    {"action": "add"},
    {"action": "add", "nodeId": 1},
    {"action": "drain", "nodeId": 7},
    {"action": "remove", "nodeId": 7},
    {"action": "reweight", "nodeId": 2},
    {"action": "drain", "nodeId": "x"},
]


def test_ring_post_refusals_match_dfs_tpu(tmp_path):
    """Each bad change answers 400 with the text dfs_tpu's runtime gives
    for it (an unstarted dfs_tpu node over the same address book)."""
    from dfs_tpu.config import CDCParams as RefCDC
    from dfs_tpu.config import PeerAddr as RefPeer
    from dfs_tpu.node.runtime import StorageNodeServer as RefServer

    cluster = _mk_cluster(3)
    ref_cluster = RefCluster(peers=tuple(
        RefPeer(node_id=p.node_id, host=p.host, port=p.port,
                internal_port=p.internal_port) for p in cluster.peers),
        replication_factor=2)
    ref = RefServer(RefNodeConfig(
        node_id=1, cluster=ref_cluster, data_root=tmp_path / "ref",
        fragmenter="cdc", cdc=RefCDC(min_size=64, avg_size=256,
                                     max_size=1024)))

    async def ref_text(body):
        try:
            await ref.ring_admin(
                str(body.get("action", "")),
                node_id=int(body["nodeId"])
                if body.get("nodeId") is not None else None,
                weight=None)
        except (ValueError, TypeError) as e:
            return f"Bad ring change: {e}"
        raise AssertionError(f"dfs_tpu accepted {body}")

    async def go():
        nodes = await _start(cluster, tmp_path / "port",
                             ring=RingConfig(vnodes=64, members="1,2"))
        try:
            for body in BAD_CHANGES:
                st, text = await asyncio.to_thread(
                    _post, cluster.peer(1).port, "/ring",
                    json.dumps(body).encode())
                assert st == 400, (body, st, text)
                assert text == await ref_text(body), body
            st, text = await asyncio.to_thread(
                _post, cluster.peer(1).port, "/ring", b"[1]")
            assert st == 400 and text == "Bad ring change: want a JSON " \
                                         "object"
            assert all(n.ring.epoch == 0 for n in nodes.values())
        finally:
            await _stop(nodes)

    _run(go())


def test_tiering_stands_still_while_the_ring_migrates(tmp_path):
    cluster = _mk_cluster(3, rf=3)

    async def go():
        nodes = await _start(cluster, tmp_path, ids={1},
                             ring=RingConfig(vnodes=64),
                             tier=TierConfig(enabled=True, ec_k=1,
                                             min_idle_s=0,
                                             hot_fraction=0.0))
        try:
            n = nodes[1]
            n.ring.on_change = None
            n.ring.install(n.ring.propose_next({1: 1.0, 2: 1.0, 3: 0.5}))
            assert (await n.tier_scan_once())["skipped"] == "migrating"
            n.ring.finish_migration()
            assert (await n.tier_scan_once())["skipped"] is None
        finally:
            await _stop(nodes)

    _run(go())


def test_ring_metrics_and_members_standby(tmp_path):
    """/metrics ring carries the RingConfig echo and the rebalance block;
    a standby outside ring.members owns nothing at epoch 0."""
    cluster = _mk_cluster(3)

    async def go():
        nodes = await _start(cluster, tmp_path, ids={1}, ring=RingConfig(
            vnodes=32, members="1,2", rebalance_credit_bytes=4096))
        try:
            r = nodes[1].metrics()["ring"]
            assert (r["vnodes"], r["members"], r["rebalanceCreditBytes"],
                    r["mode"], r["active"]) == (32, "1,2", 4096, "hash",
                                                [1, 2])
            assert set(r["rebalance"]) == {
                "migrating", "fromEpoch", "bytesMoved", "pushes",
                "creditStallS", "dualReadHits", "epochMismatches",
                "sinceProgressS", "lastSeconds", "lastBytesMoved"}
            for d in _digests(200):
                assert 3 not in nodes[1].ring.replica_set(d, 2)
            assert RingMember(1).weight == 1.0
            # the subcommand: node 2 and 3 do not answer -> exit 1; a
            # reweight through the CLI installs epoch 1
            port = str(cluster.peer(1).port)
            assert await asyncio.to_thread(
                cli_main, ["--port", port, "ring", "status"]) == 1
            nodes[1].ring.on_change = None
            assert await asyncio.to_thread(
                cli_main, ["--port", port, "ring", "reweight", "1",
                           "--weight", "2"]) == 0
            assert nodes[1].ring.epoch == 1
            assert nodes[1].ring.current.weight_of(1) == 2.0
        finally:
            await _stop(nodes)

    _run(go())
