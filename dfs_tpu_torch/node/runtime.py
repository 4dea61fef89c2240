"""The asyncio node runtime: a port of dfs_tpu's ``StorageNodeServer``
(``dfs_tpu/node/runtime.py``) for the default configuration.

One process per node, two listeners:

- the external HTTP API (:mod:`dfs_tpu_torch.api.http`);
- the internal binary storage plane (this module), speaking dfs_tpu's
  frames and ops, so port nodes and dfs_tpu nodes can share a cluster.

An upload hashes the body (fileId = sha256), chunks it through the
anchored CDC + SHA-256 chain on the card (in a worker thread, so the
event loop keeps serving; or with a host strategy, ``fixed`` or ``cdc``,
or through a sidecar process, ``NodeConfig.sidecar_port``), places every
distinct chunk on its ring owners — local puts and concurrent replication
with a hash echo per slice —, falls back to sloppy-quorum handoff when
an owner is down, fails below ``write_quorum`` copies, and acks by saving
the manifest (fsync'd) and announcing it to every peer. An erasure-coded
upload (``ec_k``) stores one copy of every chunk plus P+Q parity per
stripe of k chunks, encoded on the fragmenter's device or, with a host
strategy or a sidecar, the node's (:mod:`dfs_tpu_torch.ops.ec`), each
shard of a stripe pinned to its own node. A download gathers chunks
locally and in batches from their owners (an EC shard's stripe holder),
verifies every chunk and the whole file, and streams them out; an EC shard
that no node serves is decoded from its stripe. Repair re-replicates,
regenerates this node's lost EC shards by decode, moves handoff copies
home and converges deletes and creates by anti-entropy; scrub re-hashes
the local store.

With ``NodeConfig.sim.enabled`` (``serve --sim``) the similarity plane
(:mod:`dfs_tpu_torch.sim`) sketches every new stored chunk on the node's
device and the CAS may store it as a delta against a similar resident
base; a delta's base is pinned against ``delete_chunks``, relocation and
GC, and scrub queues a missing base for repair.

The serving tier (:mod:`dfs_tpu_torch.serve`, ``NodeConfig.serve``) is
wired where dfs_tpu wires it: the hot-chunk cache and per-digest
single-flight in front of the verified gather (``_fetch_verified``),
readahead of streamed downloads, admission gates on the HTTP routes and on
the bulk internal ops, end-to-end deadlines (``X-Dfs-Deadline``, the wire's
``deadline`` field, dropped at dispatch and before a read), hedged reads
(``_fetch_chunk``, the batched gather) and hedged replication stores. The
default ``ServeConfig()`` builds no cache, gate or hedge policy and runs
the paths as they are without the tier.

With ``NodeConfig.index.enabled`` (``serve --index``) the dedup/index
plane (:mod:`dfs_tpu_torch.index`) is wired where dfs_tpu wires it: the
digest LSI behind the CAS's ``has`` and its put/delete feed, opened (or
rebuilt from the CAS walk) before the listeners; the peer-existence
filters gossiped every ``filter_sync_s`` (``get_filter`` /
``filter_delta`` / ``get_filters``); placement that skips what a peer's
filter rules out or vouches for, every filter-credited copy confirmed by
one ``has_chunks`` round per peer before the manifest acks; repair's
filter-trimmed probe; and scrub healing the index against the CAS walk in
both directions. The LSI journals ``index_rebuild`` / ``index_compact``
through ``lsi.on_event``.

With ``NodeConfig.tier.enabled`` (``serve --tier``) the tiering plane
(:mod:`dfs_tpu_torch.tier`) keeps a temperature ledger fed by every read
(the verified gather and the ``get_chunk(s)`` ops), and a scan
(``POST /tier`` or every ``scan_interval_s``) demotes the cold tail to
P+Q EC stripes encoded on the node's device, flips the manifest and the
index tier bit, and reclaims the surplus replicas through
``delete_chunks``; a cold file read past ``promote_reads`` is
re-materialized replicated in the background and its parity reclaimed.

The observability core (:mod:`dfs_tpu_torch.obs`, ``NodeConfig.obs``) is
built first and on by default, as in dfs_tpu: every HTTP request is an
``http.<route>`` span, every storage-plane call an ``rpc.<op>`` span whose
context rides the wire's ``trace`` field into the peer's ``peer.<op>``
span, and the phases of an upload (``upload.hash_file``,
``upload.fragment`` — where the card chunks —, ``upload.replicate``,
``upload.handoff``, ``upload.ec_encode``, ``upload.verify_trusted``) and a
read (``download.gather``, ``serve.flight.wait``, ``cas.*``) are spans
under it. Spans sit in a bounded ring (``get_trace`` and ``GET /trace``
stitch them across nodes), lifecycle events go to the flight-recorder
journal under ``<data root>/node-<id>/journal/`` (``GET /events``), and
the sentinel samples event-loop lag, the CAS backlog and credit stalls.

With ``NodeConfig.chaos.enabled`` (``serve --chaos``) the fault injector
(:mod:`dfs_tpu_torch.chaos`) is wired where dfs_tpu wires it: peer faults
in the RPC client, a slow node in ``_serve_internal_frame``, disk faults
in the ChunkStore hook, and SIGKILL at the 11 crash points
(``place.*`` in ``_place_batch``, ``upload.*`` in ``_finalize_upload``,
``demote.*`` in the demotion, ``sim.*`` in the similarity plane).

The elastic ring (:mod:`dfs_tpu_torch.ring`, ``NodeConfig.ring``) is
wired where dfs_tpu wires it: the :class:`RingManager` holds the current
and previous map, persists them to ``<data root>/node-<id>/ring.json`` and
kicks a rebalance walk on every install; ``ring_admin`` (``POST /ring``)
adds, drains, removes or reweights a member and pushes the new epoch to
every peer with ``propose_ring``; a restarted node catches up with one
``get_ring`` round. Placement uses the current epoch; reads walk the
current owners, then the previous ones (the dual-read window, counted as
``dualReadHits``), and EC reads add the previous stripe holders. The repair
walk is the rebalancer: one designated mover per digest (the first alive
previous-epoch holder) pushes under the ring's byte credits, the joiner's
pulls are metered the same way, and the window closes
(``finish_migration``) only after a walk that confirmed every
current-epoch owner of every digest at an unchanged map pair. The
tiering plane and ``delete_chunks`` stand still while the ring migrates.

The census plane (:mod:`dfs_tpu_torch.obs.census`, ``NodeConfig.census``)
answers ``GET /census``: every peer's bucketed CAS inventory
(``get_census``), compared with the expectation from this node's
manifests and ring, mismatched buckets drilled down. The history sampler
(:mod:`dfs_tpu_torch.obs.history`) feeds ``GET /metrics/history`` and the
doctor's trend rule, and journals ``disk_pressure`` when free space
crosses 5%. ``GET /doctor`` fans out ``get_doctor`` snapshots and runs
dfs_tpu's fifteen rules (:mod:`dfs_tpu_torch.obs.doctor`).

Resumable uploads and the smart client (:mod:`dfs_tpu_torch.client`) use
four more entry points: ``missing_digests`` (``POST /missing``),
``upload_resume`` (a client's chunk table plus only the missing payloads),
``commit_manifest`` (the single-hop commit: durable copies re-counted at
write quorum, below-quorum chunks healed, absent ones answered 409) and
``dataplane_info`` (``GET /dataplane``: ring, peers, rf and the chunking
description).
"""

from __future__ import annotations

import asyncio
import contextlib
import errno
import math
import queue as _queue
import threading
import time
import types
from collections import deque
from typing import Mapping, Sequence

import numpy as np

from dfs_tpu_torch import resolve_device
from dfs_tpu_torch.api.http import make_http_handler
from dfs_tpu_torch.comm.rpc import (DeadlineExpired, InternalClient,
                                    RpcError, RpcRemoteError,
                                    RpcUnreachable)
from dfs_tpu_torch.comm.wire import (FrameServerProtocol, WireError,
                                     encode_frame, pack_chunks, unpack_chunks)
from dfs_tpu_torch.config import NodeConfig
from dfs_tpu_torch.fragmenter.base import get_fragmenter
from dfs_tpu_torch.meta.manifest import (ChunkRef, EcInfo, Manifest,
                                         StripeRef, ec_stripe_groups,
                                         stripe_shard_len)
from dfs_tpu_torch.ops import ec as ec_ops
from dfs_tpu_torch.node.health import HealthMonitor
from dfs_tpu_torch.obs import Observability, Span, parse_wire_trace
from dfs_tpu_torch.ring import RingMap
from dfs_tpu_torch.ring.manager import RingManager
from dfs_tpu_torch.serve import BatchPrefetcher, ServingTier
from dfs_tpu_torch.store.aio import AsyncChunkStore
from dfs_tpu_torch.store.cas import NodeStore
from dfs_tpu_torch.utils import deadline
from dfs_tpu_torch.utils.aio import create_logged_task, gather_abort_siblings
from dfs_tpu_torch.utils.hashing import (is_hex_digest, sha256_hex,
                                         sha256_many_hex, sha256_new)
from dfs_tpu_torch.utils.logging import Counters, Stopwatches, get_logger
from dfs_tpu_torch.utils.trace import LatencyRecorder

# the internal-plane ops this node serves; any other answers "unknown op"
_OPS = frozenset({"store_chunks", "has_chunks", "announce", "tombstones",
                  "list_manifests", "get_chunk", "get_chunks",
                  "get_manifest", "delete", "delete_chunks", "health",
                  "get_filter", "filter_delta", "get_filters",
                  "get_trace", "get_ring", "propose_ring", "get_census",
                  "get_doctor"})
# the bulk ops: the internal admission gate bounds these only, so a health
# probe never queues behind transfers and makes a busy node look dead
_HEAVY_OPS = frozenset({"store_chunks", "get_chunk", "get_chunks"})


class UploadError(RuntimeError):
    """An upload that cannot be acknowledged; ``status`` is the HTTP
    answer (500 below quorum, 400 for a bad request, 507 on ENOSPC)."""

    def __init__(self, msg: str, status: int = 500) -> None:
        super().__init__(msg)
        self.status = status


class NotFoundError(KeyError):
    """No manifest for the file id anywhere reachable (or tombstoned)."""


class DownloadError(RuntimeError):
    pass


class DeadlineExceeded(DownloadError):
    """The caller's end-to-end deadline expired during a read: HTTP 503 +
    Retry-After, never a 500 (the cluster is healthy, the budget is not),
    and the fetch walks stop instead of touring every candidate."""


class RangeNotSatisfiable(DownloadError):
    """The requested byte range lies past the end of the file."""

    def __init__(self, size: int) -> None:
        super().__init__(f"range not satisfiable (size {size})")
        self.size = size


def ec_placement_map(manifest: Manifest, ring
                     ) -> Mapping[str, tuple[int, ...]]:
    """digest -> holder nodes of every shard (data and parity) of an
    erasure-coded manifest, from the manifest and the ring alone, so any
    node locates any shard. ``ring`` is a :class:`RingMap` or a list of
    node ids (the static map over them). A digest in several stripes
    (dedup within the file) gets the union of its slots' holders. Cached
    per (layout fingerprint, ring): a degraded read asks twice."""
    if not isinstance(ring, RingMap):
        ring = RingMap.static(list(ring))
    ec = manifest.ec
    assert ec is not None
    key = (manifest.file_id, ec.k, len(manifest.chunks), len(ec.stripes),
           ec.stripes[0].p if ec.stripes else "",
           ec.stripes[-1].q if ec.stripes else "", ring.key)
    hit = _EC_PLACEMENT_CACHE.get(key)
    if hit is None:
        hit = _ec_placement_build(manifest, ring)
        if len(_EC_PLACEMENT_CACHE) >= 64:
            _EC_PLACEMENT_CACHE.pop(next(iter(_EC_PLACEMENT_CACHE)))
        _EC_PLACEMENT_CACHE[key] = hit
    return hit


_EC_PLACEMENT_CACHE: dict = {}


def _ec_placement_build(manifest: Manifest, ring: RingMap
                        ) -> Mapping[str, tuple[int, ...]]:
    ec = manifest.ec
    assert ec is not None
    pl: dict[str, list[int]] = {}
    groups = ec_stripe_groups(manifest.chunks, ec.k)
    for s, (st, grp) in enumerate(zip(ec.stripes, groups)):
        # one ring walk per stripe: the k data holders, then P and Q
        holders = ring.ec_stripe_nodes(manifest.file_id, s, len(grp) + 2)
        for j, c in enumerate(grp):
            pl.setdefault(c.digest, []).append(holders[j])
        pl.setdefault(st.p, []).append(holders[len(grp)])
        pl.setdefault(st.q, []).append(holders[len(grp) + 1])
    # read-only: the cached map is shared by every reader
    return types.MappingProxyType(
        {d: tuple(dict.fromkeys(v)) for d, v in pl.items()})


def ec_shard_items(manifest: Manifest) -> list[tuple[str, int]]:
    """(digest, byte length) of every shard of an EC manifest: data
    chunks at their length, parity at the stripe's padded shard length."""
    ec = manifest.ec
    assert ec is not None
    out = [(c.digest, c.length) for c in manifest.chunks]
    for st in ec.stripes:
        out.append((st.p, st.shard_len))
        out.append((st.q, st.shard_len))
    return out


class ByteBudget:
    """Counting byte semaphore between the fragmenter thread and the
    placement loop of a streaming upload: the fragmenter blocks once
    ``budget`` bytes of produced chunks are unconsumed. One chunk larger
    than the whole budget is admitted when nothing else is outstanding."""

    def __init__(self, budget: int) -> None:
        self.budget = max(1, int(budget))
        self._out = 0
        self._cv = threading.Condition()

    def acquire(self, n: int, timeout: float | None = None) -> bool:
        with self._cv:
            ok = self._cv.wait_for(
                lambda: self._out + n <= self.budget or self._out == 0,
                timeout)
            if ok:
                self._out += n
            return ok

    def release(self, n: int) -> None:
        with self._cv:
            self._out = max(0, self._out - n)
            self._cv.notify_all()

    @property
    def outstanding(self) -> int:
        with self._cv:
            return self._out


class _TrustLedger:
    """Filter-credited replica copies awaiting pre-ack verification, as
    dfs_tpu's. When placement trusts a peer-filter positive (skipping the
    ``has_chunks`` probe and the transfer), the copy it credits is a bloom
    "maybe": every trusted (peer, digest, length) lands here, and
    :meth:`StorageNodeServer._verify_trusted` confirms the ledger with one
    ``has_chunks`` round per peer before the manifest write acks the
    upload — a false positive delays an ack, never weakens one."""

    def __init__(self) -> None:
        self.by_peer: dict[int, dict[str, int]] = {}

    def credit(self, peer: int, digest: str, length: int) -> None:
        self.by_peer.setdefault(peer, {})[digest] = length

    def __bool__(self) -> bool:
        return bool(self.by_peer)


def _config_fingerprint(cfg: NodeConfig) -> str:
    """sha256 over the config surface a healthy cluster shares (node-local
    identity excluded), journaled in the ``boot`` event."""
    import dataclasses as _dc
    import json as _json

    d = _dc.asdict(cfg)
    for local in ("node_id", "data_root", "device", "sidecar_port"):
        d.pop(local, None)
    return sha256_hex(_json.dumps(d, sort_keys=True, default=str).encode())


class StorageNodeServer:
    # per-RPC payload cap of replication slices, and the batch size of
    # streamed reads and repair fetches (class-level so tests can scale)
    _REPLICA_SLICE_BYTES = 8 * 1024 * 1024
    _FETCH_BATCH_BYTES = 32 * 1024 * 1024

    def __init__(self, cfg: NodeConfig) -> None:
        self.cfg = cfg
        self.log = get_logger("node", cfg.node_id)
        # the device and the fragmenter first: without the card (and
        # without device="cpu") the node raises here, before it touches
        # the disk. The device encodes EC and sketches whatever chunks:
        # the anchored chain on it, a host strategy (fixed, cdc) or a
        # sidecar process (sidecar_port, which overrides `fragmenter`)
        self.device = resolve_device(cfg.device)
        if cfg.sidecar_port:
            from dfs_tpu_torch.sidecar.service import SidecarFragmenter

            self.fragmenter = SidecarFragmenter(cfg.sidecar_port)
        else:
            self.fragmenter = get_fragmenter(
                cfg.fragmenter, cdc_params=cfg.cdc, frag=cfg.frag,
                device=cfg.device, fixed_parts=cfg.fixed_parts)
        self.store = NodeStore(cfg.data_root, cfg.node_id,
                               fsync=cfg.durability.fsync)
        self.counters = Counters()
        self.latency = LatencyRecorder()
        # the flight recorder under the node's data root, built before
        # the Observability hub so every subsystem's obs.event() lands in
        # it; None with journal_bytes == 0
        journal = None
        if cfg.obs.journal_bytes > 0:
            from dfs_tpu_torch.obs.journal import Journal

            journal = Journal(self.store.root / "journal", cfg.node_id,
                              total_bytes=cfg.obs.journal_bytes,
                              segment_bytes=cfg.obs.journal_segment_bytes)
        # observability first: the client, the CAS tier, the serving tier
        # and the planes take it as their tracing and journal hook
        self.obs = Observability(cfg.obs, cfg.node_id,
                                 latency=self.latency, journal=journal)
        self._config_hash = _config_fingerprint(cfg)
        self._started_at = time.time()
        # fault injection: None unless ChaosConfig.enabled, built right
        # after obs so injected faults journal trace-stamped; disk faults
        # ride the ChunkStore hook on the CAS worker threads
        self.chaos = None
        if cfg.chaos.enabled:
            from dfs_tpu_torch.chaos import ChaosInjector

            self.chaos = ChaosInjector(cfg.chaos, cfg.node_id, obs=self.obs)
            self.store.chunks.fault = self.chaos.store_hook()
        # the similarity plane: None unless SimConfig.enabled, so the
        # default node's CAS paths stay as they are; its sim.* crash
        # points fire through the injector
        self.sim = None
        if cfg.sim.enabled:
            from dfs_tpu_torch.sim import SimPlane

            self.sim = SimPlane(cfg.sim, self.store.root / "sim",
                                device=self._ec_device())
            if self.chaos is not None:
                self.sim.crash = self.chaos.maybe_crash
            self.store.chunks.sim = self.sim
        # the dedup/index plane: None unless IndexConfig.enabled, so the
        # default node's existence checks stay one stat per digest. Opened
        # in start(), before the listeners. (DigestIndex.hook stays
        # unwired, as in dfs_tpu: no crash point lives there.)
        self.index = None
        self._filter_sync_task: asyncio.Task | None = None
        if cfg.index.enabled:
            from dfs_tpu_torch.index import IndexPlane

            self.index = IndexPlane(cfg.index, self.store.root)
            self.index.lsi.on_event = self.obs.event
            # the ChunkStore seam: every put/delete feeds the LSI from the
            # CAS worker threads; has() answers from it first
            self.store.chunks.index = self.index
        self.ingest_stalls = Stopwatches()
        # the elastic ring: built after obs (epoch changes journal) and
        # before the client (placement-bearing RPCs carry the epoch); the
        # default config compiles the static epoch-0 ring
        self.ring = RingManager(cfg, self.store.root, obs=self.obs)
        self.ring.on_change = self._on_ring_change
        # rebalance kicks and the boot catch-up: owned here, so stop()
        # cancels and awaits them
        self._ring_tasks: set[asyncio.Task] = set()
        self.cas = AsyncChunkStore(self.store.chunks,
                                   workers=cfg.ingest.cas_io_threads,
                                   obs=self.obs)
        self._STREAM_FLUSH_BYTES = cfg.ingest.flush_bytes
        self.client = InternalClient(cfg.connect_timeout_s,
                                     cfg.request_timeout_s, cfg.retries,
                                     coalesce_fetches=cfg.serve.cache_bytes
                                     > 0, ring=self.ring, obs=self.obs,
                                     chaos=self.chaos)
        self.health = HealthMonitor(cfg.cluster, cfg.node_id, self.client,
                                    probe_interval_s=cfg.health_probe_s,
                                    obs=self.obs)
        # the stall sentinel: loop lag, CAS backlog and credit stalls,
        # journaled as incidents; None when sampled off
        self.sentinel = None
        if cfg.obs.sentinel_interval_s > 0:
            from dfs_tpu_torch.obs.sentinel import Sentinel

            self.sentinel = Sentinel(self.obs, cas=self.cas,
                                     stalls=self.ingest_stalls,
                                     interval_s=cfg.obs.sentinel_interval_s,
                                     lag_s=cfg.obs.sentinel_lag_s)
            self.obs.sentinel = self.sentinel
        # the serving tier: with ServeConfig() every component is off
        self.serve = ServingTier(cfg.serve, obs=self.obs)
        # the hot/cold tiering plane: None unless TierConfig.enabled, so
        # the default node never touches a ledger and never scans
        self.tier = None
        self._tier_task: asyncio.Task | None = None
        self._tier_promoting: set[str] = set()   # file ids mid-promotion
        # cold files whose surplus replicas are confirmed reclaimed, keyed
        # to the ring epoch of the confirmation
        self._tier_surplus_done: dict[str, int] = {}
        # strong refs of background promotions (the loop keeps weak ones)
        self._tier_tasks: set[asyncio.Task] = set()
        if cfg.tier.enabled:
            from dfs_tpu_torch.tier import TierPlane

            self.tier = TierPlane(cfg.tier, self.store.root / "tier",
                                  obs=self.obs)
        # the census plane's history sampler: None with
        # history_interval_s == 0 (census queries still answer)
        self.history = None
        if cfg.census.history_interval_s > 0:
            from dfs_tpu_torch.obs.history import MetricsHistory

            self.history = MetricsHistory(
                cfg.census.history_interval_s, cfg.census.history_slots,
                cfg.census.history_coarse_every,
                cfg.census.history_coarse_slots)
        self._history_task: asyncio.Task | None = None
        # the last census this node coordinated (doctor material)
        self._last_census: dict | None = None
        self._disk_pressure = False
        self._repair_lock = asyncio.Lock()
        self.under_replicated: set[str] = set()  # digests needing repair
        self._ec_encode_device: str | None = None  # where EC last encoded
        self._internal_server: asyncio.AbstractServer | None = None
        self._http_server: asyncio.AbstractServer | None = None
        self._inbound: set[FrameServerProtocol] = set()

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #

    async def start(self) -> None:
        addr = self.cfg.self_addr
        if self.index is not None:
            # opened (or rebuilt from the CAS walk) before the boot sweep
            # and the listeners: the sweep's orphan GC feeds deletes
            # through the ChunkStore seam, and deletes noted into an
            # unopened index would be overwritten by the WAL replay
            info = await asyncio.to_thread(self.index.open_or_rebuild,
                                           self.store.chunks.digests)
            if info["rebuilt"]:
                self.log.warning("digest index rebuilt from CAS walk "
                                 "(%d entries): %s", info["entries"],
                                 info["reason"])
        # crash recovery before anything can be in flight
        swept = await asyncio.to_thread(self.store.boot_sweep)
        # journaled on every boot, zeros included: after a crash the
        # journal then says what recovery found, even when it was nothing
        self.obs.event("boot_sweep", **swept)
        if swept["tmps"] or swept["orphans"]:
            self.log.info("boot sweep: %d temp(s), %d aged orphan(s)",
                          swept["tmps"], swept["orphans"])
        loop = asyncio.get_running_loop()
        self._internal_server = await loop.create_server(
            lambda: FrameServerProtocol(self._serve_internal_frame,
                                        on_connect=self._inbound.add,
                                        on_close=self._inbound.discard),
            addr.host, addr.internal_port)
        self._http_server = await asyncio.start_server(
            make_http_handler(self), addr.host, addr.port)
        if self.cfg.health_probe_s > 0:
            self.health.start()
        if self.sentinel is not None:
            self.sentinel.start()
        if self.history is not None:
            self._history_task = create_logged_task(
                self._history_loop(), self.log, "census-history")
        if self._peers():
            # a (re)started node may have slept through epoch bumps: one
            # get_ring round adopts the highest epoch any peer holds (the
            # epoch carried on placement RPCs is the backstop)
            self._spawn_ring_task(self._ring_catchup(), "ring-catchup")
        if self.tier is not None and self.cfg.tier.scan_interval_s > 0:
            # the demotion worker (scan_interval_s == 0: POST /tier only)
            self._tier_task = create_logged_task(
                self._tier_loop(), self.log, "tier-scan")
        if self.index is not None \
                and self.index.local_filter is not None \
                and self.cfg.index.filter_sync_s > 0 and self._peers():
            # peer-existence filter gossip on the configured cadence
            self._filter_sync_task = create_logged_task(
                self._filter_sync_loop(), self.log, "filter-sync")
        # the flight recorder's first question: what config this life ran
        self.obs.event("boot", configHash=self._config_hash,
                       http=addr.port, internal=addr.internal_port,
                       fragmenter=self.fragmenter.name)
        self.log.info("node %d up: http=%d internal=%d fragmenter=%s on %s",
                      self.cfg.node_id, addr.port, addr.internal_port,
                      self.fragmenter.name, self.frag_stats()["device"])

    async def stop(self) -> None:
        owned = [t for t in (self._filter_sync_task, self._tier_task,
                             self._history_task, *self._tier_tasks,
                             *self._ring_tasks) if t is not None]
        for task in owned:
            task.cancel()
        self._filter_sync_task = self._tier_task = None
        self._history_task = None
        # awaited: no walk or sampler outlives the node
        await asyncio.gather(*owned, return_exceptions=True)
        if self.tier is not None:
            # parting ledger snapshot, best-effort: losing it only
            # under-counts heat
            with contextlib.suppress(OSError):
                await asyncio.to_thread(self.tier.snapshot_ledger)
        self.health.stop()
        if self.sentinel is not None:
            self.sentinel.stop()
        self.client.close()
        self.cas.close()
        if self.sim is not None:
            # band-log close + dir fsync, off the loop
            await asyncio.to_thread(self.sim.close)
        if self.index is not None:
            # WAL buffer flush + run fds closed, off the loop; CAS jobs
            # racing the close lose only buffered put records (the safe
            # direction)
            await asyncio.to_thread(self.index.close)
        # peers keep pooled connections into this node open; close them
        # or wait_closed() waits on a peer that has not spoken lately. The
        # listeners close first; a connection accepted just before (a
        # peer's boot catch-up) registers a moment later, so the inbound
        # set is closed again until the servers are done
        servers = [srv for srv in (self._internal_server, self._http_server)
                   if srv is not None]
        for srv in servers:
            srv.close()
        while True:
            for conn in list(self._inbound):
                conn.close()
            try:
                await asyncio.wait_for(asyncio.gather(
                    *(srv.wait_closed() for srv in servers)), 0.5)
                break
            except asyncio.TimeoutError:
                continue
        if self.obs.journal is not None:
            # last: the teardown above may still emit; close() drains the
            # queue and joins the writer thread, off the loop
            await asyncio.to_thread(self.obs.journal.close)

    def _peers(self) -> list:
        return [p for p in self.cfg.cluster.peers
                if p.node_id != self.cfg.node_id]

    # ------------------------------------------------------------------ #
    # membership plane
    # ------------------------------------------------------------------ #

    def _spawn_ring_task(self, coro, name: str) -> None:
        task = create_logged_task(coro, self.log, name)
        self._ring_tasks.add(task)
        task.add_done_callback(self._ring_tasks.discard)

    def _on_ring_change(self) -> None:
        """RingManager install hook: kick a rebalance walk at once (the
        repair walk is the rebalancer) instead of waiting for the next
        periodic repair."""
        try:
            asyncio.get_running_loop()
        except RuntimeError:
            return      # installed at boot, before start(): repair runs it
        self._spawn_ring_task(self._rebalance_kick(), "rebalance-kick")

    async def _rebalance_kick(self) -> None:
        # the kick may be spawned inside a deadlined RPC's dispatch (an
        # epoch adopted off a placement-bearing call): the walk must not
        # inherit that request's budget
        deadline.clear()
        try:
            await self.repair_once()
        except Exception as e:  # noqa: BLE001 — the next repair retries
            self.log.warning("rebalance kick failed: %s", e)

    async def _ring_catchup(self) -> None:
        """Boot catch-up: adopt the highest epoch any peer holds."""
        best: dict | None = None
        for peer in self._peers():
            try:
                resp, _ = await self.client.call(
                    peer, {"op": "get_ring"}, retries=1)
            except RpcError:
                continue    # best-effort: epoch gossip converges the rest
            ring = resp.get("ring")
            if isinstance(ring, dict) \
                    and isinstance(ring.get("epoch"), int) \
                    and ring["epoch"] > self.ring.epoch \
                    and (best is None or ring["epoch"] > best["epoch"]):
                best = ring
        if best is not None:
            try:
                self.ring.adopt(best, source="catchup")
            except ValueError as e:
                self.log.warning("ring catch-up rejected peer map: %s", e)

    async def ring_admin(self, action: str, node_id: int | None = None,
                         weight: float | None = None) -> dict:
        """Admin membership change (``POST /ring``): build the epoch+1 map,
        install it here, push it to every peer (best-effort: a peer that
        misses it converges through the epoch on placement RPCs), and
        answer the new map with the per-peer push results. A bad request
        raises ValueError with dfs_tpu's text."""
        cur = self.ring.current
        weights = {m.node_id: m.weight for m in cur.members}
        if action == "add":
            if node_id is None:
                raise ValueError("add needs nodeId")
            if node_id not in {p.node_id for p in self.cfg.cluster.peers}:
                raise ValueError(
                    f"node {node_id} is not in the cluster address "
                    "book (boot every process with it in --nodes/"
                    "--cluster-config first)")
            if weights.get(node_id, 0) > 0:
                raise ValueError(f"node {node_id} is already a ring "
                                 "member")
            if weight is None:
                # the joiner's disk headroom against the median member's
                weight = await self._derive_add_weight(
                    node_id, [m for m, w in weights.items() if w > 0])
            weights[node_id] = float(weight)
        elif action == "drain":
            if node_id is None or node_id not in weights:
                raise ValueError(f"node {node_id} is not a ring member")
            weights[node_id] = 0.0
        elif action == "remove":
            if node_id is None or node_id not in weights:
                raise ValueError(f"node {node_id} is not a ring member")
            del weights[node_id]
            if not weights:
                raise ValueError("cannot remove the last ring member")
        elif action == "reweight":
            if node_id is None or node_id not in weights:
                raise ValueError(f"node {node_id} is not a ring member")
            if weight is None:
                raise ValueError("reweight needs weight")
            weights[node_id] = float(weight)
        else:
            raise ValueError(f"unknown ring action {action!r} "
                             "(add/drain/remove/reweight)")
        if not any(w > 0 for w in weights.values()):
            raise ValueError("change would leave no active member")
        new = self.ring.propose_next(weights)
        self.ring.install(new, source=f"admin:{action}")
        ring_dict = new.to_dict()

        async def push(peer) -> tuple[int, bool]:
            try:
                await self.client.call(
                    peer, {"op": "propose_ring", "ring": ring_dict},
                    retries=2)
                return peer.node_id, True
            except RpcError:
                return peer.node_id, False   # reported per peer

        pushed = dict(await asyncio.gather(
            *(push(p) for p in self._peers())))
        return {"action": action, "epoch": new.epoch,
                "ring": ring_dict, "pushed": pushed}

    _ADD_WEIGHT_MIN = 0.25    # capacity-derived weight clamp: a tiny disk
    _ADD_WEIGHT_MAX = 4.0     # still takes some share, a huge one never
                              # dominates the map on day one

    async def _derive_add_weight(self, node_id: int,
                                 members: list[int]) -> float:
        """Default weight of ``ring add``: the joiner's free disk bytes
        over the median active member's, clamped to [0.25, 4.0]. Free
        bytes come from the census ``disk`` block (``get_census``; this
        node's own statvfs). Any failure falls back to 1.0."""
        async def free_bytes(nid: int) -> float | None:
            try:
                if nid == self.cfg.node_id:
                    disk = await asyncio.to_thread(self._disk_usage)
                else:
                    resp, _ = await self.client.call(
                        self.cfg.cluster.peer(nid),
                        {"op": "get_census"}, retries=1)
                    disk = (resp.get("census") or {}).get("disk") or {}
                free = disk.get("freeBytes")
                return float(free) if isinstance(free, (int, float)) \
                    and free > 0 else None
            except (RpcError, KeyError):
                return None       # degrades to the 1.0 fallback

        target = await free_bytes(node_id)
        if target is None:
            return 1.0
        frees = [f for f in await asyncio.gather(
            *(free_bytes(m) for m in members)) if f is not None]
        if not frees:
            return 1.0
        frees.sort()
        median = frees[len(frees) // 2]
        if median <= 0:
            return 1.0
        w = max(self._ADD_WEIGHT_MIN,
                min(self._ADD_WEIGHT_MAX, target / median))
        return round(w, 3)

    async def ring_status(self, cluster: bool = True) -> dict:
        """``GET /ring``: this node's membership view and (``cluster``)
        every peer's epoch and migration state, partial on dead peers."""
        out = {"nodeId": self.cfg.node_id,
               "epoch": self.ring.epoch,
               "mode": "static" if self.ring.current.vnodes == 0
               else "hash",
               "vnodes": self.ring.current.vnodes,
               "members": self.ring.current.to_dict()["members"],
               "active": self.ring.current.active_ids(),
               "migrating": self.ring.migrating,
               "previousEpoch": self.ring.previous.epoch
               if self.ring.previous is not None else None,
               "rebalance": self.ring.rebalance_stats()}
        if not cluster:
            return out

        async def one(peer) -> tuple[int, dict | None]:
            try:
                resp, _ = await self.client.call(
                    peer, {"op": "get_ring"}, retries=1)
                ring = resp.get("ring") or {}
                return peer.node_id, {
                    "epoch": ring.get("epoch"),
                    "migrating": bool(resp.get("migrating"))}
            except RpcError:
                return peer.node_id, None   # the partial-result signal

        peers = dict(await asyncio.gather(
            *(one(p) for p in self._peers())))
        out["peers"] = {str(k): v for k, v in sorted(peers.items())}
        out["peersFailed"] = sum(1 for v in peers.values() if v is None)
        return out

    def ring_stats(self) -> dict:
        """``/metrics`` ``ring``: the RingConfig fields, then the live
        epoch and rebalance state, as dfs_tpu's."""
        r = self.cfg.ring
        return {"vnodes": r.vnodes,
                "members": r.members,
                "rebalanceCreditBytes": r.rebalance_credit_bytes,
                "epoch": self.ring.epoch,
                "mode": "static" if self.ring.current.vnodes == 0
                else "hash",
                "active": self.ring.current.active_ids(),
                "rebalance": self.ring.rebalance_stats()}

    # ------------------------------------------------------------------ #
    # dedup/index plane: filter gossip
    # ------------------------------------------------------------------ #

    async def _filter_sync_loop(self) -> None:
        """Replicate every peer's existence filter every
        ``IndexConfig.filter_sync_s``; the first round runs at once."""
        interval = self.cfg.index.filter_sync_s
        while True:
            try:
                await self._filter_sync_once()
            except Exception as e:  # noqa: BLE001 — the next tick retries
                self.log.warning("filter sync failed: %s", e)
            await asyncio.sleep(interval)

    async def _filter_sync_once(self) -> int:
        """One gossip round: per peer a ``filter_delta`` from the replica's
        (generation, version) cursor, or a full ``get_filter`` when there
        is no replica yet, the generation moved or the delta is unusable
        (never a poisoned replica). Returns the peers synced."""
        plane = self.index
        if plane is None or plane.local_filter is None:
            return 0
        synced = 0
        for peer in self._peers():
            st = plane.peer_filters.state(peer.node_id)
            try:
                if st is None:
                    ok = await self._filter_fetch_full(peer)
                else:
                    resp = await self.client.filter_delta(
                        peer, st["gen"], st["version"], retries=1)
                    gen, version = resp.get("gen"), resp.get("version")
                    ok = (not resp.get("resync")
                          and isinstance(gen, int)
                          and isinstance(version, int)
                          and plane.peer_filters.apply_delta(
                              peer.node_id, gen, version,
                              resp.get("adds")))
                    if not ok:
                        ok = await self._filter_fetch_full(peer)
                if ok:
                    synced += 1
            except RpcRemoteError:
                # a live peer without the filter plane: nothing to sync,
                # its probes simply stay untrimmed
                continue
            except RpcError:
                self.counters.inc("filter_sync_failures")
        return synced

    async def _filter_fetch_full(self, peer) -> bool:
        """Full filter resync from one peer; False when the peer runs no
        filter plane or sent garbage."""
        meta, body = await self.client.get_filter(peer, retries=1)
        if meta is None:
            return False
        try:
            # a copy: the replica outlives the reply frame
            self.index.peer_filters.apply_full(peer.node_id, meta,
                                               bytes(body))
        except (KeyError, TypeError, ValueError):
            self.counters.inc("filter_sync_failures")
            return False
        self.obs.event("filter_resync", peer=peer.node_id,
                       gen=meta.get("gen"), bytes=len(body))
        return True

    def index_stats(self) -> dict:
        """``/metrics`` ``index``: the IndexConfig fields, and the live
        plane (LSI gauges, filter bytes, probe-skip counters) with it."""
        c = self.cfg.index
        out = {"enabled": c.enabled,
               "memtableEntries": c.memtable_entries,
               "compactRuns": c.compact_runs,
               "filterBitsPerKey": c.filter_bits_per_key,
               "filterSyncS": c.filter_sync_s,
               "backgroundCompact": c.background_compact,
               "echoCacheEntries": c.echo_cache_entries}
        if self.index is not None:
            out.update(self.index.stats())
        return out

    # ------------------------------------------------------------------ #
    # internal storage plane (server side)
    # ------------------------------------------------------------------ #

    async def _serve_internal_frame(self, conn, header: dict,
                                    body: memoryview, nbytes_in: int) -> None:
        """Serve one inbound frame; ``body`` is a read-only view of its
        receive buffer. An op error becomes an error reply. The op is a
        ``peer.<op>`` server span, parented by the wire's optional
        ``trace`` field (the caller's ``rpc.<op>`` span); an untraced
        frame roots a fresh trace for the bulk ops only, so health probes
        never fill the ring. Its time also goes to ``/metrics`` latency
        as ``peer.<op>``, and to the server RPC table by sender."""
        op = header.get("op")
        name = f"peer.{op}" if op in _OPS else "peer.other"
        tr = parse_wire_trace(header.get("trace"))
        # the sender's remaining budget (the optional wire field) starts
        # this hop's own countdown; absent = no deadline
        budget = deadline.parse_wire(header.get("deadline"))
        dl_token = deadline.activate(budget) if budget is not None \
            else None
        t0 = time.perf_counter()
        try:
            with (self.obs.server_span(name, tr)
                  if tr is not None or op in _HEAVY_OPS
                  else contextlib.nullcontext(Span())) as sp:
                sp.bytes = nbytes_in
                try:
                    if self.chaos is not None:
                        # a slow node (chaos serve_delay): inside the span,
                        # before the gate, so probes feel it too
                        await self.chaos.before_serve(str(op))
                    gate = self.serve.admission.internal
                    if gate.enabled and op in _HEAVY_OPS:
                        # a shed op reaches the peer as an error reply
                        async with gate.slot():
                            resp, rbody = await self._dispatch(header,
                                                               body)
                    else:
                        resp, rbody = await self._dispatch(header, body)
                except Exception as e:  # noqa: BLE001 — answered to the peer
                    sp.err = type(e).__name__
                    resp, rbody = {"ok": False, "error": str(e)}, b""
                # encoded inside the span: its bytes are the frame totals
                head, bufs, nbytes_out = encode_frame(resp, rbody)
                sp.bytes = nbytes_in + nbytes_out
        finally:
            if dl_token is not None:
                deadline.restore(dl_token)
        dt = time.perf_counter() - t0
        self.latency.record(name, dt)
        self.obs.rpc_server.record(
            tr[2] if tr is not None and tr[2] is not None else "-",
            str(op), dt, bytes_out=nbytes_out, bytes_in=nbytes_in,
            error=not resp.get("ok", False))
        try:
            conn.send_encoded(head, bufs)
            await conn.drain()
        except (ConnectionError, OSError, WireError):
            self.counters.inc("peer_reply_aborted")
            conn.close()

    async def _dispatch(self, header: dict, body) -> tuple[dict, object]:
        op = header.get("op")
        if deadline.expired():
            # the caller's budget ran out while the frame queued or flew:
            # dropped before any CAS job, hash pass or write
            self.counters.inc("deadline_drops")
            self.obs.event("deadline_shed", where="dispatch", op=str(op))
            return {"ok": False, "error": "deadline expired"}, b""
        repoch, rfp = header.get("repoch"), header.get("rfp")
        ring = self.ring.current
        if isinstance(repoch, int) and not isinstance(repoch, bool) \
                and (repoch != ring.epoch
                     or (isinstance(rfp, str) and rfp != ring.fingerprint)):
            # a placement-bearing op from a node with another ring (a
            # lagging epoch, or another map at the same epoch): refused
            # with ours, so the stale side converges and retries
            self.ring.note_epoch_mismatch()
            self.counters.inc("ring_epoch_mismatches")
            return {"ok": False,
                    "error": f"ring epoch mismatch (have {ring.epoch}, "
                             f"got {repoch})",
                    "ringEpoch": ring.epoch, "ring": ring.to_dict()}, b""
        if op == "get_ring":
            # membership query (ring status, boot catch-up): ungated
            return {"ok": True, "ring": self.ring.current.to_dict(),
                    "previous": self.ring.previous.to_dict()
                    if self.ring.previous is not None else None,
                    "migrating": self.ring.migrating}, b""
        if op == "propose_ring":
            # epoch-versioned install (admin push, the stale-peer
            # refresh); idempotent: a map at or below ours answers ok
            try:
                installed = self.ring.adopt(header.get("ring"),
                                            source="propose")
            except ValueError as e:
                return {"ok": False, "error": f"bad ring map: {e}"}, b""
            return {"ok": True, "epoch": self.ring.epoch,
                    "installed": installed}, b""
        if op == "store_chunks":
            # hash echo: every digest recomputed from the received bytes,
            # off the loop with the writes
            pairs = unpack_chunks(header.get("chunks", []), body)

            def store_all():
                echoed = sha256_many_hex([b for _, b in pairs])
                good = [(actual, data) for (claimed, data), actual
                        in zip(pairs, echoed) if claimed == actual]
                # one batch: with the sim plane its new chunks are
                # sketched in one call on the node's device
                done = self.store.chunks.put_batch(good, verify=False)
                stored = sum(done)
                nbytes = sum(len(b) for (_, b), ok in zip(good, done) if ok)
                return echoed, stored, len(good) - stored, nbytes

            echoed, stored, dedup, nbytes = await asyncio.to_thread(store_all)
            if stored:
                self.counters.inc("chunks_stored", stored)
                self.counters.inc("bytes_stored", nbytes)
            if dedup:
                self.counters.inc("dedup_hits", dedup)
            return {"ok": True, "digests": echoed}, b""
        if op == "has_chunks":
            digests = header.get("digests", [])
            mask = await self.cas.has_many(digests)
            return {"ok": True,
                    "have": [d for d, h in zip(digests, mask) if h]}, b""
        if op == "get_filter":
            # the full filter snapshot; filter null = no filter plane
            if self.index is None or self.index.local_filter is None:
                return {"ok": True, "filter": None}, b""
            meta, fbody = self.index.local_filter.snapshot()
            return {"ok": True, "filter": meta}, fbody
        if op == "filter_delta":
            # the digests added since (gen, since), or resync; a malformed
            # cursor answers resync, never an error
            if self.index is None or self.index.local_filter is None:
                return {"ok": True, "resync": True, "gen": -1,
                        "version": 0}, b""
            gen, since = header.get("gen"), header.get("since")
            if not isinstance(gen, int) or not isinstance(since, int) \
                    or isinstance(gen, bool) or isinstance(since, bool):
                return {"ok": True, "resync": True, "gen": -1,
                        "version": 0}, b""
            return {"ok": True,
                    **self.index.local_filter.delta(gen, since)}, b""
        if op == "get_filters":
            # this node's own filter and every replica it gossips: the
            # meta table in the header (blob lengths included), the blobs
            # concatenated in table order as the body
            metas: list[dict] = []
            blobs: list[bytes] = []
            if self.index is not None \
                    and self.index.local_filter is not None:
                fmeta, blob = self.index.local_filter.snapshot()
                metas.append({"nodeId": self.cfg.node_id,
                              "gen": fmeta["gen"],
                              "version": fmeta["version"],
                              "capacity": fmeta["capacity"],
                              "bitsPerKey": fmeta["bitsPerKey"],
                              "ageS": 0.0, "length": len(blob)})
                blobs.append(blob)
                for _pid, pmeta, pblob in \
                        self.index.peer_filters.replicas():
                    metas.append({**pmeta, "length": len(pblob)})
                    blobs.append(pblob)
            return {"ok": True, "filters": metas}, blobs
        if op == "announce":
            m = Manifest.from_json(header["manifest"])
            if header.get("fresh"):
                self.store.manifests.clear_tombstone(m.file_id)
            if await asyncio.to_thread(self.store.manifests.save, m):
                self.counters.inc("manifests_announced")
            else:
                self.counters.inc("announce_rejected_tombstoned")
            return {"ok": True}, b""
        if op == "tombstones":
            # ts None: the tombstone vanished meanwhile (a fresh re-upload
            # cleared it) and must not be advertised
            ms = self.store.manifests
            tombs = [{"id": fid, "ts": ts} for fid in ms.tombstones()
                     if (ts := ms.tombstone_ts(fid)) is not None]
            return {"ok": True, "tombs": tombs}, b""
        if op == "list_manifests":
            return {"ok": True, "ids": self.store.manifests.ids()}, b""
        if op == "get_chunk":
            if self.tier is not None:
                # a holder serving a peer's read is read demand too:
                # without this only the coordinator's ledger heats
                self.tier.ledger.note_read(header["digest"])
            data = await self.cas.get(header["digest"])
            if data is None:
                return {"ok": False, "error": "chunk not found"}, b""
            return {"ok": True}, data
        if op == "get_chunks":
            if self.tier is not None:
                for d in header.get("digests", []):
                    if isinstance(d, str):
                        self.tier.ledger.note_read(d)
            have = await self.cas.get_many(header.get("digests", []))
            table, bufs = pack_chunks(have)
            return {"ok": True, "chunks": table}, bufs
        if op == "get_manifest":
            m = self.store.manifests.load(header["fileId"])
            return {"ok": True,
                    "manifest": None if m is None else m.to_json(),
                    "mtime": self.store.manifests.mtime(
                        header["fileId"])}, b""
        if op == "delete":
            await asyncio.to_thread(self._forget_file, header["fileId"])
            return {"ok": True}, b""
        if op == "delete_chunks":
            # a peer asks this node to drop copies it no longer places
            # here; every digest this node still owns by its own manifests
            # and ring is refused
            digests = header.get("digests", [])
            if not (isinstance(digests, list) and
                    all(isinstance(d, str) and len(d) == 64
                        for d in digests)):
                return {"ok": False, "error": "bad digests"}, b""
            if self.ring.migrating:
                # the dual-read window may need any replica
                return {"ok": True, "removed": [],
                        "refused": list(digests)}, b""

            def reclaim():
                expected = self._expected_digests_here(set(digests))
                removed, refused = [], []
                for d in digests:
                    if d in expected:
                        refused.append(d)
                    elif self.store.chunks.delete(d):
                        removed.append(d)
                    elif self.store.chunks.delta_pinned(d):
                        # a delta base: resident deltas reconstruct
                        # through it, so it is refused like an owned chunk
                        refused.append(d)
                return removed, refused

            removed, refused = await asyncio.to_thread(reclaim)
            self.serve.drop_cached(removed)
            return {"ok": True, "removed": removed, "refused": refused}, b""
        if op == "get_trace":
            # this node's spans of one trace, for the stitcher: a bounded
            # ring scan, ungated like health
            return {"ok": True, "spans": self.obs.spans_for(
                str(header.get("traceId", "")))}, b""
        if op == "get_doctor":
            # this node's diagnosis snapshot; ungated like get_trace
            return {"ok": True, "doctor": await self.doctor_snapshot()}, b""
        if op == "get_census":
            # the bucketed CAS inventory; ``prefixes`` drills member
            # lists of those buckets. Ungated; the scan runs on the CAS
            # read pool
            prefixes = header.get("prefixes")
            if prefixes is not None and not (
                    isinstance(prefixes, list)
                    and all(isinstance(p, str) and len(p) ==
                            self.store.chunks.PREFIX_HEX
                            for p in prefixes)):
                return {"ok": False, "error": "bad prefixes"}, b""
            return {"ok": True,
                    "census": await self.census_inventory(prefixes)}, b""
        if op == "health":
            return {"ok": True, "nodeId": self.cfg.node_id,
                    "chunks": await asyncio.to_thread(
                        self.store.chunks.count),
                    "files": len(self.store.manifests.ids())}, b""
        return {"ok": False, "error": f"unknown op {op!r}"}, b""

    def _expected_digests_here(self, candidates: set[str]) -> set[str]:
        """The candidates this node holds canonically by its own
        manifests and ring: an EC shard where the stripe placement pins
        it here, a replicated chunk where the ring makes this node an
        owner. ``delete_chunks`` deletes only what this never returns."""
        out: set[str] = set()
        rf = self.cfg.cluster.replication_factor
        ring = self.ring.current
        me = self.cfg.node_id
        for m in self.store.manifests.list():
            if m.ec is not None:
                pl = ec_placement_map(m, ring)
                for d in m.all_digests():
                    if d in candidates and me in pl.get(d, ()):
                        out.add(d)
            else:
                for c in m.chunks:
                    if c.digest in candidates \
                            and me in ring.owners(c.digest, rf):
                        out.add(c.digest)
            if len(out) == len(candidates):
                break
        return out

    # ------------------------------------------------------------------ #
    # upload
    # ------------------------------------------------------------------ #

    async def upload(self, data: bytes, name: str,
                     ec_k: int = 0) -> tuple[Manifest, dict]:
        """Whole-body upload. Hashing, chunking and the EC encode run in
        worker threads so a large body never stalls the event loop. With
        ``ec_k`` the chunks are grouped into stripes of ``ec_k``, each
        stripe gains P and Q, and every shard is placed once, on its
        stripe holder (the parity is the redundancy)."""
        with self.obs.span("upload.hash_file", latency=True):
            file_id = await asyncio.to_thread(sha256_hex, data)
        if not name:
            name = f"file-{file_id[:8]}"
        # opened on the loop around the await: the worker thread does not
        # inherit the trace context, the await does
        with self.obs.span("upload.fragment", latency=True):
            manifest = await asyncio.to_thread(
                self.fragmenter.manifest, data, name=name, file_id=file_id)
        stats = self._new_upload_stats()
        stats["bytes"] = len(data)
        seen: set[str] = set()
        batch: list[tuple[str, memoryview]] = []
        view = memoryview(data).toreadonly()
        for c in manifest.chunks:
            if c.digest in seen:
                continue          # duplicate content within the file
            seen.add(c.digest)
            batch.append((c.digest, view[c.offset:c.offset + c.length]))
        stats["uniqueChunks"] = len(seen)
        placement = None
        rf = None
        if ec_k:
            ids = self.ring.node_ids()
            if ec_k + 2 > len(ids):
                raise UploadError(
                    f"ec={ec_k} needs {ec_k + 2} nodes, ring has "
                    f"{len(ids)} active (shards of a stripe must land "
                    "on distinct nodes)", status=400)
            if ec_k > 255:
                # the Q coefficients repeat beyond GF(256)*'s order 255
                raise UploadError("ec must be <= 255", status=400)
            with self.obs.span("upload.ec_encode", latency=True):
                manifest, parity = await asyncio.to_thread(
                    self._ec_extend, manifest, data, ec_k)
            for d, b in parity:
                # P and Q share a digest at k=1 (Q == P): placed once
                if d not in seen:
                    seen.add(d)
                    batch.append((d, b))
            stats["ecParityBytes"] = sum(len(b) for _, b in parity)
            placement = ec_placement_map(manifest, self.ring.current)
            rf = 1
        ledger = self._new_trust_ledger()
        await self._place_batch(file_id, batch, stats, rf=rf,
                                placement=placement, ledger=ledger)
        if ledger:
            # filter-credited copies confirmed before the ack
            await self._verify_trusted(file_id, ledger, stats, rf=rf,
                                       placement=placement)
        await self._finalize_upload(manifest)
        self.counters.inc("upload_bytes", len(data))
        return manifest, stats

    def _ec_device(self):
        """Where the EC encode runs: the fragmenter's device (its first
        slot on a mesh) — the card when the node chunks on it — or, for a
        host strategy or a sidecar, the node's device."""
        mesh = getattr(self.fragmenter, "mesh", None)
        if mesh is not None:
            return mesh.flat[0]
        return getattr(self.fragmenter, "device", self.device)

    def _ec_extend(self, manifest: Manifest, data: bytes, k: int
                   ) -> tuple[Manifest, list[tuple[str, bytes]]]:
        """P+Q parity per stripe of ``k`` data chunks: the EC manifest and
        the parity (digest, payload) list. Worker-thread code."""
        view = memoryview(data)
        src = {c.digest: view[c.offset:c.offset + c.length]
               for c in manifest.chunks}
        return self._ec_extend_from(manifest, src, k)

    def _ec_extend_from(self, manifest: Manifest,
                        chunk_bytes: Mapping[str, bytes], k: int
                        ) -> tuple[Manifest, list[tuple[str, bytes]]]:
        """:meth:`_ec_extend` with the payloads from a digest map. Every
        stripe is encoded in one :func:`ec_ops.encode_stripes` call on
        :meth:`_ec_device`, on this thread's current stream."""
        import dataclasses as _dc

        groups = ec_stripe_groups(manifest.chunks, k)
        dev = self._ec_device()
        parity_pq = ec_ops.encode_stripes(
            [([chunk_bytes[c.digest] for c in grp], stripe_shard_len(grp))
             for grp in groups], device=dev)
        self._ec_encode_device = str(dev)
        self.counters.inc("ec_encodes")
        self.counters.inc("ec_encode_stripes", len(groups))
        blobs = [b.tobytes() for pq in parity_pq for b in pq]
        hexes = sha256_many_hex(blobs)
        stripes: list[StripeRef] = []
        parity: list[tuple[str, bytes]] = []
        for s, grp in enumerate(groups):
            pd, qd = hexes[2 * s], hexes[2 * s + 1]
            stripes.append(StripeRef(p=pd, q=qd,
                                     shard_len=stripe_shard_len(grp)))
            parity.append((pd, blobs[2 * s]))
            parity.append((qd, blobs[2 * s + 1]))
        ec = EcInfo(k=k, stripes=tuple(stripes))
        return _dc.replace(manifest, ec=ec), parity

    async def upload_stream(self, blocks, name: str) -> tuple[Manifest, dict]:
        """Bounded-memory pipelined ingest of an async iterator of byte
        blocks (an HTTP chunked body). The fragmenter's streaming walk runs
        in a worker thread; finished chunks flow back and are placed in
        ~``ingest.flush_bytes`` batches, up to ``ingest.window`` batches
        in flight, while the stream still arrives. A byte credit between
        the two stops the fragmenter, then the body reads, when placement
        falls behind. The first placement failure aborts the stream:
        reading stops and no manifest is written (the placed chunks age
        out through the GC). fileId = sha256 of the whole stream."""
        loop = asyncio.get_running_loop()
        inq: _queue.Queue = _queue.Queue(maxsize=4)
        outq: asyncio.Queue = asyncio.Queue()
        hasher = sha256_new()
        frag_dead = threading.Event()
        aborted = threading.Event()
        credits = ByteBudget(self.cfg.ingest.credit_bytes)

        def feed_iter():
            while True:
                try:
                    b = inq.get(timeout=0.5)
                except _queue.Empty:
                    # the abort must not depend on the end-of-stream
                    # sentinel arriving
                    if aborted.is_set():
                        return
                    continue
                if b is None:
                    return
                yield b

        def on_chunk(digest: str, payload: bytes) -> None:
            t0 = time.perf_counter()
            while not credits.acquire(len(payload), timeout=0.5):
                if aborted.is_set():
                    raise RuntimeError("upload aborted")
            waited = time.perf_counter() - t0
            if waited > 0.001:
                self.ingest_stalls.add("creditS", waited)
            loop.call_soon_threadsafe(outq.put_nowait, (digest, payload))

        def run_fragmenter():
            try:
                m = self.fragmenter.manifest_stream(
                    feed_iter(), name=name or "stream", store=on_chunk)
                loop.call_soon_threadsafe(outq.put_nowait, ("done", m))
            except BaseException as e:  # re-raised on the loop below
                loop.call_soon_threadsafe(outq.put_nowait, ("error", e))
            finally:
                frag_dead.set()

        def put_block(b) -> None:
            # gives up once the fragmenter thread died (it stopped
            # draining inq)
            while not frag_dead.is_set():
                try:
                    inq.put(b, timeout=0.5)
                    return
                except _queue.Full:
                    continue

        async def fragment() -> None:
            # the walk's whole life (it waits on body blocks and credits
            # too), a span on the loop around the thread
            with self.obs.span("upload.fragment", latency=True):
                await asyncio.to_thread(run_fragmenter)

        frag_task = asyncio.create_task(fragment())

        async def feeder() -> int:
            total = 0
            try:
                async for b in blocks:
                    if aborted.is_set():
                        break     # placement failed: stop reading the body
                    total += len(b)
                    hasher.update(b)
                    await asyncio.to_thread(put_block, b)
            finally:
                await asyncio.to_thread(put_block, None)
            return total

        feed_task = asyncio.create_task(feeder())
        stats = self._new_upload_stats()
        seen: set[str] = set()
        batch: list[tuple[str, bytes]] = []
        pending = 0
        manifest: Manifest | None = None
        window = max(1, self.cfg.ingest.window)
        # (task, per-batch stats) in submission order, merged FIFO
        inflight: deque[tuple[asyncio.Task, dict]] = deque()

        async def drain_one() -> None:
            task, bstats = inflight[0]
            await task            # popped only after: an abort reaps it
            inflight.popleft()
            self._merge_upload_stats(stats, bstats)

        ledger = self._new_trust_ledger()

        async def submit(b: list[tuple[str, bytes]]) -> None:
            if window == 1:
                await self._place_batch("", b, stats, ledger=ledger)
                return
            while len(inflight) >= window:
                t0 = time.perf_counter()
                for task, _ in inflight:     # surface any failure first
                    if task.done() and not task.cancelled() \
                            and task.exception() is not None:
                        await task
                if inflight[0][0].done():
                    await drain_one()
                else:
                    await asyncio.wait(
                        [t for t, _ in inflight if not t.done()],
                        return_when=asyncio.FIRST_COMPLETED)
                self.ingest_stalls.add("placementS",
                                       time.perf_counter() - t0)
            bstats = self._new_upload_stats()
            task = asyncio.create_task(
                self._place_batch("", b, bstats, ledger=ledger))
            # a failed placement wakes the consume loop even while it is
            # parked on outq behind a slow client
            task.add_done_callback(lambda t: outq.put_nowait(("placed", t)))
            inflight.append((task, bstats))
            self.ingest_stalls.peak("placeWindow", len(inflight))

        try:
            while manifest is None:
                while inflight and inflight[0][0].done():
                    await drain_one()
                item = await outq.get()
                if item[0] == "placed":
                    task = item[1]
                    if not task.cancelled() and task.exception() is not None:
                        await task            # abort the stream now
                    continue
                if item[0] == "error" and isinstance(item[1], BaseException):
                    raise UploadError(f"fragmenter failed: {item[1]}")
                if item[0] == "done" and isinstance(item[1], Manifest):
                    manifest = item[1]
                    break
                digest, payload = item
                credits.release(len(payload))
                if digest in seen:
                    continue
                seen.add(digest)
                batch.append((digest, payload))
                pending += len(payload)
                if pending >= self._STREAM_FLUSH_BYTES:
                    await submit(batch)
                    batch, pending = [], 0
            if batch:
                await submit(batch)
            while inflight:
                t0 = time.perf_counter()
                await drain_one()
                self.ingest_stalls.add("placementS",
                                       time.perf_counter() - t0)
        except BaseException:
            aborted.set()                     # unblock fragmenter + feeder
            feed_task.cancel()
            for task, _ in inflight:
                task.cancel()
            await asyncio.gather(feed_task, frag_task,
                                 *(t for t, _ in inflight),
                                 return_exceptions=True)
            raise
        try:
            # re-raises body errors (malformed chunked framing -> 400)
            total = await feed_task
        finally:
            await frag_task
        if stats["minCopies"] is None:        # empty stream
            stats["minCopies"] = self.cfg.cluster.replication_factor
        file_id = hasher.hexdigest()
        if not name:
            name = f"file-{file_id[:8]}"
        manifest = Manifest(file_id=file_id, name=name, size=total,
                            fragmenter=manifest.fragmenter,
                            chunks=manifest.chunks)
        stats["bytes"] = total
        stats["uniqueChunks"] = len(seen)
        if ledger:
            # every filter-credited copy of every batch, confirmed in one
            # has_chunks round per peer before the manifest acks
            await self._verify_trusted(file_id, ledger, stats)
        await self._finalize_upload(manifest)
        self.counters.inc("upload_bytes", total)
        return manifest, stats

    # ------------------------------------------------------------------ #
    # resume, the single-hop commit, the smart client's bootstrap
    # ------------------------------------------------------------------ #

    async def missing_digests(self, digests: list[str]) -> list[str]:
        """Which of ``digests`` the cluster holds nowhere reachable: the
        resumable upload's probe. The local CAS first (one batched
        ``has_many`` on the read pool), then one ``has_chunks`` per peer
        over each digest's dual-read candidates; digests a peer's filter
        rules out are never asked of it. Filter positives are still
        probed: a false positive answered "held" would make the client
        skip bytes and trip the resume's 409."""
        cand = [d for d in dict.fromkeys(digests) if is_hex_digest(d)]
        mask = await self.cas.has_many(cand)
        missing = [d for d, h in zip(cand, mask) if not h]
        if not missing:
            return []
        rf = self.cfg.cluster.replication_factor
        found: set[str] = set()
        by_peer: dict[int, list[str]] = {}
        for d in missing:
            # mid-rebalance the bytes may sit at previous owners only
            for t in self.ring.read_candidates(d, rf):
                if t != self.cfg.node_id:
                    by_peer.setdefault(t, []).append(d)
        plane = self.index
        if plane is not None and plane.local_filter is not None:
            trimmed: dict[int, list[str]] = {}
            for nid, ds in by_peer.items():
                if plane.peer_filters.state(nid) is None:
                    trimmed[nid] = ds       # no replica: probe as is
                    continue
                keep = [d for d in ds
                        if plane.peer_filters.contains(nid, d)
                        is not False]
                plane.probes_skipped += len(ds) - len(keep)
                if keep:
                    trimmed[nid] = keep
                elif ds:
                    plane.probe_rpcs_skipped += 1
            by_peer = trimmed

        async def probe(nid: int, ds: list[str]) -> None:
            try:
                resp, _ = await self.client.call(
                    self.cfg.cluster.peer(nid),
                    {"op": "has_chunks", "digests": ds}, retries=1)
                found.update(resp.get("have", []))
            except RpcError:
                # an unanswered probe only makes the client resend bytes
                # the cluster has; counted, since it erases the resume win
                self.counters.inc("probe_failures")

        await asyncio.gather(*(probe(n, ds) for n, ds in by_peer.items()))
        return [d for d in missing if d not in found]

    @staticmethod
    def _check_tiling(table: list[tuple[int, int, str]], size: int) -> None:
        """A chunk table must tile [0, size) contiguously with hex
        digests (400 otherwise)."""
        expect = 0
        for off, ln, dg in table:
            if off != expect or ln < 0 or not is_hex_digest(dg):
                raise UploadError("malformed chunk table", status=400)
            expect = off + ln
        if expect != size:
            raise UploadError("chunk table does not tile the stream",
                              status=400)

    async def upload_resume(self, table: list[tuple[int, int, str]],
                            name: str, file_id: str, size: int,
                            provided: dict[str, bytes]
                            ) -> tuple[Manifest, dict]:
        """An upload from a client's chunk table plus only the payloads the
        cluster lacked (``GET /chunking``, chunk locally, ``POST
        /missing``, ``POST /upload_resume``). Every provided payload is
        hashed; the rest must be held locally or fetchable from replicas
        (else a 409 naming them: the client falls back to a full upload);
        the assembled stream must hash to ``file_id``, as a regular
        upload's fileId = sha256(body)."""
        if not name:
            name = f"file-{file_id[:8]}"
        self._check_tiling(table, size)
        hexes = await asyncio.to_thread(
            sha256_many_hex, list(provided.values()))
        for d, h in zip(provided, hexes):
            if d != h:
                raise UploadError(f"provided chunk {d[:12]}… hash mismatch",
                                  status=400)
        refs = [ChunkRef(index=i, offset=off, length=ln, digest=dg)
                for i, (off, ln, dg) in enumerate(table)]
        manifest = Manifest(file_id=file_id, name=name, size=size,
                            fragmenter=self.fragmenter.name,
                            chunks=tuple(refs))
        # assembled in batches: the whole-stream hash and the placement;
        # bytes come from `provided`, the local CAS or replicas
        stats = self._new_upload_stats()
        stats["bytes"] = sum(len(b) for b in provided.values())
        hasher = sha256_new()
        seen: set[str] = set()
        ledger = self._new_trust_ledger()
        batch: list = []
        bsize = 0
        for c in refs:
            batch.append(c)
            bsize += c.length
            if bsize >= self._FETCH_BATCH_BYTES or c is refs[-1]:
                got = dict(provided)
                need = [x for x in batch if x.digest not in got]
                if need:
                    # digest-verified like every read: a rotten local copy
                    # heals from a replica
                    got.update(await self._fetch_verified(
                        manifest, need, strict=False))
                absent = [x.digest for x in batch if x.digest not in got]
                if absent:
                    raise UploadError(
                        "resume missing chunks: "
                        + ",".join(d[:12] for d in absent), status=409)
                payloads = [got[x.digest] for x in batch]
                await asyncio.to_thread(
                    lambda ps=payloads: [hasher.update(p) for p in ps])
                place = [(x.digest, got[x.digest]) for x in batch
                         if x.digest not in seen]
                seen.update(d for d, _ in place)
                await self._place_batch(file_id, place, stats,
                                        ledger=ledger)
                batch, bsize = [], 0
        if hasher.hexdigest() != file_id:
            raise UploadError("resumed stream does not hash to fileId",
                              status=400)
        stats["uniqueChunks"] = len(seen)
        if stats["minCopies"] is None:
            stats["minCopies"] = self.cfg.cluster.replication_factor
        if ledger:
            await self._verify_trusted(file_id, ledger, stats)
        await self._finalize_upload(manifest)
        self.counters.inc("uploads_resumed")
        self.counters.inc("upload_bytes", size)
        return manifest, stats

    async def commit_manifest(self, table: list[tuple[int, int, str]],
                              name: str, file_id: str, size: int
                              ) -> tuple[Manifest, dict]:
        """The single-hop commit: the smart client striped every payload
        to its ring owners (each slice hash-echoed); this one coordinator
        call turns that into an acked file with a regular upload's ack:
        every chunk confirmed at write quorum by real ``has_chunks``
        rounds (a stale filter or a lying client cannot make a phantom
        copy), below-quorum chunks re-placed through the batch path, then
        the fsync'd manifest. Chunks held nowhere reachable answer 409.

        ``file_id`` is the client's claim of sha256(stream): every chunk
        was verified at store time and every read re-verifies it, so a
        wrong claim can mis-name the file, never corrupt bytes."""
        if not name:
            name = f"file-{file_id[:8]}"
        self._check_tiling(table, size)
        refs = [ChunkRef(index=i, offset=off, length=ln, digest=dg)
                for i, (off, ln, dg) in enumerate(table)]
        manifest = Manifest(file_id=file_id, name=name, size=size,
                            fragmenter=self.fragmenter.name,
                            chunks=tuple(refs))
        stats = self._new_upload_stats()
        stats["bytes"] = size
        ring = self.ring.current
        ids = ring.active_ids()
        rf = self.cfg.cluster.replication_factor
        quorum = min(self.cfg.write_quorum, rf, len(ids))
        plane = self.index
        cache = plane.echo_cache if plane is not None else None
        digests = list(dict.fromkeys(dg for _, _, dg in table))
        copies = {d: 0 for d in digests}
        mask = await self.cas.has_many(digests)
        for d, h in zip(digests, mask):
            if h:
                copies[d] += 1
        # one real has_chunks round per owner peer, first-party evidence
        by_peer: dict[int, list[str]] = {}
        for d in digests:
            for t in ring.owners(d, rf):
                if t != self.cfg.node_id:
                    by_peer.setdefault(t, []).append(d)

        async def probe(nid: int, ds: list[str]) -> set[str]:
            try:
                resp, _ = await self.client.call(
                    self.cfg.cluster.peer(nid),
                    {"op": "has_chunks", "digests": ds},
                    retries=None if self.health.is_alive(nid) else 1)
                self.health.mark_alive(nid)
                return set(resp.get("have", []))
            except DeadlineExpired:
                raise
            except RpcError as e:
                if isinstance(e, RpcUnreachable):
                    self.health.mark_dead(nid)
                self.counters.inc("commit_probe_failures")
                return set()

        with self.obs.span("upload.commit_verify", latency=True):
            peers = sorted(by_peer)
            results = await asyncio.gather(
                *(probe(n, by_peer[n]) for n in peers))
        for nid, have in zip(peers, results):
            for d in by_peer[nid]:
                if d in have:
                    copies[d] += 1
                    if cache is not None:
                        cache.confirm(nid, d)
        confirmed = {d: n for d, n in copies.items() if n >= quorum}
        stats["dedupSkippedBytes"] = sum(
            ln for _, ln, dg in table if dg in confirmed)
        below = set(d for d in digests if d not in confirmed)
        if below:
            # heal before the ack: the bytes from the local CAS or any
            # replica (the client may have reached some owners), placed
            # through the batch path; absent everywhere -> 409, no ack
            self.obs.event("commit_replace", chunks=len(below))
            need: list = []
            for c in refs:
                if c.digest in below:
                    below.discard(c.digest)
                    need.append(c)
            fetched = await self._fetch_verified(manifest, need,
                                                 strict=False)
            absent = [c.digest for c in need if c.digest not in fetched]
            if absent:
                raise UploadError(
                    "commit missing chunks: "
                    + ",".join(d[:12] for d in absent), status=409)
            await self._place_batch(
                file_id, [(c.digest, fetched[c.digest]) for c in need],
                stats)
        stats["uniqueChunks"] = len(digests)
        batch_min = min(confirmed.values(), default=rf)
        stats["minCopies"] = batch_min if stats["minCopies"] is None \
            else min(stats["minCopies"], batch_min)
        stats["degraded"] = stats["degraded"] or batch_min < rf
        await self._finalize_upload(manifest)
        self.counters.inc("uploads_committed")
        self.counters.inc("upload_bytes", size)
        return manifest, stats

    def dataplane_info(self) -> dict:
        """``GET /dataplane``: what a smart client needs to run the data
        plane itself — the ring map, the peers' addresses, rf and write
        quorum, the fragmenter's description (its chunk boundaries match
        the cluster's bit-exactly) and the filter state."""
        out = {"nodeId": self.cfg.node_id,
               "epoch": self.ring.epoch,
               "fingerprint": self.ring.current.fingerprint,
               "ring": self.ring.current.to_dict(),
               "migrating": self.ring.migrating,
               "replicationFactor": self.cfg.cluster.replication_factor,
               "writeQuorum": self.cfg.write_quorum,
               "peers": [{"nodeId": p.node_id, "host": p.host,
                          "port": p.port,
                          "internalPort": p.internal_port}
                         for p in self.cfg.cluster.peers],
               "filters": {"enabled": False}}
        try:
            out["chunking"] = {"fragmenter": self.fragmenter.name,
                               "describe": self.fragmenter.describe()}
        except NotImplementedError:
            out["chunking"] = None     # the client takes the legacy path
        if self.index is not None and self.index.local_filter is not None:
            fstats = self.index.local_filter.stats()
            out["filters"] = {
                "enabled": True,
                "generation": fstats["generation"],
                "version": fstats["version"],
                "peerAges": {str(p): round(a, 3) for p, a in
                             self.index.peer_filters.ages().items()}}
        return out

    @staticmethod
    def _new_upload_stats() -> dict:
        return {"bytes": 0, "uniqueChunks": 0, "transferredBytes": 0,
                "dedupSkippedBytes": 0, "minCopies": None,
                "handoffChunks": 0, "degraded": False}

    @staticmethod
    def _merge_upload_stats(into: dict, part: dict) -> None:
        into["transferredBytes"] += part["transferredBytes"]
        into["dedupSkippedBytes"] += part["dedupSkippedBytes"]
        into["handoffChunks"] += part["handoffChunks"]
        into["degraded"] = into["degraded"] or part["degraded"]
        if part["minCopies"] is not None:
            into["minCopies"] = part["minCopies"] \
                if into["minCopies"] is None \
                else min(into["minCopies"], part["minCopies"])

    @staticmethod
    def _slice_payloads(items: list, max_bytes: int) -> list[list]:
        """Split (digest, payload) lists into <= max_bytes slices (at least
        one item each): the receiver hash-echoes a whole call before it
        replies, so no call carries unbounded bytes."""
        out: list[list] = []
        cur: list = []
        size = 0
        for d, b in items:
            if cur and size + len(b) > max_bytes:
                out.append(cur)
                cur, size = [], 0
            cur.append((d, b))
            size += len(b)
        if cur:
            out.append(cur)
        return out

    def _raise_if_disk_full(self, e: OSError) -> None:
        """A full local disk during placement answers 507, not a 500, and
        journals ``disk_pressure``."""
        if e.errno != errno.ENOSPC:
            return
        self.counters.inc("disk_full_rejects")
        self.obs.event("disk_pressure", cause="enospc_put")
        raise UploadError("Insufficient storage: local CAS put failed "
                          "(ENOSPC)", status=507) from e

    async def _place_batch(self, file_id: str, batch: list, stats: dict,
                           rf: int | None = None,
                           placement: Mapping[str, tuple[int, ...]]
                           | None = None,
                           ledger: _TrustLedger | None = None) -> None:
        """Place one batch of unique (digest, payload) chunks: local puts
        for the chunks this node owns, concurrent replication to the other
        owners (a ``has_chunks`` probe first, then the missing payloads in
        bounded slices, each slice's hash echo verified), then
        sloppy-quorum handoff along the digest's ring for chunks still
        below quorum. Raises UploadError if any chunk ends below quorum.
        ``rf`` overrides the cluster's replication factor (EC shards are
        placed once) and ``placement`` pins digests to explicit holders
        (the EC stripe placement); a pinned digest hands off along
        ``ring.handoff_order(pinned)``, the order the read side walks.

        With the index plane, each peer's pass consults that peer's
        existence filter first: digests the filter rules out skip the
        probe and transfer directly; positives are credited as trusted
        copies when ``ledger`` is given (probe and transfer skipped; the
        caller runs :meth:`_verify_trusted` before acking), else probed.

        Crash points ``place.before_local_put`` (before any put) and
        ``place.after_replicate`` (puts and replication done, before the
        quorum check)."""
        if self.chaos is not None:
            self.chaos.maybe_crash("place.before_local_put")
        # one map for the whole batch: an epoch adopted meanwhile must not
        # split a batch between two maps
        ring = self.ring.current
        ids = ring.active_ids()
        if self.index is not None and self.index.echo_cache is not None:
            # an epoch change since the last batch clears the cache
            self.index.echo_cache.note_epoch(ring.epoch)
        if rf is None:
            rf = self.cfg.cluster.replication_factor
        placement = placement or {}
        me = self.cfg.node_id

        def primary_targets(digest: str) -> Sequence[int]:
            return placement.get(digest) or ring.owners(digest, rf)

        def handoff_ring(digest: str) -> list[int]:
            pinned = placement.get(digest)
            if not pinned:
                return ring.owners(digest, len(ids))
            return ring.handoff_order(pinned)

        per_node: dict[int, list] = {}
        copies: dict[str, int] = {}
        payload_of: dict[str, object] = {}
        local_puts: list = []
        for digest, payload in batch:
            copies[digest] = 0
            payload_of[digest] = payload
            for target in primary_targets(digest):
                if target == me:
                    local_puts.append((digest, payload))
                    copies[digest] += 1
                else:
                    per_node.setdefault(target, []).append((digest, payload))

        async def put_local(items: list, count_dedup: bool = True) -> None:
            results = await self.cas.put_many(items, verify=False)
            nstored = nbytes = 0
            for (_, b), newly in zip(items, results):
                if newly:
                    nstored += 1
                    nbytes += len(b)
            if nstored:
                self.counters.inc("chunks_stored", nstored)
                self.counters.inc("bytes_stored", nbytes)
            if count_dedup and len(items) > nstored:
                self.counters.inc("dedup_hits", len(items) - nstored)

        # (peer, digest) pairs already counted in the byte stats: a chunk
        # counts at most once per peer across the primary and handoff
        counted: set[tuple[int, str]] = set()

        async def replicate(node_id: int, wanted: list) -> None:
            peer = self.cfg.cluster.peer(node_id)
            # a peer believed dead gets one fast attempt
            retries = None if self.health.is_alive(node_id) else 1
            # the peer's filter splits its list into ruled out (transfer
            # without a probe), trusted (under a ledger: probe and
            # transfer skipped, verified before the ack) and to probe. A
            # dead peer's filter is never trusted; no replica of its
            # filter = the path without the index.
            plane = self.index
            cache = plane.echo_cache if plane is not None else None
            trusted: set[str] = set()
            # echo-cache credit first: a digest this peer hash-echoed this
            # session under this epoch needs no ledger entry at all
            remaining = wanted
            if cache is not None and retries is None:
                echoed_skip = 0
                remaining = []
                for d, b in wanted:
                    if cache.confirmed(node_id, d):
                        echoed_skip += 1
                        copies[d] += 1
                        if (node_id, d) not in counted:
                            counted.add((node_id, d))
                            stats["dedupSkippedBytes"] += len(b)
                    else:
                        remaining.append((d, b))
                if echoed_skip:
                    plane.echo_trusted += echoed_skip
                    plane.probes_skipped += echoed_skip
            filtered = False
            to_probe = remaining
            if plane is not None and plane.local_filter is not None \
                    and retries is None \
                    and plane.peer_filters.state(node_id) is not None:
                filtered = True
                ruled_out = 0
                to_probe = []
                for d, b in remaining:
                    verdict = plane.peer_filters.contains(node_id, d)
                    if verdict is False:
                        ruled_out += 1       # straight to transfer
                    elif ledger is not None:
                        trusted.add(d)
                        copies[d] += 1
                        ledger.credit(node_id, d, len(b))
                        if (node_id, d) not in counted:
                            counted.add((node_id, d))
                            stats["dedupSkippedBytes"] += len(b)
                    else:
                        to_probe.append((d, b))
                plane.probes_skipped += ruled_out + len(trusted)
                plane.trusted += len(trusted)
                if not to_probe and remaining:
                    plane.probe_rpcs_skipped += 1
            digests = [d for d, _ in to_probe]
            try:
                staged = None
                have: set[str] = set()
                if to_probe and not filtered:
                    # the probe flies while the slices are staged in a
                    # thread
                    probe = asyncio.create_task(self.client.call(
                        peer, {"op": "has_chunks", "digests": digests},
                        retries=retries))
                    try:
                        staged = await asyncio.to_thread(
                            self._slice_payloads, remaining,
                            self._REPLICA_SLICE_BYTES)
                        resp, _ = await probe
                    except BaseException:
                        probe.cancel()
                        raise
                    have = set(resp.get("have", []))
                elif to_probe:
                    # the filter-trimmed probe: only what the filter could
                    # not rule out goes over the wire
                    resp, _ = await self.client.call(
                        peer, {"op": "has_chunks", "digests": digests},
                        retries=retries)
                    have = set(resp.get("have", []))
                    for d in digests:
                        if d not in have:
                            # the filter said maybe, the peer says no: an
                            # observed false positive, overridden so a
                            # retry stops trusting it
                            plane.peer_filters.note_fp(node_id, d)
                missing = [(d, b) for d, b in remaining
                           if d not in have and d not in trusted]
                for d, b in remaining:
                    if d in have:
                        copies[d] += 1
                        if cache is not None:
                            cache.confirm(node_id, d)
                        if (node_id, d) not in counted:
                            counted.add((node_id, d))
                            stats["dedupSkippedBytes"] += len(b)
                            self.counters.inc("dedup_remote_hits")
                if missing:
                    slices = staged if staged is not None and not have \
                        else self._slice_payloads(
                            missing, self._REPLICA_SLICE_BYTES)

                    def make_on_slice(nid: int):
                        def on_slice(part: list, echoed: list[str]) -> None:
                            # a verified slice is durable on the peer even
                            # if a later slice fails: credited at once
                            sent = {d for d, _ in part}
                            if sent & set(echoed) != sent:
                                raise RpcError(
                                    f"hash echo mismatch from node {nid}")
                            for d, b in part:
                                copies[d] += 1
                                if cache is not None:
                                    cache.confirm(nid, d)
                                if nid != node_id:
                                    # a hedge's backup copy sits off its
                                    # owners: repair moves it home
                                    self.under_replicated.add(d)
                                if (nid, d) not in counted:
                                    counted.add((nid, d))
                                    stats["transferredBytes"] += len(b)
                        return on_slice

                    # hedged write: the first digest with a live holder
                    # outside its owners names the backup train
                    backup_id = None
                    if self.serve.hedge is not None:
                        for dg, _ in missing:
                            primaries = set(primary_targets(dg))
                            backup_id = next(
                                (t for t in handoff_ring(dg)
                                 if t != node_id and t != me
                                 and t not in primaries
                                 and self.health.is_alive(t)), None)
                            if backup_id is not None:
                                break
                    if backup_id is None:
                        peak = await self.client.store_chunks_windowed(
                            peer, file_id, slices,
                            window=self.cfg.ingest.slice_inflight,
                            on_slice=make_on_slice(node_id))
                        self.ingest_stalls.peak("sliceInflight", peak)
                    else:
                        await self._store_hedged(node_id, backup_id,
                                                 file_id, slices,
                                                 make_on_slice)
                self.health.mark_alive(node_id)
            except DeadlineExpired:
                # the caller's budget died, not the peer: the upload
                # aborts as a 503, not as a replication failure
                raise
            except RpcError as e:
                self.log.warning("replication to node %d failed: %s",
                                 node_id, e)
                self.counters.inc("replication_failures")
                if isinstance(e, RpcUnreachable):
                    self.health.mark_dead(node_id)
                    if cache is not None:
                        # the confirmations were about that process
                        cache.drop(node_id)

        async def place(jobs) -> None:
            try:
                await gather_abort_siblings(*jobs)
            except OSError as e:
                self._raise_if_disk_full(e)
                raise

        with self.obs.span("upload.replicate", latency=True):
            await place([put_local(local_puts),
                         *(replicate(nid, w) for nid, w in per_node.items())])
        if self.chaos is not None:
            self.chaos.maybe_crash("place.after_replicate")

        # sloppy-quorum handoff: chunks below quorum try the next nodes of
        # their ring; handoff copies are queued for repair, which moves
        # them home. The quorum is clamped to what placement can reach.
        quorum = min(self.cfg.write_quorum, rf, len(ids))
        handoff: set[str] = set()
        next_try = {d: len(primary_targets(d)) for d in copies}
        with self.obs.span("upload.handoff", latency=True):
            while True:
                need = [d for d, n in copies.items() if n < quorum]
                if not need:
                    break
                groups: dict[int, list] = {}
                local_handoff: list = []
                for d in need:
                    order = handoff_ring(d)
                    if next_try[d] >= len(order):
                        continue                 # cluster exhausted
                    target = order[next_try[d]]
                    next_try[d] += 1
                    handoff.add(d)
                    if target == me:
                        local_handoff.append((d, payload_of[d]))
                        copies[d] += 1
                    else:
                        groups.setdefault(target, []).append(
                            (d, payload_of[d]))
                if not (local_handoff or groups):
                    break
                jobs = [replicate(nid, w) for nid, w in groups.items()]
                if local_handoff:
                    jobs.append(put_local(local_handoff, count_dedup=False))
                await place(jobs)

        failed = [d for d, n in copies.items() if n < quorum]
        if failed:
            # journaled: the 500 it becomes carries no cluster state
            self.obs.event("quorum_fail", chunksBelow=len(failed),
                           quorum=quorum)
            raise UploadError(f"Replication failed: {len(failed)} chunks "
                              f"below quorum {quorum}")
        for d, n in copies.items():
            if n < rf or d in handoff:
                self.under_replicated.add(d)
        batch_min = min(copies.values(), default=rf)
        stats["minCopies"] = batch_min if stats["minCopies"] is None \
            else min(stats["minCopies"], batch_min)
        stats["handoffChunks"] += len(handoff)
        stats["degraded"] = stats["degraded"] or bool(
            handoff or any(n < rf for n in copies.values()))

    async def _store_hedged(self, primary_id: int, backup_id: int,
                            file_id: str, slices: list,
                            make_on_slice) -> None:
        """Hedged replication store, as dfs_tpu's: the slice train goes to
        the primary; if it outlives the hedge delay and the token bucket
        allows, a second train of the same slices goes to ``backup_id``.
        Every hash-echo-verified slice is a real copy wherever it landed,
        so either train's success completes the call and a cancelled loser
        keeps what it landed. Raises only when both trains fail (the
        primary's error, so the caller's health handling targets it)."""
        hedge = self.serve.hedge
        window = self.cfg.ingest.slice_inflight

        async def send_train(nid: int):
            return await self.client.store_chunks_windowed(
                self.cfg.cluster.peer(nid), file_id, slices,
                window=window, on_slice=make_on_slice(nid))

        task = asyncio.create_task(send_train(primary_id))
        btask: asyncio.Task | None = None

        async def reap_on_cancel() -> None:
            # our caller was cancelled: the trains die with it
            task.cancel()
            if btask is not None:
                btask.cancel()
            await asyncio.gather(task, *([btask] if btask is not None
                                         else []), return_exceptions=True)

        delay = hedge.delay_s(
            self.client.rpc_stats.recent_best_mean("store_chunks"))
        try:
            peak = await asyncio.wait_for(asyncio.shield(task), delay)
            self.ingest_stalls.peak("sliceInflight", peak)
            return
        except asyncio.TimeoutError:
            pass                        # the primary is still in flight
        except asyncio.CancelledError:
            await reap_on_cancel()
            raise
        if not hedge.take():
            try:
                peak = await task
            except asyncio.CancelledError:
                await reap_on_cancel()
                raise
            self.ingest_stalls.peak("sliceInflight", peak)
            return
        hedge.note_fired()
        self.obs.event("hedge_fired", op="store_chunks",
                       primary=primary_id, backup=backup_id,
                       slices=len(slices), delayS=round(delay, 4))
        btask = asyncio.create_task(send_train(backup_id))
        try:
            done, _ = await asyncio.wait(
                {task, btask}, return_when=asyncio.FIRST_COMPLETED)
        except asyncio.CancelledError:
            await reap_on_cancel()
            raise
        first, other = (task, btask) if task in done else (btask, task)
        first_id, other_id = (primary_id, backup_id) if first is task \
            else (backup_id, primary_id)
        ferr = first.exception()
        if ferr is None:
            other.cancel()
            with contextlib.suppress(asyncio.CancelledError, RpcError,
                                     WireError):
                await other     # reaped: the winner's train landed
            if not other.cancelled() \
                    and isinstance(other.exception(), RpcUnreachable):
                self.health.mark_dead(other_id)
            if first_id == backup_id:
                hedge.note_won()
                self.obs.event("hedge_won", op="store_chunks",
                               primary=primary_id, backup=backup_id)
            else:
                self.ingest_stalls.peak("sliceInflight", first.result())
            return
        # the first train failed: the other side decides, no third train
        if isinstance(ferr, RpcUnreachable):
            self.health.mark_dead(first_id)
        try:
            await other
        except asyncio.CancelledError:
            await reap_on_cancel()
            raise
        except (RpcError, WireError) as e:
            raise (ferr if first_id == primary_id else e) from None
        if other_id == backup_id:
            hedge.note_won()
            self.obs.event("hedge_won", op="store_chunks",
                           primary=primary_id, backup=backup_id)

    def _new_trust_ledger(self) -> _TrustLedger | None:
        """A trust ledger when the filter plane is on, else None (a probe
        per batch per peer)."""
        if self.index is not None and self.index.local_filter is not None:
            return _TrustLedger()
        return None

    async def _verify_trusted(self, file_id: str, ledger: _TrustLedger,
                              stats: dict, rf: int | None = None,
                              placement: Mapping[str, tuple[int, ...]]
                              | None = None) -> None:
        """Confirm every filter-credited copy with one real ``has_chunks``
        round per peer, after the last batch and before the manifest write
        that acks, as dfs_tpu does. An unconfirmed copy (a bloom false
        positive, or a peer that died between trust and verify) is healed
        before the ack: its bytes are re-read (local store first, then any
        replica) and re-placed through the batch path without a ledger.
        Bytes held nowhere reachable fail the upload."""
        plane = self.index
        assert plane is not None
        unconfirmed: dict[str, int] = {}
        with self.obs.span("upload.verify_trusted", latency=True):
            for node_id, entries in sorted(ledger.by_peer.items()):
                peer = self.cfg.cluster.peer(node_id)
                digests = sorted(entries)
                try:
                    resp, _ = await self.client.call(
                        peer, {"op": "has_chunks", "digests": digests})
                    self.health.mark_alive(node_id)
                except RpcError as e:
                    # a sick peer, not a filter mistake: no FP override
                    if isinstance(e, RpcUnreachable):
                        self.health.mark_dead(node_id)
                        if plane.echo_cache is not None:
                            plane.echo_cache.drop(node_id)
                    self.counters.inc("index_verify_failures")
                    for d in digests:
                        stats["dedupSkippedBytes"] -= entries[d]
                        unconfirmed.setdefault(d, entries[d])
                    continue
                have = set(resp.get("have", []))
                for d in digests:
                    if d not in have:
                        plane.peer_filters.note_fp(node_id, d)
                        stats["dedupSkippedBytes"] -= entries[d]
                        unconfirmed.setdefault(d, entries[d])
                    elif plane.echo_cache is not None:
                        plane.echo_cache.confirm(node_id, d)
        if not unconfirmed:
            return
        self.counters.inc("filter_fp_replaced", len(unconfirmed))
        self.obs.event("filter_fp_replace", chunks=len(unconfirmed))
        items: list[tuple[str, bytes]] = []
        local = dict(await self.cas.get_many(sorted(unconfirmed)))
        for d, ln in sorted(unconfirmed.items()):
            b = local.get(d)
            if b is None:
                try:
                    b = await self._fetch_chunk(d, ln)
                except DeadlineExceeded:
                    raise
                except DownloadError:
                    raise UploadError(
                        f"filter-credited chunk {d[:12]}… held nowhere "
                        "reachable — retry the upload (the filter "
                        "override now forces a real transfer)")
            items.append((d, b))
        await self._place_batch(file_id, items, stats, rf=rf,
                                placement=placement)

    async def _finalize_upload(self, manifest: Manifest) -> None:
        """The ack: the manifest saved last (fsync'd, off the loop), then
        a best-effort announce to every peer. A fresh upload clears a
        tombstone, here and (fresh=True) at the peers. Crash points
        ``upload.before_manifest`` (chunks durable, no manifest: the
        torn-upload window) and ``upload.after_manifest`` (durable, not
        yet announced or acked)."""
        if self.chaos is not None:
            self.chaos.maybe_crash("upload.before_manifest")
        self.store.manifests.clear_tombstone(manifest.file_id)
        try:
            saved = await asyncio.to_thread(self.store.manifests.save,
                                            manifest)
        except OSError as e:
            self._raise_if_disk_full(e)
            raise
        if not saved:
            raise UploadError("manifest save refused (tombstone race)")
        if self.chaos is not None:
            self.chaos.maybe_crash("upload.after_manifest")
        mj = manifest.to_json()

        async def announce(peer) -> None:
            try:
                await self.client.announce(peer, mj, fresh=True)
            except RpcError as e:
                self.log.warning("announce to node %d failed: %s",
                                 peer.node_id, e)
                self.counters.inc("announce_failures")

        await asyncio.gather(*(announce(p) for p in self._peers()))
        self.counters.inc("uploads")

    # ------------------------------------------------------------------ #
    # download
    # ------------------------------------------------------------------ #

    async def _fetch_chunk(self, digest: str, length: int) -> bytes:
        """One chunk, locally or from any peer, verified against its
        digest: current-epoch owners, then previous-epoch owners (the
        dual-read window), then the rest of the address book (a drained
        or removed node may hold the only copy), each group
        believed-alive first."""
        data = await self.cas.get(digest)
        if data is not None:
            return data
        rf = self.cfg.cluster.replication_factor
        me = self.cfg.node_id
        candidates = [t for t in self.ring.read_candidates(digest, rf)
                      if t != me]
        candidates.sort(key=lambda t: not self.health.is_alive(t))
        candidates += sorted(
            (t for t in self.cfg.cluster.sorted_ids()
             if t != me and t not in candidates),
            key=lambda t: not self.health.is_alive(t))
        if self.serve.hedge is not None:
            # the same walk, but a primary that outlives the hedge delay
            # races the next replica
            return await self._fetch_chunk_hedged(digest, length,
                                                  candidates)
        for target in candidates:
            try:
                data = await self.client.get_chunk(
                    self.cfg.cluster.peer(target), digest)
                self.health.mark_alive(target)
            except DeadlineExpired as e:
                # the budget died, not the replicas: stop the walk
                raise DeadlineExceeded(str(e)) from e
            except RpcUnreachable:
                self.health.mark_dead(target)
                continue
            except RpcError:
                self.counters.inc("remote_chunk_misses")
                continue
            if len(data) == length and sha256_hex(data) == digest:
                self.counters.inc("chunks_fetched_remote")
                if self.ring.is_prev_only(digest, target, rf):
                    # served by a previous-epoch owner mid-move
                    self.ring.note_dual_read_hit()
                return data
            self.log.warning("corrupt chunk %s from node %d", digest[:12],
                             target)
        raise DownloadError(f"Could not retrieve chunk {digest[:12]}…")

    async def _fetch_chunk_hedged(self, digest: str, length: int,
                                  candidates: list[int]) -> bytes:
        """The hedged walk of :meth:`_fetch_chunk`, as dfs_tpu's: a
        replica that has not answered within the hedge delay races the
        next candidate, the first VERIFIED answer wins and the loser is
        cancelled; every hedge takes a token. A replica's outcome is
        handled as in the serial walk."""
        hedge = self.serve.hedge
        rf = self.cfg.cluster.replication_factor

        async def attempt(nid: int) -> bytes | None:
            """One replica's verified bytes, or None (miss, corrupt,
            dead)."""
            try:
                data = await self.client.get_chunk(
                    self.cfg.cluster.peer(nid), digest)
                self.health.mark_alive(nid)
            except DeadlineExpired as e:
                raise DeadlineExceeded(str(e)) from e  # stop the walk
            except RpcUnreachable:
                self.health.mark_dead(nid)
                return None
            except RpcError:
                self.counters.inc("remote_chunk_misses")
                return None
            if len(data) == length and sha256_hex(data) == digest:
                return data
            self.log.warning("corrupt chunk %s from node %d",
                             digest[:12], nid)
            return None

        def accept(data: bytes, src: int) -> bytes:
            self.counters.inc("chunks_fetched_remote")
            if self.ring.is_prev_only(digest, src, rf):
                self.ring.note_dual_read_hit()
            return data

        i = 0
        while i < len(candidates):
            nid = candidates[i]
            backup_id = candidates[i + 1] if i + 1 < len(candidates) \
                else None
            if backup_id is None:
                data = await attempt(nid)
                if data is not None:
                    return accept(data, nid)
                i += 1
                continue
            task = asyncio.create_task(attempt(nid))
            btask: asyncio.Task | None = None
            try:
                # seeded by the BEST replica's windowed mean, not the
                # primary's own
                delay = hedge.delay_s(
                    self.client.rpc_stats.recent_best_mean("get_chunk"))
                try:
                    data = await asyncio.wait_for(asyncio.shield(task),
                                                  delay)
                except asyncio.TimeoutError:
                    data = None          # the hedge trigger
                if task.done():
                    # answered (or failed fast) within the delay
                    if data is None:
                        data = task.result()
                    if data is not None:
                        return accept(data, nid)
                    i += 1
                    continue
                if not hedge.take():
                    # budget empty: wait the primary out
                    data = await task
                    if data is not None:
                        return accept(data, nid)
                    i += 1
                    continue
                hedge.note_fired()
                self.obs.event("hedge_fired", digest=digest[:12],
                               primary=nid, backup=backup_id,
                               delayS=round(delay, 4))
                btask = asyncio.create_task(attempt(backup_id))
                done, _ = await asyncio.wait(
                    {task, btask}, return_when=asyncio.FIRST_COMPLETED)
                first, other = (task, btask) if task in done \
                    else (btask, task)
                first_id, other_id = (nid, backup_id) if first is task \
                    else (backup_id, nid)
                data = first.result()
                src = first_id
                if data is None:
                    # the first finisher missed: wait on the other
                    data = await other
                    src = other_id
                else:
                    other.cancel()       # the loser
                    with contextlib.suppress(asyncio.CancelledError):
                        await other
            except (asyncio.CancelledError, DeadlineExceeded):
                # our caller was cancelled or the deadline died mid-race:
                # the racers die with it
                task.cancel()
                if btask is not None:
                    btask.cancel()
                await asyncio.gather(task, *([btask] if btask is not None
                                             else []),
                                     return_exceptions=True)
                raise
            if data is not None:
                if src == backup_id:
                    hedge.note_won()
                    self.obs.event("hedge_won", digest=digest[:12],
                                   primary=nid, backup=backup_id)
                return accept(data, src)
            i += 2                       # both replicas consumed
        raise DownloadError(f"Could not retrieve chunk {digest[:12]}…")

    async def _hedged_get_chunks(self, primary_id: int, backup_id: int,
                                 digests: list[str], expect: int
                                 ) -> tuple[list, int]:
        """Hedged batched fetch, as dfs_tpu's: ``get_chunks`` to the
        primary; past the hedge delay, with a token, the same batch to the
        backup; the first reply wins and the loser is cancelled. Returns
        (pairs, winner id); raises only when both sides fail (the
        primary's error)."""
        hedge = self.serve.hedge

        async def fetch_from(nid: int):
            return await self.client.get_chunks(
                self.cfg.cluster.peer(nid), digests,
                retries=None if self.health.is_alive(nid) else 1,
                expect_bytes=expect)

        task = asyncio.create_task(fetch_from(primary_id))
        btask: asyncio.Task | None = None

        async def reap_on_cancel() -> None:
            # our caller was cancelled: the racers die with it
            task.cancel()
            if btask is not None:
                btask.cancel()
            await asyncio.gather(task, *([btask] if btask is not None
                                         else []), return_exceptions=True)

        delay = hedge.delay_s(
            self.client.rpc_stats.recent_best_mean("get_chunks"))
        try:
            return await asyncio.wait_for(asyncio.shield(task),
                                          delay), primary_id
        except asyncio.TimeoutError:
            pass                        # the primary is still in flight
        except asyncio.CancelledError:
            await reap_on_cancel()
            raise
        if not hedge.take():
            try:
                return await task, primary_id
            except asyncio.CancelledError:
                await reap_on_cancel()
                raise
        hedge.note_fired()
        self.obs.event("hedge_fired", op="get_chunks",
                       primary=primary_id, backup=backup_id,
                       chunks=len(digests), delayS=round(delay, 4))
        btask = asyncio.create_task(fetch_from(backup_id))
        try:
            done, _ = await asyncio.wait(
                {task, btask}, return_when=asyncio.FIRST_COMPLETED)
        except asyncio.CancelledError:
            await reap_on_cancel()
            raise
        first, other = (task, btask) if task in done else (btask, task)
        first_id, other_id = (primary_id, backup_id) if first is task \
            else (backup_id, primary_id)
        ferr = first.exception()
        if ferr is None:
            other.cancel()
            with contextlib.suppress(asyncio.CancelledError, RpcError,
                                     WireError):
                await other     # reaped: the winner's reply is the result
            if not other.cancelled() \
                    and isinstance(other.exception(), RpcUnreachable):
                self.health.mark_dead(other_id)
            if first_id == backup_id:
                hedge.note_won()
                self.obs.event("hedge_won", op="get_chunks",
                               primary=primary_id, backup=backup_id)
            return first.result(), first_id
        # the first finisher failed: the other side decides, no third RPC
        if isinstance(ferr, RpcUnreachable):
            self.health.mark_dead(first_id)
        try:
            got = await other
        except asyncio.CancelledError:
            await reap_on_cancel()
            raise
        except (RpcError, WireError) as e:
            raise (ferr if first_id == primary_id else e) from None
        if other_id == backup_id:
            hedge.note_won()
            self.obs.event("hedge_won", op="get_chunks",
                           primary=primary_id, backup=backup_id)
        return got, other_id

    async def _gather_chunks(self, manifest: Manifest | None, chunks=None,
                             strict: bool = True,
                             prefetched: dict | None = None,
                             ec_fallback: bool = True) -> dict:
        """digest -> verified bytes for the given chunks (default: all of
        the manifest's): ``prefetched`` first, then the local store, then
        batched fetches from each chunk's first believed-alive owner (up
        to rf rounds, a failed peer's chunks regrouping onto the next
        owner), batched mop-up rounds, a cluster-wide ``has_chunks``
        sweep, and last the per-chunk walk. An EC manifest's shards are
        asked of their stripe holders and then their handoff order; the
        per-chunk walk is skipped for them and, with ``ec_fallback``, what
        no node served is decoded from its stripe (:meth:`_ec_recover`).
        ``strict=False`` skips what no peer produced instead of
        raising."""
        need: dict[str, int] = {}
        for c in (manifest.chunks if chunks is None else chunks):
            need.setdefault(c.digest, c.length)
        out: dict[str, object] = {}
        for d in list(need):
            b = (prefetched or {}).get(d)
            if b is not None:
                out[d] = b
                del need[d]
        if need:
            for d, b in await self.cas.get_many(list(need)):
                out[d] = b
                del need[d]
        if not need:
            return out
        rf = self.cfg.cluster.replication_factor
        me = self.cfg.node_id
        ring = self.ring
        # EC shards sit at their stripe holders, not at the digest's
        # owners: ask those, then the handoff order the write side walked;
        # mid-migration the previous epoch's holders join (dual read)
        pref = ec_placement_map(manifest, ring.current) \
            if manifest is not None and manifest.ec is not None else {}
        pref_prev = ec_placement_map(manifest, ring.previous) \
            if pref and ring.previous is not None else {}

        def candidates_for(d: str) -> Sequence[int]:
            pinned = pref.get(d)
            if pinned:
                out = ring.handoff_order(pinned)
                prev_pin = pref_prev.get(d)
                if prev_pin:
                    out = list(dict.fromkeys(list(out) + list(prev_pin)))
                return out
            # current owners, then previous-epoch owners (dual read)
            return ring.read_candidates(d, rf)

        def group_remaining(exclude: set[int]) -> dict[int, list[str]]:
            groups: dict[int, list[str]] = {}
            for d in need:
                if d in out:
                    continue
                cands = [t for t in candidates_for(d)
                         if t != me and t not in exclude]
                cands.sort(key=lambda t: not self.health.is_alive(t))
                if cands:
                    groups.setdefault(cands[0], []).append(d)
            return groups

        async def fetch_batches(node_id: int, digests: list[str]) -> None:
            peer = self.cfg.cluster.peer(node_id)
            batch: list[str] = []
            size = 0

            async def flush() -> None:
                nonlocal batch, size
                if not batch:
                    return
                # hedge target of the batch: the most common next replica
                # among its digests (what the backup lacks, the mop-up
                # rounds fetch)
                backup_id = None
                if self.serve.hedge is not None:
                    votes: dict[int, int] = {}
                    for d in batch:
                        for t in candidates_for(d):
                            if t != node_id and t != me:
                                votes[t] = votes.get(t, 0) + 1
                                break
                    if votes:
                        backup_id = max(votes, key=votes.get)
                src = node_id
                try:
                    if backup_id is not None:
                        got, src = await self._hedged_get_chunks(
                            node_id, backup_id, list(batch),
                            sum(need[d] for d in batch))
                    else:
                        got = await self.client.get_chunks(
                            peer, batch,
                            retries=None
                            if self.health.is_alive(node_id) else 1,
                            expect_bytes=sum(need[d] for d in batch))
                    self.health.mark_alive(src)
                except DeadlineExpired as e:
                    # the budget died, not the peer: abort the gather
                    raise DeadlineExceeded(str(e)) from e
                except RpcUnreachable:
                    self.health.mark_dead(node_id)
                    got = []
                except (RpcError, WireError) as e:
                    self.counters.inc("fetch_batch_errors")
                    self.log.warning("batched fetch from node %d failed: "
                                     "%s: %s", node_id, type(e).__name__, e)
                    got = []
                if got:
                    hexes = await asyncio.to_thread(
                        sha256_many_hex, [b for _, b in got])
                    for (d, b), h in zip(got, hexes):
                        if (d in need and d not in out and h == d
                                and len(b) == need[d]):
                            out[d] = b
                            self.counters.inc("chunks_fetched_remote")
                            if ring.migrating and ring.is_prev_only(
                                    d, src, rf):
                                ring.note_dual_read_hit()
                batch, size = [], 0

            for d in digests:
                batch.append(d)
                size += need[d]
                if size >= self._FETCH_BATCH_BYTES:
                    await flush()
            await flush()

        tried: set[int] = set()
        for _ in range(rf):
            groups = group_remaining(tried)
            if not groups:
                break
            await asyncio.gather(*(fetch_batches(nid, ds)
                                   for nid, ds in groups.items()))
            tried.update(groups)
        # mop-up: round r asks each missing digest's r-th candidate, so no
        # chunk crosses the wire from two peers at once
        for r in range(rf):
            missing = [d for d in need if d not in out]
            if not missing:
                break
            by_peer: dict[int, list[str]] = {}
            for d in missing:
                cands = [t for t in candidates_for(d) if t != me]
                if cands:
                    by_peer.setdefault(cands[min(r, len(cands) - 1)],
                                       []).append(d)
            if not by_peer:
                break
            await asyncio.gather(*(fetch_batches(nid, ds)
                                   for nid, ds in by_peer.items()))
        # cluster-wide sweep: copies parked off their owners (handoff)
        missing = [d for d in need if d not in out]
        if missing:
            claims: dict[str, int] = {}

            async def who_has(nid: int) -> None:
                try:
                    have = await self.client.has_chunks(
                        self.cfg.cluster.peer(nid), missing, retries=1)
                    for d in have:
                        claims.setdefault(d, nid)
                except DeadlineExpired as e:
                    raise DeadlineExceeded(str(e)) from e
                except RpcError:
                    self.counters.inc("probe_failures")

            await asyncio.gather(*(who_has(p.node_id)
                                   for p in self._peers()))
            groups2: dict[int, list[str]] = {}
            for d, nid in claims.items():
                groups2.setdefault(nid, []).append(d)
            if groups2:
                await asyncio.gather(*(fetch_batches(nid, ds)
                                       for nid, ds in groups2.items()))
        # the per-chunk walk: not for EC shards, which every peer was just
        # asked for; their next stop is the parity decode
        missing = [d for d in need if d not in out]
        is_ec = manifest is not None and manifest.ec is not None
        if missing and not is_ec:
            sem = asyncio.Semaphore(8)

            async def one(d: str) -> None:
                async with sem:
                    try:
                        out[d] = await self._fetch_chunk(d, need[d])
                    except DeadlineExceeded:
                        raise     # a dead budget ends the read
                    except DownloadError:
                        pass      # stays missing: raised or skipped below

            await asyncio.gather(*(one(d) for d in missing))
            missing = [d for d in need if d not in out]
        if missing and is_ec and ec_fallback:
            await self._ec_recover(manifest, set(missing), out)
            missing = [d for d in need if d not in out]
        if missing and strict:
            raise DownloadError(
                f"Could not retrieve chunk {missing[0][:12]}…")
        return out

    async def _ec_recover(self, manifest: Manifest, wanted: set[str],
                          out: dict) -> None:
        """Rebuild lost shards of an EC manifest from their stripe-mates.
        The surviving shards of every affected stripe come in one gather
        (non-strict, no decode: no recursion); the stripes then decode in
        one batched host solve (:func:`ec_ops.recover_stripes_np`), each
        recovered shard digest-verified before it joins ``out``. Lost
        parity is re-encoded from the recovered data. A stripe past the
        two-erasure budget is skipped (the caller decides whether that is
        fatal); one that needs a shard another stripe of this pass
        recovers (in-file dedup) waits for the next round."""
        ec = manifest.ec
        assert ec is not None
        groups = ec_stripe_groups(manifest.chunks, ec.k)
        affected = [
            (s, st, grp)
            for s, (st, grp) in enumerate(zip(ec.stripes, groups))
            if wanted.intersection([c.digest for c in grp]
                                   + [st.p, st.q])]
        # the wanted digests were just shown unreachable: not asked again
        fetch: dict[str, ChunkRef] = {}
        for s, st, grp in affected:
            for c in grp:
                if c.digest not in out and c.digest not in wanted:
                    fetch.setdefault(c.digest, ChunkRef(
                        index=0, offset=0, length=c.length,
                        digest=c.digest))
            for d in (st.p, st.q):
                if d not in out and d not in wanted:
                    fetch.setdefault(d, ChunkRef(
                        index=0, offset=0, length=st.shard_len, digest=d))
        have = dict(out)
        if fetch:
            got = await self._gather_chunks(
                manifest, chunks=list(fetch.values()), strict=False,
                ec_fallback=False)
            have.update(got)

        def padded(d: str, ln: int, shard_len: int) -> np.ndarray | None:
            # `out` first: a digest shared between stripes may have been
            # recovered by an earlier round of this pass
            b = out.get(d)
            if b is None:
                b = have.get(d)
            if b is None or len(b) != ln:
                return None
            if ln == shard_len:
                return np.frombuffer(b, dtype=np.uint8)
            arr = np.zeros(shard_len, dtype=np.uint8)
            arr[:ln] = np.frombuffer(b, dtype=np.uint8)
            return arr

        pending = affected
        while pending:
            deferred = []
            inputs = []
            meta = []
            for s, st, grp in pending:
                data = [padded(c.digest, c.length, st.shard_len)
                        for c in grp]
                p = padded(st.p, st.shard_len, st.shard_len)
                q = padded(st.q, st.shard_len, st.shard_len)
                lost = sum(d is None for d in data) \
                    + (p is None) + (q is None)
                if lost > 2:
                    deferred.append((s, st, grp, lost))
                    continue
                inputs.append((data, p, q))
                meta.append((s, st, grp))
            recs: list = []
            if inputs:
                try:
                    recs = await asyncio.to_thread(
                        ec_ops.recover_stripes_np, inputs)
                except ValueError as e:
                    # per stripe, so one malformed stripe cannot sink the
                    # others
                    self.log.warning("ec batch decode failed (%s); "
                                     "retrying per stripe", e)

                    def per_stripe() -> list:
                        got = []
                        for data, p, q in inputs:
                            try:
                                got.append(ec_ops.recover_stripe(data, p, q))
                            except ValueError as e2:
                                got.append(None)
                                self.log.warning("ec decode failed: %s", e2)
                        return got

                    recs = await asyncio.to_thread(per_stripe)
            progress = False
            for (s, st, grp), rec in zip(meta, recs):
                if rec is None:
                    continue
                recovered = False
                for c, arr in zip(grp, rec):
                    if c.digest in wanted and c.digest not in out:
                        b = arr[:c.length].tobytes()
                        if sha256_hex(b) == c.digest:
                            out[c.digest] = b
                            recovered = True
                        else:
                            self.log.error(
                                "ec decode produced wrong digest for %s",
                                c.digest[:12])
                if (st.p in wanted and st.p not in out) \
                        or (st.q in wanted and st.q not in out):
                    full = np.stack([np.asarray(a) for a in rec])
                    pb, qb = ec_ops.encode_pq_np(full)
                    for d, b in ((st.p, pb.tobytes()),
                                 (st.q, qb.tobytes())):
                        if d in wanted and d not in out \
                                and sha256_hex(b) == d:
                            out[d] = b
                            recovered = True
                if recovered:
                    progress = True
                    self.counters.inc("ec_decodes")
            if not deferred:
                break
            if not progress:
                for s, st, grp, lost in deferred:
                    self.log.warning(
                        "ec stripe %d of %s: %d shards lost, beyond P+Q",
                        s, manifest.file_id[:12], lost)
                break
            pending = [(s, st, grp) for s, st, grp, _ in deferred]

    async def _resolve_manifest(self, file_id: str) -> Manifest:
        """The local manifest, else a peer's (adopted with its origin
        mtime); a tombstoned id is not found even if a peer still has it."""
        manifest = self.store.manifests.load(file_id)
        if manifest is None and self.store.manifests.is_tombstoned(file_id):
            raise NotFoundError(file_id)
        if manifest is None:
            for peer in self._peers():
                try:
                    mj, mt = await self.client.get_manifest(peer, file_id)
                except RpcError:
                    continue
                if mj:
                    manifest = Manifest.from_json(mj)
                    await asyncio.to_thread(self.store.manifests.save,
                                            manifest, mt)
                    break
        if manifest is None:
            raise NotFoundError(file_id)
        return manifest

    async def _fetch_verified(self, manifest: Manifest, chunks: list,
                              strict: bool = True) -> dict:
        """The serving tier's front of :meth:`_fetch_verified_direct`, as
        dfs_tpu's. With the tier's cache (``cache_bytes > 0``) hot digests
        come from the cache; cold ones are claimed per digest
        (single-flight) and every digest this caller leads is fetched in
        ONE batched direct gather, then cached and handed to the waiters.
        A leader's failure rejects its claims without poisoning a retry;
        a waiter whose flight failed fetches directly. Without the cache:
        the direct path. An expired deadline is refused first."""
        if deadline.expired():
            # checked per batch: a mid-download expiry stops the rest
            self.counters.inc("deadline_drops")
            self.obs.event("deadline_shed", where="fetch")
            raise DeadlineExceeded("deadline expired")
        if self.tier is not None:
            # the temperature feed: every requested digest is one read,
            # before the cache split (cache hits heat the ledger too)
            for c in chunks:
                self.tier.ledger.note_read(c.digest)
        serve = self.serve
        if not serve.read_path_enabled:
            return await self._fetch_verified_direct(manifest, chunks,
                                                     strict)
        length: dict[str, int] = {}
        for c in chunks:
            length.setdefault(c.digest, c.length)
        out: dict = {}
        waits: dict[str, asyncio.Future] = {}
        mine: list[str] = []
        for d in length:
            b = serve.cache.get(d)
            if b is not None:
                out[d] = b
                continue
            leader, fut = serve.flight.claim(d)
            if leader:
                mine.append(d)
            else:
                waits[d] = fut
        if mine:
            refs = [ChunkRef(index=0, offset=0, length=length[d],
                             digest=d) for d in mine]
            try:
                got = await self._fetch_verified_direct(
                    manifest, refs, strict=False)
            except BaseException as e:
                # a cancelled leader (its client hung up) is a plain fetch
                # failure to the waiters: their requests are alive
                exc = e if isinstance(e, Exception) else DownloadError(
                    "origin fetch cancelled")
                for d in mine:
                    serve.flight.reject(d, exc)
                raise
            for d in mine:
                b = got.get(d)
                if b is None:
                    serve.flight.reject(d, DownloadError(
                        f"Could not retrieve chunk {d[:12]}…"))
                else:
                    serve.cache.put(d, b)
                    serve.flight.resolve(d, b)
                    out[d] = b
        failed_waits: list[str] = []
        if waits:
            # one span for the whole wait, not one per coalesced digest
            with self.obs.span("serve.flight.wait"):
                for d, fut in waits.items():
                    try:
                        out[d] = await serve.flight.wait(fut)
                    except DownloadError:
                        failed_waits.append(d)   # re-fetched just below
                    except asyncio.CancelledError:
                        if not fut.done():
                            raise                # WE were cancelled
                        failed_waits.append(d)   # the leader's flight died
        if failed_waits:
            # a rejected flight says nothing about this request: one
            # batched direct attempt
            refs = [ChunkRef(index=0, offset=0, length=length[d],
                             digest=d) for d in failed_waits]
            got = await self._fetch_verified_direct(
                manifest, refs, strict=False)
            for d in failed_waits:
                b = got.get(d)
                if b is not None:
                    serve.cache.put(d, b)
                    out[d] = b
        missing = [d for d in length if d not in out]
        if missing and strict:
            raise DownloadError(
                f"Could not retrieve chunk {missing[0][:12]}…")
        return out

    async def _fetch_verified_direct(self, manifest: Manifest,
                                     chunks: list,
                                     strict: bool = True) -> dict:
        """Gather chunks with the local copies digest-verified first: a
        rotten local copy is evicted, queued for repair and fetched from a
        replica instead."""
        digests = list(dict.fromkeys(c.digest for c in chunks))
        local = await self.cas.get_many(digests)
        hexes = await asyncio.to_thread(sha256_many_hex,
                                        [b for _, b in local])
        good: dict[str, bytes] = {}
        for (d, b), h in zip(local, hexes):
            if h == d:
                good[d] = b
            else:
                self.store.chunks.delete(d)
                self.serve.drop_cached([d])
                self.under_replicated.add(d)
                self.log.warning("evicted corrupt local chunk %s on read",
                                 d[:12])
                self.obs.event("corrupt_chunk", digest=d[:12], where="read")
        return await self._gather_chunks(manifest, chunks=chunks,
                                         prefetched=good, strict=strict)

    async def download_range(self, file_id: str, first: int | None,
                             last: int | None
                             ) -> tuple[Manifest, list, int, int]:
        """An HTTP byte range ((first, last) as parsed from ``bytes=``;
        either side open): only the overlapping chunks are gathered.
        Returns (manifest, payload views in order, start, end)."""
        manifest = await self._resolve_manifest(file_id)
        size = manifest.size
        if first is None:                   # suffix: the last N bytes
            if not last:
                raise RangeNotSatisfiable(size)
            start, end = max(0, size - last), size
        else:
            start = first
            end = size if last is None else min(last + 1, size)
        if start >= size or start >= end:
            raise RangeNotSatisfiable(size)
        wanted = [c for c in manifest.chunks
                  if c.offset < end and c.offset + c.length > start]
        by_digest = await self._fetch_verified(manifest, wanted)
        parts = []
        for c in wanted:
            b = memoryview(by_digest[c.digest])
            parts.append(b[max(0, start - c.offset):
                           min(c.length, end - c.offset)])
        self.counters.inc("range_downloads")
        return manifest, parts, start, end

    async def download_stream(self, file_id: str):
        """-> (manifest, async generator of chunk payloads in order).
        Chunks are gathered in ~32 MiB batches, so node memory stays about
        one batch. Every chunk is verified, and the whole-file hash is
        checked incrementally with the final chunk held back: a corrupt
        assembly is truncated before its last byte. The first batch is
        fetched before returning, so a missing chunk fails before any
        byte is sent. A cold file read hot enough is promoted in the
        background; this read decodes through the EC path."""
        manifest = await self._resolve_manifest(file_id)
        self._tier_maybe_promote(manifest)
        batches: list[list] = []
        cur: list = []
        size = 0
        for c in manifest.chunks:
            cur.append(c)
            size += c.length
            if size >= self._FETCH_BATCH_BYTES:
                batches.append(cur)
                cur, size = [], 0
        if cur:
            batches.append(cur)
        first = await self._fetch_verified(manifest, batches[0]) \
            if batches else {}

        async def gen():
            nonlocal first
            # readahead (ServeConfig.readahead_batches = K > 0): batches
            # i+1..i+K fetch while batch i drains; memory stays K+1
            # batches. Built here, not before the body starts: batch 0 is
            # fetched above, and a body closed before its first iteration
            # must own no fetch task (an unstarted generator's finally
            # never runs)
            pre: BatchPrefetcher | None = None
            if self.serve.readahead_batches > 0 and len(batches) > 1:
                pre = BatchPrefetcher(
                    batches, lambda b: self._fetch_verified(manifest, b),
                    self.serve.readahead_batches, start=1)
                pre.prime()
            hasher = sha256_new()
            held = None
            total = 0
            try:
                for i, batch in enumerate(batches):
                    if i:
                        got = await (pre.get(i) if pre is not None else
                                     self._fetch_verified(manifest, batch))
                    else:
                        got, first = first, None
                    payloads = [got[c.digest] for c in batch]
                    await asyncio.to_thread(
                        lambda ps=payloads: [hasher.update(p) for p in ps])
                    for b in payloads:
                        if held is not None:
                            total += len(held)
                            yield held
                        held = b
                if hasher.hexdigest() != file_id:
                    raise DownloadError("File corrupted")
                if held is not None:
                    total += len(held)
                    yield held
                self.counters.inc("downloads")
                self.counters.inc("download_bytes", total)
            finally:
                if pre is not None:      # an abandoned body stops fetching
                    await pre.close()

        return manifest, gen()

    async def download(self, file_id: str) -> tuple[Manifest, bytearray]:
        """The whole file as one buffer, through :meth:`download_stream`."""
        manifest, gen = await self.download_stream(file_id)
        out = bytearray()
        with self.obs.span("download.gather", latency=True):
            async for part in gen:
                out += part
        return manifest, out

    # ------------------------------------------------------------------ #
    # metrics
    # ------------------------------------------------------------------ #

    def ingest_stats(self) -> dict:
        ing = self.cfg.ingest
        return {"window": ing.window,
                "flushBytes": self._STREAM_FLUSH_BYTES,
                "creditBytes": ing.credit_bytes,
                "sliceInflight": ing.slice_inflight,
                "stalls": self.ingest_stalls.snapshot(),
                "cas": self.cas.stats()}

    def frag_stats(self) -> dict:
        """``/metrics`` ``frag``: the FragmenterConfig knobs, the engine,
        the device it runs on, the kernel launches of this process and
        where the EC encode ran (``ecEncode``: its device, calls and
        stripes) — what actually runs."""
        from dfs_tpu_torch import kernels

        f = self.cfg.frag
        counts = self.counters.snapshot()
        mesh = getattr(self.fragmenter, "mesh", None)
        device = ",".join(str(d) for d in mesh.flat) if mesh is not None \
            else str(self._ec_device())
        return {"devices": f.devices,
                "regionBytes": f.region_bytes,
                "stagingBuffers": f.staging_buffers,
                "engine": self.fragmenter.name,
                "degraded": False,
                "device": device,
                "launches": kernels.launch_counts(),
                "ecEncode": {"device": self._ec_encode_device,
                             "calls": counts.get("ec_encodes", 0),
                             "stripes": counts.get("ec_encode_stripes",
                                                   0)}}

    def durability_stats(self) -> dict:
        return {"mode": self.cfg.durability.mode,
                "fsyncs": self.store.chunks.fsync_count()}

    def chaos_stats(self) -> dict:
        """``/metrics`` ``chaos``: the active knobs and per-kind injected
        fault counters; ``{"enabled": False}`` without the injector."""
        if self.chaos is None:
            return {"enabled": False}
        return self.chaos.stats()

    async def trace_spans(self, trace_id: str,
                          cluster: bool = True) -> dict:
        """This node's spans of one trace and (``cluster``) every peer's
        through the ``get_trace`` op, merged for the stitcher (``GET
        /trace``, ``trace <id>``). An unreachable peer makes the result
        partial (``peersFailed``), never an error."""
        from dfs_tpu_torch.obs.stitch import merge_spans

        lists: list[list[dict]] = [self.obs.spans_for(trace_id)]
        peers = self._peers() if cluster else []

        async def one(peer) -> list[dict] | None:
            try:
                resp, _ = await self.client.call(
                    peer, {"op": "get_trace", "traceId": trace_id},
                    retries=1)
            except RpcError:
                return None           # counted in peersFailed
            spans = resp.get("spans")
            return spans if isinstance(spans, list) else []

        failed = 0
        for got in await asyncio.gather(*(one(p) for p in peers)):
            if got is None:
                failed += 1
            else:
                lists.append(got)
        return {"traceId": trace_id,
                "slowSpanS": self.cfg.obs.slow_span_s,
                "spans": merge_spans(lists),
                "peersQueried": len(peers), "peersFailed": failed}

    def metrics(self) -> dict:
        """``GET /metrics``: the counters and the sections of dfs_tpu's
        document for the parts ported."""
        snap: dict = self.counters.snapshot()
        snap["nodeId"] = self.cfg.node_id
        snap["underReplicated"] = len(self.under_replicated)
        snap["latency"] = self.latency.snapshot()
        snap["peersAlive"] = self.health.snapshot()
        snap["ingest"] = self.ingest_stats()
        snap["frag"] = self.frag_stats()
        snap["durability"] = self.durability_stats()
        snap["retryBudget"] = self.client.retry_budget.stats()
        snap["ring"] = self.ring_stats()
        snap["census"] = self.census_stats()
        snap["index"] = self.index_stats()
        snap["tier"] = self.tier_stats()
        snap["sim"] = self.sim_stats()
        snap["serve"] = self.serve.stats()
        snap["obs"] = self.obs.stats()
        snap["chaos"] = self.chaos_stats()
        snap["rpcClient"] = {
            f"{p}:{o}": {"count": r[0], "errors": r[1], "retries": r[2],
                         "bytesOut": r[3], "bytesIn": r[4],
                         "seconds": round(r[5], 6)}
            for p, o, r in self.client.rpc_stats.rows()}
        return snap

    def sim_stats(self) -> dict:
        """``/metrics`` ``sim``: ``{"enabled": False}`` without the plane;
        with it the SimConfig fields, the plane's counters and the
        delta-stored chunk count."""
        s = self.cfg.sim
        if self.sim is None:
            return {"enabled": False}
        out = {"enabled": s.enabled,
               "sketchSize": s.sketch_size,
               "bands": s.bands,
               "shingleBytes": s.shingle_bytes,
               "maxCandidates": s.max_candidates,
               "minChunkBytes": s.min_chunk_bytes,
               "minSavingsFrac": s.min_savings_frac,
               "maxDeltaDepth": s.max_delta_depth,
               "devices": s.devices,
               "rematerializeReads": s.rematerialize_reads}
        out.update(self.sim.stats())
        out["deltaChunks"] = self.store.chunks.delta_count()
        out["device"] = str(self.sim.sketcher.device)
        return out

    # ------------------------------------------------------------------ #
    # cluster doctor
    # ------------------------------------------------------------------ #

    def _disk_usage(self) -> dict:
        """Blocking statvfs under the node's data root (call it through
        ``asyncio.to_thread``); {} when it fails, read as unknown."""
        import shutil

        try:
            u = shutil.disk_usage(self.store.root)
            return {"totalBytes": u.total, "freeBytes": u.free}
        except OSError:
            return {}

    async def doctor_snapshot(self) -> dict:
        """This node's diagnosis snapshot, dfs_tpu's document: metric
        summaries, recent journal incidents, disk headroom, config
        fingerprint, wall clock, ring and tier views. Blocking reads run
        off the loop."""
        incidents: list[dict] = []
        if self.obs.journal is not None:
            tail = await asyncio.to_thread(self.obs.journal.tail, 0.0, 64)
            incidents = tail.get("events", [])
        obs_stats = self.obs.stats()
        return {
            "nodeId": self.cfg.node_id,
            "now": time.time(),
            "uptimeS": round(time.time() - self._started_at, 3),
            "configHash": self._config_hash,
            "chunks": await asyncio.to_thread(self.store.chunks.count),
            "files": len(self.store.manifests.ids()),
            "peersAlive": self.health.snapshot(),
            "underReplicated": len(self.under_replicated),
            "admission": self.serve.admission.stats(),
            "hedge": self.serve.hedge.stats()
            if self.serve.hedge is not None else {"enabled": False},
            "cache": self.serve.cache.stats()
            if self.serve.cache is not None else {"enabled": False},
            "ingestStalls": self.ingest_stalls.snapshot(),
            "cas": self.cas.stats(),
            "sentinel": obs_stats["sentinel"],
            "journal": obs_stats["journal"],
            "rpcClient": obs_stats["rpcClient"],
            "counters": self.counters.snapshot(),
            "incidents": incidents,
            "disk": await asyncio.to_thread(self._disk_usage),
            # the capacity_trend rule's slope and the last census this
            # node coordinated (the underreplication rule)
            "capacity": self._capacity_summary(),
            "census": self._last_census,
            "index": {"enabled": False} if self.index is None else {
                "enabled": True,
                "syncS": self.cfg.index.filter_sync_s,
                "peerAgeS": {str(p): round(a, 3) for p, a in
                             sorted(self.index.peer_filters.ages()
                                    .items())}},
            # the epoch_mismatch and rebalance_stuck evidence
            "ring": {"epoch": self.ring.epoch,
                     "migrating": self.ring.migrating,
                     **{k: v for k, v in
                        self.ring.rebalance_stats().items()
                        if k in ("sinceProgressS", "bytesMoved",
                                 "dualReadHits")}},
            "tier": {"enabled": False} if self.tier is None else {
                "enabled": True,
                "scanIntervalS": self.cfg.tier.scan_interval_s,
                "sinceProgressS": round(
                    time.monotonic() - self.tier.last_progress_at, 3),
                "errors": self.tier.errors,
                "scans": self.tier.scans},
        }

    async def doctor_report(self, cluster: bool = True) -> dict:
        """``GET /doctor``: this node's snapshot and (``cluster``) every
        peer's through ``get_doctor`` (one fast attempt each), then
        dfs_tpu's rule table over them. A peer that cannot answer is a
        ``dead_peer`` finding, never an error."""
        from dfs_tpu_torch.obs.doctor import diagnose

        snaps: dict[int, dict | None] = {
            self.cfg.node_id: await self.doctor_snapshot()}
        # clock_skew compares each snapshot against the moment it arrived
        snaps[self.cfg.node_id]["receivedAt"] = time.time()
        failed = 0
        peers = self._peers() if cluster else []

        async def one(peer) -> tuple[int, dict | None]:
            try:
                resp, _ = await self.client.call(
                    peer, {"op": "get_doctor"}, retries=1)
                d = resp.get("doctor")
                if isinstance(d, dict):
                    d["receivedAt"] = time.time()
                    return peer.node_id, d
                return peer.node_id, None
            except RpcError:
                return peer.node_id, None   # the dead_peer finding

        for nid, snap in await asyncio.gather(*(one(p) for p in peers)):
            snaps[nid] = snap
            if snap is None:
                failed += 1
        now = time.time()
        findings = diagnose(snaps, coordinator_now=now)
        return {"coordinator": self.cfg.node_id, "now": now,
                "peersFailed": failed,
                "nodes": {str(k): v for k, v in sorted(snaps.items())},
                "findings": findings}

    # ------------------------------------------------------------------ #
    # census and capacity plane
    # ------------------------------------------------------------------ #

    # per-bucket digest-list cap of a census drill-down
    _CENSUS_LIST_CAP = 4096
    # disk_pressure fires crossing below 5% free and re-arms above 10%
    _DISK_PRESSURE_FRACTION = 0.05
    # counters the history sampler tracks (rates come from differencing)
    _HISTORY_COUNTERS = ("http_requests", "uploads", "downloads",
                         "upload_bytes", "download_bytes",
                         "chunks_stored", "bytes_stored", "dedup_hits",
                         "replication_failures", "http_shed")

    async def _history_loop(self) -> None:
        interval = self.cfg.census.history_interval_s
        while True:
            await asyncio.sleep(interval)
            try:
                await self._history_sample_once()
            except Exception as e:  # noqa: BLE001 — the next tick retries
                self.log.warning("census history sample failed: %s", e)

    async def _history_sample_once(self) -> None:
        """One history tick: the selected counters and gauges into the
        two-resolution ring; disk and CAS reads run off the loop."""
        h = self.history
        now = time.time()
        c = self.counters.snapshot()
        for k in self._HISTORY_COUNTERS:
            h.observe(f"counter.{k}", c.get(k, 0), now)
        h.observe("cas.pending", self.cas.pending, now)
        h.observe("ingest.creditS",
                  self.ingest_stalls.snapshot().get("creditS", 0.0), now)
        cache = self.serve.cache
        if cache is not None:
            cs = cache.stats()
            h.observe("cache.hits", cs["hits"], now)
            h.observe("cache.misses", cs["misses"], now)
            h.observe("cache.bytes", cs["bytes"], now)
        calls = secs = 0
        for _, _, row in self.obs.rpc_client.rows():
            calls += row[0]
            secs += row[5]
        h.observe("rpc.clientCalls", calls, now)
        h.observe("rpc.clientSeconds", secs, now)
        h.observe("capacity.casBytes",
                  await asyncio.to_thread(self.store.chunks.bytes_total),
                  now)
        h.observe("capacity.casChunks",
                  await asyncio.to_thread(self.store.chunks.count), now)
        disk = await asyncio.to_thread(self._disk_usage)
        if disk:
            h.observe("capacity.diskFreeBytes", disk["freeBytes"], now)
            h.observe("capacity.diskTotalBytes", disk["totalBytes"], now)
            frac = disk["freeBytes"] / max(1, disk["totalBytes"])
            if frac < self._DISK_PRESSURE_FRACTION:
                if not self._disk_pressure:
                    self._disk_pressure = True
                    self.obs.event("disk_pressure",
                                   freeBytes=disk["freeBytes"],
                                   totalBytes=disk["totalBytes"])
            elif frac >= 2 * self._DISK_PRESSURE_FRACTION:
                self._disk_pressure = False

    def _capacity_summary(self) -> dict:
        """The history's last capacity gauges and the CAS growth slope
        (the doctor's capacity_trend material); never a scan."""
        h = self.history
        if h is None:
            return {"enabled": False}
        return {"enabled": True,
                "casBytes": h.last("capacity.casBytes"),
                "casChunks": h.last("capacity.casChunks"),
                "diskFreeBytes": h.last("capacity.diskFreeBytes"),
                "diskTotalBytes": h.last("capacity.diskTotalBytes"),
                "growthBytesPerS": h.trend("capacity.casBytes")}

    def census_stats(self) -> dict:
        """``/metrics`` ``census``: the CensusConfig fields, the sampler's
        state, the capacity summary and the last census."""
        c = self.cfg.census
        return {"historyIntervalS": c.history_interval_s,
                "historySlots": c.history_slots,
                "coarseEvery": c.history_coarse_every,
                "coarseSlots": c.history_coarse_slots,
                "maxListed": c.max_listed,
                "history": self.history.stats()
                if self.history is not None else {"enabled": False},
                "capacity": self._capacity_summary(),
                "lastCensus": self._last_census}

    async def census_inventory(self, prefixes=None) -> dict:
        """This node's census contribution: the bucketed CAS inventory
        (one read-pool job), disk headroom and the serve cache's top-K
        temperature; ``prefixes`` adds member lists of those buckets."""
        inv = await self.cas.inventory(prefixes,
                                       list_cap=self._CENSUS_LIST_CAP)
        inv["nodeId"] = self.cfg.node_id
        inv["disk"] = await asyncio.to_thread(self._disk_usage)
        cache = self.serve.cache
        inv["cacheTemperature"] = cache.temperature() \
            if cache is not None else []
        return inv

    async def census_report(self, cluster: bool = True) -> dict:
        """``GET /census``: every peer's ``get_census`` summary (one fast
        attempt each, partial on dead peers), compared with the
        expectation from this node's manifests and ring (the previous
        epoch's owners join it mid-migration), the mismatched buckets
        drilled down, then the replication histogram and bounded
        under-replicated, orphaned and over-replicated lists, with the
        capacity (``df``) section. Findings are journaled
        (``census_underreplicated``, ``census_orphan``)."""
        from dfs_tpu_torch.obs import census as census_mod

        rf = self.cfg.cluster.replication_factor
        cur_ring = self.ring.current
        prev_ring = self.ring.previous
        manifests = await asyncio.to_thread(self.store.manifests.list)
        expected, cur_expected, lengths, logical = \
            await asyncio.to_thread(census_mod.expected_state_ring,
                                    manifests, cur_ring, prev_ring, rf)
        peers = self._peers() if cluster else []
        inventories: dict[int, dict | None] = {
            self.cfg.node_id: await self.census_inventory()}

        async def one(peer) -> tuple[int, dict | None]:
            try:
                inv = await self.client.get_census(peer, retries=1)
                return peer.node_id, inv if isinstance(inv, dict) else None
            except RpcError:
                return peer.node_id, None   # counted in peersFailed

        for nid, inv in await asyncio.gather(*(one(p) for p in peers)):
            inventories[nid] = inv
        failed = sum(1 for v in inventories.values() if v is None)

        # drill only the buckets whose summary differs from expectation
        exp_by_node = await asyncio.to_thread(
            census_mod.summarize_expected, expected, lengths)
        drill_want: dict[int, list[str]] = {}
        for nid, inv in inventories.items():
            if inv is None:
                continue
            mism = census_mod.diff_buckets(
                exp_by_node.get(nid, {}), inv.get("buckets") or {})
            if mism:
                drill_want[nid] = mism[:census_mod.DRILL_BUCKET_CAP]

        async def drill(nid: int, want: list[str]) -> tuple[int, dict]:
            if nid == self.cfg.node_id:
                inv = await self.cas.inventory(
                    want, list_cap=self._CENSUS_LIST_CAP)
                return nid, inv.get("listed") or {}
            try:
                inv = await self.client.get_census(
                    self.cfg.cluster.peer(nid), prefixes=want, retries=1)
                return nid, (inv or {}).get("listed") or {}
            except RpcError:
                return nid, {}    # reported as uncheckedBuckets

        drilled: dict[int, dict] = {}
        for nid, listed in await asyncio.gather(
                *(drill(n, w) for n, w in drill_want.items())):
            drilled[nid] = listed

        report = await asyncio.to_thread(
            census_mod.build_report, expected, lengths, inventories,
            drilled, self.cfg.census.max_listed, cur_expected)
        report["ringEpoch"] = cur_ring.epoch
        report["migrating"] = prev_ring is not None

        nodes_cap: dict[str, dict | None] = {}
        cluster_bytes = cluster_chunks = 0
        for nid in sorted(inventories):
            inv = inventories[nid]
            if inv is None:
                nodes_cap[str(nid)] = None
                continue
            disk = inv.get("disk") or {}
            nodes_cap[str(nid)] = {
                "casBytes": inv.get("bytes", 0),
                "casChunks": inv.get("chunks", 0),
                "diskFreeBytes": disk.get("freeBytes"),
                "diskTotalBytes": disk.get("totalBytes"),
                "cacheTemperature": inv.get("cacheTemperature") or []}
            cluster_bytes += inv.get("bytes", 0)
            cluster_chunks += inv.get("chunks", 0)
        unique_bytes = sum(lengths.values())
        report["capacity"] = {
            "nodes": nodes_cap,
            "clusterCasBytes": cluster_bytes,
            "clusterChunks": cluster_chunks,
            "logicalBytes": logical,
            "uniqueBytes": unique_bytes,
            "dedupRatio": round(logical / unique_bytes, 6)
            if unique_bytes else 0.0}
        report["coordinator"] = self.cfg.node_id
        report["now"] = time.time()
        report["peersFailed"] = failed

        if report["underReplicatedTotal"]:
            self.obs.event(
                "census_underreplicated",
                count=report["underReplicatedTotal"],
                sample=[f["digest"][:12]
                        for f in report["underReplicated"][:4]])
        if report["orphanedTotal"]:
            self.obs.event(
                "census_orphan", count=report["orphanedTotal"],
                sample=[f["digest"][:12]
                        for f in report["orphaned"][:4]])
        self._last_census = {"at": report["now"],
                             "underReplicated":
                             report["underReplicatedTotal"],
                             "orphaned": report["orphanedTotal"],
                             "overReplicated":
                             report["overReplicatedTotal"],
                             "peersFailed": failed}
        self.counters.inc("census_runs")
        return report

    # ------------------------------------------------------------------ #
    # listing, delete, anti-entropy, repair, scrub
    # ------------------------------------------------------------------ #

    def list_files(self) -> list[dict]:
        return [{"fileId": m.file_id, "name": m.name, "size": m.size,
                 "chunks": m.total_chunks, "fragmenter": m.fragmenter}
                for m in self.store.manifests.list()]

    def _forget_file(self, file_id: str, ts: float | None = None,
                     gc: bool = True) -> bool:
        """Tombstone a manifest and (``gc``) sweep the chunks no manifest
        references any more. ``ts`` carries an origin deletion time. With
        the cache on, the file's digests leave it too: it may hold chunks
        this node only fetched from peers, which the GC cannot name."""
        m = self.store.manifests.load(file_id) \
            if self.serve.cache is not None else None
        found = self.store.manifests.delete(file_id, ts=ts)
        if gc:
            self.serve.drop_cached(self.store.gc())
        if m is not None:
            self.serve.drop_cached(m.all_digests())
        return found

    async def delete(self, file_id: str) -> bool:
        found = await asyncio.to_thread(self._forget_file, file_id)

        async def forget(peer) -> None:
            try:
                await self.client.call(peer, {"op": "delete",
                                              "fileId": file_id})
            except RpcError:
                # converges later through tombstone anti-entropy; the
                # journal dates the window a peer kept serving the file
                self.counters.inc("delete_propagate_failures")
                self.obs.event("delete_propagate_fail", peer=peer.node_id,
                               fileId=file_id[:12])

        await asyncio.gather(*(forget(p) for p in self._peers()))
        return found

    async def _tombstone_antientropy(self) -> int:
        """Pull peers' tombstones and converge last-writer-wins: a node
        that slept through a delete applies it (with its origin time)
        before it re-replicates; a tombstone older than our manifest is
        answered by re-announcing the manifest (fresh) instead. Returns
        the number applied."""
        known = set(self.store.manifests.tombstones())
        applied = 0
        for peer in self._peers():
            try:
                resp, _ = await self.client.call(peer, {"op": "tombstones"},
                                                 retries=1)
                self.health.mark_alive(peer.node_id)
            except RpcError:
                self.counters.inc("antientropy_rpc_failures")
                continue
            for t in resp.get("tombs", []):
                fid, ts = t.get("id"), t.get("ts")
                if fid in known or not isinstance(fid, str) \
                        or not is_hex_digest(fid) or ts is None:
                    continue
                try:
                    ts = float(ts)
                except (TypeError, ValueError):
                    continue
                if not math.isfinite(ts):
                    continue
                local_mtime = self.store.manifests.mtime(fid)
                if local_mtime is not None and local_mtime > ts:
                    m = self.store.manifests.load(fid)
                    if m is not None:
                        try:
                            await self.client.announce(peer, m.to_json(),
                                                       fresh=True)
                        except RpcError:
                            self.counters.inc("antientropy_rpc_failures")
                    continue
                await asyncio.to_thread(self._forget_file, fid, ts, False)
                known.add(fid)
                applied += 1
        if applied:
            self.serve.drop_cached(await asyncio.to_thread(self.store.gc))
            self.log.info("anti-entropy: applied %d tombstones", applied)
        return applied

    async def _manifest_antientropy(self) -> int:
        """Adopt manifests this node missed (announce is best-effort),
        keeping their origin mtime; tombstoned ids are skipped. Returns the
        number adopted."""
        known = set(self.store.manifests.ids())
        adopted = 0
        for peer in self._peers():
            try:
                resp, _ = await self.client.call(
                    peer, {"op": "list_manifests"}, retries=1)
                self.health.mark_alive(peer.node_id)
            except RpcError:
                self.counters.inc("antientropy_rpc_failures")
                continue
            for fid in resp.get("ids", []):
                if (fid in known or not isinstance(fid, str)
                        or not is_hex_digest(fid)
                        or self.store.manifests.is_tombstoned(fid)):
                    continue
                try:
                    mj, mt = await self.client.get_manifest(peer, fid)
                except RpcError:
                    self.counters.inc("antientropy_rpc_failures")
                    continue
                if not mj:
                    continue
                try:
                    m = Manifest.from_json(mj)
                except (ValueError, KeyError):
                    continue              # a corrupt peer manifest
                if m.file_id == fid and await asyncio.to_thread(
                        self.store.manifests.save, m, mt):
                    known.add(fid)
                    adopted += 1
        if adopted:
            self.log.info("anti-entropy: adopted %d manifests", adopted)
        return adopted

    async def repair_once(self) -> int:
        """One repair cycle, serialized (the periodic loop and the
        install-time rebalance kick must not interleave two walks):
        tombstone anti-entropy first (so a deleted file is never pushed
        back), manifest anti-entropy second, then restore this node's own
        missing copies (an EC shard by decode when no node holds it), push
        each owner or stripe holder what it lacks (verified by hash echo),
        move confirmed handoff copies home (never an EC shard), and sweep
        aged orphans. Returns the chunks repaired or moved.

        It is also the online rebalancer, as in dfs_tpu: after an epoch
        change the same walk places against the new owner map; during the
        migration window each digest has one designated mover (the first
        alive previous-epoch holder), every push and every pull of this
        node's own share is charged against the ring's byte credits and
        counted as moved, and a walk that confirmed every current-epoch
        owner of every digest, with this node's own copies whole and the
        maps unchanged since it began, closes the window."""
        async with self._repair_lock:
            return await self._repair_once_locked()

    async def _repair_once_locked(self) -> int:
        await self._tombstone_antientropy()
        await self._manifest_antientropy()
        # one placement snapshot for the whole walk: a map adopted
        # mid-walk takes effect next cycle and blocks finish_migration
        cur = self.ring.current
        prev = self.ring.previous
        migrating = prev is not None
        rf = self.cfg.cluster.replication_factor
        me = self.cfg.node_id
        need: dict[int, list[tuple[str, int]]] = {}
        chunk_len: dict[str, int] = {}
        own_missing: dict[str, int] = {}
        own_missing_ec: list[tuple[Manifest, list[ChunkRef]]] = []
        ec_digests: set[str] = set()
        stray: dict[str, frozenset[int]] = {}
        # previous-epoch holders of EC shards (the designated-mover order);
        # replicated digests walk the previous ring on demand
        prev_ec_holders: dict[str, tuple[int, ...]] = {}

        def designated_mover(d: str) -> bool:
            """Mid-migration exactly one node pushes a digest to its new
            owners: the first alive previous-epoch holder (a digest no
            previous holder survives for is pushed by whoever holds it).
            Outside a migration every node pushes."""
            if not migrating:
                return True
            holders = prev_ec_holders.get(d)
            if holders is None:
                holders = prev.owners(d, rf)
            for p in holders:
                if p == me:
                    return True
                if self.health.is_alive(p):
                    return False
            return True

        local_digests = set(await asyncio.to_thread(
            self.store.chunks.digests))
        for m in self.store.manifests.list():
            if m.ec is not None:
                # EC shards live at their stripe holders, one copy each; a
                # holder missing its shard regenerates it here by decode
                # (the push loop below moves surviving copies only)
                pl = ec_placement_map(m, cur)
                pl_prev = ec_placement_map(m, prev) if migrating else {}
                miss: dict[str, int] = {}
                for d, ln in ec_shard_items(m):
                    chunk_len[d] = ln
                    ec_digests.add(d)
                    if migrating:
                        prev_ec_holders.setdefault(
                            d, tuple(pl_prev.get(d, ())))
                    for target in pl[d]:
                        if target != me:
                            need.setdefault(target, []).append((d, ln))
                        elif d not in local_digests:
                            miss[d] = ln
                if miss:
                    own_missing_ec.append(
                        (m, [ChunkRef(index=0, offset=0, length=ln,
                                      digest=d)
                             for d, ln in miss.items()]))
                continue
            for c in m.chunks:
                chunk_len[c.digest] = c.length
                targets = cur.owners(c.digest, rf)
                for target in targets:
                    if target != me:
                        need.setdefault(target, []).append(
                            (c.digest, c.length))
                    elif c.digest not in local_digests:
                        own_missing[c.digest] = c.length
                if me not in targets and c.digest in local_digests:
                    stray[c.digest] = frozenset(targets)

        async def restore_missing(manifest: Manifest | None,
                                  refs: list[ChunkRef]) -> tuple[int, bool]:
            """This node's missing copies, gathered in bounded batches
            (with the manifest: EC shards decode) and put locally. During
            a migration each batch is charged against the byte credits
            and counted as moved: the joiner's pull is the bulk of an
            add. Returns (restored, every ref came back)."""
            n = 0
            ok = True
            batch: list[ChunkRef] = []
            size = 0

            async def flush() -> None:
                nonlocal n, ok, batch, size
                if not batch:
                    return
                if migrating:
                    self.ring.note_credit_stall(
                        await self.ring.credits.acquire(size))
                got = await self._gather_chunks(manifest, chunks=batch,
                                                strict=False)
                items = list(got.items())
                stored = await self.cas.put_many(items, verify=False)
                for (d, _), newly in zip(items, stored):
                    self.under_replicated.discard(d)
                    if newly:
                        self.counters.inc("chunks_stored")
                n += len(items)
                ok = ok and {r.digest for r in batch} <= set(got)
                if migrating and got:
                    self.ring.note_moved(
                        sum(len(b) for b in got.values()), pushes=0)
                batch, size = [], 0

            for r in refs:
                batch.append(r)
                size += r.length
                if size >= self._FETCH_BATCH_BYTES:
                    await flush()
            await flush()
            return n, ok

        repaired = 0
        own_restored = True       # did every own-copy restore succeed?
        if own_missing:
            n_restored, own_restored = await restore_missing(
                None, [ChunkRef(index=0, offset=0, length=ln, digest=d)
                       for d, ln in own_missing.items()])
            repaired += n_restored
        for m, refs in own_missing_ec:
            n_restored, ok = await restore_missing(m, refs)
            repaired += n_restored
            own_restored = own_restored and ok
        verified: set[str] = set()
        # digest -> owners that CONFIRMED their copy this cycle: a stray
        # local copy is deleted only once all its owners confirmed, and the
        # migration window closes only once every owner confirmed
        confirmed: dict[str, set[int]] = {}
        plane = self.index
        for node_id, wanted in need.items():
            peer = self.cfg.cluster.peer(node_id)
            digests = sorted({d for d, _ in wanted})
            # the peer's filter trims the probe: what it rules out is
            # pushed unprobed (the push's hash echo confirms it); positives
            # are always probed, since relocation deletes strays on
            # confirmations and a bloom "maybe" must never stand for one
            probe_digests = digests
            filter_known = (plane is not None
                            and plane.local_filter is not None
                            and plane.peer_filters.state(node_id)
                            is not None)
            if filter_known:
                probe_digests = [
                    d for d in digests
                    if plane.peer_filters.contains(node_id, d)
                    is not False]
                plane.probes_skipped += len(digests) - len(probe_digests)
            try:
                have: set[str] = set()
                if probe_digests:
                    have = await self.client.has_chunks(peer,
                                                        probe_digests)
                    if filter_known:
                        for d in probe_digests:
                            if d not in have:
                                plane.peer_filters.note_fp(node_id, d)
                elif digests:
                    plane.probe_rpcs_skipped += 1
                verified |= have
                for d in have:
                    confirmed.setdefault(d, set()).add(node_id)
                to_push = sorted(set(digests) - have)
                if migrating:
                    # one mover per digest: a membership change moves each
                    # byte once across the cluster, not once per node
                    to_push = [d for d in to_push if designated_mover(d)]
                local = dict(await self.cas.get_many(to_push))
                payload = []
                for d in to_push:
                    b = local.get(d)
                    if b is None:
                        if d in ec_digests:
                            # stripe-placed, not on the digest ring the
                            # per-chunk walk follows; a shard no node holds
                            # is its holder's decode job (own_missing_ec)
                            continue
                        try:
                            b = await self._fetch_chunk(d, chunk_len[d])
                        except DownloadError:
                            continue      # stays queued; next cycle
                    payload.append((d, b))
                # serial slices: repair must not compete with live ingest
                for part in self._slice_payloads(
                        payload, self._REPLICA_SLICE_BYTES):
                    if migrating:
                        # the rebalance byte credits bound migration pushes
                        self.ring.note_credit_stall(
                            await self.ring.credits.acquire(
                                sum(len(b) for _, b in part)))
                    echoed = set(await self.client.store_chunks(
                        peer, "", part))
                    ok = {d for d, _ in part} & echoed
                    repaired += len(ok)
                    verified |= ok
                    for d in ok:
                        confirmed.setdefault(d, set()).add(node_id)
                    if migrating and ok:
                        self.ring.note_moved(
                            sum(len(b) for d, b in part if d in ok),
                            pushes=1)
            except RpcError as e:
                self.log.warning("repair push to node %d failed: %s",
                                 node_id, e)
                self.counters.inc("repair_push_failures")
                self.obs.event("repair_push_fail", peer=node_id,
                               cause=type(e).__name__)
        self.under_replicated -= verified
        # EC shards are pinned to their stripe holders: never relocated
        for d in ec_digests:
            stray.pop(d, None)

        def relocate() -> list[str]:
            return [d for d, holders in stray.items()
                    if holders <= confirmed.get(d, set())
                    and self.store.chunks.delete(d)]

        relocated = await asyncio.to_thread(relocate) if stray else []
        if relocated:
            self.serve.drop_cached(relocated)
            self.counters.inc("relocated_chunks", len(relocated))
        # migration completion: this walk probed every current-epoch owner
        # of every digest this node's manifests reference; when each one
        # confirmed its copy and this node's own copies are whole, the data
        # reached its new homes and the dual-read window closes. A walk
        # that skipped a dead peer or lost a push leaves it open, and a map
        # adopted mid-walk makes the next cycle judge again
        if migrating and self.ring.current is cur \
                and self.ring.previous is prev:
            complete = own_restored and all(
                all(node_id in confirmed.get(d, ())
                    for d, _ in wanted)
                for node_id, wanted in need.items())
            if complete:
                self.ring.finish_migration()
        # chunks of aborted streams (placed, never committed): the hour of
        # grace keeps in-flight uploads safe
        swept = await asyncio.to_thread(self.store.gc, 3600.0)
        if swept:
            self.serve.drop_cached(swept)
            self.log.info("gc: swept %d aged orphan chunks", len(swept))
        if repaired or swept or relocated:
            # the repair and GC decisions a post-mortem needs dated
            self.obs.event("repair", repaired=repaired,
                           sweptOrphans=len(swept),
                           relocated=len(relocated),
                           underReplicated=len(self.under_replicated))
        self.counters.inc("repairs")
        return repaired

    async def scrub_once(self) -> dict:
        """Re-hash every local chunk; delete the ones that no longer hash
        to their digest and queue them for repair. A delta whose base
        chain is broken queues the first unresolvable base instead; a
        corrupt base takes its dependent deltas with it."""
        scanned = corrupt = delta_missing_base = 0
        ch = self.store.chunks
        digests = await asyncio.to_thread(ch.digests)
        for i in range(0, len(digests), 64):
            def read_and_hash(ds=digests[i:i + 64]) -> list[tuple[str, str]]:
                # delta residency before the read tells an absent read
                # apart: a delta get() dropped as corrupt looks like a raw
                # chunk deleted mid-scrub otherwise
                pre = {d: ch.delta_base(d) for d in ds} \
                    if ch.delta_count() else {}
                blobs = [(d, ch.get(d)) for d in ds]
                present = [(d, b) for d, b in blobs if b is not None]
                hexes = sha256_many_hex([b for _, b in present])
                okmap = {d: h == d for (d, _), h in zip(present, hexes)}
                out = []
                for d, b in blobs:
                    if b is not None:
                        out.append((d, "ok" if okmap[d] else "corrupt"))
                    elif pre.get(d):
                        if ch.delta_base(d):
                            cur = d     # the first unresolvable link
                            while (nb := ch.delta_base(cur)) is not None:
                                cur = nb
                            out.append((d, f"base:{cur}"))
                        else:
                            out.append((d, "corrupt"))   # get() dropped it
                return out

            for d, status in await asyncio.to_thread(read_and_hash):
                scanned += 1
                if status == "ok":
                    continue
                if status.startswith("base:"):
                    delta_missing_base += 1
                    self.under_replicated.add(status[5:])
                    self.log.warning("scrub: delta %s missing base %s — "
                                     "queued for repair", d[:12],
                                     status[5:17])
                    continue
                corrupt += 1
                if not ch.delete(d) and ch.delta_pinned(d):
                    # a corrupt pinned base: its dependents reconstruct
                    # through the rotten bytes, so they go too (deepest
                    # first, each delete releasing the next pin)
                    for dep in ch.delta_dependents(d):
                        if ch.delete(dep):
                            self.serve.drop_cached([dep])
                            self.under_replicated.add(dep)
                    ch.delete(d)
                self.serve.drop_cached([d])
                self.under_replicated.add(d)
                self.log.warning("scrub: corrupt chunk %s deleted", d[:12])
        self.counters.inc("scrubs")
        if corrupt:
            self.counters.inc("scrub_corrupt", corrupt)
            self.obs.event("scrub_corrupt", scanned=scanned,
                           corrupt=corrupt)
        if delta_missing_base:
            self.counters.inc("scrub_delta_missing_base", delta_missing_base)
        out = {"scanned": scanned, "corrupt": corrupt,
               "deltaMissingBase": delta_missing_base}
        if self.index is not None:
            out.update(await asyncio.to_thread(self._scrub_index_heal,
                                               digests))
        return out

    def _scrub_index_heal(self, cas_digests: list[str]) -> dict:
        """Heal the digest index against the CAS walk the scrub just paid
        for, in both directions: digests on disk the index never heard of
        (a lost WAL tail) become present; digests the index calls present
        that the walk cannot find (a missed delete record) are expunged —
        the dangerous direction, since a stale "present" makes
        ``has_chunks`` vouch for bytes that do not exist. The disk side is
        re-listed, so a chunk stored mid-scrub is never expunged. Worker
        thread."""
        on_disk = set(self.store.chunks.digests())
        on_disk.update(cas_digests)
        in_index = {d.hex() for d in self.index.lsi.present_digests()}
        missing = on_disk - in_index
        phantom = in_index - on_disk
        for d in missing:
            self.index.note_put(d)
        for d in phantom:
            self.index.note_delete(d)
        if missing or phantom:
            self.counters.inc("index_healed_missing", len(missing))
            self.counters.inc("index_healed_phantom", len(phantom))
            self.obs.event("index_healed", missing=len(missing),
                           phantom=len(phantom))
            self.log.warning("scrub: index healed (%d missing, %d phantom)",
                             len(missing), len(phantom))
        return {"healedMissing": len(missing),
                "healedPhantom": len(phantom)}

    # ------------------------------------------------------------------ #
    # hot/cold tiering plane
    # ------------------------------------------------------------------ #

    async def _tier_loop(self) -> None:
        """Periodic demotion scan (``tier.scan_interval_s > 0``).
        Background work: no request deadline, and a scan already in
        flight sheds the next tick instead of stacking."""
        from dfs_tpu_torch.serve import ShedError

        deadline.clear()
        while True:
            await asyncio.sleep(self.cfg.tier.scan_interval_s)
            try:
                await self.tier_scan_once()
            except ShedError:
                continue          # a POST /tier holds the single slot
            except (RpcError, OSError, DownloadError) as e:
                self.tier.errors += 1
                self.obs.event("tier_error", where="scan", error=str(e))
                self.log.warning("tier scan failed: %s", e)

    async def tier_scan_once(self) -> dict:
        """One demotion scan (``POST /tier``, the worker loop): classify
        every replicated file by temperature, demote the cold tail to EC,
        and finish earlier demotions whose surplus reclaim was
        interrupted. Raises ShedError when a scan is already running (HTTP
        503 + Retry-After)."""
        from dfs_tpu_torch.tier import classify

        plane = self.tier
        cfg = self.cfg.tier
        deadline.clear()          # background work: no request budget
        async with plane.gate.slot():
            out = {"scanned": 0, "cold": 0, "demoted": 0,
                   "finished": 0, "skipped": None}
            if self.ring.migrating:
                # a rebalance moves ownership under the dual-read window:
                # demotion waits for stable ground
                out["skipped"] = "migrating"
                return out
            if cfg.ec_k + 2 > len(self.ring.node_ids()):
                out["skipped"] = "ring too small for ec stripes"
                return out
            now = time.time()
            manifests = await asyncio.to_thread(self.store.manifests.list)
            entries: list[dict] = []
            by_id: dict[str, Manifest] = {}
            cold_done: list[Manifest] = []
            for m in manifests:
                if m.tier == "cold":
                    cold_done.append(m)
                    continue
                if m.ec is not None:
                    continue      # a user-chosen EC layout is not ours
                heat, last = plane.ledger.file_temperature(
                    (c.digest for c in m.chunks), now=now)
                entries.append({"fileId": m.file_id, "bytes": m.size,
                                "heat": heat, "lastAccess": last})
                by_id[m.file_id] = m
            # the budget base counts the already-cold bytes too: the hot
            # set is a fraction of the corpus, not of what is left
            cold = classify(entries, cfg.hot_fraction, cfg.min_idle_s,
                            now=now,
                            total_bytes=(sum(e["bytes"] for e in entries)
                                         + sum(m.size for m in cold_done)))
            out["scanned"] = len(entries)
            out["cold"] = len(cold)
            for fid in sorted(cold):
                if fid in self._tier_promoting:
                    continue      # a racing promotion wins: it has reads
                if plane.in_redemote_cooldown(fid, now=now):
                    out["cooldown"] = out.get("cooldown", 0) + 1
                    continue
                try:
                    if await self._demote_file(by_id[fid]):
                        out["demoted"] += 1
                except (RpcError, OSError, DownloadError,
                        UploadError) as e:
                    # one unreachable replica set must not starve the scan
                    plane.errors += 1
                    self.obs.event("tier_error", where="demote",
                                   fileId=fid, error=str(e))
                    self.log.warning("tier demote %s failed: %s",
                                     fid[:12], e)
            # finish pass: idempotent, skipped once confirmed clean at this
            # ring epoch
            for m in cold_done:
                if self._tier_surplus_done.get(m.file_id) \
                        == self.ring.epoch:
                    continue
                try:
                    await self._tier_delete_surplus(m)
                    out["finished"] += 1
                except (RpcError, OSError) as e:
                    plane.errors += 1
                    self.obs.event("tier_error", where="finish",
                                   fileId=m.file_id, error=str(e))
                    self.log.warning("tier finish %s failed: %s",
                                     m.file_id[:12], e)
            plane.scans += 1
            plane.last_scan_at = now
            plane.note_progress()
            await asyncio.to_thread(plane.snapshot_ledger)
            self.obs.event("tier_scan", scanned=out["scanned"],
                           cold=out["cold"], demoted=out["demoted"],
                           finished=out["finished"])
            return out

    async def _demote_file(self, m: Manifest) -> bool:
        """Demote one cold replicated file to EC: gather its bytes, encode
        P+Q on the node's device (:meth:`_ec_extend_from`), place data and
        parity at their stripe holders, commit the cold manifest (the
        durable tier flip), flip the index tier bits, then reclaim the
        surplus replicas. Parity before the flip and the flip before the
        deletes, so a crash anywhere leaves the file readable: the crash
        points ``demote.after_parity_write`` and ``demote.after_tier_flip``
        sit after each step (``demote.before_replica_delete`` opens
        :meth:`_tier_delete_surplus`)."""
        import dataclasses as _dc

        plane = self.tier
        plane.note_credit_stall(await plane.credits.acquire(m.size))
        data = await self._gather_chunks(m)
        cold_m, parity = await asyncio.to_thread(
            self._ec_extend_from, _dc.replace(m, tier="cold"), data,
            self.cfg.tier.ec_k)
        seen: set[str] = set()
        batch: list[tuple[str, bytes]] = []
        for c in m.chunks:
            if c.digest not in seen:
                seen.add(c.digest)
                batch.append((c.digest, data[c.digest]))
        for d, b in parity:
            if d not in seen:     # k=1 makes Q == P
                seen.add(d)
                batch.append((d, b))
        stats = self._new_upload_stats()
        placement = ec_placement_map(cold_m, self.ring.current)
        await self._place_batch(m.file_id, batch, stats, rf=1,
                                placement=placement)
        if self.chaos is not None:
            self.chaos.maybe_crash("demote.after_parity_write")
        # the commit: a tombstone landing mid-demotion wins
        if not await asyncio.to_thread(self.store.manifests.save, cold_m):
            return False
        if self.index is not None:
            def flip() -> None:
                for d in sorted({c.digest for c in m.chunks}):
                    self.index.note_tier(d, True)
            await asyncio.to_thread(flip)
        if self.chaos is not None:
            self.chaos.maybe_crash("demote.after_tier_flip")
        await self._announce_all(cold_m)
        pbytes = sum(len(b) for _, b in parity)
        plane.demoted_files += 1
        plane.demoted_bytes += m.size
        plane.parity_bytes += pbytes
        plane.note_progress()
        self.counters.inc("tier_demotions")
        self.obs.event("tier_demote", fileId=m.file_id, bytes=m.size,
                       parityBytes=pbytes)
        await self._tier_delete_surplus(cold_m)
        return True

    async def _tier_delete_surplus(self, m: Manifest) -> tuple[int, int]:
        """Reclaim the replica copies the cold layout no longer expects:
        locally by the same re-derivation peers use (a digest shared with
        a hot manifest keeps its replicas), remotely through
        ``delete_chunks``, where each peer refuses what it still owns by
        its own manifests. A refusal (a peer that missed the cold
        announce) re-announces and leaves the file for the next scan's
        finish pass. Returns (removed, refused) across the cluster."""
        if self.chaos is not None:
            self.chaos.maybe_crash("demote.before_replica_delete")
        digests = sorted({c.digest for c in m.chunks})
        length = {c.digest: c.length for c in m.chunks}
        plane = self.tier

        def local_reclaim() -> list[str]:
            expected = self._expected_digests_here(set(digests))
            return [d for d in digests
                    if d not in expected and self.store.chunks.delete(d)]

        removed_local = await asyncio.to_thread(local_reclaim)
        self.serve.drop_cached(removed_local)
        removed = len(removed_local)
        refused = 0
        plane.reclaimed_bytes += sum(length[d] for d in removed_local)

        async def one(peer) -> tuple[list[str], int]:
            try:
                resp, _ = await self.client.call(
                    peer, {"op": "delete_chunks", "digests": digests},
                    retries=1)
                return (resp.get("removed") or [],
                        len(resp.get("refused") or []))
            except RpcError:
                return [], len(digests)   # retried by the finish pass

        for got, ref in await asyncio.gather(
                *(one(p) for p in self._peers())):
            removed += len(got)
            refused += ref
            plane.reclaimed_bytes += sum(length.get(d, 0) for d in got)
        if refused:
            await self._announce_all(m)
            self._tier_surplus_done.pop(m.file_id, None)
        else:
            self._tier_surplus_done[m.file_id] = self.ring.epoch
        plane.note_progress()
        return removed, refused

    def _tier_maybe_promote(self, manifest: Manifest) -> None:
        """Read-path promotion check: a cold file whose decayed heat
        crossed ``promote_reads`` is re-materialized replicated in the
        background; the triggering read is served by the EC decode."""
        if self.tier is None or manifest.tier != "cold":
            return
        if manifest.file_id in self._tier_promoting:
            return
        heat, _ = self.tier.ledger.file_temperature(
            c.digest for c in manifest.chunks)
        if heat < self.cfg.tier.promote_reads:
            return
        self._tier_promoting.add(manifest.file_id)
        task = create_logged_task(self._promote_file(manifest), self.log,
                                  "tier-promote")
        self._tier_tasks.add(task)
        task.add_done_callback(self._tier_tasks.discard)

    async def _promote_file(self, m: Manifest) -> None:
        """Re-materialize a hot-again cold file at full replication:
        gather (the EC decode fills a dead holder), place at the ring's rf
        owners, commit the hot manifest, flip the index tier bits back,
        then reclaim the orphaned parity through ``delete_chunks`` —
        demotion's order mirrored."""
        import dataclasses as _dc

        plane = self.tier
        deadline.clear()          # not the triggering request's budget
        try:
            plane.note_credit_stall(await plane.credits.acquire(m.size))
            data = await self._gather_chunks(m)
            hot_m = _dc.replace(m, ec=None, tier=None)
            seen: set[str] = set()
            batch: list[tuple[str, bytes]] = []
            for c in m.chunks:
                if c.digest not in seen:
                    seen.add(c.digest)
                    batch.append((c.digest, data[c.digest]))
            stats = self._new_upload_stats()
            await self._place_batch(m.file_id, batch, stats)
            if not await asyncio.to_thread(self.store.manifests.save,
                                           hot_m):
                return            # tombstoned meanwhile
            if self.index is not None:
                def flip() -> None:
                    for d in sorted(seen):
                        self.index.note_tier(d, False)
                await asyncio.to_thread(flip)
            await self._announce_all(hot_m)
            self._tier_surplus_done.pop(m.file_id, None)
            await self._tier_reclaim_parity(m)
            plane.promoted_files += 1
            plane.promoted_bytes += m.size
            plane.note_promoted(m.file_id)
            plane.note_progress()
            self.counters.inc("tier_promotions")
            self.obs.event("tier_promote", fileId=m.file_id, bytes=m.size)
        except (RpcError, OSError, DownloadError, UploadError) as e:
            # the file stays cold; a later read re-triggers
            plane.errors += 1
            self.obs.event("tier_error", where="promote",
                           fileId=m.file_id, error=str(e))
            self.log.warning("tier promote %s failed: %s",
                             m.file_id[:12], e)
        finally:
            self._tier_promoting.discard(m.file_id)

    async def _tier_reclaim_parity(self, m: Manifest) -> tuple[int, int]:
        """Delete the parity a promotion orphaned, with surplus reclaim's
        discipline: a peer whose manifests still expect it refuses."""
        if m.ec is None:
            return 0, 0
        parity = sorted({d for st in m.ec.stripes for d in (st.p, st.q)})

        def local() -> int:
            expected = self._expected_digests_here(set(parity))
            return sum(1 for d in parity
                       if d not in expected
                       and self.store.chunks.delete(d))

        removed = await asyncio.to_thread(local)
        self.serve.drop_cached(parity)
        refused = 0

        async def one(peer) -> tuple[int, int]:
            try:
                resp, _ = await self.client.call(
                    peer, {"op": "delete_chunks", "digests": parity},
                    retries=1)
                return (len(resp.get("removed") or []),
                        len(resp.get("refused") or []))
            except RpcError:
                return 0, len(parity)     # the aged GC is the backstop

        for got, ref in await asyncio.gather(
                *(one(p) for p in self._peers())):
            removed += got
            refused += ref
        return removed, refused

    async def _announce_all(self, manifest: Manifest) -> None:
        """Best-effort announce to every peer, without ``fresh``: a tier
        flip bounces off tombstones, never resurrects a deleted file."""
        mj = manifest.to_json()

        async def announce(peer) -> None:
            try:
                await self.client.announce(peer, mj)
            except RpcError as e:
                self.log.warning("announce to node %d failed: %s",
                                 peer.node_id, e)
                self.counters.inc("announce_failures")

        await asyncio.gather(*(announce(p) for p in self._peers()))

    def tier_stats(self) -> dict:
        """``/metrics`` ``tier``: ``{"enabled": False}`` without the
        plane; with it the TierConfig fields and the plane's counters."""
        t = self.cfg.tier
        plane = self.tier
        if plane is None:
            return {"enabled": False}
        return {"enabled": t.enabled,
                "hotFraction": t.hot_fraction,
                "minIdleS": t.min_idle_s,
                "scanIntervalS": t.scan_interval_s,
                "ecK": t.ec_k,
                "demoteCreditBytes": t.demote_credit_bytes,
                "halfLifeS": t.half_life_s,
                "promoteReads": t.promote_reads,
                "redemoteCooldownS": t.redemote_cooldown_s,
                "ledgerEntries": t.ledger_entries,
                "ledgerSize": len(plane.ledger),
                "scans": plane.scans,
                "demotedFiles": plane.demoted_files,
                "demotedBytes": plane.demoted_bytes,
                "parityBytes": plane.parity_bytes,
                "reclaimedBytes": plane.reclaimed_bytes,
                "promotedFiles": plane.promoted_files,
                "promotedBytes": plane.promoted_bytes,
                "errors": plane.errors,
                "creditStallS": round(plane.credit_stall_s, 3),
                "sinceProgressS": round(
                    time.monotonic() - plane.last_progress_at, 3),
                "admission": plane.gate.stats()}
