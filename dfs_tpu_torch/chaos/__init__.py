"""Deterministic, seed-driven fault injection (a copy of dfs_tpu's
``chaos``: the same knobs, crash points and decision stream, so one seed
gives a port node the fault schedule a dfs_tpu node of the same id gets).

Three fault families, each on an existing seam:

- **Peer faults**: outbound latency, dropped connections, one-way
  partitions and torn frames in the RPC client
  (:meth:`dfs_tpu_torch.comm.rpc.InternalClient._call_once`), and
  whole-node slowness in the inbound frame server
  (``StorageNodeServer._serve_internal_frame``).
- **Disk faults**: ENOSPC, EIO and slow I/O through the
  :class:`~dfs_tpu_torch.store.cas.ChunkStore` fault hook, which runs on
  the CAS worker threads (never the event loop) and so covers
  :class:`~dfs_tpu_torch.store.aio.AsyncChunkStore` too.
- **Crash points**: SIGKILL at the named points of the write, demotion
  and similarity paths (:data:`CRASH_POINTS`), the windows
  fsync-before-ack durability exists to survive.

A node built from ``ChaosConfig()`` holds no injector (every seam is one
``is None`` branch). Every probabilistic decision draws from one
``random.Random(seed ^ node_id)`` stream in call order. Every injected
fault bumps a per-kind counter (``/metrics`` ``chaos``) and journals a
trace-stamped ``chaos_inject`` event. ``POST /chaos`` swaps the mutable
knobs atomically; ``enabled`` and ``seed`` are boot-only.
"""

from __future__ import annotations

import errno
import os
import random
import signal
import threading
import time

from dfs_tpu_torch.config import ChaosConfig

# Registered crash points: the named moments in the write/demotion
# paths where a configured injector kills the process with SIGKILL
# (kill -9 grade — no finally blocks, no flushes; exactly what
# fsync-before-ack must survive). ``place.*``/``upload.*`` points fire
# on a default-config upload, ``demote.*`` points only during a tiering
# demotion, ``sim.*`` points only on the similarity plane's paths.
CRASH_POINTS = frozenset({
    # _place_batch: before any local CAS put of the batch
    "place.before_local_put",
    # _place_batch: local puts + replication done, before quorum check
    "place.after_replicate",
    # _finalize_upload: chunks durable, manifest NOT yet written — the
    # classic "after CAS put, before manifest" torn-upload window
    "upload.before_manifest",
    # _finalize_upload: manifest written (upload is durable), before
    # the announce fan-out / HTTP ack
    "upload.after_manifest",
    # _demote_file: parity durable at its stripe holders, the cold
    # manifest NOT yet written — the file must stay readable replicated
    "demote.after_parity_write",
    # _demote_file: cold manifest committed + index tier bit flipped,
    # surplus replicas NOT yet deleted — readable either way, surplus
    # reclaimed by the next scan's finish pass
    "demote.after_tier_flip",
    # _demote_file: immediately before the surplus-replica deletes of
    # an already-cold file — the torn window where only SOME deletes
    # landed; every remaining read must reconstruct from the stripe
    "demote.before_replica_delete",
    # similarity plane (dfs_tpu_torch.sim) — ``sim.*`` points fire only
    # when the plane stores/serves delta chunks:
    # ChunkStore delta put: delta file linked, index record NOT yet
    # written — the false-negative window the stat backstop covers
    "sim.after_delta_write",
    # NodeStore.gc: live + delta-pinned sets computed, before any
    # orphan delete — a crash mid-GC must never have deleted a base
    # whose delta dependents are live
    "sim.before_base_gc",
    # ChunkStore re-materialize-on-hot: raw copy durable, the delta
    # file NOT yet unlinked — both representations present, raw wins
    "sim.after_rematerialize",
    # BandIndex log compaction: compacted log written and fsynced at
    # its temp name, bands.log NOT yet atomically replaced — replay
    # must still serve the old complete log, and the next compaction
    # unlinks the leftover temp
    "sim.band_compact",
})

# knobs POST /chaos may change at runtime (everything except the
# master switch and the boot-time seed)
MUTABLE_KNOBS = frozenset({
    "rpc_delay_s", "rpc_delay_peers", "rpc_drop_rate", "partition",
    "rpc_truncate_rate", "serve_delay_s", "disk_error_rate",
    "disk_full", "disk_delay_s", "crash_point",
})


def _peer_set(spec: str) -> frozenset[int] | None:
    """csv of node ids -> frozenset, or None for '' (= every peer)."""
    if not spec:
        return None
    return frozenset(int(p) for p in spec.split(",") if p.strip())


class ChaosError(OSError):
    """An injected transport fault. An OSError subclass on purpose: the
    RPC retry loop treats it exactly like a real connection failure
    (retry → backoff → budget → RpcUnreachable), which is the point —
    injected faults must exercise the REAL failure paths."""


class ChunkStoreFault:
    """The :class:`ChunkStore` fault hook an injector installs: called
    at the top of every put/get ON THE CAS WORKER THREAD (so injected
    disk delays never touch the event loop). Raises the injected
    OSError or sleeps; counts every fault it fires."""

    def __init__(self, injector: "ChaosInjector") -> None:
        self._inj = injector

    def __call__(self, op: str, digest: str) -> None:
        inj = self._inj
        cfg = inj.cfg          # ONE snapshot: knobs can't mix mid-swap
        if cfg.disk_delay_s > 0:
            time.sleep(cfg.disk_delay_s)
            inj.count("disk_delay")
        if op == "put" and cfg.disk_full:
            inj.count("disk_full", digest=digest[:12])
            raise OSError(errno.ENOSPC, "chaos: injected disk full")
        if cfg.disk_error_rate > 0 \
                and inj.roll() < cfg.disk_error_rate:
            inj.count("disk_error", op=op, digest=digest[:12])
            raise OSError(errno.EIO, f"chaos: injected {op} EIO")


class ChaosInjector:
    """One node's active fault state. Thread-safe: knobs are read from
    the event loop (RPC seams) and CAS worker threads (disk hook);
    ``set()`` swaps them under a lock. The decision RNG is its own
    lock-guarded stream so decision ORDER — and therefore the fault
    schedule under a fixed seed — is well-defined."""

    def __init__(self, cfg: ChaosConfig, node_id: int, obs=None) -> None:
        if cfg.crash_point and cfg.crash_point not in CRASH_POINTS:
            raise ValueError(
                f"unknown crash point {cfg.crash_point!r} "
                f"(registered: {sorted(CRASH_POINTS)})")
        self.node_id = node_id
        self._obs = obs
        self._lock = threading.Lock()
        # seed ^ node_id, exactly as documented (config.py):
        # an operator must be able to reproduce a node's
        # fault schedule offline from the two numbers alone
        self._rng = random.Random(cfg.seed ^ node_id)
        self._counts: dict[str, int] = {}
        self._apply(cfg)

    # ---- knob state -------------------------------------------------- #

    def _apply(self, cfg: ChaosConfig) -> None:
        # ONE reference swap carries every knob: readers (event-loop
        # RPC seams, CAS worker threads) take one snapshot of _state
        # and never observe a mix of old and new knobs mid-set() —
        # the atomicity POST /chaos advertises
        self._state = (cfg, _peer_set(cfg.rpc_delay_peers),
                       _peer_set(cfg.partition) or frozenset())

    @property
    def cfg(self) -> ChaosConfig:
        """The active knob snapshot (immutable; atomic to read)."""
        return self._state[0]

    def set(self, **knobs) -> dict:
        """Swap mutable knobs at runtime (POST /chaos). Unknown or
        immutable knob names raise ValueError — the harness must fail
        loudly on a typo, not silently run a different scenario.
        Values are validated by rebuilding the frozen ChaosConfig."""
        bad = set(knobs) - MUTABLE_KNOBS
        if bad:
            raise ValueError(f"unknown/immutable chaos knobs: "
                             f"{sorted(bad)}")
        import dataclasses

        with self._lock:
            cfg = dataclasses.replace(self.cfg, **knobs)
            if cfg.crash_point and cfg.crash_point not in CRASH_POINTS:
                raise ValueError(
                    f"unknown crash point {cfg.crash_point!r}")
            self._apply(cfg)
        if self._obs is not None:
            self._obs.event("chaos_set",
                            knobs={k: knobs[k] for k in sorted(knobs)})
        return self.stats()

    def roll(self) -> float:
        """One uniform [0,1) draw from the node's deterministic decision
        stream (decision order defines the schedule)."""
        with self._lock:
            return self._rng.random()

    def count(self, kind: str, **fields) -> None:
        """Meter + journal one injected fault (trace-stamped via the
        obs context, so `trace <id>` shows which request ate it)."""
        with self._lock:
            self._counts[kind] = self._counts.get(kind, 0) + 1
        if self._obs is not None:
            self._obs.event("chaos_inject", kind=kind, **fields)

    # ---- peer faults (RPC client seam) ------------------------------- #

    def partitioned(self, peer_id: int) -> bool:
        return peer_id in self._state[2]

    def check_partition(self, peer_id: int, op: str) -> None:
        """Raise before dialing when this node's link to the peer is
        partitioned away (one-way: only THIS side's sends fail)."""
        if peer_id in self._state[2]:
            self.count("partition", peer=peer_id, op=op)
            raise ChaosError(errno.EHOSTUNREACH,
                             f"chaos: partitioned from node {peer_id}")

    async def before_rpc(self, peer_id: int, op: str) -> None:
        """Outbound-call faults that fire before the frame is sent:
        injected link latency, then a possible connection drop."""
        import asyncio

        cfg, delay_peers, _ = self._state
        if cfg.rpc_delay_s > 0 and (delay_peers is None
                                    or peer_id in delay_peers):
            self.count("rpc_delay", peer=peer_id, op=op)
            await asyncio.sleep(cfg.rpc_delay_s)
        if cfg.rpc_drop_rate > 0 and self.roll() < cfg.rpc_drop_rate:
            self.count("rpc_drop", peer=peer_id, op=op)
            raise ChaosError(errno.ECONNRESET,
                             f"chaos: dropped call to node {peer_id}")

    def truncate_now(self, peer_id: int, op: str) -> bool:
        """Whether to truncate THIS outbound frame mid-body (the caller
        writes a torn frame and closes — the receiver's torn-frame
        handling is what gets exercised)."""
        rate = self.cfg.rpc_truncate_rate
        if rate <= 0 or self.roll() >= rate:
            return False
        self.count("rpc_truncate", peer=peer_id, op=op)
        return True

    # ---- inbound faults (frame server seam) -------------------------- #

    async def before_serve(self, op: str) -> None:
        """Inbound service delay: the whole node is slow (the shape the
        peers see it in their client RPC tables)."""
        import asyncio

        delay = self.cfg.serve_delay_s
        if delay > 0:
            self.count("serve_delay", op=op)
            await asyncio.sleep(delay)

    # ---- disk faults (ChunkStore hook) ------------------------------- #

    def store_hook(self) -> ChunkStoreFault:
        return ChunkStoreFault(self)

    # ---- crash points ------------------------------------------------ #

    def maybe_crash(self, point: str) -> None:
        """Die by SIGKILL if ``point`` is the configured crash point.
        The journal event is best-effort (the bounded writer thread may
        not flush it — that is the point of kill -9); the harness
        correlates crashes by exit signal, not by journal."""
        if point != self.cfg.crash_point:
            return
        if self._obs is not None:
            self._obs.event("chaos_crash", point=point)
        self._kill()

    def _kill(self) -> None:
        """SIGKILL this process: no finally blocks, no flushes (tests
        replace it on an instance to see which points are reached)."""
        os.kill(os.getpid(), signal.SIGKILL)

    # ---- surface ----------------------------------------------------- #

    def stats(self) -> dict:
        """``/metrics`` ``chaos`` section: the active knobs plus
        per-kind injected-fault counters. Knob keys mirror ChaosConfig
        fields."""
        with self._lock:
            counts = dict(sorted(self._counts.items()))
        cfg = self.cfg
        return {"enabled": True, "seed": cfg.seed,
                "rpcDelayS": cfg.rpc_delay_s,
                "rpcDelayPeers": cfg.rpc_delay_peers,
                "rpcDropRate": cfg.rpc_drop_rate,
                "partition": cfg.partition,
                "rpcTruncateRate": cfg.rpc_truncate_rate,
                "serveDelayS": cfg.serve_delay_s,
                "diskErrorRate": cfg.disk_error_rate,
                "diskFull": cfg.disk_full,
                "diskDelayS": cfg.disk_delay_s,
                "crashPoint": cfg.crash_point,
                "injected": counts}


__all__ = ["CRASH_POINTS", "MUTABLE_KNOBS", "ChaosError",
           "ChaosInjector", "ChunkStoreFault"]
