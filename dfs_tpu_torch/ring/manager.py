"""One node's live ring state, a copy of dfs_tpu's ``RingManager``
(``dfs_tpu/ring/manager.py``): epochs, the dual-read migration window and
the rebalance byte-credit bucket.

The :class:`RingManager` owns:

- the **current** :class:`~dfs_tpu_torch.ring.RingMap` (what placement
  uses) and, while a membership change is being absorbed, the
  **previous** map — reads consult both owner sets during the window, so
  no read fails mid-move;
- **epoch transitions**: ``install`` accepts any map above the current one
  under the ``(epoch, fingerprint)`` total order (admin ``POST /ring``
  locally, ``propose_ring`` from peers, the epoch-mismatch refresh in the
  RPC client), opens the migration window, persists the state to
  ``<node root>/ring.json`` (the format dfs_tpu writes, so either package
  resumes the other's), journals ``ring_epoch_change`` and
  ``rebalance_start`` and calls the runtime's ``on_change`` hook;
- the **byte-credit bucket** (``RingConfig.rebalance_credit_bytes``): the
  repair walk charges every migrated payload byte here, so rebalance
  bandwidth is bounded per node;
- the **progress counters** ``/metrics`` and the doctor read: bytes moved,
  pushes, credit stalls, dual-read hits, seconds since last progress.

Installs and counter updates happen on the owning event loop. The state
file is tiny and written atomically without fsync: epoch gossip is the
durable source of truth.
"""

from __future__ import annotations

import asyncio
import json
import os
import time
from pathlib import Path
from typing import Sequence

from dfs_tpu_torch.config import NodeConfig
from dfs_tpu_torch.ring import DEFAULT_VNODES, RingMap
from dfs_tpu_torch.store.cas import _atomic_write
from dfs_tpu_torch.utils.logging import get_logger


class ByteRate:
    """Token bucket metering payload bytes per second (the rebalance
    credit; the tiering plane meters demotion with it too). ``acquire`` is async — it sleeps until the bucket can
    cover the request — and returns the seconds it stalled so the
    caller can attribute the wait. ``rate == 0`` disables the gate.

    One oversized request (a chunk larger than a whole second of
    credit) is admitted by letting the deficit go negative — the
    classic byte-semaphore rule: it
    simply pre-charges future seconds, so the long-run rate still
    holds."""

    def __init__(self, rate_bytes_per_s: int) -> None:
        self.rate = max(0, int(rate_bytes_per_s))
        self._avail = float(self.rate)
        self._last = time.monotonic()

    async def acquire(self, n: int) -> float:
        if self.rate <= 0 or n <= 0:
            return 0.0
        stalled = 0.0
        # a request larger than one full bucket admits at full-bucket
        # (overdrawing into the future — the oversized-chunk rule);
        # ordinary requests wait for their full byte count
        needed = min(float(n), float(self.rate))
        while True:
            now = time.monotonic()
            self._avail = min(float(self.rate),
                              self._avail + (now - self._last) * self.rate)
            self._last = now
            if self._avail >= needed:
                self._avail -= n
                return stalled
            wait = min(1.0, (needed - self._avail) / self.rate)
            stalled += wait
            await asyncio.sleep(wait)


class RingManager:
    """Live membership state of one node (module docstring)."""

    STATE_FILE = "ring.json"

    def __init__(self, cfg: NodeConfig, root: Path, obs=None) -> None:
        self.cfg = cfg
        self.obs = obs
        self.log = get_logger("ring", cfg.node_id)
        self._state_path = Path(root) / self.STATE_FILE
        # runtime hook: called (on the event loop) after every install
        # so the rebalancer kicks immediately instead of waiting for
        # the next periodic repair tick
        self.on_change = None
        self.current: RingMap = self._compile_epoch0()
        self.previous: RingMap | None = None
        self._migration_started: float | None = None
        self._last_progress: float | None = None
        # cumulative counters (/metrics ring.rebalance) + per-migration
        self._bytes_moved = 0
        self._pushes = 0
        self._credit_stall_s = 0.0
        self._dual_read_hits = 0
        self._epoch_mismatches = 0
        self._last_seconds: float | None = None
        self._last_bytes_moved = 0
        self._mig_bytes0 = 0
        self.credits = ByteRate(cfg.ring.rebalance_credit_bytes)
        self._load_persisted()

    # ---- epoch-0 compilation + persistence --------------------------- #

    def _compile_epoch0(self) -> RingMap:
        cluster_ids = sorted(p.node_id for p in self.cfg.cluster.peers)
        want = self.cfg.ring.member_ids()
        if want is None:
            ids = cluster_ids
        else:
            ids = [i for i in want if i in cluster_ids]
            if not ids:
                raise ValueError("ring.members names no cluster peer")
        if self.cfg.ring.vnodes > 0:
            return RingMap.hashed({i: 1.0 for i in ids}, epoch=0,
                                  vnodes=self.cfg.ring.vnodes)
        return RingMap.static(ids, epoch=0)

    def _load_persisted(self) -> None:
        try:
            d = json.loads(self._state_path.read_bytes())
        except FileNotFoundError:
            return
        except (OSError, ValueError) as e:
            self.log.warning("ring state unreadable (%s); recompiling "
                             "epoch 0", e)
            return
        try:
            cur = RingMap.from_dict(d.get("current"))
            prev = RingMap.from_dict(d["previous"]) \
                if d.get("previous") else None
        except ValueError as e:
            self.log.warning("ring state malformed (%s); recompiling "
                             "epoch 0", e)
            return
        # members must be addressable: drop ids the boot cluster config
        # no longer knows (an operator shrank the address book)
        known = {p.node_id for p in self.cfg.cluster.peers}
        if any(m.node_id not in known for m in cur.members):
            self.log.warning("persisted ring names unknown peers; "
                             "recompiling epoch 0")
            return
        if cur.epoch > self.current.epoch:
            self.current = cur
            if prev is not None and prev.epoch < cur.epoch:
                self.previous = prev
                self._migration_started = time.monotonic()
                self._last_progress = time.monotonic()
            self.log.info("resumed ring epoch %d from disk%s",
                          cur.epoch,
                          " (migration in progress)"
                          if prev is not None else "")

    def _persist(self) -> None:
        # Deliberately NOT fsync'd: ring.json is a resume hint, not acked
        # state — a
        # snapshot lost to power failure is re-taught by epoch gossip,
        # and the atomic rename alone already rules out a torn file.
        try:
            _atomic_write(self._state_path, json.dumps(
                {"current": self.current.to_dict(),
                 "previous": self.previous.to_dict()
                 if self.previous is not None else None}).encode())
        except OSError as e:
            # best-effort: the epoch gossip re-teaches a node that lost
            # its state file — but log it, a read-only data dir is news
            self.log.warning("ring state persist failed: %s", e)

    # ---- epoch state ------------------------------------------------- #

    @property
    def epoch(self) -> int:
        return self.current.epoch

    @property
    def migrating(self) -> bool:
        return self.previous is not None

    def node_ids(self) -> list[int]:
        """Sorted ACTIVE member ids of the current epoch — what every
        placement decision ranges over."""
        return self.current.active_ids()

    def install(self, new: RingMap, source: str = "propose") -> bool:
        """Adopt a strictly-greater map under the (epoch, fingerprint)
        TOTAL order: open the migration window (previous = current),
        reset per-migration counters, persist, journal, kick the
        rebalancer. Returns False (no-op) for maps at or below the
        current one — install is idempotent under the gossip's
        at-least-once delivery. The fingerprint tiebreak is what
        reconciles two admins racing on different nodes: both build
        DIFFERENT epoch-N maps, every node deterministically picks the
        same winner, and the loser's already-placed copies converge
        through the normal rebalance/repair walk."""
        if (new.epoch, new.fingerprint) <= (self.current.epoch,
                                            self.current.fingerprint):
            return False
        if not new.active_ids():
            # a memberless / all-drained map would wedge every
            # placement on the whole cluster (and persist + gossip).
            # The admin path already refuses this; the WIRE adopt path
            # must too — one malformed propose_ring frame is not
            # allowed to brick the ring.
            raise ValueError("ring map has no active member")
        known = {p.node_id for p in self.cfg.cluster.peers}
        unknown = [m.node_id for m in new.members
                   if m.node_id not in known]
        if unknown:
            raise ValueError(f"ring members {unknown} not in the "
                             "cluster address book")
        old = self.current
        # a migration superseded mid-flight keeps the OLDEST previous
        # map: reads must keep finding bytes that never left their
        # epoch-N-2 home (the window only closes on rebalance_done)
        if self.previous is None:
            self.previous = old
            self._migration_started = time.monotonic()
            self._mig_bytes0 = self._bytes_moved
        self.current = new
        self._last_progress = time.monotonic()
        self._persist()
        self.log.info("ring epoch %d -> %d (%s): members %s",
                      old.epoch, new.epoch, source,
                      [(m.node_id, m.weight) for m in new.members])
        if self.obs is not None:
            self.obs.event("ring_epoch_change", fromEpoch=old.epoch,
                           epoch=new.epoch, source=source,
                           members=[m.node_id for m in new.members],
                           active=new.active_ids())
            self.obs.event("rebalance_start", epoch=new.epoch)
        if self.on_change is not None:
            self.on_change()
        return True

    def adopt(self, ring_dict: dict, source: str = "gossip") -> bool:
        """Install a map received over the wire (dict form); malformed
        input raises ValueError for the caller to surface."""
        return self.install(RingMap.from_dict(ring_dict), source=source)

    def propose_next(self, weights: dict[int, float]) -> RingMap:
        """Build the epoch+1 map for an admin action. Any live
        membership change promotes a static cluster to hash mode (a
        static map cannot express minimal movement): vnodes =
        configured count, or DEFAULT_VNODES when unset."""
        vnodes = self.current.vnodes or self.cfg.ring.vnodes \
            or DEFAULT_VNODES
        return RingMap.hashed(weights, epoch=self.current.epoch + 1,
                              vnodes=vnodes)

    def finish_migration(self) -> None:
        """Close the dual-read window: the rebalance walk confirmed
        every digest at its new-epoch owners. Journals
        ``rebalance_done`` with the migration's movement stats."""
        if self.previous is None:
            return
        seconds = time.monotonic() - (self._migration_started
                                      or time.monotonic())
        moved = self._bytes_moved - self._mig_bytes0
        self.previous = None
        self._migration_started = None
        self._last_seconds = round(seconds, 3)
        self._last_bytes_moved = moved
        self._persist()
        self.log.info("rebalance done: epoch %d, %d bytes moved in "
                      "%.1fs", self.current.epoch, moved, seconds)
        if self.obs is not None:
            self.obs.event("rebalance_done", epoch=self.current.epoch,
                           bytesMoved=moved, seconds=round(seconds, 3))

    # ---- placement (current epoch) ----------------------------------- #

    def replica_set(self, digest: str, rf: int) -> list[int]:
        return self.current.owners(digest, rf)

    def handoff_order(self, pinned: Sequence[int]) -> list[int]:
        return self.current.handoff_order(pinned)

    # ---- dual-read window -------------------------------------------- #

    def read_candidates(self, digest: str, rf: int) -> list[int]:
        """Owner candidates for a READ: current-epoch owners first,
        then previous-epoch owners still holding the bytes mid-move.
        Outside a migration window this IS the replica set."""
        cur = self.current.owners(digest, rf)
        if self.previous is None:
            return cur
        seen = set(cur)
        return cur + [n for n in self.previous.owners(digest, rf)
                      if n not in seen]

    def prev_owners(self, digest: str, rf: int) -> list[int]:
        """Previous-epoch owners (empty outside a migration window) —
        the designated-mover order of the rebalancer."""
        if self.previous is None:
            return []
        return self.previous.owners(digest, rf)

    def is_prev_only(self, digest: str, node_id: int, rf: int) -> bool:
        """Was this holder reachable ONLY through the dual-read window
        (a previous-epoch owner that is not a current one)? Counted as
        ``dualReadHits`` by the read paths."""
        if self.previous is None:
            return False
        return node_id not in self.current.owners(digest, rf) \
            and node_id in self.previous.owners(digest, rf)

    # ---- counters ---------------------------------------------------- #

    def note_moved(self, nbytes: int, pushes: int = 1) -> None:
        self._bytes_moved += int(nbytes)
        self._pushes += pushes
        self._last_progress = time.monotonic()

    def note_credit_stall(self, seconds: float) -> None:
        if seconds > 0:
            self._credit_stall_s += seconds

    def note_dual_read_hit(self) -> None:
        self._dual_read_hits += 1

    def note_epoch_mismatch(self) -> None:
        self._epoch_mismatches += 1

    def rebalance_stats(self) -> dict:
        now = time.monotonic()
        return {
            "migrating": self.migrating,
            "fromEpoch": self.previous.epoch
            if self.previous is not None else None,
            "bytesMoved": self._bytes_moved,
            "pushes": self._pushes,
            "creditStallS": round(self._credit_stall_s, 3),
            "dualReadHits": self._dual_read_hits,
            "epochMismatches": self._epoch_mismatches,
            "sinceProgressS": round(now - self._last_progress, 3)
            if self.migrating and self._last_progress is not None
            else None,
            "lastSeconds": self._last_seconds,
            "lastBytesMoved": self._last_bytes_moved,
        }


__all__ = ["ByteRate", "RingManager"]
