"""Peer-existence filters: blocked bloom summaries of each node's
digest set, exchanged over the storage plane. A copy of dfs_tpu's
``index/filter.py``: the probe bits are the same for the same digests, so
the raw filter bytes on the wire mean the same in both packages.

A ``has_chunks`` probe RPC per placement batch per peer works until the
cluster is big and the catalog hot; a compact approximate-membership
summary of each peer's digest set lets placement answer most existence
questions locally (Fan et al., "Cuckoo Filter", CoNEXT'14 frames the
trade space; the blocked-bloom layout here is the cache-friendly
classic: every key's k probe bits live in ONE 64-byte block, so a
membership test touches one cache line).

Semantics the callers rely on:

- **definitely absent** (filter negative) is authoritative at the
  filter's build generation: the digest was not in the peer's index
  when the filter (or the delta that would have carried it) was built.
  Staleness — a chunk stored since the last sync — can yield a false
  "absent", which every caller treats as "transfer/probe it anyway"
  (a wasted transfer the receiving put dedups; never a correctness
  loss).
- **maybe present** (filter positive) carries the bloom false-positive
  rate (~0.8% at the default 10 bits/key). Callers that act on a
  positive must either verify it (the placement trust ledger's
  pre-ack ``has_chunks`` verification, runtime ``_verify_trusted``)
  or be harmless when wrong (repair's probe simply finds out).
- filters only ever ADD bits: deletes cannot be unlearned, so the
  owner rebuilds its filter (fresh bloom over the live digest set)
  whenever the LSI compacts, bumping ``generation``. A peer holding a
  replica of an older generation full-resyncs on the next exchange —
  the same at-least-once "newest wins, resend is idempotent"
  discipline as ``propose_ring``.

Wire exchange (runtime ``_filter_sync_once`` / ops ``get_filter`` +
``filter_delta``): a replica tracks (generation, version); the delta op
returns the digests added since a version, or tells the caller to
resync when the generation moved, the version is unknown, or the add
log no longer reaches back far enough. A malformed/corrupt delta is
answered the same way: full resync, never a poisoned replica.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

_BLOCK_BITS = 512      # 64-byte blocks: one cache line per test
_MAX_K = 8


class BlockedBloomFilter:
    """Bloom filter whose k bits for a key all live in one 64-byte
    block. Keys are sha256 digests, so the probe hashes are just
    slices of the digest itself — uniform by construction, zero extra
    hashing, and identical across processes (the wire exchange ships
    raw filter bytes)."""

    def __init__(self, capacity: int, bits_per_key: int = 10,
                 buf: bytearray | None = None) -> None:
        self.capacity = max(1, int(capacity))
        self.bits_per_key = max(1, int(bits_per_key))
        nbits = self.capacity * self.bits_per_key
        self.nblocks = max(1, (nbits + _BLOCK_BITS - 1) // _BLOCK_BITS)
        self.k = min(_MAX_K, max(1, round(0.7 * self.bits_per_key)))
        if buf is None:
            self.buf = bytearray(self.nblocks * (_BLOCK_BITS // 8))
        else:
            if len(buf) != self.nblocks * (_BLOCK_BITS // 8):
                raise ValueError("filter buffer size mismatch")
            self.buf = buf

    def _probes(self, raw: bytes):
        h1 = int.from_bytes(raw[:8], "big")
        h2 = int.from_bytes(raw[8:16], "big") | 1
        base = (h1 % self.nblocks) * _BLOCK_BITS
        for i in range(self.k):
            yield base + ((h2 * (i + 1) + (h1 >> 33)) % _BLOCK_BITS)

    def add_raw(self, raw: bytes) -> None:
        for bit in self._probes(raw):
            self.buf[bit >> 3] |= 1 << (bit & 7)

    def contains_raw(self, raw: bytes) -> bool:
        for bit in self._probes(raw):
            if not self.buf[bit >> 3] & (1 << (bit & 7)):
                return False
        return True

    def add(self, digest: str) -> None:
        self.add_raw(bytes.fromhex(digest[:32]))

    def contains(self, digest: str) -> bool:
        return self.contains_raw(bytes.fromhex(digest[:32]))


# add-log capacity: deltas reach back at most this many adds; a replica
# further behind full-resyncs (bounded memory beats unbounded history)
_ADD_LOG_CAP = 16384
# one delta reply carries at most this many digests — beyond it the
# caller is told to resync (a giant delta IS a resync, minus the bound)
DELTA_CAP = 8192


class LocalFilter:
    """This node's own existence filter: the authoritative copy peers
    replicate. Thread-safe — adds arrive from CAS worker threads (the
    ChunkStore put feed), reads from the event loop (the sync ops)."""

    def __init__(self, bits_per_key: int = 10,
                 min_capacity: int = 1 << 16) -> None:
        self.bits_per_key = max(1, int(bits_per_key))
        self.min_capacity = max(1024, int(min_capacity))
        self._lock = threading.Lock()
        self._bloom = BlockedBloomFilter(self.min_capacity,
                                         self.bits_per_key)
        # RANDOM generation, not a counter from 0: a restarted node's
        # filter must never collide with its crashed life's generation
        # — a peer still holding the old replica at the same (gen,
        # version) cursor would silently skip the resync and diverge
        # (the delta protocol's only change detector is gen equality)
        self.generation = self._fresh_generation()
        self.version = 0          # adds applied since this generation
        self._entries = 0
        self._adds: deque[str] = deque(maxlen=_ADD_LOG_CAP)
        self._adds_base = 0       # version of the oldest retained add

    def _fresh_generation(self) -> int:
        gen = int.from_bytes(os.urandom(4), "big")
        while gen == getattr(self, "generation", None):
            gen = int.from_bytes(os.urandom(4), "big")
        return gen

    def add(self, digest: str) -> None:
        """Record a newly-stored digest (callers pass only NEWLY stored
        ones — ``ChunkStore.put`` returning True — so ``version`` is a
        meaningful add count, not a touch count)."""
        with self._lock:
            self._bloom.add(digest)
            self._entries += 1
            self.version += 1
            if len(self._adds) == self._adds.maxlen:
                self._adds_base += 1
            self._adds.append(digest)
            # over capacity the FP rate decays; growth happens by
            # rebuild at the next compaction — meanwhile keep adding
            # (a hot filter is still better than none)

    def rebuild(self, raw_digests: list[bytes]) -> None:
        """Fresh bloom over the live digest set (LSI compaction hook):
        deletes drop out, capacity re-sizes, generation bumps — every
        peer replica resyncs on its next exchange."""
        bloom = BlockedBloomFilter(
            max(self.min_capacity, 2 * len(raw_digests)),
            self.bits_per_key)
        for raw in raw_digests:
            bloom.add_raw(raw[:16])
        with self._lock:
            self._bloom = bloom
            self.generation = self._fresh_generation()
            self.version = 0
            self._entries = len(raw_digests)
            self._adds.clear()
            self._adds_base = 0

    def snapshot(self) -> tuple[dict, bytes]:
        """(meta header, filter bytes) for the ``get_filter`` op."""
        with self._lock:
            return ({"gen": self.generation, "version": self.version,
                     "capacity": self._bloom.capacity,
                     "bitsPerKey": self._bloom.bits_per_key,
                     "entries": self._entries},
                    bytes(self._bloom.buf))

    def delta(self, gen: int, since: int) -> dict:
        """The ``filter_delta`` op body: digests added since ``since``,
        or ``{"resync": True}`` when the replica must refetch the full
        filter (generation moved / version from the future / add log
        no longer reaches back / delta too large)."""
        with self._lock:
            if gen != self.generation or since > self.version \
                    or since < self._adds_base \
                    or self.version - since > DELTA_CAP:
                return {"resync": True, "gen": self.generation,
                        "version": self.version}
            adds = list(self._adds)[since - self._adds_base:]
            return {"resync": False, "gen": self.generation,
                    "version": self.version, "adds": adds}

    def stats(self) -> dict:
        with self._lock:
            return {"generation": self.generation,
                    "version": self.version,
                    "entries": self._entries,
                    "bytes": len(self._bloom.buf),
                    "capacity": self._bloom.capacity}


class PeerFilterSet:
    """Replicas of every peer's existence filter, fed by the sync loop.

    ``contains(peer, digest)`` is tri-state: True (maybe present),
    False (definitely absent at the replica's generation), None (no
    usable replica — the caller falls back to probing, the pre-filter
    behavior). ``note_fp`` records an OBSERVED false positive (the
    peer answered "absent" for a filter-positive digest): the digest
    joins a per-peer override set consulted before the bloom, so a
    deterministic bloom collision cannot wedge a retry loop into
    trusting the same phantom copy forever. Overrides clear on the
    next full resync (the rebuilt filter re-judges)."""

    def __init__(self) -> None:
        self._peers: dict[int, dict] = {}
        self.resyncs = 0
        self.deltas = 0
        self.fp_observed = 0

    def state(self, peer: int) -> dict | None:
        return self._peers.get(peer)

    def apply_full(self, peer: int, meta: dict, body: bytes) -> None:
        bloom = BlockedBloomFilter(int(meta["capacity"]),
                                   int(meta["bitsPerKey"]),
                                   buf=bytearray(body))
        self._peers[peer] = {"gen": int(meta["gen"]),
                             "version": int(meta["version"]),
                             "bloom": bloom,
                             "syncedAt": time.monotonic(),
                             "fpOverride": set(), "fp": 0}
        self.resyncs += 1

    def apply_delta(self, peer: int, gen: int, version: int,
                    adds: list) -> bool:
        """Apply one delta; False = unusable (caller must full-resync).
        Validation is strict ON PURPOSE: a malformed digest from a
        skewed peer must trigger a resync, not poison the replica."""
        st = self._peers.get(peer)
        if st is None or st["gen"] != gen:
            return False
        if not isinstance(adds, list) or version < st["version"]:
            return False
        for d in adds:
            if not (isinstance(d, str) and len(d) >= 32):
                return False
            try:
                st["bloom"].add(d)
            except ValueError:
                return False
        st["version"] = version
        st["syncedAt"] = time.monotonic()
        self.deltas += 1
        return True

    def contains(self, peer: int, digest: str) -> bool | None:
        st = self._peers.get(peer)
        if st is None:
            return None
        if digest in st["fpOverride"]:
            return False
        return st["bloom"].contains(digest)

    def note_fp(self, peer: int, digest: str) -> None:
        st = self._peers.get(peer)
        self.fp_observed += 1
        if st is not None:
            st["fp"] += 1
            if len(st["fpOverride"]) < 4096:
                st["fpOverride"].add(digest)

    def drop(self, peer: int) -> None:
        self._peers.pop(peer, None)

    def replicas(self) -> list[tuple[int, dict, bytes]]:
        """Every held replica as ``(peer, meta, filter bytes)`` — the
        batched ``get_filters`` exchange serves these so an external
        client can learn the whole cluster's existence summaries from
        ONE node (each meta carries ``ageS`` so the client can judge
        staleness against its own freshness bound)."""
        now = time.monotonic()
        return [(p, {"nodeId": p, "gen": st["gen"],
                     "version": st["version"],
                     "capacity": st["bloom"].capacity,
                     "bitsPerKey": st["bloom"].bits_per_key,
                     "ageS": round(now - st["syncedAt"], 3)},
                 bytes(st["bloom"].buf))
                for p, st in sorted(self._peers.items())]

    def ages(self) -> dict[int, float]:
        now = time.monotonic()
        return {p: now - st["syncedAt"]
                for p, st in self._peers.items()}

    def stats(self) -> dict:
        return {"peers": {str(p): {"gen": st["gen"],
                                   "version": st["version"],
                                   "bytes": len(st["bloom"].buf),
                                   "ageS": round(time.monotonic()
                                                 - st["syncedAt"], 3),
                                   "fp": st["fp"]}
                          for p, st in sorted(self._peers.items())},
                "resyncs": self.resyncs, "deltas": self.deltas,
                "fpObserved": self.fp_observed}
