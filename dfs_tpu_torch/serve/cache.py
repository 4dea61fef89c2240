"""Byte-budgeted in-memory hot-chunk cache with SIEVE eviction (a copy
of dfs_tpu's ``serve/cache.py``).

Keyed by sha256 digest, so immutability is structural: an entry can only
ever be present-and-correct or absent — there is no invalidation problem,
and delete/GC/scrub paths merely :meth:`ChunkCache.drop` entries to
reclaim memory.

Eviction is SIEVE (Zhang et al., "SIEVE is Simpler than LRU", NSDI '24):
a FIFO queue with one *visited* bit per entry and a moving hand. Hits set
the bit in place (lazy promotion — no list surgery on the hot path, no
lock-order hazards); eviction walks the hand from the queue tail toward
the head, clearing visited bits until it finds a cold entry. One
sequential scan of the corpus (a full download of a cold file) inserts
entries with visited=0 at the head and evicts them before they can push
out the genuinely-hot set — the scan resistance plain LRU lacks, which is
exactly the hazard of fronting a chunk store whose normal workload IS
whole-file scans.

Thread-safe: the node runtime calls from its event loop, but scrub/GC
paths run in worker threads; one plain lock covers every mutation (the
critical sections are dict/pointer ops, never I/O or hashing).
"""

from __future__ import annotations

import heapq
import threading
import time


class _Node:
    __slots__ = ("key", "data", "visited", "newer", "older", "hits",
                 "last")

    def __init__(self, key: str, data: bytes) -> None:
        self.key = key
        self.data = data
        self.visited = False
        self.newer: _Node | None = None
        self.older: _Node | None = None
        # per-digest temperature: hit count and last-access wall time,
        # read by temperature() top-K
        self.hits = 0
        self.last = 0.0


class ChunkCache:
    """SIEVE cache over ``digest -> bytes`` with a byte budget."""

    def __init__(self, budget_bytes: int) -> None:
        if budget_bytes <= 0:
            raise ValueError("cache budget must be positive bytes")
        self.budget = int(budget_bytes)
        self._map: dict[str, _Node] = {}
        self._head: _Node | None = None   # newest insertion
        self._tail: _Node | None = None   # oldest insertion
        self._hand: _Node | None = None   # SIEVE eviction hand
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.inserts = 0

    # ------------------------------------------------------------------ #

    def get(self, digest: str) -> memoryview | None:
        """Hot hit → READ-ONLY memoryview of the cached payload (never a
        copy: downstream range slicing and socket writes operate on views
        of the one cached buffer)."""
        with self._lock:
            node = self._map.get(digest)
            if node is None:
                self.misses += 1
                return None
            node.visited = True       # lazy promotion: no list movement
            node.hits += 1
            node.last = time.time()
            self.hits += 1
            return memoryview(node.data).toreadonly()

    def put(self, digest: str, data) -> bool:
        """Insert verified bytes; returns False when already present or
        when the payload alone exceeds the whole budget (a chunk bigger
        than the cache must not wipe it to still not fit). The cache
        OWNS its entries: a non-bytes payload (e.g. a memoryview slice
        of a wire frame) is copied compactly here — caching a view would
        pin the whole multi-MiB frame per cached chunk."""
        n = len(data)
        if n > self.budget:
            return False
        with self._lock:
            if digest in self._map:
                return False
            if not isinstance(data, bytes):
                data = bytes(data)   # the ownership copy
            while self._bytes + n > self.budget:
                self._evict_one()
            node = _Node(digest, data)
            node.older = self._head
            if self._head is not None:
                self._head.newer = node
            self._head = node
            if self._tail is None:
                self._tail = node
            self._map[digest] = node
            self._bytes += n
            self.inserts += 1
            return True

    def drop(self, digest: str) -> bool:
        """Remove an entry (delete/GC/scrub reclaim). True if present."""
        with self._lock:
            node = self._map.pop(digest, None)
            if node is None:
                return False
            self._unlink(node)
            self._bytes -= len(node.data)
            return True

    def clear(self) -> None:
        with self._lock:
            self._map.clear()
            self._head = self._tail = self._hand = None
            self._bytes = 0

    # ------------------------------------------------------------------ #

    def _unlink(self, node: _Node) -> None:
        if self._hand is node:
            self._hand = node.newer    # hand keeps walking toward head
        if node.older is not None:
            node.older.newer = node.newer
        if node.newer is not None:
            node.newer.older = node.older
        if self._head is node:
            self._head = node.older
        if self._tail is node:
            self._tail = node.newer

    def _evict_one(self) -> None:
        # SIEVE: walk the hand tail->head; visited entries get one more
        # round (bit cleared in place), the first cold entry is evicted
        # and the hand rests just headward of it. put() only runs with
        # bytes > 0, so the queue is non-empty and the walk terminates:
        # at worst it clears every visited bit and returns to a cold tail.
        node = self._hand if self._hand is not None else self._tail
        while node is not None and node.visited:
            node.visited = False
            node = node.newer
        if node is None:               # wrapped past the head
            node = self._tail
            while node is not None and node.visited:
                node.visited = False
                node = node.newer
        assert node is not None, "evict on empty cache"
        self._hand = node.newer
        del self._map[node.key]
        self._unlink(node)
        self._bytes -= len(node.data)
        self.evictions += 1

    # ------------------------------------------------------------------ #

    def __len__(self) -> int:
        return len(self._map)

    @property
    def bytes_used(self) -> int:
        return self._bytes

    def stats(self) -> dict:
        with self._lock:
            return {"enabled": True, "budgetBytes": self.budget,
                    "bytes": self._bytes, "entries": len(self._map),
                    "hits": self.hits, "misses": self.misses,
                    "inserts": self.inserts, "evictions": self.evictions}

    def temperature(self, k: int = 16) -> list[dict]:
        """Bounded top-K hottest resident digests — per-entry hit count
        + last-access wall time, hottest first, as ``/metrics``
        ``serve.cache.temperature`` shows them. O(entries) under the
        lock: the entry count is budget-bounded and this is a
        diagnostics read, not a data-plane hop."""
        with self._lock:
            top = heapq.nlargest(max(0, int(k)), self._map.values(),
                                 key=lambda n: (n.hits, n.last))
        return [{"digest": n.key, "hits": n.hits,
                 "bytes": len(n.data), "lastAccess": round(n.last, 3)}
                for n in top if n.hits > 0]
