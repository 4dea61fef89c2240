"""Per-peer RPC statistics (the :class:`RpcStats` of dfs_tpu's ``obs``).

The port keeps only what the hedge and ``/metrics`` read: every
storage-plane call is recorded per (peer, op) with its latency, bytes and
outcome, and :meth:`RpcStats.recent_best_mean` seeds the hedge delay from
the best replica's windowed mean latency of successful calls. Tracing, the
journal and the rest of dfs_tpu's ``obs`` are not ported.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from dfs_tpu_torch.utils.logging import capped_key


class RpcStats:
    """Per-(peer, op) RPC counters: calls, errors, retries, bytes out/in,
    total seconds, and a 60 s window of samples. Key cardinality is
    capped: past ``_MAX_KEYS`` new keys fold into
    ``("_overflow", "_overflow")``."""

    _MAX_KEYS = 256
    # recency window of recent_best_mean; at extreme call rates it covers
    # the last _RECENT_MAX calls
    RECENT_WINDOW_S = 60.0
    _RECENT_MAX = 512

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # (peer, op) -> [count, errors, retries, bytes_out, bytes_in, s]
        self._m: dict[tuple, list] = {}
        # (peer, op) -> [deque[(monotonic ts, seconds, error)], rolling
        # sum, rolling count, ok-only sum, ok-only count]: the ok-only
        # pair feeds the hedge delay (a fast error reply is not what a
        # healthy fetch takes)
        self._recent: dict[tuple, list] = {}
        self._overflow_warned = False

    def _row(self, peer, op) -> tuple[tuple, list]:
        key = capped_key(self._m, (peer, op), self._MAX_KEYS, self,
                         "RpcStats", ("_overflow", "_overflow"))
        row = self._m.get(key)
        if row is None:
            row = self._m[key] = [0, 0, 0, 0, 0, 0.0]
        return key, row

    def record(self, peer, op: str, seconds: float, bytes_out: int = 0,
               bytes_in: int = 0, error: bool = False) -> None:
        now = time.monotonic()
        with self._lock:
            key, row = self._row(peer, op)
            row[0] += 1
            if error:
                row[1] += 1
            row[3] += bytes_out
            row[4] += bytes_in
            row[5] += seconds
            ent = self._recent.get(key)
            if ent is None:
                ent = self._recent[key] = [deque(), 0.0, 0, 0.0, 0]
            ent[0].append((now, seconds, error))
            ent[1] += seconds
            ent[2] += 1
            if not error:
                ent[3] += seconds
                ent[4] += 1
            self._expire(ent, now)

    def _expire(self, ent: list, now: float) -> None:
        """Drop expired (and over-bound) samples, keeping the rolling sums
        exact. The caller holds the lock."""
        dq = ent[0]
        cutoff = now - self.RECENT_WINDOW_S
        while dq and (dq[0][0] < cutoff or len(dq) > self._RECENT_MAX):
            _, s, err = dq.popleft()
            ent[1] -= s
            ent[2] -= 1
            if not err:
                ent[3] -= s
                ent[4] -= 1
        if ent[2] == 0:
            ent[1] = 0.0   # re-zero float drift at every empty window
        if ent[4] == 0:
            ent[3] = 0.0

    def retry(self, peer, op: str) -> None:
        with self._lock:
            _, row = self._row(peer, op)
            row[2] += 1

    def recent_best_mean(self, op: str) -> float | None:
        """The LOWEST per-peer windowed mean of successful calls of
        ``op``: what a healthy replica currently takes (None without a
        sample)."""
        now = time.monotonic()
        best: float | None = None
        with self._lock:
            for (_, o), ent in self._recent.items():
                if o != op:
                    continue
                self._expire(ent, now)
                if ent[4] == 0:
                    continue
                mean = ent[3] / ent[4]
                if best is None or mean < best:
                    best = mean
        return best

    def rows(self) -> list[tuple[str, str, list]]:
        """(peer, op, [count, errors, retries, bytes_out, bytes_in, s])
        rows, sorted by key."""
        with self._lock:
            return [(str(p), str(o), list(r))
                    for (p, o), r in sorted(self._m.items(),
                                            key=lambda kv: str(kv[0]))]


__all__ = ["RpcStats"]
