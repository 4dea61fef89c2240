"""Hedged-read policy: a latency-derived hedge delay and a token-bucket
hedge budget (a copy of dfs_tpu's ``serve/hedge.py``).

"The Tail at Scale" (Dean & Barroso, CACM 2013): with replicated immutable
chunks, one slow replica makes every read routed to it an outlier while a
good copy sits one ring step away. A hedged request asks the next replica
once the primary has not answered within a delay, and takes the first
verified answer.

- **Delay.** ``clamp(HEDGE_MEAN_FACTOR x the BEST replica's windowed mean
  RPC latency, floor, cap)`` (``RpcStats.recent_best_mean``, 60 s window).
  The best replica's mean, not the primary's own: a slow primary's samples
  would walk its own delay up past its slowness and switch hedging off
  exactly when it is needed. The floor stops a microsecond-fast history
  from hedging every call; the cap bounds the wait.
- **Budget.** Every fired hedge takes a token (``hedge_budget_per_s``
  refill, burst of ``BURST_CAP``). An empty bucket waits the primary out,
  so hedge load is bounded by the refill rate however sick a replica gets.
  Denials are counted and windowed.

Loop-affine like the RPC client that drives it: touched only from the
owning event loop, no locks.
"""

from __future__ import annotations

import collections
import time

# hedge delay = clamp(factor x windowed mean, floor, cap): 3x the mean
# approximates "slower than this call usually is, by enough margin that
# healthy jitter does not hedge" without keeping per-peer histograms
HEDGE_MEAN_FACTOR = 3.0


class HedgePolicy:
    """One node's hedged-read state: delay derivation, the token
    bucket, and the fired/won/denied counters (with 60 s recency
    windows)."""

    BURST_CAP = 8.0       # bucket capacity: bounded hedge burst
    RECENT_WINDOW_S = 60.0
    _RECENT_MAX = 512

    def __init__(self, floor_s: float, cap_s: float,
                 budget_per_s: float) -> None:
        self.floor_s = float(floor_s)
        self.cap_s = float(cap_s)
        self.budget_per_s = float(budget_per_s)
        self._tokens = min(self.BURST_CAP, max(1.0, budget_per_s))
        self._last = time.monotonic()
        self.fired = 0
        self.won = 0
        self.denied = 0
        self._fired_ts: collections.deque[float] = \
            collections.deque(maxlen=self._RECENT_MAX)
        self._denied_ts: collections.deque[float] = \
            collections.deque(maxlen=self._RECENT_MAX)

    def delay_s(self, recent_mean_s: float | None) -> float:
        """Hedge delay given the best replica's windowed mean RPC
        latency (None = no recent sample anywhere: use the floor — a
        cluster we know nothing about is assumed healthy)."""
        if recent_mean_s is None:
            return self.floor_s
        return min(self.cap_s,
                   max(self.floor_s, HEDGE_MEAN_FACTOR * recent_mean_s))

    def take(self) -> bool:
        """Consume one hedge token; False = budget empty (the caller
        waits the primary out; the denial is counted)."""
        now = time.monotonic()
        self._tokens = min(self.BURST_CAP,
                           self._tokens + (now - self._last)
                           * self.budget_per_s)
        self._last = now
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return True
        self.denied += 1
        self._denied_ts.append(now)
        return False

    def note_fired(self) -> None:
        self.fired += 1
        self._fired_ts.append(time.monotonic())

    def note_won(self) -> None:
        self.won += 1

    @staticmethod
    def _recent(ts: collections.deque, cutoff: float) -> int:
        return sum(1 for t in ts if t >= cutoff)

    def stats(self) -> dict:
        """``/metrics`` serve ``hedge`` section. floorS/capS/budgetPerS
        mirror the ServeConfig fields; fired/won/denied are since start,
        the *Recent pair covers RECENT_WINDOW_S. The deques are bounded,
        so the windowed counts saturate at ``windowCap``."""
        cutoff = time.monotonic() - self.RECENT_WINDOW_S
        return {"enabled": True,
                "floorS": self.floor_s,
                "capS": self.cap_s,
                "budgetPerS": self.budget_per_s,
                "tokens": round(self._tokens, 2),
                "fired": self.fired,
                "won": self.won,
                "denied": self.denied,
                "firedRecent": self._recent(self._fired_ts, cutoff),
                "deniedRecent": self._recent(self._denied_ts, cutoff),
                "windowCap": self._RECENT_MAX}


__all__ = ["HEDGE_MEAN_FACTOR", "HedgePolicy"]
