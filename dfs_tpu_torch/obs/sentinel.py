"""Runtime stall sentinels (a copy of dfs_tpu's ``obs/sentinel.py``).

A periodic sampler on the node's event loop that

- measures **event-loop lag** (scheduled wake vs actual wake of an
  ``asyncio.sleep``: anything occupying the loop shows up here),
- reads the **CAS-pool backlog** (jobs submitted but not yet finished:
  the disk tier is saturated),
- tracks **ingest credit stalls** (delta of the ``creditS`` stopwatch:
  chunking blocked on unconsumed output),

and journals an incident (``loop_lag`` / ``cas_backlog`` /
``credit_stall``) when a sample crosses its threshold. Last/max gauges
are served under ``/metrics`` ``obs.sentinel``. Costs one timer wakeup
per ``ObsConfig.sentinel_interval_s`` (default 1 s) and a few dict reads
per sample.
"""

from __future__ import annotations

import asyncio
import collections
import threading
import time

from dfs_tpu_torch.utils.aio import create_logged_task
from dfs_tpu_torch.utils.logging import get_logger


class Sentinel:
    """One node's sampler. ``start()`` on a running loop; ``stop()`` on
    shutdown. ``cas`` (AsyncChunkStore) and ``stalls`` (the ingest
    Stopwatches) are optional — standalone use samples loop lag only."""

    # CAS jobs pending beyond workers x this factor = a backlog incident
    _CAS_BACKLOG_FACTOR = 4
    # fraction of the sample interval spent credit-stalled that counts
    # as an incident (0.5 = chunking blocked half the interval)
    _CREDIT_STALL_FRACTION = 0.5
    # recency window of the windowed gauge (recentMaxLagS): one
    # historical spike does not stay in it for the process lifetime
    RECENT_WINDOW_S = 60.0

    def __init__(self, obs, cas=None, stalls=None,
                 interval_s: float = 1.0, lag_s: float = 0.25) -> None:
        self.obs = obs
        self.cas = cas
        self.stalls = stalls
        self.interval_s = float(interval_s)
        self.lag_s = float(lag_s)
        self.log = get_logger("sentinel", obs.node_id)
        self._task: asyncio.Task | None = None
        self._lock = threading.Lock()
        self._samples = 0
        self._incidents = 0
        self._last_lag = 0.0
        self._max_lag = 0.0
        # (monotonic ts, lag) samples inside RECENT_WINDOW_S, pruned on
        # write AND filtered on read — bounded by window/interval
        self._recent: collections.deque[tuple[float, float]] = \
            collections.deque()
        self._cas_pending = 0
        self._credit_s_prev: float | None = None
        self._credit_stall_last = 0.0

    async def _sample_once(self, lag: float) -> None:
        incidents = 0
        if lag >= self.lag_s:
            incidents += 1
            self.obs.event("loop_lag", lagS=round(lag, 6))
            self.log.warning("event-loop lag %.3fs (threshold %.3fs)",
                             lag, self.lag_s)
        pending = 0
        if self.cas is not None:
            pending = self.cas.pending
            workers = getattr(self.cas, "_workers", 1)
            if pending > workers * self._CAS_BACKLOG_FACTOR:
                incidents += 1
                self.obs.event("cas_backlog", pending=pending,
                               workers=workers)
        credit_delta = 0.0
        if self.stalls is not None:
            credit_s = self.stalls.snapshot().get("creditS", 0.0)
            if self._credit_s_prev is not None:
                credit_delta = max(0.0, credit_s - self._credit_s_prev)
                # duty cycle over the ACTUAL sample period: loop lag
                # stretches the period past interval_s, and judging the
                # stretched delta against the nominal interval would
                # over-fire credit_stall exactly when the loop itself
                # is the pathology
                if credit_delta >= (self.interval_s + lag) \
                        * self._CREDIT_STALL_FRACTION:
                    incidents += 1
                    self.obs.event("credit_stall",
                                   stalledS=round(credit_delta, 6))
            self._credit_s_prev = credit_s
        now = time.monotonic()
        with self._lock:
            self._samples += 1
            self._incidents += incidents
            self._last_lag = lag
            self._max_lag = max(self._max_lag, lag)
            self._recent.append((now, lag))
            cutoff = now - self.RECENT_WINDOW_S
            while self._recent and self._recent[0][0] < cutoff:
                self._recent.popleft()
            self._cas_pending = pending
            self._credit_stall_last = credit_delta

    async def _loop(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            t0 = loop.time()
            await asyncio.sleep(self.interval_s)
            # anything that occupied the loop during the sleep delays
            # the wakeup past the scheduled deadline — that delay IS
            # the loop lag user requests experienced
            lag = loop.time() - t0 - self.interval_s
            await self._sample_once(max(0.0, lag))

    def start(self) -> None:
        if self.interval_s <= 0 or self._task is not None:
            return
        self._task = create_logged_task(self._loop(), self.log, "sentinel")

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    def stats(self) -> dict:
        """``/metrics`` ``obs.sentinel`` section. ``intervalS`` /
        ``lagThresholdS`` mirror the ObsConfig fields."""
        cutoff = time.monotonic() - self.RECENT_WINDOW_S
        with self._lock:
            recent_max = max((lag for t, lag in self._recent
                              if t >= cutoff), default=0.0)
            return {"enabled": True,
                    "intervalS": self.interval_s,
                    "lagThresholdS": self.lag_s,
                    "samples": self._samples,
                    "incidents": self._incidents,
                    "lastLagS": round(self._last_lag, 6),
                    "maxLagS": round(self._max_lag, 6),
                    "recentMaxLagS": round(recent_max, 6),
                    "casPending": self._cas_pending,
                    "creditStallS": round(self._credit_stall_last, 6)}


__all__ = ["Sentinel"]
