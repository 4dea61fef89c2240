"""Embedded metrics history (a copy of dfs_tpu's ``obs/history.py``):
fixed-memory multi-resolution time series.

``/metrics`` answers "what is the value now"; the trend questions the
census/capacity plane needs — *which way is CAS usage moving, how fast
is the disk filling, did ingest throughput fall off a cliff an hour
ago* — require history, and shipping a full TSDB dependency for a
storage node is exactly the kind of weight this repo avoids. This is
the embedded alternative: a bounded ring of downsampled buckets per
series per resolution, in memory, O(resolutions) per observation.

Design:

- **Multi-resolution, independently fed.** Every observation lands in
  each resolution's *open* bucket (default: 10 s x 360 = 1 h fine,
  5 min x 288 = 24 h coarse — ``CensusConfig``). Bucket start times
  are aligned to the resolution step and the coarse step is an integer
  multiple of the fine step, so a closed coarse bucket's ``sum`` /
  ``count`` equal the sum over the fine buckets it spans — the
  downsampling-correctness invariant tests/test_torch_census.py pins across
  rollover.
- **Fixed memory.** Bounded series count (overflow names fold into
  ``_overflow``, the repo-wide cardinality discipline) x bounded slots
  per resolution; empty intervals simply have no bucket (no filler
  points for idle series).
- **Gauge semantics.** Each bucket keeps (ts, last, min, max, sum,
  count). Monotonic counters are recorded as gauge samples of their
  running total — rates fall out of differencing ``last`` between
  buckets, which is also how :meth:`trend` estimates a slope for the
  doctor's ``capacity_trend`` disk-full ETA.

Thread-safe: one lock, dict/deque ops only under it (the sampler runs
on the event loop; ``/metrics/history`` readers may be anywhere).
"""

from __future__ import annotations

import threading
import time
from collections import deque

from dfs_tpu_torch.utils.logging import capped_key

# bucket layout: [start_ts, last, min, max, sum, count]
_TS, _LAST, _MIN, _MAX, _SUM, _COUNT = range(6)


class _Series:
    __slots__ = ("open", "rings")

    def __init__(self, n_res: int) -> None:
        # per resolution: open bucket (list | None) + closed-bucket ring
        self.open: list[list | None] = [None] * n_res
        self.rings: list[deque] = [deque() for _ in range(n_res)]


class MetricsHistory:
    """Bounded multi-resolution history over named series."""

    _MAX_SERIES = 128

    def __init__(self, interval_s: float, slots: int,
                 coarse_every: int, coarse_slots: int) -> None:
        fine = float(interval_s)
        # resolutions as (step seconds, slots kept); coarse step is an
        # exact fine-step multiple so bucket boundaries nest (the sum
        # preservation invariant depends on it)
        self.resolutions: tuple[tuple[float, int], ...] = (
            (fine, int(slots)),
            (fine * int(coarse_every), int(coarse_slots)))
        self._lock = threading.Lock()
        self._series: dict[str, _Series] = {}
        self._samples = 0
        self._overflow_warned = False

    # ---- write side --------------------------------------------------- #

    def observe(self, name: str, value: float,
                now: float | None = None) -> None:
        """Record one sample into every resolution's open bucket,
        closing buckets whose window ``now`` has moved past."""
        if now is None:
            now = time.time()
        value = float(value)
        with self._lock:
            name = capped_key(self._series, name, self._MAX_SERIES, self,
                              "MetricsHistory", "_overflow")
            s = self._series.get(name)
            if s is None:
                s = self._series[name] = _Series(len(self.resolutions))
            self._samples += 1
            for i, (step, keep) in enumerate(self.resolutions):
                start = now - (now % step)   # aligned bucket start
                b = s.open[i]
                if b is not None and start > b[_TS]:
                    ring = s.rings[i]
                    ring.append(b)
                    while len(ring) > keep:
                        ring.popleft()
                    b = None
                if b is None:
                    s.open[i] = [start, value, value, value, value, 1]
                    continue
                b[_LAST] = value
                if value < b[_MIN]:
                    b[_MIN] = value
                if value > b[_MAX]:
                    b[_MAX] = value
                b[_SUM] += value
                b[_COUNT] += 1

    # ---- read side ---------------------------------------------------- #

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._series)

    def snapshot(self, name: str) -> dict | None:
        """One series, every resolution, oldest point first; the open
        (still-accumulating) bucket is included as the last point.
        Points are ``[ts, last, min, max, sum, count]``. None for an
        unknown series."""
        with self._lock:
            s = self._series.get(name)
            if s is None:
                return None
            res = []
            for i, (step, keep) in enumerate(self.resolutions):
                pts = [list(b) for b in s.rings[i]]
                if s.open[i] is not None:
                    pts.append(list(s.open[i]))
                res.append({"stepS": step, "slots": keep, "points": pts})
            return {"name": name, "resolutions": res}

    def last(self, name: str) -> float | None:
        """Most recent observed value of a series, or None."""
        with self._lock:
            s = self._series.get(name)
            if s is None:
                return None
            b = s.open[0]
            if b is None and s.rings[0]:
                b = s.rings[0][-1]
            return None if b is None else b[_LAST]

    def trend(self, name: str, window_s: float | None = None
              ) -> float | None:
        """Least-effort slope estimate (units/second) over the fine
        resolution: (newest last - oldest last) / elapsed, optionally
        restricted to the trailing ``window_s``. None when fewer than
        two buckets exist — a trend needs history. Used for monotonic
        gauges (CAS bytes) by the doctor's disk-full ETA."""
        with self._lock:
            s = self._series.get(name)
            if s is None:
                return None
            pts = list(s.rings[0])
            if s.open[0] is not None:
                pts.append(s.open[0])
            if window_s is not None and pts:
                cutoff = pts[-1][_TS] - window_s
                pts = [p for p in pts if p[_TS] >= cutoff]
            if len(pts) < 2:
                return None
            dt = pts[-1][_TS] - pts[0][_TS]
            if dt <= 0:
                return None
            return (pts[-1][_LAST] - pts[0][_LAST]) / dt

    def stats(self) -> dict:
        with self._lock:
            return {"enabled": True, "series": len(self._series),
                    "samples": self._samples,
                    "resolutions": [{"stepS": st, "slots": sl}
                                    for st, sl in self.resolutions]}


__all__ = ["MetricsHistory"]
