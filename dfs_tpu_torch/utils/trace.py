"""Latency histograms (a copy of dfs_tpu's ``utils/trace.py``
:class:`LatencyRecorder`, log2 buckets from 1 us to ~134 s) and
:func:`span`, which times a phase into one."""

from __future__ import annotations

import bisect
import contextlib
import math
import threading
import time

from dfs_tpu_torch.utils.logging import capped_key

# bucket upper bounds in seconds; bucket i covers (_BOUNDS[i-1],
# _BOUNDS[i]], one overflow bucket past the last
_BOUNDS = [2.0 ** e for e in range(-20, 8)]


class LatencyRecorder:
    """Lock-protected streaming histograms; ``snapshot()`` gives count,
    mean, p50/p90/p99 (geometric bucket midpoints, clamped by the observed
    max) and max per name."""

    _MAX_NAMES = 512

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._hist: dict[str, list[int]] = {}
        self._stats: dict[str, tuple[int, float, float]] = {}  # n, sum, max
        self._overflow_warned = False

    def record(self, name: str, seconds: float) -> None:
        idx = bisect.bisect_left(_BOUNDS, seconds)
        with self._lock:
            name = capped_key(self._hist, name, self._MAX_NAMES, self,
                              "LatencyRecorder", "_overflow")
            h = self._hist.setdefault(name, [0] * (len(_BOUNDS) + 1))
            h[min(idx, len(_BOUNDS))] += 1
            n, s, mx = self._stats.get(name, (0, 0.0, 0.0))
            self._stats[name] = (n + 1, s + seconds, max(mx, seconds))

    @staticmethod
    def _quantile(h: list[int], q: float, total: int) -> float:
        if total == 0:
            return 0.0
        target = math.ceil(q * total)
        seen = 0
        for i, c in enumerate(h):
            seen += c
            if seen >= target:
                if i >= len(_BOUNDS):          # overflow bucket
                    return _BOUNDS[-1] * math.sqrt(2.0)
                lo = _BOUNDS[i - 1] if i > 0 else _BOUNDS[0] / 2.0
                return math.sqrt(lo * _BOUNDS[i])
        return _BOUNDS[-1] * math.sqrt(2.0)

    def snapshot(self) -> dict[str, dict[str, float]]:
        with self._lock:
            out = {}
            for name, h in self._hist.items():
                n, s, mx = self._stats[name]
                out[name] = {
                    "count": n,
                    "mean_s": round(s / n, 6) if n else 0.0,
                    "p50_s": round(min(self._quantile(h, 0.50, n), mx), 6),
                    "p90_s": round(min(self._quantile(h, 0.90, n), mx), 6),
                    "p99_s": round(min(self._quantile(h, 0.99, n), mx), 6),
                    "max_s": round(mx, 6),
                }
            return out


@contextlib.contextmanager
def span(name: str, recorder: LatencyRecorder | None = None):
    """Time a phase into ``recorder`` under ``name``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if recorder is not None:
            recorder.record(name, time.perf_counter() - t0)
