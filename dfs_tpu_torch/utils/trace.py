"""Latency histograms and the device-trace capture (a port of dfs_tpu's
``utils/trace.py``).

- :class:`LatencyRecorder` — lock-protected streaming histograms, log2
  buckets from 1 us to ~134 s; ``snapshot()`` serves count / mean /
  p50 / p90 / p99 / max per name under ``/metrics``, and
  ``histogram_snapshot()`` / ``exemplar_snapshot()`` the raw buckets and
  the last trace id that landed in each, for the OpenMetrics page.
- :func:`span` — times a phase into a recorder and, while
  :func:`device_trace` captures, opens a ``torch.profiler.record_function``
  range of the same name, so the device timeline shows which phase a
  kernel ran in.
- :func:`device_trace` — a ``torch.profiler.profile`` capture (CPU, and
  CUDA when the card is there) around a block, exported as a Chrome trace
  (``<log_dir>/trace.json``). This is dfs_tpu's ``jax.profiler`` capture
  for the card.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import math
import os
import threading
import time

from dfs_tpu_torch.utils.logging import capped_key

# bucket upper bounds in seconds; bucket i covers (_BOUNDS[i-1],
# _BOUNDS[i]], one overflow bucket past the last. Exported (read-only by
# convention) for the OpenMetrics exposition, which emits the raw buckets
_BOUNDS = [2.0 ** e for e in range(-20, 8)]
BUCKET_BOUNDS = tuple(_BOUNDS)


class LatencyRecorder:
    """Streaming histograms per name; names beyond ``_MAX_NAMES`` fold
    into ``"_overflow"`` (logged once)."""

    _MAX_NAMES = 512

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._hist: dict[str, list[int]] = {}
        self._stats: dict[str, tuple[int, float, float]] = {}  # n, sum, max
        # name -> {bucket index -> (trace_id, observed seconds, wall ts)}:
        # the last traced observation per bucket (the OpenMetrics
        # exemplar), bounded by names x buckets
        self._ex: dict[str, dict[int, tuple[str, float, float]]] = {}
        self._overflow_warned = False

    def record(self, name: str, seconds: float,
               exemplar: str | None = None) -> None:
        """One observation; ``exemplar`` (a trace id) tags the bucket it
        lands in."""
        idx = bisect.bisect_left(_BOUNDS, seconds)
        with self._lock:
            name = capped_key(self._hist, name, self._MAX_NAMES, self,
                              "LatencyRecorder", "_overflow")
            h = self._hist.setdefault(name, [0] * (len(_BOUNDS) + 1))
            h[min(idx, len(_BOUNDS))] += 1
            n, s, mx = self._stats.get(name, (0, 0.0, 0.0))
            self._stats[name] = (n + 1, s + seconds, max(mx, seconds))
            if exemplar is not None:
                self._ex.setdefault(name, {})[min(idx, len(_BOUNDS))] = (
                    exemplar, seconds, time.time())

    @staticmethod
    def _quantile(h: list[int], q: float, total: int) -> float:
        """The geometric midpoint of the bucket the q-th sample falls in."""
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

    def histogram_snapshot(self) -> dict[str, tuple[list[int], int, float]]:
        """name -> (bucket counts aligned to BUCKET_BOUNDS plus the
        overflow slot, total count, sum of seconds)."""
        with self._lock:
            return {name: (list(h), self._stats[name][0],
                           self._stats[name][1])
                    for name, h in self._hist.items()}

    def exemplar_snapshot(self
                          ) -> dict[str, dict[int, tuple[str, float, float]]]:
        """name -> {bucket index -> (trace_id, seconds, wall ts)}."""
        with self._lock:
            return {name: dict(ex) for name, ex in self._ex.items()}


# Set only while device_trace() captures. span() reads this flag instead
# of importing the profiler per call: a request path never imports it
# unless a capture is active.
_PROFILING = False


def annotate(name: str):
    """An entered ``record_function(name)`` while a capture is active,
    else None; the caller exits it (see :func:`span`)."""
    if not _PROFILING:
        return None
    import torch.profiler  # device_trace already imported it

    rf = torch.profiler.record_function(name)
    rf.__enter__()
    return rf


def close_annotation(rf) -> None:
    if rf is not None:
        with contextlib.suppress(Exception):
            rf.__exit__(None, None, None)


@contextlib.contextmanager
def span(name: str, recorder: LatencyRecorder | None = None):
    """Time a phase into ``recorder`` under ``name``; frame it on the
    device trace while one is captured."""
    rf = annotate(name)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if recorder is not None:
            recorder.record(name, time.perf_counter() - t0)
        close_annotation(rf)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace around a block (CPU activity,
    and CUDA when available) and export it to ``<log_dir>/trace.json``
    (Chrome trace format). Usage: ``with device_trace('/tmp/t'):
    frag.chunk(data)``. Yields the profiler."""
    global _PROFILING
    import torch
    import torch.profiler

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    _PROFILING = True
    try:
        yield prof
    finally:
        _PROFILING = False
        if torch.cuda.is_available():
            torch.cuda.synchronize()    # the block's kernels in the trace
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def kernels_within(trace_file: str, range_name: str,
                   funcs: dict[str, tuple[str, ...]]) -> dict[str, int]:
    """Read a :func:`device_trace` export: for each name of ``funcs``
    (name -> CUDA function names, as ``kernels.DEVICE_FUNCS``), the device
    kernels whose start lies inside a ``range_name`` range (the CPU range
    or its device twin)."""
    with open(trace_file) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X"]
    ranges = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
              for e in events if e.get("name") == range_name
              and e.get("cat") in ("user_annotation", "gpu_user_annotation")]
    out = {}
    for name, fns in funcs.items():
        out[name] = sum(
            1 for e in events
            if e.get("cat") == "kernel"
            and any(fn in e.get("name", "") for fn in fns)
            and any(a <= float(e["ts"]) <= b for a, b in ranges))
    return out
