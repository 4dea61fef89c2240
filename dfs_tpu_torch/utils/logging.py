"""Loggers and the node's metric registries (a copy of dfs_tpu's
``utils/logging.py``): thread-safe monotonic counters and float
stopwatches with peak gauges, served under ``/metrics``."""

from __future__ import annotations

import logging
import threading
from collections import defaultdict


def capped_key(table: dict, key, cap: int, owner, what: str, fold):
    """``key`` while it is present or the registry has room, else the
    registry's ``fold`` key (warning once): a metric name derived from
    peer input can never grow ``/metrics`` without bound."""
    if key in table or len(table) < cap:
        return key
    if not owner._overflow_warned:
        owner._overflow_warned = True
        logging.getLogger("dfs_tpu_torch.metrics").warning(
            "%s cardinality cap (%d) hit; folding new keys into %r",
            what, cap, fold)
    return fold


def get_logger(name: str, node_id: int | None = None) -> logging.Logger:
    suffix = f".node{node_id}" if node_id is not None else ""
    logger = logging.getLogger(f"dfs_tpu_torch.{name}{suffix}")
    root = logging.getLogger("dfs_tpu_torch")
    if not root.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s"))
        root.addHandler(h)
        root.setLevel(logging.INFO)
        root.propagate = False
    return logger


class Counters:
    """Thread-safe monotonic counters, at most ``_MAX_NAMES`` names."""

    _MAX_NAMES = 512

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._c: dict[str, int] = defaultdict(int)
        self._overflow_warned = False

    def inc(self, name: str, by: int = 1) -> None:
        with self._lock:
            name = capped_key(self._c, name, self._MAX_NAMES, self,
                              "Counters", "_overflow")
            self._c[name] += by

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self._c)


class Stopwatches:
    """Thread-safe float accumulators (seconds) plus peak gauges: where
    the write path's time went (blocked on credits, on placement) and the
    pipeline depths it reached."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._s: dict[str, float] = defaultdict(float)
        self._peak: dict[str, float] = {}

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            self._s[name] += seconds

    def peak(self, name: str, value: float) -> None:
        with self._lock:
            if value > self._peak.get(name, float("-inf")):
                self._peak[name] = value

    def snapshot(self) -> dict[str, float]:
        with self._lock:
            out = {k: round(v, 6) for k, v in self._s.items()}
            out.update({f"{k}Peak": v for k, v in self._peak.items()})
            return out
