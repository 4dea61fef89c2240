"""The serving tier of a node (a copy of dfs_tpu's ``serve/``).

The storage plane below is content-addressed and immutable: a digest's
bytes never change, deletes and GC only make entries vanish. On that
substrate the tier adds:

- :mod:`.cache` — a byte-budgeted in-memory hot-chunk cache with SIEVE
  eviction; entries are only ever dropped (delete, GC, scrub, repair),
  never updated;
- :mod:`.singleflight` — per-digest coalescing: N concurrent readers of a
  chunk cost one local read or peer RPC; a failure reaches the current
  waiters and never poisons a retry;
- :mod:`.admission` — bounded concurrency per request class (download,
  upload, internal) with a bounded queue, 503 + Retry-After beyond it,
  and deadline shedding;
- :mod:`.hedge` — hedged reads and writes: a latency-derived delay and a
  token bucket;
- :mod:`.prefetch` — readahead of streamed downloads.

Everything is off by default (``ServeConfig()``): a node with the default
config runs the read, write and internal paths it runs without the tier.
"""

from __future__ import annotations

from dfs_tpu_torch.serve.admission import (AdmissionControl,
                                           ClientDisconnected, ShedError)
from dfs_tpu_torch.serve.cache import ChunkCache
from dfs_tpu_torch.serve.hedge import HedgePolicy
from dfs_tpu_torch.serve.prefetch import BatchPrefetcher
from dfs_tpu_torch.serve.singleflight import SingleFlight


class ServingTier:
    """One node's serving-tier state: the hot-chunk cache (None when the
    budget is 0), the per-digest single-flight table, the admission gates
    and the hedge policy (None when the hedge budget is 0). Built by every
    node; the default config makes every component a no-op."""

    def __init__(self, cfg, obs=None) -> None:
        self.cfg = cfg
        self.cache = ChunkCache(cfg.cache_bytes) \
            if cfg.cache_bytes > 0 else None
        self.flight = SingleFlight()
        # obs reaches the admission gates only (events, queue-wait spans)
        self.admission = AdmissionControl(cfg, obs=obs)
        self.readahead_batches = int(cfg.readahead_batches)
        # the budget refill is the master switch: 0 builds no policy and
        # the reads and writes take the single-replica walk
        self.hedge = HedgePolicy(cfg.hedge_floor_s, cfg.hedge_cap_s,
                                 cfg.hedge_budget_per_s) \
            if cfg.hedge_budget_per_s > 0 else None

    @property
    def read_path_enabled(self) -> bool:
        """The cache + single-flight read path rides the cache budget."""
        return self.cache is not None

    def drop_cached(self, digests) -> int:
        """Forget cached entries of deleted, GC'd or corrupt chunks (a
        memory reclaim: a cached entry is never wrong, only
        unreferenced). Returns the number dropped."""
        if self.cache is None:
            return 0
        n = 0
        for d in digests:
            if self.cache.drop(d):
                n += 1
        return n

    def stats(self) -> dict:
        """``/metrics`` ``serve``: dfs_tpu's document, off shapes too."""
        out: dict = {
            "flight": self.flight.stats(),
            "admission": self.admission.stats(),
            "readaheadBatches": self.readahead_batches,
            "defaultDeadlineS": self.cfg.default_deadline_s,
            "hedge": self.hedge.stats() if self.hedge is not None
            else {"enabled": False,
                  "floorS": self.cfg.hedge_floor_s,
                  "capS": self.cfg.hedge_cap_s,
                  "budgetPerS": self.cfg.hedge_budget_per_s},
        }
        if self.cache is not None:
            out["cache"] = self.cache.stats()
            out["cache"]["temperature"] = self.cache.temperature()
        else:
            out["cache"] = {"enabled": False}
        return out


__all__ = ["AdmissionControl", "BatchPrefetcher", "ChunkCache",
           "ClientDisconnected", "HedgePolicy", "ServingTier",
           "ShedError", "SingleFlight"]
