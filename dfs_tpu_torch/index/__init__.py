"""The dedup/index plane of the port, a copy of dfs_tpu's ``index/``.

Two halves, both default-off behind :class:`~dfs_tpu_torch.config.IndexConfig`:

- :mod:`dfs_tpu_torch.index.lsi` — the persistent log-structured local
  digest index, so local existence probes stop being one stat syscall per
  digest;
- :mod:`dfs_tpu_torch.index.filter` — blocked-bloom summaries of each
  peer's digest set, delta-gossiped over the storage plane, so placement
  can skip most ``has_chunks`` probe round-trips.

:class:`IndexPlane` is the node-facing assembly: the runtime builds one
when ``IndexConfig.enabled`` and hands it to the :class:`ChunkStore` (the
``index`` seam — put/delete feed + the ``has()`` fast path). A node built
with ``IndexConfig()`` builds no plane and every seam is one ``is None``
branch. Both halves stay host Python, as in dfs_tpu; the on-disk files
(``<node>/index/``) and the filter bytes on the wire are the same in both
packages.
"""

from __future__ import annotations

from collections import OrderedDict
from pathlib import Path

from dfs_tpu_torch.index.filter import (DELTA_CAP, BlockedBloomFilter,
                                        LocalFilter, PeerFilterSet)
from dfs_tpu_torch.index.lsi import DigestIndex

# run-internal bloom sizing (per-run skip filters inside the LSI) —
# deliberately NOT the peer-filter knob: the peer exchange can be off
# (filter_bits_per_key=0) while lookups still want run skipping
_RUN_BLOOM_BITS = 10


class EchoCache:
    """Per-peer bounded LRU of digests whose presence on that peer was
    *hash-echo confirmed this session* — the peer itself hashed the
    payload and echoed the digest back (``store_chunks`` echo), or
    answered a pre-ack ``has_chunks`` verification round. Unlike a
    bloom positive this is first-party evidence, so a cache hit skips
    even the trust-verification round on re-upload (the trust ledger
    still covers everything the cache cannot vouch for).

    Scoped to one ring epoch: a membership change moves digest
    ownership, so ``note_epoch`` with a new epoch drops everything —
    stale epochs must never vouch for placement under a new map. A
    peer's death drops its shard (``drop``): the confirmation was about
    THAT process's durable store; its restart re-earns entries.

    Single-owner affinity (event loop on the node, the caller's thread
    in the SDK) — no locks, matching the placement counters."""

    def __init__(self, per_peer: int) -> None:
        self.per_peer = max(1, int(per_peer))
        self._peers: dict[int, OrderedDict] = {}
        self.epoch: int | None = None
        self.hits = 0
        self.confirms = 0
        self.invalidations = 0

    def note_epoch(self, epoch: int) -> None:
        """Pin the cache to a ring epoch; a DIFFERENT epoch than the
        pinned one clears every entry (ownership moved)."""
        if self.epoch is not None and epoch != self.epoch:
            self._peers.clear()
            self.invalidations += 1
        self.epoch = epoch

    def confirm(self, peer: int, digest: str) -> None:
        lru = self._peers.setdefault(peer, OrderedDict())
        if digest in lru:
            lru.move_to_end(digest)
        else:
            lru[digest] = None
            if len(lru) > self.per_peer:
                lru.popitem(last=False)
        self.confirms += 1

    def confirmed(self, peer: int, digest: str) -> bool:
        lru = self._peers.get(peer)
        if lru is None or digest not in lru:
            return False
        lru.move_to_end(digest)
        self.hits += 1
        return True

    def drop(self, peer: int) -> None:
        self._peers.pop(peer, None)

    def stats(self) -> dict:
        return {"entries": sum(len(v) for v in self._peers.values()),
                "perPeerCap": self.per_peer,
                "hits": self.hits, "confirms": self.confirms,
                "invalidations": self.invalidations}


class IndexPlane:
    """One node's dedup/index plane: LSI + local filter + peer-filter
    replicas + the probe-skipping counters placement feeds.

    The LSI feed methods (``note_put`` / ``note_delete`` / ``lookup``)
    run on the bounded CAS worker threads (the ChunkStore seam); the
    counters are event-loop-only (placement/probe paths)."""

    def __init__(self, cfg, root: Path) -> None:
        self.cfg = cfg
        self.lsi = DigestIndex(
            Path(root) / "index",
            memtable_entries=cfg.memtable_entries,
            compact_runs=cfg.compact_runs,
            bloom_bits_per_key=_RUN_BLOOM_BITS,
            background_compact=getattr(cfg, "background_compact",
                                       False))
        self.local_filter: LocalFilter | None = None
        self.peer_filters = PeerFilterSet()
        if cfg.filter_bits_per_key > 0:
            self.local_filter = LocalFilter(
                bits_per_key=cfg.filter_bits_per_key)
            self.lsi.on_compact = self.local_filter.rebuild
        self.echo_cache: EchoCache | None = None
        if getattr(cfg, "echo_cache_entries", 0) > 0:
            self.echo_cache = EchoCache(cfg.echo_cache_entries)
        # placement probe-skipping accounting (event loop only)
        self.probes_skipped = 0       # digests never probed over RPC
        self.probe_rpcs_skipped = 0   # whole has_chunks RPCs elided
        self.trusted = 0              # filter-positive copies credited
        self.echo_trusted = 0         # echo-cache copies credited
                                      # (skip ledger AND verify round)

    # ---- ChunkStore seam (CAS worker threads) ------------------------ #

    def note_put(self, digest: str, defer_flush: bool = False) -> None:
        self.lsi.note_put(digest, defer_flush=defer_flush)
        if self.local_filter is not None:
            self.local_filter.add(digest)

    def note_delete(self, digest: str,
                    defer_flush: bool = False) -> None:
        self.lsi.note_delete(digest, defer_flush=defer_flush)
        # blooms cannot unlearn: the delete stays a stale bit until the
        # next compaction rebuilds the filter (fresh generation)

    def note_tier(self, digest: str, cold: bool) -> None:
        """Tier flip: presence is unchanged — the digest stays in
        the local filter either way — only the LSI state byte moves
        between hot and cold."""
        self.lsi.note_tier(digest, cold)

    def maybe_flush(self) -> None:
        """Deferred flush/compaction check (see DigestIndex.note_put):
        the ChunkStore seam calls this AFTER releasing its ordering
        mutex, so a merge never freezes every CAS worker behind it."""
        self.lsi.maybe_flush()

    def lookup(self, digest: str) -> bool:
        return self.lsi.lookup(digest)

    # ---- lifecycle --------------------------------------------------- #

    def open_or_rebuild(self, cas_digests) -> dict:
        info = self.lsi.open_or_rebuild(cas_digests)
        if self.local_filter is not None and not info["rebuilt"]:
            # prime the local filter from the opened index; the
            # rebuild path already primed it via on_compact — doing it
            # again would re-pay a full-catalog merge at boot
            self.local_filter.rebuild(self.lsi.present_digests())
        return info

    def close(self) -> None:
        self.lsi.close()

    # ---- /metrics "index" (live half; config echo lives in runtime) -- #

    def stats(self) -> dict:
        out = {"lsi": self.lsi.stats(),
               "probesSkipped": self.probes_skipped,
               "probeRpcsSkipped": self.probe_rpcs_skipped,
               "filterTrusted": self.trusted,
               "filterFp": self.peer_filters.fp_observed,
               "echoTrusted": self.echo_trusted}
        if self.local_filter is not None:
            out["filter"] = self.local_filter.stats()
            out["peerFilters"] = self.peer_filters.stats()
        if self.echo_cache is not None:
            out["echoCache"] = self.echo_cache.stats()
        return out


__all__ = ["IndexPlane", "DigestIndex", "LocalFilter",
           "BlockedBloomFilter", "PeerFilterSet", "EchoCache",
           "DELTA_CAP"]
