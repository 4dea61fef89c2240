"""Similarity compression plane (the port of dfs_tpu's ``sim/``).

Three parts, all default-off behind ``SimConfig`` (config.py):

- batched min-hash sketches (``sim.sketch``): every eligible put gets a
  ``sketch_size``-lane uint32 min-hash, computed on the node's device and
  byte-identical to dfs_tpu's NumPy oracle;
- a crash-safe band index (``sim.bands``): LSH band keys map to recent
  local digests, bounding the candidate set a new chunk is compared
  against;
- delta-encoded chunk storage (``sim.delta`` + the ``ChunkStore`` sim
  seam): when a candidate base yields a patch at or below
  ``min_savings_frac`` of the raw size, the CAS stores ``base-digest +
  patch`` and reconstructs transparently on read.

This module stays import-light: ``store.cas`` imports the delta codec
through the package, and the sketch stack (torch) only loads when a plane
is constructed.
"""

from __future__ import annotations

import threading
from pathlib import Path

from dfs_tpu_torch.config import SimConfig
from dfs_tpu_torch.sim.bands import BandIndex
from dfs_tpu_torch.sim.delta import make_delta


class SimPlane:
    """The node-side similarity plane: owns the sketcher and the band
    index, and plugs into ``ChunkStore.sim``. Thread-safe: encode and
    read-note calls arrive from the CAS worker threads.

    ``device`` is where the sketches run (None: the card, raising without
    one). ``crash`` is dfs_tpu's chaos seam for the ``sim.*`` crash points;
    the port has no chaos plane yet, so it stays None."""

    def __init__(self, cfg: SimConfig, root: Path, device=None) -> None:
        from dfs_tpu_torch.sim.sketch import SimSketcher, band_keys

        self.cfg = cfg
        self.sketcher = SimSketcher(cfg, device=device)
        self._band_keys = band_keys
        self.bands = BandIndex(Path(root),
                               per_key=max(8, cfg.max_candidates))
        self._crash = None
        self._mu = threading.Lock()
        self._reads: dict[str, int] = {}   # delta digest -> reads since stored
        # counters (the /metrics "sim" section)
        self.sketched = 0              # chunks sketched
        self.encode_attempts = 0       # candidate sets tried
        self.deltas_written = 0        # deltas durably stored
        self.delta_bytes = 0           # on-disk bytes of those deltas
        self.raw_bytes_deferred = 0    # raw bytes the deltas replaced
        self.delta_reads = 0           # reconstructions served
        self.rematerialized = 0        # deltas promoted back to raw
        self.missing_base = 0          # reconstructions refused: base gone

    # -- chaos seam -----------------------------------------------------
    @property
    def crash(self):
        return self._crash

    @crash.setter
    def crash(self, fn) -> None:
        self._crash = fn
        self.bands.crash = fn

    def maybe_crash(self, point: str) -> None:
        if self._crash is not None:
            self._crash(point)

    # -- write path -----------------------------------------------------
    def sketch_for_batch(self, store, items) -> dict:
        """Sketches for the new, eligible chunks of a put batch in one
        ``sketch_many`` (the ``AsyncChunkStore.put_many`` -> ``put_batch``
        seam). Returns ``{digest: sketch}`` for ``put(..., sketch=)``."""
        todo = []
        seen: set[str] = set()
        for d, b in items:
            if len(b) >= self.cfg.min_chunk_bytes and d not in seen \
                    and not store.has(d):
                seen.add(d)
                todo.append((d, b))
        if not todo:
            return {}
        arrs = self.sketcher.sketch_many([b for _, b in todo])
        with self._mu:
            self.sketched += len(todo)
        return {d: arrs[i] for i, (d, _) in enumerate(todo)}

    def encode_for_put(self, store, digest: str, data: bytes,
                       sketch=None):
        """Try to delta-encode ``data`` against a band-index candidate.
        Returns ``(base_digest, delta_blob)`` when a candidate beats the
        ``min_savings_frac`` bar, else None (store raw). The digest is
        registered in the band index either way, so later similar chunks
        can encode against this one."""
        if len(data) < self.cfg.min_chunk_bytes:
            return None
        if not isinstance(data, bytes):
            # replication hands zero-copy bytearray/memoryview slices; the
            # encoder hashes target slices (dict keys), so materialize once
            data = bytes(data)
        if sketch is None:
            sketch = self.sketcher.sketch_one(data)
            with self._mu:
                self.sketched += 1
        keys = self._band_keys(sketch, self.cfg.bands)
        if not keys:               # featureless chunk: no shingles
            return None
        cands = self.bands.lookup(keys, exclude=digest,
                                  limit=self.cfg.max_candidates)
        best = None
        bar = int(len(data) * self.cfg.min_savings_frac)
        for base_d in cands:
            # depth gate before the read: a base at the chain cap would
            # make this delta unreconstructible by policy
            depth = store.delta_depth(base_d)
            if depth < 0 or depth + 1 > self.cfg.max_delta_depth:
                continue
            base = store.get(base_d)
            if base is None:
                continue
            blob = make_delta(base_d, base, data)
            if len(blob) <= bar and (best is None
                                     or len(blob) < len(best[1])):
                best = (base_d, blob)
        with self._mu:
            if cands:
                self.encode_attempts += 1
        self.bands.add(digest, keys)
        return best

    def note_delta_stored(self, raw_len: int, blob_len: int) -> None:
        """Called by the CAS once a delta is durably linked and its base
        chain verified (``ChunkStore._put_delta``)."""
        with self._mu:
            self.deltas_written += 1
            self.delta_bytes += blob_len
            self.raw_bytes_deferred += raw_len

    def note_delta_dropped(self, blob_len: int) -> None:
        with self._mu:
            self.deltas_written = max(0, self.deltas_written - 1)
            self.delta_bytes = max(0, self.delta_bytes - blob_len)

    # -- read path ------------------------------------------------------
    def note_delta_read(self, digest: str) -> bool:
        """Count a reconstruction; True when the read count says this
        delta is hot and should re-materialize as raw
        (``rematerialize_reads`` = 0 disables)."""
        with self._mu:
            self.delta_reads += 1
            if self.cfg.rematerialize_reads <= 0:
                return False
            n = self._reads.get(digest, 0) + 1
            if n >= self.cfg.rematerialize_reads:
                self._reads.pop(digest, None)
                self.rematerialized += 1
                return True
            self._reads[digest] = n
            return False

    def note_missing_base(self) -> None:
        with self._mu:
            self.missing_base += 1

    # -- observability --------------------------------------------------
    def stats(self) -> dict:
        """Live counters; the config-mirror keys are added by
        ``StorageNodeServer.sim_stats``. ``sketchDegraded`` is kept for
        the shape of dfs_tpu's document and is always False: the port's
        sketcher never falls back."""
        with self._mu:
            return {
                "sketched": self.sketched,
                "encodeAttempts": self.encode_attempts,
                "deltasWritten": self.deltas_written,
                "deltaBytes": self.delta_bytes,
                "rawBytesDeferred": self.raw_bytes_deferred,
                "deltaReads": self.delta_reads,
                "rematerialized": self.rematerialized,
                "missingBase": self.missing_base,
                "bandKeys": self.bands.keys_total(),
                "bandEntries": len(self.bands),
                "bandCompactions": self.bands.compactions,
                "sketchDegraded": False,
            }

    def close(self) -> None:
        self.bands.close()
