"""Crash-safe similarity band index (a copy of dfs_tpu's
``sim/bands.py``; ``bands.log`` records are shared byte for byte).

Maps LSH band keys (``sketch.band_keys``) to the recent local digests that
produced them: the bounded candidate set a new chunk's bands look up
before delta encoding.

- ONE append-only log (``bands.log``) of fixed-size CRC-framed records; a
  torn tail (kill -9 mid-append) is truncated at the first bad record on
  replay, so every surviving record was fully written;
- adds are buffered writes with no fsync: losing the tail of the log is
  the safe direction (a missed delta, never wrong bytes: candidates are
  verified against resident chunk content before any delta is written);
- the in-memory map is bounded per key (newest candidates win) and
  rebuilt from the log at open; a structurally wrong file degrades to a
  shorter index, because the chunk files are the ground truth;
- the log compacts itself: once it carries ``compact_factor`` bytes per
  live byte (and is past ``compact_min_bytes``), ``add`` rewrites the
  live records through a temp file (create-only ``"xb"`` open, payload
  fsync, the ``sim.band_compact`` crash point, atomic ``os.replace``,
  directory fsync). kill -9 anywhere leaves either the old complete log
  or the new complete log; a leftover temp is unlinked by the next
  attempt.

``crash`` is the chaos seam of dfs_tpu's ``sim.*`` crash points. The port
has no chaos plane yet, so it stays None and ``maybe_crash`` does nothing.
"""

from __future__ import annotations

import collections
import os
import struct
import threading
import zlib
from pathlib import Path

_REC = struct.Struct(">IQ32s")     # crc32(key||digest), band key, digest

# compaction trigger: rewrite once the log holds this many bytes per
# LIVE byte — and never below the floor, where rewriting is noise
_COMPACT_FACTOR = 4
_COMPACT_MIN_BYTES = 1 << 16


class BandIndex:
    """Bounded band-key -> recent-digests map over an append-only log.
    Thread-safe: adds arrive from the CAS worker threads."""

    def __init__(self, root: Path, per_key: int = 8,
                 compact_factor: int = _COMPACT_FACTOR,
                 compact_min_bytes: int = _COMPACT_MIN_BYTES) -> None:
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.path = self.root / "bands.log"
        self.per_key = max(1, int(per_key))
        self.compact_factor = max(2, int(compact_factor))
        self.compact_min_bytes = max(_REC.size, int(compact_min_bytes))
        self.crash = None   # chaos seam, wired through SimPlane.crash
        self.compactions = 0
        self._mu = threading.Lock()
        self._map: dict[int, collections.deque[str]] = {}
        self.replayed = 0
        self.truncated = 0
        self._log_bytes = 0
        self._replay()
        self._fh = open(self.path, "ab")

    def _replay(self) -> None:
        try:
            blob = self.path.read_bytes()
        except OSError:
            return
        good = 0
        while good + _REC.size <= len(blob):
            crc, key, raw = _REC.unpack_from(blob, good)
            if crc != zlib.crc32(blob[good + 4:good + _REC.size]):
                break
            self._note(key, raw.hex())
            good += _REC.size
            self.replayed += 1
        if good < len(blob):
            # torn tail: truncate so the next append starts on a record
            # boundary (the r16 WAL discipline)
            self.truncated = len(blob) - good
            with open(self.path, "r+b") as fh:
                fh.truncate(good)
        self._log_bytes = good

    def maybe_crash(self, point: str) -> None:
        if self.crash is not None:
            self.crash(point)

    def _note(self, key: int, digest: str) -> None:
        dq = self._map.get(key)
        if dq is None:
            dq = self._map[key] = collections.deque(maxlen=self.per_key)
        if digest in dq:
            dq.remove(digest)
        dq.appendleft(digest)

    def add(self, digest: str, keys: list[int]) -> None:
        """Record ``digest`` under its band keys (buffered append; no
        fsync — see module docstring for why losing it is safe).
        Triggers a compaction when the dead:live ratio crosses the
        configured factor."""
        raw = bytes.fromhex(digest)
        with self._mu:
            for key in keys:
                body = _REC.pack(0, key, raw)[4:]
                self._fh.write(struct.pack(">I", zlib.crc32(body)) + body)
                self._note(key, digest)
                self._log_bytes += _REC.size
            self._fh.flush()
            live = sum(len(dq) for dq in self._map.values())
            if self._log_bytes >= self.compact_min_bytes \
                    and self._log_bytes >= \
                    self.compact_factor * live * _REC.size:
                self._compact_locked(live)

    def compact(self) -> int:
        """Rewrite the log down to the live records (public entry for
        tests/tools; ``add`` triggers it automatically). Returns the
        number of records written."""
        with self._mu:
            return self._compact_locked(
                sum(len(dq) for dq in self._map.values()))

    def _compact_locked(self, live: int) -> int:
        """The crash-safe log rewrite, ``_mu`` held. Exactly the
        DFS011 ordering discipline: temp written create-only ("xb" —
        a leftover from a crashed run is unlinked first, never
        appended onto), payload fsynced BEFORE the atomic rename makes
        it visible, directory entry fsynced after. The registered
        ``sim.band_compact`` crash point fires in the widest window —
        new log durable at its temp name, old log still the visible
        one — where replay must still serve the OLD complete log."""
        tmp = self.path.with_suffix(".compact")
        tmp.unlink(missing_ok=True)
        with open(tmp, "xb") as fh:
            for key, dq in self._map.items():
                # deques hold newest-first; replay appendleft-rebuilds
                # that order only from an oldest-first file
                for digest in reversed(dq):
                    body = _REC.pack(0, key, bytes.fromhex(digest))[4:]
                    fh.write(struct.pack(">I", zlib.crc32(body)) + body)
            fh.flush()
            os.fsync(fh.fileno())
        self.maybe_crash("sim.band_compact")
        self._fh.close()
        os.replace(tmp, self.path)
        self._fsync_dir()
        self._fh = open(self.path, "ab")
        self._log_bytes = live * _REC.size
        self.compactions += 1
        return live

    def lookup(self, keys: list[int], exclude: str | None = None,
               limit: int = 8) -> list[str]:
        """Candidate digests sharing any band with ``keys`` — unique,
        newest first, at most ``limit``."""
        out: list[str] = []
        seen = {exclude} if exclude else set()
        with self._mu:
            for key in keys:
                for d in self._map.get(key, ()):
                    if d not in seen:
                        seen.add(d)
                        out.append(d)
                        if len(out) >= limit:
                            return out
        return out

    def __len__(self) -> int:
        with self._mu:
            return sum(len(dq) for dq in self._map.values())

    def keys_total(self) -> int:
        with self._mu:
            return len(self._map)

    def _fsync_dir(self) -> None:
        """Sync the log's directory entry (after a compaction rename,
        and once at clean shutdown)."""
        try:
            fd = os.open(self.root, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        except OSError:
            pass

    def close(self) -> None:
        with self._mu:
            try:
                self._fh.close()
            except OSError:
                pass
        # sync the log's directory entry once at shutdown so a clean
        # stop persists the index across an immediate power cut
        self._fsync_dir()
