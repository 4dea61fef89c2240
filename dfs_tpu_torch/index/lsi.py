"""Log-structured local digest index (the dedup/index plane's L0), a copy
of dfs_tpu's ``index/lsi.py``: the WAL, run and ``CURRENT`` files are byte
for byte the same, so either package opens an ``index/`` the other wrote.

Every dedup decision today bottoms out in ``os.path.isfile`` — one stat
syscall per digest (store/cas.py ``has``), which is fine until the
catalog outgrows the dentry cache and every existence probe becomes a
disk seek (the Data Domain "disk bottleneck": Zhu et al., FAST'08).
This module is the memory-bounded on-disk fingerprint index that keeps
existence probes off the filesystem:

- an **append-only WAL** of (state, digest) records feeds a bounded
  in-memory **memtable** (dict, at most ``memtable_entries`` keys);
- a full memtable flushes to an immutable **sorted run** file; runs
  carry in-memory **fence pointers** (one 8-byte digest prefix per
  ``FENCE_EVERY`` records) and an optional per-run bloom, so a lookup
  is an O(1) memtable hit or ONE ``pread`` of a fenced block;
- when the run count exceeds ``compact_runs`` every run (plus the live
  memtable) folds into ONE base run — newest record wins, tombstones
  drop (a full compaction covers the whole keyspace, so "not found"
  and "deleted" are the same answer afterwards).

Crash safety is by ordering, not by fsync:

- the ``CURRENT`` manifest (atomic replace) is the only commitment
  point: runs and WALs it does not name do not exist — a crash mid
  flush/compaction leaves the previous CURRENT intact and the orphan
  files are swept at the next open;
- WAL records carry a per-record CRC; a torn tail (kill -9 mid-append)
  is truncated at the first bad record on replay;
- the feed ordering in ``ChunkStore`` (put recorded AFTER the link is
  visible, delete recorded BEFORE the unlink) makes every crash-window
  divergence a FALSE NEGATIVE — the index may not know about a chunk
  that exists (the stat backstop in ``ChunkStore.has`` covers it), but
  a "present" answer always refers to a chunk whose link was durable
  when the record was written. Put records may sit in a small buffer
  (flushed every ``_WAL_BUFFER`` records — losing them is the safe
  direction); delete records are written through before the unlink
  happens, because losing one would flip the divergence direction.

Anything structurally wrong at open (missing/corrupt CURRENT, bad run
checksum, impossible counts) degrades to a **rebuild from a CAS walk**
(``open_or_rebuild``) — the chunk files themselves are always the
ground truth, the index is a cache of their existence.

Thread discipline: every method is safe to call from the bounded CAS
worker threads (store/aio.py) — one lock guards the memtable/WAL/run
list; run files are immutable and read via ``os.pread`` on fds that
stay open until the run is retired, so lookups never race a
compaction's unlink.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
import zlib
from bisect import bisect_right
from pathlib import Path
from typing import Callable, Iterable

from dfs_tpu_torch.index.filter import BlockedBloomFilter
from dfs_tpu_torch.utils.hashing import is_hex_digest

_RUN_MAGIC = 0x44495831            # "DIX1"
_RUN_HEADER = struct.Struct(">IHHQ")   # magic, version, reserved, count
_RUN_VERSION = 1
_REC = 33                          # 32 digest bytes + 1 state byte
_WAL_REC = 37                      # state + digest32 + crc32
_WAL_BUFFER = 256                  # put records buffered before a write
FENCE_EVERY = 1024                 # records per fenced block

_PRESENT = 1
_DELETED = 0
_PRESENT_COLD = 2   # present, demoted to the EC cold tier — a
                    # presence verdict for every reader (lookup /
                    # filters / compaction keep the record), distinct
                    # only for the tiering plane's bookkeeping


class _Run:
    """One immutable sorted run: an open fd + in-memory fences (+ bloom).

    ``fences[i]`` is the first 8 digest bytes (big-endian int) of record
    ``i * FENCE_EVERY``; a lookup bisects the fences, preads one block,
    and binary-searches the 33-byte records inside it.

    ``refs``/``retired`` are guarded by the OWNING index's lock: a
    lookup pins the runs it snapshots before releasing the lock to
    pread, and a compaction retires a run instead of closing it — the
    fd is disposed only once the last pinned reader drains, so an
    unlocked pread can never hit a closed (or worse, reused) fd.
    """

    def __init__(self, path: Path, fd: int, count: int,
                 fences: list[int], bloom: BlockedBloomFilter | None
                 ) -> None:
        self.path = path
        self.fd = fd
        self.count = count
        self.fences = fences
        self.bloom = bloom
        self.refs = 0          # pinned readers (owner lock)
        self.retired = False   # replaced by a compaction (owner lock)
        self.drop_file = True  # retirement unlinks (False at shutdown:
                               # the files ARE the persisted index)

    def dispose(self) -> None:
        """Close (+ unlink, per ``drop_file``) — owner lock held,
        ``refs == 0``."""
        self.close()
        if self.drop_file:
            try:
                self.path.unlink()
            except OSError:
                pass

    def get(self, raw: bytes, prefix: int) -> int | None:
        """State byte for ``raw`` (32-byte digest) or None if absent."""
        if self.bloom is not None and not self.bloom.contains_raw(raw):
            return None
        # rightmost fence <= prefix names the block that can hold the
        # digest (fences are the block FIRST keys)
        blk = bisect_right(self.fences, prefix) - 1
        while blk >= 0:
            first = blk * FENCE_EVERY
            n = min(FENCE_EVERY, self.count - first)
            if n <= 0:
                return None
            data = os.pread(self.fd, n * _REC,
                            _RUN_HEADER.size + first * _REC)
            lo, hi = 0, len(data) // _REC
            while lo < hi:
                mid = (lo + hi) // 2
                d = data[mid * _REC:mid * _REC + 32]
                if d < raw:
                    lo = mid + 1
                elif d > raw:
                    hi = mid
                else:
                    return data[mid * _REC + 32]
            # fences hold only 8-byte PREFIXES, which are ambiguous at
            # block boundaries: if this block's first prefix equals the
            # probe's, records with the same prefix but smaller
            # suffixes sort into the PREVIOUS block — walk back (loop:
            # a >1024-way prefix collision would span several blocks).
            # Missing this returned None from the newest run and let an
            # older run resurrect a tombstoned digest.
            if blk > 0 and self.fences[blk] == prefix:
                blk -= 1
                continue
            return None
        return None

    def records(self) -> Iterable[tuple[bytes, int]]:
        """(digest, state) pairs in sorted order — the merge input."""
        off = _RUN_HEADER.size
        left = self.count
        while left:
            n = min(left, 8192)
            data = os.pread(self.fd, n * _REC, off)
            for i in range(n):
                rec = data[i * _REC:(i + 1) * _REC]
                yield rec[:32], rec[32]
            off += n * _REC
            left -= n

    def close(self) -> None:
        try:
            os.close(self.fd)
        except OSError:
            pass


class DigestIndex:
    """Persistent, crash-safe, memory-bounded digest→presence index.

    ``hook`` is the chaos seam (same shape as ``ChunkStore.fault``):
    when set it is called with a crash-point name at the compaction
    commit edge, so the kill -9 crash tests / bench can die exactly
    mid-compaction. ``on_event(etype, **fields)`` is a journal hook
    (index_rebuild / index_compact); the port's runtime has no event
    journal and leaves it unset.
    """

    def __init__(self, root: Path, memtable_entries: int = 65536,
                 compact_runs: int = 4, bloom_bits_per_key: int = 10,
                 background_compact: bool = False) -> None:
        self.root = Path(root)
        self.memtable_entries = max(256, int(memtable_entries))
        self.compact_runs = max(1, int(compact_runs))
        self.bloom_bits_per_key = max(0, int(bloom_bits_per_key))
        self.background_compact = bool(background_compact)
        self.hook: Callable[[str], None] | None = None
        self.on_event: Callable[..., None] | None = None
        # on_compact(present_digest_iter, count): the filter plane's
        # rebuild hook — a compaction is the one moment the full present
        # set is in hand, which is exactly when the local existence
        # filter can drop its accumulated deletes and bump generation
        self.on_compact: Callable[[list[bytes]], None] | None = None
        self._lock = threading.Lock()
        self._memtable: dict[bytes, int] = {}
        self._runs: list[_Run] = []
        self._wal_fd: int | None = None
        self._wal_name = ""
        self._wal_buf: list[bytes] = []
        self._seq = 0
        self._compacting = False
        self._compactions = 0
        self._rebuilds = 0
        self._wal_records = 0
        # background-compaction plumbing: the cv
        # shares the index lock, the thread starts lazily on the first
        # requested merge, and the stall counters attribute merge time
        # to whoever paid it — a CAS worker (inline mode, where one put
        # froze behind a multi-second merge) or
        # the dedicated thread (background mode)
        self._compact_cv = threading.Condition(self._lock)
        self._compact_thread: threading.Thread | None = None
        self._compact_wanted = False
        self._closed = False
        self._compact_stall_s = 0.0   # merge seconds paid by callers
        self._bg_compact_s = 0.0      # merge seconds on the thread

    # ---------------------------------------------------------------- #
    # open / rebuild
    # ---------------------------------------------------------------- #

    def open_or_rebuild(self, cas_digests: Callable[[], list[str]]
                        ) -> dict:
        """Open the persisted index; on ANY structural damage fall back
        to a rebuild from ``cas_digests()`` (the CAS walk is ground
        truth). Returns {"rebuilt": bool, "entries": int, "runs": int,
        "reason": str | None}."""
        self.root.mkdir(parents=True, exist_ok=True)
        reason = None
        try:
            entries = self._open()
        except (OSError, ValueError, KeyError, struct.error,
                json.JSONDecodeError) as e:
            reason = f"{type(e).__name__}: {e}"
            entries = self._rebuild(cas_digests())
        # run-list length read under the lock: boot ordering makes an
        # unlocked read safe TODAY, but nothing pins open_or_rebuild to
        # run before the workers start
        with self._lock:
            nruns = len(self._runs)
        info = {"rebuilt": reason is not None, "entries": entries,
                "runs": nruns, "reason": reason}
        if reason is not None and self.on_event is not None:
            self.on_event("index_rebuild", entries=entries,
                          reason=reason[:160])
        return info

    def _open(self) -> int:
        cur_path = self.root / "CURRENT"
        strays = {p.name for p in self.root.iterdir()
                  if p.name != "CURRENT"}
        if not cur_path.is_file():
            if strays:
                # runs/WALs with no manifest: a crash before the very
                # first CURRENT write, or a deleted manifest — the
                # orphans are unnamed state, rebuild from ground truth
                raise ValueError("runs without a CURRENT manifest")
            self._init_fresh()
            return 0
        cur = json.loads(cur_path.read_bytes())
        runs = cur["runs"]
        wal = cur["wal"]
        if not isinstance(runs, list) or not isinstance(wal, str):
            raise ValueError("malformed CURRENT")
        with self._lock:
            for name in runs:
                self._runs.append(self._load_run(self.root / name))
            self._seq = 1 + max(
                [int(n.split("-")[1].split(".")[0]) for n in runs]
                + [int(wal.split("-")[1].split(".")[0])], default=0)
            self._wal_name = wal
            self._replay_wal(self.root / wal)
            self._wal_fd = os.open(self.root / wal,
                                   os.O_WRONLY | os.O_CREAT
                                   | os.O_APPEND, 0o600)
            # unnamed files are leftovers of a crashed flush/compaction
            for name in strays - set(runs) - {wal}:
                (self.root / name).unlink(missing_ok=True)
            return sum(r.count for r in self._runs) \
                + len(self._memtable)

    def _init_fresh(self) -> None:
        with self._lock:
            self._wal_name = f"wal-{self._seq:08d}.log"
            self._seq += 1
            self._wal_fd = os.open(self.root / self._wal_name,
                                   os.O_WRONLY | os.O_CREAT
                                   | os.O_APPEND, 0o600)
            self._write_current_locked()

    def _write_current_locked(self) -> None:
        data = json.dumps({"runs": [r.path.name for r in self._runs],
                           "wal": self._wal_name}).encode()
        tmp = self.root / ".CURRENT.tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, self.root / "CURRENT")

    def _load_run(self, path: Path) -> _Run:
        fd = os.open(path, os.O_RDONLY)
        try:
            head = os.pread(fd, _RUN_HEADER.size, 0)
            magic, version, _, count = _RUN_HEADER.unpack(head)
            if magic != _RUN_MAGIC or version != _RUN_VERSION:
                raise ValueError(f"bad run header in {path.name}")
            size = os.fstat(fd).st_size
            if size != _RUN_HEADER.size + count * _REC + 4:
                raise ValueError(f"run {path.name} size mismatch")
            # one sequential pass builds fences + bloom AND verifies the
            # footer checksum — the open-time cost that buys pread-only
            # lookups for the run's whole life
            fences: list[int] = []
            bloom = BlockedBloomFilter(count, self.bloom_bits_per_key) \
                if self.bloom_bits_per_key and count else None
            crc = 0
            off = _RUN_HEADER.size
            left = count
            i = 0
            while left:
                n = min(left, 8192)
                data = os.pread(fd, n * _REC, off)
                crc = zlib.crc32(data, crc)
                for j in range(n):
                    rec = data[j * _REC:(j + 1) * _REC]
                    if i % FENCE_EVERY == 0:
                        fences.append(int.from_bytes(rec[:8], "big"))
                    if bloom is not None:
                        bloom.add_raw(rec[:32])
                    i += 1
                off += n * _REC
                left -= n
            footer = os.pread(fd, 4, off)
            if len(footer) != 4 \
                    or int.from_bytes(footer, "big") != crc:
                raise ValueError(f"run {path.name} checksum mismatch")
            return _Run(path, fd, count, fences, bloom)
        except BaseException:
            os.close(fd)
            raise

    def _replay_wal(self, path: Path) -> None:
        try:
            data = path.read_bytes()
        except FileNotFoundError:
            return
        good = 0
        replayed: dict[bytes, int] = {}
        for off in range(0, len(data) - _WAL_REC + 1, _WAL_REC):
            rec = data[off:off + _WAL_REC]
            if zlib.crc32(rec[:33]) != int.from_bytes(rec[33:], "big"):
                break   # torn tail: everything after is untrusted
            replayed[rec[1:33]] = rec[0]
            good = off + _WAL_REC
        # replayed records are STRICTLY OLDER than anything already in
        # the memtable: a caller that noted before open() (nothing in
        # the runtime does since the boot reorder, but the seam does
        # not forbid it) must not have its verdicts overwritten by the
        # previous life's WAL
        for raw, state in replayed.items():
            self._memtable.setdefault(raw, state)
        self._wal_records = good // _WAL_REC
        if good != len(data):
            # truncate the torn tail so the next append starts clean
            with open(path, "r+b") as f:
                f.truncate(good)

    def _rebuild(self, digests: list[str]) -> int:
        """Reset to one sorted base run built from the CAS walk."""
        with self._lock:
            for r in self._runs:
                r.close()
            self._runs = []
            self._memtable = {}
            self._wal_buf = []
            if self._wal_fd is not None:
                os.close(self._wal_fd)
                self._wal_fd = None
            for p in list(self.root.iterdir()):
                # multi-step teardown without a crash point: a kill -9
                # anywhere in the rebuild leaves at worst NO CURRENT —
                # the next open starts empty and the stat backstop /
                # scrub walk (which triggered this rebuild) re-feeds
                # everything; the index is derived state by design
                p.unlink(missing_ok=True)
            self._seq = 0
            self._rebuilds += 1
            recs = sorted((bytes.fromhex(d), _PRESENT)
                          for d in digests if is_hex_digest(d))
            if recs:
                self._runs.append(self._write_run_locked(recs))
            self._wal_name = f"wal-{self._seq:08d}.log"
            self._seq += 1
            self._wal_fd = os.open(self.root / self._wal_name,
                                   os.O_WRONLY | os.O_CREAT
                                   | os.O_APPEND, 0o600)
            self._write_current_locked()
            if self.on_compact is not None:
                self.on_compact([d for d, _ in recs])
            return len(recs)

    # ---------------------------------------------------------------- #
    # feed (CAS worker threads)
    # ---------------------------------------------------------------- #

    def note_put(self, digest: str, defer_flush: bool = False) -> None:
        """Record a newly-visible chunk. Called AFTER the CAS link is
        durable-visible — a crash between link and record leaves a
        false NEGATIVE (stat backstop covers it), never a false
        positive. Buffered: losing the buffer is the same safe
        direction. ``defer_flush=True`` records WITHOUT the memtable
        flush/compaction trigger — the ChunkStore seam notes under its
        ordering mutex and runs :meth:`maybe_flush` after releasing
        it, so a multi-second merge never freezes every CAS worker
        behind one put."""
        self._note(digest, _PRESENT, wal_flush=False,
                   defer_flush=defer_flush)

    def note_delete(self, digest: str, defer_flush: bool = False
                    ) -> None:
        """Record a deletion. Called BEFORE the unlink and written
        through (unbuffered): losing a delete record would leave a
        stale "present" — the one divergence direction the design
        forbids. ``defer_flush`` as in :meth:`note_put` (the WAL
        write-through still happens inline — it is one buffered
        ``write``, not a merge)."""
        self._note(digest, _DELETED, wal_flush=True,
                   defer_flush=defer_flush)

    def note_tier(self, digest: str, cold: bool) -> None:
        """Record a tier flip. Written through like a delete:
        the tier bit is flipped UNDER the demotion barrier (parity
        durable, replicas not yet dropped), so losing the record would
        leave the next life re-demoting an already-cold file — safe
        but wasteful; the write-through makes it merely unlikely. The
        WAL/run record format already round-trips arbitrary state
        bytes, so cold survives replay and compaction for free."""
        self._note(digest, _PRESENT_COLD if cold else _PRESENT,
                   wal_flush=True, defer_flush=False)

    def _note(self, digest: str, state: int, wal_flush: bool,
              defer_flush: bool) -> None:
        raw = bytes.fromhex(digest)
        body = bytes((state,)) + raw
        rec = body + zlib.crc32(body).to_bytes(4, "big")
        with self._lock:
            self._memtable[raw] = state
            self._wal_buf.append(rec)
            self._wal_records += 1
            if wal_flush or len(self._wal_buf) >= _WAL_BUFFER:
                self._flush_wal_locked()
            if not defer_flush:
                self._maybe_flush_locked()

    def maybe_flush(self) -> None:
        """Run the memtable-flush/compaction threshold check — the
        deferred half of ``defer_flush=True`` notes, called OUTSIDE
        the caller's ordering mutex."""
        with self._lock:
            self._maybe_flush_locked()

    def _maybe_flush_locked(self) -> None:
        # two triggers: distinct keys (memtable growth) and WAL
        # RECORDS — same-key churn (repeated store/delete of one
        # working set) rewrites memtable entries without growing the
        # dict, and an unbounded WAL would make replay time
        # proportional to total churn instead of catalog size
        if len(self._memtable) >= self.memtable_entries \
                or self._wal_records >= 8 * self.memtable_entries:
            self._flush_memtable_locked()

    def _flush_wal_locked(self) -> None:
        if self._wal_buf and self._wal_fd is not None:
            os.write(self._wal_fd, b"".join(self._wal_buf))
            self._wal_buf = []

    # ---------------------------------------------------------------- #
    # flush + compaction
    # ---------------------------------------------------------------- #

    def _write_run_locked(self, recs: list[tuple[bytes, int]]) -> _Run:
        """Allocate a sequence number and write one sorted run —
        callers hold the lock."""
        seq = self._seq
        self._seq += 1
        return self._write_run_file(recs, seq)

    def _write_run_file(self, recs: list[tuple[bytes, int]],
                        seq: int) -> _Run:
        """Write one sorted run (tmp + atomic rename) and return it
        loaded. Touches NO shared state (``seq`` is pre-allocated), so
        the off-lock compaction can call it while notes and lookups
        keep serving. ``recs`` must be sorted by digest."""
        name = f"run-{seq:08d}.idx"
        tmp = self.root / f".{name}.tmp"
        crc = 0
        with open(tmp, "wb") as f:
            f.write(_RUN_HEADER.pack(_RUN_MAGIC, _RUN_VERSION, 0,
                                     len(recs)))
            block: list[bytes] = []
            for raw, state in recs:
                block.append(raw + bytes((state,)))
                if len(block) >= 8192:
                    data = b"".join(block)
                    crc = zlib.crc32(data, crc)
                    f.write(data)
                    block = []
            if block:
                data = b"".join(block)
                crc = zlib.crc32(data, crc)
                f.write(data)
            f.write(crc.to_bytes(4, "big"))
        path = self.root / name
        os.replace(tmp, path)
        return self._load_run(path)

    def _flush_memtable_locked(self) -> None:
        """Memtable -> new run; commit via CURRENT; fresh WAL. Crash
        anywhere before the CURRENT replace: the old CURRENT still
        names the old WAL, which replays the same memtable."""
        if not self._memtable:
            return
        self._flush_wal_locked()
        recs = sorted(self._memtable.items())
        run = self._write_run_locked(recs)
        self._runs.append(run)
        old_wal = self._wal_name
        self._wal_name = f"wal-{self._seq:08d}.log"
        self._seq += 1
        new_fd = os.open(self.root / self._wal_name,
                         os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o600)
        # multi-step sequence without its own crash point: every
        # interruption window is covered by the docstring's ordering
        # argument (before the replace the old CURRENT replays the old
        # WAL; after it the old-WAL unlink is idempotent cleanup), and
        # the compaction edge one level up fires the ``index.compact``
        # chaos seam kill tests drive
        self._write_current_locked()
        if self._wal_fd is not None:
            os.close(self._wal_fd)
        self._wal_fd = new_fd
        (self.root / old_wal).unlink(missing_ok=True)
        self._memtable = {}
        self._wal_records = 0
        self._request_compact_locked()

    def _request_compact_locked(self) -> None:
        """Route a due compaction: inline on the calling (CAS worker)
        thread — the historical behavior, its cost attributed to
        ``compactStallS`` — or handed to the dedicated thread when
        ``background_compact`` (the caller returns immediately; the
        worker never stalls behind the merge)."""
        if self._compacting or len(self._runs) <= self.compact_runs:
            return
        if self.background_compact:
            self._compact_wanted = True
            if self._compact_thread is None and not self._closed:
                self._compact_thread = threading.Thread(
                    target=self._compact_loop,
                    name="dfs-index-compact", daemon=True)
                self._compact_thread.start()
            self._compact_cv.notify_all()
            return
        t0 = time.monotonic()
        self._maybe_compact_locked()
        self._compact_stall_s += time.monotonic() - t0

    def _compact_loop(self) -> None:
        """Dedicated compaction thread: waits for a due merge, runs it,
        repeats. The chaos ``index.compact`` crash point now fires on
        this thread — SIGKILL semantics are process-wide, so the crash
        tests' commit-edge kill window is unchanged."""
        with self._lock:
            while True:
                while not self._compact_wanted and not self._closed:
                    self._compact_cv.wait()
                if self._closed:
                    return
                self._compact_wanted = False
                t0 = time.monotonic()
                self._maybe_compact_locked()
                self._bg_compact_s += time.monotonic() - t0
                self._compact_cv.notify_all()

    def drain_compaction(self) -> None:
        """Block until no compaction is pending or running — test /
        bench determinism; an inline-mode index returns immediately."""
        with self._lock:
            while self._compact_wanted or self._compacting:
                self._compact_cv.wait(timeout=0.05)

    def _maybe_compact_locked(self) -> None:
        """Fold every current run into one base run, newest record
        winning, tombstones dropped (full-keyspace compaction).

        The merge + new-run write — seconds for a large catalog — run
        WITHOUT the lock: the snapshot runs are immutable (pinned via
        refs so nothing disposes them), so notes and lookups keep
        serving while the merge streams; only the seq allocation, the
        run-list swap, and the CURRENT commit hold the lock. Runs
        flushed DURING the merge are newer than the snapshot and
        simply stay on top of the new base run; ``_compacting`` keeps
        a concurrent flush from starting a second merge. The chaos
        hook fires BEFORE the CURRENT commit — a kill -9 there leaves
        the old CURRENT naming the old runs, which the next open loads
        unharmed (the half-written new run is an unnamed stray).

        Lock contract: held on entry and on exit; released in the
        middle."""
        if self._compacting or len(self._runs) <= self.compact_runs:
            return
        self._compacting = True
        snapshot = list(self._runs)
        for r in snapshot:
            r.refs += 1
        seq = self._seq
        self._seq += 1
        self._lock.release()
        try:
            merged: dict[bytes, int] = {}
            # oldest first so newer runs overwrite older verdicts
            for run in snapshot:
                merged.update(run.records())
            recs = sorted((d, s) for d, s in merged.items()
                          if s != _DELETED)
            new_run = self._write_run_file(recs, seq)
            if self.hook is not None:
                self.hook("index.compact")
        except BaseException:
            self._lock.acquire()
            self._unpin_locked(snapshot)
            self._compacting = False
            raise
        self._lock.acquire()
        self._unpin_locked(snapshot)
        # the new base run takes the OLDEST position; anything flushed
        # during the merge stays newer (overrides it on lookup)
        self._runs = [new_run] + [r for r in self._runs
                                  if r not in snapshot]
        for r in snapshot:
            r.retired = True
            if r.refs == 0:
                r.dispose()
        self._write_current_locked()          # the commitment point
        self._compacting = False
        self._compactions += 1
        self._compact_cv.notify_all()         # wake drain_compaction
        # observer callbacks off the lock: the filter rebuild
        # (on_compact) is an O(entries) bloom build that must not
        # stall every note/lookup behind it
        self._lock.release()
        try:
            if self.on_event is not None:
                self.on_event("index_compact", runsFolded=len(snapshot),
                              entries=len(recs))
            if self.on_compact is not None:
                self.on_compact([d for d, _ in recs])
        finally:
            self._lock.acquire()

    # ---------------------------------------------------------------- #
    # lookups
    # ---------------------------------------------------------------- #

    def lookup(self, digest: str) -> bool:
        """True iff the index believes the chunk is present. False
        covers both "deleted" and "never heard of it" — after a full
        compaction the two are indistinguishable, and the caller's
        stat backstop treats them the same. Run preads happen OUTSIDE
        the lock against PINNED runs (see ``_Run``): a concurrent
        compaction retires runs instead of closing them under a
        reader."""
        if not is_hex_digest(digest):
            return False
        raw = bytes.fromhex(digest)
        prefix = int.from_bytes(raw[:8], "big")
        with self._lock:
            state = self._memtable.get(raw)
            if state is not None:
                return state != _DELETED
            runs = list(reversed(self._runs))   # newest first
            for r in runs:
                r.refs += 1
        try:
            for run in runs:
                state = run.get(raw, prefix)
                if state is not None:
                    return state != _DELETED
            return False
        finally:
            with self._lock:
                self._unpin_locked(runs)

    def _unpin_locked(self, runs) -> None:
        for r in runs:
            r.refs -= 1
            if r.retired and r.refs == 0:
                r.dispose()

    def present_digests(self) -> list[bytes]:
        """Every digest the index currently believes present (raw
        32-byte form) — the filter (re)build input. One merge pass;
        callers run it off the event loop."""
        with self._lock:
            merged: dict[bytes, int] = {}
            for run in self._runs:
                merged.update(run.records())
            merged.update(self._memtable)
        return [d for d, s in merged.items() if s != _DELETED]

    # ---------------------------------------------------------------- #
    # lifecycle / stats
    # ---------------------------------------------------------------- #

    def flush(self) -> None:
        """Write through the WAL buffer (tests / clean shutdown)."""
        with self._lock:
            self._flush_wal_locked()

    def close(self) -> None:
        # stop the compaction thread first (join OUTSIDE the lock — a
        # mid-merge thread needs the lock to commit before it exits);
        # a still-pending wanted-compaction is simply dropped: the run
        # files are the persisted index either way, and the next life
        # re-triggers the merge at its first flush
        with self._lock:
            self._closed = True
            self._compact_cv.notify_all()
            t = self._compact_thread
            self._compact_thread = None
        if t is not None:
            t.join(timeout=30.0)
        with self._lock:
            self._flush_wal_locked()
            if self._wal_fd is not None:
                os.close(self._wal_fd)
                self._wal_fd = None
            # RETIRE the runs instead of closing their fds outright:
            # the CAS pools shut down with wait=False, so an in-flight
            # has_many may still be pread()ing a pinned run — its
            # unpin disposes the fd when it drains. ``drop_file=False``:
            # shutdown keeps the run FILES (they are the persisted
            # index), unlike compaction retirement.
            for r in self._runs:
                r.retired = True
                r.drop_file = False
                if r.refs == 0:
                    r.dispose()
            self._runs = []

    def stats(self) -> dict:
        """/metrics ``index.lsi`` gauges. ``memtableBytes`` is the
        bounded structure's footprint estimate (keys + states + dict
        slots); the bench's 1M-catalog gate measures the real thing
        with tracemalloc."""
        with self._lock:
            fence_entries = sum(len(r.fences) for r in self._runs)
            bloom_bytes = sum(len(r.bloom.buf) for r in self._runs
                              if r.bloom is not None)
            return {
                "memtableEntries": len(self._memtable),
                "memtableBytes": len(self._memtable) * 93,
                "memtableCap": self.memtable_entries,
                "runCount": len(self._runs),
                "runEntries": sum(r.count for r in self._runs),
                "fenceBytes": fence_entries * 8,
                "runBloomBytes": bloom_bytes,
                "walRecords": self._wal_records,
                "compactions": self._compactions,
                "rebuilds": self._rebuilds,
                # stall attribution: merge seconds paid inline by CAS
                # workers vs on the dedicated thread — backgrounding is
                # working exactly when the first stays ~0 while the
                # second (and ``compactions``) grows
                "compactStallS": round(self._compact_stall_s, 6),
                "bgCompactS": round(self._bg_compact_s, 6),
            }
