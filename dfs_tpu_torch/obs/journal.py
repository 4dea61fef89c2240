"""Flight recorder: a crash-safe, size-bounded on-disk event journal (a
copy of dfs_tpu's ``obs/journal.py``: the segments under
``<data root>/node-<id>/journal/`` are one format, so either package
reads what the other wrote).

The span ring (:mod:`dfs_tpu_torch.obs`) answers "what happened inside this request";
it cannot answer "what went wrong on this node last Tuesday" — lifecycle
events (peer death, admission sheds, RPC retry storms, repair/GC
decisions, loop-lag incidents) vanish with the process, and the ring
evicts under churn. The journal is the durable complement: every
lifecycle event is one JSON line in an append-only segment file, stamped
with the wall clock and the active trace id, so a post-mortem can walk
from "node 3 shed downloads at 14:02" to the exact traces involved.

Design constraints, in order:

- **The event loop never touches disk.** ``emit()`` is a lock-free
  ``queue.Queue.put_nowait``; a
  dedicated writer thread drains the queue and appends. A full queue
  DROPS the event and counts it (``stats()["dropped"]``) — diagnosis
  must never become backpressure on the system being diagnosed. Disk
  trouble (ENOSPC, a vanished directory) never kills the writer thread
  either: failed writes/rotations are counted (``stats()["ioErrors"]``),
  the batch drops, and journaling resumes when the disk recovers.
- **Crash-safe, not fsync-durable.** Records are newline-terminated
  JSON appended to the active segment; a ``kill -9`` mid-write leaves at
  most one torn final line, which readers silently discard (counted in
  ``stats()["torn"]`` per read). Every boot starts a FRESH segment, so
  a torn tail from the previous life never mixes with live appends.
- **Size-bounded.** The active segment rotates at
  ``segment_bytes``; oldest segments are deleted until the directory
  fits ``total_bytes``. A runaway event source costs history, never
  disk.

Segment names are ``events-<boot unix ts>-<seq>.jsonl`` — sortable
lexically within a boot and chronologically across boots (zero-padded
seq). Segments are opened create-only: a restart within the same
wall-clock second shares the boot timestamp but continues the seq past
the previous life's segments, so an existing file — torn tail included
— is never appended to.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from pathlib import Path

# record shape: {"ts": wall seconds, "type": str, "node": int,
#                "trace": 32-hex or absent, ...event fields}

_SENTINEL = None   # queue item that tells the writer thread to exit


def read_events(root: Path, since: float = 0.0,
                limit: int = 256) -> tuple[list[dict], int]:
    """-> (events with ts >= since, oldest first, at most ``limit``
    NEWEST such events; count of torn/unparsable lines skipped).

    Reads newest segment backwards so a large journal costs ~one
    segment of parsing for the common "recent events" query. Torn final
    records (crash mid-append) and any corrupt line are skipped, never
    fatal — a journal must be readable exactly when the process died
    badly. Segments may vanish mid-read (the writer's budget sweep);
    that is treated as end-of-history, not an error."""
    root = Path(root)
    try:
        segments = sorted(p for p in root.iterdir()
                          if p.name.startswith("events-")
                          and p.name.endswith(".jsonl"))
    # any sick-directory errno (missing, NotADirectory, EACCES…) is
    # empty history, not a 500 — /events must answer exactly when the
    # disk is the thing going wrong
    except OSError:
        return [], 0
    out: list[dict] = []
    torn = 0
    for seg in reversed(segments):
        try:
            raw = seg.read_bytes()
        except OSError:
            continue   # rotated away (or unreadable) under the reader
        batch: list[dict] = []
        complete = raw.endswith(b"\n")
        lines = raw.split(b"\n")
        if lines and lines[-1] == b"":
            lines.pop()
        for i, line in enumerate(lines):
            if not complete and i == len(lines) - 1:
                torn += 1          # torn final record: discard, don't parse
                continue
            try:
                ev = json.loads(line)
            except ValueError:
                torn += 1
                continue
            if isinstance(ev, dict) and ev.get("ts", 0.0) >= since:
                batch.append(ev)
        out = batch + out
        if len(out) >= limit:
            break
    return out[-limit:], torn


class Journal:
    """One node's flight recorder. Construct with the journal directory
    (created if absent); ``emit()`` from any thread; ``close()`` flushes
    and joins the writer."""

    _QUEUE_MAX = 4096

    def __init__(self, root: Path, node_id: int,
                 total_bytes: int = 16 * 1024 * 1024,
                 segment_bytes: int = 2 * 1024 * 1024) -> None:
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.node_id = node_id
        self.total_bytes = max(1, int(total_bytes))
        # a segment larger than the whole budget would let the ACTIVE
        # segment — which the sweep never deletes — overshoot the cap
        # all by itself; the budget wins ("costs history, never disk")
        self.segment_bytes = min(max(1, int(segment_bytes)),
                                 self.total_bytes)
        self._boot = time.time()
        self._seq = 0
        self._q: queue.Queue = queue.Queue(maxsize=self._QUEUE_MAX)
        self._dropped = 0
        self._emitted = 0
        self._io_errors = 0
        self._handled = 0   # records the writer has fully dealt with
        self._lock = threading.Lock()   # counters only
        self._f = None                  # writer-thread-owned
        self._f_bytes = 0
        self._writer = threading.Thread(target=self._run,
                                        name=f"journal-{node_id}",
                                        daemon=True)
        self._writer.start()

    # ---- producer side (any thread, never blocks) --------------------- #

    def emit(self, etype: str, fields: dict | None = None,
             trace: str | None = None) -> None:
        rec = {"ts": time.time(), "type": etype, "node": self.node_id}
        if trace is not None:
            rec["trace"] = trace
        if fields:
            rec.update(fields)
        try:
            self._q.put_nowait(rec)
            with self._lock:
                self._emitted += 1
        except queue.Full:
            with self._lock:
                self._dropped += 1

    # ---- writer thread ------------------------------------------------ #

    def _segment_path(self) -> Path:
        return self.root / f"events-{self._boot:.0f}-{self._seq:06d}.jsonl"

    def _open_segment(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
        # Create-only ("xb"), never append: a restart within the same
        # wall-clock second gets the same <boot ts>, and reopening the
        # previous life's segment in "ab" would glue this boot's first
        # record onto its torn final line — destroying both. Bump seq
        # past whatever names that life claimed instead.
        while True:
            self._seq += 1
            try:
                self._f = open(self._segment_path(), "xb")
                break
            except FileExistsError:
                continue
            except OSError:
                # ENOSPC, EACCES, the journal dir yanked out from under
                # us: the writer thread must SURVIVE — a dead writer
                # silently disables the flight recorder while stats()
                # keeps saying enabled. Count it, leave _f None, and
                # let _write retry a fresh open on the next batch.
                with self._lock:
                    self._io_errors += 1
                return
        self._f_bytes = 0
        self._enforce_budget()

    def _enforce_budget(self) -> None:
        """Delete oldest segments until the directory fits the budget
        (the active segment is never deleted)."""
        active = self._segment_path().name
        try:
            segs = sorted((p for p in self.root.iterdir()
                           if p.name.startswith("events-")
                           and p.name.endswith(".jsonl")
                           and p.name != active),
                          reverse=True)   # newest first
        except OSError:
            return
        budget = self.total_bytes - self._f_bytes
        for p in segs:
            try:
                n = p.stat().st_size
            except OSError:
                continue
            if budget - n < 0:
                try:
                    p.unlink()
                except OSError:
                    pass
            else:
                budget -= n

    def _run(self) -> None:
        self._open_segment()
        while True:
            try:
                rec = self._q.get(timeout=0.25)
            except queue.Empty:
                continue
            if rec is _SENTINEL:
                break
            # drain greedily: one write+flush per wakeup, not per record
            batch = [rec]
            while True:
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                if nxt is _SENTINEL:
                    self._write(batch)
                    if self._f is not None:
                        self._f.close()
                        self._f = None
                    return
                batch.append(nxt)
            self._write(batch)
            with self._lock:
                self._handled += len(batch)
        if self._f is not None:
            self._f.close()
            self._f = None

    def _write(self, batch: list[dict]) -> None:
        lines = []
        for rec in batch:
            try:
                lines.append(json.dumps(rec, separators=(",", ":"))
                             .encode() + b"\n")
            except (TypeError, ValueError):
                continue   # unserializable event field: drop the record
        # rotation is RECORD-granular: a burst bigger than a segment is
        # split at segment boundaries (overshoot bounded by one record),
        # otherwise one giant batch would land in one oversize segment
        # that the budget sweep then deletes wholesale — losing exactly
        # the burst worth keeping. One write+flush per segment chunk.
        i = 0
        while i < len(lines):
            if self._f is None:
                # an earlier rotation/write failed: retry the open so a
                # recovered disk resumes journaling (fresh segment)
                self._open_segment()
                if self._f is None:
                    return   # still broken: drop the rest, counted above
            room = self.segment_bytes - self._f_bytes
            chunk, size = [], 0
            while i < len(lines) and (not chunk or size < room):
                chunk.append(lines[i])
                size += len(lines[i])
                i += 1
            data = b"".join(chunk)
            try:
                self._f.write(data)
                self._f.flush()
            except OSError:
                # disk trouble must not take the node down (and must not
                # take the WRITER down either): count it, ditch the
                # handle so the next batch reopens, drop this batch
                with self._lock:
                    self._io_errors += 1
                try:
                    self._f.close()
                except OSError:
                    pass
                self._f = None
                return
            self._f_bytes += len(data)
            if self._f_bytes >= self.segment_bytes:
                self._open_segment()

    # ---- read side (blocking file I/O — call via asyncio.to_thread) -- #

    def tail(self, since: float = 0.0, limit: int = 256) -> dict:
        """Recent events (oldest first) + read/write health counters —
        the ``GET /events`` payload."""
        events, torn = read_events(self.root, since=since, limit=limit)
        st = self.stats()
        return {"events": events, "torn": torn,
                "dropped": st["dropped"], "emitted": st["emitted"]}

    def stats(self) -> dict:
        with self._lock:
            emitted, dropped = self._emitted, self._dropped
            io_errors = self._io_errors
        return {"enabled": True, "bytes": self.total_bytes,
                "segmentBytes": self.segment_bytes,
                "emitted": emitted, "dropped": dropped,
                "ioErrors": io_errors}

    def flush(self, timeout_s: float = 5.0) -> None:
        """Block until every event emitted BEFORE this call is on disk
        (tests and shutdown; NOT for the event loop). Queue-empty is not
        enough — the writer drains the queue into a local batch before
        touching the file, so this waits on the written-record count."""
        with self._lock:
            target = self._emitted
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if self._handled >= target:
                    return
            time.sleep(0.005)

    def close(self) -> None:
        if not self._writer.is_alive():
            return
        try:
            self._q.put(_SENTINEL, timeout=1.0)
        except queue.Full:
            pass
        self._writer.join(timeout=5.0)


__all__ = ["Journal", "read_events"]
