"""Content-addressed local persistence.

Chunks are keyed purely by their sha256 digest — ``chunks/<d[:2]>/<digest>``
— so a chunk shared by two files (or two versions of one file) is stored
once. Manifests live under ``manifests/<fileId>.json`` and deletions leave
timestamped tombstones beside them (``manifests/<fileId>.tomb``, JSON
``{"ts": <unix seconds>}``). A node's root is ``<data_root>/node-<id>/``.
This is byte for byte the layout ``dfs_tpu``'s store writes, so either
package opens a data root the other wrote, tombstones included.

With the similarity plane (:mod:`dfs_tpu_torch.sim`) attached, a chunk may
be stored as a DSD1 delta against a resident similar base under
``chunks/deltas/<d[:2]>/<digest>`` (dfs_tpu's tree) and is reconstructed
and sha256-verified on read. A resident delta pins its base: ``delete``
refuses it and GC keeps it. The delta tree is consulted only once it
exists on disk, so a store without the plane writes no ``deltas/``.

With the dedup/index plane (:mod:`dfs_tpu_torch.index`) attached, every
put and delete feeds the digest index from the calling thread (the CAS
workers), and ``has`` answers a positive from it without a stat. A put is
recorded after its link is visible and a delete before its unlink, both
under the ordering mutex, so the index may lag the disk (a false negative
the stat backstop heals) but never claims bytes that are not there.

``fsync=True`` makes every put crash-durable before it returns: the
payload file is fsync'd before the link makes it visible and the directory
after it; manifest saves and tombstone writes are fsync'd the same way,
and the manifest save is what acknowledges an upload.
"""

from __future__ import annotations

import contextlib
import errno
import itertools
import json
import os
import tempfile
import threading
import time
from pathlib import Path

from dfs_tpu_torch.meta.manifest import Manifest
# the delta codec is import-light (numpy + stdlib): safe at module level
from dfs_tpu_torch.sim.delta import HEADER_BYTES as _DELTA_HEADER_BYTES
from dfs_tpu_torch.sim.delta import apply_delta as _apply_delta
from dfs_tpu_torch.sim.delta import parse_header as _parse_delta_header
from dfs_tpu_torch.utils.hashing import is_hex_digest, sha256_hex

_TMP_SWEEP_AGE_S = 3600.0
_HEX = frozenset("0123456789abcdef")


def _fsync_path(path: str) -> None:
    """fsync a path by name (a directory after a create/rename, a file
    after a metadata-only change such as utime)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _atomic_write(path: Path | str, data: bytes, fsync: bool = False) -> None:
    parent = os.path.dirname(os.fspath(path)) or "."
    os.makedirs(parent, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=parent, prefix=".tmp-")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            if fsync:
                # payload durable BEFORE the rename makes it visible
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
        if fsync:
            _fsync_path(parent)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass          # the original error re-raises below
        raise


def _sweep_tmp_files(dirs, max_age_s: float = _TMP_SWEEP_AGE_S) -> int:
    """Unlink ``.tmp-*`` entries older than ``max_age_s`` in ``dirs``."""
    cutoff = time.time() - max_age_s
    n = 0
    for d in dirs:
        for p in d.glob(".tmp-*"):
            try:
                if p.stat().st_mtime <= cutoff:
                    p.unlink()
                    n += 1
            except OSError:
                continue  # raced a concurrent sweep or the temp's writer
    return n


class ChunkStore:
    """Flat content-addressed blob store. ``count()`` is primed by one
    scan, then kept by put/delete.

    ``sim`` is the similarity seam (a :class:`dfs_tpu_torch.sim.SimPlane`
    or None): when set, an eligible new chunk may be stored as a delta
    against a resident similar base, and ``get`` reconstructs it.

    ``index`` is the dedup/index seam (a
    :class:`dfs_tpu_torch.index.IndexPlane` or None), as dfs_tpu's.

    ``fault`` is the chaos seam (:mod:`dfs_tpu_torch.chaos`): when set,
    every put and get calls ``fault(op, digest)`` first, on the calling
    thread (the CAS workers), so injected ENOSPC / EIO / slow-disk faults
    ride the real I/O paths. None (the default) costs one attribute
    check."""

    def __init__(self, root: Path, fsync: bool = False) -> None:
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._root_str = os.fspath(self.root)
        self._fsync = bool(fsync)
        self._fsyncs = 0
        self._count: int | None = None
        self._bytes: int | None = None     # lazy; maintained by put/delete
        self._lock = threading.Lock()
        self._dirs: set[str] = set()
        self._tmp_seq = itertools.count()
        self.fault = None                  # chaos hook: fault(op, digest)
        self.sim = None
        # the dedup/index seam: None keeps every path without the index
        self.index = None
        self._deltas_root = f"{self._root_str}/deltas"
        # orders the visible link/unlink against its index record (a put
        # racing a delete of the same digest must not leave a stale
        # "present"), and delete()'s pin check + unlink against
        # _put_delta's link + pin registration: a racing delta write
        # either sees its base survive or rolls itself back
        self._index_mu = threading.Lock()
        self._delta_mu = threading.Lock()  # guards the two maps below
        self._delta_base: dict[str, str] = {}   # delta digest -> base
        self._delta_refs: dict[str, int] = {}   # base -> live dependents
        self._have_deltas = os.path.isdir(self._deltas_root)
        if self._have_deltas:
            self._prime_delta_maps()

    def _path_str(self, digest: str) -> str:
        if not is_hex_digest(digest):
            raise ValueError(f"bad digest {digest!r}")
        return f"{self._root_str}/{digest[:2]}/{digest}"

    # -- delta tree (similarity plane) ---------------------------------
    #
    # A delta-stored chunk lives at deltas/<d[:2]>/<digest> inside the
    # store root; the raw scans skip it (digests() keeps 64-hex names only,
    # and the 2-hex fan-out under deltas/ is one level deeper). The raw
    # file always wins when both exist (a crash mid-re-materialize).

    def _delta_path_str(self, digest: str) -> str:
        if not is_hex_digest(digest):
            raise ValueError(f"bad digest {digest!r}")
        return f"{self._deltas_root}/{digest[:2]}/{digest}"

    def _deltas_possible(self) -> bool:
        """False short-circuits every delta path: a store without deltas
        pays one uncontended lock and no extra stat."""
        with self._delta_mu:
            return self._have_deltas

    def _prime_delta_maps(self) -> None:
        """Rebuild the delta dependency maps from the on-disk headers (one
        41-byte read per delta) at open: the delta files are the log of
        the pins. A delta whose raw twin exists is a crash between
        re-materialize and unlink: the raw copy wins, the unlink is
        completed here."""
        droot = Path(self._deltas_root)
        for sub in sorted(droot.iterdir()) if droot.is_dir() else []:
            if not sub.is_dir():
                continue
            for p in sub.iterdir():
                d = p.name
                if len(d) != 64 or not set(d) <= _HEX:
                    continue
                if os.path.isfile(self._path_str(d)):
                    try:
                        p.unlink()
                    except OSError:
                        pass      # the raw file serves either way
                    continue
                try:
                    with open(p, "rb") as f:
                        base_d, _ = _parse_delta_header(
                            f.read(_DELTA_HEADER_BYTES))
                except (OSError, ValueError):
                    continue      # the read path drops a damaged delta
                self._delta_base[d] = base_d
                self._delta_refs[base_d] = \
                    self._delta_refs.get(base_d, 0) + 1

    def delta_base(self, digest: str) -> str | None:
        """Base digest of a delta-stored chunk, None when raw/absent."""
        with self._delta_mu:
            return self._delta_base.get(digest)

    def delta_pinned(self, digest: str) -> bool:
        """True when resident deltas reconstruct through ``digest``:
        delete() and GC must refuse it."""
        with self._delta_mu:
            return self._delta_refs.get(digest, 0) > 0

    def delta_count(self) -> int:
        with self._delta_mu:
            return len(self._delta_base)

    def delta_dependents(self, digest: str) -> list[str]:
        """Resident deltas whose base chain passes through ``digest``,
        deepest first, so deleting in order releases each pin before its
        holder is attempted."""
        with self._delta_mu:
            children: dict[str, list[str]] = {}
            for k, v in self._delta_base.items():
                children.setdefault(v, []).append(k)
        out: list[str] = []
        frontier = [digest]
        seen = {digest}
        while frontier:
            nxt = []
            for b in frontier:
                for k in children.get(b, ()):
                    if k not in seen:
                        seen.add(k)
                        out.append(k)
                        nxt.append(k)
            frontier = nxt
        out.reverse()
        return out

    def delta_depth(self, digest: str) -> int:
        """Chain length above ``digest``: 0 = raw-resident, N = a delta N
        hops from raw, -1 = absent or broken chain."""
        depth = 0
        cur = digest
        for _ in range(64):
            with self._delta_mu:
                base = self._delta_base.get(cur)
            if base is None:
                return depth if os.path.isfile(self._path_str(cur)) else -1
            depth += 1
            cur = base
        return -1

    def has(self, digest: str) -> bool:
        """Local existence. With the index plane attached a positive index
        answer is final (puts are recorded after the link, deletes before
        the unlink); a negative falls through to the stat, and a stat that
        contradicts the index re-records the digest (under the ordering
        mutex a racing delete takes), so a crash-lost record costs one
        stat, not one per probe forever."""
        if self.index is None:
            return os.path.isfile(self._path_str(digest)) \
                or (self._deltas_possible()
                    and self.delta_depth(digest) >= 0)
        if self.index.lookup(digest):
            return True
        with self._index_mu:
            present = os.path.isfile(self._path_str(digest)) \
                or (self._deltas_possible()
                    and self.delta_depth(digest) >= 0)
            if present:
                self.index.note_put(digest, defer_flush=True)
        if present:
            self.index.maybe_flush()       # outside the ordering mutex
        return present

    def has_many(self, digests) -> list[bool]:
        return [self.has(d) for d in digests]

    def put(self, digest: str, data: bytes, verify: bool = True,
            sketch=None) -> bool:
        """Store a chunk; False if it already existed (a dedup hit). The
        visible write is an ``os.link`` of a temp file, which fails if the
        chunk appeared meanwhile, so of two racing writers exactly one
        sees True. With fsync on, the payload is fsync'd before the link
        and the directory after it.

        With the similarity plane attached, an eligible new chunk may be
        stored as a delta instead; ``sketch`` carries its min-hash from
        the batched path (``put_batch``)."""
        if self.fault is not None:
            self.fault("put", digest)
        p = self._path_str(digest)
        if os.path.isfile(p):
            if self.index is not None and not self.index.lookup(digest):
                # a dedup hit on a chunk the index forgot (a crash-lost
                # WAL buffer): healed here too, as in has()
                with self._index_mu:
                    if os.path.isfile(p):
                        self.index.note_put(digest, defer_flush=True)
                self.index.maybe_flush()
            return False
        if self._deltas_possible():
            with self._delta_mu:
                if digest in self._delta_base:
                    return False   # present as a delta: a dedup hit
        if verify and sha256_hex(data) != digest:
            raise ValueError(f"data does not match digest {digest[:12]}…")
        if self.sim is not None:
            enc = self.sim.encode_for_put(self, digest, data, sketch=sketch)
            if enc is not None:
                stored = self._put_delta(digest, enc[0], enc[1],
                                         raw_len=len(data))
                if stored is not None:
                    return stored
                # rolled back (the base vanished mid-write): store raw
        return self._write_linked(os.path.dirname(p), p, data, digest)

    def put_batch(self, items, verify: bool = True) -> list[bool]:
        """Batched puts. With the plane, the batch's new eligible chunks
        are sketched in one ``sketch_for_batch`` call first; without it
        this is the per-item loop."""
        if self.sim is None:
            return [self.put(d, b, verify=verify) for d, b in items]
        sketches = self.sim.sketch_for_batch(self, items)
        return [self.put(d, b, verify=verify, sketch=sketches.get(d))
                for d, b in items]

    def _write_linked(self, parent: str, dest: str, data: bytes,
                      digest: str, on_link=None) -> bool:
        """tmp + O_EXCL + link (+ fsyncs) of ``data`` at ``dest``; False
        when ``dest`` appeared meanwhile. ``on_link`` (a delta's pin
        registration) and the index record of ``digest`` run right after
        the link, all under ``_index_mu``; the index's flush check runs
        after the mutex drops."""
        index = self.index
        if parent not in self._dirs:
            os.makedirs(parent, exist_ok=True)
            self._dirs.add(parent)
        while True:
            tmp = f"{parent}/.tmp-{os.getpid()}-{next(self._tmp_seq)}"
            try:
                fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o600)
                break
            except FileExistsError:
                continue
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
                if self._fsync:
                    f.flush()
                    os.fsync(f.fileno())
            with self._index_mu if on_link is not None \
                    or index is not None else contextlib.nullcontext():
                try:
                    os.link(tmp, dest)
                except FileExistsError:
                    return False
                except OSError as e:
                    # filesystem without hard links: atomic rename instead
                    if e.errno not in (errno.EPERM, errno.EOPNOTSUPP,
                                       errno.ENOTSUP, errno.EMLINK):
                        raise
                    os.replace(tmp, dest)
                if on_link is not None:
                    on_link()
                if index is not None:
                    # after the link is visible: a crash between the two
                    # leaves a false negative, which has()'s stat covers
                    index.note_put(digest, defer_flush=True)
            if self._fsync:
                _fsync_path(parent)
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass          # consumed by os.replace on the no-link path
        with self._lock:
            if self._fsync:
                self._fsyncs += 1
            if self._count is not None:
                self._count += 1
            if self._bytes is not None:
                self._bytes += len(data)
        if index is not None:
            index.maybe_flush()        # outside the ordering mutex
        return True

    def _put_delta(self, digest: str, base_digest: str, blob: bytes,
                   raw_len: int) -> bool | None:
        """Store ``digest`` as a delta blob against ``base_digest``.
        Returns True (stored), False (lost the link race: present), or
        None: the base vanished between the encoder's read and the pin
        registration, so the write was rolled back and the caller must
        store raw. Once the pin is registered (under ``_index_mu``, which
        delete() takes), no later delete can remove the base."""
        def pin() -> None:
            with self._delta_mu:
                self._delta_base[digest] = base_digest
                self._delta_refs[base_digest] = \
                    self._delta_refs.get(base_digest, 0) + 1
                self._have_deltas = True

        parent = f"{self._deltas_root}/{digest[:2]}"
        if not self._write_linked(parent, f"{parent}/{digest}", blob,
                                  digest, on_link=pin):
            return False
        if self.delta_depth(base_digest) < 0:
            # the base was deleted before the pin above became visible
            self._drop_delta(digest)
            return None
        if self.sim is not None:
            self.sim.maybe_crash("sim.after_delta_write")
            self.sim.note_delta_stored(raw_len, len(blob))
        return True

    def _drop_delta(self, digest: str) -> bool:
        """Unlink a delta file and release its base pin (rollback,
        corruption, re-materialize, or delete of a dead delta). The index
        delete record is skipped while the digest is still raw-resident
        (re-materialize leaves the chunk present)."""
        dp = self._delta_path_str(digest)
        with self._index_mu:
            with self._delta_mu:
                base = self._delta_base.pop(digest, None)
                if base is not None:
                    n = self._delta_refs.get(base, 0) - 1
                    if n > 0:
                        self._delta_refs[base] = n
                    else:
                        self._delta_refs.pop(base, None)
            try:
                blob_len = os.path.getsize(dp)
                if self.index is not None \
                        and not os.path.isfile(self._path_str(digest)):
                    self.index.note_delete(digest, defer_flush=True)
                os.unlink(dp)
            except FileNotFoundError:
                return False      # a racing drop: the maps are clean
        with self._lock:
            if self._count is not None:
                self._count -= 1
            if self._bytes is not None:
                self._bytes -= blob_len
        if self.sim is not None:
            self.sim.note_delta_dropped(blob_len)
        if self.index is not None:
            self.index.maybe_flush()
        return True

    def _rematerialize(self, digest: str, data: bytes) -> None:
        """Promote a hot delta back to a raw file: raw first, the delta
        unlinked after; a crash between the two leaves both, raw wins on
        read and ``_prime_delta_maps`` completes the unlink."""
        p = self._path_str(digest)
        if not os.path.isfile(p):      # raw write, past the sim seam
            self._write_linked(os.path.dirname(p), p, data, digest)
        if self.sim is not None:
            self.sim.maybe_crash("sim.after_rematerialize")
        self._drop_delta(digest)

    def get(self, digest: str) -> bytes | None:
        if self.fault is not None:
            self.fault("get", digest)
        try:
            with open(self._path_str(digest), "rb") as f:
                return f.read()
        except FileNotFoundError:
            if not self._deltas_possible():
                return None
            return self._get_delta(digest, 0)

    def _get_delta(self, digest: str, depth: int) -> bytes | None:
        """Read the delta blob, resolve its base (recursively: bases may
        be deltas), apply, and verify sha256 == digest before serving.
        Structural damage or a digest mismatch drops the delta like a
        corrupt raw chunk; a missing base reads as absent (scrub queues
        the base for repair)."""
        if depth > 64:
            return None
        try:
            with open(self._delta_path_str(digest), "rb") as f:
                blob = f.read()
        except FileNotFoundError:
            return None
        try:
            base_d, _ = _parse_delta_header(blob)
        except ValueError:
            self._drop_delta(digest)
            return None
        try:
            with open(self._path_str(base_d), "rb") as f:
                base = f.read()
        except FileNotFoundError:
            base = self._get_delta(base_d, depth + 1)
        if base is None:
            if self.sim is not None:
                self.sim.note_missing_base()
            return None
        try:
            out = _apply_delta(blob, base)
        except ValueError:
            self._drop_delta(digest)
            return None
        if sha256_hex(out) != digest:
            self._drop_delta(digest)
            return None
        if depth == 0 and self.sim is not None \
                and self.sim.note_delta_read(digest):
            self._rematerialize(digest, out)
        return out

    def delete(self, digest: str) -> bool:
        """Remove a chunk (raw or delta). A base that resident deltas
        reconstruct through is refused (False) until they die."""
        p = self._path_str(digest)
        with self._index_mu:
            if self.delta_pinned(digest):
                return False
            if self.index is not None and os.path.isfile(p):
                # recorded BEFORE the unlink (written through): a crash
                # between the two leaves a false negative for a present
                # chunk; the reverse order could persist a stale "present"
                self.index.note_delete(digest, defer_flush=True)
            try:
                # size before the unlink, for the byte gauge
                size = os.path.getsize(p)
                os.unlink(p)
            except FileNotFoundError:
                removed = False
            else:
                removed = True
        if removed:
            with self._lock:
                if self._count is not None:
                    self._count -= 1
                if self._bytes is not None:
                    self._bytes -= size
            if self.index is not None:
                self.index.maybe_flush()   # outside the ordering mutex
            return True
        return self._deltas_possible() and self._drop_delta(digest)

    def digests(self) -> list[str]:
        out = []
        for sub in sorted(self.root.iterdir()) if self.root.is_dir() else []:
            if sub.is_dir():
                # skips strays such as crash-leaked .tmp-* files, and the
                # deltas/ fan-out (2-hex names)
                out.extend(sorted(p.name for p in sub.iterdir()
                                  if len(p.name) == 64
                                  and set(p.name) <= _HEX))
        if self._deltas_possible():
            seen = set(out)
            droot = Path(self._deltas_root)
            for sub in sorted(droot.iterdir()) if droot.is_dir() else []:
                if sub.is_dir():
                    out.extend(sorted(
                        p.name for p in sub.iterdir()
                        if len(p.name) == 64 and set(p.name) <= _HEX
                        and p.name not in seen))
        return out

    def count(self) -> int:
        """Stored chunks, O(1) after the first call (the health op every
        peer probes reads it)."""
        with self._lock:
            primed = self._count
        if primed is None:
            n = len(self.digests())       # outside the lock
            with self._lock:
                if self._count is None:
                    self._count = n
        with self._lock:
            return self._count

    def total_bytes(self) -> int:
        """On-disk payload bytes: a delta-stored chunk counts its delta
        file (footprint, not logical size)."""
        total = 0
        for d in self.digests():
            for path in (self._path_str(d), self._delta_path_str(d)):
                try:
                    total += os.path.getsize(path)
                    break
                except OSError:
                    continue      # delta-stored, or deleted mid-scan
        return total

    def bytes_total(self) -> int:
        """CAS payload bytes, O(1) after the first call (the history
        sampler's capacity gauge): primed by one :meth:`inventory` pass
        outside the lock, then maintained by put and delete."""
        with self._lock:
            primed = self._bytes
        if primed is None:
            n = self.inventory()["bytes"]    # primes both gauges
            with self._lock:
                if self._bytes is None:
                    self._bytes = n
        with self._lock:
            return self._bytes

    # digest-prefix census buckets: 2 hex chars = 256 buckets, the on-disk
    # fan-out; the bucket hash is the XOR of each member digest's leading
    # 64 bits — order-free and computable from a manifest walk alone, so a
    # coordinator compares expected membership against this summary
    # without moving any digest list (obs/census.py)
    PREFIX_HEX = 2
    STAMP_HEX = 16

    @staticmethod
    def digest_stamp(digest: str) -> int:
        return int(digest[:ChunkStore.STAMP_HEX], 16)

    def inventory(self, list_prefixes=None, list_cap: int = 4096) -> dict:
        """Bucketed CAS census, as dfs_tpu's: per digest-prefix bucket
        ``[count, bytes, xor-hash]`` plus the store totals, in one readdir
        and stat pass (run off the event loop through
        :meth:`AsyncChunkStore.inventory`); it re-primes the count and
        byte gauges. A delta-stored chunk counts its delta file's bytes,
        and only while its chain reconstructs.

        With ``list_prefixes`` the walk covers exactly those buckets and
        returns only their sorted member lists (capped at ``list_cap``
        each, ``listTruncated`` set when a cap bit) — the drill-down; the
        summary keys stay present but zero and the gauges are untouched."""
        if list_prefixes is not None:
            listed: dict[str, list[str]] = {}
            truncated = False
            for prefix in sorted(set(list_prefixes)):
                sub = self.root / prefix
                pool = {d for d in (os.listdir(sub) if sub.is_dir() else [])
                        if len(d) == 64 and set(d) <= _HEX}
                if self._deltas_possible():
                    dsub = Path(self._deltas_root) / prefix
                    pool.update(
                        d for d in (os.listdir(dsub) if dsub.is_dir()
                                    else [])
                        if len(d) == 64 and set(d) <= _HEX)
                names = sorted(pool)
                if len(names) > list_cap:
                    names = names[:list_cap]
                    truncated = True
                listed[prefix] = names
            return {"buckets": {}, "chunks": 0, "bytes": 0,
                    "listed": listed, "listTruncated": truncated}
        buckets: dict[str, list] = {}
        total_n = total_b = 0
        for sub in sorted(self.root.iterdir()) if self.root.is_dir() else []:
            if not sub.is_dir() or len(sub.name) != self.PREFIX_HEX \
                    or not set(sub.name) <= _HEX:
                continue
            b = [0, 0, 0]
            for p in sub.iterdir():
                d = p.name
                if len(d) != 64 or not set(d) <= _HEX:
                    continue      # crash-leaked .tmp-* and strays
                try:
                    size = p.stat().st_size
                except OSError:
                    continue      # lost the race to a concurrent delete
                b[0] += 1
                b[1] += size
                b[2] ^= self.digest_stamp(d)
            if b[0]:
                buckets[sub.name] = b
                total_n += b[0]
                total_b += b[1]
        if self._deltas_possible():
            droot = Path(self._deltas_root)
            for sub in sorted(droot.iterdir()) if droot.is_dir() else []:
                if not sub.is_dir() or len(sub.name) != self.PREFIX_HEX \
                        or not set(sub.name) <= _HEX:
                    continue
                for p in sub.iterdir():
                    d = p.name
                    if len(d) != 64 or not set(d) <= _HEX:
                        continue
                    if os.path.isfile(self._path_str(d)):
                        continue  # mid-re-materialize: the raw pass has it
                    if self.delta_depth(d) < 0:
                        continue  # broken chain: absent for the census
                    try:
                        size = p.stat().st_size
                    except OSError:
                        continue
                    b = buckets.setdefault(sub.name, [0, 0, 0])
                    b[0] += 1
                    b[1] += size
                    b[2] ^= self.digest_stamp(d)
                    total_n += 1
                    total_b += size
        with self._lock:
            # the full scan is ground truth at scan time: every census
            # heals whatever skew the gauges carried
            self._count = total_n
            self._bytes = total_b
        return {"buckets": buckets, "chunks": total_n, "bytes": total_b}

    def fsync_count(self) -> int:
        with self._lock:
            return self._fsyncs

    def sweep_tmp(self, max_age_s: float = _TMP_SWEEP_AGE_S) -> int:
        """Reclaim crash-leaked ``.tmp-*`` files older than ``max_age_s``
        (an hour at run time, so a live put's temp is never swept; 0 only
        at boot, before anything is in flight)."""
        dirs = [sub for sub in
                (self.root.iterdir() if self.root.is_dir() else [])
                if sub.is_dir()]
        if self._deltas_possible():
            droot = Path(self._deltas_root)
            dirs.extend(sub for sub in
                        (droot.iterdir() if droot.is_dir() else [])
                        if sub.is_dir())
        return _sweep_tmp_files(dirs, max_age_s)


class ManifestStore:
    """Per-node manifest directory, ``<fileId>.json`` each; every node
    holds every manifest. Saves and deletes of one file id are serialized
    (16 striped locks), so a delete cannot land between a save's tombstone
    check and its write."""

    def __init__(self, root: Path, fsync: bool = False) -> None:
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._fsync = bool(fsync)
        self._mu = tuple(threading.Lock() for _ in range(16))

    def _lock(self, file_id: str) -> threading.Lock:
        return self._mu[int(file_id[:2], 16) & 15]

    def _path(self, file_id: str) -> Path:
        if not is_hex_digest(file_id):
            raise ValueError(f"bad file_id {file_id!r}")
        return self.root / f"{file_id}.json"

    def _tomb_path(self, file_id: str) -> Path:
        if not is_hex_digest(file_id):
            raise ValueError(f"bad file_id {file_id!r}")
        return self.root / f"{file_id}.tomb"

    def is_tombstoned(self, file_id: str) -> bool:
        return self._tomb_path(file_id).exists()

    def clear_tombstone(self, file_id: str) -> None:
        """A fresh upload of deleted content resurrects its file id."""
        self._tomb_path(file_id).unlink(missing_ok=True)

    def tombstones(self) -> list[str]:
        return sorted(p.stem for p in self.root.glob("*.tomb")
                      if is_hex_digest(p.stem))

    def save(self, m: Manifest, mtime: float | None = None) -> bool:
        """Persist a manifest; False (refused) when the file is
        tombstoned, so a late announce cannot resurrect a deleted file.
        ``mtime`` keeps the ORIGIN write time of a manifest adopted from a
        peer: the mtime is the last-writer-wins side against tombstone
        timestamps."""
        with self._lock(m.file_id):
            if self.is_tombstoned(m.file_id):
                return False
            p = self._path(m.file_id)
            _atomic_write(p, m.to_json().encode(), fsync=self._fsync)
            if mtime is not None:
                os.utime(p, (mtime, mtime))
                if self._fsync:
                    _fsync_path(os.fspath(p))
            return True

    def ids(self) -> list[str]:
        return sorted(p.stem for p in self.root.glob("*.json")
                      if is_hex_digest(p.stem))

    def load(self, file_id: str) -> Manifest | None:
        try:
            return Manifest.from_json(self._path(file_id).read_bytes())
        except FileNotFoundError:
            return None

    def list(self) -> list[Manifest]:
        out = []
        for p in sorted(self.root.glob("*.json")):
            try:
                out.append(Manifest.from_json(p.read_bytes()))
            except (ValueError, KeyError):
                continue      # a corrupt manifest does not fail the listing
        return out

    def delete(self, file_id: str, ts: float | None = None) -> bool:
        """Remove a manifest, leaving a timestamped tombstone (written
        first: a crash between the two errs toward the delete). ``ts``
        carries the ORIGIN deletion time of a propagated tombstone."""
        with self._lock(file_id):
            _atomic_write(self._tomb_path(file_id),
                          json.dumps({"ts": time.time() if ts is None
                                      else float(ts)}).encode(),
                          fsync=self._fsync)
            try:
                self._path(file_id).unlink()
                return True
            except FileNotFoundError:
                return False

    def tombstone_ts(self, file_id: str) -> float | None:
        """Deletion time of a tombstone (its file mtime if the body is
        unreadable), None if there is none."""
        p = self._tomb_path(file_id)
        try:
            return float(json.loads(p.read_bytes())["ts"])
        except FileNotFoundError:
            return None
        except (ValueError, KeyError, TypeError):
            try:
                return p.stat().st_mtime
            except FileNotFoundError:
                return None

    def mtime(self, file_id: str) -> float | None:
        try:
            return self._path(file_id).stat().st_mtime
        except FileNotFoundError:
            return None

    def sweep_tmp(self, max_age_s: float = _TMP_SWEEP_AGE_S) -> int:
        return _sweep_tmp_files([self.root], max_age_s)


class NodeStore:
    """A node's on-disk state: ``<root>/chunks`` + ``<root>/manifests``."""

    def __init__(self, data_root: Path, node_id: int,
                 fsync: bool = False) -> None:
        self.root = Path(data_root) / f"node-{node_id}"
        self.chunks = ChunkStore(self.root / "chunks", fsync=fsync)
        self.manifests = ManifestStore(self.root / "manifests", fsync=fsync)

    def boot_sweep(self) -> dict:
        """Crash recovery before the servers listen: every leaked temp
        (all from the previous life) and the aged orphan GC (a crash
        between the CAS puts and the manifest write leaves chunks no
        manifest references)."""
        tmps = self.chunks.sweep_tmp(max_age_s=0.0) \
            + self.manifests.sweep_tmp(max_age_s=0.0)
        orphans = self.gc(min_age_s=3600.0)
        return {"tmps": tmps, "orphans": len(orphans)}

    def gc(self, min_age_s: float = 0.0) -> list[str]:
        """Delete chunks no manifest references; returns their digests.
        ``min_age_s`` spares young chunks: uploads write the manifest
        last, so an in-flight upload's chunks look orphaned until it
        commits. A live delta's base chain is live too; dead deltas go
        first, and the sweep repeats while it frees pins."""
        live: set[str] = set()
        for m in self.manifests.list():
            live.update(m.all_digests())
        for d in list(live):
            cur = d
            for _ in range(64):
                base = self.chunks.delta_base(cur)
                if base is None:
                    break
                live.add(base)
                cur = base
        cutoff = time.time() - min_age_s
        dead = []
        for d in self.chunks.digests():
            if d in live:
                continue
            if min_age_s > 0:
                try:
                    st = os.stat(self.chunks._path_str(d))
                except FileNotFoundError:
                    try:   # delta-stored: age-gate on the delta file
                        st = os.stat(self.chunks._delta_path_str(d))
                    except FileNotFoundError:
                        continue
                if st.st_mtime > cutoff:
                    continue
            dead.append(d)
        # dead deltas first: each delete releases its base's pin
        dead.sort(key=lambda d: self.chunks.delta_base(d) is None)
        sim = self.chunks.sim
        if sim is not None and dead:
            sim.maybe_crash("sim.before_base_gc")
        deleted: list[str] = []
        pending = dead
        while pending:
            # a chain of dead deltas releases one pin per sweep; stop when
            # a sweep frees nothing (the rest are pinned by live deltas)
            nxt = []
            for d in pending:
                if self.chunks.delete(d):
                    deleted.append(d)
                elif self.chunks.delta_pinned(d):
                    nxt.append(d)
            if len(nxt) == len(pending):
                break
            pending = nxt
        self.chunks.sweep_tmp()
        self.manifests.sweep_tmp()
        return deleted
