"""Content-addressed local persistence.

Chunks are keyed purely by their sha256 digest — ``chunks/<d[:2]>/<digest>``
— so a chunk shared by two files (or two versions of one file) is stored
once. Manifests live under ``manifests/<fileId>.json`` and deletions leave
timestamped tombstones beside them (``manifests/<fileId>.tomb``, JSON
``{"ts": <unix seconds>}``). A node's root is ``<data_root>/node-<id>/``.
This is byte for byte the layout ``dfs_tpu``'s store writes, so either
package opens a data root the other wrote, tombstones included.

``fsync=True`` makes every put crash-durable before it returns: the
payload file is fsync'd before the link makes it visible and the directory
after it; manifest saves and tombstone writes are fsync'd the same way,
and the manifest save is what acknowledges an upload.
"""

from __future__ import annotations

import errno
import itertools
import json
import os
import tempfile
import threading
import time
from pathlib import Path

from dfs_tpu_torch.meta.manifest import Manifest
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
    """Flat content-addressed blob store. ``count()`` and the byte gauge
    are primed by one scan, then kept by put/delete."""

    def __init__(self, root: Path, fsync: bool = False) -> None:
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._root_str = os.fspath(self.root)
        self._fsync = bool(fsync)
        self._fsyncs = 0
        self._count: int | None = None
        self._lock = threading.Lock()
        self._dirs: set[str] = set()
        self._tmp_seq = itertools.count()

    def _path_str(self, digest: str) -> str:
        if not is_hex_digest(digest):
            raise ValueError(f"bad digest {digest!r}")
        return f"{self._root_str}/{digest[:2]}/{digest}"

    def has(self, digest: str) -> bool:
        return os.path.isfile(self._path_str(digest))

    def has_many(self, digests) -> list[bool]:
        return [self.has(d) for d in digests]

    def put(self, digest: str, data: bytes, verify: bool = True) -> bool:
        """Store a chunk; False if it already existed (a dedup hit). The
        visible write is an ``os.link`` of a temp file, which fails if the
        chunk appeared meanwhile, so of two racing writers exactly one
        sees True. With fsync on, the payload is fsync'd before the link
        and the directory after it."""
        p = self._path_str(digest)
        if os.path.isfile(p):
            return False
        if verify and sha256_hex(data) != digest:
            raise ValueError(f"data does not match digest {digest[:12]}…")
        parent = os.path.dirname(p)
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
            try:
                os.link(tmp, p)
            except FileExistsError:
                return False
            except OSError as e:
                # filesystem without hard links: atomic rename instead
                if e.errno not in (errno.EPERM, errno.EOPNOTSUPP,
                                   errno.ENOTSUP, errno.EMLINK):
                    raise
                os.replace(tmp, p)
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
        return True

    def put_batch(self, items, verify: bool = True) -> list[bool]:
        return [self.put(d, b, verify=verify) for d, b in items]

    def get(self, digest: str) -> bytes | None:
        try:
            with open(self._path_str(digest), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def delete(self, digest: str) -> bool:
        try:
            os.unlink(self._path_str(digest))
        except FileNotFoundError:
            return False
        with self._lock:
            if self._count is not None:
                self._count -= 1
        return True

    def digests(self) -> list[str]:
        out = []
        for sub in sorted(self.root.iterdir()) if self.root.is_dir() else []:
            if sub.is_dir():
                # skips strays such as crash-leaked .tmp-* files
                out.extend(sorted(p.name for p in sub.iterdir()
                                  if len(p.name) == 64
                                  and set(p.name) <= _HEX))
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
        total = 0
        for d in self.digests():
            try:
                total += os.path.getsize(self._path_str(d))
            except OSError:
                pass      # deleted between the listing and the stat
        return total

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
        commits."""
        live: set[str] = set()
        for m in self.manifests.list():
            live.update(m.all_digests())
        cutoff = time.time() - min_age_s
        deleted = []
        for d in self.chunks.digests():
            if d in live:
                continue
            if min_age_s > 0:
                try:
                    if os.stat(self.chunks._path_str(d)).st_mtime > cutoff:
                        continue
                except FileNotFoundError:
                    continue
            if self.chunks.delete(d):
                deleted.append(d)
        self.chunks.sweep_tmp()
        self.manifests.sweep_tmp()
        return deleted
