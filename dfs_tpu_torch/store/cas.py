"""Content-addressed local persistence.

Chunks are keyed purely by their sha256 digest — ``chunks/<d[:2]>/<digest>``
— so a chunk shared by two files (or two versions of one file) is stored
once. Manifests live under ``manifests/<fileId>.json``. A node's root is
``<data_root>/node-<id>/``. This is byte for byte the layout ``dfs_tpu``'s
store writes, so either package opens a data root the other wrote.

``fsync=True`` makes every put crash-durable before it returns: the
payload file is fsync'd before the link makes it visible and the directory
after it; a manifest save is fsync'd the same way, and the manifest save is
what acknowledges an upload.
"""

from __future__ import annotations

import errno
import itertools
import os
import tempfile
import threading
from pathlib import Path

from dfs_tpu_torch.meta.manifest import Manifest
from dfs_tpu_torch.utils.hashing import is_hex_digest, sha256_hex


def _fsync_path(path: str) -> None:
    """fsync a path by name (a directory after a create/rename)."""
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


class ChunkStore:
    """Flat content-addressed blob store."""

    def __init__(self, root: Path, fsync: bool = False) -> None:
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._root_str = os.fspath(self.root)
        self._fsync = bool(fsync)
        self._fsyncs = 0
        self._lock = threading.Lock()
        self._dirs: set[str] = set()
        self._tmp_seq = itertools.count()

    def _path_str(self, digest: str) -> str:
        if not is_hex_digest(digest):
            raise ValueError(f"bad digest {digest!r}")
        return f"{self._root_str}/{digest[:2]}/{digest}"

    def has(self, digest: str) -> bool:
        return os.path.isfile(self._path_str(digest))

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
                with self._lock:
                    self._fsyncs += 1
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass          # consumed by os.replace on the no-link path
        return True

    def get(self, digest: str) -> bytes | None:
        try:
            with open(self._path_str(digest), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def fsync_count(self) -> int:
        with self._lock:
            return self._fsyncs


class ManifestStore:
    """Per-node manifest directory, ``<fileId>.json`` each."""

    def __init__(self, root: Path, fsync: bool = False) -> None:
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._fsync = bool(fsync)

    def _path(self, file_id: str) -> Path:
        if not is_hex_digest(file_id):
            raise ValueError(f"bad file_id {file_id!r}")
        return self.root / f"{file_id}.json"

    def save(self, m: Manifest) -> None:
        _atomic_write(self._path(m.file_id), m.to_json().encode(),
                      fsync=self._fsync)

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


class NodeStore:
    """A node's on-disk state: ``<root>/chunks`` + ``<root>/manifests``."""

    def __init__(self, data_root: Path, node_id: int,
                 fsync: bool = False) -> None:
        self.root = Path(data_root) / f"node-{node_id}"
        self.chunks = ChunkStore(self.root / "chunks", fsync=fsync)
        self.manifests = ManifestStore(self.root / "manifests", fsync=fsync)
