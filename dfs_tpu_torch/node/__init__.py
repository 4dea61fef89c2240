"""Storage nodes. :mod:`dfs_tpu_torch.node.runtime` is the node as users
run it (``StorageNodeServer``: HTTP API, internal plane, replication);
:class:`LocalNode`, here, is its single-node core as a library: upload,
download and list over one data root.

:class:`LocalNode` follows ``dfs_tpu``'s ``StorageNodeServer.upload``,
``upload_stream`` and ``download`` with replication factor 1, no peers
and fsync durability. An upload

1. hashes the body: fileId = sha256(body);
2. chunks it through the CUDA fragmenter (the anchored chain);
3. puts each distinct chunk into the CAS once (fsync'd before it is
   visible) on a bounded pool of 4 workers, as the reference's async CAS
   tier does, counting ``transferredBytes`` for new
   chunks and ``dedupSkippedBytes`` for chunks already stored;
4. once every put has completed, saves the manifest (fsync'd) — the
   acknowledgement.

A download reassembles the file from its manifest and verifies every
chunk's sha256 and the whole file's against its fileId.
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from dfs_tpu_torch import resolve_device
from dfs_tpu_torch.config import FragmenterConfig
from dfs_tpu_torch.fragmenter.cdc_anchored import AnchoredCudaFragmenter
from dfs_tpu_torch.fragmenter.cdc_anchored_sharded import \
    ShardedAnchoredCudaFragmenter
from dfs_tpu_torch.meta.manifest import Manifest
from dfs_tpu_torch.ops.cdc_anchored import AnchoredCdcParams
from dfs_tpu_torch.store.cas import NodeStore
from dfs_tpu_torch.utils.hashing import sha256_hex, sha256_new


class ChunkCorrupt(IOError):
    """A stored chunk is missing or does not hash to its digest."""


class _Placement:
    """The CAS puts of one upload: each distinct digest once, on the node's
    worker pool, with at most ``limit`` payload bytes outstanding (the
    oldest put is awaited before more are queued)."""

    def __init__(self, node: "LocalNode", limit: int) -> None:
        self.node = node
        self.limit = limit
        self.seen: set[str] = set()
        self.queue: collections.deque = collections.deque()
        self.outstanding = 0
        self.stats = {"bytes": 0, "uniqueChunks": 0, "transferredBytes": 0,
                      "dedupSkippedBytes": 0}

    def put(self, digest: str, payload) -> None:
        if digest in self.seen:
            return            # duplicate content within the file: once
        self.seen.add(digest)
        fut = self.node._cas_pool.submit(self.node.store.chunks.put, digest,
                                         bytes(payload))
        self.queue.append((len(payload), fut))
        self.outstanding += len(payload)
        while self.outstanding > self.limit:
            self._settle_one()

    def _settle_one(self) -> None:
        n, fut = self.queue.popleft()
        self.outstanding -= n
        key = "transferredBytes" if fut.result() else "dedupSkippedBytes"
        self.stats[key] += n

    def finish(self, total: int) -> dict:
        """Wait for every put (a failed put raises here, before any ack)."""
        while self.queue:
            self._settle_one()
        self.stats["bytes"] = total
        self.stats["uniqueChunks"] = len(self.seen)
        return self.stats


class LocalNode:
    """One node over ``data_root`` (``<data_root>/node-<id>/``). ``device``
    defaults to the CUDA card and raises without one; ``device="cpu"`` runs
    the chain through the plain versions. ``frag.devices > 1`` chunks with
    the window-batched walk over that many slots, placed by ``device`` as
    ``parallel.mesh.make_mesh`` places them (None: one per card, raising
    when the cards are not there; "cpu": CPU slots); otherwise the
    single-device walk's knobs (region_bytes, cpu_cutoff, lane_multiple,
    max_inflight) pass through ``engine``."""

    CAS_IO_THREADS = 4                     # the reference's cas_io_threads
    PLACE_LIMIT_BYTES = 64 * 1024 * 1024   # payload bytes queued for puts

    def __init__(self, data_root, node_id: int = 1, device=None,
                 params: AnchoredCdcParams | None = None,
                 frag: FragmenterConfig | None = None, **engine) -> None:
        self.device = resolve_device(device)
        self.node_id = int(node_id)
        self.store = NodeStore(Path(data_root), self.node_id, fsync=True)
        if frag is not None and frag.devices > 1:
            self.fragmenter = ShardedAnchoredCudaFragmenter(
                params, frag, device=device, **engine)
        else:
            self.fragmenter = AnchoredCudaFragmenter(
                params, device=self.device, **engine)
        self._cas_pool = ThreadPoolExecutor(
            max_workers=self.CAS_IO_THREADS, thread_name_prefix="cas-w")

    def close(self) -> None:
        """Stop the CAS worker pool (waits for queued puts)."""
        self._cas_pool.shutdown(wait=True)

    def __enter__(self) -> "LocalNode":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def upload(self, data: bytes, name: str = "") -> tuple[Manifest, dict]:
        file_id = sha256_hex(data)
        name = name or f"file-{file_id[:8]}"
        manifest = self.fragmenter.manifest(data, name=name, file_id=file_id)
        place = _Placement(self, self.PLACE_LIMIT_BYTES)
        view = memoryview(data)
        for c in manifest.chunks:
            place.put(c.digest, view[c.offset:c.offset + c.length])
        stats = place.finish(len(data))
        self.store.manifests.save(manifest)           # the ack
        return manifest, stats

    def upload_stream(self, blocks, name: str = "") -> tuple[Manifest, dict]:
        """Bounded-memory ingest of an iterable of byte blocks: chunks are
        placed as the walk emits them; fileId = sha256 of the whole stream,
        computed incrementally."""
        hasher = sha256_new()
        total = 0
        place = _Placement(self, self.PLACE_LIMIT_BYTES)

        def tee():
            nonlocal total
            for b in blocks:
                hasher.update(b)
                total += len(b)
                yield b

        m = self.fragmenter.manifest_stream(tee(), name=name or "stream",
                                            store=place.put)
        stats = place.finish(total)
        file_id = hasher.hexdigest()
        manifest = Manifest(file_id=file_id,
                            name=name or f"file-{file_id[:8]}", size=total,
                            fragmenter=m.fragmenter, chunks=m.chunks)
        self.store.manifests.save(manifest)           # the ack
        return manifest, stats

    def download(self, file_id: str) -> bytes:
        """Reassemble a file, verifying every chunk and the whole file."""
        m = self.store.manifests.load(file_id)
        if m is None:
            raise FileNotFoundError(f"no manifest for {file_id}")
        out = np.empty((m.size,), dtype=np.uint8)
        for c in m.chunks:
            payload = self.store.chunks.get(c.digest)
            if payload is None or len(payload) != c.length \
                    or sha256_hex(payload) != c.digest:
                raise ChunkCorrupt(f"chunk {c.index} ({c.digest[:12]}…) of "
                                   f"{file_id[:12]}… is missing or corrupt")
            out[c.offset:c.offset + c.length] = np.frombuffer(payload,
                                                              np.uint8)
        body = out.tobytes()
        if sha256_hex(body) != m.file_id:
            raise ChunkCorrupt(f"{file_id[:12]}… reassembles to another "
                               "sha256")
        return body

    def list(self) -> list[Manifest]:
        return self.store.manifests.list()
