"""The chunk+hash sidecar: the port's chunking engine as a local gRPC
service, the counterpart of dfs_tpu's ``sidecar/service.py`` with the same
method names, payloads and JSON. A host process in any language streams
bytes in and gets chunk boundaries and SHA-256 digests back; a node
started with ``NodeConfig.sidecar_port`` delegates its chunking to it, so
device init and the walk run outside the node's serving loop.

The contract (``docs/sidecar_wire.md``) is gRPC over cleartext HTTP/2 with
identity (raw bytes) payloads, service ``dfs.Sidecar``:

- ``ChunkHashStream`` (stream → unary): raw byte blocks in, one JSON chunk
  table out; blocks feed the fragmenter's bounded-memory streaming walk.
- ``ChunkHash`` (unary): the whole payload in one message (1 GiB cap).
- ``ChunkHashDuplex`` (stream → stream): chunk batches flow back as the
  walk finalizes them, then ``{"done": true, ...}``; a teeing client
  trims its buffer against them.
- ``Health`` (unary): ``{"ok", "fragmenter", "window", "describe"}``;
  ``window`` is the walk's reporting-lag bound (0 for a materializing
  strategy), from which a teeing client sizes its buffer.

The port has no ``grpc`` package: both ends speak the protocol through
:mod:`dfs_tpu_torch.sidecar.h2`, and grpcio peers (dfs_tpu's client,
server and nodes) and dfs_tpu's C++ client interoperate with them.
"""

from __future__ import annotations

import json
import threading

from dfs_tpu_torch.fragmenter.base import Fragmenter
from dfs_tpu_torch.meta.manifest import ChunkRef, Manifest
from dfs_tpu_torch.ops.cdc_v2 import file_id_from_digests
from dfs_tpu_torch.sidecar import h2

_SERVICE = "dfs.Sidecar"
STREAM_BLOCK = 4 * 1024 * 1024

# a call that ended with a non-zero grpc-status: ``.code``, ``.details``
SidecarError = h2.GrpcError


def _chunk_dicts(chunks) -> list[dict]:
    return [{"index": c.index, "offset": c.offset, "length": c.length,
             "digest": c.digest} for c in chunks]


class SidecarServer:
    """The service on ``127.0.0.1:port`` (0: a free port, read ``.port``)
    around one fragmenter from ``get_fragmenter`` (``auto`` and
    ``cdc-anchored-cuda`` on ``device``: None is the CUDA card, raising
    without one; ``fixed`` and ``cdc`` on the host). Calls run on a pool
    of ``max_workers`` threads sharing that fragmenter."""

    def __init__(self, port: int = 0, fragmenter: str = "auto",
                 cdc_params=None, max_workers: int = 4, device=None,
                 fixed_parts: int = 5) -> None:
        from dfs_tpu_torch.fragmenter.base import get_fragmenter

        self.fragmenter = get_fragmenter(fragmenter, cdc_params=cdc_params,
                                         device=device,
                                         fixed_parts=fixed_parts)
        self._server = h2.GrpcServer(self._methods(), port=port,
                                     max_workers=max_workers)
        self.port = self._server.port

    def _chunk_table(self, chunks, size: int) -> bytes:
        return json.dumps({
            "fragmenter": self.fragmenter.name,
            # digest-derived, not sha256(payload): hashing the whole
            # payload again would double the service's hash work
            "fileId": file_id_from_digests([c.digest for c in chunks]),
            "size": size,
            "chunks": _chunk_dicts(chunks),
        }).encode()

    def _methods(self) -> dict:
        def chunk_hash(request: bytes) -> bytes:
            return self._chunk_table(self.fragmenter.chunk(request),
                                     len(request))

        def chunk_hash_stream(requests) -> bytes:
            m = self.fragmenter.manifest_stream(requests, name="stream")
            return self._chunk_table(list(m.chunks), m.size)

        def chunk_hash_duplex(requests):
            """Each batch goes out as the walk yields it (a batch held
            back for more input would stall a client at its tee cap);
            ``done`` comes last."""
            digests: list[str] = []
            size = 0
            batches = self.fragmenter.chunks_stream(requests)
            try:
                for batch in batches:
                    if not batch:
                        continue
                    size = batch[-1].offset + batch[-1].length
                    digests.extend(c.digest for c in batch)
                    yield json.dumps({"chunks": _chunk_dicts(batch)}).encode()
            finally:
                batches.close()
            yield json.dumps({
                "done": True, "size": size,
                "fileId": file_id_from_digests(digests),
                "fragmenter": self.fragmenter.name}).encode()

        def health(request: bytes) -> bytes:
            span = self.fragmenter.stream_span()
            try:
                desc = self.fragmenter.describe()
            except NotImplementedError:
                desc = None
            return json.dumps({"ok": True,
                               "fragmenter": self.fragmenter.name,
                               "window": span or 0,
                               "describe": desc}).encode()

        return {
            f"/{_SERVICE}/ChunkHash": (h2.UNARY_UNARY, chunk_hash),
            f"/{_SERVICE}/ChunkHashStream": (h2.STREAM_UNARY,
                                             chunk_hash_stream),
            f"/{_SERVICE}/ChunkHashDuplex": (h2.STREAM_STREAM,
                                             chunk_hash_duplex),
            f"/{_SERVICE}/Health": (h2.UNARY_UNARY, health),
        }

    def buffered(self) -> list[int]:
        """Bytes each open call holds on the server (flow-control bound)."""
        return self._server.buffered()

    @property
    def peak_buffered(self) -> int:
        return self._server.peak_buffered

    def start(self) -> None:
        self._server.start()

    def stop(self, grace: float = 0.5) -> None:
        self._server.stop(grace)


class SidecarClient:
    """Blocking client, one connection a call. Deadlines are mandatory:
    a fragmenter can wedge in device init, and an undeadlined call from a
    node would hold its upload forever."""

    def __init__(self, port: int, host: str = "127.0.0.1",
                 timeout_s: float = 600.0,
                 health_timeout_s: float = 30.0) -> None:
        self.port = port
        self.host = host
        self.timeout_s = timeout_s
        self.health_timeout_s = health_timeout_s

    def _unary(self, method: str, requests, timeout_s: float) -> dict:
        return json.loads(h2.unary(self.host, self.port,
                                   f"/{_SERVICE}/{method}", requests,
                                   timeout_s))

    def chunk_hash(self, data: bytes) -> dict:
        return self._unary("ChunkHash", [data], self.timeout_s)

    def chunk_hash_stream(self, blocks) -> dict:
        """Stream byte blocks (any iterable of bytes): no size ceiling."""
        return self._unary("ChunkHashStream", blocks, self.timeout_s)

    def chunk_hash_duplex(self, blocks):
        """Stream blocks in, iterate chunk-batch dicts out as the sidecar
        finalizes them; the last message is ``{'done': True, ...}``.
        Closing the generator early resets the call."""
        msgs = h2.call(self.host, self.port, f"/{_SERVICE}/ChunkHashDuplex",
                       blocks, self.timeout_s)
        try:
            for msg in msgs:
                yield json.loads(msg)
        finally:
            msgs.close()

    def health(self) -> dict:
        return self._unary("Health", [b""], self.health_timeout_s)

    def close(self) -> None:
        """Nothing to release: every call closes its own connection."""


class SidecarFragmenter(Fragmenter):
    """A Fragmenter that delegates chunk+hash to a sidecar process (a
    port's or dfs_tpu's). Its name is ``sidecar:<the sidecar's name>`` and
    ``describe`` passes the sidecar's description on, so ``/chunking``
    rebuilds its tables bit-exactly. ``chunk`` streams in ``STREAM_BLOCK``
    pieces through ``ChunkHashStream``; ``chunks_stream`` (the node's
    streaming upload) tees the blocks through ``ChunkHashDuplex`` with a
    buffer capped from the sidecar's ``window``."""

    def __init__(self, port: int, host: str = "127.0.0.1") -> None:
        self.client = SidecarClient(port, host=host)
        h = self.client.health()
        self.name = f"sidecar:{h['fragmenter']}"
        # reporting-lag bound of the sidecar's walk; 0 = materializing
        # backend (fixed split): then the tee cannot be safely capped
        self.stream_window = int(h.get("window") or 0)
        self._describe = h.get("describe")
        self.last_peak_buffer = 0

    def describe(self) -> dict:
        if not self._describe:
            raise NotImplementedError(f"{self.name} is not describable")
        return self._describe

    def stream_span(self) -> int | None:
        # as dfs_tpu's: this end reports no bound of its own
        return None

    def _refs(self, resp: dict) -> list[ChunkRef]:
        return [ChunkRef(index=c["index"], offset=c["offset"],
                         length=c["length"], digest=c["digest"])
                for c in resp["chunks"]]

    def chunk(self, data: bytes) -> list[ChunkRef]:
        view = memoryview(data)
        blocks = (view[i:i + STREAM_BLOCK]
                  for i in range(0, len(data), STREAM_BLOCK))
        return self._refs(self.client.chunk_hash_stream(blocks))

    def chunks_stream(self, blocks, store=None):
        """Streaming delegation over the duplex method: blocks are teed
        into a local rolling buffer while the call's sender forwards them;
        each chunk batch the sidecar streams back is sliced out of the tee
        (for ``store``) and the buffer is trimmed to the last reported
        chunk end. The buffer is capped at 2x the sidecar's ``window``
        (the sidecar always progresses with ``window`` bytes outstanding
        past its last report), so node memory stays about that size
        (``last_peak_buffer`` records the high-water mark), and the
        sidecar's flow control paces the sender off its walk."""
        cond = threading.Condition()
        buf = bytearray()
        base = 0                      # absolute offset of buf[0]
        dead = False
        self.last_peak_buffer = 0
        budget = 2 * self.stream_window if self.stream_window else None

        def tee():
            for b in blocks:
                bb = bytes(b)
                with cond:
                    while (budget is not None and not dead
                           and len(buf) + len(bb) > budget + 2 * len(bb)):
                        cond.wait(0.2)
                    if dead:
                        return
                    buf.extend(bb)
                    self.last_peak_buffer = max(self.last_peak_buffer,
                                                len(buf))
                yield bb

        replies = self.client.chunk_hash_duplex(tee())
        try:
            for msg in replies:
                if msg.get("done"):
                    return
                refs = []
                for c in msg["chunks"]:
                    ref = ChunkRef(index=c["index"], offset=c["offset"],
                                   length=c["length"], digest=c["digest"])
                    if store is not None:
                        with cond:
                            lo = ref.offset - base
                            payload = bytes(buf[lo:lo + ref.length])
                        if len(payload) != ref.length:
                            raise RuntimeError(
                                "sidecar chunk reply outran the teed stream")
                        store(ref.digest, payload)
                    refs.append(ref)
                with cond:
                    end = refs[-1].offset + refs[-1].length
                    if end > base:
                        del buf[:end - base]
                        base = end
                    cond.notify_all()
                yield refs
        finally:
            with cond:
                dead = True           # unblock a tee stuck at the cap
                cond.notify_all()
            replies.close()

    def manifest_stream(self, blocks, name: str, store=None) -> Manifest:
        if store is None:
            # metadata-only callers skip the tee copy entirely
            resp = self.client.chunk_hash_stream(blocks)
            return Manifest(file_id=resp["fileId"], name=name,
                            size=resp["size"], fragmenter=self.name,
                            chunks=tuple(self._refs(resp)))
        return super().manifest_stream(blocks, name, store=store)

    def close(self) -> None:
        self.client.close()
