"""External HTTP/1.1 API over asyncio streams — dfs_tpu's ``api/http.py``
for the routes of the default configuration:

    GET    /status               200 "OK"
    GET    /files                JSON file list
    GET    /metrics              JSON counters and sections (``sim``,
                                 ``tier``, ``chaos``: ``{"enabled":
                                 false}`` without the plane; ``index``:
                                 the IndexConfig echo with ``"enabled":
                                 false``; ``obs``: trace ring, journal,
                                 sentinel, RPC tables; ``ring``: the
                                 RingConfig echo, epoch and rebalance;
                                 ``census``: the CensusConfig echo,
                                 history and last census)
    GET    /metrics/history      the sampled series' names, or with
                                 ``?name=`` one series at both
                                 resolutions (404 unknown); ``{"enabled":
                                 false}`` with the sampler off
    GET    /census               replication census and capacity (df)
                                 over every node, partial on dead peers
                                 (``&cluster=0``: this node's only)
    GET    /doctor               the rule table over every node's
                                 snapshot (``&cluster=0``: this node)
    GET    /ring                 membership view and every peer's epoch
    POST   /ring                 {"action": "add"|"drain"|"remove"|
                                 "reweight", "nodeId": N[, "weight": W]}:
                                 the next epoch, pushed to every peer; 400
                                 with the reason on a bad change
    GET    /metrics?format=prom  the same registries as OpenMetrics text
                                 (histogram buckets with trace exemplars)
    GET    /trace?traceId=       the trace's spans from every node, merged
                                 (``&cluster=0``: this node's only); 400
                                 on a malformed id
    GET    /events?since=&limit= recent journal events, oldest first
                                 (``{"enabled": false}`` without one)
    GET    /chaos                the injector's knobs and counters
    POST   /chaos                swap mutable knobs (JSON object); both
                                 404 "Chaos disabled (boot with --chaos)"
                                 without the injector
    GET    /manifest?fileId=     the manifest JSON
    POST   /upload?name=         201 JSON {fileId, ...}; Content-Length or
                                 chunked; 411 without either, 413 too big;
                                 ``&ec=K`` erasure-codes a whole body with
                                 k = K (400 on a chunked body)
    GET    /download?fileId=     the bytes + Content-Disposition; a single
                                 Range gives 206 (416 past the end)
    DELETE /files?fileId=        200 / 404
    POST   /repair               {"repaired": N, "underReplicated": M}
    POST   /scrub                {"scanned": N, "corrupt": M,
                                  "deltaMissingBase": K} (+ healedMissing,
                                 healedPhantom with the index plane)
    GET    /tier                 the ``/metrics`` ``tier`` section
    POST   /tier                 one demotion scan now: {scanned, cold,
                                 demoted, finished, skipped}; 503 +
                                 Retry-After while a scan runs; both 404
                                 "Tiering disabled" without the plane

The serving tier (``ServeConfig``, off by default) answers ``503`` with
``Retry-After`` when an admission gate sheds an upload or a download, and
when a request's end-to-end deadline dies before its head: an
``X-Dfs-Deadline: <seconds>`` header on any route, or
``default_deadline_s`` on the client routes (/download, /upload,
/manifest, /files). A deadline that dies mid-stream truncates the body. A
download's slot is held until its body drains; a client that hangs up
while queued frees its place.

Every request is an ``http.<route>`` span (``http.other`` off the route
list), rooted fresh or adopted from an ``X-Dfs-Trace: <trace32hex>-
<span16hex>`` header (a malformed one is ignored, never an error), with
its latency recorded under the span name, the trace id as the bucket's
exemplar.

The resumable upload and the smart client's routes, with dfs_tpu's
frames and answers:

    GET    /chunking             {"fragmenter", "describe"}: the chunking
                                 parameters a client reproduces the
                                 boundaries with (404 "Fragmenter not
                                 resume-describable" without them)
    GET    /dataplane            ring map, peers' addresses, rf, write
                                 quorum, chunking and filter state
    POST   /missing              a JSON list of digests -> {"missing":
                                 [...]}, those held nowhere reachable
    POST   /upload_resume?name=  [u32 json length][json {fileId, size,
                                 chunks, provided}][the provided payloads
                                 in listed order] -> 201
    POST   /commit?name=         [u32 json length][json {fileId, size,
                                 chunks}]: the chunks are already at their
                                 owners -> 201, or 409 when some are held
                                 nowhere

Both bodies take the upload admission gate before they are read; 411
without a Content-Length, 413 too big, 400 on a bad frame or fileId, 409
on chunks the cluster lacks. Every other route answers 404. Query
strings are URL-decoded; a malformed fileId is a 400.
"""

from __future__ import annotations

import asyncio
import json
import math
import time
from typing import TYPE_CHECKING
from urllib.parse import parse_qs, unquote, urlsplit

from dfs_tpu_torch.utils import deadline
from dfs_tpu_torch.utils.hashing import is_hex_digest

if TYPE_CHECKING:
    from dfs_tpu_torch.node.runtime import StorageNodeServer

_REASONS = {200: "OK", 201: "Created", 206: "Partial Content",
            400: "Bad Request", 404: "Not Found", 411: "Length Required",
            413: "Payload Too Large", 416: "Range Not Satisfiable",
            500: "Internal Server Error", 503: "Service Unavailable",
            507: "Insufficient Storage"}
MAX_BODY = 4 * 1024 * 1024 * 1024
# plain (Content-Length) uploads above this stream through the
# bounded-memory ingest instead of materializing the body in node RAM
STREAM_BODY_BYTES = 64 * 1024 * 1024
# the routes ServeConfig.default_deadline_s applies to (the client data
# plane); an explicit X-Dfs-Deadline header is honoured on any route
_DEADLINE_DEFAULT_ROUTES = frozenset({"/download", "/upload",
                                      "/upload_resume", "/missing",
                                      "/chunking", "/manifest", "/files",
                                      "/commit"})
# routes whose fixed path may name a span; any other path is "http.other",
# so a client's path never mints span or histogram names
_TRACED_ROUTES = frozenset({"/status", "/files", "/metrics", "/manifest",
                            "/upload", "/download", "/scrub", "/repair",
                            "/trace", "/events", "/chaos", "/tier",
                            "/doctor", "/census", "/metrics/history",
                            "/ring", "/chunking", "/missing",
                            "/upload_resume", "/dataplane", "/commit"})


def _head(status: int, length: int, content_type: str,
          extra: dict[str, str] | None = None) -> bytes:
    head = [f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}",
            f"Content-Type: {content_type}",
            f"Content-Length: {length}",
            "Connection: close"]
    for k, v in (extra or {}).items():
        head.append(f"{k}: {v}")
    return ("\r\n".join(head) + "\r\n\r\n").encode()


def _resp(status: int, body: bytes, content_type: str,
          extra: dict[str, str] | None = None) -> bytes:
    return _head(status, len(body), content_type, extra) + body


def plain(status: int, text: str) -> bytes:
    return _resp(status, text.encode(), "text/plain; charset=utf-8")


def as_json(status: int, obj) -> bytes:
    return _resp(status, json.dumps(obj).encode(), "application/json")


def resp_parts(status: int, parts: list, content_type: str,
               extra: dict[str, str] | None = None) -> list:
    """``[head, *payload buffers]``, written one by one, never joined."""
    length = sum(len(p) for p in parts)
    return [_head(status, length, content_type, extra), *parts]


def binary_head(status: int, length: int, filename: str) -> bytes:
    """Download head; control characters and quotes are stripped from the
    user-supplied name before it goes into a header."""
    safe = "".join(c for c in filename if c >= " " and c != '"') or "download"
    return _head(status, length, "application/octet-stream",
                 {"Content-Disposition": f'attachment; filename="{safe}"'})


def _retry_after(node: "StorageNodeServer", e, retry_after_s: float
                 ) -> bytes:
    node.counters.inc("http_shed")
    return _resp(503, str(e).encode(), "text/plain; charset=utf-8",
                 {"Retry-After": str(max(1, math.ceil(retry_after_s)))})


def _shed(node: "StorageNodeServer", e) -> bytes:
    """503 + Retry-After: an admission gate refused the request."""
    return _retry_after(node, e, e.retry_after_s)


def _deadline_503(node: "StorageNodeServer", e) -> bytes:
    """503 + Retry-After for a deadline that died after admission: the
    answer the gate gives an expired arrival, never a 500."""
    return _retry_after(node, e, node.cfg.serve.retry_after_s)


class _GatedBody:
    """A streamed body holding a download slot for its whole life. A
    class, not a wrapping generator: closing a never-started generator
    skips its ``finally``, which would leak the slot."""

    def __init__(self, gate, gen) -> None:
        self._gate = gate
        self._gen = gen
        self._released = False

    def __aiter__(self) -> "_GatedBody":
        return self

    async def __anext__(self):
        try:
            return await self._gen.__anext__()
        except BaseException:       # StopAsyncIteration included
            await self.aclose()
            raise

    async def aclose(self) -> None:
        if self._released:
            return
        self._released = True
        try:
            await self._gen.aclose()
        finally:
            self._gate.release()


def _parse_range(value: str) -> tuple[int | None, int | None] | None:
    """A single ``bytes=`` range as (first, last), either side open;
    multi-range or malformed -> None (answered 400)."""
    if not value.startswith("bytes=") or "," in value:
        return None
    first, sep, last = value[len("bytes="):].strip().partition("-")
    if sep != "-" or (not first and not last):
        return None
    if (first and not first.isdigit()) or (last and not last.isdigit()):
        return None
    return (int(first) if first else None, int(last) if last else None)


async def _chunked_body(reader: asyncio.StreamReader, limit: int = MAX_BODY):
    """Async generator over an HTTP/1.1 chunked body; ValueError on bad
    framing or past ``limit`` bytes."""
    total = 0
    while True:
        line = (await reader.readline()).decode("latin-1").strip()
        if not line:
            raise ValueError("missing chunk size")
        try:
            size = int(line.split(";", 1)[0], 16)   # extensions ignored
        except ValueError as e:
            raise ValueError(f"bad chunk size {line!r}") from e
        if size == 0:
            while True:                  # the trailer, to its blank line
                t = await reader.readline()
                if t in (b"\r\n", b"\n", b""):
                    return
        total += size
        if total > limit:
            raise ValueError("chunked body exceeds size cap")
        data = await reader.readexactly(size)
        if await reader.readexactly(2) != b"\r\n":
            raise ValueError("missing chunk terminator")
        yield data


def make_http_handler(node: "StorageNodeServer"):
    async def handler(reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        t0 = time.perf_counter()
        body_gen = None
        try:
            out = await _serve_one(node, reader)
            if isinstance(out, tuple):          # streamed body
                out, body_gen = out
        except Exception as e:  # noqa: BLE001
            node.log.warning("http error: %s", e)
            out = plain(500, f"Internal error: {e}")
        node.latency.record("http.request", time.perf_counter() - t0)
        try:
            for part in (out if isinstance(out, list) else [out]):
                writer.write(part)
            await writer.drain()
            if body_gen is not None:
                try:
                    async for part in body_gen:
                        writer.write(part)
                        await writer.drain()
                except Exception as e:  # noqa: BLE001
                    # the head is out: truncation is the only honest signal
                    node.log.warning("download stream aborted: %s", e)
        except (ConnectionError, OSError):
            pass
        finally:
            if body_gen is not None:
                try:
                    await body_gen.aclose()
                except Exception:  # noqa: BLE001 - teardown best-effort
                    pass
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    return handler


async def _serve_one(node: "StorageNodeServer",
                     reader: asyncio.StreamReader):
    from dfs_tpu_torch.obs import parse_http_trace

    request_line = (await reader.readline()).decode("latin-1").strip()
    if not request_line:
        return plain(400, "Empty request")
    parts = request_line.split(" ")
    if len(parts) != 3:
        return plain(400, "Malformed request line")
    method, target, _version = parts
    split = urlsplit(target)
    path = unquote(split.path)
    query = {k: v[0] for k, v in parse_qs(split.query).items()}
    content_length: int | None = None
    range_header: str | None = None
    deadline_header: str | None = None
    trace_header: str | None = None
    chunked = False
    while True:
        line = (await reader.readline()).decode("latin-1")
        if line in ("\r\n", "\n", ""):
            break
        if ":" in line:
            k, v = line.split(":", 1)
            key = k.strip().lower()
            if key == "content-length":
                try:
                    content_length = int(v.strip())
                except ValueError:
                    return plain(400, "Bad Content-Length")
                if content_length < 0:
                    return plain(400, "Bad Content-Length")
            elif key == "range":
                range_header = v.strip()
            elif key == "x-dfs-deadline":
                deadline_header = v.strip()   # malformed = no deadline
            elif key == "x-dfs-trace":
                trace_header = v.strip()      # malformed = a fresh root
            elif key == "transfer-encoding":
                chunked = "chunked" in v.strip().lower()
    node.counters.inc("http_requests")
    # the deadline is born here and rides the context to every hop
    budget = deadline.parse_header(deadline_header)
    if budget is None and path in _DEADLINE_DEFAULT_ROUTES \
            and node.cfg.serve.default_deadline_s > 0:
        budget = node.cfg.serve.default_deadline_s
    dl_token = deadline.activate(budget) if budget is not None else None
    # the request span: every downstream hop parents to it through the
    # context; a streamed download's body outlives it (the span covers the
    # work up to the head and the first batch)
    name = f"http.{path}" if path in _TRACED_ROUTES else "http.other"
    streamed = False
    try:
        with node.obs.request_span(name, parse_http_trace(trace_header),
                                   latency=True) as sp:
            out = await _route(node, reader, method, path, query,
                               content_length, range_header, chunked)
            # a streamed body is iterated by the handler in this task
            # after we return, and its per-batch checks must keep seeing
            # the countdown: the context is left armed (it dies with the
            # task)
            streamed = isinstance(out, tuple)
            if isinstance(out, (bytes, bytearray)):
                sp.bytes = len(out)
            elif isinstance(out, list):
                sp.bytes = sum(len(p) for p in out)
            return out
    finally:
        if dl_token is not None and not streamed:
            deadline.restore(dl_token)


def _file_id(query: dict) -> tuple[str | None, bytes | None]:
    """(fileId, None) or (None, the 400 to answer)."""
    file_id = query.get("fileId")
    if not file_id:
        return None, plain(400, "Missing fileId")
    if not is_hex_digest(file_id):
        return None, plain(400, "Bad fileId")
    return file_id, None


async def _route(node: "StorageNodeServer", reader: asyncio.StreamReader,
                 method: str, path: str, query: dict,
                 content_length: int | None, range_header: str | None,
                 chunked: bool):
    from dfs_tpu_torch.node.runtime import (DeadlineExceeded, DownloadError,
                                            NotFoundError,
                                            RangeNotSatisfiable)
    from dfs_tpu_torch.serve import ClientDisconnected, ShedError

    if method == "GET" and path == "/status":
        return plain(200, "OK")
    if method == "GET" and path == "/files":
        return as_json(200, node.list_files())
    if method == "GET" and path == "/metrics":
        if query.get("format") == "prom":
            from dfs_tpu_torch.obs.prom import render_node_metrics

            # OpenMetrics, not text/plain 0.0.4: the bucket lines carry
            # exemplars, which only the OpenMetrics parser accepts
            return _resp(200, render_node_metrics(node).encode(),
                         "application/openmetrics-text; version=1.0.0; "
                         "charset=utf-8")
        return as_json(200, node.metrics())
    if method == "GET" and path == "/metrics/history":
        # no name: the series directory; sampler off: enabled false,
        # never an error
        history = node.history
        if history is None:
            return as_json(200, {"enabled": False, "series": []})
        name = query.get("name")
        if not name:
            return as_json(200, {"enabled": True,
                                 "series": history.names()})
        snap = history.snapshot(name)
        if snap is None:
            return plain(404, "Unknown series")
        snap["enabled"] = True
        return as_json(200, snap)
    if method == "GET" and path == "/census":
        return as_json(200, await node.census_report(
            cluster=query.get("cluster", "1") != "0"))
    if method == "GET" and path == "/doctor":
        return as_json(200, await node.doctor_report(
            cluster=query.get("cluster", "1") != "0"))
    if path == "/ring" and method in ("GET", "POST"):
        if method == "GET":
            return as_json(200, await node.ring_status(
                cluster=query.get("cluster", "1") != "0"))
        if content_length is None:
            return plain(411, "Length Required")
        if content_length > 64 * 1024:
            return plain(413, "Payload Too Large")
        try:
            body = json.loads(await reader.readexactly(content_length))
            if not isinstance(body, dict):
                raise ValueError("want a JSON object")
            action = str(body.get("action", ""))
            node_id = body.get("nodeId")
            weight = body.get("weight")
            return as_json(200, await node.ring_admin(
                action,
                node_id=int(node_id) if node_id is not None else None,
                weight=float(weight) if weight is not None else None))
        except (ValueError, TypeError, UnicodeDecodeError) as e:
            return plain(400, f"Bad ring change: {e}")
    if method == "GET" and path == "/trace":
        from dfs_tpu_torch.obs import TRACE_HEX, is_id

        tid = query.get("traceId")
        if not tid or not is_id(tid, TRACE_HEX):
            return plain(400, "Bad traceId")
        return as_json(200, await node.trace_spans(
            tid, cluster=query.get("cluster", "1") != "0"))
    if method == "GET" and path == "/events":
        journal = node.obs.journal
        if journal is None:
            return as_json(200, {"enabled": False, "events": []})
        try:
            since = float(query.get("since", 0.0))
            limit = int(query.get("limit", 256))
        except ValueError:
            return plain(400, "Bad since/limit")
        if limit < 1 or limit > 4096:
            return plain(400, "limit out of range (1..4096)")
        # segment reads are file I/O: off the loop
        out = await asyncio.to_thread(journal.tail, since, limit)
        out["enabled"] = True
        return as_json(200, out)
    if path == "/chaos" and method in ("GET", "POST"):
        # the master switch is boot-only: a node not booted with --chaos
        # cannot be made fault-injectable over HTTP
        if node.chaos is None:
            return plain(404, "Chaos disabled (boot with --chaos)")
        if method == "GET":
            return as_json(200, node.chaos.stats())
        if content_length is None:
            return plain(411, "Length Required")
        if content_length > 64 * 1024:
            return plain(413, "Payload Too Large")
        try:
            knobs = json.loads(await reader.readexactly(content_length))
            if not isinstance(knobs, dict):
                raise ValueError("want a JSON object of chaos knobs")
            return as_json(200, node.chaos.set(**knobs))
        # AttributeError: a wrong-typed knob value failing inside the
        # ChaosConfig validation is a bad request too
        except (ValueError, TypeError, AttributeError,
                UnicodeDecodeError) as e:
            return plain(400, f"Bad chaos knobs: {e}")
    if method == "GET" and path == "/manifest":
        file_id, bad = _file_id(query)
        if bad is not None:
            return bad
        m = node.store.manifests.load(file_id)
        if m is None:
            return plain(404, "File not found")
        return _resp(200, m.to_json().encode(), "application/json")
    if method == "GET" and path == "/chunking":
        try:
            desc = node.fragmenter.describe()
        except NotImplementedError:
            return plain(404, "Fragmenter not resume-describable")
        return as_json(200, {"fragmenter": node.fragmenter.name,
                             "describe": desc})
    if method == "GET" and path == "/dataplane":
        return as_json(200, node.dataplane_info())
    if method == "POST" and path in ("/commit", "/upload_resume"):
        return await _handle_framed(node, reader, path, query,
                                    content_length)
    if method == "POST" and path == "/missing":
        if content_length is None:
            return plain(411, "Length Required")
        if content_length > 64 * 1024 * 1024:
            return plain(413, "Payload Too Large")
        try:
            digests = json.loads(await reader.readexactly(content_length))
            if (not isinstance(digests, list)
                    or not all(isinstance(d, str) for d in digests)):
                raise ValueError("want a JSON list of digest strings")
        except (ValueError, UnicodeDecodeError) as e:
            return plain(400, f"Bad digest list: {e}")
        return as_json(200,
                       {"missing": await node.missing_digests(digests)})
    if method == "POST" and path == "/upload":
        ec_k = 0
        if query.get("ec"):
            # isdecimal: isdigit passes digits int() rejects
            if not query["ec"].isdecimal() or int(query["ec"]) < 1:
                return plain(400, "Bad ec parameter")
            ec_k = int(query["ec"])
            if chunked:
                return plain(400, "ec requires a whole-body upload "
                                  "(parity stripes span chunk groups)")
        if not chunked:
            if content_length is None:
                return plain(411, "Length Required")
            if content_length > MAX_BODY:
                return plain(413, "Payload Too Large")
        gate = node.serve.admission.upload
        try:
            await gate.acquire()     # shed before consuming the body
        except ShedError as e:
            return _shed(node, e)
        try:
            return await _handle_upload(node, reader, query, chunked,
                                        content_length, ec_k)
        finally:
            gate.release()
    if method == "GET" and path == "/download":
        file_id, bad = _file_id(query)
        if bad is not None:
            return bad
        rng = None
        if range_header is not None:
            rng = _parse_range(range_header)
            if rng is None:
                return plain(400, "Bad Range")
            if rng[0] is not None and rng[1] is not None and rng[0] > rng[1]:
                rng = None     # invalid range: ignored (RFC 9110 14.1.1)
        gate = node.serve.admission.download
        try:
            # a GET has no body: the watcher's read returns b"" only when
            # the client hangs up while queued
            await gate.acquire(disconnected=lambda: reader.read(1))
        except ShedError as e:
            return _shed(node, e)
        except ClientDisconnected:
            node.counters.inc("http_client_gone")
            return b""
        streaming = None
        try:
            if rng is not None:
                try:
                    manifest, parts, start, end = await node.download_range(
                        file_id, *rng)
                except RangeNotSatisfiable as e:
                    return _resp(416, b"", "text/plain",
                                 {"Content-Range": f"bytes */{e.size}"})
                return resp_parts(
                    206, parts, "application/octet-stream",
                    {"Content-Range":
                     f"bytes {start}-{end - 1}/{manifest.size}",
                     "Accept-Ranges": "bytes"})
            # streamed: chunks go out as they verify; the first batch is
            # fetched before the head, so common failures still answer
            manifest, body_gen = await node.download_stream(file_id)
            # the slot is held until the body drains or is closed
            streaming = _GatedBody(gate, body_gen)
            return binary_head(200, manifest.size, manifest.name), streaming
        except NotFoundError:
            return plain(404, "File not found")
        except DeadlineExceeded as e:
            return _deadline_503(node, e)
        except DownloadError as e:
            return plain(500, str(e))
        finally:
            if streaming is None:
                gate.release()
    if method == "POST" and path == "/scrub":
        return as_json(200, await node.scrub_once())
    if path == "/tier" and method in ("GET", "POST"):
        # tiering is a boot decision: 404 without the plane
        if node.tier is None:
            return plain(404, "Tiering disabled (boot with --tier)")
        if method == "GET":
            return as_json(200, node.tier_stats())
        try:
            return as_json(200, await node.tier_scan_once())
        except ShedError as e:
            return _shed(node, e)
    if method == "POST" and path == "/repair":
        repaired = await node.repair_once()
        return as_json(200, {"repaired": repaired,
                             "underReplicated": len(node.under_replicated)})
    if method == "DELETE" and path == "/files":
        file_id, bad = _file_id(query)
        if bad is not None:
            return bad
        found = await node.delete(file_id)
        return plain(200 if found else 404,
                     "Deleted" if found else "File not found")
    return plain(404, "Not found")


def _parse_frame(raw: bytes, with_payloads: bool):
    """``[u32 json length][json]`` and, for a resume, the provided
    payloads after it in listed order: (table, fileId, size, provided).
    Raises KeyError/ValueError/TypeError on a bad frame."""
    jlen = int.from_bytes(raw[:4], "big")
    meta = json.loads(raw[4:4 + jlen])
    off = 4 + jlen
    if not with_payloads and off != len(raw):
        raise ValueError("trailing bytes after table")
    table = [(int(o), int(ln), str(dg)) for o, ln, dg in meta["chunks"]]
    provided: dict[str, bytes] = {}
    if with_payloads:
        lengths = {dg: ln for _, ln, dg in table}
        for dg in meta["provided"]:
            ln = lengths[dg]
            provided[dg] = raw[off:off + ln]
            off += ln
        if off != len(raw):
            raise ValueError("payload section length mismatch")
    return table, str(meta["fileId"]), int(meta["size"]), provided


async def _handle_framed(node: "StorageNodeServer",
                         reader: asyncio.StreamReader, path: str,
                         query: dict, content_length: int | None) -> bytes:
    """``POST /commit`` (the table alone: the smart client striped the
    payloads to their owners) and ``POST /upload_resume`` (the table and
    the payloads the cluster lacked). The upload gate is taken before the
    body is read."""
    from dfs_tpu_torch.comm.rpc import DeadlineExpired
    from dfs_tpu_torch.node.runtime import DeadlineExceeded, UploadError
    from dfs_tpu_torch.serve import ShedError

    resume = path == "/upload_resume"
    if content_length is None:
        return plain(411, "Length Required")
    if content_length > (MAX_BODY if resume else 64 * 1024 * 1024):
        return plain(413, "Payload Too Large")
    gate = node.serve.admission.upload
    try:
        await gate.acquire()
    except ShedError as e:
        return _shed(node, e)
    try:
        raw = await reader.readexactly(content_length)
        try:
            table, file_id, size, provided = _parse_frame(raw, resume)
        except (KeyError, ValueError, TypeError) as e:
            what = "resume" if resume else "commit"
            return plain(400, f"Bad {what} frame: {e}")
        if not is_hex_digest(file_id):
            return plain(400, "Bad fileId")
        name = query.get("name", "")
        try:
            if resume:
                manifest, stats = await node.upload_resume(
                    table, name, file_id, size, provided)
            else:
                manifest, stats = await node.commit_manifest(
                    table, name, file_id, size)
        except (DeadlineExpired, DeadlineExceeded) as e:
            return _deadline_503(node, e)
        except UploadError as e:
            # 409: chunks the cluster lacks (the client falls back to a
            # full upload); 400: a bad table; 500: placement failed
            return plain(e.status, str(e))
        return as_json(201, {"fileId": manifest.file_id,
                             "name": manifest.name, "size": manifest.size,
                             "chunks": manifest.total_chunks, **stats})
    finally:
        gate.release()


async def _handle_upload(node: "StorageNodeServer",
                         reader: asyncio.StreamReader, query: dict,
                         chunked: bool, content_length: int | None,
                         ec_k: int) -> bytes:
    """POST /upload: chunked bodies and plain bodies above
    STREAM_BODY_BYTES feed the streaming ingest as they arrive (read off
    the socket in ~1 MiB pieces); smaller plain bodies, and every EC body
    (its stripes group chunks across the whole file), are read whole."""
    from dfs_tpu_torch.comm.rpc import DeadlineExpired
    from dfs_tpu_torch.node.runtime import DeadlineExceeded, UploadError

    name = query.get("name", "")
    if chunked or (content_length > STREAM_BODY_BYTES and not ec_k):
        async def _plain_body():
            left = content_length
            while left:
                b = await reader.read(min(1 << 20, left))
                if not b:
                    raise asyncio.IncompleteReadError(b"", left)
                left -= len(b)
                yield b

        body = _chunked_body(reader) if chunked else _plain_body()
        try:
            manifest, stats = await node.upload_stream(body, name)
        except (DeadlineExpired, DeadlineExceeded) as e:
            # the budget died mid-placement: placed chunks age out
            return _deadline_503(node, e)
        except UploadError as e:
            return plain(e.status, str(e))
        except ValueError as e:
            return plain(400, f"Bad request body: {e}")
    else:
        data = await reader.readexactly(content_length)
        try:
            manifest, stats = await node.upload(data, name, ec_k=ec_k)
        except (DeadlineExpired, DeadlineExceeded) as e:
            return _deadline_503(node, e)
        except UploadError as e:
            return plain(e.status, str(e))
    return as_json(201, {"fileId": manifest.file_id, "name": manifest.name,
                         "size": manifest.size,
                         "chunks": manifest.total_chunks, **stats})
