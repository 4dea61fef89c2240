"""Request-scoped distributed tracing and the node's metric tables (a
port of dfs_tpu's ``obs``).

- **Trace context**: a ``(trace_id, span_id)`` pair in a
  :mod:`contextvars` variable, so every async hop of a request (placement
  tasks, the CAS pool await, single-flight waits, admission queue waits)
  inherits it. It crosses processes as the ``X-Dfs-Trace:
  <trace32hex>-<span16hex>`` HTTP header and as the optional ``trace``
  field ``{"t","s","f"}`` of the storage-plane wire header, byte for byte
  dfs_tpu's, so one trace runs through port and dfs_tpu nodes alike.
- **Span collection**: :class:`Observability` records finished spans
  (name, ids, wall start, duration, peer, bytes, error) into a bounded
  ring (``ObsConfig.trace_ring``; 0 turns tracing off), pins the spans of
  slow or errored traces in a tail store (``tail_keep``), journals
  lifecycle events (:mod:`dfs_tpu_torch.obs.journal`) stamped with the
  active trace id, and serves ``GET /trace`` and the ``get_trace`` op;
  :mod:`dfs_tpu_torch.obs.stitch` merges the nodes' spans into one tree.
- **RPC tables**: :class:`RpcStats`, per (peer, op) calls, latency, bytes,
  errors and retries, one table for the client side (the hedge delay reads
  it) and one for the server side.

With ``trace_ring=0`` every tracing call is one ``is None`` branch; an
untraced call path with tracing on pays one ContextVar read.
"""
from __future__ import annotations

import contextlib
import contextvars
import os
import threading
import time
from collections import deque

from dfs_tpu_torch.utils import trace as _trace_mod
from dfs_tpu_torch.utils.logging import capped_key
from dfs_tpu_torch.utils.trace import LatencyRecorder

# the current (trace_id, span_id) of this task/thread, or None when the
# request was never traced. ContextVar semantics give the propagation
# for free: asyncio.create_task / asyncio.to_thread copy the context, so
# placement windows and worker-thread hops inherit the ids.
_ctx: contextvars.ContextVar[tuple[str, str] | None] = \
    contextvars.ContextVar("dfs_trace_ctx", default=None)

TRACE_HEX = 32   # 16 random bytes
SPAN_HEX = 16    # 8 random bytes


def new_trace_id() -> str:
    return os.urandom(TRACE_HEX // 2).hex()


def new_span_id() -> str:
    return os.urandom(SPAN_HEX // 2).hex()


def current() -> tuple[str, str] | None:
    """(trace_id, span_id) active in this context, or None."""
    return _ctx.get()


_HEX = frozenset("0123456789abcdef")


def is_id(s, n: int) -> bool:
    """Exactly ``n`` lowercase hex chars — the canonical id form
    (os.urandom().hex()). Strict charset on purpose: int(s, 16) also
    accepts '0x'/sign/underscore forms that would let malformed ids
    slip into rings and wire fields."""
    return isinstance(s, str) and len(s) == n and set(s) <= _HEX


def parse_http_trace(value: str | None) -> tuple[str, str] | None:
    """``X-Dfs-Trace`` header value ``<trace>-<span>`` -> (trace_id,
    parent_span_id), or None for absent/malformed (never raises — a bad
    header must not fail the request it rides on)."""
    if not value:
        return None
    t, sep, s = value.strip().partition("-")
    if sep and is_id(t, TRACE_HEX) and is_id(s, SPAN_HEX):
        return t, s
    return None


def parse_wire_trace(field) -> tuple[str, str, int | None] | None:
    """Wire-header ``trace`` field ``{"t","s"[,"f"]}`` -> (trace_id,
    parent_span_id, sender node id or None). None for absent/malformed
    — an untraced sender simply omits the field."""
    if not isinstance(field, dict):
        return None
    t, s = field.get("t"), field.get("s")
    if not (is_id(t, TRACE_HEX) and is_id(s, SPAN_HEX)):
        return None
    f = field.get("f")
    return t, s, (f if isinstance(f, int) and not isinstance(f, bool)
                  else None)


class Span:
    """Mutable annotations a caller may set while its span is open."""

    __slots__ = ("bytes", "err")

    def __init__(self) -> None:
        self.bytes = 0
        self.err: str | None = None


# shared by every no-op path; its annotations are written and discarded
_NULL_SPAN = Span()


class RpcStats:
    """Per-(peer, op) RPC counters: calls, errors, retries, bytes out/in,
    total seconds, and a 60 s window of samples. Key cardinality is
    capped: past ``_MAX_KEYS`` new keys fold into
    ``("_overflow", "_overflow")``."""

    _MAX_KEYS = 256
    # recency window of recent_best_mean; at extreme call rates it covers
    # the last _RECENT_MAX calls
    RECENT_WINDOW_S = 60.0
    _RECENT_MAX = 512

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # (peer, op) -> [count, errors, retries, bytes_out, bytes_in, s]
        self._m: dict[tuple, list] = {}
        # (peer, op) -> [deque[(monotonic ts, seconds, error)], rolling
        # sum, rolling count, ok-only sum, ok-only count]: the ok-only
        # pair feeds the hedge delay (a fast error reply is not what a
        # healthy fetch takes)
        self._recent: dict[tuple, list] = {}
        self._overflow_warned = False

    def _row(self, peer, op) -> tuple[tuple, list]:
        key = capped_key(self._m, (peer, op), self._MAX_KEYS, self,
                         "RpcStats", ("_overflow", "_overflow"))
        row = self._m.get(key)
        if row is None:
            row = self._m[key] = [0, 0, 0, 0, 0, 0.0]
        return key, row

    def record(self, peer, op: str, seconds: float, bytes_out: int = 0,
               bytes_in: int = 0, error: bool = False) -> None:
        now = time.monotonic()
        with self._lock:
            key, row = self._row(peer, op)
            row[0] += 1
            if error:
                row[1] += 1
            row[3] += bytes_out
            row[4] += bytes_in
            row[5] += seconds
            ent = self._recent.get(key)
            if ent is None:
                ent = self._recent[key] = [deque(), 0.0, 0, 0.0, 0]
            ent[0].append((now, seconds, error))
            ent[1] += seconds
            ent[2] += 1
            if not error:
                ent[3] += seconds
                ent[4] += 1
            self._expire(ent, now)

    def _expire(self, ent: list, now: float) -> None:
        """Drop expired (and over-bound) samples, keeping the rolling sums
        exact. The caller holds the lock."""
        dq = ent[0]
        cutoff = now - self.RECENT_WINDOW_S
        while dq and (dq[0][0] < cutoff or len(dq) > self._RECENT_MAX):
            _, s, err = dq.popleft()
            ent[1] -= s
            ent[2] -= 1
            if not err:
                ent[3] -= s
                ent[4] -= 1
        if ent[2] == 0:
            ent[1] = 0.0   # re-zero float drift at every empty window
        if ent[4] == 0:
            ent[3] = 0.0

    def retry(self, peer, op: str) -> None:
        with self._lock:
            _, row = self._row(peer, op)
            row[2] += 1

    def recent_best_mean(self, op: str) -> float | None:
        """The LOWEST per-peer windowed mean of successful calls of
        ``op``: what a healthy replica currently takes (None without a
        sample)."""
        now = time.monotonic()
        best: float | None = None
        with self._lock:
            for (_, o), ent in self._recent.items():
                if o != op:
                    continue
                self._expire(ent, now)
                if ent[4] == 0:
                    continue
                mean = ent[3] / ent[4]
                if best is None or mean < best:
                    best = mean
        return best

    def snapshot(self) -> dict:
        """JSON /metrics shape: '<peer>:<op>' -> counters dict.
        ``recentSeconds``/``recentCount`` cover RECENT_WINDOW_S."""
        now = time.monotonic()
        with self._lock:
            out = {}
            for (p, o), r in sorted(self._m.items(),
                                    key=lambda kv: str(kv[0])):
                ent = self._recent.get((p, o))
                if ent is not None:
                    self._expire(ent, now)
                    rs, rc = ent[1], ent[2]
                else:
                    rs, rc = 0.0, 0
                out[f"{p}:{o}"] = {"count": r[0], "errors": r[1],
                                   "retries": r[2], "bytesOut": r[3],
                                   "bytesIn": r[4],
                                   "seconds": round(r[5], 6),
                                   "recentSeconds": round(rs, 6),
                                   "recentCount": rc}
            return out

    def rows(self) -> list[tuple[str, str, list]]:
        """(peer, op, [count, errors, retries, bytes_out, bytes_in, s])
        rows, sorted by key."""
        with self._lock:
            return [(str(p), str(o), list(r))
                    for (p, o), r in sorted(self._m.items(),
                                            key=lambda kv: str(kv[0]))]


def _span_dict(r: tuple) -> dict:
    tid, sid, parent, name, node, t_wall, dur, peer, nbytes, err = r
    d = {"t": tid, "s": sid, "p": parent, "name": name, "node": node,
         "t0": round(t_wall, 6), "d": round(dur, 6)}
    if peer is not None:
        d["peer"] = peer
    if nbytes:
        d["bytes"] = nbytes
    if err:
        d["err"] = err
    return d


class Observability:
    """One node's observability state: span ring + RPC metric tables +
    the shared :class:`LatencyRecorder`, plus the diagnosis
    hooks — the flight-recorder journal, the tail-retention store that
    pins slow/errored traces across ring churn, and the sentinel gauge
    surface. Constructed unconditionally by the node runtime;
    ``ObsConfig(trace_ring=0)`` turns every tracing path into a
    constant-time no-op while the metric tables stay live.
    """

    # traces the tail store tracks at once; oldest forgotten first (its
    # already-pinned spans stay until the span-count bound evicts them)
    _MAX_INTERESTING = 128

    def __init__(self, cfg, node_id: int,
                 latency: LatencyRecorder | None = None,
                 journal=None) -> None:
        self.cfg = cfg
        self.node_id = node_id
        self.latency = latency if latency is not None else LatencyRecorder()
        self._ring: deque | None = deque(maxlen=cfg.trace_ring) \
            if cfg.trace_ring > 0 else None
        # tail retention (Dapper's tail-sampling lesson): spans of
        # slow/errored traces are COPIED here and survive main-ring
        # eviction — bounded by span count, FIFO. None = feature off.
        self._tail: deque | None = deque() \
            if cfg.tail_keep > 0 and self._ring is not None else None
        self._tail_ids: set[str] = set()
        self._interesting: dict[str, None] = {}   # insertion-ordered
        # flight recorder (obs/journal.py) — None when journaling is off
        # or the owner (tests, standalone tools) never attached one
        self.journal = journal
        # set by the node runtime when sentinels run; stats() surfaces it
        self.sentinel = None
        self._lock = threading.Lock()
        self.rpc_client = RpcStats()
        self.rpc_server = RpcStats()

    @property
    def enabled(self) -> bool:
        return self._ring is not None

    # ---- lifecycle events (flight recorder) --------------------------- #

    def event(self, etype: str, **fields) -> None:
        """Record one lifecycle event in the journal, stamped with the
        active trace id. No-op without a journal; never blocks (the
        journal writer is a bounded-queue thread)."""
        j = self.journal
        if j is None:
            return
        cur = _ctx.get() if self._ring is not None else None
        j.emit(etype, fields, trace=cur[0] if cur is not None else None)

    # ---- propagation carriers ---------------------------------------- #

    def wire_trace(self) -> dict | None:
        """The ``trace`` field to attach to an outbound wire header —
        {"t","s","f"} naming the CURRENT span as the peer's parent —
        or None (tracing off / caller untraced): the field is simply
        omitted."""
        cur = _ctx.get() if self._ring is not None else None
        if cur is None:
            return None
        return {"t": cur[0], "s": cur[1], "f": self.node_id}

    # ---- span recording ---------------------------------------------- #

    def _traced(self, name, tid, sid, parent, peer, latency_name):
        tok = _ctx.set((tid, sid))
        # a record_function range while device_trace captures, else None:
        # the span frames its kernels on the device timeline
        ann = _trace_mod.annotate(name)
        sp = Span()
        t_wall = time.time()
        t0 = time.perf_counter()
        err = None
        try:
            yield sp
        except BaseException as e:
            err = type(e).__name__
            raise
        finally:
            _ctx.reset(tok)
            dur = time.perf_counter() - t0
            if latency_name is not None:
                # traced observations carry their trace id as the
                # bucket's OpenMetrics exemplar (/metrics?format=prom)
                self.latency.record(latency_name, dur, exemplar=tid)
            ring = self._ring
            if ring is not None:
                rec = (tid, sid, parent, name, self.node_id,
                       t_wall, dur, peer, sp.bytes, err or sp.err)
                with self._lock:
                    ring.append(rec)
                    if self._tail is not None:
                        self._tail_note(rec)
            _trace_mod.close_annotation(ann)

    # ---- tail retention (lock held by caller) ------------------------- #

    def _tail_note(self, rec: tuple) -> None:
        """Pin spans of outlier traces. A span that is slow (>=
        slow_span_s) or errored marks its whole trace interesting: the
        trace's spans already in the main ring are copied into the tail
        store, and every later span of the trace lands there too — so
        the one request worth diagnosing survives the churn of the
        thousand ordinary ones that follow it (Dapper's tail lesson)."""
        tid = rec[0]
        if tid not in self._interesting:
            if not (rec[9] or rec[6] >= self.cfg.slow_span_s):
                return
            while len(self._interesting) >= self._MAX_INTERESTING:
                del self._interesting[next(iter(self._interesting))]
            self._interesting[tid] = None
            # sweep earlier spans of this trace out of the mortal ring
            for r in self._ring:
                if r[0] == tid and r[1] != rec[1]:
                    self._tail_pin(r)
        self._tail_pin(rec)

    def _tail_pin(self, rec: tuple) -> None:
        if rec[1] in self._tail_ids:
            return
        while len(self._tail) >= self.cfg.tail_keep:
            old = self._tail.popleft()
            self._tail_ids.discard(old[1])
        self._tail.append(rec)
        self._tail_ids.add(rec[1])

    @contextlib.contextmanager
    def span(self, name: str, peer=None, latency: bool = False):
        """Child span of the current context. Without an active context
        (or with tracing off) this is a no-op — except that
        ``latency=True`` still records the duration into the shared
        LatencyRecorder under ``name`` (the ``/metrics`` latency
        surface keeps its keys regardless of tracing state)."""
        cur = _ctx.get() if self._ring is not None else None
        if cur is None:
            if not latency:
                yield _NULL_SPAN
                return
            ann = _trace_mod.annotate(name)
            t0 = time.perf_counter()
            try:
                yield _NULL_SPAN
            finally:
                self.latency.record(name, time.perf_counter() - t0)
                _trace_mod.close_annotation(ann)
            return
        yield from self._traced(name, cur[0], new_span_id(), cur[1],
                                peer, name if latency else None)

    @contextlib.contextmanager
    def request_span(self, name: str,
                     incoming: tuple[str, str] | None = None, peer=None,
                     latency: bool = False):
        """Entry-point span (HTTP layer): adopts (trace_id, parent) from
        an inbound ``X-Dfs-Trace`` carrier, or roots a fresh trace —
        always-on tracing means every request is traceable, not only the
        ones a client asked about. ``latency=True`` records the span's
        duration under ``name`` — traced requests tag the bucket they
        land in with their trace id (the OpenMetrics exemplar the
        ``/metrics?format=prom`` exposition serves), and the name stays
        a bounded-cardinality histogram key even with tracing off (the
        HTTP layer only passes allowlisted route names)."""
        if self._ring is None:
            if not latency:
                yield _NULL_SPAN
                return
            t0 = time.perf_counter()
            try:
                yield _NULL_SPAN
            finally:
                self.latency.record(name, time.perf_counter() - t0)
            return
        if incoming is not None:
            tid, parent = incoming
        else:
            tid, parent = new_trace_id(), None
        yield from self._traced(name, tid, new_span_id(), parent, peer,
                                name if latency else None)

    @contextlib.contextmanager
    def server_span(self, name: str,
                    incoming: tuple[str, str, int | None] | None,
                    peer=None):
        """Storage-plane server span: ``incoming`` is
        :func:`parse_wire_trace` output. A frame without a trace field
        (an untraced caller) roots a fresh trace."""
        if self._ring is None:
            yield _NULL_SPAN
            return
        if incoming is not None:
            tid, parent = incoming[0], incoming[1]
            if peer is None:
                peer = incoming[2]
        else:
            tid, parent = new_trace_id(), None
        yield from self._traced(name, tid, new_span_id(), parent, peer,
                                None)

    # ---- query ------------------------------------------------------- #

    def spans_for(self, trace_id: str) -> list[dict]:
        """Finished spans of one trace still resident — main ring plus
        the tail-retention store (outlier traces outlive ring churn
        there), deduped by span id, ordered by wall start."""
        if self._ring is None:
            return []
        with self._lock:
            rows = [r for r in self._ring if r[0] == trace_id]
            if self._tail is not None:
                have = {r[1] for r in rows}
                rows.extend(r for r in self._tail
                            if r[0] == trace_id and r[1] not in have)
        rows.sort(key=lambda r: r[5])
        return [_span_dict(r) for r in rows]

    def stats(self) -> dict:
        """JSON ``/metrics`` ``obs`` section. The ``traceRing`` /
        ``slowSpanS`` / ``tailKeep`` keys mirror ObsConfig fields;
        ``journal`` / ``sentinel`` carry the flight-recorder and sampler
        sub-sections."""
        with self._lock:
            tail_spans = len(self._tail) if self._tail is not None else 0
        return {"traceRing": self.cfg.trace_ring,
                "slowSpanS": self.cfg.slow_span_s,
                "tailKeep": self.cfg.tail_keep,
                "spans": len(self._ring) if self._ring is not None else 0,
                "tailSpans": tail_spans,
                "journal": self.journal.stats()
                if self.journal is not None else {"enabled": False},
                "sentinel": self.sentinel.stats()
                if self.sentinel is not None else {"enabled": False},
                "rpcClient": self.rpc_client.snapshot(),
                "rpcServer": self.rpc_server.snapshot()}


__all__ = ["Observability", "RpcStats", "Span", "current", "is_id",
           "new_span_id", "new_trace_id", "parse_http_trace",
           "parse_wire_trace"]
