"""Async client of the internal storage plane (a port of dfs_tpu's
``comm/rpc.py``).

Per-peer pools of persistent :class:`FrameConnection`s, per-attempt
connect and request timeouts, bounded retries with decorrelated-jitter
backoff, and a per-peer retry budget. Placement-bearing ops carry the
sender's ring epoch and map fingerprint (``repoch``/``rfp``), as dfs_tpu's
client stamps them, so port and dfs_tpu nodes serve each other's frames.

Every call is recorded per (peer, op) in :attr:`InternalClient.rpc_stats`
(the hedge delay reads it; with an :class:`~dfs_tpu_torch.obs.Observability`
it is ``obs.rpc_client``). With the obs hook each call opens an
``rpc.<op>`` span and carries the trace context in the optional wire
``trace`` field, and retries, unreachable peers, exhausted retry budgets
and deadline sheds are journaled (``rpc_retry``, ``rpc_unreachable``,
``retry_budget_exhausted``, ``deadline_shed``). With a
:class:`~dfs_tpu_torch.chaos.ChaosInjector` each attempt passes its peer
faults first: a one-way partition, injected latency, a dropped
connection or a torn frame, all raised as the OSErrors the retry loop
already handles. Under an end-to-end deadline
(:mod:`dfs_tpu_torch.utils.deadline`) each attempt carries the remaining
budget in the optional ``deadline`` header field; a call whose budget is
gone is never sent, and a retry the budget cannot cover is not made
(:class:`DeadlineExpired`). With ``coalesce_fetches`` concurrent
``get_chunk`` calls of one digest to one peer share one transfer.

Ops: ``store_chunks`` (with the receiver's hash echo) and its windowed
form, ``has_chunks``, ``get_chunk(s)``, ``get_manifest``, ``announce``,
``delete``, ``tombstones``, ``list_manifests``, ``health``, and the
dedup/index plane's filter exchange ``get_filter``, ``get_filters`` and
``filter_delta``, the membership ops ``get_ring`` and ``propose_ring``,
and the diagnosis ops ``get_census`` and ``get_doctor`` (the frames
dfs_tpu's nodes send).

A peer that refuses a placement-bearing op with another ring answers a
structured refusal (``ringEpoch`` and its map), raised as
:class:`RingEpochMismatch`; :meth:`InternalClient.call` then converges
once, as dfs_tpu's client does: it adopts the peer's map when it wins the
``(epoch, fingerprint)`` order, or pushes ours with ``propose_ring``, and
retries the call exactly once.
"""

from __future__ import annotations

import asyncio
import contextlib
import random
import time
from typing import Any

from dfs_tpu_torch.comm.wire import (Buffer, FrameConnection, WireError,
                                     buffers_nbytes, pack_chunks,
                                     unpack_chunks)
from dfs_tpu_torch.config import PeerAddr
from dfs_tpu_torch.obs import RpcStats
from dfs_tpu_torch.serve.singleflight import SingleFlight
from dfs_tpu_torch.utils import deadline
from dfs_tpu_torch.utils.aio import gather_abort_siblings


class RpcError(RuntimeError):
    """Base for storage-plane call failures."""


class RpcUnreachable(RpcError):
    """Transport-level failure on every attempt: the only error that
    counts as evidence a peer is dead."""


class RpcRemoteError(RpcError):
    """The peer answered with an application-level error (chunk not
    found, unknown op, ring mismatch); says nothing about liveness."""


class DeadlineExpired(RpcError):
    """The caller's end-to-end deadline ran out before (or between)
    attempts: no frame is sent and no retry is paid. Not RpcUnreachable:
    an expired budget says nothing about the peer's liveness."""


class RingEpochMismatch(RpcRemoteError):
    """The peer refused a placement-bearing op because our rings differ.
    Carries the peer's epoch and (when it sent one) its ring map, so the
    stale side converges without another round trip."""

    def __init__(self, msg: str, epoch: int, ring: dict | None) -> None:
        super().__init__(msg)
        self.epoch = epoch
        self.ring = ring


# ops that carry the sender's ring epoch + fingerprint
_EPOCH_OPS = frozenset({"store_chunks", "get_chunk", "get_chunks",
                        "has_chunks"})


class RetryBudget:
    """Per-peer token bucket gating RETRY attempts (first attempts are
    free): about ``refill_per_s`` retries a second per peer with
    ``capacity`` of burst, so a partition costs one budget, not a storm.
    Touched only from the owning event loop."""

    CAPACITY = 10.0
    REFILL_PER_S = 0.5

    def __init__(self, capacity: float = CAPACITY,
                 refill_per_s: float = REFILL_PER_S) -> None:
        self.capacity = float(capacity)
        self.refill_per_s = float(refill_per_s)
        self._tokens: dict[Any, tuple[float, float]] = {}
        self._exhausted: dict[Any, int] = {}

    def take(self, peer) -> bool:
        now = time.monotonic()
        tokens, last = self._tokens.get(peer, (self.capacity, now))
        tokens = min(self.capacity,
                     tokens + (now - last) * self.refill_per_s)
        if tokens >= 1.0:
            self._tokens[peer] = (tokens - 1.0, now)
            return True
        self._tokens[peer] = (tokens, now)
        self._exhausted[peer] = self._exhausted.get(peer, 0) + 1
        return False

    def stats(self) -> dict:
        """``/metrics`` ``retryBudget``."""
        now = time.monotonic()
        tokens = {
            str(p): round(min(self.capacity,
                              t + (now - last) * self.refill_per_s), 2)
            for p, (t, last) in sorted(self._tokens.items(),
                                       key=lambda kv: str(kv[0]))}
        return {"capacity": self.capacity,
                "refillPerS": self.refill_per_s,
                "tokens": tokens,
                "exhausted": {str(p): n for p, n in
                              sorted(self._exhausted.items(),
                                     key=lambda kv: str(kv[0]))}}


class InternalClient:
    """Storage-plane RPC client with a per-peer connection pool."""

    _MAX_IDLE_PER_PEER = 4
    # bulk transfers get extra time per byte on top of the request
    # timeout: 1 MB/s is the assumed worst-case effective bandwidth of a
    # receiver that creates one fsync'd file per chunk
    _BULK_BYTES_PER_S = 1024 * 1024
    # decorrelated-jitter backoff: sleep_n = min(CAP, U(BASE, 3 sleep_n-1))
    _BACKOFF_BASE_S = 0.05
    _BACKOFF_CAP_S = 0.5

    def __init__(self, connect_timeout_s: float = 2.0,
                 request_timeout_s: float = 10.0, retries: int = 3,
                 coalesce_fetches: bool = False, ring=None, obs=None,
                 chaos=None) -> None:
        self.connect_timeout_s = connect_timeout_s
        self.request_timeout_s = request_timeout_s
        self.retries = retries
        self._ring = ring
        self._obs = obs
        self._chaos = chaos
        self.retry_budget = RetryBudget()
        # per-(peer, op) calls, latency, bytes, errors, retries: the
        # node's client table when it has an Observability
        self.rpc_stats = obs.rpc_client if obs is not None else RpcStats()
        self._backoff_rng = random.Random()
        self._pool: dict[tuple[str, int], list[FrameConnection]] = {}
        # per-(peer, digest) single-flight of get_chunk (the serving
        # tier's); None keeps one call per get_chunk
        self._flight = SingleFlight() if coalesce_fetches else None

    def _checkout(self, peer: PeerAddr) -> FrameConnection | None:
        pool = self._pool.get((peer.host, peer.internal_port))
        while pool:
            conn = pool.pop()
            if conn.closed:
                conn.close()
                continue
            return conn
        return None

    def _checkin(self, peer: PeerAddr, conn: FrameConnection) -> None:
        pool = self._pool.setdefault((peer.host, peer.internal_port), [])
        if len(pool) < self._MAX_IDLE_PER_PEER and not conn.closed:
            pool.append(conn)
        else:
            conn.close()

    def close(self) -> None:
        """Drop every pooled connection (node shutdown)."""
        for pool in self._pool.values():
            for conn in pool:
                conn.close()
        self._pool.clear()

    def _bulk_timeout(self, n_bytes: int) -> float:
        return self.request_timeout_s + n_bytes / self._BULK_BYTES_PER_S

    async def _request(self, conn: FrameConnection, header: dict, body,
                       timeout_s: float | None,
                       acct: dict) -> tuple[dict, memoryview]:
        t = self.request_timeout_s if timeout_s is None \
            else max(self.request_timeout_s, timeout_s)
        acct["out"] += await asyncio.wait_for(conn.send(header, body),
                                              timeout=t)
        resp, rbody, nrecv = await asyncio.wait_for(conn.reply(), timeout=t)
        acct["in"] += nrecv
        return resp, rbody

    async def _dial(self, peer: PeerAddr) -> FrameConnection:
        return await asyncio.wait_for(
            FrameConnection.connect(peer.host, peer.internal_port),
            timeout=self.connect_timeout_s)

    async def _call_once(self, peer: PeerAddr, header: dict, body,
                         timeout_s: float | None, acct: dict
                         ) -> tuple[dict, memoryview]:
        rem = deadline.remaining()
        if rem is not None:
            if rem <= 0:
                # expired work never reaches the wire
                raise DeadlineExpired(
                    f"peer {peer.node_id}: deadline expired before send")
            # the remaining budget, re-stamped on every attempt
            header["deadline"] = round(rem, 4)
        chaos = self._chaos
        op = str(header.get("op"))
        if chaos is not None:
            # partition: fail before dialing (one-way: only this side's
            # sends die); delay/drop: link faults before the frame goes
            # out. All OSErrors, so retries, backoff and the budget
            # handle them as real faults
            chaos.check_partition(peer.node_id, op)
            await chaos.before_rpc(peer.node_id, op)
        conn = self._checkout(peer)
        reused = conn is not None
        if conn is None:
            conn = await self._dial(peer)
        if chaos is not None and chaos.truncate_now(peer.node_id, op):
            # a torn frame: the receiver's mid-frame teardown path
            try:
                conn.send_torn(header, body)
            finally:
                conn.close()
            raise ConnectionResetError(
                f"chaos: truncated frame to node {peer.node_id}")
        try:
            resp, rbody = await self._request(conn, header, body, timeout_s,
                                              acct)
        except (ConnectionError, asyncio.IncompleteReadError, WireError):
            # a pooled connection the server closed while idle fails on
            # its first frame: retry ONCE on a fresh dial. A timeout does
            # not take this path (the peer may still be working on it)
            conn.close()
            if not reused:
                raise
            conn = await self._dial(peer)
            try:
                resp, rbody = await self._request(conn, header, body,
                                                  timeout_s, acct)
            except BaseException:
                conn.close()
                raise
        except BaseException:
            conn.close()
            raise
        # the exchange completed, so the connection is in frame sync even
        # for an application error: pool it either way
        self._checkin(peer, conn)
        if not resp.get("ok", False):
            re = resp.get("ringEpoch")
            if isinstance(re, int) and not isinstance(re, bool):
                # structured membership refusal: the peer's epoch and map
                # ride it, so call() converges without another round trip
                raise RingEpochMismatch(
                    f"peer {peer.node_id} error: {resp.get('error')}",
                    epoch=re, ring=resp.get("ring")
                    if isinstance(resp.get("ring"), dict) else None)
            raise RpcRemoteError(
                f"peer {peer.node_id} error: {resp.get('error')}")
        return resp, rbody

    async def call(self, peer: PeerAddr, header: dict,
                   body: Buffer | list[Buffer] = b"",
                   retries: int | None = None,
                   timeout_s: float | None = None
                   ) -> tuple[dict, memoryview]:
        """Bounded-retry call. ``body`` (one buffer or a list) rides the
        wire unjoined; the reply body is a read-only view of the reply
        frame. ``retries`` overrides the attempt count (1 for a peer the
        health monitor believes dead); ``timeout_s`` raises, never lowers,
        the per-attempt budget. Recorded in :attr:`rpc_stats` (frame
        bytes summed over the attempts). With the obs hook the call is an
        ``rpc.<op>`` span whose id rides the header's ``trace`` field as
        the peer's parent."""
        if self._ring is not None and header.get("op") in _EPOCH_OPS \
                and "repoch" not in header:
            header["repoch"] = self._ring.epoch
            header["rfp"] = self._ring.current.fingerprint
        op = str(header.get("op"))
        obs = self._obs
        with (obs.span(f"rpc.{op}", peer=peer.node_id) if obs is not None
              else contextlib.nullcontext()) as sp:
            if obs is not None:
                # attached inside the span: its id is the peer's parent
                tr = obs.wire_trace()
                if tr is not None:
                    header["trace"] = tr
            t0 = time.perf_counter()
            acct = {"out": 0, "in": 0}
            failed = True
            try:
                out = await self._call_converging(peer, header, body,
                                                  retries, timeout_s, acct)
                failed = False
                if sp is not None:
                    sp.bytes = acct["out"] + acct["in"]
                return out
            finally:
                self.rpc_stats.record(peer.node_id, op,
                                      time.perf_counter() - t0,
                                      bytes_out=acct["out"],
                                      bytes_in=acct["in"], error=failed)

    async def _call_converging(self, peer: PeerAddr, header: dict, body,
                               retries: int | None,
                               timeout_s: float | None,
                               acct: dict) -> tuple[dict, memoryview]:
        """:meth:`_call_retrying` plus the one-shot epoch convergence: on
        a :class:`RingEpochMismatch` the lower map refreshes — ours adopts
        the peer's map from the refusal when it wins the ``(epoch,
        fingerprint)`` order, otherwise the peer gets ours through
        ``propose_ring`` — and the call is retried exactly once. A second
        mismatch (a racing epoch bump) propagates."""
        try:
            return await self._call_retrying(peer, header, body, retries,
                                             timeout_s, acct)
        except RingEpochMismatch as e:
            ring = self._ring
            if ring is None:
                raise
            ring.note_epoch_mismatch()
            adopted = False
            if e.ring is not None:
                try:
                    adopted = ring.adopt(e.ring,
                                         source=f"mismatch:{peer.node_id}")
                except ValueError:
                    raise e from None   # malformed map from the peer
            if not adopted:
                # the peer's map lost (or was absent): teach it ours
                await self._call_retrying(
                    peer, {"op": "propose_ring",
                           "ring": ring.current.to_dict()},
                    b"", 1, None, acct)
            header["repoch"] = ring.epoch
            header["rfp"] = ring.current.fingerprint
            return await self._call_retrying(peer, header, body, retries,
                                             timeout_s, acct)

    async def _call_retrying(self, peer: PeerAddr, header: dict, body,
                             retries: int | None, timeout_s: float | None,
                             acct: dict) -> tuple[dict, memoryview]:
        attempts = retries if retries is not None else self.retries
        op = str(header.get("op"))
        last: Exception | None = None
        prev_sleep = self._BACKOFF_BASE_S
        for attempt in range(attempts):
            if attempt:
                if not self.retry_budget.take(peer.node_id):
                    self._event("retry_budget_exhausted", peer=peer.node_id,
                                op=op, attempt=attempt,
                                cause=type(last).__name__ if last
                                else None)
                    raise RpcUnreachable(
                        f"peer {peer.node_id} retry budget exhausted "
                        f"after {attempt} attempt(s): "
                        f"{type(last).__name__}: {last}")
                self.rpc_stats.retry(peer.node_id, op)
                # a retry storm on one peer is the early sign of a sick
                # link; the tables keep totals, the journal keeps when
                self._event("rpc_retry", peer=peer.node_id, op=op,
                            attempt=attempt,
                            cause=type(last).__name__ if last else None)
            try:
                return await self._call_once(peer, header, body, timeout_s,
                                             acct)
            except RpcError:
                raise            # application error: retrying won't help
            except (OSError, asyncio.TimeoutError, RuntimeError) as e:
                last = e
                if attempt + 1 < attempts:
                    prev_sleep = min(
                        self._BACKOFF_CAP_S,
                        self._backoff_rng.uniform(self._BACKOFF_BASE_S,
                                                  3.0 * prev_sleep))
                    rem = deadline.remaining()
                    if rem is not None \
                            and rem < prev_sleep + self.connect_timeout_s:
                        # the budget cannot cover the backoff plus even a
                        # connect: another attempt is waste
                        self._event("deadline_shed", where="rpc_retry",
                                    peer=peer.node_id, op=op,
                                    attempt=attempt)
                        raise DeadlineExpired(
                            f"peer {peer.node_id} {op}: deadline cannot "
                            f"cover another attempt ({rem:.3f}s left): "
                            f"{type(e).__name__}: {e}") from e
                    await asyncio.sleep(prev_sleep)
        self._event("rpc_unreachable", peer=peer.node_id, op=op,
                    attempts=attempts, cause=type(last).__name__)
        raise RpcUnreachable(
            f"peer {peer.node_id} unreachable after {attempts} attempts: "
            f"{type(last).__name__}: {last}")

    def _event(self, etype: str, **fields) -> None:
        if self._obs is not None:
            self._obs.event(etype, **fields)

    # ---- typed ops ----

    async def store_chunks(self, peer: PeerAddr, file_id: str,
                           chunks: list[tuple[str, Buffer]]) -> list[str]:
        """Send chunks; returns the digests the receiver recomputed from
        the bytes it stored (the hash echo the caller verifies)."""
        table, bufs = pack_chunks(chunks)
        resp, _ = await self.call(
            peer, {"op": "store_chunks", "fileId": file_id, "chunks": table},
            bufs, timeout_s=self._bulk_timeout(buffers_nbytes(bufs)))
        return list(resp.get("digests", []))

    async def store_chunks_windowed(
            self, peer: PeerAddr, file_id: str,
            slices: list[list[tuple[str, Buffer]]], window: int = 2,
            on_slice=None) -> int:
        """Send payload slices to ONE peer with up to ``window`` in flight
        (each on its own pooled connection). ``on_slice(part, echoed)``
        runs as each completes; an exception it raises cancels the rest
        and propagates. Returns the peak number in flight."""
        window = max(1, window)
        if window == 1 or len(slices) <= 1:
            for part in slices:
                echoed = await self.store_chunks(peer, file_id, part)
                if on_slice is not None:
                    on_slice(part, echoed)
            return 1 if slices else 0
        sem = asyncio.Semaphore(window)
        inflight = 0
        peak = 0

        async def one(part) -> None:
            nonlocal inflight, peak
            async with sem:
                inflight += 1
                peak = max(peak, inflight)
                try:
                    echoed = await self.store_chunks(peer, file_id, part)
                finally:
                    inflight -= 1
                if on_slice is not None:
                    on_slice(part, echoed)

        await gather_abort_siblings(*(one(p) for p in slices))
        return peak

    async def has_chunks(self, peer: PeerAddr, digests: list[str],
                         retries: int | None = None) -> set[str]:
        resp, _ = await self.call(peer, {"op": "has_chunks",
                                         "digests": digests},
                                  retries=retries)
        return set(resp.get("have", []))

    async def announce(self, peer: PeerAddr, manifest_json: str,
                       fresh: bool = False) -> None:
        """``fresh=True``: an announce straight from an upload, which
        clears the receiver's tombstone for the file id; replayed
        announces leave it unset and bounce off tombstones."""
        await self.call(peer, {"op": "announce", "manifest": manifest_json,
                               "fresh": fresh})

    async def get_chunk(self, peer: PeerAddr, digest: str) -> memoryview:
        """One chunk as a read-only view of the reply frame. With
        ``coalesce_fetches``, concurrent calls for one (peer, digest)
        share one transfer; a leader's failure reaches its waiters as an
        RpcError (never its CancelledError) and clears the key."""
        if self._flight is None:
            _, body = await self.call(peer, {"op": "get_chunk",
                                             "digest": digest})
            return body
        key = (peer.host, peer.internal_port, digest)
        leader, fut = self._flight.claim(key)
        if not leader:
            # a coalesced caller's trace shows where its time went:
            # waiting on another flight, not the wire
            if self._obs is not None:
                with self._obs.span("rpc.get_chunk.wait",
                                    peer=peer.node_id):
                    return await self._flight.wait(fut)
            return await self._flight.wait(fut)
        try:
            _, body = await self.call(peer, {"op": "get_chunk",
                                             "digest": digest})
        except BaseException as e:
            exc = e if isinstance(e, RpcError) else RpcRemoteError(
                f"coalesced fetch aborted: {type(e).__name__}: {e}")
            self._flight.reject(key, exc)
            raise
        self._flight.resolve(key, body)
        return body

    async def get_chunks(self, peer: PeerAddr, digests: list[str],
                         retries: int | None = None,
                         expect_bytes: int = 0
                         ) -> list[tuple[str, memoryview]]:
        """Batched fetch: (digest, payload view) for every requested chunk
        the peer holds; missing ones are absent."""
        resp, body = await self.call(
            peer, {"op": "get_chunks", "digests": digests},
            retries=retries, timeout_s=self._bulk_timeout(expect_bytes))
        return unpack_chunks(resp.get("chunks", []), body)

    async def get_filter(self, peer: PeerAddr,
                         retries: int | None = None
                         ) -> tuple[dict | None, memoryview]:
        """Full peer-existence filter snapshot: (meta, filter-bytes view),
        meta None when the peer runs no filter plane. The view is of the
        reply frame; a caller that keeps the filter copies it."""
        resp, body = await self.call(peer, {"op": "get_filter"},
                                     retries=retries)
        meta = resp.get("filter")
        return (meta if isinstance(meta, dict) else None), body

    async def get_filters(self, peer: PeerAddr,
                          retries: int | None = None
                          ) -> list[tuple[dict, memoryview]]:
        """Every filter the peer holds — its own first, then its replicas
        of the other nodes' — as (meta, filter-bytes view) pairs; each
        meta carries nodeId/gen/version/capacity/bitsPerKey/ageS/length
        and the blobs ride concatenated in table order. Empty on a peer
        without the filter plane."""
        resp, body = await self.call(peer, {"op": "get_filters"},
                                     retries=retries)
        out: list[tuple[dict, memoryview]] = []
        off = 0
        for meta in resp.get("filters", []):
            ln = int(meta.get("length", 0))
            out.append((meta, body[off:off + ln]))
            off += ln
        return out

    async def filter_delta(self, peer: PeerAddr, gen: int, since: int,
                           retries: int | None = None) -> dict:
        """Incremental filter update from (generation, version): ``adds``
        (the digests since ``since``) or ``resync: true`` when the replica
        must refetch the full filter."""
        resp, _ = await self.call(
            peer, {"op": "filter_delta", "gen": gen, "since": since},
            retries=retries)
        return resp

    async def get_census(self, peer: PeerAddr,
                         prefixes: list[str] | None = None,
                         retries: int | None = None) -> dict | None:
        """One peer's census inventory: the bucketed CAS summary, or with
        ``prefixes`` the member digest lists of exactly those buckets (the
        drill-down; the receiver caps each list)."""
        header: dict = {"op": "get_census"}
        if prefixes:
            header["prefixes"] = list(prefixes)
        resp, _ = await self.call(peer, header, retries=retries)
        census = resp.get("census")
        return census if isinstance(census, dict) else None

    async def get_manifest(self, peer: PeerAddr, file_id: str
                           ) -> tuple[str | None, float | None]:
        """-> (manifest JSON or None, the peer's manifest mtime or None)."""
        resp, _ = await self.call(peer, {"op": "get_manifest",
                                         "fileId": file_id})
        return resp.get("manifest"), resp.get("mtime")

    async def health(self, peer: PeerAddr) -> dict[str, Any]:
        resp, _ = await self.call(peer, {"op": "health"})
        return resp
