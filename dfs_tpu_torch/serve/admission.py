"""Admission control: bounded concurrency per request class and load
shedding (a copy of dfs_tpu's ``serve/admission.py``).

Without backpressure an overloaded asyncio node degrades every request at
once. Each request class (download / upload / internal) gets a
semaphore-like gate with a BOUNDED wait queue; a request that cannot be
queued is refused at once (:class:`ShedError`, answered ``503`` with
``Retry-After``), which costs the client one cheap retry instead of
costing every request in flight its latency budget.

The gate is deadline-aware: a request that arrives with its end-to-end
deadline already expired is shed at once, and a QUEUED waiter whose
deadline passes is evicted from the queue; both count ``deadlineShed``,
apart from the capacity ``shed``. A queued waiter may carry a
``disconnected`` watcher: a client that hangs up while queued frees its
position instead of taking a slot at the head (:class:`ClientDisconnected`).

``slots <= 0`` disables a gate (the default): acquire returns at once and
no counter moves. With the node's Observability a shed journals ``shed``,
a deadline shed ``deadline_shed`` and a queued client's hangup
``queue_disconnect``, and a queued acquire records an
``admission.<class>.wait`` span under the caller's trace.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import time

from dfs_tpu_torch.utils import deadline


class ShedError(RuntimeError):
    """Request refused by admission control: HTTP 503 with Retry-After."""

    def __init__(self, cls: str, retry_after_s: float,
                 reason: str = "capacity exhausted") -> None:
        super().__init__(f"{cls} {reason}, retry after "
                         f"{retry_after_s:g}s")
        self.request_class = cls
        self.retry_after_s = retry_after_s


class ClientDisconnected(RuntimeError):
    """A queued waiter's client hung up before its slot was granted."""


class AdmissionGate:
    """One request class's gate: up to ``slots`` concurrent holders, up
    to ``queue_depth`` waiters, shed beyond that."""

    # recency window of ``stats()["shedRecent"]``; the deque bound caps
    # memory under a storm
    SHED_WINDOW_S = 60.0
    _SHED_TS_MAX = 256

    def __init__(self, name: str, slots: int, queue_depth: int,
                 retry_after_s: float = 1.0, obs=None) -> None:
        self.name = name
        self._obs = obs
        self.slots = int(slots)
        self.queue_depth = max(0, int(queue_depth))
        self.retry_after_s = float(retry_after_s)
        self._active = 0
        self._queue: collections.deque[asyncio.Future] = collections.deque()
        self.admitted = 0
        self.queued = 0
        self.shed = 0
        # expired at arrival or evicted from the queue, apart from the
        # capacity sheds
        self.deadline_shed = 0
        # queued waiters whose client hung up before the grant
        self.disconnects = 0
        self._shed_ts: collections.deque[float] = \
            collections.deque(maxlen=self._SHED_TS_MAX)

    @property
    def enabled(self) -> bool:
        return self.slots > 0

    def _shed_deadline(self, where: str) -> None:
        self.deadline_shed += 1
        if self._obs is not None:
            self._obs.event("deadline_shed", cls=self.name, where=where)
        raise ShedError(self.name, self.retry_after_s,
                        reason=f"deadline expired ({where})")

    async def acquire(self, disconnected=None) -> None:
        """Take a slot (or queue for one). ``disconnected`` is an
        optional zero-arg factory of an awaitable that completes when the
        caller's client hangs up (an EOF-returning socket read); it is
        started only if this acquire queues."""
        if not self.enabled:
            return
        if deadline.expired():
            # dead on arrival: never take a slot, never join the queue
            self._shed_deadline("arrival")
        if self._active < self.slots:
            self._active += 1
            self.admitted += 1
            return
        # a cancelled waiter stays in the deque until release() skips it;
        # counting only live futures keeps ghosts from eating the depth
        waiting = sum(1 for f in self._queue if not f.done())
        if waiting >= self.queue_depth:
            self.shed += 1
            self._shed_ts.append(time.monotonic())
            if self._obs is not None:
                self._obs.event("shed", cls=self.name,
                                active=self._active, waiting=waiting)
            raise ShedError(self.name, self.retry_after_s)
        fut = asyncio.get_running_loop().create_future()
        self._queue.append(fut)
        self.queued += 1
        try:
            if self._obs is not None:
                with self._obs.span(f"admission.{self.name}.wait"):
                    await self._await_grant(fut, disconnected)
            else:
                await self._await_grant(fut, disconnected)
        except asyncio.CancelledError:
            if fut.done() and not fut.cancelled():
                # the grant raced our cancellation: the slot is ours —
                # hand it to the next waiter
                self._release_slot()
            raise
        self.admitted += 1

    def _abandon(self, fut: asyncio.Future) -> None:
        """Leave the queue without taking the slot: a raced grant passes
        straight to the next waiter, else the future is cancelled so
        ``_release_slot`` skips the ghost."""
        if fut.done() and not fut.cancelled():
            self._release_slot()
        else:
            fut.cancel()

    async def _await_grant(self, fut: asyncio.Future,
                           disconnected) -> None:
        """Wait for the grant, bounded by the caller's deadline and
        aborted by a client disconnect; a plain ``await fut`` when
        neither applies."""
        watch: asyncio.Future | None = \
            asyncio.ensure_future(disconnected()) \
            if disconnected is not None else None
        try:
            while True:
                rem = deadline.remaining()
                if rem is None and watch is None:
                    await fut
                    return
                aws = {fut} if watch is None else {fut, watch}
                done, _ = await asyncio.wait(
                    aws,
                    timeout=max(0.0, rem) if rem is not None else None,
                    return_when=asyncio.FIRST_COMPLETED)
                if fut in done:
                    return                  # granted
                if watch is not None and watch in done:
                    failed = watch.cancelled() or \
                        watch.exception() is not None
                    if failed or not watch.result():
                        # EOF or reset while queued: the client is gone
                        self._abandon(fut)
                        self.disconnects += 1
                        if self._obs is not None:
                            self._obs.event("queue_disconnect",
                                            cls=self.name)
                        raise ClientDisconnected(
                            f"{self.name} client hung up while queued")
                    # a stray byte from a pipelining client is no hangup:
                    # re-arm the watch
                    watch = asyncio.ensure_future(disconnected())
                    continue
                # the wait timed out: the deadline passed while queued
                self._abandon(fut)
                self._shed_deadline("queue")
        finally:
            if watch is not None:
                watch.cancel()

    def release(self) -> None:
        if not self.enabled:
            return
        self._release_slot()

    def _release_slot(self) -> None:
        while self._queue:
            fut = self._queue.popleft()
            if not fut.done():
                fut.set_result(None)   # slot transfers: _active unchanged
                return
        self._active -= 1

    @contextlib.asynccontextmanager
    async def slot(self):
        await self.acquire()
        try:
            yield
        finally:
            self.release()

    def stats(self) -> dict:
        cutoff = time.monotonic() - self.SHED_WINDOW_S
        return {"slots": self.slots, "queueDepth": self.queue_depth,
                "active": self._active,
                "waiting": sum(1 for f in self._queue if not f.done()),
                "admitted": self.admitted, "queuedTotal": self.queued,
                "shed": self.shed,
                "deadlineShed": self.deadline_shed,
                "disconnects": self.disconnects,
                "shedRecent": sum(1 for t in self._shed_ts if t >= cutoff)}


class AdmissionControl:
    """The node's three gates, built from a ServeConfig."""

    def __init__(self, cfg, obs=None) -> None:
        self.download = AdmissionGate(
            "download", cfg.download_slots, cfg.queue_depth,
            cfg.retry_after_s, obs=obs)
        self.upload = AdmissionGate(
            "upload", cfg.upload_slots, cfg.queue_depth, cfg.retry_after_s,
            obs=obs)
        self.internal = AdmissionGate(
            "internal", cfg.internal_slots, cfg.queue_depth,
            cfg.retry_after_s, obs=obs)

    def stats(self) -> dict:
        return {g.name: g.stats()
                for g in (self.download, self.upload, self.internal)
                if g.enabled} or {"enabled": False}
