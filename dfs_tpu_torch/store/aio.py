"""Async front of the local CAS (a copy of dfs_tpu's ``store/aio.py``).

Every :class:`ChunkStore` operation is blocking file I/O; the node's
event loop hands it to small dedicated thread pools instead, so the loop
never blocks on chunk I/O and disk concurrency is bounded
(``IngestConfig.cas_io_threads``). Three lanes, so a latency-critical
single-chunk read never queues behind a batch: ``cas-w`` puts, ``cas-r``
batched reads, ``cas-g`` single gets and existence probes. ``queueS``
(waiting for a worker) and ``busyS`` (doing I/O) are served under
``/metrics`` ``ingest.cas``; ``pending`` is the backlog the sentinel
samples. With an :class:`~dfs_tpu_torch.obs.Observability` each op
records a ``cas.<op>`` span, opened on the loop side around the await:
``run_in_executor`` does not copy the caller's context, the await does.
"""

from __future__ import annotations

import asyncio
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Sequence, TypeVar

from dfs_tpu_torch.store.cas import ChunkStore

T = TypeVar("T")


class AsyncChunkStore:
    """Bounded-thread-pool async wrapper over one node's ChunkStore."""

    def __init__(self, store: ChunkStore, workers: int = 4,
                 obs=None) -> None:
        self.store = store
        self._obs = obs
        self._workers = max(1, int(workers))
        self._wpool = ThreadPoolExecutor(max_workers=self._workers,
                                         thread_name_prefix="cas-w")
        self._rpool = ThreadPoolExecutor(max_workers=self._workers,
                                         thread_name_prefix="cas-r")
        self._gpool = ThreadPoolExecutor(max_workers=max(2,
                                                         self._workers // 2),
                                         thread_name_prefix="cas-g")
        self._lock = threading.Lock()
        self._ops = 0
        self._queue_s = 0.0
        self._busy_s = 0.0
        self._pending = 0

    async def _run(self, pool: ThreadPoolExecutor, fn: Callable[[], T],
                   opname: str | None = None) -> T:
        t_submit = time.perf_counter()
        with self._lock:
            self._pending += 1

        def job() -> T:
            t_start = time.perf_counter()
            try:
                return fn()
            finally:
                t_end = time.perf_counter()
                with self._lock:
                    self._ops += 1
                    self._pending -= 1
                    self._queue_s += t_start - t_submit
                    self._busy_s += t_end - t_start

        try:
            fut = asyncio.get_running_loop().run_in_executor(pool, job)
        except BaseException:
            with self._lock:          # never submitted: unwind the gauge
                self._pending -= 1
            raise
        if self._obs is None or opname is None:
            return await fut
        with self._obs.span(opname):
            return await fut

    async def get(self, digest: str) -> bytes | None:
        return await self._run(self._gpool, lambda: self.store.get(digest),
                               "cas.get")

    async def has_many(self, digests: Sequence[str]) -> list[bool]:
        if not digests:
            return []
        ds = list(digests)
        return await self._run(self._gpool, lambda: self.store.has_many(ds),
                               "cas.has_many")

    async def get_many(self, digests: Sequence[str]
                       ) -> list[tuple[str, bytes]]:
        """(digest, bytes) for every digest present locally, one worker
        job for the whole list; absent digests are left out."""
        if not digests:
            return []
        ds = list(digests)
        return await self._run(
            self._rpool,
            lambda: [(d, b) for d in ds
                     if (b := self.store.get(d)) is not None],
            "cas.get_many")

    async def put(self, digest: str, data: bytes,
                  verify: bool = False) -> bool:
        """Store one chunk on a write worker; True = newly stored."""
        return await self._run(
            self._wpool,
            lambda: self.store.put(digest, data, verify=verify), "cas.put")

    async def put_many(self, items: Sequence[tuple[str, bytes]],
                       verify: bool = False) -> list[bool]:
        """Store a batch in one worker job; per item True = newly stored,
        False = already there."""
        if not items:
            return []
        its = list(items)
        return await self._run(
            self._wpool, lambda: self.store.put_batch(its, verify=verify),
            "cas.put_many")

    async def inventory(self, list_prefixes=None,
                        list_cap: int = 4096) -> dict:
        """The bucketed census scan (:meth:`ChunkStore.inventory`) as one
        read-pool job: a store-wide readdir and stat pass (or, with
        ``list_prefixes``, a readdir of exactly those buckets) never runs
        on the event loop."""
        lp = list(list_prefixes) if list_prefixes else None
        return await self._run(
            self._rpool,
            lambda: self.store.inventory(lp, list_cap=list_cap),
            "cas.inventory")

    @property
    def pending(self) -> int:
        """Jobs submitted but not yet finished (queued + running)."""
        with self._lock:
            return self._pending

    def stats(self) -> dict:
        with self._lock:
            return {"workers": self._workers, "ops": self._ops,
                    "pending": self._pending,
                    "queueS": round(self._queue_s, 6),
                    "busyS": round(self._busy_s, 6)}

    def close(self) -> None:
        # wait=False: in-flight jobs finish on their threads; an async
        # stop() must not block its loop on the drain
        for pool in (self._wpool, self._rpool, self._gpool):
            pool.shutdown(wait=False)
