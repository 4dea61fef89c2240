"""Bounded readahead for streamed downloads (a copy of dfs_tpu's
``serve/prefetch.py``).

``download_stream`` fetches chunk batches strictly one at a time: while a
batch's bytes drain to the client socket, the storage plane sits idle,
and while the next batch fetches, the socket sits idle — the two costs
serialize. :class:`BatchPrefetcher` overlaps them: up to ``ahead``
batches beyond the one being consumed are fetched eagerly (as asyncio
tasks), so by the time the writer wants batch *i+1* its bytes are
usually already verified and (when the serving tier's cache is on)
already hot for the next reader of the same file.

Memory stays bounded by construction: at most ``ahead + 1`` batch
results exist at once (a result is dropped as soon as it is handed
over), exactly the contract the non-prefetching path keeps at 1.

Failure order is preserved: a prefetched batch's exception surfaces when
the consumer reaches THAT batch, never earlier — the stream truncates at
the same byte it would have without readahead. ``close()`` cancels
whatever is still in flight (client disconnect mid-download)."""

from __future__ import annotations

import asyncio
from typing import Awaitable, Callable, Sequence


class BatchPrefetcher:
    def __init__(self, batches: Sequence,
                 fetch: Callable[[object], Awaitable],
                 ahead: int, start: int = 0) -> None:
        """``start``: first batch index this prefetcher owns — the
        streamed-download path fetches batch 0 eagerly OUTSIDE the
        prefetcher (failures must surface before the response head, and
        an unstarted body generator must own no in-flight tasks)."""
        self._batches = batches
        self._fetch = fetch
        self._ahead = max(0, int(ahead))
        self._tasks: dict[int, asyncio.Task] = {}
        self._next = max(0, int(start))   # first index not yet scheduled

    @staticmethod
    def _retrieve(task: asyncio.Task) -> None:
        # mark a failed prefetch's exception retrieved: the consumer may
        # abandon the stream before reaching the failing batch, and the
        # loop would otherwise log "exception was never retrieved" at GC
        if not task.cancelled():
            task.exception()

    def _schedule_through(self, upto: int) -> None:
        upto = min(upto, len(self._batches) - 1)
        while self._next <= upto:
            i = self._next
            t = asyncio.create_task(self._fetch(self._batches[i]))
            t.add_done_callback(self._retrieve)
            self._tasks[i] = t
            self._next += 1

    def prime(self) -> None:
        """Start the initial readahead window without awaiting anything
        — called once the consumer is committed to draining the stream
        (batches ``start`` .. ``start + ahead - 1`` begin fetching while
        the batch before ``start`` drains)."""
        self._schedule_through(self._next + self._ahead - 1)

    async def get(self, i: int):
        """Result for batch ``i`` (consumed in order by the stream
        writer); schedules readahead through ``i + ahead``."""
        self._schedule_through(i + self._ahead)
        task = self._tasks.pop(i)
        return await task

    async def close(self) -> None:
        """Cancel outstanding fetches (consumer abandoned the stream)."""
        tasks = list(self._tasks.values())
        self._tasks.clear()
        for t in tasks:
            t.cancel()
        for t in tasks:
            try:
                await t
            # teardown: the consumer abandoned the stream, so a fetch
            # failure has no one left to tell — deliberately silent
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
