"""Small asyncio helpers of the node runtime (a copy of dfs_tpu's
``utils/aio.py``)."""

from __future__ import annotations

import asyncio


def create_logged_task(coro, log, what: str) -> asyncio.Task:
    """``asyncio.create_task`` plus a done-callback that logs an
    unexpected death. The caller must keep the returned task: the loop
    holds only weak references. Cancellation is not logged — it is how
    background loops are stopped."""
    task = asyncio.create_task(coro)

    def _done(t: asyncio.Task) -> None:
        if t.cancelled():
            return
        exc = t.exception()
        if exc is not None:
            log.error("background task %r died unexpectedly: %s: %s",
                      what, type(exc).__name__, exc)

    task.add_done_callback(_done)
    return task


async def gather_abort_siblings(*coros):
    """``gather()`` that cancels the surviving coroutines when one raises:
    an error that aborts one leg of concurrent work (a local disk failure
    in a placement batch) also stops the traffic gathered with it."""
    tasks = [asyncio.ensure_future(c) for c in coros]
    try:
        return await asyncio.gather(*tasks)
    except BaseException:
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        raise
