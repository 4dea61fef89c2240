"""Per-key coalescing of concurrent async fetches (single-flight), a copy
of dfs_tpu's ``serve/singleflight.py``.

The memcache "lease" idea (Nishtala et al., NSDI '13) reduced to its
asyncio core: the first caller to ask for a key becomes its *leader* and
does the real work; everyone who asks while that work is in flight awaits
the leader's future instead of issuing a duplicate local-store read or
peer RPC. Content addressing makes this strictly safe — two fetches of a
digest can never return different bytes, so collapsing them changes cost,
not meaning.

Failure discipline (the part that is easy to get wrong): a leader's
failure must reach the waiters that joined THIS flight, and must NOT
poison the key — the entry is removed *before* the exception is set, so
the next request for the key starts a fresh flight immediately. Waiters
await through :func:`asyncio.shield` — a waiter's own cancellation must
not cancel the shared future out from under its siblings.

Two APIs:
- :meth:`SingleFlight.do` — classic wrapper: one key, one coroutine
  factory.
- :meth:`SingleFlight.claim` / :meth:`resolve` / :meth:`reject` — the
  split protocol the node runtime uses to keep its BATCHED gather: a
  reader claims every cold digest it can, fetches them all in ONE
  batched gather (leadership without one-RPC-per-chunk), then resolves
  every claimed digest once that gather returns. Waiters therefore
  share the leader's whole-batch latency — the price of keeping origin
  reads batched.
"""

from __future__ import annotations

import asyncio
from typing import Any, Awaitable, Callable


class SingleFlight:
    def __init__(self) -> None:
        self._inflight: dict[Any, asyncio.Future] = {}
        self.leads = 0        # flights actually executed
        self.coalesced = 0    # calls that joined an existing flight

    def claim(self, key) -> tuple[bool, asyncio.Future | None]:
        """-> (True, None): caller is the leader and MUST later call
        resolve/reject for the key (try/finally discipline); or
        (False, future): another flight is up — ``await wait(future)``."""
        fut = self._inflight.get(key)
        if fut is not None:
            self.coalesced += 1
            return False, fut
        self._inflight[key] = asyncio.get_running_loop().create_future()
        self.leads += 1
        return True, None

    def resolve(self, key, value) -> None:
        fut = self._inflight.pop(key, None)
        if fut is not None and not fut.done():
            fut.set_result(value)

    def reject(self, key, exc: BaseException) -> None:
        """Fail the current flight for ``key``. The entry is popped
        FIRST, so a retry that arrives one tick later leads a fresh
        flight — the failure never sticks to the key."""
        fut = self._inflight.pop(key, None)
        if fut is not None and not fut.done():
            fut.set_exception(exc)
            # mark retrieved: with zero waiters (the common case for a
            # leader that failed before anyone joined) the event loop
            # would otherwise log "exception was never retrieved" at GC
            fut.exception()

    @staticmethod
    async def wait(fut: asyncio.Future):
        """Await a flight's future without being able to cancel it out
        from under the other waiters (a bare ``await fut`` propagates a
        waiter's cancellation INTO the shared future)."""
        return await asyncio.shield(fut)

    async def do(self, key, factory: Callable[[], Awaitable]):
        """Run ``factory()`` under single-flight for ``key``."""
        leader, fut = self.claim(key)
        if not leader:
            assert fut is not None
            return await self.wait(fut)
        try:
            value = await factory()
        except BaseException as e:
            self.reject(key, e)
            raise
        self.resolve(key, value)
        return value

    def stats(self) -> dict:
        return {"inflight": len(self._inflight), "leads": self.leads,
                "coalesced": self.coalesced}
