"""End-to-end request deadlines (a copy of dfs_tpu's ``utils/deadline.py``).

A deadline is born once at the HTTP edge, from the client's
``X-Dfs-Deadline: <seconds>`` header or ``ServeConfig.default_deadline_s``,
and rides a :mod:`contextvars` variable: every downstream hop of the
request (placement tasks, the CAS pool, admission queue waits, RPC calls)
inherits it, because ``asyncio.create_task`` and ``asyncio.to_thread``
copy the context.

The context holds the ABSOLUTE ``time.monotonic()`` expiry. Across a
process boundary it travels as the REMAINING budget in seconds (the
optional ``deadline`` field of the wire header, ``comm/wire.py``), so no
two clocks are ever compared and each hop loses only its flight time.

Expired work never reaches a worker thread: the RPC client refuses to
start or retry a call whose budget is gone, the admission gates evict
queued waiters whose deadline passed (``deadlineShed``), and the node's
dispatch and read path drop dead requests before the CAS pool. With no
deadline set (no header and ``default_deadline_s == 0``, the default)
every check is one ContextVar read returning None.
"""

from __future__ import annotations

import contextvars
import math
import time

# absolute monotonic expiry of the current request, or None (no deadline)
_ctx: contextvars.ContextVar[float | None] = \
    contextvars.ContextVar("dfs_deadline", default=None)

# a budget above this is clamped: it comes off the wire or from a client,
# and hours would disable the plane while it looked enabled
MAX_DEADLINE_S = 3600.0


def activate(remaining_s: float) -> contextvars.Token:
    """Start a deadline ``remaining_s`` seconds from now in the current
    context; returns the token for :func:`restore`. A non-positive budget
    still activates (expired at once): the drop paths are what must fire."""
    remaining_s = min(float(remaining_s), MAX_DEADLINE_S)
    return _ctx.set(time.monotonic() + remaining_s)


def restore(token: contextvars.Token) -> None:
    _ctx.reset(token)


def clear() -> contextvars.Token:
    """Detach the current context from any deadline, for background work
    spawned from inside a request (``create_task`` copies the context)."""
    return _ctx.set(None)


def parse_header(value: str | None) -> float | None:
    """``X-Dfs-Deadline`` value -> remaining seconds, or None when absent
    or malformed (never raises: a bad header must not fail its request)."""
    if not value:
        return None
    try:
        s = float(value.strip())
    except ValueError:
        return None
    if not math.isfinite(s):
        return None
    return s


def parse_wire(field) -> float | None:
    """Wire-header ``deadline`` field -> remaining seconds, or None when
    absent or malformed (older peers never send it)."""
    if isinstance(field, bool) or not isinstance(field, (int, float)):
        return None
    if not math.isfinite(field):
        return None
    return float(field)


def remaining() -> float | None:
    """Seconds left on the active deadline (negative once expired), or
    None when no deadline is set."""
    exp = _ctx.get()
    if exp is None:
        return None
    return exp - time.monotonic()


def expired() -> bool:
    """True iff a deadline is set and has passed."""
    exp = _ctx.get()
    return exp is not None and time.monotonic() >= exp


__all__ = ["MAX_DEADLINE_S", "activate", "clear", "expired", "parse_header",
           "parse_wire", "remaining", "restore"]
