"""One node's ring: dfs_tpu's ``RingManager`` reduced to its default
configuration — the boot peer list compiled into the static epoch-0
ring (``_compile_epoch0``), which never changes — and its ``ByteRate``
credit bucket, which the tiering plane meters demotion with."""

from __future__ import annotations

import asyncio
import time

from dfs_tpu_torch.config import NodeConfig
from dfs_tpu_torch.ring import RingMap


class ByteRate:
    """Token bucket metering payload bytes per second, a copy of dfs_tpu's.
    ``acquire`` is async — it sleeps until the bucket can cover the
    request — and returns the seconds it stalled so the caller can
    attribute the wait. ``rate == 0`` disables the gate.

    One oversized request (larger than a whole second of credit) is
    admitted by letting the deficit go negative: it pre-charges future
    seconds, so the long-run rate still holds."""

    def __init__(self, rate_bytes_per_s: int) -> None:
        self.rate = max(0, int(rate_bytes_per_s))
        self._avail = float(self.rate)
        self._last = time.monotonic()

    async def acquire(self, n: int) -> float:
        if self.rate <= 0 or n <= 0:
            return 0.0
        stalled = 0.0
        # a request larger than one full bucket admits at full-bucket
        # (overdrawing into the future); ordinary requests wait for their
        # full byte count
        needed = min(float(n), float(self.rate))
        while True:
            now = time.monotonic()
            self._avail = min(float(self.rate),
                              self._avail + (now - self._last) * self.rate)
            self._last = now
            if self._avail >= needed:
                self._avail -= n
                return stalled
            wait = min(1.0, (needed - self._avail) / self.rate)
            stalled += wait
            await asyncio.sleep(wait)


class RingManager:
    def __init__(self, cfg: NodeConfig) -> None:
        self.current: RingMap = RingMap.static(
            [p.node_id for p in cfg.cluster.peers], epoch=0)

    @property
    def epoch(self) -> int:
        return self.current.epoch

    def read_candidates(self, digest: str, rf: int) -> list[int]:
        """Where a read looks first: the digest's owners."""
        return self.current.owners(digest, rf)

    def stats(self) -> dict:
        """``/metrics`` ``ring``: the epoch-0 static ring."""
        return {"epoch": self.epoch, "mode": "static",
                "active": self.current.member_ids(),
                "fingerprint": self.current.fingerprint}
