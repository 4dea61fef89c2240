"""Failure detection: a live/dead view per peer (a copy of dfs_tpu's
``node/health.py``). The data path marks a peer dead when a call exhausts
its retries and skips it at once afterwards; a low-rate probe loop
notices recovery. Every transition is journaled (``peer_down`` /
``peer_up``) when the node has an Observability."""

from __future__ import annotations

import asyncio
import time

from dfs_tpu_torch.comm.rpc import InternalClient, RpcError, RpcUnreachable
from dfs_tpu_torch.config import ClusterConfig
from dfs_tpu_torch.utils.aio import create_logged_task
from dfs_tpu_torch.utils.logging import get_logger


class HealthMonitor:
    def __init__(self, cluster: ClusterConfig, self_id: int,
                 client: InternalClient,
                 probe_interval_s: float = 5.0, obs=None) -> None:
        self.cluster = cluster
        self.self_id = self_id
        self.client = client
        self.probe_interval_s = probe_interval_s
        self.log = get_logger("health", self_id)
        self._obs = obs
        # optimistic start: every peer alive until a call says otherwise
        self._alive: dict[int, bool] = {
            p.node_id: True for p in cluster.peers if p.node_id != self_id}
        self._last_change: dict[int, float] = {}
        self._task: asyncio.Task | None = None

    def is_alive(self, node_id: int) -> bool:
        return self._alive.get(node_id, True)

    def mark_dead(self, node_id: int) -> None:
        if self._alive.get(node_id):
            self._alive[node_id] = False
            self._last_change[node_id] = time.monotonic()
            self.log.warning("peer %d marked dead", node_id)
            if self._obs is not None:
                self._obs.event("peer_down", peer=node_id)

    def mark_alive(self, node_id: int) -> None:
        if not self._alive.get(node_id, True):
            self._alive[node_id] = True
            self._last_change[node_id] = time.monotonic()
            self.log.info("peer %d back alive", node_id)
            if self._obs is not None:
                self._obs.event("peer_up", peer=node_id)

    def snapshot(self) -> dict[str, bool]:
        return {str(k): v for k, v in sorted(self._alive.items())}

    async def probe_once(self) -> None:
        async def probe(peer) -> None:
            try:
                await self.client.health(peer)
                self.mark_alive(peer.node_id)
            except RpcUnreachable:
                self.mark_dead(peer.node_id)
            except RpcError as e:
                # the peer answered: liveness evidence, and the error must
                # not escape and end the probe loop
                self.mark_alive(peer.node_id)
                self.log.warning("health probe of node %d answered an "
                                 "error: %s", peer.node_id, e)

        await asyncio.gather(*(probe(p) for p in self.cluster.peers
                               if p.node_id != self.self_id))

    def start(self) -> None:
        async def loop() -> None:
            while True:
                await asyncio.sleep(self.probe_interval_s)
                await self.probe_once()

        self._task = create_logged_task(loop(), self.log, "health-probe")

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
