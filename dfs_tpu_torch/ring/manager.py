"""One node's ring: dfs_tpu's ``RingManager`` reduced to its default
configuration — the boot peer list compiled into the static epoch-0
ring (``_compile_epoch0``), which never changes."""

from __future__ import annotations

from dfs_tpu_torch.config import NodeConfig
from dfs_tpu_torch.ring import RingMap


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
