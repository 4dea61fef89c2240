"""Chunk placement over a static membership list (thin shims over
:mod:`dfs_tpu_torch.ring`, as dfs_tpu's ``node/placement.py`` is): the
primary owner of a digest is ``int(digest[:16], 16) mod N`` over the
sorted node ids and the other replicas follow cyclically."""

from __future__ import annotations

from typing import Sequence

from dfs_tpu_torch.ring import static_handoff_order, static_replica_set


def replica_set(digest: str, node_ids: list[int], rf: int) -> list[int]:
    """Owner node ids of a chunk digest, primary first."""
    return static_replica_set(digest, node_ids, rf)


def handoff_order(pinned: Sequence[int], node_ids: list[int]) -> list[int]:
    """Pinned holders, then the membership cyclically from the first."""
    return static_handoff_order(pinned, node_ids)
