"""Chunk placement over a static membership list (thin shims over
:mod:`dfs_tpu_torch.ring`, as dfs_tpu's ``node/placement.py`` is): the
primary owner of a digest is ``int(digest[:16], 16) mod N`` over the
sorted node ids and the other replicas follow cyclically; an erasure
stripe's shards fan out from a base derived from (file id, stripe)."""

from __future__ import annotations

from typing import Sequence

from dfs_tpu_torch.ring import (static_ec_shard_node, static_handoff_order,
                                static_replica_set)


def replica_set(digest: str, node_ids: list[int], rf: int) -> list[int]:
    """Owner node ids of a chunk digest, primary first."""
    return static_replica_set(digest, node_ids, rf)


def ec_shard_node(file_id: str, stripe: int, shard: int,
                  node_ids: list[int]) -> int:
    """Holder of shard ``shard`` (0..k-1 data, k = P, k+1 = Q) of erasure
    stripe ``stripe``: the stripe's base is ``int(file_id[:16], 16) +
    stripe * 2654435761`` mod N and its shards follow consecutively, so
    the k + 2 holders are distinct whenever N >= k + 2 and a single node
    loss costs a stripe at most one shard."""
    return static_ec_shard_node(file_id, stripe, shard, node_ids)


def handoff_order(pinned: Sequence[int], node_ids: list[int]) -> list[int]:
    """Pinned holders, then the membership cyclically from the first."""
    return static_handoff_order(pinned, node_ids)
