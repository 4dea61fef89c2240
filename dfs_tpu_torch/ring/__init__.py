"""Placement ring of the port: dfs_tpu's STATIC epoch-0 ring
(``dfs_tpu/ring/__init__.py``, ``vnodes == 0``), the placement every
default-config cluster runs.

A chunk's owners are a cyclic replica set over the sorted member ids:
the primary is ``int(digest[:16], 16) mod N`` and the others follow
cyclically. An erasure stripe's k + 2 shards fan out consecutively from a
base derived from the file id and the stripe number
(:func:`static_ec_shard_node`), bit for bit as dfs_tpu places them, so
either kind of node finds the other's shards. :attr:`RingMap.fingerprint` is computed exactly as dfs_tpu
computes it, so the ``repoch``/``rfp`` pair that placement-bearing RPCs
carry matches between a port node and a dfs_tpu node over the same peers
— a mismatch would make every ``store_chunks`` of a mixed cluster fail.
The weighted consistent-hash mode and live membership changes are not
ported.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from dfs_tpu_torch.utils.hashing import sha256_hex

# leading hex chars of a digest used as its 64-bit ring point
POINT_HEX = 16


def digest_point(digest: str) -> int:
    """64-bit ring position of a hex content digest: its leading 64 bits."""
    return int(digest[:POINT_HEX], 16)


def static_replica_set(digest: str, node_ids: list[int],
                       rf: int) -> list[int]:
    if not node_ids:
        raise ValueError("empty cluster")
    rf = min(rf, len(node_ids))
    start = digest_point(digest) % len(node_ids)
    return [node_ids[(start + j) % len(node_ids)] for j in range(rf)]


def static_ec_shard_node(file_id: str, stripe: int, shard: int,
                         node_ids: list[int]) -> int:
    if not node_ids:
        raise ValueError("empty cluster")
    base = (int(file_id[:16], 16) + stripe * 2654435761) % len(node_ids)
    return node_ids[(base + shard) % len(node_ids)]


def static_handoff_order(pinned: Sequence[int],
                         node_ids: list[int]) -> list[int]:
    if not pinned:
        return list(node_ids)
    start = node_ids.index(pinned[0]) if pinned[0] in node_ids else 0
    ring = [node_ids[(start + j) % len(node_ids)]
            for j in range(len(node_ids))]
    return list(dict.fromkeys(list(pinned) + ring))


@dataclasses.dataclass(frozen=True)
class RingMember:
    node_id: int
    weight: float = 1.0
    vnodes_seed: int = 0


@dataclasses.dataclass(frozen=True)
class RingMap:
    """A static placement map: equal members, ``vnodes == 0``."""

    epoch: int
    members: tuple[RingMember, ...]
    vnodes: int = 0

    def __post_init__(self) -> None:
        if self.epoch < 0:
            raise ValueError("epoch must be >= 0")
        if self.vnodes != 0:
            raise ValueError("only the static ring (vnodes=0) is ported")
        ids = [m.node_id for m in self.members]
        if len(set(ids)) != len(ids):
            raise ValueError("duplicate node_id in ring members")

    @staticmethod
    def static(node_ids: Sequence[int], epoch: int = 0) -> "RingMap":
        return RingMap(epoch=epoch, vnodes=0, members=tuple(
            RingMember(node_id=i) for i in sorted(node_ids)))

    def to_dict(self) -> dict:
        return {"epoch": self.epoch, "vnodes": self.vnodes,
                "members": [{"nodeId": m.node_id, "weight": m.weight,
                             "vnodesSeed": m.vnodes_seed}
                            for m in self.members]}

    @property
    def key(self) -> tuple:
        return (self.epoch, self.vnodes,
                tuple((m.node_id, m.weight, m.vnodes_seed)
                      for m in self.members))

    @property
    def fingerprint(self) -> str:
        """Content hash of the map — dfs_tpu's ``RingMap.fingerprint``:
        sha256 of ``repr(key)``, 16 hex chars."""
        return sha256_hex(repr(self.key).encode())[:16]

    def member_ids(self) -> list[int]:
        return sorted(m.node_id for m in self.members)

    def owners(self, digest: str, rf: int) -> list[int]:
        """Owner node ids of a content digest, primary first."""
        return static_replica_set(digest, self.member_ids(), rf)

    def ec_stripe_nodes(self, file_id: str, stripe: int,
                        nshards: int) -> list[int]:
        """Holder per shard (0..k-1 data, k = P, k+1 = Q) of one erasure
        stripe: consecutive members from the stripe's base, all distinct
        while ``nshards`` <= the member count (upload enforces k + 2 <=
        members). Over every member id, dead ones included."""
        ids = self.member_ids()
        return [static_ec_shard_node(file_id, stripe, j, ids)
                for j in range(nshards)]

    def ec_shard_node(self, file_id: str, stripe: int, shard: int) -> int:
        return self.ec_stripe_nodes(file_id, stripe, shard + 1)[shard]

    def handoff_order(self, pinned: Sequence[int]) -> list[int]:
        """Pinned holders, then the rest of the membership cyclically from
        the first pinned holder."""
        return static_handoff_order(pinned, self.member_ids())


__all__ = ["POINT_HEX", "RingMap", "RingMember", "digest_point",
           "static_ec_shard_node", "static_handoff_order",
           "static_replica_set"]
