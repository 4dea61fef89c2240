"""Placement ring of the port: dfs_tpu's ``RingMap`` (``dfs_tpu/ring/
__init__.py``), both modes, bit for bit.

- **static** (``vnodes == 0``) — the epoch-0 placement every
  default-config cluster runs: cyclic replica sets over the sorted member
  ids (``int(digest[:16], 16) mod N``), an erasure stripe's k + 2 shards
  fanned out consecutively from a base derived from the file id and the
  stripe number (:func:`static_ec_shard_node`).
- **hash** (``vnodes > 0``) — the weighted consistent-hash ring: each
  member projects ``round(weight * vnodes)`` virtual nodes onto a 64-bit
  circle (positions are sha256 of ``"<node_id>:<seed>:<i>"``), and a
  digest's owners are the first ``rf`` distinct members clockwise from its
  point. Adding one member at equal weight moves about 1/(N+1) of the
  digest space; weight 0 (drain) owns nothing.

Every membership change is a new map at ``epoch + 1``; the live state of
one node (current and previous map, the rebalance credits) is
:class:`dfs_tpu_torch.ring.manager.RingManager`. :meth:`RingMap.to_dict`
and :attr:`RingMap.fingerprint` give dfs_tpu's bytes for every map: the
``repoch``/``rfp`` pair that placement-bearing RPCs carry is compared
between port and dfs_tpu nodes of one cluster.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Sequence

from dfs_tpu_torch.utils.hashing import sha256_hex

# leading hex chars of a digest used as its 64-bit ring point — the
# same prefix the legacy static placement hashed, so the two modes
# read one digest the same way
POINT_HEX = 16
# vnodes per unit weight a membership CHANGE promotes a static ring to
# (a static map cannot express minimal movement; the first live
# add/remove/drain switches the cluster to consistent hashing)
DEFAULT_VNODES = 64


def _point(key: str) -> int:
    """64-bit ring position of an arbitrary string key."""
    return int(sha256_hex(key.encode())[:POINT_HEX], 16)


def digest_point(digest: str) -> int:
    """64-bit ring position of a (hex) content digest — its leading 64
    bits, exactly what the static mod-N placement hashed."""
    return int(digest[:POINT_HEX], 16)


# the static (epoch-0) placement math

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
    """One member of the placement ring. ``weight`` scales the share of
    the digest space the member owns (0 = draining: a member that owns
    nothing but is still listed — ``ring status`` shows it on its way
    out); ``vnodes_seed`` salts its vnode positions so a re-added
    member can be given fresh positions if its old arc is pathological
    (never needed in practice; kept 0)."""

    node_id: int
    weight: float = 1.0
    vnodes_seed: int = 0

    def __post_init__(self) -> None:
        if self.node_id < 0:
            raise ValueError("node_id must be >= 0")
        if not (0.0 <= float(self.weight) <= 1024.0):
            raise ValueError("weight must be in [0, 1024]")


@dataclasses.dataclass(frozen=True)
class RingMap:
    """A compact, deterministic placement map (module docstring). The
    vnode table is built lazily once per instance and cached — maps are
    immutable, epoch-versioned values."""

    epoch: int
    members: tuple[RingMember, ...]
    vnodes: int = 0            # 0 = static (legacy) mode

    def __post_init__(self) -> None:
        if self.epoch < 0:
            raise ValueError("epoch must be >= 0")
        if self.vnodes < 0:
            raise ValueError("vnodes must be >= 0")
        ids = [m.node_id for m in self.members]
        if len(set(ids)) != len(ids):
            raise ValueError("duplicate node_id in ring members")
        if self.vnodes == 0 and any(m.weight not in (1, 1.0)
                                    for m in self.members):
            raise ValueError("static mode (vnodes=0) cannot express "
                             "weights — set vnodes > 0")

    # ---- construction ------------------------------------------------ #

    @staticmethod
    def static(node_ids: Sequence[int], epoch: int = 0) -> "RingMap":
        """The static placement as a ring map: equal members, vnodes=0,
        ``owners`` the cyclic mod-N sets."""
        return RingMap(epoch=epoch, vnodes=0, members=tuple(
            RingMember(node_id=i) for i in sorted(node_ids)))

    @staticmethod
    def hashed(weights: dict[int, float], epoch: int,
               vnodes: int = DEFAULT_VNODES) -> "RingMap":
        """A weighted consistent-hash map from ``{node_id: weight}``."""
        return RingMap(epoch=epoch, vnodes=max(1, int(vnodes)),
                       members=tuple(
                           RingMember(node_id=i, weight=float(w))
                           for i, w in sorted(weights.items())))

    # ---- serialization (wire + disk) --------------------------------- #

    def to_dict(self) -> dict:
        return {"epoch": self.epoch, "vnodes": self.vnodes,
                "members": [{"nodeId": m.node_id, "weight": m.weight,
                             "vnodesSeed": m.vnodes_seed}
                            for m in self.members]}

    @staticmethod
    def from_dict(d) -> "RingMap":
        """Parse a wire/disk map; raises ValueError on malformed input
        (the propose_ring op answers an application error, never a
        traceback, on garbage)."""
        if not isinstance(d, dict):
            raise ValueError("ring map must be an object")
        try:
            members = tuple(
                RingMember(node_id=int(m["nodeId"]),
                           weight=float(m.get("weight", 1.0)),
                           vnodes_seed=int(m.get("vnodesSeed", 0)))
                for m in d.get("members", []))
            return RingMap(epoch=int(d["epoch"]),
                           vnodes=int(d.get("vnodes", 0)),
                           members=members)
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"malformed ring map: {e}") from e

    # ---- derived state ----------------------------------------------- #

    @property
    def key(self) -> tuple:
        """Cheap identity for memo keys (ec placement cache)."""
        return (self.epoch, self.vnodes,
                tuple((m.node_id, m.weight, m.vnodes_seed)
                      for m in self.members))

    @property
    def fingerprint(self) -> str:
        """Content hash of the map. Epochs alone cannot totally order
        maps: two admins racing on different nodes both build epoch+1
        from the same base and install DIFFERENT epoch-N maps — without
        a tiebreaker the two halves of the cluster would place by
        different owner maps forever while every epoch check passes.
        (epoch, fingerprint) is the total order every install and every
        wire-level mismatch check compares."""
        cached = self.__dict__.get("_fingerprint")
        if cached is None:
            cached = sha256_hex(repr(self.key).encode())[:16]
            object.__setattr__(self, "_fingerprint", cached)
        return cached

    def active_ids(self) -> list[int]:
        """Sorted ids of members that own digest space (weight > 0)."""
        return sorted(m.node_id for m in self.members if m.weight > 0)

    def member_ids(self) -> list[int]:
        return sorted(m.node_id for m in self.members)

    def weight_of(self, node_id: int) -> float | None:
        for m in self.members:
            if m.node_id == node_id:
                return m.weight
        return None

    def _table(self) -> tuple[list[int], list[int]]:
        """(sorted vnode positions, member id per position) — built once
        per map instance. Positions colliding across members (a ~2^-64
        event per pair) keep the later-sorted entry; owners() walks by
        distinct member so the effect is one vnode's arc."""
        cached = self.__dict__.get("_ring_table")
        if cached is not None:
            return cached
        pts: list[tuple[int, int]] = []
        for m in self.members:
            # every ACTIVE member projects >= 1 vnode: a tiny positive
            # weight rounding to zero would make a member "active" yet
            # own nothing — owners() would silently return fewer than
            # rf nodes and every write would lose a replica with no
            # error anywhere (weight 0 = draining stays at zero)
            n = max(1, int(round(m.weight * self.vnodes))) \
                if m.weight > 0 else 0
            for i in range(n):
                pts.append((_point(f"{m.node_id}:{m.vnodes_seed}:{i}"),
                            m.node_id))
        pts.sort()
        table = ([p for p, _ in pts], [n for _, n in pts])
        # frozen dataclass: cache via __dict__ (not a field — identity
        # and serialization must not see it)
        object.__setattr__(self, "_ring_table", table)
        return table

    # ---- placement --------------------------------------------------- #

    def owners_at(self, point: int, rf: int) -> list[int]:
        """First ``rf`` distinct active members clockwise from
        ``point`` (hash mode only)."""
        pts, ids = self._table()
        if not pts:
            raise ValueError("empty ring")
        out: list[int] = []
        seen: set[int] = set()
        i = bisect.bisect_left(pts, point)
        n = len(pts)
        for k in range(n):
            nid = ids[(i + k) % n]
            if nid not in seen:
                seen.add(nid)
                out.append(nid)
                if len(out) >= rf:
                    break
        return out

    def owners(self, digest: str, rf: int) -> list[int]:
        """Owner node ids of a content digest, primary first. Static
        mode gives the cyclic replica set; hash
        mode walks the weighted ring. ``rf`` beyond the active member
        count is clamped (every active member is an owner)."""
        if self.vnodes == 0:
            return static_replica_set(digest, self.member_ids(), rf)
        active = self.active_ids()
        if not active:
            raise ValueError("empty ring")
        return self.owners_at(digest_point(digest), min(rf, len(active)))

    def owners_key(self, key: str, rf: int) -> list[int]:
        """Owners of an arbitrary string key (EC stripe bases, handoff
        walks) — hash mode only."""
        active = self.active_ids()
        if not active:
            raise ValueError("empty ring")
        return self.owners_at(_point(key), min(rf, len(active)))

    def ec_stripe_nodes(self, file_id: str, stripe: int,
                        nshards: int) -> list[int]:
        """Holder per shard (0..k-1 data, k = P, k+1 = Q) of one erasure
        stripe: ``nshards`` DISTINCT nodes — a single node loss must
        never cost two shards of a stripe (upload enforces
        k+2 <= active members). Static mode keeps the legacy
        consecutive fan-out; hash mode takes the first ``nshards``
        distinct members clockwise from the stripe's key point."""
        if self.vnodes == 0:
            ids = self.member_ids()
            return [static_ec_shard_node(file_id, stripe, j, ids)
                    for j in range(nshards)]
        out = self.owners_key(f"ec:{file_id}:{stripe}", nshards)
        if len(out) < nshards:
            raise ValueError(
                f"stripe needs {nshards} distinct nodes, ring walk "
                f"found {len(out)}")
        return out

    def ec_shard_node(self, file_id: str, stripe: int,
                      shard: int) -> int:
        return self.ec_stripe_nodes(file_id, stripe, shard + 1)[shard]

    def handoff_order(self, pinned: Sequence[int]) -> list[int]:
        """Agreed candidate order for a PINNED (EC) shard: its pinned
        holders, then the rest of the membership in a deterministic
        walk — the write side's sloppy-quorum handoff and the read
        side's candidate scan MUST agree on this order."""
        if self.vnodes == 0:
            return static_handoff_order(pinned, self.member_ids())
        active = self.active_ids()
        if not pinned:
            return list(active)
        walk = self.owners_key(f"pin:{pinned[0]}", len(active))
        return list(dict.fromkeys(list(pinned) + walk))


__all__ = ["DEFAULT_VNODES", "POINT_HEX", "RingMap", "RingMember",
           "digest_point", "static_ec_shard_node",
           "static_handoff_order", "static_replica_set"]
