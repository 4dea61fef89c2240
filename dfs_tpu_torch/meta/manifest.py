"""Manifest v2 — chunk-granular file metadata.

The reference manifest is ``{fileId, originalName, totalFragments}`` built by
string concatenation (StorageNode.java:620-626) and parsed with ``indexOf``
hacks (StorageNode.java:657-773). Two deliberate upgrades (SURVEY.md §2.5(7)):

1. per-chunk SHA-256 digests + (offset, length) are stored in the manifest, so
   download can verify every chunk independently and the dedup index can
   address chunks by content — the reference computes fragment hashes
   (StorageNode.java:159) but throws them away;
2. serialization is real JSON (stdlib), not a hand-rolled codec that breaks on
   escaped quotes (reference defect, SURVEY.md S14).
"""

from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass(frozen=True)
class ChunkRef:
    """One content-addressed chunk of a file."""

    index: int
    offset: int
    length: int
    digest: str  # lowercase-hex sha256 of the chunk bytes


@dataclasses.dataclass(frozen=True)
class StripeRef:
    """Parity of one erasure stripe: P/Q chunk digests + the padded
    shard length (= the longest data chunk in the stripe; parity chunks
    are exactly this long)."""

    p: str
    q: str
    shard_len: int


@dataclasses.dataclass(frozen=True)
class EcInfo:
    """Erasure-coding layout (ops.ec P+Q codec): data chunks are grouped
    into stripes of ``k`` by :func:`ec_stripe_groups` — a deterministic
    function of the chunk table, so no membership list is stored — and
    each stripe gains two parity chunks. EC files store data at a single
    copy: the parity IS the redundancy (any 2 of a stripe's k+2 shards
    may be lost), placed on distinct nodes by
    node.placement.ec_shard_node."""

    k: int
    stripes: tuple[StripeRef, ...]


def stripe_shard_len(grp: tuple[ChunkRef, ...]) -> int:
    """Padded shard length of one stripe: its longest chunk rounded up
    to 4 bytes (the u32 lanes the P/Q kernel works in). The ONE place
    this invariant lives — the manifest validator and the upload encoder
    must agree byte-for-byte."""
    return -(-max(c.length for c in grp) // 4) * 4


def ec_stripe_groups(chunks: tuple[ChunkRef, ...], k: int
                     ) -> list[tuple[ChunkRef, ...]]:
    """Stripe membership: chunks sorted by (length, index), grouped k at
    a time. Parity shards pad to the LONGEST chunk of their stripe, so
    grouping similar-length chunks together keeps the storage overhead
    at ~(k+2)/k — grouping in file order measured >2x on CDC chunk-size
    distributions (padding to the stripe max swamped the parity). The
    sort is total (index tiebreak), so every node derives identical
    stripes from the manifest alone."""
    order = sorted(chunks, key=lambda c: (c.length, c.index))
    return [tuple(order[s * k:(s + 1) * k])
            for s in range(-(-len(order) // k) if order else 0)]


@dataclasses.dataclass(frozen=True)
class Manifest:
    """Whole-file metadata. ``file_id`` remains sha256(file bytes) exactly as
    in the reference (StorageNode.java:127), preserving whole-file dedup."""

    file_id: str
    name: str
    size: int
    fragmenter: str               # "fixed" | "cdc" | "cdc-tpu"
    chunks: tuple[ChunkRef, ...]
    ec: EcInfo | None = None
    tier: str | None = None       # "cold" = demoted to EC cold storage
                                  # (r20); None = replicated hot tier.
                                  # The manifest carries the CLUSTER
                                  # truth — the per-node index tier bit
                                  # is a best-effort mirror.

    def __post_init__(self) -> None:
        covered = 0
        for i, c in enumerate(self.chunks):
            if c.index != i:
                raise ValueError(f"chunk index mismatch at {i}")
            if c.offset != covered:
                raise ValueError(f"chunk offset gap at {i}")
            covered += c.length
        if covered != self.size:
            raise ValueError(f"chunks cover {covered} bytes, size is {self.size}")
        if self.ec is not None:
            k = self.ec.k
            if k < 1:
                raise ValueError("ec.k must be >= 1")
            groups = ec_stripe_groups(self.chunks, k)
            if len(self.ec.stripes) != len(groups):
                raise ValueError(
                    f"ec has {len(self.ec.stripes)} stripes, "
                    f"{len(self.chunks)} chunks at k={k} need "
                    f"{len(groups)}")
            for s, (st, grp) in enumerate(zip(self.ec.stripes, groups)):
                pad = stripe_shard_len(grp)
                if st.shard_len != pad:
                    raise ValueError(
                        f"stripe {s} shard_len {st.shard_len} != {pad}")

    @property
    def total_chunks(self) -> int:
        return len(self.chunks)

    def digests(self) -> list[str]:
        return [c.digest for c in self.chunks]

    def all_digests(self) -> list[str]:
        """Data digests plus erasure-parity digests — the full set of
        chunks this manifest keeps alive (GC's live set MUST use this:
        sweeping parity as orphaned would silently strip an EC file's
        redundancy)."""
        out = self.digests()
        if self.ec is not None:
            for st in self.ec.stripes:
                out.append(st.p)
                out.append(st.q)
        return out

    def to_json(self) -> str:
        # direct dicts, not dataclasses.asdict: asdict recurses through
        # every field generically and measured ~45 python calls per
        # ChunkRef — serializing a 64 MiB manifest cost more than
        # hashing its chunks (and finalize serializes for every peer)
        doc = {
            "version": 2,
            "fileId": self.file_id,
            "originalName": self.name,
            "size": self.size,
            "fragmenter": self.fragmenter,
            "totalFragments": len(self.chunks),  # reference-compat field name
            "chunks": [{"index": c.index, "offset": c.offset,
                        "length": c.length, "digest": c.digest}
                       for c in self.chunks],
        }
        if self.ec is not None:
            doc["ec"] = {"k": self.ec.k,
                         "stripes": [{"p": s.p, "q": s.q,
                                      "shard_len": s.shard_len}
                                     for s in self.ec.stripes]}
        if self.tier is not None:
            # emitted only when set: an untiered manifest serializes
            # byte-identically to a pre-r20 build
            doc["tier"] = self.tier
        return json.dumps(doc, indent=None, separators=(",", ":"))

    @staticmethod
    def from_json(text: str | bytes) -> "Manifest":
        d = json.loads(text)
        ec = None
        if "ec" in d:
            ec = EcInfo(k=d["ec"]["k"],
                        stripes=tuple(StripeRef(**s)
                                      for s in d["ec"]["stripes"]))
        return Manifest(
            file_id=d["fileId"],
            name=d.get("originalName", d["fileId"]),
            size=d["size"],
            fragmenter=d.get("fragmenter", "fixed"),
            chunks=tuple(ChunkRef(**c) for c in d["chunks"]),
            ec=ec,
            tier=d.get("tier"),
        )
