"""The ``fixed`` host strategy, a copy of dfs_tpu's ``fragmenter/fixed.py``:
the reference's positional split into ``parts`` fragments —
``base = total // parts``, the first ``total % parts`` fragments one byte
longer, zero-byte fragments for tiny files — with a SHA-256 per fragment.
No kernel runs here."""

from __future__ import annotations

from dfs_tpu_torch.fragmenter.base import MaterializingFragmenter
from dfs_tpu_torch.meta.manifest import ChunkRef
from dfs_tpu_torch.utils.hashing import sha256_many_hex


class FixedFragmenter(MaterializingFragmenter):
    name = "fixed"

    def __init__(self, parts: int = 5) -> None:
        if parts < 1:
            raise ValueError("parts must be >= 1")
        self.parts = parts

    def describe(self) -> dict:
        return {"kind": "fixed", "parts": self.parts}

    def chunk(self, data: bytes) -> list[ChunkRef]:
        total = len(data)
        base, rem = divmod(total, self.parts)
        sizes = [base + 1] * rem + [base] * (self.parts - rem)
        pieces, offset = [], 0
        for size in sizes:
            pieces.append(data[offset:offset + size])
            offset += size
        digests = sha256_many_hex(pieces)
        out, offset = [], 0
        for i, (size, digest) in enumerate(zip(sizes, digests)):
            out.append(ChunkRef(index=i, offset=offset, length=size,
                                digest=digest))
            offset += size
        return out
