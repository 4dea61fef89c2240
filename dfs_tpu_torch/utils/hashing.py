"""Host hashing helpers: the system-wide content address is the lowercase
hex SHA-256 of the bytes (fileId = sha256(file), chunk id = sha256(chunk))."""

from __future__ import annotations

import hashlib

import numpy as np

_HEX = frozenset("0123456789abcdef")


def sha256_hex(data: bytes | bytearray | memoryview | np.ndarray) -> str:
    """Lowercase-hex SHA-256."""
    if isinstance(data, np.ndarray):
        data = memoryview(np.ascontiguousarray(data)).cast("B")
    return hashlib.sha256(data).hexdigest()


def sha256_many_hex(chunks) -> list[str]:
    """Lowercase-hex SHA-256 of each buffer of a batch."""
    return [hashlib.sha256(c).hexdigest() for c in chunks]


def sha256_new() -> "hashlib._Hash":
    """Fresh incremental SHA-256 hasher for whole-stream ids."""
    return hashlib.sha256()


def gear_table(seed: int = 0x9E3779B9) -> np.ndarray:
    """The 256-entry uint32 Gear table of the ``cdc`` strategy, from
    splitmix64 — dfs_tpu's table for the same seed, entry for entry."""
    out = np.empty(256, dtype=np.uint64)
    x = np.uint64(seed & 0xFFFFFFFFFFFFFFFF)
    golden = np.uint64(0x9E3779B97F4A7C15)
    m1 = np.uint64(0xBF58476D1CE4E5B9)
    m2 = np.uint64(0x94D049BB133111EB)
    with np.errstate(over="ignore"):
        for i in range(256):
            x = x + golden
            z = x
            z = (z ^ (z >> np.uint64(30))) * m1
            z = (z ^ (z >> np.uint64(27))) * m2
            z = z ^ (z >> np.uint64(31))
            out[i] = z
    return (out & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def is_hex_digest(s: str) -> bool:
    """True iff ``s`` is a 64-char lowercase-hex SHA-256 digest — the only
    legal file/chunk id format."""
    return len(s) == 64 and set(s) <= _HEX


def next_pow2(x: int) -> int:
    """Smallest power of two >= max(1, x)."""
    return 1 << (max(1, x) - 1).bit_length()
