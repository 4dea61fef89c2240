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


def is_hex_digest(s: str) -> bool:
    """True iff ``s`` is a 64-char lowercase-hex SHA-256 digest — the only
    legal file/chunk id format."""
    return len(s) == 64 and set(s) <= _HEX


def next_pow2(x: int) -> int:
    """Smallest power of two >= max(1, x)."""
    return 1 << (max(1, x) - 1).bit_length()
