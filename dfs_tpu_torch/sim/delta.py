"""Binary chunk delta codec: the on-disk ``base-digest + patch`` form of a
similar chunk (a copy of dfs_tpu's ``sim/delta.py``; the format is shared
byte for byte, so either package reads the other's deltas).

A delta file replaces the raw chunk file in the CAS: same digest name,
another tree (``deltas/<dd>/<digest>`` beside ``chunks/<dd>/``), and its
payload reconstructs the exact raw bytes; the reader verifies
sha256(reconstructed) == digest before serving
(:func:`dfs_tpu_torch.utils.hashing.sha256_hex`, in ``store/cas.py``).

Format ``DSD1`` (all integers big-endian):

    magic      4  b"DSD1"
    version    1  0x01
    base       32 raw sha256 of the base chunk
    out_len    4  length of the reconstructed chunk
    ops        *  sequence of:
                    0x01 <u32 base_off> <u32 len>      copy from base
                    0x02 <u32 len> <len bytes>         literal

The encoder is anchor-block greedy: both buffers split at
content-defined anchors (a 4-byte window condition, ~64-byte blocks),
target blocks look up base blocks BY CONTENT, and every hit extends
byte-wise in both directions — so an insertion or edit resynchronizes
at the next anchor and long unchanged runs become one copy op. Pure
host code: it runs on the CAS worker threads for chunks the sketch
lookup already nominated (bounded candidates).
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC = b"DSD1"
VERSION = 1
_HDR = struct.Struct(">4sB32sI")      # magic, version, base raw, out_len
HEADER_BYTES = _HDR.size
_OP_COPY = 1
_OP_LIT = 2
_ANCHOR_MASK = 63          # 4-byte window % 64 == 0 -> ~64-byte blocks
_MIN_COPY = 12             # a copy op costs 9 bytes; shorter runs stay
                           # literal (and remain extendable)


def _anchors(data: bytes) -> np.ndarray:
    """Content-defined block starts for ``data`` (always includes 0)."""
    n = len(data)
    if n < 8:
        return np.zeros(1, dtype=np.int64)
    b = np.frombuffer(data, dtype=np.uint8).astype(np.uint32)
    v = (b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8) | b[3:]
    cut = np.flatnonzero((v & _ANCHOR_MASK) == 0) + 4
    return np.unique(np.concatenate(([0], cut[cut < n])))


def _blocks(data: bytes) -> list[tuple[int, int]]:
    starts = _anchors(data)
    ends = np.append(starts[1:], len(data))
    return [(int(o), int(e - o)) for o, e in zip(starts, ends) if e > o]


def _match_len(a: bytes, ao: int, b: bytes, bo: int, cap: int) -> int:
    """Longest common run of ``a[ao:]`` vs ``b[bo:]``, at most ``cap``."""
    n = min(len(a) - ao, len(b) - bo, cap)
    if n <= 0:
        return 0
    av = np.frombuffer(a, dtype=np.uint8, count=n, offset=ao)
    bv = np.frombuffer(b, dtype=np.uint8, count=n, offset=bo)
    neq = av != bv
    return int(np.argmax(neq)) if neq.any() else n


def encode_ops(base: bytes, target: bytes) -> bytes:
    """The op stream turning ``base`` into ``target`` (header excluded)."""
    table: dict[bytes, int] = {}
    for o, ln in _blocks(base):
        table.setdefault(base[o:o + ln], o)
    out = bytearray()
    lit_start = 0

    def flush_literal(upto: int) -> None:
        pos = lit_start
        while pos < upto:
            ln = min(upto - pos, 0xFFFFFFFF)
            out.append(_OP_LIT)
            out.extend(struct.pack(">I", ln))    # .extend, not +=: an
            out.extend(target[pos:pos + ln])     # augmented assign would
            pos += ln                            # make ``out`` local here

    cursor = 0
    for o, ln in _blocks(target):
        if o < cursor:
            continue
        p = table.get(target[o:o + ln])
        if p is None:
            continue
        # extend forward past the block, and backward into the pending
        # literal — edits resynchronize at anchors, runs grow byte-wise
        fwd = _match_len(base, p + ln, target, o + ln,
                         min(len(base), len(target)))
        back = 0
        while (o - back > lit_start and p - back > 0
               and base[p - back - 1] == target[o - back - 1]):
            back += 1
        total = back + ln + fwd
        if total < _MIN_COPY:
            continue
        flush_literal(o - back)
        out.append(_OP_COPY)
        out += struct.pack(">II", p - back, total)
        cursor = o + ln + fwd
        lit_start = cursor
    flush_literal(len(target))
    return bytes(out)


def make_delta(base_digest: str, base: bytes, target: bytes) -> bytes:
    """Full delta file body for ``target`` against ``base``."""
    return _HDR.pack(MAGIC, VERSION, bytes.fromhex(base_digest),
                     len(target)) + encode_ops(base, target)


def is_delta(blob: bytes) -> bool:
    return len(blob) >= HEADER_BYTES and blob[:4] == MAGIC


def parse_header(blob: bytes) -> tuple[str, int]:
    """-> (base digest hex, reconstructed length). Raises ValueError on
    a blob that is not a ``DSD1`` delta."""
    if len(blob) < HEADER_BYTES:
        raise ValueError("short delta header")
    magic, ver, base, out_len = _HDR.unpack_from(blob)
    if magic != MAGIC or ver != VERSION:
        raise ValueError("not a DSD1 delta")
    return base.hex(), out_len


def apply_delta(blob: bytes, base: bytes) -> bytes:
    """Reconstruct the raw chunk from a delta body + its base bytes.
    Structural damage raises ValueError — the caller treats it exactly
    like a corrupt raw chunk (delete + re-replicate)."""
    _, out_len = parse_header(blob)
    out = bytearray()
    pos = HEADER_BYTES
    n = len(blob)
    while pos < n:
        kind = blob[pos]
        pos += 1
        if kind == _OP_COPY:
            if pos + 8 > n:
                raise ValueError("torn copy op")
            off, ln = struct.unpack_from(">II", blob, pos)
            pos += 8
            if off + ln > len(base):
                raise ValueError("copy op past base end")
            out += base[off:off + ln]
        elif kind == _OP_LIT:
            if pos + 4 > n:
                raise ValueError("torn literal op")
            (ln,) = struct.unpack_from(">I", blob, pos)
            pos += 4
            if pos + ln > n:
                raise ValueError("torn literal payload")
            out += blob[pos:pos + ln]
            pos += ln
        else:
            raise ValueError(f"unknown delta op {kind}")
    if len(out) != out_len:
        raise ValueError(
            f"delta reconstructed {len(out)} bytes, header says {out_len}")
    return bytes(out)
