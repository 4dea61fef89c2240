"""HPACK (RFC 7541) header compression without Huffman coding: the header
blocks of the sidecar's HTTP/2 stack (:mod:`dfs_tpu_torch.sidecar.h2`).

- :class:`Decoder` reads every representation a peer may send: indexed
  fields, literals with incremental indexing, without indexing and never
  indexed (each with an indexed or a new name), and dynamic-table size
  updates. Its dynamic table counts ``len(name) + len(value) + 32`` bytes
  an entry and evicts the oldest entries past its size, which the peer
  may lower with a size update but never raise above the limit this end
  advertised (``SETTINGS_HEADER_TABLE_SIZE``, 4096 by default). grpcio's
  encoder indexes every new field and sends later calls as indices into
  that table.
- A string with the H (Huffman) bit set raises :class:`HpackError`: this
  stack has no Huffman table, and the HTTP/2 layer answers with
  ``GOAWAY(COMPRESSION_ERROR)`` naming it.
- :class:`Encoder` emits only static-table indexed fields and literals
  without indexing, which is always legal for a sender and needs no
  state shared with the peer.

Names and values are ``str`` decoded as Latin-1 (HTTP field bytes map one
to one).
"""

from __future__ import annotations

from collections import deque

# RFC 7541 Appendix A; index 1 is the first entry
STATIC_TABLE: tuple[tuple[str, str], ...] = (
    (":authority", ""), (":method", "GET"), (":method", "POST"),
    (":path", "/"), (":path", "/index.html"), (":scheme", "http"),
    (":scheme", "https"), (":status", "200"), (":status", "204"),
    (":status", "206"), (":status", "304"), (":status", "400"),
    (":status", "404"), (":status", "500"), ("accept-charset", ""),
    ("accept-encoding", "gzip, deflate"), ("accept-language", ""),
    ("accept-ranges", ""), ("accept", ""),
    ("access-control-allow-origin", ""), ("age", ""), ("allow", ""),
    ("authorization", ""), ("cache-control", ""),
    ("content-disposition", ""), ("content-encoding", ""),
    ("content-language", ""), ("content-length", ""),
    ("content-location", ""), ("content-range", ""), ("content-type", ""),
    ("cookie", ""), ("date", ""), ("etag", ""), ("expect", ""),
    ("expires", ""), ("from", ""), ("host", ""), ("if-match", ""),
    ("if-modified-since", ""), ("if-none-match", ""), ("if-range", ""),
    ("if-unmodified-since", ""), ("last-modified", ""), ("link", ""),
    ("location", ""), ("max-forwards", ""), ("proxy-authenticate", ""),
    ("proxy-authorization", ""), ("range", ""), ("referer", ""),
    ("refresh", ""), ("retry-after", ""), ("server", ""),
    ("set-cookie", ""), ("strict-transport-security", ""),
    ("transfer-encoding", ""), ("user-agent", ""), ("vary", ""),
    ("via", ""), ("www-authenticate", ""))

_STATIC_FIELD = {f: i + 1 for i, f in reversed(list(enumerate(STATIC_TABLE)))}
_STATIC_NAME = {n: i + 1 for i, (n, _) in reversed(list(enumerate(
    STATIC_TABLE)))}
DEFAULT_TABLE_SIZE = 4096
ENTRY_OVERHEAD = 32


class HpackError(ValueError):
    """A header block this decoder refuses: a connection error of type
    COMPRESSION_ERROR in HTTP/2."""


def encode_int(value: int, prefix_bits: int, first: int = 0) -> bytes:
    """RFC 7541 5.1 prefix integer; ``first`` carries the bits above the
    prefix in the first byte."""
    limit = (1 << prefix_bits) - 1
    if value < limit:
        return bytes([first | value])
    out = bytearray([first | limit])
    value -= limit
    while value >= 128:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def decode_int(data: bytes, pos: int, prefix_bits: int) -> tuple[int, int]:
    """(value, position after it) of the prefix integer at ``pos``."""
    if pos >= len(data):
        raise HpackError("truncated integer")
    limit = (1 << prefix_bits) - 1
    value = data[pos] & limit
    pos += 1
    if value < limit:
        return value, pos
    shift = 0
    while True:
        if pos >= len(data):
            raise HpackError("truncated integer")
        b = data[pos]
        pos += 1
        value += (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return value, pos
        if shift > 56:
            raise HpackError("integer overflow")


def _encode_str(s: str) -> bytes:
    raw = s.encode("latin-1")
    return encode_int(len(raw), 7) + raw       # H bit clear


def _decode_str(data: bytes, pos: int) -> tuple[str, int]:
    if pos >= len(data):
        raise HpackError("truncated string")
    if data[pos] & 0x80:
        raise HpackError("Huffman-coded string literal (this decoder has "
                         "no Huffman table; send plain literals)")
    n, pos = decode_int(data, pos, 7)
    if pos + n > len(data):
        raise HpackError("truncated string")
    return bytes(data[pos:pos + n]).decode("latin-1"), pos + n


class Decoder:
    """Header-block decoder of one connection direction; blocks must be
    decoded in the order they arrive (the dynamic table is shared)."""

    def __init__(self, max_table_size: int = DEFAULT_TABLE_SIZE) -> None:
        self.settings_limit = max_table_size   # what this end advertised
        self.max_size = max_table_size         # current, <= the limit
        self.size = 0
        self.table: deque[tuple[str, str]] = deque()   # newest first

    def _add(self, name: str, value: str) -> None:
        # Latin-1 maps bytes to characters one to one: len() is the size
        self.table.appendleft((name, value))
        self.size += len(name) + len(value) + ENTRY_OVERHEAD
        self._evict()

    def _evict(self) -> None:
        while self.size > self.max_size and self.table:
            n, v = self.table.pop()
            self.size -= len(n) + len(v) + ENTRY_OVERHEAD

    def _field(self, index: int) -> tuple[str, str]:
        if index == 0:
            raise HpackError("index 0")
        if index <= len(STATIC_TABLE):
            return STATIC_TABLE[index - 1]
        d = index - len(STATIC_TABLE) - 1
        if d >= len(self.table):
            raise HpackError(f"index {index} past the dynamic table "
                             f"({len(self.table)} entries)")
        return self.table[d]

    def decode(self, block: bytes) -> list[tuple[str, str]]:
        out: list[tuple[str, str]] = []
        pos = 0
        n = len(block)
        while pos < n:
            b = block[pos]
            if b & 0x80:                              # indexed field
                idx, pos = decode_int(block, pos, 7)
                out.append(self._field(idx))
            elif b & 0x40:                            # incremental indexing
                idx, pos = decode_int(block, pos, 6)
                if idx:
                    name = self._field(idx)[0]
                else:
                    name, pos = _decode_str(block, pos)
                value, pos = _decode_str(block, pos)
                self._add(name, value)
                out.append((name, value))
            elif b & 0x20:                            # table size update
                size, pos = decode_int(block, pos, 5)
                if size > self.settings_limit:
                    raise HpackError(f"table size update {size} above "
                                     f"the limit {self.settings_limit}")
                self.max_size = size
                self._evict()
            else:                     # without indexing / never indexed
                idx, pos = decode_int(block, pos, 4)
                if idx:
                    name = self._field(idx)[0]
                else:
                    name, pos = _decode_str(block, pos)
                value, pos = _decode_str(block, pos)
                out.append((name, value))
        return out


class Encoder:
    """Stateless encoder: a field equal to a static entry is one index,
    anything else a literal without indexing (indexed name where the
    static table has it), plain strings."""

    def encode(self, headers) -> bytes:
        out = bytearray()
        for name, value in headers:
            idx = _STATIC_FIELD.get((name, value))
            if idx is not None:
                out += encode_int(idx, 7, 0x80)
                continue
            idx = _STATIC_NAME.get(name)
            if idx is not None:
                out += encode_int(idx, 4)
            else:
                out += b"\x00" + _encode_str(name)
            out += _encode_str(value)
        return bytes(out)
