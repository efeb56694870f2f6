"""HPACK, the header compression of HTTP/2 (RFC 7541), for the port's
HTTP/2 connection (``h2.py``).

The machine the port serves on has no ``hpack`` package, and the standard
library has no HTTP/2, so this module holds its own:

* the 61-entry static table (Appendix A) and the dynamic table, with its
  size limit and the size updates a block may begin with;
* prefix integers (5.1) and string literals (5.2), raw or in the Huffman
  code of Appendix B, both ways.  The code is canonical (codes of one
  length are consecutive, in symbol order), so it is stored as its 257
  code lengths and the codes are rebuilt from them; decoding walks a
  4-bit state machine over the code's tree;
* :class:`Decoder`, which takes every representation (indexed; literal
  with incremental indexing, without indexing and never indexed; the
  table size update) and raises :class:`HpackError` on a malformed block,
  which the connection answers as a COMPRESSION_ERROR;
* :class:`Encoder`, which never inserts into the peer's table: it sets
  that table's size to 0 at the start of its first block (any limit the
  peer announces is then met), sends a static entry that matches a whole
  field as its index, and every other field as a literal without
  indexing (never indexed for ``authorization`` and ``cookie``), raw or,
  with ``huffman=True``, coded where that is shorter.

Names and values are ``str`` here, each byte one character (latin-1), so
that no byte is lost; names are lower case on the wire (RFC 9113 8.2).
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Iterable, List, Tuple

__all__ = ["Decoder", "Encoder", "HpackError", "STATIC_TABLE",
           "huffman_decode", "huffman_encode"]


class HpackError(Exception):
    """A malformed header block (the connection's COMPRESSION_ERROR)."""


STATIC_TABLE: Tuple[Tuple[str, str], ...] = (
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
    ("via", ""), ("www-authenticate", ""),
)
_STATIC_FIELD: Dict[Tuple[str, str], int] = {}
_STATIC_NAME: Dict[str, int] = {}
for _i, (_n, _v) in enumerate(STATIC_TABLE, 1):
    _STATIC_FIELD.setdefault((_n, _v), _i)
    _STATIC_NAME.setdefault(_n, _i)

#: the default and initial dynamic table size (SETTINGS_HEADER_TABLE_SIZE)
DEFAULT_TABLE_SIZE = 4096
#: an entry's size is its name and value lengths plus this (4.1)
_ENTRY_OVERHEAD = 32

# -- the Huffman code (Appendix B) -------------------------------------------
#: code lengths in bits of the symbols 0..255; EOS (256) is 30 ones
_CODE_LENGTHS = [int(x) for x in (
    "13 23 28 28 28 28 28 28 28 24 30 28 28 30 28 28 28 28 28 28 28 28 30 28 "
    "28 28 28 28 28 28 28 28 "
    "6 10 10 12 13 6 8 11 10 10 8 11 8 6 6 6 5 5 5 6 6 6 6 6 6 6 7 8 15 6 12 "
    "10 "
    "13 6 7 7 7 7 7 7 7 7 7 7 7 7 7 7 7 7 7 7 7 7 7 7 8 7 8 13 19 13 14 6 "
    "15 5 6 5 6 5 6 6 6 5 7 7 6 6 6 5 6 7 6 5 5 6 7 7 7 7 7 15 11 14 13 28 "
    "20 22 20 20 22 22 22 23 22 23 23 23 23 23 24 23 24 24 22 23 24 23 23 23 "
    "23 21 22 23 22 23 23 24 "
    "22 21 20 22 22 23 23 21 23 22 22 24 21 22 23 23 21 21 22 21 23 22 23 23 "
    "20 22 22 22 23 22 22 23 "
    "26 26 20 19 22 23 22 25 26 26 26 27 27 26 24 25 19 21 26 27 27 26 27 24 "
    "21 21 26 26 28 27 27 27 "
    "20 24 20 21 22 21 21 23 22 22 25 25 24 24 26 23 26 27 26 26 27 27 27 27 "
    "27 28 27 27 27 27 27 26 30").split()]
_EOS = 256


def _canonical_codes(lengths: List[int]) -> List[int]:
    """The codes of a canonical code of these lengths: in order of length,
    then of symbol, each code one more than the last, shifted to its
    length."""
    order = sorted(range(len(lengths)), key=lambda s: (lengths[s], s))
    codes = [0] * len(lengths)
    code, prev = 0, lengths[order[0]]
    for i, s in enumerate(order):
        if i:
            code = (code + 1) << (lengths[s] - prev)
        prev = lengths[s]
        codes[s] = code
    return codes


HUFFMAN_CODES = _canonical_codes(_CODE_LENGTHS)


def _build_decoder():
    """The code's tree as a 4-bit state machine: for each inner node and
    nibble, (next node, the symbol emitted or -1, whether EOS was hit).
    Each node also records whether its path from the root is all ones of
    at most 7 bits: the only padding a string may end with (5.2)."""
    tree = [[0, 0]]  # inner nodes; a leaf is -(symbol + 1)
    for sym, (code, n) in enumerate(zip(HUFFMAN_CODES, _CODE_LENGTHS)):
        node = 0
        for k in range(n - 1, 0, -1):
            bit = (code >> k) & 1
            if tree[node][bit] == 0:  # 0 is the root: unset
                tree.append([0, 0])
                tree[node][bit] = len(tree) - 1
            node = tree[node][bit]
        tree[node][code & 1] = -(sym + 1)
    pad_ok = [False] * len(tree)
    pad_ok[0] = True
    node, depth = 0, 0
    while depth < 7 and tree[node][1] > 0:
        node, depth = tree[node][1], depth + 1
        pad_ok[node] = True
    table = []
    for node in range(len(tree)):
        for nib in range(16):
            cur, sym, eos = node, -1, False
            for k in (3, 2, 1, 0):
                nxt = tree[cur][(nib >> k) & 1]
                if nxt < 0:
                    if -nxt - 1 == _EOS:
                        eos = True
                    sym, cur = -nxt - 1, 0
                else:
                    cur = nxt
            table.append((cur, sym, eos))
    return table, pad_ok


_DECODE_TABLE, _PAD_OK = _build_decoder()


def huffman_encode(data: bytes) -> bytes:
    """``data`` in the Huffman code, padded with ones to a whole byte."""
    acc, nbits = 0, 0
    for b in data:
        n = _CODE_LENGTHS[b]
        acc = (acc << n) | HUFFMAN_CODES[b]
        nbits += n
    pad = -nbits % 8
    acc = (acc << pad) | ((1 << pad) - 1)
    return acc.to_bytes((nbits + pad) // 8, "big")


def huffman_decode(data) -> bytes:
    """The bytes a Huffman-coded string holds.  HpackError where it holds
    EOS, or ends in padding that is not a prefix of EOS of at most 7
    bits."""
    out = bytearray()
    state = 0
    table = _DECODE_TABLE
    for b in data:
        for nib in (b >> 4, b & 15):
            state, sym, eos = table[state * 16 + nib]
            if eos:
                raise HpackError("Huffman string holds EOS")
            if sym >= 0:
                out.append(sym)
    if not _PAD_OK[state]:
        raise HpackError("invalid Huffman padding")
    return bytes(out)


# -- primitives ---------------------------------------------------------------
def encode_integer(value: int, prefix_bits: int, first: int = 0) -> bytes:
    """``value`` as a prefix integer (5.1), its first byte's high bits
    ``first``."""
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


def decode_integer(data, pos: int, prefix_bits: int) -> Tuple[int, int]:
    """(value, position after it) of the prefix integer at ``pos``."""
    if pos >= len(data):
        raise HpackError("header block ends inside an integer")
    limit = (1 << prefix_bits) - 1
    value = data[pos] & limit
    pos += 1
    if value < limit:
        return value, pos
    shift = 0
    while True:
        if pos >= len(data):
            raise HpackError("header block ends inside an integer")
        b = data[pos]
        pos += 1
        value += (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return value, pos
        if shift > 28:
            raise HpackError("integer too large")


def encode_string(value: bytes, huffman: bool = False) -> bytes:
    """A string literal (5.2): Huffman-coded where asked and shorter."""
    if huffman:
        coded = huffman_encode(value)
        if len(coded) < len(value):
            return encode_integer(len(coded), 7, 0x80) + coded
    return encode_integer(len(value), 7) + value


def decode_string(data, pos: int) -> Tuple[bytes, int]:
    if pos >= len(data):
        raise HpackError("header block ends before a string")
    coded = bool(data[pos] & 0x80)
    n, pos = decode_integer(data, pos, 7)
    if pos + n > len(data):
        raise HpackError("string literal runs past the header block")
    raw = bytes(data[pos:pos + n])
    return (huffman_decode(raw) if coded else raw), pos + n


# -- the dynamic table --------------------------------------------------------
class _Table:
    """The dynamic table: newest entry first, evicted from the end to keep
    its size (each entry's name and value plus 32) within ``max_size``."""

    def __init__(self, max_size: int = DEFAULT_TABLE_SIZE):
        self.entries: deque = deque()
        self.size = 0
        self.max_size = max_size

    def add(self, name: str, value: str) -> None:
        need = len(name) + len(value) + _ENTRY_OVERHEAD
        if need > self.max_size:  # an entry larger than the table empties it
            self.entries.clear()
            self.size = 0
            return
        while self.size + need > self.max_size:
            n, v = self.entries.pop()
            self.size -= len(n) + len(v) + _ENTRY_OVERHEAD
        self.entries.appendleft((name, value))
        self.size += need

    def resize(self, max_size: int) -> None:
        self.max_size = max_size
        while self.size > max_size:
            n, v = self.entries.pop()
            self.size -= len(n) + len(v) + _ENTRY_OVERHEAD

    def get(self, index: int) -> Tuple[str, str]:
        if index <= 0:
            raise HpackError("index 0 is not an entry")
        if index <= len(STATIC_TABLE):
            return STATIC_TABLE[index - 1]
        i = index - len(STATIC_TABLE) - 1
        if i >= len(self.entries):
            raise HpackError(f"index {index} is past the tables")
        return self.entries[i]


class Decoder:
    """Decodes the header blocks of one direction of a connection.
    ``max_table_size`` is the SETTINGS_HEADER_TABLE_SIZE this side
    announced: a size update may not pass it."""

    def __init__(self, max_table_size: int = DEFAULT_TABLE_SIZE):
        self.max_allowed = max_table_size
        self.table = _Table(max_table_size)

    def decode(self, block) -> List[Tuple[str, str]]:
        data = memoryview(block)
        out: List[Tuple[str, str]] = []
        pos = 0
        while pos < len(data):
            b = data[pos]
            if b & 0x80:  # indexed field
                index, pos = decode_integer(data, pos, 7)
                out.append(self.table.get(index))
            elif b & 0x40:  # literal with incremental indexing
                name, value, pos = self._literal(data, pos, 6)
                self.table.add(name, value)
                out.append((name, value))
            elif b & 0x20:  # dynamic table size update
                if out:
                    raise HpackError(
                        "table size update after a header field")
                size, pos = decode_integer(data, pos, 5)
                if size > self.max_allowed:
                    raise HpackError(f"table size update to {size} passes "
                                     f"the limit {self.max_allowed}")
                self.table.resize(size)
            else:  # literal without indexing (0x00) or never indexed (0x10)
                name, value, pos = self._literal(data, pos, 4)
                out.append((name, value))
        return out

    def _literal(self, data, pos: int, prefix_bits: int):
        index, pos = decode_integer(data, pos, prefix_bits)
        if index:
            name = self.table.get(index)[0]
        else:
            raw, pos = decode_string(data, pos)
            name = raw.decode("latin-1")
        value, pos = decode_string(data, pos)
        return name, value.decode("latin-1"), pos


#: fields never indexed by any table on their way (7.1.3)
_SENSITIVE = frozenset(("authorization", "cookie"))


class Encoder:
    """Encodes header blocks for one direction of a connection, without
    the dynamic table (see the module's docstring)."""

    def __init__(self, huffman: bool = False):
        self.huffman = huffman
        self._sized = False

    def encode(self, headers: Iterable[Tuple[str, str]]) -> bytes:
        out = bytearray()
        if not self._sized:
            out += encode_integer(0, 5, 0x20)  # the peer's table to 0
            self._sized = True
        for name, value in headers:
            name = name.lower()
            index = _STATIC_FIELD.get((name, value))
            if index is not None:
                out += encode_integer(index, 7, 0x80)
                continue
            first = 0x10 if name in _SENSITIVE else 0x00
            name_index = _STATIC_NAME.get(name)
            if name_index is not None:
                out += encode_integer(name_index, 4, first)
            else:
                out.append(first)
                out += encode_string(name.encode("latin-1"), self.huffman)
            out += encode_string(value.encode("latin-1"), self.huffman)
        return bytes(out)

