"""HPACK (RFC 7541), header compression for the h2 gRPC data plane: the
port's copy of the JAX package's ``wire/hpack.py``.

Hand-rolled because the card ships no ``h2``/``hpack`` package, and
because gRPC unary traffic needs far less than a general HTTP/2 stack: a
handful of headers that, after the first request on a connection, arrive
almost entirely as 1-byte indexed fields.

Decoder: complete (static and dynamic tables, every literal form,
Huffman, table-size updates).  Encoder: deliberately minimal, literal
without indexing with raw strings only, which every compliant peer must
accept (RFC 7541 §6.2.2) and which lets request and response header
blocks be precomputed byte templates.

The Huffman code and length constants are RFC 7541 Appendix B data.
"""

from __future__ import annotations

import collections

HUFFMAN_CODES = (
    0x1ff8, 0x7fffd8, 0xfffffe2, 0xfffffe3, 0xfffffe4, 0xfffffe5, 0xfffffe6, 0xfffffe7,
    0xfffffe8, 0xffffea, 0x3ffffffc, 0xfffffe9, 0xfffffea, 0x3ffffffd, 0xfffffeb, 0xfffffec,
    0xfffffed, 0xfffffee, 0xfffffef, 0xffffff0, 0xffffff1, 0xffffff2, 0x3ffffffe, 0xffffff3,
    0xffffff4, 0xffffff5, 0xffffff6, 0xffffff7, 0xffffff8, 0xffffff9, 0xffffffa, 0xffffffb,
    0x14, 0x3f8, 0x3f9, 0xffa, 0x1ff9, 0x15, 0xf8, 0x7fa,
    0x3fa, 0x3fb, 0xf9, 0x7fb, 0xfa, 0x16, 0x17, 0x18,
    0x0, 0x1, 0x2, 0x19, 0x1a, 0x1b, 0x1c, 0x1d,
    0x1e, 0x1f, 0x5c, 0xfb, 0x7ffc, 0x20, 0xffb, 0x3fc,
    0x1ffa, 0x21, 0x5d, 0x5e, 0x5f, 0x60, 0x61, 0x62,
    0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a,
    0x6b, 0x6c, 0x6d, 0x6e, 0x6f, 0x70, 0x71, 0x72,
    0xfc, 0x73, 0xfd, 0x1ffb, 0x7fff0, 0x1ffc, 0x3ffc, 0x22,
    0x7ffd, 0x3, 0x23, 0x4, 0x24, 0x5, 0x25, 0x26,
    0x27, 0x6, 0x74, 0x75, 0x28, 0x29, 0x2a, 0x7,
    0x2b, 0x76, 0x2c, 0x8, 0x9, 0x2d, 0x77, 0x78,
    0x79, 0x7a, 0x7b, 0x7ffe, 0x7fc, 0x3ffd, 0x1ffd, 0xffffffc,
    0xfffe6, 0x3fffd2, 0xfffe7, 0xfffe8, 0x3fffd3, 0x3fffd4, 0x3fffd5, 0x7fffd9,
    0x3fffd6, 0x7fffda, 0x7fffdb, 0x7fffdc, 0x7fffdd, 0x7fffde, 0xffffeb, 0x7fffdf,
    0xffffec, 0xffffed, 0x3fffd7, 0x7fffe0, 0xffffee, 0x7fffe1, 0x7fffe2, 0x7fffe3,
    0x7fffe4, 0x1fffdc, 0x3fffd8, 0x7fffe5, 0x3fffd9, 0x7fffe6, 0x7fffe7, 0xffffef,
    0x3fffda, 0x1fffdd, 0xfffe9, 0x3fffdb, 0x3fffdc, 0x7fffe8, 0x7fffe9, 0x1fffde,
    0x7fffea, 0x3fffdd, 0x3fffde, 0xfffff0, 0x1fffdf, 0x3fffdf, 0x7fffeb, 0x7fffec,
    0x1fffe0, 0x1fffe1, 0x3fffe0, 0x1fffe2, 0x7fffed, 0x3fffe1, 0x7fffee, 0x7fffef,
    0xfffea, 0x3fffe2, 0x3fffe3, 0x3fffe4, 0x7ffff0, 0x3fffe5, 0x3fffe6, 0x7ffff1,
    0x3ffffe0, 0x3ffffe1, 0xfffeb, 0x7fff1, 0x3fffe7, 0x7ffff2, 0x3fffe8, 0x1ffffec,
    0x3ffffe2, 0x3ffffe3, 0x3ffffe4, 0x7ffffde, 0x7ffffdf, 0x3ffffe5, 0xfffff1, 0x1ffffed,
    0x7fff2, 0x1fffe3, 0x3ffffe6, 0x7ffffe0, 0x7ffffe1, 0x3ffffe7, 0x7ffffe2, 0xfffff2,
    0x1fffe4, 0x1fffe5, 0x3ffffe8, 0x3ffffe9, 0xffffffd, 0x7ffffe3, 0x7ffffe4, 0x7ffffe5,
    0xfffec, 0xfffff3, 0xfffed, 0x1fffe6, 0x3fffe9, 0x1fffe7, 0x1fffe8, 0x7ffff3,
    0x3fffea, 0x3fffeb, 0x1ffffee, 0x1ffffef, 0xfffff4, 0xfffff5, 0x3ffffea, 0x7ffff4,
    0x3ffffeb, 0x7ffffe6, 0x3ffffec, 0x3ffffed, 0x7ffffe7, 0x7ffffe8, 0x7ffffe9, 0x7ffffea,
    0x7ffffeb, 0xffffffe, 0x7ffffec, 0x7ffffed, 0x7ffffee, 0x7ffffef, 0x7fffff0, 0x3ffffee,
    0x3fffffff,
)

HUFFMAN_LENGTHS = (
    13, 23, 28, 28, 28, 28, 28, 28, 28, 24, 30, 28, 28, 30, 28, 28,
    28, 28, 28, 28, 28, 28, 30, 28, 28, 28, 28, 28, 28, 28, 28, 28,
    6, 10, 10, 12, 13, 6, 8, 11, 10, 10, 8, 11, 8, 6, 6, 6,
    5, 5, 5, 6, 6, 6, 6, 6, 6, 6, 7, 8, 15, 6, 12, 10,
    13, 6, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7,
    7, 7, 7, 7, 7, 7, 7, 7, 8, 7, 8, 13, 19, 13, 14, 6,
    15, 5, 6, 5, 6, 5, 6, 6, 6, 5, 7, 7, 6, 6, 6, 5,
    6, 7, 6, 5, 5, 6, 7, 7, 7, 7, 7, 15, 11, 14, 13, 28,
    20, 22, 20, 20, 22, 22, 22, 23, 22, 23, 23, 23, 23, 23, 24, 23,
    24, 24, 22, 23, 24, 23, 23, 23, 23, 21, 22, 23, 22, 23, 23, 24,
    22, 21, 20, 22, 22, 23, 23, 21, 23, 22, 22, 24, 21, 22, 23, 23,
    21, 21, 22, 21, 23, 22, 23, 23, 20, 22, 22, 22, 23, 22, 22, 23,
    26, 26, 20, 19, 22, 23, 22, 25, 26, 26, 26, 27, 27, 26, 24, 25,
    19, 21, 26, 27, 27, 26, 27, 24, 21, 21, 26, 26, 28, 27, 27, 27,
    20, 24, 20, 21, 22, 21, 21, 23, 22, 22, 25, 25, 24, 24, 26, 23,
    26, 27, 26, 26, 27, 27, 27, 27, 27, 28, 27, 27, 27, 27, 27, 26,
    30,
)

# RFC 7541 Appendix A — the 61-entry static table.
STATIC_TABLE: tuple[tuple[bytes, bytes], ...] = (
    (b":authority", b""),
    (b":method", b"GET"),
    (b":method", b"POST"),
    (b":path", b"/"),
    (b":path", b"/index.html"),
    (b":scheme", b"http"),
    (b":scheme", b"https"),
    (b":status", b"200"),
    (b":status", b"204"),
    (b":status", b"206"),
    (b":status", b"304"),
    (b":status", b"400"),
    (b":status", b"404"),
    (b":status", b"500"),
    (b"accept-charset", b""),
    (b"accept-encoding", b"gzip, deflate"),
    (b"accept-language", b""),
    (b"accept-ranges", b""),
    (b"accept", b""),
    (b"access-control-allow-origin", b""),
    (b"age", b""),
    (b"allow", b""),
    (b"authorization", b""),
    (b"cache-control", b""),
    (b"content-disposition", b""),
    (b"content-encoding", b""),
    (b"content-language", b""),
    (b"content-length", b""),
    (b"content-location", b""),
    (b"content-range", b""),
    (b"content-type", b""),
    (b"cookie", b""),
    (b"date", b""),
    (b"etag", b""),
    (b"expect", b""),
    (b"expires", b""),
    (b"from", b""),
    (b"host", b""),
    (b"if-match", b""),
    (b"if-modified-since", b""),
    (b"if-none-match", b""),
    (b"if-range", b""),
    (b"if-unmodified-since", b""),
    (b"last-modified", b""),
    (b"link", b""),
    (b"location", b""),
    (b"max-forwards", b""),
    (b"proxy-authenticate", b""),
    (b"proxy-authorization", b""),
    (b"range", b""),
    (b"referer", b""),
    (b"refresh", b""),
    (b"retry-after", b""),
    (b"server", b""),
    (b"set-cookie", b""),
    (b"strict-transport-security", b""),
    (b"transfer-encoding", b""),
    (b"user-agent", b""),
    (b"vary", b""),
    (b"via", b""),
    (b"www-authenticate", b""),
)


class HpackError(Exception):
    pass


# ---------------------------------------------------------------------------
# Huffman decode: bit-walk over a tree built once from the RFC constants.
# Literal huffman values are rare on the hot path (indexed fields dominate
# after connection warmup), so simplicity wins over an FSM.
# ---------------------------------------------------------------------------

def _build_tree():
    # node = [left, right, symbol]; symbol None for internal nodes
    root = [None, None, None]
    for sym in range(256):  # 256 = EOS, never decoded to output
        code, length = HUFFMAN_CODES[sym], HUFFMAN_LENGTHS[sym]
        node = root
        for i in range(length - 1, -1, -1):
            bit = (code >> i) & 1
            nxt = node[bit]
            if nxt is None:
                nxt = [None, None, None]
                node[bit] = nxt
            node = nxt
        node[2] = sym
    return root


_HUFFMAN_TREE = _build_tree()


def huffman_decode(data: bytes) -> bytes:
    out = bytearray()
    node = _HUFFMAN_TREE
    root = _HUFFMAN_TREE
    depth = 0
    ones = 0  # consecutive 1-bits on the current partial walk
    for byte in data:
        for i in (7, 6, 5, 4, 3, 2, 1, 0):
            bit = (byte >> i) & 1
            node = node[bit]
            depth += 1
            ones = ones + 1 if bit else 0
            if node is None:
                raise HpackError("invalid huffman sequence")
            if node[2] is not None:
                out.append(node[2])
                node = root
                depth = 0
                ones = 0
    # RFC 7541 §5.2: trailing bits must be a prefix of EOS (all ones) and
    # strictly shorter than 8 bits; anything else is a decoding error
    if depth > 7:
        raise HpackError("huffman padding longer than 7 bits")
    if depth and ones != depth:
        raise HpackError("huffman padding is not an EOS prefix")
    return bytes(out)


def huffman_encode(data: bytes) -> bytes:
    bits = 0
    nbits = 0
    out = bytearray()
    for byte in data:
        code, length = HUFFMAN_CODES[byte], HUFFMAN_LENGTHS[byte]
        bits = (bits << length) | code
        nbits += length
        while nbits >= 8:
            nbits -= 8
            out.append((bits >> nbits) & 0xFF)
    if nbits:
        # pad with EOS prefix (all ones)
        out.append(((bits << (8 - nbits)) | ((1 << (8 - nbits)) - 1)) & 0xFF)
    return bytes(out)


# ---------------------------------------------------------------------------
# Primitive integer / string codecs (RFC 7541 §5)
# ---------------------------------------------------------------------------

def encode_int(value: int, prefix_bits: int, flags: int = 0) -> bytes:
    limit = (1 << prefix_bits) - 1
    if value < limit:
        return bytes((flags | value,))
    out = bytearray((flags | limit,))
    value -= limit
    while value >= 128:
        out.append(0x80 | (value & 0x7F))
        value >>= 7
    out.append(value)
    return bytes(out)


def decode_int(data, pos: int, prefix_bits: int) -> tuple[int, int]:
    limit = (1 << prefix_bits) - 1
    value = data[pos] & limit
    pos += 1
    if value < limit:
        return value, pos
    shift = 0
    while True:
        if pos >= len(data):
            raise HpackError("truncated integer")
        byte = data[pos]
        pos += 1
        value += (byte & 0x7F) << shift
        shift += 7
        if not byte & 0x80:
            return value, pos
        if shift > 35:
            raise HpackError("integer overflow")


def _decode_string(data, pos: int) -> tuple[bytes, int]:
    if pos >= len(data):
        raise HpackError("truncated string")
    huff = bool(data[pos] & 0x80)
    length, pos = decode_int(data, pos, 7)
    end = pos + length
    if end > len(data):
        raise HpackError("truncated string body")
    raw = bytes(data[pos:end])
    return (huffman_decode(raw) if huff else raw), end


def encode_string(value: bytes) -> bytes:
    """Raw (non-huffman) string — used by the minimal encoder."""
    return encode_int(len(value), 7) + value


# ---------------------------------------------------------------------------
# Decoder with dynamic table
# ---------------------------------------------------------------------------

_ENTRY_OVERHEAD = 32  # RFC 7541 §4.1


class Decoder:
    def __init__(self, max_table_size: int = 4096):
        self._dynamic: collections.deque[tuple[bytes, bytes]] = collections.deque()
        self._size = 0
        # max_table_size is OUR advertised SETTINGS_HEADER_TABLE_SIZE — the
        # ceiling the peer's encoder (and its table-size-update opcodes)
        # must stay under
        self._max_size = max_table_size
        self._settings_max = max_table_size
        # pure-decode memo: steady-state peers (our own stateless encoder)
        # send byte-identical blocks every request; a decode that neither
        # read nor wrote the dynamic table is a pure function of the bytes
        # and can be replayed from this cache.  grpcio peers use incremental
        # indexing, which marks the decode impure and bypasses the cache.
        self._cache: dict[bytes, list[tuple[bytes, bytes]]] = {}
        self._pure = True

    def _set_max(self, value: int) -> None:
        if value > self._settings_max:
            raise HpackError("peer exceeded negotiated header table size")
        self._max_size = value
        self._evict()

    def _evict(self) -> None:
        while self._size > self._max_size and self._dynamic:
            name, value = self._dynamic.pop()
            self._size -= len(name) + len(value) + _ENTRY_OVERHEAD

    def _add(self, name: bytes, value: bytes) -> None:
        self._dynamic.appendleft((name, value))
        self._size += len(name) + len(value) + _ENTRY_OVERHEAD
        self._evict()

    def _lookup(self, index: int) -> tuple[bytes, bytes]:
        if index == 0:
            raise HpackError("index 0 is invalid")
        if index <= len(STATIC_TABLE):
            return STATIC_TABLE[index - 1]
        self._pure = False  # result depends on dynamic-table state
        dyn = index - len(STATIC_TABLE) - 1
        try:
            return self._dynamic[dyn]
        except IndexError:
            raise HpackError(f"dynamic table index {index} out of range") from None

    def decode_cached(self, block: bytes) -> list[tuple[bytes, bytes]]:
        """Memoized decode for repeat blocks.  The returned list is SHARED —
        callers must not mutate it."""
        hit = self._cache.get(block)
        if hit is not None:
            return hit
        self._pure = True
        headers = self.decode(block)
        if self._pure:
            if len(self._cache) >= 256:
                # clear-on-full: unique blocks (per-request traceparent)
                # must not permanently crowd out the hot repeat blocks
                self._cache.clear()
            self._cache[bytes(block)] = headers
        return headers

    def decode(self, block: bytes) -> list[tuple[bytes, bytes]]:
        headers: list[tuple[bytes, bytes]] = []
        pos = 0
        n = len(block)
        while pos < n:
            byte = block[pos]
            if byte & 0x80:  # indexed field
                index, pos = decode_int(block, pos, 7)
                headers.append(self._lookup(index))
            elif byte & 0x40:  # literal with incremental indexing
                self._pure = False  # mutates the dynamic table
                index, pos = decode_int(block, pos, 6)
                name = self._lookup(index)[0] if index else None
                if name is None:
                    name, pos = _decode_string(block, pos)
                value, pos = _decode_string(block, pos)
                self._add(name, value)
                headers.append((name, value))
            elif byte & 0x20:  # dynamic table size update
                self._pure = False  # mutates decoder state
                size, pos = decode_int(block, pos, 5)
                self._set_max(size)
            else:  # literal without indexing (0x00) / never indexed (0x10)
                index, pos = decode_int(block, pos, 4)
                name = self._lookup(index)[0] if index else None
                if name is None:
                    name, pos = _decode_string(block, pos)
                value, pos = _decode_string(block, pos)
                headers.append((name, value))
        return headers


# ---------------------------------------------------------------------------
# Minimal encoder: literal-without-indexing, static-table name refs where
# available.  Stateless -> header blocks are constant byte templates.
# ---------------------------------------------------------------------------

_STATIC_NAME_INDEX = {}
for _i, (_name, _value) in enumerate(STATIC_TABLE, start=1):
    _STATIC_NAME_INDEX.setdefault(_name, _i)
_STATIC_FULL_INDEX = {
    (_name, _value): _i
    for _i, (_name, _value) in enumerate(STATIC_TABLE, start=1)
    if _value
}


def encode_headers(headers: list[tuple[bytes, bytes]]) -> bytes:
    """Stateless encode: fully-indexed static matches, else literal without
    indexing (name ref when the static table has the name)."""
    out = bytearray()
    for name, value in headers:
        full = _STATIC_FULL_INDEX.get((name, value))
        if full is not None:
            out += encode_int(full, 7, 0x80)
            continue
        name_idx = _STATIC_NAME_INDEX.get(name, 0)
        out += encode_int(name_idx, 4, 0x00)
        if not name_idx:
            out += encode_string(name)
        out += encode_string(value)
    return bytes(out)
