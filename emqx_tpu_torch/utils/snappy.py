"""Snappy block-format codec — the ``snappyer`` NIF analogue
(SURVEY.md §2.4: C NIFs via wolff→kafka_protocol for Kafka batch
compression).

Two implementations of the same wire format
(google/snappy format_description.txt):

- the C++ one in ``native/src/snappy.cc`` (preferred — built into
  libemqx_native.so on demand, sanitizer-covered with the host);
- a pure-Python greedy matcher/decoder here, used when no compiler is
  available, and as the differential oracle in tests.

Both produce valid streams (they need not be byte-identical — snappy
is a format, not a canonical encoding); decompress accepts any
spec-conformant stream.
"""

from __future__ import annotations

import ctypes
import struct


class SnappyError(Exception):
    pass


# ---------------------------------------------------------------------------
# pure-Python implementation


def _varint(n: int) -> bytes:
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _read_varint(data: bytes, pos: int) -> tuple[int, int]:
    n = shift = 0
    while True:
        if pos >= len(data) or shift > 32:
            raise SnappyError("bad length varint")
        b = data[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not (b & 0x80):
            return n, pos
        shift += 7


def _emit_literal(out: bytearray, chunk: bytes) -> None:
    n = len(chunk) - 1
    if n < 60:
        out.append(n << 2)
    else:
        nb = (n.bit_length() + 7) // 8
        out.append((59 + nb) << 2)
        out += n.to_bytes(nb, "little")
    out += chunk


def _emit_copy(out: bytearray, offset: int, length: int) -> None:
    while length > 64:
        _emit_copy(out, offset, 60)      # keep every chunk >= 4
        length -= 60
    if length <= 11 and offset < 2048:
        out.append(0x01 | ((length - 4) << 2) | ((offset >> 8) << 5))
        out.append(offset & 0xFF)
    elif offset < (1 << 16):
        out.append(0x02 | ((length - 1) << 2))
        out += struct.pack("<H", offset)
    else:
        out.append(0x03 | ((length - 1) << 2))
        out += struct.pack("<I", offset)


def py_compress(data: bytes) -> bytes:
    n = len(data)
    out = bytearray(_varint(n))
    if n == 0:
        return bytes(out)
    table: dict[bytes, int] = {}
    i = lit = 0
    while i + 4 <= n:
        four = data[i:i + 4]
        cand = table.get(four)
        table[four] = i
        if cand is None:
            i += 1
            continue
        length = 4
        while i + length < n and data[cand + length] == data[i + length]:
            length += 1
        # only cost-effective copies (mirrors snappy.cc): a 5-byte copy4
        # tag for a short far match would expand the stream
        if i - cand >= (1 << 16) and length < 8:
            i += 1
            continue
        if lit < i:
            _emit_literal(out, data[lit:i])
        _emit_copy(out, i - cand, length)
        i += length
        lit = i
    if lit < n:
        _emit_literal(out, data[lit:])
    return bytes(out)


def py_decompress(data: bytes) -> bytes:
    total, pos = _read_varint(data, 0)
    out = bytearray()
    n = len(data)
    while pos < n:
        tag = data[pos]
        pos += 1
        kind = tag & 0x03
        if kind == 0:                          # literal
            length = (tag >> 2) + 1
            if length > 60:
                nb = length - 60
                if pos + nb > n:
                    raise SnappyError("truncated literal length")
                length = int.from_bytes(data[pos:pos + nb], "little") + 1
                pos += nb
            if pos + length > n:
                raise SnappyError("truncated literal")
            out += data[pos:pos + length]
            pos += length
            continue
        if kind == 1:
            if pos + 1 > n:
                raise SnappyError("truncated copy1")
            length = ((tag >> 2) & 0x07) + 4
            offset = ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif kind == 2:
            if pos + 2 > n:
                raise SnappyError("truncated copy2")
            length = (tag >> 2) + 1
            (offset,) = struct.unpack_from("<H", data, pos)
            pos += 2
        else:
            if pos + 4 > n:
                raise SnappyError("truncated copy4")
            length = (tag >> 2) + 1
            (offset,) = struct.unpack_from("<I", data, pos)
            pos += 4
        if offset == 0 or offset > len(out):
            raise SnappyError("copy offset out of range")
        for _ in range(length):                # overlap-replicating copy
            out.append(out[-offset])
    if len(out) != total:
        raise SnappyError(
            f"length mismatch: header {total}, decoded {len(out)}")
    return bytes(out)


# ---------------------------------------------------------------------------
# native dispatch


def _native():
    from emqx_tpu_torch import native
    return native.load()


def compress(data: bytes) -> bytes:
    lib = _native()
    if lib is None:
        return py_compress(data)
    cap = lib.emqx_snappy_max_compressed(len(data))
    dst = ctypes.create_string_buffer(cap)
    written = lib.emqx_snappy_compress(data, len(data), dst, cap)
    if written < 0:       # capacity bound hit (pathological input):
        return py_compress(data)     # the Python emitter can't overflow
    return dst.raw[:written]


# a snappy stream cannot expand more than ~21x (best op: a 64-byte copy
# from a 3-byte tag) — cap the attacker-controlled header length before
# allocating the output buffer (64x leaves generous slack)
_MAX_EXPANSION = 64


def decompress(data: bytes) -> bytes:
    lib = _native()
    if lib is None:
        return py_decompress(data)
    total = lib.emqx_snappy_uncompressed_length(data, len(data))
    if total < 0:
        raise SnappyError("bad length varint")
    if total > max(len(data), 16) * _MAX_EXPANSION:
        raise SnappyError(
            f"implausible uncompressed length {total} "
            f"for {len(data)} input bytes")
    dst = ctypes.create_string_buffer(max(total, 1))
    written = lib.emqx_snappy_decompress(data, len(data), dst, total)
    if written < 0:
        raise SnappyError("malformed snappy stream")
    if written != total:
        raise SnappyError(
            f"length mismatch: header {total}, decoded {written}")
    return dst.raw[:written]
