"""A stdlib msgpack codec: the one the port's checkpoint manifests and wire
frames share.

The machine with the card has no ``msgpack`` package, and the JAX package
writes both its ``manifest.msgpack`` (``repro.checkpoint``) and its wire
frames (``repro.net.protocol``) with ``msgpack.packb(obj,
use_bin_type=True)``. :func:`packb` writes the same bytes for every type
those hold: str (fixstr/str8/16/32), bytes (bin8/16/32), ints of either
sign in their smallest form, Python floats as float64, None, bools,
lists/tuples (arrays) and dicts (maps). :func:`unpackb` reads them back
as strictly as ``msgpack.unpackb(raw=False, strict_map_key=True)``: it
raises :class:`CodecError`, and nothing else, on truncated input, trailing
bytes, a non-str map key, invalid UTF-8, nesting past
:data:`MAX_DEPTH` and any type code outside that set (the extension
types and the never-used 0xc1 included).
"""
from __future__ import annotations

import struct
from typing import Any

MAX_DEPTH = 100  # far below the interpreter's recursion limit (3 frames a level)


class CodecError(ValueError):
    """Bytes that are not exactly one msgpack object of the supported types."""


def _sized(out: bytearray, n: int, fix: int | None, fix_max: int, codes: tuple) -> None:
    """A length header: the fix form below ``fix_max`` (when there is one),
    else the smallest of ``codes`` (one per 1/2/4-byte big-endian length,
    None where the family has no such form)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < limit:
            out.append(code)
            out.extend(struct.pack(fmt, n))
            return
    raise ValueError(f"msgpack length {n} too large")


def _pack_int(out: bytearray, o: int) -> None:
    if 0 <= o < 128:
        out.append(o)
    elif -32 <= o < 0:
        out.append(o & 0xFF)  # negative fixint 0xe0..0xff
    elif o >= 0:
        for code, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                 (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if o < limit:
                out.append(code)
                out.extend(struct.pack(fmt, o))
                return
        raise OverflowError(f"int {o} too large for msgpack")
    else:
        for code, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                 (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if o >= -limit:
                out.append(code)
                out.extend(struct.pack(fmt, o))
                return
        raise OverflowError(f"int {o} too small for msgpack")


def packb(obj: Any) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` for dicts, lists/tuples,
    str, bytes, ints, floats, bools and None; TypeError on anything else."""
    out = bytearray()

    def put(o, depth):
        if depth > MAX_DEPTH:
            raise ValueError(f"msgpack nesting deeper than {MAX_DEPTH}")
        if o is None:
            out.append(0xC0)
        elif o is True or o is False:
            out.append(0xC3 if o else 0xC2)
        elif isinstance(o, int):
            _pack_int(out, o)
        elif isinstance(o, float):
            out.append(0xCB)
            out.extend(struct.pack(">d", o))
        elif isinstance(o, str):
            b = o.encode("utf-8")
            _sized(out, len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB))
            out.extend(b)
        elif isinstance(o, bytes | bytearray):
            _sized(out, len(o), None, 0, (0xC4, 0xC5, 0xC6))
            out.extend(o)
        elif isinstance(o, dict):
            _sized(out, len(o), 0x80, 16, (None, 0xDE, 0xDF))
            for k, v in o.items():
                put(k, depth + 1)
                put(v, depth + 1)
        elif isinstance(o, list | tuple):
            _sized(out, len(o), 0x90, 16, (None, 0xDC, 0xDD))
            for v in o:
                put(v, depth + 1)
        else:
            raise TypeError(f"cannot msgpack-encode {type(o).__name__}")

    put(obj, 0)
    return bytes(out)


# fixed-width bodies: code -> (struct format, byte count)
_FIXED = {
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
# length-prefixed: code -> (kind, struct format of the length, its bytes)
_SIZED = {
    0xD9: ("str", ">B", 1), 0xDA: ("str", ">H", 2), 0xDB: ("str", ">I", 4),
    0xC4: ("bin", ">B", 1), 0xC5: ("bin", ">H", 2), 0xC6: ("bin", ">I", 4),
    0xDC: ("array", ">H", 2), 0xDD: ("array", ">I", 4),
    0xDE: ("map", ">H", 2), 0xDF: ("map", ">I", 4),
}


def unpackb(buf: bytes) -> Any:
    """Decode exactly one msgpack object from ``buf`` (str as str, bin as
    bytes, arrays as lists, maps as dicts with str keys)."""
    if not isinstance(buf, bytes | bytearray | memoryview):
        raise CodecError(f"expected bytes, got {type(buf).__name__}")
    data = bytes(buf)
    end = len(data)
    pos = 0

    def take(n: int) -> bytes:
        nonlocal pos
        if n > end - pos:
            raise CodecError(f"truncated: need {n} bytes at offset {pos}, have {end - pos}")
        chunk = data[pos:pos + n]
        pos += n
        return chunk

    def sized(kind: str, n: int, depth: int):
        if kind == "str":
            try:
                return take(n).decode("utf-8")
            except UnicodeDecodeError as err:
                raise CodecError(f"invalid UTF-8 in str: {err}") from None
        if kind == "bin":
            return take(n)
        if n > end - pos:  # every element takes at least one byte
            raise CodecError(f"truncated: {kind} of {n} entries at offset {pos}")
        if kind == "array":
            return [get(depth + 1) for _ in range(n)]
        out = {}
        for _ in range(n):
            key = get(depth + 1)
            if not isinstance(key, str):
                raise CodecError(f"map key must be str, got {type(key).__name__}")
            out[key] = get(depth + 1)
        return out

    def get(depth: int):
        if depth > MAX_DEPTH:
            raise CodecError(f"nesting deeper than {MAX_DEPTH}")
        code = take(1)[0]
        if code <= 0x7F:
            return code
        if code >= 0xE0:
            return code - 0x100
        if 0xA0 <= code <= 0xBF:
            return sized("str", code & 0x1F, depth)
        if 0x90 <= code <= 0x9F:
            return sized("array", code & 0x0F, depth)
        if 0x80 <= code <= 0x8F:
            return sized("map", code & 0x0F, depth)
        if code == 0xC0:
            return None
        if code in (0xC2, 0xC3):
            return code == 0xC3
        if code in _FIXED:
            fmt, n = _FIXED[code]
            return struct.unpack(fmt, take(n))[0]
        if code in _SIZED:
            kind, fmt, n = _SIZED[code]
            return sized(kind, struct.unpack(fmt, take(n))[0], depth)
        raise CodecError(f"unsupported msgpack type code 0x{code:02x} at offset {pos - 1}")

    obj = get(0)
    if pos != end:
        raise CodecError(f"{end - pos} trailing bytes after the msgpack object")
    return obj
