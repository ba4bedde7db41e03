"""The msgpack subset a checkpoint manifest uses: dict, str, int, bool,
None and list.

:func:`packb` gives the bytes ``msgpack.packb`` gives with its defaults
(the smallest integer encoding; fixstr, str8, str16, str32; fixarray,
array16, array32; fixmap, map16, map32), and :func:`unpackb` gives back
what ``msgpack.unpackb`` gives (lists, dicts, str keys).  Anything outside
the subset raises ``TypeError`` on the way in and ``ValueError`` on the
way out, as does truncated or trailing input.
"""

from __future__ import annotations

import struct


def _head(n: int, fix: int, fix_max: int, tags: tuple) -> bytes:
    """A length header: fix form up to ``fix_max``, then 8-bit (when the
    type has one), 16-bit and 32-bit forms."""
    if n <= fix_max:
        return bytes([fix | n])
    for tag, fmt, limit in tags:
        if n < limit:
            return bytes([tag]) + struct.pack(fmt, n)
    raise ValueError(f"length {n} exceeds msgpack's 32-bit limit")


_STR = ((0xD9, ">B", 1 << 8), (0xDA, ">H", 1 << 16), (0xDB, ">I", 1 << 32))
_ARRAY = ((0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32))
_MAP = ((0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32))


def _int(v: int) -> bytes:
    if 0 <= v < 128 or -32 <= v < 0:
        return struct.pack(">b" if v < 0 else ">B", v)
    if v > 0:
        for tag, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < limit:
                return bytes([tag]) + struct.pack(fmt, v)
    else:
        for tag, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if v >= -limit:
                return bytes([tag]) + struct.pack(fmt, v)
    raise OverflowError(f"integer {v} does not fit msgpack's 64 bits")


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        out.append(_int(int(obj)))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out.append(_head(len(raw), 0xA0, 31, _STR))
        out.append(raw)
    elif isinstance(obj, (list, tuple)):
        out.append(_head(len(obj), 0x90, 15, _ARRAY))
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        out.append(_head(len(obj), 0x80, 15, _MAP))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj) -> bytes:
    """``obj`` (the manifest subset) -> msgpack bytes."""
    out: list[bytes] = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:end]
        self.pos = end
        return out

    def num(self, fmt: str) -> int:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def obj(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in ints:
            return self.num(ints[b])
        lengths = {0xD9: (">B", self.str), 0xDA: (">H", self.str),
                   0xDB: (">I", self.str), 0xDC: (">H", self.array),
                   0xDD: (">I", self.array), 0xDE: (">H", self.map),
                   0xDF: (">I", self.map)}
        if b in lengths:
            fmt, read = lengths[b]
            return read(self.num(fmt))
        raise ValueError(f"msgpack type 0x{b:02x} is outside the manifest "
                         "subset")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            if not isinstance(k, str):
                raise ValueError(f"map key {k!r} is not a str")
            out[k] = self.obj()
        return out


def unpackb(data: bytes):
    """msgpack bytes of the manifest subset -> the object."""
    r = _Reader(data)
    obj = r.obj()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes of extra data after "
                         "the msgpack object")
    return obj
