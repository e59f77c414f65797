"""A small msgpack reader and writer for the payload of serving bundles.

The JAX package writes ``bundle.msgpack`` with ``flax.serialization``:
msgpack maps of str keys whose leaves are arrays, packed as ext type 1
(``_MsgpackExtType.ndarray``: the msgpack array ``(shape, dtype name, C
bytes)``), numpy scalars as ext type 3 (the same payload of a 0-d array).
The port reads and writes that format itself, in pure Python: the machine
that runs it has no ``msgpack`` and no ``flax``.

Supported: maps, str, bin, ints, floats, bools, nil and lists; arrays of
numpy dtypes come back as numpy arrays that view the buffer (no copy of
a large payload), ``"bfloat16"`` arrays as torch tensors (numpy has no
bfloat16). flax splits arrays over 1 GiB into a chunked form, which is
refused with a clear error, on both sides.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
MAX_ARRAY_BYTES = 2 ** 30   # flax's MAX_CHUNK_SIZE
CHUNKED_KEY = "__msgpack_chunked_array__"


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def obj(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
                0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            return self.unpack(ints[b])
        lens = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}          # bin
        if b in lens:
            return self.take(self.unpack(lens[b]))
        lens = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}          # str
        if b in lens:
            return str(self.take(self.unpack(lens[b])), "utf-8")
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            code = self.unpack(">b")
            return _ext(code, self.take(fixext[b]))
        lens = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}          # ext
        if b in lens:
            n = self.unpack(lens[b])
            code = self.unpack(">b")
            return _ext(code, self.take(n))
        raise ValueError(f"unknown msgpack type byte 0x{b:02x}")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            out[bytes(key).decode() if isinstance(key, memoryview)
                else key] = self.obj()
        if CHUNKED_KEY in out:
            raise ValueError(
                "the bundle holds an array over 1 GiB in flax's chunked "
                "form, which this reader does not take")
        return out


def _ext(code: int, data: memoryview):
    if code not in (EXT_NDARRAY, EXT_NPSCALAR):
        raise ValueError(f"unsupported msgpack ext type {code}")
    shape, name, payload = _Reader(data).obj()
    if isinstance(name, memoryview):
        name = bytes(name).decode()
    shape = tuple(int(s) for s in shape)
    if name == "bfloat16":
        if payload.readonly:            # torch views writable buffers only
            payload = bytearray(payload)
        t = torch.frombuffer(payload, dtype=torch.bfloat16) if len(payload) \
            else torch.empty(0, dtype=torch.bfloat16)
        t = t.reshape(shape)
        return t if code == EXT_NDARRAY else t.reshape(())
    arr = np.frombuffer(payload, dtype=np.dtype(name)).reshape(shape)
    return arr if code == EXT_NDARRAY else arr[()]


def unpackb(data):
    """msgpack bytes (or any buffer) → Python objects; arrays view
    ``data``."""
    reader = _Reader(data)
    out = reader.obj()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after the msgpack object")
    return out


def read_msgpack(path):
    """A flax-msgpack file → its tree; its arrays view one writable buffer
    that the file is read into."""
    with open(path, "rb") as f:
        f.seek(0, 2)
        buf = bytearray(f.tell())
        f.seek(0)
        if f.readinto(buf) != len(buf):
            raise ValueError(f"{path}: short read")
    return unpackb(buf)


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def _int(v: int) -> bytes:
    if 0 <= v <= 0x7F:
        return struct.pack(">B", v)
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for code, fmt, hi in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                              (0xCE, ">I", 0xFFFFFFFF),
                              (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if v <= hi:
                return bytes([code]) + struct.pack(fmt, v)
    else:
        for code, fmt, lo in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                              (0xD2, ">i", -0x80000000),
                              (0xD3, ">q", -0x8000000000000000)):
            if v >= lo:
                return bytes([code]) + struct.pack(fmt, v)
    raise OverflowError(f"int {v} does not fit msgpack")


def _len_header(n: int, fix: int | None, fix_max: int, codes) -> bytes:
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for code, fmt, hi in zip(codes, (">B", ">H", ">I"),
                             (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= hi:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack object of length {n} is too large")


def _str_header(n: int) -> bytes:
    return _len_header(n, 0xA0, 31, (0xD9, 0xDA, 0xDB))


def _bin_header(n: int) -> bytes:
    return _len_header(n, None, 0, (0xC4, 0xC5, 0xC6))


def _ext_header(code: int, n: int) -> bytes:
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        return bytes([fixext[n]]) + struct.pack(">b", code)
    return _len_header(n, None, 0, (0xC7, 0xC8, 0xC9)) + struct.pack(
        ">b", code)


def _array_parts(x) -> tuple[tuple, str, memoryview]:
    """An array leaf → (shape, dtype name, its C-order bytes)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            raw = t.reshape(-1).view(torch.int16).numpy().view(np.uint8)
            return tuple(t.shape), "bfloat16", memoryview(raw)
        x = t.numpy()
    arr = np.asarray(x, order="C")   # keeps 0-d arrays 0-d
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not serialized")
    raw = memoryview(arr.reshape(-1).view(np.uint8)) if arr.size else \
        memoryview(b"")
    return arr.shape, arr.dtype.name, raw


class _Writer:
    def __init__(self, out):
        self.out = out          # a file or a bytearray's extend

    def write(self, b) -> None:
        self.out(b)

    def obj(self, x) -> None:
        if isinstance(x, np.generic):       # before float: np.float64 is one
            self.array(EXT_NPSCALAR, np.asarray(x))
        elif x is None:
            self.write(b"\xc0")
        elif x is True or x is False:
            self.write(b"\xc3" if x else b"\xc2")
        elif isinstance(x, int) and not isinstance(x, bool):
            self.write(_int(x))
        elif isinstance(x, float):
            self.write(b"\xcb" + struct.pack(">d", x))
        elif isinstance(x, str):
            b = x.encode("utf-8")
            self.write(_str_header(len(b)) + b)
        elif isinstance(x, (bytes, bytearray, memoryview)):
            b = memoryview(x).cast("B")
            self.write(_bin_header(len(b)))
            self.write(b)
        elif isinstance(x, dict):
            self.write(_len_header(len(x), 0x80, 15, (None, 0xDE, 0xDF)))
            # sorted, as flax's tree_map leaves the keys of a payload
            for k in sorted(x):
                self.obj(k)
                self.obj(x[k])
        elif isinstance(x, (list, tuple)):
            self.write(_len_header(len(x), 0x90, 15, (None, 0xDC, 0xDD)))
            for v in x:
                self.obj(v)
        elif isinstance(x, (np.ndarray, torch.Tensor)):
            self.array(EXT_NDARRAY, x)
        else:
            raise TypeError(f"cannot serialize {type(x).__name__}")

    def array(self, code: int, x) -> None:
        shape, name, raw = _array_parts(x)
        if len(raw) > MAX_ARRAY_BYTES:
            raise ValueError(
                f"an array of {len(raw)} bytes needs flax's chunked form "
                f"(over 1 GiB), which this writer does not produce")
        head = bytearray()
        inner = _Writer(head.extend)
        head += b"\x93"                     # (shape, dtype name, bytes)
        inner.obj([int(s) for s in shape])
        inner.obj(name)
        head += _bin_header(len(raw))
        self.write(_ext_header(code, len(head) + len(raw)))
        self.write(bytes(head))
        self.write(raw)


def packb(x) -> bytes:
    """Python objects → msgpack bytes, in flax's encoding of arrays."""
    out = bytearray()
    _Writer(out.extend).obj(x)
    return bytes(out)


def write_msgpack(path, tree) -> None:
    """Write ``tree`` as a flax-msgpack file, streaming each array's bytes
    from its own buffer."""
    with open(path, "wb") as f:
        _Writer(f.write).obj(tree)
