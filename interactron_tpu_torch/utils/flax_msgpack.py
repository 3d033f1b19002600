"""Reader of the checkpoints the JAX package writes (flax's
`serialization.to_bytes` / `msgpack_restore` format), in pure Python: the
port's machine has neither flax nor msgpack.

The subset of msgpack that flax writes: nil, bool, int, float, str, bin,
array, map, and two extension types, 1 (an ndarray: a nested msgpack
[shape, dtype name, row-major bytes]) and 3 (a numpy scalar, the same
payload with shape []). Arrays larger than flax's MAX_CHUNK_SIZE were split
into {"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}
dicts, which are joined back here. A bfloat16 array is widened to float32
(its bits shifted up by 16), exactly.

    restore(data) -> nested dicts of numpy arrays and Python scalars
    read(path)    -> restore(the file's bytes)
"""

import struct

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n):
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
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
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in scalars:
            return self.unpack(scalars[b])
        sizes = {0: ">B", 1: ">H", 2: ">I"}
        if 0xC4 <= b <= 0xC6:  # bin 8/16/32
            return bytes(self.take(self.unpack(sizes[b - 0xC4])))
        if 0xD9 <= b <= 0xDB:  # str 8/16/32
            return str(self.take(self.unpack(sizes[b - 0xD9])), "utf-8")
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            return self.ext(self.unpack(">b"), 1 << (b - 0xD4))
        if 0xC7 <= b <= 0xC9:  # ext 8/16/32
            n = self.unpack(sizes[b - 0xC7])
            return self.ext(self.unpack(">b"), n)
        raise ValueError(f"msgpack type byte {b:#x} is not in flax's subset")

    def array(self, n):
        return [self.value() for _ in range(n)]

    def map(self, n):
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, code, n):
        payload = self.take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack extension type {code} is not flax's ndarray or scalar")
        shape, dtype, raw = _Reader(payload).value()
        if isinstance(dtype, bytes):
            dtype = dtype.decode()
        if dtype == "bfloat16":
            bits = np.frombuffer(raw, dtype=np.uint16).astype(np.uint32) << 16
            arr = bits.view(np.float32)
        else:
            arr = np.frombuffer(raw, dtype=np.dtype(dtype)).copy()
        arr = arr.reshape(shape)
        return arr[()] if code == _EXT_NPSCALAR else arr


def _tuple(d):
    return tuple(d[str(i)] for i in range(len(d)))


def _unchunk(node):
    """flax's chunked-array dicts joined back into arrays, at any depth."""
    if not isinstance(node, dict):
        return node
    if _CHUNKED in node:
        return np.concatenate(_tuple(node["chunks"])).reshape(_tuple(node["shape"]))
    return {k: _unchunk(v) for k, v in node.items()}


def restore(data):
    """The tree that `flax.serialization.msgpack_restore(data)` returns, with
    bfloat16 arrays widened to float32."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk(tree)


def read(path):
    with open(path, "rb") as f:
        return restore(f.read())
