"""Read-only loader for the package msgpack files (`metrabs_tpu/io/checkpoints.py`).

`flax.serialization.msgpack_serialize` writes a msgpack map tree whose array
leaves are ext type 1 (ndarray: a packed (shape, dtype name, C-order bytes)
triple) and numpy scalars ext type 3 (same payload, 0-d). This is a small
pure-Python decoder for exactly that subset: maps, arrays, str, bin, ints,
floats, nil, bool and those two ext types. Anything else raises, including
flax's chunked form for arrays over 1 GiB. Neither msgpack nor flax is
needed.
"""

from __future__ import annotations

import struct

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED_KEY = '__msgpack_chunked_array__'


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError('truncated msgpack data')
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self.unpack('>B')
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.read_map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self.read_array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return self.read_str(b & 0x1f)
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in simple:
            return simple[b]
        sized = {  # type byte -> (length format, reader)
            0xc4: ('>B', self.read_bin), 0xc5: ('>H', self.read_bin),
            0xc6: ('>I', self.read_bin),
            0xd9: ('>B', self.read_str), 0xda: ('>H', self.read_str),
            0xdb: ('>I', self.read_str),
            0xdc: ('>H', self.read_array), 0xdd: ('>I', self.read_array),
            0xde: ('>H', self.read_map), 0xdf: ('>I', self.read_map),
            0xc7: ('>B', self.read_ext), 0xc8: ('>H', self.read_ext),
            0xc9: ('>I', self.read_ext)}
        if b in sized:
            fmt, reader = sized[b]
            return reader(self.unpack(fmt))
        numbers = {0xca: '>f', 0xcb: '>d', 0xcc: '>B', 0xcd: '>H', 0xce: '>I',
                   0xcf: '>Q', 0xd0: '>b', 0xd1: '>h', 0xd2: '>i', 0xd3: '>q'}
        if b in numbers:
            return self.unpack(numbers[b])
        if 0xd4 <= b <= 0xd8:  # fixext 1, 2, 4, 8, 16
            return self.read_ext(1 << (b - 0xd4))
        raise ValueError(f'unsupported msgpack type byte 0x{b:02x}')

    def read_bin(self, n: int) -> bytes:
        return bytes(self.take(n))

    def read_str(self, n: int) -> str:
        return str(self.take(n), 'utf-8')

    def read_array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def read_map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        if _CHUNKED_KEY in out:
            raise ValueError('flax chunked arrays (leaves over 1 GiB) are not supported')
        return out

    def read_ext(self, n: int):
        code = self.unpack('>b')
        payload = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray_from_bytes(payload)
        if code == _EXT_NPSCALAR:
            return _ndarray_from_bytes(payload)[()]
        raise ValueError(f'unsupported msgpack ext type {code}')


def _ndarray_from_bytes(payload: bytes) -> np.ndarray:
    reader = _Reader(payload)
    triple = reader.read()
    if reader.pos != len(payload) or not isinstance(triple, list) or len(triple) != 3:
        raise ValueError('malformed ndarray payload')
    shape, dtype_name, buffer = triple
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    if dtype_name == 'bfloat16':
        # numpy has no bfloat16: widen exactly to float32.
        bits = np.frombuffer(buffer, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(shape).copy()


def loads(data: bytes):
    """Decodes one msgpack object from `data` (all of it)."""
    reader = _Reader(data)
    out = reader.read()
    if reader.pos != len(data):
        raise ValueError('trailing bytes after the msgpack object')
    return out


def load_model_msgpack(path: str) -> dict:
    with open(path, 'rb') as f:
        return loads(f.read())
