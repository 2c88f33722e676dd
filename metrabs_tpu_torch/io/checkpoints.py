"""Package msgpack files and train-state checkpoints
(`metrabs_tpu/io/checkpoints.py`).

`flax.serialization.msgpack_serialize` writes a msgpack map tree whose array
leaves are ext type 1 (ndarray: a packed (shape, dtype name, C-order bytes)
triple) and numpy scalars ext type 3 (same payload, 0-d). `loads` is a small
pure-Python decoder for exactly that subset: maps, arrays, str, bin, ints,
floats, nil, bool and those two ext types. Anything else raises, including
flax's chunked form for arrays over 1 GiB. `dumps` writes the same subset,
as `msgpack_serialize` does, so that the JAX package reads what the port
exports. Neither msgpack nor flax is needed.

Train states are saved in torch's own format (`torch.save` of plain
containers, restored with `weights_only=True`) with the JAX package's
policy: keep the newest 2, save every 2000 steps, and restore an explicit
`load_path` before the newest checkpoint of the directory before an
`init_path`.
"""

from __future__ import annotations

import os
import re
import struct
from typing import List, Optional

import numpy as np
import torch

from metrabs_tpu_torch.train.optim import OptState

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


def _pack(obj, out: bytearray) -> None:
    if obj is None or isinstance(obj, bool):
        out.append({None: 0xc0, False: 0xc2, True: 0xc3}[obj])
    elif isinstance(obj, int):
        if 0 <= obj <= 0x7f or -32 <= obj < 0:
            out += struct.pack('>b' if obj < 0 else '>B', obj)
        else:  # the smallest fitting form, as msgpack does
            forms = (((0xcc, '>B'), (0xcd, '>H'), (0xce, '>I'), (0xcf, '>Q')) if obj >= 0
                     else ((0xd0, '>b'), (0xd1, '>h'), (0xd2, '>i'), (0xd3, '>q')))
            for i, (code, fmt) in enumerate(forms):
                bits = 8 << i
                if (obj < 1 << bits) if obj >= 0 else (obj >= -(1 << (bits - 1))):
                    out += struct.pack('>B', code) + struct.pack(fmt, obj)
                    break
    elif isinstance(obj, float):
        out += struct.pack('>Bd', 0xcb, obj)
    elif isinstance(obj, str):
        _pack_sized(out, obj.encode('utf-8'), 0xa0, 31, (0xd9, 0xda, 0xdb))
    elif isinstance(obj, bytes):
        _pack_sized(out, obj, None, 0, (0xc4, 0xc5, 0xc6))
    elif isinstance(obj, dict):
        _pack_header(out, len(obj), 0x80, 15, (None, 0xde, 0xdf))
        for k in sorted(obj):  # flax's msgpack_serialize orders keys so
            _pack(k, out)
            _pack(obj[k], out)
    elif isinstance(obj, (list, tuple)):
        _pack_header(out, len(obj), 0x90, 15, (None, 0xdc, 0xdd))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, (np.ndarray, np.generic)):
        arr = np.asarray(obj)
        if arr.dtype.hasobject:
            raise ValueError('object arrays cannot be serialized')
        payload = bytearray()
        _pack([list(arr.shape), arr.dtype.name, arr.tobytes('C')], payload)
        code = _EXT_NDARRAY if isinstance(obj, np.ndarray) else _EXT_NPSCALAR
        _pack_sized(out, bytes(payload), None, 0, (0xc7, 0xc8, 0xc9), ext_code=code)
    else:
        raise TypeError(f'cannot serialize {type(obj).__name__}')


def _pack_header(out: bytearray, n: int, fix: Optional[int], fix_max: int, sized) -> None:
    if fix is not None and n <= fix_max:
        out.append(fix | n)
    elif sized[0] is not None and n <= 0xff:
        out += struct.pack('>BB', sized[0], n)
    elif n <= 0xffff:
        out += struct.pack('>BH', sized[1], n)
    else:
        out += struct.pack('>BI', sized[2], n)


def _pack_sized(out: bytearray, data: bytes, fix, fix_max, sized, ext_code=None) -> None:
    if ext_code is not None and len(data) in (1, 2, 4, 8, 16):
        out += struct.pack('>Bb', 0xd4 + (len(data).bit_length() - 1), ext_code)
    else:
        _pack_header(out, len(data), fix, fix_max, sized)
        if ext_code is not None:
            out += struct.pack('>b', ext_code)
    out += data


def dumps(obj) -> bytes:
    """Encodes `obj` (dicts with str keys, lists, str, bytes, numbers, numpy
    arrays and scalars) byte for byte as `flax.serialization.
    msgpack_serialize` does (arrays under 1 GiB)."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def export_model_msgpack(path: str, variables: dict, metadata: Optional[dict] = None) -> None:
    """Writes inference weights (a tree of numpy arrays, + JSON-able
    metadata) as the JAX package's `export_model_msgpack` does."""
    payload = {'variables': variables}
    if metadata is not None:
        payload['metadata'] = metadata
    with open(path, 'wb') as f:
        f.write(dumps(payload))


_CKPT = re.compile(r'(\d+)\.pt$')


class CheckpointManager:
    """Train-state checkpoints `<directory>/<step>.pt`: `save` writes at
    steps that are multiples of `save_interval_steps` and later than the
    newest, keeping the newest `keep`."""

    def __init__(self, directory: str, keep: int = 2, save_interval_steps: int = 2000):
        self.directory = os.path.abspath(directory)
        self.keep, self.save_interval_steps = keep, save_interval_steps

    def all_steps(self) -> List[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(m.group(1)) for f in os.listdir(self.directory)
                      if (m := _CKPT.fullmatch(f)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f'{step}.pt')

    def should_save(self, step: int) -> bool:
        latest = self.latest_step()
        return (latest is None or step > latest) and step % self.save_interval_steps == 0

    def save(self, step: int, state, force: bool = False) -> bool:
        """Saves `state` (a `train.loop.TrainState`) as step `step` if due, or
        with `force` at any step later than the newest (the final save off
        the interval); returns whether it did."""
        latest = self.latest_step()
        if not (self.should_save(step) or force and (latest is None or step > latest)):
            return False
        os.makedirs(self.directory, exist_ok=True)
        tmp = self.path(step) + '.tmp'
        torch.save(train_state_dict(state), tmp)
        os.replace(tmp, self.path(step))
        for old in self.all_steps()[:-self.keep]:
            os.remove(self.path(old))
        return True


def train_state_dict(state) -> dict:
    """The contents of a train-state checkpoint."""
    return dict(step=state.step, model=state.model.state_dict(),
                opt_state=state.opt_state.state_dict(), ema_params=state.ema_params)


def load_train_state_dict(state, d: dict) -> None:
    """Loads `train_state_dict`'s contents into `state` in place, on its
    device."""
    device = next(state.model.parameters()).device
    state.model.load_state_dict(d['model'])
    to_dev = lambda tree: {k: v.to(device) for k, v in tree.items()} if tree is not None else None
    opt = OptState.from_state_dict(d['opt_state'])
    for adam in opt.groups.values():
        adam.mu, adam.nu = to_dev(adam.mu), to_dev(adam.nu)
    opt.acc_grads = to_dev(opt.acc_grads)
    state.opt_state = opt
    state.ema_params = to_dev(d['ema_params'])
    state.step = d['step']


def restore_train_state(directory_or_manager, state, *, load_path: Optional[str] = None,
                        init_path: Optional[str] = None):
    """Restores into `state` with the reference's precedence: `load_path`,
    else the newest checkpoint of the directory, else `init_path`. Returns
    (state, restored step: -1 for `load_path`, 0 for `init_path`), or
    (None, 0) when there is nothing to restore."""
    manager = (directory_or_manager if isinstance(directory_or_manager, CheckpointManager)
               else CheckpointManager(directory_or_manager))
    latest = manager.latest_step()
    path, step = ((load_path, -1) if load_path
                  else (manager.path(latest), latest) if latest is not None
                  else (init_path, 0) if init_path else (None, 0))
    if path is None:
        return None, 0
    load_train_state_dict(state, torch.load(path, map_location='cpu', weights_only=True))
    return state, step
