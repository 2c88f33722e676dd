"""HDF5 files without h5py: a reader of the subset that MATLAB v7.3 and
h5py's default (`libver='earliest'`) write, and a writer of prediction
dumps. Pure Python, numpy and zlib, after the public "HDF5 File Format
Specification Version 3.0".

Reader. `File(path)` has h5py's read-only surface as the drivers use it:
a context manager, `f[name]` for datasets and groups (paths with '/'),
`name in f`, `keys()`, iteration, `.attrs`, and for a dataset `.shape`,
`.dtype`, `np.asarray(ds)` and `ds[()]`. Arrays come back in the file's
dataspace order with the file's byte order, as h5py gives them (MATLAB's
column-major `[3, 17, 1, F]` reads as `[F, 1, 17, 3]`). Covered:

- superblock v0 and v1 after a user block (searched at 0, 512, 1024, ...;
  every file address is relative to the superblock, as libhdf5 reads it);
- symbol-table groups: v1 B-trees of type 0 at any depth, SNOD nodes and
  local heaps; version-1 object headers with continuation blocks;
- dataspace (v1, v2), datatype, fill value (old and v1-v3), layout v3
  (compact, contiguous, chunked with the v1 B-tree chunk index), filter
  pipeline v1/v2 and attribute (v1-v3) messages;
- fixed-point (1-8 bytes, signed or not, either byte order), IEEE floats
  of 2, 4 and 8 bytes, fixed-length strings (numpy `S`), variable-length
  strings from global-heap collections (object arrays of bytes; str in
  attributes, as h5py decodes them) and h5py's boolean enum;
- deflate, shuffle and Fletcher-32 (checked), honouring each chunk's
  filter mask; edge chunks cropped; unallocated storage reads as the fill
  value.

Everything else (superblock v2/v3, v2 object headers, new-style groups,
layout v4 chunk indexes, soft and external links, compound, reference,
array and other enum types, variable-length sequences, shared messages,
other filters) raises NotImplementedError naming the feature.

Writer. `write_hdf5(path, datasets, ...)` writes one root group of
datasets (superblock v0, v1 object headers, a symbol-table group) that
libhdf5, h5py and this reader read, as h5py writes them with
`compression='gzip'` (what `eval.harness.save_predictions_hdf5` needs):
numeric and boolean arrays chunked in h5py's guessed shape and deflated,
strings as variable-length UTF-8 in global-heap collections; optionally
attributes per dataset and a user block (MATLAB's layout).
"""

from __future__ import annotations

import math
import os
import struct
import zlib
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np

SIGNATURE = b'\x89HDF\r\n\x1a\n'

# Object header message types.
MSG_NIL = 0x0000
MSG_DATASPACE = 0x0001
MSG_LINK_INFO = 0x0002
MSG_DATATYPE = 0x0003
MSG_FILL_OLD = 0x0004
MSG_FILL = 0x0005
MSG_LINK = 0x0006
MSG_EXTERNAL = 0x0007
MSG_LAYOUT = 0x0008
MSG_GROUP_INFO = 0x000A
MSG_FILTERS = 0x000B
MSG_ATTRIBUTE = 0x000C
MSG_CONTINUATION = 0x0010
MSG_SYMBOL_TABLE = 0x0011
MSG_ATTRIBUTE_INFO = 0x0015

FILTER_DEFLATE, FILTER_SHUFFLE, FILTER_FLETCHER32 = 1, 2, 3

_CLASS_NAMES = {2: 'time', 4: 'bitfield', 5: 'opaque', 6: 'compound', 7: 'reference',
                10: 'array'}
# IEEE layouts: size -> (exponent location, exponent size, mantissa location,
# mantissa size, exponent bias).
_IEEE = {2: (10, 5, 0, 10, 15), 4: (23, 8, 0, 23, 127), 8: (52, 11, 0, 52, 1023)}


def _unsupported(feature: str):
    return NotImplementedError(f'HDF5 {feature} is not supported by this reader')


def _pad8(n: int) -> int:
    return (n + 7) & ~7


# --- datatypes ----------------------------------------------------------------

class _Type:
    """A datatype message: `storage` is the numpy dtype of the stored
    elements; `kind` is 'plain', 'vlen_str' or 'bool'."""

    def __init__(self, storage: np.dtype, kind: str = 'plain'):
        self.storage = storage
        self.kind = kind

    @property
    def dtype(self) -> np.dtype:
        """The dtype h5py reports."""
        if self.kind == 'vlen_str':
            return np.dtype(object)
        if self.kind == 'bool':
            return np.dtype(bool)
        return self.storage


def _parse_datatype(buf: bytes, pos: int, offset_size: int) -> Tuple[_Type, int]:
    """(type, bytes consumed) of the datatype message at buf[pos:]."""
    class_version, b0, b1, b2, size = struct.unpack_from('<BBBBI', buf, pos)
    cls, version = class_version & 0x0F, class_version >> 4
    bits = b0 | (b1 << 8) | (b2 << 16)
    props = pos + 8
    if cls == 0:  # fixed-point
        offset, precision = struct.unpack_from('<HH', buf, props)
        if size not in (1, 2, 4, 8) or offset != 0 or precision != 8 * size:
            raise _unsupported(f'fixed-point type of {size} bytes, offset {offset}, '
                               f'precision {precision}')
        order = '>' if bits & 1 else '<'
        return _Type(np.dtype(f'{order}{"i" if bits & 8 else "u"}{size}')), 12
    if cls == 1:  # floating point
        if bits & 0x40:
            raise _unsupported('VAX floating point')
        layout = struct.unpack_from('<HHBBBBI', buf, props)
        exp_loc, exp_size, man_loc, man_size, bias = layout[2:]
        if _IEEE.get(size) != (exp_loc, exp_size, man_loc, man_size, bias) or layout[0] != 0:
            raise _unsupported(f'non-IEEE floating point type of {size} bytes')
        return _Type(np.dtype(f'{">" if bits & 1 else "<"}f{size}')), 20
    if cls == 3:  # fixed-length string
        return _Type(np.dtype(f'S{size}')), 8
    if cls == 8:  # enum: only h5py's boolean
        n_members = bits & 0xFFFF
        base, used = _parse_datatype(buf, props, offset_size)
        p = props + used
        names = []
        for _ in range(n_members):
            end = buf.index(b'\0', p)
            names.append(buf[p:end].decode('ascii', 'replace'))
            p = end + 1 if version >= 3 else p + _pad8(end + 1 - p)
        values = np.frombuffer(buf, base.storage, n_members, p).tolist()
        p += n_members * base.storage.itemsize
        if base.storage.kind != 'i' or base.storage.itemsize != 1 or dict(
                zip(names, values)) != {'FALSE': 0, 'TRUE': 1}:
            raise _unsupported(f'enum type {dict(zip(names, values))} (only h5py\'s boolean)')
        return _Type(base.storage, 'bool'), p - pos
    if cls == 9:  # variable-length
        if bits & 0x0F != 1:
            raise _unsupported('variable-length sequence type')
        _, used = _parse_datatype(buf, props, offset_size)
        storage = np.dtype([('length', '<u4'), ('collection', f'<u{offset_size}'),
                            ('index', '<u4')])
        return _Type(storage, 'vlen_str'), 8 + used
    raise _unsupported(f'{_CLASS_NAMES.get(cls, f"class {cls}")} datatype')


def _parse_dataspace(buf: bytes, pos: int, length_size: int) -> Optional[Tuple[int, ...]]:
    """The dataspace's shape: () for a scalar, None for a null dataspace."""
    version, rank, flags = struct.unpack_from('<BBB', buf, pos)
    if version == 1:
        dims_at = pos + 8
    elif version == 2:
        kind = buf[pos + 3]
        if kind == 2:
            return None
        dims_at = pos + 4
    else:
        raise _unsupported(f'dataspace message version {version}')
    fmt = '<' + ('Q' if length_size == 8 else 'I') * rank
    return tuple(int(d) for d in struct.unpack_from(fmt, buf, dims_at))


# --- the file -------------------------------------------------------------------

class _Reader:
    """Addresses, sizes and the structures shared by every object of one
    file: superblock, heaps and object headers."""

    def __init__(self, fh):
        self.fh = fh
        fh.seek(0, os.SEEK_END)
        self.file_size = fh.tell()
        self.base = self._find_superblock()
        head = self.read_abs(self.base, 24)
        version = head[8]
        if version > 1:
            raise _unsupported(f'superblock version {version} (files written with '
                               f"libver='latest' or v110+)")
        self.offset_size, self.length_size = head[13], head[14]
        if self.offset_size not in (4, 8) or self.length_size not in (4, 8):
            raise _unsupported(f'offset size {self.offset_size} / length size '
                               f'{self.length_size}')
        self.undefined = (1 << (8 * self.offset_size)) - 1
        pos = 24 + (4 if version == 1 else 0)
        self._o = 'Q' if self.offset_size == 8 else 'I'
        self._l = 'Q' if self.length_size == 8 else 'I'
        tail = self.read_abs(self.base + pos, 4 * self.offset_size + self._entry_size())
        self.root_address = self._symbol_entry(tail, 4 * self.offset_size)[1]
        self._heaps: Dict[int, bytes] = {}
        self._collections: Dict[int, Dict[int, bytes]] = {}

    def _find_superblock(self) -> int:
        at = 0
        while at + 8 <= self.file_size:
            self.fh.seek(at)
            if self.fh.read(8) == SIGNATURE:
                return at
            at = 512 if at == 0 else 2 * at
        raise ValueError('not an HDF5 file: no superblock signature at 0, 512, 1024, ...')

    def _entry_size(self) -> int:
        return 2 * self.offset_size + 24

    def read_abs(self, address: int, n: int) -> bytes:
        if address + n > self.file_size:
            raise ValueError(f'HDF5 structure at {address} (+{n} bytes) lies past the end '
                             f'of the file ({self.file_size} bytes): truncated file')
        self.fh.seek(address)
        return self.fh.read(n)

    def read(self, address: int, n: int) -> bytes:
        """n bytes at a file address (relative to the superblock)."""
        return self.read_abs(self.base + address, n)

    def unpack(self, fmt: str, buf: bytes, pos: int):
        return struct.unpack_from('<' + fmt.replace('O', self._o).replace('L', self._l),
                                  buf, pos)

    def _symbol_entry(self, buf: bytes, pos: int):
        """(link name offset, object header address, cache type) of a symbol
        table entry."""
        return self.unpack('OOI', buf, pos)

    # Local heaps and global heap collections.
    def local_heap(self, address: int) -> bytes:
        if address not in self._heaps:
            head = self.read(address, 8 + 2 * self.length_size + self.offset_size)
            if head[:4] != b'HEAP':
                raise ValueError(f'no local heap at {address}')
            size, _, data = self.unpack('LLO', head, 8)
            self._heaps[address] = self.read(data, size)
        return self._heaps[address]

    def heap_string(self, heap: bytes, offset: int) -> str:
        return heap[offset:heap.index(b'\0', offset)].decode('utf-8')

    def collection(self, address: int) -> Dict[int, bytes]:
        if address not in self._collections:
            head = self.read(address, 8 + self.length_size)
            if head[:4] != b'GCOL':
                raise ValueError(f'no global heap collection at {address}')
            size, = self.unpack('L', head, 8)
            data = self.read(address, size)
            objects, pos = {}, 8 + self.length_size
            while pos + 8 + self.length_size <= size:
                index, = struct.unpack_from('<H', data, pos)
                n, = self.unpack('L', data, pos + 8)
                if index == 0:
                    break
                start = pos + 8 + self.length_size
                objects[index] = data[start:start + n]
                pos = start + _pad8(n)
            self._collections[address] = objects
        return self._collections[address]

    def vlen_strings(self, refs: np.ndarray) -> List[bytes]:
        out = []
        for length, address, index in refs.reshape(-1).tolist():
            if length == 0:
                out.append(b'')
            else:
                out.append(self.collection(address)[index][:length])
        return out

    # Object headers.
    def messages(self, address: int) -> List[Tuple[int, int, bytes]]:
        """(type, flags, data) of every message of the version-1 object
        header at `address`, continuation blocks included."""
        prefix = self.read(address, 16)
        if prefix[:4] == b'OHDR':
            raise _unsupported('version-2 object header')
        if prefix[0] != 1:
            raise _unsupported(f'object header version {prefix[0]}')
        size, = struct.unpack_from('<I', prefix, 8)
        blocks, out = [(address + 16, size)], []
        while blocks:
            start, n = blocks.pop(0)
            buf = self.read(start, n)
            pos = 0
            while pos + 8 <= n:
                mtype, msize, flags = struct.unpack_from('<HHB', buf, pos)
                data = buf[pos + 8:pos + 8 + msize]
                pos += 8 + msize
                if flags & 0x02:
                    raise _unsupported('shared object header message (committed datatype)')
                if mtype == MSG_CONTINUATION:
                    blocks.append(self.unpack('OL', data, 0))
                elif mtype != MSG_NIL:
                    out.append((mtype, flags, data))
        return out

    def open_object(self, address: int, name: str):
        msgs = self.messages(address)
        types = {m[0] for m in msgs}
        if types & {MSG_LINK_INFO, MSG_LINK, MSG_GROUP_INFO}:
            raise _unsupported(f'new-style group {name!r} (link messages)')
        if MSG_SYMBOL_TABLE in types:
            return Group(self, name, msgs)
        if MSG_LAYOUT in types:
            return Dataset(self, name, msgs)
        raise _unsupported(f'object {name!r} that is neither a group nor a dataset')

    # v1 B-trees.
    def btree_leaves(self, address: int, node_type: int, key_size: int
                     ) -> Iterator[Tuple[bytes, int]]:
        """(left key, child address) of every level-0 entry of the v1 B-tree
        at `address`, in key order."""
        o = self.offset_size
        head = self.read(address, 8 + 2 * o)
        if head[:4] != b'TREE' or head[4] != node_type:
            raise ValueError(f'no v1 B-tree of type {node_type} at {address}')
        level, used = head[5], struct.unpack_from('<H', head, 6)[0]
        body = self.read(address + 8 + 2 * o, used * (key_size + o) + key_size)
        for i in range(used):
            pos = i * (key_size + o)
            key = body[pos:pos + key_size]
            child, = self.unpack('O', body, pos + key_size)
            if level == 0:
                yield key, child
            else:
                yield from self.btree_leaves(child, node_type, key_size)


class Attributes(Mapping):
    """`obj.attrs`: read-only, values as h5py returns them."""

    def __init__(self, reader: _Reader, messages):
        self._reader = reader
        self._raw = {}
        for mtype, _, data in messages:
            if mtype == MSG_ATTRIBUTE:
                name, value = self._parse(data)
                self._raw[name] = value
            elif mtype == MSG_ATTRIBUTE_INFO:
                fractal_heap, = reader.unpack('O', data, 2 + (2 if data[1] & 1 else 0))
                if fractal_heap != reader.undefined:
                    raise _unsupported('dense attribute storage')

    def _parse(self, data: bytes):
        version = data[0]
        name_size, type_size, space_size = struct.unpack_from('<HHH', data, 2)
        pos = 8 + (1 if version == 3 else 0)
        pad = _pad8 if version == 1 else (lambda n: n)
        if version not in (1, 2, 3):
            raise _unsupported(f'attribute message version {version}')
        name = data[pos:pos + name_size].split(b'\0', 1)[0].decode('utf-8')
        pos += pad(name_size)
        dtype, _ = _parse_datatype(data, pos, self._reader.offset_size)
        pos += pad(type_size)
        shape = _parse_dataspace(data, pos, self._reader.length_size)
        pos += pad(space_size)
        return name, (dtype, shape, data[pos:])

    def __getitem__(self, name: str):
        dtype, shape, raw = self._raw[name]
        if shape is None:
            raise _unsupported(f'attribute {name!r} with a null dataspace')
        n = math.prod(shape)
        values = np.frombuffer(raw, dtype.storage, n).reshape(shape)
        if dtype.kind == 'vlen_str':
            strings = [s.decode('utf-8') for s in self._reader.vlen_strings(values)]
            values = np.array(strings, object).reshape(shape)
        elif dtype.kind == 'bool':
            values = values.astype(bool)
        return values[()] if shape == () else values.copy()

    def __iter__(self):
        return iter(self._raw)

    def __len__(self):
        return len(self._raw)


class _Object:
    def __init__(self, reader: _Reader, name: str, messages):
        self._reader = reader
        self.name = name
        self._messages = messages
        self.attrs = Attributes(reader, messages)


class Group(_Object, Mapping):
    """A symbol-table group: its members by name, in the file's name order."""

    def __init__(self, reader: _Reader, name: str, messages):
        super().__init__(reader, name, messages)
        data = next(d for t, _, d in messages if t == MSG_SYMBOL_TABLE)
        btree, heap_address = reader.unpack('OO', data, 0)
        heap = reader.local_heap(heap_address)
        self._members: Dict[str, Tuple[int, int]] = {}
        entry = reader._entry_size()
        for _, snod in reader.btree_leaves(btree, 0, reader.length_size):
            head = reader.read(snod, 8)
            if head[:4] != b'SNOD':
                raise ValueError(f'no symbol table node at {snod}')
            n, = struct.unpack_from('<H', head, 6)
            body = reader.read(snod + 8, n * entry)
            for i in range(n):
                name_off, header, cache = reader._symbol_entry(body, i * entry)
                self._members[reader.heap_string(heap, name_off)] = (header, cache)

    def __getitem__(self, path: str):
        obj = self
        for part in [p for p in path.split('/') if p]:
            if not isinstance(obj, Group):
                raise KeyError(f'{obj.name!r} is a dataset, not a group: {path!r}')
            if part not in obj._members:
                raise KeyError(f'no member {part!r} in {obj.name!r}')
            header, cache = obj._members[part]
            if cache == 2:
                raise _unsupported(f'soft link {part!r}')
            obj = obj._reader.open_object(header, f'{obj.name.rstrip("/")}/{part}')
        return obj

    def __contains__(self, path) -> bool:
        """Whether `path` names a member (its object is not opened)."""
        *parents, last = [p for p in path.split('/') if p] or ['']
        try:
            group = self['/'.join(parents)] if parents else self
        except KeyError:
            return False
        return isinstance(group, Group) and last in group._members

    def __iter__(self):
        return iter(self._members)

    def __len__(self):
        return len(self._members)



class Dataset(_Object):
    """A dataset: `.shape`, `.dtype`, `.attrs`; `np.asarray(ds)`, `ds[()]` and
    `ds[index]` read the whole array."""

    def __init__(self, reader: _Reader, name: str, messages):
        super().__init__(reader, name, messages)
        by_type = {}
        for mtype, _, data in messages:
            by_type.setdefault(mtype, data)
        if MSG_EXTERNAL in by_type:
            raise _unsupported('external data storage')
        self._type, _ = _parse_datatype(by_type[MSG_DATATYPE], 0, reader.offset_size)
        self.shape = _parse_dataspace(by_type[MSG_DATASPACE], 0, reader.length_size)
        if self.shape is None:
            raise _unsupported(f'null dataspace of {name!r}')
        self._layout = by_type[MSG_LAYOUT]
        self._filters = (_parse_filters(by_type[MSG_FILTERS]) if MSG_FILTERS in by_type
                         else [])
        self._fill = _fill_bytes(by_type, self._type.storage.itemsize)

    @property
    def dtype(self) -> np.dtype:
        return self._type.dtype

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def __len__(self):
        if not self.shape:
            raise TypeError('len() of a scalar dataset')
        return self.shape[0]

    def __array__(self, dtype=None, copy=None):
        out = self.read()
        return out if dtype is None else out.astype(dtype)

    def __getitem__(self, index):
        out = self.read()
        return out[()] if index == () and out.ndim == 0 else out[index]

    def read(self) -> np.ndarray:
        storage = self._type.storage
        n = self.size
        version, layout_class = self._layout[0], self._layout[1]
        if version != 3:
            raise _unsupported(f'layout message version {version}'
                               + (" (chunk indexes of libver='latest')" if version == 4
                                  else ''))
        if layout_class == 0:  # compact: the data follow its 2-byte size
            raw = np.frombuffer(self._layout, storage, n, 4)
        elif layout_class == 1:  # contiguous
            address, _ = self._reader.unpack('OL', self._layout, 2)
            if address == self._reader.undefined or n == 0:
                raw = self._filled(n)
            else:
                raw = np.frombuffer(self._reader.read(address, n * storage.itemsize), storage)
        elif layout_class == 2:
            raw = self._read_chunked()
        else:
            raise _unsupported(f'layout class {layout_class}')
        raw = raw.reshape(self.shape)
        if self._type.kind == 'vlen_str':
            strings = np.empty(raw.size, object)
            strings[:] = self._reader.vlen_strings(raw)
            return strings.reshape(self.shape)
        if self._type.kind == 'bool':
            return raw.astype(bool)
        return raw.copy()

    def _filled(self, n: int) -> np.ndarray:
        storage = self._type.storage
        if self._fill is None:
            return np.zeros(n, storage)
        return np.repeat(np.frombuffer(self._fill, storage, 1), n)

    def _read_chunked(self) -> np.ndarray:
        reader = self._reader
        rank = self._layout[2] - 1
        btree, = reader.unpack('O', self._layout, 3)
        pos = 3 + reader.offset_size
        chunk = struct.unpack_from(f'<{rank + 1}I', self._layout, pos)[:rank]
        storage = self._type.storage
        out = self._filled(self.size).reshape(self.shape)
        if btree == reader.undefined or self.size == 0:
            return out
        key_size = 8 + 8 * (rank + 1)
        for key, address in reader.btree_leaves(btree, 1, key_size):
            size, mask = struct.unpack_from('<II', key, 0)
            offsets = struct.unpack_from(f'<{rank}Q', key, 8)
            data = _unfilter(reader.read(address, size), self._filters, mask,
                             storage.itemsize)
            values = np.frombuffer(data, storage, math.prod(chunk)).reshape(chunk)
            region = tuple(slice(o, min(o + c, s)) for o, c, s in zip(offsets, chunk, self.shape))
            out[region] = values[tuple(slice(0, r.stop - r.start) for r in region)]
        return out


def _parse_filters(data: bytes) -> List[Tuple[int, int, Tuple[int, ...]]]:
    """(filter id, flags, client data) of each filter of a pipeline message."""
    version, n = data[0], data[1]
    if version not in (1, 2):
        raise _unsupported(f'filter pipeline message version {version}')
    pos = 8 if version == 1 else 2
    out = []
    for _ in range(n):
        fid, = struct.unpack_from('<H', data, pos)
        if version == 1 or fid >= 256:
            name_len, flags, n_values = struct.unpack_from('<HHH', data, pos + 2)
            pos += 8
        else:
            name_len = 0
            flags, n_values = struct.unpack_from('<HH', data, pos + 2)
            pos += 6
        pos += _pad8(name_len) if version == 1 else name_len
        values = struct.unpack_from(f'<{n_values}I', data, pos)
        pos += 4 * n_values + (4 if version == 1 and n_values % 2 else 0)
        if fid not in (FILTER_DEFLATE, FILTER_SHUFFLE, FILTER_FLETCHER32):
            raise _unsupported(f'filter {fid}')
        out.append((fid, flags, values))
    return out


def _fill_bytes(by_type: dict, itemsize: int) -> Optional[bytes]:
    """The fill value's bytes, or None for the default (zeros)."""
    if MSG_FILL in by_type:
        data = by_type[MSG_FILL]
        version = data[0]
        if version in (1, 2):
            defined = data[3]
            if version == 1 or defined:
                size, = struct.unpack_from('<I', data, 4)
                return data[8:8 + size] if size == itemsize else None
            return None
        if version == 3:
            if data[1] & 0x20:
                size, = struct.unpack_from('<I', data, 2)
                return data[6:6 + size] if size == itemsize else None
            return None
        raise _unsupported(f'fill value message version {version}')
    if MSG_FILL_OLD in by_type:
        data = by_type[MSG_FILL_OLD]
        size, = struct.unpack_from('<I', data, 0)
        return data[4:4 + size] if size == itemsize else None
    return None


def fletcher32(data: bytes) -> int:
    """HDF5's Fletcher-32 checksum (H5_checksum_fletcher32): sums of big-endian
    16-bit words modulo 65535, a trailing odd byte as the high half of one
    more word."""
    if len(data) % 2:
        data = data + b'\0'
    words = np.frombuffer(data, '>u2').astype(np.uint64)
    n = len(words)
    sum1 = int(words.sum() % 65535)
    weights = (np.arange(n, 0, -1, dtype=np.uint64) % 65535)
    sum2 = int((words * weights).sum() % 65535)
    return (sum2 << 16) | sum1


def _unfilter(data: bytes, filters, mask: int, itemsize: int) -> bytes:
    for i in reversed(range(len(filters))):
        if mask & (1 << i):
            continue
        fid, _, values = filters[i]
        if fid == FILTER_DEFLATE:
            data = zlib.decompress(data)
        elif fid == FILTER_SHUFFLE:
            size = values[0] if values else itemsize
            data = _unshuffle(data, size)
        else:
            stored, = struct.unpack('<I', data[-4:])
            data = data[:-4]
            want = fletcher32(data)
            # libhdf5 before 1.6.3 stored the two halves' bytes swapped.
            swapped = struct.unpack('<I', struct.pack('>I', want))[0]
            reduce = lambda c: ((c >> 16) % 65535, (c & 0xFFFF) % 65535)
            if reduce(stored) != reduce(want) and reduce(stored) != reduce(swapped):
                raise ValueError('HDF5 chunk fails its Fletcher-32 checksum')
    return data


def _unshuffle(data: bytes, size: int) -> bytes:
    if size <= 1:
        return data
    n = len(data) // size
    body = np.frombuffer(data, np.uint8, n * size).reshape(size, n).T.tobytes()
    return body + data[n * size:]


class File(Group):
    """An HDF5 file opened for reading: its root group."""

    def __init__(self, path, mode: str = 'r'):
        if mode != 'r':
            raise ValueError(f"mode {mode!r}: this reader opens files with 'r' only "
                             f'(write_hdf5 writes them)')
        self.filename = os.fspath(path)
        self._fh = open(self.filename, 'rb')
        try:
            reader = _Reader(self._fh)
            msgs = reader.messages(reader.root_address)
            if not any(t == MSG_SYMBOL_TABLE for t, _, _ in msgs):
                raise _unsupported('root group without a symbol table (new-style group)')
            super().__init__(reader, '/', msgs)
        except BaseException:
            self._fh.close()
            raise

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# --- the writer -------------------------------------------------------------------

# The v0 superblock's B-tree widths: libhdf5's defaults (group leaf node K 4,
# group internal node K 16, indexed storage K 32).
_LEAF_K, _INTERNAL_K, _CHUNK_K = 4, 16, 32
_UNDEFINED = 0xFFFFFFFFFFFFFFFF
_GCOL_MIN = 4096
GZIP_LEVEL = 4  # h5py's level for compression='gzip'
_HEAP_FREE_NULL = 1  # a local heap without free blocks (libhdf5's H5HL_FREE_NULL)
CHUNK_BASE, CHUNK_MIN, CHUNK_MAX = 16 * 1024, 8 * 1024, 1024 * 1024


def guess_chunk(shape: Sequence[int], typesize: int) -> Tuple[int, ...]:
    """h5py's chunk shape for a dataset (`h5py._hl.filters.guess_chunk` with
    maxshape None): halve the axes in turn until the chunk is near a target
    size that grows with the dataset."""
    shape = tuple(x if x != 0 else 1024 for x in shape)
    ndims = len(shape)
    chunks = np.array(shape, dtype='=f8')
    if not np.all(np.isfinite(chunks)):
        raise ValueError('Illegal value in chunk tuple')
    dset_size = np.prod(chunks) * typesize
    target_size = CHUNK_BASE * (2 ** np.log10(dset_size / (1024. * 1024)))
    if target_size > CHUNK_MAX:
        target_size = CHUNK_MAX
    elif target_size < CHUNK_MIN:
        target_size = CHUNK_MIN
    idx = 0
    while True:
        chunk_bytes = np.prod(chunks) * typesize
        if (chunk_bytes < target_size or abs(chunk_bytes - target_size) / target_size < 0.5) \
                and chunk_bytes < CHUNK_MAX:
            break
        if np.prod(chunks) == 1:
            break
        chunks[idx % ndims] = np.ceil(chunks[idx % ndims] / 2.0)
        idx += 1
    return tuple(int(x) for x in chunks)


class _Out:
    """The file being written: bytes appended at addresses relative to the
    superblock."""

    def __init__(self):
        self.buf = bytearray()

    def put(self, data: bytes, align: int = 8) -> int:
        self.buf += b'\0' * (-len(self.buf) % align)
        address = len(self.buf)
        self.buf += data
        return address


def _type_message(dtype: np.dtype) -> bytes:
    """The datatype message of a numpy dtype the writer stores."""
    if dtype.kind in 'iu':
        bits = (1 if dtype.byteorder == '>' else 0) | (8 if dtype.kind == 'i' else 0)
        return struct.pack('<BBBBIHH', 0x10, bits, 0, 0, dtype.itemsize, 0,
                           8 * dtype.itemsize)
    if dtype.kind == 'f':
        if dtype.itemsize not in _IEEE:
            raise TypeError(f'no HDF5 IEEE type for {dtype}')
        exp_loc, exp_size, man_loc, man_size, bias = _IEEE[dtype.itemsize]
        bits = (1 if dtype.byteorder == '>' else 0) | 0x20 | ((8 * dtype.itemsize - 1) << 8)
        return struct.pack('<BBBBIHHBBBBI', 0x11, bits & 0xFF, bits >> 8, 0, dtype.itemsize,
                           0, 8 * dtype.itemsize, exp_loc, exp_size, man_loc, man_size, bias)
    if dtype.kind == 'b':  # h5py's boolean: an enum of int8 FALSE = 0, TRUE = 1
        base = _type_message(np.dtype('i1'))
        names = b''.join(n + b'\0' * (_pad8(len(n) + 1) - len(n)) for n in (b'FALSE', b'TRUE'))
        return struct.pack('<BBBBI', 0x18, 2, 0, 0, 1) + base + names + bytes([0, 1])
    if dtype.kind == 'S':  # null-padded ASCII, as h5py writes numpy's S
        return struct.pack('<BBBBI', 0x13, 1, 0, 0, dtype.itemsize)
    raise TypeError(f'no HDF5 type written for {dtype}')


# A variable-length UTF-8 string (h5py.string_dtype('utf-8')): null-terminated,
# its base type a one-byte UTF-8 string.
_VLEN_UTF8 = (struct.pack('<BBBBI', 0x19, 0x01, 0x01, 0, 16)
              + struct.pack('<BBBBI', 0x13, 0x10, 0, 0, 1))


def _space_message(shape: Tuple[int, ...]) -> bytes:
    """A version-1 dataspace: rank 0 is a scalar; dimensions and maximum
    dimensions (equal) otherwise."""
    dims = struct.pack(f'<{len(shape)}Q', *shape)
    return struct.pack('<BBBBI', 1, len(shape), 1 if shape else 0, 0, 0) + dims + dims


def _header(messages: Sequence[Tuple[int, bytes]]) -> bytes:
    """A version-1 object header holding `messages` (type, data)."""
    body = b''.join(struct.pack('<HHB3x', t, _pad8(len(d)), 0) + d + b'\0' * (
        _pad8(len(d)) - len(d)) for t, d in messages)
    return struct.pack('<BBHII4x', 1, 0, len(messages), 1, len(body)) + body


def _attribute_message(name: str, value) -> bytes:
    """A version-1 attribute message: numbers, booleans and strings (as
    fixed-length bytes)."""
    value = np.asarray(value)
    if value.dtype.kind == 'U':
        value = np.char.encode(value, 'utf-8')
    value = value.astype(_storage_dtype(value))
    dtype_msg = _type_message(value.dtype)
    space = _space_message(value.shape)
    name_b = name.encode('utf-8') + b'\0'
    pad = lambda b: b + b'\0' * (_pad8(len(b)) - len(b))
    return (struct.pack('<BBHHH', 1, 0, len(name_b), len(dtype_msg), len(space))
            + pad(name_b) + pad(dtype_msg) + pad(space) + value.tobytes())


def _storage_dtype(value: np.ndarray) -> np.dtype:
    """The dtype stored for a numeric array: its own, native order made
    explicit."""
    dtype = value.dtype
    if dtype.kind in 'iuf' and dtype.byteorder == '=':
        return dtype.newbyteorder('<' if np.little_endian else '>')
    return dtype


def _btree(out: _Out, node_type: int, keys: List[bytes], children: List[int], k: int,
           key_size: int) -> int:
    """A v1 B-tree over `children` (len(keys) == len(children) + 1) with at
    most 2k entries per node; the root's address."""
    level = 0
    while True:
        nodes_keys, nodes_children = [], []
        for start in range(0, max(len(children), 1), 2 * k):
            ch = children[start:start + 2 * k]
            ks = keys[start:start + len(ch) + 1]
            body = b''.join(ks[i] + struct.pack('<Q', c) for i, c in enumerate(ch)) + ks[len(ch)]
            # Room for a full node, as libhdf5 reads nodes whole.
            body += b'\0' * ((2 * k) * (key_size + 8) + key_size - len(body))
            address = out.put(b'TREE' + struct.pack('<BBHQQ', node_type, level, len(ch),
                                                    _UNDEFINED, _UNDEFINED) + body)
            nodes_keys.append(ks[0])
            nodes_children.append(address)
            last_key = ks[len(ch)]
        if len(nodes_children) == 1:
            return nodes_children[0]
        keys, children = nodes_keys + [last_key], nodes_children
        level += 1


def _chunked(out: _Out, value: np.ndarray) -> Tuple[bytes, bytes]:
    """Writes `value` in chunks of h5py's guessed shape, each deflated at
    GZIP_LEVEL, and their B-tree: (layout message, filter pipeline message)."""
    rank = value.ndim
    itemsize = value.dtype.itemsize
    chunks = guess_chunk(value.shape, itemsize)
    keys, children = [], []
    grid = [range(0, s, c) for s, c in zip(value.shape, chunks)]
    for offsets in np.ndindex(*[len(g) for g in grid]) if value.size else []:
        start = [g[i] for g, i in zip(grid, offsets)]
        block = np.zeros(chunks, value.dtype)
        region = tuple(slice(s, min(s + c, d)) for s, c, d in zip(start, chunks, value.shape))
        block[tuple(slice(0, r.stop - r.start) for r in region)] = value[region]
        data = zlib.compress(block.tobytes(), GZIP_LEVEL)
        children.append(out.put(data, align=1))
        keys.append(struct.pack(f'<II{rank + 1}Q', len(data), 0, *start, 0))
    if children:
        keys.append(struct.pack(f'<II{rank + 1}Q', 0, 0,
                                *[len(g) * c for g, c in zip(grid, chunks)], 0))
        btree = _btree(out, 1, keys, children, _CHUNK_K, 8 + 8 * (rank + 1))
    else:
        btree = _UNDEFINED
    layout = struct.pack(f'<BBBQ{rank + 1}I', 3, 2, rank + 1, btree, *chunks, itemsize)
    deflate = struct.pack('<HHHHII', FILTER_DEFLATE, 0, 1, 1, GZIP_LEVEL, 0)  # optional, 1 value
    return layout, struct.pack('<BB6x', 1, 1) + deflate


def _strings(out: _Out, value: np.ndarray) -> bytes:
    """Writes a string array's elements into global heap collections and
    returns the heap references, one 16-byte element each."""
    encoded = []
    for s in value.reshape(-1).tolist():
        if not isinstance(s, (str, bytes)):
            raise TypeError(f'a string array holds {type(s).__name__} {s!r}')
        encoded.append(s.encode('utf-8') if isinstance(s, str) else s)
    refs = bytearray()
    for start in range(0, len(encoded), 65535):  # a collection's object indices are 16-bit
        part = encoded[start:start + 65535]
        objects = b''.join(struct.pack('<HH4xQ', i + 1, 1, len(s)) + s + b'\0' * (
            _pad8(len(s)) - len(s)) for i, s in enumerate(part))
        size = max(_GCOL_MIN, 16 + len(objects) + 16)
        free = size - 16 - len(objects)
        address = out.put(b'GCOL' + struct.pack('<B3xQ', 1, size) + objects
                          + struct.pack('<HH4xQ', 0, 0, free) + b'\0' * (free - 16))
        refs += b''.join(struct.pack('<IQI', len(s), address, i + 1) for i, s in enumerate(part))
    return bytes(refs)


def _dataset(out: _Out, value, attrs: Mapping) -> int:
    """Writes one dataset; the address of its object header."""
    value = np.asarray(value)
    if value.dtype.kind in 'UO':
        data = _strings(out, value)
        address = out.put(data) if data else _UNDEFINED
        messages = [(MSG_DATASPACE, _space_message(value.shape)), (MSG_DATATYPE, _VLEN_UTF8),
                    (MSG_FILL, struct.pack('<BBBB', 2, 2, 2, 0)),
                    (MSG_LAYOUT, struct.pack('<BBQQ', 3, 1, address, len(data)))]
    else:
        if value.dtype.kind not in 'iufbS':
            raise TypeError(f'no HDF5 type written for {value.dtype}')
        if value.ndim == 0:  # h5py's refusal of compression on a scalar
            raise TypeError("Scalar datasets don't support chunk/filter options")
        value = value.astype(_storage_dtype(value))
        layout, pipeline = _chunked(out, value)
        messages = [(MSG_DATASPACE, _space_message(value.shape)),
                    (MSG_DATATYPE, _type_message(value.dtype)),
                    (MSG_FILL, struct.pack('<BBBBI', 2, 2, 2, 1, value.dtype.itemsize)
                     + b'\0' * value.dtype.itemsize),
                    (MSG_LAYOUT, layout), (MSG_FILTERS, pipeline)]
    messages += [(MSG_ATTRIBUTE, _attribute_message(k, v)) for k, v in attrs.items()]
    return out.put(_header(messages))


def write_hdf5(path, datasets: Mapping[str, object], *,
               attrs: Optional[Mapping[str, Mapping[str, object]]] = None,
               userblock_size: int = 0) -> None:
    """Writes `datasets` (name -> array) as the members of the root group,
    as h5py's `create_dataset(name, data=value, compression='gzip')` writes
    them: numeric and boolean arrays chunked in h5py's guessed shape and
    deflated at GZIP_LEVEL (a scalar raises TypeError, as there); string
    arrays (numpy `U`, or objects of str or bytes) as variable-length UTF-8,
    contiguous. `attrs[name]` are the dataset's attributes (numbers; strings
    as fixed-length bytes, MATLAB's `MATLAB_class`). `userblock_size` bytes
    (0 or a power of two from 512) of zeros precede the superblock, as
    MATLAB writes its header there."""
    if userblock_size and (userblock_size < 512 or userblock_size & (userblock_size - 1)):
        raise ValueError(f'userblock_size {userblock_size}: 0 or a power of two >= 512')
    names = sorted(datasets, key=lambda n: n.encode('utf-8'))
    for name in names:
        if not name or '/' in name or '\0' in name:
            raise ValueError(f'dataset name {name!r}: one non-empty path component')
    if len(names) > 2 * _LEAF_K * 2 * _INTERNAL_K:
        raise NotImplementedError(f'{len(names)} members: the writer builds a one-level group')
    attrs = attrs or {}
    out = _Out()
    superblock_size = 8 + 16 + 4 * 8 + 40
    out.put(b'\0' * superblock_size)
    headers = [_dataset(out, datasets[n], attrs.get(n, {})) for n in names]

    # The root group: a local heap of the names, symbol table nodes of at
    # most 2 * leaf K entries and one B-tree over them.
    heap = bytearray(b'\0' * 8)  # offset 0: the empty name
    offsets = []
    for n in names:
        offsets.append(len(heap))
        b = n.encode('utf-8') + b'\0'
        heap += b + b'\0' * (_pad8(len(b)) - len(b))
    heap_data = out.put(bytes(heap))
    heap_address = out.put(b'HEAP' + struct.pack('<B3xQQQ', 0, len(heap), _HEAP_FREE_NULL,
                                                 heap_data))
    entry = lambda off, header: struct.pack('<QQI4x16x', off, header, 0)
    keys, snods = [struct.pack('<Q', 0)], []
    for start in range(0, len(names), 2 * _LEAF_K):
        part = list(range(start, min(start + 2 * _LEAF_K, len(names))))
        body = b''.join(entry(offsets[i], headers[i]) for i in part)
        body += b'\0' * (2 * _LEAF_K * 40 - len(body))
        snods.append(out.put(b'SNOD' + struct.pack('<BxH', 1, len(part)) + body))
        keys.append(struct.pack('<Q', offsets[part[-1]]))
    if snods:
        btree = _btree(out, 0, keys, snods, _INTERNAL_K, 8)
    else:  # an empty group still has a (node-less) B-tree
        btree = out.put(b'TREE' + struct.pack('<BBHQQ', 0, 0, 0, _UNDEFINED, _UNDEFINED)
                        + b'\0' * ((2 * _INTERNAL_K) * 16 + 8))
    root = out.put(_header([(MSG_SYMBOL_TABLE, struct.pack('<QQ', btree, heap_address))]))
    scratch = struct.pack('<QQ', btree, heap_address)
    out.buf[:superblock_size] = (
        SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
        + struct.pack('<HHI', _LEAF_K, _INTERNAL_K, 0)
        # The end-of-file address counts the user block, as libhdf5 writes it.
        + struct.pack('<QQQQ', userblock_size, _UNDEFINED, userblock_size + len(out.buf),
                      _UNDEFINED)
        + struct.pack('<QQI4x', 0, root, 1) + scratch)
    with open(path, 'wb') as f:
        f.write(b'\0' * userblock_size)
        f.write(bytes(out.buf))
