"""HDF5 files without h5py: a reader of what h5py writes under every
`libver` bound (MATLAB v7.3's files among them), and a writer of
prediction dumps. Pure Python, numpy and zlib, after the public "HDF5 File
Format Specification Version 3.0".

Reader. `File(path)` has h5py's read-only surface as the drivers use it:
a context manager, `f[name]` for datasets and groups (paths with '/'),
`name in f`, `keys()`, iteration, `.attrs`, and for a dataset `.shape`,
`.dtype`, `np.asarray(ds)` and `ds[()]`. Arrays come back in the file's
dataspace order with the file's byte order, as h5py gives them (MATLAB's
column-major `[3, 17, 1, F]` reads as `[F, 1, 17, 3]`). Covered:

- superblocks v0 and v1, and v2 and v3 (`libver='v108'` and later) with
  their extension (B-tree K values, driver info and file space info are
  read past: `fs_strategy='page'`/`'fsm'` with `fs_persist`), after a user
  block (searched at 0, 512, 1024, ...; every file address is relative to
  the superblock, as libhdf5 reads it);
- object headers of version 1 (continuation blocks) and 2 (`OHDR` and
  `OCHK` blocks, stored times, phase-change values, creation-order fields
  and gaps);
- the Jenkins lookup3 checksum of every structure that carries one
  (superblock v2/v3, OHDR, OCHK, FRHP, FHIB, FHDB where the heap signs its
  direct blocks, BTHD, BTIN, BTLF, FAHD, FADB, EAHD, EAIB, EASB, EADB): a
  mismatch raises ValueError naming the structure and its address;
- symbol-table groups (v1 B-trees of type 0 at any depth, SNOD nodes,
  local heaps) and new-style groups (link info and link messages, compact
  in the header or dense in a fractal heap with a v2 B-tree name index),
  members listed as h5py lists them: by name, or by creation order where
  the group tracks it;
- hard, soft and external links. A soft link resolves from the group that
  holds it ('/...' from its file's root); an external link opens its file
  where libhdf5 finds it (an absolute name as given, then the referring
  file's directory, then the working directory, an absolute name by its
  last component; `HDF5_EXT_PREFIX` is not read). A dangling link raises
  KeyError and more than MAX_LINK_HOPS soft or external links in one lookup
  RuntimeError ("too many links"), as h5py's;
- fractal heaps (direct and indirect blocks at any depth; managed, tiny
  and huge objects) and v2 B-trees at any depth (records of types 1, 5, 6,
  8, 9, 10 and 11);
- dataspace (v1, v2), datatype, fill value (old and v1-v3), layout v3
  (compact, contiguous, chunked with the v1 B-tree chunk index) and v4
  (compact, contiguous, and chunked with a single chunk, implicit, fixed
  array (paged), extensible array (super blocks, paged data blocks) or v2
  B-tree chunk index; edge chunks stored unfiltered), filter pipeline v1/v2
  and attribute (v1-v3) messages; attributes compact or dense (fractal heap
  and name index, huge ones included), listed as h5py lists them;
- fixed-point (1-8 bytes, signed or not, either byte order), IEEE floats
  of 2, 4 and 8 bytes, fixed-length strings (numpy `S`), variable-length
  strings from global-heap collections (object arrays of bytes; str in
  attributes, as h5py decodes them) and h5py's boolean enum;
- deflate, shuffle and Fletcher-32 (checked), honouring each chunk's
  filter mask; edge chunks cropped; unallocated storage reads as the fill
  value.

Refused with NotImplementedError naming the feature: shared object header
messages and the shared-message table, filtered fractal heaps and huge
objects, virtual datasets, external data storage, compound, reference,
array and non-boolean enum types, variable-length sequences, and filters
other than deflate, shuffle and Fletcher-32.

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
from typing import Dict, Iterator, List, Mapping, NamedTuple, Optional, Sequence, Tuple

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
MSG_SHARED_TABLE = 0x000F
MSG_CONTINUATION = 0x0010
MSG_SYMBOL_TABLE = 0x0011
MSG_BTREE_K = 0x0013
MSG_DRIVER_INFO = 0x0014
MSG_ATTRIBUTE_INFO = 0x0015
MSG_FILE_SPACE_INFO = 0x0017

# An object header with one of these is a group's.
_GROUP_MESSAGES = {MSG_SYMBOL_TABLE, MSG_LINK_INFO, MSG_LINK, MSG_GROUP_INFO}

FILTER_DEFLATE, FILTER_SHUFFLE, FILTER_FLETCHER32 = 1, 2, 3

# libhdf5's H5L_NUM_LINKS: soft and external links followed in one lookup.
MAX_LINK_HOPS = 16

# Layout message v4: chunked flags and chunk index types.
LAYOUT_DONT_FILTER_PARTIAL = 0x01
LAYOUT_SINGLE_INDEX_WITH_FILTER = 0x02
INDEX_SINGLE, INDEX_IMPLICIT, INDEX_FIXED_ARRAY, INDEX_EXTENSIBLE_ARRAY, INDEX_BTREE2 = (
    1, 2, 3, 4, 5)

_CLASS_NAMES = {2: 'time', 4: 'bitfield', 5: 'opaque', 6: 'compound', 7: 'reference',
                10: 'array'}
# IEEE layouts: size -> (exponent location, exponent size, mantissa location,
# mantissa size, exponent bias).
_IEEE = {2: (10, 5, 0, 10, 15), 4: (23, 8, 0, 23, 127), 8: (52, 11, 0, 52, 1023)}
_M32 = 0xFFFFFFFF


def _unsupported(feature: str):
    return NotImplementedError(f'HDF5 {feature} is not supported by this reader')


def _pad8(n: int) -> int:
    return (n + 7) & ~7


def _uint(buf: bytes, pos: int, n: int) -> int:
    return int.from_bytes(buf[pos:pos + n], 'little')


def _log2(n: int) -> int:
    return n.bit_length() - 1


def _enc_size(n: int) -> int:
    """Bytes libhdf5 uses to encode counts up to n (H5VM_limit_enc_size)."""
    return _log2(n) // 8 + 1


def _bit(bitmap: bytes, i: int) -> bool:
    """Bit i of a libhdf5 bitmap, most significant bit first (H5VM_bit_get)."""
    return bool(bitmap[i // 8] & (0x80 >> (i % 8)))


def lookup3(data: bytes, initval: int = 0) -> int:
    """Bob Jenkins' lookup3 `hashlittle` of `data`: the checksum libhdf5
    gives its metadata (H5_checksum_lookup3)."""
    n = len(data)
    a = b = c = (0xDEADBEEF + n + initval) & _M32
    if n == 0:
        return c
    blocks = (n - 1) // 12
    words = struct.unpack_from(f'<{3 * blocks}I', data)
    m = _M32
    for i in range(0, 3 * blocks, 3):
        a = (a + words[i]) & m
        b = (b + words[i + 1]) & m
        c = (c + words[i + 2]) & m
        a = (a - c) & m; a ^= ((c << 4) | (c >> 28)) & m; c = (c + b) & m  # noqa: E702
        b = (b - a) & m; b ^= ((a << 6) | (a >> 26)) & m; a = (a + c) & m  # noqa: E702
        c = (c - b) & m; c ^= ((b << 8) | (b >> 24)) & m; b = (b + a) & m  # noqa: E702
        a = (a - c) & m; a ^= ((c << 16) | (c >> 16)) & m; c = (c + b) & m  # noqa: E702
        b = (b - a) & m; b ^= ((a << 19) | (a >> 13)) & m; a = (a + c) & m  # noqa: E702
        c = (c - b) & m; c ^= ((b << 4) | (b >> 28)) & m; b = (b + a) & m  # noqa: E702
    tail = bytes(data[12 * blocks:])
    x, y, z = struct.unpack('<3I', tail + b'\0' * (12 - len(tail)))
    a, b, c = (a + x) & m, (b + y) & m, (c + z) & m
    rot = lambda v, k: ((v << k) | (v >> (32 - k))) & m  # noqa: E731
    c ^= b; c = (c - rot(b, 14)) & m  # noqa: E702
    a ^= c; a = (a - rot(c, 11)) & m  # noqa: E702
    b ^= a; b = (b - rot(a, 25)) & m  # noqa: E702
    c ^= b; c = (c - rot(b, 16)) & m  # noqa: E702
    a ^= c; a = (a - rot(c, 4)) & m  # noqa: E702
    b ^= a; b = (b - rot(a, 14)) & m  # noqa: E702
    c ^= b; c = (c - rot(b, 24)) & m  # noqa: E702
    return c


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


def _parse_dataspace(buf: bytes, pos: int, length_size: int
                     ) -> Tuple[Optional[Tuple[int, ...]], Optional[Tuple[int, ...]]]:
    """(shape, maximum shape) of a dataspace: () for a scalar, None for a
    null dataspace; an unlimited dimension's maximum is None, as h5py's."""
    version, rank, flags = struct.unpack_from('<BBB', buf, pos)
    if version == 1:
        dims_at = pos + 8
    elif version == 2:
        if buf[pos + 3] == 2:
            return None, None
        dims_at = pos + 4
    else:
        raise _unsupported(f'dataspace message version {version}')
    fmt = '<' + ('Q' if length_size == 8 else 'I') * rank
    shape = tuple(int(d) for d in struct.unpack_from(fmt, buf, dims_at))
    if not flags & 1:
        return shape, shape
    unlimited = (1 << (8 * length_size)) - 1
    maxshape = tuple(None if d == unlimited else int(d) for d in
                     struct.unpack_from(fmt, buf, dims_at + rank * length_size))
    return shape, maxshape


# --- the file -------------------------------------------------------------------

class _Message(NamedTuple):
    type: int
    data: bytes
    order: Optional[int]  # the creation-order field of a v2 header's message


class _Messages(list):
    """The messages of one object header; `attr_order_tracked` from a v2
    header's flags."""
    attr_order_tracked = False


class _Reader:
    """Addresses, sizes and the structures shared by every object of one
    file: superblock, heaps, B-trees and object headers."""

    def __init__(self, fh, path: str):
        self.fh = fh
        fh.seek(0, os.SEEK_END)
        self.file_size = fh.tell()
        self.base = self._find_superblock()
        head = self.read_abs(self.base, 24)
        self.version = version = head[8]
        if version in (0, 1):
            self.offset_size, self.length_size = head[13], head[14]
        elif version in (2, 3):
            self.offset_size, self.length_size = head[9], head[10]
        else:
            raise _unsupported(f'superblock version {version}')
        if self.offset_size not in (4, 8) or self.length_size not in (4, 8):
            raise _unsupported(f'offset size {self.offset_size} / length size '
                               f'{self.length_size}')
        self.undefined = (1 << (8 * self.offset_size)) - 1
        self._o = 'Q' if self.offset_size == 8 else 'I'
        self._l = 'Q' if self.length_size == 8 else 'I'
        if version < 2:
            pos = 24 + (4 if version == 1 else 0)
            tail = self.read_abs(self.base + pos, 4 * self.offset_size + self._entry_size())
            self.root_address = self._symbol_entry(tail, 4 * self.offset_size)[1]
            extension = self.undefined
        else:
            block = self.read(0, 12 + 4 * self.offset_size + 4)
            self.verify(block, 'superblock', 0)
            _, extension, _, self.root_address = self.unpack('OOOO', block, 12)
        # A referring file's directory, as libhdf5 keeps it for external links.
        self.extpath = os.path.join(os.getcwd(), os.path.dirname(path))
        self.root = None  # the File, once opened
        self.externals: Dict[str, 'File'] = {}
        self._heaps: Dict[int, bytes] = {}
        self._collections: Dict[int, Dict[int, bytes]] = {}
        self._fractal_heaps: Dict[int, _FractalHeap] = {}
        # Per object header address: its messages, links and attributes.
        self._messages: Dict[int, _Messages] = {}
        self._links: Dict[int, Dict[str, tuple]] = {}
        self._attributes: Dict[int, Attributes] = {}
        if extension != self.undefined:
            for m in self.messages(extension):
                if m.type == MSG_SHARED_TABLE:
                    raise _unsupported('shared object header message table (superblock '
                                       'extension message 0x000F)')
                if m.type not in (MSG_BTREE_K, MSG_DRIVER_INFO, MSG_FILE_SPACE_INFO):
                    raise _unsupported(f'superblock extension message type {m.type:#06x}')

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

    def verify(self, block: bytes, what: str, address: int) -> None:
        """Raises ValueError unless the last 4 bytes of `block` are the
        lookup3 checksum of the others."""
        stored, = struct.unpack_from('<I', block, len(block) - 4)
        if lookup3(block[:-4]) != stored:
            raise ValueError(f'HDF5 {what} at address {address} fails its lookup3 checksum: '
                             f'corrupt file')

    def signed(self, address: int, n: int, signature: bytes) -> bytes:
        """The n bytes of a structure that starts with `signature` and ends
        with its checksum, both checked."""
        block = self.read(address, n)
        if block[:4] != signature:
            raise ValueError(f'no HDF5 {signature.decode()} at address {address}')
        self.verify(block, signature.decode(), address)
        return block

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

    def fractal_heap(self, address: int) -> '_FractalHeap':
        if address not in self._fractal_heaps:
            self._fractal_heaps[address] = _FractalHeap(self, address)
        return self._fractal_heaps[address]

    # Object headers.
    def messages(self, address: int) -> _Messages:
        """The messages of the object header at `address` (version 1 or 2),
        continuation blocks included."""
        if address not in self._messages:
            self._messages[address] = (self._messages_v2(address)
                                       if self.read(address, 4) == b'OHDR'
                                       else self._messages_v1(address))
        return self._messages[address]

    def _messages_v1(self, address: int) -> _Messages:
        prefix = self.read(address, 16)
        if prefix[0] != 1:
            raise _unsupported(f'object header version {prefix[0]}')
        size, = struct.unpack_from('<I', prefix, 8)
        blocks, out = [(address + 16, size)], _Messages()
        while blocks:
            start, n = blocks.pop(0)
            buf = self.read(start, n)
            pos = 0
            while pos + 8 <= n:
                mtype, msize, flags = struct.unpack_from('<HHB', buf, pos)
                self._add_message(out, blocks, mtype, flags, buf[pos + 8:pos + 8 + msize], None)
                pos += 8 + msize
        return out

    def _messages_v2(self, address: int) -> _Messages:
        head = self.read(address, 6)
        version, flags = head[4], head[5]
        if version != 2:
            raise _unsupported(f'OHDR object header version {version}')
        pos = 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
        width = 1 << (flags & 3)
        size = _uint(self.read(address + pos, width), 0, width)
        pos += width
        block = self.signed(address, pos + size + 4, b'OHDR')
        out = _Messages()
        out.attr_order_tracked = bool(flags & 0x04)
        blocks = []
        self._v2_messages(block[pos:pos + size], flags, out, blocks)
        while blocks:
            start, n = blocks.pop(0)
            block = self.signed(start, n, b'OCHK')
            self._v2_messages(block[4:-4], flags, out, blocks)
        return out

    def _v2_messages(self, body: bytes, header_flags: int, out: _Messages, blocks) -> None:
        head = 6 if header_flags & 0x04 else 4
        pos = 0
        while pos + head <= len(body):  # fewer bytes are a gap
            mtype, msize, flags = struct.unpack_from('<BHB', body, pos)
            order = struct.unpack_from('<H', body, pos + 4)[0] if head == 6 else None
            self._add_message(out, blocks, mtype, flags, body[pos + head:pos + head + msize],
                              order)
            pos += head + msize

    def _add_message(self, out: _Messages, blocks, mtype: int, flags: int, data: bytes,
                     order: Optional[int]) -> None:
        if flags & 0x02:
            raise _unsupported(f'shared object header message (type {mtype:#06x})')
        if mtype == MSG_CONTINUATION:
            blocks.append(self.unpack('OL', data, 0))
        elif mtype != MSG_NIL:
            out.append(_Message(mtype, data, order))

    def open_object(self, address: int, name: str):
        types = {m.type for m in self.messages(address)}
        if types & _GROUP_MESSAGES:
            return Group(self, name, address)
        if MSG_LAYOUT in types:
            return Dataset(self, name, address)
        if MSG_DATATYPE in types:
            raise _unsupported(f'committed datatype {name!r}')
        raise _unsupported(f'object {name!r} that is neither a group nor a dataset')

    def attributes(self, address: int) -> 'Attributes':
        if address not in self._attributes:
            self._attributes[address] = Attributes(self, self.messages(address))
        return self._attributes[address]

    # Groups' links.
    def links(self, address: int) -> Dict[str, tuple]:
        """name -> ('hard', address), ('soft', path) or ('external', file,
        path) of the members of the group at `address`, in h5py's order."""
        if address not in self._links:
            self._links[address] = self._read_links(self.messages(address))
        return self._links[address]

    def _read_links(self, messages: Sequence[_Message]) -> Dict[str, tuple]:
        table = next((m.data for m in messages if m.type == MSG_SYMBOL_TABLE), None)
        if table is not None:
            return self._symbol_table_links(table)
        entries = [_parse_link(m.data, self) for m in messages if m.type == MSG_LINK]
        info = next((m.data for m in messages if m.type == MSG_LINK_INFO), None)
        tracked = info is not None and bool(info[1] & 1)
        if info is not None:
            heap_address, name_index = self.unpack('OO', info, 2 + (8 if tracked else 0))
            if heap_address != self.undefined:
                heap = self.fractal_heap(heap_address)
                entries += [_parse_link(heap.get(record[4:]), self)
                            for record in self.btree2_records(name_index, 5)]
        # h5py lists a group that tracks creation order in that order, else by name.
        entries.sort(key=(lambda e: e[0]) if tracked else (lambda e: e[1].encode('utf-8')))
        return {name: link for _, name, link in entries}

    def _symbol_table_links(self, table: bytes) -> Dict[str, tuple]:
        btree, heap_address = self.unpack('OO', table, 0)
        heap = self.local_heap(heap_address)
        links = {}
        entry = self._entry_size()
        for _, snod in self.btree_leaves(btree, 0, self.length_size):
            head = self.read(snod, 8)
            if head[:4] != b'SNOD':
                raise ValueError(f'no symbol table node at {snod}')
            n, = struct.unpack_from('<H', head, 6)
            body = self.read(snod + 8, n * entry)
            for i in range(n):
                name_off, header, cache = self._symbol_entry(body, i * entry)
                name = self.heap_string(heap, name_off)
                if cache == 2:  # a soft link: its value's offset in the scratch pad
                    value, = struct.unpack_from('<I', body, i * entry + 2 * self.offset_size + 8)
                    links[name] = ('soft', self.heap_string(heap, value))
                else:
                    links[name] = ('hard', header)
        return links

    def external_file(self, filename: str, link: str) -> 'File':
        """The file an external link names, where libhdf5 looks for it."""
        candidates = []
        if os.path.isabs(filename):
            candidates.append(filename)
            filename = os.path.basename(filename)
        candidates += [os.path.join(self.extpath, filename), filename]
        for path in candidates:
            if path in self.externals:
                return self.externals[path]
            if os.path.isfile(path):
                try:
                    self.externals[path] = File(path)
                except (OSError, ValueError):
                    continue
                return self.externals[path]
        raise KeyError(f"external link {link!r}: can't open file {filename!r}")

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

    # v2 B-trees.
    def btree2_records(self, address: int, record_type: int) -> Iterator[bytes]:
        """Every record of the v2 B-tree at `address`, in key order."""
        o = self.offset_size
        head = self.signed(address, 16 + o + 2 + self.length_size + 4, b'BTHD')
        tree_type = head[5]
        node_size, record_size, depth = struct.unpack_from('<IHH', head, 6)
        root, root_records = self.unpack('OH', head, 16)
        if tree_type != record_type:
            if tree_type in (2, 4):
                raise _unsupported(f'filtered huge fractal-heap objects (v2 B-tree type '
                                   f'{tree_type})')
            raise ValueError(f'the v2 B-tree at {address} has records of type {tree_type}, '
                             f'not {record_type}')
        # The widths of the child pointers' record counts (H5B2__hdr_init).
        max_records = [(node_size - 10) // record_size]
        count_size = _enc_size(max_records[0])
        total_sizes, totals = [0], [max_records[0]]
        for d in range(1, depth + 1):
            pointer = o + count_size + (total_sizes[d - 1] if d > 1 else 0)
            max_records.append((node_size - 10 - pointer) // (record_size + pointer))
            totals.append((max_records[d] + 1) * totals[d - 1] + max_records[d])
            total_sizes.append(_enc_size(totals[d]))

        def walk(node: int, n: int, d: int) -> Iterator[bytes]:
            if node == self.undefined or n == 0:
                return
            records = 6 + n * record_size
            if d == 0:
                block = self.signed(node, records + 4, b'BTLF')
                for i in range(n):
                    yield block[6 + i * record_size:6 + (i + 1) * record_size]
                return
            pointer = o + count_size + (total_sizes[d - 1] if d > 1 else 0)
            block = self.signed(node, records + (n + 1) * pointer + 4, b'BTIN')
            for i in range(n + 1):
                at = records + i * pointer
                child, = self.unpack('O', block, at)
                yield from walk(child, _uint(block, at + o, count_size), d - 1)
                if i < n:
                    yield block[6 + i * record_size:6 + (i + 1) * record_size]

        yield from walk(root, root_records, depth)


def _parse_link(data: bytes, reader: _Reader) -> Tuple[Optional[int], str, tuple]:
    """(creation order, name, link) of a link message."""
    version, flags = data[0], data[1]
    if version != 1:
        raise _unsupported(f'link message version {version}')
    pos, link_type, order = 2, 0, None
    if flags & 0x08:
        link_type = data[pos]
        pos += 1
    if flags & 0x04:
        order, = struct.unpack_from('<q', data, pos)
        pos += 8
    if flags & 0x10:  # the name's character set: ASCII or UTF-8
        pos += 1
    width = 1 << (flags & 3)
    n = _uint(data, pos, width)
    pos += width
    name = data[pos:pos + n].decode('utf-8')
    pos += n
    if link_type == 0:
        return order, name, ('hard', reader.unpack('O', data, pos)[0])
    if link_type in (1, 64):
        n, = struct.unpack_from('<H', data, pos)
        value = data[pos + 2:pos + 2 + n]
        if link_type == 1:
            return order, name, ('soft', value.decode('utf-8'))
        filename, path = value[1:].split(b'\0')[:2]
        return order, name, ('external', filename.decode('utf-8'), path.decode('utf-8'))
    raise _unsupported(f'user-defined link type {link_type} ({name!r})')


class _FractalHeap:
    """A fractal heap (FRHP): objects by heap ID."""

    def __init__(self, reader: _Reader, address: int):
        self.reader = reader
        o, l = reader.offset_size, reader.length_size  # noqa: E741
        fixed = 14 + 12 * l + 3 * o + 8
        head = reader.read(address, fixed + 4)
        if head[:4] != b'FRHP':
            raise ValueError(f'no HDF5 FRHP at address {address}')
        self.id_len, filter_len, self.flags, self.max_managed = struct.unpack_from(
            '<HHBI', head, 5)
        if filter_len:
            head = reader.read(address, fixed + l + 4 + filter_len + 4)
        reader.verify(head, 'FRHP', address)
        if filter_len:
            raise _unsupported(f'filtered fractal heap (I/O filters on its blocks) at {address}')
        self.address = address
        self.huge_btree, = reader.unpack('O', head, 14 + l)
        pos = 14 + 10 * l + 2 * o
        self.width, = struct.unpack_from('<H', head, pos)
        self.start_size, self.max_direct = reader.unpack('LL', head, pos + 2)
        max_heap_bits, _, self.root, self.root_rows = reader.unpack('HHOH', head, pos + 2 + 2 * l)
        self.offset_size = (max_heap_bits + 7) // 8
        self.length_size = min((_log2(self.max_direct) + 7) // 8, _enc_size(self.max_managed))
        self.max_direct_rows = _log2(self.max_direct) - _log2(self.start_size) + 2
        self.first_row_bits = _log2(self.start_size) + _log2(self.width)
        self.huge_direct = o + l <= self.id_len - 1
        self.huge_id_size = min(self.id_len - 1, 8)
        self._blocks: Dict[int, bytes] = {}
        self._iblocks: Dict[int, Tuple[int, ...]] = {}
        self._huge: Optional[Dict[int, Tuple[int, int]]] = None

    def row_size(self, row: int) -> int:
        return self.start_size if row == 0 else self.start_size << (row - 1)

    def get(self, heap_id: bytes) -> bytes:
        """The object a heap ID names."""
        if heap_id[0] >> 6:
            raise _unsupported(f'fractal heap ID version {heap_id[0] >> 6}')
        kind = (heap_id[0] >> 4) & 3
        if kind == 0:  # managed: an offset into the heap's space and a length
            offset = _uint(heap_id, 1, self.offset_size)
            n = _uint(heap_id, 1 + self.offset_size, self.length_size)
            block, block_offset = self._direct_block(offset)
            return block[offset - block_offset:offset - block_offset + n]
        if kind == 1:  # huge: stored on its own
            if self.huge_direct:
                address, n = self.reader.unpack('OL', heap_id, 1)
            else:
                if self._huge is None:
                    self._huge = {}
                    for record in self.reader.btree2_records(self.huge_btree, 1):
                        address, n, key = self.reader.unpack('OLL', record, 0)
                        self._huge[key] = (address, n)
                key = _uint(heap_id, 1, self.huge_id_size)
                if key not in self._huge:
                    raise ValueError(f'huge object {key} is not in the fractal heap at '
                                     f'{self.address}')
                address, n = self._huge[key]
            return self.reader.read(address, n)
        if kind == 2:  # tiny: the data are in the ID
            if self.id_len <= 17:
                n = (heap_id[0] & 0x0F) + 1
                return heap_id[1:1 + n]
            n = (((heap_id[0] & 0x0F) << 8) | heap_id[1]) + 1
            return heap_id[2:2 + n]
        raise ValueError(f'fractal heap ID of type {kind} in the heap at {self.address}')

    def _direct_block(self, offset: int) -> Tuple[bytes, int]:
        """(the direct block holding heap offset `offset`, its heap offset)."""
        if self.root_rows == 0:
            return self._dblock(self.root, self.start_size), 0
        address, rows, block_offset = self.root, self.root_rows, 0
        while True:
            children = self._iblock(address, rows)
            pos = block_offset
            for row in range(rows):
                size = self.row_size(row)
                if offset < pos + size * self.width:
                    break
                pos += size * self.width
            else:
                raise ValueError(f'heap offset {offset} lies outside the fractal heap at '
                                 f'{self.address}')
            column = (offset - pos) // size
            child, child_offset = children[row * self.width + column], pos + column * size
            if child == self.reader.undefined:
                raise ValueError(f'heap offset {offset} lies in an unallocated block of the '
                                 f'fractal heap at {self.address}')
            if row < self.max_direct_rows:
                return self._dblock(child, size), child_offset
            address, rows, block_offset = child, _log2(size) - self.first_row_bits + 1, child_offset

    def _iblock(self, address: int, rows: int) -> Tuple[int, ...]:
        if address not in self._iblocks:
            o = self.reader.offset_size
            n = rows * self.width
            block = self.reader.signed(address, 5 + o + self.offset_size + n * o + 4, b'FHIB')
            self._iblocks[address] = self.reader.unpack('O' * n, block, 5 + o + self.offset_size)
        return self._iblocks[address]

    def _dblock(self, address: int, size: int) -> bytes:
        if address not in self._blocks:
            block = self.reader.read(address, size)
            if block[:4] != b'FHDB':
                raise ValueError(f'no HDF5 FHDB at address {address}')
            if self.flags & 0x02:  # checksummed, over the block with the checksum zeroed
                at = 5 + self.reader.offset_size + self.offset_size
                self.reader.verify(block[:at] + b'\0' * 4 + block[at + 4:] + block[at:at + 4],
                                   'FHDB', address)
            self._blocks[address] = block
        return self._blocks[address]


class Attributes(Mapping):
    """`obj.attrs`: read-only, values as h5py returns them, listed in
    creation order where the object tracks it, else by name."""

    def __init__(self, reader: _Reader, messages: _Messages):
        self._reader = reader
        entries = []
        for m in messages:
            if m.type == MSG_ATTRIBUTE:
                entries.append((m.order, *self._parse(m.data)))
            elif m.type == MSG_ATTRIBUTE_INFO:
                entries += self._dense(m.data)
        entries.sort(key=(lambda e: e[0]) if messages.attr_order_tracked
                     else (lambda e: e[1].encode('utf-8')))
        self._raw = {name: value for _, name, value in entries}

    def _dense(self, info: bytes) -> list:
        """The attributes in a fractal heap, through the name index."""
        reader = self._reader
        heap_address, name_index = reader.unpack('OO', info, 2 + (2 if info[1] & 1 else 0))
        if heap_address == reader.undefined:
            return []
        heap = reader.fractal_heap(heap_address)
        out = []
        for record in reader.btree2_records(name_index, 8):
            id_len = len(record) - 9  # heap ID, flags (1), creation order (4), hash (4)
            if record[id_len] & 0x02:
                raise _unsupported('shared attribute message in dense storage')
            order, = struct.unpack_from('<I', record, id_len + 1)
            out.append((order, *self._parse(heap.get(record[:id_len]))))
        return out

    def _parse(self, data: bytes):
        version = data[0]
        if version not in (1, 2, 3):
            raise _unsupported(f'attribute message version {version}')
        if version > 1 and data[1] & 0x03:
            raise _unsupported('attribute with a shared datatype or dataspace')
        name_size, type_size, space_size = struct.unpack_from('<HHH', data, 2)
        pos = 8 + (1 if version == 3 else 0)
        pad = _pad8 if version == 1 else (lambda n: n)
        name = data[pos:pos + name_size].split(b'\0', 1)[0].decode('utf-8')
        pos += pad(name_size)
        dtype, _ = _parse_datatype(data, pos, self._reader.offset_size)
        pos += pad(type_size)
        shape, _ = _parse_dataspace(data, pos, self._reader.length_size)
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
    def __init__(self, reader: _Reader, name: str, address: int):
        self._reader = reader
        self.name = name
        self._messages = reader.messages(address)
        self.attrs = reader.attributes(address)


class Group(_Object, Mapping):
    """A group, old-style (symbol table) or new-style (links): its members
    in h5py's order; `group[path]` follows hard, soft and external links."""

    def __init__(self, reader: _Reader, name: str, address: int):
        super().__init__(reader, name, address)
        self._links = reader.links(address)

    def __getitem__(self, path: str):
        return self._resolve(path, [MAX_LINK_HOPS])

    def _resolve(self, path: str, hops: List[int]):
        obj = self._reader.root if path.startswith('/') else self
        for part in path.split('/'):
            if part in ('', '.'):
                continue
            if not isinstance(obj, Group):
                raise KeyError(f'{obj.name!r} is a dataset, not a group: {path!r}')
            if part not in obj._links:
                raise KeyError(f'no member {part!r} in {obj.name!r}')
            obj = obj._follow(part, hops)
        return obj

    def _follow(self, part: str, hops: List[int]):
        link = self._links[part]
        name = f'{self.name.rstrip("/")}/{part}'
        if link[0] == 'hard':
            return self._reader.open_object(link[1], name)
        if hops[0] == 0:
            raise RuntimeError(f'{name!r}: too many links (more than {MAX_LINK_HOPS} soft or '
                               f'external links in one lookup)')
        hops[0] -= 1
        if link[0] == 'soft':
            try:
                return self._resolve(link[1], hops)
            except KeyError as e:
                raise KeyError(f'soft link {name!r} -> {link[1]!r} dangles: {e}') from None
        target = self._reader.external_file(link[1], name)
        try:
            return target._resolve(link[2], hops)
        except KeyError as e:
            raise KeyError(f'external link {name!r} -> {link[1]}:{link[2]} dangles: {e}'
                           ) from None

    def __contains__(self, path) -> bool:
        """Whether `path` names a member (its link is not followed)."""
        *parents, last = [p for p in path.split('/') if p] or ['']
        try:
            group = self._resolve(('/' if path.startswith('/') else '') + '/'.join(parents),
                                  [MAX_LINK_HOPS])
        except KeyError:
            return False
        return isinstance(group, Group) and last in group._links

    def __iter__(self):
        return iter(self._links)

    def __len__(self):
        return len(self._links)


class Dataset(_Object):
    """A dataset: `.shape`, `.maxshape`, `.dtype`, `.attrs`; `np.asarray(ds)`,
    `ds[()]` and `ds[index]` read the whole array."""

    def __init__(self, reader: _Reader, name: str, address: int):
        super().__init__(reader, name, address)
        by_type = {}
        for m in self._messages:
            by_type.setdefault(m.type, m.data)
        if MSG_EXTERNAL in by_type:
            raise _unsupported('external data storage')
        self._type, _ = _parse_datatype(by_type[MSG_DATATYPE], 0, reader.offset_size)
        self.shape, self.maxshape = _parse_dataspace(by_type[MSG_DATASPACE], 0,
                                                     reader.length_size)
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
        if version not in (3, 4):
            raise _unsupported(f'layout message version {version}')
        if layout_class == 0:  # compact: the data follow its 2-byte size
            raw = np.frombuffer(self._layout, storage, n, 4)
        elif layout_class == 1:  # contiguous
            address, _ = self._reader.unpack('OL', self._layout, 2)
            if address == self._reader.undefined or n == 0:
                raw = self._filled(n)
            else:
                raw = np.frombuffer(self._reader.read(address, n * storage.itemsize), storage)
        elif layout_class == 2:
            raw = self._read_chunked() if version == 3 else self._read_chunked_v4()
        elif layout_class == 3:
            raise _unsupported(f'virtual dataset {self.name!r} (layout class 3)')
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

    def _place(self, chunk: Tuple[int, ...], entries, unfiltered_edges: bool = False
               ) -> np.ndarray:
        """The array from its chunks: `entries` yields (element offsets,
        address, stored size, filter mask) of each allocated chunk; the rest
        is the fill value. With `unfiltered_edges`, chunks that cross the
        dataset's edge were stored without the filters."""
        storage = self._type.storage
        out = self._filled(self.size).reshape(self.shape)
        if self.size == 0:
            return out
        for offsets, address, size, mask in entries:
            region = tuple(slice(o, min(o + c, s)) for o, c, s in zip(offsets, chunk, self.shape))
            if any(r.start >= r.stop for r in region):
                continue
            data = self._reader.read(address, size)
            edge = any(o + c > s for o, c, s in zip(offsets, chunk, self.shape))
            if not (unfiltered_edges and edge):
                data = _unfilter(data, self._filters, mask, storage.itemsize)
            values = np.frombuffer(data, storage, math.prod(chunk)).reshape(chunk)
            out[region] = values[tuple(slice(0, r.stop - r.start) for r in region)]
        return out

    def _read_chunked(self) -> np.ndarray:
        """Layout v3: chunks indexed by a v1 B-tree."""
        reader = self._reader
        rank = self._layout[2] - 1
        btree, = reader.unpack('O', self._layout, 3)
        pos = 3 + reader.offset_size
        chunk = struct.unpack_from(f'<{rank + 1}I', self._layout, pos)[:rank]

        def entries():
            if btree == reader.undefined:
                return
            for key, address in reader.btree_leaves(btree, 1, 8 + 8 * (rank + 1)):
                size, mask = struct.unpack_from('<II', key, 0)
                yield struct.unpack_from(f'<{rank}Q', key, 8), address, size, mask
        return self._place(chunk, entries())

    def _read_chunked_v4(self) -> np.ndarray:
        """Layout v4: chunks indexed by one of its five chunk indexes."""
        reader, lay = self._reader, self._layout
        flags, ndims, width = lay[2], lay[3], lay[4]
        chunk = tuple(_uint(lay, 5 + i * width, width) for i in range(ndims))[:-1]
        pos = 5 + ndims * width
        index_type = lay[pos]
        pos += 1
        # The bytes of each index's parameters, which the reader takes from
        # its header instead.
        params = {INDEX_SINGLE: 0, INDEX_IMPLICIT: 0, INDEX_FIXED_ARRAY: 1,
                  INDEX_EXTENSIBLE_ARRAY: 5, INDEX_BTREE2: 6}
        if index_type not in params:
            raise _unsupported(f'chunk index type {index_type}')
        full = math.prod(chunk) * self._type.storage.itemsize
        single = None
        if index_type == INDEX_SINGLE and flags & LAYOUT_SINGLE_INDEX_WITH_FILTER:
            single = reader.unpack('LI', lay, pos)
            pos += reader.length_size + 4
        address, = reader.unpack('O', lay, pos + params[index_type])
        # The chunk grid the fixed and extensible arrays are laid out over:
        # the maximum shape's (H5D's max_down_chunks).
        grid = tuple(None if m is None else -(-m // c) for m, c in zip(self.maxshape, chunk))

        def at(scaled):
            return tuple(s * c for s, c in zip(scaled, chunk))

        def entries():
            if address == reader.undefined:
                return
            if index_type == INDEX_SINGLE:
                size, mask = single if single else (full, 0)
                yield (0,) * len(chunk), address, size, mask
            elif index_type == INDEX_IMPLICIT:  # every chunk in order from one address
                current = tuple(-(-s // c) for s, c in zip(self.shape, chunk))
                for scaled in np.ndindex(*current):
                    index = int(np.ravel_multi_index(scaled, grid))
                    yield at(scaled), address + index * full, full, 0
            elif index_type == INDEX_BTREE2:
                filtered = bool(self._filters)
                o, rank = reader.offset_size, len(chunk)
                for record in reader.btree2_records(address, 11 if filtered else 10):
                    caddr, = reader.unpack('O', record, 0)
                    if filtered:
                        size_len = len(record) - o - 4 - 8 * rank
                        size, mask = _uint(record, o, size_len), struct.unpack_from(
                            '<I', record, o + size_len)[0]
                        pos_ = o + size_len + 4
                    else:
                        size, mask, pos_ = full, 0, o
                    yield at(struct.unpack_from(f'<{rank}Q', record, pos_)), caddr, size, mask
            else:
                if index_type == INDEX_FIXED_ARRAY:
                    elements = _fixed_array(reader, address, full)
                    unravel = lambda i: np.unravel_index(i, grid)  # noqa: E731
                else:
                    unlimited = [i for i, m in enumerate(grid) if m is None]
                    if len(unlimited) != 1:
                        raise ValueError(f'extensible array chunk index of {self.name!r} '
                                         f'with {len(unlimited)} unlimited dimensions')
                    u = unlimited[0]
                    rest = grid[:u] + grid[u + 1:]
                    per = math.prod(rest)

                    def unravel(i):  # the unlimited dimension comes first (swizzled)
                        others = list(np.unravel_index(i % per, rest)) if rest else []
                        return tuple(others[:u]) + (i // per,) + tuple(others[u:])
                    elements = _extensible_array(reader, address, full)
                for index, caddr, size, mask in elements:
                    yield at(tuple(int(s) for s in unravel(index))), caddr, size, mask

        return self._place(chunk, entries(), bool(flags & LAYOUT_DONT_FILTER_PARTIAL))


def _chunk_elements(reader: _Reader, buf: bytes, filtered: bool, element_size: int,
                    start: int, full: int):
    """(chunk index, address, stored size, filter mask) of each allocated
    chunk in a fixed or extensible array's run of elements."""
    o = reader.offset_size
    for i in range(len(buf) // element_size):
        e = buf[i * element_size:(i + 1) * element_size]
        address = _uint(e, 0, o)
        if address == reader.undefined:
            continue
        if filtered:
            yield (start + i, address, _uint(e, o, element_size - o - 4),
                   struct.unpack_from('<I', e, element_size - 4)[0])
        else:
            yield start + i, address, full, 0


def _fixed_array(reader: _Reader, address: int, full: int):
    """The elements of a fixed array (FAHD, FADB and its pages)."""
    o, l = reader.offset_size, reader.length_size  # noqa: E741
    head = reader.signed(address, 8 + l + o + 4, b'FAHD')
    filtered, element_size, page_bits = head[5] == 1, head[6], head[7]
    n, data_block = reader.unpack('LO', head, 8)
    if data_block == reader.undefined:
        return
    page = 1 << page_bits
    pages = -(-n // page) if n > page else 0
    prefix = 6 + o + (pages + 7) // 8
    if not pages:
        block = reader.signed(data_block, prefix + n * element_size + 4, b'FADB')
        yield from _chunk_elements(reader, block[prefix:-4], filtered, element_size, 0, full)
        return
    block = reader.signed(data_block, prefix + 4, b'FADB')
    page_size = page * element_size + 4
    for p in range(pages):
        if not _bit(block[6 + o:prefix], p):
            continue
        count = min(page, n - p * page)
        at = data_block + prefix + 4 + p * page_size
        data = reader.read(at, count * element_size + 4)
        reader.verify(data, 'FADB page', at)
        yield from _chunk_elements(reader, data[:-4], filtered, element_size, p * page, full)


def _extensible_array(reader: _Reader, address: int, full: int):
    """The elements of an extensible array: its index block (EAIB), the
    data blocks (EADB, paged or not) it points to directly and those of its
    super blocks (EASB)."""
    o, l = reader.offset_size, reader.length_size  # noqa: E741
    head = reader.signed(address, 12 + 6 * l + o + 4, b'EAHD')
    filtered, element_size, max_bits = head[5] == 1, head[6], head[7]
    index_elements, min_elements, min_pointers, page_bits = head[8], head[9], head[10], head[11]
    index_block, = reader.unpack('O', head, 12 + 6 * l)
    if index_block == reader.undefined:
        return
    # Each super block's (data blocks, elements per data block, first
    # element, first data block), as H5EA__hdr_init lays them out.
    super_blocks, first, first_block = [], 0, 0
    for u in range(1 + max_bits - _log2(min_elements)):
        blocks, elements = 1 << (u // 2), (1 << ((u + 1) // 2)) * min_elements
        super_blocks.append((blocks, elements, first, first_block))
        first += blocks * elements
        first_block += blocks
    in_index = 2 * _log2(min_pointers)  # super blocks whose data blocks the index block holds
    n_dblocks, n_sblocks = 2 * (min_pointers - 1), len(super_blocks) - in_index
    offset_size = (max_bits + 7) // 8
    page = 1 << page_bits
    block = reader.signed(index_block,
                          6 + o + index_elements * element_size + (n_dblocks + n_sblocks) * o + 4,
                          b'EAIB')
    pos = 6 + o
    yield from _chunk_elements(reader, block[pos:pos + index_elements * element_size], filtered,
                               element_size, 0, full)
    pos += index_elements * element_size
    dblocks = reader.unpack('O' * n_dblocks, block, pos)
    sblocks = reader.unpack('O' * n_sblocks, block, pos + n_dblocks * o)

    def data_block(at: int, elements: int, start: int, initialised):
        if at == reader.undefined:
            return
        prefix = 6 + o + offset_size
        if elements <= page:
            data = reader.signed(at, prefix + elements * element_size + 4, b'EADB')
            yield from _chunk_elements(reader, data[prefix:-4], filtered, element_size, start,
                                       full)
            return
        reader.signed(at, prefix + 4, b'EADB')
        page_size = page * element_size + 4
        for p in range(elements // page):
            if initialised is not None and not initialised(p):
                continue
            page_at = at + prefix + 4 + p * page_size
            data = reader.read(page_at, page_size)
            reader.verify(data, 'EADB page', page_at)
            yield from _chunk_elements(reader, data[:-4], filtered, element_size,
                                       start + p * page, full)

    for u in range(in_index):
        blocks, elements, start, block0 = super_blocks[u]
        for j in range(blocks):
            yield from data_block(dblocks[block0 + j], elements,
                                  index_elements + start + j * elements, None)
    for k, at in enumerate(sblocks):
        if at == reader.undefined:
            continue
        blocks, elements, start, _ = super_blocks[in_index + k]
        pages = elements // page if elements > page else 0
        bitmap_size = (pages + 7) // 8 * blocks if pages else 0
        sblock = reader.signed(at, 6 + o + offset_size + bitmap_size + blocks * o + 4, b'EASB')
        bitmap = sblock[6 + o + offset_size:6 + o + offset_size + bitmap_size]
        addresses = reader.unpack('O' * blocks, sblock, 6 + o + offset_size + bitmap_size)
        for j, dblock in enumerate(addresses):
            initialised = (lambda p, j=j: _bit(bitmap, j * pages + p)) if pages else None
            yield from data_block(dblock, elements, index_elements + start + j * elements,
                                  initialised)


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
            reader = _Reader(self._fh, self.filename)
            if not {m.type for m in reader.messages(reader.root_address)} & _GROUP_MESSAGES:
                raise ValueError(f'the root object of {self.filename} is not a group')
            reader.root = self
            super().__init__(reader, '/', reader.root_address)
        except BaseException:
            self._fh.close()
            raise

    def close(self):
        for external in self._reader.externals.values():
            external.close()
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
