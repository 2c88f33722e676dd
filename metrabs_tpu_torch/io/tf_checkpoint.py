"""Pure-Python reader (and writer) for TensorFlow checkpoint bundles: a
copy of `metrabs_tpu/io/tf_checkpoint.py`, which needs nothing of JAX but
numpy, less its use of `ml_dtypes`.

The released reference models are TF SavedModels; their weights live in the
TensorBundle format (`variables/variables.index` + `variables.data-NNNNN-of-
MMMMM`):

 - the .index file is a leveldb-style table: key-prefix-compressed blocks
   with restart arrays, a two-level index, and a fixed 48-byte footer with
   the magic 0xdb4775248b80fb57;
 - the first entry (key "") is a BundleHeaderProto (num_shards, endianness,
   version); every other entry maps a tensor name to a BundleEntryProto
   (dtype, shape, shard_id, offset, size, crc32c);
 - shard files are the raw little-endian tensor bytes at [offset, offset+size).

Only what checkpoints in practice use is supported: uncompressed blocks,
little-endian, the dtypes below. The reader widens DT_BFLOAT16 to float32
exactly (zero-extended bits), as the JAX module does. The writer
(`write_tf_checkpoint`) emits the same format (no key compression, single
data block), byte for byte as the JAX module's; it takes bfloat16 as a
`torch.bfloat16` tensor or a numpy array of a `bfloat16` dtype (JAX's), and
writes numpy uint16 as DT_UINT16.

The name->array dict feeds the mapping tables of `io/weights_import.py`.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Tuple

import numpy as np
import torch

_FOOTER_MAGIC = 0xdb4775248b80fb57
_FOOTER_SIZE = 48

# TF DataType enum -> numpy dtype (the subset that appears in checkpoints).
_DTYPES = {
    1: np.dtype('<f4'),    # DT_FLOAT
    2: np.dtype('<f8'),    # DT_DOUBLE
    3: np.dtype('<i4'),    # DT_INT32
    4: np.dtype('<u1'),    # DT_UINT8
    5: np.dtype('<i2'),    # DT_INT16
    6: np.dtype('<i1'),    # DT_INT8
    9: np.dtype('<i8'),    # DT_INT64
    10: np.dtype('bool'),  # DT_BOOL
    19: np.dtype('<f2'),   # DT_HALF
    17: np.dtype('<u2'),   # DT_UINT16
    14: np.dtype('<u2'),   # DT_BFLOAT16 (raw uint16; caller reinterprets)
}
# Write map: uint16 must encode as DT_UINT16, not the DT_BFLOAT16 entry the
# naive inversion would pick (the reader would then silently reinterpret the
# integers as bfloat16 bits). bfloat16 arrays are written as their raw bits
# under code 14 (`_as_numpy`).
_DTYPE_CODES = {v: k for k, v in _DTYPES.items() if k != 14}
_DT_BFLOAT16 = 14


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7f) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7f
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _parse_block(block: bytes) -> List[Tuple[bytes, bytes]]:
    """Decodes a leveldb-format block into (key, value) pairs."""
    if len(block) < 4:
        return []
    n_restarts = struct.unpack('<I', block[-4:])[0]
    data_end = len(block) - 4 - 4 * n_restarts
    entries = []
    pos = 0
    key = b''
    while pos < data_end:
        shared, pos = _read_varint(block, pos)
        non_shared, pos = _read_varint(block, pos)
        value_len, pos = _read_varint(block, pos)
        key = key[:shared] + block[pos:pos + non_shared]
        pos += non_shared
        value = block[pos:pos + value_len]
        pos += value_len
        entries.append((key, value))
    return entries


def _read_raw_block(data: bytes, offset: int, size: int) -> bytes:
    """Block contents + 1-byte type + 4-byte masked crc32c trailer."""
    block = data[offset:offset + size]
    block_type = data[offset + size]
    if block_type != 0:
        raise NotImplementedError(
            f'Compressed checkpoint blocks (type {block_type}) not supported')
    return block


def _proto_fields(buf: bytes):
    """Iterates (field_number, wire_type, value) of a serialized proto."""
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire == 1:
            value = struct.unpack('<Q', buf[pos:pos + 8])[0]
            pos += 8
        elif wire == 2:
            length, pos = _read_varint(buf, pos)
            value = buf[pos:pos + length]
            pos += length
        elif wire == 5:
            value = struct.unpack('<I', buf[pos:pos + 4])[0]
            pos += 4
        else:
            raise ValueError(f'Unsupported wire type {wire}')
        yield field, wire, value


def _parse_shape(buf: bytes) -> Tuple[int, ...]:
    """TensorShapeProto: repeated Dim dim = 2; Dim.size = 1 (varint)."""
    dims = []
    for field, wire, value in _proto_fields(buf):
        if field == 2 and wire == 2:
            size = 0
            for f2, w2, v2 in _proto_fields(value):
                if f2 == 1 and w2 == 0:
                    size = v2
            dims.append(size)
    return tuple(dims)


def _parse_bundle_entry(buf: bytes) -> Dict:
    """BundleEntryProto: dtype=1, shape=2, shard_id=3, offset=4, size=5,
    crc32c=6 (fixed32)."""
    entry = dict(dtype=0, shape=(), shard_id=0, offset=0, size=0)
    for field, wire, value in _proto_fields(buf):
        if field == 1:
            entry['dtype'] = value
        elif field == 2:
            entry['shape'] = _parse_shape(value)
        elif field == 3:
            entry['shard_id'] = value
        elif field == 4:
            entry['offset'] = value
        elif field == 5:
            entry['size'] = value
    return entry


def _parse_num_shards(buf: bytes) -> int:
    """BundleHeaderProto.num_shards = field 1 varint."""
    for field, wire, value in _proto_fields(buf):
        if field == 1 and wire == 0:
            return value
    return 1


def read_index_entries(index_path: str) -> Dict[bytes, bytes]:
    """All (key, value) pairs of a bundle .index table file, in order."""
    with open(index_path, 'rb') as f:
        data = f.read()
    footer = data[-_FOOTER_SIZE:]
    magic = struct.unpack('<Q', footer[-8:])[0]
    if magic != _FOOTER_MAGIC:
        raise ValueError(f'{index_path}: not a TF checkpoint index '
                         f'(magic {magic:#x})')
    # Footer: metaindex handle then index handle, as varint64 pairs.
    pos = 0
    _, pos = _read_varint(footer, pos)          # metaindex offset
    _, pos = _read_varint(footer, pos)          # metaindex size
    index_offset, pos = _read_varint(footer, pos)
    index_size, pos = _read_varint(footer, pos)

    index_block = _read_raw_block(data, index_offset, index_size)
    entries = {}
    for _, handle in _parse_block(index_block):
        hpos = 0
        block_offset, hpos = _read_varint(handle, hpos)
        block_size, hpos = _read_varint(handle, hpos)
        for key, value in _parse_block(_read_raw_block(
                data, block_offset, block_size)):
            entries[key] = value
    return entries


def _parse_object_graph(buf: bytes) -> Dict[str, str]:
    """{checkpoint_key: variable full_name} from a TrackableObjectGraph proto.

    SavedModel/tf.train.Checkpoint bundles key tensors by object-graph path
    (`layer_with_weights-3/kernel/.ATTRIBUTES/VARIABLE_VALUE`); the graph
    proto's SerializedTensor records also carry the original variable name
    (`efficientnetv2-s/stem/conv2d/kernel`) when the writer recorded it —
    the name space the reference's own converter maps from
    (`convert_model_from_tf.py:112`). TrackableObjectGraph: nodes=1;
    TrackableObject.attributes=2: SerializedTensor{name=1, full_name=2,
    checkpoint_key=3}."""
    mapping = {}
    for field, wire, node in _proto_fields(buf):
        if field != 1 or wire != 2:
            continue
        for f2, w2, attr in _proto_fields(node):
            if f2 != 2 or w2 != 2:
                continue
            full_name = ''
            ckpt_key = ''
            for f3, w3, v3 in _proto_fields(attr):
                if f3 == 2 and w3 == 2:
                    full_name = v3.decode('utf-8')
                elif f3 == 3 and w3 == 2:
                    ckpt_key = v3.decode('utf-8')
            if full_name and ckpt_key:
                mapping[ckpt_key] = full_name
    return mapping


def load_tf_checkpoint(prefix: str, strip_suffixes: bool = True
                       ) -> Dict[str, np.ndarray]:
    """Loads `<prefix>.index` + `<prefix>.data-*` into {name: array}.

    For a SavedModel, pass `<dir>/variables/variables`. With
    `strip_suffixes`, the TF object-graph suffix `/.ATTRIBUTES/VARIABLE_VALUE`
    is removed from keys (checkpoints written via tf.train.Checkpoint), so
    keys look like Keras variable paths.
    """
    entries = read_index_entries(prefix + '.index')
    header = entries.pop(b'', None)
    num_shards = _parse_num_shards(header) if header else 1

    shards = []
    for shard in range(num_shards):
        path = f'{prefix}.data-{shard:05d}-of-{num_shards:05d}'
        with open(path, 'rb') as f:
            shards.append(f.read())

    # Variable full names from the object graph (when the writer kept them).
    full_names = {}
    graph_key = next(
        (k for k in entries if k.startswith(b'_CHECKPOINTABLE_OBJECT_GRAPH')),
        None)
    if graph_key is not None:
        ge = _parse_bundle_entry(entries[graph_key])
        raw = shards[ge['shard_id']][ge['offset']:ge['offset'] + ge['size']]
        # DT_STRING tensors serialize as per-element varint lengths, then a
        # fixed 4-byte masked crc32c of the lengths, then the concatenated
        # bytes (tensor_bundle.cc WriteStringTensor); the graph is a
        # single-element tensor. Validated against checkpoints written by
        # TF 2.21 itself (tests/test_tf_oracle_backbone.py).
        length, pos = _read_varint(raw, 0)
        pos += 4  # lengths_crc32c
        full_names = _parse_object_graph(raw[pos:pos + length])

    out = {}
    for key, value in entries.items():
        name = key.decode('utf-8')
        if name.startswith('_CHECKPOINTABLE_OBJECT_GRAPH'):
            continue
        entry = _parse_bundle_entry(value)
        if entry['dtype'] not in _DTYPES:
            continue  # e.g. DT_STRING slices of the object graph
        dtype = _DTYPES[entry['dtype']]
        raw = shards[entry['shard_id']][
            entry['offset']:entry['offset'] + entry['size']]
        arr = np.frombuffer(raw, dtype=dtype).reshape(entry['shape'])
        if entry['dtype'] == _DT_BFLOAT16:  # bfloat16: upcast via zero-extended f32
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        if name in full_names:
            name = full_names[name].split(':')[0]
        elif strip_suffixes:
            name = name.replace('/.ATTRIBUTES/VARIABLE_VALUE', '')
        out[name] = arr
    return out


def _make_block(entries: List[Tuple[bytes, bytes]]) -> bytes:
    """Single block, no key sharing, one restart point."""
    out = bytearray()
    for key, value in entries:
        out += _write_varint(0) + _write_varint(len(key)) \
            + _write_varint(len(value)) + key + value
    out += struct.pack('<I', 0)      # one restart at offset 0
    out += struct.pack('<I', 1)      # n_restarts
    return bytes(out)


def _as_numpy(value):
    """(numpy array, dtype code or None): a bfloat16 torch tensor or numpy
    array becomes its raw uint16 bits under DT_BFLOAT16; other tensors
    their numpy arrays, whose dtype gives the code."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
        if value.dtype == torch.bfloat16:
            return value.view(torch.int16).numpy().view(np.uint16), _DT_BFLOAT16
        return value.numpy(), None
    arr = np.asarray(value)
    if arr.dtype.name == 'bfloat16':
        return arr.view(np.uint16), _DT_BFLOAT16
    return arr, None


def write_tf_checkpoint(prefix: str, tensors: Dict[str, np.ndarray]) -> None:
    """Writes a minimal single-shard bundle the reader round-trips.

    Used by tests and chip_smoke.py (and usable for exporting to TF
    consumers): uncompressed,
    one data block, crc fields zeroed (the reader does not verify them, and
    neither does TF unless asked to).
    """
    os.makedirs(os.path.dirname(prefix) or '.', exist_ok=True)
    names = sorted(tensors)
    data = bytearray()
    entry_values = {}
    for name in names:
        arr, code = _as_numpy(tensors[name])
        # ascontiguousarray promotes 0-d to 1-d; keep the true shape.
        arr = np.ascontiguousarray(arr).reshape(arr.shape)
        code = code or _DTYPE_CODES.get(arr.dtype.newbyteorder('<'))
        if code is None:
            raise ValueError(f'Unsupported dtype {arr.dtype} for {name}')
        offset = len(data)
        raw = arr.astype(arr.dtype.newbyteorder('<')).tobytes()
        data += raw
        shape = b''.join(
            bytes([0x12]) + _write_varint(len(_write_varint(d)) + 1)
            + bytes([0x08]) + _write_varint(d) for d in arr.shape)
        entry = (bytes([0x08]) + _write_varint(code)
                 + bytes([0x12]) + _write_varint(len(shape)) + shape
                 + bytes([0x20]) + _write_varint(offset)
                 + bytes([0x28]) + _write_varint(len(raw)))
        entry_values[name] = entry

    with open(f'{prefix}.data-00000-of-00001', 'wb') as f:
        f.write(bytes(data))

    header = bytes([0x08]) + _write_varint(1)   # num_shards = 1
    kv = [(b'', header)] + [
        (n.encode(), entry_values[n]) for n in names]
    data_block = _make_block(kv)

    out = bytearray()
    out += data_block + bytes([0]) + struct.pack('<I', 0)
    data_handle = _write_varint(0) + _write_varint(len(data_block))

    index_block = _make_block([(names[-1].encode() + b'\xff' if names
                                else b'\xff', data_handle)])
    index_offset = len(out)
    out += index_block + bytes([0]) + struct.pack('<I', 0)

    meta_block = _make_block([])
    meta_offset = len(out)
    out += meta_block + bytes([0]) + struct.pack('<I', 0)

    footer = (_write_varint(meta_offset) + _write_varint(len(meta_block))
              + _write_varint(index_offset) + _write_varint(len(index_block)))
    footer += b'\x00' * (40 - len(footer))
    footer += struct.pack('<Q', _FOOTER_MAGIC)
    out += footer
    with open(f'{prefix}.index', 'wb') as f:
        f.write(bytes(out))
