"""Minimal pure-Python reader for NASA CDF v3 files (H36M annotations).

The reference reads Human3.6M `D3_Positions/*.cdf` pose annotations with
SpacePy (`inference_scripts/predict_h36m.py:109-110`,
`install_dependencies.sh:9-24`); neither SpacePy nor the NASA CDF C library
is available here, so this implements the needed subset of the CDF V3
format directly:

 - uncompressed files and gzip-compressed files (CCR) / variables (CVVR);
 - zVariables with record variance, REAL4/REAL8/INT* data types;
 - row- and column-major layouts, big- and little-endian encodings.

Record structure is big-endian; data endianness follows the CDR encoding
field. A matching minimal writer exists for hermetic tests (and writes files
the NASA tools accept for this subset).


A copy of `metrabs_tpu/utils/cdf.py`; the port keeps its own."""

from __future__ import annotations

import struct
import zlib
from typing import Dict

import numpy as np

V3_MAGIC = 0xCDF30001
UNCOMPRESSED_MAGIC2 = 0x0000FFFF
COMPRESSED_MAGIC2 = 0xCCCC0001

# Record types.
_CDR, _GDR, _RVDR, _ADR, _AGREDR, _VXR, _VVR, _ZVDR, _AZEDR, _CCR, _CPR = \
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11
_CVVR = 13

# CDF data type -> numpy dtype char (byte order applied separately).
_DTYPES = {
    1: 'i1', 2: 'i2', 4: 'i4', 8: 'i8',
    11: 'u1', 12: 'u2', 14: 'u4',
    21: 'f4', 44: 'f4',
    22: 'f8', 45: 'f8', 31: 'f8',
    33: 'i8',
    51: 'S1', 52: 'S1',
}

_LITTLE_ENDIAN_ENCODINGS = {4, 6, 13, 16, 17, 19, 20, 21}


def _u4(buf, pos):
    return struct.unpack_from('>i', buf, pos)[0]


def _u8(buf, pos):
    return struct.unpack_from('>q', buf, pos)[0]


class CdfFile:
    """Parsed CDF: `variables` maps name -> numpy array with a leading
    record axis, matching spacepy's `cdf_file['Pose'][...]` layout."""

    def __init__(self, data: bytes):
        magic1, magic2 = struct.unpack_from('>II', data, 0)
        if magic1 != V3_MAGIC:
            if magic1 == 0xCDF26002:
                raise NotImplementedError(
                    'CDF v2.x files are not supported (v3 only)')
            raise ValueError(f'Not a CDF file (magic {magic1:#x})')
        if magic2 == COMPRESSED_MAGIC2:
            # CCR record directly after the magic wraps the inner CDF.
            pos = 8
            rec_type = _u4(data, pos + 8)
            if rec_type != _CCR:
                raise ValueError('Compressed CDF without CCR record')
            cpr_offset = _u8(data, pos + 12)
            # CCR: CPRoffset(8) uSize(8) rfuA(4) then compressed stream.
            payload = data[pos + 12 + 8 + 8 + 4:]
            inner = zlib.decompress(payload, 47)
            data = data[:8] + inner
        elif magic2 != UNCOMPRESSED_MAGIC2:
            raise ValueError(f'Unknown CDF magic2 {magic2:#x}')
        self._data = data
        self.variables: Dict[str, np.ndarray] = {}
        self._parse()

    def __getitem__(self, name: str) -> np.ndarray:
        return self.variables[name]

    def _parse(self):
        data = self._data
        # CDR at offset 8: size(8) type(4) GDRoffset(8) version... encoding
        cdr = 8
        assert _u4(data, cdr + 8) == _CDR, 'CDR expected after magic'
        gdr = _u8(data, cdr + 12)
        encoding = _u4(data, cdr + 12 + 8 + 4 + 4)
        flags = _u4(data, cdr + 12 + 8 + 4 + 4 + 4)
        self._row_major = bool(flags & 1)
        self._byteorder = ('<' if encoding in _LITTLE_ENDIAN_ENCODINGS
                           else '>')

        assert _u4(data, gdr + 8) == _GDR, 'GDR offset invalid'
        zvdr_head = _u8(data, gdr + 12 + 8)
        offset = zvdr_head
        while offset:
            offset = self._parse_zvdr(offset)

    def _parse_zvdr(self, off) -> int:
        data = self._data
        if _u4(data, off + 8) != _ZVDR:
            raise ValueError('Only zVariables are supported')
        pos = off + 12
        vdr_next = _u8(data, pos); pos += 8
        data_type = _u4(data, pos); pos += 4
        max_rec = _u4(data, pos); pos += 4
        vxr_head = _u8(data, pos); pos += 8
        pos += 8                      # VXRtail
        flags = _u4(data, pos); pos += 4
        srecords = _u4(data, pos); pos += 4
        pos += 4 + 4 + 4              # rfuB, rfuC, rfuF
        num_elems = _u4(data, pos); pos += 4
        pos += 4                      # Num
        pos += 8                      # CPRorSPRoffset
        pos += 4                      # BlockingFactor
        name = data[pos:pos + 256].split(b'\x00')[0].decode('ascii')
        pos += 256
        z_num_dims = _u4(data, pos); pos += 4
        dim_sizes = [_u4(data, pos + 4 * i) for i in range(z_num_dims)]
        pos += 4 * z_num_dims
        dim_varys = [_u4(data, pos + 4 * i) for i in range(z_num_dims)]
        pos += 4 * z_num_dims

        if data_type not in _DTYPES:
            return vdr_next  # skip unsupported (e.g. EPOCH16)
        dtype = np.dtype(self._byteorder + _DTYPES[data_type])
        shape = [s for s, v in zip(dim_sizes, dim_varys) if v]
        rec_elems = int(np.prod(shape, dtype=np.int64)) * max(num_elems, 1)
        rec_bytes = rec_elems * dtype.itemsize

        n_records = max_rec + 1
        if n_records <= 0:
            self.variables[name] = np.zeros([0] + shape, dtype)
            return vdr_next

        buf = np.zeros(n_records * rec_elems, dtype)
        self._read_vxr_chain(vxr_head, buf, rec_elems, rec_bytes, dtype)
        arr = buf.reshape([n_records] + shape)
        if not self._row_major and len(shape) > 1:
            # Column-major records: dims are stored fastest-first.
            arr = arr.reshape([n_records] + shape[::-1])
            arr = np.transpose(arr, [0] + list(range(len(shape), 0, -1)))
        self.variables[name] = arr
        return vdr_next

    def _read_vxr_chain(self, vxr_off, buf, rec_elems, rec_bytes, dtype):
        data = self._data
        while vxr_off:
            assert _u4(data, vxr_off + 8) == _VXR
            pos = vxr_off + 12
            vxr_next = _u8(data, pos); pos += 8
            n_entries = _u4(data, pos); pos += 4
            n_used = _u4(data, pos); pos += 4
            first = [_u4(data, pos + 4 * i) for i in range(n_entries)]
            pos += 4 * n_entries
            last = [_u4(data, pos + 4 * i) for i in range(n_entries)]
            pos += 4 * n_entries
            offsets = [_u8(data, pos + 8 * i) for i in range(n_entries)]
            for i in range(n_used):
                rec_type = _u4(data, offsets[i] + 8)
                n_recs = last[i] - first[i] + 1
                if rec_type == _VXR:
                    self._read_vxr_chain(
                        offsets[i], buf, rec_elems, rec_bytes, dtype)
                elif rec_type == _VVR:
                    raw = data[offsets[i] + 12:
                               offsets[i] + 12 + n_recs * rec_bytes]
                    buf[first[i] * rec_elems:(last[i] + 1) * rec_elems] = \
                        np.frombuffer(raw, dtype)
                elif rec_type == _CVVR:
                    # CVVR: rfuA(4) cSize(8) then gzip stream.
                    csize = _u8(data, offsets[i] + 12 + 4)
                    raw = zlib.decompress(
                        data[offsets[i] + 24:offsets[i] + 24 + csize], 47)
                    buf[first[i] * rec_elems:(last[i] + 1) * rec_elems] = \
                        np.frombuffer(raw[:n_recs * rec_bytes], dtype)
                else:
                    raise ValueError(f'Unexpected record type {rec_type} '
                                     'in VXR entry')
            vxr_off = vxr_next


def load_cdf(path: str) -> CdfFile:
    with open(path, 'rb') as f:
        return CdfFile(f.read())


# --------------------------------------------------------------------------
# Minimal writer (tests; subset: one or more REAL4/REAL8 zVariables,
# row-major, little-endian data, uncompressed or gzip-compressed VVRs).
# --------------------------------------------------------------------------


def write_cdf(path: str, variables: Dict[str, np.ndarray],
              compress_vvr: bool = False, column_major: bool = False) -> None:
    # Layout: CDR, GDR, then per variable: zVDR, VXR, VVR/CVVR, with sizes
    # computed up front so offsets can be embedded directly into `out`.
    base = 8  # magic numbers precede the first record
    names = list(variables)

    # Pre-serialize data payloads.
    payloads = {}
    dtype_codes = {}
    for name in names:
        arr = np.asarray(variables[name])
        code = {np.dtype('f4'): 21, np.dtype('f8'): 45,
                np.dtype('i4'): 4, np.dtype('i8'): 8}[
            arr.dtype.newbyteorder('=')]
        dtype_codes[name] = code
        a = arr.astype(arr.dtype.newbyteorder('<'))
        if column_major and arr.ndim > 2:
            a = np.transpose(
                a, [0] + list(range(arr.ndim - 1, 0, -1)))
        payloads[name] = a.tobytes()

    # Sizes: CDR body
    cdr_body_len = 8 + 4 + 4 + 4 + 4 + 4 + 4 + 4 + 4 + 4 + 256
    gdr_body_len = 8 + 8 + 8 + 8 + 4 + 4 + 4 + 4 + 4 + 8 + 4 + 4 + 4

    def zvdr_len(arr):
        return (8 + 4 + 4 + 8 + 8 + 4 + 4 + 4 + 4 + 4 + 4 + 4 + 8 + 4 + 256
                + 4 + 8 * (arr.ndim - 1))

    def vxr_len():
        return 8 + 4 + 4 + 4 + 4 + 8

    cur = base + 12 + cdr_body_len + 12 + gdr_body_len
    zvdr_offsets = {}
    vxr_offsets = {}
    vvr_offsets = {}
    vvr_bodies = {}
    for name in names:
        arr = np.asarray(variables[name])
        zvdr_offsets[name] = cur
        cur += 12 + zvdr_len(arr)
        vxr_offsets[name] = cur
        cur += 12 + vxr_len()
        vvr_offsets[name] = cur
        if compress_vvr:
            comp = zlib.compressobj(6, zlib.DEFLATED, 31)
            cdata = comp.compress(payloads[name]) + comp.flush()
            body = struct.pack('>i', 0) + struct.pack('>q', len(cdata)) + cdata
            vvr_bodies[name] = (_CVVR, body)
        else:
            vvr_bodies[name] = (_VVR, payloads[name])
        cur += 12 + len(vvr_bodies[name][1])
    eof = cur

    flags = 0 if column_major else 1  # bit0 = row-major
    cdr_body = struct.pack(
        '>q', base + 12 + cdr_body_len)            # GDR offset
    cdr_body += struct.pack('>iiiiiiiii', 3, 9, 6, flags, 0, 0, 0, 0, 0)
    cdr_body += b'\x00' * 256
    gdr_body = struct.pack(
        '>qqqq', 0, zvdr_offsets[names[0]] if names else 0, 0, eof)
    gdr_body += struct.pack('>iiiii', 0, 0, -1, 0, len(names))
    gdr_body += struct.pack('>q', 0) + struct.pack('>iii', 0, 0, 0)

    out = struct.pack('>II', V3_MAGIC, UNCOMPRESSED_MAGIC2)
    out += struct.pack('>qi', 12 + cdr_body_len, _CDR) + cdr_body
    out += struct.pack('>qi', 12 + gdr_body_len, _GDR) + gdr_body

    for idx, name in enumerate(names):
        arr = np.asarray(variables[name])
        next_zvdr = zvdr_offsets[names[idx + 1]] if idx + 1 < len(names) else 0
        dims = list(arr.shape[1:])
        body = struct.pack('>q', next_zvdr)
        body += struct.pack('>ii', dtype_codes[name], arr.shape[0] - 1)
        body += struct.pack('>qq', vxr_offsets[name], vxr_offsets[name])
        body += struct.pack('>ii', 1 | (4 if compress_vvr else 0), 0)
        body += struct.pack('>iii', 0, 0, 0)
        body += struct.pack('>ii', 1, idx)
        body += struct.pack('>q', 0)
        body += struct.pack('>i', 0)
        body += name.encode('ascii').ljust(256, b'\x00')
        body += struct.pack('>i', len(dims))
        body += b''.join(struct.pack('>i', d) for d in dims)
        body += b''.join(struct.pack('>i', 1) for _ in dims)
        out += struct.pack('>qi', 12 + len(body), _ZVDR) + body

        vxr_body = struct.pack('>q', 0) + struct.pack('>ii', 1, 1)
        vxr_body += struct.pack('>i', 0)
        vxr_body += struct.pack('>i', arr.shape[0] - 1)
        vxr_body += struct.pack('>q', vvr_offsets[name])
        out += struct.pack('>qi', 12 + len(vxr_body), _VXR) + vxr_body

        rec_type, body = vvr_bodies[name]
        out += struct.pack('>qi', 12 + len(body), rec_type) + body

    with open(path, 'wb') as f:
        f.write(out)
