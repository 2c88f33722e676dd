"""PNM, PAM and PFM decoding on the host, equal to `cv2.imread` (OpenCV
5.0's PxM, PAM and PFM readers) bit for bit, in colour and in gray.

- P1-P6 (PBM, PGM, PPM; ASCII and binary; `#` comments in the header):
  the header's numbers are read as PxMDecoder's ReadNumber reads them, one
  character after the last consumed. Binary samples are NOT scaled by
  maxval: 8-bit samples are read as stored and 16-bit ones (maxval above
  255) keep their high byte. ASCII samples are clamped to maxval and, at 8
  bits, scaled to 255 (i * 255 / maxval); at 16 bits they keep their high
  byte. PBM's 1 is black. Gray from RGB is OpenCV's icvCvt_BGR2Gray.
- P7 (PAM): WIDTH, HEIGHT, DEPTH, MAXVAL, TUPLTYPE and ENDHDR lines as
  ReadPAMHeaderLine reads them; GRAYSCALE and RGB tuples (or none, at depth
  1 or 3 with maxval below 256) unscaled; OpenCV copies RGB tuples into its
  BGR image as they are, so the colour read has red and blue swapped; maxval
  1 is read as packed bits (OpenCV's bit mode). GRAYSCALE_ALPHA and
  RGB_ALPHA, whose cv2 reads run past their rows (not a function of the
  file), raise NotImplementedError.
- PF (colour) and Pf (gray) float maps: bottom-up rows, little-endian for a
  negative scale, big-endian for a positive one; each sample times
  float(1 / |scale|), rounded half to even and saturated to 8 bits (no
  x255). cv2.imread returns None for PF in gray and for Pf in colour, and
  `decode` raises ValueError there.

Where cv2.imread returns None (a bad header, truncated data, maxval above
65535) `decode` raises ValueError. The ASCII numbers are read by
`csrc/raster_decode.cpp` (see data/raster_native.py).
"""

from __future__ import annotations

import ctypes

import numpy as np

from metrabs_tpu_torch.data import raster_native

_WHITESPACE = b' \t\n\v\f\r'
_PAM_FIELDS = (b'WIDTH', b'HEIGHT', b'DEPTH', b'MAXVAL', b'TUPLTYPE', b'ENDHDR')
_PAM_TUPLES = (b'BLACKANDWHITE', b'GRAYSCALE', b'GRAYSCALE_ALPHA', b'RGB', b'RGB_ALPHA')


def is_pnm(data: bytes) -> bool:
    """A PxM, PAM or PFM signature, as OpenCV's decoders check it."""
    return len(data) >= 3 and data[0:1] == b'P' and data[1] in b'1234567Ff' and \
        data[2] in _WHITESPACE


def _numbers(data: bytes, pos: int, count: int, max_digits: int, name: str):
    out = np.empty(count, np.int32)
    at = ctypes.c_size_t(pos)
    err = raster_native.error_buffer()
    if raster_native.library().metrabs_pnm_numbers(data, len(data), ctypes.byref(at), count,
                                                   max_digits, out.ctypes.data, err,
                                                   raster_native.ERR_LEN):
        raise ValueError(f'{name}: corrupt PNM ({err.value.decode()})')
    return out, at.value


def _pxm_header(data: bytes, name: str) -> dict:
    kind = data[1] - ord('0')
    bpp = {1: 1, 4: 1, 2: 8, 5: 8, 3: 24, 6: 24}[kind]
    values, pos = _numbers(data, 2, 2 if bpp == 1 else 3, 0, name)
    width, height = int(values[0]), int(values[1])
    maxval = 1 if bpp == 1 else int(values[2])
    if width <= 0 or height <= 0 or not 0 < maxval < 65536:
        raise ValueError(f'{name}: bad PNM header ({width}x{height}, maxval {maxval})')
    return dict(kind=kind, bpp=bpp, width=width, height=height, maxval=maxval, offset=pos)


def _pam_header(data: bytes, name: str) -> dict:
    """ReadPAMHeaderLine over the header, up to ENDHDR."""
    pos, n, fields = 3, len(data), {}

    def byte():
        nonlocal pos
        if pos >= n:
            raise ValueError(f'{name}: truncated PAM header')
        pos += 1
        return data[pos - 1:pos]

    while True:
        c = byte()
        while c in _WHITESPACE:
            c = byte()
        if c == b'#':
            while c not in (b'\n', b'\r'):
                c = byte()
            continue
        ident = b''
        while c not in _WHITESPACE and len(ident) < 8:
            ident += c
            c = byte()
        if c not in _WHITESPACE or ident not in _PAM_FIELDS:
            raise ValueError(f'{name}: bad PAM header field {ident!r}')
        value = b''
        if c not in (b'\n', b'\r'):
            c = byte()
            while c in _WHITESPACE:
                c = byte()
            while c not in (b'\n', b'\r') and len(value) < 255:
                value += c
                c = byte()
            if c not in (b'\n', b'\r'):
                raise ValueError(f'{name}: PAM header value too long')
        if ident == b'ENDHDR':
            break
        if ident in fields and ident != b'TUPLTYPE':
            raise ValueError(f'{name}: PAM field {ident.decode()} given twice')
        fields[ident] = value.rstrip()
    try:
        width, height, depth, maxval = (int(fields[k]) for k in (b'WIDTH', b'HEIGHT', b'DEPTH',
                                                                 b'MAXVAL'))
    except (KeyError, ValueError):
        raise ValueError(f'{name}: a PAM header without WIDTH, HEIGHT, DEPTH or MAXVAL') from None
    tuple_type = fields.get(b'TUPLTYPE')
    if tuple_type is not None and tuple_type not in _PAM_TUPLES:
        raise ValueError(f'{name}: PAM tuple type {tuple_type!r} (cv2.imread reads none)')
    if tuple_type is None:
        if depth == 1 and maxval == 1:
            tuple_type = b'BLACKANDWHITE'
        elif depth in (1, 3) and maxval < 256:
            tuple_type = b'GRAYSCALE' if depth == 1 else b'RGB'
        else:
            raise ValueError(f'{name}: a PAM of depth {depth}, maxval {maxval} without a tuple '
                             f'type (cv2.imread reads none)')
    if width <= 0 or height <= 0 or not 0 < maxval <= 65535 or not 1 <= depth <= 4:
        raise ValueError(f'{name}: bad PAM header ({width}x{height}x{depth}, maxval {maxval})')
    return dict(kind=7, width=width, height=height, depth=depth, maxval=maxval,
                tuple_type=tuple_type, offset=pos)


def _pfm_header(data: bytes, name: str) -> dict:
    pos = 3

    def token():
        nonlocal pos
        start = pos
        while pos < len(data) and data[pos] not in _WHITESPACE:
            if data[pos] >= 128:
                raise ValueError(f'{name}: bad PFM header byte')
            pos += 1
        if pos >= len(data):
            raise ValueError(f'{name}: truncated PFM header')
        pos += 1
        return data[start:pos - 1].decode('ascii')

    def c_int(s):  # atoi: the leading digits, 0 without any
        digits = s.lstrip()
        sign = -1 if digits[:1] == '-' else 1
        digits = digits[1:] if digits[:1] in '+-' else digits
        i = 0
        while i < len(digits) and digits[i].isdigit():
            i += 1
        return sign * int(digits[:i]) if i else 0

    def c_float(s):  # atof: the longest leading float, 0 without one
        s = s.lstrip()
        for end in range(len(s), 0, -1):
            try:
                return float(s[:end])
            except ValueError:
                continue
        return 0.0

    width, height, scale = c_int(token()), c_int(token()), c_float(token())
    if width <= 0 or height <= 0 or scale == 0 or width > 1 << 20 or height > 1 << 20:
        raise ValueError(f'{name}: bad PFM header ({width}x{height}, scale {scale})')
    return dict(kind='F' if data[1:2] == b'F' else 'f', width=width, height=height, scale=scale,
                offset=pos)


def parse(data: bytes, name: str = '<bytes>') -> dict:
    if not is_pnm(data):
        raise ValueError(f'{name}: not a PNM, PAM or PFM file')
    if data[1:2] == b'7':
        if data[2] not in b'\n\r':
            raise ValueError(f'{name}: no line break after P7')
        return _pam_header(data, name)
    if data[1:2] in (b'F', b'f'):
        if data[2] != ord('\n'):
            raise ValueError(f'{name}: no line break after the PFM signature')
        return _pfm_header(data, name)
    return _pxm_header(data, name)


def header(data: bytes, name: str = '<bytes>'):
    """(width, height) of a P1-P6 or Pf file, as PIL's size. PIL identifies
    neither PAM nor colour PFM: those raise ValueError, as PIL raises."""
    info = parse(data, name)
    if info['kind'] in (7, 'F'):
        raise ValueError(f'{name}: PIL does not identify a {"PAM" if info["kind"] == 7 else "PF"}'
                         f' file')
    return info['width'], info['height']


def _bits(rows: np.ndarray, width: int) -> np.ndarray:
    """The first `width` bits (MSB first) of each row, as 0 or 1."""
    return np.unpackbits(rows, axis=1)[:, :width]


def _take(data: bytes, offset: int, count: int, dtype, name: str) -> np.ndarray:
    size = np.dtype(dtype).itemsize * count
    if offset + size > len(data):
        raise ValueError(f'{name}: truncated pixel data')
    return np.frombuffer(data, dtype, count, offset)


def _pxm(data: bytes, info: dict, gray: bool, name: str) -> np.ndarray:
    w, h, maxval, kind = info['width'], info['height'], info['maxval'], info['kind']
    channels = 3 if info['bpp'] == 24 else 1
    if info['bpp'] == 1:
        if kind == 4:
            rows = _take(data, info['offset'], h * -(-w // 8), np.uint8, name).reshape(h, -1)
            bit = _bits(rows, w)
        else:
            bit = (_numbers(data, info['offset'], w * h, 1, name)[0] != 0).reshape(h, w)
        g = np.where(bit == 1, 0, 255).astype(np.uint8)
        return g if gray else np.repeat(g[..., None], 3, axis=2)
    count = w * h * channels
    if kind in (5, 6):
        dtype = '>u2' if maxval > 255 else np.uint8
        v = _take(data, info['offset'], count, dtype, name)
        v = (v >> 8) if maxval > 255 else v
    else:
        v = np.minimum(_numbers(data, info['offset'], count, 0, name)[0], maxval).astype(np.int64)
        v = (v >> 8) if maxval > 255 else v * 255 // maxval
    v = v.astype(np.uint8).reshape(h, w, channels)
    if channels == 1:
        return v[..., 0] if gray else np.repeat(v, 3, axis=2)
    return raster_native.gray14(v) if gray else np.ascontiguousarray(v)


def _pam(data: bytes, info: dict, gray: bool, name: str) -> np.ndarray:
    w, h, depth, maxval = info['width'], info['height'], info['depth'], info['maxval']
    if info['tuple_type'] in (b'GRAYSCALE_ALPHA', b'RGB_ALPHA'):
        raise NotImplementedError(f'{name}: a PAM of tuple type {info["tuple_type"].decode()} '
                                  f'(cv2.imread reads past its rows)')
    wide = maxval > 255
    v = _take(data, info['offset'], w * h * depth, '>u2' if wide else np.uint8, name)
    if maxval == 1:  # bit mode: each row's bytes read as packed bits
        g = (_bits(np.asarray(v, np.uint8).reshape(h, w * depth), w) * 255).astype(np.uint8)
        return g if gray else np.repeat(g[..., None], 3, axis=2)
    v = ((v >> 8) if wide else v).astype(np.uint8).reshape(h, w, depth)
    if depth == 1:
        return v[..., 0] if gray else np.repeat(v, 3, axis=2)
    if depth != 3 or info['tuple_type'] == b'GRAYSCALE':
        raise NotImplementedError(f'{name}: a {info["tuple_type"].decode()} PAM of depth {depth}')
    # The samples go into OpenCV's BGR image as they are (red and blue swap);
    # gray converts them as RGB.
    return raster_native.gray14(v) if gray else np.ascontiguousarray(v[..., ::-1])


def _pfm(data: bytes, info: dict, gray: bool, name: str) -> np.ndarray:
    channels = 3 if info['kind'] == 'F' else 1
    if gray != (channels == 1):
        raise ValueError(f'{name}: cv2.imread reads a {"colour" if channels == 3 else "gray"} '
                         f'PFM in {"gray" if gray else "colour"} as None')
    w, h = info['width'], info['height']
    dtype = '<f4' if info['scale'] < 0 else '>f4'
    v = _take(data, info['offset'], w * h * channels, dtype, name).reshape(h, w, channels)[::-1]
    v = v.astype(np.float32) * np.float32(1.0 / abs(info['scale']))
    out = raster_native.saturate_u8(v)
    return out[..., 0] if gray else out


def decode(data: bytes, name: str = '<bytes>', gray: bool = False) -> np.ndarray:
    """RGB uint8 [H, W, 3] of a PNM, PAM or PFM file as `cv2.imread(path,
    IMREAD_COLOR)` gives it (in RGB order), or with `gray` uint8 [H, W] as
    `IMREAD_GRAYSCALE` gives it."""
    info = parse(data, name)
    if info['width'] > 1 << 20 or info['height'] > 1 << 20 or \
            info['width'] * info['height'] > 1 << 30:
        raise ValueError(f'{name}: {info["width"]}x{info["height"]} pixels (cv2.imread refuses)')
    if info['kind'] == 7:
        return _pam(data, info, gray, name)
    if info['kind'] in ('F', 'f'):
        return _pfm(data, info, gray, name)
    return _pxm(data, info, gray, name)

