"""The EXIF Orientation tag of a TIFF-structured block, read as OpenCV's
`ExifReader` reads it for a PNG's `eXIf` chunk and a WebP's `EXIF` chunk
(the block starts with its TIFF header). A JPEG's first APP1 is read by
`csrc/jpeg_decode.cpp` under the same rules, 6 bytes in."""

from __future__ import annotations

import struct


def orientation(block: bytes) -> int:
    """The Orientation (tag 0x0112) of IFD0, 1 when there is none: the byte
    order from `II` or `MM`, the tag mark 42, IFD0's offset and its entries;
    the value is the SHORT in the entry's value field, whatever the entry's
    type says. A read past the block's end ends the search, keeping what was
    read before it; the first Orientation entry counts, as OpenCV keeps the
    first entry of each tag."""
    if block[:2] == b'II':
        order = '<'
    elif block[:2] == b'MM':
        order = '>'
    else:
        return 1
    n = len(block)

    def u16(at: int):
        return struct.unpack_from(order + 'H', block, at)[0] if at + 1 < n else None

    if u16(2) != 0x2A or 7 >= n:
        return 1
    offset = struct.unpack_from(order + 'I', block, 4)[0]
    count = u16(offset)
    if count is None:
        return 1
    offset += 2
    for _ in range(count):
        tag = u16(offset)
        if tag is None:
            return 1
        if tag == 0x0112:
            value = u16(offset + 8)
            return 1 if value is None else value
        offset += 12
    return 1


# TIFF field types: struct code and size of one value.
_FIELD_TYPES = {1: ('B', 1), 2: ('B', 1), 3: ('H', 2), 4: ('I', 4), 5: ('II', 8), 6: ('b', 1),
                7: ('B', 1), 8: ('h', 2), 9: ('i', 4), 10: ('ii', 8), 11: ('f', 4), 12: ('d', 8),
                13: ('I', 4), 16: ('Q', 8), 17: ('q', 8), 18: ('Q', 8)}


def tiff_ifd0(data: bytes, name: str = '<bytes>') -> dict:
    """The entries of the first IFD of a TIFF file, classic (`II*\\0`,
    `MM\\0*`) or BigTIFF (`II+\\0`, `MM\\0+`): tag -> tuple of values
    (RATIONALs as floats, ASCII and UNDEFINED as bytes). As libtiff reads a
    directory, the first entry of a tag counts and entries of an unknown type
    are skipped; an entry whose values lie past the end of the file raises
    ValueError, as does a truncated header or directory. The byte order is
    entry '_order' ('<' or '>'), BigTIFF entry '_big'."""
    if len(data) < 8 or data[:2] not in (b'II', b'MM'):
        raise ValueError(f'{name}: not a TIFF file')
    order = '<' if data[:2] == b'II' else '>'
    version = struct.unpack_from(order + 'H', data, 2)[0]
    if version == 42:
        big, offset = False, struct.unpack_from(order + 'I', data, 4)[0]
    elif version == 43 and len(data) >= 16 and struct.unpack_from(order + 'HH', data, 4) == (8, 0):
        big, offset = True, struct.unpack_from(order + 'Q', data, 8)[0]
    else:
        raise ValueError(f'{name}: not a TIFF file (version {version})')
    count_fmt, entry_size, inline = ('Q', 20, 8) if big else ('H', 12, 4)
    count_size = 8 if big else 2
    if offset + count_size > len(data):
        raise ValueError(f'{name}: truncated TIFF (no first directory)')
    count = struct.unpack_from(order + count_fmt, data, offset)[0]
    if offset + count_size + count * entry_size > len(data):
        raise ValueError(f'{name}: truncated TIFF directory')
    entries = {'_order': order, '_big': big}
    for i in range(count):
        at = offset + count_size + i * entry_size
        tag, kind = struct.unpack_from(order + 'HH', data, at)
        n = struct.unpack_from(order + ('Q' if big else 'I'), data, at + 4)[0]
        if tag in entries or kind not in _FIELD_TYPES:
            continue
        code, size = _FIELD_TYPES[kind]
        nbytes = n * size
        value_at = at + (12 if big else 8)
        if nbytes > inline:
            value_at = struct.unpack_from(order + ('Q' if big else 'I'), data, value_at)[0]
        if value_at + nbytes > len(data):
            raise ValueError(f'{name}: TIFF tag {tag} lies past the end of the file')
        raw = data[value_at:value_at + nbytes]
        if kind in (2, 7):
            entries[tag] = raw
        elif kind in (5, 10):
            pairs = struct.unpack(order + code[0] * (2 * n), raw)
            entries[tag] = tuple(a / b if b else 0.0 for a, b in zip(pairs[::2], pairs[1::2]))
        else:
            entries[tag] = struct.unpack(order + code * n, raw)
    return entries
