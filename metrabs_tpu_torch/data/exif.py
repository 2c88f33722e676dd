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
