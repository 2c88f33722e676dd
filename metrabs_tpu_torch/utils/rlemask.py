"""COCO run-length-encoded mask codec (a copy of `metrabs_tpu/utils/
rlemask.py`, numpy only).

The COCO compressed-RLE format is public: masks are
column-major with runs alternating zero/one (starting with zeros), and the
`counts` bytestring packs each run length as little-endian 5-bit groups with
a continuation bit, biased by 48 into printable ASCII; from the fourth run
on, lengths are delta-coded against the run two positions back.

`eval.association.decode_rle` re-exports `decode`.
"""

from __future__ import annotations

from typing import List, Union

import numpy as np

RLE = dict  # {'size': [h, w], 'counts': bytes|str|List[int]}


def _decode_counts(data: bytes) -> List[int]:
    """Compressed counts bytestring -> absolute run lengths."""
    counts: List[int] = []
    i = 0
    while i < len(data):
        x = 0
        k = 0
        while True:
            c = data[i] - 48
            x |= (c & 0x1F) << (5 * k)
            i += 1
            k += 1
            if not c & 0x20:
                if c & 0x10:  # sign-extend the final group
                    x |= -1 << (5 * k)
                break
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def _encode_counts(counts: List[int]) -> bytes:
    """Absolute run lengths -> compressed counts bytestring (the exact
    inverse of `_decode_counts`, matching the pycocotools wire format)."""
    out = bytearray()
    for j, x in enumerate(counts):
        if j > 2:
            x -= counts[j - 2]
        while True:
            c = x & 0x1F
            x >>= 5  # Python >> is arithmetic for negatives, as required
            more = (x != -1) if (c & 0x10) else (x != 0)
            out.append((c | (0x20 if more else 0)) + 48)
            if not more:
                break
    return bytes(out)


def decode(rle: Union[RLE, np.ndarray]) -> np.ndarray:
    """COCO RLE dict {'size': [h, w], 'counts': ...} -> [h, w] uint8 mask.
    `counts` may be compressed bytes/str or an uncompressed list of run
    lengths. A dense array passes through unchanged (uint8-cast)."""
    if isinstance(rle, np.ndarray):
        return rle.astype(np.uint8)
    h, w = rle['size']
    counts = rle['counts']
    if isinstance(counts, str):
        counts = counts.encode('ascii')
    if isinstance(counts, (bytes, bytearray)):
        counts = _decode_counts(bytes(counts))
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for run in counts:
        flat[pos:pos + run] = val
        pos += run
        val = 1 - val
    return flat.reshape((w, h)).T  # column-major runs


def encode(mask: np.ndarray) -> RLE:
    """[h, w] binary mask -> COCO compressed-RLE dict. Inverse of `decode`."""
    mask = np.asarray(mask)
    if mask.ndim != 2:
        raise ValueError(f'expected a [h, w] mask, got shape {mask.shape}')
    h, w = mask.shape
    flat = (mask.T.reshape(-1) > 0).astype(np.int8)  # column-major
    # Run-length extraction: boundaries where the value changes.
    if flat.size == 0:
        counts: List[int] = []
    else:
        change = np.flatnonzero(np.diff(flat)) + 1
        bounds = np.concatenate([[0], change, [flat.size]])
        runs = np.diff(bounds)
        counts = runs.tolist()
        if flat[0] == 1:  # runs must start with a (possibly empty) zero run
            counts = [0] + counts
    return {'size': [h, w], 'counts': _encode_counts(counts)}


def area(rle: Union[RLE, np.ndarray]) -> int:
    """Foreground pixel count of an RLE (or dense) mask."""
    if isinstance(rle, np.ndarray):
        return int(np.count_nonzero(rle))
    counts = rle['counts']
    if isinstance(counts, str):
        counts = counts.encode('ascii')
    if isinstance(counts, (bytes, bytearray)):
        counts = _decode_counts(bytes(counts))
    return int(sum(counts[1::2]))
