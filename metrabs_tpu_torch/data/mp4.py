"""ISO base media files (MP4, QuickTime `.mov`) without a video library:
the index of a file's first video track, and a muxer for one mp4v track.

Reading walks the boxes `ftyp`, `moov` (before or after `mdat`) / `mvhd` /
`trak` / `tkhd` (the display matrices: a phone's portrait clip is stored
landscape and turned by them, which cv2 applies), `mdia` / `mdhd` / `hdlr`
and `minf` / `stbl` of the first video track (`vide`), whose sample
table gives each packet: `stsd` (the sample entry's FourCC and size; for
`mp4v` the `esds` DecoderSpecificInfo: the VOS and VOL; for `avc1` and
`avc3` the `avcC`; for `hvc1` and `hev1` the `hvcC`), `stts` (durations:
the frame rate is the `mdhd` timescale over them), `stss` (key frames;
without it every sample is one), `stsc`, `stsz` and `stco`/`co64`. An H.264
or HEVC track's presentation times are its decoding times plus the `ctts`
offsets (versions 0 and 1, read as signed, as FFmpeg's mov demuxer reads
them), shifted by the `elst` edit (an empty edit first delays them):
B-frame streams reorder their frames so. An
edit list that FFmpeg would make drop decoded frames (an edit that starts
past the first frame or ends before the last), holds several edits or
plays at another rate raises UnsupportedVideo.

Writing lays a file out as FFmpeg does: `ftyp`, then `mdat` with the
packets, then `moov` with one track (mp4v with its `esds`, avc1 with its
`avcC`, or hvc1 or hev1 with its `hvcC`), one sample per chunk, `stss` for
the key frames, and `co64` in place of `stco` once an offset passes 4 GiB.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Dict, List, Optional, Tuple

import numpy as np

from metrabs_tpu_torch.data.mpeg4 import UnsupportedVideo

_CONTAINERS = (b'moov', b'trak', b'mdia', b'minf', b'stbl', b'edts', b'dinf')
MPEG4_VISUAL = 0x20  # esds objectTypeIndication of MPEG-4 Part 2 video
# The decoder configuration box of each H.264 and HEVC sample entry
_CONFIG_BOX = {'avc1': b'avcC', 'avc3': b'avcC', 'hvc1': b'hvcC', 'hev1': b'hvcC'}


def _boxes(data: bytes, start: int, end: int):
    """(type, payload start, payload end) of the boxes in data[start:end]."""
    pos = start
    while pos + 8 <= end:
        size, kind = struct.unpack('>I4s', data[pos:pos + 8])
        head = 8
        if size == 1:
            size = struct.unpack('>Q', data[pos + 8:pos + 16])[0]
            head = 16
        elif size == 0:
            size = end - pos
        if size < head or pos + size > end:
            raise ValueError(f'box {kind!r} of size {size} runs past its parent')
        yield kind, pos + head, pos + size
        pos += size


def _top_level(f: BinaryIO, file_size: int):
    """(type, payload offset, payload size) of the file's top-level boxes."""
    pos = 0
    while pos + 8 <= file_size:
        f.seek(pos)
        head = f.read(16)
        size, kind = struct.unpack('>I4s', head[:8])
        n = 8
        if size == 1:
            size, n = struct.unpack('>Q', head[8:16])[0], 16
        elif size == 0:
            size = file_size - pos
        if size < n:
            raise ValueError(f'top-level box {kind!r} of size {size}')
        yield kind, pos + n, min(size, file_size - pos) - n
        pos += size


def _find(data: bytes, start: int, end: int, path: Tuple[bytes, ...]):
    for kind, a, b in _boxes(data, start, end):
        if kind == path[0]:
            return (a, b) if len(path) == 1 else _find(data, a, b, path[1:])
    return None


def _descriptor(data: bytes, pos: int) -> Tuple[int, int, int]:
    """(tag, payload start, payload end) of an MPEG-4 descriptor."""
    tag = data[pos]
    pos += 1
    length = 0
    for _ in range(4):
        b = data[pos]
        pos += 1
        length = (length << 7) | (b & 0x7f)
        if not b & 0x80:
            break
    return tag, pos, pos + length


def decoder_specific_info(esds: bytes) -> Tuple[int, bytes]:
    """(objectTypeIndication, DecoderSpecificInfo) of an esds payload."""
    tag, a, end = _descriptor(esds, 4)  # after version and flags
    if tag != 0x03:
        raise ValueError(f'esds without an ES_Descriptor (tag {tag})')
    flags = esds[a + 2]
    pos = a + 3
    if flags & 0x80:
        pos += 2
    if flags & 0x40:
        pos += 1 + esds[pos]
    if flags & 0x20:
        pos += 2
    tag, a, end = _descriptor(esds, pos)
    if tag != 0x04:
        raise ValueError(f'esds without a DecoderConfigDescriptor (tag {tag})')
    object_type = esds[a]
    pos = a + 13
    if pos < end:
        tag, a, b = _descriptor(esds, pos)
        if tag == 0x05:
            return object_type, esds[a:b]
    return object_type, b''


def read_index(path: str, f: BinaryIO, file_size: int) -> Dict:
    """The first video track of an MP4/QuickTime file: codec (the sample
    entry's FourCC), width, height (as stored), fps, the byte offset and
    size of each packet, the key-frame mask, the decoder configuration,
    (H.264, HEVC) each packet's presentation time in the track's timescale,
    the rotation cv2 applies to its frames (`display_rotation` of the
    track header's matrix after the movie header's) and the sample entry's
    colour (`colr`: (matrix_coefficients, full range) or None)."""
    moov = None
    for kind, at, size in _top_level(f, file_size):
        if kind == b'moov':
            f.seek(at)
            moov = f.read(size)
            break
    if moov is None:
        raise ValueError(f'{path}: no moov box')
    for kind, a, b in _boxes(moov, 0, len(moov)):
        if kind != b'trak':
            continue
        hdlr = _find(moov, a, b, (b'mdia', b'hdlr'))
        if hdlr is None or moov[hdlr[0] + 8:hdlr[0] + 12] != b'vide':
            continue
        mvhd = _find(moov, 0, len(moov), (b'mvhd',))
        version = moov[mvhd[0]]
        movie_scale = struct.unpack('>I', moov[mvhd[0] + (20 if version == 1 else 12):][:4])[0]
        out = _read_track(path, moov, a, b, movie_scale)
        tkhd = _find(moov, a, b, (b'tkhd',))
        if tkhd is not None:
            # The matrices follow 32 (36 in version 1) and 24 (36) bytes of
            # times, ids, rate and volume.
            movie = _matrix(moov, mvhd[0] + (48 if version == 1 else 36))
            track = _matrix(moov, tkhd[0] + (52 if moov[tkhd[0]] == 1 else 40))
            out['rotation'] = display_rotation(_times(track, movie))
        return out
    raise ValueError(f'{path}: no video track')


def _matrix(data: bytes, at: int) -> np.ndarray:
    """A 3x3 transformation matrix of a movie or track header: a, b and c, d
    in 16.16 fixed point, u, v, w in 2.30, row by row as stored."""
    return np.asarray(struct.unpack('>9i', data[at:at + 36]), np.int64).reshape(3, 3)


def _times(track: np.ndarray, movie: np.ndarray) -> np.ndarray:
    """The track's matrix applied after the movie's, in FFmpeg's mov demuxer's
    fixed point: each product shifted by its row's point (16, 16, 30) of the
    track's matrix, the sums kept in 32 bits."""
    out = np.zeros((3, 3), np.int64)
    for e, shift in enumerate((16, 16, 30)):
        out += (track[:, e:e + 1] * movie[e:e + 1, :]) >> shift
    return ((out + (1 << 31)) % (1 << 32)) - (1 << 31)


def display_rotation(matrix) -> int:
    """The clockwise rotation cv2.VideoCapture applies to the frames of a
    stream with this display matrix (3x3, a and b at [0, 0] and [0, 1], c
    and d at [1, 0] and [1, 1], in 16.16): its CAP_PROP_ORIENTATION_META,
    the angle of FFmpeg's av_display_rotation_get rounded to even and taken
    modulo 360, when that is 90, 180 or 270, else 0 (cv2 leaves other
    angles as they are). A mirror so counts only through its angle: (-1, 0,
    0, 1) turns by 180 degrees, (1, 0, 0, -1) not at all."""
    m = np.asarray(matrix, np.float64).reshape(3, 3) / 65536.0
    scale = np.hypot(m[0, 0], m[1, 0]), np.hypot(m[0, 1], m[1, 1])
    if scale[0] == 0 or scale[1] == 0:
        return 0
    angle = int(np.rint(np.degrees(np.arctan2(m[0, 1] / scale[1], m[0, 0] / scale[0])))) % 360
    return angle if angle in (90, 180, 270) else 0


def _read_track(path: str, moov: bytes, a: int, b: int, movie_scale: int) -> Dict:
    mdhd = _find(moov, a, b, (b'mdia', b'mdhd'))
    version = moov[mdhd[0]]
    timescale = struct.unpack('>I', moov[mdhd[0] + (20 if version == 1 else 12):][:4])[0]
    stbl = _find(moov, a, b, (b'mdia', b'minf', b'stbl'))
    if stbl is None:
        raise ValueError(f'{path}: video track without a sample table')
    table = {kind: (x, y) for kind, x, y in _boxes(moov, *stbl)}

    def payload(kind):
        return moov[table[kind][0]:table[kind][1]] if kind in table else None

    stsd = payload(b'stsd')
    entry = next(iter(_boxes(stsd, 8, len(stsd))), None)
    if entry is None:
        raise ValueError(f'{path}: empty sample description')
    codec = stsd[entry[1] - 4:entry[1]].decode('latin1')
    width, height = struct.unpack('>HH', stsd[entry[1] + 24:entry[1] + 28])
    config = b''
    colour = None
    for kind, x, y in _boxes(stsd, entry[1] + 78, entry[2]):
        if kind == b'esds' and codec == 'mp4v':
            object_type, config = decoder_specific_info(stsd[x:y])
            if object_type != MPEG4_VISUAL:
                codec = f'mp4v (objectTypeIndication {object_type:#x})'
        elif codec in _CONFIG_BOX and kind == _CONFIG_BOX[codec]:
            config = stsd[x:y]
        elif kind == b'colr' and colour is None and stsd[x:x + 4] in (b'nclx', b'nclc'):
            # colour_primaries, transfer_characteristics, matrix_coefficients
            # and (nclx) full_range_flag; QuickTime's nclc has no range.
            matrix = struct.unpack('>H', stsd[x + 8:x + 10])[0]
            full = stsd[x + 10] >> 7 if stsd[x:x + 4] == b'nclx' and y > x + 10 else 0
            colour = (matrix, full)
    sizes = _sample_sizes(payload(b'stsz'))
    offsets = _sample_offsets(path, payload(b'stsc'), payload(b'stco'), payload(b'co64'), sizes)
    n = len(sizes)
    stts = payload(b'stts')
    deltas = np.frombuffer(stts[8:8 + 8 * struct.unpack('>I', stts[4:8])[0]], '>u4').reshape(-1, 2)
    total = float((deltas[:, 0].astype(np.int64) * deltas[:, 1]).sum())
    if len(deltas) == 1 and deltas[0, 1]:
        fps = timescale / float(deltas[0, 1])
    else:
        fps = n * timescale / total if total else 0.0
    keyframes = np.ones(n, bool)
    stss = payload(b'stss')
    if stss is not None:
        keyframes[:] = False
        sync = np.frombuffer(stss[8:8 + 4 * struct.unpack('>I', stss[4:8])[0]], '>u4')
        keyframes[sync[(sync >= 1) & (sync <= n)].astype(np.int64) - 1] = True
    out = dict(codec=codec, width=width, height=height, fps=fps, offsets=offsets,
               sizes=sizes, keyframes=keyframes, config=config, colour=colour)
    if codec in _CONFIG_BOX:
        dts = np.concatenate([[0], np.cumsum(np.repeat(deltas[:, 1].astype(np.int64),
                                                       deltas[:, 0].astype(np.int64)))])[:n]
        ctts = payload(b'ctts')
        if ctts is not None:
            runs = np.frombuffer(ctts[8:8 + 8 * struct.unpack('>I', ctts[4:8])[0]],
                                 '>i4').reshape(-1, 2).astype(np.int64)
            offsets_ct = np.repeat(runs[:, 1], runs[:, 0])
            if len(offsets_ct) < n:
                raise ValueError(f'{path}: a ctts of {len(offsets_ct)} of {n} samples')
            dts = dts + offsets_ct[:n]
        elst = _find(moov, a, b, (b'edts', b'elst'))
        shift = 0
        if elst is not None and n:
            shift = _edit_shift(path, moov[elst[0]:elst[1]], int(dts.min()), int(dts.max()),
                                timescale, movie_scale)
        out['pts'] = dts + shift
    return out


def _edit_shift(path: str, elst: bytes, first: int, last: int, timescale: int,
                movie_scale: int) -> int:
    """What an edit list adds to the composition times: the empty edits'
    delay less the media_time of its edit, which must start at the first
    composition time (`first`) or before it and end after the last one
    (`last`): FFmpeg drops the decoded frames outside the edit, and such a
    list raises."""
    version, count = elst[0], struct.unpack('>I', elst[4:8])[0]
    size = 20 if version == 1 else 12
    delay, edit = 0, None
    for k in range(count):
        e = elst[8 + size * k:8 + size * (k + 1)]
        duration, media_time = struct.unpack('>Qq' if version == 1 else '>Ii', e[:size - 4])
        rate = struct.unpack('>i', e[size - 4:size])[0]
        if media_time == -1:
            if edit is None:
                delay += duration * timescale // movie_scale
            continue
        if edit is not None:
            raise UnsupportedVideo(f'{path}: an edit list (elst) of several edits')
        if rate != 0x10000:
            raise UnsupportedVideo(f'{path}: an edit list (elst) at a rate of {rate / 65536}')
        edit = media_time, duration
    if edit is None:
        return 0
    media_time, duration = edit
    if media_time > first or (duration and media_time + duration * timescale / movie_scale <= last):
        raise UnsupportedVideo(f'{path}: an edit list (elst) that drops decoded frames '
                               f'(media_time {media_time}, composition times {first} to {last})')
    return delay - media_time


def _sample_sizes(stsz: bytes) -> np.ndarray:
    size, count = struct.unpack('>II', stsz[4:12])
    if size:
        return np.full(count, size, np.int64)
    return np.frombuffer(stsz[12:12 + 4 * count], '>u4').astype(np.int64)


def _sample_offsets(path: str, stsc: bytes, stco: Optional[bytes], co64: Optional[bytes],
                    sizes: np.ndarray) -> np.ndarray:
    if co64 is not None:
        chunks = np.frombuffer(co64[8:8 + 8 * struct.unpack('>I', co64[4:8])[0]], '>u8')
    elif stco is not None:
        chunks = np.frombuffer(stco[8:8 + 4 * struct.unpack('>I', stco[4:8])[0]], '>u4')
    else:
        raise ValueError(f'{path}: sample table without chunk offsets')
    chunks = chunks.astype(np.int64)
    runs = np.frombuffer(stsc[8:8 + 12 * struct.unpack('>I', stsc[4:8])[0]], '>u4').reshape(-1, 3)
    per_chunk = np.zeros(len(chunks), np.int64)
    for k, (first, count, _) in enumerate(runs):
        last = runs[k + 1][0] - 1 if k + 1 < len(runs) else len(chunks)
        per_chunk[first - 1:last] = count
    offsets = np.empty(len(sizes), np.int64)
    s = 0
    for chunk, count in zip(chunks, per_chunk):
        pos = chunk
        for _ in range(count):
            if s == len(sizes):
                break
            offsets[s] = pos
            pos += sizes[s]
            s += 1
    if s != len(sizes):
        raise ValueError(f'{path}: the chunks hold {s} of {len(sizes)} samples')
    return offsets


def _box(kind: bytes, payload: bytes) -> bytes:
    return struct.pack('>I4s', 8 + len(payload), kind) + payload


def _full_box(kind: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return _box(kind, struct.pack('>I', (version << 24) | flags) + payload)


def _descr(tag: int, payload: bytes) -> bytes:
    n = len(payload)
    return bytes([tag, 0x80 | (n >> 21) & 0x7f, 0x80 | (n >> 14) & 0x7f, 0x80 | (n >> 7) & 0x7f,
                  n & 0x7f]) + payload


_IDENTITY = struct.pack('>9I', 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


class Mp4Muxer:
    """One video track: `ftyp`, `mdat` (its size in 64 bits, filled in on
    close), then `moov`. `timescale / delta` is the frame rate; `config` is
    the VOS and VOL for an mp4v track's esds, an avc1 track's avcC or an
    hvc1 or hev1 track's hvcC (`codec` 'avc1', 'hvc1' or 'hev1', whose
    packets are length-prefixed NAL units)."""

    def __init__(self, f: BinaryIO, width: int, height: int, timescale: int, delta: int,
                 config: bytes, codec: str = 'mp4v'):
        if codec not in ('mp4v', 'avc1', 'hvc1', 'hev1'):
            raise UnsupportedVideo(f'the MP4 muxer writes mp4v, avc1, hvc1 and hev1 tracks, '
                                   f'not {codec!r}')
        self.f, self.width, self.height = f, width, height
        self.timescale, self.delta, self.config = timescale, delta, config
        self.codec = codec
        self.sizes: List[int] = []
        self.offsets: List[int] = []
        self.keys: List[int] = []
        f.write(_box(b'ftyp', b'isom' + struct.pack('>I', 512) + b'isomiso2mp41'))
        self.mdat_at = f.tell()
        f.write(struct.pack('>I4sQ', 1, b'mdat', 0))

    def write(self, packet: bytes, key: bool) -> None:
        self.offsets.append(self.f.tell())
        self.sizes.append(len(packet))
        if key:
            self.keys.append(len(self.sizes))
        self.f.write(packet)

    def close(self) -> None:
        end = self.f.tell()
        self.f.seek(self.mdat_at + 8)
        self.f.write(struct.pack('>Q', end - self.mdat_at))
        self.f.seek(end)
        self.f.write(self._moov())

    def _moov(self) -> bytes:
        n = len(self.sizes)
        duration = n * self.delta
        movie_duration = duration * 1000 // self.timescale
        mvhd = _full_box(b'mvhd', 0, 0, struct.pack('>IIII', 0, 0, 1000, movie_duration)
                         + struct.pack('>IH10x', 0x10000, 0x100) + _IDENTITY + bytes(24)
                         + struct.pack('>I', 2))
        tkhd = _full_box(b'tkhd', 0, 3, struct.pack('>IIIII', 0, 0, 1, 0, movie_duration)
                         + bytes(8) + struct.pack('>hhh2x', 0, 0, 0) + _IDENTITY
                         + struct.pack('>II', self.width << 16, self.height << 16))
        mdhd = _full_box(b'mdhd', 0, 0, struct.pack('>IIIIHH', 0, 0, self.timescale, duration,
                                                    0x55c4, 0))
        hdlr = _full_box(b'hdlr', 0, 0, struct.pack('>I4s12x', 0, b'vide') + b'VideoHandler\0')
        vmhd = _full_box(b'vmhd', 0, 1, bytes(8))
        dinf = _box(b'dinf', _full_box(b'dref', 0, 0, struct.pack('>I', 1)
                                       + _full_box(b'url ', 0, 1, b'')))
        if self.codec in _CONFIG_BOX:
            extension = _box(_CONFIG_BOX[self.codec], self.config)
        else:
            es = (struct.pack('>HB', 1, 0)
                  + _descr(0x04, struct.pack('>BB3sII', MPEG4_VISUAL, 0x11, bytes(3),
                                             max(self.sizes, default=0) * 8, 0)
                           + _descr(0x05, self.config))
                  + _descr(0x06, b'\x02'))
            extension = _full_box(b'esds', 0, 0, _descr(0x03, es))
        entry = _box(self.codec.encode(), bytes(6) + struct.pack('>H', 1) + bytes(16)
                     + struct.pack('>HHIIIH', self.width, self.height, 0x480000, 0x480000, 0, 1)
                     + bytes(32) + struct.pack('>Hh', 24, -1) + extension)
        stsd = _full_box(b'stsd', 0, 0, struct.pack('>I', 1) + entry)
        stts = _full_box(b'stts', 0, 0, struct.pack('>III', 1, n, self.delta) if n
                         else struct.pack('>I', 0))
        stss = _full_box(b'stss', 0, 0, struct.pack(f'>I{len(self.keys)}I', len(self.keys),
                                                    *self.keys))
        stsc = _full_box(b'stsc', 0, 0, struct.pack('>IIII', 1, 1, 1, 1) if n
                         else struct.pack('>I', 0))
        stsz = _full_box(b'stsz', 0, 0, struct.pack(f'>II{n}I', 0, n, *self.sizes))
        if self.offsets and self.offsets[-1] >= 1 << 32:
            chunks = _full_box(b'co64', 0, 0, struct.pack(f'>I{n}Q', n, *self.offsets))
        else:
            chunks = _full_box(b'stco', 0, 0, struct.pack(f'>I{n}I', n, *self.offsets))
        stbl = _box(b'stbl', stsd + stts + stss + stsc + stsz + chunks)
        minf = _box(b'minf', vmhd + dinf + stbl)
        trak = _box(b'trak', tkhd + _box(b'mdia', mdhd + hdlr + minf))
        return _box(b'moov', mvhd + trak)
