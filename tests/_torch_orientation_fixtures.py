"""Writes the rotated clips of the port's video layer
(`tests/torch_fixtures/orientation/`): phones store a portrait clip as
landscape frames and turn it by the display matrix of the track header
(`tkhd`), which cv2.VideoCapture applies (CAP_PROP_ORIENTATION_AUTO is 1 by
default), FFmpeg's mov demuxer multiplying in the movie header's (`mvhd`).

The same 96x64 frames (the portrait JPEG fixture shrunk, shifted per frame)
are coded as mp4v (the port's encoder), H.264 (libx264) and HEVC at 8 and 10
bits (libx265), I and P pictures, and written by the port's muxers:

- `<codec>_<case>.mp4` and `.mov` for each matrix of `MATRICES` in the
  track header: the turns by 90, 180 and 270 degrees, the two mirrors, the
  transpose and 45 degrees (which cv2 leaves as it is). The `.mov` has the
  shape of a phone's QuickTime file (`quicktime`): `ftyp qt  `, a sound
  track before the video track, `co64` chunk offsets and a `colr` box in
  the sample entry;
- `<codec>_mvhd90.mp4`: the turn by 90 degrees in the movie header only;
- `<codec>_roll90.mkv`: a Matroska track whose rectangular Projection has a
  ProjectionPoseRoll of 90 degrees (counter-clockwise), which FFmpeg's
  matroska demuxer makes a display matrix of: cv2 turns it by 270.

`manifest.json` holds per file cv2's frames (RGB SHA-256), its frame count,
rate, width, height (CAP_PROP_FRAME_WIDTH and HEIGHT, which swap at 90 and
270 degrees) and CAP_PROP_ORIENTATION_META, and its seek for every N (JAX's
`imread('#frame=N')`).

    python tests/_torch_orientation_fixtures.py
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import json
import math
import struct
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
ORIENTATION_DIR = ROOT / 'tests' / 'torch_fixtures' / 'orientation'
SIZE = (96, 64)  # stored (width, height)
FRAMES = 4
FPS = 25.0
_C45 = math.cos(math.pi / 4)
# (a, b, c, d) of the track header's matrix; each with cv2's turn (clockwise).
MATRICES = {
    'rot90': ((0, 1, -1, 0), 90),
    'rot180': ((-1, 0, 0, -1), 180),
    'rot270': ((0, -1, 1, 0), 270),
    'mirror_x': ((-1, 0, 0, 1), 180),  # a mirror: turned by its angle, not mirrored
    'mirror_y': ((1, 0, 0, -1), 0),
    'transpose': ((0, 1, 1, 0), 90),
    'rot45': ((_C45, _C45, -_C45, _C45), 0),  # cv2 turns by 90, 180 and 270 only
}
EXTRA = {'mvhd90': 90, 'roll90': 270}
CODECS = ('mp4v', 'h264', 'hevc8', 'hevc10')
CASES = ([(f'{codec}_{case}{ext}', codec, case) for codec in CODECS for case in MATRICES
          for ext in ('.mp4', '.mov')]
         + [(f'{codec}_mvhd90.mp4', codec, 'mvhd90') for codec in CODECS]
         + [(f'{codec}_roll90.mkv', codec, 'roll90') for codec in CODECS])


def sha256(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes() if isinstance(a, np.ndarray)
                          else a).hexdigest()


# --------------------------------------------------------------------------
# Editing the moov box of a file the port's MP4 muxer wrote (ftyp, mdat,
# then moov: changing moov moves no sample).

_CONTAINER_BOXES = (b'moov', b'trak', b'mdia', b'minf', b'stbl', b'edts', b'dinf')


def parse_boxes(data: bytes) -> list:
    """[type, payload bytes, or the children of a container box] per box."""
    out, pos = [], 0
    while pos < len(data):
        size, kind = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + size]
        out.append([kind, parse_boxes(body) if kind in _CONTAINER_BOXES else body])
        pos += size
    return out


def build_boxes(boxes: list) -> bytes:
    from metrabs_tpu_torch.data import mp4
    return b''.join(mp4._box(kind, build_boxes(body) if isinstance(body, list) else body)
                    for kind, body in boxes)


def child(boxes: list, *path: bytes) -> list:
    """The [type, body] entry at `path` (the first box of each type)."""
    for entry in boxes:
        if entry[0] == path[0]:
            return entry if len(path) == 1 else child(entry[1], *path[1:])
    raise KeyError(path)


def fixed_matrix(a: float, b: float, c: float, d: float) -> bytes:
    """A header's matrix of (a, b, c, d) in 16.16, u, v 0 and w 1 in 2.30."""
    f = lambda v: int(round(v * 65536))  # noqa: E731
    return struct.pack('>9i', f(a), f(b), 0, f(c), f(d), 0, 0, 0, 1 << 30)


def set_matrix(moov: list, box: bytes, matrix: bytes) -> None:
    """Puts `matrix` into the movie header (`mvhd`) or the video track's
    header (`tkhd`), versions 0 and 1."""
    entry = child(moov, b'mvhd') if box == b'mvhd' else child(_video_trak(moov), b'tkhd')
    body = bytearray(entry[1])
    at = {b'mvhd': (36, 48), b'tkhd': (40, 52)}[box][body[0] == 1]
    body[at:at + 36] = matrix
    entry[1] = bytes(body)


def _video_trak(moov: list) -> list:
    for kind, body in moov:
        if kind == b'trak' and child(body, b'mdia', b'hdlr')[1][8:12] == b'vide':
            return body
    raise KeyError('no video track')


def _sound_trak() -> list:
    """A sound track of no samples (16-bit PCM, 48 kHz), track 2."""
    from metrabs_tpu_torch.data import mp4
    fb = mp4._full_box
    tkhd = fb(b'tkhd', 0, 3, struct.pack('>IIIII', 0, 0, 2, 0, 0) + bytes(8)
              + struct.pack('>hhh2x', 0, 1, 0x100) + mp4._IDENTITY + bytes(8))
    mdhd = fb(b'mdhd', 0, 0, struct.pack('>IIIIHH', 0, 0, 48000, 0, 0x55c4, 0))
    hdlr = fb(b'hdlr', 0, 0, struct.pack('>I4s12x', 0, b'soun') + b'SoundHandler\0')
    entry = mp4._box(b'sowt', bytes(6) + struct.pack('>H', 1) + bytes(8)
                     + struct.pack('>HHHHI', 2, 16, 0, 0, 48000 << 16))
    empty = struct.pack('>I', 0)
    stbl = [[b'stsd', struct.pack('>II', 0, 1) + entry], [b'stts', bytes(4) + empty],
            [b'stsc', bytes(4) + empty], [b'stsz', bytes(4) + struct.pack('>II', 0, 0)],
            [b'stco', bytes(4) + empty]]
    dinf = [[b'dref', struct.pack('>II', 0, 1) + fb(b'url ', 0, 1, b'')]]
    minf = [[b'smhd', bytes(8)], [b'dinf', dinf], [b'stbl', stbl]]
    return [b'trak', [[b'tkhd', tkhd[8:]], [b'mdia', [[b'mdhd', mdhd[8:]], [b'hdlr', hdlr[8:]],
                                                      [b'minf', minf]]]]]


def quicktime(moov: list, colour=(1, 1, 1, 0)) -> None:
    """A phone's QuickTime layout of the moov: a sound track before the video
    track, `co64` in place of `stco`, and a `colr` (nclx: primaries,
    transfer, matrix, full range) at the end of the video sample entry."""
    video_at = next(k for k, (kind, body) in enumerate(moov) if kind == b'trak')
    moov.insert(video_at, _sound_trak())
    mvhd = child(moov, b'mvhd')
    mvhd[1] = mvhd[1][:-4] + struct.pack('>I', 3)  # next_track_ID
    stbl = child(_video_trak(moov), b'mdia', b'minf', b'stbl')[1]
    for entry in stbl:
        if entry[0] == b'stco':
            n = struct.unpack('>I', entry[1][4:8])[0]
            offsets = struct.unpack(f'>{n}I', entry[1][8:8 + 4 * n])
            entry[0], entry[1] = b'co64', entry[1][:8] + struct.pack(f'>{n}Q', *offsets)
        elif entry[0] == b'stsd':
            size = struct.unpack('>I', entry[1][8:12])[0]
            sample_entry = entry[1][8:8 + size]
            prim, transfer, matrix, full = colour
            colr = struct.pack('>I4s4sHHHB', 19, b'colr', b'nclx', prim, transfer, matrix,
                               full << 7)
            grown = struct.pack('>I', size + len(colr)) + sample_entry[4:] + colr
            entry[1] = entry[1][:8] + grown + entry[1][8 + size:]


def rewrite_mp4(path: Path, edit, brand: bytes = None) -> None:
    """Rewrites the port muxer's file at `path`: `edit(moov boxes)` changes
    its moov, `brand` (4 bytes) replaces its ftyp's brands (same size)."""
    data = path.read_bytes()
    moov_at = 0
    while data[moov_at + 4:moov_at + 8] != b'moov':  # ftyp, then mdat with a 64-bit size
        size = struct.unpack('>I', data[moov_at:moov_at + 4])[0]
        moov_at += struct.unpack('>Q', data[moov_at + 8:moov_at + 16])[0] if size == 1 else size
    moov = parse_boxes(data[moov_at + 8:])
    edit(moov)
    head = bytearray(data[:moov_at])
    if brand is not None:
        assert head[4:8] == b'ftyp' and struct.unpack('>I', head[:4])[0] == 28
        head[8:28] = brand + struct.pack('>I', 0x200) + brand * 3
    from metrabs_tpu_torch.data import mp4
    path.write_bytes(bytes(head) + mp4._box(b'moov', build_boxes(moov)))


# --------------------------------------------------------------------------

@contextlib.contextmanager
def matroska_roll(roll: float):
    """The port's Matroska muxer writing a Projection with this roll."""
    from metrabs_tpu_torch.data import video
    plain = video._MatroskaMuxer
    video._MatroskaMuxer = functools.partial(plain, roll=roll)
    try:
        yield
    finally:
        video._MatroskaMuxer = plain


def frames():
    from _torch_mp4v_fixtures import shifted_frames
    return shifted_frames(FRAMES, SIZE)


def encode(codec: str, rgb):
    """(packets, key flags) of the frames in `codec` (mp4v: None; the port's
    VideoWriter encodes them itself)."""
    if codec == 'h264':
        from _torch_h264_fixtures import x264_encode
        return x264_encode(rgb, {'keyint': FRAMES, 'min-keyint': FRAMES}, FPS)[:2]
    if codec.startswith('hevc'):
        from _torch_hevc_fixtures import x265_encode
        return x265_encode(rgb, {'keyint': FRAMES, 'min-keyint': FRAMES}, FPS,
                           depth=int(codec[4:]))
    return None


def write_clip(path: Path, codec: str, rgb, coded, roll: float = 0.0) -> None:
    """The frames through the port's muxer for `path`'s extension (.mp4 or
    .mkv)."""
    from _torch_h264_fixtures import write_container
    from metrabs_tpu_torch.data import video
    with matroska_roll(roll):
        if codec == 'mp4v':
            with video.VideoWriter(str(path), FPS, SIZE, 'mp4v') as writer:
                for frame in rgb:
                    writer.write(frame)
        else:
            packets, keys = coded
            write_container(path, packets, keys, SIZE, FPS, 'h264' if codec == 'h264' else 'hevc')


def cv2_entry(path: Path) -> dict:
    import cv2
    from _torch_h264_fixtures import cv2_seeks
    cap = cv2.VideoCapture(str(path))
    rgb = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        rgb.append(sha256(frame[..., ::-1]))
    meta = dict(frame_count=cap.get(cv2.CAP_PROP_FRAME_COUNT), fps=cap.get(cv2.CAP_PROP_FPS),
                width=int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                height=int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
                orientation=cap.get(cv2.CAP_PROP_ORIENTATION_META), frames_read=len(rgb))
    cap.release()
    return dict(cv2=meta, rgb_sha256=rgb, seek=cv2_seeks(path, rgb),
                file_sha256=hashlib.sha256(path.read_bytes()).hexdigest())


def write_fixtures() -> None:
    ORIENTATION_DIR.mkdir(parents=True, exist_ok=True)
    rgb = frames()
    coded = {codec: encode(codec, rgb) for codec in CODECS}
    manifest = {}
    for name, codec, case in CASES:
        path = ORIENTATION_DIR / name
        if case == 'roll90':
            write_clip(path, codec, rgb, coded[codec], roll=90.0)
            turn = EXTRA[case]
        else:
            mp4_path = path.with_suffix('.mp4') if path.suffix == '.mp4' else \
                path.with_name(path.stem + '_mov.mp4')
            write_clip(mp4_path, codec, rgb, coded[codec])
            if case == 'mvhd90':
                matrix, turn = fixed_matrix(*MATRICES['rot90'][0]), EXTRA[case]
                rewrite_mp4(path, lambda moov: set_matrix(moov, b'mvhd', matrix))
            else:
                matrix, turn = fixed_matrix(*MATRICES[case][0]), MATRICES[case][1]
                if path.suffix == '.mov':
                    mp4_path.rename(path)

                    def edit(moov, matrix=matrix):
                        set_matrix(moov, b'tkhd', matrix)
                        quicktime(moov)
                    rewrite_mp4(path, edit, brand=b'qt  ')
                else:
                    rewrite_mp4(path, lambda moov, m=matrix: set_matrix(moov, b'tkhd', m))
        entry = cv2_entry(path)
        entry.update(codec=codec, case=case, turn=turn)
        manifest[name] = entry
        print(name, path.stat().st_size, entry['cv2'])
    (ORIENTATION_DIR / 'manifest.json').write_text(json.dumps(manifest, indent=1) + '\n')


if __name__ == '__main__':
    write_fixtures()
