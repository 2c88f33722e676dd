"""Video files without a video library: Motion JPEG, MPEG-4 Part 2 (`mp4v`),
H.264 and HEVC in AVI, Matroska and MP4.

Reading: the demuxers index a file's video packets once (AVI: RIFF with the
`idx1` index, or the OpenDML `indx` super index and its `ix##` chunks that
FFmpeg writes past 1 GiB; an AVI with neither raises; Matroska: EBML with
SimpleBlock and BlockGroup in Clusters, `DefaultDuration` for the frame
rate; MP4: `data.mp4`), with each packet's key-frame flag and the codec's
private header (AVI `strf` extra bytes, Matroska `CodecPrivate`, MP4 `esds`,
`avcC` or `hvcC`).

- Motion JPEG: frame N is one seek, one read and one `jpeg.decode`, which
  equals `cv2.imdecode` of the packet bit for bit. A packet without a DHT
  segment (the AVI1 convention of Motion JPEG cameras) is decoded with the
  standard Huffman tables, as libjpeg-turbo decodes it. `cv2.VideoCapture`
  decodes through FFmpeg's own IDCT and colour conversion, so its frames
  differ from these by a few levels.
- mp4v (FourCCs `mp4v`, `MP4V`, `FMP4`, `DIVX`, `DX50`, `XVID`; Matroska
  `V_MPEG4/ISO/SP`, `/ASP`, `/AP`): decoded by `data.mpeg4`, whose luma
  equals FFmpeg's and whose RGB equals `cv2.VideoCapture`'s, Simple and
  Advanced Simple (B-VOPs, packed bitstreams, quarter-pel, MPEG
  quantisation, GMC, interlaced). Frames come out in FFmpeg's output
  order, which the index finds from the VOP headers without decoding
  (`_index_vops`): an anchor after the B-VOPs it follows, no frame for a
  VOP that is not coded (but the last again after a final one), a packed
  stream's stored VOP with the next packet; frame N is the N-th, as cv2's
  seek gives it on these files whatever the container's timestamps (MP4
  `ctts`, Matroska's, AVI's none). `num_frames_of_video` stays the
  container's count, as cv2's CAP_PROP_FRAME_COUNT does. Key frames are
  the packets whose first VOP is an I-VOP (FFmpeg's parser's flags), and
  those from which a decoder soon agrees with one from the start are entry
  points (an open GOP's B-VOPs after the I-VOP, which FFmpeg skips there,
  precede its frame). The stream's own VOL decides what is refused.
- H.264 (AVI FourCCs `H264`, `X264`, `AVC1` in any case, Annex B; Matroska
  `V_MPEG4/ISO/AVC` and MP4 `avc1`/`avc3`, length-prefixed with the avcC as
  the configuration): decoded by `data.h264`, whose planes equal FFmpeg's and
  whose RGB equals `cv2.VideoCapture`'s. B-frame streams come out in
  FFmpeg's output order (picture order counts), which the index finds from
  the slice headers without decoding; frame N is the N-th frame of that
  order, as cv2's CAP_PROP_POS_FRAMES seek gives it on these files. MP4's
  `ctts` and `elst` and Matroska's block timestamps (presentation times)
  must order the frames as the picture order counts do, else the file
  raises. Random access starts at the last IDR picture whose frames reach
  the frame, or at a recovery point whose frames are exact by then (its
  recovery-point SEI; an open GOP's leading B pictures are not taken from
  it), else at the first frame.
- HEVC (AVI FourCCs `HEVC`, `H265`, `HVC1`, `HEV1` in any case, Annex B;
  Matroska `V_MPEGH/ISO/HEVC` and MP4 `hvc1`/`hev1`, length-prefixed with
  the hvcC as the configuration): decoded by `data.hevc`, whose planes equal
  FFmpeg's and whose RGB equals `cv2.VideoCapture`'s, I, P and B slices, Main
  and Main 10 (uint16 planes; RGB uint8, as cv2's).
  It is indexed as H.264 is, by one codec-neutral path: the output order
  from the slice headers, frame N as the N-th frame of that order (cv2's
  seek gives it on these files), presentation times checked against it,
  and random access from the last IRAP picture (IDR, CRA or BLA) whose
  frames reach the frame. A decoder started at a CRA picture skips its RASL
  pictures, as FFmpeg does after a seek, so that entry is exact from the
  first frame it outputs (an IDR_W_RADL picture's RADL pictures decode from
  it); a stream that starts at such a CRA picture raises (cv2 counts
  frames it never outputs).

Frames come out as cv2 displays them: MP4's display matrices (the track
header's after the movie header's, `mp4.display_rotation`) and a Matroska
track's Projection roll turn them by 90, 180 or 270 degrees, as a phone's
portrait clip stored landscape is turned; `VideoIndex` keeps the stored size
for the decoders and reports the displayed one (`displayed_size`). An MP4
sample entry's `colr` (matrix and range) sets the RGB conversion of mp4v
and H.264 streams that do not send their own, as FFmpeg's decoders keep it.
QuickTime files (`ftyp qt  `, sound tracks before the video track, `co64`)
are read as MP4.

Frame N of mp4v, H.264 and HEVC is decoded from such an entry point. Each file
keeps a few decoders and its last few frames under a lock, so frames read
in order, from one thread or from several, are each decoded once; every
frame a packet outputs is kept.

Writing: `VideoWriter` writes RGB frames as Motion JPEG (`jpeg.encode`,
equal to `cv2.imencode`) or mp4v (`mpeg4.Encoder`) into an AVI (RIFF,
`idx1`, and past `DEFAULT_RIFF_LIMIT` bytes the OpenDML index in AVIX
extensions, as FFmpeg writes them), a Matroska file (SimpleBlocks, one
Cluster per second, Cues) or, for mp4v, an MP4 file, chosen by the
extension, as cv2 chooses. Frame sizes are kept as given, odd ones too.

Any other codec (VP9, AV1, ...) or container raises UnsupportedVideo
naming it (ROADMAP.md, "Video").
"""

from __future__ import annotations

import collections
import dataclasses
import os
import struct
import threading
from typing import BinaryIO, Dict, List, Optional, Tuple

import numpy as np

from metrabs_tpu_torch.data import h264, hevc, jpeg, mp4, mpeg4
from metrabs_tpu_torch.data.mpeg4 import UnsupportedVideo  # noqa: F401 (the module's error)

MJPEG_CODECS = ('MJPG', 'mjpg', 'V_MJPEG')  # AVI FourCCs, the Matroska CodecID
# AVI FourCCs (any case) and Matroska CodecIDs of MPEG-4 Part 2 video
MP4V_FOURCCS = ('MP4V', 'FMP4', 'DIVX', 'DX50', 'XVID')
MP4V_CODEC_IDS = ('V_MPEG4/ISO/SP', 'V_MPEG4/ISO/ASP', 'V_MPEG4/ISO/AP')
# H.264: AVI FourCCs (any case), the Matroska CodecID, MP4 sample entries
H264_FOURCCS = ('H264', 'X264', 'AVC1')
H264_CODEC_IDS = ('V_MPEG4/ISO/AVC', 'avc1', 'avc3')
# HEVC: AVI FourCCs (any case; cv2's FFmpeg reads these four as HEVC), the
# Matroska CodecID, MP4 sample entries
HEVC_FOURCCS = ('HEVC', 'H265', 'HVC1', 'HEV1')
HEVC_CODEC_IDS = ('V_MPEGH/ISO/HEVC', 'hvc1', 'hev1')
# The codecs whose frames may be reordered, indexed from their slice headers,
# and their MP4 decoder configuration box
_REORDERED = {'h264': (h264, 'avcC'), 'hevc': (hevc, 'hvcC')}
_ROADMAP = 'ROADMAP.md §1, "Still to port"'
_ENTRY_PACKETS = 64  # how far a decoder from a key frame may run before it agrees
DEFAULT_RIFF_LIMIT = 1 << 30  # FFmpeg's AVI_MAX_RIFF_SIZE: an AVIX extension past 1 GiB
_AVIIF_KEYFRAME = 0x10


def codec_kind(codec: str) -> Optional[str]:
    """'mjpeg', 'mp4v', 'h264', 'hevc' or None for a FourCC, CodecID or
    sample entry."""
    if codec in MJPEG_CODECS:
        return 'mjpeg'
    if codec.upper() in MP4V_FOURCCS or codec in MP4V_CODEC_IDS:
        return 'mp4v'
    if codec.upper() in H264_FOURCCS or codec in H264_CODEC_IDS:
        return 'h264'
    if codec.upper() in HEVC_FOURCCS or codec in HEVC_CODEC_IDS:
        return 'hevc'
    return None


@dataclasses.dataclass
class VideoIndex:
    """Where each video packet of a file lies, and the stream's header."""
    path: str
    container: str  # 'avi', 'matroska' or 'mp4'
    codec: str  # the AVI FourCC, the Matroska CodecID or the MP4 sample entry
    width: int
    height: int
    fps: float
    offsets: np.ndarray  # int64 byte offset of each packet
    sizes: np.ndarray  # int64 byte length of each packet
    keyframes: Optional[np.ndarray] = None  # bool per packet; None: every one
    config: bytes = b''  # the codec's private header (mp4v: VOS and VOL; avcC; hvcC)
    # The packet whose decoding outputs each frame, in output order (mp4v:
    # the coded VOPs; H.264 and HEVC reorder: n_frames for the flush at the
    # end);
    # None: one frame per packet.
    frame_packets: Optional[np.ndarray] = None
    # Entry points of random access (mp4v, H.264, HEVC): (first packet, first frame
    # decoded exactly from it, whether it starts at a recovery point), and
    # the first frame a decoder that starts there outputs, by first packet.
    entries: Optional[List[Tuple[int, int, bool]]] = None
    first_frames: Optional[Dict[int, int]] = None
    # Presentation time of each packet (MP4 H.264 and HEVC: decoding time plus ctts,
    # shifted by the elst; Matroska: the block timestamps); None for AVI.
    pts: Optional[np.ndarray] = None
    # The clockwise turn (0, 90, 180 or 270 degrees) cv2 gives the frames:
    # MP4's display matrices (`mp4.display_rotation`), a Matroska track's
    # ProjectionPoseRoll. `width` and `height` stay the stored frames'.
    rotation: int = 0
    # An MP4 sample entry's colour (`colr`): (matrix_coefficients, full
    # range), which FFmpeg's mp4v and H.264 decoders keep for cv2 where the
    # stream does not send its own (its HEVC decoder does not); None without.
    colour: Optional[Tuple[int, int]] = None

    def __post_init__(self):
        if self.keyframes is None:
            self.keyframes = np.ones(len(self.offsets), bool)
        if self.frame_packets is None:
            self.frame_packets = np.arange(len(self.offsets), dtype=np.int64)

    @property
    def n_frames(self) -> int:
        """The container's frame count (cv2's CAP_PROP_FRAME_COUNT)."""
        return len(self.offsets)

    @property
    def n_decoded(self) -> int:
        """How many frames a decoder outputs (cv2's frames read)."""
        return len(self.frame_packets)

    @property
    def kind(self) -> Optional[str]:
        return codec_kind(self.codec)

    @property
    def displayed_size(self) -> Tuple[int, int]:
        """(width, height) of the frames as read (cv2's CAP_PROP_FRAME_WIDTH
        and HEIGHT): the stored ones, swapped by a turn of 90 or 270 degrees."""
        if self.rotation in (90, 270):
            return self.height, self.width
        return self.width, self.height

    def display(self, frame: np.ndarray) -> np.ndarray:
        """A decoded frame turned as cv2 turns it (`rotation`)."""
        if not self.rotation:
            return frame
        return np.ascontiguousarray(np.rot90(frame, -self.rotation // 90))

    def packet(self, i: int, f: Optional[BinaryIO] = None) -> bytes:
        if not 0 <= i < self.n_frames:
            raise IndexError(f'{self.path}: packet {i} of {self.n_frames}')
        if f is None:
            with open(self.path, 'rb') as g:
                return self.packet(i, g)
        f.seek(int(self.offsets[i]))
        data = f.read(int(self.sizes[i]))
        if len(data) != self.sizes[i]:
            raise ValueError(f'{self.path}: truncated packet {i}')
        return data

    def frame(self, i: int, f: Optional[BinaryIO] = None) -> np.ndarray:
        """RGB uint8 [H, W, 3] of frame i as displayed (mp4v, H.264, HEVC:
        through the file's decoder state, from the entry point before i)."""
        if self.kind != 'mjpeg':
            return _stream(self).read(i)
        return self.display(jpeg.decode(self.packet(i, f), f'{self.path}#frame={i}'))

    def decoder(self, start: int = 0, headers_only: bool = False):
        """A decoder of this stream whose first packet is `start`
        (`headers_only`: one that orders frames without decoding them)."""
        if self.kind == 'h264':
            recovering = any(s == start and r for s, _, r in self.entries or [])
            return h264.Decoder(self.config, self.path, recovering, headers_only, self.colour)
        if self.kind == 'hevc':
            return hevc.Decoder(self.config, self.path, headers_only)
        return mpeg4.Decoder(self.config, self.path,
                             self.codec if self.container == 'avi' else '', self.colour,
                             start, headers_only)

    def entry_for(self, frame: int) -> Tuple[int, int]:
        """(first packet, first exact frame) of the latest entry point from
        which `frame` decodes exactly."""
        return max((start, exact) for start, exact, _ in self.entries
                   if self.first_frames[start] <= frame and exact <= frame)


_INDEX_LOCK = threading.Lock()
_INDEX_CACHE: Dict[str, Tuple[Tuple[int, int], VideoIndex]] = {}


def index(path: str) -> VideoIndex:
    """The packet index of a video file, parsed once per path and kept until
    the file's size or modification time changes. Raises FileNotFoundError,
    ValueError for a corrupt file and UnsupportedVideo for another codec or
    container."""
    path = str(path)
    st = os.stat(path)
    key = (st.st_size, st.st_mtime_ns)
    with _INDEX_LOCK:
        hit = _INDEX_CACHE.get(path)
        if hit is not None and hit[0] == key:
            return hit[1]
    with open(path, 'rb') as f:
        head = f.read(12)
        if head[:4] == b'RIFF' and head[8:12] == b'AVI ':
            idx = _index_avi(path, f, st.st_size)
        elif head[:4] == b'\x1a\x45\xdf\xa3':
            idx = _index_matroska(path, f, st.st_size)
        elif head[4:8] in (b'ftyp', b'moov', b'mdat', b'free', b'wide', b'skip'):
            idx = VideoIndex(path=path, container='mp4', **mp4.read_index(path, f, st.st_size))
        else:
            raise UnsupportedVideo(f'{path}: not an AVI, Matroska or MP4 file')
        if idx.kind is None:
            raise UnsupportedVideo(f'{path}: codec {idx.codec!r} is not ported, only Motion JPEG, '
                                   f'MPEG-4 Part 2 (mp4v), H.264 and HEVC ({_ROADMAP})')
        if idx.kind == 'mp4v':
            _index_vops(idx, f)
        elif idx.kind in _REORDERED:
            _index_reordered(idx, f)
    with _INDEX_LOCK:  # threads that parsed the file at once all get the first index
        hit = _INDEX_CACHE.get(path)
        if hit is not None and hit[0] == key:
            return hit[1]
        _INDEX_CACHE[path] = (key, idx)
    return idx


def _index_reordered(idx: VideoIndex, f: BinaryIO) -> None:
    """H.264 and HEVC: the output order, from the parameter sets and slice
    headers (picture order counts, reference marking and the reorder depth)
    without decoding, and the entry points: packet 0, the IDR (HEVC: IRAP)
    pictures and the H.264 recovery points among the key frames (exact from
    their recovery_frame_cnt on; one whose leading pictures would be output
    among the frames before it is no entry). A decoder started at an HEVC
    CRA picture skips its RASL pictures: the entry is exact from the first
    frame it outputs (a RADL picture's or the CRA's own)."""
    codec, config_box = _REORDERED[idx.kind]
    name = codec.Decoder.CODEC
    size = codec.length_size(idx.config)
    if idx.container != 'avi' and not size:
        raise ValueError(f'{idx.path}: an {name} track without its {config_box}')
    n = idx.n_frames
    scan = idx.decoder(headers_only=True)
    emitter, order = [], []  # per output frame: the packet that outputs it, its picture
    kinds = []  # HEVC: the NAL unit type of each packet's picture
    try:
        for p in range(n + 1):
            packet = idx.packet(p, f) if p < n else None
            pictures = scan.order(packet)
            if p < n and scan.pictures != p + 1:
                raise ValueError(f'{idx.path}: {name} packet {p} holds {scan.pictures - p} '
                                 f'pictures, not one')
            if p < n and idx.kind == 'hevc':
                kinds.append(hevc.nal_unit_type(packet, size))
            emitter += [p] * len(pictures)
            order += pictures
    finally:
        scan.close()
    if len(order) != n:
        raise UnsupportedVideo(f'{idx.path}: {n - len(order)} of its {n} {name} pictures are never '
                               f'output (RASL pictures of the CRA picture that starts the stream, '
                               f'or pictures with pic_output_flag 0), and cv2 counts them')
    display = np.empty(n, np.int64)  # the output frame of each packet's picture
    display[np.asarray(order, np.int64)] = np.arange(n)
    idx.frame_packets = np.asarray(emitter, np.int64)
    if idx.pts is not None and not np.array_equal(np.argsort(idx.pts, kind='stable'), order):
        what = 'composition times (ctts)' if idx.container == 'mp4' else 'block timestamps'
        raise UnsupportedVideo(f'{idx.path}: {what} whose order disagrees with the {name} '
                               f"stream's picture order counts")
    # The first frame a decoder that starts at packet k outputs; frames
    # decoded before k all precede it for an entry point.
    first = np.minimum.accumulate(display[::-1])[::-1]
    before = np.maximum.accumulate(np.concatenate([[-1], display[:-1]]))
    idx.entries, idx.first_frames = [(0, 0, False)], {0: 0}
    for k in np.flatnonzero(idx.keyframes[1:]) + 1:
        k = int(k)
        e = codec.entry_point(idx.packet(k, f), size)
        if e.idr:
            skipped = np.asarray(_rasl_pictures(kinds, k), np.int64)
            start = int(np.delete(display[k:], skipped - k).min())
            if before[k] < first[k] and (display[skipped] < start).all():
                idx.entries.append((k, start, False))
                idx.first_frames[k] = start
        elif e.recovery_frames >= 0 and e.exact and before[k] < first[k]:
            exact = k + e.recovery_frames
            idx.entries.append((k, int(display[exact]) if exact < n else n, True))
            idx.first_frames[k] = int(first[k])


def _index_vops(idx: VideoIndex, f: BinaryIO) -> None:
    """mp4v: the output order, from the VOP headers (coding types, vop_coded,
    times, a packed stream's stored VOPs) without decoding, and the entry
    points. A decoder started at a key frame runs beside the one from the
    start until both hold the same anchors and stored VOP (an open GOP's
    first B-VOPs, which FFmpeg skips without their forward reference, lie
    between); the key frame is an entry point if what it output by then is
    the sequence the first one output up to there: frames from its first
    one on, each as the first decoder decodes it. Key frames are the
    packets whose first VOP is an I-VOP, as FFmpeg's mpeg4 parser flags
    them for cv2 (a packed stream's not-coded placeholder of an I-VOP
    included)."""
    n = idx.n_frames
    keys = np.zeros(n, bool)
    scan = idx.decoder(headers_only=True)
    emitter, order = [], []  # per output frame: the packet that outputs it, its tag
    idx.entries, idx.first_frames = [(0, 0, False)], {0: 0}
    trials: List[Tuple[int, 'mpeg4.Decoder', list]] = []  # (first packet, decoder, its tags)
    try:
        for p in range(n + 1):
            packet = idx.packet(p, f) if p < n else None
            if p < n:
                at = packet.find(b'\x00\x00\x01\xb6')
                keys[p] = 0 <= at < len(packet) - 4 and packet[at + 4] >> 6 == 0
            if p < n and p and keys[p] and not scan.pending:
                trials.append((p, idx.decoder(p, headers_only=True), []))
            tags = scan.order(packet)
            emitter += [p] * len(tags)
            order += tags
            for trial in list(trials):
                start, decoder, out = trial
                out += decoder.order(packet)
                agrees = p == n or decoder.same_state(scan)  # past the flush: all is out
                if not agrees and p - start < _ENTRY_PACKETS:
                    continue
                trials.remove(trial)
                decoder.close()
                first = len(order) - len(out)
                if agrees and order[first:] == out:
                    idx.entries.append((start, first, False))
                    idx.first_frames[start] = first
    finally:
        scan.close()
        for _, decoder, _ in trials:
            decoder.close()
    idx.frame_packets = np.asarray(emitter, np.int64)
    idx.keyframes = keys


def _rasl_pictures(kinds: List[int], k: int) -> List[int]:
    """The packets of the RASL pictures a decoder that starts at the IRAP
    picture of packet k skips (HEVC; none for H.264): those up to the next
    IRAP picture."""
    out = []
    for p in range(k + 1, len(kinds)):
        if kinds[p] in hevc.IRAP_TYPES:
            break
        if kinds[p] in hevc.RASL_TYPES:
            out.append(p)
    return out


def read_frame(path: str, i: int) -> np.ndarray:
    """Frame i (from 0) of a video as RGB uint8 [H, W, 3]; FileNotFoundError
    past the frames a decoder outputs, as JAX's cv2 read raises."""
    idx = index(path)
    if not 0 <= i < idx.n_decoded:
        raise FileNotFoundError(f'{path}#frame={i}: the video has {idx.n_decoded} frames')
    return idx.frame(i)


def iter_frames(path: str):
    """Every frame of a video in output order, RGB uint8 [H, W, 3], through
    one open file (and for mp4v, H.264 and HEVC one decoder of its own: each
    frame is decoded once; the last frames of H.264 and HEVC come from the
    flush at the end)."""
    idx = index(path)
    with open(path, 'rb') as f:
        if idx.kind != 'mjpeg':
            cursor = _Cursor(idx, 0)
            try:
                while not cursor.done:
                    yield from cursor.step(f)
            finally:
                cursor.decoder.close()
            return
        for i in range(idx.n_frames):
            yield idx.frame(i, f)


# --------------------------------------------------------------------------
# mp4v, H.264 and HEVC random access

_CACHED_FRAMES = 16  # frames kept per file: twice predict_common's 8 I/O threads
_CURSORS = 3  # decoders kept per file
_MAX_STREAMS = 2  # files with decoders kept
_STREAMS_LOCK = threading.Lock()
_STREAMS: Dict[str, '_Stream'] = {}


class _Cursor:
    """A decoder started at an entry point: the packet it decodes next, the
    frame it outputs next and the first frame it decodes exactly."""

    def __init__(self, idx: VideoIndex, start: int, exact_from: int = 0):
        self.idx = idx
        self.decoder = idx.decoder(start)
        self.start = self.next = start
        self.frame = idx.first_frames[start]
        self.exact_from = exact_from
        self.done = False  # past the flush at the end
        self.flushed = start  # H.264, HEVC: the entry point before which it last flushed
        # H.264, HEVC: the pictures before an entry point all precede it in
        # output order (mp4v decodes on through them: an I-VOP outputs the
        # anchor before it)
        self.entry_starts = set() if idx.kind == 'mp4v' else {s for s, _, _ in idx.entries}

    def step(self, f: BinaryIO) -> list:
        """Decodes the next packet, or flushes the decoder before an entry
        point's packet (H.264, HEVC) and past the last: the frames it outputs,
        turned as displayed (`VideoIndex.display`). The
        frames before an entry point so come out without decoding its
        packet, which a cursor started there may decode."""
        idx = self.idx
        p = self.next
        if p >= idx.n_frames:
            self.done = True
            out = self.decoder.flush()
        elif p in self.entry_starts and self.flushed != p:
            self.flushed = p
            out = self.decoder.flush()
        else:
            self.next += 1
            out = self.decoder.decode(idx.packet(p, f))
        self.frame += len(out)
        return [idx.display(frame) for frame in out]


class _Stream:
    """The decoders over one mp4v, H.264 or HEVC file and the last _CACHED_FRAMES
    frames they decoded. Readers of frame i take the lock: a frame at hand
    is copied out; else the cursor that stands after the entry point of i
    and has not output i decodes on to it; else a new cursor starts at that
    entry point. Every frame a packet outputs goes into the cache. Up to
    _CURSORS cursors are kept, so that the I/O threads of one batch may ask
    across a GOP boundary in any order and each frame read in order is
    decoded once."""

    def __init__(self, idx: VideoIndex):
        self.idx = idx
        self.lock = threading.Lock()
        self.cursors: List[_Cursor] = []  # the most recently used last
        self.frames: 'collections.OrderedDict[int, np.ndarray]' = collections.OrderedDict()

    def read(self, i: int) -> np.ndarray:
        idx = self.idx
        if not 0 <= i < idx.n_decoded:
            raise IndexError(f'{idx.path}: frame {i} of {idx.n_decoded}')
        with self.lock:
            hit = self.frames.get(i)
            if hit is not None:
                return hit.copy()
            start, exact_from = idx.entry_for(i)
            reach = start
            first = idx.first_frames[start]
            if first and idx.frame_packets[first - 1] >= start:
                # The entry's packet outputs the frame before it (an mp4v
                # I-VOP the anchor before it, an IDR picture those waiting):
                # a cursor in the GOP before goes on through that packet
                # rather than leave it to a second decoder.
                reach = max([s for s, _, _ in idx.entries if s < start], default=start)
            usable = [c for c in self.cursors
                      if reach <= c.next and c.frame <= i and c.exact_from <= i and not c.done]
            if usable:
                cursor = max(usable, key=lambda c: c.frame)
                self.cursors.remove(cursor)
            else:
                cursor = _Cursor(idx, start, exact_from)
                if len(self.cursors) >= _CURSORS:
                    self.cursors.pop(0).decoder.close()
            self.cursors.append(cursor)
            rgb = None
            with open(idx.path, 'rb') as f:
                while rgb is None:
                    if cursor.done:
                        raise ValueError(f'{idx.path}: the decoder ended before frame {i}')
                    first = cursor.frame
                    for k, frame in enumerate(cursor.step(f), first):
                        if k >= cursor.exact_from:
                            self.frames[k] = frame
                            if len(self.frames) > _CACHED_FRAMES:
                                self.frames.popitem(last=False)
                        if k == i:
                            rgb = frame
            return rgb.copy()


def _stream(idx: VideoIndex) -> _Stream:
    with _STREAMS_LOCK:
        stream = _STREAMS.get(idx.path)
        if stream is None or stream.idx is not idx:
            stream = _STREAMS[idx.path] = _Stream(idx)
            while len(_STREAMS) > _MAX_STREAMS:
                del _STREAMS[next(iter(_STREAMS))]
        return stream


# --------------------------------------------------------------------------
# AVI


def _chunks(f: BinaryIO, start: int, end: int):
    """(FourCC, data offset, size, list type or None) of the RIFF chunks
    between start and end."""
    pos = start
    while pos + 8 <= end:
        f.seek(pos)
        head = f.read(12)
        if len(head) < 8:
            return
        fcc, size = head[:4], struct.unpack('<I', head[4:8])[0]
        if fcc in (b'RIFF', b'LIST'):
            yield fcc, pos + 12, size - 4, head[8:12]
        else:
            yield fcc, pos + 8, size, None
        pos += 8 + size + (size & 1)


def _index_avi(path: str, f: BinaryIO, file_size: int) -> VideoIndex:
    stream, n_streams = None, 0
    movi: List[Tuple[int, int]] = []
    idx1 = None
    riffs = []
    pos = 0
    while pos + 12 <= file_size:  # RIFF 'AVI ' then RIFF 'AVIX' extensions
        f.seek(pos)
        head = f.read(12)
        if head[:4] != b'RIFF':
            break
        size = struct.unpack('<I', head[4:8])[0]
        riffs.append((pos + 12, min(pos + 8 + size, file_size)))
        pos += 8 + size + (size & 1)
    for r_start, r_end in riffs:
        for fcc, at, size, kind in _chunks(f, r_start, r_end):
            if kind == b'hdrl':
                for sfcc, sat, ssize, skind in _chunks(f, at, at + size):
                    if skind == b'strl':
                        parsed = _parse_strl(f, sat, ssize, n_streams)
                        if parsed is not None and stream is None:
                            stream = parsed
                        n_streams += 1
            elif kind == b'movi':
                movi.append((at - 4, at + size))
            elif fcc == b'idx1' and idx1 is None:
                f.seek(at)
                idx1 = f.read(size)
    if stream is None:
        raise ValueError(f'{path}: no video stream in the AVI header')
    ids = (b'%02ddc' % stream['number'], b'%02ddb' % stream['number'])
    offsets, sizes, keys = [], [], []
    if stream['indx']:
        for qw_offset, _ in stream['indx']:
            # An ix## chunk: its header, then nEntriesInUse at 12 and
            # qwBaseOffset at 20; each entry's offset is its data's.
            f.seek(qw_offset)
            head = f.read(32)
            entries = struct.unpack('<I', head[12:16])[0]
            base = struct.unpack('<Q', head[20:28])[0]
            raw = np.frombuffer(f.read(8 * entries), '<u4').reshape(-1, 2)
            offsets.extend((base + raw[:, 0].astype(np.int64)).tolist())
            sizes.extend((raw[:, 1] & 0x7FFFFFFF).astype(np.int64).tolist())
            keys.extend((raw[:, 1] & 0x80000000 == 0).tolist())  # bit 31: not a key frame
    elif idx1 is not None and movi:
        raw = np.frombuffer(idx1[:len(idx1) // 16 * 16], np.dtype([
            ('id', 'S4'), ('flags', '<u4'), ('offset', '<u4'), ('size', '<u4')]))
        raw = raw[np.isin(raw['id'], ids)]
        if len(raw):
            # Offsets count from the 'movi' FourCC, or from the file's start.
            base = movi[0][0] if raw['offset'][0] < movi[0][0] else 0
            offsets = (raw['offset'].astype(np.int64) + base + 8).tolist()
            sizes = raw['size'].astype(np.int64).tolist()
            keys = (raw['flags'] & _AVIIF_KEYFRAME != 0).tolist()
    else:
        raise ValueError(f'{path}: AVI without an index (idx1 or OpenDML indx)')
    return VideoIndex(path=path, container='avi', codec=stream['codec'],
                      width=stream['width'], height=stream['height'], fps=stream['fps'],
                      offsets=np.asarray(offsets, np.int64), sizes=np.asarray(sizes, np.int64),
                      keyframes=np.asarray(keys, bool), config=stream['extra'])


def _parse_strl(f, start: int, size: int, number: int):
    """The video stream's header fields (None for another stream type)."""
    out = dict(number=number, indx=[])
    for fcc, at, csize, _ in _chunks(f, start, start + size):
        f.seek(at)
        data = f.read(csize)
        if fcc == b'strh':
            if data[:4] != b'vids':
                return None
            scale, rate = struct.unpack('<II', data[20:28])
            out.update(handler=data[4:8], fps=rate / scale if scale else 0.0)
        elif fcc == b'strf':
            width, height = struct.unpack('<ii', data[4:12])
            header = struct.unpack('<I', data[:4])[0]  # biSize: the codec's bytes follow
            out.update(width=width, height=abs(height), compression=data[16:20],
                       extra=data[max(header, 40):])
        elif fcc == b'indx':
            longs, sub, kind, n_used = struct.unpack('<HBBI', data[:8])
            if kind == 0:  # AVI_INDEX_OF_INDEXES: (qwOffset, dwSize, dwDuration) entries
                for k in range(n_used):
                    qw, dw, _ = struct.unpack('<QII', data[24 + 16 * k:40 + 16 * k])
                    out['indx'].append((qw, dw))
    if 'fps' not in out or 'width' not in out:
        raise ValueError('AVI stream header without strh or strf')
    codec = out['compression'] if out['compression'].strip(b'\0') else out['handler']
    out['codec'] = codec.decode('latin1')
    return out


class _AviMuxer:
    """RIFF AVI with one video stream (`fourcc`), laid out as FFmpeg lays it out:
    hdrl with avih and strl (strh, strf, a JUNK chunk that becomes the
    OpenDML `indx` super index), a JUNK that becomes the `odml` list, then
    `movi` with `00dc` chunks and `idx1`. Past DEFAULT_RIFF_LIMIT bytes the RIFF
    is closed with an `ix00` standard index and the packets go on in
    RIFF 'AVIX' extensions, each with its own `ix00`. The indexes flag the
    key frames (idx1 AVIIF_KEYFRAME; ix## entries with bit 31 clear)."""

    SUPER_ENTRIES = 256

    def __init__(self, f: BinaryIO, width: int, height: int, fps: float,
                 fourcc: bytes = b'MJPG'):
        self.f, self.width, self.height, self.fps = f, width, height, fps
        self.fourcc = fourcc
        # (data offset, size, key) per RIFF
        self.riff_frames: List[List[Tuple[int, int, bool]]] = [[]]
        self.ix_chunks: List[Tuple[int, int, int]] = []  # (offset, size, frames)
        self.scale, self.rate = _rational(fps)
        self._write_headers()
        self.riff_start = 0
        self.movi_start = self._begin_list(b'movi')

    def _begin(self, fcc: bytes) -> int:
        at = self.f.tell()
        self.f.write(fcc + b'\0\0\0\0')
        return at

    def _begin_list(self, kind: bytes, fcc: bytes = b'LIST') -> int:
        at = self._begin(fcc)
        self.f.write(kind)
        return at

    def _end(self, at: int) -> None:
        end = self.f.tell()
        size = end - at - 8
        self.f.seek(at + 4)
        self.f.write(struct.pack('<I', size))
        self.f.seek(end)
        if size & 1:
            self.f.write(b'\0')

    def _chunk(self, fcc: bytes, data: bytes) -> None:
        self.f.write(fcc + struct.pack('<I', len(data)) + data)
        if len(data) & 1:
            self.f.write(b'\0')

    def _write_headers(self) -> None:
        riff = self._begin_list(b'AVI ', b'RIFF')
        assert riff == 0
        hdrl = self._begin_list(b'hdrl')
        self.avih_at = self.f.tell()
        self._chunk(b'avih', self._avih(0, 0))
        strl = self._begin_list(b'strl')
        self.strh_at = self.f.tell()
        self._chunk(b'strh', self._strh(0, 0))
        self._chunk(b'strf', struct.pack('<IiiHH4sIiiII', 40, self.width, self.height, 1, 24,
                                         self.fourcc, self.width * self.height * 3, 0, 0, 0,
                                         0))
        self.indx_at = self.f.tell()
        self._chunk(b'JUNK', self._indx([]))
        self._end(strl)
        self.odml_at = self.f.tell()
        self._chunk(b'JUNK', b'odmldmlh' + struct.pack('<I', 248) + bytes(248))
        self._end(hdrl)

    def _avih(self, frames: int, max_bytes: int) -> bytes:
        usec = int(round(1e6 * self.scale / self.rate))
        return struct.pack('<14I', usec, 0, 0, 0x910, frames, 0, 1, max_bytes, self.width,
                           self.height, 0, 0, 0, 0)

    def _strh(self, frames: int, max_bytes: int) -> bytes:
        return (b'vids' + self.fourcc + struct.pack('<IHHIIIIIIII', 0, 0, 0, 0, self.scale,
                                                    self.rate, 0,
                                          frames, max_bytes, 0xFFFFFFFF, 0)
                + struct.pack('<4h', 0, 0, self.width, self.height))

    def _indx(self, entries) -> bytes:
        body = struct.pack('<HBBI4s12x', 4, 0, 0, len(entries), b'00dc')
        for offset, size, frames in entries:
            body += struct.pack('<QII', offset, size, frames)
        return body + bytes(16 * (self.SUPER_ENTRIES - len(entries)))

    def write(self, packet: bytes, key: bool = True) -> None:
        if self.f.tell() - self.riff_start + len(packet) + 8 > DEFAULT_RIFF_LIMIT and \
                self.riff_frames[-1]:
            self._close_riff()
            if len(self.riff_frames) > self.SUPER_ENTRIES:
                raise ValueError(f'more than {self.SUPER_ENTRIES} RIFF extensions')
            self.riff_start = self._begin_list(b'AVIX', b'RIFF')
            self.movi_start = self._begin_list(b'movi')
            self.riff_frames.append([])
        self.riff_frames[-1].append((self.f.tell() + 8, len(packet), key))
        self._chunk(b'00dc', packet)

    def _write_ix(self) -> None:
        frames = self.riff_frames[-1]
        base = frames[0][0] - 8 if frames else 0
        at = self.f.tell()
        body = struct.pack('<HBBI4sQ4x', 2, 0, 1, len(frames), b'00dc', base)
        body += b''.join(struct.pack('<II', off - base, size | (0 if key else 1 << 31))
                         for off, size, key in frames)
        self._chunk(b'ix00', body)
        self.ix_chunks.append((at, len(body) + 8, len(frames)))

    def _close_riff(self) -> None:
        self._write_ix()
        self._end(self.movi_start)
        if len(self.riff_frames) == 1:
            self._write_idx1()
        self._end(self.riff_start)

    def _write_idx1(self) -> None:
        body = b''.join(struct.pack('<4sIII', b'00dc', _AVIIF_KEYFRAME if key else 0,
                                    off - 8 - self.movi_start - 8, size)
                        for off, size, key in self.riff_frames[0])
        self._chunk(b'idx1', body)

    def close(self) -> None:
        all_frames = [fr for riff in self.riff_frames for fr in riff]
        max_bytes = max((size for _, size, _ in all_frames), default=0)
        if len(self.riff_frames) == 1:
            self._end(self.movi_start)
            self._write_idx1()
            self._end(self.riff_start)
        else:
            self._close_riff()
            self.f.seek(self.indx_at)
            self.f.write(b'indx' + struct.pack('<I', 24 + 16 * self.SUPER_ENTRIES)
                         + self._indx(self.ix_chunks))
            self.f.seek(self.odml_at)
            self.f.write(b'LIST' + struct.pack('<I', 4 + 8 + 248) + b'odmldmlh'
                         + struct.pack('<II', 248, len(all_frames)) + bytes(244))
        self.f.seek(self.avih_at + 8)
        self.f.write(self._avih(len(self.riff_frames[0]), max_bytes))
        self.f.seek(self.strh_at + 8)
        self.f.write(self._strh(len(all_frames), max_bytes))
        self.f.seek(0, os.SEEK_END)


def _rational(fps: float) -> Tuple[int, int]:
    """(scale, rate) with rate / scale == fps: an integer rate as it is,
    another to a millionth."""
    if fps <= 0 or not np.isfinite(fps):
        raise ValueError(f'frame rate must be positive, got {fps}')
    if abs(fps - round(fps)) < 1e-9:
        return 1, int(round(fps))
    return 1000000, int(round(fps * 1000000))


# --------------------------------------------------------------------------
# Matroska

_EBML, _SEGMENT, _SEEKHEAD, _INFO, _TRACKS, _CLUSTER, _CUES = (
    0x1A45DFA3, 0x18538067, 0x114D9B74, 0x1549A966, 0x1654AE6B, 0x1F43B675, 0x1C53BB6B)
_TOP_LEVEL = (_SEEKHEAD, _INFO, _TRACKS, _CLUSTER, _CUES, 0x1254C367, 0x1941A469, 0x1043A770)
_UNKNOWN = -1


def _read_vint(f: BinaryIO, keep_marker: bool):
    """(value, length) of an EBML variable-length integer: an element ID
    with its marker bit kept, or a size without it (all ones: _UNKNOWN)."""
    first = f.read(1)
    if not first:
        raise EOFError
    b = first[0]
    if b == 0:
        raise ValueError('invalid EBML variable-length integer')
    length = 1
    while not b & (0x80 >> (length - 1)):
        length += 1
    rest = f.read(length - 1)
    if len(rest) != length - 1:
        raise EOFError
    value = b if keep_marker else b & ((0x80 >> (length - 1)) - 1)
    for c in rest:
        value = (value << 8) | c
    if not keep_marker and value == (1 << (7 * length)) - 1:
        return _UNKNOWN, length
    return value, length


def _elements(f: BinaryIO, start: int, end: int):
    """(id, data offset, size or _UNKNOWN) of the EBML elements between
    start and end; an element of unknown size ends where the next one of the
    top level begins."""
    pos = start
    while pos < end:
        f.seek(pos)
        try:
            eid, n_id = _read_vint(f, keep_marker=True)
            size, n_size = _read_vint(f, keep_marker=False)
        except EOFError:
            return
        at = pos + n_id + n_size
        yield eid, at, size
        if size == _UNKNOWN:
            return
        pos = at + size


def _uint(data: bytes) -> int:
    return int.from_bytes(data, 'big')


def _float(data: bytes) -> float:
    """An EBML float: 0, 4 or 8 bytes, big-endian."""
    return struct.unpack('>f' if len(data) == 4 else '>d', data)[0] if data else 0.0


def _index_matroska(path: str, f: BinaryIO, file_size: int) -> VideoIndex:
    doc = None
    segment = None
    for eid, at, size in _elements(f, 0, file_size):
        if eid == _EBML:
            for cid, cat, csize in _elements(f, at, at + size):
                if cid == 0x4282:
                    f.seek(cat)
                    doc = f.read(csize).decode('latin1')
        elif eid == _SEGMENT:
            segment = (at, file_size if size == _UNKNOWN else min(at + size, file_size))
            break
    if doc not in ('matroska', 'webm') or segment is None:
        raise ValueError(f'{path}: not a Matroska file (DocType {doc!r})')
    scale, track = 1000000, None
    blocks: List[Tuple[int, int, int, bool]] = []  # (data offset, size, timestamp, key)
    pos, end = segment
    while pos < end:
        f.seek(pos)
        try:
            eid, n_id = _read_vint(f, keep_marker=True)
            size, n_size = _read_vint(f, keep_marker=False)
        except EOFError:
            break
        at = pos + n_id + n_size
        if eid == _INFO:
            for cid, cat, csize in _elements(f, at, at + size):
                if cid == 0x2AD7B1:
                    f.seek(cat)
                    scale = _uint(f.read(csize))
        elif eid == _TRACKS:
            track = _matroska_video_track(f, at, at + size)
        elif eid == _CLUSTER:
            if track is None:
                raise ValueError(f'{path}: a Cluster before the Tracks')
            size = _matroska_cluster(f, at, size, end, track['number'], blocks)
        if size == _UNKNOWN:
            raise ValueError(f'{path}: element {eid:#x} of unknown size')
        pos = at + size
    if track is None:
        raise ValueError(f'{path}: no video track')
    if track['default_duration']:
        fps = 1e9 / track['default_duration']
    elif len(blocks) > 1:  # timestamps in presentation order: sorted first
        fps = 1e9 / (float(np.median(np.diff(sorted(b[2] for b in blocks)))) * scale)
    else:
        fps = 0.0
    return VideoIndex(path=path, container='matroska', codec=track['codec'],
                      width=track['width'], height=track['height'], fps=fps,
                      offsets=np.asarray([b[0] for b in blocks], np.int64),
                      sizes=np.asarray([b[1] for b in blocks], np.int64),
                      keyframes=np.asarray([b[3] for b in blocks], bool), config=track['private'],
                      pts=np.asarray([b[2] for b in blocks], np.int64),
                      rotation=_projection_rotation(track['projection']))


def _projection_rotation(projection: Dict[int, float]) -> int:
    """The turn cv2 gives a Matroska track with a Projection (its
    ProjectionType and ProjectionPoseYaw, Pitch and Roll by element ID):
    FFmpeg's matroska demuxer makes a display matrix of a rectangular
    projection whose pitch is 0 and yaw 0 or 180 degrees (a mirror) from
    its roll, counter-clockwise (av_display_rotation_set in 16.16, then
    av_display_matrix_flip), and cv2 turns by that matrix."""
    yaw, pitch, roll = (projection.get(k, 0.0) for k in (0x7673, 0x7674, 0x7675))
    if projection.get(0x7671, 0) != 0 or (yaw == pitch == roll == 0) or pitch != 0 \
            or yaw not in (0.0, 180.0, -180.0) or np.isnan(roll):
        return 0
    flip = -1 if yaw else 1
    radians = roll * flip * np.pi / 180  # av_display_rotation_set(-roll * flip)
    c, s = np.cos(radians), np.sin(radians)
    fixed = lambda v: int(v * 65536)  # noqa: E731 (CONV_DP: truncated)
    matrix = [[fixed(c) * flip, fixed(-s), 0], [fixed(s) * flip, fixed(c), 0], [0, 0, 1 << 30]]
    return mp4.display_rotation(matrix)


def _matroska_video_track(f, start: int, end: int):
    for eid, at, size in _elements(f, start, end):
        if eid != 0xAE:  # TrackEntry
            continue
        fields = dict(number=None, kind=None, codec='', default_duration=0, width=0, height=0,
                      private=b'', projection={})
        for cid, cat, csize in _elements(f, at, at + size):
            f.seek(cat)
            data = f.read(csize)
            if cid == 0xD7:
                fields['number'] = _uint(data)
            elif cid == 0x83:
                fields['kind'] = _uint(data)
            elif cid == 0x86:
                fields['codec'] = data.rstrip(b'\0').decode('latin1')
            elif cid == 0x23E383:
                fields['default_duration'] = _uint(data)
            elif cid == 0x63A2:
                fields['private'] = data
            elif cid == 0xE0:
                for vid, vat, vsize in _elements(f, cat, cat + csize):
                    f.seek(vat)
                    if vid == 0xB0:
                        fields['width'] = _uint(f.read(vsize))
                    elif vid == 0xBA:
                        fields['height'] = _uint(f.read(vsize))
                    elif vid == 0x7670:  # Projection: its type (uint) and pose (floats)
                        for pid, pat, psize in _elements(f, vat, vat + vsize):
                            f.seek(pat)
                            data = f.read(psize)
                            if pid == 0x7671:
                                fields['projection'][pid] = _uint(data)
                            elif pid in (0x7673, 0x7674, 0x7675):
                                fields['projection'][pid] = _float(data)
            elif cid == 0x6D80:  # ContentEncodings: compressed or encrypted frames
                raise UnsupportedVideo('Matroska content encodings are not ported')
        if fields['kind'] == 1:
            return fields
    return None


def _matroska_cluster(f, start: int, size: int, segment_end: int, track: int,
                      blocks: list) -> int:
    """Appends the track's blocks of one Cluster; returns the Cluster's size
    (found by its end for one of unknown size)."""
    end = segment_end if size == _UNKNOWN else start + size
    timestamp = 0
    pos = start
    while pos < end:
        f.seek(pos)
        try:
            eid, n_id = _read_vint(f, keep_marker=True)
            esize, n_size = _read_vint(f, keep_marker=False)
        except EOFError:
            break
        if size == _UNKNOWN and eid in _TOP_LEVEL:
            return pos - start
        at = pos + n_id + n_size
        if esize == _UNKNOWN:
            raise ValueError('a Cluster child of unknown size')
        if eid == 0xE7:  # Timestamp
            f.seek(at)
            timestamp = _uint(f.read(esize))
        elif eid == 0xA3:  # SimpleBlock: bit 7 of its flags marks a key frame
            _matroska_block(f, at, esize, track, timestamp, blocks, None)
        elif eid == 0xA0:  # BlockGroup: a key frame unless it has a ReferenceBlock
            children = list(_elements(f, at, at + esize))
            key = not any(cid == 0xFB for cid, _, _ in children)
            for cid, cat, csize in children:
                if cid == 0xA1:  # Block
                    _matroska_block(f, cat, csize, track, timestamp, blocks, key)
        pos = at + esize
    return end - start


def _matroska_block(f, at: int, size: int, track: int, cluster_ts: int, blocks: list,
                    key: Optional[bool]) -> None:
    f.seek(at)
    number, n = _read_vint(f, keep_marker=False)
    if number != track:
        return
    rel, flags = struct.unpack('>hB', f.read(3))
    if flags & 0x06:
        raise UnsupportedVideo('laced Matroska blocks are not ported')
    head = n + 3
    blocks.append((at + head, size - head, cluster_ts + rel,
                   bool(flags & 0x80) if key is None else key))


def _id_bytes(eid: int) -> bytes:
    return eid.to_bytes((eid.bit_length() + 7) // 8, 'big')


def _element(eid: int, data: bytes) -> bytes:
    return _id_bytes(eid) + _size8(len(data)) + data


def _size8(n: int) -> bytes:
    return (n | (1 << 56)).to_bytes(8, 'big')


def _uint_element(eid: int, value: int) -> bytes:
    return _element(eid, value.to_bytes(max(1, (value.bit_length() + 7) // 8), 'big'))


class _MatroskaMuxer:
    """A Matroska file with one video track (`codec_id`, with `private` as
    its CodecPrivate): EBML header, then a Segment with SeekHead, Info
    (TimestampScale 1 ms, Duration), Tracks (DefaultDuration from the frame
    rate), one Cluster per second of SimpleBlocks (the key frames flagged)
    and Cues, one CuePoint per Cluster. Sizes are written as 8-byte numbers
    and filled in on close."""

    CLUSTER_MS = 1000

    def __init__(self, f: BinaryIO, width: int, height: int, fps: float,
                 codec_id: bytes = b'V_MJPEG', private: bytes = b'', roll: float = 0.0):
        self.f, self.fps = f, fps
        self.n = 0
        self.clusters: List[Tuple[int, int]] = []  # (segment-relative offset, timestamp)
        self.cluster_at = None
        f.write(_element(_EBML, b''.join([
            _uint_element(0x4286, 1), _uint_element(0x42F7, 1), _uint_element(0x42F2, 4),
            _uint_element(0x42F3, 8), _element(0x4282, b'matroska'),
            _uint_element(0x4287, 4), _uint_element(0x4285, 2)])))
        self.segment_at = f.tell()
        f.write(_id_bytes(_SEGMENT) + _size8(0))
        self.data_at = f.tell()
        # SeekHead: Info, Tracks and Cues (filled in on close), each position 8 bytes.
        self.seek_at = f.tell()
        f.write(self._seekhead(0, 0, 0))
        self.info_at = f.tell()
        f.write(self._info(0.0))
        self.tracks_at = f.tell()
        f.write(_element(_TRACKS, _element(0xAE, b''.join([
            _uint_element(0xD7, 1), _uint_element(0x73C5, 1), _uint_element(0x83, 1),
            _uint_element(0x9C, 0), _element(0x86, codec_id),
            *([_element(0x63A2, private)] if private else []),
            _uint_element(0x23E383, int(round(1e9 / fps))),
            _element(0xE0, _uint_element(0xB0, width) + _uint_element(0xBA, height)
                     + (_element(0x7670, _uint_element(0x7671, 0)
                                 + _element(0x7675, struct.pack('>d', roll))) if roll else b''))
        ]))))

    @staticmethod
    def _seekhead(info: int, tracks: int, cues: int) -> bytes:
        def seek(eid, pos):
            return _element(0x4DBB, _element(0x53AB, _id_bytes(eid))
                            + _element(0x53AC, pos.to_bytes(8, 'big')))
        return _element(_SEEKHEAD, seek(_INFO, info) + seek(_TRACKS, tracks)
                        + seek(_CUES, cues))

    @staticmethod
    def _info(duration_ms: float) -> bytes:
        return _element(_INFO, b''.join([
            _uint_element(0x2AD7B1, 1000000), _element(0x4D80, b'metrabs_tpu_torch'),
            _element(0x5741, b'metrabs_tpu_torch'),
            _element(0x4489, struct.pack('>d', duration_ms))]))

    def _timestamp(self, i: int) -> int:
        return int(round(i * 1000 / self.fps))

    def write(self, packet: bytes, key: bool = True) -> None:
        ts = self._timestamp(self.n)
        if self.cluster_at is None or ts - self.clusters[-1][1] >= self.CLUSTER_MS:
            self._end_cluster()
            self.cluster_at = self.f.tell()
            self.clusters.append((self.cluster_at - self.data_at, ts))
            self.f.write(_id_bytes(_CLUSTER) + _size8(0) + _uint_element(0xE7, ts))
        rel = ts - self.clusters[-1][1]
        self.f.write(_element(0xA3, b'\x81' + struct.pack('>hB', rel, 0x80 if key else 0)
                              + packet))
        self.n += 1

    def _end_cluster(self) -> None:
        if self.cluster_at is None:
            return
        end = self.f.tell()
        self.f.seek(self.cluster_at + 4)
        self.f.write(_size8(end - self.cluster_at - 12))
        self.f.seek(end)
        self.cluster_at = None

    def close(self) -> None:
        self._end_cluster()
        cues_at = self.f.tell()
        self.f.write(_element(_CUES, b''.join(
            _element(0xBB, _uint_element(0xB3, ts) + _element(
                0xB7, _uint_element(0xF7, 1) + _uint_element(0xF1, offset)))
            for offset, ts in self.clusters)))
        end = self.f.tell()
        self.f.seek(self.segment_at + 4)
        self.f.write(_size8(end - self.data_at))
        self.f.seek(self.seek_at)
        self.f.write(self._seekhead(self.info_at - self.data_at, self.tracks_at - self.data_at,
                                    cues_at - self.data_at))
        self.f.seek(self.info_at)
        self.f.write(self._info(self.n * 1000 / self.fps))
        self.f.seek(end)


# --------------------------------------------------------------------------


class VideoWriter:
    """Writes RGB uint8 [H, W, 3] frames of one size into the container the
    extension names, as cv2 does: `fourcc` 'MJPG' (each frame through
    `jpeg.encode` at cv2's default quality) into `.avi` or `.mkv`, or
    'mp4v' (`mpeg4.Encoder`: an I-VOP every 12 frames at cv2's quantiser)
    into `.mp4`, `.avi` or `.mkv`. Any other codec or container raises
    UnsupportedVideo naming it. Each AVI RIFF holds at most
    DEFAULT_RIFF_LIMIT bytes; an OpenDML AVIX extension follows past it."""

    def __init__(self, path: str, fps: float, size: Tuple[int, int], fourcc: str = 'MJPG'):
        path = str(path)
        codec = {'MJPG': 'mjpeg', 'MP4V': 'mp4v'}.get(fourcc.upper())
        if codec is None:
            raise UnsupportedVideo(f'{path}: codec {fourcc!r} is not ported for writing, only '
                                   f'MJPG and mp4v ({_ROADMAP})')
        ext = os.path.splitext(path)[1].lower()
        containers = ('.avi', '.mkv', '.mp4') if codec == 'mp4v' else ('.avi', '.mkv')
        if ext not in containers:
            raise UnsupportedVideo(f'{path}: container {ext or "(none)"!r} is not ported for '
                                   f'{fourcc}, only {", ".join(containers)}')
        self.path, self.width, self.height = path, int(size[0]), int(size[1])
        self.n_frames = 0
        # The mp4v encoder (None for MJPG): its `reconstruction()` is what a
        # decoder gives for the frame written last.
        self.encoder = (mpeg4.Encoder(self.width, self.height, float(fps))
                         if codec == 'mp4v' else None)
        self._f = open(path, 'wb')
        try:
            if codec == 'mjpeg':
                mux_args = dict(avi=(b'MJPG',), mkv=(b'V_MJPEG',))
            else:
                mux_args = dict(avi=(b'mp4v',), mkv=(b'V_MPEG4/ISO/SP', self.encoder.config))
            if ext == '.avi':
                self._mux = _AviMuxer(self._f, self.width, self.height, float(fps),
                                      *mux_args['avi'])
            elif ext == '.mkv':
                self._mux = _MatroskaMuxer(self._f, self.width, self.height, float(fps),
                                           *mux_args['mkv'])
            else:
                rate, scale = self.encoder.time_resolution, self.encoder.time_increment
                self._mux = mp4.Mp4Muxer(self._f, self.width, self.height, rate, scale,
                                         self.encoder.config)
        except BaseException:
            self._f.close()
            raise

    def write(self, rgb: np.ndarray) -> None:
        if rgb.shape != (self.height, self.width, 3):
            raise ValueError(f'{self.path}: frame of shape {rgb.shape}, the video is '
                             f'{self.height}x{self.width}x3')
        if self.encoder is None:
            self.write_packet(jpeg.encode(rgb))
            return
        packet, key = self.encoder.encode(rgb)
        if key and isinstance(self._mux, _AviMuxer):
            packet = self.encoder.config + packet  # AVI key frames carry the VOL, as FFmpeg's
        self.write_packet(packet, key)

    def write_packet(self, packet: bytes, key: bool = True) -> None:
        """Writes one encoded frame as it is."""
        self._mux.write(packet, key)
        self.n_frames += 1

    def close(self) -> None:
        if self._f.closed:
            return
        try:
            self._mux.close()
        finally:
            self._f.close()
            if self.encoder is not None:
                self.encoder.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
