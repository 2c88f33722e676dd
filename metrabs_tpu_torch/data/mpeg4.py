"""MPEG-4 Part 2 video (the `mp4v` that cv2 and FFmpeg write, and the
Advanced Simple streams of Xvid) on the host, through `csrc/mpeg4_video.cpp`.

`Decoder` turns the packets of one stream into RGB frames in FFmpeg's
output order. Its planes equal FFmpeg's (`cv2.VideoCapture(path,
cv2.CAP_FFMPEG, [cv2.CAP_PROP_CONVERT_RGB, 0])` for luma, FFmpeg's decoder
for all three) bit for bit, with FFmpeg's Xvid IDCT for Xvid-stamped
streams, and its RGB equals `cv2.VideoCapture`'s BGR frames (swscale's
conversion, `csrc/yuv_rgb.h`: the unscaled path at even heights, the scaler
at odd ones). It decodes the Simple Profile and the Advanced Simple tools
libxvidcore writes: B-VOPs (direct mode included), the packed bitstream,
MPEG quantisation, quarter-pel, GMC of three warping points and
interlaced coding (field DCT and field vectors). A stream that uses another
tool (static sprites, data partitioning, reduced resolution, newpred,
scalability, not-8-bit, ...) raises UnsupportedVideo naming it, as do the
streams FFmpeg decodes with bug workarounds (DivX, old or unstamped Xvid).
`frames_decoded` counts the VOPs decoded, of every type.

`Encoder` writes I-VOPs every GOP frames and P-VOPs between at a fixed
quantiser (OpenCV's GOP of 12 and its qmin of 3), and reconstructs each
frame through the decoder's own IDCT and motion compensation, so a decoder
(FFmpeg's or this one) sees the encoder's reconstruction exactly. It stays
Simple Profile, as cv2's FFmpeg writes mp4v.

The library is built with the host C++ compiler at first use
(`ops/cuda_build.py::build_host_library`) and called through `ctypes`, which
releases the GIL during each call.
"""

from __future__ import annotations

import ctypes
import threading
from fractions import Fraction
from typing import Dict, List, Optional, Tuple

import numpy as np

from metrabs_tpu_torch.ops import cuda_build

GOP = 12  # OpenCV's gop_size for FFmpeg encoders
QSCALE = 3  # OpenCV's qmin: at its bit rate, FFmpeg's rate control rarely goes above
_ERR_LEN = 256
_LOCK = threading.Lock()
_LIB = None
_COUNT_LOCK = threading.Lock()
_FRAMES_DECODED = 0


class UnsupportedVideo(NotImplementedError):
    """A container, codec or coding tool that the port does not read or write."""


def _library() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            path, _ = cuda_build.build_host_library('mpeg4_video')
            lib = ctypes.CDLL(str(path))
            vp, sz, i, cp = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_char_p
            ip, i64 = ctypes.POINTER(ctypes.c_int), ctypes.c_int64
            for name, args, res in (
                    ('decoder_new', [], vp), ('decoder_free', [vp], None),
                    ('decoder_headers_only', [vp], None), ('decoder_fourcc', [vp, cp], None),
                    ('decoder_config', [vp, cp, sz, ip, ip, cp, i], i),
                    ('decoder_colour', [vp, i, i], None),
                    ('decode', [vp, cp, sz, i64, cp, i], i),
                    ('next', [vp, ctypes.POINTER(i64)], i),
                    ('frame', [vp, vp, vp, vp, vp, cp, i], i), ('pictures', [vp], i),
                    ('stats', [vp, ctypes.POINTER(i64), i], None),
                    ('state_equal', [vp, vp], i), ('pending', [vp], i),
                    ('encoder_new', [i] * 6, vp), ('encoder_free', [vp], None),
                    ('encoder_config', [vp, cp, i], i),
                    ('encode', [vp, vp, ctypes.POINTER(vp), ctypes.POINTER(sz), ip], i),
                    ('encoder_recon', [vp, vp, vp, vp], None),
                    ('encoder_tools', [vp] + [i] * 6, None)):
                f = getattr(lib, 'metrabs_mp4v_' + name)
                f.argtypes, f.restype = args, res
            _LIB = lib
        return _LIB


def frames_decoded() -> int:
    """How many VOPs every Decoder of this process has decoded."""
    return _FRAMES_DECODED


# The decoder's counts (csrc/mpeg4_video.cpp, Stat): VOPs by type, not coded,
# B-VOPs FFmpeg skips, VOPs a packed stream stores, then MBs by tool.
STATS = ('i_vops', 'p_vops', 'b_vops', 's_vops', 'not_coded_vops', 'b_vops_skipped',
         'packed_vops', 'gmc_mbs', 'field_dct_mbs', 'field_mv_mbs', 'direct_mbs',
         'direct_field_mbs', 'four_mv_mbs', 'quarter_pel_vectors')


def _check(rc: int, err, name: str) -> None:
    if rc == 1:
        raise ValueError(f'{name}: corrupt mp4v stream ({err.value.decode()})')
    if rc == 2:
        raise UnsupportedVideo(
            f'{name}: the mp4v stream uses {err.value.decode()}, which the port does not '
            f'decode (MPEG-4 Part 2 Simple and Advanced Simple Profile as Xvid writes it)')
    if rc == 3:
        raise ValueError(f'{name}: no VOP (frame) in the mp4v packet')
    if rc != 0:
        raise RuntimeError(f'{name}: the mp4v decoder returned {rc}')


def _has_vol(data: bytes) -> bool:
    at = data.find(b'\x00\x00\x01')
    while 0 <= at < len(data) - 3:
        if 0x20 <= data[at + 3] <= 0x2f:
            return True
        at = data.find(b'\x00\x00\x01', at + 3)
    return False


class Decoder:
    """Decodes the packets of one mp4v stream in order, and hands out frames
    in FFmpeg's output order: with B-VOPs (low_delay 0) an I- or P-VOP comes
    out when the next one is decoded, and the last at `flush`; a VOP that is
    not coded gives none (but a stream that ends on one gives its last frame
    again at the flush, as FFmpeg does); a packed stream's second VOP (Xvid's
    and DivX 5's packed B-VOPs) is decoded with the next packet, whose own
    VOP, a placeholder, is dropped.

    `config` is the decoder configuration (MP4's esds, Matroska's
    CodecPrivate, AVI's strf extra bytes); without one, the first key frame
    must carry the VOL, as AVI key frames do. `fourcc` is an AVI stream's
    FourCC, which FFmpeg reads where the stream carries no encoder stamp
    (XVID: Xvid's IDCT). `start`: the index of the first packet in its file
    (the frames carry `4 * packet + VOP in the packet` as their tags).
    `headers_only`: VOP headers are read and frames ordered, no MB decoded
    (`order`)."""

    def __init__(self, config: bytes = b'', name: str = '<mp4v>', fourcc: str = '',
                 colour: Optional[Tuple[int, int]] = None, start: int = 0,
                 headers_only: bool = False):
        self._lib = _library()
        self._ptr = self._lib.metrabs_mp4v_decoder_new()
        self.name = name
        self.width = self.height = 0
        self.packets = start
        self._counted = not headers_only
        self._lib.metrabs_mp4v_decoder_fourcc(self._ptr, fourcc.encode('latin1'))
        if headers_only:
            self._lib.metrabs_mp4v_decoder_headers_only(self._ptr)
        if colour is not None:  # the container's (matrix_coefficients, full range)
            self._lib.metrabs_mp4v_decoder_colour(self._ptr, *colour)
        if config:
            self.configure(config)

    def configure(self, data: bytes) -> bool:
        """Reads the headers of `data` up to its first VOP; True if a VOL
        (the frame size) was found."""
        w, h = ctypes.c_int(), ctypes.c_int()
        err = ctypes.create_string_buffer(_ERR_LEN)
        rc = self._lib.metrabs_mp4v_decoder_config(self._ptr, data, len(data), ctypes.byref(w),
                                                   ctypes.byref(h), err, _ERR_LEN)
        if rc == 3:
            return False
        _check(rc, err, self.name)
        self.width, self.height = w.value, h.value
        return True

    def _send(self, packet: Optional[bytes]) -> None:
        global _FRAMES_DECODED
        if packet is not None:
            if not self.width or _has_vol(packet):
                self.configure(packet)
            if not self.width:
                raise ValueError(f'{self.name}: a packet before the video object layer header')
        err = ctypes.create_string_buffer(_ERR_LEN)
        before = self.pictures
        data = b'' if packet is None else packet
        rc = self._lib.metrabs_mp4v_decode(self._ptr, data, len(data), self.packets, err, _ERR_LEN)
        if packet is not None:
            self.packets += 1
        if self._counted:
            with _COUNT_LOCK:
                _FRAMES_DECODED += self.pictures - before
        _check(rc, err, self.name)

    def _take(self, luma: bool, planes: bool = False):
        h, w = self.height, self.width
        rgb = np.empty((h, w, 3), np.uint8)
        y = np.empty((h, w), np.uint8) if luma or planes else None
        u = np.empty(((h + 1) // 2, (w + 1) // 2), np.uint8) if planes else None
        v = np.empty_like(u) if planes else None
        ptr = lambda a: None if a is None else a.ctypes.data  # noqa: E731
        err = ctypes.create_string_buffer(_ERR_LEN)
        _check(self._lib.metrabs_mp4v_frame(self._ptr, rgb.ctypes.data, ptr(y), ptr(u), ptr(v),
                                            err, _ERR_LEN), err, self.name)
        return (rgb, (y, u, v)) if planes else (rgb, y) if luma else rgb

    def _waiting(self) -> Optional[int]:
        tag = ctypes.c_int64()
        return tag.value if self._lib.metrabs_mp4v_next(self._ptr, ctypes.byref(tag)) else None

    def decode(self, packet: bytes, luma: bool = False, planes: bool = False) -> list:
        """The frames (none or one) the packet outputs, RGB uint8 [H, W, 3]
        (with `luma`: (RGB, Y [H, W]); with `planes`: (RGB, (Y, U, V)), the
        chroma [(H + 1) // 2, (W + 1) // 2])."""
        self._send(packet)
        return [self._take(luma, planes)] if self._waiting() is not None else []

    def flush(self, luma: bool = False, planes: bool = False) -> list:
        """The frame still waiting at the end of the stream, as `decode`."""
        self._send(None)
        return [self._take(luma, planes)] if self._waiting() is not None else []

    def order(self, packet: Optional[bytes]) -> List[int]:
        """The tags of the frames a packet (None: the end of the stream)
        outputs, without their samples."""
        self._send(packet)
        tag = self._waiting()
        if tag is None:
            return []
        self._lib.metrabs_mp4v_frame(self._ptr, None, None, None, None, None, 0)
        return [tag]

    @property
    def pictures(self) -> int:
        """How many VOPs this decoder has decoded (or parsed, headers only)."""
        return self._lib.metrabs_mp4v_pictures(self._ptr)

    @property
    def pending(self) -> bool:
        """Whether a packed stream's VOP waits for the next packet."""
        return bool(self._lib.metrabs_mp4v_pending(self._ptr))

    def same_state(self, other: 'Decoder') -> bool:
        """Whether this decoder and `other`, after the same packet, output
        alike from there on: the same anchors and stored VOP."""
        return bool(self._lib.metrabs_mp4v_state_equal(self._ptr, other._ptr))

    def stats(self) -> Dict[str, int]:
        """What the decoder met so far, by STATS."""
        out = (ctypes.c_int64 * len(STATS))()
        self._lib.metrabs_mp4v_stats(self._ptr, out, len(STATS))
        return dict(zip(STATS, out))

    def close(self) -> None:
        if self._ptr:
            self._lib.metrabs_mp4v_decoder_free(self._ptr)
            self._ptr = None

    def __del__(self):
        self.close()


def time_base(fps: float) -> Tuple[int, int]:
    """(resolution, increment): fps as resolution / increment with a
    16-bit resolution, as the VOL carries it (25 -> (25, 1), 29.97... ->
    (30000, 1001))."""
    if not fps > 0 or not np.isfinite(fps):
        raise ValueError(f'frame rate must be positive, got {fps}')
    f = Fraction(fps).limit_denominator(1001)
    if not 0 < f.numerator <= 65535:
        raise ValueError(f'frame rate {fps} does not fit the VOL time base')
    return f.numerator, f.denominator


class Encoder:
    """Encodes RGB uint8 [H, W, 3] frames of one size into mp4v packets.

    The coding tools beyond those of cv2's stream are off by default:
    `ac_pred` (AC prediction, per intra MB where it saves bits), `dquant`
    (qscale changes by -1, -2, +1, +2 in turn over the coded MBs),
    `four_mv` (four vectors per MB where they cost less), `packet_mbs`
    (a resync marker and video packet every that many MBs), `dc_threshold`
    (intra_dc_vlc_thr 0-7: from 1 on, the DC goes through the AC table at
    qscale 13, 15, ... and above) and `not_coded_every` (every that many
    frames a P-VOP that is not coded: the previous frame repeats)."""

    def __init__(self, width: int, height: int, fps: float, qscale: int = QSCALE,
                 ac_pred: bool = False, dquant: bool = False,
                 four_mv: bool = False, packet_mbs: int = 0, dc_threshold: int = 0,
                 not_coded_every: int = 0):
        self._lib = _library()
        self.width, self.height = int(width), int(height)
        self.time_resolution, self.time_increment = time_base(fps)
        self._ptr = self._lib.metrabs_mp4v_encoder_new(
            self.width, self.height, self.time_resolution, self.time_increment, GOP, int(qscale))
        if not self._ptr:
            raise ValueError(f'mp4v cannot encode {width}x{height} at {fps} fps, qscale {qscale} '
                             f'(sizes below 8192, qscale 1-31)')
        self._lib.metrabs_mp4v_encoder_tools(self._ptr, int(ac_pred), int(dquant), int(four_mv),
                                             int(packet_mbs), int(dc_threshold),
                                             int(not_coded_every))
        buf = ctypes.create_string_buffer(256)
        n = self._lib.metrabs_mp4v_encoder_config(self._ptr, buf, len(buf))
        self.config = buf.raw[:n]  # VOS, VO and VOL

    def encode(self, rgb: np.ndarray) -> Tuple[bytes, bool]:
        """(packet, is key frame) of one frame."""
        rgb = np.ascontiguousarray(rgb)
        if rgb.shape != (self.height, self.width, 3) or rgb.dtype != np.uint8:
            raise ValueError(f'expected uint8 [{self.height}, {self.width}, 3], got {rgb.dtype} '
                             f'{rgb.shape}')
        data, size, key = ctypes.c_void_p(), ctypes.c_size_t(), ctypes.c_int()
        self._lib.metrabs_mp4v_encode(self._ptr, rgb.ctypes.data, ctypes.byref(data),
                                      ctypes.byref(size), ctypes.byref(key))
        return ctypes.string_at(data.value, size.value), bool(key.value)

    def reconstruction(self):
        """(y, u, v) planes of the last frame as a decoder reconstructs it."""
        h, w = self.height, self.width
        y = np.empty((h, w), np.uint8)
        u = np.empty(((h + 1) // 2, (w + 1) // 2), np.uint8)
        v = np.empty_like(u)
        self._lib.metrabs_mp4v_encoder_recon(self._ptr, y.ctypes.data, u.ctypes.data,
                                             v.ctypes.data)
        return y, u, v

    def close(self) -> None:
        if self._ptr:
            self._lib.metrabs_mp4v_encoder_free(self._ptr)
            self._ptr = None

    def __del__(self):
        self.close()
