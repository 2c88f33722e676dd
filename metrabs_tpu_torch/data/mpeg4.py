"""MPEG-4 Part 2 Simple Profile video (the `mp4v` that cv2 and FFmpeg
write) on the host, through `csrc/mpeg4_video.cpp`.

`Decoder` turns the packets of one stream into RGB frames. Its luma planes
equal FFmpeg's (`cv2.VideoCapture(path, cv2.CAP_FFMPEG,
[cv2.CAP_PROP_CONVERT_RGB, 0])`) bit for bit, with FFmpeg's Xvid IDCT for
Xvid-stamped streams, and its RGB equals `cv2.VideoCapture`'s BGR frames
(swscale's conversion, `csrc/yuv_rgb.h`: the unscaled path at even heights,
the scaler at odd ones). A stream that uses a tool beyond the Simple
Profile (B-VOPs, quarter-pel, GMC, interlaced, data partitioning, MPEG
quantisation, ...) raises UnsupportedVideo naming it, as do the streams
FFmpeg decodes with bug workarounds (DivX, old or unstamped Xvid).

`Encoder` writes I-VOPs every GOP frames and P-VOPs between at a fixed
quantiser (OpenCV's GOP of 12 and its qmin of 3), and reconstructs each
frame through the decoder's own IDCT and motion compensation, so a decoder
(FFmpeg's or this one) sees the encoder's reconstruction exactly.

The library is built with the host C++ compiler at first use
(`ops/cuda_build.py::build_host_library`) and called through `ctypes`, which
releases the GIL during each call.
"""

from __future__ import annotations

import ctypes
import threading
from fractions import Fraction
from typing import Optional, Tuple

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
            vp, sz, i, ip = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int, ctypes.POINTER(
                ctypes.c_int)
            lib.metrabs_mp4v_decoder_new.restype = vp
            lib.metrabs_mp4v_decoder_new.argtypes = []
            lib.metrabs_mp4v_decoder_free.argtypes = [vp]
            lib.metrabs_mp4v_decoder_fourcc.argtypes = [vp, ctypes.c_char_p]
            lib.metrabs_mp4v_decoder_fourcc.restype = None
            lib.metrabs_mp4v_vop_coded.argtypes = [vp, ctypes.c_char_p, sz, ip, ctypes.c_char_p,
                                                   i]
            lib.metrabs_mp4v_vop_coded.restype = ctypes.c_int
            lib.metrabs_mp4v_decoder_config.argtypes = [vp, ctypes.c_char_p, sz, ip, ip,
                                                        ctypes.c_char_p, i]
            lib.metrabs_mp4v_decoder_colour.argtypes = [vp, i, i]
            lib.metrabs_mp4v_decoder_colour.restype = None
            lib.metrabs_mp4v_decode_rgb.argtypes = [vp, ctypes.c_char_p, sz, vp, vp,
                                                    ctypes.c_char_p, i]
            lib.metrabs_mp4v_encoder_new.restype = vp
            lib.metrabs_mp4v_encoder_new.argtypes = [i] * 6
            lib.metrabs_mp4v_encoder_free.argtypes = [vp]
            lib.metrabs_mp4v_encoder_config.argtypes = [vp, ctypes.c_char_p, i]
            lib.metrabs_mp4v_encode.argtypes = [vp, vp, ctypes.POINTER(vp), ctypes.POINTER(sz),
                                                ip]
            lib.metrabs_mp4v_encoder_recon.argtypes = [vp, vp, vp, vp]
            lib.metrabs_mp4v_encoder_tools.argtypes = [vp] + [i] * 6
            lib.metrabs_mp4v_encoder_tools.restype = None
            for name in ('decoder_config', 'decode_rgb', 'encoder_config', 'encode'):
                getattr(lib, f'metrabs_mp4v_{name}').restype = ctypes.c_int
            lib.metrabs_mp4v_decoder_free.restype = lib.metrabs_mp4v_encoder_free.restype = None
            lib.metrabs_mp4v_encoder_recon.restype = None
            _LIB = lib
        return _LIB


def frames_decoded() -> int:
    """How many packets every Decoder of this process has decoded."""
    return _FRAMES_DECODED


def _check(rc: int, err, name: str) -> None:
    if rc == 1:
        raise ValueError(f'{name}: corrupt mp4v stream ({err.value.decode()})')
    if rc == 2:
        raise UnsupportedVideo(
            f'{name}: the mp4v stream uses {err.value.decode()}, which the port does not '
            f'decode (MPEG-4 Part 2 Simple Profile only)')
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
    """Decodes the packets of one mp4v stream in order. `config` is the
    decoder configuration (MP4's esds, Matroska's CodecPrivate, AVI's strf
    extra bytes); without one, the first key frame must carry the VOL, as
    AVI key frames do. `fourcc` is an AVI stream's FourCC, which FFmpeg
    reads where the stream carries no encoder stamp (XVID: Xvid's IDCT)."""

    def __init__(self, config: bytes = b'', name: str = '<mp4v>', fourcc: str = '',
                 colour: Optional[Tuple[int, int]] = None):
        self._lib = _library()
        self._ptr = self._lib.metrabs_mp4v_decoder_new()
        self.name = name
        self.width = self.height = 0
        self._lib.metrabs_mp4v_decoder_fourcc(self._ptr, fourcc.encode('latin1'))
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

    def decode(self, packet: bytes, luma: bool = False):
        """RGB uint8 [H, W, 3] of the packet's VOP (and its luma plane
        [H, W] if `luma`); a not-coded VOP gives the previous frame again
        (`data.video` numbers frames as FFmpeg does, without it)."""
        global _FRAMES_DECODED
        if not self.width or _has_vol(packet):
            self.configure(packet)
        if not self.width:
            raise ValueError(f'{self.name}: a packet before the video object layer header')
        rgb = np.empty((self.height, self.width, 3), np.uint8)
        y = np.empty((self.height, self.width), np.uint8) if luma else None
        err = ctypes.create_string_buffer(_ERR_LEN)
        rc = self._lib.metrabs_mp4v_decode_rgb(self._ptr, packet, len(packet), rgb.ctypes.data,
                                               y.ctypes.data if luma else None, err, _ERR_LEN)
        _check(rc, err, self.name)
        with _COUNT_LOCK:
            _FRAMES_DECODED += 1
        return (rgb, y) if luma else rgb

    def vop_coded(self, packet: bytes) -> bool:
        """The vop_coded flag of the packet's VOP, read from its headers
        (FFmpeg outputs no frame for a VOP that is not coded)."""
        coded = ctypes.c_int()
        err = ctypes.create_string_buffer(_ERR_LEN)
        rc = self._lib.metrabs_mp4v_vop_coded(self._ptr, packet, len(packet), ctypes.byref(coded),
                                              err, _ERR_LEN)
        _check(rc, err, self.name)
        return bool(coded.value)

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
