"""H.264 / AVC video on the host, through `csrc/h264_decode.cpp`.

`Decoder` turns the packets of one stream (access units, length-prefixed
as MP4 and Matroska hold them, or Annex B as AVI holds them) into frames.
Its Y, U and V planes equal FFmpeg's (`cv2.VideoCapture(path,
cv2.CAP_FFMPEG, [cv2.CAP_PROP_CONVERT_RGB, 0])` gives the luma plane) bit
for bit, as the standard's decoding process is exact, and its RGB equals
`cv2.VideoCapture`'s BGR frames, converted as swscale converts them for the
stream's VUI (matrix_coefficients and video_full_range_flag; `csrc/
yuv_rgb.h`).

Ported: progressive 8-bit 4:2:0 streams of I, P and B slices in the
Constrained Baseline, Main and High profiles, with CAVLC or CABAC (the
tools are listed in `csrc/h264_decode.cpp`: the direct modes, implicit and
explicit bi-prediction weights among them). Frames come out in FFmpeg's
output order (picture order, delayed by the VUI's max_num_reorder_frames).
A stream that uses a tool beyond them raises UnsupportedVideo naming it:
interlaced coding, 4:0:0, 4:2:2, 4:4:4 and bit depths above 8, FMO and
ASO, redundant slices, SP and SI slices, data partitioning, transform
bypass, SVC and MVC NAL units, reordering deeper than
max_num_reorder_frames.

The library is built with the host C++ compiler at first use
(`ops/cuda_build.py::build_host_library`) and called through `ctypes`, which
releases the GIL during each call. A failed build raises.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, NamedTuple, Optional

import numpy as np

from metrabs_tpu_torch.data.mpeg4 import UnsupportedVideo
from metrabs_tpu_torch.ops import cuda_build

_ERR_LEN = 256
_LOCK = threading.Lock()
_LIB = None
_COUNT_LOCK = threading.Lock()
_FRAMES_DECODED = 0


def _library() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            path, _ = cuda_build.build_host_library('h264_decode')
            lib = ctypes.CDLL(str(path))
            vp, sz, i, cp = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_char_p
            ip = ctypes.POINTER(ctypes.c_int)
            lib.metrabs_h264_decoder_new.restype = vp
            lib.metrabs_h264_decoder_new.argtypes = []
            lib.metrabs_h264_decoder_free.argtypes = [vp]
            lib.metrabs_h264_decoder_free.restype = None
            lib.metrabs_h264_decoder_config.argtypes = [vp, cp, sz, cp, i]
            for name in ('decoder_recovering', 'decoder_headers_only', 'flush'):
                getattr(lib, f'metrabs_h264_{name}').argtypes = [vp]
                getattr(lib, f'metrabs_h264_{name}').restype = None
            lib.metrabs_h264_decode.argtypes = [vp, cp, sz, cp, i]
            lib.metrabs_h264_pictures.argtypes = [vp]
            lib.metrabs_h264_next.argtypes = [vp, ip, ip, ip]
            lib.metrabs_h264_frame.argtypes = [vp, vp, vp, vp, vp, cp, i]
            lib.metrabs_h264_packet_info.argtypes = [cp, sz, i, ip, ip, ip]
            for name in ('decoder_config', 'decode', 'pictures', 'next', 'frame', 'packet_info'):
                getattr(lib, f'metrabs_h264_{name}').restype = ctypes.c_int
            _LIB = lib
        return _LIB


def frames_decoded() -> int:
    """How many pictures every Decoder of this process has decoded."""
    return _FRAMES_DECODED


def _check(rc: int, err, name: str) -> None:
    if rc == 1:
        raise ValueError(f'{name}: corrupt H.264 stream ({err.value.decode()})')
    if rc == 2:
        raise UnsupportedVideo(
            f'{name}: the H.264 stream uses {err.value.decode()}, which the port does not '
            f'decode (progressive 8-bit 4:2:0 I, P and B slices only)')
    if rc != 0:
        raise RuntimeError(f'{name}: the H.264 decoder returned {rc}')


def length_size(config: bytes) -> int:
    """The NAL unit length size of an avcC; 0 without one (Annex B)."""
    return (config[4] & 3) + 1 if len(config) >= 7 and config[0] == 1 else 0


class EntryPoint(NamedTuple):
    """What a packet offers random access: an IDR picture, or a
    recovery-point SEI whose frames are exact from `recovery_frames` on."""
    idr: bool
    recovery_frames: int  # -1 without a recovery point
    exact: bool


def entry_point(packet: bytes, nal_length_size: int) -> EntryPoint:
    """The IDR slice and recovery-point SEI of a packet, read from its NAL
    unit headers and SEI payloads (no decoding)."""
    lib = _library()
    idr, rec, exact = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.metrabs_h264_packet_info(packet, len(packet), nal_length_size, ctypes.byref(idr),
                                      ctypes.byref(rec), ctypes.byref(exact))
    if rc:
        raise ValueError('corrupt H.264 packet (a NAL unit runs past it)')
    return EntryPoint(bool(idr.value), rec.value, bool(exact.value))


class Decoder:
    """Decodes the packets of one H.264 stream in order. `config` is the
    decoder configuration (MP4's avcC, Matroska's CodecPrivate; AVI's
    packets carry their parameter sets). `recovering`: decoding starts at a
    recovery point, whose references before it are taken as grey (its frames
    are exact from the recovery point's count on). `headers_only`: the
    decoder reads parameter sets and slice headers only, and `order` tells
    which pictures each packet outputs (`data.video` indexes a stream so).

    Pictures come out in output order, as FFmpeg's decoder hands them to
    cv2: a picture waits while reordering may still put a later one before
    it, so a packet outputs none, one or several, and `flush` outputs those
    still waiting at the end of the stream."""

    def __init__(self, config: bytes = b'', name: str = '<h264>', recovering: bool = False,
                 headers_only: bool = False):
        self._lib = _library()
        self._ptr = self._lib.metrabs_h264_decoder_new()
        self.name = name
        if recovering:
            self._lib.metrabs_h264_decoder_recovering(self._ptr)
        if headers_only:
            self._lib.metrabs_h264_decoder_headers_only(self._ptr)
        self._counted = not headers_only
        if config:
            err = ctypes.create_string_buffer(_ERR_LEN)
            _check(self._lib.metrabs_h264_decoder_config(self._ptr, config, len(config), err,
                                                         _ERR_LEN), err, name)

    def decode(self, packet: bytes, luma: bool = False, planes: bool = False) -> list:
        """The frames the packet outputs, in output order: each RGB uint8
        [H, W, 3]; with `luma` (RGB, Y [H, W]); with `planes` (RGB, (Y, U,
        V)), the chroma planes [(H + 1) // 2, (W + 1) // 2]."""
        self._send(packet)
        return self._take(luma, planes)

    def flush(self, luma: bool = False, planes: bool = False) -> list:
        """The frames still waiting at the end of the stream, as `decode`
        returns them."""
        self._lib.metrabs_h264_flush(self._ptr)
        return self._take(luma, planes)

    def order(self, packet: Optional[bytes]) -> List[int]:
        """The decoding-order indices of the pictures a packet (None: the
        end of the stream) outputs, without their samples."""
        if packet is None:
            self._lib.metrabs_h264_flush(self._ptr)
        else:
            self._send(packet)
        out = []
        w, h, index = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        while self._lib.metrabs_h264_next(self._ptr, ctypes.byref(w), ctypes.byref(h),
                                          ctypes.byref(index)):
            out.append(index.value)
            self._lib.metrabs_h264_frame(self._ptr, None, None, None, None, None, 0)
        return out

    @property
    def pictures(self) -> int:
        """How many pictures this decoder has decoded (or parsed)."""
        return self._lib.metrabs_h264_pictures(self._ptr)

    def _send(self, packet: bytes) -> None:
        global _FRAMES_DECODED
        err = ctypes.create_string_buffer(_ERR_LEN)
        before = self._lib.metrabs_h264_pictures(self._ptr)
        rc = self._lib.metrabs_h264_decode(self._ptr, packet, len(packet), err, _ERR_LEN)
        if self._counted:
            with _COUNT_LOCK:
                _FRAMES_DECODED += self._lib.metrabs_h264_pictures(self._ptr) - before
        _check(rc, err, self.name)

    def _take(self, luma: bool, planes: bool) -> list:
        out = []
        err = ctypes.create_string_buffer(_ERR_LEN)
        w, h, index = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        while self._lib.metrabs_h264_next(self._ptr, ctypes.byref(w), ctypes.byref(h),
                                          ctypes.byref(index)):
            hh, ww = h.value, w.value
            rgb = np.empty((hh, ww, 3), np.uint8)
            y = np.empty((hh, ww), np.uint8) if luma or planes else None
            u = v = None
            if planes:
                u = np.empty(((hh + 1) // 2, (ww + 1) // 2), np.uint8)
                v = np.empty_like(u)
            ptr = lambda a: None if a is None else a.ctypes.data  # noqa: E731
            rc = self._lib.metrabs_h264_frame(self._ptr, rgb.ctypes.data, ptr(y), ptr(u), ptr(v),
                                              err, _ERR_LEN)
            _check(rc, err, self.name)
            out.append((rgb, (y, u, v)) if planes else (rgb, y) if luma else rgb)
        return out

    def close(self) -> None:
        if self._ptr:
            self._lib.metrabs_h264_decoder_free(self._ptr)
            self._ptr = None

    def __del__(self):
        self.close()


def annexb(packet: bytes, config: bytes) -> bytes:
    """A length-prefixed packet (after the avcC `config`) as FFmpeg's
    h264_mp4toannexb filter gives it, which is what cv2 returns for
    CAP_PROP_FORMAT -1: a 4-byte start code before the first NAL unit and
    before parameter sets, 3 bytes before the others, and the avcC's SPS
    and PPS before an IDR picture that carries none."""
    size = length_size(config)
    if not size:
        return packet
    sets = b''.join(b'\x00\x00\x00\x01' + nal for nal in _avcc_sets(config))
    out, pos, first, seen = [], 0, True, False
    while pos + size <= len(packet):
        n = int.from_bytes(packet[pos:pos + size], 'big')
        nal = packet[pos + size:pos + size + n]
        pos += size + n
        kind = nal[0] & 31
        seen |= kind in (7, 8)
        if kind == 5 and not seen:
            out.append(sets)
            seen, first = True, False
        out.append((b'\x00\x00\x00\x01' if first or kind in (7, 8) else b'\x00\x00\x01') + nal)
        first = False
    return b''.join(out)


def _avcc_sets(config: bytes):
    pos, out = 5, []
    for kind in range(2):
        count = config[pos] & (31 if kind == 0 else 255)
        pos += 1
        for _ in range(count):
            n = int.from_bytes(config[pos:pos + 2], 'big')
            out.append(config[pos + 2:pos + 2 + n])
            pos += 2 + n
    return out
