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
from typing import Optional, Tuple

from metrabs_tpu_torch.data.native_video import EntryPoint, NativeDecoder, bind
from metrabs_tpu_torch.ops import cuda_build

_LOCK = threading.Lock()
_LIB = None


def _library() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            path, _ = cuda_build.build_host_library('h264_decode')
            lib = ctypes.CDLL(str(path))
            bind(lib, 'metrabs_h264_')
            lib.metrabs_h264_decoder_recovering.argtypes = [ctypes.c_void_p]
            lib.metrabs_h264_decoder_recovering.restype = None
            lib.metrabs_h264_decoder_colour.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
            lib.metrabs_h264_decoder_colour.restype = None
            ip = ctypes.POINTER(ctypes.c_int)
            lib.metrabs_h264_packet_info.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                                     ctypes.c_int, ip, ip, ip]
            lib.metrabs_h264_packet_info.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def frames_decoded() -> int:
    """How many pictures every Decoder of this process has decoded."""
    return Decoder.frames_decoded


def length_size(config: bytes) -> int:
    """The NAL unit length size of an avcC; 0 without one (Annex B)."""
    return (config[4] & 3) + 1 if len(config) >= 7 and config[0] == 1 else 0


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


class Decoder(NativeDecoder):
    """Decodes the packets of one H.264 stream in order
    (`native_video.NativeDecoder`). `recovering`: decoding starts at a
    recovery point, whose references before it are taken as grey (its frames
    are exact from the recovery point's count on). Pictures wait while
    reordering may still put a later one before them. `colour`: the
    container's (matrix_coefficients, full range), which RGB follows where
    the VUI does not send them, as FFmpeg's decoder does."""

    PREFIX, CODEC = 'metrabs_h264_', 'H.264'
    SCOPE = 'progressive 8-bit 4:2:0 I, P and B slices only'
    frames_decoded = 0

    def __init__(self, config: bytes = b'', name: str = '<h264>', recovering: bool = False,
                 headers_only: bool = False, colour: Optional[Tuple[int, int]] = None):
        super().__init__(_library(), config, name, headers_only)
        if recovering:
            self._call('decoder_recovering', self._ptr)
        if colour is not None:
            self._call('decoder_colour', self._ptr, *colour)


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
