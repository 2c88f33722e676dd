"""HEVC / H.265 video on the host, through `csrc/hevc_decode.cpp`.

`Decoder` turns the packets of one stream (access units, length-prefixed
as MP4 and Matroska hold them, or Annex B as AVI holds them) into frames.
Its Y, U and V planes equal FFmpeg's bit for bit, as the standard's
decoding process is exact (at 8 bits `cv2.VideoCapture(path,
cv2.CAP_FFMPEG, [cv2.CAP_PROP_CONVERT_RGB, 0])` gives the luma plane; at 10
bits cv2 gives no plane, and libde265's and the stream's hash SEIs are the
oracles), and its RGB equals `cv2.VideoCapture`'s BGR frames, converted as
swscale converts them for the stream's VUI (matrix_coeffs and
video_full_range_flag; `csrc/yuv_rgb.h`, shared with `data.h264`).

Ported: progressive 4:2:0 Main and Main 10 streams (8-bit samples, and 9 or
10 bits in uint16 planes; luma and chroma of one depth) of I, P and B slices
(the tools are listed in `csrc/hevc_decode.cpp`: bi-prediction with the
default and explicit weights, combined bi-predictive merge candidates and
the temporal candidates of either list among them), with the
decoded-picture hash SEI checked on every picture that carries one
(`Decoder.hashes`). Frames come out in FFmpeg's output order (picture order
counts, delayed by sps_max_num_reorder_pics); the RASL pictures of a CRA
picture that starts decoding are skipped, as FFmpeg skips them. NAL units
of the unspecified types 48 to 63 (a Dolby Vision stream's RPU, 62, and
enhancement layer, 63) are skipped, as FFmpeg's decoder skips them for cv2.
A stream that uses a tool beyond them raises UnsupportedVideo naming it: bit
depths above 10, unequal luma and chroma bit depths, 4:0:0, 4:2:2 and
4:4:4, separate colour planes, field coding, tiles, dependent slice
segments, PCM coding units, long-term reference pictures, mvd_l1_zero_flag
(x265 never sets it), and the range, multilayer, 3D and screen content
extensions.

The library is built with the host C++ compiler at first use
(`ops/cuda_build.py::build_host_library`) and called through `ctypes`, which
releases the GIL during each call. A failed build raises.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Tuple

from metrabs_tpu_torch.data.native_video import EntryPoint, NativeDecoder, bind
from metrabs_tpu_torch.ops import cuda_build

_LOCK = threading.Lock()
_LIB = None
IRAP_TYPES = range(16, 24)  # nal_unit_type of BLA, IDR and CRA pictures
RASL_TYPES = (8, 9)  # RASL_N, RASL_R: skipped by a decoder that starts at their CRA


def _library() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            path, _ = cuda_build.build_host_library('hevc_decode')
            lib = ctypes.CDLL(str(path))
            bind(lib, 'metrabs_hevc_')
            ip = ctypes.POINTER(ctypes.c_int)
            lib.metrabs_hevc_hashes.argtypes = [ctypes.c_void_p, ip, ip]
            lib.metrabs_hevc_hashes.restype = None
            lib.metrabs_hevc_packet_info.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                                     ctypes.c_int, ip]
            lib.metrabs_hevc_packet_info.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def frames_decoded() -> int:
    """How many pictures every Decoder of this process has decoded."""
    return Decoder.frames_decoded


def length_size(config: bytes) -> int:
    """The NAL unit length size of an hvcC; 0 without one (Annex B)."""
    return (config[21] & 3) + 1 if len(config) >= 23 and config[0] == 1 else 0


def nal_unit_type(packet: bytes, nal_length_size: int) -> int:
    """The NAL unit type of a packet's first slice (-1 without one), read
    from its NAL unit headers."""
    kind = ctypes.c_int()
    rc = _library().metrabs_hevc_packet_info(packet, len(packet), nal_length_size,
                                             ctypes.byref(kind))
    if rc:
        raise ValueError('corrupt HEVC packet (a NAL unit runs past it)')
    return kind.value


def entry_point(packet: bytes, nal_length_size: int) -> EntryPoint:
    """Whether a packet's picture is an IRAP picture (IDR, CRA or BLA): a
    decoder may start there. A CRA picture's RASL pictures (`RASL_TYPES`,
    after it in decoding order, before it in output order) are then skipped,
    as FFmpeg skips them after a seek. (An HEVC stream gives no recovery
    points here.)"""
    return EntryPoint(nal_unit_type(packet, nal_length_size) in IRAP_TYPES, -1, False)


class Decoder(NativeDecoder):
    """Decodes the packets of one HEVC stream in order
    (`native_video.NativeDecoder`), checking the decoded-picture hash SEI of
    every picture that carries one (`hashes`)."""

    PREFIX, CODEC = 'metrabs_hevc_', 'HEVC'
    SCOPE = 'progressive 8- and 10-bit 4:2:0 I, P and B slices only'
    frames_decoded = 0

    def __init__(self, config: bytes = b'', name: str = '<hevc>', headers_only: bool = False):
        super().__init__(_library(), config, name, headers_only)

    @property
    def hashes(self) -> Tuple[Tuple[int, int, int], Tuple[int, int, int]]:
        """Per plane (Y, U, V): the decoded-picture hash SEI messages checked,
        and those that disagreed with the decoded picture."""
        checked, failed = (ctypes.c_int * 3)(), (ctypes.c_int * 3)()
        self._call('hashes', self._ptr, checked, failed)
        return tuple(checked), tuple(failed)


def annexb(packet: bytes, config: bytes) -> bytes:
    """A length-prefixed packet (after the hvcC `config`) as FFmpeg's
    hevc_mp4toannexb filter gives it, which is what cv2 returns for
    CAP_PROP_FORMAT -1: a 4-byte start code before every NAL unit, and the
    hvcC's parameter sets before the first IRAP slice of the packet."""
    size = length_size(config)
    if not size:
        return packet
    sets = b''.join(b'\x00\x00\x00\x01' + nal for nal in hvcc_nals(config))
    out, pos, got_irap = [], 0, False
    while pos + size <= len(packet):
        n = int.from_bytes(packet[pos:pos + size], 'big')
        nal = packet[pos + size:pos + size + n]
        pos += size + n
        irap = (nal[0] >> 1 & 63) in IRAP_TYPES
        if irap and not got_irap:
            out.append(sets)
        got_irap |= irap
        out.append(b'\x00\x00\x00\x01' + nal)
    return b''.join(out)


def hvcc_nals(config: bytes) -> List[bytes]:
    """The NAL units of an hvcC's arrays (VPS, SPS, PPS, SEI), in order."""
    pos, out = 23, []
    for _ in range(config[22]):
        count = int.from_bytes(config[pos + 1:pos + 3], 'big')
        pos += 3
        for _ in range(count):
            n = int.from_bytes(config[pos:pos + 2], 'big')
            out.append(config[pos + 2:pos + 2 + n])
            pos += 2 + n
    return out
