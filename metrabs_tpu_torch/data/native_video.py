"""The ctypes side of the port's host video decoders (`data.h264`,
`data.hevc`): each library exports the same C interface under its own
prefix (`metrabs_h264_`, `metrabs_hevc_`; `csrc/video_codec.h` holds what
the two C++ decoders share), and `NativeDecoder` drives it.

A decoder takes the packets of one stream in decoding order and hands out
frames in output order, as FFmpeg's decoder hands them to cv2: a packet
outputs none, one or several, and `flush` outputs those still waiting at
the end of the stream. Each call releases the GIL. RGB frames are uint8 at
every bit depth, as cv2's; the planes are uint8 at 8 bits and uint16 above
(`<prefix>bit_depth` tells the next picture's).
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, NamedTuple, Optional

import numpy as np

from metrabs_tpu_torch.data.mpeg4 import UnsupportedVideo

_ERR_LEN = 256


class EntryPoint(NamedTuple):
    """What a packet offers random access: an IDR picture (HEVC: an IRAP
    picture, IDR, CRA or BLA), or an H.264 recovery-point SEI whose frames
    are exact from `recovery_frames` on."""
    idr: bool
    recovery_frames: int  # -1 without a recovery point
    exact: bool


def bind(lib: ctypes.CDLL, prefix: str) -> None:
    """Declares the C interface the decoders share, `<prefix>decoder_new`
    to `<prefix>frame`, on a loaded library."""
    vp, sz, i, cp = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_char_p
    ip = ctypes.POINTER(ctypes.c_int)
    for name, args, res in (('decoder_new', [], vp), ('decoder_free', [vp], None),
                            ('decoder_headers_only', [vp], None),
                            ('decoder_config', [vp, cp, sz, cp, i], i),
                            ('decode', [vp, cp, sz, cp, i], i), ('flush', [vp, cp, i], i),
                            ('pictures', [vp], i), ('next', [vp, ip, ip, ip], i),
                            ('bit_depth', [vp], i), ('frame', [vp, vp, vp, vp, vp, cp, i], i)):
        f = getattr(lib, prefix + name)
        f.argtypes, f.restype = args, res


class NativeDecoder:
    """Decodes the packets of one stream in order through a library bound by
    `bind`. `config` is the decoder configuration (MP4's avcC or hvcC,
    Matroska's CodecPrivate; AVI's packets carry their parameter sets).
    `headers_only`: the decoder reads parameter sets and slice headers only,
    and `order` tells which pictures each packet outputs (`data.video`
    indexes a stream so). Subclasses name the library's prefix, the codec
    and what the port decodes of it, for the errors, and count the pictures
    their decoders decode."""

    PREFIX = ''
    CODEC = ''
    SCOPE = ''
    _count_lock = threading.Lock()
    frames_decoded = 0  # per subclass: pictures every decoder of this process decoded

    def __init__(self, lib: ctypes.CDLL, config: bytes, name: str, headers_only: bool):
        self._lib = lib
        self._ptr = self._call('decoder_new')
        self.name = name
        if headers_only:
            self._call('decoder_headers_only', self._ptr)
        self._counted = not headers_only
        if config:
            err = ctypes.create_string_buffer(_ERR_LEN)
            self._check(self._call('decoder_config', self._ptr, config, len(config), err,
                                   _ERR_LEN), err)

    def _call(self, name: str, *args):
        return getattr(self._lib, self.PREFIX + name)(*args)

    def _check(self, rc: int, err) -> None:
        if rc == 1:
            raise ValueError(f'{self.name}: corrupt {self.CODEC} stream ({err.value.decode()})')
        if rc == 2:
            raise UnsupportedVideo(
                f'{self.name}: the {self.CODEC} stream uses {err.value.decode()}, which the port '
                f'does not decode ({self.SCOPE})')
        if rc != 0:
            raise RuntimeError(f'{self.name}: the {self.CODEC} decoder returned {rc}')

    def decode(self, packet: bytes, luma: bool = False, planes: bool = False) -> list:
        """The frames the packet outputs, in output order: each RGB uint8
        [H, W, 3]; with `luma` (RGB, Y [H, W]); with `planes` (RGB, (Y, U,
        V)), the chroma planes [(H + 1) // 2, (W + 1) // 2]; planes uint8 at
        8 bits, uint16 above."""
        self._send(packet)
        return self._take(luma, planes)

    def flush(self, luma: bool = False, planes: bool = False) -> list:
        """The frames still waiting at the end of the stream, as `decode`
        returns them."""
        self._send(None)
        return self._take(luma, planes)

    def order(self, packet: Optional[bytes]) -> List[int]:
        """The decoding-order indices of the pictures a packet (None: the
        end of the stream) outputs, without their samples."""
        self._send(packet)
        out = []
        w, h, index = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        while self._call('next', self._ptr, ctypes.byref(w), ctypes.byref(h), ctypes.byref(index)):
            out.append(index.value)
            self._call('frame', self._ptr, None, None, None, None, None, 0)
        return out

    @property
    def pictures(self) -> int:
        """How many pictures this decoder has decoded (or parsed)."""
        return self._call('pictures', self._ptr)

    def _send(self, packet: Optional[bytes]) -> None:
        err = ctypes.create_string_buffer(_ERR_LEN)
        before = self.pictures
        if packet is None:
            rc = self._call('flush', self._ptr, err, _ERR_LEN)
        else:
            rc = self._call('decode', self._ptr, packet, len(packet), err, _ERR_LEN)
        if self._counted:
            cls = type(self)
            with cls._count_lock:
                cls.frames_decoded += self.pictures - before
        self._check(rc, err)

    def _take(self, luma: bool, planes: bool) -> list:
        out = []
        err = ctypes.create_string_buffer(_ERR_LEN)
        w, h, index = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        while self._call('next', self._ptr, ctypes.byref(w), ctypes.byref(h), ctypes.byref(index)):
            hh, ww = h.value, w.value
            rgb = np.empty((hh, ww, 3), np.uint8)
            dtype = np.uint16 if self._call('bit_depth', self._ptr) > 8 else np.uint8
            y = np.empty((hh, ww), dtype) if luma or planes else None
            u = v = None
            if planes:
                u = np.empty(((hh + 1) // 2, (ww + 1) // 2), dtype)
                v = np.empty_like(u)
            ptr = lambda a: None if a is None else a.ctypes.data  # noqa: E731
            self._check(self._call('frame', self._ptr, rgb.ctypes.data, ptr(y), ptr(u), ptr(v),
                                   err, _ERR_LEN), err)
            out.append((rgb, (y, u, v)) if planes else (rgb, y) if luma else rgb)
        return out

    def close(self) -> None:
        if getattr(self, '_ptr', None):
            self._call('decoder_free', self._ptr)
            self._ptr = None

    def __del__(self):
        self.close()
