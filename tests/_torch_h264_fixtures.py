"""Writes the H.264 fixtures of the port's video layer with libx264, and the
Xvid-stamped mp4v fixtures with libxvidcore, both through ctypes (cv2's
writer refuses H.264, and the card's machine has neither library:
`chip_smoke.py` holds the port's decoders to the recorded hashes there):

- `tests/torch_fixtures/h264/h264_<size>.mp4|.mkv|.avi`: 14 frames across a
  GOP of 12 (IDR pictures at 0 and 12, P slices between, no B slices) of
  shifted copies of the portrait JPEG fixture at 96x66 (coded as 96x80 and
  cropped), 320x568 and 1080x1920, x264's `medium` preset at its default
  rate, in the three containers written by the port's muxers (MP4 `avc1`
  with the avcC, Matroska `V_MPEG4/ISO/AVC`, AVI `H264` in Annex B);
- `h264_tool_<tool>.mp4`: 96x66 clips with one of x264's options that
  switches a coding tool on or off (CAVLC, no 8x8 transform, no deblocking,
  partitions none or all, 1 or 4 references, weighted prediction off or
  smart, 4 slices, intra refresh with recovery-point SEIs, the JVT scaling
  matrices, constrained intra prediction, deblocking offsets, the Baseline
  and Main profiles) and `h264_vui_<vui>.mp4` with the VUI's full-range
  flag and colour matrix (BT.601, BT.709, unspecified);
- `tests/torch_fixtures/mp4v/xvid_<size>.avi|.mkv`: libxvidcore's Simple
  Profile (half-pel, no B-VOPs, quarter-pel, GMC or interlacing) at a fixed
  quantiser, stamped `XviD<build>` in its user data;
- `manifest.json` beside each: per file cv2's frame count, rate, size and
  frames read, and per frame the SHA-256 of FFmpeg's luma plane
  (`cv2.CAP_PROP_CONVERT_RGB` 0), of `cv2.VideoCapture`'s frame as RGB, of
  the packet as cv2 returns it (`cv2.CAP_PROP_FORMAT` -1) with its key
  flag, and for H.264 of x264's reconstruction (Y, U, V: cv2 gives no
  chroma plane). For a stream whose VUI names the BT.709 matrix, cv2's raw
  output is not the luma plane (it converts it): `luma_from` is then
  'x264' and the luma hashes are the reconstruction's;
- `tests/torch_fixtures/h264_b/h264b_*`: B-frame clips (`write_b_fixtures`:
  x264's medium B-frame defaults at three sizes, one option each, three
  streams edited after x264 wrote them), the MP4s with the ctts and elst
  FFmpeg's mov muxer writes, the Matroska blocks with presentation
  timestamps, and a manifest of cv2's frames in output order, its seek for
  every N (JAX's `imread`, read twice), x264's pts/dts and its
  reconstruction, which equals FFmpeg's only for the pictures x264
  deblocks (not the non-reference B ones).

    python tests/_torch_h264_fixtures.py      # all
    python tests/_torch_h264_fixtures.py b    # the B-frame clips only
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import sys
from pathlib import Path
from typing import Optional

import numpy as np

from _torch_mp4v_fixtures import MP4V_DIR, XVID_CASES, cv2_read, sha256, shifted_frames

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:  # run as a script: the port's muxers write the containers
    sys.path.insert(0, str(ROOT))
H264_DIR = ROOT / 'tests' / 'torch_fixtures' / 'h264'
GOP = 12
FRAMES = 14
CONTAINERS = ('.mp4', '.mkv', '.avi')
BASE = {'bframes': 0, 'threads': 1, 'lookahead-threads': 1, 'keyint': GOP, 'min-keyint': GOP,
        'scenecut': 0}

# (stem, fps, (width, height) or None for the fixture's size, x264 options)
SIZES = [
    ('h264_96x66', 10.0, (96, 66), {}),
    ('h264_320x568', 30000 / 1001, (320, 568), {}),
    ('h264_1080x1920', 25.0, None, {}),
]
TOOLS = {
    'cavlc': {'cabac': 0},
    'no_8x8dct': {'no-8x8dct': 1},
    'no_deblock': {'no-deblock': 1},
    'partitions_none': {'partitions': 'none'},
    'partitions_all': {'partitions': 'all'},
    'ref1': {'ref': 1},
    'ref4': {'ref': 4, 'mixed-refs': 1},
    'weightp0': {'weightp': 0},
    'weightp2': {'weightp': 2},
    'slices4': {'slices': 4},
    'intra_refresh': {'intra-refresh': 1, 'keyint': 6, 'min-keyint': 6},
    'cqm_jvt': {'cqm': 'jvt'},
    'constrained_intra': {'constrained-intra': 1},
    'deblock_offsets': {'deblock': '-3:2'},
    'baseline': {'profile': 'baseline'},
    'main': {'profile': 'main'},
}
VUIS = {
    'fullrange': {'fullrange': 'on'},
    'bt709': {'colormatrix': 'bt709'},
    'bt601': {'colormatrix': 'smpte170m'},
    'unspecified': {'colormatrix': 'undef'},
    'bt709_fullrange': {'colormatrix': 'bt709', 'fullrange': 'on'},
}
TOOL_SIZE = (96, 66)
CASES = ([(stem + ext, fps, size, opts) for stem, fps, size, opts in SIZES for ext in CONTAINERS]
         + [(f'h264_tool_{t}.mp4', 25.0, TOOL_SIZE, o) for t, o in TOOLS.items()]
         + [(f'h264_vui_{v}.mp4', 25.0, TOOL_SIZE, o) for v, o in VUIS.items()])


# --------------------------------------------------------------------------
# libx264 through ctypes (x264.h, API build 164)

class _Nal(ctypes.Structure):
    _fields_ = [('i_ref_idc', ctypes.c_int), ('i_type', ctypes.c_int),
                ('b_long_startcode', ctypes.c_int), ('i_first_mb', ctypes.c_int),
                ('i_last_mb', ctypes.c_int), ('i_payload', ctypes.c_int),
                ('p_payload', ctypes.POINTER(ctypes.c_uint8)), ('i_padding', ctypes.c_int)]


# Colour spaces of x264_image_t (x264.h) by chroma format.
X264_CSP = {'i400': 0x0001, 'i420': 0x0002, 'i422': 0x0006, 'i444': 0x000c}
X264_CSP_HIGH_DEPTH = 0x2000
# Offsets in x264_param_t (i_width, i_height, i_csp, i_bitdepth) and
# x264_picture_t (x264.h of build 164).
PARAM_WIDTH = 28
PIC_PTS, PIC_KEYFRAME, PIC_IMG = 16, 12, 40  # i_dts follows i_pts


def _input_planes(frame: np.ndarray, csp: str, depth: int):
    """The planes of an RGB frame in x264's input layout: cv2's I420, the
    chroma repeated for 4:2:2 and 4:4:4, samples of 16 bits above depth 8."""
    import cv2
    h, w = frame.shape[:2]
    flat = cv2.cvtColor(np.ascontiguousarray(frame[..., ::-1]), cv2.COLOR_BGR2YUV_I420).reshape(-1)
    q = (h // 2) * (w // 2)
    y = flat[:h * w].reshape(h, w)
    u, v = flat[h * w:h * w + q].reshape(h // 2, w // 2), flat[h * w + q:].reshape(h // 2, w // 2)
    chroma = {'i400': [], 'i420': [u, v], 'i422': [np.repeat(c, 2, 0) for c in (u, v)],
              'i444': [np.repeat(np.repeat(c, 2, 0), 2, 1) for c in (u, v)]}[csp]
    planes = [y] + chroma
    if depth > 8:
        planes = [p.astype(np.uint16) << (depth - 8) for p in planes]
    return [np.ascontiguousarray(p) for p in planes]


def x264_encode(frames, options: dict, fps: float, csp: str = 'i420', depth: int = 8,
                times: Optional[list] = None):
    """Annex B packets (one access unit per frame, SPS and PPS before each
    IDR, in decoding order), their key flags and x264's reconstruction (y,
    u, v) of each (4:2:0 at 8 bits; None otherwise). `times`, if given,
    receives each packet's (pts, dts) in frames."""
    lib = ctypes.CDLL('libx264.so.164')
    vp = ctypes.c_void_p
    lib.x264_param_default_preset.argtypes = [vp, ctypes.c_char_p, ctypes.c_char_p]
    lib.x264_param_parse.argtypes = [vp, ctypes.c_char_p, ctypes.c_char_p]
    lib.x264_param_apply_profile.argtypes = [vp, ctypes.c_char_p]
    lib.x264_encoder_open_164.argtypes = [vp]
    lib.x264_encoder_open_164.restype = vp
    lib.x264_encoder_encode.argtypes = [vp, vp, vp, vp, vp]
    lib.x264_encoder_delayed_frames.argtypes = [vp]
    lib.x264_encoder_close.argtypes = [vp]
    lib.x264_picture_init.argtypes = [vp]
    h, w = frames[0].shape[:2]
    options = dict(BASE, **options)
    profile = options.pop('profile', None)
    param = ctypes.create_string_buffer(8192)
    assert lib.x264_param_default_preset(param, b'medium', None) == 0
    num, den = (fps, 1) if float(fps).is_integer() else (30000, 1001)
    options['fps'] = f'{int(num)}/{int(den)}'
    for key, value in options.items():
        assert lib.x264_param_parse(param, key.encode(), str(value).encode()) == 0, (key, value)
    ctypes.memmove(ctypes.addressof(param) + PARAM_WIDTH,
                   np.array([w, h, X264_CSP[csp], depth], np.int32).tobytes(), 16)
    if profile:
        assert lib.x264_param_apply_profile(param, profile.encode()) == 0, profile
    enc = lib.x264_encoder_open_164(param)
    assert enc, options
    pic, out = ctypes.create_string_buffer(1024), ctypes.create_string_buffer(1024)
    lib.x264_picture_init(pic)
    nals, n_nal = ctypes.POINTER(_Nal)(), ctypes.c_int()
    packets, keys, recon = [], [], []

    def collect(size):
        if size <= 0:
            return
        packets.append(b''.join(ctypes.string_at(nals[i].p_payload, nals[i].i_payload)
                                for i in range(n_nal.value)))
        keys.append(bool(np.frombuffer(out.raw[PIC_KEYFRAME:PIC_KEYFRAME + 4], np.int32)[0]))
        if times is not None:
            times.append(tuple(int(t) for t in np.frombuffer(out.raw[PIC_PTS:PIC_PTS + 16],
                                                              np.int64)))
        if csp != 'i420' or depth != 8:
            recon.append(None)
            return
        strides = np.frombuffer(out.raw[PIC_IMG + 8:PIC_IMG + 24], np.int32)
        planes = np.frombuffer(out.raw[PIC_IMG + 24:PIC_IMG + 56], np.uint64)
        as_array = lambda p, shape: np.ctypeslib.as_array(  # noqa: E731
            ctypes.cast(int(p), ctypes.POINTER(ctypes.c_uint8)), shape)
        y = as_array(planes[0], (h, strides[0]))[:, :w].copy()
        uv = as_array(planes[1], ((h + 1) // 2, strides[1]))[:, :2 * ((w + 1) // 2)].copy()
        recon.append((y, uv[:, 0::2].copy(), uv[:, 1::2].copy()))  # NV12

    for k, frame in enumerate(frames):
        planes = _input_planes(frame, csp, depth)
        image_csp = X264_CSP[csp] | (X264_CSP_HIGH_DEPTH if depth > 8 else 0)
        strides = [p.strides[0] for p in planes] + [0] * (4 - len(planes))
        pointers = [p.ctypes.data for p in planes] + [0] * (4 - len(planes))
        ctypes.memmove(ctypes.addressof(pic) + PIC_IMG,
                       np.array([image_csp, len(planes)] + strides, np.int32).tobytes(), 24)
        ctypes.memmove(ctypes.addressof(pic) + PIC_IMG + 24,
                       np.array(pointers, np.uint64).tobytes(), 32)
        ctypes.memmove(ctypes.addressof(pic) + PIC_PTS, np.array([k], np.int64).tobytes(), 8)
        collect(lib.x264_encoder_encode(enc, ctypes.byref(nals), ctypes.byref(n_nal), pic, out))
    while lib.x264_encoder_delayed_frames(enc):
        collect(lib.x264_encoder_encode(enc, ctypes.byref(nals), ctypes.byref(n_nal), None, out))
    lib.x264_encoder_close(enc)
    return packets, keys, recon


# --------------------------------------------------------------------------
# libxvidcore through ctypes (xvid.h, API 4)

XVID_VERSION = (1 << 16) | (3 << 8)
XVID_VOP_HALFPEL = 1 << 1
XVID_VOP_INTER4V = 1 << 2
XVID_VOP_TOPFIELDFIRST = 1 << 9
XVID_VOP_ALTERNATESCAN = 1 << 10
XVID_GLOBAL_PACKED = 1 << 0
XVID_GLOBAL_CLOSED_GOP = 1 << 1
XVID_VOL_MPEGQUANT = 1 << 0
XVID_VOL_QUARTERPEL = 1 << 2
XVID_VOL_GMC = 1 << 3
XVID_VOL_REDUCED_ENABLE = 1 << 4
XVID_VOL_INTERLACING = 1 << 5
XVID_ME_HALFPELREFINE16 = 1 << 4
XVID_ME_HALFPELREFINE8 = 1 << 6
XVID_ME_QUARTERPELREFINE16 = 1 << 7
XVID_ME_QUARTERPELREFINE8 = 1 << 8
XVID_ME_GME_REFINE = 1 << 9
XVID_ME_EXTSEARCH16 = 1 << 10
XVID_CSP_PLANAR = 1 << 0
XVID_CSP_NULL = 1 << 14
XVID_KEYFRAME = 1 << 1


class _XvidGblInit(ctypes.Structure):
    _fields_ = [('version', ctypes.c_int), ('cpu_flags', ctypes.c_uint), ('debug', ctypes.c_int)]


class _XvidEncCreate(ctypes.Structure):
    _fields_ = [('version', ctypes.c_int), ('profile', ctypes.c_int), ('width', ctypes.c_int),
                ('height', ctypes.c_int), ('num_zones', ctypes.c_int), ('zones', ctypes.c_void_p),
                ('num_plugins', ctypes.c_int), ('plugins', ctypes.c_void_p),
                ('num_threads', ctypes.c_int), ('max_bframes', ctypes.c_int),
                ('global_flags', ctypes.c_int), ('fincr', ctypes.c_int), ('fbase', ctypes.c_int),
                ('max_key_interval', ctypes.c_int), ('frame_drop_ratio', ctypes.c_int),
                ('bquant_ratio', ctypes.c_int), ('bquant_offset', ctypes.c_int),
                ('min_quant', ctypes.c_int * 3), ('max_quant', ctypes.c_int * 3),
                ('handle', ctypes.c_void_p), ('start_frame_num', ctypes.c_int),
                ('num_slices', ctypes.c_int)]


class _XvidImage(ctypes.Structure):
    _fields_ = [('csp', ctypes.c_int), ('plane', ctypes.c_void_p * 4),
                ('stride', ctypes.c_int * 4)]


class _XvidEncFrame(ctypes.Structure):
    _fields_ = [('version', ctypes.c_int), ('vol_flags', ctypes.c_int),
                ('quant_intra_matrix', ctypes.c_void_p), ('quant_inter_matrix', ctypes.c_void_p),
                ('par', ctypes.c_int), ('par_width', ctypes.c_int), ('par_height', ctypes.c_int),
                ('fincr', ctypes.c_int), ('vop_flags', ctypes.c_int), ('motion', ctypes.c_int),
                ('input', _XvidImage), ('type', ctypes.c_int), ('quant', ctypes.c_int),
                ('bframe_threshold', ctypes.c_int), ('bitstream', ctypes.c_void_p),
                ('length', ctypes.c_int), ('out_flags', ctypes.c_int)]


def xvid_encode(frames, fps: float, quant: int, max_bframes: int = 0, global_flags: int = 0,
                vol_flags: int = 0, vop_flags: int = XVID_VOP_HALFPEL, motion: int = 0,
                quant_intra_matrix=None, quant_inter_matrix=None, gop: int = GOP):
    """Packets (the first with the VOL and the XviD user data) and key
    flags, in coding order: an I-VOP every `gop` frames. The defaults are
    Simple Profile tools; `max_bframes` (B-VOPs), `global_flags`
    (XVID_GLOBAL_*: packed bitstream, closed GOP), `vol_flags`
    (XVID_VOL_*: MPEG quantisation, quarter-pel, GMC, interlacing),
    `vop_flags` (XVID_VOP_*), `motion` (XVID_ME_*) and the two 64-entry
    matrices (natural order) switch on Advanced Simple tools. With B-VOPs
    the encoder holds frames back: the flush at the end (an input of
    XVID_CSP_NULL) writes those left."""
    import cv2
    lib = ctypes.CDLL('libxvidcore.so.4')
    lib.xvid_global.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.xvid_encore.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    assert lib.xvid_global(None, 0, ctypes.byref(_XvidGblInit(XVID_VERSION, 0, 0)), None) == 0
    h, w = frames[0].shape[:2]
    create = _XvidEncCreate(version=XVID_VERSION, width=w, height=h, max_key_interval=gop,
                            max_bframes=max_bframes, global_flags=global_flags,
                            bquant_ratio=150, bquant_offset=100)
    create.fincr, create.fbase = (1, int(fps)) if float(fps).is_integer() else (1001, 30000)
    assert lib.xvid_encore(None, 0, ctypes.byref(create), None) == 0, (w, h)
    buf = ctypes.create_string_buffer(w * h * 4 + 4096)
    matrices = [None if m is None else (ctypes.c_ubyte * 64)(*m)
                for m in (quant_intra_matrix, quant_inter_matrix)]
    packets, keys = [], []
    for k in range(len(frames) + max_bframes + 2):
        fr = _XvidEncFrame(version=XVID_VERSION, vol_flags=vol_flags, vop_flags=vop_flags,
                           motion=motion, quant=quant)
        for name, m in zip(('quant_intra_matrix', 'quant_inter_matrix'), matrices):
            if m is not None:
                setattr(fr, name, ctypes.cast(m, ctypes.c_void_p))
        if k < len(frames):
            flat = cv2.cvtColor(np.ascontiguousarray(frames[k][..., ::-1]),
                                cv2.COLOR_BGR2YUV_I420).reshape(-1)
            q = (h // 2) * (w // 2)
            planes = [np.ascontiguousarray(flat[:h * w]),
                      np.ascontiguousarray(flat[h * w:h * w + q]),
                      np.ascontiguousarray(flat[h * w + q:h * w + 2 * q])]
            fr.input.csp = XVID_CSP_PLANAR
            for i, (p, stride) in enumerate(zip(planes, (w, w // 2, w // 2))):
                fr.input.plane[i] = p.ctypes.data
                fr.input.stride[i] = stride
        else:
            fr.input.csp = XVID_CSP_NULL
        fr.bitstream = ctypes.cast(buf, ctypes.c_void_p)
        fr.length = len(buf)
        n = lib.xvid_encore(create.handle, 2, ctypes.byref(fr), None)
        if n > 0:
            packets.append(buf.raw[:n])
            keys.append(bool(fr.out_flags & XVID_KEYFRAME))
        elif k >= len(frames):
            break
    lib.xvid_encore(create.handle, 1, None, None)
    return packets, keys


# --------------------------------------------------------------------------
# H.264 packets for the containers: Annex B as x264 writes them (AVI), or
# length-prefixed after an avcC (Matroska, MP4).

def avcc(sps: bytes, pps: bytes) -> bytes:
    """An avcC (ISO/IEC 14496-15 AVCDecoderConfigurationRecord) of one SPS
    and one PPS (NAL units without start codes), 4-byte NAL lengths."""
    return (bytes([1, sps[1], sps[2], sps[3], 0xFF, 0xE1]) + len(sps).to_bytes(2, 'big') + sps
            + bytes([1]) + len(pps).to_bytes(2, 'big') + pps)


def annexb_to_lengths(data: bytes, size: int = 4) -> bytes:
    """Annex B NAL units (start codes) as length-prefixed ones."""
    out = []
    for nal in split_annexb(data):
        out.append(len(nal).to_bytes(size, 'big') + nal)
    return b''.join(out)


def split_annexb(data: bytes):
    """The NAL units of Annex B data, without their start codes."""
    starts = []
    i = data.find(b'\x00\x00\x01')
    while i >= 0:
        starts.append(i + 3)
        i = data.find(b'\x00\x00\x01', i + 3)
    for k, s in enumerate(starts):
        end = starts[k + 1] - 3 if k + 1 < len(starts) else len(data)
        nal = data[s:end].rstrip(b'\x00')
        if nal:
            yield nal


def parameter_sets(data: bytes) -> Optional[bytes]:
    """An avcC of the first SPS and PPS in Annex B data (None without
    them)."""
    sps = pps = None
    for nal in split_annexb(data):
        if nal[0] & 31 == 7 and sps is None:
            sps = nal
        elif nal[0] & 31 == 8 and pps is None:
            pps = nal
    return avcc(sps, pps) if sps and pps else None


def write_container(path: Path, packets, keys, size, fps: float, codec: str,
                    times=None) -> None:
    """Annex B H.264 packets (codec 'h264'), HEVC packets ('hevc': MP4
    `hvc1` and Matroska without the parameter sets in band, AVI `HEVC` with
    them; 'hev1': an MP4 `hev1` track that keeps them) or mp4v packets
    ('xvid') into the container the extension names, through the port's
    muxers. `times`
    (x264's (pts, dts) per packet, in frames) marks a stream whose frames
    are reordered: Matroska's block timestamps are then the presentation
    times, and the MP4 gets the time base, `ctts` and `elst` that FFmpeg's
    mov muxer writes for it."""
    from metrabs_tpu_torch.data import mp4, mpeg4, video
    w, h = size
    ext = path.suffix
    with open(path, 'wb') as f:
        if codec in ('hevc', 'hev1'):
            from _torch_hevc_fixtures import hevc_container_args
            mux, data = hevc_container_args(f, ext, packets, size, fps, codec, times)
        elif codec == 'h264':
            config = parameter_sets(packets[0])
            lp = [annexb_to_lengths(p) for p in packets]
            if ext == '.avi':
                mux = video._AviMuxer(f, w, h, fps, b'H264')
                data = packets
            elif ext == '.mkv':
                mux = video._MatroskaMuxer(f, w, h, fps, b'V_MPEG4/ISO/AVC', config)
                if times is not None:
                    mux._timestamp = lambda i: int(round(times[i][0] * 1000 / fps))
                data = lp
            elif times is not None:
                res, inc = mov_time_base(fps)
                mux = mp4.Mp4Muxer(f, w, h, res, inc, config, codec='avc1')
                plain = mux._moov
                mux._moov = lambda: moov_with_timing(plain(), *mov_timing_boxes(times, inc, res))
                data = lp
            else:
                res, inc = mpeg4.time_base(fps)
                mux = mp4.Mp4Muxer(f, w, h, res, inc, config, codec='avc1')
                data = lp
        else:
            vol = packets[0][:packets[0].index(b'\x00\x00\x01\xb6')]
            if ext == '.avi':
                mux = video._AviMuxer(f, w, h, fps, b'XVID')
            else:
                mux = video._MatroskaMuxer(f, w, h, fps, b'V_MPEG4/ISO/ASP', vol)
            data = packets
        for packet, key in zip(data, keys):
            mux.write(packet, key)
        mux.close()


def mov_time_base(fps: float):
    """(timescale, delta) of FFmpeg's mov muxer for a video stream whose
    time base is 1/fps: the denominator doubled up to 10000 or more."""
    from metrabs_tpu_torch.data import mpeg4
    res, inc = mpeg4.time_base(fps)
    while res < 10000:
        res, inc = 2 * res, 2 * inc
    return res, inc


def insert_box(moov: bytes, path, box: bytes, after: bytes) -> bytes:
    """moov with `box` put into the box at `path` (a tuple of types below
    moov), after its child `after`, each enclosing box's size grown."""
    import struct

    def walk(data: bytes, path) -> bytes:
        out, pos = [], 8
        out.append(data[:8])
        while pos < len(data):
            size, kind = struct.unpack('>I4s', data[pos:pos + 8])
            child = data[pos:pos + size]
            if path and kind == path[0]:
                child = walk(child, path[1:])
            out.append(child)
            if not path and kind == after:
                out.append(box)
            pos += size
        body = b''.join(out)
        return struct.pack('>I', len(body)) + body[4:]

    return walk(moov, path)


def mov_timing_boxes(times, delta: int, timescale: int, version: Optional[int] = None):
    """The boxes FFmpeg's mov muxer adds for a stream whose pts and dts
    differ (`times`: (pts, dts) per packet, in frames of `delta` ticks):
    `ctts` (pts - dts per sample, in runs; version 1 if an offset is
    negative) and `edts` with an `elst` whose media_time skips the dts
    before the first pts (an empty edit first if the presentation starts
    late)."""
    import struct
    from metrabs_tpu_torch.data import mp4
    offsets = [(p - d) * delta for p, d in times]
    runs = []
    for o in offsets:
        if runs and runs[-1][1] == o:
            runs[-1][0] += 1
        else:
            runs.append([1, o])
    if version is None:
        version = int(min(offsets) < 0)
    ctts = mp4._full_box(b'ctts', version, 0, struct.pack('>I', len(runs)) + b''.join(
        struct.pack('>Ii', c, o) for c, o in runs))
    start_dts = times[0][1] * delta
    start_ct = offsets[0]
    delay = (start_dts + start_ct) * 1000 // timescale
    duration = -(-len(times) * delta * 1000 // timescale)
    entries = []
    if delay > 0:
        entries.append(struct.pack('>Iii', delay, -1, 0x10000))
        media_time = start_ct
    else:
        media_time = -min(start_dts, 0)
        duration += delay
    entries.append(struct.pack('>IiI', duration, media_time, 0x10000))
    elst = mp4._full_box(b'elst', 0, 0, struct.pack('>I', len(entries)) + b''.join(entries))
    return ctts, mp4._box(b'edts', elst)


def moov_with_timing(moov: bytes, ctts: bytes, edts: Optional[bytes]) -> bytes:
    """The port's moov with a ctts after its stss and an edts after its tkhd."""
    moov = insert_box(moov, (b'trak', b'mdia', b'minf', b'stbl'), ctts, b'stss')
    return insert_box(moov, (b'trak',), edts, b'tkhd') if edts else moov


def cv2_packets_and_keys(path: str):
    import cv2
    cap = cv2.VideoCapture(str(path), cv2.CAP_FFMPEG, [cv2.CAP_PROP_FORMAT, -1])
    packets, keys = [], []
    while True:
        ok, data = cap.read()
        if not ok:
            break
        packets.append(data.tobytes())
        keys.append(bool(cap.get(cv2.CAP_PROP_LRF_HAS_KEY_FRAME)))
    cap.release()
    return packets, keys


def cv2_entry(path: Path, written: dict, recon=None) -> dict:
    bgr, meta = cv2_read(path)
    lumas, _ = cv2_read(path, _raw_params())
    packets, keys = cv2_packets_and_keys(str(path))
    entry = dict(written=written, cv2=dict(meta, frames_read=len(bgr)),
                 rgb_sha256=[sha256(f[..., ::-1]) for f in bgr],
                 packet_sha256=[sha256(p) for p in packets], key_frames=keys,
                 file_sha256=hashlib.sha256(path.read_bytes()).hexdigest())
    luma = [sha256(y) for y in lumas]
    entry['luma_from'] = 'cv2'
    if recon is not None:
        entry['recon_sha256'] = [[sha256(p) for p in planes] for planes in recon]
        recon_luma = [sha256(planes[0]) for planes in recon]
        if luma != recon_luma:  # cv2 converts the plane (BT.709): the reconstruction's
            luma, entry['luma_from'] = recon_luma, 'x264'
    entry['luma_sha256'] = luma
    return entry


def _raw_params():
    import cv2
    return [cv2.CAP_PROP_CONVERT_RGB, 0]


def write_fixtures() -> None:
    H264_DIR.mkdir(parents=True, exist_ok=True)
    manifest = {}
    encoded = {}
    for name, fps, size, options in CASES:
        stem = name.rsplit('.', 1)[0]
        key = (stem, fps, size, tuple(sorted(options.items())))
        if key not in encoded:
            frames = shifted_frames(FRAMES, size)
            encoded[key] = (x264_encode(frames, options, fps), frames[0].shape[1::-1])
        (packets, keys, recon), wh = encoded[key]
        path = H264_DIR / name
        write_container(path, packets, keys, wh, fps, 'h264')
        manifest[name] = cv2_entry(path, dict(frames=FRAMES, fps=fps, width=wh[0], height=wh[1],
                                              x264=options, key_frames=keys), recon)
    (H264_DIR / 'manifest.json').write_text(json.dumps(manifest, indent=1) + '\n')

    mp4v_manifest = json.loads((MP4V_DIR / 'manifest.json').read_text())
    for name, fps, size, quant in XVID_CASES:
        frames = shifted_frames(FRAMES, size)
        packets, keys = xvid_encode(frames, fps, quant)
        path = MP4V_DIR / name
        wh = frames[0].shape[1::-1]
        write_container(path, packets, keys, wh, fps, 'xvid')
        mp4v_manifest[name] = cv2_entry(path, dict(frames=FRAMES, fps=fps, width=wh[0],
                                                   height=wh[1], xvid_quant=quant))
    (MP4V_DIR / 'manifest.json').write_text(json.dumps(mp4v_manifest, indent=1) + '\n')


# --------------------------------------------------------------------------
# B-frame clips (tests/torch_fixtures/h264_b): x264's `medium` B-frame
# defaults (bframes 3, b-pyramid normal, weightb, direct spatial, b-adapt 1)
# and one option each, and three streams edited from x264's.

H264_B_DIR = ROOT / 'tests' / 'torch_fixtures' / 'h264_b'
B_BASE = dict(BASE, bframes=3)
B_SIZES = [
    ('h264b_96x66', 10.0, (96, 66), CONTAINERS),
    ('h264b_320x568', 30000 / 1001, (320, 568), CONTAINERS),
    ('h264b_1080x1920', 25.0, None, ('.mp4',)),
]
B_TOOLS = {
    'direct_temporal': {'direct': 'temporal'},
    'direct_auto': {'direct': 'auto'},
    'weightb0': {'weightb': 0},
    'pyramid_none': {'b-pyramid': 'none'},
    'pyramid_strict': {'b-pyramid': 'strict'},
    'bframes1': {'bframes': 1},
    'bframes16': {'bframes': 16, 'b-adapt': 0, 'keyint': 24, 'min-keyint': 24},
    'badapt2': {'b-adapt': 2},
    'cavlc': {'cabac': 0},
    'partitions_all': {'partitions': 'all'},
    'ref1': {'ref': 1},
    'ref4': {'ref': 4, 'mixed-refs': 1},
    'slices4': {'slices': 4},
    'weightp2': {'weightp': 2},
    'no_deblock': {'no-deblock': 1},
    'open_gop': {'open-gop': 1},
}
# Streams edited after x264 wrote them (cv2 decodes them as the oracle):
# (x264 options, edit).
B_CRAFTED = {
    'weighted_bipred1': ({'cabac': 0}, 'weighted_bipred1'),
    'direct_8x8_inference0': ({'no-8x8dct': 1}, 'direct_8x8_inference0'),
    'no_bitstream_restriction': ({}, 'no_bitstream_restriction'),
}
B_FRAMES = 14
B_FRAMES_LONG = 20  # bframes16: room for a long run of B pictures
B_CASES = ([(stem + ext, fps, size, B_BASE, None) for stem, fps, size, exts in B_SIZES
            for ext in exts]
           + [(f'h264b_tool_{t}.mp4', 25.0, TOOL_SIZE, dict(B_BASE, **o), None)
              for t, o in B_TOOLS.items()]
           + [(f'h264b_crafted_{c}.mp4', 25.0, TOOL_SIZE, dict(B_BASE, **o), edit)
              for c, (o, edit) in B_CRAFTED.items()])
# The weights edited into the B slices of `weighted_bipred1` (denominators 5):
# list 0's first entry luma and chroma, list 1's first entry luma.
CRAFTED_WEIGHTS = {'denom': (5, 5), 'l0': ((37, -3), ((29, 2), (35, -1))), 'l1': ((27, 4), None)}


def moving_frames(n: int, size=None):
    """`shifted_frames` with a patch of the first frame, flipped, moving the
    other way: two motions for the B pictures to predict from both sides."""
    frames = shifted_frames(n, size)
    h, w = frames[0].shape[:2]
    ph, pw = h // 3, w // 3
    patch = np.ascontiguousarray(frames[0][:ph, :pw][::-1, ::-1])
    for k, frame in enumerate(frames):
        y, x = (h - ph) * (n - 1 - k) // max(n - 1, 1), (w - pw) * k // max(n - 1, 1)
        frame[y:y + ph, x:x + pw] = patch
    return frames


class BitReader:
    """Exp-Golomb and fixed-length reads over a string of RBSP bits."""

    def __init__(self, bits: str):
        self.bits, self.pos = bits, 0

    def u(self, n: int) -> int:
        v = int(self.bits[self.pos:self.pos + n] or '0', 2)
        self.pos += n
        return v

    def ue(self) -> int:
        zeros = 0
        while self.bits[self.pos] == '0':
            zeros += 1
            self.pos += 1
        self.pos += 1
        return (1 << zeros) - 1 + self.u(zeros)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) // 2 if k & 1 else -(k // 2)


def rbsp_bits(nal: bytes) -> str:
    """The RBSP of a NAL unit (emulation prevention removed, stop bit and
    trailing zeros dropped) as a string of bits."""
    rbsp, zeros = bytearray(), 0
    for b in nal[1:]:
        if zeros >= 2 and b == 3:
            zeros = 0
            continue
        rbsp.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return ''.join(f'{b:08b}' for b in rbsp).rstrip('0')[:-1]


def nal_from_bits(header: int, bits: str) -> bytes:
    """A NAL unit of an RBSP's bits: stop bit, alignment, emulation prevention."""
    bits += '1'
    bits += '0' * (-len(bits) % 8)
    raw = bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))
    out, zeros = bytearray([header]), 0
    for b in raw:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def ue_bits(v: int) -> str:
    b = bin(v + 1)[2:]
    return '0' * (len(b) - 1) + b


def se_bits(v: int) -> str:
    return ue_bits(2 * v - 1 if v > 0 else -2 * v)


def sps_fields(nal: bytes) -> dict:
    """What an SPS says, with the bit positions of the fields an edit
    changes (`at_*`)."""
    r = BitReader(rbsp_bits(nal))
    f = dict(profile=r.u(8))
    r.u(8)
    f['level'] = r.u(8)
    r.ue()
    if f['profile'] in (100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139, 134, 135):
        if r.ue() == 3:
            r.u(1)
        r.ue()
        r.ue()
        r.u(1)
        f['scaling'] = r.u(1)
        if f['scaling']:
            raise ValueError('SPS scaling matrices are not parsed here')
    f['log2_frame_num'] = r.ue() + 4
    f['poc_type'] = r.ue()
    if f['poc_type'] == 0:
        f['log2_poc'] = r.ue() + 4
    elif f['poc_type'] == 1:
        f['delta_always_zero'] = r.u(1)
        r.se()
        r.se()
        for _ in range(r.ue()):
            r.se()
    f['max_refs'] = r.ue()
    r.u(1)
    r.ue()
    r.ue()
    if not r.u(1):
        r.u(1)
    f['at_direct_8x8'] = r.pos
    f['direct_8x8_inference'] = r.u(1)
    if r.u(1):
        for _ in range(4):
            r.ue()
    f['bitstream_restriction'] = 0
    if r.u(1):  # VUI
        if r.u(1) and r.u(8) == 255:
            r.u(32)
        if r.u(1):
            r.u(1)
        if r.u(1):
            r.u(4)
            if r.u(1):
                r.u(24)
        if r.u(1):
            r.ue()
            r.ue()
        if r.u(1):
            r.u(65)
        hrd = [r.u(1)]

        def skip_hrd():
            count = r.ue() + 1
            r.u(8)
            for _ in range(count):
                r.ue()
                r.ue()
                r.u(1)
            r.u(20)
        if hrd[0]:
            skip_hrd()
        hrd.append(r.u(1))
        if hrd[1]:
            skip_hrd()
        if any(hrd):
            r.u(1)
        r.u(1)
        f['at_bitstream_restriction'] = r.pos
        f['bitstream_restriction'] = r.u(1)
        if f['bitstream_restriction']:
            r.u(1)
            for _ in range(4):
                r.ue()
            f['max_num_reorder_frames'] = r.ue()
    return f


def pps_fields(nal: bytes) -> dict:
    r = BitReader(rbsp_bits(nal))
    f = dict(id=r.ue())
    r.ue()
    f['cabac'] = r.u(1)
    f['bottom_field_pic_order'] = r.u(1)
    r.ue()
    f['num_ref_idx'] = (r.ue() + 1, r.ue() + 1)
    f['weighted_pred'] = r.u(1)
    f['at_weighted_bipred'] = r.pos
    f['weighted_bipred_idc'] = r.u(2)
    r.se()
    r.se()
    r.se()
    f['deblocking_control'] = r.u(1)
    f['constrained_intra'] = r.u(1)
    r.u(1)
    f['transform_8x8'] = r.u(1) if r.pos < len(r.bits) else 0
    return f


def slice_fields(nal: bytes, sps: dict, pps: dict) -> dict:
    """A slice header up to its reference list modifications (CAVLC or
    CABAC alike): slice type, POC fields, direct mode, active references
    and the bit position after the modifications (`at_weights`, where a
    pred_weight_table goes)."""
    r = BitReader(rbsp_bits(nal))
    f = dict(nal_ref_idc=nal[0] >> 5 & 3, idr=nal[0] & 31 == 5)
    f['first_mb'] = r.ue()
    f['type'] = r.ue() % 5
    r.ue()
    f['frame_num'] = r.u(sps['log2_frame_num'])
    if f['idr']:
        r.ue()
    if sps['poc_type'] == 0:
        f['poc_lsb'] = r.u(sps['log2_poc'])
        if pps['bottom_field_pic_order']:
            r.se()
    elif sps['poc_type'] == 1 and not sps['delta_always_zero']:
        r.se()
        if pps['bottom_field_pic_order']:
            r.se()
    if f['type'] == 1:
        f['direct_spatial'] = r.u(1)
    lists = {0: 1, 1: 2}.get(f['type'], 0)
    f['num_ref_idx'] = list(pps['num_ref_idx'][:lists])
    if lists and r.u(1):
        f['num_ref_idx'] = [r.ue() + 1 for _ in range(lists)]
    for _ in range(lists):
        if r.u(1):
            while r.ue() != 3:
                r.ue()
    f['at_weights'] = r.pos
    return f


def stream_nals(packets):
    """Per Annex B packet its NAL units, with the SPS and PPS in force."""
    sps = pps = None
    for packet in packets:
        nals = list(split_annexb(packet))
        for nal in nals:
            if nal[0] & 31 == 7:
                sps = sps_fields(nal)
            elif nal[0] & 31 == 8:
                pps = pps_fields(nal)
        yield nals, sps, pps


def _weight_table_bits(num_ref_idx) -> str:
    w = CRAFTED_WEIGHTS
    bits = ue_bits(w['denom'][0]) + ue_bits(w['denom'][1])
    for lst, n in zip(('l0', 'l1'), num_ref_idx):
        luma, chroma = w[lst]
        for i in range(n):
            if i == 0:
                bits += '1' + se_bits(luma[0]) + se_bits(luma[1])
                bits += ('1' + ''.join(se_bits(v) for c in chroma for v in c)) if chroma else '0'
            else:
                bits += '00'
    return bits


def craft(packets, edit: str):
    """x264's Annex B packets edited: `weighted_bipred1` sets the PPS's
    weighted_bipred_idc to 1 and gives every B slice a pred_weight_table
    (CAVLC, so the slice data after it needs no realignment);
    `direct_8x8_inference0` clears the SPS's direct_8x8_inference_flag (a
    stream without the 8x8 transform, whose B_8x8 parse the flag would
    change); `no_bitstream_restriction` drops the VUI's bitstream_restriction."""
    out = []
    for nals, sps, pps in stream_nals(packets):
        edited = []
        for nal in nals:
            kind = nal[0] & 31
            bits = None
            if kind == 7 and edit == 'direct_8x8_inference0':
                bits = rbsp_bits(nal)
                at = sps_fields(nal)['at_direct_8x8']
                bits = bits[:at] + '0' + bits[at + 1:]
            elif kind == 7 and edit == 'no_bitstream_restriction':
                bits = rbsp_bits(nal)
                bits = bits[:sps_fields(nal)['at_bitstream_restriction']] + '0'
            elif kind == 8 and edit == 'weighted_bipred1':
                bits = rbsp_bits(nal)
                at = pps_fields(nal)['at_weighted_bipred']
                bits = bits[:at] + '01' + bits[at + 2:]
            elif kind in (1, 5) and edit == 'weighted_bipred1':
                f = slice_fields(nal, sps, pps)
                if f['type'] == 1:
                    assert not pps['cabac']
                    bits = rbsp_bits(nal)
                    at = f['at_weights']
                    bits = bits[:at] + _weight_table_bits(f['num_ref_idx']) + bits[at:]
            edited.append(nal if bits is None else nal_from_bits(nal[0], bits))
        out.append(b''.join(b'\x00\x00\x00\x01' + nal for nal in edited))
    return out


def cv2_seeks(path: Path, rgb_sha256) -> list:
    """What JAX's `imread('<path>#frame=N')` (cv2.VideoCapture,
    CAP_PROP_POS_FRAMES, read) returns for every N up to two past the last
    frame: the index of the sequential frame it equals, -1 where it raises.
    Read twice: an answer that does not repeat raises here."""
    from metrabs_tpu.data import improc as jax_improc
    out = []
    for n in range(len(rgb_sha256) + 2):
        answers = []
        for _ in range(2):
            try:
                digest = sha256(jax_improc.imread(f'{path}#frame={n}'))
                answers.append(rgb_sha256.index(digest) if digest in rgb_sha256 else -2)
            except FileNotFoundError:
                answers.append(-1)
        if answers[0] != answers[1] or answers[0] == -2:
            raise RuntimeError(f'{path}: cv2 seeks to frame {n} give {answers}')
        out.append(answers[0])
    return out


def write_b_fixtures() -> None:
    H264_B_DIR.mkdir(parents=True, exist_ok=True)
    manifest, encoded = {}, {}
    for name, fps, size, options, edit in B_CASES:
        stem = name.rsplit('.', 1)[0]
        frames_n = B_FRAMES_LONG if 'bframes16' in name else B_FRAMES
        key = (stem, fps, size)
        if key not in encoded:
            frames = moving_frames(frames_n, size)
            times = []
            packets, keys, recon = x264_encode(frames, options, fps, times=times)
            if edit:
                packets, recon = craft(packets, edit), None
            encoded[key] = packets, keys, recon, times, frames[0].shape[1::-1]
        packets, keys, recon, times, wh = encoded[key]
        path = H264_B_DIR / name
        write_container(path, packets, keys, wh, fps, 'h264', times=times)
        entry = cv2_entry(path, dict(frames=frames_n, fps=fps, width=wh[0], height=wh[1],
                                     x264=options, edit=edit, key_frames=keys,
                                     times=times), None)
        if recon is not None:  # in output order; FFmpeg's oracle where they agree
            by_pts = [planes for _, planes in sorted(zip([t[0] for t in times], recon),
                                                      key=lambda x: x[0])]
            entry['recon_sha256'] = [[sha256(p) for p in planes] for planes in by_pts]
            entry['recon_equals_ffmpeg'] = [sha256(planes[0]) == luma for planes, luma in
                                            zip(by_pts, entry['luma_sha256'])]
        entry['seek'] = cv2_seeks(path, entry['rgb_sha256'])
        manifest[name] = entry
    (H264_B_DIR / 'manifest.json').write_text(json.dumps(manifest, indent=1) + '\n')


if __name__ == '__main__':
    if sys.argv[1:] != ['b']:  # `b`: the B-frame clips only
        write_fixtures()
    write_b_fixtures()
