"""Writes the HEVC fixtures of the port's video layer with libx265 through
ctypes (cv2's FFmpeg writer opens no HEVC encoder that works everywhere,
and where libx265, libde265 and cv2 are missing, as on a GPU host,
`chip_smoke.py` holds the port's decoder to the recorded hashes):

- `tests/torch_fixtures/hevc/hevc_<size>.mp4|.mkv|.avi`: 14 frames across a
  GOP of 12 (an IDR picture at 0 and, x265's open GOP being its default, a
  CRA picture at 12, P slices between, no B slices) of
  shifted copies of the portrait JPEG fixture at 96x66 (coded as 96x72 and
  cropped by the conformance window) and 320x568, x265's `medium` preset at
  its default rate, in the three containers written by the port's muxers
  (MP4 `hvc1` with the hvcC and no parameter sets in band, Matroska
  `V_MPEGH/ISO/HEVC` likewise, AVI `HEVC` in Annex B with the parameter
  sets before each key frame), `hevc_96x66_hev1.mp4` (`hev1`: the
  parameter sets in band as well) and `hevc_1080x1920.mp4`;
- `hevc_tool_<tool>.mp4`: 96x66 clips with one of x265's options that
  switches a coding tool on or off (CTU and TU sizes, AMP and rectangular
  partitions, transform skip, lossless coding, scaling lists, sign hiding,
  SAO, deblocking, TMVP, merge candidates, references, slices, WPP,
  constrained intra prediction, strong intra smoothing, quantisation
  groups with chroma offsets, weighted prediction, open GOPs with CRA
  pictures, the VUI's range and matrix, the decoded-picture hash SEI);
  `hevc_1080x1920.mp4` and the MP4 and Matroska clips at 96x66 carry MD5
  hash SEIs as well;
- `manifest.json`: per file x265's options, cv2's frame count, rate, size
  and frames read, its seek for every N (JAX's `imread`, read twice), and
  per frame the SHA-256 of the packet as cv2 returns it (`CAP_PROP_FORMAT`
  -1) with its key flag, of FFmpeg's luma plane (`cv2.CAP_PROP_CONVERT_RGB`
  0), of `cv2.VideoCapture`'s frame as RGB and of libde265's Y, U and V
  planes (a second decoder: cv2 gives no chroma plane). For a stream whose
  VUI names the BT.709 matrix cv2's raw output is not the luma plane (it
  converts it): `luma_from` is then 'libde265' and the luma hashes are
  libde265's.

- `tests/torch_fixtures/hevc_b/hevcb_*`: B-frame clips (`write_b_fixtures`:
  x265's medium B-frame defaults at three sizes, one B-frame option each),
  the MP4s with the ctts and elst FFmpeg's mov muxer writes, the Matroska
  blocks with presentation timestamps, and a manifest of cv2's frames in
  output order, its seek for every N, x265's pts/dts and libde265's planes.

- `tests/torch_fixtures/hevc10/`: Main 10 clips (`write_fixtures10`) through
  x265's 10-bit API (`x265_api`): the medium preset at 96x66 and 320x568
  with no B frames and with its B-frame defaults, in MP4, a phone's
  QuickTime .mov, Matroska and AVI; a tool clip each (`TOOLS10`); and the
  phone's clip `PHONE` (1920x1080 stored, turned by 90 degrees, HLG over
  BT.2020, Dolby Vision RPUs). The manifest holds libde265's 16-bit planes
  and cv2's RGB frames, metadata and seek.

    python tests/_torch_hevc_fixtures.py      # 8-bit, I/P and B
    python tests/_torch_hevc_fixtures.py b    # the B-frame clips only
    python tests/_torch_hevc_fixtures.py 10   # the Main 10 clips only
"""

from __future__ import annotations

import ctypes
import json
from pathlib import Path

import numpy as np

from _torch_h264_fixtures import _input_planes, cv2_entry, cv2_seeks, split_annexb, write_container
from _torch_mp4v_fixtures import sha256, shifted_frames

ROOT = Path(__file__).resolve().parent.parent
HEVC_DIR = ROOT / 'tests' / 'torch_fixtures' / 'hevc'
GOP = 12
FRAMES = 14
CONTAINERS = ('.mp4', '.mkv', '.avi')
# x265's thread pool stays on: without it x265 writes no WPP substreams (and
# broken slices); its output is the same on every run all the same.
BASE = {'bframes': 0, 'frame-threads': 1, 'keyint': GOP, 'min-keyint': GOP, 'scenecut': 0,
        'repeat-headers': 1, 'info': 0, 'log-level': 'error'}

# (stem, fps, (width, height) or None for the fixture's size, containers)
SIZES = [
    ('hevc_96x66', 10.0, (96, 66), CONTAINERS),
    ('hevc_320x568', 30000 / 1001, (320, 568), CONTAINERS),
    ('hevc_1080x1920', 25.0, None, ('.mp4',)),
]
TOOLS = {
    'ctu16': {'ctu': 16},
    'ctu32': {'ctu': 32},
    'max_tu4': {'max-tu-size': 4},
    'max_tu8': {'max-tu-size': 8},
    'tu_depth4': {'tu-intra-depth': 4, 'tu-inter-depth': 4},
    'amp_rect': {'amp': 1, 'rect': 1},
    'tskip': {'tskip': 1},
    'lossless': {'lossless': 1},
    'cu_lossless': {'cu-lossless': 1},
    'scaling_default': {'scaling-list': 'default'},
    'signhide0': {'signhide': 0},
    'no_sao': {'sao': 0},
    'sao_non_deblock': {'sao-non-deblock': 1},
    'deblock_offsets': {'deblock': '-3:2'},
    'no_deblock': {'no-deblock': 1},
    'tmvp0': {'temporal-mvp': 0},
    'max_merge1': {'max-merge': 1},
    'max_merge5': {'max-merge': 5},
    'ref1': {'ref': 1},
    'ref4': {'ref': 4},
    # x265 writes broken slices when they outnumber the CTU rows: 16x16 CTUs
    # give 96x66 five rows.
    'slices4': {'slices': 4, 'ctu': 16},
    'no_wpp': {'wpp': 0, 'ctu': 32},  # beside ctu32, whose rows x265 codes as WPP substreams
    'constrained_intra': {'constrained-intra': 1},
    'strong_intra0': {'strong-intra-smoothing': 0},
    'qg8_chroma_offsets': {'qg-size': 8, 'cbqpoffs': 3, 'crqpoffs': -2},
    'weightp': {'weightp': 1},  # on a fade (FADE_TOOLS): x265 then sends weights
    'open_gop': {'keyint': 6, 'min-keyint': 6, 'open-gop': 1},
    'closed_gop': {'open-gop': 0},
    'fullrange_bt709': {'range': 'full', 'colormatrix': 'bt709'},
    'bt709': {'colormatrix': 'bt709'},
    'hash1': {'hash': 1},
    'hash2': {'hash': 2},
    'hash3': {'hash': 3},
}
TOOL_SIZE = (96, 66)
FADE_TOOLS = ('weightp',)  # clips of frames that darken by 6% a frame
CASES = ([(stem + ext, fps, size, {}) for stem, fps, size, exts in SIZES for ext in exts]
         + [('hevc_96x66_hev1.mp4', 10.0, (96, 66), {})]
         + [(f'hevc_tool_{t}.mp4', 25.0, TOOL_SIZE, o) for t, o in TOOLS.items()])

# NAL unit types (H.265 Table 7-1)
VPS, SPS, PPS = 32, 33, 34
IRAP = range(16, 24)


def nal_type(nal: bytes) -> int:
    return nal[0] >> 1 & 63


# --------------------------------------------------------------------------
# libx265 through ctypes (x265.h, API build 199)

class _Nal(ctypes.Structure):
    _fields_ = [('type', ctypes.c_uint32), ('size', ctypes.c_uint32),
                ('payload', ctypes.POINTER(ctypes.c_uint8))]


# Offsets in x265_picture (x265.h of build 199)
PIC_PTS, PIC_PLANES, PIC_STRIDE, PIC_DEPTH, PIC_CSP = 0, 24, 48, 60, 72
X265_CSP = {'i400': 0, 'i420': 1, 'i422': 2, 'i444': 3}


# The functions of x265's API struct (x265.h: struct x265_api, build 199)
# by their byte offset. It has one layout at every bit depth; these offsets
# were found by matching the 8-bit struct's pointers against the exported
# symbols, which they equal.
X265_API = {'param_alloc': 48, 'param_free': 56, 'param_parse': 72, 'param_default_preset': 88,
            'picture_alloc': 96, 'picture_free': 104, 'picture_init': 112, 'encoder_open': 120,
            'encoder_encode': 160, 'encoder_close': 184}


def x265_api(depth: int) -> dict:
    """libx265's functions for `depth`-bit samples (8, 10 or 12; the
    library builds all three), from `x265_api_get_199(depth)`."""
    lib = ctypes.CDLL('libx265.so.199')
    vp, i, cp = ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p
    lib.x265_api_get_199.restype = vp
    lib.x265_api_get_199.argtypes = [i]
    api = lib.x265_api_get_199(depth)
    assert api, f'libx265 has no {depth}-bit API'
    assert np.frombuffer(ctypes.string_at(api, 32), np.int32)[7] == depth  # x265_api.bit_depth
    pointers = np.frombuffer(ctypes.string_at(api, 192), np.uint64)
    types = {'param_alloc': (vp,), 'param_free': (None, vp), 'param_parse': (i, vp, cp, cp),
             'param_default_preset': (i, vp, cp, cp), 'picture_alloc': (vp,),
             'picture_free': (None, vp), 'picture_init': (None, vp, vp), 'encoder_open': (vp, vp),
             'encoder_encode': (i, vp, vp, vp, vp, vp), 'encoder_close': (None, vp)}
    return {name: ctypes.CFUNCTYPE(*types[name])(int(pointers[at // 8]))
            for name, at in X265_API.items()}


def x265_encode(frames, options: dict, fps: float, csp: str = 'i420', times=None, depth: int = 8):
    """Annex B packets (one access unit per frame, in decoding order; the
    VPS, SPS and PPS before each IRAP picture) and their key flags (an IRAP
    picture), samples of `depth` bits (8, 10 or 12: 8-bit ones shifted up)
    in the chroma format `csp` (x264's input layout: cv2's I420, the chroma
    repeated for 4:2:2 and 4:4:4), through x265's API of that depth.
    `times`, if given, receives each packet's (pts, dts) in frames."""
    x = x265_api(depth)
    h, w = frames[0].shape[:2]
    param = x['param_alloc']()
    assert x['param_default_preset'](param, b'medium', None) == 0
    num, den = (fps, 1) if float(fps).is_integer() else (30000, 1001)
    opts = dict(BASE, **options)
    opts.update({'fps': f'{int(num)}/{int(den)}', 'input-res': f'{w}x{h}',
                 'input-csp': csp})
    for key, value in opts.items():
        assert x['param_parse'](param, key.encode(), str(value).encode()) == 0, (key, value)
    enc = x['encoder_open'](param)
    assert enc, opts
    pic, out = x['picture_alloc'](), x['picture_alloc']()
    x['picture_init'](param, pic)
    x['picture_init'](param, out)
    nals, n_nal = ctypes.POINTER(_Nal)(), ctypes.c_uint32()
    packets, keys = [], []

    def collect(size):
        if size <= 0:
            return
        data = b''.join(ctypes.string_at(nals[i].payload, nals[i].size)
                        for i in range(n_nal.value))
        packets.append(data)
        vcl = [nal_type(n) for n in split_annexb(data) if nal_type(n) < 32]
        keys.append(vcl[0] in IRAP)
        if times is not None:
            times.append(tuple(int(t) for t in np.frombuffer(ctypes.string_at(out, 16), np.int64)))

    for k, frame in enumerate(frames):
        planes = _input_planes(frame, csp, depth)
        n = len(planes)
        ctypes.memmove(pic + PIC_PLANES, np.array([p.ctypes.data for p in planes] + [0] * (3 - n),
                                                  np.uint64).tobytes(), 24)
        ctypes.memmove(pic + PIC_STRIDE, np.array([p.strides[0] for p in planes] + [0] * (3 - n),
                                                  np.int32).tobytes(), 12)
        ctypes.memmove(pic + PIC_DEPTH, np.array([depth], np.int32).tobytes(), 4)
        ctypes.memmove(pic + PIC_CSP, np.array([X265_CSP[csp]], np.int32).tobytes(), 4)
        ctypes.memmove(pic + PIC_PTS, np.array([k], np.int64).tobytes(), 8)
        collect(x['encoder_encode'](enc, ctypes.byref(nals), ctypes.byref(n_nal), pic, out))
    while True:
        size = x['encoder_encode'](enc, ctypes.byref(nals), ctypes.byref(n_nal), None, out)
        if size <= 0:
            break
        collect(size)
    x['encoder_close'](enc)
    x['picture_free'](pic)
    x['picture_free'](out)
    x['param_free'](param)
    return packets, keys


# --------------------------------------------------------------------------
# libde265 through ctypes (de265.h): the second plane oracle

def de265_decode(packets):
    """libde265's (Y, U, V) of each picture of Annex B packets, in output
    order: uint8 planes at 8 bits, uint16 above."""
    lib = ctypes.CDLL('libde265.so.0')
    vp = ctypes.c_void_p
    lib.de265_new_decoder.restype = vp
    lib.de265_free_decoder.argtypes = [vp]
    lib.de265_push_data.argtypes = [vp, ctypes.c_char_p, ctypes.c_int, ctypes.c_int64, vp]
    lib.de265_flush_data.argtypes = [vp]
    lib.de265_decode.argtypes = [vp, ctypes.POINTER(ctypes.c_int)]
    lib.de265_get_next_picture.argtypes = [vp]
    lib.de265_get_next_picture.restype = vp
    lib.de265_get_image_plane.argtypes = [vp, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.de265_get_image_plane.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.de265_get_image_width.argtypes = [vp, ctypes.c_int]
    lib.de265_get_image_height.argtypes = [vp, ctypes.c_int]
    lib.de265_get_bits_per_pixel.argtypes = [vp, ctypes.c_int]
    ctx = lib.de265_new_decoder()
    out = []

    def drain():
        while True:
            img = lib.de265_get_next_picture(ctx)
            if not img:
                return
            planes = []
            for c in range(3):
                stride = ctypes.c_int()
                ptr = lib.de265_get_image_plane(img, c, ctypes.byref(stride))
                w, h = lib.de265_get_image_width(img, c), lib.de265_get_image_height(img, c)
                wide = lib.de265_get_bits_per_pixel(img, c) > 8  # 16-bit little-endian samples
                a = np.ctypeslib.as_array(ptr, (h, stride.value))[:, :w * (1 + wide)].copy()
                planes.append(a.view('<u2') if wide else a)
            out.append(tuple(planes))

    for k, packet in enumerate(packets):
        assert lib.de265_push_data(ctx, packet, len(packet), k, None) == 0
        more = ctypes.c_int(1)
        while more.value:
            err = lib.de265_decode(ctx, ctypes.byref(more))
            drain()
            if err in (13, 14):  # DE265_ERROR_WAITING_FOR_INPUT_DATA, IMAGE_BUFFER_FULL
                break
    lib.de265_flush_data(ctx)
    more = ctypes.c_int(1)
    while more.value:
        lib.de265_decode(ctx, ctypes.byref(more))
        drain()
    lib.de265_free_decoder(ctx)
    return out



def hevc_frames(n: int, size, tool: str = ''):
    """`shifted_frames`, darkening by 6% a frame for the FADE_TOOLS."""
    frames = shifted_frames(n, size)
    if tool in FADE_TOOLS:
        frames = [np.ascontiguousarray((f * (1 - 0.06 * k)).astype(np.uint8))
                  for k, f in enumerate(frames)]
    return frames


# --------------------------------------------------------------------------
# HEVC packets for the containers

def hvcc(vps: bytes, sps: bytes, pps: bytes) -> bytes:
    """An hvcC (ISO/IEC 14496-15 HEVCDecoderConfigurationRecord) of one VPS,
    SPS and PPS (NAL units without start codes), 4-byte NAL lengths, the
    profile, tier and level copied from the SPS's profile_tier_level."""
    ptl = rbsp(sps)[1:13]  # after the VPS id, sub-layer count and nesting flag
    head = bytes([1]) + ptl + bytes([0xF0, 0x00, 0xFC, 0xFD, 0xF8, 0xF8, 0, 0, 0x0F])
    arrays = b''.join(bytes([0x80 | t, 0, 1]) + len(nal).to_bytes(2, 'big') + nal
                      for t, nal in ((VPS, vps), (SPS, sps), (PPS, pps)))
    return head + bytes([3]) + arrays


def rbsp(nal: bytes) -> bytes:
    """A NAL unit's payload without its 2-byte header and emulation prevention."""
    out, zeros = bytearray(), 0
    for b in nal[2:]:
        if zeros >= 2 and b == 3:
            zeros = 0
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def hevc_container_args(f, ext: str, packets, size, fps: float, codec: str, times=None):
    """The port's muxer for an HEVC stream in `ext` and the packets it holds.
    `times` (x265's (pts, dts) per packet, in frames) marks a stream whose
    frames are reordered: Matroska's block timestamps are then the
    presentation times, and the MP4 gets the time base, `ctts` and `elst`
    that FFmpeg's mov muxer writes for it."""
    from metrabs_tpu_torch.data import mp4, mpeg4, video
    from _torch_h264_fixtures import (annexb_to_lengths, mov_time_base, mov_timing_boxes,
                                      moov_with_timing)
    w, h = size
    sets = {nal_type(n): n for n in split_annexb(packets[0]) if nal_type(n) in (VPS, SPS, PPS)}
    config = hvcc(sets[VPS], sets[SPS], sets[PPS])

    def without_sets(p):
        return b''.join(b'\x00\x00\x00\x01' + n for n in split_annexb(p)
                        if nal_type(n) not in (VPS, SPS, PPS))

    if ext == '.avi':
        return video._AviMuxer(f, w, h, fps, b'HEVC'), packets
    lp = [annexb_to_lengths(p if codec == 'hev1' else without_sets(p)) for p in packets]
    if ext == '.mkv':
        mux = video._MatroskaMuxer(f, w, h, fps, b'V_MPEGH/ISO/HEVC', config)
        if times is not None:
            mux._timestamp = lambda i: int(round(times[i][0] * 1000 / fps))
        return mux, lp
    entry = 'hvc1' if codec == 'hevc' else 'hev1'
    if times is None:
        res, inc = mpeg4.time_base(fps)
        return mp4.Mp4Muxer(f, w, h, res, inc, config, codec=entry), lp
    res, inc = mov_time_base(fps)
    mux = mp4.Mp4Muxer(f, w, h, res, inc, config, codec=entry)
    plain = mux._moov
    mux._moov = lambda: moov_with_timing(plain(), *mov_timing_boxes(times, inc, res))
    return mux, lp


# --------------------------------------------------------------------------
# What the parameter sets say (to read each clip's tool back)

class BitReader:
    def __init__(self, data: bytes):
        self.bits, self.pos = ''.join(f'{b:08b}' for b in data), 0

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


def _skip_ptl(r: BitReader, max_sub_layers_minus1: int) -> int:
    r.u(3)
    profile = r.u(5)
    r.u(32 + 48 + 8)
    flags = [(r.u(1), r.u(1)) for _ in range(max_sub_layers_minus1)]
    if max_sub_layers_minus1:
        r.u(2 * (8 - max_sub_layers_minus1))
    for p, lv in flags:
        r.u(88 * p + 8 * lv)
    return profile


def _st_rps(r: BitReader, idx: int, sets: list, num: int) -> list:
    """st_ref_pic_set(idx) (7.3.7): its (POC delta, used by the current
    picture) pairs, in no particular order."""
    if idx and r.u(1):
        ref = sets[idx - 1 - (r.ue() if idx == num else 0)]
        sign, delta = r.u(1), r.ue() + 1
        delta = -delta if sign else delta
        out = []
        for d, _ in ref + [(0, 0)]:
            used = r.u(1)
            if (used or r.u(1)) and d + delta:
                out.append((d + delta, used))
        return out
    neg, pos = r.ue(), r.ue()
    out, poc = [], 0
    for _ in range(neg):
        poc -= r.ue() + 1
        out.append((poc, r.u(1)))
    poc = 0
    for _ in range(pos):
        poc += r.ue() + 1
        out.append((poc, r.u(1)))
    return out


def sps_fields(nal: bytes) -> dict:
    r = BitReader(rbsp(nal))
    r.u(4)
    msl = r.u(3)
    r.u(1)
    f = dict(profile=_skip_ptl(r, msl))
    r.ue()
    f['at_chroma_format_idc'] = r.pos
    f['chroma_format_idc'] = r.ue()
    f['width'], f['height'] = r.ue(), r.ue()
    if r.u(1):
        f['conformance_window'] = [r.ue() for _ in range(4)]
    f['at_bit_depth'] = r.pos
    f['bit_depth'] = (r.ue() + 8, r.ue() + 8)
    f['log2_max_poc_lsb'] = r.ue() + 4
    ordering = r.u(1)
    for _ in range(0 if ordering else msl, msl + 1):
        f['max_dec_pic_buffering'], f['max_num_reorder'] = r.ue() + 1, r.ue()
        r.ue()
    f['log2_min_cb'] = r.ue() + 3
    f['log2_ctb'] = f['log2_min_cb'] + r.ue()
    f['log2_min_tb'] = r.ue() + 2
    f['log2_max_tb'] = f['log2_min_tb'] + r.ue()
    f['max_th_depth_inter'], f['max_th_depth_intra'] = r.ue(), r.ue()
    f['scaling_list'] = r.u(1)
    if f['scaling_list']:
        f['scaling_list_data'] = r.u(1)
        if f['scaling_list_data']:
            raise ValueError('SPS scaling lists are not parsed here')
    f['amp'], f['sao'] = r.u(1), r.u(1)
    f['at_pcm'] = r.pos
    f['pcm'] = r.u(1)
    if f['pcm']:
        raise ValueError('PCM parameters are not parsed here')
    sets = []
    n = r.ue()
    for i in range(n):
        sets.append(_st_rps(r, i, sets, n))
    f['st_rps'] = sets
    f['at_long_term_refs'] = r.pos
    f['long_term_refs'] = r.u(1)
    if f['long_term_refs']:
        raise ValueError('long-term parameters are not parsed here')
    f['temporal_mvp'], f['strong_intra_smoothing'] = r.u(1), r.u(1)
    f['full_range'], f['matrix'] = 0, 2
    if r.u(1):  # VUI
        if r.u(1) and r.u(8) == 255:
            r.u(32)
        if r.u(1):
            r.u(1)
        if r.u(1):
            r.u(3)
            f['full_range'] = r.u(1)
            if r.u(1):
                r.u(16)
                f['matrix'] = r.u(8)
        if r.u(1):
            r.ue()
            r.ue()
        r.u(1)
        f['at_field_seq'] = r.pos
    return f


def pps_fields(nal: bytes) -> dict:
    r = BitReader(rbsp(nal))
    f = dict(id=r.ue(), sps_id=r.ue())
    f['at_dependent_slices'] = r.pos
    f['dependent_slices'], f['output_flag_present'] = r.u(1), r.u(1)
    f['num_extra_bits'] = r.u(3)
    f['sign_hiding'], f['cabac_init_present'] = r.u(1), r.u(1)
    f['num_ref_idx_default'] = (r.ue() + 1, r.ue() + 1)
    f['init_qp'] = 26 + r.se()
    f['constrained_intra'], f['transform_skip'], f['cu_qp_delta'] = r.u(1), r.u(1), r.u(1)
    f['diff_cu_qp_delta_depth'] = r.ue() if f['cu_qp_delta'] else 0
    f['cb_qp_offset'], f['cr_qp_offset'] = r.se(), r.se()
    f['slice_chroma_qp_offsets'] = r.u(1)
    f['weighted_pred'], f['weighted_bipred'] = r.u(1), r.u(1)
    f['transquant_bypass'] = r.u(1)
    f['at_tiles'] = r.pos
    f['tiles'], f['wpp'] = r.u(1), r.u(1)
    if f['tiles']:
        raise ValueError('tiles are not parsed here')
    f['loop_filter_across_slices'] = r.u(1)
    f['deblocking_disabled'], f['beta_offset'], f['tc_offset'] = 0, 0, 0
    if r.u(1):
        f['deblocking_override'] = r.u(1)
        f['deblocking_disabled'] = r.u(1)
        if not f['deblocking_disabled']:
            f['beta_offset'], f['tc_offset'] = 2 * r.se(), 2 * r.se()
    f['scaling_list_data'] = r.u(1)
    if not f['scaling_list_data']:  # x265 sends none
        f['lists_modification'] = r.u(1)
        f['log2_parallel_merge_level'] = r.ue() + 2
    return f


def slice_fields(nal: bytes, sps: dict, pps: dict) -> dict:
    """A slice segment header (7.3.6.1) up to five_minus_max_num_merge_cand:
    of a P or B slice its active references (`num_ref_idx` of list 0,
    `num_ref_idx_l1`), mvd_l1_zero_flag, the collocated picture's list and
    index, whether a pred_weight_table sends a weight, and MaxNumMergeCand
    (`at_<flag>`: the RBSP bit position of a B slice's flag)."""
    r = BitReader(rbsp(nal))
    t = nal_type(nal)
    f = dict(nal_type=t, temporal_id=(nal[1] & 7) - 1, first=r.u(1))
    if 16 <= t <= 23:
        r.u(1)
    r.ue()
    if not f['first']:
        ctb = 1 << sps['log2_ctb']
        ctbs = -(-sps['width'] // ctb) * -(-sps['height'] // ctb)
        f['address'] = r.u((ctbs - 1).bit_length())
    r.u(pps['num_extra_bits'])
    f['type'] = r.ue()  # 0 B, 1 P, 2 I
    rps = []
    if t not in (19, 20):
        f['poc_lsb'] = r.u(sps['log2_max_poc_lsb'])
        n = len(sps['st_rps'])
        if r.u(1):
            rps = sps['st_rps'][r.u((n - 1).bit_length()) if n > 1 else 0]
        else:
            rps = _st_rps(r, n, sps['st_rps'], n)
        f['temporal_mvp'] = r.u(1) if sps['temporal_mvp'] else 0
    if sps['sao']:
        f['sao'] = (r.u(1), r.u(1))
    if f['type'] in (0, 1):
        lists = 2 if f['type'] == 0 else 1
        refs = list(pps['num_ref_idx_default'][:lists])
        if r.u(1):
            refs = [r.ue() + 1 for _ in range(lists)]
        f['num_ref_idx'] = refs[0]
        if lists == 2:
            f['num_ref_idx_l1'] = refs[1]
        total = sum(used for _, used in rps)
        if pps['lists_modification'] and total > 1:
            for n_refs in refs:
                if r.u(1):
                    r.u(n_refs * (total - 1).bit_length())
        if lists == 2:
            f['at_mvd_l1_zero'] = r.pos
            f['mvd_l1_zero'] = r.u(1)
        if pps['cabac_init_present']:
            f['cabac_init'] = r.u(1)
        if f.get('temporal_mvp'):
            if lists == 2:
                f['at_collocated_from_l0'] = r.pos
            f['collocated_from_l0'] = r.u(1) if lists == 2 else 1
            f['collocated_ref_idx'] = r.ue() if refs[1 - f['collocated_from_l0']] > 1 else 0
        if (pps['weighted_pred'] and lists == 1) or (pps['weighted_bipred'] and lists == 2):
            r.ue()
            r.se()
            f['weights'] = False
            for n_refs in refs:
                luma = [r.u(1) for _ in range(n_refs)]
                chroma = [r.u(1) for _ in range(n_refs)]
                f['weights'] |= any(luma) or any(chroma)
                for lw, cw in zip(luma, chroma):
                    for _ in range(2 * lw + 4 * cw):
                        r.se()
        f['max_merge'] = 5 - r.ue()
    return f


def stream_fields(packets) -> dict:
    """Of Annex B packets: the first SPS and PPS, the slice headers of each
    packet and the hash SEI's type (None without one)."""
    sps = pps = None
    slices, hash_type = [], None
    for p in packets:
        nals = list(split_annexb(p))
        for n in nals:
            if nal_type(n) == SPS and sps is None:
                sps = sps_fields(n)
            elif nal_type(n) == PPS and pps is None:
                pps = pps_fields(n)
            elif nal_type(n) == 40 and n[2] == 132:  # decoded_picture_hash
                hash_type = n[4]
        slices.append([slice_fields(n, sps, pps) for n in nals if nal_type(n) < 32])
    return dict(sps=sps, pps=pps, slices=slices, hash_type=hash_type)


def nal_from_bits(header: bytes, bits: str) -> bytes:
    """A NAL unit of an RBSP's bits: stop bit, alignment, emulation prevention."""
    bits += '1'
    bits += '0' * (-len(bits) % 8)
    raw = bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))
    out, zeros = bytearray(header), 0
    for b in raw:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def rbsp_bits(nal: bytes) -> str:
    """The RBSP of a NAL unit as bits, without its stop bit and alignment."""
    return ''.join(f'{b:08b}' for b in rbsp(nal)).rstrip('0')[:-1]


def edit_parameter_set(packets, kind: int, at: str, value: str, width: int = 1):
    """Annex B packets whose SPS (kind SPS) or PPS (PPS) has `width` bits at
    the field position `at` (of sps_fields/pps_fields) replaced by `value`."""
    out = []
    for p in packets:
        nals = []
        for n in split_annexb(p):
            if nal_type(n) == kind:
                pos = (sps_fields if kind == SPS else pps_fields)(n)[at]
                bits = rbsp_bits(n)
                n = nal_from_bits(n[:2], bits[:pos] + value + bits[pos + width:])
            nals.append(n)
        out.append(b''.join(b'\x00\x00\x00\x01' + n for n in nals))
    return out


# --------------------------------------------------------------------------

def write_fixtures() -> None:
    HEVC_DIR.mkdir(parents=True, exist_ok=True)
    manifest, encoded = {}, {}
    for name, fps, size, options in CASES:
        stem = name.rsplit('.', 1)[0]
        tool = stem[len('hevc_tool_'):] if stem.startswith('hevc_tool_') else ''
        opts = dict(options)
        if name.endswith(('.mp4', '.mkv')) and not tool and stem != 'hevc_320x568':
            opts.setdefault('hash', 1)  # MD5 SEIs for the card to check
        key = (stem.replace('_hev1', ''), fps, size, tuple(sorted(opts.items())))
        if key not in encoded:
            frames = hevc_frames(FRAMES, size, tool)
            packets, keys = x265_encode(frames, opts, fps)
            encoded[key] = packets, keys, de265_decode(packets), frames[0].shape[1::-1]
        packets, keys, planes, wh = encoded[key]
        path = HEVC_DIR / name
        write_container(path, packets, keys, wh, fps, 'hev1' if 'hev1' in stem else 'hevc')
        fields = stream_fields(packets)
        entry = cv2_entry(path, dict(frames=FRAMES, fps=fps, width=wh[0], height=wh[1], x265=opts,
                                     key_frames=keys,
                                     slice_types=[[sl['type'] for sl in p] for p in fields['slices']],
                                     hash_type=fields['hash_type']))
        entry['de265_sha256'] = [[sha256(p) for p in yuv] for yuv in planes]
        de265_luma = [yuv[0] for yuv in entry['de265_sha256']]
        if entry['luma_sha256'] != de265_luma:  # cv2 converts the plane (BT.709)
            entry['luma_sha256'], entry['luma_from'] = de265_luma, 'libde265'
        entry['seek'] = cv2_seeks(path, entry['rgb_sha256'])
        manifest[name] = entry
        print(name, path.stat().st_size, entry['luma_from'])
    (HEVC_DIR / 'manifest.json').write_text(json.dumps(manifest, indent=1) + '\n')


# --------------------------------------------------------------------------
# B-frame clips

HEVC_B_DIR = ROOT / 'tests' / 'torch_fixtures' / 'hevc_b'
# x265's medium preset with its B-frame defaults (bframes 4, b-adapt 2,
# b-pyramid, open GOP); its info SEI names the options, which no header
# shows for some of them (b-adapt).
B_BASE = {'bframes': 4, 'info': 1}
B_FRAMES = 14
B_FRAMES_LONG = 20  # bframes16: room for a run of 16 B pictures
B_SIZES = [
    ('hevcb_96x66', 10.0, (96, 66), CONTAINERS),
    ('hevcb_320x568', 30000 / 1001, (320, 568), CONTAINERS),
    ('hevcb_1080x1920', 25.0, None, ('.mp4',)),
]
B_TOOLS = {
    'bframes1': {'bframes': 1},
    'bframes16': {'bframes': 16, 'b-adapt': 0, 'keyint': 24, 'min-keyint': 24},
    'badapt0': {'b-adapt': 0},
    'badapt2': {'b-adapt': 2},
    'pyramid0': {'b-pyramid': 0},
    'weightb': {'weightb': 1},  # on a fade (B_FADE_TOOLS): x265 then sends weights
    'ref1': {'ref': 1},
    'ref4': {'ref': 4},
    'max_merge1': {'max-merge': 1},
    'max_merge5': {'max-merge': 5},
    'tmvp0': {'temporal-mvp': 0},
    'amp_rect': {'amp': 1, 'rect': 1},
    'slices4': {'slices': 4, 'ctu': 16},
    'no_wpp': {'wpp': 0, 'ctu': 32},
    # An IDR_W_RADL picture every 8 frames with the B pictures before it
    # decoded after it as its RADL pictures.
    'closed_radl': {'open-gop': 0, 'radl': 2, 'keyint': 8, 'min-keyint': 8},
    # A CRA picture every 6 frames whose leading B pictures are RASL pictures.
    'open_gop': {'keyint': 6, 'min-keyint': 6},
    'temporal_layers': {'temporal-layers': 1},
    'hash1': {'hash': 1},
    'hash2': {'hash': 2},
    'hash3': {'hash': 3},
}
B_FADE_TOOLS = ('weightb',)
# A stream edited after x265 wrote it (cv2 decodes it as the oracle): x265
# writes collocated_from_l0_flag 0 in every B slice; `collocated_l0` sets it
# to 1 where the header keeps its length (`set_slice_flag`): the collocated
# picture then comes from list 0, the slice data parses the same and its
# temporal candidates change.
B_CRAFTED = ('collocated_l0',)
B_CASES = ([(stem + ext, fps, size, {}) for stem, fps, size, exts in B_SIZES for ext in exts]
           + [(f'hevcb_tool_{t}.mp4', 25.0, TOOL_SIZE, o) for t, o in B_TOOLS.items()]
           + [(f'hevcb_crafted_{c}.mp4', 25.0, TOOL_SIZE, {}) for c in B_CRAFTED])


def set_slice_flag(packets, at: str):
    """Annex B packets whose B slices have the one-bit flag at the position
    `at` of slice_fields (`at_collocated_from_l0`, `at_mvd_l1_zero`) set.
    collocated_ref_idx (here 0, one bit) follows collocated_from_l0_flag when
    the list it names holds more than one picture: the flag is set only in
    the slices whose two lists agree on that, so that the header keeps its
    length and the slice data its byte alignment."""
    out = []
    sps = pps = None
    for p in packets:
        nals = []
        for n in split_annexb(p):
            if nal_type(n) == SPS:
                sps = sps_fields(n)
            elif nal_type(n) == PPS:
                pps = pps_fields(n)
            elif nal_type(n) < 32:
                f = slice_fields(n, sps, pps)
                if at in f and (at != 'at_collocated_from_l0'
                                or (f['num_ref_idx'] > 1) == (f['num_ref_idx_l1'] > 1)):
                    bits = rbsp_bits(n)
                    n = nal_from_bits(n[:2], bits[:f[at]] + '1' + bits[f[at] + 1:])
            nals.append(n)
        out.append(b''.join(b'\x00\x00\x00\x01' + n for n in nals))
    return out


def hevc_b_frames(n: int, size, tool: str = ''):
    """`moving_frames` of the H.264 B clips (two motions, for prediction from
    both sides), darkening by 6% a frame for the B_FADE_TOOLS."""
    from _torch_h264_fixtures import moving_frames
    frames = moving_frames(n, size)
    if tool in B_FADE_TOOLS:
        frames = [np.ascontiguousarray((f * (1 - 0.06 * k)).astype(np.uint8))
                  for k, f in enumerate(frames)]
    return frames


def write_b_fixtures() -> None:
    """The B-frame clips of `tests/torch_fixtures/hevc_b/`: the MP4s with the
    ctts and elst of FFmpeg's mov muxer, the Matroska blocks with
    presentation timestamps, and a manifest as the I/P clips' (cv2's
    frames in output order, its seek for every N) with x265's pts/dts, each
    packet's NAL unit type and slice types, and per frame whether
    libde265's luma equals FFmpeg's (where it does its Y, U and V are the
    chroma oracle; where it does not, on a few B pictures, cv2 rules)."""
    HEVC_B_DIR.mkdir(parents=True, exist_ok=True)
    manifest, encoded = {}, {}
    for name, fps, size, options in B_CASES:
        stem = name.rsplit('.', 1)[0]
        tool = stem[len('hevcb_tool_'):] if stem.startswith('hevcb_tool_') else ''
        crafted = stem[len('hevcb_crafted_'):] if stem.startswith('hevcb_crafted_') else None
        opts = dict(B_BASE, **options)
        if name.endswith(('.mp4', '.mkv')) and not tool and not crafted and stem != 'hevcb_320x568':
            opts.setdefault('hash', 1)  # MD5 SEIs for the card to check
        n = B_FRAMES_LONG if tool == 'bframes16' else B_FRAMES
        key = (stem.split('.')[0], fps, size, tuple(sorted(opts.items())))
        if key not in encoded:
            frames = hevc_b_frames(n, size, tool)
            times = []
            packets, keys = x265_encode(frames, opts, fps, times=times)
            if crafted:
                packets = set_slice_flag(packets, 'at_collocated_from_l0')
            encoded[key] = packets, keys, times, de265_decode(packets), frames[0].shape[1::-1]
        packets, keys, times, planes, wh = encoded[key]
        path = HEVC_B_DIR / name
        write_container(path, packets, keys, wh, fps, 'hevc', times=times)
        fields = stream_fields(packets)
        slices = fields['slices']
        entry = cv2_entry(path, dict(frames=n, fps=fps, width=wh[0], height=wh[1], x265=opts,
                                     edit=crafted, key_frames=keys, times=times,
                                     nal_types=[p[0]['nal_type'] for p in slices],
                                     slice_types=[[sl['type'] for sl in p] for p in slices],
                                     hash_type=fields['hash_type']))
        entry['de265_sha256'] = [[sha256(p) for p in yuv] for yuv in planes]
        entry['de265_equals_ffmpeg'] = [yuv[0] == luma for yuv, luma in
                                        zip(entry['de265_sha256'], entry['luma_sha256'])]
        entry['seek'] = cv2_seeks(path, entry['rgb_sha256'])
        manifest[name] = entry
        print(name, path.stat().st_size, sum(entry['de265_equals_ffmpeg']), len(planes))
    (HEVC_B_DIR / 'manifest.json').write_text(json.dumps(manifest, indent=1) + '\n')


# --------------------------------------------------------------------------
# Main 10 clips

HEVC10_DIR = ROOT / 'tests' / 'torch_fixtures' / 'hevc10'
CONTAINERS10 = ('.mp4', '.mov', '.mkv', '.avi')
# (stem, fps, (width, height), x265 options beyond BASE, containers)
SIZES10 = [
    ('hevc10_96x66', 10.0, (96, 66), {}, CONTAINERS10),
    ('hevc10_320x568', 30000 / 1001, (320, 568), {}, CONTAINERS10),
    ('hevc10b_96x66', 10.0, (96, 66), B_BASE, CONTAINERS10),
    ('hevc10b_320x568', 30000 / 1001, (320, 568), B_BASE, CONTAINERS10),
]
TOOLS10 = {
    'no_sao': {'sao': 0},
    'crf8': {'crf': 8},  # large levels and SAO offsets (up to 31 at 10 bits)
    'weightp': {'weightp': 1},  # on a fade
    'weightb': dict(B_BASE, weightb=1),  # on a fade
    'strong_intra0': {'strong-intra-smoothing': 0},
    'tskip': {'tskip': 1},
    'signhide0': {'signhide': 0},
    'amp_rect': {'amp': 1, 'rect': 1},
    'no_wpp': {'wpp': 0, 'ctu': 32},
    'lossless': {'lossless': 1},
    'qg8_chroma_offsets': {'qg-size': 8, 'cbqpoffs': 3, 'crqpoffs': -2},
    'bt2020': {'colormatrix': 'bt2020nc'},
    # An iPhone's HDR signalling: cv2's FFmpeg maps BT.2020 primaries and
    # the HLG transfer to its RGB's, which the port does not (F11).
    'bt2020_hlg': {'colorprim': 'bt2020', 'transfer': 'arib-std-b67', 'colormatrix': 'bt2020nc'},
    'fullrange_bt709': {'range': 'full', 'colormatrix': 'bt709'},
    'dovi_rpu': {},  # NAL units of type 62 (Dolby Vision RPUs) after each picture
    'hash1': {'hash': 1},
    'hash2': {'hash': 2},
    'hash3': {'hash': 3},
}
FADE_TOOLS10 = ('weightp', 'weightb')
# Uncropped, so that the MD5 SEIs can judge libde265's planes (its weighted
# B pictures go wrong where the hash shows the port's right).
TOOL10_SIZES = {'weightb': (96, 64)}
# The phone's clip: a portrait video as an iPhone stores it (landscape
# 1920x1080 frames turned by 90 degrees in the track header) in QuickTime's
# layout (its colr naming BT.2020 and HLG), Main 10 over the BT.2020 matrix
# with x265's B-frame defaults, and a Dolby Vision RPU after each picture.
# Its VUI names no primaries and no transfer: an iPhone's names BT.2020 and
# HLG, which cv2 maps to other colours (F11, `bt2020_hlg`).
PHONE = 'hevc10_phone_1920x1080.mov'
PHONE_FRAMES = 24
PHONE_OPTIONS = dict(B_BASE, hash=1, **TOOLS10['bt2020'])
CASES10 = ([(stem + ext, fps, size, opts) for stem, fps, size, opts, exts in SIZES10
            for ext in exts]
           + [(f'hevc10_tool_{t}.mp4', 25.0, TOOL10_SIZES.get(t, TOOL_SIZE), o)
              for t, o in TOOLS10.items()]
           + [(PHONE, 30.0, (1920, 1080), PHONE_OPTIONS)])
# A Dolby Vision RPU's NAL unit: type 62, layer 0, temporal id 0, and a
# payload that parses as none (FFmpeg warns and ignores it; no emulation
# prevention needed).
DOVI_RPU = bytes([62 << 1, 1, 0x19, 0x08, 0x09, 0x15, 0x40, 0x80])


def with_rpus(packets):
    """Annex B packets with a Dolby Vision RPU NAL unit last in each, as
    an iPhone's HDR stream carries them."""
    return [p + b'\x00\x00\x00\x01' + DOVI_RPU for p in packets]


def phone_frames(n: int):
    """The portrait fixture's frames (shifted), stored turned 90 degrees
    counter-clockwise: what cv2 turns back by the clip's matrix."""
    return [np.ascontiguousarray(np.rot90(f, 1)) for f in shifted_frames(n)]


def cv2_entry10(path: Path, written: dict) -> dict:
    """cv2's frames (RGB SHA-256), metadata (with the orientation), packets
    and key flags of a clip; its seek for every N. cv2 gives no plane of a
    10-bit stream (CAP_PROP_CONVERT_RGB 0 returns the rows' first bytes)."""
    import cv2
    from _torch_h264_fixtures import cv2_packets_and_keys
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
    packets, keys = cv2_packets_and_keys(str(path))
    import hashlib
    return dict(written=written, cv2=meta, rgb_sha256=rgb, packet_sha256=[sha256(p) for p in packets],
                key_frames=keys, seek=cv2_seeks(path, rgb),
                file_sha256=hashlib.sha256(path.read_bytes()).hexdigest())


def write_fixtures10() -> None:
    """The Main 10 clips of `tests/torch_fixtures/hevc10/` and their manifest:
    libde265's 16-bit planes (the plane oracle: cv2 gives none at 10 bits),
    cv2's RGB frames, metadata and seek, x265's options. The .mov files have
    a phone's QuickTime layout (`_torch_orientation_fixtures.quicktime`),
    the phone's clip its matrix too."""
    from _torch_orientation_fixtures import (MATRICES, fixed_matrix, quicktime, rewrite_mp4,
                                             set_matrix)
    HEVC10_DIR.mkdir(parents=True, exist_ok=True)
    manifest, encoded = {}, {}
    for name, fps, size, options in CASES10:
        stem, ext = name.rsplit('.', 1)
        tool = stem[len('hevc10_tool_'):] if stem.startswith('hevc10_tool_') else ''
        opts = dict(options)
        if (ext in ('mp4', 'mov', 'mkv') and not tool and '320x568' not in stem) or \
                opts.get('bframes'):
            # MD5 SEIs for the card to check, and on the B pictures where
            # libde265 goes wrong the oracle of the planes
            opts.setdefault('hash', 1)
        n = PHONE_FRAMES if name == PHONE else FRAMES
        key = (stem, fps, size, tuple(sorted(opts.items())))
        if key not in encoded:
            if name == PHONE:
                frames = phone_frames(n)
            else:
                frames = shifted_frames(n, size)
                if tool in FADE_TOOLS10:
                    frames = [np.ascontiguousarray((f * (1 - 0.06 * k)).astype(np.uint8))
                              for k, f in enumerate(frames)]
            times = []
            packets, keys = x265_encode(frames, opts, fps, times=times, depth=10)
            if tool == 'dovi_rpu' or name == PHONE:
                packets = with_rpus(packets)
            reordered = opts.get('bframes', 0) > 0
            encoded[key] = (packets, keys, times if reordered else None, de265_decode(packets),
                            frames[0].shape[1::-1])
        packets, keys, times, planes, wh = encoded[key]
        path = HEVC10_DIR / name
        if ext == 'mov':
            mp4_path = path.with_name(stem + '_mov.mp4')
            write_container(mp4_path, packets, keys, wh, fps, 'hevc', times=times)
            mp4_path.rename(path)
            colour = (9, 18, 9, 0) if name == PHONE else (1, 1, 1, 0)

            def edit(moov, phone=name == PHONE, colour=colour):
                if phone:
                    set_matrix(moov, b'tkhd', fixed_matrix(*MATRICES['rot90'][0]))
                quicktime(moov, colour)
            rewrite_mp4(path, edit, brand=b'qt  ')
        else:
            write_container(path, packets, keys, wh, fps, 'hevc', times=times)
        fields = stream_fields(packets)
        slices = fields['slices']
        entry = cv2_entry10(path, dict(frames=n, fps=fps, width=wh[0], height=wh[1], x265=opts,
                                       key_frames=keys, times=times,
                                       nal_types=[p[0]['nal_type'] for p in slices],
                                       slice_types=[[sl['type'] for sl in p] for p in slices],
                                       hash_type=fields['hash_type'],
                                       bit_depth=fields['sps']['bit_depth']))
        entry['de265_sha256'] = [[sha256(p) for p in yuv] for yuv in planes]
        entry['sei_md5'], entry['de265_verified'] = md5_seis(packets, times, planes, fields['sps'])
        manifest[name] = entry
        print(name, path.stat().st_size, entry['cv2'], entry['de265_verified'].count(False))
    (HEVC10_DIR / 'manifest.json').write_text(json.dumps(manifest, indent=1) + '\n')


def md5_seis(packets, times, planes, sps):
    """Per output picture: the MD5s of its decoded-picture hash SEI (None
    without one), and whether libde265's planes equal them (None where the
    conformance window crops the picture, which the hash covers whole).
    libde265 goes wrong on a few B pictures; there the hash is the oracle."""
    import hashlib
    sums = []
    for p in packets:
        found = None
        for n in split_annexb(p):
            if nal_type(n) == 40 and n[2] == 132 and n[4] == 0:
                r = rbsp(n)
                found = [r[3 + 16 * c:19 + 16 * c].hex() for c in range(3)]
        sums.append(found)
    order = np.argsort([t[0] for t in times], kind='stable') if times else range(len(packets))
    cropped = 'conformance_window' in sps
    md5s, verified = [], []
    for j, yuv in zip(order, planes):
        md5s.append(sums[j])
        if sums[j] is None or cropped:
            verified.append(None)
        else:
            verified.append([hashlib.md5(a.astype('<u2').tobytes()).hexdigest() for a in yuv] == sums[j])
    return md5s, verified


if __name__ == '__main__':
    import sys
    which = sys.argv[1:]  # `b`: the B-frame clips only; `10`: the Main 10 clips only
    if which == ['10']:
        write_fixtures10()
    else:
        if which != ['b']:
            write_fixtures()
        write_b_fixtures()
