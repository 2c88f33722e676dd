"""Writes the MPEG-4 Advanced Simple fixtures of the port's video layer
(`tests/torch_fixtures/mp4v_asp`) with libxvidcore (and FFmpeg's own mpeg4
encoder, libavcodec 59, for field motion vectors, which Xvid does not
write), both through ctypes, and records what cv2 and FFmpeg's decoder make
of them (the card's machine has neither library: `chip_smoke.py` holds the
port's decoder to the recorded hashes there):

- `xvid_asp_<tool>.avi`: one tool each at 96x66, 24 frames with an I-VOP
  every 10 (so the open GOPs' B-VOPs follow the I-VOP they precede): B-VOPs
  in an open and a closed GOP, a packed bitstream, MPEG quantisation with
  the default and with custom matrices, quarter-pel with 4MV and B-VOPs,
  GMC (S-VOPs whose MBs pick the warp), and interlaced coding (field DCT,
  top field first, alternate scan, B-VOPs) of frames whose fields come from
  two moments (woven, as an interlaced camera films);
- `lavc_asp_interlaced.avi` and `lavc_asp_interlaced_qpel.avi`: FFmpeg's
  encoder with field DCT and field motion estimation (field vectors in P-
  and B-VOPs, field direct mode; the second with quarter-pel, MPEG
  quantisation and 4MV);
- `xvid_asp_usual_<size>.avi|.mkv`: Xvid's usual Advanced Simple stream,
  two B-VOPs, packed, quarter-pel, MPEG quantisation and GMC together, at
  96x66 (24 frames), 320x568 (14) and 1080x1920 (25; an I-VOP every 12),
  in AVI and Matroska (block timestamps in packet order, as a remux of the
  AVI writes them). The 320x568 stream ends on a packet of a P-VOP and the
  B-VOP before it, with no placeholder after: FFmpeg never decodes that
  B-VOP, and cv2 reads 13 frames of 13 packets;
- `xvid_asp_bvop.mp4|.mkv`: the open-GOP B-VOP stream in an MP4 with the
  `ctts` and `elst` FFmpeg's mov muxer writes, and in Matroska with
  presentation timestamps;
- `manifest.json`: per file cv2's frame count, rate, size and frames read,
  per frame the SHA-256 of FFmpeg's luma plane (`cv2.CAP_PROP_CONVERT_RGB`
  0), of `cv2.VideoCapture`'s frame as RGB, of the packet as cv2 returns it
  with its key flag, cv2's seek for every N (JAX's `imread`), the planes
  FFmpeg's decoder outputs (libavcodec through ctypes, without swscale:
  Y, U, V), the tools the headers carry (`_torch_mp4v_headers`), and
  whether cv2's frames are FFmpeg's: its swscale refuses interlaced
  frames ("Invalid argument"), so cv2 returns no picture of them (raw
  planes that often change from read to read, RGB unrelated to the
  video). The RGB of those clips (`rgb_from` 'lavc+swscale') is FFmpeg's
  decoder's planes through libswscale (FFmpeg 5.1's, through ctypes) as
  cv2 asks it to convert (yuv420p to bgr24 at the same size, bicubic),
  which gives cv2's RGB bit for bit on every other clip (checked as the
  manifest is written).

    python tests/_torch_mp4v_asp_fixtures.py   # ~1 minute, ~1.9 MB
"""

from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

import numpy as np

import _torch_h264_fixtures as F
from _torch_mp4v_fixtures import cv2_read, sha256, shifted_frames
from _torch_mp4v_headers import stream_tools

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:  # run as a script: the port's muxers write the containers
    sys.path.insert(0, str(ROOT))
ASP_DIR = ROOT / 'tests' / 'torch_fixtures' / 'mp4v_asp'
TOOL_SIZE = (96, 66)
TOOL_FRAMES, TOOL_GOP = 24, 10
QUANT = 4
# A custom pair of matrices (natural order), unlike the defaults.
INTRA_MATRIX = [8 + (i % 8) + 3 * (i // 8) for i in range(64)]
INTER_MATRIX = [16 + 2 * (i % 8) + (i // 8) for i in range(64)]


def _me(qpel: bool = False) -> int:
    me = F.XVID_ME_HALFPELREFINE16 | F.XVID_ME_HALFPELREFINE8 | F.XVID_ME_EXTSEARCH16
    return me | (F.XVID_ME_QUARTERPELREFINE16 | F.XVID_ME_QUARTERPELREFINE8 if qpel else 0)


def xvid_cases():
    """(name, xvid_encode options, frames, size, woven frames) of the Xvid clips."""
    hpel, v4 = F.XVID_VOP_HALFPEL, F.XVID_VOP_INTER4V
    usual = dict(max_bframes=2, global_flags=F.XVID_GLOBAL_PACKED,
                 vol_flags=F.XVID_VOL_QUARTERPEL | F.XVID_VOL_MPEGQUANT | F.XVID_VOL_GMC,
                 vop_flags=hpel | v4, motion=_me(True) | F.XVID_ME_GME_REFINE)
    tools = {
        'bvop': dict(max_bframes=2, motion=_me()),
        'bvop_closed': dict(max_bframes=2, global_flags=F.XVID_GLOBAL_CLOSED_GOP, motion=_me()),
        'packed': dict(max_bframes=2, global_flags=F.XVID_GLOBAL_PACKED, motion=_me()),
        'mpegquant': dict(vol_flags=F.XVID_VOL_MPEGQUANT, motion=_me()),
        'mpegquant_custom': dict(vol_flags=F.XVID_VOL_MPEGQUANT, motion=_me(),
                                 quant_intra_matrix=INTRA_MATRIX,
                                 quant_inter_matrix=INTER_MATRIX),
        'qpel': dict(max_bframes=2, vol_flags=F.XVID_VOL_QUARTERPEL, vop_flags=hpel | v4,
                     motion=_me(True)),
        'gmc': dict(vol_flags=F.XVID_VOL_GMC, motion=_me() | F.XVID_ME_GME_REFINE),
        'interlaced': dict(max_bframes=2, vol_flags=F.XVID_VOL_INTERLACING, motion=_me(),
                           vop_flags=hpel | F.XVID_VOP_TOPFIELDFIRST | F.XVID_VOP_ALTERNATESCAN),
    }
    out = [(f'xvid_asp_{t}', o, TOOL_FRAMES, TOOL_SIZE, t == 'interlaced')
           for t, o in tools.items()]
    out += [('xvid_asp_usual_96x66', usual, TOOL_FRAMES, TOOL_SIZE, False),
            ('xvid_asp_usual_320x568', usual, 14, (320, 568), False),
            ('xvid_asp_usual_1080x1920', dict(usual, quant=8), 25, None, False)]
    return out


# FFmpeg's encoder (AVOptions of its codec context): field DCT and field
# motion estimation, two B-frames, an I-VOP every 10 frames at quantiser 4.
LAVC_CASES = [
    ('lavc_asp_interlaced', {'flags': '+ildct+ilme', 'bf': 2, 'g': TOOL_GOP, 'qmin': QUANT,
                             'qmax': QUANT}),
    ('lavc_asp_interlaced_qpel', {'flags': '+ildct+ilme+qpel+mv4', 'mpeg_quant': 1, 'bf': 2,
                                  'g': TOOL_GOP, 'qmin': QUANT, 'qmax': QUANT}),
]


def frames_for(n: int, size, woven: bool):
    """RGB frames: the shifted portrait fixture; woven: each frame's odd rows
    from the next moment (two fields filmed apart)."""
    if not woven:
        return shifted_frames(n, size)
    base = shifted_frames(2 * n, size)
    out = []
    for k in range(n):
        f = base[2 * k].copy()
        f[1::2] = base[2 * k + 1][1::2]
        out.append(f)
    return out


def i420(frame):
    import cv2
    h, w = frame.shape[:2]
    flat = cv2.cvtColor(np.ascontiguousarray(frame[..., ::-1]), cv2.COLOR_BGR2YUV_I420).reshape(-1)
    q = (h // 2) * (w // 2)
    return (flat[:h * w].reshape(h, w), flat[h * w:h * w + q].reshape(h // 2, w // 2),
            flat[h * w + q:].reshape(h // 2, w // 2))


# --------------------------------------------------------------------------
# libavcodec 59 (FFmpeg 5.1) through ctypes: FFmpeg's mpeg4 decoder, whose
# planes need no swscale, and its encoder.

AV_CODEC_ID_MPEG4 = 12
# Offsets in AVPacket (data, size, flags) and AVFrame (data, linesize,
# width, height, format, pts) of libavcodec 59 and libavutil 57.
PKT_DATA, PKT_SIZE, PKT_FLAGS = 24, 32, 40
FRAME_LINESIZE, FRAME_WIDTH, FRAME_FORMAT, FRAME_PTS = 64, 104, 116, 136


class _AVOption(ctypes.Structure):
    _fields_ = [('name', ctypes.c_char_p), ('help', ctypes.c_char_p), ('offset', ctypes.c_int),
                ('type', ctypes.c_int), ('default', ctypes.c_int64), ('min', ctypes.c_double),
                ('max', ctypes.c_double), ('flags', ctypes.c_int), ('unit', ctypes.c_char_p)]


def _libav():
    vp = ctypes.c_void_p
    av, au = ctypes.CDLL('libavcodec.so.59'), ctypes.CDLL('libavutil.so.57')
    for name, args, res in (
            ('avcodec_find_decoder', [ctypes.c_int], vp),
            ('avcodec_find_encoder', [ctypes.c_int], vp),
            ('avcodec_alloc_context3', [vp], vp), ('avcodec_open2', [vp, vp, vp], ctypes.c_int),
            ('av_packet_alloc', [], vp), ('av_packet_unref', [vp], None),
            ('avcodec_send_packet', [vp, vp], ctypes.c_int),
            ('avcodec_receive_frame', [vp, vp], ctypes.c_int),
            ('avcodec_send_frame', [vp, vp], ctypes.c_int),
            ('avcodec_receive_packet', [vp, vp], ctypes.c_int)):
        f = getattr(av, name)
        f.argtypes, f.restype = args, res
    for name, args, res in (
            ('av_frame_alloc', [], vp), ('av_frame_unref', [vp], None),
            ('av_frame_get_buffer', [vp, ctypes.c_int], ctypes.c_int),
            ('av_opt_find', [vp, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int],
             ctypes.POINTER(_AVOption)),
            ('av_opt_set', [vp, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int], ctypes.c_int)):
        f = getattr(au, name)
        f.argtypes, f.restype = args, res
    return av, au


def _put(address: int, values, dtype=np.int32) -> None:
    data = np.asarray(values, dtype).tobytes()
    ctypes.memmove(address, data, len(data))


def _get(address: int, offset: int, n: int, dtype=np.int32):
    return np.frombuffer(ctypes.string_at(address + offset, n * np.dtype(dtype).itemsize), dtype)


def lavc_decode(packets):
    """(Y, U, V) of each frame FFmpeg's mpeg4 decoder outputs for the packets
    (in output order; the flush at the end included)."""
    av, au = _libav()
    codec = av.avcodec_find_decoder(AV_CODEC_ID_MPEG4)
    ctx = av.avcodec_alloc_context3(codec)
    assert av.avcodec_open2(ctx, codec, None) == 0
    pkt, frame = av.av_packet_alloc(), au.av_frame_alloc()
    out = []

    def drain():
        while av.avcodec_receive_frame(ctx, frame) == 0:
            ptrs = _get(frame, 0, 3, np.uint64)
            lines = _get(frame, FRAME_LINESIZE, 3)
            w, h = _get(frame, FRAME_WIDTH, 2)
            planes = []
            for k, (pw, ph) in enumerate(((w, h), ((w + 1) // 2, (h + 1) // 2),
                                          ((w + 1) // 2, (h + 1) // 2))):
                raw = ctypes.string_at(int(ptrs[k]), int(lines[k]) * int(ph))
                planes.append(np.frombuffer(raw, np.uint8).reshape(ph, lines[k])[:, :pw].copy())
            out.append(planes)
            au.av_frame_unref(frame)

    for p in packets:
        data = ctypes.create_string_buffer(p, len(p))
        _put(pkt + PKT_DATA, [ctypes.addressof(data)], np.uint64)
        _put(pkt + PKT_SIZE, [len(p)])
        av.avcodec_send_packet(ctx, pkt)
        drain()
    av.avcodec_send_packet(ctx, None)
    drain()
    return out


def lavc_encode(frames, fps: int, options: dict):
    """Packets and key flags of FFmpeg's mpeg4 encoder (Lavc-stamped) for RGB
    frames, `options` set on its codec context by name. The frame size and
    time base have no option: they lie after `flags2` in AVCodecContext
    (extradata, extradata_size, time_base, ticks_per_frame, delay, width,
    height)."""
    av, au = _libav()
    codec = av.avcodec_find_encoder(AV_CODEC_ID_MPEG4)
    ctx = av.avcodec_alloc_context3(codec)
    offset = lambda name: au.av_opt_find(ctx, name.encode(), None, 0, 0).contents.offset  # noqa: E731
    h, w = frames[0].shape[:2]
    time_base = offset('flags2') + 4 + 4 + 8 + 4
    _put(ctx + time_base, [1, fps])
    _put(ctx + time_base + 16, [w, h])
    _put(ctx + offset('pixel_format'), [0])  # yuv420p
    for key, value in options.items():
        assert au.av_opt_set(ctx, key.encode(), str(value).encode(), 1) == 0, key
    assert av.avcodec_open2(ctx, codec, None) == 0
    pkt = av.av_packet_alloc()
    packets, keys = [], []

    def drain():
        while av.avcodec_receive_packet(ctx, pkt) == 0:
            data = int(_get(pkt, PKT_DATA, 1, np.uint64)[0])
            size, flags = int(_get(pkt, PKT_SIZE, 1)[0]), int(_get(pkt, PKT_FLAGS, 1)[0])
            packets.append(ctypes.string_at(data, size))
            keys.append(bool(flags & 1))
            av.av_packet_unref(pkt)

    for i, frame in enumerate(frames):
        fr = au.av_frame_alloc()
        _put(fr + FRAME_WIDTH, [w, h])
        _put(fr + FRAME_FORMAT, [0])
        assert au.av_frame_get_buffer(fr, 0) == 0
        ptrs, lines = _get(fr, 0, 3, np.uint64), _get(fr, FRAME_LINESIZE, 3)
        for k, plane in enumerate(i420(frame)):
            for r in range(plane.shape[0]):
                ctypes.memmove(int(ptrs[k]) + r * int(lines[k]), plane[r].tobytes(), plane.shape[1])
        _put(fr + FRAME_PTS, [i], np.int64)
        assert av.avcodec_send_frame(ctx, fr) == 0
        drain()
    av.avcodec_send_frame(ctx, None)
    drain()
    return packets, keys


def sws_rgb(planes):
    """RGB uint8 [H, W, 3] of (Y, U, V) planes through libswscale 6 (FFmpeg
    5.1) as cv2's FFmpeg backend converts a frame: yuv420p to bgr24 at the
    same size, SWS_BICUBIC, the default colour space (BT.601, limited)."""
    sws = ctypes.CDLL('libswscale.so.6')
    vp, i = ctypes.c_void_p, ctypes.c_int
    sws.sws_getContext.argtypes, sws.sws_getContext.restype = [i] * 7 + [vp, vp, vp], vp
    sws.sws_scale.argtypes, sws.sws_scale.restype = [vp, vp, vp, i, i, vp, vp], i
    sws.sws_freeContext.argtypes, sws.sws_freeContext.restype = [vp], None
    h, w = planes[0].shape

    def padded(rows, cols):  # swscale's SIMD reads and writes past a row's end
        return np.zeros((rows + 2, (cols + 127) // 64 * 64), np.uint8)

    src = []
    for plane in planes:
        buf = padded(*plane.shape)
        buf[:plane.shape[0], :plane.shape[1]] = plane
        src.append(buf)
    dst = padded(h, 3 * w)
    ctx = sws.sws_getContext(w, h, 0, w, h, 3, 4, None, None, None)  # yuv420p, bgr24, bicubic
    assert ctx
    sws.sws_scale(ctx, (vp * 4)(*[b.ctypes.data for b in src], None),
                  (i * 4)(*[b.strides[0] for b in src], 0), 0, h,
                  (vp * 4)(dst.ctypes.data, None, None, None), (i * 4)(dst.strides[0], 0, 0, 0))
    sws.sws_freeContext(ctx)
    return dst[:h, :3 * w].reshape(h, w, 3)[..., ::-1]


# --------------------------------------------------------------------------
# Containers and the manifest

def display_frames(packets) -> list:
    """The display frame of each packet's first VOP, from the VOP times
    (modulo_time_base and vop_time_increment, in frames of the VOL's
    fixed_vop_time_increment, or of 1 tick without one)."""
    from _torch_mp4v_headers import _Bits, _units, parse_vol
    vol, base, last_base, out = None, 0, 0, []
    for packet in packets:
        first = None
        for code, payload in _units(packet):
            if 0x20 <= code <= 0x2f and vol is None:
                vol = parse_vol(payload)
            elif code == 0xb3:
                b = _Bits(payload)
                hours, minutes = b.u(5), b.u(6)
                b.u(1)
                base = b.u(6) + 60 * (minutes + 60 * hours)
            elif code == 0xb6 and first is None:
                b = _Bits(payload[:16])
                kind, incr = b.u(2), 0
                while b.u(1):
                    incr += 1
                b.u(1)
                inc = b.u(max((vol['time_resolution'] - 1).bit_length(), 1))
                if kind != 2:
                    last_base, base = base, base + incr
                    first = base * vol['time_resolution'] + inc
                else:
                    first = (last_base + incr) * vol['time_resolution'] + inc
        out.append(first)
    step = min(b - a for a, b in zip(sorted(out), sorted(out)[1:]) if b > a)
    return [(t - min(out)) // step for t in out]


def write_container(path: Path, packets, keys, size, fps: float, pts=None, fourcc=b'XVID'):
    """mp4v packets into the container the extension names, through the
    port's muxers: AVI (FourCC `fourcc`), Matroska (block timestamps from
    `pts`, in frames, else in packet order) or MP4 (with FFmpeg's ctts and
    elst for `pts`)."""
    from metrabs_tpu_torch.data import mp4, video
    w, h = size
    config = packets[0][:packets[0].index(b'\x00\x00\x01\xb6')]
    with open(path, 'wb') as f:
        if path.suffix == '.avi':
            mux = video._AviMuxer(f, w, h, fps, fourcc)
        elif path.suffix == '.mkv':
            mux = video._MatroskaMuxer(f, w, h, fps, b'V_MPEG4/ISO/ASP', config)
            if pts is not None:
                mux._timestamp = lambda i: int(round(pts[i] * 1000 / fps))
        else:
            res, inc = F.mov_time_base(fps)
            mux = mp4.Mp4Muxer(f, w, h, res, inc, config)
            times = [(p, d) for d, p in enumerate(pts)]
            plain = mux._moov
            mux._moov = lambda: F.moov_with_timing(plain(), *F.mov_timing_boxes(times, inc, res))
        for packet, key in zip(packets, keys):
            mux.write(packet, key)
        mux.close()


def entry(path: Path, written: dict) -> dict:
    from metrabs_tpu_torch.data import video
    out = F.cv2_entry(path, written)
    idx = video.index(str(path))
    packets = [idx.packet(i) for i in range(idx.n_frames)]
    planes = lavc_decode(packets)
    out['lavc_sha256'] = [[sha256(p) for p in yuv] for yuv in planes]
    out['cv2_is_ffmpeg'] = [sha256(p[0]) for p in planes] == out['luma_sha256']
    rgb = [sha256(sws_rgb(p)) for p in planes]
    out['rgb_from'] = 'cv2'
    if out['cv2_is_ffmpeg']:  # the reference of the interlaced clips' RGB holds here
        assert rgb == out['rgb_sha256'], path.name
    else:  # FFmpeg's planes and swscale's RGB; cv2 has no picture of them
        out['luma_sha256'] = [sha256(p[0]) for p in planes]
        out['luma_from'], out['rgb_sha256'], out['rgb_from'] = 'lavc', rgb, 'lavc+swscale'
    tools = stream_tools(packets)
    out['tools'] = dict(tools, vol={k: v for k, v in tools['vol'].items()
                                    if not k.endswith('matrix')},
                        custom_matrices=[k for k in ('intra_matrix', 'inter_matrix')
                                         if tools['vol'][k] is not None])
    out['seek'] = F.cv2_seeks(path, out['rgb_sha256']) if out['cv2_is_ffmpeg'] else None
    return out


def write_fixtures() -> None:
    ASP_DIR.mkdir(parents=True, exist_ok=True)
    manifest = {}
    fps = 10.0
    for stem, options, n, size, woven in xvid_cases():
        frames = frames_for(n, size, woven)
        opts = dict(options)
        quant = opts.pop('quant', QUANT)
        packets, keys = F.xvid_encode(frames, fps, quant, gop=TOOL_GOP if size == TOOL_SIZE else 12,
                                      **opts)
        wh = frames[0].shape[1::-1]
        written = dict(frames=n, fps=fps, width=wh[0], height=wh[1], xvid_quant=quant,
                       xvid={k: v for k, v in opts.items() if not k.endswith('matrix')},
                       woven_fields=woven, key_frames=keys)
        exts = ['.avi']
        if stem.startswith('xvid_asp_usual'):
            exts.append('.mkv')
        if stem == 'xvid_asp_bvop':
            exts += ['.mp4', '.mkv']
        pts = display_frames(packets)
        for ext in exts:
            path = ASP_DIR / (stem + ext)
            packed = 'global_flags' in opts and opts['global_flags'] & F.XVID_GLOBAL_PACKED
            write_container(path, packets, keys, wh, fps, None if packed else pts)
            manifest[path.name] = entry(path, dict(written, pts=None if packed else pts))
    for stem, options in LAVC_CASES:
        frames = frames_for(TOOL_FRAMES, TOOL_SIZE, True)
        packets, keys = lavc_encode(frames, int(fps), options)
        path = ASP_DIR / (stem + '.avi')
        write_container(path, packets, keys, TOOL_SIZE, fps, fourcc=b'FMP4')
        manifest[path.name] = entry(path, dict(frames=TOOL_FRAMES, fps=fps, width=TOOL_SIZE[0],
                                               height=TOOL_SIZE[1], lavc=options,
                                               woven_fields=True, key_frames=keys))
    (ASP_DIR / 'manifest.json').write_text(json.dumps(manifest, indent=1) + '\n')


if __name__ == '__main__':
    write_fixtures()
