"""The port's H.264 layer (`csrc/h264_decode.cpp`, `data/h264.py` and the
H.264 paths of `data/mp4.py`, `data/video.py` and `data/improc.py`) against
OpenCV's FFmpeg backend, x264's reconstruction and the JAX package's
helpers, on the clips libx264 wrote into `tests/torch_fixtures/h264/`
(`python tests/_torch_h264_fixtures.py`) and on streams written here:

- the demuxers (MP4 avc1 with its avcC, Matroska V_MPEG4/ISO/AVC, AVI H264
  in Annex B) find cv2's packets (as FFmpeg's mp4toannexb filter hands
  them to cv2) and its key frames;
- every frame's Y, U and V planes equal x264's reconstruction bit for bit
  and its luma equals FFmpeg's (`CAP_PROP_CONVERT_RGB` 0), on every size,
  container, coding tool and VUI; the RGB frames equal `cv2.VideoCapture`'s
  (the full-range and BT.709 VUI clips among them);
- each tool clip really uses its tool (read from its parameter sets and
  slice headers);
- `video_extents`, `video_fps`, `num_frames_of_video` and
  `imread('#frame=N')` equal JAX's (the NTSC rate within FPS_REL), also
  from the recovery points of an intra-refresh stream;
- frames read in order, through `iter_frames` or `predict_common`'s I/O
  pool, are each decoded once;
- interlaced coding, 4:0:0, 4:2:2, 4:4:4, bit depths above 8 and transform
  bypass (written by x264), FMO, redundant slices, ASO, SP and SI slices,
  data partitioning and SVC/MVC NAL units (written here by editing x264's
  streams), and container timing that disagrees with a B-frame stream's
  picture order raise UnsupportedVideo naming the tool (B slices themselves:
  tests/test_torch_h264_b.py).
"""

import hashlib
import json
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from _torch_h264_fixtures import (CASES, H264_DIR, TOOLS, VUIS, split_annexb, write_container,
                                  x264_encode)
from _torch_mp4v_fixtures import shifted_frames
from _torch_train import one_torch_thread  # noqa: F401 (fixture)
from metrabs_tpu.data import improc as jax_improc
from metrabs_tpu_torch.data import h264, improc, video

pytestmark = pytest.mark.usefixtures('one_torch_thread')

MANIFEST = json.loads((H264_DIR / 'manifest.json').read_text())
NAMES = [name for name, *_ in CASES]
FPS_REL = 1e-4  # cv2 reports the 30000/1001 clip as 29.97


def path_of(name: str) -> str:
    return str(H264_DIR / name)


def sha256(data) -> str:
    if isinstance(data, np.ndarray):
        data = np.ascontiguousarray(data).tobytes()
    return hashlib.sha256(data).hexdigest()


def decode_all(path: str):
    """(RGB, (Y, U, V)) of every frame through one decoder, in output order."""
    idx = video.index(path)
    decoder = idx.decoder(0)
    with open(path, 'rb') as f:
        frames = [out for i in range(idx.n_frames)
                  for out in decoder.decode(idx.packet(i, f), planes=True)]
    return frames + decoder.flush(planes=True)


def test_manifest_lists_every_fixture():
    on_disk = sorted(p.name for p in H264_DIR.iterdir() if p.suffix in ('.mp4', '.avi', '.mkv'))
    assert on_disk == sorted(NAMES) == sorted(MANIFEST)
    for name in NAMES:
        assert sha256((H264_DIR / name).read_bytes()) == MANIFEST[name]['file_sha256']


@pytest.mark.parametrize('name', NAMES)
def test_packets_and_key_frames_equal_cv2s(name):
    idx = video.index(path_of(name))
    entry = MANIFEST[name]
    assert idx.kind == 'h264' and idx.n_frames == entry['cv2']['frames_read']
    assert [sha256(h264.annexb(idx.packet(i), idx.config)) for i in range(idx.n_frames)] == \
        entry['packet_sha256']
    assert idx.keyframes.tolist() == entry['key_frames'] == entry['written']['key_frames']
    assert (idx.width, idx.height) == (entry['cv2']['width'], entry['cv2']['height'])


@pytest.mark.parametrize('name', NAMES)
def test_planes_equal_ffmpeg_and_x264_bit_for_bit(name):
    entry = MANIFEST[name]
    got = decode_all(path_of(name))
    assert [[sha256(p) for p in planes] for _, planes in got] == entry['recon_sha256']
    assert [sha256(planes[0]) for _, planes in got] == entry['luma_sha256']
    # cv2 gives the luma plane itself except where the VUI names BT.709.
    assert entry['luma_from'] == ('x264' if 'bt709' in name else 'cv2')


@pytest.mark.parametrize('name', NAMES)
def test_rgb_equals_videocapture(name):
    frames = list(video.iter_frames(path_of(name)))
    assert [sha256(f) for f in frames] == MANIFEST[name]['rgb_sha256']


@pytest.mark.parametrize('name', [n for n in NAMES if 'tool' not in n])
def test_metadata_and_imread_equal_jax(name):
    path = path_of(name)
    np.testing.assert_array_equal(improc.video_extents(path), jax_improc.video_extents(path))
    assert improc.video_fps(path) == pytest.approx(jax_improc.video_fps(path), rel=FPS_REL)
    assert improc.num_frames_of_video(path) == jax_improc.num_frames_of_video(path)
    for i in (13, 0, 11, 12, 5):  # backwards and forwards, across the GOP boundary
        np.testing.assert_array_equal(improc.imread(f'{path}#frame={i}'),
                                      jax_improc.imread(f'{path}#frame={i}'))
    with pytest.raises(FileNotFoundError):
        improc.imread(f'{path}#frame=14')


# --------------------------------------------------------------------------
# The tools each clip uses, read from its parameter sets and slice headers.

class Reader:
    def __init__(self, nal: bytes):
        rbsp = bytearray()
        zeros = 0
        for b in nal[1:]:
            if zeros >= 2 and b == 3:
                zeros = 0
                continue
            rbsp.append(b)
            zeros = zeros + 1 if b == 0 else 0
        self.bits = ''.join(f'{b:08b}' for b in rbsp)
        self.pos = 0

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


def nal_units(path: str):
    idx = video.index(path)
    for i in range(idx.n_frames):
        yield i, list(split_annexb(h264.annexb(idx.packet(i), idx.config)))


def stream_tools(path: str) -> dict:
    """What the first SPS, PPS and the slices of a clip say."""
    out = dict(slices_per_picture=0, recovery_points=0, slice_types=set(), i_after_first=0)
    sps = pps = None
    for i, nals in nal_units(path):
        slices = 0
        for nal in nals:
            kind = nal[0] & 31
            if kind == 7 and sps is None:
                r = Reader(nal)
                sps = dict(profile=r.u(8))
                r.u(16)
                r.ue()
                if sps['profile'] in (100, 110, 122, 244):
                    r.ue()
                    r.ue()
                    r.ue()
                    r.u(1)
                    sps['scaling'] = r.u(1)
                sps['log2_frame_num'] = r.ue() + 4
                sps['poc_type'] = r.ue()
                if sps['poc_type'] == 0:
                    sps['log2_poc'] = r.ue() + 4
                sps['max_refs'] = r.ue()
            elif kind == 8 and pps is None:
                r = Reader(nal)
                r.ue()
                r.ue()
                pps = dict(cabac=r.u(1))
                r.u(1)
                r.ue()
                r.ue()
                r.ue()
                pps['weighted'] = r.u(1)
                r.u(2)
                r.se()
                r.se()
                r.se()
                pps['deblocking_control'] = r.u(1)
                pps['constrained_intra'] = r.u(1)
                r.u(1)
                pps['transform_8x8'] = r.u(1) if r.pos < len(r.bits) - 8 else 0
                pps['scaling'] = r.u(1) if pps['transform_8x8'] or r.pos < len(r.bits) - 8 else 0
            elif kind == 6:
                out['recovery_points'] += nal[1] == 6
            elif kind in (1, 5):
                slices += 1
                r = Reader(nal)
                r.ue()
                slice_type = r.ue() % 5
                out['slice_types'].add(slice_type)
                out['i_after_first'] += i > 0 and slice_type == 2
        out['slices_per_picture'] = max(out['slices_per_picture'], slices)
    out.update(sps=sps, pps=pps)
    return out


TOOL_CHECKS = {
    'cavlc': lambda t: t['pps']['cabac'] == 0,
    'no_8x8dct': lambda t: t['pps']['cabac'] == 1 and t['pps']['transform_8x8'] == 0,
    'no_deblock': lambda t: t['pps']['deblocking_control'] == 1,
    'partitions_none': lambda t: t['pps']['transform_8x8'] == 1,
    'partitions_all': lambda t: t['pps']['transform_8x8'] == 1,
    'ref1': lambda t: t['sps']['max_refs'] == 1,
    'ref4': lambda t: t['sps']['max_refs'] == 4,
    'weightp0': lambda t: t['pps']['weighted'] == 0,
    'weightp2': lambda t: t['pps']['weighted'] == 1,
    'slices4': lambda t: t['slices_per_picture'] == 4,
    'intra_refresh': lambda t: t['recovery_points'] >= 2 and t['i_after_first'] == 0,
    'cqm_jvt': lambda t: t['sps'].get('scaling') == 1 or t['pps']['scaling'] == 1,
    'constrained_intra': lambda t: t['pps']['constrained_intra'] == 1,
    'deblock_offsets': lambda t: t['pps']['deblocking_control'] == 1,
    'baseline': lambda t: t['sps']['profile'] == 66 and t['pps']['cabac'] == 0,
    'main': lambda t: t['sps']['profile'] == 77 and t['pps']['cabac'] == 1,
}


@pytest.mark.parametrize('tool', list(TOOLS))
def test_each_tool_clip_uses_its_tool_and_decodes_exactly(tool):
    """The clip's parameter sets and slices show the tool (and the default
    clip does not), and its planes equal x264's and FFmpeg's."""
    name = f'h264_tool_{tool}.mp4'
    tools = stream_tools(path_of(name))
    assert TOOL_CHECKS[tool](tools), tools
    assert tools['slice_types'] <= {0, 2}  # I and P slices only
    got = decode_all(path_of(name))
    assert [sha256(p[0]) for _, p in got] == MANIFEST[name]['luma_sha256']
    assert [[sha256(x) for x in p] for _, p in got] == MANIFEST[name]['recon_sha256']


@pytest.mark.parametrize('vui', list(VUIS))
def test_vui_clips_convert_as_cv2(vui):
    """The full-range flag and the matrix move cv2's RGB (the same planes),
    and the port's RGB moves with them."""
    name = f'h264_vui_{vui}.mp4'
    plain = MANIFEST['h264_vui_unspecified.mp4']
    rgb = [sha256(f) for f in video.iter_frames(path_of(name))]
    assert rgb == MANIFEST[name]['rgb_sha256']
    if vui in ('fullrange', 'bt709', 'bt709_fullrange'):
        assert MANIFEST[name]['recon_sha256'] == plain['recon_sha256']
        assert rgb != plain['rgb_sha256']


def test_random_access_from_recovery_points():
    """An intra-refresh stream (no IDR after its first frame): frames past a
    recovery point decode from it exactly, the ones before from the start."""
    path = path_of('h264_tool_intra_refresh.mp4')
    idx = video.index(path)
    recovering = [row for row in idx.entries if row[2]]
    assert recovering and all(start > 0 and exact >= start for start, exact, _ in recovering)
    want = MANIFEST['h264_tool_intra_refresh.mp4']['rgb_sha256']
    for i in (13, 7, 3, 12):
        video._STREAMS.clear()
        assert sha256(improc.imread(f'{path}#frame={i}')) == want[i]
    video._STREAMS.clear()
    before = h264.frames_decoded()
    improc.imread(f'{path}#frame=13')
    start, _ = idx.entry_for(13)
    assert start > 0 and h264.frames_decoded() - before == 14 - start


def test_one_decode_per_frame_in_order(monkeypatch):
    name = 'h264_320x568.mkv'
    path = path_of(name)
    n = MANIFEST[name]['cv2']['frames_read']
    before = h264.frames_decoded()
    assert len(list(video.iter_frames(path))) == n
    assert h264.frames_decoded() - before == n
    parse = video._index_matroska

    def slow_parse(*args):
        time.sleep(0.05)
        return parse(*args)

    monkeypatch.setattr(video, '_index_matroska', slow_parse)
    video._STREAMS.clear()
    video._INDEX_CACHE.clear()
    before = h264.frames_decoded()
    with ThreadPoolExecutor(8) as pool:
        frames = list(pool.map(improc.imread, [f'{path}#frame={i}' for i in range(n)]))
    assert h264.frames_decoded() - before == n
    assert [sha256(f) for f in frames] == MANIFEST[name]['rgb_sha256']


# --------------------------------------------------------------------------
# Refusals

def write_annexb_avi(path, packets, size, keys=None) -> str:
    with open(path, 'wb') as f:
        mux = video._AviMuxer(f, size[0], size[1], 25.0, b'H264')
        for k, packet in enumerate(packets):
            mux.write(packet, keys[k] if keys else k == 0)
        mux.close()
    return str(path)


SMALL = (48, 32)


@pytest.mark.parametrize('what, options, csp, depth', [
    ('interlaced coding', {'interlaced': 1}, 'i420', 8),
    ('4:0:0', {}, 'i400', 8),
    ('4:2:2', {}, 'i422', 8),
    ('4:4:4', {}, 'i444', 8),
    ('bit depths above 8', {}, 'i420', 10),
    ('transform bypass', {'qp': 0}, 'i420', 8),
])
def test_tools_x264_writes_raise_naming_them(tmp_path, what, options, csp, depth):
    packets, keys, _ = x264_encode(shifted_frames(4, SMALL), options, 25.0, csp=csp, depth=depth)
    path = write_annexb_avi(tmp_path / 'clip.avi', packets, SMALL, keys)
    with pytest.raises(video.UnsupportedVideo, match=what):
        list(video.iter_frames(path))


def rbsp_bits(nal: bytes) -> str:
    return Reader(nal).bits


def nal_from_bits(header: int, bits: str) -> bytes:
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


def rewrite(nal: bytes, edit) -> bytes:
    """The NAL unit with its RBSP's bits edited (the stop bit dropped first)."""
    bits = rbsp_bits(nal).rstrip('0')[:-1]
    return nal_from_bits(nal[0], edit(bits))


def edit_pps(bits: str, field: str) -> str:
    r = Reader(b'\x00')
    r.bits, r.pos = bits, 0
    r.ue()
    r.ue()
    r.u(2)
    at = r.pos  # num_slice_groups_minus1
    if field == 'fmo':
        return bits[:at] + ue_bits(1) + ue_bits(0) + ue_bits(0) + ue_bits(0) + bits[at + 1:]
    r.ue()
    r.ue()
    r.ue()
    r.u(3)
    r.se()
    r.se()
    r.se()
    r.u(2)
    at = r.pos  # redundant_pic_cnt_present_flag
    return bits[:at] + '1' + bits[at + 1:]


def edit_slice_type(bits: str, slice_type: int) -> str:
    r = Reader(b'\x00')
    r.bits, r.pos = bits, 0
    r.ue()
    start = r.pos
    r.ue()
    return bits[:start] + ue_bits(slice_type) + bits[r.pos:]


def crafted(kind: str, packets):
    """x264's packets edited into a stream with the tool."""
    out = [list(split_annexb(p)) for p in packets]
    sc = b'\x00\x00\x00\x01'
    if kind in ('FMO', 'redundant slices'):
        field = 'fmo' if kind == 'FMO' else 'redundant'
        out[0] = [rewrite(n, lambda b: edit_pps(b, field)) if n[0] & 31 == 8 else n
                  for n in out[0]]
    elif kind in ('SP slices', 'SI slices'):
        t = 3 if kind == 'SP slices' else 4
        out[1] = [rewrite(n, lambda b: edit_slice_type(b, t)) if n[0] & 31 == 1 else n
                  for n in out[1]]
    elif kind == 'data partitioning':
        out[1] = [bytes([(n[0] & 0xE0) | 2]) + n[1:] if n[0] & 31 == 1 else n for n in out[1]]
    elif kind == 'SVC and MVC NAL units':
        out[1] = [bytes([0x6E, 0x80, 0x00, 0x00])] + out[1]  # a prefix NAL unit (type 14)
    elif kind == 'ASO':
        slices = [n for n in out[1] if n[0] & 31 == 1]
        others = [n for n in out[1] if n[0] & 31 != 1]
        out[1] = others + slices[::-1]
    return [b''.join(sc + n for n in nals) for nals in out]


@pytest.mark.parametrize('kind', ['FMO', 'redundant slices', 'SP slices', 'SI slices',
                                  'data partitioning', 'SVC and MVC NAL units', 'ASO'])
def test_crafted_tools_raise_naming_them(tmp_path, kind):
    options = {'slices': 4} if kind == 'ASO' else {}
    packets, keys, _ = x264_encode(shifted_frames(3, (48, 64)), options, 25.0)
    plain = write_annexb_avi(tmp_path / 'plain.avi', packets, (48, 64), keys)
    assert len(list(video.iter_frames(plain))) == 3  # the stream before the edit decodes
    path = write_annexb_avi(tmp_path / 'clip.avi', crafted(kind, packets), (48, 64), keys)
    with pytest.raises(video.UnsupportedVideo, match=kind):
        list(video.iter_frames(path))


@pytest.mark.parametrize('ext', ['.mp4', '.mkv'])
def test_b_frame_timing_in_mp4_raises(tmp_path, ext):
    """A B-frame stream whose container timing disagrees with its picture
    order counts raises at indexing: an MP4 ctts, or Matroska block
    timestamps, that put its frames in decoding order (FFmpeg outputs them
    in picture order, and cv2 would number them by the other)."""
    times = []
    packets, keys, _ = x264_encode(shifted_frames(4, SMALL), {'bframes': 2, 'b-adapt': 0}, 25.0,
                                   times=times)
    assert [pts for pts, _ in times] != sorted(pts for pts, _ in times)  # B slices reorder
    in_decoding_order = [(k, dts) for k, (_, dts) in enumerate(times)]
    path = tmp_path / f'clip{ext}'
    write_container(path, packets, keys, SMALL, 25.0, 'h264', times=in_decoding_order)
    with pytest.raises(video.UnsupportedVideo, match='ctts' if ext == '.mp4' else 'timestamps'):
        video.index(str(path))
    write_container(path, packets, keys, SMALL, 25.0, 'h264', times=times)
    video._INDEX_CACHE.clear()
    assert len(list(video.iter_frames(str(path)))) == 4
