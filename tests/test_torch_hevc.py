"""The port's HEVC layer (`csrc/hevc_decode.cpp`, `data/hevc.py` and the
HEVC paths of `data/mp4.py`, `data/video.py` and `data/improc.py`) against
OpenCV's FFmpeg backend, libde265 and the JAX package's helpers, on the
clips libx265 wrote into `tests/torch_fixtures/hevc/` (`python
tests/_torch_hevc_fixtures.py`) and on streams written here:

- the demuxers (MP4 hvc1 and hev1 with the hvcC, Matroska
  V_MPEGH/ISO/HEVC, AVI HEVC in Annex B under each FourCC cv2 reads as
  HEVC) find cv2's packets (as FFmpeg's hevc_mp4toannexb filter hands them
  to cv2) and its key frames;
- every frame's luma equals FFmpeg's (`CAP_PROP_CONVERT_RGB` 0) and its Y,
  U and V planes libde265's, bit for bit, on every size, container and
  coding tool; the RGB frames equal `cv2.VideoCapture`'s (the full-range
  and BT.709 clips among them);
- each tool clip really uses its tool (read from its parameter sets and
  slice headers), and the default clip does not;
- every decoded-picture hash SEI verifies (x265's CRC of a chroma plane
  covers its last CTU row only: shown on a one-row stream);
- `video_extents`, `video_fps`, `num_frames_of_video` and
  `imread('#frame=N')` equal JAX's and cv2's seek for every N;
- frames read in order, through `iter_frames` or 8 threads, are each
  decoded once, and random access starts at the last IRAP picture;
- 4:0:0, 4:2:2, 4:4:4 and bit depth 12 (written by x265), unequal luma
  and chroma bit depths, PCM, long-term references, tiles, dependent slice
  segments and field coding (written here by editing x265's parameter sets)
  raise UnsupportedVideo naming the tool (10-bit streams decode:
  tests/test_torch_hevc10.py).
"""

import hashlib
import json
import random
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from _torch_hevc_fixtures import (CASES, HEVC_DIR, PPS, SPS, TOOLS, edit_parameter_set,
                                  hevc_frames, nal_type, split_annexb, stream_fields, x265_encode)
from _torch_mp4v_fixtures import shifted_frames
from _torch_train import one_torch_thread  # noqa: F401 (fixture)
from metrabs_tpu.data import improc as jax_improc
from metrabs_tpu_torch.data import hevc, improc, video

pytestmark = pytest.mark.usefixtures('one_torch_thread')

MANIFEST = json.loads((HEVC_DIR / 'manifest.json').read_text())
NAMES = [name for name, *_ in CASES]
FPS_REL = 1e-4  # cv2 reports the 30000/1001 clip as 29.97


def path_of(name: str) -> str:
    return str(HEVC_DIR / name)


def sha256(data) -> str:
    if isinstance(data, np.ndarray):
        data = np.ascontiguousarray(data).tobytes()
    return hashlib.sha256(data).hexdigest()


def decode_all(path: str):
    """(RGB, (Y, U, V)) of every frame through one decoder, in output order,
    and the decoder's hash counts."""
    idx = video.index(path)
    decoder = idx.decoder(0)
    with open(path, 'rb') as f:
        frames = [out for i in range(idx.n_frames)
                  for out in decoder.decode(idx.packet(i, f), planes=True)]
    frames += decoder.flush(planes=True)
    return frames, decoder.hashes


def annexb_packets(path: str):
    idx = video.index(path)
    return [hevc.annexb(idx.packet(i), idx.config) for i in range(idx.n_frames)]


def test_manifest_lists_every_fixture():
    on_disk = sorted(p.name for p in HEVC_DIR.iterdir() if p.suffix in ('.mp4', '.avi', '.mkv'))
    assert on_disk == sorted(NAMES) == sorted(MANIFEST)
    for name in NAMES:
        assert sha256((HEVC_DIR / name).read_bytes()) == MANIFEST[name]['file_sha256']


@pytest.mark.parametrize('name', NAMES)
def test_packets_and_key_frames_equal_cv2s(name):
    idx = video.index(path_of(name))
    entry = MANIFEST[name]
    assert idx.kind == 'hevc' and idx.n_frames == entry['cv2']['frames_read']
    assert [sha256(p) for p in annexb_packets(path_of(name))] == entry['packet_sha256']
    assert idx.keyframes.tolist() == entry['key_frames'] == entry['written']['key_frames']
    assert (idx.width, idx.height) == (entry['cv2']['width'], entry['cv2']['height'])


@pytest.mark.parametrize('name', NAMES)
def test_planes_equal_ffmpeg_and_libde265_bit_for_bit(name):
    entry = MANIFEST[name]
    got, _ = decode_all(path_of(name))
    assert [[sha256(p) for p in planes] for _, planes in got] == entry['de265_sha256']
    assert [sha256(planes[0]) for _, planes in got] == entry['luma_sha256']
    # cv2 gives the luma plane itself except where the VUI names BT.709.
    assert entry['luma_from'] == ('libde265' if 'bt709' in name else 'cv2')


@pytest.mark.parametrize('name', NAMES)
def test_rgb_equals_videocapture(name):
    frames = list(video.iter_frames(path_of(name)))
    assert [sha256(f) for f in frames] == MANIFEST[name]['rgb_sha256']


@pytest.mark.parametrize('name', NAMES)
def test_every_seek_equals_cv2s(name):
    """imread('#frame=N') for every N up to two past the last frame, as
    cv2's CAP_PROP_POS_FRAMES seek (JAX's imread) answered it."""
    path = path_of(name)
    entry = MANIFEST[name]
    video._STREAMS.clear()
    for n, want in enumerate(entry['seek']):
        if want < 0:
            with pytest.raises(FileNotFoundError):
                improc.imread(f'{path}#frame={n}')
        else:
            assert sha256(improc.imread(f'{path}#frame={n}')) == entry['rgb_sha256'][want]


@pytest.mark.parametrize('name', [n for n in NAMES if 'tool' not in n])
def test_metadata_and_imread_equal_jax(name):
    path = path_of(name)
    np.testing.assert_array_equal(improc.video_extents(path), jax_improc.video_extents(path))
    assert improc.video_fps(path) == pytest.approx(jax_improc.video_fps(path), rel=FPS_REL)
    assert improc.num_frames_of_video(path) == jax_improc.num_frames_of_video(path)
    for i in (13, 0, 11, 12, 5):  # backwards and forwards, across the GOP boundary
        np.testing.assert_array_equal(improc.imread(f'{path}#frame={i}'),
                                      jax_improc.imread(f'{path}#frame={i}'))


# --------------------------------------------------------------------------
# The tool each clip uses, read from its parameter sets and slice headers.

def _p_slices(f):
    return [s for packet in f['slices'] for s in packet if s['type'] == 1]


TOOL_CHECKS = {
    'ctu16': lambda f: f['sps']['log2_ctb'] == 4,
    'ctu32': lambda f: f['sps']['log2_ctb'] == 5 and f['pps']['wpp'],
    'max_tu4': lambda f: f['sps']['log2_max_tb'] == 2,
    'max_tu8': lambda f: f['sps']['log2_max_tb'] == 3,
    # depth 4 below a 64x64 CTB reaches the 4x4 TBs at 3
    'tu_depth4': lambda f: (f['sps']['max_th_depth_inter'], f['sps']['max_th_depth_intra']) == (3, 3),
    'amp_rect': lambda f: f['sps']['amp'],
    'tskip': lambda f: f['pps']['transform_skip'],
    'lossless': lambda f: f['pps']['transquant_bypass'],
    'cu_lossless': lambda f: f['pps']['transquant_bypass'],
    'scaling_default': lambda f: f['sps']['scaling_list'] and not f['pps']['scaling_list_data'],
    'signhide0': lambda f: not f['pps']['sign_hiding'],
    'no_sao': lambda f: not f['sps']['sao'],
    # x265 chooses the offsets from samples before deblocking: nothing in the
    # headers tells it, but SAO is on (ENCODER_SIDE)
    'sao_non_deblock': lambda f: f['sps']['sao'],
    'deblock_offsets': lambda f: (f['pps']['tc_offset'], f['pps']['beta_offset']) == (-6, 4),
    'no_deblock': lambda f: f['pps']['deblocking_disabled'],
    'tmvp0': lambda f: not f['sps']['temporal_mvp'],
    'max_merge1': lambda f: {s['max_merge'] for s in _p_slices(f)} == {1},
    'max_merge5': lambda f: {s['max_merge'] for s in _p_slices(f)} == {5},
    'ref1': lambda f: {s['num_ref_idx'] for s in _p_slices(f)} == {1},
    'ref4': lambda f: max(s['num_ref_idx'] for s in _p_slices(f)) == 4,
    'slices4': lambda f: max(len(p) for p in f['slices']) == 4,
    'no_wpp': lambda f: f['sps']['log2_ctb'] == 5 and not f['pps']['wpp'],
    'constrained_intra': lambda f: f['pps']['constrained_intra'],
    'strong_intra0': lambda f: not f['sps']['strong_intra_smoothing'],
    'qg8_chroma_offsets': lambda f: (f['sps']['log2_ctb'] - f['pps']['diff_cu_qp_delta_depth'],
                                     f['pps']['cb_qp_offset'], f['pps']['cr_qp_offset']) == (3, 3, -2),
    # x265 weighs most P slices of a fade, and few others
    'weightp': lambda f: f['pps']['weighted_pred'] and sum(s['weights'] for s in _p_slices(f)) >= 8,
    'open_gop': lambda f: [p[0]['nal_type'] for p in f['slices']].count(21) == 2,
    'closed_gop': lambda f: [p[0]['nal_type'] for p in f['slices']][12] in (19, 20),
    'fullrange_bt709': lambda f: (f['sps']['full_range'], f['sps']['matrix']) == (1, 1),
    'bt709': lambda f: (f['sps']['full_range'], f['sps']['matrix']) == (0, 1),
    'hash1': lambda f: f['hash_type'] == 0,
    'hash2': lambda f: f['hash_type'] == 1,
    'hash3': lambda f: f['hash_type'] == 2,
}


ENCODER_SIDE = ('sao_non_deblock',)


@pytest.mark.parametrize('tool', list(TOOLS))
def test_each_tool_clip_uses_its_tool(tool):
    """The clip's parameter sets and slices show the tool, the default
    clip's (x265's medium preset at 96x66, without a hash SEI) do not, and
    the clip has I and P slices only."""
    fields = stream_fields(annexb_packets(path_of(f'hevc_tool_{tool}.mp4')))
    assert TOOL_CHECKS[tool](fields), fields
    default = stream_fields(annexb_packets(path_of('hevc_96x66.avi')))
    assert tool in ENCODER_SIDE or not TOOL_CHECKS[tool](default)
    assert {s['type'] for p in fields['slices'] for s in p} <= {1, 2}


@pytest.mark.parametrize('name', [n for n in NAMES if MANIFEST[n]['written']['hash_type'] is not None])
def test_hash_seis_verify(name):
    """Every picture's hash SEI is checked. MD5 and the checksum verify on
    every plane; x265's CRC verifies on the luma plane, and on the chroma
    planes it covers their last CTU row only (see the next test)."""
    _, (checked, failed) = decode_all(path_of(name))
    n = MANIFEST[name]['cv2']['frames_read']
    assert checked == (n, n, n)
    assert failed == ((0, n, n) if MANIFEST[name]['written']['hash_type'] == 1 else (0, 0, 0))


def test_x265_crc_of_chroma_covers_its_last_ctu_row(tmp_path):
    """On a picture of one CTU row (96x64) x265's CRC is the standard's, and
    it verifies on every plane."""
    packets, keys = x265_encode(shifted_frames(3, (96, 64)), {'hash': 2}, 25.0)
    decoder = hevc.Decoder()
    for packet in packets:
        decoder.decode(packet)
    decoder.flush()
    assert decoder.hashes == ((3, 3, 3), (0, 0, 0))


# --------------------------------------------------------------------------
# Random access and decoding each picture once

def test_entry_points_are_the_irap_pictures():
    """CRA pictures (x265's open GOP) are entry points: frame 13 decodes
    from the CRA at packet 12, frame 7 from the one at 6."""
    name = 'hevc_tool_open_gop.mp4'
    path = path_of(name)
    idx = video.index(path)
    assert [s for s, _, _ in idx.entries] == [0, 6, 12]
    want = MANIFEST[name]['rgb_sha256']
    for frame, start in ((13, 12), (7, 6), (3, 0)):
        video._STREAMS.clear()
        before = hevc.frames_decoded()
        assert sha256(improc.imread(f'{path}#frame={frame}')) == want[frame]
        assert hevc.frames_decoded() - before == frame + 1 - start


def test_one_decode_per_frame_in_order():
    name = 'hevc_320x568.mkv'
    path = path_of(name)
    n = MANIFEST[name]['cv2']['frames_read']
    before = hevc.frames_decoded()
    assert len(list(video.iter_frames(path))) == n
    assert hevc.frames_decoded() - before == n
    video._STREAMS.clear()
    video._INDEX_CACHE.clear()
    before = hevc.frames_decoded()
    with ThreadPoolExecutor(8) as pool:
        frames = list(pool.map(improc.imread, [f'{path}#frame={i}' for i in range(n)]))
    assert hevc.frames_decoded() - before == n
    assert [sha256(f) for f in frames] == MANIFEST[name]['rgb_sha256']


def test_random_access_from_8_threads():
    name = 'hevc_320x568.mp4'
    path = path_of(name)
    order = [i for i in range(14) for _ in range(2)]
    random.Random(0).shuffle(order)
    video._STREAMS.clear()
    with ThreadPoolExecutor(8) as pool:
        frames = list(pool.map(improc.imread, [f'{path}#frame={i}' for i in order]))
    want = MANIFEST[name]['rgb_sha256']
    assert [sha256(f) for f in frames] == [want[i] for i in order]


@pytest.mark.parametrize('fourcc', ['HEVC', 'h265', 'Hvc1', 'hev1'])
def test_avi_fourccs_cv2_reads_as_hevc(tmp_path, fourcc):
    data = bytearray((HEVC_DIR / 'hevc_96x66.avi').read_bytes())
    assert data.count(b'HEVC') == 2  # strh fccHandler and strf biCompression
    path = tmp_path / 'clip.avi'
    path.write_bytes(bytes(data).replace(b'HEVC', fourcc.encode()))
    assert video.index(str(path)).kind == 'hevc'
    assert [sha256(f) for f in video.iter_frames(str(path))] == \
        MANIFEST['hevc_96x66.avi']['rgb_sha256']


# --------------------------------------------------------------------------
# Refusals

SMALL = (64, 64)  # x265's smallest picture: one CTU


def write_annexb_avi(path, packets, keys) -> str:
    with open(path, 'wb') as f:
        mux = video._AviMuxer(f, SMALL[0], SMALL[1], 25.0, b'HEVC')
        for packet, key in zip(packets, keys):
            mux.write(packet, key)
        mux.close()
    return str(path)


@pytest.mark.parametrize('what, options, csp, depth', [
    ('4:0:0', {}, 'i400', 8),
    ('4:2:2', {}, 'i422', 8),
    ('4:4:4', {}, 'i444', 8),
    ('bit depth 12', {}, 'i420', 12),  # x265's 12-bit API (Main 12)
])
def test_tools_x265_writes_raise_naming_them(tmp_path, what, options, csp, depth):
    packets, keys = x265_encode(hevc_frames(6, SMALL), options, 25.0, csp=csp, depth=depth)
    path = write_annexb_avi(tmp_path / 'clip.avi', packets, keys)
    with pytest.raises(video.UnsupportedVideo, match=what):
        list(video.iter_frames(path))


# (what the error names, parameter set, field position, the bits put there,
# the bits they replace)
CRAFTED = {
    # bit_depth_luma_minus8 2 under 8-bit chroma
    'unequal luma and chroma bit depths': (SPS, 'at_bit_depth', '011', 1),
    'PCM coding units': (SPS, 'at_pcm', '1', 1),
    'long-term reference pictures': (SPS, 'at_long_term_refs', '1', 1),
    'field coding': (SPS, 'at_field_seq', '1', 1),
    'tiles': (PPS, 'at_tiles', '1', 1),
    'dependent slice segments': (PPS, 'at_dependent_slices', '1', 1),
}


@pytest.mark.parametrize('what', list(CRAFTED))
def test_crafted_tools_raise_naming_them(tmp_path, what):
    kind, at, value, width = CRAFTED[what]
    packets, keys = x265_encode(hevc_frames(2, SMALL), {}, 25.0)
    edited = edit_parameter_set(packets, kind, at, value, width)
    assert edited != packets
    assert [nal_type(n) for n in split_annexb(edited[0])][:3] == [32, 33, 34]
    path = write_annexb_avi(tmp_path / 'clip.avi', edited, keys)
    with pytest.raises(video.UnsupportedVideo, match=what):
        list(video.iter_frames(path))
