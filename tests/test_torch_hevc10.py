"""The port's HEVC Main 10 decoding (`csrc/hevc_decode.cpp` at 9 and 10 bits,
`csrc/yuv_rgb.h`'s 16-bit scaler path, the uint16 planes of
`data/native_video.py`) against libde265, OpenCV's FFmpeg backend and the
JAX package's helpers, on the clips x265's 10-bit API wrote into
`tests/torch_fixtures/hevc10/` (`python tests/_torch_hevc_fixtures.py 10`):

- every picture's Y, U and V equal libde265's bit for bit (cv2 gives no
  plane of a 10-bit stream), at both sizes, with and without B slices, in
  MP4, a phone's QuickTime .mov, Matroska and AVI, and with each tool;
- every decoded-picture hash SEI (MD5, CRC, checksum over two bytes per
  sample) verifies;
- the RGB frames equal `cv2.VideoCapture`'s bit for bit (swscale's scaler
  path from 16-bit planes at every height), with BT.601, BT.709, BT.2020
  and full range;
- the demuxers find cv2's packets and key frames, Dolby Vision RPU NAL units
  (type 62) included, which the decoder skips as FFmpeg does;
- `video_extents`, `video_fps`, `num_frames_of_video` and
  `imread('#frame=N')` equal JAX's and cv2's seek for every N, and the
  phone's clip (1920x1080 stored, turned by 90 degrees) reads as JAX reads
  it: 1080 wide;
- each tool clip uses its tool; 4:2:2 at 10 bits raises naming it.
"""

import hashlib
import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from _torch_hevc_fixtures import (CASES10, HEVC10_DIR, PHONE, TOOLS10, hevc_frames, stream_fields,
                                  x265_encode)
from _torch_train import one_torch_thread  # noqa: F401 (fixture)
from metrabs_tpu.data import improc as jax_improc
from metrabs_tpu_torch.data import hevc, improc, video

pytestmark = pytest.mark.usefixtures('one_torch_thread')

MANIFEST = json.loads((HEVC10_DIR / 'manifest.json').read_text())
NAMES = [name for name, *_ in CASES10]
FPS_REL = 1e-4  # cv2 reports the 30000/1001 clips as 29.97
# Fault F11 (ROADMAP.md §3): where the VUI names BT.2020 primaries and the
# HLG transfer (an iPhone's HDR), cv2's FFmpeg maps them to its RGB's
# colours, which the port does not: the port converts the matrix only, as
# FFmpeg does for BT.709 or unspecified primaries and SDR transfers. Per
# clip: (max |port - cv2|, pixels that differ, of all pixels).
CV2_MAPS_COLOURS = {'hevc10_tool_bt2020_hlg.mp4': (132, 88704, 88704)}
MATCHED = [n for n in NAMES if n not in CV2_MAPS_COLOURS]


def path_of(name: str) -> str:
    return str(HEVC10_DIR / name)


def sha256(data) -> str:
    if isinstance(data, np.ndarray):
        data = np.ascontiguousarray(data).tobytes()
    return hashlib.sha256(data).hexdigest()


def decode_all(path: str):
    """(RGB, (Y, U, V)) of every picture through one decoder, in output
    order (as stored: not turned), and the decoder's hash counts."""
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
    on_disk = sorted(p.name for p in HEVC10_DIR.iterdir() if p.name != 'manifest.json')
    assert on_disk == sorted(NAMES) == sorted(MANIFEST)
    for name in NAMES:
        assert sha256((HEVC10_DIR / name).read_bytes()) == MANIFEST[name]['file_sha256']
        assert MANIFEST[name]['written']['bit_depth'] == [10, 10]


@pytest.mark.parametrize('name', NAMES)
def test_packets_and_key_frames_equal_cv2s(name):
    idx = video.index(path_of(name))
    entry = MANIFEST[name]
    assert idx.kind == 'hevc' and idx.n_frames == entry['cv2']['frames_read']
    assert [sha256(p) for p in annexb_packets(path_of(name))] == entry['packet_sha256']
    assert idx.keyframes.tolist() == entry['key_frames'] == entry['written']['key_frames']
    assert idx.displayed_size == (entry['cv2']['width'], entry['cv2']['height'])


@pytest.mark.parametrize('name', NAMES)
def test_planes_equal_libde265_bit_for_bit(name):
    """Every picture's planes equal libde265's, but where libde265's go
    wrong (a few B pictures): there they equal the stream's own MD5 SEI,
    which the manifest shows libde265's do not."""
    got, _ = decode_all(path_of(name))
    entry = MANIFEST[name]
    assert len(got) == len(entry['de265_sha256'])
    assert all(p.dtype == np.uint16 and p.max() < 1024 for _, planes in got for p in planes)
    for (_, planes), de265, md5, verified in zip(got, entry['de265_sha256'], entry['sei_md5'],
                                                 entry['de265_verified']):
        if verified is False:
            assert [hashlib.md5(p.tobytes()).hexdigest() for p in planes] == md5
        else:
            assert [sha256(p) for p in planes] == de265


@pytest.mark.parametrize('name', MATCHED)
def test_rgb_equals_videocapture(name):
    frames = list(video.iter_frames(path_of(name)))
    assert [sha256(f) for f in frames] == MANIFEST[name]['rgb_sha256']


@pytest.mark.parametrize('name', list(CV2_MAPS_COLOURS))
def test_f11_cv2_maps_hdr_colours(name):
    """F11, pinned: on a clip whose VUI names BT.2020 primaries and HLG the
    port's frames differ from cv2's by exactly the recorded residue (every
    pixel), while its planes equal libde265's (above) and its frames of the
    same stream under the BT.2020 matrix alone equal cv2's."""
    import cv2
    path = path_of(name)
    port = list(video.iter_frames(path))
    cap = cv2.VideoCapture(path)
    cv2_frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        cv2_frames.append(frame[..., ::-1])
    cap.release()
    assert [sha256(f) for f in cv2_frames] == MANIFEST[name]['rgb_sha256']
    diff = np.stack([np.abs(a.astype(int) - b) for a, b in zip(port, cv2_frames)]).max(-1)
    assert (int(diff.max()), int((diff > 0).sum()), diff.size) == CV2_MAPS_COLOURS[name]
    plain = MANIFEST['hevc10_tool_bt2020.mp4']
    assert plain['written']['x265'] == {'colormatrix': 'bt2020nc'}


@pytest.mark.parametrize('name', MATCHED)
def test_every_seek_equals_cv2s(name):
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
    for i in (13, 0, 11, 5):
        np.testing.assert_array_equal(improc.imread(f'{path}#frame={i}'),
                                      jax_improc.imread(f'{path}#frame={i}'))


@pytest.mark.parametrize('name', [n for n in NAMES if MANIFEST[n]['written']['hash_type'] is not None])
def test_hash_seis_verify(name):
    """Every picture's hash SEI is checked over two bytes per sample. MD5 and
    the checksum verify on every plane; x265's CRC of a chroma plane covers
    its last CTU row only (tests/test_torch_hevc.py), so at 96x66 it fails
    there, as at 8 bits."""
    _, (checked, failed) = decode_all(path_of(name))
    n = MANIFEST[name]['cv2']['frames_read']
    assert checked == (n, n, n)
    assert failed == ((0, n, n) if MANIFEST[name]['written']['hash_type'] == 1 else (0, 0, 0))


def test_x265_crc_at_10_bits_verifies_on_one_ctu_row():
    """On a picture of one CTU row (96x64) x265's CRC over both bytes of each
    sample is the standard's, and it verifies on every plane."""
    packets, _ = x265_encode(hevc_frames(3, (96, 64)), {'hash': 2}, 25.0, depth=10)
    decoder = hevc.Decoder()
    for packet in packets:
        decoder.decode(packet)
    decoder.flush()
    assert decoder.hashes == ((3, 3, 3), (0, 0, 0))


def test_the_phones_clip_reads_as_jax_reads_it():
    """1920x1080 Main 10 stored, turned by 90 degrees in the track header:
    1080 wide and 1920 high as displayed, as JAX (cv2) reads it, every frame
    with JAX's pixels."""
    path = path_of(PHONE)
    idx = video.index(path)
    assert (idx.width, idx.height, idx.rotation) == (1920, 1080, 90)
    assert tuple(improc.video_extents(path)) == tuple(jax_improc.video_extents(path)) == (1080, 1920)
    entry = MANIFEST[PHONE]
    assert entry['cv2']['orientation'] == 90 and entry['written']['x265']['colormatrix'] == 'bt2020nc'
    for i in (23, 0, 12):
        got = improc.imread(f'{path}#frame={i}')
        assert got.shape == (1920, 1080, 3)
        np.testing.assert_array_equal(got, jax_improc.imread(f'{path}#frame={i}'))


def test_b_in_order_reads_decode_each_picture_once():
    name = 'hevc10b_320x568.mkv'
    path = path_of(name)
    n = MANIFEST[name]['cv2']['frames_read']
    video._STREAMS.clear()
    before = hevc.frames_decoded()
    assert [sha256(improc.imread(f'{path}#frame={i}')) for i in range(n)] == \
        MANIFEST[name]['rgb_sha256']
    assert hevc.frames_decoded() - before == n
    before = hevc.frames_decoded()
    assert len(list(video.iter_frames(path))) == n
    assert hevc.frames_decoded() - before == n


def test_one_decode_per_frame_in_order():
    name = 'hevc10_320x568.mkv'
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


# --------------------------------------------------------------------------
# The tool each clip uses, read from its parameter sets and slice headers.

def _slices(f, kind):
    return [s for packet in f['slices'] for s in packet if s['type'] == kind]


TOOL_CHECKS = {
    'no_sao': lambda f: not f['sps']['sao'],
    'crf8': lambda f: f['bytes'] > 6000,  # the default clip's are 3381
    'weightp': lambda f: f['pps']['weighted_pred'] and sum(s['weights'] for s in _slices(f, 1)) >= 8,
    'weightb': lambda f: f['pps']['weighted_bipred'] and any(s['weights'] for s in _slices(f, 0)),
    'strong_intra0': lambda f: not f['sps']['strong_intra_smoothing'],
    'tskip': lambda f: f['pps']['transform_skip'],
    'signhide0': lambda f: not f['pps']['sign_hiding'],
    'amp_rect': lambda f: f['sps']['amp'],
    'no_wpp': lambda f: f['sps']['log2_ctb'] == 5 and not f['pps']['wpp'],
    'lossless': lambda f: f['pps']['transquant_bypass'],
    'qg8_chroma_offsets': lambda f: (f['sps']['log2_ctb'] - f['pps']['diff_cu_qp_delta_depth'],
                                     f['pps']['cb_qp_offset'], f['pps']['cr_qp_offset']) == (3, 3, -2),
    'bt2020': lambda f: (f['sps']['full_range'], f['sps']['matrix']) == (0, 9),
    'bt2020_hlg': lambda f: (f['sps']['full_range'], f['sps']['matrix']) == (0, 9),
    'fullrange_bt709': lambda f: (f['sps']['full_range'], f['sps']['matrix']) == (1, 1),
    'dovi_rpu': lambda f: True,  # the NAL units: test_dolby_vision_rpus_are_skipped
    'hash1': lambda f: f['hash_type'] == 0,
    'hash2': lambda f: f['hash_type'] == 1,
    'hash3': lambda f: f['hash_type'] == 2,
}


@pytest.mark.parametrize('tool', list(TOOLS10))
def test_each_tool_clip_uses_its_tool(tool):
    packets = annexb_packets(path_of(f'hevc10_tool_{tool}.mp4'))
    fields = dict(stream_fields(packets), bytes=sum(map(len, packets)))
    assert fields['sps']['bit_depth'] == (10, 10)
    assert TOOL_CHECKS[tool](fields), fields
    packets = annexb_packets(path_of('hevc10_96x66.avi'))
    default = dict(stream_fields(packets), bytes=sum(map(len, packets)))
    assert tool == 'dovi_rpu' or not TOOL_CHECKS[tool](default)


def test_dolby_vision_rpus_are_skipped():
    """The RPU clip and the phone's carry a NAL unit of type 62 last in every
    access unit (cv2's packets hold it); their pictures equal libde265's and
    their frames cv2's (the tests above)."""
    from _torch_h264_fixtures import split_annexb
    for name in ('hevc10_tool_dovi_rpu.mp4', PHONE):
        packets = annexb_packets(path_of(name))
        assert all([n[0] >> 1 & 63 for n in split_annexb(p)][-1] == 62 for p in packets)


def test_422_at_10_bits_raises_naming_it(tmp_path):
    packets, keys = x265_encode(hevc_frames(4, (64, 64)), {}, 25.0, csp='i422', depth=10)
    path = tmp_path / 'clip.avi'
    with open(path, 'wb') as f:
        mux = video._AviMuxer(f, 64, 64, 25.0, b'HEVC')
        for packet, key in zip(packets, keys):
            mux.write(packet, key)
        mux.close()
    with pytest.raises(video.UnsupportedVideo, match='4:2:2'):
        list(video.iter_frames(str(path)))
