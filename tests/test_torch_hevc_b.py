"""The port's HEVC layer on streams with B slices (`csrc/hevc_decode.cpp`,
`data/hevc.py`, and the reordering paths of `data/mp4.py`, `data/video.py`
and `data/improc.py`) against OpenCV's FFmpeg backend, libde265 and the JAX
package's helpers, on the clips of `tests/torch_fixtures/hevc_b/` (`python
tests/_torch_hevc_fixtures.py b`) and on streams written here:

- the demuxers find cv2's packets and key frames in MP4 (with the `ctts`
  and `elst` of FFmpeg's mov muxer), Matroska (block timestamps in
  presentation order) and AVI (Annex B, no timestamps);
- every frame's luma equals FFmpeg's (`CAP_PROP_CONVERT_RGB` 0) and its RGB
  `cv2.VideoCapture`'s, in cv2's output order, on x265's `medium` B-frame
  clips at three sizes, a clip per B-frame option and a stream edited from
  x265's (collocated_from_l0_flag 1); Y, U and V equal libde265's wherever
  its luma equals FFmpeg's (libde265 differs on a few B pictures, and on
  the chroma of the four-slice clip: cv2 rules there);
- each clip's tool is read from its parameter sets, slice headers or x265's
  options SEI, and the flags x265 writes one way only are shown;
- every decoded-picture hash SEI verifies;
- `num_frames_of_video`, `video_fps` and `imread('#frame=N')` equal JAX's
  for every N, each seek as cv2 answered it when the fixture was written,
  and on a 40-frame open-GOP stream in each container as cv2 answers it;
- a CRA picture's entry point skips its RASL pictures and is exact from
  the CRA's frame on; an IDR_W_RADL picture's RADL pictures decode from it;
- reads from 8 threads in shuffled order give cv2's frames, and 8 I/O
  threads reading closed GOPs in chunks decode each picture once;
- what stays refused raises UnsupportedVideo naming it: mvd_l1_zero_flag,
  a stream that starts at a CRA picture with RASL pictures, presentation
  times out of picture order.
"""

import hashlib
import json
import random
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from _torch_h264_fixtures import write_container
from _torch_hevc_fixtures import (B_CASES, B_CRAFTED, B_TOOLS, HEVC_B_DIR, hevc_b_frames,
                                  nal_type, set_slice_flag, split_annexb, stream_fields,
                                  x265_encode)
from _torch_train import one_torch_thread  # noqa: F401 (fixture)
from metrabs_tpu.data import improc as jax_improc
from metrabs_tpu_torch.data import hevc, improc, video

pytestmark = pytest.mark.usefixtures('one_torch_thread')

MANIFEST = json.loads((HEVC_B_DIR / 'manifest.json').read_text())
NAMES = [name for name, *_ in B_CASES]
FPS_REL = 1e-4  # cv2 reports the 30000/1001 clip as 29.97
# libde265 gives other chroma planes than FFmpeg on this clip's slices (as
# on some multi-slice I/P streams): its U and V are no oracle there.
DE265_CHROMA_DIFFERS = ('hevcb_tool_slices4.mp4',)
RASL, RADL, CRA, IDR_W_RADL = (8, 9), (6, 7), 21, 19


def path_of(name: str) -> str:
    return str(HEVC_B_DIR / name)


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


def test_manifest_lists_every_b_fixture():
    on_disk = sorted(p.name for p in HEVC_B_DIR.iterdir() if p.suffix in ('.mp4', '.avi', '.mkv'))
    assert on_disk == sorted(NAMES) == sorted(MANIFEST)
    for name in NAMES:
        assert sha256((HEVC_B_DIR / name).read_bytes()) == MANIFEST[name]['file_sha256']
    total = sum(p.stat().st_size for p in HEVC_B_DIR.iterdir())
    assert total < 1.25 * 2 ** 20


@pytest.mark.parametrize('name', NAMES)
def test_b_packets_key_frames_and_timing_equal_cv2s(name):
    idx = video.index(path_of(name))
    entry = MANIFEST[name]
    assert idx.kind == 'hevc' and idx.n_frames == entry['cv2']['frames_read']
    assert [sha256(p) for p in annexb_packets(path_of(name))] == entry['packet_sha256']
    assert idx.keyframes.tolist() == entry['key_frames'] == entry['written']['key_frames']
    assert (idx.width, idx.height) == (entry['cv2']['width'], entry['cv2']['height'])
    # Presentation times order the frames as the picture order counts do.
    pts = [t[0] for t in entry['written']['times']]
    if idx.container == 'avi':
        assert idx.pts is None
    else:
        assert np.argsort(idx.pts, kind='stable').tolist() == np.argsort(pts).tolist()
    assert pts != sorted(pts)  # the B pictures are reordered
    assert idx.frame_packets.tolist() == sorted(idx.frame_packets.tolist())
    assert idx.n_decoded == idx.n_frames


@pytest.mark.parametrize('name', NAMES)
def test_b_planes_equal_ffmpeg_and_libde265_bit_for_bit(name):
    """Luma and RGB equal cv2's for every frame; Y, U and V equal libde265's
    where its luma equals FFmpeg's (Y only on DE265_CHROMA_DIFFERS)."""
    entry = MANIFEST[name]
    got, _ = decode_all(path_of(name))
    assert entry['luma_from'] == 'cv2'
    assert [sha256(planes[0]) for _, planes in got] == entry['luma_sha256']
    assert [sha256(rgb) for rgb, _ in got] == entry['rgb_sha256']
    agree = entry['de265_equals_ffmpeg']
    assert sum(agree) >= len(agree) - 1
    chroma_differs = []
    for (_, planes), want, same in zip(got, entry['de265_sha256'], agree):
        if not same:
            continue
        assert sha256(planes[0]) == want[0]
        chroma_differs.append([sha256(p) for p in planes[1:]] != want[1:])
    assert any(chroma_differs) == (name in DE265_CHROMA_DIFFERS)


@pytest.mark.parametrize('name', NAMES)
def test_b_iter_frames_equal_sequential_cv2(name):
    assert [sha256(f) for f in video.iter_frames(path_of(name))] == MANIFEST[name]['rgb_sha256']


@pytest.mark.parametrize('name', [n for n in NAMES if 'tool' not in n and 'crafted' not in n])
def test_b_metadata_and_every_seek_equal_jax(name):
    """Frame count, rate and size equal JAX's (cv2's); imread('#frame=N')
    equals JAX's for every N, and both equal the seek table cv2 gave when
    the fixture was written (the N-th frame of the sequential read, or
    FileNotFoundError)."""
    path = path_of(name)
    entry = MANIFEST[name]
    np.testing.assert_array_equal(improc.video_extents(path), jax_improc.video_extents(path))
    assert improc.video_fps(path) == pytest.approx(jax_improc.video_fps(path), rel=FPS_REL)
    assert improc.num_frames_of_video(path) == jax_improc.num_frames_of_video(path) == \
        entry['cv2']['frame_count']
    rgb = entry['rgb_sha256']
    assert entry['seek'] == list(range(len(rgb))) + [-1, -1]
    video._STREAMS.clear()
    for n, want in enumerate(entry['seek']):
        if want < 0:
            for read in (improc.imread, jax_improc.imread):
                with pytest.raises(FileNotFoundError):
                    read(f'{path}#frame={n}')
            continue
        got = improc.imread(f'{path}#frame={n}')
        assert sha256(got) == rgb[want]
        if '1080' not in name:  # cv2's seeks of the large clip: once, into the manifest
            np.testing.assert_array_equal(got, jax_improc.imread(f'{path}#frame={n}'))


@pytest.mark.parametrize('name', [n for n in NAMES if 'tool' in n or 'crafted' in n])
def test_b_tool_clips_seek_as_cv2(name):
    """Every seek of the option clips, in shuffled order with one cache."""
    path = path_of(name)
    entry = MANIFEST[name]
    assert improc.num_frames_of_video(path) == entry['cv2']['frame_count']
    assert improc.video_fps(path) == pytest.approx(entry['cv2']['fps'], rel=FPS_REL)
    video._STREAMS.clear()
    order = list(range(len(entry['seek'])))
    random.Random(name).shuffle(order)
    for n in order:
        want = entry['seek'][n]
        if want < 0:
            with pytest.raises(FileNotFoundError):
                improc.imread(f'{path}#frame={n}')
        else:
            assert sha256(improc.imread(f'{path}#frame={n}')) == entry['rgb_sha256'][want]


# --------------------------------------------------------------------------
# The tools each clip uses, read from its parameter sets, slice headers and
# x265's options SEI.

def stream_tools(name: str) -> dict:
    packets = annexb_packets(path_of(name))
    f = stream_fields(packets)
    slices = [s for p in f['slices'] for s in p]
    b = [s for s in slices if s['type'] == 0]
    kinds = [p[0]['nal_type'] for p in f['slices']]
    run = best = 0
    for p in f['slices']:
        run = run + 1 if p[0]['type'] == 0 else 0
        best = max(best, run)
    options = next((n[n.index(b'options:'):].decode('latin1') for p in packets
                    for n in split_annexb(p) if nal_type(n) == 39 and b'options:' in n), '')
    return dict(f, b=b, kinds=kinds, max_b_run=best, options=options,
                b_refs=sum(s['nal_type'] % 2 == 1 for s in b),
                tids={s['temporal_id'] for s in slices})


TOOL_CHECKS = {
    'bframes1': lambda t: t['max_b_run'] == 1 and 'bframes=1 ' in t['options'],
    'bframes16': lambda t: t['max_b_run'] == 16,
    'badapt0': lambda t: 'b-adapt=0' in t['options'],
    'badapt2': lambda t: 'b-adapt=2' in t['options'] and 'bframes=4 ' in t['options'],
    'pyramid0': lambda t: t['b_refs'] == 0 and 'no-b-pyramid' in t['options'],
    'weightb': lambda t: t['pps']['weighted_bipred'] and sum(s['weights'] for s in t['b']) >= 4,
    'ref1': lambda t: max(s['num_ref_idx'] for s in t['b']) == 1,
    'ref4': lambda t: 'ref=4' in t['options'],  # 14 frames hold 3 in list 0
    'max_merge1': lambda t: {s['max_merge'] for s in t['b']} == {1},
    'max_merge5': lambda t: {s['max_merge'] for s in t['b']} == {5},
    'tmvp0': lambda t: not t['sps']['temporal_mvp'],
    'amp_rect': lambda t: t['sps']['amp'] and ' rect ' in t['options'],
    'slices4': lambda t: max(len(p) for p in t['slices']) == 4,
    'no_wpp': lambda t: t['sps']['log2_ctb'] == 5 and not t['pps']['wpp'],
    'closed_radl': lambda t: (IDR_W_RADL in t['kinds'] and
                              set(t['kinds'][t['kinds'].index(IDR_W_RADL) + 1:][:2]) <= set(RADL)),
    'open_gop': lambda t: any(k == CRA and t['kinds'][i + 1] in RASL
                              for i, k in enumerate(t['kinds'][:-1])),
    'temporal_layers': lambda t: t['tids'] == {0, 1} and 2 in t['kinds'],  # TSA_N pictures
    'hash1': lambda t: t['hash_type'] == 0,
    'hash2': lambda t: t['hash_type'] == 1,
    'hash3': lambda t: t['hash_type'] == 2,
    'collocated_l0': lambda t: {s['collocated_from_l0'] for s in t['b']} == {0, 1},
}


@pytest.mark.parametrize('tool', list(B_TOOLS) + list(B_CRAFTED))
def test_each_b_clip_uses_its_tool(tool):
    """The clip's headers show the tool (and x265's defaults do not), and it
    has B slices."""
    name = f'hevcb_tool_{tool}.mp4' if tool in B_TOOLS else f'hevcb_crafted_{tool}.mp4'
    tools = stream_tools(name)
    assert tools['b'], tools['kinds']
    assert TOOL_CHECKS[tool](tools), tools
    default = stream_tools('hevcb_96x66.avi')
    assert not TOOL_CHECKS[tool](default) or tool == 'badapt2'  # x265's medium default


def test_x265_writes_b_slice_flags_one_way():
    """In every B slice of every clip x265 writes collocated_from_l0_flag 0
    (the collocated picture from list 1, at index 0), mvd_l1_zero_flag 0 and
    no cabac_init_flag; the edited clip sets the first where its header
    keeps its length."""
    flags = {}
    for name in NAMES:
        for s in stream_tools(name)['b']:
            edited = 'crafted' in name
            flags.setdefault(edited, set()).add(
                (s.get('collocated_from_l0'), s.get('collocated_ref_idx'), s['mvd_l1_zero'],
                 s.get('cabac_init')))
    assert flags[False] == {(0, 0, 0, None), (None, None, 0, None)}  # the latter: tmvp0
    assert flags[True] == {(0, 0, 0, None), (1, 0, 0, None)}


@pytest.mark.parametrize('name', [n for n in NAMES
                                  if MANIFEST[n]['written']['hash_type'] is not None])
def test_b_hash_seis_verify(name):
    """Every picture's hash SEI is checked: MD5 and the checksum verify on
    every plane, x265's CRC on luma (its chroma CRC covers the last CTU row
    only, as tests/test_torch_hevc.py shows)."""
    _, (checked, failed) = decode_all(path_of(name))
    n = MANIFEST[name]['cv2']['frames_read']
    assert checked == (n, n, n)
    assert failed == ((0, n, n) if MANIFEST[name]['written']['hash_type'] == 1 else (0, 0, 0))


# --------------------------------------------------------------------------
# Leading pictures and random access

def test_cra_entry_skips_its_rasl_pictures():
    """The open GOP's CRA picture is an entry point whose decoder skips its
    RASL pictures (as FFmpeg does after a seek): exact from the CRA's own
    frame, which it outputs first; the RASL frames before it decode from
    the IDR picture. Taking the first frame of the packets from the CRA on
    (the RASL's) as the entry's first frame would number every frame it
    outputs one too low."""
    name = 'hevcb_tool_open_gop.mp4'
    path = path_of(name)
    idx = video.index(path)
    kinds = MANIFEST[name]['written']['nal_types']
    k = kinds.index(CRA)
    rasl = [p for p in range(k + 1, len(kinds)) if kinds[p] in RASL]
    order = np.argsort([t[0] for t in MANIFEST[name]['written']['times']])
    display = np.empty(len(order), int)
    display[order] = np.arange(len(order))
    assert rasl and all(display[r] < display[k] for r in rasl)
    starts = {s: exact for s, exact, _ in idx.entries}
    assert starts[k] == idx.first_frames[k] == display[k] > min(display[k:])
    want = MANIFEST[name]['rgb_sha256']
    for i in range(idx.n_frames):
        video._STREAMS.clear()
        assert sha256(improc.imread(f'{path}#frame={i}')) == want[i]
        start = idx.entry_for(i)[0]
        assert start == max(s for s in starts if starts[s] <= i)
        assert (start == k) == (display[k] <= i < starts[max(starts)])
    # A decoder started at the CRA outputs the CRA's frame first.
    decoder = idx.decoder(k)
    out = []
    for p in range(k, idx.n_frames):
        out += decoder.decode(idx.packet(p))
    out += decoder.flush()
    assert len(out) == idx.n_frames - k - len(rasl)
    assert [sha256(f) for f in out] == want[display[k]:]


def test_idr_w_radl_entry_decodes_its_radl_pictures():
    """An IDR_W_RADL picture's RADL pictures (decoded after it, output before
    it) come from it: the entry is exact from the first RADL frame."""
    name = 'hevcb_tool_closed_radl.mp4'
    path = path_of(name)
    idx = video.index(path)
    kinds = MANIFEST[name]['written']['nal_types']
    k = kinds.index(IDR_W_RADL)
    order = np.argsort([t[0] for t in MANIFEST[name]['written']['times']])
    display = np.empty(len(order), int)
    display[order] = np.arange(len(order))
    radl = [p for p in range(k + 1, idx.n_frames) if kinds[p] in RADL]
    assert radl and all(display[r] < display[k] for r in radl)
    first = min(display[k:])
    assert (k, first, False) in idx.entries and first == min(display[r] for r in radl)
    want = MANIFEST[name]['rgb_sha256']
    for i in range(first, idx.n_frames):
        video._STREAMS.clear()
        assert idx.entry_for(i)[0] == k
        assert sha256(improc.imread(f'{path}#frame={i}')) == want[i]


def test_b_random_access_from_eight_threads():
    name = 'hevcb_320x568.mkv'
    path = path_of(name)
    n = MANIFEST[name]['cv2']['frames_read']
    video._STREAMS.clear()
    video._INDEX_CACHE.clear()
    order = list(range(n))
    random.Random(19).shuffle(order)
    before = hevc.frames_decoded()
    with ThreadPoolExecutor(8) as pool:
        frames = list(pool.map(improc.imread, [f'{path}#frame={i}' for i in order]))
    assert [sha256(f) for f in frames] == [MANIFEST[name]['rgb_sha256'][i] for i in order]
    # The CRA picture's RASL picture decodes only from the IDR picture, so a
    # cursor from there and one from the CRA picture may both pass the CRA.
    assert hevc.frames_decoded() - before < 2 * n


def test_b_in_order_reads_decode_each_packet_once():
    name = 'hevcb_96x66.avi'
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


def test_decoder_outputs_in_picture_order_with_its_delay():
    """Pictures wait until more than sps_max_num_reorder_pics (2) do, then
    come out in picture order; the flush outputs the rest."""
    name = 'hevcb_96x66.mp4'
    idx = video.index(path_of(name))
    assert stream_tools(name)['sps']['max_num_reorder'] == 2
    decoder = idx.decoder(0)
    counts = [len(decoder.order(idx.packet(i))) for i in range(idx.n_frames)]
    assert counts[:2] == [0, 0] and sum(counts) + len(decoder.order(None)) == idx.n_frames
    assert idx.frame_packets[-1] == idx.n_frames  # the last frames come from the flush


def test_b_gops_read_by_eight_io_threads_decode_each_picture_once(tmp_path):
    """predict_aspset's reads (chunks of 8 frames, 8 I/O threads) of a clip
    whose closed GOPs repeat (chip_smoke's HEVC B ASPset views): frames
    before an entry point come out of a flush, so no two cursors decode the
    entry point's packet."""
    name = 'hevcb_96x66.mp4'
    src = video.index(path_of(name))
    entry = MANIFEST[name]
    kinds = entry['written']['nal_types']
    end = kinds.index(CRA)  # the IDR picture's GOP: packets 0 to the CRA, closed
    packets, keys, times, want = [], [], [], []
    for _ in range(3):
        for i in range(end):
            packets.append(hevc.annexb(src.packet(i), src.config))
            keys.append(bool(src.keyframes[i]))
            pts, dts = entry['written']['times'][i]
            times.append((pts + len(want), dts + len(want)))
        want += entry['rgb_sha256'][:end]
    path = str(tmp_path / 'view.mkv')
    write_container(tmp_path / 'view.mkv', packets, keys, (96, 66), 10.0, 'hevc', times=times)
    n = len(want)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # threads switch often: a lost update would show
    try:
        for seed in range(4):
            video._STREAMS.clear()
            rng = random.Random(seed)
            before = hevc.frames_decoded()
            got = []
            with ThreadPoolExecutor(8) as pool:
                for chunk in range(0, n, 8):
                    order = list(range(chunk, min(chunk + 8, n)))
                    rng.shuffle(order)
                    frames = list(pool.map(improc.imread, [f'{path}#frame={i}' for i in order]))
                    got += sorted(zip(order, [sha256(f) for f in frames]))
            assert [h for _, h in got] == want
            assert hevc.frames_decoded() - before == n, seed
    finally:
        sys.setswitchinterval(interval)


# --------------------------------------------------------------------------
# Refusals

SMALL = (64, 64)


@pytest.fixture(scope='module')
def small_b():
    times = []
    packets, keys = x265_encode(hevc_b_frames(8, SMALL), {'bframes': 3}, 25.0, times=times)
    return packets, keys, times


def test_mvd_l1_zero_flag_raises_naming_it(tmp_path, small_b):
    """x265 never sets mvd_l1_zero_flag: a B slice that does is refused at its
    header, naming the flag."""
    packets, keys, times = small_b
    edited = set_slice_flag(packets, 'at_mvd_l1_zero')
    assert edited != packets
    path = tmp_path / 'clip.avi'
    write_container(path, edited, keys, SMALL, 25.0, 'hevc', times=times)
    with pytest.raises(video.UnsupportedVideo, match='mvd_l1_zero_flag'):
        list(video.iter_frames(str(path)))


def test_stream_starting_at_a_cra_with_rasl_pictures_raises(tmp_path):
    """Cut at the open GOP's CRA picture, the stream's RASL pictures are
    never output (cv2 counts them all the same): refused by name."""
    name = 'hevcb_tool_open_gop.mp4'
    src = video.index(path_of(name))
    entry = MANIFEST[name]
    k = entry['written']['nal_types'].index(CRA)
    packets = [hevc.annexb(src.packet(i), src.config) for i in range(k, src.n_frames)]
    times = [(p - k, d - k) for p, d in entry['written']['times'][k:]]
    path = tmp_path / 'cut.mkv'
    write_container(path, packets, src.keyframes[k:].tolist(), (96, 66), 25.0, 'hevc',
                    times=times)
    with pytest.raises(video.UnsupportedVideo, match='RASL pictures of the CRA picture'):
        video.index(str(path))


@pytest.mark.parametrize('ext', ['.mp4', '.mkv'])
def test_b_timing_in_decoding_order_raises(tmp_path, small_b, ext):
    """A B-frame stream whose MP4 has no ctts, or whose Matroska timestamps
    follow the decoding order: the presentation times disagree with the
    picture order counts, which the port refuses by name."""
    packets, keys, _ = small_b
    path = tmp_path / f'clip{ext}'
    write_container(path, packets, keys, SMALL, 25.0, 'hevc')
    what = 'composition times' if ext == '.mp4' else 'block timestamps'
    with pytest.raises(video.UnsupportedVideo, match=what):
        video.index(str(path))


@pytest.mark.parametrize('ext', ['.mp4', '.mkv', '.avi'])
def test_long_open_gop_b_stream_seeks_as_cv2(tmp_path, ext):
    """A 40-frame stream with a CRA picture every 6 frames, its leading B
    pictures RASL pictures: past cv2's 16-frame backoff, where it seeks with
    av_seek_frame to a key frame and counts frames from its time stamp,
    imread('#frame=N') gives the N-th frame in each container, and so does
    the port."""
    import cv2
    times = []
    packets, keys = x265_encode(hevc_b_frames(40, (96, 66)),
                                {'bframes': 4, 'keyint': 6, 'min-keyint': 6}, 25.0, times=times)
    kinds = [nal_type(next(n for n in split_annexb(p) if nal_type(n) < 32)) for p in packets]
    assert kinds.count(CRA) >= 5 and any(k in RASL for k in kinds)
    path = str(tmp_path / f'clip{ext}')
    write_container(tmp_path / f'clip{ext}', packets, keys, (96, 66), 25.0, 'hevc', times=times)
    cap = cv2.VideoCapture(path)
    sequential = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        sequential.append(sha256(frame[..., ::-1]))
    cap.release()
    assert len(sequential) == 40
    video._STREAMS.clear()
    for n in range(40):
        want = sha256(jax_improc.imread(f'{path}#frame={n}'))
        assert want == sequential[n]
        assert sha256(improc.imread(f'{path}#frame={n}')) == want
