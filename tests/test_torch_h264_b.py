"""The port's H.264 layer on streams with B slices (`csrc/h264_decode.cpp`,
`data/h264.py`, and the reordering paths of `data/mp4.py`, `data/video.py`
and `data/improc.py`) against OpenCV's FFmpeg backend and the JAX package's
helpers, on the clips of `tests/torch_fixtures/h264_b/` (`python
tests/_torch_h264_fixtures.py b`) and on streams written here:

- the demuxers find cv2's packets and key frames in MP4 (with the `ctts`
  and `elst` of FFmpeg's mov muxer), Matroska (block timestamps in
  presentation order) and AVI (Annex B, no timestamps);
- every frame's luma equals FFmpeg's (`CAP_PROP_CONVERT_RGB` 0) and its RGB
  `cv2.VideoCapture`'s, in cv2's output order, on x264's `medium` clips at
  three sizes, a clip per B-frame option and three streams edited from
  x264's (explicit bi-prediction weights, direct_8x8_inference_flag 0, no
  bitstream_restriction); Y, U and V equal x264's reconstruction wherever
  its luma equals FFmpeg's (x264 leaves non-reference B pictures
  unfiltered);
- each clip's tool is read from its parameter sets and slice headers;
- `num_frames_of_video`, `video_fps` and `imread('#frame=N')` equal JAX's
  for every N, each seek as cv2 answered it when the fixture was written;
  `iter_frames` equals cv2's sequential read;
- reads from 8 threads in shuffled order decode each packet once, and an
  open GOP's recovery point is an entry point whose leading B pictures
  are not taken from it;
- what stays refused raises UnsupportedVideo naming it: edit lists that
  drop decoded frames or hold several edits, reordering deeper than
  max_num_reorder_frames, interlaced and 4:2:2 B-frame streams.
"""

import hashlib
import json
import random
import struct
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import cv2
import numpy as np
import pytest

from _torch_h264_fixtures import (B_CASES, B_CRAFTED, B_TOOLS, CRAFTED_WEIGHTS, H264_B_DIR,
                                  BitReader, annexb_to_lengths, insert_box, mov_time_base,
                                  mov_timing_boxes, moving_frames, nal_from_bits, parameter_sets,
                                  rbsp_bits, slice_fields, sps_fields, split_annexb, stream_nals,
                                  ue_bits, write_container, x264_encode)
from _torch_train import one_torch_thread  # noqa: F401 (fixture)
from metrabs_tpu.data import improc as jax_improc
from metrabs_tpu_torch.data import h264, improc, mp4, video

pytestmark = pytest.mark.usefixtures('one_torch_thread')

MANIFEST = json.loads((H264_B_DIR / 'manifest.json').read_text())
NAMES = [name for name, *_ in B_CASES]
FPS_REL = 1e-4  # cv2 reports the 30000/1001 clip as 29.97
SMALL = (48, 32)


def path_of(name: str) -> str:
    return str(H264_B_DIR / name)


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


def test_manifest_lists_every_b_fixture():
    on_disk = sorted(p.name for p in H264_B_DIR.iterdir() if p.suffix in ('.mp4', '.avi', '.mkv'))
    assert on_disk == sorted(NAMES) == sorted(MANIFEST)
    for name in NAMES:
        assert sha256((H264_B_DIR / name).read_bytes()) == MANIFEST[name]['file_sha256']
    assert sum((H264_B_DIR / n).stat().st_size for n in NAMES) < 1.5 * 2 ** 20


@pytest.mark.parametrize('name', NAMES)
def test_b_packets_and_key_frames_equal_cv2s(name):
    idx = video.index(path_of(name))
    entry = MANIFEST[name]
    assert idx.kind == 'h264' and idx.n_frames == entry['cv2']['frames_read']
    assert [sha256(h264.annexb(idx.packet(i), idx.config)) for i in range(idx.n_frames)] == \
        entry['packet_sha256']
    assert idx.keyframes.tolist() == entry['key_frames'] == entry['written']['key_frames']
    assert (idx.width, idx.height) == (entry['cv2']['width'], entry['cv2']['height'])
    # Presentation times order the frames as the picture order counts do.
    pts = [t[0] for t in entry['written']['times']]
    if idx.container == 'avi':
        assert idx.pts is None
    else:
        assert np.argsort(idx.pts, kind='stable').tolist() == np.argsort(pts).tolist()
    assert idx.frame_packets.tolist() == sorted(idx.frame_packets.tolist())
    assert idx.n_decoded == idx.n_frames


@pytest.mark.parametrize('name', NAMES)
def test_b_planes_equal_ffmpeg_bit_for_bit(name):
    """Luma and RGB equal cv2's for every frame; all three planes equal
    x264's reconstruction where its luma is FFmpeg's."""
    entry = MANIFEST[name]
    got = decode_all(path_of(name))
    assert [sha256(planes[0]) for _, planes in got] == entry['luma_sha256']
    assert [sha256(rgb) for rgb, _ in got] == entry['rgb_sha256']
    if 'recon_sha256' in entry:
        same = entry['recon_equals_ffmpeg']
        assert 0 < sum(same) and (sum(same) < len(same) or 'no_deblock' in name)
        for (_, planes), recon, agree in zip(got, entry['recon_sha256'], same):
            if agree:
                assert [sha256(p) for p in planes] == recon


@pytest.mark.parametrize('name', NAMES)
def test_b_iter_frames_equal_sequential_cv2(name):
    assert [sha256(f) for f in video.iter_frames(path_of(name))] == MANIFEST[name]['rgb_sha256']


@pytest.mark.parametrize('name', [n for n in NAMES if 'tool' not in n])
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
def test_b_tool_and_crafted_clips_seek_as_cv2(name):
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
# The tools each clip uses, read from its parameter sets and slice headers.

def stream_tools(path: str) -> dict:
    idx = video.index(path)
    packets = [h264.annexb(idx.packet(i), idx.config) for i in range(idx.n_frames)]
    out = dict(types='', direct=set(), b_slices=0, b_refs=0, slices=0, max_b_run=0, refs=[0, 0],
               non_idr_i=0, poc_below_i=0, options='')
    run, last_i_poc = 0, None
    for nals, sps, pps in stream_nals(packets):
        out.setdefault('sps', sps)
        out.setdefault('pps', pps)
        n_slices, kind = 0, None
        for nal in nals:
            if nal[0] & 31 == 6 and b'x264' in nal:
                out['options'] = nal[nal.index(b'options:'):].decode('latin1')
            if nal[0] & 31 not in (1, 5):
                continue
            f = slice_fields(nal, sps, pps)
            n_slices += 1
            kind = f['type']
            for lst, n in enumerate(f['num_ref_idx']):
                out['refs'][lst] = max(out['refs'][lst], n)
            if kind == 1:
                out['b_slices'] += 1
                out['b_refs'] += f['nal_ref_idc'] > 0
                out['direct'].add(f['direct_spatial'])
                if last_i_poc is not None and f['poc_lsb'] < last_i_poc:
                    out['poc_below_i'] += 1
            if kind == 2 and n_slices == 1:
                last_i_poc = f['poc_lsb'] if not f['idr'] else None
                out['non_idr_i'] += not f['idr']
        out['slices'] = max(out['slices'], n_slices)
        out['types'] += 'PBI'[kind]
        run = run + 1 if kind == 1 else 0
        out['max_b_run'] = max(out['max_b_run'], run)
    return out


MEDIUM = dict(direct={1}, wbi=2, reorder=2)
TOOL_CHECKS = {
    'direct_temporal': lambda t: 0 in t['direct'],
    'direct_auto': lambda t: t['direct'] == {0, 1},
    'weightb0': lambda t: t['pps']['weighted_bipred_idc'] == 0,
    'pyramid_none': lambda t: t['b_refs'] == 0 and t['sps']['max_num_reorder_frames'] == 1,
    'pyramid_strict': lambda t: t['b_refs'] > 0 and 'b_pyramid=1' in t['options'],
    'bframes1': lambda t: t['max_b_run'] == 1,
    'bframes16': lambda t: t['max_b_run'] > 3 and 'bframes=16' in t['options'],
    'badapt2': lambda t: 'b_adapt=2' in t['options'],
    'cavlc': lambda t: t['pps']['cabac'] == 0,
    'partitions_all': lambda t: 'analyse=0x3:0x133' in t['options'],
    'ref1': lambda t: t['refs'][0] == 1,
    'ref4': lambda t: t['refs'][0] == 4 and 'ref=4' in t['options'],  # 14 frames hold 4
    'slices4': lambda t: t['slices'] == 4,
    'weightp2': lambda t: t['pps']['weighted_pred'] == 1 and 'weightp=2' in t['options'],
    'no_deblock': lambda t: t['pps']['deblocking_control'] == 1 and 'deblock=0' in t['options'],
    'open_gop': lambda t: t['non_idr_i'] > 0 and t['poc_below_i'] > 0,
    'weighted_bipred1': lambda t: t['pps']['weighted_bipred_idc'] == 1 and t['pps']['cabac'] == 0,
    'direct_8x8_inference0': lambda t: (t['sps']['direct_8x8_inference'] == 0
                                        and t['pps']['transform_8x8'] == 0),
    'no_bitstream_restriction': lambda t: t['sps']['bitstream_restriction'] == 0,
}


@pytest.mark.parametrize('tool', list(B_TOOLS) + list(B_CRAFTED))
def test_each_b_clip_uses_its_tool(tool):
    """The clip's parameter sets and slices show the tool (and x264's
    defaults do not), and it has B slices."""
    name = f'h264b_tool_{tool}.mp4' if tool in B_TOOLS else f'h264b_crafted_{tool}.mp4'
    tools = stream_tools(path_of(name))
    assert tools['b_slices'] > 0 and 'B' in tools['types'], tools['types']
    assert TOOL_CHECKS[tool](tools), tools
    default = stream_tools(path_of('h264b_96x66.mp4'))
    assert not TOOL_CHECKS[tool](default) or tool == 'weightp2'  # x264's default weightp
    assert default['direct'] == MEDIUM['direct']
    assert default['pps']['weighted_bipred_idc'] == MEDIUM['wbi']
    assert default['sps']['max_num_reorder_frames'] == MEDIUM['reorder']


def test_crafted_weights_are_in_the_b_slices():
    """The explicit weight table edited into each B slice is what the
    decoder reads (the table's bits follow the list modifications)."""
    path = path_of('h264b_crafted_weighted_bipred1.mp4')
    idx = video.index(path)
    packets = [h264.annexb(idx.packet(i), idx.config) for i in range(idx.n_frames)]
    found = 0
    for nals, sps, pps in stream_nals(packets):
        for nal in nals:
            if nal[0] & 31 not in (1, 5):
                continue
            f = slice_fields(nal, sps, pps)
            if f['type'] != 1:
                continue
            r = BitReader(rbsp_bits(nal))
            r.pos = f['at_weights']
            assert (r.ue(), r.ue()) == CRAFTED_WEIGHTS['denom']
            assert r.u(1) == 1 and (r.se(), r.se()) == CRAFTED_WEIGHTS['l0'][0]
            found += 1
    assert found == stream_tools(path)['b_slices'] > 0


# --------------------------------------------------------------------------
# Random access

def test_b_random_access_from_eight_threads_decodes_each_packet_once(monkeypatch):
    name = 'h264b_320x568.mkv'
    path = path_of(name)
    n = MANIFEST[name]['cv2']['frames_read']
    parse = video._index_matroska

    def slow_parse(*args):
        time.sleep(0.05)
        return parse(*args)

    monkeypatch.setattr(video, '_index_matroska', slow_parse)
    video._STREAMS.clear()
    video._INDEX_CACHE.clear()
    order = list(range(n))
    random.Random(17).shuffle(order)
    before = h264.frames_decoded()
    with ThreadPoolExecutor(8) as pool:
        frames = list(pool.map(improc.imread, [f'{path}#frame={i}' for i in order]))
    assert h264.frames_decoded() - before == n
    assert [sha256(f) for f in frames] == [MANIFEST[name]['rgb_sha256'][i] for i in order]


def test_b_in_order_reads_decode_each_packet_once():
    name = 'h264b_96x66.avi'
    path = path_of(name)
    n = MANIFEST[name]['cv2']['frames_read']
    video._STREAMS.clear()
    before = h264.frames_decoded()
    assert [sha256(improc.imread(f'{path}#frame={i}')) for i in range(n)] == \
        MANIFEST[name]['rgb_sha256']
    assert h264.frames_decoded() - before == n
    before = h264.frames_decoded()
    assert len(list(video.iter_frames(path))) == n
    assert h264.frames_decoded() - before == n


def test_open_gop_recovery_point_is_an_entry_point():
    """The open GOP's non-IDR I picture is an entry point (its
    recovery-point SEI): a decoder started there outputs its leading B
    pictures first, which are not exact and are never read from it; the
    frames from the I picture on are."""
    name = 'h264b_tool_open_gop.mp4'
    path = path_of(name)
    idx = video.index(path)
    want = MANIFEST[name]['rgb_sha256']
    recovering = [row for row in idx.entries if row[2]]
    assert len(recovering) == 1
    start, exact, _ = recovering[0]
    first = idx.first_frames[start]
    assert 0 < first < exact < idx.n_frames  # leading B pictures between
    assert h264.entry_point(idx.packet(start), h264.length_size(idx.config)).exact
    for i in range(first, idx.n_frames):
        video._STREAMS.clear()
        assert sha256(improc.imread(f'{path}#frame={i}')) == want[i]
        assert idx.entry_for(i)[0] == (start if i >= exact else 0)
    # Decoded from the recovery point, the leading frames differ from cv2's.
    decoder = h264.Decoder(idx.config, path, recovering=True)
    out = []
    for p in range(start, idx.n_frames):
        out += decoder.decode(idx.packet(p))
    out += decoder.flush()
    assert len(out) == idx.n_frames - first
    assert [sha256(f) for f in out[exact - first:]] == want[exact:]
    assert [sha256(f) for f in out[:exact - first]] != want[first:exact]


def test_decoder_outputs_in_picture_order_with_its_delay():
    """Each packet outputs at most one picture once max_num_reorder_frames
    wait (FFmpeg's has_b_frames), and the flush outputs the rest."""
    name = 'h264b_96x66.mp4'
    idx = video.index(path_of(name))
    decoder = idx.decoder(0)
    counts = [len(decoder.order(idx.packet(i))) for i in range(idx.n_frames)]
    reorder = MEDIUM['reorder']
    assert counts[:reorder] == [0] * reorder and set(counts[reorder:]) == {1}
    assert len(decoder.order(None)) == reorder
    assert idx.frame_packets.tolist() == list(range(reorder, idx.n_frames)) + [idx.n_frames] * 2


# --------------------------------------------------------------------------
# MP4 timing and refusals

def write_b_mp4(path, packets, keys, times, elst=None, ctts_version=None, shift=0) -> str:
    """packets into an MP4 with FFmpeg's ctts; `elst` (segment_duration,
    media_time, rate) entries replace its edit list (empty: no edit list),
    `shift` moves every pts (a ctts of negative offsets)."""
    res, inc = mov_time_base(25.0)
    with open(path, 'wb') as f:
        mux = mp4.Mp4Muxer(f, *SMALL, res, inc, parameter_sets(packets[0]), codec='avc1')
        for packet, key in zip(packets, keys):
            mux.write(annexb_to_lengths(packet), key)
        ctts, edts = mov_timing_boxes([(p + shift, d) for p, d in times], inc, res, ctts_version)
        if elst == []:
            edts = None
        elif elst is not None:
            edts = mp4._box(b'edts', mp4._full_box(b'elst', 0, 0, struct.pack('>I', len(elst))
                                                   + b''.join(struct.pack('>Iii', *e)
                                                              for e in elst)))
        moov = insert_box(mux._moov(), (b'trak', b'mdia', b'minf', b'stbl'), ctts, b'stss')
        if edts:
            moov = insert_box(moov, (b'trak',), edts, b'tkhd')
        end = f.tell()
        f.seek(mux.mdat_at + 8)
        f.write(struct.pack('>Q', end - mux.mdat_at))
        f.seek(end)
        f.write(moov)
    return str(path)


@pytest.fixture(scope='module')
def small_b():
    times = []
    packets, keys, _ = x264_encode(moving_frames(8, SMALL), {'bframes': 3}, 25.0, times=times)
    return packets, keys, times


DURATION_MS = 8 * 40
EDITS = {  # (segment_duration ms, media_time ticks of 512, rate) of FFmpeg's and other lists
    'ffmpeg': ([(DURATION_MS, 1024, 0x10000)], None),
    'ends_inside_the_last': ([(DURATION_MS - 20, 1024, 0x10000)], None),
    'none': ([], None),
    'empty_edit_first': ([(80, -1, 0x10000), (DURATION_MS, 1024, 0x10000)], None),
    'negative_ctts': ([(DURATION_MS, 0, 0x10000)], -2),
    'drops_the_first': ([(DURATION_MS, 1536, 0x10000)], 'drops decoded frames'),
    'ends_early': ([(DURATION_MS - 40, 1024, 0x10000)], 'drops decoded frames'),
    'several_edits': ([(160, 1024, 0x10000), (160, 3072, 0x10000)], 'several edits'),
    'slow_rate': ([(DURATION_MS, 1024, 0x8000)], 'rate'),
}


@pytest.mark.parametrize('edit', list(EDITS))
def test_mp4_edit_lists_read_as_ffmpeg_or_refused(tmp_path, small_b, edit):
    """The ctts and elst as FFmpeg's mov demuxer applies them: presentation
    times from 0 with FFmpeg's list (as without one, after an empty edit and
    with version 1 negative offsets), and cv2's frames; a list that would
    make FFmpeg drop frames (cv2 then reads fewer than its frame count),
    holds several edits or plays at another rate raises."""
    packets, keys, times = small_b
    elst, outcome = EDITS[edit]
    shift = outcome if isinstance(outcome, int) else 0
    path = write_b_mp4(tmp_path / 'clip.mp4', packets, keys, times, elst=elst,
                       ctts_version=1 if shift else None, shift=shift)
    if isinstance(outcome, str):
        with pytest.raises(video.UnsupportedVideo, match=outcome):
            video.index(path)
        return
    idx = video.index(path)
    pts = np.sort(idx.pts)
    assert np.array_equal(np.diff(pts), np.full(7, 512))
    assert pts[0] == {'ffmpeg': 0, 'ends_inside_the_last': 0, 'none': 1024,
                      'empty_edit_first': 1024, 'negative_ctts': 0}[edit]
    cap = cv2.VideoCapture(path)
    want = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        want.append(sha256(frame[..., ::-1]))
    assert [sha256(f) for f in video.iter_frames(path)] == want and len(want) == 8
    assert improc.num_frames_of_video(path) == jax_improc.num_frames_of_video(path) == 8


def test_reordering_deeper_than_max_num_reorder_frames_raises(tmp_path, small_b):
    """A B-pyramid stream whose VUI claims no reordering
    (max_num_reorder_frames 0): FFmpeg would drop the pictures it outputs
    late; the port refuses the stream by name."""
    packets, keys, times = small_b

    def zero_reorder(nal):
        f = sps_fields(nal)
        r_bits = rbsp_bits(nal)
        r = BitReader(r_bits)
        r.pos = f['at_bitstream_restriction'] + 2
        for _ in range(4):
            r.ue()
        at = r.pos
        r.ue()
        return nal_from_bits(nal[0], r_bits[:at] + ue_bits(0) + r_bits[r.pos:])

    edited = [b''.join(b'\x00\x00\x00\x01' + (zero_reorder(n) if n[0] & 31 == 7 else n)
                       for n in split_annexb(p)) for p in packets]
    path = write_b_mp4(tmp_path / 'clip.mp4', edited, keys, times)
    with pytest.raises(video.UnsupportedVideo, match='max_num_reorder_frames'):
        list(video.iter_frames(path))


@pytest.mark.parametrize('what, options, csp', [
    ('interlaced coding', {'interlaced': 1, 'bframes': 2, 'b-adapt': 0}, 'i420'),
    ('4:2:2', {'bframes': 2, 'b-adapt': 0}, 'i422'),
])
def test_b_streams_of_refused_tools_raise_naming_them(tmp_path, what, options, csp):
    packets, keys, _ = x264_encode(moving_frames(4, SMALL), options, 25.0, csp=csp)
    assert any(slice_fields(n, s, p)['type'] == 1 for nals, s, p in stream_nals(packets)
               for n in nals if n[0] & 31 in (1, 5)) or csp != 'i420'
    with open(tmp_path / 'clip.avi', 'wb') as f:
        mux = video._AviMuxer(f, *SMALL, 25.0, b'H264')
        for packet, key in zip(packets, keys):
            mux.write(packet, key)
        mux.close()
    with pytest.raises(video.UnsupportedVideo, match=what):
        list(video.iter_frames(str(tmp_path / 'clip.avi')))


def test_b_gops_read_by_eight_io_threads_decode_each_picture_once(tmp_path):
    """predict_aspset's reads (chunks of 8 frames, 8 I/O threads) of a clip
    whose closed GOPs repeat (chip_smoke's B-frame ASPset views): frames
    before an entry point come out of a flush, so no two cursors decode the
    entry point's packet."""
    name = 'h264b_96x66.mp4'
    src = video.index(path_of(name))
    entry = MANIFEST[name]
    starts = [int(k) for k in np.flatnonzero(src.keyframes)] + [src.n_frames]
    packets, keys, times, want = [], [], [], []
    for g in (1, 0, 1):  # 2 + 12 + 2 frames
        first, end = starts[g], starts[g + 1]
        for i in range(first, end):
            packets.append(h264.annexb(src.packet(i), src.config))
            keys.append(bool(src.keyframes[i]))
            pts, dts = entry['written']['times'][i]
            times.append((pts + len(want) - first, dts + len(want) - first))
        want += entry['rgb_sha256'][first:end]
    path = str(tmp_path / 'view.mkv')
    write_container(tmp_path / 'view.mkv', packets, keys, (96, 66), 10.0, 'h264',
                    times=times)
    n = len(want)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # threads switch often: a lost update would show
    try:
        for seed in range(6):
            video._STREAMS.clear()
            rng = random.Random(seed)
            before = h264.frames_decoded()
            got = []
            with ThreadPoolExecutor(8) as pool:
                for chunk in range(0, n, 8):
                    order = list(range(chunk, min(chunk + 8, n)))
                    rng.shuffle(order)
                    frames = list(pool.map(improc.imread, [f'{path}#frame={i}' for i in order]))
                    got += sorted(zip(order, [sha256(f) for f in frames]))
            assert [h for _, h in got] == want
            assert h264.frames_decoded() - before == n, seed
    finally:
        sys.setswitchinterval(interval)
