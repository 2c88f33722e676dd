"""The port's mp4v layer on MPEG-4 Advanced Simple streams (`csrc/mpeg4_video.cpp`,
`data/mpeg4.py` and the mp4v paths of `data/video.py` and `data/improc.py`)
against OpenCV's FFmpeg backend, FFmpeg's decoder (libavcodec through
ctypes) and the JAX package's helpers, on the clips of
`tests/torch_fixtures/mp4v_asp/` (`python tests/_torch_mp4v_asp_fixtures.py`)
and on streams edited here:

- the demuxers find cv2's packets and key frames in AVI (packed or not),
  Matroska and MP4 (with `ctts`);
- every frame's luma equals FFmpeg's (`CAP_PROP_CONVERT_RGB` 0) and its RGB
  `cv2.VideoCapture`'s, in cv2's output order and number; all three planes
  equal those FFmpeg's decoder outputs. B-VOPs (open and closed GOPs,
  direct mode over 1MV and 4MV), the packed bitstream, MPEG quantisation
  (default and custom matrices), quarter-pel, GMC, and Xvid's usual stream
  of them all at three sizes and in two containers;
- interlaced streams (field DCT, field vectors, field direct mode,
  alternate scan) equal FFmpeg's decoder bit for bit; cv2 returns no
  picture of them (its swscale refuses interlaced frames, F14), so there
  the port's RGB equals FFmpeg's decoder's planes through libswscale as cv2
  asks it to convert (which gives cv2's RGB on every other clip), and its
  frame numbering is FFmpeg's decoder's;
- each clip's tool is read from its own headers (`_torch_mp4v_headers`)
  and found by the decoder in its MBs;
- `video_extents`, `num_frames_of_video` and `imread('#frame=N')` equal
  JAX's for every N, each seek as cv2 answered it when the fixture was
  written;
- frames read in order, by one thread or by 8 I/O threads in any order
  within a batch, are each decoded once;
- a packed Xvid stream's DivX 5 stamp does not refuse it (the Xvid stamp
  wins, as in FFmpeg), and it does without the Xvid stamp;
- a low-delay stream that ends on a not-coded VOP gives its last frame
  again at the end, as FFmpeg does (F13);
- what stays refused raises UnsupportedVideo naming it.
"""

import hashlib
import json
import random
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from _torch_mp4v_asp_fixtures import (ASP_DIR, INTER_MATRIX, INTRA_MATRIX, lavc_decode,
                                      write_container)
from _torch_mp4v_fixtures import MP4V_DIR, cv2_lumas, cv2_read, shifted_frames
from _torch_mp4v_headers import _units, stream_tools
from _torch_train import one_torch_thread  # noqa: F401 (fixture)
from metrabs_tpu.data import improc as jax_improc
from metrabs_tpu_torch.data import improc, mp4, mpeg4, video

pytestmark = pytest.mark.usefixtures('one_torch_thread')

MANIFEST = json.loads((ASP_DIR / 'manifest.json').read_text())
NAMES = sorted(MANIFEST)
CV2_NAMES = [n for n in NAMES if MANIFEST[n]['cv2_is_ffmpeg']]
INTERLACED = [n for n in NAMES if 'interlaced' in n]
FPS_REL = 1e-4


def path_of(name: str) -> str:
    return str(ASP_DIR / name)


def sha256(data) -> str:
    if isinstance(data, np.ndarray):
        data = np.ascontiguousarray(data).tobytes()
    return hashlib.sha256(data).hexdigest()


def decode_all(path: str):
    """(RGB, (Y, U, V)) of every frame, in output order, through one decoder."""
    idx = video.index(path)
    decoder = idx.decoder()
    out = []
    with open(path, 'rb') as f:
        for i in range(idx.n_frames):
            out += decoder.decode(idx.packet(i, f), planes=True)
    return out + decoder.flush(planes=True)


def test_manifest_lists_every_asp_fixture():
    on_disk = sorted(p.name for p in ASP_DIR.iterdir() if p.suffix in ('.mp4', '.avi', '.mkv'))
    assert on_disk == NAMES
    for name in NAMES:
        assert sha256((ASP_DIR / name).read_bytes()) == MANIFEST[name]['file_sha256']
    assert sum((ASP_DIR / n).stat().st_size for n in NAMES) < 1.5 * 2 ** 20
    assert sorted(INTERLACED) == sorted(set(NAMES) - set(CV2_NAMES))


@pytest.mark.parametrize('name', NAMES)
def test_asp_packets_and_key_frames_equal_cv2s(name):
    idx = video.index(path_of(name))
    entry = MANIFEST[name]
    assert idx.kind == 'mp4v' and idx.n_frames == entry['cv2']['frame_count']
    assert [sha256(idx.packet(i)) for i in range(idx.n_frames)] == entry['packet_sha256']
    # cv2's key flags are FFmpeg's mpeg4 parser's (the first VOP an I-VOP):
    # a packed stream's placeholders of I-VOPs too, which Xvid leaves unflagged.
    assert idx.keyframes.tolist() == entry['key_frames']
    if not entry['tools']['packed_packets']:
        assert entry['key_frames'] == entry['written']['key_frames']
    assert (idx.width, idx.height) == (entry['cv2']['width'], entry['cv2']['height'])
    assert idx.n_decoded == entry['cv2']['frames_read'] == len(entry['lavc_sha256'])
    assert idx.frame_packets.tolist() == sorted(idx.frame_packets.tolist())


@pytest.mark.parametrize('name', NAMES)
def test_asp_planes_equal_ffmpeg_bit_for_bit(name):
    """Y, U and V equal FFmpeg's decoder's for every frame; luma equals
    cv2's raw read and RGB cv2's frames where cv2 has a picture, else
    FFmpeg's planes through libswscale (`rgb_from`)."""
    entry = MANIFEST[name]
    got = decode_all(path_of(name))
    assert [[sha256(p) for p in planes] for _, planes in got] == entry['lavc_sha256']
    assert [sha256(planes[0]) for _, planes in got] == entry['luma_sha256']
    assert entry['rgb_from'] == ('cv2' if entry['cv2_is_ffmpeg'] else 'lavc+swscale')
    assert [sha256(rgb) for rgb, _ in got] == entry['rgb_sha256']


@pytest.mark.parametrize('name', NAMES)
def test_asp_iter_frames_equal_sequential_reads(name):
    """iter_frames gives cv2's sequential read (interlaced: FFmpeg's
    decoder's frames through libswscale, as cv2 has no picture of them)."""
    got = [sha256(f) for f in video.iter_frames(path_of(name))]
    assert got == MANIFEST[name]['rgb_sha256']


@pytest.mark.parametrize('name', NAMES)
def test_asp_metadata_and_every_seek_equal_jax(name):
    """Frame count, rate and size equal JAX's (cv2's); imread('#frame=N')
    equals JAX's for every N and the seek table cv2 gave when the fixture
    was written (the N-th frame of the sequential read, or
    FileNotFoundError). Interlaced: JAX's frames are cv2's garbage (F14),
    so N is the N-th frame FFmpeg's decoder outputs, through libswscale."""
    path = path_of(name)
    entry = MANIFEST[name]
    np.testing.assert_array_equal(improc.video_extents(path), jax_improc.video_extents(path))
    assert improc.video_fps(path) == pytest.approx(jax_improc.video_fps(path), rel=FPS_REL)
    assert improc.num_frames_of_video(path) == jax_improc.num_frames_of_video(path) == \
        entry['cv2']['frame_count']
    video._STREAMS.clear()
    if not entry['cv2_is_ffmpeg']:
        want = entry['rgb_sha256']
        order = list(range(len(want)))
        random.Random(name).shuffle(order)
        for n in order:
            assert sha256(improc.imread(f'{path}#frame={n}')) == want[n]
        for n in (len(want), len(want) + 1):
            with pytest.raises(FileNotFoundError):
                improc.imread(f'{path}#frame={n}')
        return
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


def header_tools(name: str) -> dict:
    idx = video.index(path_of(name))
    return stream_tools([idx.packet(i) for i in range(idx.n_frames)])


def decoder_stats(name: str) -> dict:
    idx = video.index(path_of(name))
    decoder = idx.decoder()
    for i in range(idx.n_frames):
        decoder.decode(idx.packet(i))
    return decoder.stats()


def open_gop_b_vops(name: str) -> int:
    """B-VOPs coded after an I-VOP that they precede in display order."""
    idx = video.index(path_of(name))
    entry = MANIFEST[name]
    pts, n = entry['written']['pts'], 0
    types = []
    for i in range(idx.n_frames):
        vops = [p for c, p in _units(idx.packet(i)) if c == 0xb6]
        types.append('IPBS'[vops[0][0] >> 6])
    for i, t in enumerate(types):
        if t == 'I':
            j = i + 1
            while j < len(types) and types[j] == 'B':
                n += pts[j] < pts[i]
                j += 1
    return n


# name: (what the headers must carry, what the decoder must meet in the MBs)
TOOLS = {
    'xvid_asp_bvop.avi': (lambda t, v: t['vop_types']['B'] > 0 and v['low_delay'] == 0,
                          lambda s: s['direct_mbs'] > 0),
    'xvid_asp_bvop_closed.avi': (lambda t, v: t['vop_types']['B'] > 0, lambda s: s['b_vops'] > 0),
    'xvid_asp_packed.avi': (lambda t, v: t['packed_packets'] > 0 and t['not_coded'] > 0 and
                            'DivX503b1393p' in t['user_data'] and 'XviD0069' in t['user_data'],
                            lambda s: s['packed_vops'] > 0),
    'xvid_asp_mpegquant.avi': (lambda t, v: v['quant_type'] == 1 and
                               v['intra_matrix'] is None is v['inter_matrix'],
                               lambda s: s['p_vops'] > 0),
    'xvid_asp_mpegquant_custom.avi': (lambda t, v: v['quant_type'] == 1 and v['intra_matrix'] and
                                      v['inter_matrix'], lambda s: s['p_vops'] > 0),
    'xvid_asp_qpel.avi': (lambda t, v: v['quarter_sample'] == 1 and t['vop_types']['B'] > 0,
                          lambda s: s['quarter_pel_vectors'] > 0 and s['four_mv_mbs'] > 0
                          and s['direct_mbs'] > 0),
    'xvid_asp_gmc.avi': (lambda t, v: v['sprite_enable'] == 2 and t['vop_types']['S'] > 0 and
                         v['sprite_warping_points'] == 3, lambda s: s['gmc_mbs'] > 0),
    'xvid_asp_interlaced.avi': (lambda t, v: v['interlaced'] == 1 and t['top_field_first'] > 0
                                and t['alternate_scan'] > 0 and t['vop_types']['B'] > 0,
                                lambda s: s['field_dct_mbs'] > 0),
    'lavc_asp_interlaced.avi': (lambda t, v: v['interlaced'] == 1 and t['vop_types']['B'] > 0,
                                lambda s: s['field_dct_mbs'] > 0 and s['field_mv_mbs'] > 0
                                and s['direct_field_mbs'] > 0),
    'lavc_asp_interlaced_qpel.avi': (lambda t, v: v['interlaced'] == 1 and v['quarter_sample']
                                     and v['quant_type'] == 1,
                                     lambda s: s['field_mv_mbs'] > 0 and s['four_mv_mbs'] > 0
                                     and s['quarter_pel_vectors'] > 0),
}
USUAL = (lambda t, v: t['vop_types']['B'] > 0 and t['vop_types']['S'] > 0 and
         t['packed_packets'] > 0 and v['quarter_sample'] == 1 and v['quant_type'] == 1 and
         v['sprite_enable'] == 2,
         lambda s: s['gmc_mbs'] > 0 and s['quarter_pel_vectors'] > 0 and s['packed_vops'] > 0)
TOOLS.update({n: USUAL for n in NAMES if 'usual' in n})


@pytest.mark.parametrize('name', sorted(TOOLS))
def test_each_asp_clip_carries_its_tool(name):
    """Read from the file's own headers (and so recorded in the manifest),
    and met by the decoder in its MBs: a fixture that lacks its tool fails."""
    headers, mbs = TOOLS[name]
    tools = header_tools(name)
    assert headers(tools, tools['vol'])
    recorded = MANIFEST[name]['tools']
    assert recorded['vop_types'] == tools['vop_types']
    assert recorded['vol']['quarter_sample'] == tools['vol']['quarter_sample']
    assert mbs(decoder_stats(name))


def test_open_and_closed_gops_as_xvid_writes_them():
    """Without XVID_GLOBAL_CLOSED_GOP, B-VOPs follow an I-VOP they precede
    (FFmpeg skips them after a seek there); with it, none does. Both decode
    as cv2 reads them, and the open GOP's I-VOPs are entry points whose
    first frame is the I-VOP's."""
    assert open_gop_b_vops('xvid_asp_bvop.avi') > 0
    assert open_gop_b_vops('xvid_asp_bvop_closed.avi') == 0
    idx = video.index(path_of('xvid_asp_bvop.avi'))
    pts = MANIFEST['xvid_asp_bvop.avi']['written']['pts']
    keys = [int(k) for k in np.flatnonzero(idx.keyframes)]
    assert [(s, f) for s, f, _ in idx.entries] == [(k, pts[k]) for k in keys]


def test_custom_matrices_are_read_to_their_end_of_matrix_zero():
    """The custom fixture's VOL carries Xvid's matrices in zigzag order
    ended by a zero, the default fixture none."""
    from _torch_mp4v_headers import parse_vol
    zigzag = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48,
              41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15,
              23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]
    vol = parse_vol(next(p for c, p in _units(video.index(
        path_of('xvid_asp_mpegquant_custom.avi')).packet(0)) if 0x20 <= c <= 0x2f))
    assert vol['intra_matrix'] == [INTRA_MATRIX[z] for z in zigzag]
    assert vol['inter_matrix'] == [INTER_MATRIX[z] for z in zigzag]


def test_packed_xvid_streams_divx_stamp_does_not_refuse_it(tmp_path):
    """Xvid's packed mode stamps DivX503b1393p beside XviD0069: the Xvid
    stamp wins (FFmpeg drops the DivX version where both are present), so the
    stream decodes through FFmpeg's Xvid IDCT as cv2 reads it. Without the
    Xvid stamp it is a DivX stream, refused."""
    name = 'xvid_asp_packed.avi'
    assert [sha256(y) for _, (y, _, _) in decode_all(path_of(name))] == \
        MANIFEST[name]['luma_sha256']
    src = video.index(path_of(name))
    path = str(tmp_path / 'divx_only.avi')
    with open(path, 'wb') as f:
        mux = video._AviMuxer(f, src.width, src.height, src.fps, b'XVID')
        for i in range(src.n_frames):
            mux.write(src.packet(i).replace(b'\x00\x00\x01\xb2XviD0069', b''),
                      bool(src.keyframes[i]))
        mux.close()
    with pytest.raises(video.UnsupportedVideo, match='DivX'):
        list(video.iter_frames(path))


def test_asp_in_order_reads_decode_each_frame_once(monkeypatch):
    """Frames read in order (one thread; 8 I/O threads, each indexing the
    file at once; and the threads of one batch in any order) decode each
    VOP once: a packed stream's stored B-VOPs and an open GOP's across the
    boundaries too."""
    for name in ('xvid_asp_usual_320x568.mkv', 'xvid_asp_bvop.avi', 'xvid_asp_packed.avi'):
        path = path_of(name)
        n = MANIFEST[name]['cv2']['frames_read']
        video._STREAMS.clear()
        before = mpeg4.frames_decoded()
        assert [sha256(improc.imread(f'{path}#frame={i}')) for i in range(n)] == \
            MANIFEST[name]['rgb_sha256']
        assert mpeg4.frames_decoded() - before == n
        before = mpeg4.frames_decoded()
        assert len(list(video.iter_frames(path))) == n
        assert mpeg4.frames_decoded() - before == n
    name = 'xvid_asp_usual_96x66.mkv'
    path = path_of(name)
    n = MANIFEST[name]['cv2']['frames_read']
    parse = video._index_matroska

    def slow_parse(*args):
        time.sleep(0.05)
        return parse(*args)

    monkeypatch.setattr(video, '_index_matroska', slow_parse)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for seed in range(4):
            video._STREAMS.clear()
            video._INDEX_CACHE.clear()
            rng = random.Random(seed)
            before = mpeg4.frames_decoded()
            got = []
            with ThreadPoolExecutor(8) as pool:
                for chunk in range(0, n, 8):
                    order = list(range(chunk, min(chunk + 8, n)))
                    rng.shuffle(order)
                    frames = list(pool.map(improc.imread, [f'{path}#frame={i}' for i in order]))
                    got += sorted(zip(order, [sha256(f) for f in frames]))
            assert [h for _, h in got] == MANIFEST[name]['rgb_sha256']
            assert mpeg4.frames_decoded() - before == n, seed
    finally:
        sys.setswitchinterval(interval)


def test_asp_random_access_decodes_from_the_entry_point():
    """Far from the decoder's position, a frame decodes from the last entry
    point before it; a packed stream's key-flagged placeholder, whose
    stored B-VOP comes from the packet before, is none."""
    name = 'xvid_asp_packed.avi'
    path = path_of(name)
    idx = video.index(path)
    starts = [s for s, _, _ in idx.entries]
    assert starts[0] == 0 and set(starts) < set(np.flatnonzero(idx.keyframes).tolist()) | {0}
    assert 10 not in starts and 20 not in starts  # placeholders of I-VOPs packed with a B-VOP
    video._STREAMS.clear()
    before = mpeg4.frames_decoded()
    improc.imread(f'{path}#frame=23')
    last = max(s for s in starts)
    assert 0 < last and mpeg4.frames_decoded() - before < 24 - idx.first_frames[last] + 2


def test_f13_a_final_not_coded_vop_gives_the_last_frame_again(tmp_path):
    """F13: FFmpeg outputs the last frame again at the end of a low-delay
    stream whose last VOP is not coded, so cv2 reads 4 frames of a 4-packet
    stream whose packet 3 is not coded (the port read 3 before): frame 3 is
    frame 2 again, for the port as for JAX."""
    path = str(tmp_path / 'final_skip.mp4')
    frames = shifted_frames(4, (96, 66))
    encoder = mpeg4.Encoder(96, 66, 10.0, not_coded_every=3)
    with open(path, 'wb') as f:
        mux = mp4.Mp4Muxer(f, 96, 66, encoder.time_resolution, encoder.time_increment,
                           encoder.config)
        for frame in frames:
            mux.write(*encoder.encode(frame))
        mux.close()
    rgb, meta = cv2_read(path)
    assert meta['frame_count'] == 4 and len(rgb) == 4
    got = list(video.iter_frames(path))
    assert len(got) == 4 and video.index(path).n_decoded == 4
    for f, bgr in zip(got, rgb):
        np.testing.assert_array_equal(f, bgr[..., ::-1])
    np.testing.assert_array_equal(got[3], got[2])
    for i in (3, 1):
        np.testing.assert_array_equal(improc.imread(f'{path}#frame={i}'),
                                      jax_improc.imread(f'{path}#frame={i}'))
    with pytest.raises(FileNotFoundError):
        improc.imread(f'{path}#frame=4')


def test_interlaced_frames_cv2_has_no_picture_of(tmp_path):
    """F14: cv2's swscale refuses interlaced frames, so cv2's RGB of an
    interlaced clip is unrelated to the video (its raw planes are not
    FFmpeg's either, and often change from read to read), while FFmpeg's
    decoder (libavcodec) gives the port's planes and the port's RGB is near
    the frames encoded."""
    name = 'lavc_asp_interlaced.avi'
    path = path_of(name)
    got = decode_all(path)
    assert [sha256(y) for y in cv2_lumas(path)] != [sha256(p[0]) for _, p in got]
    idx = video.index(path)
    lavc = lavc_decode([idx.packet(i) for i in range(idx.n_frames)])
    for (_, planes), want in zip(got, lavc):
        for p, w in zip(planes, want):
            np.testing.assert_array_equal(p, w)
    cv, _ = cv2_read(path)
    from _torch_mp4v_asp_fixtures import frames_for
    src = frames_for(len(got), (96, 66), True)
    port_err = np.mean([np.abs(f.astype(int) - s).mean() for (f, _), s in zip(got, src)])
    cv2_err = np.mean([np.abs(f[..., ::-1].astype(int) - s).mean() for f, s in zip(cv, src)])
    assert port_err < 8 < 40 < cv2_err


def vol_with(tool: str) -> bytes:
    """The usual fixture's VOS, VO and VOL (verid 2: quarter-pel, GMC with 3
    points, MPEG quantisation) with one more tool's bits set ('plain': none)."""
    from _torch_mp4v_headers import _Bits, parse_vol
    packet = video.index(path_of('xvid_asp_usual_96x66.avi')).packet(0)
    start = next(i for i in range(len(packet) - 4) if packet[i:i + 3] == b'\x00\x00\x01'
                 and 0x20 <= packet[i + 3] <= 0x2f) + 4
    end = packet.index(b'\x00\x00\x01', start)
    vol = parse_vol(packet[start:end])
    assert vol['ver_id'] == 2 and vol['sprite_enable'] == 2 and vol['not_8_bit'] == 0
    text = _Bits(packet[start:end]).bits
    sprite, tail = vol['at']['sprite_enable'], vol['at']['complexity_estimation_disable']
    # complexity_estimation_disable, resync_marker_disable, data_partitioned,
    # newpred_enable, reduced_resolution_vop_enable, scalability
    assert text[tail] == '1' and text[tail + 2:tail + 6] == '0000'
    edits = {'plain': (0, 0, ''),
             'static sprites': (sprite, 2, '01'),
             'GMC of other than 3': (sprite + 2, 6, '000010'),
             'sprite brightness change': (sprite + 10, 1, '1'),
             'not-8-bit': (vol['at']['not_8_bit'], 1, '1'),
             'complexity estimation': (tail, 1, '0'),
             'data partitioning': (tail + 2, 1, '10'),
             'newpred': (tail + 3, 1, '1000'),
             'reduced resolution': (tail + 4, 1, '1'),
             'scalability': (tail + 5, 1, '1')}
    where, n, put = edits[tool]
    text = text[:where] + put + text[where + n:]
    padded = text + '0' * (-len(text) % 8)
    body = int(padded, 2).to_bytes(len(padded) // 8, 'big')
    return packet[:start] + body + packet[end:packet.index(b'\x00\x00\x01\xb6')]


REFUSED = ['newpred', 'reduced resolution', 'scalability', 'data partitioning',
           'complexity estimation', 'GMC of other than 3', 'sprite brightness change',
           'not-8-bit', 'static sprites']


@pytest.mark.parametrize('tool', REFUSED)
def test_tools_still_refused_raise_naming_them(tool):
    """Each tool libxvidcore does not write (Xvid 1.3 writes no reduced
    resolution VOP either, whatever its flags say) raises by name, from the
    usual fixture's VOL with the tool's bits set."""
    assert mpeg4.Decoder(vol_with('plain')).width == 96
    with pytest.raises(video.UnsupportedVideo, match=tool):
        mpeg4.Decoder(vol_with(tool))


@pytest.mark.parametrize('stamp, fourcc, tool', [(b'XviD0032', b'XVID', 'Xvid streams'),
                                                 (b'', b'XVID', 'Xvid streams'),
                                                 (b'DivX503b1393p', b'DIVX', 'DivX')])
def test_old_xvid_and_divx_asp_streams_raise(tmp_path, stamp, fourcc, tool):
    """ASP streams FFmpeg decodes with bug workarounds (DivX, Xvid builds up
    to 32 or unstamped in an XVID AVI) stay refused."""
    src = video.index(path_of('xvid_asp_bvop.avi'))
    path = str(tmp_path / 'restamped.avi')
    with open(path, 'wb') as f:
        mux = video._AviMuxer(f, src.width, src.height, src.fps, fourcc)
        for i in range(src.n_frames):
            packet = src.packet(i)
            if b'XviD0069' in packet:
                packet = packet.replace(b'\x00\x00\x01\xb2XviD0069',
                                        b'\x00\x00\x01\xb2' + stamp if stamp else b'')
            mux.write(packet, bool(src.keyframes[i]))
        mux.close()
    with pytest.raises(video.UnsupportedVideo, match=tool):
        list(video.iter_frames(path))


def test_matroska_and_mp4_timestamps_of_b_vops(tmp_path):
    """The B-VOP clip's MP4 (ctts) and Matroska (presentation timestamps)
    read as its AVI, and its Matroska with timestamps in packet order (a
    remux of the AVI) reads so too, as cv2 reads it: the order comes from
    the VOP headers, whatever the container's timestamps say."""
    name = 'xvid_asp_bvop.avi'
    want = MANIFEST[name]['rgb_sha256']
    for other in ('xvid_asp_bvop.mp4', 'xvid_asp_bvop.mkv'):
        assert MANIFEST[other]['rgb_sha256'] == want
        pts = MANIFEST[other]['written']['pts']
        assert pts != sorted(pts)  # presentation times, out of packet order
        assert [sha256(f) for f in video.iter_frames(path_of(other))] == want
    src = video.index(path_of(name))
    packets = [src.packet(i) for i in range(src.n_frames)]
    path = tmp_path / 'remux.mkv'
    write_container(path, packets, src.keyframes.tolist(), (src.width, src.height), src.fps)
    rgb, _ = cv2_read(str(path))
    assert [sha256(f[..., ::-1]) for f in rgb] == want
    assert [sha256(f) for f in video.iter_frames(str(path))] == want


def test_simple_profile_fixtures_still_one_frame_per_packet():
    """The Simple Profile clips (cv2's and Xvid's, low delay) keep one frame
    per packet through the reordering path, each an entry point at its key
    frames."""
    for name in ('mp4v_92x66.avi', 'xvid_96x66.mkv'):
        idx = video.index(str(MP4V_DIR / name))
        assert idx.frame_packets.tolist() == list(range(idx.n_frames))
        keys = np.flatnonzero(idx.keyframes).tolist()
        assert [(s, f) for s, f, _ in idx.entries] == [(k, k) for k in keys]


@pytest.mark.parametrize('name', ['xvid_asp_bvop.avi', 'xvid_asp_packed.avi'])
def test_stream_cut_at_an_open_gops_i_vop_reads_as_cv2(tmp_path, name):
    """A clip cut at an open GOP's I-VOP (its B-VOPs, coded after it, need
    the anchor before the cut): FFmpeg skips them, so cv2 reads fewer frames
    than the container counts. The port's count, frames and every seek equal
    cv2's and JAX's; num_frames_of_video stays the container's."""
    src = video.index(path_of(name))
    cut = int(np.flatnonzero(src.keyframes)[1])
    path = str(tmp_path / f'cut{name[-4:]}')
    with open(path, 'wb') as f:
        mux = video._AviMuxer(f, src.width, src.height, src.fps, b'XVID')
        first = src.packet(0)
        vol = first[:first.index(b'\x00\x00\x01\xb6')]
        for i in range(cut, src.n_frames):
            packet = src.packet(i)
            mux.write(vol + packet if i == cut else packet, bool(src.keyframes[i]))
        mux.close()
    rgb, meta = cv2_read(path)
    assert meta['frame_count'] == src.n_frames - cut > len(rgb)
    idx = video.index(path)
    assert idx.n_decoded == len(rgb)
    want = [sha256(f[..., ::-1]) for f in rgb]
    assert [sha256(f) for f in video.iter_frames(path)] == want
    assert improc.num_frames_of_video(path) == jax_improc.num_frames_of_video(path) == \
        src.n_frames - cut
    for n in range(len(rgb) + 1):
        if n == len(rgb):
            with pytest.raises(FileNotFoundError):
                improc.imread(f'{path}#frame={n}')
            continue
        got = improc.imread(f'{path}#frame={n}')
        np.testing.assert_array_equal(got, jax_improc.imread(f'{path}#frame={n}'))
