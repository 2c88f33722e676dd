"""The port's mp4v layer (`csrc/mpeg4_video.cpp`, `data/mpeg4.py`,
`data/mp4.py` and the mp4v paths of `data/video.py` and `data/improc.py`)
against OpenCV's FFmpeg backend and the JAX package's helpers, on the clips
cv2 wrote into `tests/torch_fixtures/mp4v/` (`python
tests/_torch_mp4v_fixtures.py`) and on files written here:

- the demuxers (MP4, AVI, Matroska) find cv2's packets, byte for byte, and
  its key frames;
- every frame's luma plane equals FFmpeg's (`CAP_PROP_CONVERT_RGB` 0) bit
  for bit, I-VOPs and P-VOPs across a GOP boundary, and the RGB frames equal
  `cv2.VideoCapture`'s (RGB_TOL: no level off on these even-height frames,
  so no drift over a GOP either);
- `video_extents`, `video_fps`, `num_frames_of_video` and
  `imread('#frame=N')` equal JAX's (the NTSC rate within FPS_REL);
- cv2 reads every file the port writes, in the three containers and at an
  odd size, with its frame count, rate and size, and its luma equals the
  port's decode and the encoder's reconstruction;
- the encoder against cv2's own mp4v on 24 shifted 1080x1920 frames: PSNR
  no more than PSNR_MARGIN_DB below, bytes at most BYTES_RATIO times;
- the tools cv2's stream never uses, written by the port's encoder (AC
  prediction, dquant, 4MV, video packets, the DC through the AC table):
  FFmpeg's luma planes equal the port's; a not-coded VOP gives no frame, as
  FFmpeg gives none: the frames, their count and `imread('#frame=N')` are
  cv2's and JAX's;
- libxvidcore's clips (Xvid-stamped, in `tests/torch_fixtures/mp4v/` with
  the cv2 ones) decode through FFmpeg's Xvid IDCT, equal to FFmpeg bit for
  bit, while a Lavc-stamped XVID AVI keeps the simple IDCT and unstamped
  XVID or DivX streams, which FFmpeg decodes with bug workarounds, raise;
- RGB equals `cv2.VideoCapture`'s at odd heights (swscale's scaler path)
  and odd widths;
- frames read in order, through `iter_frames` or `predict_common`'s I/O
  pool, are each decoded once, whatever order the threads ask in;
- the Advanced Simple VOLs (interlaced, quarter-pel, MPEG quantisation)
  read; newpred, reduced resolution, scalability, not-8-bit, static
  sprites, data partitioning, non-rectangular shape, S-VOPs without GMC and
  VP9 raise UnsupportedVideo naming the tool or codec, and a B-VOP with one
  anchor before it gives no frame, as FFmpeg skips it
  (`tests/test_torch_mp4v_asp.py` holds the Advanced Simple streams);
- `transform_video` on JAX's layout: the port's output is no further from
  the inverted frames than JAX's (cv2's encoder) by TRANSFORM_MARGIN.
"""

import hashlib
import io
import json
import time
from concurrent.futures import ThreadPoolExecutor

import cv2
import numpy as np
import pytest

from _torch_mp4v_fixtures import (CASES, MP4V_DIR, XVID_CASES, cv2_lumas, cv2_read, cv2_write,
                                  shifted_frames)
from _torch_train import one_torch_thread  # noqa: F401 (fixture)
from metrabs_tpu.data import improc as jax_improc
from metrabs_tpu_torch.data import improc, mp4, mpeg4, video

pytestmark = pytest.mark.usefixtures('one_torch_thread')

MANIFEST = json.loads((MP4V_DIR / 'manifest.json').read_text())
NAMES = [name for name, *_ in CASES] + [name for name, *_ in XVID_CASES]
RGB_TOL = dict(mean=0.0, max=0)  # levels of uint8 RGB against cv2.VideoCapture, per frame
DRIFT_TOL = 0.5  # mean levels: the last P-VOP of a GOP against its I-VOP's error
FPS_REL = 1e-4  # cv2 reports the 30000/1001 clip as 29.97
PSNR_MARGIN_DB = 0.5
BYTES_RATIO = 1.5
TRANSFORM_MARGIN = 0.5  # mean levels: the port's transform_video output against JAX's


def path_of(name: str) -> str:
    return str(MP4V_DIR / name)


def sha256(data) -> str:
    if isinstance(data, np.ndarray):
        data = np.ascontiguousarray(data).tobytes()
    return hashlib.sha256(data).hexdigest()


def decode_all(path: str):
    """(RGB, luma) of every packet's frame through one decoder: these streams
    have no B-VOPs, so each packet outputs its own frame, or none for a VOP
    that is not coded, whose frame is the one before (as cv2 gives it)."""
    idx = video.index(path)
    decoder = mpeg4.Decoder(idx.config, path)
    out = []
    with open(path, 'rb') as f:
        for i in range(idx.n_frames):
            out += decoder.decode(idx.packet(i, f), luma=True) or out[-1:]
    return out


def test_manifest_lists_every_fixture():
    on_disk = sorted(p.name for p in MP4V_DIR.iterdir() if p.suffix in ('.mp4', '.avi', '.mkv'))
    assert on_disk == sorted(NAMES) == sorted(MANIFEST)
    for name in NAMES:
        assert sha256((MP4V_DIR / name).read_bytes()) == MANIFEST[name]['file_sha256']


@pytest.mark.parametrize('name', NAMES)
def test_packets_and_key_frames_equal_cv2s(name):
    idx = video.index(path_of(name))
    assert idx.kind == 'mp4v' and idx.n_frames == MANIFEST[name]['cv2']['frames_read']
    assert [sha256(idx.packet(i)) for i in range(idx.n_frames)] == \
        MANIFEST[name]['packet_sha256']
    # An I-VOP every 12 frames, as cv2 writes: the container flags them.
    np.testing.assert_array_equal(np.flatnonzero(idx.keyframes), [0, 12])
    assert (idx.width, idx.height) == (MANIFEST[name]['cv2']['width'],
                                       MANIFEST[name]['cv2']['height'])


@pytest.mark.parametrize('name', NAMES)
def test_luma_equals_ffmpeg_bit_for_bit(name):
    got = decode_all(path_of(name))
    assert [sha256(y) for _, y in got] == MANIFEST[name]['luma_sha256']
    for (_, y), want in zip(got, cv2_lumas(path_of(name))):
        np.testing.assert_array_equal(y, want)


@pytest.mark.parametrize('name', NAMES)
def test_rgb_equals_videocapture(name):
    frames = list(video.iter_frames(path_of(name)))
    want, _ = cv2_read(path_of(name))
    assert len(frames) == len(want)
    errors = []
    for got, bgr in zip(frames, want):
        diff = np.abs(got.astype(np.int32) - bgr[..., ::-1])
        assert diff.mean() <= RGB_TOL['mean'] and diff.max() <= RGB_TOL['max']
        errors.append(diff.mean())
    assert errors[11] <= errors[0] + DRIFT_TOL  # the GOP's last P-VOP against its I-VOP
    assert [sha256(f) for f in frames] == MANIFEST[name]['rgb_sha256']


@pytest.mark.parametrize('name', NAMES)
def test_metadata_and_imread_equal_jax(name):
    path = path_of(name)
    np.testing.assert_array_equal(improc.video_extents(path), jax_improc.video_extents(path))
    assert improc.video_fps(path) == pytest.approx(jax_improc.video_fps(path), rel=FPS_REL)
    assert improc.num_frames_of_video(path) == jax_improc.num_frames_of_video(path)
    for i in (13, 0, 11, 12, 5):  # backwards and forwards, across the GOP boundary
        np.testing.assert_array_equal(improc.imread(f'{path}#frame={i}'),
                                      jax_improc.imread(f'{path}#frame={i}'))


@pytest.mark.parametrize('ext', ['.mp4', '.avi', '.mkv'])
@pytest.mark.parametrize('size, fps', [((93, 67), 10.0), ((320, 568), 30000 / 1001)])
def test_written_files_read_by_cv2(tmp_path, ext, size, fps):
    path = str(tmp_path / f'port{ext}')
    frames = shifted_frames(14, size)
    recon = []
    with video.VideoWriter(path, fps, size, 'mp4v') as writer:
        for frame in frames:
            writer.write(frame)
            recon.append(writer.encoder.reconstruction()[0])
    bgr, meta = cv2_read(path)
    assert len(bgr) == meta['frame_count'] == 14
    assert (meta['width'], meta['height']) == size
    assert meta['fps'] == pytest.approx(fps, rel=FPS_REL)
    idx = video.index(path)
    assert (idx.width, idx.height, idx.n_frames) == (*size, 14)
    assert idx.fps == pytest.approx(fps, rel=1e-6)
    np.testing.assert_array_equal(np.flatnonzero(idx.keyframes), [0, 12])
    got = decode_all(path)
    for (_, y), want, r in zip(got, cv2_lumas(path), recon):
        np.testing.assert_array_equal(y, want)
        np.testing.assert_array_equal(y, r)


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float(10 * np.log10(255.0 ** 2 / mse))


def test_encoder_quality_and_size_against_cv2(tmp_path):
    frames = shifted_frames(24)
    ours, theirs = str(tmp_path / 'port.mp4'), str(tmp_path / 'cv2.mp4')
    with video.VideoWriter(ours, 25.0, (1080, 1920), 'mp4v') as writer:
        for frame in frames:
            writer.write(frame)
    cv2_write(theirs, frames, 25.0)
    quality = {}
    for path in (ours, theirs):
        read, _ = cv2_read(path)
        assert len(read) == 24
        quality[path] = np.mean([psnr(bgr[..., ::-1], f) for bgr, f in zip(read, frames)])
    port_bytes = sum(video.index(ours).sizes)
    cv2_bytes = sum(video.index(theirs).sizes)
    assert quality[ours] >= quality[theirs] - PSNR_MARGIN_DB, quality
    assert port_bytes <= BYTES_RATIO * cv2_bytes, (port_bytes, cv2_bytes)


def test_one_decode_per_frame_in_order(monkeypatch):
    path = path_of('mp4v_320x568.mkv')
    n = MANIFEST['mp4v_320x568.mkv']['cv2']['frames_read']
    before = mpeg4.frames_decoded()
    assert len(list(video.iter_frames(path))) == n
    assert mpeg4.frames_decoded() - before == n
    # predict_common's I/O pool: eight threads read '#frame=i' in order, and
    # each indexes the file at once (the parse slowed, so that they overlap).
    parse = video._index_matroska

    def slow_parse(*args):
        time.sleep(0.05)
        return parse(*args)

    monkeypatch.setattr(video, '_index_matroska', slow_parse)
    video._STREAMS.clear()
    video._INDEX_CACHE.clear()
    before = mpeg4.frames_decoded()
    with ThreadPoolExecutor(8) as pool:
        frames = list(pool.map(improc.imread, [f'{path}#frame={i}' for i in range(n)]))
    assert mpeg4.frames_decoded() - before == n
    assert [sha256(f) for f in frames] == MANIFEST['mp4v_320x568.mkv']['rgb_sha256']
    # The threads of one batch ask across a GOP boundary in any order.
    for order in ([12, 8, 13, 9, 11, 10], [13, 12, 11, 10, 9, 8], [8, 13, 12, 9, 10, 11],
                  [13, 8, 12, 9]):
        video._STREAMS.clear()
        improc.imread(f'{path}#frame=7')
        before = mpeg4.frames_decoded()
        for i in order:
            improc.imread(f'{path}#frame={i}')
        assert mpeg4.frames_decoded() - before == len(order)
    # Far from the decoder's position, a frame decodes from its GOP's key
    # frame: 12 then 13; then 0 to 5.
    video._STREAMS.clear()
    for i, decodes in ((13, 2), (5, 6), (4, 0)):
        before = mpeg4.frames_decoded()
        improc.imread(f'{path}#frame={i}')
        assert mpeg4.frames_decoded() - before == decodes


class Bits:
    def __init__(self):
        self.bits = []

    def put(self, value: int, n: int):
        self.bits += [(value >> (n - 1 - k)) & 1 for k in range(n)]
        return self

    def stuffing(self):
        self.put(0, 1)
        while len(self.bits) % 8:
            self.put(1, 1)
        return self

    def bytes(self) -> bytes:
        return np.packbits(np.asarray(self.bits, np.uint8)).tobytes()


def vol(verid=1, interlaced=0, sprite=0, quant_type=0, quarter_pel=0, partitioned=0,
        shape=0, not_8_bit=0, newpred=0, reduced=0, scalability=0) -> bytes:
    """VOS, VO and a VOL of 64x48 with the given tools."""
    b = Bits()
    b.put(0x1b0, 32).put(1, 8).put(0x1b5, 32).put(1, 1).put(1, 4).put(1, 3).put(1, 4).put(0, 1)
    b.stuffing()
    b.put(0x100, 32).put(0x120, 32)
    b.put(0, 1).put(1, 8).put(1, 1).put(verid, 4).put(1, 3).put(1, 4)
    b.put(1, 1).put(1, 2).put(1, 1).put(0, 1)  # vol_control_parameters
    b.put(shape, 2).put(1, 1).put(25, 16).put(1, 1).put(0, 1)
    b.put(1, 1).put(64, 13).put(1, 1).put(48, 13).put(1, 1)
    b.put(interlaced, 1).put(1, 1).put(sprite, 1 if verid == 1 else 2)
    b.put(not_8_bit, 1)
    if not_8_bit:
        b.put(5, 4).put(8, 4)  # quant_precision, bits_per_pixel
    b.put(quant_type, 1)
    if quant_type:
        b.put(0, 2)  # default matrices
    if verid != 1:
        b.put(quarter_pel, 1)
    b.put(1, 1).put(1, 1).put(partitioned, 1)
    if partitioned:
        b.put(0, 1)
    if verid != 1:
        b.put(newpred, 1)
        if newpred:
            b.put(0, 3)  # requested_upstream_message_type, newpred_segment_type
        b.put(reduced, 1)
    b.put(scalability, 1).stuffing()
    return b.bytes()


def with_vop_type(packet: bytes, vop_type: int) -> bytes:
    at = packet.index(b'\x00\x00\x01\xb6') + 4
    return packet[:at] + bytes([(packet[at] & 0x3f) | (vop_type << 6)]) + packet[at + 1:]


def write_mp4(path: str, frames, fps: float = 25.0, **tools):
    """frames through mpeg4.Encoder with `tools` into an MP4 file; returns
    the encoder's reconstructed luma planes."""
    h, w = frames[0].shape[:2]
    encoder = mpeg4.Encoder(w, h, fps, **tools)
    recon = []
    with open(path, 'wb') as f:
        mux = mp4.Mp4Muxer(f, w, h, encoder.time_resolution, encoder.time_increment,
                           encoder.config)
        for frame in frames:
            mux.write(*encoder.encode(frame))
            recon.append(encoder.reconstruction()[0])
        mux.close()
    return recon


CODING_TOOLS = {
    'ac_pred': dict(ac_pred=True), 'dquant': dict(dquant=True), '4mv': dict(four_mv=True),
    'packets_of_7': dict(packet_mbs=7), 'dc_through_ac': dict(dc_threshold=1, qscale=14),
    'dc_threshold_dquant': dict(dc_threshold=3, dquant=True, qscale=16),
    'all': dict(ac_pred=True, dquant=True, four_mv=True, packet_mbs=9, dc_threshold=2)}


@pytest.mark.parametrize('tool', list(CODING_TOOLS))
@pytest.mark.parametrize('size', [(93, 67), (320, 568)])
def test_coding_tools_decode_as_ffmpeg(tmp_path, tool, size):
    """The tools cv2's stream never uses (AC prediction and the alternate
    scans, dquant with the AC rescale, 4MV with its chroma rounding and
    clips, video packets, the DC through the AC table), written by the
    encoder: FFmpeg's luma planes, the port's and the encoder's
    reconstruction are equal."""
    path = str(tmp_path / 'tools.mp4')
    recon = write_mp4(path, shifted_frames(14, size), **CODING_TOOLS[tool])
    want = cv2_lumas(path)
    assert len(want) == 14
    for (_, y), w, r in zip(decode_all(path), want, recon):
        np.testing.assert_array_equal(y, w)
        np.testing.assert_array_equal(y, r)


def test_not_coded_vops_repeat_the_reference(tmp_path):
    """A VOP with vop_coded 0 gives no frame, as FFmpeg gives none (cv2
    reads 12 of 14): the port's frames, their count and `imread('#frame=N')`
    equal cv2's and JAX's (N numbers the frames FFmpeg outputs, and past
    them raises); `num_frames_of_video` stays the container's 14, as JAX's
    CAP_PROP_FRAME_COUNT. The decoder itself repeats the reference."""
    path = str(tmp_path / 'skips.mp4')
    recon = write_mp4(path, shifted_frames(14, (93, 67)), not_coded_every=5)
    got = [y for _, y in decode_all(path)]
    for i in (5, 10):
        np.testing.assert_array_equal(got[i], got[i - 1])
    idx = video.index(path)
    assert idx.frame_packets.tolist() == [i for i in range(14) if i not in (5, 10)]
    assert improc.num_frames_of_video(path) == jax_improc.num_frames_of_video(path) == 14
    coded = [y for i, y in enumerate(got) if i not in (5, 10)]
    want = cv2_lumas(path)
    assert len(want) == len(coded) == 12
    for y, w, r in zip(coded, want, [r for i, r in enumerate(recon) if i not in (5, 10)]):
        np.testing.assert_array_equal(y, w)
        np.testing.assert_array_equal(y, r)
    rgb, _ = cv2_read(path)
    frames = list(video.iter_frames(path))
    assert len(frames) == len(rgb) == 12
    for f, bgr in zip(frames, rgb):
        np.testing.assert_array_equal(f, bgr[..., ::-1])
    for i in (11, 0, 4, 5, 9, 10, 6):
        np.testing.assert_array_equal(improc.imread(f'{path}#frame={i}'),
                                      jax_improc.imread(f'{path}#frame={i}'))
    for module in (improc, jax_improc):
        with pytest.raises(FileNotFoundError):
            module.imread(f'{path}#frame=12')


def xvid_avi(tmp_path, name: str, user_data: bytes = None, fourcc: bytes = b'XVID') -> str:
    """The Xvid fixture's packets in an AVI with `fourcc`, its user data
    replaced by `user_data` (b'': removed)."""
    src = str(MP4V_DIR / 'xvid_96x66.avi')
    idx = video.index(src)
    stamp = b'\x00\x00\x01\xb2XviD'
    path = str(tmp_path / name)
    with open(path, 'wb') as f:
        mux = video._AviMuxer(f, idx.width, idx.height, idx.fps, fourcc)
        for i in range(idx.n_frames):
            packet = idx.packet(i)
            if user_data is not None and stamp in packet:
                at = packet.index(stamp)
                end = packet.index(b'\x00\x00\x01', at + 4)
                packet = packet[:at] + (b'\x00\x00\x01\xb2' + user_data if user_data else b'') \
                    + packet[end:]
            mux.write(packet, bool(idx.keyframes[i]))
        mux.close()
    return path


def test_xvid_stamp_selects_ffmpegs_idct(tmp_path):
    """FFmpeg decodes Xvid-stamped streams with its Xvid IDCT and the others
    with its simple IDCT: the Xvid fixture restamped Lavc in an XVID AVI
    decodes through the simple IDCT, equal to FFmpeg and unlike the Xvid
    decode; without any stamp (FFmpeg's Xvid build 0, with its workarounds
    for old Xvid builds) and stamped DivX it raises."""
    xvid = [y for _, y in decode_all(str(MP4V_DIR / 'xvid_96x66.avi'))]
    lavc = xvid_avi(tmp_path, 'lavc.avi', b'Lavc61.19.100')
    got = [y for _, y in decode_all(lavc)]
    want = cv2_lumas(lavc)
    assert len(got) == len(want) == 14
    for y, w in zip(got, want):
        np.testing.assert_array_equal(y, w)
    assert any(not np.array_equal(a, b) for a, b in zip(got, xvid))
    for name, data, fourcc, tool in (('bare.avi', b'', b'XVID', 'Xvid streams'),
                                     ('old.avi', b'XviD0032', b'XVID', 'Xvid streams'),
                                     ('divx.avi', b'DivX503b1393p', b'DIVX', 'DivX')):
        with pytest.raises(video.UnsupportedVideo, match=tool):
            list(video.iter_frames(xvid_avi(tmp_path, name, data, fourcc)))
    # Without a stamp, an mp4v FourCC keeps the simple IDCT.
    bare = xvid_avi(tmp_path, 'bare_mp4v.avi', b'', b'FMP4')
    for y, w in zip((y for _, y in decode_all(bare)), cv2_lumas(bare)):
        np.testing.assert_array_equal(y, w)


@pytest.mark.parametrize('size', [(93, 67), (96, 67), (92, 65), (31, 17), (320, 569)])
def test_rgb_equals_videocapture_at_odd_sizes(tmp_path, size):
    """At an odd height swscale leaves its unscaled converter for its scaler
    (bicubic chroma, the MMX vertical filter, C tables for the last two rows;
    full chroma interpolation at an odd width): the port's RGB of its own
    mp4v equals cv2's on every frame."""
    path = str(tmp_path / 'odd.mp4')
    frames = shifted_frames(3, size) + [
        np.random.default_rng(size[0]).integers(0, 256, (size[1], size[0], 3), dtype=np.uint8)]
    write_mp4(path, frames)
    want, _ = cv2_read(path)
    got = list(video.iter_frames(path))
    assert len(got) == len(want) == 4
    for f, bgr in zip(got, want):
        np.testing.assert_array_equal(f, bgr[..., ::-1])


def test_rgb_of_odd_heights_below_9_rows_raises(tmp_path):
    """There swscale's vertical chroma filter has two taps and it takes a
    shortcut the port does not emulate."""
    path = str(tmp_path / 'tiny.mp4')
    write_mp4(path, shifted_frames(2, (48, 7)))
    with pytest.raises(video.UnsupportedVideo, match='odd height below 9'):
        list(video.iter_frames(path))


def top_level_boxes(data: bytes):
    pos, boxes = 0, []
    while pos < len(data):
        size = int.from_bytes(data[pos:pos + 4], 'big')
        if size == 1:
            size = int.from_bytes(data[pos + 8:pos + 16], 'big')
        boxes.append((data[pos + 4:pos + 8], data[pos:pos + size]))
        pos += size
    return boxes


def test_mp4_with_moov_first_reads(tmp_path):
    """cv2's MP4 laid out `moov` first (faststart), its chunk offsets moved
    by the moov's size: the same packets."""
    src = MP4V_DIR / 'mp4v_320x568.mp4'
    boxes = dict(top_level_boxes(src.read_bytes()))
    moov = bytearray(boxes[b'moov'])
    at = moov.index(b'stco') + 8
    n = int.from_bytes(moov[at:at + 4], 'big')
    for k in range(n):
        p = at + 4 + 4 * k
        moov[p:p + 4] = (int.from_bytes(moov[p:p + 4], 'big') + len(moov)).to_bytes(4, 'big')
    path = tmp_path / 'faststart.mp4'
    path.write_bytes(boxes[b'ftyp'] + bytes(moov) + b''.join(
        box for kind, box in top_level_boxes(src.read_bytes()) if kind not in (b'ftyp', b'moov')))
    a, b = video.index(str(src)), video.index(str(path))
    assert a.n_frames == b.n_frames == 14
    assert [a.packet(i) for i in range(14)] == [b.packet(i) for i in range(14)]


def test_mp4_muxer_switches_to_co64_past_4_gib(tmp_path):
    """Sample offsets past 4 GiB go into co64 (the offsets stand in for a
    file that large) and read back as written."""
    f = io.BytesIO()
    mux = mp4.Mp4Muxer(f, 64, 48, 25, 1, vol())
    mux.offsets, mux.sizes, mux.keys = [40, 1 << 32, (1 << 32) + 1000], [1000, 1000, 500], [1]
    moov = mux._moov()
    assert b'co64' in moov and b'stco' not in moov
    path = tmp_path / 'big.mp4'
    path.write_bytes(moov)
    with open(path, 'rb') as g:
        index = mp4.read_index(str(path), g, len(moov))
    assert index['offsets'].tolist() == mux.offsets and index['sizes'].tolist() == mux.sizes
    assert index['keyframes'].tolist() == [True, False, False] and index['fps'] == 25.0
    assert index['config'] == vol() and (index['width'], index['height']) == (64, 48)


TOOLS = {'newpred': dict(verid=2, newpred=1), 'reduced resolution': dict(verid=2, reduced=1),
         'scalability': dict(scalability=1), 'not-8-bit': dict(not_8_bit=1),
         'static sprites': dict(sprite=1), 'data partitioning': dict(partitioned=1),
         'non-rectangular shape': dict(shape=1)}
# Advanced Simple tools the decoder reads (tests/test_torch_mp4v_asp.py decodes them)
ASP_VOLS = [dict(interlaced=1), dict(verid=2, quarter_pel=1), dict(quant_type=1)]


@pytest.mark.parametrize('tool', list(TOOLS))
def test_advanced_simple_tools_raise_naming_them(tool):
    """The tools libxvidcore does not write raise by name; the plain VOL and
    the Advanced Simple ones (interlaced, quarter-pel, MPEG quantisation)
    read."""
    for tools in [{}] + ASP_VOLS:
        assert mpeg4.Decoder(vol(**tools)).width == 64
    with pytest.raises(video.UnsupportedVideo, match=tool):
        mpeg4.Decoder(vol(**TOOLS[tool]))


@pytest.mark.parametrize('vop_type, tool', [(2, None), (3, 'S-VOPs')])
def test_b_and_s_vops_raise_naming_them(vop_type, tool):
    """An S-VOP in a stream without GMC raises naming it; a B-VOP after one
    anchor (the I-VOP) gives no frame and no error, as FFmpeg skips a B-VOP
    without two anchors."""
    path = path_of('mp4v_92x66.mp4')
    idx = video.index(path)
    decoder = mpeg4.Decoder(idx.config, path)
    decoder.decode(idx.packet(0))
    packet = with_vop_type(idx.packet(1), vop_type)
    if tool is None:
        assert decoder.decode(packet) == [] and decoder.stats()['b_vops_skipped'] == 1
        return
    with pytest.raises(video.UnsupportedVideo, match=tool):
        decoder.decode(packet)


@pytest.mark.parametrize('ext, entry, codec', [('.mp4', b'mp4v', 'vp09'),
                                                ('.avi', b'mp4v', 'VP90'),
                                                ('.mkv', b'V_MPEG4/ISO/ASP', 'V_VP9')])
def test_other_codecs_in_each_container_raise_naming_them(tmp_path, ext, entry, codec):
    data = (MP4V_DIR / f'mp4v_92x66{ext}').read_bytes()
    assert entry in data
    path = tmp_path / f'clip{ext}'
    if ext == '.mkv':  # a longer CodecID: the port's muxer writes the file with it
        src = video.index(str(MP4V_DIR / 'mp4v_92x66.mkv'))
        with open(path, 'wb') as f:
            mux = video._MatroskaMuxer(f, src.width, src.height, src.fps, codec.encode(),
                                       src.config)
            for i in range(src.n_frames):
                mux.write(src.packet(i), bool(src.keyframes[i]))
            mux.close()
    else:
        path.write_bytes(data.replace(entry, codec.encode()))
    with pytest.raises(video.UnsupportedVideo, match=codec):
        improc.num_frames_of_video(str(path))
    with pytest.raises(NotImplementedError, match=codec):
        improc.imread(f'{path}#frame=0')


def test_transform_video_on_jaxs_layout(tmp_path):
    """JAX's test_transform_video_roundtrip (32x24, 10 fps, mp4v .mp4 in and
    out) through the port and through JAX, on the same source."""
    src = str(tmp_path / 'src.mp4')
    writer = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*'mp4v'), 10.0, (32, 24))
    for i in range(5):
        writer.write(np.full((24, 32, 3), i * 30, np.uint8))
    writer.release()
    np.testing.assert_array_equal(improc.video_extents(src), jax_improc.video_extents(src))
    assert improc.video_fps(src) == jax_improc.video_fps(src) == 10.0
    assert improc.num_frames_of_video(src) == jax_improc.num_frames_of_video(src) == 5
    for i in range(5):
        np.testing.assert_array_equal(improc.imread(f'{src}#frame={i}'),
                                      jax_improc.imread(f'{src}#frame={i}'))
    inverted = [255 - f for f in video.iter_frames(src)]
    errors = {}
    for name, module in (('port', improc), ('jax', jax_improc)):
        calls = []

        def fn(frame):
            calls.append(frame.shape)
            return 255 - frame

        dst = str(tmp_path / name / 'dst.mp4')
        module.transform_video(src, dst, fn)
        assert len(calls) == 5 and calls[0] == (24, 32, 3)
        assert jax_improc.num_frames_of_video(dst) == improc.num_frames_of_video(dst) == 5
        out = list(video.iter_frames(dst))
        assert out[0].mean() > 200  # the dark first frame comes back bright
        errors[name] = np.mean([np.abs(a.astype(int) - b).mean() for a, b in zip(out, inverted)])
    assert errors['port'] <= errors['jax'] + TRANSFORM_MARGIN, errors
