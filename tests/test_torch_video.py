"""The port's Motion JPEG video layer (`metrabs_tpu_torch/data/video.py` and
the video helpers of `data/improc.py`) against OpenCV's FFmpeg backend and
the JAX package's helpers, on the MJPG clips cv2 wrote into
`tests/torch_fixtures/video/` (`python tests/_torch_video_fixtures.py`):

- every packet the demuxers find decodes equal to `cv2.imdecode` of the same
  bytes, and to the manifest's hash (what the card checks);
- frames against `cv2.VideoCapture`, which decodes with FFmpeg's IDCT and
  swscale's chroma upsampling, within VIDEOCAPTURE_TOL (measured on the
  fixtures and the files these tests write: mean |difference| at most 3.07
  levels per frame; the largest single difference 55, at a chroma edge of a
  93x67 frame, where FFmpeg replicates chroma and libjpeg interpolates it);
- `imread('<video>#frame=N')` against JAX's `imread` within that tolerance;
- `video_extents`, `video_fps` and `num_frames_of_video` equal to JAX's on
  AVI; on Matroska equal but for the NTSC clip's frame rate: cv2 reports
  29.97 where the track's DefaultDuration (33366700 ns, to the nanosecond)
  gives 29.97000003;
- files the port writes are read by `cv2.VideoCapture` with their count,
  size and frame rate, odd sizes kept; the OpenDML index past the RIFF
  limit; a frame without Huffman tables; `transform_video` as JAX's test
  drives it; the mp4v that cv2 writes reads in each container, and every
  other codec or container raises, naming it.
"""

import hashlib
import json
import os
import shutil
import struct

import cv2
import numpy as np
import pytest

from _torch_video_fixtures import VIDEO_CASES, VIDEO_DIR, clip_frames
from metrabs_tpu.data import improc as jax_improc
from metrabs_tpu_torch.data import improc, jpeg, video

MANIFEST = json.loads((VIDEO_DIR / 'manifest.json').read_text())
NAMES = [name for name, *_ in VIDEO_CASES]
VIDEOCAPTURE_TOL = dict(mean=3.5, max=64)  # levels of uint8 RGB, per frame


def path_of(name: str) -> str:
    return str(VIDEO_DIR / name)


def capture_frames(path: str):
    cap = cv2.VideoCapture(path, cv2.CAP_FFMPEG)
    frames = []
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        frames.append(bgr[..., ::-1])
    meta = dict(count=cap.get(cv2.CAP_PROP_FRAME_COUNT), fps=cap.get(cv2.CAP_PROP_FPS),
                width=int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                height=int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
    cap.release()
    return frames, meta


def assert_close_to_capture(got: np.ndarray, want: np.ndarray) -> None:
    assert got.shape == want.shape
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.mean() <= VIDEOCAPTURE_TOL['mean'] and diff.max() <= VIDEOCAPTURE_TOL['max'], (
        diff.mean(), diff.max())


def rgb_digest(rgb: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(rgb).tobytes()).hexdigest()


def test_manifest_lists_every_fixture():
    on_disk = sorted(p.name for p in VIDEO_DIR.iterdir() if p.suffix in ('.avi', '.mkv'))
    assert on_disk == sorted(NAMES) == sorted(MANIFEST)
    for name in NAMES:
        data = (VIDEO_DIR / name).read_bytes()
        assert hashlib.sha256(data).hexdigest() == MANIFEST[name]['file_sha256']


@pytest.mark.parametrize('name', NAMES)
def test_packets_decode_equal_to_cv2_imdecode(name):
    idx = video.index(path_of(name))
    entry = MANIFEST[name]
    assert idx.n_frames == entry['cv2']['frames_read'] == len(entry['packet_sha256_rgb'])
    for i in range(idx.n_frames):
        packet = idx.packet(i)
        assert packet[:2] == b'\xff\xd8'
        want = cv2.imdecode(np.frombuffer(packet, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]
        got = idx.frame(i)
        np.testing.assert_array_equal(got, want)
        assert rgb_digest(got) == entry['packet_sha256_rgb'][i]


@pytest.mark.parametrize('name', NAMES)
def test_frames_against_videocapture(name):
    want, meta = capture_frames(path_of(name))
    got = list(video.iter_frames(path_of(name)))
    assert len(got) == len(want) == MANIFEST[name]['cv2']['frames_read']
    for g, w in zip(got, want):
        assert_close_to_capture(g, w)


@pytest.mark.parametrize('name', ['mjpg_320x568.avi', 'mjpg_320x568_ntsc.mkv', 'mjpg_93x67.avi'])
def test_imread_frame_against_jax(name):
    n = MANIFEST[name]['cv2']['frames_read']
    for i in sorted({0, 1, n // 2, n - 1}):
        got = improc.imread(f'{path_of(name)}#frame={i}')
        assert_close_to_capture(got, jax_improc.imread(f'{path_of(name)}#frame={i}'))
        np.testing.assert_array_equal(got, video.index(path_of(name)).frame(i))
    with pytest.raises(FileNotFoundError):
        improc.imread(f'{path_of(name)}#frame={n}')


@pytest.mark.parametrize('name', NAMES)
def test_metadata_against_jax(name):
    path = path_of(name)
    cv = MANIFEST[name]['cv2']
    np.testing.assert_array_equal(improc.video_extents(path), jax_improc.video_extents(path))
    np.testing.assert_array_equal(improc.video_extents(path), [cv['width'], cv['height']])
    assert improc.num_frames_of_video(path) == jax_improc.num_frames_of_video(path) == \
        cv['frame_count']
    if name == 'mjpg_320x568_ntsc.mkv':
        # cv2 wrote the rate as 2997/100: DefaultDuration 33366700 ns, whose
        # inverse is 29.97000003; cv2 reports FFmpeg's rational, 29.97.
        assert jax_improc.video_fps(path) == 29.97
        assert improc.video_fps(path) == 1e9 / 33366700 != 29.97
    else:
        assert improc.video_fps(path) == jax_improc.video_fps(path) == cv['fps']


def test_metadata_of_missing_file_raises(tmp_path):
    for fn in (improc.video_fps, improc.video_extents, improc.num_frames_of_video):
        with pytest.raises(FileNotFoundError):
            fn(str(tmp_path / 'nope.avi'))


def test_index_parsed_once_and_renewed_on_change(tmp_path):
    path = str(tmp_path / 'v.avi')
    shutil.copyfile(path_of('mjpg_93x67.avi'), path)
    first = video.index(path)
    assert video.index(path) is first
    shutil.copyfile(path_of('mjpg_320x568.avi'), path)
    os.utime(path, ns=(1, 1))
    assert video.index(path).width == 320


@pytest.mark.parametrize('ext', ['.avi', '.mkv'])
@pytest.mark.parametrize('size', [(96, 64), (93, 67)])
def test_written_files_read_by_videocapture(tmp_path, ext, size):
    w, h = size
    frames = clip_frames(7, size)
    path = str(tmp_path / f'out{ext}')
    with video.VideoWriter(path, 12.5, (w, h)) as writer:
        for frame in frames:
            writer.write(frame)
    want, meta = capture_frames(path)
    assert meta == dict(count=7, fps=12.5, width=w, height=h)
    idx = video.index(path)
    assert (idx.width, idx.height, idx.fps, idx.n_frames) == (w, h, 12.5, 7)
    for i, frame in enumerate(frames):
        packet = idx.packet(i)
        assert packet == jpeg.encode(frame)
        assert_close_to_capture(idx.frame(i), want[i])
    assert [f.shape for f in video.iter_frames(path)] == [(h, w, 3)] * 7


def test_matroska_clusters_split_every_second(tmp_path):
    path = str(tmp_path / 'long.mkv')
    frame = np.full((16, 24, 3), 90, np.uint8)
    with video.VideoWriter(path, 30000 / 1001, (24, 16)) as writer:
        for _ in range(75):
            writer.write(frame)
    assert (tmp_path / 'long.mkv').read_bytes().count(b'\x1f\x43\xb6\x75') == 3
    _, meta = capture_frames(path)
    assert meta['count'] == 75 and meta['fps'] == pytest.approx(30000 / 1001, rel=1e-4)
    assert improc.num_frames_of_video(path) == 75


def test_opendml_index_past_the_riff_limit(tmp_path, monkeypatch):
    """Past DEFAULT_RIFF_LIMIT the writer closes the RIFF with an ix00 chunk
    and goes on in AVIX extensions, with the indx super index in the header,
    as FFmpeg does past 1 GiB; cv2 and the port read every frame back."""
    monkeypatch.setattr(video, 'DEFAULT_RIFF_LIMIT', 4000)
    path = str(tmp_path / 'odml.avi')
    frames = [np.full((32, 48, 3), 20 * k, np.uint8) for k in range(11)]
    with video.VideoWriter(path, 25, (48, 32)) as writer:
        for frame in frames:
            writer.write(frame)
    data = (tmp_path / 'odml.avi').read_bytes()
    assert data.count(b'AVIX') >= 2 and b'indx' in data and b'ix00' in data
    idx = video.index(path)
    assert idx.n_frames == 11
    want, meta = capture_frames(path)
    assert meta['count'] == 11 and len(want) == 11
    for i, frame in enumerate(frames):
        assert idx.packet(i) == jpeg.encode(frame)
        assert_close_to_capture(idx.frame(i), want[i])


def strip_dht(packet: bytes) -> bytes:
    out, pos = bytearray(packet[:2]), 2
    while True:
        marker, length = packet[pos + 1], struct.unpack('>H', packet[pos + 2:pos + 4])[0]
        if marker != 0xC4:
            out += packet[pos:pos + 2 + length]
        if marker == 0xDA:
            return bytes(out + packet[pos + 2 + length:])
        pos += 2 + length


def test_frame_without_huffman_tables(tmp_path):
    """A fixture frame in the AVI1 convention (no DHT segment; the encoder's
    tables are the standard ones, FFmpeg's are optimised) decodes with the
    standard tables, as libjpeg-turbo and FFmpeg decode it."""
    rgb = video.index(path_of('mjpg_320x568.avi')).frame(3)
    packet = strip_dht(jpeg.encode(rgb))
    assert b'\xff\xc4' not in packet[:packet.index(b'\xff\xda')]
    path = str(tmp_path / 'nodht.avi')
    with video.VideoWriter(path, 25, (320, 568)) as writer:
        writer.write_packet(packet)
        writer.write_packet(packet)
    got = improc.imread(f'{path}#frame=1')
    np.testing.assert_array_equal(
        got, cv2.imdecode(np.frombuffer(packet, np.uint8), cv2.IMREAD_COLOR)[..., ::-1])
    np.testing.assert_array_equal(got, jpeg.decode(jpeg.encode(rgb)))
    want, _ = capture_frames(path)
    assert_close_to_capture(got, want[1])


def test_matroska_blockgroup_and_unknown_sizes(tmp_path):
    """A Segment and a Cluster of unknown size, frames in BlockGroups and a
    track without DefaultDuration (frame rate from the timestamps), as
    live-streaming muxers write them."""
    el, uint = video._element, video._uint_element
    frames = [np.full((16, 16, 3), v, np.uint8) for v in (30, 120, 210)]
    header = el(0x1A45DFA3, el(0x4282, b'matroska') + uint(0x4287, 4) + uint(0x4285, 2))
    tracks = el(0x1654AE6B, el(0xAE, uint(0xD7, 1) + uint(0x83, 1) + el(0x86, b'V_MJPEG')
                               + el(0xE0, uint(0xB0, 16) + uint(0xBA, 16))))
    blocks = b''.join(el(0xA0, el(0xA1, b'\x81' + struct.pack('>hB', 40 * k, 0)
                                  + jpeg.encode(f))) for k, f in enumerate(frames))
    unknown = b'\x01\xff\xff\xff\xff\xff\xff\xff'
    cluster = b'\x1f\x43\xb6\x75' + unknown + uint(0xE7, 0) + blocks
    path = tmp_path / 'live.mkv'
    path.write_bytes(header + b'\x18\x53\x80\x67' + unknown + tracks + cluster)
    idx = video.index(str(path))
    assert idx.n_frames == 3 and idx.fps == pytest.approx(25.0)
    for i, frame in enumerate(frames):
        np.testing.assert_array_equal(idx.frame(i), jpeg.decode(jpeg.encode(frame)))


def test_transform_video_like_jax(tmp_path):
    """JAX's test_transform_video_roundtrip on MJPG: the frame function sees
    every frame, the output has as many, and an inverted dark frame comes
    back bright."""
    src = str(tmp_path / 'src.avi')
    with video.VideoWriter(src, 10.0, (32, 24)) as writer:
        for i in range(5):
            writer.write(np.full((24, 32, 3), i * 30, np.uint8))
    calls = []

    def fn(frame):
        calls.append(frame.shape)
        return 255 - frame

    dst = str(tmp_path / 'sub' / 'dst.mkv')
    improc.transform_video(src, dst, fn)
    assert len(calls) == 5 and calls[0] == (24, 32, 3)
    assert improc.num_frames_of_video(dst) == 5 and improc.video_fps(dst) == 10.0
    cap = cv2.VideoCapture(dst)
    ok, frame = cap.read()
    cap.release()
    assert ok and frame.mean() > 200
    # JAX's default codec, mp4v, into MP4; MJPG as asked; any other raises naming it.
    improc.transform_video(src, str(tmp_path / 'x.mp4'), fn)
    assert video.index(str(tmp_path / 'x.mp4')).codec == 'mp4v'
    improc.transform_video(src, str(tmp_path / 'x.avi'), fn, fourcc='MJPG')
    assert video.index(str(tmp_path / 'x.avi')).codec == 'MJPG'
    with pytest.raises(NotImplementedError, match='avc1'):
        improc.transform_video(src, str(tmp_path / 'y.mp4'), fn, fourcc='avc1')


@pytest.mark.parametrize('ext, codec', [('.mp4', 'mp4v'), ('.avi', 'mp4v'), ('.mkv', 'V_MPEG4')])
def test_other_codecs_raise_naming_it(tmp_path, ext, codec):
    """The codec cv2 writes for the mp4v FourCC in each container reads
    (tests/test_torch_mp4v.py holds its frames to FFmpeg's); the same file
    with its codec renamed to VP9's raises naming that (H.264 and HEVC, the
    names this test used before the port read them, are
    tests/test_torch_h264.py's and tests/test_torch_hevc.py's)."""
    path = str(tmp_path / f'clip{ext}')
    writer = cv2.VideoWriter(path, cv2.CAP_FFMPEG, cv2.VideoWriter_fourcc(*'mp4v'), 10, (32, 24))
    assert writer.isOpened()
    for _ in range(3):
        writer.write(np.zeros((24, 32, 3), np.uint8))
    writer.release()
    assert video.index(path).codec.startswith(codec)
    assert improc.num_frames_of_video(path) == 3
    np.testing.assert_array_equal(improc.imread(f'{path}#frame=2'),
                                  jax_improc.imread(f'{path}#frame=2'))
    data = open(path, 'rb').read()
    entry = {'.mp4': b'mp4v', '.avi': b'mp4v', '.mkv': b'V_MPEG4/ISO/ASP'}[ext]
    other = {'.mp4': b'vp09', '.avi': b'VP90', '.mkv': b'V_VP9'}[ext]
    renamed = str(tmp_path / f'vp9{ext}')
    with open(renamed, 'wb') as f:
        if ext == '.mkv':  # a longer CodecID: the port's muxer writes the file with it
            src = video.index(path)
            mux = video._MatroskaMuxer(f, src.width, src.height, src.fps, other, src.config)
            for i in range(src.n_frames):
                mux.write(src.packet(i), bool(src.keyframes[i]))
            mux.close()
        else:
            f.write(data.replace(entry, other))
    with pytest.raises(NotImplementedError, match=other.decode()):
        improc.imread(f'{renamed}#frame=0')
    with pytest.raises(NotImplementedError, match=other.decode()):
        improc.num_frames_of_video(renamed)


def test_avi_without_an_index_raises(tmp_path):
    """An AVI whose idx1 chunk is gone (and that has no OpenDML indx) is
    refused rather than scanned."""
    data = (VIDEO_DIR / 'mjpg_93x67.avi').read_bytes()
    assert data.count(b'idx1') == 1
    path = tmp_path / 'noindex.avi'
    path.write_bytes(data.replace(b'idx1', b'JUNK').replace(b'indx', b'JUNK'))
    with pytest.raises(ValueError, match='without an index'):
        video.index(str(path))


def test_writer_refuses_other_codecs_and_containers(tmp_path):
    with pytest.raises(NotImplementedError, match='avc1'):
        video.VideoWriter(str(tmp_path / 'a.avi'), 25, (8, 8), fourcc='avc1')
    with pytest.raises(NotImplementedError, match='.mp4'):
        video.VideoWriter(str(tmp_path / 'a.mp4'), 25, (8, 8))  # MJPG into MP4
    with pytest.raises(NotImplementedError, match='.webm'):
        video.VideoWriter(str(tmp_path / 'a.webm'), 25, (8, 8), fourcc='mp4v')
    with video.VideoWriter(str(tmp_path / 'b.avi'), 25, (8, 8)) as writer:
        with pytest.raises(ValueError, match='8x8x3'):
            writer.write(np.zeros((8, 9, 3), np.uint8))


def test_video_audio_mux_needs_ffmpeg(tmp_path, monkeypatch):
    monkeypatch.setattr(shutil, 'which', lambda name: None)
    with pytest.raises(RuntimeError, match='ffmpeg'):
        improc.video_audio_mux('a.mkv', 'b.mkv', str(tmp_path / 'c.mkv'))
    with pytest.raises(RuntimeError, match='ffmpeg'):
        jax_improc.video_audio_mux('a.mkv', 'b.mkv', str(tmp_path / 'c.mkv'))
