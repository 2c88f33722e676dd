"""The display rotation of the port's video layer (`data/mp4.py`'s display
matrices, `data/video.py`'s Matroska Projection, `VideoIndex.display`)
against OpenCV's FFmpeg backend and the JAX package's helpers, on the
rotated clips of `tests/torch_fixtures/orientation/` (`python
tests/_torch_orientation_fixtures.py`) and on matrices written here:

- every frame of every clip, read in order (`iter_frames`), by seek
  (`imread('#frame=N')` for every N, as cv2's seek answered it) and from 8
  threads, equals cv2.VideoCapture's (which turns the frames by the matrix:
  CAP_PROP_ORIENTATION_AUTO is on by default), for mp4v, H.264 and HEVC at 8
  and 10 bits, in MP4 and in the QuickTime layout of a phone's .mov;
- `video_extents`, `video_fps` and `num_frames_of_video` equal JAX's (cv2's
  CAP_PROP_FRAME_WIDTH and HEIGHT swap at 90 and 270 degrees), and JAX's
  `imread('#frame=N')` gives the port's frames;
- the turn follows the table of CAP_PROP_ORIENTATION_META: the track
  header's matrix after the movie header's, in FFmpeg's fixed point, its
  angle rounded, applied at 90, 180 and 270 degrees only (mirrors count
  through their angle); a Matroska roll turns the other way;
- `transform_video` and `demo_video` see JAX's frames of a rotated clip,
  and the demo, on a minted package, gives JAX's poses.
"""

import hashlib
import json
import math
import random
import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from _torch_orientation_fixtures import (CASES, MATRICES, ORIENTATION_DIR, child, fixed_matrix,
                                         parse_boxes, rewrite_mp4, set_matrix)
from _torch_train import one_torch_thread  # noqa: F401 (fixture)
from metrabs_tpu.data import improc as jax_improc
from metrabs_tpu_torch.data import improc, mp4, video

pytestmark = pytest.mark.usefixtures('one_torch_thread')

MANIFEST = json.loads((ORIENTATION_DIR / 'manifest.json').read_text())
NAMES = [name for name, *_ in CASES]


def path_of(name: str) -> str:
    return str(ORIENTATION_DIR / name)


def sha256(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def test_manifest_lists_every_fixture():
    on_disk = sorted(p.name for p in ORIENTATION_DIR.iterdir() if p.name != 'manifest.json')
    assert on_disk == sorted(NAMES) == sorted(MANIFEST)
    for name in NAMES:
        assert hashlib.sha256((ORIENTATION_DIR / name).read_bytes()).hexdigest() == \
            MANIFEST[name]['file_sha256']


@pytest.mark.parametrize('name', NAMES)
def test_frames_and_extents_equal_cv2s(name):
    path = path_of(name)
    entry = MANIFEST[name]
    idx = video.index(path)
    assert idx.rotation == entry['turn'] == (entry['cv2']['orientation']
                                             if entry['cv2']['orientation'] in (90, 180, 270) else 0)
    assert (idx.width, idx.height) == (96, 64)  # as stored: what the decoders see
    assert tuple(improc.video_extents(path)) == (entry['cv2']['width'], entry['cv2']['height'])
    assert [sha256(f) for f in video.iter_frames(path)] == entry['rgb_sha256']


@pytest.mark.parametrize('name', NAMES)
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


@pytest.mark.parametrize('name', [n for n in NAMES if 'rot90' in n or 'roll' in n or 'mvhd' in n
                                  or 'mirror_x' in n])
def test_metadata_and_imread_equal_jax(name):
    path = path_of(name)
    np.testing.assert_array_equal(improc.video_extents(path), jax_improc.video_extents(path))
    assert improc.video_fps(path) == jax_improc.video_fps(path)
    assert improc.num_frames_of_video(path) == jax_improc.num_frames_of_video(path)
    for i in (3, 0, 2):
        np.testing.assert_array_equal(improc.imread(f'{path}#frame={i}'),
                                      jax_improc.imread(f'{path}#frame={i}'))


def test_random_access_from_8_threads():
    name = 'hevc10_rot90.mov'
    path = path_of(name)
    order = [i for i in range(4) for _ in range(4)]
    random.Random(1).shuffle(order)
    video._STREAMS.clear()
    with ThreadPoolExecutor(8) as pool:
        frames = list(pool.map(improc.imread, [f'{path}#frame={i}' for i in order]))
    want = MANIFEST[name]['rgb_sha256']
    assert [sha256(f) for f in frames] == [want[i] for i in order]


def test_the_mov_layout_is_a_phones():
    """The .mov fixtures have ftyp `qt  `, a sound track before the video
    track, co64 offsets and a colr box in the sample entry; the index takes
    the video track."""
    data = (ORIENTATION_DIR / 'h264_rot90.mov').read_bytes()
    assert data[4:12] == b'ftypqt  '
    moov = parse_boxes(data[data.rindex(b'moov') + 4:])
    traks = [body for kind, body in moov if kind == b'trak']
    assert [child(t, b'mdia', b'hdlr')[1][8:12] for t in traks] == [b'soun', b'vide']
    stbl = dict((kind, body) for kind, body in child(traks[1], b'mdia', b'minf', b'stbl')[1])
    assert b'co64' in stbl and b'stco' not in stbl
    assert b'colrnclx' in stbl[b'stsd']
    idx = video.index(path_of('h264_rot90.mov'))
    assert idx.kind == 'h264' and idx.n_frames == 4


# --------------------------------------------------------------------------
# The turn of a matrix, held to cv2's table and FFmpeg's arithmetic

def _matrix(a, b, c, d):
    f = lambda v: int(round(v * 65536))  # noqa: E731
    return np.array([[f(a), f(b), 0], [f(c), f(d), 0], [0, 0, 1 << 30]], np.int64)


@pytest.mark.parametrize('case', list(MATRICES))
def test_display_rotation_follows_cv2s_table(case):
    (a, b, c, d), turn = MATRICES[case]
    assert mp4.display_rotation(_matrix(a, b, c, d)) == turn


@pytest.mark.parametrize('first, second, turn', [
    ('rot90', 'rot90', 180), ('rot90', 'rot270', 0), ('rot180', 'rot180', 0),
    ('rot45', 'rot45', 90), ('transpose', 'transpose', 0), ('mirror_x', 'mirror_x', 0)])
def test_movie_and_track_matrices_multiply(first, second, turn):
    """cv2 turns a clip with both matrices by their product (probed: 45 and
    45 degrees give 90, two mirrors none)."""
    product = mp4._times(_matrix(*MATRICES[first][0]), _matrix(*MATRICES[second][0]))
    assert mp4.display_rotation(product) == turn


@pytest.mark.parametrize('degrees, turn', [(89, 0), (89.6, 90), (90.4, 90), (91, 0), (-90, 270),
                                           (269.6, 270), (180, 180)])
def test_only_whole_turns_of_the_rounded_angle(degrees, turn):
    r = math.radians(degrees)
    assert mp4.display_rotation(_matrix(math.cos(r), math.sin(r), -math.sin(r), math.cos(r))) == turn


def test_a_degenerate_matrix_turns_nothing():
    assert mp4.display_rotation(np.zeros((3, 3))) == 0


@pytest.mark.parametrize('roll, yaw, pitch, turn', [
    (90.0, 0.0, 0.0, 270), (-90.0, 0.0, 0.0, 90), (180.0, 0.0, 0.0, 180), (270.0, 0.0, 0.0, 90),
    (45.0, 0.0, 0.0, 0), (90.0, 0.0, 10.0, 0), (90.0, 30.0, 0.0, 0), (90.0, 180.0, 0.0, 90),
    (0.0, 0.0, 0.0, 0)])
def test_matroska_projection_turns(roll, yaw, pitch, turn):
    """The roll is counter-clockwise (cv2 turns a roll of 90 by 270, probed);
    a yaw of 180 mirrors and so turns it back; another pitch or yaw gives no
    display matrix."""
    projection = {0x7671: 0, 0x7673: yaw, 0x7674: pitch, 0x7675: roll}
    assert video._projection_rotation(projection) == turn


def test_matroska_projections_of_other_types_turn_nothing():
    assert video._projection_rotation({0x7671: 1, 0x7675: 90.0}) == 0  # equirectangular


def test_written_matrices_read_back(tmp_path):
    """A clip rewritten with each matrix of the table in the track header,
    then with version-1 headers: the index reads the turn cv2 applies."""
    src = ORIENTATION_DIR / 'hevc8_mirror_y.mp4'
    for case, ((a, b, c, d), turn) in MATRICES.items():
        path = tmp_path / f'{case}.mp4'
        path.write_bytes(src.read_bytes())
        rewrite_mp4(path, lambda moov, m=fixed_matrix(a, b, c, d): set_matrix(moov, b'tkhd', m))
        assert video.index(str(path)).rotation == turn, case


def test_version_1_headers(tmp_path):
    """tkhd and mvhd of version 1 (64-bit times): the matrices lie further on."""
    path = tmp_path / 'v1.mp4'
    path.write_bytes((ORIENTATION_DIR / 'h264_rot90.mp4').read_bytes())

    def to_v1(moov):
        from _torch_orientation_fixtures import _video_trak, child
        for entry in (child(moov, b'mvhd'), child(_video_trak(moov), b'tkhd')):
            body = entry[1]
            if entry[0] == b'mvhd':  # times and duration to 64 bits
                c, m, scale, dur = struct.unpack('>IIII', body[4:20])
                entry[1] = bytes([1]) + body[1:4] + struct.pack('>QQIQ', c, m, scale, dur) + body[20:]
            else:
                c, m, tid, res, dur = struct.unpack('>IIIII', body[4:24])
                entry[1] = (bytes([1]) + body[1:4] + struct.pack('>QQIIQ', c, m, tid, res, dur)
                            + body[24:])
    rewrite_mp4(path, to_v1)
    rewrite_mp4(path, lambda moov: set_matrix(moov, b'mvhd', fixed_matrix(-1, 0, 0, -1)))
    idx = video.index(str(path))
    assert idx.rotation == 270  # 90 after 180
    assert idx.n_frames == 4 and tuple(improc.video_extents(str(path))) == (64, 96)


# --------------------------------------------------------------------------
# Through the drivers

def test_transform_video_sees_jaxs_frames(tmp_path):
    """transform_video on a portrait-turned clip: the frame function gets
    JAX's (cv2's) turned frames, and the output has their size."""
    src = path_of('hevc10_rot90.mov')
    seen = {}
    for name, module in (('port', improc), ('jax', jax_improc)):
        seen[name] = []

        def fn(frame, _seen=seen[name]):
            _seen.append(frame.copy())
            return 255 - frame

        dst = str(tmp_path / name / 'dst.mp4')
        module.transform_video(src, dst, fn)
        assert tuple(improc.video_extents(dst)) == tuple(jax_improc.video_extents(dst)) == (64, 96)
    assert len(seen['port']) == len(seen['jax']) == 4
    for a, b in zip(seen['port'], seen['jax']):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope='module')
def tiny_package(tmp_path_factory):
    """A tiny-backbone 64 px Metrabs package, float32, weights minted from a
    seed (tests/_torch_port.py), without a detector: the demo then estimates
    on its fixed box over the middle of each frame as displayed."""
    from _torch_port import make_family_package
    directory = str(tmp_path_factory.mktemp('turned_demo') / 'pkg')
    return make_family_package(directory, 'tiny')


POSES3D = dict(atol=1.0, rtol=1e-3)  # tests/test_torch_estimator.py, tests/test_torch_demos.py


def test_demo_video_on_a_turned_clip_matches_jax(tmp_path, tiny_package, monkeypatch, capsys):
    """demo_video on the Main 10 .mov turned by 90 degrees, with a minted
    package: JAX's demo (reading through cv2) and the port's hand the
    estimator the same portrait frames (64x96 as displayed) and the same box
    and camera (both from the displayed size), get the same poses within
    POSES3D, print the same line and write videos of the displayed size."""
    import metrabs_tpu.io.packaging as jax_packaging
    from metrabs_tpu.apps import demo_video as jax_demo_video
    from metrabs_tpu_torch.apps import demo_image, demo_video
    src = path_of('hevc10_rot90.mov')
    calls = {'port': [], 'jax': []}

    def recorded(est, name):
        plain = est.estimate_poses_batched

        def estimate(images, boxes, **kw):
            out = plain(images, boxes, **kw)
            calls[name].append((np.asarray(images).copy(), np.asarray(boxes).copy(),
                                {k: np.asarray(v) for k, v in out.items()}))
            return out
        est.estimate_poses_batched = estimate
        return est

    port_load, jax_load = demo_image.load_estimator, jax_packaging.load_pose_estimator
    monkeypatch.setattr(demo_image, 'load_estimator',
                        lambda *a, **k: recorded(port_load(*a, **k), 'port'))
    monkeypatch.setattr(jax_packaging, 'load_pose_estimator',
                        lambda *a, **k: recorded(jax_load(*a, **k), 'jax'))
    args = ['--video', src, '--package', tiny_package, '--num-aug', '2', '--frame-batch', '4',
            '--max-boxes', '2']
    with pytest.warns(UserWarning, match='bone_mean_lengths'):
        demo_video.main(args + ['--device', 'cpu', '--out', str(tmp_path / 'port.mp4')])
    port_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with pytest.warns(UserWarning, match='bone_mean_lengths'):
        jax_demo_video.main(args + ['--out', str(tmp_path / 'jax.mp4')])
    jax_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert port_line == jax_line and port_line['frames'] == port_line['total_poses'] == 4
    assert len(calls['port']) == len(calls['jax']) == 1
    (im1, boxes1, out1), (im2, boxes2, out2) = calls['port'][0], calls['jax'][0]
    assert im1.shape == (4, 96, 64, 3)
    np.testing.assert_array_equal(im1, im2)
    np.testing.assert_array_equal(boxes1, boxes2)
    np.testing.assert_allclose(out1['poses3d'], out2['poses3d'], **POSES3D)
    for out in ('port.mp4', 'jax.mp4'):
        assert tuple(jax_improc.video_extents(str(tmp_path / out))) == (64, 96)
