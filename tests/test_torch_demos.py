"""The port's demos and the drivers that read or draw video (`apps/
demo_image.py`, `demo_video.py`, `webcam_demo.py`, `predict_aspset.py` and
`--viz-dir` of `predict_3dpw` and `predict_mupots`) against the JAX
package's on the same weights or the same stub estimator:

- `demo_image.main` prints JAX's JSON line, the pelvis within POSES3D of
  tests/test_torch_estimator.py, on a tiny-backbone package read by both;
- `demo_video` makes the calls and frame counts of JAX's
  `test_letterbox_and_partial_batch` and `test_stream_mode` (JAX's file is
  marked slow for its XLA compiles; these run the port alone against the
  numbers that test asserts), reads and writes mp4v (JAX's codec) and
  Motion JPEG at the source's size, and
  `letterbox_frame` and `fov_intrinsics` equal JAX's;
- `camera_extrinsics_from_pitch_height` equals JAX's; the webcam's capture
  raises after the set-up;
- `predict_aspset` on JAX's `test_predict_drivers.py` layout with MJPG .mkv
  videos: the same `.npz` files as JAX's driver with the same stub, whose
  features are binned so that FFmpeg's decode (JAX's cv2.VideoCapture) and
  libjpeg's (the port's) of the flat frames give the same poses; with mp4v
  .mkv videos, as JAX's test writes them, the very same images and poses;
- on an H.264 or HEVC input (the libx264 fixtures, with and without B
  slices, and the libx265 ones),
  `demo_video` hands the same estimator JAX's very frames (JAX reads them
  through cv2) and prints JAX's line, and `transform_video` maps JAX's
  frames and writes an output no further from them than JAX's;
- `--viz-dir` writes JAX's file names.
"""

import json
import os

import cv2
import numpy as np
import pytest
import torch

import _torch_bench_layouts as layouts
from _torch_port import make_family_package
from _torch_train import one_torch_thread  # noqa: F401 (fixture)
from metrabs_tpu_torch.apps import demo_image, demo_video, predict_aspset, webcam_demo
from metrabs_tpu_torch.data import improc, video

POSES3D = dict(atol=1.0, rtol=1e-3)  # tests/test_torch_estimator.py
TRANSFORM_MARGIN = 0.5  # mean levels, as tests/test_torch_mp4v.py's transform_video test


@pytest.fixture(scope='module')
def tiny_package(tmp_path_factory):
    """A tiny-backbone 64 px Metrabs package with a YOLOv4-tiny detector at
    96 px, float32, weights minted from a seed (tests/_torch_port.py)."""
    directory = str(tmp_path_factory.mktemp('demo_package') / 'pkg')
    return make_family_package(directory, 'tiny', detector='yolov4-tiny',
                               detector_input_size=96)


def last_json(text: str) -> dict:
    return json.loads([line for line in text.strip().splitlines() if line.startswith('{')][-1])


@pytest.mark.parametrize('boxes', ['20,10,60,100;90,20,50,90', None])
def test_demo_image_prints_jax_line(tmp_path, tiny_package, capsys, one_torch_thread, boxes):
    from metrabs_tpu.apps import demo_image as jax_demo_image
    rng = np.random.default_rng(3)
    image = rng.integers(0, 256, (120, 160, 3), dtype=np.uint8)
    path = str(tmp_path / 'in.jpg')
    improc.imwrite(path, image)
    common = ['--image', path, '--package', tiny_package, '--num-aug', '2']
    if boxes:
        common += ['--boxes', boxes]
    with pytest.warns(UserWarning, match='bone_mean_lengths'):
        jax_demo_image.main(common)
    want = last_json(capsys.readouterr().out)
    with pytest.warns(UserWarning, match='bone_mean_lengths'):
        demo_image.main(common + ['--device', 'cpu', '--out', str(tmp_path / 'o.jpg'),
                                  '--out-3d', str(tmp_path / 'o3.png'), '--fast-load'])
    printed = capsys.readouterr().out
    assert 'fast-load: ignored' in printed
    got = last_json(printed)
    assert got.keys() == want.keys()
    assert got['n_poses'] == want['n_poses'] and got['poses3d_shape'] == want['poses3d_shape']
    assert got['poses2d_shape'] == want['poses2d_shape']
    if want['pose0_pelvis_mm'] is None:
        assert got['pose0_pelvis_mm'] is None
    else:
        np.testing.assert_allclose(got['pose0_pelvis_mm'], want['pose0_pelvis_mm'], **POSES3D)
    assert improc.imread(str(tmp_path / 'o.jpg')).shape == image.shape
    assert improc.imread(str(tmp_path / 'o3.png')).shape[2] == 3


def test_default_estimator_is_seeded_and_runs(tmp_path, capsys, monkeypatch, one_torch_thread):
    est = demo_image.build_default_estimator(device='cpu')
    assert est.cfg.backbone == 'mobilenetv3-small' and est.cfg.dtype == 'bfloat16'
    assert est.cfg.proc_side == 256 and est.cfg.depth == 8 and est.joint_info.n_joints == 17
    again = demo_image.build_default_estimator(device='cpu')
    for (name, a), b in zip(est.crop_model.state_dict().items(),
                            again.crop_model.state_dict().values()):
        assert torch.equal(a, b), name
    path = str(tmp_path / 'in.png')
    improc.imwrite(path, np.random.default_rng(0).integers(0, 256, (64, 48, 3), dtype=np.uint8))
    with pytest.warns(UserWarning, match='bone_mean_lengths'):
        demo_image.main(['--image', path, '--device', 'cpu', '--num-aug', '1'])
    got = last_json(capsys.readouterr().out)
    assert got['n_poses'] == 1 and got['poses3d_shape'] == [1, 17, 3]
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        demo_image.build_default_estimator()  # the card by default, no fallback


def write_clip(path: str, n: int, w: int, h: int, fourcc: str = 'MJPG') -> None:
    rng = np.random.default_rng(0)
    with video.VideoWriter(path, 10, (w, h), fourcc) as writer:
        for _ in range(n):
            writer.write(rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8))


def recording(est, *methods):
    calls = {m: [] for m in methods}
    for m in methods:
        original = getattr(est, m)

        def wrapped(images, *args, _m=m, _orig=original, **kwargs):
            calls[_m].append(tuple(np.asarray(images).shape))
            return _orig(images, *args, **kwargs)
        setattr(est, m, wrapped)
    return calls


def test_demo_video_letterbox_and_partial_batch(tmp_path, tiny_package, monkeypatch, capsys,
                                                one_torch_thread):
    """JAX's test_letterbox_and_partial_batch: 7 frames of 100x76 through
    --frame-batch 4 and --letterbox 96x128 are two calls of (4, 96, 128, 3);
    the overlay video keeps the source's size."""
    from metrabs_tpu_torch.io.packaging import load_pose_estimator
    est = load_pose_estimator(tiny_package, device='cpu')
    est.detector = None  # the full-image box path, as JAX's test has no detector
    calls = recording(est, 'estimate_poses_batched')
    monkeypatch.setattr(demo_image, 'build_default_estimator', lambda device='cuda': est)
    src, out = str(tmp_path / 'in.avi'), str(tmp_path / 'out.mkv')
    write_clip(src, n=7, w=100, h=76)
    demo_video.main(['--video', src, '--out', out, '--num-aug', '1', '--frame-batch', '4',
                     '--letterbox', '96x128', '--device', 'cpu'])
    assert last_json(capsys.readouterr().out)['frames'] == 7
    assert calls['estimate_poses_batched'] == [(4, 96, 128, 3), (4, 96, 128, 3)]
    cap = cv2.VideoCapture(out)
    assert int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)) == 100
    assert int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)) == 76
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 7
    cap.release()
    assert improc.num_frames_of_video(out) == 7


def test_demo_video_stream_mode(tmp_path, tiny_package, monkeypatch, capsys, one_torch_thread):
    """JAX's test_stream_mode: 10 frames, --frame-batch 2 --stream 2 flush
    as three detect_poses_stream calls of (2, 2, 96, 128, 3), the last
    padded; the demo makes no batched call of its own."""
    from metrabs_tpu_torch.io.packaging import load_pose_estimator
    est = load_pose_estimator(tiny_package, device='cpu')
    calls = recording(est, 'detect_poses_stream', 'detect_poses_batched')
    monkeypatch.setattr(demo_image, 'build_default_estimator', lambda device='cuda': est)
    src = str(tmp_path / 'in.mkv')
    write_clip(src, n=10, w=100, h=76)
    demo_video.main(['--video', src, '--num-aug', '1', '--frame-batch', '2', '--stream', '2',
                     '--letterbox', '96x128', '--max-boxes', '2', '--device', 'cpu'])
    assert last_json(capsys.readouterr().out)['frames'] == 10
    assert calls['detect_poses_stream'] == [(2, 2, 96, 128, 3)] * 3
    # detect_poses_stream makes its K batched calls inside; the demo none.
    assert len(calls['detect_poses_batched']) == 6
    # --max-frames stops early and flushes the partial batch.
    demo_video.main(['--video', src, '--num-aug', '1', '--frame-batch', '4', '--max-frames', '5',
                     '--max-boxes', '2', '--device', 'cpu', '--out', str(tmp_path / 'o.avi')])
    assert last_json(capsys.readouterr().out)['frames'] == 5
    assert improc.num_frames_of_video(str(tmp_path / 'o.avi')) == 5


def test_demo_video_refuses_mp4_output(tmp_path):
    """--out writes mp4v into .mp4, .avi or .mkv; another container is
    refused before the estimator loads."""
    with pytest.raises(NotImplementedError, match='mp4v into .mp4, .avi or .mkv'):
        demo_video.main(['--video', 'in.avi', '--out', str(tmp_path / 'out.webm')])


def test_demo_video_mp4v_in_and_out(tmp_path, tiny_package, monkeypatch, capsys,
                                    one_torch_thread):
    """JAX's test_letterbox_and_partial_batch on its own formats: 7 frames of
    100x76 mp4v .mp4 in, mp4v .mp4 out, read back by cv2 and by the port
    as 100x76 x 7, each input frame decoded once."""
    from metrabs_tpu_torch.data import mpeg4
    from metrabs_tpu_torch.io.packaging import load_pose_estimator
    est = load_pose_estimator(tiny_package, device='cpu')
    est.detector = None  # the full-image box path, as JAX's test has no detector
    calls = recording(est, 'estimate_poses_batched')
    monkeypatch.setattr(demo_image, 'build_default_estimator', lambda device='cuda': est)
    src, out = str(tmp_path / 'in.mp4'), str(tmp_path / 'out.mp4')
    write_clip(src, n=7, w=100, h=76, fourcc='mp4v')
    before = mpeg4.frames_decoded()
    demo_video.main(['--video', src, '--out', out, '--num-aug', '1', '--frame-batch', '4',
                     '--letterbox', '96x128', '--device', 'cpu'])
    assert mpeg4.frames_decoded() - before == 7
    assert last_json(capsys.readouterr().out)['frames'] == 7
    assert calls['estimate_poses_batched'] == [(4, 96, 128, 3), (4, 96, 128, 3)]
    cap = cv2.VideoCapture(out)
    assert int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)) == 100
    assert int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)) == 76
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 7
    cap.release()
    idx = video.index(out)
    assert (idx.codec, idx.width, idx.height, idx.n_frames) == ('mp4v', 100, 76, 7)


def h264_fixture(name: str) -> str:
    """A libx264 clip: I and P slices (h264_*) or B slices too (h264b_*)."""
    from _torch_h264_fixtures import H264_B_DIR, H264_DIR
    return str((H264_B_DIR if name.startswith('h264b_') else H264_DIR) / name)


def hevc_fixture(name: str) -> str:
    """A libx265 clip: I and P slices (hevc_*) or B slices too (hevcb_*)."""
    from _torch_hevc_fixtures import HEVC_B_DIR, HEVC_DIR
    return str((HEVC_B_DIR if name.startswith('hevcb_') else HEVC_DIR) / name)


class EdgeStub(layouts.StubEstimator):
    """The drivers' stub estimator with the skeleton edges the demos draw."""

    def __init__(self):
        super().__init__()
        self.skeletons.joint_edges = lambda name: [(0, 1), (1, 2)]
        self.detector = object()


@pytest.mark.parametrize('name', ['h264_320x568.mp4', 'h264_96x66.mkv', 'h264_96x66.avi'])
def test_demo_video_on_h264_matches_jax(tmp_path, monkeypatch, capsys, name):
    """demo_video on a libx264 clip: the port's and JAX's demo (JAX reading
    through cv2) hand the same estimator the very same frames in the same
    batches, so it gives the same poses, and both print the same line; each
    frame is decoded once."""
    demo_video_matches_jax(tmp_path, monkeypatch, capsys, h264_fixture(name))


@pytest.mark.parametrize('name', ['h264b_320x568.mp4', 'h264b_96x66.mkv', 'h264b_96x66.avi'])
def test_demo_video_on_h264_b_frames_matches_jax(tmp_path, monkeypatch, capsys, name):
    """demo_video on a libx264 clip with B slices (the MP4 with FFmpeg's
    ctts and elst): JAX's frames in output order, JAX's line, each picture
    decoded once."""
    demo_video_matches_jax(tmp_path, monkeypatch, capsys, h264_fixture(name))


@pytest.mark.parametrize('name', ['hevc_320x568.mp4', 'hevc_96x66.mkv', 'hevc_96x66.avi'])
def test_demo_video_on_hevc_matches_jax(tmp_path, monkeypatch, capsys, name):
    """demo_video on a libx265 clip: JAX's frames, batches, poses and line;
    each picture decoded once."""
    demo_video_matches_jax(tmp_path, monkeypatch, capsys, hevc_fixture(name))


@pytest.mark.parametrize('name', ['hevcb_320x568.mp4', 'hevcb_96x66.mkv', 'hevcb_96x66.avi'])
def test_demo_video_on_hevc_b_matches_jax(tmp_path, monkeypatch, capsys, name):
    """demo_video on a libx265 clip with B slices (the MP4 with FFmpeg's
    ctts and elst; the 320x568 clip's CRA picture has a RASL picture): JAX's
    frames in output order, batches, poses and line, each picture decoded
    once."""
    demo_video_matches_jax(tmp_path, monkeypatch, capsys, hevc_fixture(name))


@pytest.mark.parametrize('name', ['xvid_asp_usual_320x568.mkv', 'xvid_asp_usual_96x66.avi',
                                  'xvid_asp_bvop.mp4'])
def test_demo_video_on_xvid_asp_matches_jax(tmp_path, monkeypatch, capsys, name):
    """demo_video on libxvidcore's Advanced Simple clips (B-VOPs, packed,
    quarter-pel, MPEG quantisation and GMC; B-VOPs in an MP4 with ctts):
    JAX's frames in output order, batches, poses and line, each VOP decoded
    once."""
    from _torch_mp4v_asp_fixtures import ASP_DIR
    demo_video_matches_jax(tmp_path, monkeypatch, capsys, str(ASP_DIR / name))


def demo_video_matches_jax(tmp_path, monkeypatch, capsys, src):
    import metrabs_tpu.apps.demo_image as jax_demo_image
    from metrabs_tpu.apps import demo_video as jax_demo_video
    from metrabs_tpu_torch.data import h264, hevc, mpeg4
    idx = video.index(src)
    codec = {'h264': h264, 'hevc': hevc, 'mp4v': mpeg4}[idx.kind]
    n = idx.n_decoded
    port, jax = EdgeStub(), EdgeStub()
    monkeypatch.setattr(demo_image, 'build_default_estimator', lambda device='cuda': port)
    monkeypatch.setattr(jax_demo_image, 'build_default_estimator', lambda: jax)
    args = ['--video', src, '--num-aug', '1', '--frame-batch', '4', '--max-boxes', '2']
    before = codec.frames_decoded()
    demo_video.main(args + ['--device', 'cpu', '--out', str(tmp_path / 'port.mp4')])
    assert codec.frames_decoded() - before == n
    port_line = last_json(capsys.readouterr().out)
    jax_demo_video.main(args + ['--out', str(tmp_path / 'jax.mp4')])
    jax_line = last_json(capsys.readouterr().out)
    assert port_line == jax_line and port_line['frames'] == n
    assert len(port.calls) == len(jax.calls) == -(-n // 4)
    for (m1, im1, kw1), (m2, im2, kw2) in zip(list(port.calls), list(jax.calls)):
        assert m1 == m2 == 'detect'
        np.testing.assert_array_equal(im1, im2)
        out1 = port.detect_poses_batched(im1, **kw1)
        out2 = jax.detect_poses_batched(im2, **kw2)
        for key in ('poses3d', 'poses2d', 'valid'):
            np.testing.assert_array_equal(out1[key], out2[key])
    for out in ('port.mp4', 'jax.mp4'):
        assert improc.num_frames_of_video(str(tmp_path / out)) == n


def test_transform_video_on_h264_matches_jax(tmp_path):
    """transform_video on a libx264 .mp4 through the port and through JAX:
    the frame function sees the same frames, and the port's mp4v output is
    no further from the inverted frames than JAX's (cv2's encoder) by
    TRANSFORM_MARGIN."""
    transform_video_matches_jax(tmp_path, h264_fixture('h264_96x66.mp4'))


def test_transform_video_on_h264_b_frames_matches_jax(tmp_path):
    """transform_video on a libx264 .mp4 with B slices, ctts and elst: the
    frames in JAX's order, an output as close to them as JAX's."""
    transform_video_matches_jax(tmp_path, h264_fixture('h264b_96x66.mp4'))


def test_transform_video_on_hevc_matches_jax(tmp_path):
    """transform_video on a libx265 .mp4: the frames JAX sees, an output as
    close to them as JAX's."""
    transform_video_matches_jax(tmp_path, hevc_fixture('hevc_96x66.mp4'))


def test_transform_video_on_hevc_b_matches_jax(tmp_path):
    """transform_video on a libx265 .mp4 with B slices, ctts and elst: the
    frames in JAX's order, an output as close to them as JAX's."""
    transform_video_matches_jax(tmp_path, hevc_fixture('hevcb_96x66.mp4'))


def transform_video_matches_jax(tmp_path, src):
    from metrabs_tpu.data import improc as jax_improc
    seen, errors = {}, {}
    inverted = [255 - f for f in video.iter_frames(src)]
    for name, module in (('port', improc), ('jax', jax_improc)):
        seen[name] = []

        def fn(frame, _seen=seen[name]):
            _seen.append(frame.copy())
            return 255 - frame

        dst = str(tmp_path / name / 'dst.mp4')
        module.transform_video(src, dst, fn)
        out = list(video.iter_frames(dst))
        assert len(out) == 14 == jax_improc.num_frames_of_video(dst)
        errors[name] = np.mean([np.abs(a.astype(int) - b).mean() for a, b in zip(out, inverted)])
    assert len(seen['port']) == len(seen['jax']) == 14
    for a, b in zip(seen['port'], seen['jax']):
        np.testing.assert_array_equal(a, b)
    assert errors['port'] <= errors['jax'] + TRANSFORM_MARGIN, errors


@pytest.mark.parametrize('src_hw, out_hw', [((76, 100), (96, 128)), ((1080, 1920), (540, 960)),
                                            ((480, 270), (256, 256)), ((33, 47), (100, 60))])
def test_letterbox_and_intrinsics_equal_jax(src_hw, out_hw):
    from metrabs_tpu.apps import demo_video as jax_demo_video
    rgb = np.random.default_rng(sum(src_hw)).integers(0, 256, (*src_hw, 3), dtype=np.uint8)
    got = demo_video.letterbox_frame(rgb, *out_hw)
    want = jax_demo_video.letterbox_frame(rgb, *out_hw)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    for fov in (30.0, 55.0, 90.0):
        np.testing.assert_array_equal(demo_video.fov_intrinsics(fov, *src_hw),
                                      jax_demo_video.fov_intrinsics(fov, *src_hw))


@pytest.mark.parametrize('pitch, height', [(0.0, 1.0), (15.0, 1.6), (-7.5, 0.4)])
def test_camera_extrinsics_equal_jax(pitch, height):
    from metrabs_tpu.apps import webcam_demo as jax_webcam
    np.testing.assert_array_equal(webcam_demo.camera_extrinsics_from_pitch_height(pitch, height),
                                  jax_webcam.camera_extrinsics_from_pitch_height(pitch, height))


def test_webcam_capture_raises_after_set_up(monkeypatch, tiny_package):
    seen = []
    monkeypatch.setattr(demo_image, 'build_default_estimator',
                        lambda device='cuda': seen.append(device) or demo_image.load_estimator(
                            tiny_package, device, False))
    with pytest.warns(UserWarning, match='bone_mean_lengths'):
        with pytest.raises(NotImplementedError, match='ROADMAP.md'):
            webcam_demo.main(['--pitch-degrees', '10', '--device', 'cpu'])
    assert seen == ['cpu']


class BinnedStub(layouts.StubEstimator):
    """The stub with features binned to 16 levels: the flat frames decode to
    within a few levels of each other under FFmpeg and libjpeg, and each
    frame's value sits in the middle of its bin."""

    @staticmethod
    def _features(images):
        mean = images.reshape(len(images), -1, 3).astype(np.float64).mean(1)
        return np.floor(mean / 16) * 16


def mint_aspset_with_videos(root, n_frames: int = 3, w: int = 96, h: int = 64,
                            fourcc: str = 'MJPG'):
    """JAX's test_predict_aspset layout (test_predict_drivers.py) with .mkv
    videos written by cv2 (MJPG, or mp4v as JAX's test writes them), two
    views; frames flat, mid-bin colours."""
    subj, vid = '1e2f', '0001'
    views = ('left', 'mid')
    os.makedirs(root)
    with open(root / 'splits.csv', 'w') as f:
        f.write('subject,video,view,split\n')
        for view in views:
            f.write(f'{subj},{vid},{view},test\n')
    for d in ('boxes', 'cameras', 'videos'):
        os.makedirs(root / 'test' / d / subj)
    for i_view, view in enumerate(views):
        with open(root / 'test' / 'boxes' / subj / f'{subj}-{vid}-{view}.csv', 'w') as f:
            f.write('x1,y1,x2,y2\n')
            for k in range(n_frames):
                f.write(f'{10 + k},{10 + i_view},100,90\n')
        with open(root / 'test' / 'cameras' / subj / f'{subj}-{view}.json', 'w') as f:
            json.dump(dict(intrinsic_matrix=[[900.0, 0, w / 2, 0], [0, 900.0, h / 2, 0],
                                             [0, 0, 1, 0]]), f)
        writer = cv2.VideoWriter(str(root / 'test' / 'videos' / subj / f'{subj}-{vid}-{view}.mkv'),
                                 cv2.CAP_FFMPEG, cv2.VideoWriter_fourcc(*fourcc), 25, (w, h))
        assert writer.isOpened()
        for k in range(n_frames):
            writer.write(np.full((h, w, 3), (16 * (2 + k) + 8, 16 * (6 + i_view) + 8, 200),
                                 np.uint8))
        writer.release()
    return [f'{subj}-{vid}-{view}' for view in views]


def test_predict_aspset_matches_jax(tmp_path, monkeypatch):
    import metrabs_tpu.io.packaging as jax_packaging
    import metrabs_tpu_torch.io.packaging as packaging
    from metrabs_tpu.apps import predict_aspset as jax_predict_aspset
    monkeypatch.setitem(layouts.SKELETON_JOINTS, 'aspset_17', 17)
    port, jax = (BinnedStub(skeleton_names=tuple(layouts.SKELETON_JOINTS)) for _ in range(2))
    monkeypatch.setattr(packaging, 'load_pose_estimator', lambda path, device='cuda': port)
    monkeypatch.setattr(jax_packaging, 'load_pose_estimator', lambda path: jax)
    root = tmp_path / 'aspset'
    names = mint_aspset_with_videos(root)
    predict_aspset.main(['--package', 'stub', '--root', str(root), '--output-dir',
                         str(tmp_path / 'port'), '--device', 'cpu'])
    jax_predict_aspset.main(['--package', 'stub', '--root', str(root), '--output-dir',
                             str(tmp_path / 'jax')])
    assert sorted(os.listdir(tmp_path / 'port')) == sorted(os.listdir(tmp_path / 'jax')) == \
        sorted(f'{n}.npz' for n in names)
    for name in names:
        with np.load(tmp_path / 'port' / f'{name}.npz') as a, \
                np.load(tmp_path / 'jax' / f'{name}.npz') as b:
            assert a.files == b.files == ['coords3d_pred_world']
            assert a['coords3d_pred_world'].shape == (3, 17, 3)
            np.testing.assert_array_equal(a['coords3d_pred_world'], b['coords3d_pred_world'])
    assert len(port.calls) == len(jax.calls) == 2
    for (_, im1, kw1), (_, im2, kw2) in zip(port.calls, jax.calls):
        assert im1.shape == im2.shape and np.abs(im1.astype(int) - im2).max() <= 8
        assert kw1.keys() == kw2.keys() and kw1['skeleton'] == 'aspset_17'
        for k in ('boxes', 'intrinsic_matrix', 'extrinsic_matrix', 'distortion_coeffs'):
            np.testing.assert_array_equal(kw1[k], kw2[k], err_msg=k)


def test_predict_aspset_on_mp4v_matches_jax(tmp_path, monkeypatch):
    """JAX's layout with mp4v .mkv videos, as JAX's test writes them: the
    port's frames equal cv2's, so the driver gives JAX's poses and hands the
    estimator JAX's very images; each frame is decoded once."""
    import metrabs_tpu.io.packaging as jax_packaging
    import metrabs_tpu_torch.io.packaging as packaging
    from metrabs_tpu.apps import predict_aspset as jax_predict_aspset
    from metrabs_tpu_torch.data import mpeg4
    monkeypatch.setitem(layouts.SKELETON_JOINTS, 'aspset_17', 17)
    port, jax = (layouts.StubEstimator(skeleton_names=tuple(layouts.SKELETON_JOINTS))
                 for _ in range(2))
    monkeypatch.setattr(packaging, 'load_pose_estimator', lambda path, device='cuda': port)
    monkeypatch.setattr(jax_packaging, 'load_pose_estimator', lambda path: jax)
    root = tmp_path / 'aspset'
    names = mint_aspset_with_videos(root, n_frames=14, fourcc='mp4v')
    before = mpeg4.frames_decoded()
    predict_aspset.main(['--package', 'stub', '--root', str(root), '--output-dir',
                         str(tmp_path / 'port'), '--device', 'cpu'])
    assert mpeg4.frames_decoded() - before == 2 * 14
    jax_predict_aspset.main(['--package', 'stub', '--root', str(root), '--output-dir',
                             str(tmp_path / 'jax')])
    for name in names:
        with np.load(tmp_path / 'port' / f'{name}.npz') as a, \
                np.load(tmp_path / 'jax' / f'{name}.npz') as b:
            assert a['coords3d_pred_world'].shape == (14, 17, 3)
            np.testing.assert_array_equal(a['coords3d_pred_world'], b['coords3d_pred_world'])
    assert len(port.calls) == len(jax.calls) == 4
    for (_, im1, _), (_, im2, _) in zip(port.calls, jax.calls):
        np.testing.assert_array_equal(im1, im2)


def test_predict_aspset_on_xvid_asp_matches_jax(tmp_path, monkeypatch):
    """JAX's layout with libxvidcore's Advanced Simple .mkv videos (the usual
    packed stream with quarter-pel, MPEG quantisation and GMC; B-VOPs with
    presentation timestamps): the port's frames equal cv2's, so the driver
    gives JAX's poses and hands the estimator JAX's very images; each VOP is
    decoded once."""
    import shutil

    import metrabs_tpu.io.packaging as jax_packaging
    import metrabs_tpu_torch.io.packaging as packaging
    from _torch_mp4v_asp_fixtures import ASP_DIR
    from metrabs_tpu.apps import predict_aspset as jax_predict_aspset
    from metrabs_tpu_torch.data import mpeg4
    monkeypatch.setitem(layouts.SKELETON_JOINTS, 'aspset_17', 17)
    port, jax = (layouts.StubEstimator(skeleton_names=tuple(layouts.SKELETON_JOINTS))
                 for _ in range(2))
    monkeypatch.setattr(packaging, 'load_pose_estimator', lambda path, device='cuda': port)
    monkeypatch.setattr(jax_packaging, 'load_pose_estimator', lambda path: jax)
    root = tmp_path / 'aspset'
    names = mint_aspset_with_videos(root, n_frames=24, w=96, h=66)
    for name, clip in zip(names, ('xvid_asp_usual_96x66.mkv', 'xvid_asp_bvop.mkv')):
        subj = name.split('-')[0]
        shutil.copy(ASP_DIR / clip, root / 'test' / 'videos' / subj / f'{name}.mkv')
    before = mpeg4.frames_decoded()
    predict_aspset.main(['--package', 'stub', '--root', str(root), '--output-dir',
                         str(tmp_path / 'port'), '--device', 'cpu'])
    assert mpeg4.frames_decoded() - before == 2 * 24
    jax_predict_aspset.main(['--package', 'stub', '--root', str(root), '--output-dir',
                             str(tmp_path / 'jax')])
    for name in names:
        with np.load(tmp_path / 'port' / f'{name}.npz') as a, \
                np.load(tmp_path / 'jax' / f'{name}.npz') as b:
            assert a['coords3d_pred_world'].shape == (24, 17, 3)
            np.testing.assert_array_equal(a['coords3d_pred_world'], b['coords3d_pred_world'])
    assert len(port.calls) == len(jax.calls) == 6
    for (_, im1, _), (_, im2, _) in zip(port.calls, jax.calls):
        np.testing.assert_array_equal(im1, im2)


def test_predict_aspset_with_the_real_estimator(tmp_path, tiny_package, one_torch_thread):
    root = tmp_path / 'aspset'
    names = mint_aspset_with_videos(root, n_frames=5)
    with pytest.warns(UserWarning, match='bone_mean_lengths'):
        predict_aspset.main(['--package', tiny_package, '--root', str(root), '--output-dir',
                             str(tmp_path / 'out'), '--batch-size', '2', '--device', 'cpu'])
    for name in names:
        with np.load(tmp_path / 'out' / f'{name}.npz') as f:
            assert f['coords3d_pred_world'].shape == (5, 17, 3)
            assert np.isfinite(f['coords3d_pred_world']).all()


@pytest.mark.parametrize('driver', ['predict_3dpw', 'predict_mupots'])
def test_viz_dir_writes_jax_file_names(tmp_path, monkeypatch, driver):
    import importlib

    import metrabs_tpu.io.packaging as jax_packaging
    import metrabs_tpu_torch.io.packaging as packaging
    monkeypatch.setattr(packaging, 'load_pose_estimator',
                        lambda path, device='cuda': layouts.StubEstimator())
    monkeypatch.setattr(jax_packaging, 'load_pose_estimator',
                        lambda path: layouts.StubEstimator())
    root = tmp_path / 'data'
    if driver == 'predict_3dpw':
        layouts.mint_3dpw(root, np.random.default_rng(3), n_seqs=2, n_frames=5)
        extra = ['--gtassoc', '--batch-size', '3']
    else:
        layouts.mint_mupots(root, np.random.default_rng(2), sequences=(1, 6), n_frames=5)
        extra = ['--batch-size', '2']
    for package, out in (('metrabs_tpu_torch', 'port'), ('metrabs_tpu', 'jax')):
        argv = ['--package', 'stub', '--root', str(root), '--output-path',
                str(tmp_path / f'{out}_pred'), '--viz-dir', str(tmp_path / f'{out}_viz'),
                '--viz-step', '2'] + extra
        if package == 'metrabs_tpu_torch':
            argv += ['--device', 'cpu']
        importlib.import_module(f'{package}.apps.{driver}').main(argv)
    got, want = (sorted(os.listdir(tmp_path / f'{out}_viz')) for out in ('port', 'jax'))
    assert got == want and len(got) == 6
    for name in got:
        figure = improc.imread(str(tmp_path / 'port_viz' / name))
        assert figure.ndim == 3 and figure.shape[1] > figure.shape[0] > 100
