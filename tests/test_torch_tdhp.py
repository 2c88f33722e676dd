"""MPI-INF-3DHP's scoring path in the port (`data.datasets.load_3dhp_test_frames`,
`apps.predict_3dhp`, `apps.eval_3dhp`) against the JAX package's, on layouts
minted in `tmp_path`: `annot_data.mat` in MATLAB's layout written by h5py
(tests/_torch_hdf5_fixtures.py) under each of LIBVERS (superblock v0, v2
with v2 object headers and dense attributes, v3 with layout-v4 chunk
indexes), JPEG frames written by cv2.

The drivers run twice with one `StubEstimator` each (the same images bit for
bit, the same keyword arguments, equal NPZ), then with the real estimators
of one minted package (a tiny backbone at 64 px and a YOLOv4-tiny at 96 px)
on the CPU: the port's poses within POSE_TOL of JAX's. The eval apps print
the same metrics on the same dump.
"""

import json

import numpy as np
import pytest

import _torch_bench_layouts as layouts
from _torch_train import one_torch_thread  # noqa: F401 (fixture)

SEQUENCES = {1: (5, [1]), 3: (3, []), 5: (4, [2])}  # TS: (frames, invalid frames)
FRAME_HW = {1: (128, 128), 3: (128, 128), 5: (68, 120)}  # 2048x2048 and 1920x1080 / 16
SCALE = 1 / 16
# predict_3dhp's world-space poses, port against JAX on one package (float32
# convolutions on both sides; tests/test_torch_estimator.py's tolerance).
POSE_TOL = dict(atol=1.0, rtol=1e-3)
# The annotation files' bounds: h5py's default, v108 and latest (the last
# with groups and datasets that track creation order).
LIBVERS = ('earliest', 'v108', 'latest')


@pytest.fixture
def layout(tmp_path, request):
    """The 3DHP layout, its annotations written under `request.param`
    (default: h5py's default bound)."""
    libver = getattr(request, 'param', 'earliest')
    root = tmp_path / '3dhp'
    cameras = layouts.mint_3dhp(root, SEQUENCES, FRAME_HW, SCALE, libver=libver,
                                track_order=libver == 'latest')
    version = (root / 'TS1' / 'annot_data.mat').read_bytes()[512 + 8]
    assert version == {'earliest': 0, 'v108': 2, 'latest': 3}[libver]
    return root, cameras


@pytest.mark.parametrize('layout', LIBVERS, indirect=True)
def test_load_3dhp_test_frames_matches_jax(layout):
    from metrabs_tpu.data.datasets import load_3dhp_test_frames as jax_load
    from metrabs_tpu_torch.data.datasets import load_3dhp_test_frames
    root, cameras = layout
    ours, theirs = load_3dhp_test_frames(str(root), cameras), jax_load(str(root), cameras)
    assert [s[0] for s in ours] == [s[0] for s in theirs] == ['TS1', 'TS3', 'TS5']
    for (name, paths, cam), (_, want_paths, want_cam) in zip(ours, theirs):
        assert paths == want_paths
        assert len(paths) == SEQUENCES[int(name[2:])][0] - len(SEQUENCES[int(name[2:])][1])
        for field in ('intrinsic_matrix', 'extrinsic_matrix', 'distortion_coeffs', 'world_up'):
            got, want = getattr(cam, field), getattr(want_cam, field)
            if want is None:
                assert got is None, field
            else:
                np.testing.assert_array_equal(got, want, err_msg=field)
    assert ours[2][2].distortion_coeffs.shape == (12,)


@pytest.fixture
def stubs(monkeypatch):
    """(port stub, JAX stub), each with a detector, returned by each
    package's `load_pose_estimator`; the port's records its device."""
    import metrabs_tpu.io.packaging as jax_packaging
    import metrabs_tpu_torch.io.packaging as packaging
    port, jax = layouts.StubEstimator(), layouts.StubEstimator()
    port.detector = jax.detector = object()
    port.devices = []

    def load_port(path, device='cuda'):
        port.devices.append(device)
        return port
    monkeypatch.setattr(packaging, 'load_pose_estimator', load_port)
    monkeypatch.setattr(jax_packaging, 'load_pose_estimator', lambda path: jax)
    return port, jax


def run_both(layout, tmp_path, extra=()):
    from metrabs_tpu.apps import predict_3dhp as jax_predict
    from metrabs_tpu_torch.apps import predict_3dhp
    root, cameras = layout
    args = ['--root', str(root), '--cameras-json', cameras, '--batch-size', '3', *extra]
    predict_3dhp.main(args + ['--package', 'pkg', '--output-path', str(tmp_path / 'port.npz'),
                              '--device', 'cpu'])
    jax_predict.main(args + ['--package', 'pkg', '--output-path', str(tmp_path / 'jax.npz')])


@pytest.mark.parametrize('layout', LIBVERS, indirect=True)
def test_predict_3dhp_matches_jax(tmp_path, layout, stubs):
    from test_torch_bench_apps import assert_npz_equal, assert_same_calls
    run_both(layout, tmp_path, ['--num-aug', '2'])
    port, jax = stubs
    assert port.devices == ['cpu']
    # TS1: 4 valid frames in batches of 3, TS3: 3, TS5: 3 (1920x1080 with distortion).
    assert [c[1].shape[:3] for c in port.calls] == [(3, 128, 128), (1, 128, 128),
                                                    (3, 128, 128), (3, 68, 120)]
    assert_same_calls(port, jax)
    kwargs = port.calls[-1][2]
    assert kwargs['max_detections'] == 1 and kwargs['detector_flip_aug']
    assert kwargs['skeleton'] == 'mpi_inf_3dhp_17' and kwargs['num_aug'] == 2
    assert np.any(kwargs['distortion_coeffs'] != 0) and kwargs['distortion_coeffs'].shape == (3, 12)
    assert_npz_equal(tmp_path / 'port.npz', tmp_path / 'jax.npz')


def test_predict_3dhp_refuses_what_jax_refuses(tmp_path, layout, stubs):
    from metrabs_tpu_torch.apps import predict_3dhp
    port, _ = stubs
    root, cameras = layout
    argv = ['--package', 'pkg', '--root', str(root), '--cameras-json', cameras,
            '--output-path', str(tmp_path / 'o.npz'), '--device', 'cpu']
    port.skeletons.skeleton_names = ('h36m_17',)
    with pytest.raises(ValueError, match='mpi_inf_3dhp_17'):
        predict_3dhp.main(argv)
    port.detector = None
    with pytest.raises(ValueError, match='detector-driven'):
        predict_3dhp.main(argv)


@pytest.fixture(scope='module')
def package(tmp_path_factory):
    """A JAX package: tiny backbone at 64 px on H36M-17 joints (whose
    registry has mpi_inf_3dhp_17) with a float32 YOLOv4-tiny at 96 px."""
    from _torch_port import make_family_package
    return make_family_package(str(tmp_path_factory.mktemp('tdhp') / 'pkg'), 'tiny',
                               detector='yolov4-tiny', detector_input_size=96)


@pytest.mark.parametrize('layout', ['latest'], indirect=True)
def test_predict_3dhp_with_the_real_estimators_matches_jax(tmp_path, layout, package,
                                                           one_torch_thread):
    """Both drivers on one package, on annotations of superblock v3: the
    same frames (paths), and the port's poses within POSE_TOL of JAX's,
    whose detector picked the same person."""
    from metrabs_tpu.apps import predict_3dhp as jax_predict
    from metrabs_tpu_torch.apps import predict_3dhp
    root, cameras = layout
    args = ['--package', package, '--root', str(root), '--cameras-json', cameras,
            '--batch-size', '4']
    predict_3dhp.main(args + ['--output-path', str(tmp_path / 'port.npz'), '--device', 'cpu'])
    jax_predict.main(args + ['--output-path', str(tmp_path / 'jax.npz')])
    with np.load(tmp_path / 'port.npz') as got, np.load(tmp_path / 'jax.npz') as want:
        np.testing.assert_array_equal(got['image_path'], want['image_path'])
        poses, want_poses = got['coords3d_pred_world'], want['coords3d_pred_world']
        assert poses.shape == want_poses.shape == (10, 17, 3) and np.isfinite(poses).all()
        np.testing.assert_allclose(poses, want_poses, **POSE_TOL)


@pytest.mark.parametrize('layout', LIBVERS, indirect=True)
def test_eval_3dhp_matches_jax(tmp_path, layout, stubs, capsys):
    """The stub's dump, one frame's prediction dropped (undetected: infinite
    error), scored by both eval apps."""
    from metrabs_tpu.apps import eval_3dhp as jax_eval
    from metrabs_tpu_torch.apps import eval_3dhp
    from metrabs_tpu_torch.utils import hdf5
    run_both(layout, tmp_path)
    with np.load(tmp_path / 'port.npz') as f:
        paths, poses = f['image_path'], f['coords3d_pred_world']
    # Predictions near the ground truth, so that PCK and AUC are neither 0 nor 100.
    root, _ = layout
    rng = np.random.default_rng(0)
    for i, path in enumerate(paths):
        seq = next(p for p in str(path).split('/') if p.startswith('TS'))
        with hdf5.File(str(root / seq / 'annot_data.mat')) as m:
            frame = int(str(path).split('_')[-1].split('.')[0]) - 1
            poses[i] = m['annot3'][()][frame, 0] + rng.normal(0, 60, (17, 3))
    np.savez(tmp_path / 'scored.npz', image_path=paths[1:], coords3d_pred_world=poses[1:])
    for extra in ([], ['--threshold-mm', '100']):
        argv = ['--pred-path', str(tmp_path / 'scored.npz'), '--root', str(root)] + extra
        capsys.readouterr()
        ours = eval_3dhp.main(argv)
        printed = capsys.readouterr().out
        theirs = jax_eval.main(argv)
        assert printed == capsys.readouterr().out
        assert ours == theirs and json.loads(printed) == ours
        assert ours['n_frames'] == 10 and 0 < ours['pck'] < 100 and np.isfinite(ours['mpjpe'])
        assert sorted(ours['per_seq_pck']) == ['TS1', 'TS3', 'TS5']
    np.savez(tmp_path / 'none.npz', image_path=np.array(['x/TS2/img_000001.jpg']),
             coords3d_pred_world=np.zeros((1, 17, 3)))
    for main in (eval_3dhp.main, jax_eval.main):
        with pytest.raises(SystemExit, match='No prediction matched'):
            main(['--pred-path', str(tmp_path / 'none.npz'), '--root', str(root)])


def test_fixtures_read_as_their_manifest_says():
    """The committed fixtures (annotations under three bounds, the 6151-frame
    one, the structures of v3 files, SWMR and paged files), read by the
    port's reader and by h5py, against the manifest (what h5py read when
    they were written): every group's members in order, every dataset and
    alias, every attribute in order."""
    import h5py

    import _torch_hdf5_fixtures as fixtures
    from metrabs_tpu_torch.utils import hdf5
    manifest = fixtures.read_manifest()
    on_disk = sorted(p.name for p in fixtures.FIXTURE_DIR.iterdir() if p.name != 'manifest.json')
    assert sorted(manifest) == on_disk
    assert {fixtures.fixture_name(s) for s in fixtures.SEQUENCES} | {
        fixtures.LARGE_NAME, fixtures.STRUCTURES, fixtures.EXTERNAL, 'swmr.h5',
        'page.h5'} == set(manifest)
    versions = {}
    for name, want in manifest.items():
        path = fixtures.FIXTURE_DIR / name
        if name.endswith('.mat'):
            assert path.read_bytes().startswith(b'MATLAB 7.3 MAT-file')
        with hdf5.File(path) as ours, h5py.File(path, 'r') as theirs:
            versions[name] = ours._reader.version
            assert list(ours) == list(theirs)
            for group, members in want['groups'].items():
                assert list(ours[group]) == list(theirs[group]) == members, (name, group)
            for key, digest in want['datasets'].items():
                assert fixtures.digest(ours[key][()]) == digest, (name, key)
                assert fixtures.digest(theirs[key][()]) == digest, (name, key)
            for key, target in want['aliases'].items():
                assert fixtures.digest(ours[key][()]) == want['datasets'][target], (name, key)
            for key, attrs in want['attrs'].items():
                assert list(ours[key].attrs) == [attr for attr, _ in attrs], (name, key)
                for attr, digest in attrs:
                    assert fixtures.digest(ours[key].attrs[attr]) == digest, (name, key, attr)
            if name.endswith('.mat'):
                assert ours['annot3'].attrs['MATLAB_class'] == b'double'
    assert [versions[fixtures.fixture_name(s)] for s in ('TS1', 'TS2', 'TS5', 'TS6')] == [
        0, 2, 0, 3]
    assert versions[fixtures.STRUCTURES] == versions[fixtures.LARGE_NAME] == 3
