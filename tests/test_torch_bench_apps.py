"""The port's benchmark drivers (`metrabs_tpu_torch/apps/{predict,eval}_*`,
`eval_benchmark`, `average_metrics`) against the JAX package's.

Each prediction driver runs twice on a JPEG layout minted in `tmp_path`,
the JAX driver and the port's, each with the same `StubEstimator`
(tests/_torch_bench_layouts.py): both must hand the estimator the same
images, bit for bit (so the port's decode equals cv2's), with the same
keyword arguments, and write equal files. The eval apps print JAX's
metrics on the same dumps. The port's real estimator then runs
`predict_h36m`, `predict_3dpw` and `eval_benchmark` at a tiny width on the
CPU, and the options the port refuses raise NotImplementedError.
"""

import json
import pickle

import numpy as np
import pytest
import torch

import _torch_bench_layouts as layouts
from _torch_train import one_torch_thread  # noqa: F401 (fixture)

# pa_mpjpe: Procrustes in float32 through torch's eigensolver against JAX's
# (they agree to ~2e-7 in rotation); every other metric is equal.
PA_MPJPE_RTOL = 1e-5
# eval_benchmark's metrics through torch against JAX's evaluate_predictions.
METRIC_RTOL = 1e-5


@pytest.fixture
def stubs(monkeypatch):
    """(port stub, JAX stub): each package's `load_pose_estimator` returns
    its own; the port's records the device it was asked for."""
    import metrabs_tpu.io.packaging as jax_packaging
    import metrabs_tpu_torch.io.packaging as packaging
    port, jax = layouts.StubEstimator(), layouts.StubEstimator()
    port.devices = []

    def load_port(path, device='cuda'):
        port.devices.append(device)
        return port
    monkeypatch.setattr(packaging, 'load_pose_estimator', load_port)
    monkeypatch.setattr(jax_packaging, 'load_pose_estimator', lambda path: jax)
    return port, jax


def assert_same_calls(port, jax):
    assert len(port.calls) == len(jax.calls) > 0
    for (m1, im1, kw1), (m2, im2, kw2) in zip(port.calls, jax.calls):
        assert m1 == m2
        assert im1.dtype == im2.dtype == np.uint8 and im1.shape == im2.shape
        np.testing.assert_array_equal(im1, im2)
        assert kw1.keys() == kw2.keys()
        for k, want in kw2.items():
            got = kw1[k]
            if isinstance(want, np.ndarray):
                assert got.dtype == want.dtype and got.shape == want.shape, k
                np.testing.assert_array_equal(got, want, err_msg=k)
            else:
                assert got == want, k


def assert_npz_equal(path_a, path_b):
    with np.load(path_a) as a, np.load(path_b) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def run_both(name, argv_port, argv_jax):
    import importlib
    importlib.import_module(f'metrabs_tpu_torch.apps.{name}').main(argv_port)
    importlib.import_module(f'metrabs_tpu.apps.{name}').main(argv_jax)


def test_predict_h36m_matches_jax(tmp_path, stubs):
    root = tmp_path / 'h36m'
    info = layouts.mint_h36m(root, np.random.default_rng(0), subjects=(9, 11),
                             activities=('Walking',), n_frames=8, frame_step=4)
    args = ['--package', 'pkg', '--h36m-root', str(root), '--cameras-json',
            info['cameras_json'], '--frame-step', '4', '--batch-size', '6']
    run_both('predict_h36m', args + ['--output-path', str(tmp_path / 'port.npz'),
                                     '--device', 'cpu'],
             args + ['--output-path', str(tmp_path / 'jax.npz')])
    port, jax = stubs
    assert port.devices == ['cpu'] and len(port.calls) == 3  # 16 examples in batches of 6
    assert_same_calls(port, jax)
    assert_npz_equal(tmp_path / 'port.npz', tmp_path / 'jax.npz')


def test_predict_3doh_matches_jax(tmp_path, stubs):
    """Its last frame has another size: that batch splits frame by frame."""
    layouts.mint_3doh(tmp_path / '3doh', np.random.default_rng(1), n=5)
    args = ['--package', 'pkg', '--root', str(tmp_path / '3doh'), '--batch-size', '3']
    run_both('predict_3doh', args + ['--output-path', str(tmp_path / 'port.npz'),
                                     '--device', 'cpu'],
             args + ['--output-path', str(tmp_path / 'jax.npz')])
    port, jax = stubs
    assert [c[1].shape[0] for c in port.calls] == [3, 1, 1]
    assert_same_calls(port, jax)
    assert_npz_equal(tmp_path / 'port.npz', tmp_path / 'jax.npz')


def test_predict_and_eval_mupots_match_jax(tmp_path, stubs, capsys):
    root = tmp_path / 'mupots'
    layouts.mint_mupots(root, np.random.default_rng(2), sequences=(1, 6), n_frames=5)
    args = ['--package', 'pkg', '--root', str(root), '--batch-size', '2',
            '--max-detections', '4', '--num-aug', '2']
    run_both('predict_mupots', args + ['--output-path', str(tmp_path / 'port.npz'),
                                       '--device', 'cpu'],
             args + ['--output-path', str(tmp_path / 'jax.npz')])
    port, jax = stubs
    assert_same_calls(port, jax)
    assert_npz_equal(tmp_path / 'port.npz', tmp_path / 'jax.npz')

    from metrabs_tpu.apps import eval_mupots as jax_eval
    from metrabs_tpu_torch.apps import eval_mupots
    for extra in ([], ['--all-joints'], ['--threshold-mm', '2000']):
        argv = ['--pred-path', str(tmp_path / 'port.npz'), '--root', str(root)] + extra
        capsys.readouterr()
        ours = eval_mupots.main(argv)
        printed = capsys.readouterr().out
        theirs = jax_eval.main(argv)
        assert printed == capsys.readouterr().out
        assert ours == theirs and ours['n_frames'] == 10
    assert ours['recall'] > 0


@pytest.mark.parametrize('association', ['gtassoc', 'masks', 'gtassoc_real_intrinsics'])
def test_predict_and_eval_3dpw_match_jax(tmp_path, stubs, capsys, association):
    root = tmp_path / '3dpw'
    masks_dir = tmp_path / 'masks'
    layouts.mint_3dpw(root, np.random.default_rng(3), n_seqs=2, n_frames=5,
                      masks_dir=masks_dir if association == 'masks' else None)
    args = ['--package', 'pkg', '--root', str(root), '--batch-size', '3', '--num-aug', '2']
    if association == 'masks':
        args += ['--masks-dir', str(masks_dir)]
    else:
        args += ['--gtassoc']
    if association.endswith('real_intrinsics'):
        args += ['--real-intrinsics']
    run_both('predict_3dpw', args + ['--output-path', str(tmp_path / 'port'), '--device', 'cpu'],
             args + ['--output-path', str(tmp_path / 'jax')])
    port, jax = stubs
    assert len(port.calls) == 4  # 2 sequences of 5 frames in batches of 3
    assert_same_calls(port, jax)
    for name in ('seq_00', 'seq_01'):
        got = pickle.loads((tmp_path / 'port' / 'test' / f'{name}.pkl').read_bytes())
        want = pickle.loads((tmp_path / 'jax' / 'test' / f'{name}.pkl').read_bytes())
        assert got.keys() == want.keys() == {'jointPositions'}
        assert got['jointPositions'].shape == (2, 5, 24, 3)
        np.testing.assert_array_equal(got['jointPositions'], want['jointPositions'])

    from metrabs_tpu.apps import eval_3dpw as jax_eval
    from metrabs_tpu_torch.apps import eval_3dpw
    for extra in ([], ['--joints', '0,1,2,4,5,16']):
        argv = ['--pred-path', str(tmp_path / 'port'), '--root', str(root)] + extra
        capsys.readouterr()
        ours = eval_3dpw.main(argv + ['--device', 'cpu'])
        printed = json.loads(capsys.readouterr().out)
        theirs = jax_eval.main(argv)
        assert printed == ours and json.loads(capsys.readouterr().out) == theirs
        assert ours.keys() == theirs.keys()
        for k, v in theirs.items():
            if k == 'pa_mpjpe':
                assert ours[k] == pytest.approx(v, rel=PA_MPJPE_RTOL)
            else:
                assert ours[k] == v, k
        assert ours['n_poses'] > 0 and np.isfinite(ours['pa_mpjpe'])


def test_average_metrics_matches_jax(tmp_path, capsys):
    from metrabs_tpu.apps import average_metrics as jax_average
    from metrabs_tpu_torch.apps import average_metrics
    rng = np.random.default_rng(4)
    paths = []
    for i in range(3):
        run = dict(benchmark='h36m', mpjpe=float(rng.uniform(40, 60)), n_poses=100 + i,
                   pck=float(rng.uniform(80, 95)))
        if i == 2:
            del run['pck']
        paths.append(str(tmp_path / f'run{i}.json'))
        (tmp_path / f'run{i}.json').write_text(json.dumps(run))
    for files in (paths, paths[:1]):
        capsys.readouterr()
        average_metrics.main(files)
        ours = capsys.readouterr().out
        jax_average.main(files)
        assert ours == capsys.readouterr().out and json.loads(ours)['mpjpe']['n'] == len(files)


# --- the port's real estimator on the CPU, at a tiny width -----------------

@pytest.fixture(scope='module')
def tiny_package(tmp_path_factory):
    """A tiny-backbone 64 px Metrabs package with a YOLOv4-tiny detector,
    weights minted from a seed (tests/_torch_port.py)."""
    from _torch_port import make_family_package
    directory = str(tmp_path_factory.mktemp('tiny_package') / 'pkg')
    return make_family_package(directory, 'tiny', detector='yolov4-tiny',
                               detector_input_size=96)


@pytest.fixture(scope='module')
def tiny_smpl_package(tmp_path_factory):
    """A tiny-backbone 64 px Metrabs package on SMPL-24 joints (predict_3dpw
    asks for skeleton smpl_24) with a YOLOv4-tiny detector whose heads fire
    (chip_smoke.firing_detector_variables), minted with torch alone."""
    import chip_smoke
    from metrabs_tpu_torch.config import AugConfig, ModelConfig
    from metrabs_tpu_torch.io.packaging import save_pose_estimator_package
    from metrabs_tpu_torch.pipeline.skeletons import SMPL_24
    cfg = ModelConfig(proc_side=64, backbone='tiny', n_joints=24, dtype='float32',
                      backbone_scan_blocks=False)
    gen = torch.Generator().manual_seed(8)
    directory = str(tmp_path_factory.mktemp('tiny_smpl_package') / 'pkg')
    save_pose_estimator_package(
        directory, cfg=cfg, aug_cfg=AugConfig(), joint_info=SMPL_24,
        crop_model_variables=chip_smoke.mint_crop_variables(cfg, gen),
        detector_variables=chip_smoke.firing_detector_variables(gen, 'yolov4-tiny'),
        detector_type='yolov4-tiny', detector_dtype='float32', detector_input_size=96)
    return directory


def test_predict_h36m_with_the_real_estimator(tmp_path, tiny_package, one_torch_thread):
    from metrabs_tpu_torch.apps import predict_h36m
    root = tmp_path / 'h36m'
    info = layouts.mint_h36m(root, np.random.default_rng(5), subjects=(9,),
                             activities=('Walking',), n_frames=8, frame_step=4)
    out = tmp_path / 'h36m.npz'
    predict_h36m.main(['--package', tiny_package, '--h36m-root', str(root), '--cameras-json',
                       info['cameras_json'], '--frame-step', '4', '--output-path', str(out),
                       '--batch-size', '3', '--device', 'cpu'])
    with np.load(out) as f:
        assert f['coords3d_pred_world'].shape == (8, 17, 3) and len(f['image_path']) == 8
        assert np.isfinite(f['coords3d_pred_world']).all()


def test_predict_3dpw_with_the_real_estimator(tmp_path, tiny_smpl_package, one_torch_thread):
    from metrabs_tpu_torch.apps import eval_3dpw, predict_3dpw
    root = tmp_path / '3dpw'
    layouts.mint_3dpw(root, np.random.default_rng(6), n_seqs=1, n_frames=4,
                      frame_hw=(96, 128))
    predict_3dpw.main(['--package', tiny_smpl_package, '--root', str(root), '--output-path',
                       str(tmp_path / 'pred'), '--gtassoc', '--batch-size', '2',
                       '--device', 'cpu'])
    got = pickle.loads((tmp_path / 'pred' / 'test' / 'seq_00.pkl').read_bytes())
    poses = got['jointPositions']
    assert poses.shape == (2, 4, 24, 3)
    assert np.isfinite(poses).all()  # every track found in every frame
    out = eval_3dpw.main(['--pred-path', str(tmp_path / 'pred'), '--root', str(root),
                          '--device', 'cpu'])
    assert out['n_poses'] == 7 and np.isfinite(out['pa_mpjpe'])  # one frame's campose invalid


@pytest.mark.parametrize('benchmark', ['h36m', '3dpw'])
def test_eval_benchmark_prints_jax_metrics_of_its_predictions(tmp_path, tiny_package, capsys,
                                                            one_torch_thread, benchmark):
    """The port's `eval_benchmark` on a pickle of Human3.6M examples with
    JPEG frames (written by the JAX adapter), its prediction dump scored by
    JAX's `evaluate_predictions`: the same metric table."""
    from metrabs_tpu.data.datasets import load_h36m_examples
    from metrabs_tpu.eval.harness import (BENCHMARK_PROTOCOLS, JOINT_SUBSETS,
                                          evaluate_predictions)
    from metrabs_tpu.pipeline.skeletons import H36M_17
    from metrabs_tpu_torch.apps import eval_benchmark
    root = tmp_path / 'h36m'
    info = layouts.mint_h36m(root, np.random.default_rng(7), subjects=(9,),
                             activities=('Walking',), n_frames=8, frame_step=4)
    examples = load_h36m_examples(str(root), info['cameras_json'], subjects=(9,), frame_step=4)
    (tmp_path / 'examples.pkl').write_bytes(pickle.dumps(examples))
    capsys.readouterr()
    eval_benchmark.main(['--package', tiny_package, '--examples', str(tmp_path / 'examples.pkl'),
                         '--benchmark', benchmark, '--pred-out', str(tmp_path / 'preds.npz'),
                         '--batch-size', '5', '--workers', '2', '--mirror-aug',
                         '--device', 'cpu'])
    printed = json.loads(capsys.readouterr().out)
    protocol = BENCHMARK_PROTOCOLS[benchmark]
    with np.load(tmp_path / 'preds.npz') as f:
        preds = {k: f[k] for k in f.files}
    assert preds['poses3d_pred_cam'].shape == (len(examples), 17, 3)
    want = evaluate_predictions(
        preds, joint_info=H36M_17, threshold_mm=protocol.pck_threshold_mm,
        joint_subset=JOINT_SUBSETS[protocol.joint_subset] if protocol.joint_subset else None)
    assert printed.pop('benchmark') == benchmark
    assert printed.keys() == want.keys()
    for k, v in want.items():
        assert printed[k] == pytest.approx(float(v), rel=METRIC_RTOL, abs=1e-6), k


# --- what the port refuses ---------------------------------------------------

@pytest.mark.parametrize('driver', ['predict_3dpw', 'predict_mupots'])
def test_viz_dir_raises(tmp_path, driver):
    import importlib
    main = importlib.import_module(f'metrabs_tpu_torch.apps.{driver}').main
    with pytest.raises(NotImplementedError, match='ROADMAP.md'):
        main(['--package', 'pkg', '--root', str(tmp_path), '--output-path', str(tmp_path / 'o'),
              '--viz-dir', str(tmp_path / 'viz'), '--device', 'cpu'])


def test_eval_benchmark_hdf5_dump_raises(tmp_path, tiny_package, one_torch_thread):
    """F5: `--pred-out x.h5` needed h5py, which the card's machine lacks."""
    from metrabs_tpu_torch.apps import eval_benchmark
    from metrabs_tpu_torch.data.camera import Camera
    from metrabs_tpu_torch.data.loading import Example3D
    layouts.write_jpeg(tmp_path / 'f.jpg', 80, 60, seed=0)
    cam = Camera(intrinsic_matrix=np.float32([[100, 0, 30], [0, 100, 40], [0, 0, 1]]),
                 world_up=(0, -1, 0))
    pose = np.random.default_rng(9).normal(0, 200, (17, 3)) + [0, 0, 3000]
    example = Example3D(image_path=str(tmp_path / 'f.jpg'), camera=cam,
                        bbox=np.float32([10, 10, 40, 60]), world_coords=pose.astype(np.float32))
    (tmp_path / 'ex.pkl').write_bytes(pickle.dumps([example]))
    with pytest.raises(NotImplementedError, match='ROADMAP.md'):
        eval_benchmark.main(['--package', tiny_package, '--examples', str(tmp_path / 'ex.pkl'),
                             '--pred-out', str(tmp_path / 'p.h5'), '--device', 'cpu'])


@pytest.mark.parametrize('driver', ['predict_h36m', 'predict_3doh', 'predict_mupots',
                                    'predict_3dpw', 'eval_benchmark', 'eval_3dpw'])
def test_drivers_default_to_cuda_and_raise_without_it(tmp_path, tiny_package, monkeypatch,
                                                      driver):
    import importlib
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    main = importlib.import_module(f'metrabs_tpu_torch.apps.{driver}').main
    argv = dict(
        predict_h36m=['--h36m-root', str(tmp_path), '--cameras-json', 'c.json',
                      '--output-path', 'o.npz'],
        predict_3doh=['--root', str(tmp_path), '--output-path', 'o.npz'],
        predict_mupots=['--root', str(tmp_path), '--output-path', 'o.npz'],
        predict_3dpw=['--root', str(tmp_path), '--output-path', 'o'],
        eval_benchmark=['--examples', 'e.pkl'],
        eval_3dpw=['--pred-path', str(tmp_path), '--root', str(tmp_path)])[driver]
    if driver != 'eval_3dpw':
        argv = ['--package', tiny_package] + argv
    with pytest.raises(RuntimeError, match="needs CUDA.*device='cpu'"):
        main(argv)
