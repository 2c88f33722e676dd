"""The port's training app (`metrabs_tpu_torch.apps.train.main`) on the CPU,
on example pickles written by the JAX package's classes (half of the images
as PNG files, half in memory), with the JAX package reading what it exports:

 - `main --device cpu` trains a tiny backbone at 64 px in float32 for 2 steps
   for each model class (Metrabs with validation, EMA export and the
   inference-mode BN phase; Metro; Model25D with its bone lengths), keeps
   the newest two checkpoints, then resumes from the checkpoint directory
   (restores step 2, takes exactly one step);
 - the exported package is read by JAX's `load_crop_model`, whose forward
   equals the port's on the same crops: computing in float64 on both sides
   within FORWARD_RTOL of the largest coordinate (Model25D: its 2.5D head;
   its bone solve within BONE_SOLVE_RTOL), in float32 (as exported) within
   1 mm + 1e-3;
 - `predict_dataset` (a partial last batch, with and without the mirror
   test-time augmentation) equals JAX's on the same weights within
   PREDICT_RTOL of the largest coordinate;
 - the flags and defaults are JAX's (`--device` added), `build_load_config`
   makes JAX's LoadConfig, and the multi-device flags used where they cannot
   apply raise SystemExit (the two-rank runs are in
   tests/test_torch_parallel.py).
"""

import json
import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrabs_tpu.apps import train as jax_train
from metrabs_tpu.data.camera import Camera
from metrabs_tpu.data.loading import Example2D, Example3D
from metrabs_tpu.eval import harness as jax_harness
from metrabs_tpu.io import packaging as jax_packaging
from metrabs_tpu.pipeline import skeletons as jax_skeletons
from metrabs_tpu_torch.apps import train
from metrabs_tpu_torch.data import cvfree
from metrabs_tpu_torch.data.loading import load_examples
from metrabs_tpu_torch.eval import harness
from metrabs_tpu_torch.io import packaging
from metrabs_tpu_torch.pipeline import skeletons
from tests._torch_train import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures('one_torch_thread')

FORWARD_RTOL = 1e-5  # of the largest coordinate
# Model25D's LM bone solve near the flat minimum of a random 2.5D head
# (tests/test_torch_crop_models.py: ~1e-4 between JAX's jit and eager too).
BONE_SOLVE_RTOL = 1e-4
# float32 convolutions of XLA and PyTorch through the absolute reconstruction.
PREDICT_RTOL = 1e-4  # of the largest coordinate


def _write_datasets(tmp_path, n=6):
    """JAX-written pickles of 3D, 2D and held-out 3D examples."""
    rng = np.random.default_rng(0)
    cam = Camera(optical_center=np.zeros(3, np.float32),
                 intrinsic_matrix=np.array([[250, 0, 80], [0, 250, 60], [0, 0, 1]], np.float32),
                 distortion_coeffs=np.array([-0.1, 0.02, 0, 0, 0], np.float32),
                 world_up=(0, -1, 0))
    ex3, ex2, val = [], [], []
    for i in range(n + 3):
        pose = (rng.normal(size=(17, 3)) * 150 + [0, 0, 3500]).astype(np.float32)
        img = rng.integers(0, 255, size=(120, 160, 3), dtype=np.uint8)
        path = str(tmp_path / f'{i}.png')
        cvfree.write_png(path, img)
        in_memory = img if i % 2 else None
        pts = cam.world_to_image(pose)
        (x0, y0), (x1, y1) = pts.min(0) - 10, pts.max(0) + 10
        mask = np.zeros((120, 160), np.float32)
        mask[int(max(y0, 0)):int(y1), int(max(x0, 0)):int(x1)] = 1
        example = Example3D(image_path=path, camera=cam,
                            bbox=np.array([x0, y0, x1 - x0, y1 - y0], np.float32),
                            world_coords=pose, image=in_memory, mask=mask)
        (ex3 if i < n else val).append(example)
        ex2.append(Example2D(image_path=path, bbox=np.array([30, 20, 100, 80], np.float32),
                             coords=rng.uniform(30, 110, size=(14, 2)).astype(np.float32),
                             image=in_memory, camera=cam if i % 3 else None))
    paths = {}
    for name, examples in (('ds3', ex3), ('ds2', ex2[:n]), ('val', val)):
        paths[name] = str(tmp_path / f'{name}.pkl')
        with open(paths[name], 'wb') as f:
            pickle.dump(examples, f)
    np.savez(tmp_path / 'bones.npz', lengths=np.full(len(jax_skeletons.H36M_17.edges), 300.0,
                                                     np.float32))
    return paths


def _argv(paths, tmp_path, model_class, steps):
    argv = ['--ds3d', paths['ds3'], '--ds2d', paths['ds2'],
            '--checkpoint-dir', str(tmp_path / f'ckpt_{model_class}'),
            '--backbone', 'tiny', '--proc-side', '64', '--depth', '4',
            '--batch-size', '3', '--batch-size-2d', '3', '--training-steps', str(steps),
            '--workers', '2', '--dtype', 'float32', '--checkpoint-period', '1',
            '--log-period', '1', '--export-dir', str(tmp_path / f'pkg_{model_class}'),
            '--model-class', model_class, '--device', 'cpu']
    if model_class == 'metrabs':
        argv += ['--ds3d-val', paths['val'], '--validate-period', '2', '--batch-size-test', '2',
                 '--ema-momentum', '0.9', '--finetune-in-inference-mode', '1']
    if model_class == 'model25d':
        argv += ['--bone-lengths', str(tmp_path / 'bones.npz')]
    return argv


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    """Each model class trained 2 steps, then resumed to 3."""
    tmp_path = tmp_path_factory.mktemp('app')
    paths = _write_datasets(tmp_path)
    out = {}
    for model_class in ('metrabs', 'metro', 'model25d'):
        train.main(_argv(paths, tmp_path, model_class, 2))
        ckpt = tmp_path / f'ckpt_{model_class}'
        first = sorted(p.name for p in ckpt.glob('*.pt'))
        log_first = [json.loads(l) for l in (ckpt / 'train_log.jsonl').read_text().splitlines()]
        train.main(_argv(paths, tmp_path, model_class, 3))
        log = [json.loads(l) for l in (ckpt / 'train_log.jsonl').read_text().splitlines()]
        out[model_class] = dict(first=first, second=sorted(p.name for p in ckpt.glob('*.pt')),
                                log_first=log_first, log=log,
                                package=str(tmp_path / f'pkg_{model_class}'))
    out['paths'] = paths
    return out


@pytest.mark.parametrize('model_class', ['metrabs', 'metro', 'model25d'])
def test_main_trains_resumes_and_checkpoints(trained, model_class):
    run = trained[model_class]
    assert run['first'] == ['1.pt', '2.pt'] and run['second'] == ['2.pt', '3.pt']
    steps = [r['step'] for r in run['log'] if 'loss' in r]
    assert steps == [1, 2, 3]  # the second run restored step 2 and took one step
    assert all(np.isfinite(r['loss']) and r['steps_per_sec'] > 0
               for r in run['log'] if 'loss' in r)
    val = [r for r in run['log'] if 'val_mean_error' in r]
    if model_class == 'metrabs':
        assert [r['step'] for r in val] == [2]
        assert all(np.isfinite(v) for r in val for k, v in r.items() if k.startswith('val_'))
    else:
        assert not val
    manifest = json.loads(open(f'{run["package"]}/manifest.json').read())
    assert manifest['model_class'] == model_class
    means = np.asarray(manifest['bone_mean_lengths'], np.float32)
    assert means.shape == (16,) and np.all(np.isfinite(means)) and np.all(means > 0)


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
@pytest.mark.parametrize('model_class', ['metrabs', 'metro', 'model25d'])
def test_exported_package_reads_in_jax_with_the_ports_forward(trained, model_class, dtype,
                                                              tmp_path):
    """As exported (float32: poses atol 1 mm + rtol 1e-3, the repo's bound
    between XLA's and PyTorch's float32 convolutions through the absolute
    reconstruction) and computing in float64 on both sides (FORWARD_RTOL of
    the largest coordinate)."""
    pkg = trained[model_class]['package']
    if dtype == 'float64':
        shutil.copytree(pkg, tmp_path / 'pkg')
        pkg = str(tmp_path / 'pkg')
        manifest = json.loads(open(f'{pkg}/manifest.json').read())
        manifest['model_config']['dtype'] = 'float64'
        open(f'{pkg}/manifest.json', 'w').write(json.dumps(manifest))
    rng = np.random.default_rng(1)
    crops = rng.uniform(0, 1, (3, 64, 64, 3)).astype(dtype)
    k = np.tile(np.array([[80, 0, 32], [0, 80, 32], [0, 0, 1]], dtype), (3, 1, 1))
    with jax.enable_x64(dtype == 'float64'):
        jmodel, jvariables, _, _, jmanifest = jax_packaging.load_crop_model(pkg)
        if dtype == 'float64':
            jvariables = jax.tree_util.tree_map(lambda v: np.asarray(v, np.float64), jvariables)
        want = np.asarray(jmodel.apply(jvariables, jnp.asarray(crops)) if model_class == 'metro'
                          else jmodel.apply(jvariables, jnp.asarray(crops), jnp.asarray(k)))
    model, cfg, _, manifest = packaging.load_crop_model(pkg, device='cpu')
    assert jmanifest == manifest
    model.to(getattr(torch, dtype))
    with torch.inference_mode():
        got = (model(torch.from_numpy(crops)) if model_class == 'metro'
               else model(torch.from_numpy(crops), torch.from_numpy(k))).numpy()
    assert got.dtype == want.dtype and np.all(np.isfinite(got))
    if dtype == 'float64' and model_class == 'model25d':
        with jax.enable_x64():
            want25d = np.asarray(jmodel.apply(jvariables, jnp.asarray(crops),
                                              method=jmodel.forward_25d))
        with torch.inference_mode():
            got25d = model.forward_25d(torch.from_numpy(crops)).numpy()
        np.testing.assert_allclose(got25d, want25d, rtol=0,
                                   atol=FORWARD_RTOL * np.abs(want25d).max())
        np.testing.assert_allclose(got, want, rtol=0, atol=BONE_SOLVE_RTOL * np.abs(want).max())
    elif dtype == 'float64':
        np.testing.assert_allclose(got, want, rtol=0, atol=FORWARD_RTOL * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1.0)


@pytest.mark.parametrize('mirror', [False, True], ids=['plain', 'mirror'])
def test_predict_dataset_matches_jax(trained, mirror):
    pkg = trained['metrabs']['package']
    examples = load_examples(trained['paths']['val'])
    with open(trained['paths']['val'], 'rb') as f:
        jax_examples = pickle.load(f)
    model, cfg, _, _ = packaging.load_crop_model(pkg, device='cpu')
    got = harness.predict_dataset(
        lambda c, k, v: model(c, k, sample_valid=v), examples, skeletons.H36M_17, cfg,
        batch_size=2, n_workers=2, test_time_mirror_aug=mirror, device='cpu')
    jmodel, jvariables, jcfg, _, _ = jax_packaging.load_crop_model(pkg)
    want = jax_harness.predict_dataset(
        lambda state, c, k, v: jmodel.apply(state, c, k, train=False, sample_valid=v),
        jax_examples, jax_skeletons.H36M_17, jcfg, crop_model_state=jvariables, batch_size=2,
        n_workers=2, test_time_mirror_aug=mirror)
    assert got.keys() == want.keys()
    assert len(got['poses3d_pred_cam']) == len(examples) == 3  # 2 + a padded batch of 1
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=PREDICT_RTOL * np.abs(want[key]).max(), err_msg=key)


def test_flags_and_load_config_match_jax():
    required = ['--ds3d', 'a', '--ds2d', 'b', '--checkpoint-dir', 'c']
    ours, theirs = vars(train.parse_args(required)), vars(jax_train.parse_args(required))
    assert ours.pop('device') == 'cuda'
    assert ours == theirs
    overrides = ['--no-color-aug', '--rot-aug-degrees', '5', '--occlude-aug-prob-2d', '0.1',
                 '--partial-visibility-prob', '0.2', '--no-geom-aug']
    assert (vars(train.build_load_config(train.parse_args(required + overrides)))
            == vars(jax_train.build_load_config(jax_train.parse_args(required + overrides))))


@pytest.mark.parametrize('flags,message', [
    (['--distributed'], 'torchrun'),
    (['--model-parallel', '2'], 'needs --distributed'),
    (['--model-parallel', '0', '--tp-min-size', '1024'], 'at least 1')],
    ids=['distributed', 'model_parallel', 'tp_min_size'])
def test_unported_flags_raise(tmp_path, flags, message, monkeypatch):
    """The multi-device flags where they cannot apply: `--distributed`
    outside torchrun, a model axis in one process, an empty model axis."""
    for name in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR', 'MASTER_PORT'):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(SystemExit, match=message):
        train.main(['--ds3d', 'a', '--ds2d', 'b', '--checkpoint-dir', str(tmp_path),
                    '--device', 'cpu'] + flags)


def test_main_raises_without_cuda(monkeypatch, tmp_path):
    paths = _write_datasets(tmp_path, n=2)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='needs CUDA'):
        train.main(['--ds3d', paths['ds3'], '--ds2d', paths['ds2'],
                    '--checkpoint-dir', str(tmp_path / 'ck')])


def test_checkpoint_manager_force_saves_off_the_interval(tmp_path):
    """The app's final save: `force` saves a step off the interval, never one
    that is not later than the newest."""
    from metrabs_tpu_torch.config import TrainConfig
    from metrabs_tpu_torch.io.checkpoints import CheckpointManager
    from metrabs_tpu_torch.train import loop, optim
    state = loop.create_train_state(torch.nn.Linear(2, 2), optim.Optimizer(TrainConfig()),
                                    device='cpu')
    manager = CheckpointManager(str(tmp_path), save_interval_steps=8)
    assert manager.save(8, state) and not manager.save(11, state)
    assert manager.save(11, state, force=True) and not manager.save(11, state, force=True)
    assert not manager.save(9, state, force=True)
    assert manager.all_steps() == [8, 11]
