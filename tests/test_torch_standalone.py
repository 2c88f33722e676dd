"""The port stands alone: `metrabs_tpu_torch` and `chip_smoke.py` import
nothing of jax, flax, optax, orbax, msgpack, ml_dtypes or the JAX package
`metrabs_tpu`, and no import statement of theirs names a package the card's
machine lacks (cv2, h5py, matplotlib, PIL, ml_dtypes, msgpack), at any
level, its
entry points run on the card unless the caller names another device, and
its copies of the JAX package's framework-free modules (config with the
training hyperparameters, joint info, TTA schedules, skeletons, bone
priors, the host data pipeline, the registry of released models, the TF
checkpoint reader and writer, the bone-length statistics, the RLE mask
codec and mask IoU, the evaluation's association and its numpy metrics)
agree with the originals. Also F1's regression test: a train-mode MBConv
never runs the fused chain.
"""

import ast
import dataclasses
import itertools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from metrabs_tpu import config as jax_config
from metrabs_tpu.data import pipeline as jax_data
from metrabs_tpu.models import registry as jax_registry
from metrabs_tpu.pipeline import bone_priors as jax_bone_priors
from metrabs_tpu.pipeline import skeletons as jax_skeletons
from metrabs_tpu.pipeline import tta as jax_tta
from metrabs_tpu_torch import config
from metrabs_tpu_torch.data import pipeline as data
from metrabs_tpu_torch.eval import harness, metrics
from metrabs_tpu_torch.io import packaging
from metrabs_tpu_torch.models import registry
from metrabs_tpu_torch.pipeline import bone_priors, skeletons, tta
from metrabs_tpu_torch.pipeline.estimator import PoseEstimator
from metrabs_tpu_torch.train import loop, optim

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ('metrabs_tpu', 'jax', 'jaxlib', 'flax', 'optax', 'orbax', 'msgpack', 'ml_dtypes')
# Packages the card's machine does not have (F4: cv2, F5: h5py).
MISSING_ON_CARD = ('cv2', 'h5py', 'matplotlib', 'PIL', 'ml_dtypes', 'msgpack')
PORT_FILES = sorted(str(p.relative_to(REPO)) for p in (REPO / 'metrabs_tpu_torch').rglob('*.py')
                    if '_build' not in p.parts) + ['chip_smoke.py']


def imported_modules(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize('path', PORT_FILES)
def test_port_file_imports_nothing_of_jax(path):
    """Every import statement, also those inside functions."""
    tree = ast.parse((REPO / path).read_text(), filename=path)
    bad = [m for m in imported_modules(tree) if m.split('.')[0] in FORBIDDEN]
    assert not bad, f'{path} imports {bad}'


@pytest.mark.parametrize('path', PORT_FILES)
def test_port_file_imports_no_cv2_at_module_level(path):
    """The import statements that run on import (not those inside functions)
    import none of MISSING_ON_CARD (cv2 first among them)."""
    tree = ast.parse((REPO / path).read_text(), filename=path)
    in_functions = {id(n) for fn in ast.walk(tree)
                    if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
                    for n in ast.walk(fn)}
    on_import = ast.Module(body=[n for n in ast.walk(tree) if id(n) not in in_functions
                                 and isinstance(n, (ast.Import, ast.ImportFrom))],
                           type_ignores=[])
    bad = {m.split('.')[0] for m in imported_modules(on_import)} & set(MISSING_ON_CARD)
    assert not bad, f'{path} imports {bad}'


@pytest.mark.parametrize('path', PORT_FILES)
def test_port_file_imports_no_cv2(path):
    """Every import statement, also those inside functions, imports none of
    MISSING_ON_CARD (F4: `pose_to_mask` imported cv2 when called; F5:
    `save_predictions_hdf5` imported h5py)."""
    tree = ast.parse((REPO / path).read_text(), filename=path)
    bad = {m.split('.')[0] for m in imported_modules(tree)} & set(MISSING_ON_CARD)
    assert not bad, f'{path} imports {bad}'


_STANDALONE_SCRIPT = """
import importlib, pkgutil, sys
for name in {missing!r}:
    sys.modules[name] = None  # any import of these fails, as on the card's machine
import numpy as np
import torch
import metrabs_tpu_torch
for mod in pkgutil.walk_packages(metrabs_tpu_torch.__path__, 'metrabs_tpu_torch.'):
    importlib.import_module(mod.name)
import chip_smoke
from metrabs_tpu_torch.io.packaging import pose_estimator_from_variables
from metrabs_tpu_torch import config
from metrabs_tpu_torch.config import ModelConfig
manifest = chip_smoke.manifest_for('float32')
manifest['model_config']['proc_side'] = 64
cfg = ModelConfig(**manifest['model_config'])
variables = chip_smoke.mint_crop_variables(cfg, torch.Generator().manual_seed(0))
est = pose_estimator_from_variables(variables, manifest, device='cpu')
frames = np.random.default_rng(0).integers(0, 256, (1, 120, 160, 3), dtype=np.uint8)
out = est.estimate_poses_batched(frames, [[[20, 10, 60, 100]]], num_aug=2)
assert tuple(out['poses3d'].shape) == (1, 1, 17, 3), out['poses3d'].shape
assert bool(out['poses3d'].isfinite().all())
stream = est.estimate_poses_stream(np.stack([frames, frames]), [[[[20, 10, 60, 100]]]] * 2,
                                   num_aug=2)
assert all(torch.equal(stream[k][1], out[k]) for k in out)
from metrabs_tpu_torch.io import tf_checkpoint, weights, weights_import
pairs = (weights_import.import_backbone_from_tf(None, variables, cfg.backbone)
         + weights_import.import_metrabs_head_from_tf(None, variables))
flat = {{'/'.join(k): v for k, v in weights.flatten_dict(variables).items()}}
tf_checkpoint.write_tf_checkpoint(sys.argv[1], {{n: (t or np.asarray)(flat[p]) for p, n, t in pairs}})
tf_vars = tf_checkpoint.load_tf_checkpoint(sys.argv[1])
imported = weights_import.import_metrabs_head_from_tf(
    tf_vars, weights_import.import_backbone_from_tf(tf_vars, variables, cfg.backbone))
assert all(np.array_equal(v, flat['/'.join(k)])
           for k, v in weights.flatten_dict(imported).items())
from metrabs_tpu_torch.models.backbones.tiny import TinyBackbone
from metrabs_tpu_torch.models.metrabs import Metrabs
from metrabs_tpu_torch.pipeline.skeletons import H36M_17, LSP_14
from metrabs_tpu_torch.train import loop, optim
tcfg = config.TrainConfig()
cfg = ModelConfig(proc_side=64, backbone='tiny', dtype='float32')
optimizer = optim.Optimizer(tcfg)
state = loop.create_train_state(Metrabs(cfg, TinyBackbone(width=8, use_bn=True)), optimizer,
                                device='cpu')
step = loop.make_train_step(state.model, optimizer, H36M_17, LSP_14, cfg, tcfg)
k = np.tile(np.float32([[60, 0, 32], [0, 60, 32], [0, 0, 1]]), (2, 1, 1))
g = np.random.default_rng(0)
b3 = dict(image=g.uniform(size=(2, 64, 64, 3)).astype(np.float32), intrinsics=k,
          coords3d_true=(g.normal(0, 300, (2, 17, 3)) + [0, 0, 3000]).astype(np.float32),
          joint_validity_mask=np.ones((2, 17), bool))
b2 = dict(image=g.uniform(size=(2, 64, 64, 3)).astype(np.float32), intrinsics=k,
          coords2d_true=g.uniform(0, 64, (2, 14, 2)).astype(np.float32),
          joint_validity_mask=np.ones((2, 14), bool))
losses = step(state, b3, b2, generator=torch.Generator().manual_seed(0))
assert state.step == 1 and bool(losses['loss'].isfinite())
from metrabs_tpu_torch.eval.metrics import compute_pose3d_metrics
from metrabs_tpu_torch.models.metro import Metro
optimizer = optim.Optimizer(tcfg)
metro = Metro(cfg, TinyBackbone(width=8, use_bn=True))
state = loop.create_train_state(metro, optimizer, device='cpu')
losses = loop.make_train_step_metro(metro, optimizer, H36M_17, LSP_14, cfg, tcfg)(state, b3, b2)
assert bool(losses['loss'].isfinite())
m = compute_pose3d_metrics(b3['coords3d_true'], b3['coords3d_true'], b3['joint_validity_mask'],
                           device='cpu')
assert float(m['mean_error_procrustes']) < 1e-3 and float(m['mean_pck']) == 1.0
from metrabs_tpu_torch.data import camera, cvfree, loading
from metrabs_tpu_torch.pipeline.skeletons import H36M_17
image = np.random.default_rng(1).integers(0, 256, (90, 120, 3), dtype=np.uint8)
cvfree.write_png(sys.argv[1] + '.png', image)
mask = np.zeros((90, 120), np.float32)
mask[20:80, 40:90] = 1
cam = camera.Camera(intrinsic_matrix=np.float32([[150, 0, 60], [0, 150, 45], [0, 0, 1]]),
                    distortion_coeffs=np.float32([-0.1, 0.01, 0, 0, 0]), world_up=(0, -1, 0))
pose = (np.random.default_rng(2).normal(size=(17, 3)) * 150 + [0, 0, 3000]).astype(np.float32)
ex = loading.Example3D(image_path=sys.argv[1] + '.png', camera=cam,
                       bbox=np.float32([30, 10, 60, 75]), world_coords=pose, mask=mask)
out = loading.load_and_transform3d(ex, H36M_17, True, np.random.default_rng(0),
                                   config.ModelConfig(proc_side=64),
                                   loading.LoadConfig(background_aug_prob=1.0))
assert out['image'].shape == (64, 64, 3) and bool(np.isfinite(out['image']).all())
from metrabs_tpu_torch.eval.association import associate_predictions_to_masks, pose_to_mask
poses2d = np.random.default_rng(3).uniform(10, 110, (2, 17, 2))
masks = [pose_to_mask(p, (120, 120), H36M_17, 8) for p in poses2d]
matched = associate_predictions_to_masks(pose[None].repeat(2, 0) + [[[0, 0, 0]], [[1, 0, 0]]],
                                         poses2d[::-1], (120, 120), masks, H36M_17)
assert matched.shape == (2, 17, 3) and matched[0, 0, 0] == pose[0, 0] + 1
import hashlib, json
from metrabs_tpu_torch.data.improc import imread
fixtures = 'tests/torch_fixtures/jpeg'
manifest = json.load(open(fixtures + '/manifest.json'))
for name in ('progressive_s420_61x75.jpg', 'exif_orientation6_40x64.jpg', 'gray_48x80.jpg'):
    im = imread(fixtures + '/' + name)
    assert hashlib.sha256(im.tobytes()).hexdigest() == manifest[name]['sha256_rgb'], name
from metrabs_tpu_torch.eval import harness
try:
    harness.save_predictions(sys.argv[1] + '.h5', dict(x=np.zeros(2)))
    raise AssertionError('an HDF5 dump was written')
except NotImplementedError:
    pass
leaked = sorted(m for m, mod in sys.modules.items()
                if mod is not None and m.split('.')[0] in {forbidden!r})
assert not leaked, leaked
print('STANDALONE_OK')
"""


def test_port_and_chip_smoke_run_without_jax_loaded(tmp_path):
    """Every module of the port and chip_smoke's helpers, then a small CPU
    `estimate_poses_batched` and `estimate_poses_stream` on weights minted
    with torch alone, those weights through a TF checkpoint and back, one
    CPU train step of Metrabs and one of Metro, the eval metrics, an example
    loaded from a PNG with every augmentation (`load_and_transform3d`), the
    mask association, JPEG fixtures decoded to their manifest hashes and the
    HDF5 dump refused, in a process that never loads jax, flax, optax,
    msgpack, ml_dtypes or `metrabs_tpu` and where none of MISSING_ON_CARD
    can be imported."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    script = _STANDALONE_SCRIPT.format(forbidden=set(FORBIDDEN), missing=MISSING_ON_CARD)
    proc = subprocess.run([sys.executable, '-c', script, str(tmp_path / 'ckpt')], cwd=REPO,
                          env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert 'STANDALONE_OK' in proc.stdout


@pytest.fixture
def no_cuda(monkeypatch):
    """A machine without CUDA, wherever the test runs."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)


@pytest.mark.parametrize('entry', ['PoseEstimator', 'pose_estimator_from_variables',
                                   'crop_model_from_variables', 'detector_from_variables',
                                   'load_crop_model', 'load_pose_estimator',
                                   'create_train_state', 'device_prefetch',
                                   'model25d_from_variables', 'metro_from_variables',
                                   'yolov8_from_variables', 'estimate_poses_stream',
                                   'detect_poses_stream', 'detect_poses_pipelined',
                                   'compute_pose3d_metrics', 'evaluate_predictions',
                                   'predict_dataset'])
def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda, tmp_path, entry):
    families = dict(model_config={}, model_class='model25d', detector_type='yolov8m')
    default_estimator = lambda: PoseEstimator(torch.nn.Identity(), skeletons.H36M_17,
                                              config.ModelConfig())
    frames = np.zeros((1, 1, 64, 64, 3), np.uint8)
    poses = np.zeros((2, 17, 3), np.float32)
    calls = dict(
        compute_pose3d_metrics=lambda: metrics.compute_pose3d_metrics(
            poses, poses, np.ones((2, 17), bool)),
        predict_dataset=lambda: harness.predict_dataset(
            lambda c, k, v: None, [None], skeletons.H36M_17, config.ModelConfig()),
        evaluate_predictions=lambda: harness.evaluate_predictions(dict(
            poses3d_pred_cam=poses, poses3d_true_cam=poses,
            joint_validity_mask=np.ones((2, 17), bool))),
        estimate_poses_stream=lambda: default_estimator().estimate_poses_stream(
            frames, np.zeros((1, 1, 1, 4))),
        detect_poses_stream=lambda: default_estimator().detect_poses_stream(frames),
        detect_poses_pipelined=lambda: list(default_estimator().detect_poses_pipelined(
            frames)),
        model25d_from_variables=lambda: packaging.pose_estimator_from_variables({}, families),
        metro_from_variables=lambda: packaging.crop_model_from_variables(
            {}, dict(families, model_class='metro')),
        yolov8_from_variables=lambda: packaging.detector_from_variables(
            {}, families, bn_fold=False),
        create_train_state=lambda: loop.create_train_state(
            torch.nn.Linear(2, 2), optim.Optimizer(config.TrainConfig())),
        device_prefetch=lambda: data.device_prefetch([{'x': np.zeros(2)}]),
        PoseEstimator=lambda: PoseEstimator(torch.nn.Identity(), skeletons.H36M_17,
                                            config.ModelConfig()),
        pose_estimator_from_variables=lambda: packaging.pose_estimator_from_variables({}, {}),
        crop_model_from_variables=lambda: packaging.crop_model_from_variables({}, {}),
        detector_from_variables=lambda: packaging.detector_from_variables(
            {}, {}, bn_fold=False),
        load_crop_model=lambda: packaging.load_crop_model(str(tmp_path)),
        load_pose_estimator=lambda: packaging.load_pose_estimator(str(tmp_path)))
    with pytest.raises(RuntimeError, match="needs CUDA.*device='cpu'"):
        calls[entry]()


def test_estimator_runs_on_the_cpu_when_asked(no_cuda):
    est = PoseEstimator(torch.nn.Identity(), skeletons.H36M_17, config.ModelConfig(),
                        bone_mean_lengths=np.ones(16, np.float32), device='cpu')
    assert est.device == torch.device('cpu') and est._mean_bones.device.type == 'cpu'


def test_tf_checkpoint_copy_writes_the_originals_bytes(tmp_path):
    """The same tensors through the port's copy of the TensorBundle writer
    and the original: the same files, read back alike by both readers."""
    from metrabs_tpu.io import tf_checkpoint as jax_tf_checkpoint
    from metrabs_tpu_torch.io import tf_checkpoint
    rng = np.random.default_rng(0)
    tensors = {'b/kernel': rng.normal(size=(3, 3, 2, 4)).astype(np.float32),
               'b/step': np.array(7, np.int64), 'b/flags': np.array([True, False]),
               'a/h': rng.normal(size=(3,)).astype(np.float16)}
    out = {}
    for name, module in (('port', tf_checkpoint), ('jax', jax_tf_checkpoint)):
        module.write_tf_checkpoint(str(tmp_path / name / 'ckpt'), tensors)
        out[name] = [(tmp_path / name / f).read_bytes()
                     for f in ('ckpt.index', 'ckpt.data-00000-of-00001')]
    assert out['port'] == out['jax']
    for module in (tf_checkpoint, jax_tf_checkpoint):
        loaded = module.load_tf_checkpoint(str(tmp_path / 'port' / 'ckpt'))
        assert sorted(loaded) == sorted(tensors)
        for k, v in tensors.items():
            np.testing.assert_array_equal(loaded[k], v)


def test_registry_copy_matches_jax():
    """The 14 released configurations: names, backbones, sizes, detectors,
    augmentation flags and the configs they make."""
    assert list(registry.NAMED_MODELS) == list(jax_registry.NAMED_MODELS)
    for name, ours in registry.NAMED_MODELS.items():
        theirs = jax_registry.get_named_model(name)
        assert dataclasses.astuple(ours) == dataclasses.astuple(theirs)
        assert (dataclasses.asdict(ours.model_config(depth=4))
                == dataclasses.asdict(theirs.model_config(depth=4)))
        assert dataclasses.asdict(ours.aug_config()) == dataclasses.asdict(theirs.aug_config())
    with pytest.raises(KeyError, match='Unknown model'):
        registry.get_named_model('metrabs_vit_y4')


@pytest.mark.parametrize('name', ['ModelConfig', 'AugConfig', 'TrainConfig'])
def test_config_fields_and_defaults_match_jax(name):
    ours, theirs = getattr(config, name), getattr(jax_config, name)
    as_pairs = lambda cls: [(f.name, f.default) for f in dataclasses.fields(cls)]
    assert as_pairs(ours) == as_pairs(theirs)
    assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs())


@pytest.mark.parametrize('aug', [{}, dict(rot_aug_360=True), dict(rot_aug_360_half=True),
                                 dict(rot_aug_degrees=10.0)],
                         ids=['default', '360', '360_half', 'deg10'])
@pytest.mark.parametrize('num_aug', [1, 2, 3, 4, 5])
def test_tta_params_match_jax(num_aug, aug):
    ours = tta.make_tta_params(num_aug, config.AugConfig(**aug))
    theirs = jax_tta.make_tta_params(num_aug, jax_config.AugConfig(**aug))
    for field in dataclasses.fields(theirs):
        want = getattr(theirs, field.name)
        got = getattr(ours, field.name)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=field.name)


@pytest.mark.parametrize('name', sorted(jax_skeletons.BUILTIN_SKELETONS))
def test_builtin_skeleton_matches_jax(name):
    """Names, edges, mirror mapping and joint-to-bone matrix of the built-in
    skeleton, its indices through a registry of H36M-17 joints (where it
    resolves there), and its bone priors."""
    ours, theirs = skeletons.BUILTIN_SKELETONS[name], jax_skeletons.BUILTIN_SKELETONS[name]
    assert (ours.names, ours.edges) == (theirs.names, theirs.edges)
    np.testing.assert_array_equal(ours.mirror_mapping, theirs.mirror_mapping)
    np.testing.assert_array_equal(ours.joint2bone_matrix(), theirs.joint2bone_matrix())
    reg = skeletons.SkeletonRegistry(skeletons.H36M_17)
    jax_reg = jax_skeletons.SkeletonRegistry(jax_skeletons.H36M_17)
    assert reg.skeleton_names == jax_reg.skeleton_names
    if name in jax_reg.skeleton_names:
        np.testing.assert_array_equal(reg.indices(name), jax_reg.indices(name))
        assert reg.joint_names(name) == jax_reg.joint_names(name)
        assert reg.joint_edges(name) == jax_reg.joint_edges(name)
    np.testing.assert_array_equal(bone_priors.priors_for_joint_info(ours),
                                  jax_bone_priors.priors_for_joint_info(theirs))


def test_bone_priors_asset_is_a_copy_of_jax():
    assert Path(bone_priors.ASSET_PATH).read_bytes() == Path(
        jax_bone_priors.ASSET_PATH).read_bytes()
    np.testing.assert_array_equal(bone_priors.priors_for_joint_info(skeletons.H36M_17),
                                  jax_bone_priors.priors_for_joint_info(jax_skeletons.H36M_17))
    unknown = skeletons.make_joint_info(['a', 'b'], [('a', 'b')])
    assert bone_priors.priors_for_joint_info(unknown) is None


def test_data_pipeline_copies_match_jax():
    assert data.ROUNDROBIN_SECTIONS == jax_data.ROUNDROBIN_SECTIONS
    for n in (1, 2, 3, 6):
        assert data.huge2d_sections(n) == jax_data.huge2d_sections(n)
    lists = [list(range(5)), list(range(100, 103)), list(range(200, 207))]
    take = lambda mod: list(itertools.islice(
        mod.roundrobin_iterate(lists, [2, 1, 3], np.random.default_rng(4)), 60))
    assert take(data) == take(jax_data)
    with pytest.raises(ValueError, match='empty'):
        next(data.roundrobin_iterate([[], [1]], [1, 1], np.random.default_rng(0)))

    class Example:
        def __init__(self, path):
            self.image_path = path
    examples = [Example(p) for p in ('/d/H36M_x/1.jpg', '/d/coco_down/2.jpg', '/d/h36m_/3.jpg')]
    prefixes = ['h36m_', 'coco_down']
    assert ([[e.image_path for e in sec] for sec in data.build_dataset_sections(
        examples, prefixes)] == [[e.image_path for e in sec] for sec in
                                 jax_data.build_dataset_sections(examples, prefixes)])
    with pytest.raises(RuntimeError, match='No section'):
        data.build_dataset_sections([Example('/d/mpii/1.jpg')], prefixes)


@pytest.mark.parametrize('use_processes', [False, True], ids=['threads', 'processes'])
def test_parallel_batch_loader_matches_jax(use_processes):
    def batches(mod):
        loader = mod.ParallelBatchLoader(_load_example, iter(range(10)), 4, n_workers=2,
                                         seed=7, use_processes=use_processes)
        try:
            return list(loader)
        finally:
            loader.close()
    ours, theirs = batches(data), batches(jax_data)
    assert [b['x'].shape for b in ours] == [(4, 3), (4, 3), (2, 3)]
    for a, b in zip(ours, theirs, strict=True):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def _load_example(example, rng):
    return dict(x=rng.uniform(size=3) + example, i=np.int64(example))


def test_device_prefetch_on_the_cpu_keeps_order_and_values():
    batches = [dict(x=np.full((2, 3), i, np.float32)) for i in range(5)]
    out = list(data.device_prefetch(iter(batches), device='cpu'))
    assert [int(b['x'][0, 0]) for b in out] == list(range(5))
    assert all(isinstance(b['x'], torch.Tensor) for b in out)


def test_f1_train_mode_mbconv_takes_the_unfused_chain(monkeypatch):
    """F1: `MBConv` took the fused chain (no backward, folded running
    statistics) in train mode too. In train mode it must take the unfused
    chain, so that `expand_conv`, `norm0`, `depthwise_conv` and `norm1` learn."""
    from metrabs_tpu_torch.models.backbones import efficientnet_v2 as effnet
    from metrabs_tpu_torch.ops import mbconv_cuda
    a = effnet.decode_block_string('r1_k3_s1_din1_dout1_e4_i8_o8_se0.25')
    block = effnet.MBConv(a, a, effnet._BnOptions(False, 1, False), fuse='on')
    assert block.fusable
    monkeypatch.setattr(mbconv_cuda, 'fused_mbconv_inner', lambda *args: pytest.fail(
        'the fused MBConv chain ran in train mode'))
    x = torch.randn(4, 8, 6, 6, generator=torch.Generator().manual_seed(0))
    block.train()(x).square().sum().backward()
    for name, p in block.named_parameters():
        assert p.grad is not None and p.grad.abs().max() > 0, name


def _copies_rlemask(rng):
    from metrabs_tpu.utils import rlemask as theirs
    from metrabs_tpu_torch.utils import rlemask as ours
    for shape in ((13, 7), (1, 40), (0, 3)):
        mask = (rng.uniform(size=shape) > 0.6).astype(np.uint8)
        rle = ours.encode(mask)
        assert rle == theirs.encode(mask)
        np.testing.assert_array_equal(ours.decode(rle), theirs.decode(rle))
        assert ours.area(rle) == theirs.area(rle) == int(mask.sum())
        counts = ours._decode_counts(rle['counts'])
        assert counts == theirs._decode_counts(rle['counts'])
        assert ours._encode_counts(counts) == theirs._encode_counts(counts)


def _copies_mask_iou(rng):
    from metrabs_tpu.data.masks import mask_iou as theirs
    from metrabs_tpu_torch.data.masks import mask_iou as ours
    a, b = rng.uniform(size=(2, 9, 11)) > 0.5
    for m1, m2 in ((a, b), (a, a), (np.zeros((3, 3)), np.zeros((3, 3)))):
        assert ours(m1, m2) == theirs(m1, m2)


def _copies_bone_length_stats(rng):
    from metrabs_tpu.pipeline.plausibility import BoneLengthStats as Theirs
    from metrabs_tpu_torch.pipeline.plausibility import BoneLengthStats as Ours
    ours, theirs = Ours(skeletons.H36M_17.edges), Theirs(skeletons.H36M_17.edges)
    for _ in range(2):
        coords, valid = rng.normal(0, 300, (5, 17, 3)), rng.random((5, 17)) < 0.7
        ours.update(coords, valid)
        theirs.update(coords, valid)
    np.testing.assert_array_equal(ours.mean_lengths(), theirs.mean_lengths())
    assert ours.n_samples == theirs.n_samples


def _copies_association(rng):
    from metrabs_tpu.eval import association as theirs
    from metrabs_tpu.pipeline import skeletons as jax_skeletons
    from metrabs_tpu_torch.eval import association as ours
    assert ours.ASSOC_JOINTS == theirs.ASSOC_JOINTS
    pred = rng.normal(size=(2, 17, 2)) * 30 + [[[100, 100]], [[400, 300]]]
    true = np.concatenate([rng.normal(size=(2, 19, 2)) * 30 + [[[400, 300]], [[100, 100]]],
                           rng.uniform(0, 1, (2, 19, 1))], -1)
    poses3d, prev = rng.normal(size=(2, 17, 3)), np.zeros((2, 17, 2))
    got = ours.associate_predictions(poses3d, pred, true, prev, skeletons.H36M_17,
                                     skeletons.COCO_19)
    want = theirs.associate_predictions(poses3d, pred, true, prev, jax_skeletons.H36M_17,
                                        jax_skeletons.COCO_19)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _copies_harness(rng):
    from metrabs_tpu.eval import harness as theirs
    from metrabs_tpu_torch.eval import harness as ours
    assert ours.JOINT_SUBSETS == theirs.JOINT_SUBSETS
    assert ({k: dataclasses.astuple(v) for k, v in ours.BENCHMARK_PROTOCOLS.items()}
            == {k: dataclasses.astuple(v) for k, v in theirs.BENCHMARK_PROTOCOLS.items()})
    gts = [rng.normal(0, 300, (k, 17, 3)) for k in (2, 1, 0)]
    preds = [g + rng.normal(0, 80, g.shape) for g in gts]
    for kwargs in ({}, dict(root_index=0, eval_joints=[1, 4, 7])):
        assert (ours.matched_pose_metrics(preds, gts, **kwargs)
                == theirs.matched_pose_metrics(preds, gts, **kwargs))


@pytest.mark.parametrize('check', [_copies_rlemask, _copies_mask_iou, _copies_bone_length_stats,
                                   _copies_association, _copies_harness],
                         ids=['rlemask', 'mask_iou', 'bone_length_stats', 'association', 'harness'])
def test_numpy_copies_match_jax(check):
    """The port's copies of the JAX package's numpy code give the originals'
    results on the same random inputs."""
    check(np.random.default_rng(0))
