"""The torch train-to-serve run (`scripts/train_to_serve_e2e_torch.py`), the
verify drive (`scripts/verify_e2e_torch.py`) and the bone-prior generator
(`scripts/gen_bone_priors_torch.py`) against the JAX package's scripts and
assets on the CPU.

- Stage 0: the torch script's scenes equal the JAX script's
  (`scripts/train_to_serve_e2e.py`, drawn with cv2) bit for bit, and its
  poses, boxes and 2D coordinates exactly.
- The training feed (both streams, flipped or not) equals JAX's on the scenes.
- The quality gates (smoke and full), the training app's argument list and
  the record's keys are the JAX script's, read from its source.
- A smoke of the whole torch script on the CPU runs every stage, and the
  served-gap ablation (`scripts/ablate_crop_served_gap_torch.py`) runs on
  its package; the verify drive runs to VERIFY OK on the CPU.
- `accumulate_builtin_priors` equals JAX's, and the generator rewrites the
  port's asset byte for byte.
"""

from __future__ import annotations

import ast
import importlib.util
import itertools
import json
import types
from pathlib import Path

import cv2
import numpy as np
import pytest

from metrabs_tpu.pipeline import bone_priors as jax_bone_priors
from metrabs_tpu_torch.data import cvfree, loading
from metrabs_tpu_torch.eval import harness
from metrabs_tpu_torch.pipeline import bone_priors
from tests._torch_train import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
JAX_SCRIPT = REPO / 'scripts' / 'train_to_serve_e2e.py'


def load_script(name: str):
    spec = importlib.util.spec_from_file_location(name, REPO / 'scripts' / f'{name}.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


t2s = load_script('train_to_serve_e2e_torch')
t2s_jax = load_script('train_to_serve_e2e')


def jax_main_node() -> ast.FunctionDef:
    tree = ast.parse(JAX_SCRIPT.read_text())
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == 'main')


def jax_assignments(target: str):
    """The value nodes of every `target = ...` in the JAX script's main, in
    source order."""
    return [n.value for n in ast.walk(jax_main_node())
            if isinstance(n, ast.Assign) and len(n.targets) == 1
            and isinstance(n.targets[0], ast.Name) and n.targets[0].id == target]


def evaluate(node: ast.expr, namespace: dict):
    return eval(compile(ast.Expression(node), str(JAX_SCRIPT), 'eval'), dict(namespace))


@pytest.mark.parametrize('seed,n_scenes', [(7, 6), (1007, 4), (3, 5)])
def test_build_split_equals_jax(seed, n_scenes):
    """Images bit for bit; poses, boxes and 2D coordinates exactly; the
    examples are the port's classes with the JAX script's fields."""
    scenes, ex3d, ex2d, cam = t2s.build_split(seed, n_scenes)
    jscenes, jex3d, jex2d, jcam = t2s_jax.build_split(seed, n_scenes)
    assert len(scenes) == n_scenes and sum(len(p) for _, p in scenes) == len(jex3d)
    for (img, poses), (jimg, jposes) in zip(scenes, jscenes):
        assert img.dtype == jimg.dtype == np.uint8
        np.testing.assert_array_equal(img, jimg)
        assert len(poses) == len(jposes)
        for p, jp in zip(poses, jposes):
            np.testing.assert_array_equal(p, jp)
    assert len(ex3d) == len(jex3d) and len(ex2d) == len(jex2d)
    for e, j in zip(ex3d, jex3d):
        assert isinstance(e, loading.Example3D) and e.image_path == j.image_path
        np.testing.assert_array_equal(e.bbox, j.bbox)
        np.testing.assert_array_equal(e.world_coords, j.world_coords)
        np.testing.assert_array_equal(e.image, j.image)
    for e, j in zip(ex2d, jex2d):
        assert isinstance(e, loading.Example2D) and e.image_path == j.image_path
        np.testing.assert_array_equal(e.bbox, j.bbox)
        np.testing.assert_array_equal(e.coords, j.coords)
        assert e.coords.dtype == j.coords.dtype == np.float32
    np.testing.assert_array_equal(cam.intrinsic_matrix, jcam.intrinsic_matrix)
    np.testing.assert_array_equal(cam.world_up, jcam.world_up)
    for margin in (2, 18):
        np.testing.assert_array_equal(t2s.person_bbox(cam, scenes[0][1][0], margin),
                                      t2s_jax.person_bbox(jcam, jscenes[0][1][0], margin))


def test_training_feed_equals_jax_on_the_scenes():
    """Both streams' examples of the scenes through the app's loaders at the
    run's settings (256 px, appearance augmentations off) equal JAX's bit for
    bit, the crops of flipped and unflipped draws alike."""
    from metrabs_tpu.config import ModelConfig as JaxModelConfig
    from metrabs_tpu.data import loading as jax_loading
    from metrabs_tpu.pipeline import skeletons as jax_skeletons
    from metrabs_tpu_torch.config import ModelConfig
    from metrabs_tpu_torch.pipeline import skeletons

    _, ex3d, ex2d, _ = t2s.build_split(7, 2)
    _, jex3d, jex2d, _ = t2s_jax.build_split(7, 2)
    off = dict(occlude_aug_prob=0, occlude_aug_prob_2d=0, background_aug_prob=0, color_aug=False)
    flipped = set()
    for seed in range(8):
        i = seed % len(ex3d)
        for fn, ours, theirs, joints in (('load_and_transform3d', ex3d, jex3d, 'H36M_17'),
                                         ('load_and_transform2d', ex2d, jex2d, 'LSP_14')):
            got = getattr(loading, fn)(ours[i], getattr(skeletons, joints), True,
                                       np.random.default_rng(seed), ModelConfig(proc_side=256),
                                       loading.LoadConfig(**off))
            want = getattr(jax_loading, fn)(theirs[i], getattr(jax_skeletons, joints), True,
                                            np.random.default_rng(seed),
                                            JaxModelConfig(proc_side=256),
                                            jax_loading.LoadConfig(**off))
            assert got.keys() == want.keys()
            for key in want:
                np.testing.assert_array_equal(got[key], want[key], err_msg=f'{fn} {key}')
            if 'rot_to_world' in got:
                flipped.add(bool(np.linalg.det(got['rot_to_world']) < 0))
    assert flipped == {False, True}


def test_app_feed_equals_jax_over_batches():
    """The training app's feed as both apps build it from the run's argument
    list (round-robin order from `--seed`, loaders seeded `--seed` and
    `--seed` + 1, `--workers` threads, the load config of the flags) gives
    JAX's batches bit for bit, batch after batch, on shared scene images,
    which no load changes."""
    from metrabs_tpu.apps import train as jax_train
    from metrabs_tpu.config import ModelConfig as JaxModelConfig
    from metrabs_tpu.data import loading as jax_loading
    from metrabs_tpu.data import pipeline as jax_pipeline
    from metrabs_tpu.pipeline import skeletons as jax_skeletons
    from metrabs_tpu_torch.apps import train
    from metrabs_tpu_torch.config import ModelConfig
    from metrabs_tpu_torch.data import pipeline
    from metrabs_tpu_torch.pipeline import skeletons

    run = t2s.parse_args(['--device', 'cpu'])
    run.absloss_start_step = run.steps // 5
    argv = t2s.crop_train_args(run, 'a', 'b', 'v', 'c', 'p')
    argv = argv[:argv.index('--device')]
    args = train.parse_args(argv)
    assert vars(args) | {'device': None} == vars(jax_train.parse_args(argv)) | {
        'device': None, 'tp_min_size': args.tp_min_size}

    def feed(app, pipe, load, joints, config, ex3d, ex2d):
        rng = np.random.default_rng(args.seed)
        it3d = pipe.roundrobin_iterate([ex3d], [args.batch_size], rng)
        it2d = pipe.roundrobin_iterate([ex2d], [args.batch_size_2d], rng)
        cfg, lcfg = config(proc_side=args.proc_side), app.build_load_config(args)
        return (pipe.ParallelBatchLoader(
                    lambda ex, r: load.load_and_transform3d(ex, joints.H36M_17, True, r, cfg, lcfg),
                    it3d, batch_size=args.batch_size, n_workers=args.workers, seed=args.seed),
                pipe.ParallelBatchLoader(
                    lambda ex, r: load.load_and_transform2d(ex, joints.LSP_14, True, r, cfg, lcfg),
                    it2d, batch_size=args.batch_size_2d, n_workers=args.workers,
                    seed=args.seed + 1))

    _, ex3d, ex2d, _ = t2s.build_split(7, 4)
    _, jex3d, jex2d, _ = t2s_jax.build_split(7, 4)
    images = [ex.image.copy() for ex in ex3d]
    ours = feed(train, pipeline, loading, skeletons, ModelConfig, ex3d, ex2d)
    theirs = feed(jax_train, jax_pipeline, jax_loading, jax_skeletons, JaxModelConfig, jex3d,
                  jex2d)
    try:
        for _ in range(6):
            for got, want in zip(map(next, ours), map(next, theirs)):
                assert got.keys() == want.keys()
                for key in want:
                    np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    finally:
        for loader in ours + theirs:
            loader.close()
    assert all(np.array_equal(a, ex.image) for a, ex in zip(images, ex3d))


def test_scene_constants_equal_jax():
    assert t2s.TEMPLATE == t2s_jax.TEMPLATE
    assert t2s.LSP_FROM_H36M == t2s_jax.LSP_FROM_H36M
    assert (t2s.SCENE_SIDE, t2s.Z_RANGE) == (t2s_jax.SCENE_SIDE, t2s_jax.Z_RANGE)


@pytest.mark.parametrize('smoke', [False, True], ids=['full', 'smoke'])
def test_quality_gates_equal_jax(smoke):
    """The JAX script's two `gate = dict(...)` assignments: the full bar,
    then the smoke run's."""
    full, relaxed = (evaluate(node, {}) for node in jax_assignments('gate'))
    assert t2s.quality_gates(smoke) == (relaxed if smoke else full)


@pytest.mark.parametrize('backbone', ['efficientnetv2-s', 'tiny'])
@pytest.mark.parametrize('steps', [6000, 200, 7])
def test_crop_train_args_equal_jax(backbone, steps):
    """`apps.train.main`'s arguments are the JAX script's list (with its
    CPU substitution for the tiny backbone), plus the device."""
    args = t2s.parse_args(['--steps', str(steps), '--backbone', backbone, '--device', 'cpu'])
    args.absloss_start_step = args.steps // 5
    paths = dict(ds3d_path='a.pkl', ds2d_path='b.pkl', val_path='v.pkl', ckpt_dir='ck',
                 package_dir='pk')
    namespace = dict(args=types.SimpleNamespace(**vars(args)), **paths)
    (lst,) = jax_assignments('crop_args')
    want = evaluate(lst, namespace)
    if backbone == 'tiny':
        want[want.index('tiny')] = 'mobilenetv3-small'
        want += ['--proc-side', '128', '--dtype', 'float32']
    got = t2s.crop_train_args(args, *paths.values())
    device_at = got.index('--device')
    assert got[device_at:device_at + 2] == ['--device', 'cpu']
    assert got[:device_at] + got[device_at + 2:] == want


def test_box_recall_counts_hits_at_iou_half():
    gt = [[np.float32([10, 10, 40, 80]), np.float32([200, 50, 40, 80])], []]
    boxes5 = np.zeros((2, 3, 5), np.float32)
    boxes5[0, 0, :4] = (12, 10, 40, 80)    # IoU 0.905: a hit
    boxes5[0, 1, :4] = (230, 50, 40, 80)   # IoU 0.143: a miss
    boxes5[1, 0, :4] = (0, 0, 50, 50)      # no ground truth there
    valid = np.array([[True, True, False], [True, False, False]])
    recall, mean_iou = harness.box_recall(boxes5, valid, gt)
    assert recall == 0.5
    np.testing.assert_allclose(mean_iou, 38 * 80 / (42 * 80), rtol=1e-6)
    assert harness.box_recall(boxes5, np.zeros_like(valid), gt) == (0.0, 0.0)


@pytest.fixture(scope='module')
def smoke_run(tmp_path_factory):
    """The whole script at a smoke size on the CPU, on one intra-op thread:
    (its record, its standard output, its output directory)."""
    import contextlib
    import io

    import torch
    out_dir = tmp_path_factory.mktemp('t2s')
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    stdout = io.StringIO()
    try:
        with contextlib.redirect_stdout(stdout):
            record = t2s.main(['--device', 'cpu', '--backbone', 'tiny', '--steps', '4',
                               '--det-steps', '2', '--scenes', '3', '--val-scenes', '2',
                               '--smoke', '--batch-size', '2', '--det-batch', '2',
                               '--out', str(out_dir / 'out'),
                               '--record', str(out_dir / 'record.json')])
    finally:
        torch.set_num_threads(n_threads)
    return record, stdout.getvalue(), out_dir


def test_record_keys_include_jax(smoke_run):
    """Every stage runs; the record holds the JAX script's keys (read from
    its `record = dict(...)`) plus the port's, is written and printed as the
    line before TRAIN2SERVE OK, and the pickles hold the port's classes."""
    record, stdout, out_dir = smoke_run
    (node,) = jax_assignments('record')
    jax_keys = {k.arg for k in node.keywords}
    assert jax_keys <= set(record)
    assert set(record) - jax_keys == {'device', 'steps_per_s', 'crop_step_median_s',
                                      'det_step_median_s', 'peak_memory_gib'}
    assert record['device'] == 'cpu' and record['smoke'] is True
    assert [s for s, _ in record['val_mpjpe_curve']] == [1, 2, 3, 4]
    assert np.isfinite(record['mpjpe_served_gt_boxes'])
    assert set(record['detect_poses_matched']) == {'matched_pck', 'matched_apck', 'recall'}
    assert json.loads((out_dir / 'record.json').read_text())['n_val_people'] \
        == record['n_val_people']
    lines = stdout.strip().splitlines()
    assert lines[-1] == 'TRAIN2SERVE OK'
    assert json.loads(lines[-2])['n_train_people'] == record['n_train_people']
    examples = loading.load_examples(str(out_dir / 'out' / 'ds3d.pkl'))
    assert len(examples) == record['n_train_people']
    assert all(type(e) is loading.Example3D for e in examples)
    manifest = json.loads((out_dir / 'out' / 'package' / 'manifest.json').read_text())
    assert manifest['has_detector'] and manifest['detector_type'] == 'yolov4-tiny'
    assert len(manifest['bone_mean_lengths']) == 16


def test_ablation_on_the_smoke_package(smoke_run, tmp_path, one_torch_thread):  # noqa: F811
    """`scripts/ablate_crop_served_gap_torch.py` on the smoke run's package:
    every entry of JAX's ablation record plus the detect entries, the
    single-aug terms of num_aug 2 and aug 0's terms in pairs and threes, each
    a different serve, finite; the neutral serve's root-relative
    error equal to the crop protocol's within 1 mm (the same crops but for
    the warp)."""
    _, _, out_dir = smoke_run
    record = load_script('ablate_crop_served_gap_torch').main(
        ['--device', 'cpu', '--package', str(out_dir / 'out' / 'package'), '--val-scenes', '2',
         '--record', str(tmp_path / 'gap.json')])
    served = ('served_neutral', 'served_gamma', 'served_scale')
    assert set(record) == {'val', 'near', 'far', 'wall_s'}
    assert set(record['val']) == {'crop_eval', *served, *(
        f'{kind}_aug{n}' for kind in ('served', 'detect') for n in (1, 2, 5)),
        'served_aug2_0', 'served_aug2_1', 'served_flip', 'served_gamma06', 'served_rot_neg',
        'served_scale08', 'served_rot_pos', *(
            'served_' + '+'.join(c) for n in (2, 3)
            for c in itertools.combinations(('flip', 'gamma06', 'rot_neg', 'scale08'), n))}
    # Each single-aug entry served its own aug: no two of them agree.
    singles = [v['mpjpe_abs'] for k, v in record['val'].items()
               if k.startswith('served_') and k[7:10] not in ('aug',)]
    assert len(set(singles)) == len(singles)
    assert all(set(record[split]) == {'crop_eval', *served} for split in ('near', 'far'))
    for split in ('val', 'near', 'far'):
        for entry in record[split].values():
            assert all(np.isfinite(v) for v in entry.values())
        np.testing.assert_allclose(record[split]['served_neutral']['mpjpe'],
                                   record[split]['crop_eval']['mpjpe'], atol=1.0)
    assert json.loads((tmp_path / 'gap.json').read_text())['val'] == record['val']


@pytest.mark.parametrize('num_aug', [2, 5])
def test_single_aug_params_equal_the_schedules_augs(num_aug):
    """Each aug of a stock TTA schedule, made alone from its terms, is that
    aug (the ablation's single-aug variants are the schedule's parts)."""
    from metrabs_tpu_torch.pipeline import tta
    ablation = load_script('ablate_crop_served_gap_torch')
    stock = tta.make_tta_params(num_aug)
    for i in range(num_aug):
        one = ablation.single_aug_params(
            gamma=float(stock.gammas[i]), scale=float(stock.scales[i]),
            angle=float(stock.angles[i]), flip=bool(stock.should_flip[i]))
        for field in ('gammas', 'angles', 'scales', 'should_flip'):
            np.testing.assert_array_equal(getattr(one, field), getattr(stock, field)[i:i + 1])
        np.testing.assert_allclose(one.rotflip_mats, stock.rotflip_mats[i:i + 1], atol=1e-7)
        assert one.rotflip_mats.dtype == np.float32


def test_script_raises_without_cuda_by_default(monkeypatch, tmp_path):
    import torch
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="needs CUDA.*device='cpu'"):
        t2s.main(['--out', str(tmp_path), '--record', str(tmp_path / 'r.json')])
    verify = load_script('verify_e2e_torch')
    with pytest.raises(RuntimeError, match="needs CUDA.*device='cpu'"):
        verify.main([])


def test_verify_e2e_torch_on_the_cpu(one_torch_thread, capsys):  # noqa: F811
    """The verify drive's asserts on the CPU, to VERIFY OK."""
    load_script('verify_e2e_torch').main(['--device', 'cpu'])
    out = capsys.readouterr().out
    assert out.strip().splitlines()[-1] == 'VERIFY OK'
    assert 'image (1920, 1080, 3)' in out


def test_accumulate_builtin_priors_equals_jax():
    assert bone_priors.BASE_TEMPLATE_MM == jax_bone_priors.BASE_TEMPLATE_MM
    assert bone_priors.SKELETON_OVERRIDES_MM == jax_bone_priors.SKELETON_OVERRIDES_MM
    for n, seed in ((512, 0), (64, 3)):
        assert (bone_priors.accumulate_builtin_priors(n, seed)
                == jax_bone_priors.accumulate_builtin_priors(n, seed))
    names = ('pelv', 'spin', 'spi2')
    np.testing.assert_array_equal(bone_priors.template_for('kinectv2_25', names),
                                  jax_bone_priors.template_for('kinectv2_25', names))


def test_generator_rewrites_the_asset_byte_for_byte(tmp_path, monkeypatch):
    shipped = Path(bone_priors.ASSET_PATH).read_bytes()
    out = tmp_path / 'assets' / 'bone_priors.json'
    monkeypatch.setattr(bone_priors, 'ASSET_PATH', str(out))
    load_script('gen_bone_priors_torch').main()
    assert out.read_bytes() == shipped
    assert out.read_bytes() == Path(jax_bone_priors.ASSET_PATH).read_bytes()


@pytest.mark.parametrize('radius', [1, 2, 4, 7, 13])
def test_filled_circle_equals_cv2(radius):
    """`cvfree.circle(..., -1)` against `cv2.circle(..., -1)`, centers
    inside, on and beyond the border."""
    rng = np.random.default_rng(radius)
    for _ in range(40):
        img = rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
        center = (int(rng.integers(-10, 74)), int(rng.integers(-10, 58)))
        color = tuple(int(c) for c in rng.integers(0, 256, 3))
        want = cv2.circle(img.copy(), center, radius, color, -1)
        np.testing.assert_array_equal(cvfree.circle(img.copy(), center, radius, color, -1),
                                      want)
    with pytest.raises(NotImplementedError, match='outline'):
        cvfree.circle(img, (5, 5), 3, (1, 2, 3), 1)


RUN_START, RUN_STEPS = 490, 24


def scene_batches(n_steps: int, batch: int = 4):
    """Per step a 3D and a 2D batch of `batch` crops of the run's training
    scenes at 64 px, through JAX's loaders with the run's appearance
    augmentations off and its geometric ones on."""
    from metrabs_tpu.config import ModelConfig as JaxModelConfig
    from metrabs_tpu.data import loading as jax_loading
    from metrabs_tpu.pipeline.skeletons import H36M_17, LSP_14

    _, ex3d, ex2d, _ = t2s_jax.build_split(7, 3)
    lcfg = jax_loading.LoadConfig(occlude_aug_prob=0, occlude_aug_prob_2d=0,
                                  background_aug_prob=0, color_aug=False)
    streams = ((jax_loading.load_and_transform3d, ex3d, H36M_17, 'coords3d_true'),
               (jax_loading.load_and_transform2d, ex2d, LSP_14, 'coords2d_true'))
    rng = np.random.default_rng(11)
    for _ in range(n_steps):
        out = []
        for load, examples, joints, coords in streams:
            items = [load(examples[int(i)], joints, True, np.random.default_rng(int(seed)),
                          JaxModelConfig(proc_side=64), lcfg)
                     for i, seed in zip(rng.integers(len(examples), size=batch),
                                        rng.integers(1 << 31, size=batch))]
            out.append({k: np.stack([d[k] for d in items])
                        for k in ('image', 'intrinsics', coords, 'joint_validity_mask')})
        yield out


def test_train_steps_follow_jax_along_the_runs_schedule(one_torch_thread):  # noqa: F811
    """The train step at the run's settings (EMA 0.995, base LR 1e-3) along
    24 steps on batches of the scenes, each step from JAX's state of the step
    before: micro-steps 490-513 cross the weak-perspective warm-up's end at
    500 and the absolute loss's start after 505; the optimizer's counts 0-23
    run the two-phase schedule of 24 steps to its last value, in phase two.
    At every step the port's LR equals JAX's, and its losses, Adam moments,
    BN statistics, parameters and EMA are within the one-step tolerances of
    tests/_torch_train.py. The tiny backbone computes in float64 on both
    sides (float32 parameters, as in tests/test_torch_train_effnet.py): in
    float32 the first conv's gradient over these mostly flat crops keeps
    ~2e-4 of its largest element as rounding noise on either side."""
    import jax
    import jax.numpy as jnp
    import torch

    with jax.enable_x64(True):
        follow_jax_steps(jnp.float64, torch.float64)


def follow_jax_steps(jax_dtype, port_dtype):
    import dataclasses

    import jax
    import jax.numpy as jnp
    import torch
    from flax import serialization
    from metrabs_tpu.pipeline.skeletons import H36M_17, LSP_14
    from metrabs_tpu.train import loop as jax_loop
    from metrabs_tpu.train import optim as jax_optim
    from metrabs_tpu_torch.io.weights import load_flax_train_state, torch_state_dict_from_flax
    from metrabs_tpu_torch.pipeline import skeletons
    from metrabs_tpu_torch.train import loop
    from tests import _torch_train as tt

    cfg, tcfg = tt.cfgs('tiny')
    tcfg = dataclasses.replace(tcfg, training_steps=RUN_STEPS, ema_momentum=0.995,
                               base_learning_rate=1e-3, absloss_start_step=RUN_START + 15)
    model, tx, state = tt.jax_train_state(cfg, tcfg, tt.jax_backbone('tiny', dtype=jax_dtype))
    state = state.replace(step=jnp.int32(RUN_START))
    optimizer, pstate = tt.port_train_state(cfg, tcfg, tt.port_backbone('tiny', dtype=port_dtype),
                                            state)
    jax_step = jax.jit(jax_loop.make_train_step(model, tx, H36M_17, LSP_14, cfg, tcfg))
    pcfg, ptcfg = tt.port_cfgs(cfg, tcfg)
    port_step = loop.make_train_step(pstate.model, optimizer, skeletons.H36M_17,
                                     skeletons.LSP_14, pcfg, ptcfg)
    jax_lr = jax_optim.lr_schedule(tcfg)
    lrs = []
    for count, (b3, b2) in enumerate(scene_batches(RUN_STEPS)):
        load_flax_train_state(pstate, tt.to_numpy(serialization.to_state_dict(state)))
        assert pstate.step == RUN_START + count
        key = jax.random.fold_in(jax.random.PRNGKey(5), count)
        state, jax_losses = jax_step(state, b3, b2, key)
        losses = port_step(pstate, b3, b2, mix=torch.tensor(tt.jax_mix(key, 8)))
        lr = optimizer.schedules['all'](count)
        assert lr == float(jax_lr(count)), count
        lrs.append(lr)
        for k, want in tt.to_numpy(jax_losses).items():
            np.testing.assert_allclose(losses[k].numpy(), want, rtol=tt.LOSS_RTOL,
                                       err_msg=f'{k} at step {RUN_START + count}')
        adam, jax_adam = pstate.opt_state.groups['all'], state.opt_state[0]
        assert adam.count == int(jax_adam.count) == count + 1
        tt.assert_trees_close(tt.flat_port(adam.mu), tt.flat_jax_params(jax_adam.mu), 'mu')
        tt.assert_trees_close(tt.flat_port(adam.nu), tt.flat_jax_params(jax_adam.nu), 'nu')
        buffers = {k: v.numpy() for k, v in pstate.model.state_dict().items()
                   if k.endswith(('running_mean', 'running_var'))}
        tt.assert_trees_close(buffers, {k: v.numpy() for k, v in torch_state_dict_from_flax(
            {'batch_stats': tt.to_numpy(state.batch_stats)}).items()}, 'batch_stats')
        port_params, jax_params = tt.flat_port(pstate.params()), tt.flat_jax_params(state.params)
        tt.assert_params_moved_alike(port_params, jax_params, lr)
        tt.assert_ema_close(tt.flat_port(pstate.ema_params), tt.flat_jax_params(state.ema_params),
                            port_params, jax_params, tcfg.ema_momentum)
        assert pstate.step == int(state.step) == RUN_START + count + 1
    # The schedule decays through phase one and ends in phase two at its last value.
    assert lrs[0] == float(np.float32(1e-3)) and all(a > b for a, b in zip(lrs, lrs[1:]))
    assert lrs[-1] < 1e-3 / 30


def test_bfloat16_training_keeps_float32_master_weights(one_torch_thread):  # noqa: F811
    """The run trains in bfloat16: the parameters, the EMA and Adam's moments
    stay float32, as in JAX's state (flax's param_dtype), so an update below
    a bfloat16 ulp moves a weight instead of rounding away."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import torch
    from metrabs_tpu_torch.pipeline import skeletons
    from metrabs_tpu_torch.train import loop
    from tests import _torch_train as tt

    cfg, tcfg = tt.cfgs('tiny')
    cfg = dataclasses.replace(cfg, dtype='bfloat16')
    model, _, state = tt.jax_train_state(cfg, tcfg, tt.jax_backbone('tiny', dtype=jnp.bfloat16))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, tt.PROC_SIDE, tt.PROC_SIDE, 3), jnp.bfloat16),
                            jnp.eye(3)[None])
    assert {leaf.dtype for leaf in jax.tree_util.tree_leaves(shapes['params'])} == {
        np.dtype(np.float32)}
    optimizer, pstate = tt.port_train_state(
        cfg, tcfg, tt.port_backbone('tiny', dtype=torch.bfloat16), state)
    pcfg, ptcfg = tt.port_cfgs(cfg, tcfg)
    step = loop.make_train_step(pstate.model, optimizer, skeletons.H36M_17, skeletons.LSP_14,
                                pcfg, ptcfg)
    before = {k: v.detach().clone() for k, v in pstate.params().items()}
    step(pstate, *tt.make_batches(np.random.default_rng(0)), mix=torch.full((8, 1, 1), 0.5))
    adam = pstate.opt_state.groups['all']
    for tree in (pstate.params(), pstate.ema_params, adam.mu, adam.nu):
        assert {t.dtype for t in tree.values()} == {torch.float32}
    lr = optimizer.schedules['all'](0)
    moved = below_ulp = 0
    for name, p in pstate.params().items():
        delta = (p.detach() - before[name]).abs()
        ulp = before[name].abs() * 2.0 ** -8  # bfloat16 keeps 8 significant bits
        small = (ulp > 2 * lr) & (delta > 0)
        below_ulp += int(small.sum())
        moved += int((small & (p.detach() != p.detach().bfloat16().float())).sum())
    assert below_ulp > 0 and moved == below_ulp


def test_2d_joint_index_groups_equal_jax():
    """The 2D stream's LSP-14 joints map onto the model's H36M-17 joints as
    in JAX's losses."""
    from metrabs_tpu.pipeline import skeletons as jax_skeletons
    from metrabs_tpu.train import losses as jax_losses
    from metrabs_tpu_torch.pipeline import skeletons
    from metrabs_tpu_torch.train import losses

    got = losses.get_2d_joint_index_groups(skeletons.H36M_17, skeletons.LSP_14)
    want = jax_losses.get_2d_joint_index_groups(jax_skeletons.H36M_17, jax_skeletons.LSP_14)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
