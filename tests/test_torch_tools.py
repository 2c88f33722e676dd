"""The port's measuring and sanity scripts (`scripts/*_torch.py`) on the
CPU: each `main` runs at a tiny configuration with `--device cpu` and prints
its JSON line with the figures it promises, and without `--device` it
refuses to run off the card; the overfit check's drawing equals cv2's and
its first 3 steps' losses equal JAX's from the same weights (within
tests/_torch_train.py's loss tolerance); the pipelined flagship run equals
the serial one; and the minting helpers moved out of chip_smoke.py mint the
same bytes as before the move."""

import contextlib
import hashlib
import io
import json

import numpy as np
import pytest
import torch

from scripts import (_flops_torch, _minting_torch, bench_data_pipeline_torch,
                     bench_pipelined_flagship_torch, mfu_experiments_torch, overfit_sanity_torch,
                     profile_cropmodel_torch, profile_pipeline_torch, profile_trace_torch)
from tests._torch_train import LOSS_RTOL, jax_mix, one_torch_thread  # noqa: F401 (fixture)

TRACE_KEYS = {'device_ms', 'busy_ms', 'wall_ms', 'profiled_wall_ms', 'busy_share',
              'categories_ms', 'category_launches', 'top_kernels', 'conv_input_formats',
              'wrapper_launches', 'timeline'}
TINY_FRAME = ['--height', '120', '--width', '160']
RUNS = {
    'trace_cropmodel': (profile_trace_torch, ['--mode', 'cropmodel', '--backbone', 'tiny',
                                              '--res', '64', '--batch', '2', '--iters', '1',
                                              '--dtype', 'float32'], TRACE_KEYS),
    'trace_train': (profile_trace_torch, ['--mode', 'train', '--backbone', 'tiny', '--res', '64',
                                          '--batch', '2', '--iters', '1', '--dtype', 'float32'],
                    TRACE_KEYS | {'remat', 'bn_bf16_stats'}),
    'pipeline': (profile_pipeline_torch, ['--backbone', 'tiny', '--res', '64', '--n-boxes', '2',
                                          '--num-aug', '2', '--iters', '2', '--dtype', 'float32']
                 + TINY_FRAME,
                 {'decode_pyramid_ms', 'warp_k1_ms', 'crop_model_ms', 'estimate_ms'}),
    'cropmodel': (profile_cropmodel_torch, ['--backbone', 'efficientnetv2-s', '--res', '64',
                                            '--batch', '2', '--scales', '32', '--batches', '1',
                                            '--calls', '1', '--dtype', 'float32'],
                  {'full_ms', 'backbone_head_ms', 'backbone_ms', 'backbone_gflop_per_crop',
                   'resolution_scaling', 'batch_scaling'}),
    'flops': (_flops_torch, ['--models', 'mobilenetv3-small@64'], {'models'}),
    'mfu': (mfu_experiments_torch, ['--backbone', 'tiny', '--res', '64', '--batch', '2',
                                    '--warmup', '1', '--steps', '2', '--dtype', 'float32',
                                    '--variants', 'remat_all', 'no_remat', 'bn_stats_bf16'],
            {'variants', 'peak_bf16_tflops', 'fwd_flops_per_crop', 'card'}),
    'overfit': (overfit_sanity_torch, ['--steps', '3', '--n-examples', '4'],
                {'mpjpe_before', 'mpjpe_after', 'improvement', 'passed', 'ms_per_step'}),
    'data_pipeline': (bench_data_pipeline_torch, ['--step-ms', '300', '--batch', '2',
                                                  '--workers', '2', '--n-batches', '2'],
                      {'ms_per_batch', 'examples_per_s', 'batches_per_s', 'step_ms', 'margin',
                       'margin_one_stream', 'cores_needed'}),
}


def run_main(module, argv):
    """(main's return, the last line it printed, parsed as JSON)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = module.main(argv)
    return result, json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize('name', sorted(RUNS))
def test_script_main_prints_its_json_line(name, tmp_path, one_torch_thread):  # noqa: F811
    module, argv, keys = RUNS[name]
    argv = argv + ['--device', 'cpu']
    if module is profile_trace_torch:
        argv += ['--outdir', str(tmp_path / 'trace')]
    if module is mfu_experiments_torch:
        argv += ['--out', str(tmp_path / 'mfu.json')]
    result, line = run_main(module, argv)
    assert keys <= set(line), keys - set(line)
    assert line['device'] == 'cpu'
    if module is profile_trace_torch:
        assert line['timeline'] == 'host ops'
        assert sum(line['categories_ms'].values()) == pytest.approx(line['device_ms'])
    if module is mfu_experiments_torch:
        # The tiny backbone has no bf16 BN statistics: recorded, and the sweep goes on.
        assert 'error' in line['variants']['bn_stats_bf16']
        assert line['variants']['no_remat']['ms_per_step'] > 0
        assert json.loads((tmp_path / 'mfu.json').read_text())['variants'].keys() == \
            line['variants'].keys()


@pytest.mark.parametrize('module', [profile_trace_torch, profile_pipeline_torch,
                                    profile_cropmodel_torch, _flops_torch, mfu_experiments_torch,
                                    overfit_sanity_torch, bench_data_pipeline_torch,
                                    bench_pipelined_flagship_torch],
                         ids=lambda m: m.__name__.split('.')[-1])
def test_script_defaults_to_the_card(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='needs CUDA'):
        module.main([])


def test_trace_detect_mode_on_the_minted_cell(tmp_path, one_torch_thread):  # noqa: F811
    """The detect mode of the smoke run's [tools] phase, on one small frame:
    the YOLOv4-416 + EffNetV2-S crop model unfolded with fuse_mbconv='on'."""
    result, line = run_main(profile_trace_torch, [
        '--mode', 'detect', '--res', '64', '--batch', '1', '--iters', '1', '--dtype', 'float32',
        '--device', 'cpu', '--outdir', str(tmp_path)])
    assert line['k2'] == 'on' and line['bn_fold'] is False and line['frames'] == [1, 1080, 1920, 3]
    assert sum(line['category_launches'].values()) > 1000
    assert sum(line['categories_ms'].values()) == pytest.approx(line['busy_ms'], rel=5e-3)
    assert line['categories_ms']['BatchNorm'] > 0  # the unfolded norms, labelled by their hooks


def test_pipelined_flagship_equals_serial(tmp_path, one_torch_thread):  # noqa: F811
    out = tmp_path / 'pipelined.json'
    result, line = run_main(bench_pipelined_flagship_torch, [
        '--backbone', 'tiny', '--res', '64', '--batch', '1', '--n-batches', '2', '--repeats', '1',
        '--dtype', 'float32', '--device', 'cpu', '--out', str(out)] + TINY_FRAME)
    assert line['max_abs_difference'] == 0  # the masks are held equal inside
    assert set(line['results']) == {'serial', 'pipelined_if2', 'pipelined_if3'}
    assert len(line['valid_per_batch']) == 2
    assert json.loads(out.read_text())['results'] == line['results']


def test_overfit_drawing_equals_cv2():
    cv2 = pytest.importorskip('cv2')
    from metrabs_tpu_torch.pipeline.skeletons import H36M_17

    rng = np.random.default_rng(0)
    cam = overfit_sanity_torch.make_camera()
    for _ in range(6):
        pts = cam.world_to_image((rng.normal(size=(17, 3)) * 220 + [0, 0, 3500]))
        want = np.full((480, 640, 3), 32, np.uint8)
        for a, b in H36M_17.edges:
            cv2.line(want, tuple(np.round(pts[a]).astype(int).tolist()),
                     tuple(np.round(pts[b]).astype(int).tolist()), (0, 255, 0), 3)
        for j, pt in enumerate(pts):
            cv2.circle(want, tuple(np.round(pt).astype(int).tolist()), 5,
                       (255, 30 + j * 12, 30 + j * 12), -1)
        np.testing.assert_array_equal(overfit_sanity_torch.render(pts, H36M_17.edges), want)


def test_overfit_first_steps_match_jax(one_torch_thread):  # noqa: F811
    """Three steps of the tiny configuration from the same minted weights on
    the same batches, the port given the mix JAX draws from PRNGKey(i)."""
    import jax
    import jax.numpy as jnp
    from metrabs_tpu.config import ModelConfig, TrainConfig
    from metrabs_tpu.models.backbones.tiny import TinyBackbone
    from metrabs_tpu.models.metrabs import Metrabs
    from metrabs_tpu.pipeline.skeletons import H36M_17, LSP_14
    from metrabs_tpu.train import loop, optim
    from metrabs_tpu_torch.io.weights import flax_variables_from_state_dict

    state, step, cfg, _ = overfit_sanity_torch.build('tiny', 900, 'cpu')
    batch3d, batch2d = overfit_sanity_torch.make_batches(
        overfit_sanity_torch.render_examples(8, np.random.default_rng(0)), cfg)
    variables = flax_variables_from_state_dict(state.model.state_dict())

    jcfg = ModelConfig(proc_side=64, stride_train=32, stride_test=32, depth=4, n_joints=17,
                       dtype='float32')
    jtcfg = TrainConfig(training_steps=900, base_learning_rate=1e-3, absloss_start_step=50)
    model = Metrabs(cfg=jcfg, backbone=TinyBackbone(width=32, dtype=jnp.float32))
    tx = optim.build_optimizer(jtcfg)
    params = jax.tree_util.tree_map(jnp.asarray, variables['params'])
    jstate = loop.TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                             opt_state=tx.init(params), ema_params=params)
    jstep = jax.jit(loop.make_train_step(model, tx, H36M_17, LSP_14, jcfg, jtcfg))
    j3 = {k: jnp.asarray(v) for k, v in batch3d.items()}
    j2 = {k: jnp.asarray(v) for k, v in batch2d.items()}
    for i in range(3):
        key = jax.random.PRNGKey(i)
        jstate, want = jstep(jstate, j3, j2, key)
        got = step(state, batch3d, batch2d, mix=torch.as_tensor(jax_mix(key, 16)))
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=LOSS_RTOL,
                                       err_msg=f'step {i} {k}')


# SHA-256 of the minted helpers' output before they moved from chip_smoke.py
# to scripts/_minting_torch.py (computed on the tree before the move).
MINTED_SHA256 = {
    'crop': 'eeda3e7aaeaf51b7379bc69f69526dedba7544cdc964bb68aba7c67ff25a75aa',
    'detector': '3b5f727d238bed20504671c86d294c5431de7017d69b33afb56f16af8a8a5c73',
    'firing_tiny': '44cf174954158405971473703b56009a0e1cd52e9b192f3c22bd33df6a7ab473',
    'boxes': '2ed504a4e5d1ee47158d64bf6e2da75d7cb87858b1dca48e22724dda139f49ea',
    'frames': 'f114908826459f1c761eaa3f557c0de3a7193838959952ee6992819c154f3c17',
    'manifests': 'a51dd3cf062f7fb87415a4dbd0a0985a651ef25fa09c27c0fbab1c81ea269e71',
}


def tree_sha256(tree) -> str:
    h = hashlib.sha256()

    def leaves(t, prefix=''):
        if isinstance(t, dict):
            for k in sorted(t):
                yield from leaves(t[k], f'{prefix}/{k}')
        else:
            yield prefix, np.asarray(t)

    for k, v in leaves(tree):
        h.update(k.encode())
        h.update(str(v.dtype).encode())
        h.update(str(v.shape).encode())
        h.update(np.ascontiguousarray(v).tobytes())
    return h.hexdigest()


def test_minting_helpers_mint_the_bytes_of_before_the_move():
    import chip_smoke
    from metrabs_tpu_torch.config import ModelConfig

    m = _minting_torch
    assert chip_smoke.mint_crop_variables is m.mint_crop_variables
    gen = torch.Generator().manual_seed(0)
    cfg = ModelConfig(**m.manifest_for('bfloat16')['model_config'])
    boxes, valid = m.synthetic_boxes()
    got = dict(
        crop=tree_sha256(m.mint_crop_variables(cfg, gen)),
        detector=tree_sha256(m.mint_detector_variables(gen)),
        firing_tiny=tree_sha256(m.firing_detector_variables(gen, 'yolov4-tiny')),
        boxes=tree_sha256({'boxes': boxes, 'valid': valid}),
        frames=tree_sha256({'frames': m.synthetic_frames(torch.Generator().manual_seed(0),
                                                         'cpu').numpy()}),
        manifests=hashlib.sha256(json.dumps(
            [m.manifest_for('float32'), m.detect_manifest_for('bfloat16')],
            sort_keys=True).encode()).hexdigest())
    assert got == MINTED_SHA256
