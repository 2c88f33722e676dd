"""The port's multi-process training and serving (`metrabs_tpu_torch.parallel.
mesh`, `train.loop.make_sharded_train_step`, `PoseEstimator(mesh=...)`,
`apps.train --distributed`) on the CPU, each rank a spawned process on a
gloo process group (tests/_torch_dist.py; one world is reused for several
checks, and each world fails within its deadline if a rank hangs):

 - `shard_example_stream` and `tp_shardings` agree with JAX's;
 - JAX's sharded step equal to its unsharded step (the global batch's
   statistics), the reference of the next check;
 - the W-rank data-parallel step (W = 2 and 4) against JAX's
   `make_sharded_train_step` on a (W, 1) mesh of the 8 virtual devices, from
   the same state, batch and mix, within tests/_torch_train.py's
   tolerances: ranks hold different numbers of valid joints, and with ghost
   splits 2 and 3 the BatchNorm groups straddle ranks and the 3D/2D
   boundary (a TinyBackbone whose BatchNorms are the packages' own
   `GhostBatchNorm`s, built alike on both sides, computing in float64 from
   float32 parameters on both sides as tests/test_torch_train_effnet.py
   does: in float32, ghost statistics over 12 rows of 2x2 maps put even the
   one-rank port 2% of a tensor's largest gradient away from JAX, and
   float64 brings both within 1e-6);
 - the (2, 2) tensor-parallel step against JAX's (2, 2) step and against
   the port's (4, 1) step within JAX's own rtol 1e-4, atol 1e-5
   (tests/test_train.py), with sharded leaves;
 - data-parallel serving (W = 2) against the one-rank port: estimate and
   its stream exactly, detect and its stream within
   tests/test_torch_estimator.py's tolerances (the detector's convolutions
   of one frame differ from those of two in the last bit), and within those
   tolerances of JAX's unsharded estimator; the (1, 2) tensor-parallel
   fused serve (K2's plain version on channel slices) within those of the
   one-rank fused serve; a frame batch that 'data' does not divide raises
   as JAX does; `replicate` broadcasts rank 0's tensors;
 - the kernel-norm projection under tensor parallelism stays local to a
   rank's out-channel slice;
 - `apps.train.main --distributed` on two ranks: tensor-parallel, then
   resumed data-parallel from the gathered checkpoint, rank 0 alone logging
   and writing checkpoints and the package;
 - NCCL where this torch has none raises, with no switch to gloo;
 - scripts/validate_distributed_cpu_torch.py passes.
"""

import copy
import dataclasses
import functools
import json
import types

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrabs_tpu.data import pipeline as jax_pipeline
from metrabs_tpu.io.packaging import load_pose_estimator as jax_load_pose_estimator
from metrabs_tpu.models.backbones import common as jax_common
from metrabs_tpu.parallel import mesh as jax_mesh
from metrabs_tpu.pipeline.skeletons import H36M_17, LSP_14
from metrabs_tpu.train import loop as jax_loop
from metrabs_tpu.train import optim as jax_optim
from metrabs_tpu_torch.data import pipeline
from metrabs_tpu_torch.io.packaging import load_pose_estimator
from metrabs_tpu_torch.io.weights import torch_state_dict_from_flax
from metrabs_tpu_torch.models.backbones.builder import build_backbone
from metrabs_tpu_torch.parallel import mesh as mesh_mod
from tests import _torch_dist as td
from tests import _torch_port
from tests import _torch_train as tt
from tests.test_torch_estimator import compare, frames_and_boxes

from tests._torch_train import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures('one_torch_thread')

N3 = N2 = 12  # the global batch: 24 rows, divisible by 2, 3 and 4
TP_TOL = dict(rtol=1e-4, atol=1e-5)
CLIP_NORM = 0.5  # below the minted kernels' out-channel norms: the projection clips
BONE_MEANS = np.full(16, 700.0, np.float32)  # a prior the filter keeps some poses under


class GhostTiny(nn.Module):
    """TinyBackbone (width 16, BatchNorm momentum 0.99, eps 1e-5) with the
    JAX package's `GhostBatchNorm` of `splits` ghost splits, computing in
    float64 from float32 parameters."""
    width: int = 16
    splits: int = 1

    @nn.compact
    def __call__(self, x, train: bool = False):
        x = x.astype(jnp.float64)
        for i in range(5):
            x = nn.Conv(self.width, (3, 3), strides=(2, 2), padding='SAME', use_bias=False,
                        dtype=jnp.float64, param_dtype=jnp.float32, name=f'conv{i}')(x)
            x = jax_common.batch_norm(0.99, 1e-5, jnp.float64, f'bn{i}',
                                      ghost_splits=self.splits)(x, train=train)
            x = nn.relu(x)
        return x


def port_ghost_tiny(splits: int):
    from metrabs_tpu_torch.models.backbones.tiny import TinyBackbone
    backbone = TinyBackbone(width=16, use_bn=True, dtype=torch.float64)
    for i in range(5):
        getattr(backbone, f'bn{i}').splits = splits
    return backbone


def global_batches():
    """The global 3D and 2D batches; the ranks' rows hold different numbers
    of valid joints (whole blocks of rows masked more than others)."""
    b3, b2 = tt.make_batches(np.random.default_rng(7), N3, N2)
    b3['joint_validity_mask'][:3, 2:13] = False
    b3['joint_validity_mask'][7, 5] = False
    b2['joint_validity_mask'][-3:, 1:10] = False
    return b3, b2


def jax_step_and_state(splits: int, mesh_shape, tp_min_size=None):
    """(JAX state before, state after, losses) of JAX's sharded step on a
    mesh of the virtual devices, and the port's state holding the state
    before (with its configs)."""
    with jax.enable_x64(True):
        return _jax_step_and_state(splits, mesh_shape, tp_min_size)


def _jax_step_and_state(splits: int, mesh_shape, tp_min_size):
    cfg, tcfg = tt.cfgs('tiny')
    tcfg = dataclasses.replace(tcfg, batch_size=N3, batch_size_2d=N2)
    model, tx, state = tt.jax_train_state(cfg, tcfg, GhostTiny(splits=splits))
    _, pstate = tt.port_train_state(cfg, tcfg, port_ghost_tiny(splits), state)
    mesh = jax_mesh.make_mesh(*mesh_shape)
    shardings = (None if tp_min_size is None
                 else jax_mesh.tp_shardings(mesh, state, min_size=tp_min_size))
    unsharded = jax_loop.make_train_step(model, tx, H36M_17, LSP_14, cfg, tcfg)
    step = jax_loop.make_sharded_train_step(unsharded, mesh, state_shardings=shardings)
    b3, b2 = global_batches()
    with mesh:
        after, losses = step(state, b3, b2, jax.random.PRNGKey(3))
    pcfg, ptcfg = tt.port_cfgs(cfg, tcfg)
    job = dict(state=pstate, cfg=pcfg, tcfg=ptcfg, b3=b3, b2=b2,
               mix=tt.jax_mix(jax.random.PRNGKey(3), N3 + N2))
    return dict(before=state, after=after, losses=tt.to_numpy(losses), tcfg=tcfg,
                shardings=shardings, step=unsharded), job


def check_against_jax(got, ref):
    """A port step's results (`tests._torch_dist.state_results`) against
    JAX's step, with tests/_torch_train.py's tolerances."""
    for k, want in ref['losses'].items():
        np.testing.assert_allclose(got['losses'][k], want, rtol=tt.LOSS_RTOL, err_msg=k)
    after, tcfg = ref['after'], ref['tcfg']
    mu = tt.flat_jax_params(after.opt_state[0].mu)
    tt.assert_grads_close(got['grads'], {k: v / np.float32(0.1) for k, v in mu.items()})
    tt.assert_trees_close(got['mu'], mu, 'mu')
    tt.assert_trees_close(got['nu'], tt.flat_jax_params(after.opt_state[0].nu), 'nu')
    stats = {k: v.numpy() for k, v in torch_state_dict_from_flax(
        {'batch_stats': tt.to_numpy(after.batch_stats)}).items()}
    tt.assert_trees_close(got['buffers'], stats, 'batch_stats')
    jax_params = tt.flat_jax_params(after.params)
    tt.assert_ema_close(got['ema'], tt.flat_jax_params(after.ema_params), got['params'],
                        jax_params, tcfg.ema_momentum)
    tt.assert_params_moved_alike(got['params'], jax_params,
                                 float(jax_optim.lr_schedule(tcfg)(0)))
    assert got['step'] == int(after.step) == 1


def check_ranks_agree(per_rank):
    """Every rank ends with the same parameters (checksums) and state."""
    assert len({r['checksum'] for r in per_rank}) == 1, [r['checksum'] for r in per_rank]
    for r in per_rank[1:]:
        for key in ('params', 'ema', 'mu', 'nu', 'buffers'):
            for name, v in r[key].items():
                np.testing.assert_array_equal(v, per_rank[0][key][name], err_msg=name)


@pytest.fixture(scope='module')
def package(tmp_path_factory):
    return _torch_port.make_package(str(tmp_path_factory.mktemp('pkg') / 'p'), scanned=False,
                                    detector='yolov4', bone_mean_lengths=BONE_MEANS)


# One aug: the plausibility filter keeps some of the random model's poses
# (two random augs never agree) and drops others.
DETECT = dict(num_aug=1, max_detections=4, detector_threshold=0.0, internal_batch_size=4)
ESTIMATE = dict(num_aug=2, internal_batch_size=4)  # two boxes per chunk: three chunks


def serving_calls():
    frames, boxes, valid = frames_and_boxes()
    stream = (np.stack([frames, frames[:, ::-1].copy()]), np.stack([boxes, boxes]),
              np.stack([valid, valid[:, ::-1].copy()]))
    return [('estimate_poses_batched', (frames, boxes, valid), ESTIMATE),
            ('estimate_poses_stream', stream, ESTIMATE),
            ('detect_poses_batched', (frames,), DETECT),
            ('detect_poses_stream', (stream[0],), DETECT),
            ('estimate_poses_batched', (np.concatenate([frames, frames[:1]]),
                                        np.concatenate([boxes, boxes[:1]]),
                                        np.concatenate([valid, valid[:1]])), ESTIMATE)]


@pytest.fixture(scope='module')
def two_ranks(package):
    """One world of two ranks: the step with ghost splits 1, 2 and 3 on a
    (2, 1) mesh, each serving call on a (2, 1) mesh, then the (1, 2)
    tensor-parallel fused detect; rank 0 also makes the one-rank port's
    calls (the test's own process has run XLA, which changes the CPU's
    floating-point state)."""
    refs, jobs = [], []
    for splits in (1, 2, 3):
        ref, job = jax_step_and_state(splits, (2, 1))
        refs.append(ref)
        jobs.append(dict(job, mesh=(2, 1)))
    calls = serving_calls()
    per_rank = td.run_world(td.several, 2, [
        ('train_steps', dict(jobs=jobs)),
        ('serve', dict(package=package, mesh=(2, 1), calls=calls, reference=4)),
        ('serve', dict(package=package, mesh=(1, 2), calls=calls[2:3], fused=True,
                       tp_min_size=4096, reference=1)),
        ('replicate', None)])
    steps = {s: (ref, [r[0][i] for r in per_rank])
             for i, (s, ref) in enumerate(zip((1, 2, 3), refs))}
    dp, tp = [r[1] for r in per_rank], [r[2] for r in per_rank]
    return dict(steps=steps, dp=dp, tp=tp, want=dp[0]['reference'],
                want_fused=tp[0]['reference'][0], estimate_args=calls[0][1],
                replicated=[r[3] for r in per_rank])


@pytest.fixture(scope='module')
def four_rank_steps():
    """On four ranks: ghost splits 1 and 3 on a (4, 1) mesh, then the (2, 2)
    tensor-parallel step (ghost splits 1, min_size 2048 as
    tests/test_train.py)."""
    refs, jobs = {}, []
    for splits in (1, 3):
        ref, job = jax_step_and_state(splits, (4, 1))
        refs[f'dp{splits}'] = ref
        jobs.append(dict(job, mesh=(4, 1)))
    ref, job = jax_step_and_state(1, (2, 2), tp_min_size=2048)
    refs['tp'] = ref
    jobs.append(dict(job, mesh=(2, 2), tp_min_size=2048))
    # The kernel-norm projection on: per out-channel, so local to a slice.
    clipped = dataclasses.replace(job['tcfg'], constrain_kernel_norm=CLIP_NORM)
    jobs += [dict(job, state=copy.deepcopy(job['state']), tcfg=clipped, mesh=(4, 1)),
             dict(job, state=copy.deepcopy(job['state']), tcfg=clipped, mesh=(2, 2),
                  tp_min_size=2048)]
    refs['dp_clip'] = refs['tp_clip'] = None
    # Port-only pairs: convolutions with a bias, and depthwise convolutions.
    names = ['dp1', 'dp3', 'tp', 'dp_clip', 'tp_clip']
    for kind, min_size in (('bias', 2048), ('depthwise', 256)):
        port_job = port_only_job(kind)
        jobs += [dict(port_job, state=copy.deepcopy(port_job['state']), mesh=(4, 1)),
                 dict(port_job, mesh=(2, 2), tp_min_size=min_size)]
        names += [f'dp_{kind}', f'tp_{kind}']
        refs[f'dp_{kind}'] = refs[f'tp_{kind}'] = None
    per_rank = td.run_world(td.train_steps, 4, dict(jobs=jobs))
    return {name: (refs[name], [r[i] for r in per_rank]) for i, name in enumerate(names)}


def port_only_job(kind: str) -> dict:
    """A step job of the port alone: TinyBackbone with biased convolutions
    ('bias') or MobileNetV3-small-mini ('depthwise': depthwise convolutions
    and the SE block's biased ones), weights from torch's initialisers,
    computing in float64 (as `GhostTiny`: float32 rounding through the
    train-mode BatchNorms of small maps outgrows the tolerance)."""
    from metrabs_tpu_torch.models.backbones.tiny import TinyBackbone
    from metrabs_tpu_torch.models.metrabs import Metrabs
    from metrabs_tpu_torch.train import loop, optim
    cfg, tcfg = tt.port_cfgs(*tt.cfgs('tiny'))
    tcfg = dataclasses.replace(tcfg, batch_size=N3, batch_size_2d=N2)
    torch.manual_seed(0)
    backbone = (TinyBackbone(width=16, dtype=torch.float64) if kind == 'bias'
                else build_backbone('mobilenetv3-small-mini', dtype=torch.float64))
    state = loop.create_train_state(Metrabs(cfg, backbone), optim.Optimizer(tcfg), device='cpu')
    b3, b2 = global_batches()
    mix = np.random.default_rng(3).uniform(size=(N3 + N2, 1, 1)).astype(np.float32)
    return dict(state=state, cfg=cfg, tcfg=tcfg, b3=b3, b2=b2, mix=mix)


@pytest.mark.parametrize('splits', [1, 2, 3])
def test_two_rank_step_matches_jax_sharded_step(two_ranks, splits):
    ref, per_rank = two_ranks['steps'][splits]
    check_ranks_agree(per_rank)
    check_against_jax(per_rank[0], ref)


def test_jax_sharded_step_equals_its_unsharded_step(two_ranks):
    """The reference the port is held to: JAX's sharded step computes the
    global batch's ghost-split statistics and masked means, i.e. equals its
    unsharded step (ghost splits 3 straddling the ranks, float64 as above),
    within tests/_torch_train.py's tolerances."""
    ref = two_ranks['steps'][3][0]
    b3, b2 = global_batches()
    with jax.enable_x64(True):
        want, want_losses = jax.jit(ref['step'])(ref['before'], b3, b2, jax.random.PRNGKey(3))
    got = ref['after']
    np.testing.assert_allclose(ref['losses']['loss'], float(want_losses['loss']), rtol=1e-6)
    tt.assert_grads_close(tt.flat_jax_params(got.opt_state[0].mu),
                          tt.flat_jax_params(want.opt_state[0].mu))
    stats = lambda s: {k: v.numpy() for k, v in torch_state_dict_from_flax(
        {'batch_stats': tt.to_numpy(s.batch_stats)}).items()}
    tt.assert_trees_close(stats(got), stats(want), 'batch_stats')
    tt.assert_params_moved_alike(tt.flat_jax_params(got.params), tt.flat_jax_params(want.params),
                                 float(jax_optim.lr_schedule(ref['tcfg'])(0)))


@pytest.mark.parametrize('splits', [1, 3])
def test_four_rank_step_matches_jax_sharded_step(four_rank_steps, splits):
    ref, per_rank = four_rank_steps[f'dp{splits}']
    check_ranks_agree(per_rank)
    check_against_jax(per_rank[0], ref)


def test_tensor_parallel_step_matches_jax_and_data_parallel(four_rank_steps):
    ref, per_rank = four_rank_steps['tp']
    got = per_rank[0]
    # Some leaf really is sharded over 'model', on both sides.
    specs = [str(leaf.sharding.spec) for leaf in jax.tree_util.tree_leaves(ref['after'].params)]
    assert any('model' in s for s in specs)
    assert got['sharded'] == ['backbone.conv1.weight', 'backbone.conv2.weight',
                              'backbone.conv3.weight', 'backbone.conv4.weight']
    check_ranks_agree(per_rank)
    dp = four_rank_steps['dp1'][1][0]
    np.testing.assert_allclose(got['losses']['loss'], dp['losses']['loss'], rtol=1e-5)
    jax_params = tt.flat_jax_params(ref['after'].params)
    for name, want in dp['params'].items():
        np.testing.assert_allclose(got['params'][name], want, **TP_TOL, err_msg=name)
        np.testing.assert_allclose(got['params'][name], jax_params[name], **TP_TOL,
                                   err_msg=name)


def test_tensor_parallel_kernel_norm_projection_stays_local(four_rank_steps):
    """`project_kernel_norms` clips each out-channel's norm, which a rank's
    slice holds whole: the (2, 2) step with it equals the (4, 1) step."""
    dp, tp = four_rank_steps['dp_clip'][1][0], four_rank_steps['tp_clip'][1][0]
    assert tp['sharded']
    check_ranks_agree(four_rank_steps['tp_clip'][1])
    for name in tp['sharded']:
        norms = np.sqrt((tp['params'][name].astype(np.float64) ** 2).sum(axis=(1, 2, 3)))
        assert norms.max() <= CLIP_NORM * (1 + 1e-6), name  # clipped
    for name, want in dp['params'].items():
        np.testing.assert_allclose(tp['params'][name], want, **TP_TOL, err_msg=name)


@pytest.mark.parametrize('kind', ['bias', 'depthwise'])
def test_tensor_parallel_step_matches_data_parallel_port(four_rank_steps, kind):
    """Sharded convolutions with a bias (replicated, added after the
    gather) and depthwise ones (on their input's channel slice): the (2, 2)
    step against the (4, 1) step, gradients and updated parameters with
    tests/_torch_train.py's tolerances (MobileNetV3's BatchNorm before a
    BatchNorm has a gradient that is zero in exact arithmetic)."""
    dp, tp_ranks = four_rank_steps[f'dp_{kind}'][1][0], four_rank_steps[f'tp_{kind}'][1]
    tp = tp_ranks[0]
    check_ranks_agree(tp_ranks)
    want = 'bias' if kind == 'bias' else 'depthwise'
    assert any(want in n or (kind == 'bias' and n.startswith('backbone.conv'))
               for n in tp['sharded']), tp['sharded']
    np.testing.assert_allclose(tp['losses']['loss'], dp['losses']['loss'], rtol=1e-5)
    tt.assert_grads_close(tp['grads'], dp['grads'])
    tt.assert_params_moved_alike(tp['params'], dp['params'],
                                 float(jax_optim.lr_schedule(tt.cfgs('tiny')[1])(0)))


@pytest.mark.parametrize('block,count', [(8, 2), (12, 3), (24, 4), (6, 1)])
def test_shard_example_stream_matches_jax(block, count):
    stream = list(range(5 * block + block // 2))  # a partial last block
    for index in range(count):
        assert (list(pipeline.shard_example_stream(iter(stream), block, index, count))
                == list(jax_pipeline.shard_example_stream(iter(stream), block, index, count)))
    shards = [list(pipeline.shard_example_stream(iter(stream), block, i, count))
              for i in range(count)]
    full = 5 * block
    assert sorted(x for s in shards for x in s if x < full) == list(range(full))  # covering
    assert len({x for s in shards for x in s}) == sum(len(s) for s in shards)  # disjoint
    for package in (pipeline, jax_pipeline):
        with pytest.raises(ValueError, match='must divide'):
            next(package.shard_example_stream(iter(stream), 7, 0, 2))


def test_tp_shardings_picks_jax_leaves():
    """The same tiny state and min_size 2048 (tests/test_train.py): JAX's rule
    on HWIO/[in, out] leaves, the port's on [O, ...] leaves, pick the same
    parameters, and Adam's moments mirror them."""
    cfg, tcfg = tt.cfgs('tiny')
    _, _, state = tt.jax_train_state(cfg, tcfg, tt.jax_backbone('tiny'))
    _, pstate = tt.port_train_state(cfg, tcfg, tt.port_backbone('tiny'), state)
    jmesh = jax_mesh.make_mesh(n_data=4, n_model=2)
    jsh = jax_mesh.tp_shardings(jmesh, state, min_size=2048)

    def sharded(tree):
        from metrabs_tpu_torch.io.weights import _torch_key, flatten_dict
        return sorted(_torch_key(k) for k, v in flatten_dict({'params': tree}).items()
                      if 'model' in str(v.spec))

    mesh = types.SimpleNamespace(mesh_dim_names=('data', 'model'), size=(4, 2).__getitem__)
    ours = mesh_mod.sharded_names(mesh_mod.tp_shardings(mesh, pstate, min_size=2048))
    assert ours and sorted(ours) == sharded(jsh.params) == sharded(jsh.opt_state[0].mu)
    assert mesh_mod.sharded_names(mesh_mod.tp_shardings(mesh, pstate)) == []  # 2**16


@pytest.mark.parametrize('call', [0, 1], ids=['estimate', 'estimate_stream'])
def test_data_parallel_estimate_equals_one_rank(two_ranks, call):
    """Exact: each chunk runs the same crops through the same CPU kernels on
    whichever rank it is dealt to."""
    want = two_ranks['want'][call]
    for rank in two_ranks['dp']:
        got = rank['results'][call]
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize('call', [2, 3], ids=['detect', 'detect_stream'])
def test_data_parallel_detect_matches_one_rank(two_ranks, call):
    """Not exact on the CPU: the detector runs each rank's frame alone, and
    oneDNN's convolutions of a batch of one frame differ from those of two
    in the last bit (boxes by 1.5e-5 px); so the boxes within 1e-3 px and
    the poses within tests/test_torch_estimator.py's tolerances, the valid
    masks equal."""
    want = {k: torch.as_tensor(v) for k, v in two_ranks['want'][call].items()}
    assert want['valid'].any() and not want['valid'].all()
    for rank in two_ranks['dp']:
        got = {k: torch.as_tensor(v) for k, v in rank['results'][call].items()}
        compare(got, want, want['valid'].numpy(), boxes_tol=dict(atol=1e-3, rtol=0),
                min_depth_2d=200.0)


@pytest.mark.parametrize('call', [0, 2], ids=['estimate', 'detect'])
def test_data_parallel_serving_matches_jax(two_ranks, package, call):
    jest = jax_load_pose_estimator(package)
    got = {k: torch.as_tensor(v) for k, v in two_ranks['dp'][0]['results'][call].items()}
    if call == 0:
        frames, boxes, valid = two_ranks['estimate_args']
        want = jest.estimate_poses_batched(frames, boxes, valid, **ESTIMATE)
        compare(got, want, valid)
    else:
        want = jest.detect_poses_batched(two_ranks['estimate_args'][0], **DETECT)
        compare(got, want, np.asarray(want['valid']), boxes_tol=dict(atol=1e-3, rtol=0),
                min_depth_2d=200.0)


def test_tensor_parallel_fused_serve_matches_one_rank(two_ranks):
    """K2's plain version on each rank's channel slice of the sharded
    depthwise weights, its v and SE mean all-gathered."""
    tp = two_ranks['tp']
    sharded = tp[0]['sharded']
    assert any('depthwise_conv' in n for n in sharded) and any('expand_conv' in n
                                                             for n in sharded)
    want = {k: torch.as_tensor(v) for k, v in two_ranks['want_fused'].items()}
    for rank in tp:
        got = {k: torch.as_tensor(v) for k, v in rank['results'][0].items()}
        compare(got, want, want['valid'].numpy(), boxes_tol=dict(atol=1e-3, rtol=0),
                min_depth_2d=200.0)


def test_frame_batch_not_divisible_by_data_raises_as_jax(two_ranks):
    for rank in two_ranks['dp']:
        assert 'should be divisible by 2, but it is equal to 3' in rank['results'][4]
    jmesh = jax_mesh.make_mesh(n_data=2)
    with pytest.raises(ValueError, match='should be divisible by 2, but it is equal to 3'):
        jax_mesh.shard_batch(jmesh, np.zeros((3, 4)))


def test_distributed_train_app_checkpoints_resumes_and_exports(tmp_path):
    """Two ranks: two tensor-parallel steps (--model-parallel 2), then
    resumed data-parallel to three from the gathered checkpoint."""
    from tests.test_torch_train_app import _write_datasets
    from metrabs_tpu_torch.io.checkpoints import load_model_msgpack
    paths = _write_datasets(tmp_path, n=8)
    ckpt, pkg = tmp_path / 'ckpt', tmp_path / 'pkg'

    def argv(steps, extra=()):
        return ['--ds3d', paths['ds3'], '--ds2d', paths['ds2'], '--checkpoint-dir', str(ckpt),
                '--backbone', 'tiny', '--proc-side', '64', '--depth', '4',
                '--batch-size', '4', '--batch-size-2d', '4', '--training-steps', str(steps),
                '--workers', '1', '--dtype', 'float32', '--checkpoint-period', '1',
                '--log-period', '1', '--export-dir', str(pkg), '--ema-momentum', '0.9',
                '--device', 'cpu', *extra]

    runs = [(argv(2, ['--model-parallel', '2', '--tp-min-size', '1024']), td.free_port()),
            (argv(3), td.free_port())]
    seen = td.run_world(td.app_runs, 2, dict(runs=runs, checkpoint_dir=str(ckpt)), init=False)
    assert seen[0] == [['1.pt', '2.pt'], ['2.pt', '3.pt']]
    log = [json.loads(line) for line in (ckpt / 'train_log.jsonl').read_text().splitlines()]
    assert [r['step'] for r in log] == [1, 2, 3]  # rank 0 alone; the resume took one step
    assert all(np.isfinite(r['loss']) for r in log)
    final = torch.load(ckpt / '3.pt', weights_only=True)
    first = torch.load(ckpt / '2.pt', weights_only=True)
    assert final['step'] == 3 and first['step'] == 2
    for sd in (first, final):  # full shapes, also where the run was tensor-parallel
        assert tuple(sd['model']['backbone.conv1.weight'].shape) == (32, 32, 3, 3)
        assert tuple(sd['opt_state']['groups']['all']['mu']['backbone.conv1.weight'].shape) \
            == (32, 32, 3, 3)
    exported = torch_state_dict_from_flax(
        load_model_msgpack(str(pkg / 'crop_model.msgpack'))['variables'])
    for name, value in final['ema_params'].items():
        np.testing.assert_array_equal(exported[name].numpy(), value.numpy(), err_msg=name)
    assert json.loads((pkg / 'manifest.json').read_text())['bone_mean_lengths']


def test_replicate_broadcasts_rank_0(two_ranks):
    for got in two_ranks['replicated']:
        np.testing.assert_array_equal(got['a'], np.zeros(3, np.float32))
        np.testing.assert_array_equal(got['b'][0], np.arange(4))


def test_nccl_unavailable_raises_without_switching_backend():
    assert mesh_mod.default_backend('cpu') == 'gloo'
    assert mesh_mod.default_backend('cuda:1') == 'nccl'
    with pytest.raises(RuntimeError, match='NCCL backend is not available'):
        mesh_mod.init_process_group('nccl', f'tcp://localhost:{td.free_port()}', 0, 1)
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match='torchrun'):
        mesh_mod.init_distributed()


def test_validate_distributed_cpu_torch_script():
    """scripts/validate_distributed_cpu_torch.py: two gloo processes, three
    steps on different local data, equal parameters, disjoint and covering
    example streams."""
    import subprocess
    import sys
    proc = subprocess.run([sys.executable, 'scripts/validate_distributed_cpu_torch.py'],
                          cwd=td.REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert 'DISTRIBUTED CPU VALIDATION OK' in proc.stdout
