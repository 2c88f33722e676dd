"""The training app (`metrabs_tpu/apps/train.py`): trains a crop model from
example pickles (one per dataset, round-robin mixed) through the data layer,
checkpoints, resumes, validates and exports a package that serves.

  python -m metrabs_tpu_torch.apps.train \\
      --ds3d h36m.pkl,muco.pkl --ds2d mpii.pkl,coco.pkl \\
      --checkpoint-dir runs/exp1 --training-steps 400000 \\
      --backbone efficientnetv2-s [--sections 4,6 --sections2d 8,8] ...

The flags and their defaults are the JAX app's, plus `--device` (default
`cuda`; the app raises without CUDA unless another device is named). The
multi-device flags (`--distributed`, `--model-parallel` above 1,
`--tp-min-size`) raise SystemExit: the port trains on one device. The
pickles may come from either package (`data.loading.load_examples`).

`train_log.jsonl` in the checkpoint directory gets one record per log
period (the mean loss is the last step's; `steps_per_sec` covers the steps
and their data feed, not validation or checkpointing) and one per
validation (`val_*` metrics and its `seconds`).
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import os
import time

import numpy as np
import torch

from metrabs_tpu_torch.config import AugConfig, ModelConfig, TrainConfig
from metrabs_tpu_torch.io import weights
from metrabs_tpu_torch.io.checkpoints import load_model_msgpack
from metrabs_tpu_torch.models.metrabs import set_last_point_weights_
from metrabs_tpu_torch.train.loop import TrainState


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--ds3d', required=True, help='comma-separated Example3D pickles')
    p.add_argument('--ds2d', required=True, help='comma-separated Example2D pickles')
    p.add_argument('--sections', default=None,
                   help='round-robin counts per 3D dataset (default: equal split)')
    p.add_argument('--sections2d', default=None)
    p.add_argument('--checkpoint-dir', required=True)
    p.add_argument('--backbone', default='efficientnetv2-s')
    p.add_argument('--proc-side', type=int, default=256)
    p.add_argument('--depth', type=int, default=8)
    p.add_argument('--n-joints', type=int, default=17)
    p.add_argument('--batch-size', type=int, default=32)
    p.add_argument('--batch-size-2d', type=int, default=32)
    p.add_argument('--training-steps', type=int, default=400_000)
    p.add_argument('--base-learning-rate', type=float, default=2.121e-4)
    p.add_argument('--grad-accum-steps', type=int, default=1)
    p.add_argument('--ema-momentum', type=float, default=1.0)
    p.add_argument('--constrain-kernel-norm', type=float, default=float('inf'),
                   help='max-norm projection of conv kernels after each update; inf '
                        '(default) = off')
    p.add_argument('--dual-finetune-lr', action='store_true')
    p.add_argument('--ghost-bn-splits', type=int, default=1)
    p.add_argument('--seed', type=int, default=1)
    p.add_argument('--workers', type=int, default=12)
    p.add_argument('--checkpoint-period', type=int, default=2000)
    p.add_argument('--log-period', type=int, default=100)
    p.add_argument('--ds3d-val', default=None,
                   help='held-out Example3D pickle for periodic in-training validation')
    p.add_argument('--validate-period', type=int, default=0,
                   help='run the validation metric pass every N optimizer steps (0 = off)')
    p.add_argument('--batch-size-test', type=int, default=150)
    p.add_argument('--load-path', default=None)
    p.add_argument('--init-path', default=None)
    p.add_argument('--load-backbone-from', default=None,
                   help='package dir (or crop_model.msgpack): warm-start the backbone from '
                        'an exported crop model, grafting the source head joints into the '
                        'last head slots; skipped for --transform-coords')
    p.add_argument('--export-dir', default=None)
    p.add_argument('--dtype', default='bfloat16')
    p.add_argument('--finetune-in-inference-mode', type=int, default=0,
                   help='freeze BN to inference mode for the final N steps')
    p.add_argument('--no-remat', action='store_true',
                   help='disable backbone block rematerialization (on by default: fewer '
                        'stored activations for a recompute in the backward pass)')
    p.add_argument('--optimizer-mu-dtype', default='',
                   help="Adam first-moment dtype, e.g. 'bfloat16' (second moment stays "
                        "float32)")
    p.add_argument('--distributed', action='store_true',
                   help='multi-process training: not ported (one device), raises')
    p.add_argument('--model-parallel', type=int, default=1,
                   help='model-axis extent: only 1 is ported, other values raise')
    p.add_argument('--tp-min-size', type=int, default=None,
                   help='smallest kernel sharded over the model axis (JAX default 65536): '
                        'not ported, raises when given')
    p.add_argument('--absloss-factor', type=float, default=None,
                   help='weight of the absolute-pose loss once active (default 0.1)')
    p.add_argument('--absloss-start-step', type=int, default=None,
                   help='optimizer step after which the absolute-pose loss switches on '
                        '(default 5000); must be < --training-steps for the absolute '
                        'channel to train at all')
    p.add_argument('--model-class', default='metrabs',
                   choices=('metrabs', 'metro', 'model25d'),
                   help='crop-model architecture: metrabs (absolute, default), metro '
                        '(root-relative only), model25d (2.5D head + bone-length depth)')
    p.add_argument('--bone-lengths', default=None,
                   help="model25d: npz with `lengths` [n_bones] ideal bone lengths in mm, "
                        "optionally `bones` [n_bones, 2] joint-index pairs")
    # Latent-joint / manifold fine-tuning: all three modes need
    # --affine-weights (npz with w1 [J,L] encode, w2 [L,J] decode).
    p.add_argument('--affine-weights', default=None)
    p.add_argument('--transform-coords', action='store_true')
    p.add_argument('--predict-all-and-latents', action='store_true')
    p.add_argument('--regularize-to-manifold', action='store_true')
    # Augmentation hyperparameters (defaults = LoadConfig's).
    p.add_argument('--no-geom-aug', action='store_true',
                   help='disable rotation/scale/shift/flip augmentation')
    p.add_argument('--no-color-aug', action='store_true')
    p.add_argument('--rot-aug-degrees', type=float, default=None)
    p.add_argument('--scale-aug-up', type=float, default=None)
    p.add_argument('--scale-aug-down', type=float, default=None)
    p.add_argument('--shift-aug', type=float, default=None)
    p.add_argument('--occlude-aug-prob', type=float, default=None)
    p.add_argument('--occlude-aug-prob-2d', type=float, default=None)
    p.add_argument('--background-aug-prob', type=float, default=None)
    p.add_argument('--partial-visibility-prob', type=float, default=None)
    p.add_argument('--device', default='cuda',
                   help="the device to train on (default cuda; 'cpu' for a CPU run)")
    return p.parse_args(argv)


def build_load_config(args):
    """LoadConfig from CLI overrides (None = keep the default)."""
    from metrabs_tpu_torch.data.loading import LoadConfig

    overrides = {}
    if args.no_geom_aug:
        overrides['geom_aug'] = False
    if args.no_color_aug:
        overrides['color_aug'] = False
    for field in ('rot_aug_degrees', 'scale_aug_up', 'scale_aug_down',
                  'shift_aug', 'occlude_aug_prob', 'occlude_aug_prob_2d',
                  'background_aug_prob', 'partial_visibility_prob'):
        value = getattr(args, field)
        if value is not None:
            overrides[field] = value
    return LoadConfig(**overrides)


def warm_start_backbone(state: TrainState, path: str, cfg: ModelConfig,
                        apply_head_surgery: bool) -> TrainState:
    """Grafts the backbone parameters and BatchNorm statistics of an exported
    crop model (a package directory, or its `crop_model.msgpack`) into
    `state`'s model, in place, and resets the EMA to the parameters. A
    scanned-layout source is unrolled first. With `apply_head_surgery` (the
    Metrabs heads other than `transform_coords`), the source's Metrabs head
    goes into the last slots of this head (`set_last_point_weights_`), so a
    model with more joints fine-tunes from one with fewer; a source without
    a Metrabs head leaves the head as it is. Raises SystemExit where the
    source's backbone does not match this one's.

    The surgery fills the head's own point count: JAX's warm start passes
    `cfg.n_joints`, which for a `predict_all_and_latents` head (n_latents +
    n_joints points) fails to reshape."""
    path = os.path.join(path, 'crop_model.msgpack') if os.path.isdir(path) else path
    loaded = weights.scanned_to_flat(load_model_msgpack(path)['variables'])
    model = state.model
    own = model.state_dict()
    is_stat = lambda name: name.endswith(('running_mean', 'running_var'))
    for collection in ('params', 'batch_stats'):
        source = loaded.get(collection, {})
        if 'backbone' not in source:
            continue
        grafted = weights.torch_state_dict_from_flax({collection: {'backbone': source['backbone']}})
        target = {k: v for k, v in own.items() if k.startswith('backbone.')
                  and is_stat(k) == (collection == 'batch_stats')}
        if (grafted.keys() != target.keys()
                or any(grafted[k].shape != target[k].shape for k in target)):
            raise SystemExit(f'--load-backbone-from: {collection}/backbone tree does not match '
                             f'the configured backbone ({cfg.backbone})')
        with torch.no_grad():
            for name, tensor in grafted.items():
                target[name].copy_(tensor)
    if apply_head_surgery:
        conv = loaded.get('params', {}).get('heatmap_heads', {}).get('conv_final')
        if conv is None:
            print('load-backbone-from: source has no metrabs head; backbone grafted, head '
                  'left at init', flush=True)
        else:
            head = weights.torch_state_dict_from_flax({'params': {'conv_final': conv}})
            set_last_point_weights_(model.heatmap_heads, head['conv_final.weight'],
                                    head['conv_final.bias'])
    state.ema_params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return state


def init_like_flax_(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Initialises `model`'s weights in place as flax's defaults do, from
    `seed`: convolution and dense kernels LeCun-normal (a normal of variance
    1 / fan-in truncated at two standard deviations), biases zero; the
    normalisation layers keep their unit scale and zero shift."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (torch.nn.Conv2d, torch.nn.Linear)):
                fan_in = module.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                torch.nn.init.trunc_normal_(module.weight, 0.0, std, -2 * std, 2 * std,
                                            generator=gen)
                if module.bias is not None:
                    module.bias.zero_()
    return model


def _multi_device_refused(args):
    if args.distributed:
        raise SystemExit('--distributed: multi-process training is not ported (one device; '
                         'ROADMAP.md)')
    if args.model_parallel != 1:
        raise SystemExit(f'--model-parallel {args.model_parallel}: model parallelism is not '
                         f'ported (one device; ROADMAP.md)')
    if args.tp_min_size is not None:
        raise SystemExit('--tp-min-size: model parallelism is not ported (one device; '
                         'ROADMAP.md)')


def main(argv=None):
    args = parse_args(argv)
    _multi_device_refused(args)

    from metrabs_tpu_torch.data.loading import (load_and_transform2d, load_and_transform3d,
                                                load_examples)
    from metrabs_tpu_torch.data.pipeline import (ParallelBatchLoader, device_prefetch,
                                                 roundrobin_iterate)
    from metrabs_tpu_torch.eval.harness import evaluate_predictions, predict_dataset
    from metrabs_tpu_torch.io.checkpoints import CheckpointManager, restore_train_state
    from metrabs_tpu_torch.io.packaging import save_pose_estimator_package
    from metrabs_tpu_torch.models.backbones.builder import build_backbone
    from metrabs_tpu_torch.models.metrabs import build_crop_model
    from metrabs_tpu_torch.pipeline.estimator import checked_device
    from metrabs_tpu_torch.pipeline.plausibility import BoneLengthStats
    from metrabs_tpu_torch.pipeline.skeletons import H36M_17, LSP_14, SkeletonRegistry
    from metrabs_tpu_torch.train import loop as loop_mod, optim

    device = checked_device(args.device)
    cfg = ModelConfig(
        proc_side=args.proc_side, depth=args.depth, n_joints=args.n_joints,
        dtype=args.dtype, backbone=args.backbone, backbone_scan_blocks=False,
        backbone_remat=not args.no_remat)
    tcfg = TrainConfig(
        batch_size=args.batch_size, batch_size_2d=args.batch_size_2d,
        training_steps=args.training_steps,
        base_learning_rate=args.base_learning_rate,
        grad_accum_steps=args.grad_accum_steps,
        ema_momentum=args.ema_momentum, dual_finetune_lr=args.dual_finetune_lr,
        ghost_bn_splits=(args.ghost_bn_splits,), seed=args.seed,
        finetune_in_inference_mode=args.finetune_in_inference_mode,
        optimizer_mu_dtype=args.optimizer_mu_dtype,
        transform_coords=args.transform_coords,
        predict_all_and_latents=args.predict_all_and_latents,
        regularize_to_manifold=args.regularize_to_manifold,
        constrain_kernel_norm=args.constrain_kernel_norm,
        batch_size_test=args.batch_size_test,
        **{k: v for k, v in (('absloss_factor', args.absloss_factor),
                             ('absloss_start_step', args.absloss_start_step))
           if v is not None})
    if (args.model_class == 'metrabs'
            and tcfg.absloss_start_step >= args.training_steps * args.grad_accum_steps):
        print(f'WARNING: absloss_start_step ({tcfg.absloss_start_step}) >= total steps '
              f'({args.training_steps * args.grad_accum_steps}) — the ABSOLUTE-pose loss will '
              f'never activate in this run (pass --absloss-start-step < total steps)',
              flush=True)

    affine_weights = None
    latent_mode = ''
    if args.transform_coords:
        latent_mode = 'transform_coords'
    elif args.predict_all_and_latents:
        latent_mode = 'predict_all_and_latents'
    if args.model_class != 'metrabs' and (latent_mode or args.regularize_to_manifold):
        raise SystemExit('latent/manifold modes apply to the metrabs model class only')
    if latent_mode or args.regularize_to_manifold:
        if not args.affine_weights:
            raise SystemExit('--affine-weights is required for latent/manifold modes')
        affine_weights = loop_mod.load_affine_weights(args.affine_weights)
        n_latents = affine_weights['recombination_weights'].shape[0]
    else:
        n_latents = 0

    # Joint sets: 3D = the model's joints (H36M-17), 2D = LSP-14-compatible
    # weak annotations.
    joint_info3d, joint_info2d = H36M_17, LSP_14
    lists3d = [load_examples(path) for path in args.ds3d.split(',')]
    lists2d = [load_examples(path) for path in args.ds2d.split(',')]
    rng_np = np.random.default_rng(args.seed)

    def sections(spec, n_lists, total):
        if spec:
            out = [int(x) for x in spec.split(',')]
            if len(out) != n_lists or sum(out) != total:
                raise SystemExit(f'sections {out} must be {n_lists} counts summing to {total}')
            return out
        base = total // n_lists
        out = [base] * n_lists
        out[0] += total - base * n_lists
        return out

    it3d = roundrobin_iterate(
        lists3d, sections(args.sections, len(lists3d), args.batch_size), rng_np)
    it2d = roundrobin_iterate(
        lists2d, sections(args.sections2d, len(lists2d), args.batch_size_2d), rng_np)

    # The crop model (`main.py:177-180`), initialised from the seed.
    model_kwargs = dict(model_class=args.model_class)
    bones_25d = bone_lengths_ideal = None
    if args.model_class == 'metrabs':
        model_kwargs.update(latent_mode=latent_mode, n_latents=n_latents)
    elif args.model_class == 'model25d':
        if not args.bone_lengths:
            raise SystemExit('--bone-lengths (npz) is required for --model-class model25d')
        bl = np.load(args.bone_lengths)
        bones_25d = (tuple(tuple(map(int, b)) for b in bl['bones'])
                     if 'bones' in bl else joint_info3d.edges)
        bone_lengths_ideal = tuple(float(x) for x in bl['lengths'])
        if len(bone_lengths_ideal) != len(bones_25d):
            raise SystemExit(f'{len(bone_lengths_ideal)} bone lengths for {len(bones_25d)} '
                             f'bones')
        model_kwargs.update(bones=bones_25d, bone_lengths_ideal=bone_lengths_ideal)
    model = init_like_flax_(build_crop_model(
        cfg, functools.partial(build_backbone, ghost_splits=args.ghost_bn_splits),
        **model_kwargs), args.seed)
    if latent_mode:
        # The deployed model decodes latent points with the autoencoder's
        # weights (the package's constants).
        with torch.no_grad():
            for name in ('recombination_weights', 'encoder_weights'):
                getattr(model, name).copy_(torch.from_numpy(affine_weights[name]))
    optimizer = optim.Optimizer(tcfg)
    state = loop_mod.create_train_state(model, optimizer, device=device)
    if args.load_backbone_from:
        # Warm start at build; a checkpoint restored below takes precedence.
        state = warm_start_backbone(
            state, args.load_backbone_from, cfg,
            apply_head_surgery=(args.model_class == 'metrabs' and not args.transform_coords))
        print(f'warm-started backbone from {args.load_backbone_from}', flush=True)

    def make_step(**kwargs):
        if args.model_class == 'metrabs':
            return loop_mod.make_train_step(model, optimizer, joint_info3d, joint_info2d, cfg,
                                            tcfg, affine_weights=affine_weights, **kwargs)
        maker = dict(metro=loop_mod.make_train_step_metro,
                     model25d=loop_mod.make_train_step_model25d)[args.model_class]
        return maker(model, optimizer, joint_info3d, joint_info2d, cfg, tcfg, **kwargs)

    step_fn = make_step()
    # The final phase's step with BN frozen in inference mode, switched in by
    # step index below.
    step_fn_inf = make_step(bn_inference=True) if tcfg.finetune_in_inference_mode else None

    # Checkpoint restore (precedence: load_path > latest > init_path).
    manager = CheckpointManager(args.checkpoint_dir, save_interval_steps=args.checkpoint_period)
    restored, start_step = restore_train_state(manager, state, load_path=args.load_path,
                                               init_path=args.init_path)
    if restored is not None:
        state = restored
        print(f'restored checkpoint at step {state.step}', flush=True)

    log_path = os.path.join(args.checkpoint_dir, 'train_log.jsonl')
    os.makedirs(args.checkpoint_dir, exist_ok=True)

    def log(rec):
        print(json.dumps(rec), flush=True)
        with open(log_path, 'a') as f:
            f.write(json.dumps(rec) + '\n')

    lcfg = build_load_config(args)
    loader3 = ParallelBatchLoader(
        lambda ex, r: load_and_transform3d(ex, joint_info3d, True, r, cfg, lcfg),
        it3d, batch_size=args.batch_size, n_workers=args.workers, seed=args.seed)
    loader2 = ParallelBatchLoader(
        lambda ex, r: load_and_transform2d(ex, joint_info2d, True, r, cfg, lcfg),
        it2d, batch_size=args.batch_size_2d, n_workers=args.workers, seed=args.seed + 1)

    def batch_fields(b, keys):
        return {k: v for k, v in b.items() if k in keys}

    # model25d also supervises the 2D pixel coordinates of the 3D batch.
    feed3_keys = ('image', 'intrinsics', 'coords3d_true', 'joint_validity_mask')
    if args.model_class == 'model25d':
        feed3_keys += ('coords2d_true',)
    # Dataset mean bone lengths from the ground-truth batches as they stream
    # by, shipped in the package as plausibility priors.
    bone_stats = BoneLengthStats(joint_info3d.edges)

    def accumulate_bones(gen):
        for b in gen:
            bone_stats.update(b['coords3d_true'], b['joint_validity_mask'])
            yield b

    feed3 = device_prefetch(
        accumulate_bones(batch_fields(b, feed3_keys) for b in loader3), device)
    feed2 = device_prefetch(
        (batch_fields(b, ('image', 'intrinsics', 'coords2d_true', 'joint_validity_mask'))
         for b in loader2), device)

    # Periodic validation over a held-out 3D set: a forward-only metric pass
    # through `predict_dataset`, logged beside the training losses.
    val_examples = None
    if args.ds3d_val and args.validate_period:
        if args.model_class != 'metrabs':
            raise SystemExit('--ds3d-val validation supports the metrabs crop model '
                             '(absolute metrics)')
        val_examples = load_examples(args.ds3d_val)

    def run_validation(step_idx):
        start = time.time()
        model.eval()
        preds = predict_dataset(
            lambda crops, intrinsics, valid: model(crops, intrinsics, sample_valid=valid),
            val_examples, joint_info3d, cfg, batch_size=tcfg.batch_size_test,
            n_workers=args.workers, device=device)
        metrics = evaluate_predictions(preds, joint_info=joint_info3d, device=device)
        log(dict(step=step_idx, **{f'val_{k}': v for k, v in metrics.items()},
                 seconds=time.time() - start))

    total_steps = args.training_steps * args.grad_accum_steps
    # Step index at which BN switches to frozen inference mode.
    switch_step = total_steps + 1
    if tcfg.finetune_in_inference_mode:
        switch_step = ((args.training_steps - tcfg.finetune_in_inference_mode)
                       * args.grad_accum_steps)
    generator = (torch.Generator(device=device) if device.type == 'cuda'
                 else torch.Generator())
    try:
        t_last = time.time()
        for i in range(state.step, total_steps):
            b3 = next(feed3)
            b2 = next(feed2)
            active_step = step_fn_inf if i >= switch_step else step_fn
            # The step's randomness depends on its index alone, as JAX's
            # fold_in(rng, i) does, so a resumed run repeats it.
            generator.manual_seed((args.seed + 2) * 1_000_003 + i)
            losses = active_step(state, b3, b2, generator=generator)
            if (i + 1) % args.log_period == 0:
                loss = float(losses['loss'])
                log(dict(step=i + 1, loss=loss,
                         steps_per_sec=args.log_period / (time.time() - t_last)))
                t_last = time.time()
            pause = time.time()
            if (val_examples is not None
                    and (i + 1) % (args.validate_period * args.grad_accum_steps) == 0):
                run_validation(i + 1)
            manager.save(i + 1, state)
            t_last += time.time() - pause
    finally:
        # Save on the way out, also off the checkpoint interval.
        if manager.latest_step() != state.step:
            manager.save(state.step, state, force=True)
        loader3.close()
        loader2.close()

    if args.export_dir:
        state_dict = (state.ema_state_dict() if tcfg.ema_momentum < 1
                      else state.model.state_dict())
        variables = weights.flax_variables_from_state_dict(state_dict)
        # Dataset mean bone lengths where the run saw ground truth for every
        # edge; otherwise none, and the estimator warns at load time.
        bone_means = bone_stats.mean_lengths()
        if bone_stats.n_samples == 0 or not np.isfinite(bone_means).all():
            bone_means = None
        save_pose_estimator_package(
            args.export_dir, cfg=cfg, aug_cfg=AugConfig(), crop_model_variables=variables,
            joint_info=joint_info3d, skeleton_registry=SkeletonRegistry(joint_info3d),
            latent_mode=latent_mode, n_latents=n_latents, model_class=args.model_class,
            bones_25d=bones_25d, bone_lengths_ideal=bone_lengths_ideal,
            bone_mean_lengths=bone_means)
        print(f'exported package to {args.export_dir}', flush=True)


if __name__ == '__main__':
    main()
