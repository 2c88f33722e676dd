"""The training app (`metrabs_tpu/apps/train.py`), its first piece:
`warm_start_backbone`, the backbone warm start of `--load-backbone-from`.

The app's `main`, `parse_args` and `build_load_config` drive the data layer
(example loading, augmentation, image warps) and come with it.
"""

from __future__ import annotations

import os

import torch

from metrabs_tpu_torch.config import ModelConfig
from metrabs_tpu_torch.io import weights
from metrabs_tpu_torch.io.checkpoints import load_model_msgpack
from metrabs_tpu_torch.models.metrabs import set_last_point_weights_
from metrabs_tpu_torch.train.loop import TrainState


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
