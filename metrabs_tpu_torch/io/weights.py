"""Carries packaged JAX variable trees across to the port's modules.

Plain-numpy versions of the two serving-time layout transforms of the JAX
package, which cannot be imported here because they reach flax:
`scanned_to_flat` (`metrabs_tpu/io/scan_convert.py`) and
`fold_bn_variables` (`metrabs_tpu/io/bn_fold.py`), both on nested dicts of
numpy arrays. Then `crop_model_state_dict_from_flax` maps the flat tree onto
the state_dict of the port's crop model of any class and backbone family:
conv kernels HWIO [kh, kw, I, O] -> OIHW (depthwise [k, k, 1, E] -> [E, 1,
k, k]), BatchNorm scale/bias/mean/var -> weight/bias/running_mean/
running_var, GroupNorm's `gn` scale/bias -> weight/bias, and the latent
modes' `constants` collection -> the model's float32 buffers.

The detector's half: `yolo_scanned_to_flat` unrolls YOLOv4's scanned
residual groups (the inverse of `metrabs_tpu/detect/yolov4.py::
yolo_flat_to_scanned`; a YOLOv8 tree, which has none, passes unchanged),
and `detector_state_dict_from_flax` maps the flat tree onto the port's
detector modules.

Training's half: `flax_train_state_dict` and `load_flax_train_state` carry a
JAX `TrainState` across in both directions, in the form
`flax.serialization.to_state_dict` gives it (nested dicts of numpy arrays;
the JAX side restores with `from_state_dict(template, ...)`): params and
batch_stats, the Adam moments and counts of `optax.adamw` (inside
`multi_transform` for dual LR, inside `MultiSteps` for accumulation), mapped
with the parameters' transposes, and the EMA parameters.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from metrabs_tpu_torch.config import ModelConfig
from metrabs_tpu_torch.models.metrabs import build_crop_model

Key = Tuple[str, ...]

_SCAN_GROUP = re.compile(r'blocks_(\d+)_scan(\d+)$')
_FLAT_BLOCK = re.compile(r'blocks_(\d+)$')
_YOLO_SCAN_GROUP = re.compile(r'res_scan_(\d+)_(\d+)$')

# The one BN epsilon each foldable family uses throughout.
_BN_EPSILONS = {'efficientnetv2': 1e-3, 'mobilenetv3': 1e-3, 'resnet': 1e-5}


def flatten_dict(tree: Dict, prefix: Key = ()) -> Dict[Key, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten_dict(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def unflatten_dict(flat: Dict[Key, np.ndarray]) -> Dict:
    tree: Dict = {}
    for key, value in flat.items():
        node = tree
        for part in key[:-1]:
            node = node.setdefault(part, {})
        node[key[-1]] = value
    return tree


def scanned_to_flat(variables: Dict) -> Dict:
    """Splits every `.../blocks_{s}_scan{n}/block/...` stacked leaf (leading
    axis n) into n flat `.../blocks_{s+i}/...` leaves, at any depth and in
    any collection; other keys pass through."""
    out = {}
    for key, value in flatten_dict(variables).items():
        hits = [(j, m) for j, part in enumerate(key)
                if (m := _SCAN_GROUP.match(part))]
        if not hits:
            out[key] = value
            continue
        if len(hits) > 1:
            raise ValueError(f'Nested scan groups at {key}')
        j, m = hits[0]
        start, n = int(m.group(1)), int(m.group(2))
        if j + 1 >= len(key) or key[j + 1] != 'block':
            raise ValueError(f'Scan group {key} lacks the "block" wrapper')
        if value.shape[0] != n:
            raise ValueError(f'Leading axis {value.shape[0]} != scan length {n} at {key}')
        for i in range(n):
            out[key[:j] + (f'blocks_{start + i}',) + key[j + 2:]] = value[i]
    return unflatten_dict(out)


def _conv_candidates(bn_name: str) -> Iterator[str]:
    """Sibling module names that may hold the conv feeding `bn_name`, by the
    naming conventions of the JAX package's conv->BN families."""
    if bn_name == 'bn':
        yield 'conv'
    if bn_name.endswith('_bn'):
        base = bn_name[:-3]
        yield base
        yield base + '_conv'
    if bn_name.startswith('bn') and bn_name[2:].isdigit():
        yield 'conv' + bn_name[2:]
    if bn_name == 'norm0':
        yield 'expand_conv'
    if bn_name == 'norm1':
        yield 'depthwise_conv'
        yield 'project_conv'
    if bn_name == 'norm2':
        yield 'project_conv'


def _find_conv_kernel_key(params: Dict[Key, np.ndarray], parent: Key, bn_name: str):
    for cand in _conv_candidates(bn_name):
        for key in (parent + (cand, 'kernel'), parent + (cand, 'conv', 'kernel')):
            if key in params:
                return key
    return None


def fold_bn_variables(variables: Dict, epsilon: float) -> Dict:
    """Folds every inference BN into its feeding conv: kernel' = kernel * g,
    bias' = beta - mean * g (+ old bias * g) with g = gamma / sqrt(var + eps).
    float64 arithmetic, cast back to the stored dtype; BN leaves removed.
    Raises ValueError on a BN with no conv sibling (pre-activation BNs)."""
    params = flatten_dict(variables['params'])
    stats = flatten_dict(variables.get('batch_stats', {}))
    bn_scopes = [key[:-1] for key in params
                 if len(key) >= 3 and key[-2:] == ('bn', 'scale')]
    for scope in bn_scopes:  # (..., bn_name, 'bn')
        parent, bn_name = scope[:-2], scope[-2]
        kernel_key = _find_conv_kernel_key(params, parent, bn_name)
        if kernel_key is None:
            kernel_key = _find_conv_kernel_key(params, scope[:-1], 'bn')
        if kernel_key is None:
            raise ValueError(
                f'BN at {"/".join(scope)} has no conv sibling to fold into; '
                f'candidates tried: {list(_conv_candidates(bn_name))}')
        gamma = np.asarray(params.pop(scope + ('scale',)), np.float64)
        beta = np.asarray(params.pop(scope + ('bias',)), np.float64)
        mean = np.asarray(stats.pop(scope + ('mean',)), np.float64)
        var = np.asarray(stats.pop(scope + ('var',)), np.float64)
        kernel = np.asarray(params[kernel_key])
        g = gamma / np.sqrt(var + epsilon)
        b = beta - mean * g
        g_k = g.reshape(g.shape[:-1] + (1,) * (kernel.ndim - g.ndim) + g.shape[-1:])
        params[kernel_key] = (kernel.astype(np.float64) * g_k).astype(kernel.dtype)
        bias_key = kernel_key[:-1] + ('bias',)
        if bias_key in params:
            b = b + np.asarray(params[bias_key], np.float64) * g
        params[bias_key] = b.astype(kernel.dtype)
    out = dict(variables)
    out['params'] = unflatten_dict(params)
    if 'batch_stats' in variables:
        if stats:
            out['batch_stats'] = unflatten_dict(stats)
        else:
            out.pop('batch_stats')
    return out


def bn_epsilon_for(backbone_name: str) -> float:
    name = backbone_name.lower().replace('_', '-')
    for family, eps in _BN_EPSILONS.items():
        if name.startswith(family):
            return eps
    raise ValueError(f'No BN epsilon known for backbone {backbone_name!r}')


# Metrabs' latent-mode `constants` collection: float32 buffers of the model.
_CONSTANTS = ('recombination_weights', 'encoder_weights')


def _torch_key(key: Key) -> str:
    """('params', 'backbone', 'blocks_3', 'norm0', 'bn', 'scale') ->
    'backbone.blocks.3.norm0.weight'; ('constants', name) -> name."""
    collection, *path, leaf = key
    if collection == 'constants' and not path and leaf in _CONSTANTS:
        return leaf
    parts = []
    for part in path:
        m = _FLAT_BLOCK.match(part)
        if m:
            parts += ['blocks', m.group(1)]
        elif part != 'bn':
            parts.append(part)
    names = {('params', 'kernel'): 'weight', ('params', 'bias'): 'bias',
             ('params', 'scale'): 'weight', ('batch_stats', 'mean'): 'running_mean',
             ('batch_stats', 'var'): 'running_var'}
    if (collection, leaf) not in names:
        raise ValueError(f'Unexpected variable {"/".join(key)}')
    return '.'.join(parts + [names[collection, leaf]])


def _tensor(value) -> torch.Tensor:
    value = np.asarray(value)
    if value.dtype.name == 'bfloat16':  # JAX's bfloat16 (ml_dtypes): widen exactly
        return torch.tensor(value.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(np.ascontiguousarray(value))


def torch_state_dict_from_flax(variables: Dict) -> Dict[str, torch.Tensor]:
    """Torch names and layouts of a flat-layout JAX variable tree (any of
    its collections; conv kernels HWIO -> OIHW), unchecked."""
    state = {}
    for key, value in flatten_dict(variables).items():
        tensor = _tensor(value)
        if key[-1] == 'kernel':
            tensor = tensor.permute(3, 2, 0, 1).contiguous()  # HWIO -> OIHW
        state[_torch_key(key)] = tensor
    return state


def crop_model_state_dict_from_flax(variables: Dict, cfg: ModelConfig,
                                    **crop_model_kwargs) -> Dict[str, torch.Tensor]:
    """The state_dict of the port's crop model `build_crop_model(cfg,
    **crop_model_kwargs)` (model class, latent mode) from a flat-layout JAX
    variable tree (numpy leaves) of the same model (`cfg.bn_fold` picks the
    BN layout). Raises ValueError on a leftover, missing or misshapen
    entry."""
    with torch.device('meta'):
        expected = build_crop_model(cfg, **crop_model_kwargs).state_dict()
    state = torch_state_dict_from_flax(variables)
    missing = sorted(set(expected) - set(state))
    leftover = sorted(set(state) - set(expected))
    if missing or leftover:
        raise ValueError(f'Variable tree does not match the crop model: missing '
                         f'{missing[:8]}, leftover {leftover[:8]}')
    for name, tensor in state.items():
        if tensor.shape != expected[name].shape:
            raise ValueError(f'Shape mismatch at {name}: {tuple(tensor.shape)} vs '
                             f'{tuple(expected[name].shape)}')
    return state


def _is_bare_bn(parts) -> bool:
    """Whether the norm module at `parts` is flax's BatchNorm or GroupNorm
    itself (a detector's `bn`, GroupNormCompat's `gn`, the tiny backbone's
    `bn<i>`) rather than the JAX package's GhostBatchNorm, which wraps one
    named `bn`."""
    return (parts[-1] in ('bn', 'gn')
            or (len(parts) == 2 and parts[0] == 'backbone' and parts[1].startswith('bn')))


def flax_variables_from_state_dict(state: Dict[str, torch.Tensor]) -> Dict:
    """Inverse of `crop_model_state_dict_from_flax` and of
    `detector_state_dict_from_flax`: a flat-layout JAX-style variable tree
    (numpy leaves) from a port crop model's or detector's state_dict."""
    flat = {}
    for name, tensor in state.items():
        if name in _CONSTANTS:
            flat[('constants', name)] = tensor.detach().cpu().float().numpy()
            continue
        *path, leaf = name.split('.')
        parts = []
        i = 0
        while i < len(path):
            if path[i] == 'blocks':
                parts.append(f'blocks_{path[i + 1]}')
                i += 2
            else:
                parts.append(path[i])
                i += 1
        value = tensor.detach().cpu().float().numpy()
        # Norm modules: the BNs (bn, bn<k>, norm<k>, <name>_bn) and `gn`.
        is_norm = (parts[-1] == 'gn' or parts[-1].startswith(('bn', 'norm'))
                   or parts[-1].endswith('_bn'))
        bn_scope = parts if _is_bare_bn(parts) else parts + ['bn']
        if leaf == 'weight' and value.ndim == 4:
            flat[('params', *parts, 'kernel')] = value.transpose(2, 3, 1, 0)
        elif leaf in ('running_mean', 'running_var'):
            flat[('batch_stats', *bn_scope, leaf[len('running_'):])] = value
        elif leaf == 'weight':
            flat[('params', *bn_scope, 'scale')] = value
        elif is_norm:
            flat[('params', *bn_scope, 'bias')] = value
        else:
            flat[('params', *parts, 'bias')] = value
    return unflatten_dict(flat)


def _params_tree(named: Dict[str, torch.Tensor]) -> Dict:
    return flax_variables_from_state_dict(named).get('params', {}) if named else {}


def flax_train_state_dict(state) -> Dict:
    """A port `train.loop.TrainState` as the state dict of the JAX
    `TrainState` of the same optimizer configuration. Parameters outside an
    Adam group of the dual-LR optimizer are optax's MaskedNode, {} here.
    A bfloat16 first moment comes out as float32 (exactly)."""
    params = dict(state.model.named_parameters())
    variables = flax_variables_from_state_dict(state.model.state_dict())
    keys = list(flatten_dict(_params_tree(params)))

    def masked_tree(named):
        flat = flatten_dict(_params_tree(named))
        return unflatten_dict({k: flat.get(k, {}) for k in keys})

    def adam(a):
        count = np.int32(a.count)
        return {'0': {'count': count, 'mu': masked_tree(a.mu), 'nu': masked_tree(a.nu)},
                '1': {}, '2': {'count': count}}

    opt = state.opt_state
    opt_sd = (adam(opt.groups['all']) if 'all' in opt.groups
              else {'inner_states': {g: {'inner_state': adam(a)} for g, a in opt.groups.items()}})
    if opt.acc_grads is not None:
        opt_sd = {'acc_grads': _params_tree(opt.acc_grads),
                  'gradient_step': np.int32(opt.gradient_step), 'inner_opt_state': opt_sd,
                  'mini_step': np.int32(opt.mini_step), 'skip_state': {}}
    return {'step': np.int32(state.step), 'params': variables['params'],
            'batch_stats': variables.get('batch_stats', {}), 'opt_state': opt_sd,
            'ema_params': _params_tree(state.ema_params)}


def load_flax_train_state(state, flax_state: Dict) -> None:
    """Loads the state dict of a JAX `TrainState` (`flax.serialization.
    to_state_dict`, numpy leaves) into the port's `state` of the same model
    and optimizer configuration, in place. Raises ValueError where the trees
    do not match. A latent model's constants are no part of JAX's
    `TrainState` (its train step takes them apart): the model keeps its
    own."""
    model_state = torch_state_dict_from_flax(
        {'params': flax_state['params'], 'batch_stats': flax_state.get('batch_stats', {})})
    model_state.update({k: v for k, v in state.model.state_dict().items() if k in _CONSTANTS})
    state.model.load_state_dict(model_state)

    @torch.no_grad()
    def copy_into(dst: Dict[str, torch.Tensor], tree: Dict, what: str):
        src = torch_state_dict_from_flax({'params': tree})
        if src.keys() != dst.keys():
            raise ValueError(f'{what}: parameters {sorted(set(src) ^ set(dst))[:8]} are in '
                             f'one tree only')
        for name, t in src.items():
            dst[name].copy_(t)

    copy_into(state.ema_params, flax_state['ema_params'], 'ema_params')
    opt, opt_sd = state.opt_state, flax_state['opt_state']
    if opt.acc_grads is not None:
        opt.mini_step = int(opt_sd['mini_step'])
        opt.gradient_step = int(opt_sd['gradient_step'])
        copy_into(opt.acc_grads, opt_sd['acc_grads'], 'acc_grads')
        opt_sd = opt_sd['inner_opt_state']
    for group, adam in opt.groups.items():
        adam_sd = opt_sd if group == 'all' else opt_sd['inner_states'][group]['inner_state']
        adam.count = int(adam_sd['0']['count'])
        if int(adam_sd['2']['count']) != adam.count:
            raise ValueError(f'Adam and schedule counts differ in group {group!r}')
        copy_into(adam.mu, adam_sd['0']['mu'], f'mu of {group!r}')
        copy_into(adam.nu, adam_sd['0']['nu'], f'nu of {group!r}')
    state.step = int(flax_state['step'])


def yolo_scanned_to_flat(variables: Dict) -> Dict:
    """Splits every `res_scan_<start>_<n>/{conv_a,conv_b}/...` stacked leaf
    (leading axis n) of a YOLOv4 tree into `conv_<start+2i>` (conv_a) and
    `conv_<start+2i+1>` (conv_b); other keys pass through."""
    out = {}
    for key, value in flatten_dict(variables).items():
        m = _YOLO_SCAN_GROUP.match(key[1]) if len(key) > 2 else None
        if not m:
            out[key] = value
            continue
        start, n = int(m.group(1)), int(m.group(2))
        offsets = {'conv_a': 0, 'conv_b': 1}
        if key[2] not in offsets:
            raise ValueError(f'Unexpected member {key[2]!r} of scan group {"/".join(key)}')
        if value.shape[0] != n:
            raise ValueError(f'Leading axis {value.shape[0]} != scan length {n} at {key}')
        for i in range(n):
            out[(key[0], f'conv_{start + 2 * i + offsets[key[2]]}') + key[3:]] = value[i]
    return unflatten_dict(out)


_DETECTOR_NAMES = {('params', 'kernel'): 'weight', ('params', 'bias'): 'bias',
                   ('params', 'scale'): 'weight', ('batch_stats', 'mean'): 'running_mean',
                   ('batch_stats', 'var'): 'running_var'}


def detector_state_dict_from_flax(variables: Dict, model: torch.nn.Module
                                  ) -> Dict[str, torch.Tensor]:
    """The state_dict of the port's detector `model` (built for the tree's BN
    layout, on any device, meta included) from a flat-layout JAX detector
    tree, whose module paths the port keeps: YOLOv4's `conv_<i>/{conv,bn}`,
    YOLOv8's nested `l2/m0/cv1/{conv,bn}` and `l22/cv2_0_2`. Raises
    ValueError on a leftover, missing or misshapen entry."""
    expected = model.state_dict()
    state = {}
    for key, value in flatten_dict(variables).items():
        collection, *path, leaf = key
        if not path or (collection, leaf) not in _DETECTOR_NAMES:
            raise ValueError(f'Unexpected detector variable {"/".join(key)}')
        value = np.asarray(value)
        if leaf == 'kernel':
            value = value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        state['.'.join(path + [_DETECTOR_NAMES[collection, leaf]])] = torch.tensor(
            np.ascontiguousarray(value))
    missing = sorted(set(expected) - set(state))
    leftover = sorted(set(state) - set(expected))
    if missing or leftover:
        raise ValueError(f'Variable tree does not match the detector: missing '
                         f'{missing[:8]}, leftover {leftover[:8]}')
    for name, tensor in state.items():
        if tensor.shape != expected[name].shape:
            raise ValueError(f'Shape mismatch at {name}: {tuple(tensor.shape)} vs '
                             f'{tuple(expected[name].shape)}')
    return state
