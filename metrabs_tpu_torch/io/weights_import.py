"""Weight import from the released reference models
(`metrabs_tpu/io/weights_import.py`), onto JAX-layout variable trees.

Every function takes and returns the port's JAX-style variable tree: nested
dicts of numpy arrays with the JAX package's paths (`params/backbone/
blocks_3/norm0/bn/scale`, ...), such as `io.weights.
flax_variables_from_state_dict` gives for a port model, and returns the
same tree JAX's importer returns, leaf for leaf. The tree then goes into the
port's modules through `io.weights.crop_model_state_dict_from_flax` (or into
a package through `io.packaging.save_pose_estimator_package`).

Two sources. The reference's PyTorch port's torchvision-style state_dicts
(`metrabs_pytorch/` EfficientNetV2 backbones and the 1x1 head), mapped as
the reference's own TF->PT converter does (`metrabs_pytorch/
convert_model_from_tf.py:89-202`), but PT->JAX layout: OIHW conv kernels ->
HWIO, depthwise OIHW (O=channels, I=1) -> HWIO with feature groups, BN
(weight, bias, running_mean, running_var) -> (scale, bias, mean, var). And
the TF SavedModel / checkpoint variables by name (`io.tf_checkpoint.
load_tf_checkpoint`), for the EfficientNetV2, ResNet and MobileNetV3
families and the head; with `tf_vars=None` the mapping functions return
their (path, TF name, transform) pairs for a template tree instead.

torchvision EfficientV2 layout (see `metrabs_pytorch/backbones/
efficientnet.py:295-330`): `features.0` stem conv+BN; `features.{1..S}` are
stages of MBConv/FusedMBConv whose `block` submodules are Conv2dNormActivation
/ SE / conv; `features.{S+1}` the head conv+BN. The JAX layout is flat
`blocks_{i}` in the same traversal order, so the import is a linear walk.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch

from metrabs_tpu_torch.io.weights import flatten_dict, unflatten_dict


def _flat(tree: Dict) -> Dict[str, Any]:
    """{'/'-joined path: leaf} of a variable tree."""
    return {'/'.join(key): value for key, value in flatten_dict(tree).items()}


def _unflat(flat: Dict[str, Any]) -> Dict:
    return unflatten_dict({tuple(path.split('/')): value for path, value in flat.items()})


def _numpy_state_dict(state_dict: Dict[str, Any]) -> Dict[str, np.ndarray]:
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in state_dict.items()}


def _conv_kernel(pt_weight: np.ndarray) -> np.ndarray:
    """OIHW -> HWIO. The same transpose also covers depthwise convs:
    torch [C, 1, H, W] -> feature-grouped [H, W, 1, C]."""
    return np.transpose(pt_weight, (2, 3, 1, 0))


def import_effnetv2_from_torch(
        state_dict: Dict[str, Any], flax_variables: Dict,
        backbone_scope: str = 'backbone') -> Dict:
    """Fills an EfficientNetV2 variable tree from a torchvision-style
    state_dict (as used by metrabs_pytorch). Returns updated variables.

    The walk enumerates torch keys stage by stage and assigns to the
    blocks_{i} modules in order; conv/BN sublayer roles are recognized from
    the key structure within each block.
    """
    sd = _numpy_state_dict(state_dict)
    flat = _flat(flax_variables)

    def put(path: str, value: np.ndarray):
        key = path
        if key not in flat:
            raise KeyError(f'No parameter at {key}')
        if tuple(flat[key].shape) != value.shape:
            raise ValueError(
                f'Shape mismatch at {key}: tree {tuple(flat[key].shape)} vs torch '
                f'{value.shape}')
        flat[key] = value.astype(np.asarray(flat[key]).dtype)

    bb = f'params/{backbone_scope}'
    bs = f'batch_stats/{backbone_scope}'

    # Stem: features.0 = Conv2dNormActivation(conv, bn).
    put(f'{bb}/stem_conv/kernel', _conv_kernel(sd['features.0.0.weight']))
    put(f'{bb}/stem_bn/bn/scale', sd['features.0.1.weight'])
    put(f'{bb}/stem_bn/bn/bias', sd['features.0.1.bias'])
    put(f'{bs}/stem_bn/bn/mean', sd['features.0.1.running_mean'])
    put(f'{bs}/stem_bn/bn/var', sd['features.0.1.running_var'])

    # Stages: group keys features.{s}.{b}.block.*
    stage_ids = sorted({
        int(k.split('.')[1]) for k in sd
        if k.startswith('features.') and k.split('.')[1].isdigit()})
    body_stages = stage_ids[1:-1]  # drop stem and head
    head_stage = stage_ids[-1]

    block_idx = 0
    for s in body_stages:
        b = 0
        while f'features.{s}.{b}.block.0.0.weight' in sd:
            pre = f'features.{s}.{b}.block'
            dst = f'blocks_{block_idx}'
            # Identify fused vs mbconv by sublayer shapes:
            # MBConv: block.0 expand 1x1 (or absent when e=1 -> torchvision
            # always has expand for v2 MBConv stages), block.1 depthwise,
            # block.2 SE, block.3 project.
            # FusedMBConv e!=1: block.0 kxk expand, block.1 project 1x1.
            # FusedMBConv e==1: block.0 kxk project only.
            # torchvision EffNetV2 rule: MBConv blocks have an SE at block.2
            # (fc1/fc2); FusedMBConv blocks have no SE.
            is_mbconv = f'{pre}.2.fc1.weight' in sd
            if is_mbconv:
                put(f'{bb}/{dst}/expand_conv/kernel', _conv_kernel(sd[f'{pre}.0.0.weight']))
                _bn_put(put, bb, bs, dst, 'norm0', sd, f'{pre}.0.1')
                put(f'{bb}/{dst}/depthwise_conv/kernel',
                    _conv_kernel(sd[f'{pre}.1.0.weight']))
                _bn_put(put, bb, bs, dst, 'norm1', sd, f'{pre}.1.1')
                put(f'{bb}/{dst}/se/reduce/kernel', _conv_kernel(sd[f'{pre}.2.fc1.weight']))
                put(f'{bb}/{dst}/se/reduce/bias', sd[f'{pre}.2.fc1.bias'])
                put(f'{bb}/{dst}/se/expand/kernel', _conv_kernel(sd[f'{pre}.2.fc2.weight']))
                put(f'{bb}/{dst}/se/expand/bias', sd[f'{pre}.2.fc2.bias'])
                put(f'{bb}/{dst}/project_conv/kernel', _conv_kernel(sd[f'{pre}.3.0.weight']))
                _bn_put(put, bb, bs, dst, 'norm2', sd, f'{pre}.3.1')
            else:
                has_expand = f'{pre}.1.0.weight' in sd
                if has_expand:
                    put(f'{bb}/{dst}/expand_conv/kernel',
                        _conv_kernel(sd[f'{pre}.0.0.weight']))
                    _bn_put(put, bb, bs, dst, 'norm0', sd, f'{pre}.0.1')
                    put(f'{bb}/{dst}/project_conv/kernel',
                        _conv_kernel(sd[f'{pre}.1.0.weight']))
                    _bn_put(put, bb, bs, dst, 'norm1', sd, f'{pre}.1.1')
                else:
                    put(f'{bb}/{dst}/project_conv/kernel',
                        _conv_kernel(sd[f'{pre}.0.0.weight']))
                    _bn_put(put, bb, bs, dst, 'norm1', sd, f'{pre}.0.1')
            block_idx += 1
            b += 1

    # Head: features.{last} conv+bn.
    put(f'{bb}/head_conv/kernel', _conv_kernel(sd[f'features.{head_stage}.0.weight']))
    put(f'{bb}/head_bn/bn/scale', sd[f'features.{head_stage}.1.weight'])
    put(f'{bb}/head_bn/bn/bias', sd[f'features.{head_stage}.1.bias'])
    put(f'{bs}/head_bn/bn/mean', sd[f'features.{head_stage}.1.running_mean'])
    put(f'{bs}/head_bn/bn/var', sd[f'features.{head_stage}.1.running_var'])

    return _unflat(flat)


def _bn_put(put, bb, bs, dst, norm_name, sd, pt_prefix):
    put(f'{bb}/{dst}/{norm_name}/bn/scale', sd[f'{pt_prefix}.weight'])
    put(f'{bb}/{dst}/{norm_name}/bn/bias', sd[f'{pt_prefix}.bias'])
    put(f'{bs}/{dst}/{norm_name}/bn/mean', sd[f'{pt_prefix}.running_mean'])
    put(f'{bs}/{dst}/{norm_name}/bn/var', sd[f'{pt_prefix}.running_var'])


def import_metrabs_head_from_torch(
        state_dict: Dict[str, Any], flax_variables: Dict,
        head_key: str = 'heatmap_heads') -> Dict:
    """Imports the 1x1 head conv (`metrabs_pytorch/models/metrabs.py:67-85`,
    a LazyConv2d named 'conv_final'). PT OIHW -> HWIO; channel layout
    [2d | 3d (d j)] is identical in both."""
    sd = _numpy_state_dict(state_dict)
    flat = _flat(flax_variables)
    key = next(k for k in sd if k.endswith('conv_final.weight'))
    bias_key = key.replace('.weight', '.bias')
    dst_k = f'params/{head_key}/conv_final/kernel'
    dst_b = f'params/{head_key}/conv_final/bias'
    flat[dst_k] = np.transpose(sd[key], (2, 3, 1, 0)).astype(
        np.asarray(flat[dst_k]).dtype)
    flat[dst_b] = sd[bias_key].astype(np.asarray(flat[dst_b]).dtype)
    return _unflat(flat)


# ---------------------------------------------------------------------------
# TF-side imports: reference SavedModel / checkpoint variables by NAME.
# The name->array dict comes from io/tf_checkpoint.load_tf_checkpoint; names
# follow the reference's Keras layer naming (the same space its own TF->PT
# converter maps from, `metrabs_pytorch/convert_model_from_tf.py:101-202`).
# ---------------------------------------------------------------------------


def _tf_get(tf_vars: Dict[str, np.ndarray], name: str) -> np.ndarray:
    for candidate in (name, name + ':0'):
        if candidate in tf_vars:
            return np.asarray(tf_vars[candidate])
    raise KeyError(f'TF variable {name!r} not found '
                   f'(have e.g. {sorted(tf_vars)[:3]}...)')


def _apply_mapping(tf_vars, flax_variables, pairs):
    """pairs: [(path, tf_name, transform)] with '/'-joined tree paths."""
    flat = _flat(flax_variables)
    for path, tf_name, transform in pairs:
        if path not in flat:
            raise KeyError(f'No parameter at {path}')
        value = _tf_get(tf_vars, tf_name)
        if transform is not None:
            value = transform(value)
        if tuple(flat[path].shape) != tuple(value.shape):
            raise ValueError(f'Shape mismatch at {path}: tree '
                             f'{tuple(flat[path].shape)} vs TF {value.shape}')
        flat[path] = value.astype(np.asarray(flat[path]).dtype)
    return _unflat(flat)


def _bn_pairs(flax_prefix_p, flax_prefix_s, tf_name):
    """Keras BatchNorm (gamma/beta/moving_*) -> bn (scale/bias/mean/var)."""
    return [
        (f'{flax_prefix_p}/scale', f'{tf_name}/gamma', None),
        (f'{flax_prefix_p}/bias', f'{tf_name}/beta', None),
        (f'{flax_prefix_s}/mean', f'{tf_name}/moving_mean', None),
        (f'{flax_prefix_s}/var', f'{tf_name}/moving_variance', None),
    ]


def _dw(kernel: np.ndarray) -> np.ndarray:
    """TF depthwise [h, w, c, mult=1] -> grouped-conv [h, w, 1, c]."""
    return np.transpose(kernel, (0, 1, 3, 2))


def import_effnetv2_from_tf(
        tf_vars: Dict[str, np.ndarray], flax_variables: Dict,
        model_name: str, backbone_scope: str = 'backbone') -> Dict:
    """Reference-fork EfficientNetV2 TF variables -> the tree (flat blocks_{i}).

    TF naming per `convert_model_from_tf.py:133-194`:
    `{model}/stem/conv2d/kernel`, per block `{model}/blocks_{i}/...` with
    conv2d[-_1]/depthwise_conv2d/se/conv2d[-_1] + tpu_batch_normalization
    [_1,_2], `{model}/head/conv2d/kernel`. TF kernels are already HWIO.
    """
    flat = _flat(flax_variables)
    bb = f'params/{backbone_scope}'
    bs = f'batch_stats/{backbone_scope}'
    model_name = model_name.split('-stride')[0]  # dilated variants share vars

    pairs = [(f'{bb}/stem_conv/kernel', f'{model_name}/stem/conv2d/kernel',
              None)]
    pairs += _bn_pairs(f'{bb}/stem_bn/bn', f'{bs}/stem_bn/bn',
                       f'{model_name}/stem/tpu_batch_normalization')

    block_ids = sorted({
        int(k.split('/')[2].split('_')[1]) for k in flat
        if k.startswith(f'{bb}/blocks_')})
    for i in block_ids:
        dst = f'blocks_{i}'
        tf_b = f'{model_name}/blocks_{i}'
        is_mbconv = f'{bb}/{dst}/se/reduce/kernel' in flat
        has_expand = f'{bb}/{dst}/expand_conv/kernel' in flat
        if is_mbconv:
            pairs += [(f'{bb}/{dst}/expand_conv/kernel',
                       f'{tf_b}/conv2d/kernel', None)]
            pairs += _bn_pairs(f'{bb}/{dst}/norm0/bn', f'{bs}/{dst}/norm0/bn',
                               f'{tf_b}/tpu_batch_normalization')
            pairs += [(f'{bb}/{dst}/depthwise_conv/kernel',
                       f'{tf_b}/depthwise_conv2d/depthwise_kernel', _dw)]
            pairs += _bn_pairs(f'{bb}/{dst}/norm1/bn', f'{bs}/{dst}/norm1/bn',
                               f'{tf_b}/tpu_batch_normalization_1')
            pairs += [
                (f'{bb}/{dst}/se/reduce/kernel', f'{tf_b}/se/conv2d/kernel',
                 None),
                (f'{bb}/{dst}/se/reduce/bias', f'{tf_b}/se/conv2d/bias', None),
                (f'{bb}/{dst}/se/expand/kernel', f'{tf_b}/se/conv2d_1/kernel',
                 None),
                (f'{bb}/{dst}/se/expand/bias', f'{tf_b}/se/conv2d_1/bias',
                 None),
                (f'{bb}/{dst}/project_conv/kernel', f'{tf_b}/conv2d_1/kernel',
                 None)]
            pairs += _bn_pairs(f'{bb}/{dst}/norm2/bn', f'{bs}/{dst}/norm2/bn',
                               f'{tf_b}/tpu_batch_normalization_2')
        elif has_expand:
            pairs += [(f'{bb}/{dst}/expand_conv/kernel',
                       f'{tf_b}/conv2d/kernel', None)]
            pairs += _bn_pairs(f'{bb}/{dst}/norm0/bn', f'{bs}/{dst}/norm0/bn',
                               f'{tf_b}/tpu_batch_normalization')
            pairs += [(f'{bb}/{dst}/project_conv/kernel',
                       f'{tf_b}/conv2d_1/kernel', None)]
            pairs += _bn_pairs(f'{bb}/{dst}/norm1/bn', f'{bs}/{dst}/norm1/bn',
                               f'{tf_b}/tpu_batch_normalization_1')
        else:
            pairs += [(f'{bb}/{dst}/project_conv/kernel',
                       f'{tf_b}/conv2d/kernel', None)]
            pairs += _bn_pairs(f'{bb}/{dst}/norm1/bn', f'{bs}/{dst}/norm1/bn',
                               f'{tf_b}/tpu_batch_normalization')

    pairs += [(f'{bb}/head_conv/kernel', f'{model_name}/head/conv2d/kernel',
               None)]
    pairs += _bn_pairs(f'{bb}/head_bn/bn', f'{bs}/head_bn/bn',
                       f'{model_name}/head/tpu_batch_normalization')
    if tf_vars is None:  # collection mode (tests / inventory dumps)
        return pairs
    return _apply_mapping(tf_vars, flax_variables, pairs)


def import_resnet_from_tf(
        tf_vars: Dict[str, np.ndarray], flax_variables: Dict,
        backbone_scope: str = 'backbone') -> Dict:
    """Reference-fork (Keras applications) ResNet variables -> the tree.

    Keras naming (`metrabs_tf/backbones/resnet.py:170-515`): stem
    `conv1_conv`/`conv1_bn`; stage s block b sublayer j ->
    `conv{s+2}_block{b+1}_{j}_{conv,bn}` (j=0 is the projection shortcut);
    V2 adds `_preact_bn` per block and a final `post_bn`. Biases are copied
    exactly where the tree has them (the tree mirrors the fork's
    use_bias choices). DenseSameConv nests its kernel under `conv/`.
    """
    flat = _flat(flax_variables)
    bb = f'params/{backbone_scope}'
    bs = f'batch_stats/{backbone_scope}'

    def conv_kernel_path(module):
        nested = f'{bb}/{module}/conv/kernel'
        return nested if nested in flat else f'{bb}/{module}/kernel'

    pairs = []

    def add_conv(module, tf_layer):
        kpath = conv_kernel_path(module)
        pairs.append((kpath, f'{tf_layer}/kernel', None))
        bias_path = kpath.replace('/kernel', '/bias')
        if bias_path in flat:
            pairs.append((bias_path, f'{tf_layer}/bias', None))

    def add_bn(module, tf_layer):
        # BatchNorm or GroupNorm per what the tree contains; the
        # groupnorm variant's Keras layers are named *_gn with gamma/beta
        # only (`metrabs_tf/backbones/resnet.py:174-176,277`).
        if f'{bb}/{module}/gn/scale' in flat:
            tf_gn = tf_layer[:-3] + '_gn' if tf_layer.endswith('_bn') \
                else tf_layer
            pairs.extend([
                (f'{bb}/{module}/gn/scale', f'{tf_gn}/gamma', None),
                (f'{bb}/{module}/gn/bias', f'{tf_gn}/beta', None)])
        else:
            pairs.extend(_bn_pairs(f'{bb}/{module}/bn', f'{bs}/{module}/bn',
                                   tf_layer))

    add_conv('stem_conv', 'conv1_conv')
    if f'{bb}/stem_bn/bn/scale' in flat or f'{bb}/stem_bn/gn/scale' in flat:
        add_bn('stem_bn', 'conv1_bn')

    blocks = sorted({
        tuple(map(int, re.match(
            r'stage(\d+)_block(\d+)', k.split('/')[2]).groups()))
        for k in flat if k.startswith(f'{bb}/stage')})
    for si, b in blocks:
        mod = f'stage{si}_block{b}'
        tf_pre = f'conv{si + 2}_block{b + 1}'
        if f'{bb}/{mod}/preact_bn/bn/scale' in flat:
            add_bn(f'{mod}/preact_bn', f'{tf_pre}_preact_bn')
        for j in range(4):
            kpath = conv_kernel_path(f'{mod}/conv{j}')
            if kpath in flat:
                add_conv(f'{mod}/conv{j}', f'{tf_pre}_{j}_conv')
            if (f'{bb}/{mod}/bn{j}/bn/scale' in flat
                    or f'{bb}/{mod}/bn{j}/gn/scale' in flat):
                add_bn(f'{mod}/bn{j}', f'{tf_pre}_{j}_bn')

    if f'{bb}/post_bn/bn/scale' in flat:
        add_bn('post_bn', 'post_bn')
    if tf_vars is None:
        return pairs
    return _apply_mapping(tf_vars, flax_variables, pairs)


def import_mobilenetv3_from_tf(
        tf_vars: Dict[str, np.ndarray], flax_variables: Dict,
        backbone_scope: str = 'backbone') -> Dict:
    """Reference-fork (Keras applications) MobileNetV3 variables -> the tree.

    Keras naming (`metrabs_tf/backbones/mobilenet_v3.py:266-548`): stem
    `Conv` + `Conv/BatchNorm`; block i -> `expanded_conv[_i]/{expand,
    depthwise,project}` (+`/BatchNorm`), SE `.../squeeze_excite/Conv[_1]`
    (block 0 has no `_0` suffix and no expand); head `Conv_1` (+BN) and
    `Conv_2` (bias).
    """
    flat = _flat(flax_variables)
    bb = f'params/{backbone_scope}'
    bs = f'batch_stats/{backbone_scope}'
    pairs = [(f'{bb}/stem_conv/kernel', 'Conv/kernel', None)]
    pairs += _bn_pairs(f'{bb}/stem_bn/bn', f'{bs}/stem_bn/bn',
                       'Conv/BatchNorm')

    block_ids = sorted({
        int(k.split('/')[2].split('_')[1]) for k in flat
        if k.startswith(f'{bb}/block_')})
    for i in block_ids:
        mod = f'block_{i}'
        tf_pre = 'expanded_conv' if i == 0 else f'expanded_conv_{i}'
        if f'{bb}/{mod}/expand/kernel' in flat:
            pairs += [(f'{bb}/{mod}/expand/kernel', f'{tf_pre}/expand/kernel',
                       None)]
            pairs += _bn_pairs(f'{bb}/{mod}/expand_bn/bn',
                               f'{bs}/{mod}/expand_bn/bn',
                               f'{tf_pre}/expand/BatchNorm')
        pairs += [(f'{bb}/{mod}/depthwise/kernel',
                   f'{tf_pre}/depthwise/depthwise_kernel', _dw)]
        pairs += _bn_pairs(f'{bb}/{mod}/depthwise_bn/bn',
                           f'{bs}/{mod}/depthwise_bn/bn',
                           f'{tf_pre}/depthwise/BatchNorm')
        if f'{bb}/{mod}/squeeze_excite/conv/kernel' in flat:
            pairs += [
                (f'{bb}/{mod}/squeeze_excite/conv/kernel',
                 f'{tf_pre}/squeeze_excite/Conv/kernel', None),
                (f'{bb}/{mod}/squeeze_excite/conv/bias',
                 f'{tf_pre}/squeeze_excite/Conv/bias', None),
                (f'{bb}/{mod}/squeeze_excite/conv_1/kernel',
                 f'{tf_pre}/squeeze_excite/Conv_1/kernel', None),
                (f'{bb}/{mod}/squeeze_excite/conv_1/bias',
                 f'{tf_pre}/squeeze_excite/Conv_1/bias', None)]
        pairs += [(f'{bb}/{mod}/project/kernel', f'{tf_pre}/project/kernel',
                   None)]
        pairs += _bn_pairs(f'{bb}/{mod}/project_bn/bn',
                           f'{bs}/{mod}/project_bn/bn',
                           f'{tf_pre}/project/BatchNorm')

    pairs += [(f'{bb}/conv_1/kernel', 'Conv_1/kernel', None)]
    pairs += _bn_pairs(f'{bb}/conv_1_bn/bn', f'{bs}/conv_1_bn/bn',
                       'Conv_1/BatchNorm')
    pairs += [(f'{bb}/conv_2/kernel', 'Conv_2/kernel', None),
              (f'{bb}/conv_2/bias', 'Conv_2/bias', None)]
    if tf_vars is None:
        return pairs
    return _apply_mapping(tf_vars, flax_variables, pairs)


def import_metrabs_head_from_tf(
        tf_vars: Dict[str, np.ndarray], flax_variables: Dict,
        head_key: str = 'heatmap_heads') -> Dict:
    """The 1x1 output conv: `metrabs/metrabs_heads/conv2d`
    (`convert_model_from_tf.py:196`). With `tf_vars=None`, its mapping
    pairs, as the backbone functions give theirs."""
    pairs = [(f'params/{head_key}/conv_final/kernel',
              'metrabs/metrabs_heads/conv2d/kernel', None),
             (f'params/{head_key}/conv_final/bias',
              'metrabs/metrabs_heads/conv2d/bias', None)]
    if tf_vars is None:
        return pairs
    return _apply_mapping(tf_vars, flax_variables, pairs)


def import_backbone_from_tf(
        tf_vars: Dict[str, np.ndarray], flax_variables: Dict,
        backbone_name: str, backbone_scope: str = 'backbone') -> Dict:
    """Dispatch by backbone family name (registry naming)."""
    name = backbone_name.lower().replace('_', '-')
    if name.startswith('efficientnetv2'):
        return import_effnetv2_from_tf(
            tf_vars, flax_variables, name, backbone_scope)
    if name.startswith('resnet'):
        return import_resnet_from_tf(tf_vars, flax_variables, backbone_scope)
    if name.startswith('mobilenetv3'):
        return import_mobilenetv3_from_tf(
            tf_vars, flax_variables, backbone_scope)
    raise ValueError(f'No TF import mapping for backbone {backbone_name!r}')


def load_affine_weights(source, flax_variables: Dict) -> Dict:
    """Loads ACAE affine-combining autoencoder weights into the latent-mode
    model constants (`metrabs_tf/models/metrabs.py:25-35`): an .npz path or
    dict with w1 [n_joints, n_latents] (encoder) and w2 [n_latents,
    n_joints] (decoder / recombination). Shapes are validated against the
    model's n_latents/n_joints."""
    ws = np.load(source) if isinstance(source, str) else source
    w1 = np.asarray(ws['w1'], np.float32)
    w2 = np.asarray(ws['w2'], np.float32)
    if w1.shape != w2.shape[::-1]:
        raise ValueError(f'w1 {w1.shape} and w2 {w2.shape} are not '
                         'transpose-compatible')
    flat = _flat(flax_variables)
    enc_key = next((k for k in flat if k.endswith('encoder_weights')), None)
    rec_key = next(
        (k for k in flat if k.endswith('recombination_weights')), None)
    if enc_key is None or rec_key is None:
        raise KeyError('Model has no latent-mode constants (latent_mode '
                       'unset or n_latents=0)')
    for key, val in ((enc_key, w1), (rec_key, w2)):
        if tuple(np.asarray(flat[key]).shape) != val.shape:
            raise ValueError(f'{key}: expected {np.asarray(flat[key]).shape},'
                             f' got {val.shape}')
        flat[key] = val
    return _unflat(flat)
