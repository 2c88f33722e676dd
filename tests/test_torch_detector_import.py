"""The port's detector importers against the JAX package's, on the same
files: `detect.yolov8.import_yolov8_from_torch` and
`export_torch_style_state_dict` (an ultralytics DetectionModel state dict)
and `detect.yolov4.load_darknet_weights` (a darknet `.weights` file, built
as tests/test_detector.py builds one), with the port's own
`write_darknet_weights`. Trees must be equal bit for bit; the imported tree
must load into the port's detector module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrabs_tpu.detect import yolov4 as jax_yolov4
from metrabs_tpu.detect import yolov8 as jax_yolov8
from metrabs_tpu_torch.detect import yolov4, yolov8
from metrabs_tpu_torch.detect.yolov4 import build_detector_model
from metrabs_tpu_torch.io.weights import detector_state_dict_from_flax, flatten_dict
from tests import _torch_port
from tests.test_torch_weights_import import assert_trees_equal, jax_template, zeros_tree


def port_detector_tree(kind):
    with torch.device('meta'):
        model = build_detector_model(kind)
    return zeros_tree(model)


def jax_yolov8_shapes(size):
    model = jax_yolov8.YOLOv8(size=size, dtype=jnp.float32)
    return jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))


def test_yolov8_import_export_round_trip_matches_jax():
    minted = _torch_port.detector_variables('yolov8n', scan_repeats=False, size=64)
    sd = yolov8.export_torch_style_state_dict(minted)
    want_sd = jax_yolov8.export_torch_style_state_dict(minted)
    assert list(sd) == list(want_sd)
    for k, v in want_sd.items():
        np.testing.assert_array_equal(sd[k], v, err_msg=k)
    ours = yolov8.import_yolov8_from_torch({k: torch.tensor(v) for k, v in sd.items()},
                                           port_detector_tree('yolov8n'))
    theirs = jax_yolov8.import_yolov8_from_torch(want_sd, jax_template(jax_yolov8_shapes('n')))
    assert_trees_equal(ours, theirs)
    assert_trees_equal(ours, minted)
    with torch.device('meta'):
        model = build_detector_model('yolov8n')
    detector_state_dict_from_flax(ours, model)


def test_yolov8_import_rejects_a_mismatch():
    sd = yolov8.export_torch_style_state_dict(port_detector_tree('yolov8n'))
    with pytest.raises(ValueError, match='wrong size variant'):
        yolov8.import_yolov8_from_torch(sd, port_detector_tree('yolov8s'))
    template = port_detector_tree('yolov8n')
    with pytest.raises(KeyError, match='unconsumed'):
        yolov8.import_yolov8_from_torch(dict(sd, **{'model.23.x': np.zeros(1)}), template)
    del sd['model.0.bn.running_var']
    with pytest.raises(KeyError, match='missing'):
        yolov8.import_yolov8_from_torch(sd, template)


def synthetic_darknet_file(path, variables, header=np.zeros(5, np.int32), seed=0):
    """A yolov4(-tiny).weights file of the canonical layout for the flat
    tree `variables`: per conv [beta, gamma, mean, var] (var positive) or
    [bias], then the OIHW kernel."""
    flat = flatten_dict(variables)
    rng = np.random.default_rng(seed)
    blobs = [header.tobytes()]
    i = 0
    while ('params', f'conv_{i}', 'conv', 'kernel') in flat:
        kh, kw, cin, cout = flat[('params', f'conv_{i}', 'conv', 'kernel')].shape
        if ('params', f'conv_{i}', 'bn', 'scale') in flat:
            extra = np.concatenate([rng.normal(size=3 * cout), rng.uniform(0.5, 1.5, cout)])
        else:
            extra = rng.normal(size=cout)
        blobs.append(extra.astype(np.float32).tobytes())
        blobs.append(rng.normal(size=cout * cin * kh * kw).astype(np.float32).tobytes())
        i += 1
    path.write_bytes(b''.join(blobs))
    return str(path)


@pytest.fixture(scope='module')
def tiny_templates():
    model = jax_yolov4.build_detector_model('yolov4-tiny', dtype=jnp.float32,
                                            scan_repeats=False)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               jnp.zeros((1, 96, 96, 3)), train=False))
    return model, jax_template(shapes), port_detector_tree('yolov4-tiny')


def test_darknet_import_matches_jax(tiny_templates, tmp_path):
    model, jax_tree, port_tree = tiny_templates
    path = synthetic_darknet_file(tmp_path / 'yolov4-tiny.weights', port_tree)
    ours = yolov4.load_darknet_weights(port_tree, path)
    assert_trees_equal(ours, jax_yolov4.load_darknet_weights(model, jax_tree, path))
    with torch.device('meta'):
        module = build_detector_model('yolov4-tiny')
    detector_state_dict_from_flax(ours, module)
    # The port's writer gives the same file, under the released header.
    out = tmp_path / 'written.weights'
    yolov4.write_darknet_weights(ours, str(out))
    written = out.read_bytes()
    assert written[:20] == yolov4.DARKNET_HEADER.tobytes()
    assert written[20:] == open(path, 'rb').read()[20:]
    assert_trees_equal(yolov4.load_darknet_weights(port_tree, str(out)), ours)


@pytest.mark.parametrize('change', ['extra_float', 'missing_float', 'partial_float', 'empty'])
def test_darknet_file_of_the_wrong_size_raises(tiny_templates, tmp_path, change):
    model, jax_tree, port_tree = tiny_templates
    raw = open(synthetic_darknet_file(tmp_path / 'ok.weights', port_tree), 'rb').read()
    raw = {'extra_float': raw + bytes(4), 'missing_float': raw[:-4],
           'partial_float': raw + bytes(2), 'empty': b''}[change]
    path = tmp_path / 'bad.weights'
    path.write_bytes(raw)
    with pytest.raises(ValueError, match='size mismatch|not a darknet header'):
        yolov4.load_darknet_weights(port_tree, str(path))
    if change in ('extra_float', 'missing_float'):  # JAX rejects these too
        with pytest.raises(ValueError):
            jax_yolov4.load_darknet_weights(model, jax_tree, str(path))
