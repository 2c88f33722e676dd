"""The port's TensorBundle reader and writer (`metrabs_tpu_torch/io/
tf_checkpoint.py`) against the JAX package's (`metrabs_tpu/io/
tf_checkpoint.py`): the two writers give byte-equal files for the same
tensors, bfloat16 included (JAX's as an `ml_dtypes` array, the port's as
that array or as a `torch.bfloat16` tensor), and each reader reads the
other's file to the same arrays, exactly."""

import ml_dtypes
import numpy as np
import pytest
import torch

from metrabs_tpu.io import tf_checkpoint as jax_tc
from metrabs_tpu_torch.io import tf_checkpoint as tc


def tensors(seed=0):
    rng = np.random.default_rng(seed)
    return {
        'a/kernel': rng.normal(size=(3, 3, 4, 8)).astype(np.float32),
        'a/bias': rng.normal(size=(8,)).astype(np.float32),
        'step': np.array(123456789, np.int64),
        'flags': np.array([True, False, True]),
        'h': rng.normal(size=(5,)).astype(np.float16),
        'd': rng.normal(size=(2, 3)),
        'i8': rng.integers(-128, 128, size=(7,)).astype(np.int8),
        'u16': rng.integers(0, 65536, size=(4,)).astype(np.uint16),
        'bf': rng.normal(size=(6, 2)).astype(ml_dtypes.bfloat16),
        'big': rng.normal(size=(300, 200)).astype(np.float32),
    }


def files(prefix):
    return [open(prefix + suffix, 'rb').read()
            for suffix in ('.index', '.data-00000-of-00001')]


@pytest.mark.parametrize('bf16_as', ['numpy', 'torch'])
def test_writers_give_byte_equal_files(tmp_path, bf16_as):
    want = tensors()
    ours = dict(want)
    if bf16_as == 'torch':
        ours['bf'] = torch.tensor(want['bf'].astype(np.float32)).to(torch.bfloat16)
    jax_tc.write_tf_checkpoint(str(tmp_path / 'jax' / 'ckpt'), want)
    tc.write_tf_checkpoint(str(tmp_path / 'port' / 'ckpt'), ours)
    assert files(str(tmp_path / 'port' / 'ckpt')) == files(str(tmp_path / 'jax' / 'ckpt'))


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_each_reader_reads_the_others_file(tmp_path, writer):
    """Every dtype round-trips; bfloat16 comes back widened to float32 and
    uint16 as uint16 (DT_UINT16, not reinterpreted as bfloat16 bits)."""
    want = tensors()
    prefix = str(tmp_path / 'ckpt')
    (jax_tc if writer == 'jax' else tc).write_tf_checkpoint(prefix, want)
    ours, theirs = tc.load_tf_checkpoint(prefix), jax_tc.load_tf_checkpoint(prefix)
    assert sorted(ours) == sorted(theirs) == sorted(want)
    for name, value in want.items():
        expected = value.astype(np.float32) if name == 'bf' else value
        for got in (ours[name], theirs[name]):
            assert got.dtype == expected.dtype and got.shape == expected.shape, name
            np.testing.assert_array_equal(got, expected, err_msg=name)


def test_object_graph_suffix_stripped(tmp_path):
    prefix = str(tmp_path / 'ckpt')
    tc.write_tf_checkpoint(prefix, {'model/w/.ATTRIBUTES/VARIABLE_VALUE': np.ones(3, np.float32),
                                    'model/b': np.zeros(2, np.float32)})
    assert sorted(tc.load_tf_checkpoint(prefix)) == ['model/b', 'model/w']
    assert sorted(tc.load_tf_checkpoint(prefix, strip_suffixes=False)) == [
        'model/b', 'model/w/.ATTRIBUTES/VARIABLE_VALUE']
    assert sorted(jax_tc.load_tf_checkpoint(prefix)) == ['model/b', 'model/w']


def test_bad_magic_rejected(tmp_path):
    path = tmp_path / 'junk.index'
    path.write_bytes(b'\x00' * 64)
    with pytest.raises(ValueError, match='not a TF checkpoint index'):
        tc.read_index_entries(str(path))
    with pytest.raises(ValueError, match='not a TF checkpoint index'):
        tc.load_tf_checkpoint(str(tmp_path / 'junk'))


def test_unsupported_dtype_rejected(tmp_path):
    with pytest.raises(ValueError, match='Unsupported dtype'):
        tc.write_tf_checkpoint(str(tmp_path / 'ckpt'), {'c': np.zeros(2, np.complex64)})
