"""The port's HDF5 reader and writer (`metrabs_tpu_torch/utils/hdf5.py`)
against h5py.

Reader: each case writes a file with h5py in `tmp_path` (its default
`libver='earliest'`, as MATLAB's v7.3 files are written) and reads it with
both; every group's members, every dataset's dtype, shape and values
(exactly) and every attribute must agree. Writer: the port's
`save_predictions_hdf5` and JAX's (h5py) write the same dump; h5py reads
both the same (keys, dtypes, shapes, values, gzip at level 4 on numeric
data), and so does the port's reader.
"""

import numpy as np
import pytest

h5py = pytest.importorskip('h5py')

from metrabs_tpu_torch.utils import hdf5  # noqa: E402


def assert_same(ours, theirs, path='/'):
    """Recursively: members, dtypes, shapes, values and attributes."""
    assert sorted(ours.attrs) == sorted(theirs.attrs), path
    for name in theirs.attrs:
        got, want = ours.attrs[name], theirs.attrs[name]
        assert type(got) is type(want), (path, name, type(got), type(want))
        np.testing.assert_array_equal(got, want, err_msg=f'{path} @{name}')
    if isinstance(theirs, h5py.Dataset):
        assert isinstance(ours, (hdf5.Dataset, h5py.Dataset)), path
        assert ours.shape == theirs.shape, path
        assert ours.dtype == theirs.dtype, (path, ours.dtype, theirs.dtype)
        got, want = ours[()], theirs[()]
        got_arr, want_arr = np.asarray(ours), np.asarray(theirs)
        assert got_arr.dtype == want_arr.dtype and got_arr.shape == want_arr.shape, path
        np.testing.assert_array_equal(got_arr, want_arr, err_msg=path)
        if isinstance(want, np.ndarray):
            assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        else:
            assert type(got) is type(want), (path, type(got), type(want))
        np.testing.assert_array_equal(got, want, err_msg=path)
        return
    assert isinstance(ours, (hdf5.Group, h5py.Group)), path
    assert list(ours.keys()) == list(theirs.keys()), path
    for name in theirs:
        assert name in ours and f'{name}/nothing' not in ours
        assert_same(ours[name], theirs[name], f'{path}{name}/')


def write_dtypes(f, rng):
    for code in ('i1', 'i2', 'i4', 'i8', 'u1', 'u2', 'u4', 'u8', 'f2', 'f4', 'f8',
                 '>i2', '>i4', '>i8', '>u4', '>f4', '>f8'):
        info = np.iinfo(code) if code[-2] in 'iu' else None
        value = (rng.integers(info.min, info.max, (7, 3), dtype=np.dtype(code).newbyteorder('='))
                 if info else rng.normal(0, 1e3, (7, 3)))
        f.create_dataset(code.replace('>', 'be_'), data=np.asarray(value).astype(code))
    logical = f.create_dataset('logical', data=(rng.random((6, 1)) > 0.5).astype(np.uint8))
    logical.attrs['MATLAB_class'] = np.bytes_('logical')
    f['numpy_bool'] = rng.random(9) > 0.5  # h5py's enum


def write_shapes(f, rng):
    f['scalar_f8'] = 2.5
    f['scalar_i4'] = np.int32(-7)
    f['one_d'] = rng.normal(size=11)
    f['four_d'] = rng.normal(size=(5, 1, 17, 3))
    f['empty'] = np.zeros((0, 3), np.float32)
    f.create_dataset('empty_chunked', data=np.zeros((0, 4)), compression='gzip')
    # MATLAB's empty array: its dims vector as uint64, flagged MATLAB_empty.
    empty = f.create_dataset('matlab_empty', data=np.array([0, 0], np.uint64))
    empty.attrs['MATLAB_class'] = np.bytes_('double')
    empty.attrs['MATLAB_empty'] = np.uint8(1)


def write_layouts(f, rng):
    compact = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    compact.set_layout(h5py.h5d.COMPACT)
    f.create_dataset('compact', data=rng.integers(0, 99, (4, 5)).astype('i2'), dcpl=compact)
    f.create_dataset('contiguous', data=rng.normal(size=(30, 7)), chunks=None)
    f.create_dataset('chunked_edges', data=rng.normal(size=(23, 10, 3)), chunks=(5, 4, 2))
    f.create_dataset('chunked_exact', data=rng.normal(size=(8, 8)), chunks=(4, 4))


def write_filters(f, rng):
    data = rng.normal(size=(40, 9)).astype(np.float32)
    smooth = np.cumsum(rng.integers(-3, 4, (50, 6)), 0).astype(np.int32)
    for level in (1, 4, 9):
        f.create_dataset(f'gzip{level}', data=smooth, chunks=(16, 4), compression='gzip',
                         compression_opts=level)
    f.create_dataset('shuffle_gzip', data=data, chunks=(16, 4), compression='gzip',
                     shuffle=True)
    f.create_dataset('shuffle_only', data=smooth, chunks=(7, 6), shuffle=True)
    f.create_dataset('fletcher32', data=data, chunks=(9, 9), fletcher32=True)
    f.create_dataset('fletcher32_odd', data=rng.integers(0, 255, (13, 7), dtype=np.uint8),
                     chunks=(5, 3), fletcher32=True)
    f.create_dataset('all_three', data=smooth, chunks=(16, 4), compression='gzip',
                     shuffle=True, fletcher32=True)
    # A chunk stored with its filter skipped (bit 0 of its filter mask).
    masked = f.create_dataset('filter_mask', shape=(8, 8), dtype='f4', chunks=(4, 4),
                              compression='gzip')
    masked[4:, :] = 3.0
    masked.id.write_direct_chunk((0, 0), np.arange(16, dtype='f4').tobytes(), filter_mask=1)


def write_groups(f, rng):
    g = f.create_group('a/b/c')
    g['deep'] = np.arange(3)
    f['a/x'] = np.float32(1.5)
    many = f.create_group('many')
    for i in range(130):  # more members than one symbol table node (8) and B-tree splits
        many[f'member_{rng.permutation(1000)[0]:03d}_{i}'] = np.full(2, i)
    f.create_group('empty_group')


def write_many_chunks(f, rng):
    # 25 x 12 = 300 chunks: a chunk B-tree of two levels (64 entries per node).
    f.create_dataset('many_chunks', data=rng.normal(size=(100, 47)), chunks=(4, 4),
                     compression='gzip')
    f.create_dataset('one_d_chunks', data=np.arange(1000, dtype='>i4'), chunks=(3,))


def write_strings(f, rng):
    ds = f.create_dataset('annot', data=rng.normal(size=(3, 2)))
    ds.attrs['MATLAB_class'] = np.bytes_('double')
    ds.attrs['vlen_attr'] = 'héllo'
    ds.attrs['int_array'] = np.arange(4, dtype=np.int16)
    ds.attrs['float_scalar'] = 0.25
    ds.attrs['fixed_array'] = np.array([b'ab', b'cde'])
    for i in range(40):  # an object header that needs continuation blocks
        ds.attrs[f'extra_{i}'] = np.full(i % 5 + 1, i)
    f.attrs['root_attr'] = np.bytes_('root')
    f['fixed'] = np.array([b'abc', b'', b'xyzzy'])
    f['vlen_utf8'] = np.array(['ä', '', 'img_000001.jpg', 'x' * 300], object).astype(
        h5py.string_dtype('utf-8'))
    f.create_dataset('vlen_ascii', data=np.array([b'a', b'bc'], object),
                     dtype=h5py.string_dtype('ascii'))
    f.create_dataset('vlen_2d', data=np.array([['a', 'b'], ['cd', 'e']], object),
                     dtype=h5py.string_dtype('utf-8'))
    f['vlen_scalar'] = 'one string'


def write_unallocated(f, rng):
    f.create_dataset('never_written', shape=(4, 3), dtype='f4', fillvalue=1.5)
    f.create_dataset('never_written_default', shape=(5,), dtype='i8')
    f.create_dataset('chunked_never_written', shape=(10, 10), dtype='u2', chunks=(4, 4),
                     fillvalue=7, compression='gzip')
    partial = f.create_dataset('partly_written', shape=(10, 10), dtype='f8', chunks=(4, 4),
                               fillvalue=-1.0)
    partial[5:7, 1:3] = 9.0


CASES = dict(dtypes=write_dtypes, shapes=write_shapes, layouts=write_layouts,
             filters=write_filters, groups=write_groups, many_chunks=write_many_chunks,
             strings=write_strings, unallocated=write_unallocated)


@pytest.mark.parametrize('userblock', [0, 512, 2048])
@pytest.mark.parametrize('case', sorted(CASES))
def test_reader_equals_h5py(tmp_path, case, userblock):
    path = tmp_path / 'f.h5'
    with h5py.File(path, 'w', userblock_size=userblock) as f:
        CASES[case](f, np.random.default_rng(sorted(CASES).index(case)))
    with hdf5.File(path) as ours, h5py.File(path, 'r') as theirs:
        assert_same(ours, theirs)


def test_matlab_user_block_text_and_slicing(tmp_path):
    """A user block holding MATLAB's header text; `ds[index]`, `len` and
    `np.asarray(ds, dtype)` as h5py's."""
    import _torch_hdf5_fixtures as fixtures
    path = tmp_path / 'annot_data.mat'
    arrays = fixtures.matlab_annotations(40, [3, 7], seed=1)
    fixtures.write_matlab_h5py(path, arrays)
    assert path.read_bytes()[:10] == b'MATLAB 7.3'
    with hdf5.File(str(path), 'r') as ours, h5py.File(path, 'r') as theirs:
        assert_same(ours, theirs)
        for key in ('valid_frame', 'annot3'):
            assert len(ours[key]) == len(theirs[key]) == 40
            np.testing.assert_array_equal(ours[key][3:9], theirs[key][3:9])
            np.testing.assert_array_equal(np.asarray(ours[key], np.float32),
                                          np.asarray(theirs[key], np.float32))
        valid = np.asarray(ours['valid_frame'])[:, 0]
        assert valid.shape == (40,) and np.flatnonzero(valid == 0).tolist() == [3, 7]


def test_libver_latest_raises_or_reads_equal(tmp_path):
    path = tmp_path / 'latest.h5'
    with h5py.File(path, 'w', libver='latest') as f:
        write_layouts(f, np.random.default_rng(0))
    with pytest.raises(NotImplementedError, match='superblock version'):
        hdf5.File(path)


@pytest.mark.parametrize('what', ['compound', 'reference', 'soft_link', 'vlen_sequence',
                                  'enum', 'external_link'])
def test_unsupported_features_raise_naming_them(tmp_path, what):
    path = tmp_path / 'f.h5'
    with h5py.File(path, 'w') as f:
        f['plain'] = np.arange(3)
        if what == 'compound':
            f['x'] = np.zeros(2, [('a', 'i4'), ('b', 'f8')])
        elif what == 'reference':
            f.create_dataset('x', data=[f['plain'].ref], dtype=h5py.ref_dtype)
        elif what == 'soft_link':
            f['x'] = h5py.SoftLink('/plain')
        elif what == 'vlen_sequence':
            f.create_dataset('x', (2,), dtype=h5py.vlen_dtype(np.int32))
        elif what == 'enum':
            f.create_dataset('x', data=np.zeros(2, 'u1'),
                             dtype=h5py.enum_dtype({'RED': 0, 'GREEN': 1}, basetype='u1'))
        else:
            f['x'] = h5py.ExternalLink('other.h5', '/y')
    if what == 'external_link':  # only a new-style group holds one
        with pytest.raises(NotImplementedError, match='new-style group'):
            hdf5.File(path)
        return
    with hdf5.File(path) as ours:
        np.testing.assert_array_equal(ours['plain'][()], np.arange(3))
        assert 'x' in ours.keys()
        with pytest.raises(NotImplementedError, match='HDF5 .* not supported'):
            ours['x'][()]


def test_not_hdf5_truncated_and_write_mode(tmp_path):
    (tmp_path / 'text.h5').write_bytes(b'not an hdf5 file' * 100)
    with pytest.raises(ValueError, match='no superblock'):
        hdf5.File(tmp_path / 'text.h5')
    with h5py.File(tmp_path / 'ok.h5', 'w') as f:
        f.create_dataset('x', data=np.arange(10000.0))
    data = (tmp_path / 'ok.h5').read_bytes()
    (tmp_path / 'cut.h5').write_bytes(data[:len(data) // 2])
    with pytest.raises(ValueError, match='truncated'):
        with hdf5.File(tmp_path / 'cut.h5') as f:
            f['x'][()]
    with pytest.raises(ValueError, match="'r' only"):
        hdf5.File(tmp_path / 'ok.h5', 'w')
    with pytest.raises(KeyError):
        hdf5.File(tmp_path / 'ok.h5')['y']


def test_fletcher32_checksum_is_checked(tmp_path):
    path = tmp_path / 'f.h5'
    with h5py.File(path, 'w') as f:
        f.create_dataset('x', data=np.arange(64, dtype='u1'), chunks=(64,), fletcher32=True)
    data = bytearray(path.read_bytes())
    at = bytes(data).index(bytes(range(64)))
    data[at + 10] ^= 0xFF
    path.write_bytes(bytes(data))
    with hdf5.File(path) as f, pytest.raises(ValueError, match='Fletcher-32'):
        f['x'][()]


# --- the writer -------------------------------------------------------------


def dump(rng, n=37):
    """A prediction dump as eval_benchmark writes it, plus the other kinds
    of values a dump may hold."""
    return dict(
        poses3d_pred_cam=rng.normal(0, 500, (n, 17, 3)).astype(np.float32),
        poses3d_true_cam=rng.normal(0, 500, (n, 17, 3)),
        joint_validity_mask=rng.random((n, 17)) > 0.2,
        image_path=np.array([f'/data/S9/Images/frame_{i:06d}.jpg' for i in range(n)]),
        names_object=np.array(['ä', 'b' * 40, ''], object),
        big=rng.integers(-1000, 1000, (300, 400)).astype(np.int16),
        be=np.arange(6, dtype='>f8'),
        empty=np.zeros((0, 17, 3), np.float32))


def test_save_predictions_hdf5_reads_equal_to_jax(tmp_path):
    """The port's writer and JAX's (h5py) on one dump: h5py and the port's
    reader read both files the same."""
    from metrabs_tpu.eval import harness as jax_harness
    from metrabs_tpu_torch.eval import harness
    preds = dump(np.random.default_rng(0))
    harness.save_predictions(str(tmp_path / 'port.h5'), preds)
    jax_harness.save_predictions(str(tmp_path / 'jax.h5'), preds)
    with h5py.File(tmp_path / 'port.h5', 'r') as ours, h5py.File(tmp_path / 'jax.h5') as theirs:
        assert_same(ours, theirs)
        for key, value in preds.items():
            if value.dtype.kind in 'UO':
                assert ours[key].compression is None and h5py.check_string_dtype(
                    ours[key].dtype).encoding == 'utf-8'
                assert [s.decode() for s in ours[key][()]] == [str(s) for s in value]
            else:
                assert ours[key].compression == theirs[key].compression == 'gzip'
                assert ours[key].compression_opts == theirs[key].compression_opts == 4
                assert ours[key].chunks == theirs[key].chunks, key
                np.testing.assert_array_equal(ours[key][()], value)
    for name in ('port.h5', 'jax.h5'):
        with hdf5.File(tmp_path / name) as ours, h5py.File(tmp_path / name) as theirs:
            assert_same(ours, theirs)


def test_writer_options_read_equal_in_h5py(tmp_path):
    """A MATLAB-like file from the writer (user block, MATLAB_class
    attributes), an empty one and a root group of more members than one
    symbol table node holds, read by h5py and by the port's reader."""
    rng = np.random.default_rng(1)
    arrays = dict(annot3=rng.normal(size=(50, 1, 17, 3)), valid_frame=np.ones((50, 1)))
    hdf5.write_hdf5(tmp_path / 'm.mat', arrays, userblock_size=512,
                    attrs={k: {'MATLAB_class': 'double'} for k in arrays})
    members = {f'k{i}': np.arange(i, dtype=np.uint8) for i in range(70)}
    hdf5.write_hdf5(tmp_path / 'many.h5', members)
    hdf5.write_hdf5(tmp_path / 'empty.h5', {})
    with h5py.File(tmp_path / 'm.mat') as f:
        assert f.userblock_size == 512 and f['annot3'].compression == 'gzip'
        assert f['annot3'].attrs['MATLAB_class'] == b'double'
        for k, v in arrays.items():
            np.testing.assert_array_equal(f[k][()], v)
    with h5py.File(tmp_path / 'many.h5') as f:
        assert sorted(f) == sorted(members)
        assert all(np.array_equal(f[k][()], v) for k, v in members.items())
    with h5py.File(tmp_path / 'empty.h5') as f:
        assert len(f) == 0
    for name in ('m.mat', 'many.h5', 'empty.h5'):
        with hdf5.File(tmp_path / name) as ours, h5py.File(tmp_path / name) as theirs:
            assert_same(ours, theirs)


def test_writer_refuses_what_h5py_refuses(tmp_path):
    from metrabs_tpu.eval import harness as jax_harness
    from metrabs_tpu_torch.eval import harness
    for save in (harness.save_predictions, jax_harness.save_predictions):
        with pytest.raises(TypeError, match="Scalar datasets don't support"):
            save(str(tmp_path / 'scalar.h5'), dict(x=np.float32(1.0)))
    with pytest.raises(TypeError, match='holds int'):
        hdf5.write_hdf5(tmp_path / 'o.h5', dict(x=np.array(['a', 3], object)))
    with pytest.raises(ValueError, match='userblock_size'):
        hdf5.write_hdf5(tmp_path / 'o.h5', {}, userblock_size=100)
