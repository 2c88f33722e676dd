"""The port's HDF5 reader and writer (`metrabs_tpu_torch/utils/hdf5.py`)
against h5py.

Reader: each case writes a file with h5py in `tmp_path` under each `libver`
bound (`earliest`, as MATLAB's v7.3 files are written, `v108`: superblock
v2, v2 object headers, new-style groups and dense attributes, `v110` and
`latest`: superblock v3 and layout-v4 chunk indexes) and reads it with
both; every group's members in order, every dataset's dtype, shape and
values (exactly) and every attribute must agree. The structures of
tests/_torch_hdf5_fixtures.py (every chunk index, paged; a dense group of
2000 links; groups that track creation order; dense and huge attributes;
soft and external links) are written once per module. A flipped byte in
each structure that carries a checksum raises; what the reader refuses
raises naming it. Writer: the port's `save_predictions_hdf5` and JAX's
(h5py) write the same dump; h5py reads both the same (keys, dtypes, shapes,
values, gzip at level 4 on numeric data), and so does the port's reader.
"""

import os
import shutil

import numpy as np
import pytest

h5py = pytest.importorskip('h5py')

import _torch_hdf5_fixtures as fixtures  # noqa: E402
from metrabs_tpu_torch.utils import hdf5  # noqa: E402

LIBVERS = fixtures.LIBVERS


def assert_same(ours, theirs, path='/'):
    """Recursively: members and their order, dtypes, shapes, values and
    attributes. A member reached by a soft or external link is compared
    as a dataset, or by its members as a group; a dangling link must raise
    in both the same way."""
    assert sorted(ours.attrs) == sorted(theirs.attrs), path
    assert list(ours.attrs) == list(theirs.attrs), path
    for name in theirs.attrs:
        got, want = ours.attrs[name], theirs.attrs[name]
        assert type(got) is type(want), (path, name, type(got), type(want))
        np.testing.assert_array_equal(got, want, err_msg=f'{path} @{name}')
    if isinstance(theirs, h5py.Dataset):
        assert isinstance(ours, (hdf5.Dataset, h5py.Dataset)), path
        assert ours.shape == theirs.shape and ours.maxshape == theirs.maxshape, path
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
        link = theirs.get(name, getlink=True)
        try:
            want = theirs[name]
        except (KeyError, RuntimeError) as e:  # dangling, or too many links
            with pytest.raises(type(e)):
                ours[name]
            continue
        got = ours[name]
        if isinstance(link, h5py.HardLink) or isinstance(want, h5py.Dataset):
            assert_same(got, want, f'{path}{name}/')
        else:
            assert isinstance(got, hdf5.Group) and list(got) == list(want), f'{path}{name}/'


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


# Each case under each bound; the earliest keeps the ids it had before the
# bound was a parameter.
READER_CASES = [pytest.param(case, userblock, libver,
                             id=f'{case}-{userblock}' + ('' if libver == 'earliest'
                                                          else f'-{libver}'))
                for case in sorted(CASES) for userblock in (0, 512, 2048) for libver in LIBVERS]


@pytest.mark.parametrize('case,userblock,libver', READER_CASES)
def test_reader_equals_h5py(tmp_path, case, userblock, libver):
    path = tmp_path / 'f.h5'
    with h5py.File(path, 'w', userblock_size=userblock, libver=libver) as f:
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
    """`libver='latest'` (superblock v3, v2 object headers, link messages,
    layout-v4 chunk indexes) reads as h5py reads it."""
    path = tmp_path / 'latest.h5'
    with h5py.File(path, 'w', libver='latest') as f:
        write_layouts(f, np.random.default_rng(0))
    assert path.read_bytes()[8] == 3  # superblock version
    with hdf5.File(path) as ours, h5py.File(path, 'r') as theirs:
        assert_same(ours, theirs)


def write_virtual(f):
    layout = h5py.VirtualLayout(shape=(3,), dtype='i8')
    layout[:] = h5py.VirtualSource('.', 'plain', shape=(3,))
    f.create_virtual_dataset('x', layout)


def write_filtered_heap(f):
    """A dense group whose fractal heap deflates its blocks (a group
    creation property h5py does not wrap)."""
    gcpl = h5py.h5p.create(h5py.h5p.GROUP_CREATE)
    fixtures.libhdf5_call('H5Pset_deflate', gcpl, 6)
    h5py.h5g.create(f.id, b'x', gcpl=gcpl)
    for i in range(30):
        f['x'][f'member_{i}'] = i


@pytest.mark.parametrize('what', ['compound', 'reference', 'soft_link', 'vlen_sequence',
                                  'enum', 'external_link', 'virtual', 'filtered_heap',
                                  'shared_messages'])
def test_unsupported_features_raise_naming_them(tmp_path, what):
    """What the reader refuses raises NotImplementedError naming it; soft
    and external links (refused before superblock v2 was read) read as
    h5py reads them."""
    path = tmp_path / 'f.h5'
    fcpl = h5py.h5p.create(h5py.h5p.FILE_CREATE)
    if what == 'shared_messages':  # a table for every kind of message (not wrapped by h5py)
        fixtures.libhdf5_call('H5Pset_shared_mesg_nindexes', fcpl, 1)
        fixtures.libhdf5_call('H5Pset_shared_mesg_index', fcpl, 0, 0x1F, 0)
    fapl = h5py.h5p.create(h5py.h5p.FILE_ACCESS)
    fapl.set_libver_bounds(h5py.h5f.LIBVER_LATEST if what in ('virtual', 'filtered_heap')
                           else h5py.h5f.LIBVER_EARLIEST, h5py.h5f.LIBVER_LATEST)
    with h5py.File(h5py.h5f.create(str(path).encode(), h5py.h5f.ACC_TRUNC, fcpl=fcpl,
                                   fapl=fapl)) as f:
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
        elif what == 'external_link':
            f['x'] = h5py.ExternalLink('other.h5', '/y')
        elif what == 'virtual':
            write_virtual(f)
        elif what == 'filtered_heap':
            write_filtered_heap(f)
        else:
            f.create_dataset('x', data=np.arange(4.0), compression='gzip')
    if what in ('soft_link', 'external_link'):
        with h5py.File(tmp_path / 'other.h5', 'w') as f:
            f['y'] = np.arange(4, dtype='u2')
        with hdf5.File(path) as ours, h5py.File(path, 'r') as theirs:
            assert_same(ours, theirs)
            np.testing.assert_array_equal(ours['x'][()], theirs['x'][()])
        return
    if what == 'shared_messages':
        with pytest.raises(NotImplementedError, match='shared object header message table'):
            hdf5.File(path)
        return
    feature = {'virtual': 'virtual dataset', 'filtered_heap': 'filtered fractal heap'}
    with hdf5.File(path) as ours:
        np.testing.assert_array_equal(ours['plain'][()], np.arange(3))
        assert 'x' in ours.keys()
        with pytest.raises(NotImplementedError,
                           match=f'HDF5 {feature.get(what, "")}.* not supported'):
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


# --- every libver bound's structures ---------------------------------------------


@pytest.fixture(scope='module')
def structures(tmp_path_factory):
    """tests/_torch_hdf5_fixtures.py's structures written once under each
    bound, `latest` with the three-level v2 B-tree and a 72 KB attribute,
    beside the target of their external links."""
    root = tmp_path_factory.mktemp('structures')
    fixtures.write_external(root / fixtures.EXTERNAL)
    paths = {}
    for libver in LIBVERS:
        paths[libver] = root / f'{libver}.h5'
        fixtures.write_structures(paths[libver], libver, big=libver == 'latest')
    return paths


@pytest.mark.parametrize('libver', LIBVERS)
def test_structures_read_equal_to_h5py(structures, libver, tmp_path, monkeypatch):
    """Chunk indexes, dense and creation-ordered groups, dense and huge
    attributes, soft links and external links, with the working directory
    elsewhere (the external file is found beside the referring one)."""
    monkeypatch.chdir(tmp_path)
    with hdf5.File(structures[libver]) as ours, h5py.File(structures[libver], 'r') as theirs:
        assert_same(ours, theirs)
        assert list(ours['ordered']) == ['z', 'a', 'm']
        assert len(ours['dense']) == fixtures.DENSE_LINKS
        np.testing.assert_array_equal(ours['external'][()], theirs['external'][()])
        assert ours['external_group/z'][()] == b'in the other file'
        with pytest.raises(KeyError):
            ours['external_dangling']
        with pytest.raises(KeyError):
            ours['soft/dangling']


def layout_index(ds) -> int:
    """The chunk index type of a layout-v4 chunked dataset."""
    layout = ds._layout
    assert layout[0] == 4 and layout[1] == 2, ds.name
    return layout[5 + layout[3] * layout[4]]


def test_latest_structures_exercise_every_index_and_block(structures, monkeypatch):
    """The `latest` file holds what the reader is held to: each chunk index,
    the arrays' pages, super blocks, a B-tree three levels deep, indirect
    heap blocks and a huge attribute; each structure's checksum is
    verified on the way."""
    verified = []
    verify = hdf5._Reader.verify
    monkeypatch.setattr(hdf5._Reader, 'verify', lambda self, block, what, address: (
        verified.append(what), verify(self, block, what, address))[1])
    want = {'single': 1, 'single_filtered': 1, 'implicit': 2, 'fixed': 3, 'fixed_paged': 3,
            'fixed_paged_filtered': 3, 'dont_filter_partial': 3, 'extensible': 4,
            'extensible_middle': 4, 'extensible_paged': 4, 'never_written': 4, 'btree2': 5,
            'btree2_filtered': 5, 'btree2_deep': 5}
    with hdf5.File(structures['latest']) as f:
        index = f['index']
        assert {name: layout_index(index[name]) for name in index} == want
        for name in want:
            index[name][()]
        assert index['single_filtered']._layout[2] == hdf5.LAYOUT_SINGLE_INDEX_WITH_FILTER
        assert index['dont_filter_partial']._layout[2] == hdf5.LAYOUT_DONT_FILTER_PARTIAL
        list(f['dense'])
        heap = f._reader.fractal_heap(f._reader.unpack(
            'O', next(m.data for m in f['dense']._messages if m.type == hdf5.MSG_LINK_INFO),
            2)[0])
        assert heap.root_rows > 0  # a root indirect block
        assert f['attributed'].attrs['huge'].nbytes > heap.max_managed
    assert verified.count('BTIN') >= 3 and {'FADB page', 'EADB page', 'EASB', 'FHIB', 'FHDB',
                                             'superblock', 'OHDR'} <= set(verified)


SIGNED = ['superblock', 'OHDR', 'OCHK', 'FRHP', 'FHIB', 'FHDB', 'BTHD', 'BTIN', 'BTLF', 'FAHD',
          'FADB', 'EAHD', 'EAIB', 'EASB', 'EADB']


def read_everything(path):
    """Every member, dataset and attribute of a file, through the reader."""
    with hdf5.File(path) as f:
        def visit(group):
            dict(group.attrs)
            for name in group:
                if group._links[name][0] != 'hard':
                    continue
                obj = group[name]
                if isinstance(obj, hdf5.Group):
                    visit(obj)
                else:
                    obj[()]
                    {k: obj.attrs[k] for k in obj.attrs}
        visit(f)


@pytest.mark.parametrize('what', SIGNED)
def test_checksums_are_checked(structures, tmp_path, monkeypatch, what):
    """One byte flipped inside a structure (the last one its checksum
    covers) raises ValueError naming the structure and its address."""
    seen = {}
    verify = hdf5._Reader.verify

    def record(self, block, name, address):
        seen.setdefault(name, (address + self.base, len(block)))
        return verify(self, block, name, address)
    monkeypatch.setattr(hdf5._Reader, 'verify', record)
    read_everything(structures['latest'])
    monkeypatch.setattr(hdf5._Reader, 'verify', verify)
    assert what in seen, sorted(seen)
    at, n = seen[what]
    data = bytearray(structures['latest'].read_bytes())
    data[at + n - 5] ^= 0x01
    path = tmp_path / 'flipped.h5'
    path.write_bytes(bytes(data))
    shutil.copy(structures['latest'].parent / fixtures.EXTERNAL, tmp_path)
    with pytest.raises(ValueError, match=f'HDF5 {what} at address {at} fails its lookup3'):
        read_everything(path)


@pytest.mark.parametrize('libver', ['earliest', 'latest'])
def test_track_order_groups(tmp_path, libver):
    """Groups that track creation order, compact and dense, under a v0
    superblock (v2 object headers in a v0 file) and a v3 one: h5py's order."""
    path = tmp_path / 'ordered.h5'
    rng = np.random.default_rng(4)
    with h5py.File(path, 'w', libver=libver, track_order=True) as f:
        for name in 'zam':
            f[name] = np.array(ord(name))
        dense = f.create_group('dense', track_order=True)
        for name in rng.permutation([f'k{i:02d}' for i in range(40)]):
            dense[name] = np.int8(1)
        f.create_group('by_name', track_order=False)['b'] = 1
        f['by_name']['a'] = 2
        for name in ('y', 'x'):
            f['dense'].attrs[name] = np.float32(1)
    data = path.read_bytes()
    assert data[8] == (0 if libver == 'earliest' else 3) and b'OHDR' in data
    with hdf5.File(path) as ours, h5py.File(path, 'r') as theirs:
        assert_same(ours, theirs)
        assert list(ours)[:3] == ['z', 'a', 'm'] and list(ours['by_name']) == ['a', 'b']
        assert list(ours['dense']) != sorted(ours['dense']) and len(ours['dense']) == 40
        assert list(ours['dense'].attrs) == ['y', 'x']


@pytest.mark.parametrize('libver', ['earliest', 'latest'])
def test_soft_links_resolve_as_in_h5py(tmp_path, libver):
    """Soft links in old-style (symbol table) and new-style groups: absolute,
    relative, to '.', chains up to MAX_LINK_HOPS and one longer, a cycle,
    a dangling one and '..' (no parent in HDF5 paths)."""
    path = tmp_path / 'soft.h5'
    with h5py.File(path, 'w', libver=libver) as f:
        f['d'] = np.arange(3)
        f['a'] = h5py.SoftLink('/b')
        f['b'] = h5py.SoftLink('/a')
        previous = '/d'
        for i in range(hdf5.MAX_LINK_HOPS + 2):
            f[f'chain_{i:02d}'] = h5py.SoftLink(previous)
            previous = f'/chain_{i:02d}'
        f['dangling'] = h5py.SoftLink('/nothing')
        g = f.create_group('g')
        g['up'] = h5py.SoftLink('../d')
        g['down'] = h5py.SoftLink('sub/x')
        g.create_group('sub')['x'] = 5
        g['here'] = h5py.SoftLink('.')
    assert (b'OHDR' in path.read_bytes()) == (libver == 'latest')
    paths = ['d', 'a', 'dangling', 'g/up', 'g/down', 'g/here', 'g/here/here/down',
             'g/here/sub/x'] + [f'chain_{i:02d}' for i in range(hdf5.MAX_LINK_HOPS + 2)]
    with hdf5.File(path) as ours, h5py.File(path, 'r') as theirs:
        assert list(ours) == list(theirs)
        for name in paths:
            try:
                want = theirs[name]
            except (KeyError, RuntimeError) as e:
                with pytest.raises(type(e)):
                    ours[name]
                continue
            got = ours[name]
            if isinstance(want, h5py.Dataset):
                np.testing.assert_array_equal(got[()], want[()])
            else:
                assert list(got) == list(want)
        for name in ('dangling', 'a', 'g/up', 'g/here/x', 'g/sub/x', 'dangling/x'):
            assert (name in ours) == (name in theirs), name
        with pytest.raises(RuntimeError, match='too many links'):
            ours[f'chain_{hdf5.MAX_LINK_HOPS:02d}']
        ours[f'chain_{hdf5.MAX_LINK_HOPS - 1:02d}']


def test_external_links_are_found_where_libhdf5_finds_them(tmp_path, monkeypatch):
    """An external link's file: an absolute name as given, else by its last
    component beside the referring file, else in the working directory; a
    relative name beside the referring file (subdirectories kept), else in
    the working directory. Probed against h5py with the working directory
    elsewhere, then with files removed; a missing file or path raises
    KeyError in both."""
    base = tmp_path
    for d in ('dir1/sub', 'cwd', 'other'):
        (base / d).mkdir(parents=True)

    def mint(path, value):
        with h5py.File(base / path, 'w', libver='latest') as f:
            f['y'] = np.array(value)
    for path, value in (('dir1/t.h5', 1), ('cwd/t.h5', 2), ('other/abs.h5', 3),
                        ('dir1/abs.h5', 4), ('cwd/abs.h5', 5), ('dir1/sub/t2.h5', 6)):
        mint(path, value)
    with h5py.File(base / 'dir1/ref.h5', 'w') as f:
        f['relative'] = h5py.ExternalLink('t.h5', '/y')
        f['absolute'] = h5py.ExternalLink(str(base / 'other/abs.h5'), '/y')
        f['absolute_missing'] = h5py.ExternalLink(str(base / 'nowhere/abs.h5'), '/y')
        f['subdirectory'] = h5py.ExternalLink('sub/t2.h5', '/y')
        f['no_file'] = h5py.ExternalLink('zzz.h5', '/y')
        f['no_path'] = h5py.ExternalLink('t.h5', '/q')
        f['twice'] = h5py.ExternalLink('ref.h5', '/relative')
    monkeypatch.chdir(base / 'cwd')

    def values(opener, name):
        out = {}
        with opener(name) as f:
            for key in f:
                try:
                    out[key] = int(f[key][()])
                except KeyError:
                    out[key] = 'KeyError'
        return out
    for name in (str(base / 'dir1/ref.h5'), '../dir1/ref.h5'):
        want = values(lambda n: h5py.File(n, 'r'), name)
        assert values(hdf5.File, name) == want
        assert want['relative'] == 1 and want['absolute_missing'] == 4
    for path in ('dir1/t.h5', 'other/abs.h5', 'dir1/abs.h5'):
        os.remove(base / path)
    want = values(lambda n: h5py.File(n, 'r'), str(base / 'dir1/ref.h5'))
    assert values(hdf5.File, str(base / 'dir1/ref.h5')) == want
    assert want['relative'] == 2 and want['absolute'] == 5 and want['no_file'] == 'KeyError'


@pytest.mark.parametrize('how', ['page-earliest', 'page-latest', 'fsm-earliest', 'fsm-v108',
                                 'swmr'])
def test_file_space_strategies_and_swmr_read_equal(tmp_path, how):
    """Paged and free-space-managed file space that persists its free space
    (superblock v2 or v3 with an extension), and a file written in SWMR
    mode."""
    path = tmp_path / 'f.h5'
    if how == 'swmr':
        fixtures.write_swmr(path)
    else:
        strategy, libver = how.split('-')
        fixtures.write_page(path, strategy, libver)
    assert path.read_bytes()[8] in (2, 3)
    with hdf5.File(path) as ours, h5py.File(path, 'r') as theirs:
        assert_same(ours, theirs)


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
