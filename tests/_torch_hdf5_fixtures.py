"""Writes the HDF5 fixtures of the port's HDF5 reader under
`tests/torch_fixtures/hdf5/` with h5py, and `manifest.json`: for each file
every dataset's SHA-256 of the C-order bytes h5py reads, its dtype and
shape, every attribute's likewise, and every group's members in h5py's
order. The card's machine has no h5py; `chip_smoke.py` holds the port's
reader to the manifest there.

    python tests/_torch_hdf5_fixtures.py

No file written by MATLAB itself is in the repository, so the annotation
layout is h5py's imitation of MATLAB v7.3's `annot_data.mat` of the
MPI-INF-3DHP test set: a 512-byte user block that starts with MATLAB's
header text, doubles in MATLAB's column-major order (its [3, 17, 1, F]
`annot3` reads as [F, 1, 17, 3]), chunked and deflated with edge chunks,
each dataset with its `MATLAB_class` attribute. TS1 (48 frames) and TS5
(40) are written under h5py's default bound (superblock v0), TS2 (48) with
`libver='v108'` (superblock v2, `annot3`'s attributes dense) and TS6 (40)
with `libver='latest'` (superblock v3, layout v4 with fixed-array chunk
indexes); TS1-4 are 2048x2048, TS5-6 1920x1080. Each has one invalid frame.
`large_annot_data.mat` holds TDHP_LARGE_FRAMES frames under
`libver='latest'` (a pose held per chunk, so that it deflates small).

`structures_v3.h5` (with `structures_ext.h5`, the target of its external
link) holds the other structures of files h5py writes from
`libver='v110'` on: each layout-v4 chunk index (single chunk, implicit,
fixed and extensible arrays, paged, and a v2 B-tree of two levels), edge
and unallocated chunks, a dense group of DENSE_LINKS links (indirect
fractal-heap blocks), groups that track creation order, dense and huge
attributes, soft links and an external link. `swmr.h5` is written in SWMR
mode and `page.h5` with `fs_strategy='page'` and `fs_persist`.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import json
import os
from pathlib import Path

import numpy as np

FIXTURE_DIR = Path(__file__).resolve().parent / 'torch_fixtures' / 'hdf5'
MANIFEST = FIXTURE_DIR / 'manifest.json'
# sequence -> (frames, the invalid frame, libver, seed)
SEQUENCES = {'TS1': (48, 5, 'earliest', 0), 'TS2': (48, 17, 'v108', 2),
             'TS5': (40, 30, 'earliest', 1), 'TS6': (40, 9, 'latest', 3)}
LIBVERS = ('earliest', 'v108', 'v110', 'latest')
CHUNK_FRAMES = 32  # frames per chunk: every annotation fixture ends in an edge chunk
MATLAB_HEADER = (b'MATLAB 7.3 MAT-file, Platform: GLNXA64, Created on: Sat Oct 17 00:00:00 '
                 b'2026 HDF5 schema 1.00 .')
DENSE_ATTRS = 10  # extra attributes on annot3 under v108: more than 8 go dense
LARGE_FRAMES = 6151  # TS1's frames in the published test set
LARGE_NAME = 'large_annot_data.mat'
DENSE_LINKS = 2000
STRUCTURES, EXTERNAL = 'structures_v3.h5', 'structures_ext.h5'
# libhdf5's H5D_CHUNK_DONT_FILTER_PARTIAL_CHUNKS (H5Pset_chunk_opts), which
# h5py does not wrap.
DONT_FILTER_PARTIAL_CHUNKS = 0x0002


def fixture_name(sequence: str) -> str:
    return f'{sequence}_annot_data.mat'


def matlab_annotations(n_frames: int, invalid, seed: int, held: int = 1) -> dict:
    """`valid_frame` [F, 1], `annot3` and `univ_annot3` [F, 1, 17, 3] float64
    in mm, as h5py reads MATLAB's arrays: one person walking about 4 m in
    front of the camera, `invalid` frames marked 0; each pose held for
    `held` frames."""
    rng = np.random.default_rng(seed)
    t = (np.arange(n_frames) // held * held)[:, None, None]
    centre = np.array([-300.0, 100.0, 4000.0]) + t * [12.0, 0.0, -5.0] / held
    offset = rng.normal(0, 200, (1, 17, 3))
    noise = rng.normal(0, 10, (-(-n_frames // held), 17, 3)).repeat(held, 0)[:n_frames]
    annot3 = centre + offset + noise
    valid = np.ones((n_frames, 1))
    valid[list(np.atleast_1d(invalid))] = 0
    return dict(valid_frame=valid, annot3=annot3[:, None],
                univ_annot3=annot3[:, None] * 0.95)


def write_matlab_h5py(path, arrays: dict, libver: str = 'earliest', track_order: bool = False,
                      dense_attrs: int = 0) -> None:
    """MATLAB v7.3's layout of `arrays`, written by h5py (module docstring)
    under `libver`; `dense_attrs` more attributes on `annot3`."""
    import h5py
    with h5py.File(path, 'w', userblock_size=512, libver=libver, track_order=track_order) as f:
        for name, value in arrays.items():
            chunks = (min(CHUNK_FRAMES, len(value)),) + value.shape[1:]
            ds = f.create_dataset(name, data=value, chunks=chunks, compression='gzip',
                                  track_order=track_order)
            ds.attrs['MATLAB_class'] = np.bytes_('double')
            if name == 'annot3':
                for i in range(dense_attrs):
                    ds.attrs[f'MATLAB_note_{i:02d}'] = np.float64(i)
    with open(path, 'r+b') as f:
        f.write(MATLAB_HEADER.ljust(116, b' ') + b'\0' * 8 + b'\x00\x02IM')


# The libhdf5 calls for creation properties h5py does not wrap: name ->
# argument types (each returns herr_t, negative on failure).
_HID, _UINT = ctypes.c_int64, ctypes.c_uint
LIBHDF5_CALLS = {'H5Pset_chunk_opts': (_HID, _UINT), 'H5Pset_deflate': (_HID, _UINT),
                 'H5Pset_shared_mesg_nindexes': (_HID, _UINT),
                 'H5Pset_shared_mesg_index': (_HID, _UINT, _UINT, _UINT)}


def libhdf5_call(name: str, plist, *args) -> None:
    """One of LIBHDF5_CALLS on an h5py property list, through h5py's own
    libhdf5; raises if it fails."""
    import h5py
    libs = glob.glob(os.path.join(os.path.dirname(h5py.__file__), '..', 'h5py.libs',
                                  'libhdf5-*.so*'))
    function = getattr(ctypes.CDLL(libs[0] if libs else 'libhdf5.so'), name)
    function.argtypes, function.restype = LIBHDF5_CALLS[name], ctypes.c_int
    if function(plist.id, *args) < 0:
        raise RuntimeError(f'{name}{(plist.id, *args)} failed')


def dcpl(chunks, alloc_early=False, dont_filter_partial=False, fill=None, gzip=False):
    import h5py
    plist = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    plist.set_chunk(chunks)
    if gzip:
        plist.set_deflate(4)
    if alloc_early:
        plist.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
    if fill is not None:
        plist.set_fill_value(np.asarray(fill))
    if dont_filter_partial:
        libhdf5_call('H5Pset_chunk_opts', plist, DONT_FILTER_PARTIAL_CHUNKS)
    return plist


def create_with(group, name, shape, dtype, plist, maxshape=None):
    """A dataset created through the low-level API with a creation plist."""
    import h5py
    space = h5py.h5s.create_simple(shape, maxshape)
    tid = h5py.h5t.py_create(np.dtype(dtype))
    h5py.h5d.create(group.id, name.encode(), tid, space, dcpl=plist)
    return group[name]


def write_chunk_indexes(f, rng, deep: bool = False) -> None:
    """Under libver v110+: each layout-v4 chunk index, with edge chunks,
    unallocated chunks and the filtered variants, the fixed and extensible
    arrays paged. `deep` adds a v2 B-tree index of three levels (8100
    chunks)."""
    g = f.create_group('index')
    g.create_dataset('single', data=rng.normal(size=(5, 7)), chunks=(5, 7))
    g.create_dataset('single_filtered', data=np.arange(300, dtype='i4').reshape(20, 15),
                     chunks=(20, 15), compression='gzip', shuffle=True)
    implicit = create_with(g, 'implicit', (10, 7), 'i4', dcpl((4, 3), alloc_early=True, fill=7))
    implicit[2:5, 1:6] = np.arange(15).reshape(3, 5)
    g.create_dataset('fixed', data=rng.normal(size=(9, 10)).astype('f4'), chunks=(4, 4))
    # 3000 chunks: the fixed array pages (1024 elements a page); the last
    # page is short and the middle one never written.
    paged = g.create_dataset('fixed_paged', shape=(3000,), dtype='i2', chunks=(1,),
                             fillvalue=-1)
    paged[:1000] = np.arange(1000)
    paged[2100:2990] = np.arange(890)
    paged_gz = g.create_dataset('fixed_paged_filtered', shape=(3100,), dtype='f8', chunks=(1,),
                                compression='gzip', fletcher32=True)
    paged_gz[:] = np.arange(3100) / 7
    g.create_dataset('extensible', data=rng.integers(0, 9, (130, 3)), chunks=(1, 2),
                     maxshape=(None, 3))
    ea = g.create_dataset('extensible_middle', shape=(3, 500, 2), maxshape=(3, None, 2),
                          chunks=(2, 3, 2), dtype='u2', compression='gzip')
    ea[:, :400] = rng.integers(0, 60000, (3, 400, 2))
    g.create_dataset('btree2', data=rng.normal(size=(31, 29)), chunks=(2, 2),
                     maxshape=(None, None))
    bt = g.create_dataset('btree2_filtered', shape=(40, 33), maxshape=(None, None),
                          chunks=(3, 3), dtype='i8', compression='gzip', shuffle=True,
                          fletcher32=True, fillvalue=5)
    bt[:35, 4:] = rng.integers(-99, 99, (35, 29))
    partial = create_with(g, 'dont_filter_partial', (23, 10), 'f4',
                          dcpl((5, 4), dont_filter_partial=True, gzip=True))
    partial[...] = rng.normal(size=(23, 10))
    g.create_dataset('never_written', shape=(6, 6), dtype='f4', chunks=(3, 3), fillvalue=2.5,
                     maxshape=(None, 6))
    # Chunks past 131,000 lie in the extensible array's paged data blocks
    # (1024 elements a page): most of them are never written.
    sparse = g.create_dataset('extensible_paged', shape=(140000,), maxshape=(None,),
                              chunks=(1,), dtype='u1', fillvalue=3)
    sparse[:100] = np.arange(100)
    sparse[139000:140000] = np.arange(1000) % 251
    if deep:
        tree = g.create_dataset('btree2_deep', shape=(90, 90), maxshape=(None, None),
                                chunks=(1, 1), dtype='u1')
        tree[...] = rng.integers(0, 255, (90, 90))


def write_links(f, rng, external: str = EXTERNAL, dense_links: int = DENSE_LINKS) -> None:
    """A dense group of `dense_links` links (hard and soft), groups that
    track creation order (compact and dense), soft links (relative,
    absolute, to '.', dangling) and external links (one to `external`'s
    '/y', one dangling)."""
    import h5py
    f['target'] = np.arange(5, dtype='i2')
    dense = f.create_group('dense')
    names = [f'link_{int(i):05d}' for i in rng.permutation(dense_links)]
    for k, name in enumerate(names):
        dense[name] = h5py.SoftLink('/target') if k % 97 == 0 else f['target']
    ordered = f.create_group('ordered', track_order=True)
    for name in 'zam':
        ordered[name] = np.array(ord(name))
    ordered_dense = f.create_group('ordered_dense', track_order=True)
    for name in rng.permutation([f'n{i}' for i in range(20)]):
        ordered_dense[name] = f['target']
    soft = f.create_group('soft')
    soft['absolute'] = h5py.SoftLink('/target')
    soft.create_group('sub')['x'] = np.float32(2.5)
    soft['relative'] = h5py.SoftLink('sub/x')
    soft['here'] = h5py.SoftLink('.')
    soft['dangling'] = h5py.SoftLink('/nothing')
    f['external'] = h5py.ExternalLink(external, '/y')
    f['external_group'] = h5py.ExternalLink(external, '/g')
    f['external_dangling'] = h5py.ExternalLink('no_such_file.h5', '/y')


def write_attributes(f, rng, huge: int = 700) -> None:
    """Compact attributes, dense ones (more than 8), attributes that track
    creation order, and one of `huge` doubles (more than the heap's 4 KiB of
    managed space: a huge heap object)."""
    ds = f.create_dataset('attributed', data=np.arange(4.0))
    for i in rng.permutation(12):
        ds.attrs[f'attr_{i:02d}'] = np.arange(i + 1, dtype='i4')
    ds.attrs['text'] = 'héllo'
    ds.attrs['huge'] = np.arange(huge, dtype='f8')
    ordered = f.create_dataset('attributed_ordered', data=np.zeros(2), track_order=True)
    for name in ('zeta', 'alpha', 'mid'):
        ordered.attrs[name] = np.bytes_(name)
    g = f.create_group('group_attrs', track_order=True)
    for i in range(15):
        g.attrs[f'g{14 - i}'] = np.float32(i)
    f.attrs['root_attr'] = np.int64(7)


def write_external(path) -> None:
    import h5py
    with h5py.File(path, 'w', libver='latest') as f:
        f['y'] = np.arange(6, dtype='>i4').reshape(2, 3)
        f.create_group('g')['z'] = np.bytes_('in the other file')


def write_structures(path, libver: str = 'latest', big: bool = False,
                     external: str = EXTERNAL, rng=None) -> None:
    """Chunk indexes, links and attributes (above) in one file; `big` adds
    the three-level v2 B-tree and makes the huge attribute 72 KB."""
    import h5py
    rng = np.random.default_rng(3) if rng is None else rng
    with h5py.File(path, 'w', libver=libver) as f:
        write_chunk_indexes(f, rng, deep=big)
        write_links(f, rng, external)
        write_attributes(f, rng, huge=9000 if big else 700)


def write_swmr(path) -> None:
    """A file written in SWMR mode: datasets grown and flushed after
    `swmr_mode` is set."""
    import h5py
    with h5py.File(path, 'w', libver='latest') as f:
        frames = f.create_dataset('frames', shape=(0, 17, 3), maxshape=(None, 17, 3),
                                  chunks=(8, 17, 3), dtype='f8', compression='gzip')
        count = f.create_dataset('count', shape=(0,), maxshape=(None,), chunks=(16,),
                                 dtype='i8')
        f.swmr_mode = True
        rng = np.random.default_rng(5)
        for step in range(5):
            n = frames.shape[0]
            frames.resize(n + 7, 0)
            frames[n:] = rng.normal(0, 100, (7, 17, 3))
            count.resize(step + 1, 0)
            count[step] = n + 7
            f.flush()


def write_page(path, strategy: str = 'page', libver: str = 'earliest') -> None:
    """A file of paged (or free-space-managed) file space that persists its
    free space, with a dataset deleted so that there is some."""
    import h5py
    kwargs = dict(fs_page_size=4096) if strategy == 'page' else {}
    with h5py.File(path, 'w', libver=libver, fs_strategy=strategy, fs_persist=True,
                   **kwargs) as f:
        rng = np.random.default_rng(6)
        f['kept'] = rng.normal(size=(40, 3))
        f['removed'] = np.zeros(3000)
        f.create_dataset('chunked', data=rng.integers(0, 9, (50, 7)), chunks=(8, 7),
                         compression='gzip')
        f.create_group('g').attrs['note'] = 'page'
        del f['removed']


def write_large_annotations(path, libver: str = 'latest') -> dict:
    """A MATLAB-layout annot_data.mat of LARGE_FRAMES frames, poses held per
    chunk (it deflates small); returns the arrays."""
    arrays = matlab_annotations(LARGE_FRAMES, list(range(0, LARGE_FRAMES, 97)), seed=11,
                                held=CHUNK_FRAMES)
    write_matlab_h5py(path, arrays, libver=libver)
    return arrays


def digest(value) -> dict:
    """SHA-256, dtype and shape of an array h5py read (strings of object
    arrays as their UTF-8 bytes, each ended by a NUL)."""
    value = np.asarray(value)
    if value.dtype.kind == 'O':
        data = b''.join((s.encode('utf-8') if isinstance(s, str) else s) + b'\0'
                        for s in value.reshape(-1).tolist())
    else:
        value = np.ascontiguousarray(value)
        data = value.tobytes()
    return dict(sha256=hashlib.sha256(data).hexdigest(), dtype=value.dtype.str,
                shape=list(value.shape))


def describe(path) -> dict:
    """What h5py reads of a file: every group's members in order, every
    dataset reached by a link (hard, soft or external) and every attribute,
    as digests by path; a dataset seen before under another path is an
    alias of that path."""
    import h5py
    out = dict(groups={}, datasets={}, aliases={}, attrs={})
    seen = {}

    def attrs(path, obj):  # [name, digest] pairs in h5py's order
        if len(obj.attrs):
            out['attrs'][path] = [[k, digest(obj.attrs[k])] for k in obj.attrs]

    def visit(path, group):
        out['groups'][path] = list(group)
        attrs(path, group)
        for name in group:
            child = f'{path.rstrip("/")}/{name}'
            link = group.get(name, getlink=True)
            try:
                obj = group[name]
            except (KeyError, RuntimeError):
                continue  # a dangling link
            if isinstance(obj, h5py.Dataset):
                key = (obj.file.filename, h5py.h5o.get_info(obj.id).addr)
                if key in seen:
                    out['aliases'][child] = seen[key]
                    continue
                seen[key] = child
                out['datasets'][child] = digest(obj[()])
                attrs(child, obj)
            elif isinstance(link, h5py.HardLink):
                visit(child, obj)

    with h5py.File(path, 'r') as f:
        visit('/', f)
    return out


def write_fixtures() -> dict:
    FIXTURE_DIR.mkdir(parents=True, exist_ok=True)
    for sequence, (n_frames, invalid, libver, seed) in SEQUENCES.items():
        write_matlab_h5py(FIXTURE_DIR / fixture_name(sequence),
                          matlab_annotations(n_frames, invalid, seed=seed), libver=libver,
                          dense_attrs=DENSE_ATTRS if libver == 'v108' else 0)
    write_large_annotations(FIXTURE_DIR / LARGE_NAME)
    write_external(FIXTURE_DIR / EXTERNAL)
    write_structures(FIXTURE_DIR / STRUCTURES)
    write_swmr(FIXTURE_DIR / 'swmr.h5')
    write_page(FIXTURE_DIR / 'page.h5')
    names = sorted(p.name for p in FIXTURE_DIR.iterdir() if p.suffix in ('.h5', '.mat'))
    manifest = {name: describe(FIXTURE_DIR / name) for name in names}
    MANIFEST.write_text(json.dumps(manifest, indent=1, sort_keys=True) + '\n')
    return manifest


def read_manifest() -> dict:
    return json.loads(MANIFEST.read_text())


if __name__ == '__main__':
    written = write_fixtures()
    total = sum((FIXTURE_DIR / n).stat().st_size for n in written)
    print(f'{len(written)} fixtures, {total / 1024:.1f} KiB, in {FIXTURE_DIR}')
