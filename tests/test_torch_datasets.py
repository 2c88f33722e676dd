"""The port's dataset adapters (`metrabs_tpu_torch/data/datasets.py`) and
its copies of the CDF and MATLAB readers against the JAX package's, on
layouts minted in `tmp_path` in each benchmark's published format: every
`Example3D` field equal (cameras included), and the 3DHP adapter refusing
the HDF5 annotations it cannot read.
"""

import dataclasses
import pickle

import numpy as np
import pytest

import _torch_bench_layouts as layouts
from metrabs_tpu.data import datasets as jax_datasets
from metrabs_tpu.utils import cdf as jax_cdf
from metrabs_tpu.utils import matlabfile as jax_matlabfile
from metrabs_tpu_torch.data import datasets
from metrabs_tpu_torch.utils import cdf, matlabfile

CAMERA_FIELDS = ('R', 't', 'intrinsic_matrix', 'distortion_coeffs', 'world_up')


def assert_cameras_equal(ours, theirs):
    assert type(ours).__name__ == type(theirs).__name__ == 'Camera'
    assert vars(ours).keys() == vars(theirs).keys()
    for name in CAMERA_FIELDS:
        got, want = getattr(ours, name), getattr(theirs, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def assert_examples_equal(ours, theirs):
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert type(a).__name__ == type(b).__name__
        for field in dataclasses.fields(b):
            got, want = getattr(a, field.name), getattr(b, field.name)
            if field.name == 'camera':
                assert_cameras_equal(got, want)
            elif isinstance(want, np.ndarray):
                assert got.dtype == want.dtype and got.shape == want.shape, field.name
                np.testing.assert_array_equal(got, want, err_msg=field.name)
            else:
                assert got == want, field.name


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.mark.parametrize('case', ['finite', 'partly_nan', 'all_nan'])
def test_boxes_from_joints_match_jax(rng, case):
    pts = rng.uniform(0, 500, (17, 2))
    if case == 'partly_nan':
        pts[[2, 5, 9]] = np.nan
    elif case == 'all_nan':
        pts[:] = np.nan
    got, want = datasets.boxes_from_joints(pts), jax_datasets.boxes_from_joints(pts)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_3dpw_examples_match_jax(tmp_path, rng):
    layouts.mint_3dpw(tmp_path, rng, n_seqs=2, n_frames=4)
    assert_examples_equal(datasets.load_3dpw_examples(str(tmp_path)),
                          jax_datasets.load_3dpw_examples(str(tmp_path)))


def test_mupots_examples_and_annotations_match_jax(tmp_path, rng):
    layouts.mint_mupots(tmp_path, rng, sequences=(1, 6, 7), with_frames=False)
    assert_examples_equal(datasets.load_mupots_examples(str(tmp_path)),
                          jax_datasets.load_mupots_examples(str(tmp_path)))
    for seqs in (None, [6, 7], [2]):
        ours = list(datasets.load_mupots_annotations(str(tmp_path), seqs))
        theirs = list(jax_datasets.load_mupots_annotations(str(tmp_path), seqs))
        assert [(i, a.shape) for i, a in ours] == [(i, a.shape) for i, a in theirs]
        for (_, a), (_, b) in zip(ours, theirs):
            for cell_a, cell_b in zip(a.ravel(), b.ravel()):
                pa, pb = datasets.parse_mupots_person(cell_a), jax_datasets.parse_mupots_person(cell_b)
                assert (pa is None) == (pb is None)
                if pa is not None:
                    np.testing.assert_array_equal(pa[0], pb[0])
                    assert (pa[1] is None) == (pb[1] is None)
                    if pa[1] is not None:
                        np.testing.assert_array_equal(pa[1], pb[1])


@pytest.mark.parametrize('extrinsics,bbox', [(True, True), (False, False)])
def test_npz_examples_match_jax(tmp_path, rng, extrinsics, bbox):
    path = tmp_path / 'ex.npz'
    layouts.mint_npz(path, rng, with_extrinsics=extrinsics, with_bbox=bbox)
    assert_examples_equal(datasets.load_npz_examples(str(path), image_root='/data'),
                          jax_datasets.load_npz_examples(str(path), image_root='/data'))


@pytest.mark.parametrize('cameras', ['json', 'xml'])
def test_h36m_examples_match_jax(tmp_path, rng, cameras):
    info = layouts.mint_h36m(tmp_path, rng, subjects=(9, 11), with_frames=False,
                             write_cdf=cdf.write_cdf)
    path = info['cameras_json'] if cameras == 'json' else info['metadata_xml']
    for step in (1, 4):
        assert_examples_equal(
            datasets.load_h36m_examples(str(tmp_path), path, frame_step=step),
            jax_datasets.load_h36m_examples(str(tmp_path), path, frame_step=step))


def test_h36m_cameras_match_jax(tmp_path, rng):
    info = layouts.mint_h36m(tmp_path, rng, with_frames=False)
    for loader in ('load_h36m_cameras', 'load_h36m_metadata_xml'):
        path = info['cameras_json'] if loader == 'load_h36m_cameras' else info['metadata_xml']
        ours, theirs = getattr(datasets, loader)(path), getattr(jax_datasets, loader)(path)
        assert ours.keys() == theirs.keys()
        for key in theirs:
            assert_cameras_equal(ours[key], theirs[key])
    angles = rng.uniform(-np.pi, np.pi, 3)
    np.testing.assert_array_equal(datasets.h36m_rotation_from_angles(angles),
                                  jax_datasets.h36m_rotation_from_angles(angles))
    assert datasets.H36M_RELEVANT_JOINTS == jax_datasets.H36M_RELEVANT_JOINTS
    assert datasets.H36M_CAMERA_IDS == jax_datasets.H36M_CAMERA_IDS
    with pytest.raises(AssertionError, match='rotation differs'):
        datasets.validate_h36m_metadata_against_json(info['metadata_xml'], info['cameras_json'])


def test_3doh_examples_match_jax(tmp_path, rng):
    layouts.mint_3doh(tmp_path, rng, n=5)
    assert_examples_equal(datasets.load_3doh_examples(str(tmp_path)),
                          jax_datasets.load_3doh_examples(str(tmp_path)))


@pytest.mark.parametrize('frame_step', [1, 2])
def test_aspset_examples_match_jax(tmp_path, rng, frame_step):
    layouts.mint_aspset(tmp_path, rng)
    ours = datasets.load_aspset_examples(str(tmp_path), frame_step=frame_step)
    assert_examples_equal(ours, jax_datasets.load_aspset_examples(
        str(tmp_path), frame_step=frame_step))
    assert all('.mkv#frame=' in ex.image_path for ex in ours)
    from metrabs_tpu_torch.data.improc import imread
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        imread(ours[0].image_path)


def test_3dhp_test_frames_raise_where_the_hdf5_annotations_are(tmp_path):
    import json
    cams = {'subj1_4': dict(intrinsic_matrix=np.eye(3).tolist()),
            'subj5_6': dict(intrinsic_matrix=np.eye(3).tolist(), distortion=[0.1, 0, 0, 0, 0])}
    cam_json = tmp_path / 'cams.json'
    cam_json.write_text(json.dumps(cams))
    assert datasets.load_3dhp_test_frames(str(tmp_path), str(cam_json)) == []
    assert jax_datasets.load_3dhp_test_frames(str(tmp_path), str(cam_json)) == []
    (tmp_path / 'TS2').mkdir()
    (tmp_path / 'TS2' / 'annot_data.mat').write_bytes(b'\x89HDF\r\n\x1a\n')
    with pytest.raises(NotImplementedError, match='ROADMAP.md'):
        datasets.load_3dhp_test_frames(str(tmp_path), str(cam_json))
    with pytest.raises(KeyError):  # the cameras are parsed first, as in JAX
        (tmp_path / 'bad.json').write_text('{}')
        datasets.load_3dhp_test_frames(str(tmp_path), str(tmp_path / 'bad.json'))


@pytest.mark.parametrize('options', [{}, dict(compress_vvr=True), dict(column_major=True)],
                         ids=['plain', 'gzip', 'column_major'])
@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_cdf_copy_writes_and_reads_as_jax(tmp_path, rng, options, dtype):
    variables = {'Pose': rng.normal(size=(1, 9, 96)).astype(dtype),
                 'Other': rng.normal(size=(2, 3, 4)).astype(dtype)}
    cdf.write_cdf(str(tmp_path / 'ours.cdf'), variables, **options)
    jax_cdf.write_cdf(str(tmp_path / 'theirs.cdf'), variables, **options)
    assert (tmp_path / 'ours.cdf').read_bytes() == (tmp_path / 'theirs.cdf').read_bytes()
    for module in (cdf, jax_cdf):
        loaded = module.load_cdf(str(tmp_path / 'ours.cdf'))
        for name, value in variables.items():
            np.testing.assert_array_equal(loaded[name], value)
    with pytest.raises(ValueError):
        cdf.CdfFile(b'\x01' * 64)


def test_matlabfile_copy_loads_as_jax(tmp_path, rng):
    layouts.mint_mupots(tmp_path, rng, sequences=(3,), with_frames=False)
    path = str(tmp_path / 'TS3' / 'annot.mat')
    ours, theirs = matlabfile.load(path), jax_matlabfile.load(path)
    assert pickle.dumps(ours['annotations'].shape) == pickle.dumps(theirs['annotations'].shape)
    for a, b in zip(ours['annotations'].ravel(), theirs['annotations'].ravel()):
        assert a.keys() == b.keys()
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
