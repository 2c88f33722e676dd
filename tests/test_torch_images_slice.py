"""The slice of the new still-image formats on the CPU: JAX's demo_image
(cv2's read, JAX's estimator) against the port's (its own TIFF, BMP and GIF
readers, its estimator) on the tiny package's minted weights, and
calibrate_camera on calibration set (a)'s views written losslessly as
8-bit gray TIFF and BMP: the port's app gives exactly its answer on the
PNGs, and the JAX app's (cv2 reading the copies) within the app
tolerances of tests/test_torch_calibrate.py.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest

import _torch_image_fixtures as fx
from _torch_train import one_torch_thread  # noqa: F401 (fixture)
from metrabs_tpu.data import improc as jax_improc
from metrabs_tpu_torch.data import improc
from test_torch_calibrate import (APP_F_RTOL, APP_PP_TOL_PX, APP_RMS_TOL_PX, CV2_MISSES, FIXTURES,
                                  MANIFEST, assert_calibrations_close, run_jax_app, run_port_app)
from test_torch_png import POSES3D


@pytest.mark.parametrize('name', ['tiff_rgb16_lzw_pred2_tiles_be.tif', 'bmp_cv2_rgb.bmp',
                                  'gif_pillow_palette.gif'])
def test_demo_image_matches_jax(name, tmp_path, capsys, one_torch_thread):
    from _torch_port import make_family_package
    from metrabs_tpu.apps import demo_image as jax_demo_image
    from metrabs_tpu_torch.apps import demo_image
    package = make_family_package(str(tmp_path / 'pkg'), 'tiny')
    path = str(fx.FIXTURE_DIR / name)
    common = ['--image', path, '--package', package, '--num-aug', '2',
              '--boxes', '2,3,30,40;10,5,25,30']
    with pytest.warns(UserWarning, match='bone_mean_lengths'):
        jax_demo_image.main(common)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with pytest.warns(UserWarning, match='bone_mean_lengths'):
        demo_image.main(common + ['--device', 'cpu', '--out', str(tmp_path / 'o.png')])
    got = json.loads([t for t in capsys.readouterr().out.splitlines() if t.startswith('{')][-1])
    assert got.keys() == want.keys() and got['n_poses'] == want['n_poses'] == 2
    np.testing.assert_allclose(got['pose0_pelvis_mm'], want['pose0_pelvis_mm'], **POSES3D)
    assert improc.imread(str(tmp_path / 'o.png')).shape == jax_improc.imread(path).shape


@pytest.mark.parametrize('kind', ['tif', 'bmp'])
def test_calibrate_camera_on_tiff_and_bmp_copies_of_set_a(kind, tmp_path):
    """Set (a) without the view cv2 misses, its gray reads written as
    8-bit gray TIFF (PackBits strips) or BMP (a gray palette): the gray
    reads are the PNGs', so the port's JSON equals its JSON on the PNGs,
    and the JAX app on the copies agrees as it does on the PNGs."""
    run = MANIFEST['calibrations']['a']
    pngs = tmp_path / 'png'
    shutil.copytree(FIXTURES / 'a', pngs)
    for view in CV2_MISSES:
        (pngs / Path(view).name).unlink()
    copies = tmp_path / kind
    copies.mkdir()
    write = fx.gray_tiff if kind == 'tif' else fx.gray_bmp
    for png in sorted(pngs.glob('*.png')):
        gray = improc.imread(str(png), gray=True)
        out = copies / f'{png.stem}.{kind}'
        out.write_bytes(write(gray))
        np.testing.assert_array_equal(improc.imread(str(out), gray=True), gray)
    on_pngs = run_port_app(str(pngs / '*.png'), run['square_mm'], tmp_path / 'png.json')
    got = run_port_app(str(copies / f'*.{kind}'), run['square_mm'], tmp_path / 'copy.json')
    assert got == on_pngs
    want = run_jax_app(str(copies / f'*.{kind}'), run['square_mm'], tmp_path / 'jax.json')
    assert got.keys() == want.keys() and got['image_shape'] == want['image_shape']
    assert_calibrations_close(got, want, APP_F_RTOL, APP_PP_TOL_PX, APP_RMS_TOL_PX, np.inf)
