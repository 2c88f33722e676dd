"""The port's data layer without OpenCV, against OpenCV and the JAX package on
the CPU.

`metrabs_tpu_torch.data.cvfree` against cv2 (OpenCV 5.0, where the tests
run), at small sizes with seeded inputs, for every interpolation, dtype,
channel count and border case the loaders use:

 - remap (nearest and linear, uint8 and float32, 1 and 3 channels, taps
   outside the image, coordinates on exact halves): equal;
 - resize: INTER_AREA by whole and fractional factors is equal on uint8
   and float32, INTER_LINEAR up and down equal on uint8; on float32
   INTER_LINEAR and INTER_CUBIC (the synthetic background's 8x8 upsampling)
   are within FLOAT_RESIZE_ATOL of cv2, whose float resize sums its taps in
   an order not found (a third of the values differ by an ulp; the largest
   difference seen is 3.6e-7). A uint8 background made from the cubic
   upsampling by truncation can therefore differ by one grey level where the
   upsampled value lies within an ulp of a level (5.7e-6 of the values at
   256 px); the loaders' images below show none;
 - RGB to HSV and back on float32 (including the rows' scalar tails):
   within 2e-6, which at hues near 360 means equal;
 - RGB to Lab and back on uint8: equal on all 2^24 values;
 - convex hulls and convex fills, thick lines (thickness 1-8, inside and
   across the image border) and polygon fills inside the image: equal.
   Polygons with vertices outside the image differ in FILL_POLY_SHARE of
   their pixels at most (OpenCV 5 changed how it clips such edges; 5% of
   random border-crossing quads differ at all);
 - elliptic kernels, erosion, dilation and connected components (4 and 8,
   labels, statistics and centroids): equal;
 - PNG: written here and read by cv2, written by cv2 (every row filter) and
   read here, equal.

The data modules against the JAX package, on the same inputs and `rng`
seeds: `load_and_transform3d` / `load_and_transform2d` (train and test,
geometric augmentation on and off, both occlusion types, the background
with a mask, a distorted camera, 2D examples with and without a camera, the
3DHP and Panoptic colour fixes): intrinsics, coordinates, rotations,
camera location, validity and field-of-view masks equal and the image
within 2e-6; the 200 default occluders (masks equal, images within 1e-6);
the helpers of `improc`, `masks`, `camera`, `boxes` and `augment`; and
`load_examples` on pickles the JAX package wrote.
"""

import pickle

import cv2
import numpy as np
import pytest

from metrabs_tpu.config import ModelConfig as JaxModelConfig
from metrabs_tpu.data import boxes as jax_boxes
from metrabs_tpu.data import camera as jax_camera
from metrabs_tpu.data import improc as jax_improc
from metrabs_tpu.data import loading as jax_loading
from metrabs_tpu.data import masks as jax_masks
from metrabs_tpu.data.augment import background as jax_background
from metrabs_tpu.data.augment import color as jax_color
from metrabs_tpu.data.augment import occlusion as jax_occlusion
from metrabs_tpu.pipeline import skeletons as jax_skeletons
from metrabs_tpu_torch.config import ModelConfig
from metrabs_tpu_torch.data import boxes, camera, cvfree, improc, loading, masks
from metrabs_tpu_torch.data.augment import background, color, occlusion
from metrabs_tpu_torch.pipeline import skeletons

FLOAT_RESIZE_ATOL = 1e-6
FILL_POLY_SHARE = 1e-3
IMAGE_ATOL = 2e-6


def _image(rng, shape, dtype):
    if dtype == np.uint8:
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return rng.uniform(0, 1, shape).astype(np.float32)


# --- cvfree against cv2 -----------------------------------------------------

@pytest.mark.parametrize('interp', [cv2.INTER_NEAREST, cv2.INTER_LINEAR], ids=['nearest', 'linear'])
@pytest.mark.parametrize('channels', [1, 3])
@pytest.mark.parametrize('dtype', [np.uint8, np.float32], ids=['uint8', 'float32'])
def test_remap_equals_cv2(dtype, channels, interp):
    rng = np.random.default_rng(1)
    h, w = 23, 31
    im = _image(rng, (h, w) if channels == 1 else (h, w, channels), dtype)
    map_x = rng.uniform(-3, w + 2, (60, 70)).astype(np.float32)
    map_y = rng.uniform(-3, h + 2, (60, 70)).astype(np.float32)
    # Exact halves and quarters, where the rounding rule shows.
    map_x[:10] = np.round(map_x[:10] * 4) / 4
    map_y[:10] = np.round(map_y[:10] * 2) / 2
    want = cv2.remap(im, map_x, map_y, interp, borderMode=cv2.BORDER_CONSTANT, borderValue=0)
    got = cvfree.remap(im, map_x, map_y, interp)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _resize_cases():
    for src, dst in (((40, 52), (13, 17)), ((120, 90), (37, 29)), ((45, 45), (44, 44))):
        yield 'area_fractional', src, dst, cv2.INTER_AREA
    for factor in (2, 3, 4):
        yield f'area_x{factor}', (24 * factor, 20 * factor), (24, 20), cv2.INTER_AREA
    yield 'linear_up', (17, 23), (61, 40), cv2.INTER_LINEAR
    yield 'linear_down', (97, 61), (40, 33), cv2.INTER_LINEAR
    yield 'linear_half', (64, 96), (32, 48), cv2.INTER_LINEAR
    # INTER_AREA enlarging an axis (demo_video's letterbox): OpenCV's linear
    # path with its area weights.
    yield 'area_up', (17, 23), (61, 40), cv2.INTER_AREA
    yield 'area_up_mixed', (40, 30), (25, 70), cv2.INTER_AREA


@pytest.mark.parametrize('case', list(_resize_cases()), ids=lambda c: c[0])
@pytest.mark.parametrize('channels', [1, 3])
@pytest.mark.parametrize('dtype', [np.uint8, np.float32], ids=['uint8', 'float32'])
def test_resize_equals_cv2(case, channels, dtype):
    name, (h, w), (oh, ow), interp = case
    rng = np.random.default_rng(2)
    im = _image(rng, (h, w) if channels == 1 else (h, w, channels), dtype)
    want = cv2.resize(im, (ow, oh), interpolation=interp)
    got = cvfree.resize(im, (ow, oh), interp)
    assert got.dtype == want.dtype and got.shape == want.shape
    if dtype == np.float32 and (interp == cv2.INTER_LINEAR or name.startswith('area_up')):
        np.testing.assert_allclose(got, want, atol=FLOAT_RESIZE_ATOL, rtol=0)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('size', [(256, 256), (64, 64), (37, 100)])
def test_cubic_resize_of_the_background_is_within_an_ulp_of_cv2(size):
    small = np.random.default_rng(3).uniform(0, 1, (8, 8, 3)).astype(np.float32)
    want = cv2.resize(small, size, interpolation=cv2.INTER_CUBIC)
    got = cvfree.resize(small, size, cvfree.INTER_CUBIC)
    np.testing.assert_allclose(got, want, atol=FLOAT_RESIZE_ATOL, rtol=0)
    with pytest.raises(NotImplementedError):
        cvfree.resize((small * 255).astype(np.uint8), size, cvfree.INTER_CUBIC)
    np.testing.assert_array_equal(cvfree.resize(small, (8, 8), cvfree.INTER_CUBIC), small)


@pytest.mark.parametrize('width', [64, 37, 7])
def test_hsv_round_trip_equals_cv2(width):
    """Widths with and without a scalar tail in OpenCV's 8-pixel loop."""
    rng = np.random.default_rng(4)
    im = rng.uniform(0, 1, (40, width, 3)).astype(np.float32)
    im[:5] = np.round(im[:5] * 4) / 4  # ties between channels
    im[5:8] = im[5:8, :, :1]  # gray: no hue
    hsv = cv2.cvtColor(im, cv2.COLOR_RGB2HSV)
    np.testing.assert_allclose(cvfree.rgb_to_hsv(im), hsv, atol=2e-6, rtol=0)
    hsv[..., 0] = np.mod(hsv[..., 0] + rng.uniform(-72, 72, hsv.shape[:2]), 360).astype(np.float32)
    hsv[..., 1] = np.minimum(hsv[..., 1] * 1.3, 1)
    hsv[:2, :2, 0] = 360.0
    np.testing.assert_allclose(cvfree.hsv_to_rgb(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB),
                               atol=2e-6, rtol=0)


def test_lab_equals_cv2_on_every_uint8_value():
    codes = np.arange(1 << 24, dtype=np.uint32)
    every = np.stack([codes >> 16, (codes >> 8) & 255, codes & 255], -1).astype(np.uint8)
    every = every.reshape(4096, 4096, 3)
    for ours, code in ((cvfree.rgb_to_lab, cv2.COLOR_RGB2LAB), (cvfree.lab_to_rgb,
                                                                cv2.COLOR_LAB2RGB)):
        want = cv2.cvtColor(every, code)
        for rows in range(0, 4096, 1024):
            np.testing.assert_array_equal(ours(every[rows:rows + 1024]),
                                          want[rows:rows + 1024], err_msg=ours.__name__)


def test_convex_hull_and_fill_equal_cv2():
    rng = np.random.default_rng(5)
    for i in range(150):
        side = int(rng.integers(10, 120))
        pts = rng.uniform(side * 0.1, side * 0.9, (int(rng.integers(4, 9)), 2)).astype(np.int32)
        hull = cv2.convexHull(pts)
        ours = cvfree.convex_hull(pts)
        assert {tuple(p) for p in ours.reshape(-1, 2)} == {tuple(p) for p in hull.reshape(-1, 2)}
        colour = rng.uniform(0, 1, 3)
        want = np.zeros((side, side, 3), np.float32)
        cv2.fillConvexPoly(want, hull, colour.tolist())
        got = cvfree.fill_convex_poly(np.zeros((side, side, 3), np.float32), ours,
                                      colour.astype(np.float32))
        np.testing.assert_array_equal(got, want, err_msg=str(pts.tolist()))


@pytest.mark.parametrize('thickness', range(1, 9))
def test_line_equals_cv2(thickness):
    rng = np.random.default_rng(6 + thickness)
    for i in range(60):
        low, high = (-25, 85) if i % 2 else (0, 60)
        p1, p2 = (tuple(int(v) for v in rng.integers(low, high, 2)) for _ in range(2))
        want = cv2.line(np.zeros((50, 60), np.uint8), p1, p2, 1, thickness=thickness)
        got = cvfree.line(np.zeros((50, 60), np.uint8), p1, p2, 1, thickness=thickness)
        np.testing.assert_array_equal(got, want, err_msg=f'{p1} {p2}')


def test_fill_poly_equals_cv2_inside_the_image():
    rng = np.random.default_rng(7)
    differing = total = 0
    for i in range(400):
        inside = i % 2 == 0
        pts = rng.integers(0, 60, (int(rng.integers(3, 7)), 2)) if inside else \
            rng.integers(-30, 90, (4, 2))
        want = cv2.fillPoly(np.zeros((60, 60), np.uint8), [pts.astype(np.int32)], 1)
        got = cvfree.fill_poly(np.zeros((60, 60), np.uint8), [pts.astype(np.int32)], 1)
        if inside:
            np.testing.assert_array_equal(got, want, err_msg=str(pts.tolist()))
        else:
            differing += int((got != want).sum())
            total += got.size
    assert differing <= FILL_POLY_SHARE * total


def test_morphology_and_components_equal_cv2():
    rng = np.random.default_rng(8)
    for k in range(1, 12):
        for ksize in ((k, k), (k, k + 2), (k + 3, k)):
            np.testing.assert_array_equal(cvfree.ellipse_kernel(ksize),
                                          cv2.getStructuringElement(cv2.MORPH_ELLIPSE, ksize))
    for trial in range(30):
        mask = (rng.uniform(size=(40, 37)) > rng.uniform(0.3, 0.8)).astype(np.uint8)
        if trial % 2:
            mask = cv2.dilate(mask, np.ones((3, 3), np.uint8))
        kernel = cvfree.ellipse_kernel(int(rng.integers(1, 8)))
        iterations = int(rng.integers(1, 3))
        for op, ours in ((cv2.MORPH_ERODE, cvfree.erode), (cv2.MORPH_DILATE, cvfree.dilate)):
            np.testing.assert_array_equal(ours(mask, kernel, iterations),
                                          cv2.morphologyEx(mask, op, kernel,
                                                           iterations=iterations))
        for connectivity in (4, 8):
            n, labels, stats, centroids = cv2.connectedComponentsWithStats(
                mask, connectivity=connectivity, ltype=cv2.CV_32S)
            got = cvfree.connected_components_with_stats(mask, connectivity)
            assert got[0] == n
            np.testing.assert_array_equal(got[1], labels)
            np.testing.assert_array_equal(got[2], stats)
            np.testing.assert_allclose(got[3], centroids, equal_nan=True)


@pytest.mark.parametrize('channels', [1, 3, 4])
def test_png_round_trips_with_cv2(tmp_path, channels):
    rng = np.random.default_rng(9)
    shape = (37, 53) if channels == 1 else (37, 53, channels)
    noise = rng.integers(0, 256, shape, dtype=np.uint8)
    smooth = cv2.resize(rng.integers(0, 256, shape[:2] and (4, 4, channels)[:len(shape)],
                                     dtype=np.uint8), (53, 37),
                        interpolation=cv2.INTER_LINEAR).reshape(shape)
    bgr = lambda im: im if channels == 1 else im[..., [2, 1, 0, 3][:channels]]
    filters = set()
    for name, im in (('noise', noise), ('smooth', smooth)):
        ours = str(tmp_path / f'ours_{name}.png')
        cvfree.write_png(ours, im)
        np.testing.assert_array_equal(cvfree.read_png(ours), im)
        np.testing.assert_array_equal(cv2.imread(ours, cv2.IMREAD_UNCHANGED), bgr(im))
        for level in (0, 1, 9):
            theirs = str(tmp_path / f'cv2_{name}_{level}.png')
            cv2.imwrite(theirs, bgr(im), [cv2.IMWRITE_PNG_COMPRESSION, level])
            np.testing.assert_array_equal(cvfree.read_png(theirs), im)
            filters |= _png_row_filters(theirs)
    assert filters == {0, 1, 2, 3, 4} or channels == 1, filters


def _png_row_filters(path):
    import struct
    import zlib
    data = open(path, 'rb').read()
    pos, idat = 8, b''
    while pos < len(data):
        length, kind = struct.unpack('>I4s', data[pos:pos + 8])
        if kind == b'IHDR':
            w, h, _, color_type = struct.unpack('>IIBB', data[pos + 8:pos + 18])
        if kind == b'IDAT':
            idat += data[pos + 8:pos + 8 + length]
        pos += 12 + length
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    return set(raw[:, 0].tolist())


def test_imread_matches_cv2_imread(tmp_path):
    """Gray and RGBA PNGs come back as 3-channel RGB, as cv2.IMREAD_COLOR
    reads them; .npy files load as they are; a JPEG decodes as cv2 decodes
    it (tests/test_torch_jpeg.py holds the decoder to cv2 in depth); an
    mp4v video's frame reads as JAX's cv2 reads it, and is readable for
    both (tests/test_torch_mp4v.py holds the decoder to FFmpeg in depth)."""
    rng = np.random.default_rng(10)
    for shape in ((20, 30), (20, 30, 3), (20, 30, 4)):
        im = rng.integers(0, 256, shape, dtype=np.uint8)
        path = str(tmp_path / f'im{len(shape)}_{shape[-1]}.png')
        cv2.imwrite(path, im)
        want = cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
        np.testing.assert_array_equal(improc.imread(path), want)
        np.testing.assert_array_equal(improc.image_extents(path), jax_improc.image_extents(path))
    np.save(tmp_path / 'im.npy', want)
    np.testing.assert_array_equal(improc.imread(str(tmp_path / 'im.npy')), want)
    np.testing.assert_array_equal(improc.image_extents(str(tmp_path / 'im.npy')), [30, 20])
    jpg = str(tmp_path / 'im.jpg')
    cv2.imwrite(jpg, want)
    np.testing.assert_array_equal(improc.imread(jpg), jax_improc.imread(jpg))
    np.testing.assert_array_equal(improc.image_extents(jpg), jax_improc.image_extents(jpg))
    writer = cv2.VideoWriter(str(tmp_path / 'v.mp4'), cv2.CAP_FFMPEG,
                             cv2.VideoWriter_fourcc(*'mp4v'), 10, (32, 24))
    for _ in range(5):
        writer.write(np.zeros((24, 32, 3), np.uint8))
    writer.release()
    video = f'{tmp_path}/v.mp4#frame=3'
    np.testing.assert_array_equal(improc.imread(video), jax_improc.imread(video))
    assert improc.is_image_readable(jpg) and improc.is_image_readable(video)
    assert jax_improc.is_image_readable(video)
    assert not improc.is_image_readable(f'{tmp_path}/v.mp4#frame=5')
    with pytest.raises(FileNotFoundError):
        improc.imread(str(tmp_path / 'missing.png'))


# --- the data modules against the JAX package ------------------------------

def test_improc_helpers_match_jax():
    rng = np.random.default_rng(11)
    im = rng.integers(0, 256, (30, 41, 3), dtype=np.uint8)
    imf = rng.uniform(-0.1, 1.1, (30, 41, 3)).astype(np.float32)
    np.testing.assert_array_equal(improc.normalize01(im), jax_improc.normalize01(im))
    np.testing.assert_array_equal(improc.normalize01(imf), jax_improc.normalize01(imf))
    for x in (im, imf):
        np.testing.assert_array_equal(improc.adjust_gamma(x, 0.67), jax_improc.adjust_gamma(x, 0.67))
    for a, b in ((None, None), (110, 145), (120, 138)):
        np.testing.assert_array_equal(improc.white_balance(im, a, b),
                                      jax_improc.white_balance(im, a, b))
    for factor in (0.3, 0.55, 0.5, 1.0, 1.7):
        for x in (im, imf, imf[..., 0]):
            got, want = improc.resize_by_factor(x, factor), jax_improc.resize_by_factor(x, factor)
            if factor > 1 and x.dtype == np.float32:  # INTER_LINEAR on float32
                np.testing.assert_allclose(got, want, atol=FLOAT_RESIZE_ATOL, rtol=0)
            else:
                np.testing.assert_array_equal(got, want)
    w = rng.uniform(0, 1, (30, 41)).astype(np.float32)
    np.testing.assert_array_equal(improc.blend_image(im, im[::-1], w),
                                  jax_improc.blend_image(im, im[::-1], w))
    assert improc.rounded_int_tuple([1.5, 2.4]) == jax_improc.rounded_int_tuple([1.5, 2.4])


def test_masks_match_jax():
    from metrabs_tpu.utils import rlemask as jax_rlemask
    rng = np.random.default_rng(12)
    mask = cv2.dilate((rng.uniform(size=(50, 43)) > 0.8).astype(np.uint8), np.ones((3, 3)))
    for fn in ('erode', 'dilate'):
        for m in (mask, mask.astype(bool)):
            np.testing.assert_array_equal(getattr(masks, fn)(m, 5, 2),
                                          getattr(jax_masks, fn)(m, 5, 2))
    for fn in ('outline', 'get_inline'):
        np.testing.assert_array_equal(getattr(masks, fn)(mask), getattr(jax_masks, fn)(mask))
    for got, want in zip(masks.largest_connected_component(mask),
                         jax_masks.largest_connected_component(mask)):
        np.testing.assert_array_equal(got, want)
    stack = rng.uniform(size=(3, 20, 24)) > 0.7
    np.testing.assert_array_equal(masks.masks_to_label_map(stack),
                                  jax_masks.masks_to_label_map(stack))
    pts = rng.uniform(2, 40, (5, 2))
    img_ours, img_jax = np.zeros((50, 43), np.uint8), np.zeros((50, 43), np.uint8)
    masks.fill_polygon(img_ours, pts, 1)
    jax_masks.fill_polygon(img_jax, pts, 1)
    np.testing.assert_array_equal(img_ours, img_jax)
    rle = jax_rlemask.encode(mask)
    assert masks.resize_mask(rle, (77, 61)) == jax_masks.resize_mask(rle, (77, 61))
    canvas = rng.integers(0, 256, (50, 43, 3), dtype=np.uint8)
    ours, theirs = canvas.copy(), canvas.copy()
    masks.draw_mask(ours, mask, (10, 200, 30))
    jax_masks.draw_mask(theirs, mask, (10, 200, 30))
    np.testing.assert_array_equal(ours, theirs)


def _cameras(distorted: bool):
    kw = dict(optical_center=np.array([100, -50, 20], np.float32),
              rot_world_to_cam=np.eye(3, dtype=np.float32),
              intrinsic_matrix=np.array([[300, 0, 160], [0, 310, 120], [0, 0, 1]], np.float32),
              distortion_coeffs=(np.array([-0.2, 0.05, 0.001, -0.001, 0.01], np.float32)
                                 if distorted else None),
              world_up=(0, -1, 0))
    return camera.Camera(**kw), jax_camera.Camera(**kw)


@pytest.mark.parametrize('interp', [cv2.INTER_LINEAR, cv2.INTER_NEAREST], ids=['linear', 'nearest'])
@pytest.mark.parametrize('antialias', [1, 2, 3])
def test_reproject_image_matches_jax(antialias, interp):
    rng = np.random.default_rng(13)
    (ours, theirs), (ours_new, theirs_new) = _cameras(True), _cameras(False)
    for cam in (ours_new, theirs_new):
        cam.turn_towards(target_image_point=np.array([150.0, 100.0]))
        cam.zoom(1.3)
        cam.rotate(roll=0.2)
        cam.center_principal_point((48, 48))
    for im in (rng.integers(0, 256, (240, 320, 3), dtype=np.uint8),
               rng.uniform(0, 1, (240, 320)).astype(np.float32)):
        np.testing.assert_array_equal(
            camera.reproject_image(im, ours, ours_new, (48, 48), interp=interp,
                                   antialias_factor=antialias),
            jax_camera.reproject_image(im, theirs, theirs_new, (48, 48), interp=interp,
                                       antialias_factor=antialias))
    points = rng.uniform(0, 300, (9, 2)).astype(np.float32)
    np.testing.assert_array_equal(camera.reproject_image_points(points, ours, ours_new),
                                  jax_camera.reproject_image_points(points, theirs, theirs_new))


def test_boxes_match_jax():
    box = np.array([10.5, 20, 30, 55], np.float32)
    for fn in ('center', 'expand_to_square'):
        np.testing.assert_array_equal(getattr(boxes, fn)(box), getattr(jax_boxes, fn)(box))
    np.testing.assert_array_equal(boxes.intersection(box, box + 7),
                                  jax_boxes.intersection(box, box + 7))
    np.testing.assert_array_equal(
        boxes.random_partial_subbox(box, np.random.default_rng(3)),
        jax_boxes.random_partial_subbox(box, np.random.default_rng(3)))


def test_default_occluders_match_jax():
    ours, theirs = occlusion.load_occluders(), jax_occlusion.load_occluders()
    assert len(ours) == len(theirs) == 200
    for (im, mask), (jax_im, jax_mask) in zip(ours, theirs):
        np.testing.assert_array_equal(mask, jax_mask)
        np.testing.assert_allclose(im, jax_im, atol=1e-6, rtol=0)


@pytest.mark.parametrize('dtype', [np.uint8, np.float32], ids=['uint8', 'float32'])
def test_appearance_augmentations_match_jax(dtype):
    rng = np.random.default_rng(14)
    im = _image(rng, (64, 64, 3), dtype)
    for seed in range(6):
        for ours, theirs in ((color.augment_color, jax_color.augment_color),
                             (occlusion.random_erase, jax_occlusion.random_erase),
                             (occlusion.object_occlude, jax_occlusion.object_occlude)):
            np.testing.assert_array_equal(ours(im.copy(), np.random.default_rng(seed)),
                                          theirs(im.copy(), np.random.default_rng(seed)))


def test_background_augmentation_matches_jax(tmp_path):
    """The synthetic background and a directory of PNG backgrounds."""
    rng = np.random.default_rng(15)
    for i in range(2):
        cv2.imwrite(str(tmp_path / f'bg{i}.png'), rng.integers(0, 256, (50, 70, 3), np.uint8))
    im = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    fgmask = np.zeros((64, 64), np.float32)
    fgmask[10:50, 20:40] = 1
    for bg_dir in (None, str(tmp_path)):
        for seed in range(3):
            for x in (im, im.astype(np.float32) / 255):
                got, want = (module.augment_background(x, fgmask, np.random.default_rng(seed),
                                                       background_dir=bg_dir)
                             for module in (background, jax_background))
                # The synthetic background's float cubic upsampling: an ulp.
                np.testing.assert_allclose(got, want, atol=FLOAT_RESIZE_ATOL, rtol=0)


def _occlusion_kind(seed: int, prob: float):
    """The occlusion type augment_appearance draws for the loader's `rng`
    seed (the appearance stream is the loader's first), and whether it
    applies it."""
    rng = np.random.default_rng(seed)
    appearance = loading._new_rng(rng)
    occlusion_rng = np.random.default_rng(appearance.integers(np.iinfo(np.int64).max))
    kind = str(occlusion_rng.choice(['objects', 'random-erase']))
    if kind == 'objects':
        return kind, occlusion_rng.uniform(0.0, 1.0) < prob
    return kind, None


def _seed_with(kind: str) -> int:
    prob = loading.LoadConfig().occlude_aug_prob
    return next(s for s in range(100) if _occlusion_kind(s, prob)[0] == kind
                and _occlusion_kind(s, prob)[1] in (True, None))


LOAD_CASES = {
    'train': dict(), 'test': dict(is_train=False), 'no_geom_aug': dict(lcfg=dict(geom_aug=False)),
    'objects': dict(seed=_seed_with('objects')),
    'random_erase': dict(seed=_seed_with('random-erase'), lcfg=dict(occlude_aug_prob=1.0)),
    'background': dict(mask=True, lcfg=dict(background_aug_prob=1.0)),
    'distorted': dict(distorted=True), 'partial': dict(lcfg=dict(partial_visibility_prob=1.0)),
    '3dhp': dict(path='data/3dhp/ts2/img_0001.png'), 'panoptic': dict(path='data/panoptic/1.png'),
    'antialias_nearest': dict(lcfg=dict(antialias_train=2, interpolation=cv2.INTER_NEAREST)),
}


def _example_pair(stream: str, distorted=False, mask=False, path='syn/0.png', with_camera=True):
    rng = np.random.default_rng(16)
    image = rng.integers(0, 256, (240, 320, 3), dtype=np.uint8)
    fgmask = None
    if mask:
        fgmask = np.zeros((240, 320), np.float32)
        fgmask[50:200, 100:220] = 1
    pose = (rng.normal(size=(17, 3)) * 200 + [0, 0, 3000]).astype(np.float32)
    coords = rng.uniform(100, 200, (14, 2)).astype(np.float32)
    coords[3] = np.nan
    out = []
    for module, cam in zip((loading, jax_loading), _cameras(distorted)):
        if stream == '3d':
            out.append(module.Example3D(image_path=path, camera=cam,
                                        bbox=np.array([90, 40, 140, 180], np.float32),
                                        world_coords=pose, image=image, mask=fgmask))
        else:
            out.append(module.Example2D(image_path=path,
                                        bbox=np.array([90, 60, 120, 150], np.float32),
                                        coords=coords, image=image, mask=fgmask,
                                        camera=cam if with_camera else None))
    return out


def _assert_same_outputs(got, want):
    assert got.keys() == want.keys()
    for key in want:
        if key == 'image':
            np.testing.assert_allclose(got[key], want[key], atol=IMAGE_ATOL, rtol=0)
        else:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert got[key].dtype == want[key].dtype, key


@pytest.mark.parametrize('case', sorted(LOAD_CASES))
def test_load_and_transform3d_matches_jax(case):
    spec = LOAD_CASES[case]
    ours, theirs = _example_pair('3d', spec.get('distorted', False), spec.get('mask', False),
                                 spec.get('path', 'syn/0.png'))
    outs = [module.load_and_transform3d(
        ex, joints.H36M_17, spec.get('is_train', True),
        np.random.default_rng(spec.get('seed', 0)), config(proc_side=64),
        module.LoadConfig(**spec.get('lcfg', {})))
        for module, ex, joints, config in ((loading, ours, skeletons, ModelConfig),
                                           (jax_loading, theirs, jax_skeletons, JaxModelConfig))]
    _assert_same_outputs(*outs)


@pytest.mark.parametrize('case', ['train', 'test', 'no_geom_aug', 'background', 'no_camera',
                                  'objects', 'random_erase'])
def test_load_and_transform2d_matches_jax(case):
    spec = dict(LOAD_CASES.get(case, {}))
    if case == 'random_erase':
        spec['lcfg'] = dict(occlude_aug_prob_2d=1.0)
    ours, theirs = _example_pair('2d', mask=spec.get('mask', False),
                                 with_camera=case != 'no_camera')
    outs = [module.load_and_transform2d(
        ex, joints.LSP_14, spec.get('is_train', True),
        np.random.default_rng(spec.get('seed', 0)), config(proc_side=64),
        module.LoadConfig(**spec.get('lcfg', {})))
        for module, ex, joints, config in ((loading, ours, skeletons, ModelConfig),
                                           (jax_loading, theirs, jax_skeletons, JaxModelConfig))]
    _assert_same_outputs(*outs)


def test_load_config_matches_jax():
    import dataclasses
    as_pairs = lambda cls: [(f.name, f.default) for f in dataclasses.fields(cls)]
    assert as_pairs(loading.LoadConfig) == as_pairs(jax_loading.LoadConfig)


def test_load_examples_reads_jax_pickles(tmp_path):
    ours, theirs = _example_pair('3d', distorted=True)
    ours2d, theirs2d = _example_pair('2d')
    path = tmp_path / 'ds.pkl'
    path.write_bytes(pickle.dumps([theirs, theirs2d, jax_loading.LoadConfig()]))
    ex3, ex2, lcfg = loading.load_examples(str(path))
    assert type(ex3) is loading.Example3D and type(ex3.camera) is camera.Camera
    assert type(ex2) is loading.Example2D and type(lcfg) is loading.LoadConfig
    got = loading.load_and_transform3d(ex3, skeletons.H36M_17, True, np.random.default_rng(1),
                                       ModelConfig(proc_side=64))
    want = loading.load_and_transform3d(ours, skeletons.H36M_17, True, np.random.default_rng(1),
                                        ModelConfig(proc_side=64))
    _assert_same_outputs(got, want)
    path.write_bytes(pickle.dumps(JaxModelConfig()))
    with pytest.raises(pickle.UnpicklingError, match='no counterpart'):
        loading.load_examples(str(path))
