"""The port's pose drawing (`metrabs_tpu_torch/utils/viz.py`,
`apps/demo_image.draw_poses`) against the JAX package's cv2 and matplotlib
drawing: the 2D overlays equal JAX's images bit for bit (the `valid` mask,
non-finite joints, joints off the image, thicknesses 1-4); the 3D scene puts
every joint within a pixel of where matplotlib's own transform puts it
(`proj3d.proj_transform`, then `ax.transData`, in JAX's figure at dpi 110
before `bbox_inches='tight'`), with and without the image panel and for both
`world_up` signs; and the scene is written and returned as documented.
"""

import matplotlib
import numpy as np
import pytest

matplotlib.use('Agg')  # headless, as the JAX helper expects

from metrabs_tpu.apps import demo_image as jax_demo_image  # noqa: E402
from metrabs_tpu.utils import viz as jax_viz  # noqa: E402
from metrabs_tpu_torch.apps import demo_image  # noqa: E402
from metrabs_tpu_torch.data import improc  # noqa: E402
from metrabs_tpu_torch.pipeline.skeletons import H36M_17, SMPL_24  # noqa: E402
from metrabs_tpu_torch.utils import viz  # noqa: E402

H, W = 120, 160


def random_poses2d(rng, n_poses: int, n_joints: int, spread: float = 1.6) -> np.ndarray:
    """Joints over and beyond the image (up to `spread` times its size on
    each side), a few non-finite."""
    poses = np.stack([rng.uniform(-(spread - 1) * W, spread * W, (n_poses, n_joints)),
                      rng.uniform(-(spread - 1) * H, spread * H, (n_poses, n_joints))], -1)
    nan_rows = rng.random((n_poses, n_joints)) < 0.1
    poses[nan_rows, rng.integers(0, 2)] = np.nan
    poses[rng.random((n_poses, n_joints)) < 0.05] = np.inf
    return poses.astype(np.float32)


@pytest.mark.parametrize('thickness', [1, 2, 3, 4])
@pytest.mark.parametrize('seed', range(4))
def test_draw_poses_2d_equals_jax(seed, thickness):
    rng = np.random.default_rng(seed)
    image = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    joint_info = (H36M_17, SMPL_24)[seed % 2]
    poses = random_poses2d(rng, 7, joint_info.n_joints)
    valid = rng.random(7) < 0.7 if seed % 3 else None
    got = viz.draw_poses_2d(image, poses, joint_info.edges, valid, thickness)
    want = jax_viz.draw_poses_2d(image, poses, joint_info.edges, valid, thickness)
    np.testing.assert_array_equal(got, want)
    assert not np.shares_memory(got, image)


@pytest.mark.parametrize('seed', range(4))
def test_demo_draw_poses_equals_jax(seed):
    """JAX's `draw_poses` draws every joint (no finiteness check), so the
    poses here are finite, on and off the image."""
    rng = np.random.default_rng(10 + seed)
    image = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    poses = np.nan_to_num(random_poses2d(rng, 4, 17, spread=1.3), nan=5.0, posinf=-7.0)
    got = demo_image.draw_poses(image, poses, H36M_17.edges)
    np.testing.assert_array_equal(got, jax_demo_image.draw_poses(image, poses, H36M_17.edges))


def matplotlib_pixels(poses3d, valid, world_up, image, poses2d):
    """Each plotted joint's canvas pixel in JAX's figure: (pose index,
    [J, 2]) pairs, NaN where the joint is not finite."""
    from mpl_toolkits.mplot3d import proj3d
    import matplotlib.pyplot as plt

    fig = jax_viz.plot_poses_3d(poses3d, H36M_17.edges, valid=valid, world_up=world_up,
                                image=image, poses2d=poses2d)
    fig.set_dpi(viz.DPI)
    fig.canvas.draw()
    ax = fig.axes[-1]
    height = fig.canvas.get_width_height()[1]
    m = ax.get_proj()
    out = []
    for p, pose in enumerate(poses3d):
        if valid is not None and not valid[p]:
            continue
        x, y = pose[:, 0], pose[:, 2]
        z = -pose[:, 1] if world_up[1] < 0 else pose[:, 1]
        xs, ys, _ = proj3d.proj_transform(x, y, z, m)
        disp = ax.transData.transform(np.column_stack([xs, ys]))
        out.append((p, np.stack([disp[:, 0], height - disp[:, 1]], -1)))
    size = tuple(fig.canvas.get_width_height())
    plt.close(fig)
    return out, size


@pytest.mark.parametrize('with_image', [False, True])
@pytest.mark.parametrize('world_up', [(0, -1, 0), (0, 1, 0)])
def test_plot_poses_3d_joints_where_matplotlib_puts_them(with_image, world_up):
    rng = np.random.default_rng(int(with_image) + 2 * (world_up[1] > 0))
    poses3d = rng.normal(0, 350, (4, 17, 3)) + [200, -300, 4500]
    poses3d[1, 5] = np.nan
    valid = np.array([True, False, True, True])
    image = rng.integers(0, 256, (240, 180, 3), dtype=np.uint8) if with_image else None
    poses2d = rng.uniform(0, 180, (4, 17, 2)) if with_image else None
    want, size = matplotlib_pixels(poses3d, valid, world_up, image, poses2d)
    scene = viz.Scene3D(poses3d, H36M_17.edges, valid=valid, world_up=world_up,
                        with_image=with_image)
    assert (scene.width_px, scene.height_px) == size
    got = scene.pose_pixels()
    assert [p for p, _ in got] == [p for p, _ in want] == [0, 2, 3]
    for (_, g), (_, w) in zip(got, want):
        finite = np.isfinite(w).all(1)
        assert finite.sum() >= 16
        np.testing.assert_allclose(g[finite], w[finite], atol=1.0)


def test_plot_poses_3d_draws_each_pose_at_its_joints():
    """The uncropped canvas has the pose's colour at its joints' pixels."""
    rng = np.random.default_rng(5)
    poses3d = rng.normal(0, 300, (2, 17, 3)) + [0, 0, 4000]
    scene = viz.Scene3D(poses3d, H36M_17.edges)
    canvas = scene.render()
    for p, px in scene.pose_pixels():
        colour = np.array(viz._COLORS[p % len(viz._COLORS)])
        hits = [np.any(np.all(canvas[int(y) - 1:int(y) + 2, int(x) - 1:int(x) + 2] == colour, -1))
                for x, y in px]
        assert np.mean(hits) > 0.8


def test_plot_poses_3d_writes_and_returns(tmp_path):
    rng = np.random.default_rng(6)
    poses3d = rng.normal(0, 300, (17, 3)) + [0, 0, 4000]  # one [J, 3] pose
    image = rng.integers(0, 256, (90, 120, 3), dtype=np.uint8)
    poses2d = rng.uniform(0, 100, (1, 17, 2))
    out = viz.plot_poses_3d(poses3d, H36M_17.edges, image=image, poses2d=poses2d)
    assert out.dtype == np.uint8 and out.ndim == 3 and out.shape[2] == 3
    assert out.shape[0] <= 6 * viz.DPI and out.shape[1] <= 12 * viz.DPI
    assert np.all(out[0] == 255) and np.all(out[:, 0] == 255)  # the padding
    for name in ('scene.jpg', 'scene.png'):
        path = tmp_path / name
        assert viz.plot_poses_3d(poses3d, H36M_17.edges, out_path=str(path), image=image,
                                 poses2d=poses2d) is None
        back = improc.imread(str(path))
        assert back.shape == out.shape
        if name.endswith('.png'):
            np.testing.assert_array_equal(back, out)
    # No valid pose: the empty axes, as matplotlib draws them.
    empty = viz.plot_poses_3d(poses3d[None], H36M_17.edges, valid=np.array([False]))
    assert empty.shape[0] > 100 and np.any(empty != 255)


def test_bitmap_font_covers_the_labels():
    for text in ('x (mm)', 'depth (mm)', 'up (mm)', '-1250.5', '0123456789'):
        assert all(ch in viz._GLYPHS for ch in text)
