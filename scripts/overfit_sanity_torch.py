"""End-to-end learning sanity of the port's training stack (the counterpart
of `scripts/overfit_sanity.py`): the crop model must learn pose estimation
from synthetic stick-figure images.

    python scripts/overfit_sanity_torch.py [--steps 900]
    python scripts/overfit_sanity_torch.py --backbone efficientnetv2-s

Renders the JAX script's stick figures (the same poses from the same seed,
drawn with `data/cvfree.py`'s line and circle, which equal cv2's bit for
bit), loads them through `data/loading.py::load_and_transform3d`, trains the
tiny crop model (64 px, float32, depth 4) for `--steps` steps on them and
reports the root-relative MPJPE before and after on the training set. JAX's
bar: the MPJPE must at least halve. `--backbone efficientnetv2-s` runs the
production configuration: 256 px, bf16 compute, blocks rematerialised,
AdamW + EMA. Weights are minted from a seed (0.8x He), so no download is
needed; each step draws from a generator seeded with its index, as JAX's
script passes `PRNGKey(i)`. Prints the run and one JSON line; exits 1 when
the bar is missed. Defaults to the card and raises without CUDA (`--device
cpu` for tests).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scripts import _minting_torch as minting  # noqa: E402
from scripts import _tracelib_torch as tracelib  # noqa: E402

BAR = 0.5  # the MPJPE after must be below this share of the MPJPE before
# LSP-14's joints in H36M-17 order (the JAX script's 2D stream).
GROUPS_JOINTS = [3, 2, 1, 4, 5, 6, 16, 15, 14, 11, 12, 13, 8, 10]
K_RENDER = np.array([[500, 0, 320], [0, 500, 240], [0, 0, 1]], np.float32)


def make_camera():
    from metrabs_tpu_torch.data.camera import Camera
    return Camera(optical_center=np.zeros(3, np.float32), intrinsic_matrix=K_RENDER,
                  world_up=(0, -1, 0))


def render(pts: np.ndarray, edges) -> np.ndarray:
    """The JAX script's drawing of projected joints `pts` [17, 2]: green
    3 px bones, then a filled 5 px circle per joint, on a 640x480 frame of
    grey 32."""
    from metrabs_tpu_torch.data import cvfree

    img = np.full((480, 640, 3), 32, np.uint8)
    for a, b in edges:
        cvfree.line(img, tuple(np.round(pts[a]).astype(int)), tuple(np.round(pts[b]).astype(int)),
                    (0, 255, 0), 3)
    for j, pt in enumerate(pts):
        color = (255, 30 + j * 12, 30 + j * 12)
        cvfree.circle(img, tuple(np.round(pt).astype(int)), 5, color, -1)
    return img


def render_examples(n: int, rng: np.random.Generator):
    """`n` Example3D of random poses ~220 mm around a root 3.5 m ahead, drawn
    into their images, with boxes around the projections plus 20 px."""
    from metrabs_tpu_torch.data.loading import Example3D
    from metrabs_tpu_torch.pipeline.skeletons import H36M_17

    examples = []
    for i in range(n):
        cam = make_camera()
        pose = (rng.normal(size=(17, 3)) * 220 + [0, 0, 3500]).astype(np.float32)
        pts = cam.world_to_image(pose)
        x0, y0 = pts.min(0) - 20
        x1, y1 = pts.max(0) + 20
        examples.append(Example3D(
            image_path=f'synthetic/stick_{i}.jpg', camera=cam,
            bbox=np.array([x0, y0, x1 - x0, y1 - y0], np.float32), world_coords=pose,
            image=render(pts, H36M_17.edges)))
    return examples


def make_batches(examples, cfg):
    """(batch3d, batch2d) numpy dicts: every example loaded without
    augmentation, and the same images with LSP-14 2D labels."""
    from metrabs_tpu_torch.data.loading import LoadConfig, load_and_transform3d
    from metrabs_tpu_torch.pipeline.skeletons import H36M_17

    lcfg = LoadConfig(geom_aug=False, occlude_aug_prob=0, color_aug=False,
                      background_aug_prob=0, partial_visibility_prob=0)
    loaded = [load_and_transform3d(ex, H36M_17, False, np.random.default_rng(1), cfg, lcfg)
              for ex in examples]
    batch3d = {k: np.stack([d[k] for d in loaded])
               for k in ('image', 'intrinsics', 'coords3d_true', 'joint_validity_mask')}
    batch2d = dict(image=batch3d['image'], intrinsics=batch3d['intrinsics'],
                   coords2d_true=np.stack([d['coords2d_true'][GROUPS_JOINTS] for d in loaded]),
                   joint_validity_mask=np.ones((len(examples), 14), bool))
    return batch3d, batch2d


def build(backbone: str, steps: int, device, proc_side=None):
    """(train state, step, ModelConfig, TrainConfig) of the JAX script's
    configurations: tiny (64 px, stride 32, depth 4, float32) or a real
    backbone at 256 px in bf16 with remat."""
    tcfg = dict(training_steps=steps, base_learning_rate=1e-3, absloss_start_step=50)
    if backbone == 'tiny':
        return minting.minted_trainer(
            'tiny', proc_side or 64, device, 'float32', remat=False,
            model_config=dict(stride_train=32, stride_test=32, depth=4), **tcfg)
    return minting.minted_trainer(backbone, proc_side or 256, device, 'bfloat16', remat=True,
                                  **tcfg)


def evaluate(state, cfg, batch3d, device) -> dict:
    """compute_pose3d_metrics of the model's eval-mode predictions on the
    training set, as floats."""
    from metrabs_tpu_torch.eval.metrics import compute_pose3d_metrics

    model = state.model
    model.eval()
    with torch.no_grad():
        preds = model(torch.as_tensor(batch3d['image'], device=device).to(
            getattr(torch, cfg.dtype)), torch.as_tensor(batch3d['intrinsics'], device=device))
    model.train()
    m = compute_pose3d_metrics(preds, batch3d['coords3d_true'], batch3d['joint_validity_mask'],
                               device=device)
    return {k: float(v) for k, v in m.items()}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    # 900 steps: JAX's 2x bar with margin (its exponential-decay schedule
    # scales with --steps, so more steps also decay slower early on).
    parser.add_argument('--steps', type=int, default=900)
    parser.add_argument('--n-examples', type=int, default=32)
    parser.add_argument('--backbone', default='tiny',
                        help="'tiny' or a builder name like 'efficientnetv2-s' (256 px bf16)")
    parser.add_argument('--proc-side', type=int, default=None)
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv)

    from metrabs_tpu_torch.pipeline.estimator import checked_device
    device = checked_device(args.device)
    rng = np.random.default_rng(0)
    state, step, cfg, tcfg = build(args.backbone, args.steps, device, args.proc_side)
    batch3d, batch2d = make_batches(render_examples(args.n_examples, rng), cfg)
    b3 = {k: torch.as_tensor(v, device=device) for k, v in batch3d.items()}
    b2 = {k: torch.as_tensor(v, device=device) for k, v in batch2d.items()}

    m0 = evaluate(state, cfg, batch3d, device)
    print(f'before: MPJPE={m0["mean_error"]:.1f}mm abs={m0["mean_error_abs"]:.1f}mm', flush=True)
    t0 = time.time()
    losses = []
    for i in range(args.steps):
        gen = torch.Generator(device=device).manual_seed(i)
        losses.append(step(state, b3, b2, generator=gen)['loss'])
        if (i + 1) % 100 == 0:
            print(f'step {i + 1}: loss={float(losses[-1]):.4f}', flush=True)
    losses = [float(v) for v in losses]
    train_s = time.time() - t0
    print(f'{args.steps} steps in {train_s:.0f}s')
    m1 = evaluate(state, cfg, batch3d, device)
    improvement = m0['mean_error'] / max(m1['mean_error'], 1e-9)
    passed = m1['mean_error'] < m0['mean_error'] * BAR
    print(f'after:  MPJPE={m1["mean_error"]:.1f}mm abs={m1["mean_error_abs"]:.1f}mm '
          f'PCK150={m1["mean_pck"]:.3f}')
    print(f'rootrel MPJPE improved {improvement:.1f}x')
    print('LEARNING SANITY PASSED' if passed else
          'LEARNING SANITY FAILED: training failed to learn')
    result = dict(backbone=args.backbone, proc_side=cfg.proc_side, dtype=cfg.dtype,
                  remat=cfg.backbone_remat, steps=args.steps, n_examples=args.n_examples,
                  device=str(device), mpjpe_before=m0['mean_error'],
                  mpjpe_after=m1['mean_error'], mpjpe_abs_before=m0['mean_error_abs'],
                  mpjpe_abs_after=m1['mean_error_abs'], pck150_after=m1['mean_pck'],
                  improvement=improvement, passed=passed, train_s=train_s,
                  ms_per_step=train_s / max(args.steps, 1) * 1e3,
                  loss_first=losses[0] if losses else None,
                  loss_last=losses[-1] if losses else None)
    if device.type == 'cuda':
        result['card'] = tracelib.card_name()
        print(result['card'])
    print(json.dumps(result))
    return result


if __name__ == '__main__':
    sys.exit(0 if main()['passed'] else 1)
