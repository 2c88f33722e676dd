"""End-to-end verification drive of the PyTorch port (`metrabs_tpu_torch`)
on the card (`scripts/verify_e2e.py` in torch): the public `PoseEstimator`
API on a real photograph, exercising the GroupNorm ResNet crop model in
bfloat16, the TTA aug axis (`average_aug=False`), a degenerate [0, 0, 0, 0]
box, the `lsp_14` skeleton gather, `detect_poses_batched` with a bfloat16
YOLOv4-tiny detector and `detect_poses_stream` (K=2 identical frame
batches, whose slices must be equal). Weights are drawn from fixed seeds
(flax's default initialisation); nothing is downloaded. Prints stage
timestamps, so that a hang is attributable, and VERIFY OK only if every
check passed.

  python scripts/verify_e2e_torch.py                  # on the card
  python scripts/verify_e2e_torch.py --device cpu     # on the CPU

The image is tests/torch_fixtures/jpeg/frame_3dpw_1080x1920.jpg (a portrait
3DPW frame, 1080 wide), decoded by the port's JPEG decoder; the boxes are
the JAX script's.
"""

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

IMAGE = os.path.join(REPO, 'tests', 'torch_fixtures', 'jpeg', 'frame_3dpw_1080x1920.jpg')
BOXES = np.array([[230, 340, 280, 700], [620, 310, 330, 750], [0, 0, 0, 0]], np.float32)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--device', default='cuda',
                   help="the device to run on (default cuda; 'cpu' for a CPU run)")
    p.add_argument('--image', default=IMAGE)
    args = p.parse_args(argv)
    t0 = time.time()

    def tick(msg):
        print(f'[{time.time() - t0:7.1f}s] {msg}', flush=True)

    import torch

    from metrabs_tpu_torch.apps.train import init_like_flax_
    from metrabs_tpu_torch.config import ModelConfig
    from metrabs_tpu_torch.data.improc import imread
    from metrabs_tpu_torch.detect.yolov4 import PersonDetector, YOLOv4Tiny
    from metrabs_tpu_torch.models.metrabs import build_crop_model
    from metrabs_tpu_torch.pipeline import bone_priors
    from metrabs_tpu_torch.pipeline.estimator import PoseEstimator, checked_device
    from metrabs_tpu_torch.pipeline.skeletons import H36M_17

    device = checked_device(args.device)
    print(device, torch.cuda.get_device_name(device) if device.type == 'cuda' else '',
          flush=True)
    img = imread(args.image)
    print('image', img.shape, flush=True)

    # The crop model on the GroupNorm ResNet, in bfloat16 (the loader's
    # layout: float32 weights drawn, then each submodule cast).
    cfg = ModelConfig(proc_side=256, depth=8, n_joints=17, dtype='bfloat16',
                      backbone='resnet50v1-5-groupnorm', backbone_scan_blocks=False)
    model = init_like_flax_(build_crop_model(cfg), 0).to(device).eval()
    for child in model.children():
        child.to(torch.bfloat16)
    model.requires_grad_(False)
    tick('init done')
    priors = bone_priors.priors_for_joint_info(H36M_17)
    est = PoseEstimator(model, H36M_17, cfg, bone_mean_lengths=priors, device=device)
    tick('estimate_poses start')
    out = est.estimate_poses(img, BOXES, num_aug=2, average_aug=False)
    p = out['poses3d']
    print('estimate_poses (GN resnet, aug axis, degenerate box):', p.shape,
          'finite:', bool(np.all(np.isfinite(p))), flush=True)
    assert p.shape == (3, 2, 17, 3), p.shape
    assert np.all(np.isfinite(p)), 'non-finite poses from estimate_poses'

    tick('first done')
    out14 = est.estimate_poses(img, BOXES[:2], num_aug=2, skeleton='lsp_14')
    print('lsp_14:', out14['poses3d'].shape, flush=True)
    assert out14['poses3d'].shape == (2, 14, 3)

    # The detector path with a bfloat16 YOLOv4-tiny.
    tick('lsp done')
    det_model = init_like_flax_(YOLOv4Tiny(), 1).to(device, torch.bfloat16).eval()
    det_model.requires_grad_(False)
    det = PersonDetector(det_model, input_size=416)
    est2 = PoseEstimator(model, H36M_17, cfg, detector=det, bone_mean_lengths=priors,
                         device=device)
    tick('det init done')
    out2 = est2.detect_poses_batched(img[None], num_aug=2, max_detections=4,
                                     detector_threshold=0.0)
    p2 = out2['poses3d'].cpu().numpy()
    v2 = out2['valid'].cpu().numpy().astype(bool)
    finite_at_valid = bool(np.all(np.isfinite(p2[v2])))
    print('detect_poses_batched (bf16 tiny detector):', p2.shape, 'valid:', int(v2.sum()),
          'finite-at-valid ok:', finite_at_valid, flush=True)
    assert p2.shape == (1, 4, 17, 3), p2.shape
    assert finite_at_valid, 'non-finite poses at valid detection rows'
    assert sorted(out2.keys()) == ['boxes', 'poses2d', 'poses3d', 'valid']
    print('keys:', sorted(out2.keys()), flush=True)

    tick('stream start')
    imgs_k = np.stack([img, img])[:, None]
    out3 = est2.detect_poses_stream(imgs_k, num_aug=2, max_detections=4,
                                    detector_threshold=0.0)
    p3 = out3['poses3d'].cpu().numpy()
    slices_equal = bool(np.allclose(p3[0], p3[1], equal_nan=True))
    print('detect_poses_stream (K=2):', p3.shape, 'slices equal:', slices_equal, flush=True)
    assert p3.shape == (2, 1, 4, 17, 3), p3.shape
    assert slices_equal, 'stream slices for identical frames diverged'
    # VERIFY OK is gated by every assert above: it only prints if all
    # checks actually passed.
    print('VERIFY OK', flush=True)


if __name__ == '__main__':
    main()
