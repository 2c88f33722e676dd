"""The full train -> checkpoint -> export -> package -> serve -> score loop of
the PyTorch port (`metrabs_tpu_torch`), on the card, with a production
backbone, minting trained weights for both the crop model and the person
detector: `scripts/train_to_serve_e2e.py` in torch, on the same synthetic
multi-person stick-figure world and to the same gates.

  stage 0  render multi-person scenes (the JAX script's, pixel for pixel);
           per-person Example3D + LSP-like 2D pickles; held-out val scenes
  stage 1  `apps.train.main` production config (EffNetV2-S 256px bf16, remat,
           AdamW + EMA, dual 2D/3D streams, periodic validation) ->
           checkpoints -> packaged export WITH dataset-derived bone priors
  stage 2  YOLOv4-tiny detector training (`detect.train`) on the same scenes;
           recall on the held-out scenes; detector added to the package
  stage 3  `load_pose_estimator` (asserting NO bone-prior warning) ->
           `detect_poses_batched` on the held-out scenes (BN folded, the warp
           kernel) -> Hungarian-matched multi-person metrics + GT-box
           `estimate_poses_batched` MPJPE
  stage 4  the record: the JAX script's fields, plus the card's name and power
           limit, the median step time of each stage, the peak device memory
           and the wall time

Assertion-gated: prints the record as one JSON line and then TRAIN2SERVE OK
only if every stage's checks pass.

  python scripts/train_to_serve_e2e_torch.py            # full run on the card
  python scripts/train_to_serve_e2e_torch.py --device cpu --backbone tiny \\
      --steps 60 --det-steps 30 --scenes 12 --smoke     # CPU smoke test

`--device` (default cuda; raises without CUDA) stands where the JAX script
has `--platform`; every other flag is the JAX script's. The defaults write
under runs/train2serve_torch and to TRAIN2SERVE_torch.json in the checkout.
"""

import argparse
import json
import os
import pickle
import statistics
import subprocess
import sys
import time
import warnings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

_t0 = time.time()


def tick(msg):
    print(f'[{time.time() - _t0:7.1f}s] {msg}', flush=True)


# H36M-17 template skeleton (mm; x right, y down, z forward), the JAX
# script's: bone lengths are consistent across renders so the accumulated
# bone priors and the plausibility filter are meaningful; non-planar (bent
# arms and knees) so that no yaw in `sample_pose`'s range makes a view
# degenerate.
TEMPLATE = {
    'pelv': (0, 0, 0), 'rhip': (-130, 0, 10), 'rkne': (-145, 450, 60),
    'rank': (-155, 890, 15), 'lhip': (130, 0, 10), 'lkne': (145, 450, 60),
    'lank': (155, 890, 15), 'spin': (0, -250, -20), 'neck': (0, -500, -30),
    'head': (0, -600, 10), 'htop': (0, -720, -25), 'lsho': (185, -480, -10),
    'lelb': (265, -210, 70), 'lwri': (305, 40, 150), 'rsho': (-185, -480, -10),
    'relb': (-265, -210, 70), 'rwri': (-305, 40, 150)}

# H36M joint index -> LSP-14 slot (the weak 2D stream's mapping).
LSP_FROM_H36M = [3, 2, 1, 4, 5, 6, 16, 15, 14, 11, 12, 13, 8, 10]

SCENE_SIDE = 416

# Person depth range (mm): at f=420 a 1610mm-tall figure spans ~96-210 px.
Z_RANGE = (3200, 7000)

# The detector's ground-truth boxes per image after padding (fixed shapes).
DET_MAX_PEOPLE = 3


def quality_gates(smoke: bool) -> dict:
    """The assertion-enforced bar; `smoke` only checks that every stage runs
    end to end and its outputs are finite and shaped."""
    if smoke:
        return dict(curve_ratio=float('inf'), final_mpjpe=float('inf'),
                    det_recall=-1.0, served_recall=-1.0, served_pck=-1.0,
                    served_apck=-1.0, served_mpjpe=float('inf'))
    return dict(curve_ratio=0.5, final_mpjpe=150.0, det_recall=0.85,
                served_recall=0.8, served_pck=0.5, served_apck=0.6,
                served_mpjpe=150.0)


def _template():
    from metrabs_tpu_torch.pipeline.skeletons import H36M_17
    return np.array([TEMPLATE[n] for n in H36M_17.names], np.float32)


def make_camera():
    from metrabs_tpu_torch.data.camera import Camera
    k = np.array([[420, 0, SCENE_SIDE / 2], [0, 420, SCENE_SIDE / 2],
                  [0, 0, 1]], np.float32)
    return Camera(optical_center=np.zeros(3, np.float32),
                  intrinsic_matrix=k, world_up=(0, -1, 0))


def sample_pose(rng):
    """The template turned by a yaw in +-1.2 rad (no side-on views, whose
    left and right limbs overlap), with 25 mm of noise per joint and no
    global scale jitter (an unknowable body scale would put a floor under
    the absolute error)."""
    yaw = rng.uniform(-1.2, 1.2)
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    pose = _template() @ rot.T
    pose = pose + rng.normal(size=pose.shape).astype(np.float32) * 25
    return pose


def render_scene(rng, cam, z_range=Z_RANGE):
    """One multi-person scene: image u8 [S, S, 3], list of world poses. Each
    figure is drawn as the JAX script draws it with OpenCV: its edges as
    2-pixel lines in a colour per edge, its joints as filled discs of radius
    4 (`data.cvfree`, equal to cv2)."""
    from metrabs_tpu_torch.data import cvfree
    from metrabs_tpu_torch.pipeline.skeletons import H36M_17
    img = rng.integers(0, 55, (SCENE_SIDE, SCENE_SIDE, 3),
                       dtype=np.uint8).astype(np.uint8)
    n_people = int(rng.integers(1, 4))
    poses = []
    slots = rng.permutation(3)[:n_people]
    for slot in slots:
        for _ in range(40):
            z = rng.uniform(*z_range)
            x = (slot - 1) * z * 0.28 + rng.uniform(-150, 150)
            y = rng.uniform(-80, 220)
            pose = sample_pose(rng) + np.array([x, y, z], np.float32)
            pts = cam.world_to_image(pose)
            if (pts.min() > 12 and pts.max() < SCENE_SIDE - 12):
                break
        else:
            continue
        for e, (a, b) in enumerate(H36M_17.edges):
            # Distinct per-edge colors: limbs stay identifiable even when
            # they cross (color augmentation is off in this run).
            color = (40 + e * 12, 230 - e * 9, 60 + e * 10)
            cvfree.line(img, tuple(np.round(pts[a]).astype(int)),
                        tuple(np.round(pts[b]).astype(int)), color, 2)
        for j, pt in enumerate(pts):
            color = (255, 25 + j * 13, 25 + j * 13)
            cvfree.circle(img, tuple(np.round(pt).astype(int)), 4, color, -1)
        poses.append(pose)
    return img, poses


def person_bbox(cam, pose, margin):
    pts = cam.world_to_image(pose)
    x0, y0 = pts.min(0) - margin
    x1, y1 = pts.max(0) + margin
    x0, y0 = max(x0, 0), max(y0, 0)
    x1 = min(x1, SCENE_SIDE - 1)
    y1 = min(y1, SCENE_SIDE - 1)
    return np.array([x0, y0, x1 - x0, y1 - y0], np.float32)


def scene_boxes(scenes, cam, margin=18):
    """[n_scenes, most people in a scene, 4] `person_bbox`es of every
    person, zeros where a scene has fewer people."""
    boxes = np.zeros((len(scenes), max(len(poses) for _, poses in scenes), 4), np.float32)
    for i, (_, poses) in enumerate(scenes):
        for k, pose in enumerate(poses):
            boxes[i, k] = person_bbox(cam, pose, margin)
    return boxes


def build_split(seed, n_scenes, z_range=Z_RANGE):
    """(scenes [(image, poses)], Example3D list, Example2D list, camera) of
    `n_scenes` scenes drawn from `default_rng(seed)`, the port's classes."""
    from metrabs_tpu_torch.data.loading import Example2D, Example3D
    rng = np.random.default_rng(seed)
    cam = make_camera()
    scenes, ex3d, ex2d = [], [], []
    for i in range(n_scenes):
        img, poses = render_scene(rng, cam, z_range)
        scenes.append((img, poses))
        for k, pose in enumerate(poses):
            bbox = person_bbox(cam, pose, margin=18)
            ex3d.append(Example3D(
                image_path=f'synth/scene{seed}_{i}_{k}.jpg', camera=cam,
                bbox=bbox, world_coords=pose, image=img))
            pts2d = cam.world_to_image(pose)[LSP_FROM_H36M]
            ex2d.append(Example2D(
                image_path=f'synth/scene{seed}_{i}_{k}.jpg', bbox=bbox,
                coords=pts2d.astype(np.float32), image=img, camera=cam))
    return scenes, ex3d, ex2d, cam


def card_name(device) -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`'s
    line for the card, or the device's type off the card."""
    if device.type != 'cuda':
        return device.type
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         timeout=60, check=True)
    return smi.stdout.strip().splitlines()[device.index or 0]


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--steps', type=int, default=6000)
    p.add_argument('--absloss-start-step', type=int, default=None,
                   help='step at which the ABSOLUTE-pose loss activates (default steps//5, '
                        'so ~80%% of the run trains the absolute channel)')
    p.add_argument('--det-steps', type=int, default=800)
    p.add_argument('--scenes', type=int, default=96)
    p.add_argument('--val-scenes', type=int, default=16)
    p.add_argument('--device', default='cuda',
                   help="the device to run on (default cuda; 'cpu' for a CPU run)")
    p.add_argument('--backbone', default='efficientnetv2-s',
                   help="'tiny' for the CPU smoke config")
    p.add_argument('--finetune-inference-mode', type=int, default=0,
                   help='freeze BN to inference mode for the final N steps')
    p.add_argument('--batch-size', type=int, default=16)
    p.add_argument('--det-batch', type=int, default=8)
    p.add_argument('--out', default=os.path.join(REPO, 'runs', 'train2serve_torch'))
    p.add_argument('--record', default=os.path.join(REPO, 'TRAIN2SERVE_torch.json'))
    p.add_argument('--skip-train', action='store_true',
                   help='reuse an existing package in --out (stage 3 only)')
    p.add_argument('--smoke', action='store_true',
                   help='mechanics-only run: relaxes all quality gates so a short CPU run '
                        'validates the plumbing, not learning')
    return p.parse_args(argv)


def crop_train_args(args, ds3d_path, ds2d_path, val_path, ckpt_dir, package_dir):
    """`apps.train.main`'s arguments: the JAX script's list, plus the device."""
    crop_args = [
        '--ds3d', ds3d_path, '--ds2d', ds2d_path,
        '--checkpoint-dir', ckpt_dir, '--export-dir', package_dir,
        '--backbone', args.backbone,
        '--batch-size', str(args.batch_size),
        '--batch-size-2d', str(args.batch_size),
        '--training-steps', str(args.steps),
        '--base-learning-rate', '1e-3',
        '--ema-momentum', '0.995',
        '--workers', '3', '--seed', '3',
        '--checkpoint-period', str(min(max(args.steps // 3, 1), 500)),
        '--log-period', '50',
        '--absloss-start-step', str(args.absloss_start_step),
        '--finetune-in-inference-mode', str(args.finetune_inference_mode),
        '--ds3d-val', val_path,
        '--validate-period', str(max(args.steps // 5, 1)),
        '--batch-size-test', '32',
        # Synthetic stick figures carry their entire signal in thin colored
        # strokes: random-erase occlusion deletes limbs outright and hue
        # jitter destroys the color-coded joint identities, so the appearance
        # augmentations stay off (geometric augmentation stays on for
        # held-out-scene generalization).
        '--occlude-aug-prob', '0', '--occlude-aug-prob-2d', '0',
        '--background-aug-prob', '0', '--no-color-aug',
        '--device', args.device,
    ]
    if args.backbone == 'tiny':
        # CPU smoke config: the tiny backbone is not in the builder
        # registry; substitute the smallest real one at low res.
        crop_args[crop_args.index('tiny')] = 'mobilenetv3-small'
        crop_args += ['--proc-side', '128', '--dtype', 'float32']
    return crop_args


def read_curves(log_path):
    """(val MPJPE curve, absolute curve, median step time in s) from the
    training log: the step time is the median over log windows of
    1 / steps_per_sec (the windows exclude validation and checkpoints)."""
    curve, abs_curve, step_times = [], [], []
    with open(log_path) as f:
        for line in f:
            rec = json.loads(line)
            if 'val_mean_error' in rec:
                curve.append((rec['step'], rec['val_mean_error']))
            if 'val_mean_error_abs' in rec:
                abs_curve.append((rec['step'], rec['val_mean_error_abs']))
            if 'steps_per_sec' in rec:
                step_times.append(1.0 / rec['steps_per_sec'])
    return curve, abs_curve, statistics.median(step_times) if step_times else float('nan')


def train_detector(args, train_scenes, cam, device):
    """Stage 2's training: YOLOv4-tiny@416 float32 from flax's default
    initialisation (seeded), Adam on the cosine schedule, batches of
    `--det-batch` training scenes with tight boxes. Returns (the model, the
    median step time in s)."""
    import torch

    from metrabs_tpu_torch.apps.train import init_like_flax_
    from metrabs_tpu_torch.detect.train import (
        build_targets, create_detector_train_state, make_detector_train_step)
    from metrabs_tpu_torch.detect.yolov4 import YOLOv4Tiny
    from metrabs_tpu_torch.train import optim

    det_model = init_like_flax_(YOLOv4Tiny(), 11)
    det_tx = optim.Adam(optim.cosine_decay_schedule(1e-3, args.det_steps, alpha=0.05))
    det_state = create_detector_train_state(det_model, det_tx, device=device)
    det_step = make_detector_train_step(det_model, det_tx, input_size=SCENE_SIDE)
    det_rng = np.random.default_rng(21)
    sync = torch.cuda.synchronize if device.type == 'cuda' else (lambda: None)

    def det_batch():
        idx = det_rng.integers(0, len(train_scenes), args.det_batch)
        imgs = np.stack([train_scenes[i][0] for i in idx])
        # Tight boxes (margin 2, the stroke width): the plausibility filter's
        # box-consistency check demands that the projected pose cover over
        # half the detection box, which assumes tight person boxes.
        boxes = [np.stack([person_bbox(cam, p, margin=2) for p in train_scenes[i][1]])
                 for i in idx]
        targets, masks, gtb, gtv = build_targets(boxes, SCENE_SIDE)
        pad = DET_MAX_PEOPLE - gtb.shape[1]
        gtb = np.pad(gtb, ((0, 0), (0, pad), (0, 0)))
        gtv = np.pad(gtv, ((0, 0), (0, pad)))
        return imgs.astype(np.float32) / 255.0, targets, masks, gtb, gtv

    times = []
    for i in range(args.det_steps):
        batch = det_batch()
        sync()
        t0 = time.perf_counter()
        det_state, det_loss = det_step(det_state, *batch)
        sync()
        times.append(time.perf_counter() - t0)
        if (i + 1) % 100 == 0 or i == 0:
            tick(f'det step {i + 1}: loss={float(det_loss):.4f}')
    det_model.eval().requires_grad_(False)
    return det_model, statistics.median(times) if times else float('nan')


def main(argv=None):
    global _t0
    _t0 = time.time()
    args = parse_args(argv)
    gate = quality_gates(args.smoke)
    if args.absloss_start_step is None:
        args.absloss_start_step = args.steps // 5

    import torch

    from metrabs_tpu_torch.pipeline.estimator import checked_device
    device = checked_device(args.device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    card = card_name(device)
    tick(f'device: {device} ({card}); torch {torch.__version__}')

    tick('stage 0: rendering synthetic multi-person scenes')
    os.makedirs(args.out, exist_ok=True)
    train_scenes, train3d, train2d, cam = build_split(7, args.scenes)
    val_scenes, val3d, _, _ = build_split(1007, args.val_scenes)
    ds3d_path = os.path.join(args.out, 'ds3d.pkl')
    ds2d_path = os.path.join(args.out, 'ds2d.pkl')
    val_path = os.path.join(args.out, 'ds3d_val.pkl')
    for path, data in ((ds3d_path, train3d), (ds2d_path, train2d),
                       (val_path, val3d)):
        with open(path, 'wb') as f:
            pickle.dump(data, f)
    tick(f'{len(train3d)} train people / {len(val3d)} val people rendered')

    package_dir = os.path.join(args.out, 'package')
    ckpt_dir = os.path.join(args.out, 'ckpt')
    log_path = os.path.join(ckpt_dir, 'train_log.jsonl')

    if not args.skip_train:
        tick('stage 1: crop-model training (production config)')
        from metrabs_tpu_torch.apps import train as train_app
        if os.path.exists(log_path):
            os.remove(log_path)
        train_app.main(crop_train_args(args, ds3d_path, ds2d_path, val_path, ckpt_dir,
                                       package_dir))
        tick('stage 1 done: package exported')

    with open(os.path.join(package_dir, 'manifest.json')) as f:
        manifest = json.load(f)
    assert manifest.get('bone_mean_lengths'), \
        'export did not ship dataset-derived bone priors'
    tick('bone priors present in manifest: ok')

    curve, abs_curve, crop_step_s = read_curves(log_path)
    assert curve, 'no validation records in the training log'
    tick('val MPJPE curve: ' + ', '.join(f'{s}:{v:.0f}mm' for s, v in curve))
    if abs_curve:
        tick('val ABSOLUTE MPJPE curve: ' + ', '.join(f'{s}:{v:.0f}mm' for s, v in abs_curve))
    # Either the curve halves from its first recorded point, or the model is
    # already well converged: 60 mm on held-out scenes is PCK@150 ~0.99.
    assert (curve[-1][1] < curve[0][1] * gate['curve_ratio']
            or curve[-1][1] < min(60.0, gate['final_mpjpe'])), (
        f'training did not reduce val MPJPE 2x nor converge: {curve[0]} -> {curve[-1]}')
    assert curve[-1][1] < gate['final_mpjpe'], (
        f'final val MPJPE {curve[-1][1]:.1f}mm too high for the synthetic set')

    # ---- stage 2: detector training -------------------------------------
    from metrabs_tpu_torch.detect.yolov4 import PersonDetector
    from metrabs_tpu_torch.eval.harness import box_recall
    from metrabs_tpu_torch.io.packaging import add_detector_to_package
    from metrabs_tpu_torch.io.weights import flax_variables_from_state_dict

    val_imgs = np.stack([s[0] for s in val_scenes])
    det_path = os.path.join(package_dir, 'detector.msgpack')
    det_step_s = float('nan')
    if not args.skip_train or not os.path.exists(det_path):
        tick('stage 2: detector training (YOLOv4-tiny)')
        det_model, det_step_s = train_detector(args, train_scenes, cam, device)
        detector = PersonDetector(det_model, input_size=SCENE_SIDE)
        with torch.inference_mode():
            boxes5, bvalid = detector.detect_batched(
                torch.as_tensor(val_imgs, device=device), threshold=0.3, max_detections=8)
        det_recall, det_iou = box_recall(
            boxes5.cpu().numpy(), bvalid.cpu().numpy(),
            [[person_bbox(cam, p, margin=2) for p in poses] for _, poses in val_scenes])
        n_gt = sum(len(poses) for _, poses in val_scenes)
        tick(f'detector val: recall@0.5={det_recall:.3f} mean-IoU={det_iou:.3f} over '
             f'{n_gt} GT boxes')
        assert det_recall >= gate['det_recall'], \
            f'detector recall {det_recall:.3f} < {gate["det_recall"]}'
        det_vars = flax_variables_from_state_dict(
            {k: v.detach().cpu() for k, v in det_model.state_dict().items()})
        add_detector_to_package(
            package_dir, det_vars, detector_type='yolov4-tiny',
            detector_dtype='float32', detector_input_size=SCENE_SIDE)
        tick('detector added to package')
    else:
        det_recall, det_iou = float('nan'), float('nan')

    # ---- stage 3: serve the package -------------------------------------
    tick('stage 3: serving the trained package')
    from metrabs_tpu_torch.eval.harness import matched_pose_metrics
    from metrabs_tpu_torch.io.packaging import load_pose_estimator

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        est = load_pose_estimator(package_dir, device=device)
    prior_warnings = [w for w in caught if 'bone_mean_lengths' in str(w.message)]
    assert not prior_warnings, (
        'the packaged estimator still warns about missing bone priors: '
        f'{[str(w.message) for w in prior_warnings]}')
    tick('load_pose_estimator: no bone-prior warning')

    intrinsics = np.tile(cam.intrinsic_matrix[None], (len(val_scenes), 1, 1))
    out = est.detect_poses_batched(val_imgs, intrinsic_matrix=intrinsics, num_aug=2,
                                   max_detections=8, detector_threshold=0.3)
    poses3d = out['poses3d'].cpu().numpy()
    valid = out['valid'].cpu().numpy().astype(bool)
    assert np.all(np.isfinite(poses3d[valid])), 'non-finite served poses at valid rows'

    preds_per_frame = [poses3d[i][valid[i]] for i in range(len(val_scenes))]
    gts_per_frame = [list(s[1]) for s in val_scenes]
    matched = matched_pose_metrics(preds_per_frame, gts_per_frame,
                                   threshold_mm=150.0, root_index=0)
    tick(f'detect_poses served eval: {matched}')
    assert matched['recall'] >= gate['served_recall'], matched
    assert matched['matched_pck'] >= gate['served_pck'], matched
    # Absolute camera-space PCK@150: the scenes carry exact intrinsics, so a
    # trained absolute channel must clear the gate.
    assert matched['matched_apck'] >= gate['served_apck'], matched

    # GT-box crop-model eval through the served estimator (user boxes,
    # confidence 1).
    out_gt = est.estimate_poses_batched(val_imgs, scene_boxes(val_scenes, cam),
                                        intrinsic_matrix=intrinsics, num_aug=2)
    poses_gt = out_gt['poses3d'].cpu().numpy()
    errs = []
    for i, (_, poses) in enumerate(val_scenes):
        for k, gt_pose in enumerate(poses):
            pred = poses_gt[i, k]
            rr = ((pred - pred[:1]) - (gt_pose - gt_pose[:1]))
            errs.append(np.linalg.norm(rr, axis=-1).mean())
    mpjpe_served = float(np.mean(errs))
    tick(f'estimate_poses (GT boxes) served root-rel MPJPE: {mpjpe_served:.1f}mm over '
         f'{len(errs)} people')
    assert mpjpe_served < gate['served_mpjpe'], mpjpe_served

    # ---- stage 4: the record ---------------------------------------------
    record = dict(
        smoke=args.smoke,
        backbone=args.backbone, steps=args.steps, det_steps=args.det_steps,
        absloss_start_step=args.absloss_start_step,
        n_train_people=len(train3d), n_val_people=len(val3d),
        val_mpjpe_curve=curve, val_abs_mpjpe_curve=abs_curve,
        detector_recall=det_recall,
        detector_mean_iou=det_iou,
        detect_poses_matched=matched, mpjpe_served_gt_boxes=mpjpe_served,
        device=card, steps_per_s=1.0 / crop_step_s,
        crop_step_median_s=crop_step_s, det_step_median_s=det_step_s,
        peak_memory_gib=(torch.cuda.max_memory_allocated(device) / 2**30
                         if device.type == 'cuda' else None),
        wall_s=time.time() - _t0)
    with open(args.record, 'w') as f:
        json.dump(record, f, indent=2)
    tick(f'record written to {args.record}')
    print(json.dumps(record), flush=True)
    print('TRAIN2SERVE OK', flush=True)
    return record


if __name__ == '__main__':
    main()
