"""PyTorch / CUDA port of `metrabs_tpu` for NVIDIA Hopper GPUs.

The JAX package `metrabs_tpu` is the reference: each module here mirrors the
module of the same path there, keeps its public layouts (images NHWC
[N, H, W, 3], matrices [N, 3, 3], poses [..., J, 3]) and is tested against
it on the same inputs (`tests/test_torch_*.py`). This package imports torch
and nothing of jax, flax or `metrabs_tpu`: it keeps its own copies of the
framework-free modules it needs (`config`, `utils.joint_info`,
`pipeline.tta`, `pipeline.skeletons`, `pipeline.bone_priors` and its asset,
`models.registry`).

Ported so far: `io.packaging.load_pose_estimator(pkg)` with
`estimate_poses_batched` and `detect_poses_batched` (YOLOv4 and YOLOv8
detectors, plausibility filter, pose NMS) for every package the JAX package
writes (EfficientNetV2, MobileNetV3 and ResNet backbones; Metrabs with its
latent modes, Model25D, and Metro as a bare crop model), and the plain
Metrabs trainer (`train`). The TPU
kernels run as hand-written CUDA kernels on CUDA tensors: the crop warp
(`csrc/warp.cu`) and the fused MBConv chain (`csrc/mbconv.cu`). The entry
points run on the card unless the caller passes `device='cpu'`.
"""
