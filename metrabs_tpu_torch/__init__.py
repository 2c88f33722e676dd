"""PyTorch / CUDA port of `metrabs_tpu` for NVIDIA Hopper GPUs.

The JAX package `metrabs_tpu` is the reference: each module here mirrors the
module of the same path there, keeps its public layouts (images NHWC
[N, H, W, 3], matrices [N, 3, 3], poses [..., J, 3]) and is tested against
it on the same inputs (`tests/test_torch_*.py`). This package imports torch
and never jax or flax; it reuses only the jax-free modules of `metrabs_tpu`
(config, joint_info, pipeline.tta, pipeline.skeletons).

Ported so far: the crop path behind
`io.packaging.load_pose_estimator(pkg).estimate_poses_batched` with the
EfficientNetV2 crop model; the crop warp runs as a hand-written CUDA kernel
(`csrc/warp.cu`) on CUDA tensors.
"""
