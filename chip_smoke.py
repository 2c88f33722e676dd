#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`metrabs_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, one line or a few each; any failure exits non-zero before the last
line:
 1. device: a CUDA device, its name and power limit from nvidia-smi;
 2. build: nvcc builds the port's two kernels, the crop warp
    `metrabs_tpu_torch/csrc/warp.cu` and the fused MBConv chain
    `metrabs_tpu_torch/csrc/mbconv.cu`, for sm_90a from the checkout, and the
    host C++ compiler the JPEG decoder `csrc/jpeg_decode.cpp` and encoder
    `csrc/jpeg_encode.cpp`, the mp4v codec `csrc/mpeg4_video.cpp`, the H.264
    decoder `csrc/h264_decode.cpp` and the native image ops
    `csrc/improc.cpp`, all seven compilers started together;
 3. kernel: the warp kernel against its plain PyTorch version at the serving
    shape (8 synthetic 1080p frames, 64 crops of 256x256, pyramid levels 0-2,
    lens distortion on some crops, a crop entirely outside its frame), and
    each crop within NATIVE_WARP_TOL of the C++ warp (`utils/native.py`) on
    its level image of `build_flat_pyramid` with the level-adjusted K; the
    MBConv kernel against its plain version at every shape of K2_CASES (the
    four the detect path gives it, EffNetV2-L@384's stage 5 and 6 in
    bfloat16, S stage 5 in float32), v required equal. For each: the
    kernel's time, the bytes it must move (for the warp: its output and the
    distinct pyramid pixels its taps read), its bound and share of it, the
    plain version's time and, for K2, the port's unfused chain's (BN, silu,
    pad, cuDNN depthwise conv, BN, silu, mean). A kernel timed above
    MAX_BOUND_SHARE of its bound, or a profile that lost launches, is
    measured again and then fails;
 4. main: `estimate_poses_batched` of an estimator built by the same
    function `load_pose_estimator` uses after reading a package, with
    EffNetV2-S at 256 px in bfloat16 (BN folded, flat layout) and weights
    minted from a seed, on 8 synthetic 1080p frames with 16 boxes each
    (some invalid), num_aug 2, internal batch 64. Checks shapes, finiteness,
    the validity mask and that the warp kernel ran once per non-empty chunk;
    then holds a float32 estimator on the GPU against the same estimator on
    the CPU (plain warp) on a small input, and times the bf16 path;
 5. detect: `detect_poses_batched` of the same crop model with BN unfolded
    and `fuse_mbconv='on'`, plus a minted YOLOv4-416 in bfloat16, on the
    same frames: num_aug 2, max_detections 16, internal batch 64, detector
    threshold 0 (every slot valid) and the plausibility filter on. Checks
    shapes, finiteness, and that the warp kernel ran once and the MBConv
    kernel 28 times (the qualifying blocks) per non-empty chunk, split over
    its input shapes as K2_CASES expects; then holds a float32 detect
    estimator on the GPU against the same one on the CPU on a small frame,
    times the bf16 path, and splits one call's time under torch.profiler,
    with K2's launches and device time per call against the bound of the
    launches its wrapper counted, shape by shape;
 5b. tools: one `scripts/profile_trace_torch.py` detect-mode profile of the
    same estimator on the same frames (`profile`: a warm-up, a timed and a
    profiled call): its categories must sum to the device-busy time within
    TOOLS_BUSY_TOL, and both the wrappers' counts and the trace's records
    must give K1 and K2 their detect-path launches; prints the device time by
    category, the top kernels, the convolutions' input memory formats and
    `scripts/_flops_torch.py`'s forward FLOPs per crop of EffNetV2-S@256;
 6. train: the trainer (`metrabs_tpu_torch.train`) on EffNetV2-S@256
    Metrabs with BN unfolded and `fuse_mbconv='on'`, H36M-17 3D and LSP-14
    2D joints, weights minted from TrainConfig's seed, bf16 compute with
    f32 master weights, batches of 32 + 32 synthetic examples through
    `ParallelBatchLoader` and `device_prefetch` (one batch, repeated): 3
    warm-up and 20 timed steps (median step time, images/s), one more under
    torch.profiler (device-busy share, kernels), the peak memory and the
    losses. Checks finite losses that fall on the repeated batch, a nonzero
    gradient in every backbone parameter (F1) and no K1 or K2 launch in a
    step; holds one float32 step on the GPU (TF32 off) against the same
    step on the CPU; then packages the EMA weights and serves them with
    `load_pose_estimator` on the main phase's frames and boxes, folded (K1
    once per non-empty chunk) and unfolded with `fuse_mbconv='on'` (K2 28
    times per chunk, v equal to the plain chain's on the trained weights);
 6b. train_families: every other crop-model family trained as phase 6
    trains plain Metrabs (EffNetV2-S@256, bf16 compute with f32 master
    weights, TrainConfig defaults, 32 + 32 synthetic examples, one batch
    repeated): Metro, Model25D (H36M-17 bones, minted ideal lengths),
    Metrabs in `transform_coords` and `predict_all_and_latents` (an affine
    autoencoder of FAMILY_N_LATENTS points minted into an npz and read back
    by `load_affine_weights`) and plain Metrabs with `regularize_to_manifold`,
    warm-started by `warm_start_backbone` from phase 6's package (backbone
    and head equal to the source's bit for bit). Per mode: 3 warm-up and 5
    timed steps and one profiled (median step time, images/s, device-busy
    share, peak memory), the checks of phase 6 (finite, falling losses, a
    gradient in every backbone parameter, no K1 or K2 launch), one step
    past `teacher_start_step` for `predict_all_and_latents` (the teacher term
    live), one float32 step on the GPU against the CPU; then the EMA weights
    packaged with the bone lengths of the 3D batches (`BoneLengthStats`),
    the crop model's eval-mode predictions on its training batch scored by
    `compute_pose3d_metrics` and `rigid_align` on the GPU against the CPU,
    and the package served on the main frames and boxes: folded bf16 through
    `load_pose_estimator` with K1 once per non-empty chunk (Metro: refused
    there, as in JAX), and FAMILY_FUSED_SERVE also unfolded with
    `fuse_mbconv='on'` (K2 28 times per chunk, v equal to the plain chain's);
 6c. train_app: the training app (`apps.train.main`) on a dataset minted
    under runs/ with the port's own classes and PNG writer (64 Example3D on
    1000x1000 frames with Human3.6M's cameras, half with lens distortion,
    half with foreground masks; 64 Example2D, some without a camera; 32
    held out): first `ParallelBatchLoader` alone over each stream
    (examples/s with every augmentation), then `main` at EffNetV2-S@256,
    bf16, 32 + 32, the default LoadConfig (every augmentation, synthetic
    occluders and backgrounds), 24 steps with log period 4, checkpoint
    period 8 and validation through `predict_dataset` every 12 steps, and
    again to 28 steps. Checks finite losses and validation metrics, the
    newest two checkpoints kept, the resumed run restoring step 24 and
    taking 4 steps, no K1 or K2 launch in the app, finite positive bone
    means in the exported manifest, and the package served as [train]
    serves its own (folded: K1 per chunk; fused: K2 28 times per chunk, v
    exact). Prints the loader's examples/s, the app's median step time and
    images/s, and [train]'s repeated-batch step time of the same run;
 7. families: the other model families, weights minted from a seed:
    (a) `detect_poses_batched` of ResNet-50@256 (metrabs_rn50_y4's crop
    model) in bf16 with BN folded by the loader's default, plus a minted
    YOLOv8-m@640 in bf16, on the main frames (settings of phase 5): shapes,
    finiteness on the detector's mask, K1 once per non-empty chunk and K2
    never; the float32 pair on the GPU against the CPU on a small frame
    (masks equal, boxes within BOX_TOL_PX, poses within 1 mm + 1e-3); the
    median of 5 calls and one call under torch.profiler. (b)
    `estimate_poses_batched` of MobileNetV3-L@256 (metrabs_mob3l_y4t's) in
    bf16, folded, on the main frames and boxes: K1 once per non-empty chunk,
    K2 never, the median of 5 calls and one profiled call. (c) each of
    FAMILY_CASES in float32 on the GPU against the CPU on a small frame with
    2 boxes, with another frame moving the poses; Metro built by
    `load_crop_model` and refused by `load_pose_estimator`; a float32
    YOLOv8-n's detections equal on the GPU and the CPU;
 8. import: the released metrabs_eff2s_y4 (EffNetV2-S@256 and YOLOv4-416,
    bf16), weights minted from a seed, written in the released formats by
    the port's own code (a TF TensorBundle under the reference fork's names,
    a darknet yolov4.weights, both under runs/ and deleted after the phase),
    read back by its importers (every leaf equal to the minted one bit for
    bit), packaged with the detector by its writer and loaded unfolded with
    `fuse_mbconv='on'`; on the main frames: `detect_poses_stream` (K=2
    batches, the second the frames mirrored) with K1 once and K2 28 times
    per non-empty chunk, `detect_poses_pipelined` (in_flight 2, 3 batches)
    and `estimate_poses_stream` (K=2, the main boxes), each against the
    batched calls within STREAM_TOL; F3 (the detect output's CUDA boxes back
    into `estimate_poses_batched`) and F2 (zero boxes, empty shapes); K1 and
    K2 counted again under torch.profiler on one stream call; the median of
    5 calls per frame batch, stream against batched, with the device-busy
    share of one profiled call of each;
 9. bench_apps: the benchmark path on JPEG frames. The host JPEG decoder
    (`csrc/jpeg_decode.cpp`) on every fixture of tests/torch_fixtures/jpeg,
    each held to the SHA-256 of cv2's decode in its manifest, then its time
    on the 1080x1920 frame (median of 20 on one thread, frames/s on 8). A
    3DPW layout (2 sequences x 24 copies of the portrait fixture, sequence
    pickles with 2 tracks) and a Human3.6M one (S9, one activity, 4 cameras
    x 8 copies of the 1000x1002 fixture, CDF poses from the port's writer, a
    cameras JSON) are minted under runs/ (deleted after), with
    metrabs_eff2s_y4 minted on SMPL-24 joints with a YOLOv4-416 whose heads
    fire (`firing_detector_variables`) and on H36M-17. `apps.predict_3dpw
    .main --gtassoc` with its defaults runs the first loaded unfolded with
    `fuse_mbconv='on'` (K1 once and K2 28 times per non-empty chunk), then
    `apps.eval_3dpw.main`; its first batch again with each K1 launch
    (portrait pyramids) held against the plain warp, K2's v against the
    plain chain, and under torch.profiler; `apps.predict_h36m.main` runs the
    second folded (K1 once per batch, K2 never), its first batch again with
    each K1 launch (odd level sizes, lens distortion) against the plain
    warp, then `apps.eval_benchmark.main` on a pickle of the same examples.
    Prints frames/s per driver with and without the package's loading, the
    share of `jpeg.decode` in its wall time, valid boxes per frame and
    finite metrics;
10. tdhp: MPI-INF-3DHP's scoring path. The port's HDF5 reader on every
    fixture of tests/torch_fixtures/hdf5: MATLAB-layout annotations written
    under three libver bounds (superblock v0; v2 with v2 object headers and
    dense attributes; v3 with layout-v4 chunk indexes), the structures of v3
    files (every chunk index, paged; a dense group of 2000 links; groups
    that track creation order; dense and huge attributes; soft and external
    links), a SWMR-written and a paged file: every group's members in
    order, every dataset, alias and attribute held to the SHA-256, dtype
    and shape h5py read in its manifest. A layout under runs/ (deleted
    after): TS1 and TS2 with 48 frames of 2048x2048 each and TS5 and TS6
    with 40 of 1920x1080 (copies of the JPEG fixtures), each with its
    fixture `annot_data.mat` (superblock v0, v2, v0 and v3; one invalid
    frame each), and a cameras JSON with 12 distortion coefficients for
    subj5_6. metrabs_eff2s_y4 on H36M-17 joints
    (whose registry has mpi_inf_3dhp_17) with YOLOv4-416, loaded unfolded
    with `fuse_mbconv='on'`: `apps.predict_3dhp.main` with its defaults (K1
    once and K2 28 times per non-empty chunk), `apps.eval_3dhp.main` on its
    dump (finite PCK, AUC, MPJPE), the first batch of each frame size again
    with each K1 launch against the plain warp and K2's v against the plain
    chain; the predictions through `save_predictions` as .npz and .h5 read
    back equal; a MATLAB-layout file of TDHP_LARGE_FRAMES frames written by
    the port (superblock v0) and read, and the fixture of as many frames
    that h5py wrote under `libver='latest'` read, each read timed. Prints frames/s with and without the package's
    loading and the decoding share;
11. detector_train: the detector trainer (`detect.train`) on minted
    416x416 scenes of upright figures with tight person boxes, float32,
    batch 8, BN frozen, Adam on the cosine schedule: YOLOv4-tiny for 3 + 30
    steps (the loss must fall) and full YOLOv4 (CSPDarknet53, mish) for 2 +
    5 (finite), each with its median step time, images/s, one step under
    torch.profiler (kernels, device busy share) and peak memory, no K1 or K2
    launch; one float32 step of an initial YOLOv4-tiny on the GPU against
    the same step on the CPU in float64; then the trained YOLOv4-tiny added
    to a metrabs_eff2s_y4 crop-model package (`add_detector_to_package`)
    and served folded by `detect_poses_batched` on held-out scenes, each K1
    launch against the plain warp, with the detector's recall at IoU 0.5
    printed;
12. train2serve: `scripts/train_to_serve_e2e_torch.py`'s `main` in-process
    at full width (EffNetV2-S@256 bf16 at 16 + 16 through `apps.train.main`,
    YOLOv4-tiny@416 float32 at batch 8), cut by TRAIN2SERVE_ARGS (24
    training and 8 held-out scenes, 40 crop steps with validation every 8,
    40 detector steps, the smoke gates), every K1 launch of its folded serve
    against the plain warp and K2 never; the crop step timed alone and with
    the feed, one step under torch.profiler (busy share, kernels, peak
    memory), the detector's step median, the served matched metrics and
    GT-box MPJPE from the script's record; then the trained package loaded
    unfolded with `fuse_mbconv='on'` and served on the held-out scenes'
    ground-truth boxes: K1 once and K2 28 times per chunk, each K1 launch
    and K2's v on the first chunk's input to each fused block against the
    plain versions. Its files are under runs/ and deleted after.
13. demos: drawing and video. The host JPEG encoder (`csrc/jpeg_encode.cpp`)
    on every case of tests/torch_fixtures/jpeg_encode (images minted from a
    numpy seed and decoded fixtures), each held to the SHA-256 of
    cv2.imencode in its manifest, then its time on the 1080x1920 frame
    (median of 20 on one thread); the video reader on the cv2-written MJPG
    fixtures of tests/torch_fixtures/video (AVI and Matroska), every packet
    held to the SHA-256 of cv2.imdecode and the metadata to cv2's; the mp4v
    decoder (`csrc/mpeg4_video.cpp`) on the cv2-written fixtures of
    tests/torch_fixtures/mp4v (MP4, AVI and Matroska, I- and P-VOPs across
    a GOP; the libxvidcore clips through FFmpeg's Xvid IDCT), every packet,
    luma plane and RGB frame held to the SHA-256 of cv2's in the manifest
    and the metadata to cv2's, the decode timed on one thread; the H.264
    decoder (`csrc/h264_decode.cpp`) on the libx264 fixtures of
    tests/torch_fixtures/h264 (three sizes in MP4, Matroska and AVI, the
    per-tool and VUI clips), every packet (as cv2 returns it), key flag,
    Y/U/V plane (x264's reconstruction), luma and RGB frame held to the
    manifest's SHA-256 and the metadata to cv2's, the 1080x1920 decode timed
    on one thread; the same decoder on the B-frame fixtures of
    tests/torch_fixtures/h264_b (x264's medium B-frame defaults at three
    sizes, MP4 with FFmpeg's ctts and elst, Matroska and AVI; a clip per
    B-frame option; three edited streams), every packet, key flag, luma and
    RGB frame in output order held to cv2's SHA-256, Y/U/V to x264's
    reconstruction where its luma is FFmpeg's, imread('#frame=N') for every
    N to cv2's seek table, the metadata to cv2's, the 1080x1920 B-stream
    decode per packet timed on one thread; the HEVC decoder
    (`csrc/hevc_decode.cpp`) on the libx265 fixtures of
    tests/torch_fixtures/hevc (two sizes in MP4 hvc1, Matroska and AVI, an
    hev1 MP4, 1080x1920 in MP4, a clip per coding tool), every packet (as
    cv2 returns it), key flag, Y/U/V plane (libde265's), luma and RGB frame
    held to the manifest's SHA-256, imread('#frame=N') for every N to cv2's
    seek table, the metadata to cv2's and every decoded-picture hash SEI
    checked (MD5 and checksum on every plane, x265's CRC on luma), the
    1080x1920 decode timed per frame on one thread; the same decoder on the
    B-frame fixtures of tests/torch_fixtures/hevc_b (x265's medium B-frame
    defaults at three sizes, MP4 with FFmpeg's ctts and elst, Matroska and
    AVI; a clip per B-frame option; an edited stream), every packet, key
    flag, luma and RGB frame in output order held to cv2's SHA-256, Y/U/V to
    libde265's where its luma is FFmpeg's, every seek, the metadata and the
    hash SEIs likewise, the 1080x1920 B-stream decode per packet timed on
    one thread beside the I/P time; the same decoder on the Main 10 clips of
    tests/torch_fixtures/hevc10 (x265's 10-bit API: two sizes with and
    without B slices in MP4, a phone's QuickTime .mov, Matroska and AVI, a
    clip per tool, the phone's turned 1920x1080 clip), every packet, key
    flag, 16-bit Y/U/V plane (libde265's, or the picture's MD5 SEI where
    libde265's are wrong), RGB frame as displayed (not on the HLG clip,
    fault F11), seek and hash SEI likewise, the phone clip's decode per
    packet timed on one thread; the turned clips of
    tests/torch_fixtures/orientation (fault F10: mp4v, H.264 and HEVC 8- and
    10-bit, every matrix of cv2's table, MP4 and QuickTime), their turns,
    frames, seeks and displayed sizes held to cv2's; the mp4v decoder on
    the Advanced Simple clips of tests/torch_fixtures/mp4v_asp
    (libxvidcore's B-VOPs in open and closed GOPs, packed, MPEG
    quantisation with default and custom matrices, quarter-pel with 4MV,
    GMC and interlaced coding; FFmpeg's encoder's field vectors; Xvid's
    usual stream of them all at three sizes in AVI and Matroska; B-VOPs in
    MP4 with ctts), every packet, key flag, Y/U/V plane (FFmpeg's
    decoder's) and luma plane held to the manifest, RGB frames and every
    seek to cv2's, on the interlaced clips, which cv2 has no picture of
    (fault F14), to FFmpeg's decoder's frames through libswscale, the
    1080x1920 decode per packet timed on one thread, the packets that
    decode a B-VOP apart. Under runs/ (deleted
    after): the mp4v
    encoder on
    MP4V_FRAMES shifted 1080x1920 frames into an .mp4 (timed on one
    thread), read back with its luma equal to the encoder's reconstruction;
    metrabs_eff2s_y4 minted on H36M-17 with a firing YOLOv4-416, a 24-frame
    1080x1920 MJPEG .avi and an ASPset-510 layout (one subject, two views
    of 16 1080x1920 mp4v .mkv frames, box CSVs, camera JSONs), all written
    by the port; a 24-frame 1080x1920 H.264 .mp4 and a second ASPset layout
    of 2 x 16 frames of H.264 .mkv, muxed by the port from the 1080x1920
    fixture's packets (each clip starts at an IDR picture); a 24-frame
    1080x1920 B-frame H.264 .mp4 (ctts, elst) and a third ASPset layout of
    B-frame .mkv views, whole closed GOPs of the 1080x1920 B-frame fixture
    (H264_B_DEMO_GOPS, H264_B_ASPSET_GOPS); a 24-frame 1080x1920 HEVC .mp4
    (hvc1) and a fourth ASPset layout of HEVC .mkv views, muxed from the
    1080x1920 HEVC fixture's packets (each clip starts at an IRAP picture);
    a 24-frame 1080x1920 B-frame HEVC .mp4 (ctts, elst) and a fifth ASPset
    layout of B-frame HEVC .mkv views, whole closed GOPs of the 1080x1920
    HEVC B fixture (HEVC_B_DEMO_GOPS, HEVC_B_ASPSET_GOPS).
    The demos' detector calls are
    made with `suppress_implausible_poses=False`, so that the random
    weights' poses survive and are drawn. `apps.demo_image.main` on the
    1080x1920 JPEG fixture, folded, with `--out` (.jpg) and `--out-3d`
    (.png), every K1 launch against the plain warp, both files read back,
    poses found and the overlay unlike the undrawn frame; `apps.demo_video.main`
    with `--frame-batch 8`, on the MJPEG .avi as is and with `--stream 2`
    (each writing an overlay .mkv) and on the mp4v and H.264 .mp4 (each
    writing an .mp4; the H.264 input's frames held to the manifest, and the
    H.264 run made again with every K1 launch against the plain warp),
    each overlay mp4v as JAX's demo writes it, read back (frames, size,
    poses drawn: its first frame unlike the same frame encoded undrawn),
    frames/s end to end and the decoding, drawing and encoding shares of the
    wall, the mp4v and H.264 inputs' frames each decoded once; one batch again with each K1 launch
    against the plain warp, then profiled (busy share); on the B-frame .mp4
    once with every K1 launch against the plain warp, every input frame the
    manifest's, each picture decoded once (path demo_video_h264_b); on the
    HEVC .mp4 and the HEVC B-frame .mp4 likewise (paths demo_video_hevc,
    demo_video_hevc_b); on the phone's clip of tests/torch_fixtures/hevc10
    (HEVC Main 10 in QuickTime's layout, 1920x1080 stored and turned by 90
    degrees in its track header) timed, then again with every K1 launch
    against the plain warp, every input frame as displayed the manifest's,
    the overlay 1080 wide, each picture decoded once (path
    demo_video_hevc10); on Xvid's usual Advanced Simple 1080x1920 AVI
    (MP4V_ASP_DEMO) timed, then again with every K1 launch against the
    plain warp, every input frame the manifest's, each VOP decoded once
    (path demo_video_mp4v_asp);
    `apps.predict_3dpw.main --viz-dir` on a 3DPW layout of 8 frames
    (SMPL-24 package), its figures under JAX's names read back and timed;
    `apps.predict_aspset.main` on the mp4v .mkv clips and on the H.264
    .mkv clips, loaded unfolded with `fuse_mbconv='on'` (K1 once and K2 28
    times per chunk), each frame decoded once, frames/s with and without
    the package's loading and the decoding share; then each again with every
    K1 launch against the plain warp and every K2 launch against the plain
    chain, both exact; on the B-frame .mkv views once with every launch so
    checked, every input frame the manifest's, each picture decoded once
    by the 8 I/O threads (path predict_aspset_h264_b); on the HEVC and HEVC
    B-frame .mkv views likewise (paths predict_aspset_hevc,
    predict_aspset_hevc_b), and on an ASPset layout whose two views are
    Xvid's usual Advanced Simple .mkv (MP4V_ASP_VIEW, all its frames) likewise
    (path predict_aspset_mp4v_asp);
13b. images: still images as cv2.imread reads them. Every fixture of
    tests/torch_fixtures/images (PNG of every colour type and depth with
    and without tRNS, Adam7, APNG and eXIf; Adobe CMYK, YCCK and RGB
    JPEG; WebP lossless, lossy with every loop-filter type, 2-8 token
    partitions, segmentation, alpha, animation and EXIF) decoded in colour
    and in gray and held to the manifest's SHA-256 of cv2's reads (this
    machine has neither cv2 nor Pillow), image_extents to PIL's sizes;
    the 4032x3024 Paeth-filtered PNG and the 4032x3024 lossy WebP
    (Orientation 6) decoded IMAGE_DECODE_REPEATS times each on one host
    thread (median ms); then `apps.demo_image.main` (folded, `--out`) on
    that WebP and on the 640x480 palette PNG with metrabs_eff2s_y4 on
    H36M-17 and a firing YOLOv4-416: K1 launched, every launch exact
    against the plain warp, poses found, the overlay read back at the
    displayed size (paths demo_image_webp, demo_image_png_palette). The
    TIFF, BMP, PNM/PAM/PFM, GIF, Sun raster and Radiance fixtures are held
    to their hashes likewise (where cv2 returns None, the port must raise,
    and image_extents must raise where PIL does); a 4032x3024 16-bit RGB
    TIFF (LZW, predictor 2, 256x256 tiles) and a 4032x3024 24-bit BMP are
    minted here (tests/_torch_image_fixtures.py: numpy only), each decoded
    IMAGE_DECODE_REPEATS times on one host thread, every decode equal to
    the pixels it was written from, and read by demo_image as above (paths
    demo_image_tiff, demo_image_bmp); and apps.calibrate_camera on
    calibration set (a)'s views written as 8-bit gray TIFF and BMP must give
    exactly its JSON on the PNGs, with K1 and K2 counted in each run and
    both 0 (paths calibrate_tiff, calibrate_bmp);
14. calibrate: camera calibration without OpenCV on the checkerboard
    fixtures of tests/torch_fixtures/calib ((a) 640x480 PNG views, (b)
    1920x1080 JPEG views through a known lens, a partial board and an empty
    scene), held to the cv2 5.0 results in their manifest: every view's gray
    read (SHA-256), found flag (the port also finds CALIB_CV2_MISSES, where
    cv2 does not) and corners after the app's refinement on the card,
    `corner_subpix` from cv2's detections, `calibrate_camera` on cv2's
    corners (K, rms, the lens's displacement over the image), then
    `apps.calibrate_camera.main` on each directory against the JAX app's
    result and (b) against the true camera; seconds per view printed; one
    view of (b) rendered again by `render_checkerboard` and held to its
    RGB and JPEG hashes. Then `estimate_poses_batched` (EffNetV2-S@256 bf16
    folded, the main frames and boxes, num_aug 2) with the K and
    coefficients calibrated from (b): K1 once per non-empty chunk and K2
    never, every K1 launch exact against the plain warp and each of its
    crops within NATIVE_WARP_TOL of the C++ warp.
15. parallel: several ranks (`parallel.mesh`). (a) This process joins a
    one-rank NCCL group: `make_sharded_train_step` at EffNetV2-S@256 bf16,
    32 + 32, against the plain step from the same state, batch and
    generator (cuDNN deterministic in both), within the parity tolerance of
    tests/_torch_train.py, with its one gradient all-reduce timed. Then the
    one-rank serve of phase 5's detect path (threshold 0, the plausibility
    filter on) on the main frames, its detector run on each rank's frames
    in turn (`BlockwiseDetector`), and PARALLEL_RANKS spawned processes
    sharing cuda:0 over gloo (their collectives through host copies),
    joined with a deadline: (b) on a (2, 1) mesh, `detect_poses_batched`
    (YOLOv4-416 + EffNetV2-S@256 bf16 unfolded, `fuse_mbconv='on'`) with
    each rank detecting its frames and running its share of the chunks,
    K1 once and K2 28 times per chunk of its share, every launch exact
    against the plain versions, valid equal to the one-rank serve and the
    poses within 1 mm + 1e-3; a float32 step (TF32 off) of 16 + 16 per rank
    against the one-rank step on the global 32 + 32, ranks left equal; (c)
    on a (1, 2) mesh with the weights of at least PARALLEL_TP_MIN_SIZE
    elements sharded over 'model' (every fused block's depthwise weight
    among them: K2 on channel slices), the fused detect in float32 (4
    detections per frame) against (b)'s data-parallel serve in float32,
    every launch exact, and a float32 step (JAX's default tp_min_size)
    against the one-rank step and, within twice the relative limits,
    against (b)'s. Prints each path's launches per rank, the collectives'
    calls, bytes and time per call and per step, and the device-busy share
    of one data-parallel call.
The second-to-last line is a JSON object with the kernels' measurements
(each kernel's `launches_by_path` counts every path's run);
the last is {"ok": true, "device": {...}}.
"""

import collections
import concurrent.futures
import dataclasses
import functools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from scripts._minting_torch import (  # noqa: F401 (re-exported to the tests)
    BOXES_PER_FRAME, DETECTOR_FIRE_BIAS, DETECTOR_SIZE, FRAME_H, FRAME_W, JOINT_EDGES,
    JOINT_NAMES, N_FRAMES, PROC_SIDE, SEED, detect_manifest_for, firing_detector_variables,
    manifest_for, mint_crop_variables, mint_detector_variables, mint_state, synthetic_boxes,
    synthetic_frames)

NUM_AUG = 2
INTERNAL_BATCH = 64
WARP_TOL = 1e-4  # linear [0, 1] values; FMA and reassociation between nvcc and ATen
POSE_ATOL_MM, POSE_RTOL = 1.0, 1e-3
# The fused MBConv kernel's cases: (label, [N, E, H, W], dtype, launches
# expected per detect-path chunk of 64 crops, which the detect phase checks
# against the wrapper's count per shape): the four shapes the detect path
# gives it (EffNetV2-S@256), EffNetV2-L@384's stage 5 and 6 at batch 128,
# and S stage 5 in float32. v must equal the plain version's exactly (same
# operations in the same order, no FMA contraction); the SE mean sums the
# same values in another order: 1e-5.
K2_CASES = (('S@256 stage 4', (64, 512, 16, 16), torch.bfloat16, 5),
            ('S@256 stage 5 first', (64, 768, 16, 16), torch.bfloat16, 1),
            ('S@256 stage 5', (64, 960, 16, 16), torch.bfloat16, 8),
            ('S@256 stage 6', (64, 1536, 8, 8), torch.bfloat16, 14),
            ('L@384 stage 5', (128, 1344, 24, 24), torch.bfloat16, 0),
            ('L@384 stage 6', (128, 2304, 12, 12), torch.bfloat16, 0),
            ('S@256 stage 5', (64, 960, 16, 16), torch.float32, 0))
K2_MAIN_CASE = 2  # the one the kernels line reports; every case is under 'cases'
K2_MEAN_TOL = dict(atol=1e-5, rtol=1e-5)
K2_BLOCKS = 28  # MBConv blocks of EffNetV2-S that the fused chain takes
K2_KERNELS = ('mbconv_warp_kernel', 'mbconv_strip_kernel')  # profiler names
# Bounds (H100 SXM datasheet peaks, at 700 W): HBM
# bytes per second and float32 operations per second outside the tensor
# cores, where both kernels compute. Operations counted per element: K2 2
# (BN0) + 4 (silu: exp, add, reciprocal, multiply) + 18 (9 taps) + 2 (BN1) +
# 4 (silu) + 1 (mean) = 31; K1 per output pixel ~20 (ray and divide) + ~25
# (distortion) + 4 (intrinsics) + 6 (clamps, floor) + 27 (3 bilinear blends)
# = 82.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
K2_OPS_PER_ELEMENT = 31
K1_OPS_PER_PIXEL = 82
# A kernel's bound over its time above this share is a timing fault, not a
# fast kernel (5% for the datasheet rates' rounding).
MAX_BOUND_SHARE = 1.05
TIMING_TRIES = 3  # profiles of a kernel before a lost record or such a share fails
MAX_DETECTIONS = 16
BOX_TOL_PX = 1e-2
TRAIN_WARMUP, TRAIN_STEPS = 3, 20
TRAINED_PACKAGE = 'runs/chip_smoke_trained_package'  # [train]'s, read by [train_families]
TRAIN_PARITY_BATCH = 2  # per stream, in the float32 GPU-vs-CPU step
# Kernel-name groups of a train step's device time, first match wins.
TRAIN_KERNEL_GROUPS = (
    ('optimizer (foreach)', ('multi_tensor_apply',)),
    ('convolution', ('conv', 'gemm', 'xmma', 'cudnn', 'sm90_', 'cutlass', 'wgrad', 'dgrad')),
    ('reduction', ('reduce',)),
    ('copy, cast, memcpy', ('copy', 'memcpy', 'memset', 'cat')),
    ('elementwise', ('elementwise', 'vectorized', 'unrolled')))


def phase(name: str, msg: str) -> None:
    print(f'[{name}] {msg}', flush=True)


CARD_UNKNOWN = 'nvidia-smi failed'


def card_name() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else CARD_UNKNOWN


def fail(name: str, msg: str) -> None:
    print(f'[{name}] FAIL: {msg}', flush=True)
    sys.exit(1)


def cuda_time_ms(fn, n_warm: int = 3, n: int = 25) -> float:
    """Median over `n` warm calls of the device time between CUDA events."""
    for _ in range(n_warm):
        fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profiled(run, name: str):
    """(the events of one `run()` under torch.profiler, its wall ms). A
    profile without a single GPU kernel record (torch.profiler drops a whole
    profile now and then) is taken again, up to TIMING_TRIES times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(TIMING_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = prof.events()
        if any(e.device_type == DeviceType.CUDA for e in events):
            return events, wall_ms
        phase(name, 'torch.profiler recorded no GPU kernels: profiling again')
    fail(name, f'torch.profiler recorded no GPU kernels in {TIMING_TRIES} profiles')


def device_time_ms(fn, n: int = 25) -> float:
    """Mean device time of `fn` over `n` warm calls: the summed durations of
    the GPU kernels it launches, from torch.profiler, so without the host's
    launch gaps that `cuda_time_ms` includes. `fn` launches the same kernels
    every call, so each kernel name must be recorded a multiple of `n`
    times; a profile that lost records (a sum over fewer launches than were
    made, which reads as a kernel faster than its bound) is taken again, up
    to TIMING_TRIES times."""
    from torch.autograd import DeviceType

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(TIMING_TRIES):
        events, _ = profiled(lambda: [fn() for _ in range(n)], 'kernel')
        events = [e for e in events if e.device_type == DeviceType.CUDA]
        counts = collections.Counter(e.name for e in events)
        if all(c % n == 0 for c in counts.values()):
            return sum(e.device_time_total for e in events) / n / 1e3
        phase('kernel', f'torch.profiler recorded {sorted(counts.values())} launches per '
                        f'kernel over {n} calls, not a multiple of {n}: profiling again')
    fail('kernel', f'torch.profiler lost kernel records in {TIMING_TRIES} profiles of {n} '
                   f'calls')


def timed_against_bound(name: str, fn, bound_ms: float) -> float:
    """`device_time_ms(fn)`, which must not beat `bound_ms` by more than
    MAX_BOUND_SHARE allows: a kernel timed faster than the card can move its
    bytes or do its operations was timed wrong. Measured again, up to
    TIMING_TRIES times, before it fails."""
    for _ in range(TIMING_TRIES):
        ms = device_time_ms(fn)
        if bound_ms / ms <= MAX_BOUND_SHARE:
            return ms
        phase('kernel', f'{name}: {ms:.4f} ms is {100 * bound_ms / ms:.1f}% of its bound '
                        f'{bound_ms:.4f} ms: timing again')
    fail('kernel', f'{name}: timed above {100 * MAX_BOUND_SHARE:.0f}% of its bound in '
                   f'{TIMING_TRIES} measurements')


def warp_case(dev, n_crops: int = 64, side: int = 256):
    """Per-crop geometry of the kernel check: scales that select pyramid
    levels 0, 1 and 2, rotations, distortion on every third crop, and the
    last crop looking far outside its frame (all zero border)."""
    g = np.random.default_rng(SEED)
    scales = np.array([0.7, 0.35, 0.18, 1.4] * (n_crops // 4), np.float32)
    angles = g.uniform(-0.6, 0.6, n_crops)
    cx = g.uniform(0, FRAME_W, n_crops)
    cy = g.uniform(0, FRAME_H, n_crops)
    k_old = np.array([[1500.0, 0, FRAME_W / 2], [0, 1500.0, FRAME_H / 2], [0, 0, 1]])
    invproj = np.zeros((n_crops, 3, 3))
    for i in range(n_crops):
        c, s = math.cos(angles[i]), math.sin(angles[i])
        a = np.array([[c, -s], [s, c]]) / scales[i]
        m = np.eye(3)
        m[:2, :2] = a
        m[:2, 2] = np.array([cx[i], cy[i]]) - a @ np.array([side / 2, side / 2])
        invproj[i] = np.linalg.inv(k_old) @ m
    invproj[-1, :2, 2] += 10.0  # ~15000 px away: only the zero ring is sampled
    dist = np.zeros((n_crops, 12))
    dist[::3, 0] = g.uniform(-0.2, 0.2, len(dist[::3]))
    dist[::3, 1] = g.uniform(-0.05, 0.05, len(dist[::3]))
    dist[::3, 2:4] = g.uniform(-0.01, 0.01, (len(dist[::3]), 2))
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    return dict(intrinsic_matrix=t(np.tile(k_old, (n_crops, 1, 1))),
                new_invprojmat=t(invproj), distortion_coeffs=t(dist),
                crop_scales=t(scales),
                image_ids=torch.arange(n_crops, device=dev) % N_FRAMES)


def k2_case(shape, dtype, gen: torch.Generator, dev):
    """The expand-conv output u [N, E, H, W] in `dtype`, the depthwise weight
    [E, 1, 3, 3] and the two inference BatchNorms around the depthwise conv,
    with random statistics."""
    from metrabs_tpu_torch.models.backbones.common import FrozenBatchNorm2d

    e = shape[1]
    rand = lambda lo, hi: torch.rand(e, generator=gen, device=dev) * (hi - lo) + lo
    u = (torch.randn(shape, generator=gen, device=dev) * 2).to(dtype)
    dw = torch.randn((e, 1, 3, 3), generator=gen, device=dev) * 0.3
    bns = []
    for _ in range(2):
        bn = FrozenBatchNorm2d(e, 1e-3).to(dev)
        bn.weight.data, bn.bias.data = rand(0.5, 1.5), rand(-0.3, 0.3)
        bn.running_mean.copy_(rand(-0.5, 0.5))
        bn.running_var.copy_(rand(0.5, 1.5))
        bns.append(bn)
    return u, dw, bns


def unfused_chain(u, dw, bn0, bn1):
    """The port's unfused MBConv inner chain (`efficientnet_v2.MBConv` with
    `fuse_mbconv='off'`): BN, silu, pad, cuDNN depthwise conv, BN, silu, and
    the SE block's spatial mean."""
    x = torch.nn.functional.silu(bn0(u))
    x = torch.nn.functional.conv2d(torch.nn.functional.pad(x, (1, 1, 1, 1)), dw.to(x.dtype),
                                   groups=x.shape[1])
    x = torch.nn.functional.silu(bn1(x))
    return x, torch.mean(x, dim=(2, 3))


def bound(n_bytes: float, n_ops: float):
    """(least ms, 'bytes' or 'operations'): the larger of the bytes over the
    HBM rate and the float32 operations over the float32 rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def k2_bound(shape, element_size: int):
    """(bytes, least ms, what bounds it) of K2 on a u of `shape`: u read and
    v written once, the float32 taps, BN constants and SE mean;
    K2_OPS_PER_ELEMENT."""
    n, e = shape[:2]
    numel = math.prod(shape)
    n_bytes = 2 * numel * element_size + 4 * (n * e + 9 * e + 4 * e)
    return (n_bytes, *bound(n_bytes, K2_OPS_PER_ELEMENT * numel))


def check_k2(gen, dev):
    """Every K2 case: the kernel against its plain version, its times beside
    its bound, the plain version's and the unfused chain's. Returns one dict
    per case."""
    from metrabs_tpu_torch.ops import mbconv, mbconv_cuda

    results = []
    for label, shape, dtype, _ in K2_CASES:
        u, dw, (bn0, bn1) = k2_case(shape, dtype, gen, dev)
        taps, sb = mbconv.inner_constants(dw, *bn0.folded(), *bn1.folded())
        got_v, got_mean = mbconv_cuda.fused_mbconv_inner(u, taps, sb)
        want_v, want_mean = mbconv.fused_mbconv_inner(u, taps, sb)
        torch.cuda.synchronize()
        name = f'fused_mbconv_inner {label} {list(shape)} {str(dtype)[6:]}'
        if got_v.shape != u.shape or got_v.dtype != dtype or got_mean.shape != shape[:2]:
            fail('kernel', f'{name}: output {tuple(got_v.shape)} {got_v.dtype}, '
                           f'mean {tuple(got_mean.shape)}')
        if not (torch.isfinite(got_v).all() and torch.isfinite(got_mean).all()):
            fail('kernel', f'{name}: non-finite kernel output')
        err_v = (got_v.float() - want_v.float()).abs().max().item()
        err_mean = (got_mean - want_mean).abs().max().item()
        if err_v != 0.0 or not torch.allclose(got_mean, want_mean, **K2_MEAN_TOL):
            fail('kernel', f'{name}: max |kernel - plain| v {err_v:.3g} (must be 0), mean '
                           f'{err_mean:.3g} (tol {K2_MEAN_TOL})')
        unfused_v, _ = unfused_chain(u, dw, bn0, bn1)
        err_unfused = (got_v.float() - unfused_v.float()).abs().max().item()
        del got_v, want_v, unfused_v
        kernel = lambda: mbconv_cuda.fused_mbconv_inner(u, taps, sb)
        n_bytes, bound_ms, bound_by = k2_bound(u.shape, u.element_size())
        ms, event_ms = timed_against_bound(name, kernel, bound_ms), cuda_time_ms(kernel)
        plain_ms = device_time_ms(lambda: mbconv.fused_mbconv_inner(u, taps, sb))
        unfused_ms = device_time_ms(lambda: unfused_chain(u, dw, bn0, bn1))
        phase('kernel', f'{name}: max |kernel - plain| v {err_v:.3g}, mean {err_mean:.3g}; '
                        f'vs the unfused chain {err_unfused:.3g} (BN folded vs not); kernel '
                        f'{ms:.4f} ms, {n_bytes / 1e6:.1f} MB, bound {bound_ms:.4f} ms '
                        f'({bound_by}), {100 * bound_ms / ms:.1f}% of bound; plain torch '
                        f'{plain_ms:.4f} ms, unfused cuDNN chain {unfused_ms:.4f} ms (device '
                        f'time, mean of 25); kernel {event_ms:.4f} ms between CUDA events '
                        f'(median of 25 single calls, launch included)')
        results.append(dict(case=label, shape=list(shape), dtype=str(dtype)[6:],
                            max_abs_err=err_v, max_abs_err_mean=err_mean, ms=ms,
                            event_ms=event_ms,
                            plain_ms=plain_ms, unfused_ms=unfused_ms, bytes=n_bytes,
                            bound_ms=bound_ms, bound_by=bound_by, bound_share=bound_ms / ms))
        del u
    return results


def k1_bound(flat, params, geom, side):
    """(bytes, least ms, what bounds it) of K1 on these inputs: every output
    byte, the parameters, and each distinct pyramid pixel that a bilinear tap
    reads, once; K1_OPS_PER_PIXEL."""
    from metrabs_tpu_torch.ops import warp as warp_ops

    coords = warp_ops.warp_pyramid_coords(params, side)
    idx00, _, _ = warp_ops.bilinear_corners(geom[:, 0], geom[:, 1], geom[:, 2], coords)
    used = torch.zeros(flat.shape[0], dtype=torch.bool, device=flat.device)
    wp = geom[:, 2, None, None]
    for offset in (0, 1, wp, wp + 1):
        used[(idx00 + offset).reshape(-1)] = True
    n_pixels = params.shape[0] * side[0] * side[1]
    n_bytes = (n_pixels * 3 * 4 + int(used.sum()) * flat.element_size() * 3
               + params.numel() * 4 + geom.numel() * 8)
    return (n_bytes, *bound(n_bytes, K1_OPS_PER_PIXEL * n_pixels))


def profile_detect(est, run):
    """One `run()` under torch.profiler, with ranges around the detector, its
    box NMS (where `est` has a detector), the crop model, the plausibility
    filter and its pose NMS. Returns (wall ms, {name: device ms}, {name:
    host ms}, busy device ms, kernel count, {kernel: launches})."""
    from torch.autograd import DeviceType
    from torch.profiler import record_function

    from metrabs_tpu_torch.detect import yolov4
    from metrabs_tpu_torch.pipeline import plausibility

    def labelled(name, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return wrapped

    patches = [(est.detector, 'detect_batched', 'detector'), (yolov4, 'box_nms', 'detector_nms'),
               (est, 'crop_model', 'crop_model'),
               (plausibility, 'suppress_implausible_poses', 'pose_filter'),
               (plausibility, 'pose_non_max_suppression', 'pose_nms')]
    patches = [p for p in patches if p[0] is not None]
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]
    for obj, attr, name in patches:
        setattr(obj, attr, labelled(name, getattr(obj, attr)))
    try:
        events, wall_ms = profiled(run, 'profile')
    finally:
        for obj, attr, value in saved:
            setattr(obj, attr, value)
    names = {name for _, _, name in patches}
    device_ms, host_ms = {}, {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name in names:
            device_ms[e.name] = device_ms.get(e.name, 0.0) + e.device_time_total / 1e3
            host_ms[e.name] = host_ms.get(e.name, 0.0) + e.cpu_time_total / 1e3
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and e.name not in names]
    counts = {}
    for key, patterns in (('K2 (mbconv kernel)', K2_KERNELS),
                          ('K1 (warp kernel)', ('warp_pyramid_kernel',))):
        mine = [e for e in kernels if any(p in e.name for p in patterns)]
        device_ms[key] = sum(e.device_time_total for e in mine) / 1e3
        counts[key] = len(mine)
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3  # one stream: no overlap
    return wall_ms, device_ms, host_ms, busy_ms, len(kernels), counts


def synthetic_example(index: int, stream: str, side: int = PROC_SIDE) -> dict:
    """Training example `index` of the 3D or 2D stream, made from (SEED,
    index) alone: a noise image, a camera, and a person of 17 joints around
    a root 2.5-5 m away with their projection into the crop (3D) or 14
    joints inside the crop (2D), ~10% of the joints marked invalid."""
    rng = np.random.default_rng((SEED, index))
    k = np.float32([[1.5 * side, 0, side / 2], [0, 1.5 * side, side / 2], [0, 0, 1]])
    out = dict(image=rng.random((side, side, 3), dtype=np.float32), intrinsics=k)
    if stream == '3d':
        root = np.concatenate([rng.normal(0, 300, 2), rng.uniform(2500, 5000, 1)])
        coords = (root + rng.normal(0, 250, (17, 3))).astype(np.float32)
        projected = coords @ k.T
        out.update(coords3d_true=coords, coords2d_true=projected[:, :2] / projected[:, 2:],
                   joint_validity_mask=rng.random(17) < 0.9)
    else:
        out.update(coords2d_true=rng.uniform(0.12 * side, 0.88 * side, (14, 2)).astype(
            np.float32), joint_validity_mask=rng.random(14) < 0.9)
    return out


def synthetic_batches(tcfg, n_steps: int, dev, bone_stats=None, first_example: int = 0):
    """`n_steps` (3D, 2D) batch pairs of tcfg's sizes through
    `ParallelBatchLoader` and `device_prefetch`, of the examples from
    `first_example` on. Both streams cycle over one batch's worth of
    examples, so every step sees the same batch. The 3D batches update
    `bone_stats` (a `BoneLengthStats`) on the host as they stream by, as the
    trainer measures the package's bone lengths."""
    import itertools

    from metrabs_tpu_torch.data.pipeline import ParallelBatchLoader, device_prefetch

    loaders = [ParallelBatchLoader(lambda i, _, s=stream: synthetic_example(i, s),
                                   itertools.cycle(range(offset, offset + size)), size,
                                   n_workers=4, seed=SEED)
               for stream, offset, size in (
                   ('3d', first_example, tcfg.batch_size),
                   ('2d', first_example + tcfg.batch_size, tcfg.batch_size_2d))]
    pairs = ({'3d': a, '2d': b} for a, b in itertools.islice(zip(*loaders), n_steps))
    if bone_stats is not None:
        pairs = (bone_stats.update(pair['3d']['coords3d_true'],
                                   pair['3d']['joint_validity_mask']) or pair for pair in pairs)
    return device_prefetch(({f'{s}/{k}': v for s, batch in pair.items()
                             for k, v in batch.items()} for pair in pairs), device=dev), loaders


def split_streams(batch: dict):
    return [{k.split('/', 1)[1]: v for k, v in batch.items() if k.startswith(s)}
            for s in ('3d/', '2d/')]


def make_trainer(cfg, tcfg, variables, dev, fuse: str = 'off', model_kwargs=None,
                 affine_weights=None):
    """(train state on `dev`, train step) of a crop model with `variables`,
    of the class and latent mode of `model_kwargs` (`build_crop_model`'s),
    with the autoencoder's `affine_weights` in the latent and manifold
    modes."""
    from metrabs_tpu_torch.io.weights import crop_model_state_dict_from_flax
    from metrabs_tpu_torch.models.backbones.builder import build_backbone
    from metrabs_tpu_torch.models.metrabs import build_crop_model
    from metrabs_tpu_torch.pipeline.skeletons import H36M_17, LSP_14
    from metrabs_tpu_torch.train import loop, optim

    model_kwargs = model_kwargs or {}
    model = build_crop_model(cfg, functools.partial(build_backbone, fuse_mbconv=fuse),
                             **model_kwargs)
    model.load_state_dict(crop_model_state_dict_from_flax(variables, cfg, **model_kwargs))
    optimizer = optim.Optimizer(tcfg)
    state = loop.create_train_state(model, optimizer, device=dev)
    model_class = model_kwargs.get('model_class', 'metrabs')
    if model_class != 'metrabs':
        maker = dict(metro=loop.make_train_step_metro,
                     model25d=loop.make_train_step_model25d)[model_class]
        return state, maker(model, optimizer, H36M_17, LSP_14, cfg, tcfg)
    return state, loop.make_train_step(model, optimizer, H36M_17, LSP_14, cfg, tcfg,
                                       affine_weights=affine_weights)


def train_parity(cfg, tcfg, variables, dev, name='train', model_kwargs=None,
                 affine_weights=None):
    """One float32 step (TF32 off) on the GPU against the same step on the CPU
    from the same state, batch and mix (the Metrabs step's), drop-connect off
    on both (the two devices' generators differ), for the crop model of
    `model_kwargs` (`make_trainer`'s). Returns the worst deviations; fails past
    the parity tolerance of `step_deviations`."""
    from metrabs_tpu_torch.models.backbones import efficientnet_v2

    cfg32 = dataclasses.replace(cfg, dtype='float32')
    n = TRAIN_PARITY_BATCH
    b3, b2 = [{k: torch.as_tensor(np.stack([synthetic_example(i, s)[k] for i in ids]))
               for k in synthetic_example(0, s)}
              for s, ids in (('3d', range(n)), ('2d', range(100, 100 + n)))]
    mix = torch.rand((2 * n, 1, 1), generator=torch.Generator().manual_seed(SEED))
    step_kwargs = {} if (model_kwargs or {}).get('model_class', 'metrabs') != 'metrabs' else dict(
        mix=mix)
    saved_survival = efficientnet_v2.SURVIVAL_PROB
    efficientnet_v2.SURVIVAL_PROB = 1.0
    try:
        runs = []
        for d in (dev, 'cpu'):
            state, step = make_trainer(cfg32, tcfg, variables, d, model_kwargs=model_kwargs,
                                       affine_weights=affine_weights)
            runs.append(step_record(state, step(state, b3, b2, **step_kwargs)))
            del state
    finally:
        efficientnet_v2.SURVIVAL_PROB = saved_survival
    worst, ok = step_deviations(*runs, tcfg)
    if not ok:
        fail(name, f'the float32 GPU step differs from the CPU step: {worst}')
    return worst


def step_record(state, losses) -> dict:
    """One step's losses, gradients, updated parameters, Adam moments, EMA
    and BatchNorm statistics, as float32 host tensors (tensor-parallel
    leaves gathered to their full shapes: a collective)."""
    from metrabs_tpu_torch.parallel import mesh as mesh_mod
    from metrabs_tpu_torch.train import loop

    full = loop.full_train_state_dict(state)
    grads = {k: p.grad for k, p in state.params().items()}
    if state.sharded:
        grads = mesh_mod.gather_named(grads, state.sharded, state.mesh)
    named = lambda t: {k: v.detach().float().cpu() for k, v in t.items()}
    adam = full['opt_state']['groups']['all']
    return dict(losses=named(losses), grads=named(grads),
                params=named({k: full['model'][k] for k in grads}), mu=named(adam['mu']),
                nu=named(adam['nu']), ema=named(full['ema_params']),
                stats=named({k: v for k, v in full['model'].items()
                             if k.endswith(('running_mean', 'running_var'))}))


def step_deviations(got: dict, want: dict, tcfg, stats_atol: float = 1e-7,
                    rel_scale: float = 1.0):
    """(the worst deviations of step record `got` from `want`, whether they
    are within the parity tolerance of tests/_torch_train.py), with Adam's
    moments held per tensor as the gradients are (mu is 0.1 g after one
    step; float32 rounding through forty train-mode BatchNorms reaches
    ~6e-5 of a tensor's largest gradient, beyond an elementwise rtol on its
    small elements). The BatchNorm statistics within `stats_atol` + 1e-4
    relative. `rel_scale` multiplies the relative limits of the losses,
    gradients, moments and statistics."""
    lr = float(tcfg.base_learning_rate)
    worst = {}
    worst['loss_rel'] = max(abs(got['losses'][k] - want['losses'][k]).item()
                            / abs(want['losses'][k]).item() for k in want['losses'])
    # A tensor whose gradient is zero in exact arithmetic (the bias of a BN
    # that the next train-mode BN cancels) holds rounding noise on both
    # sides: it and its moments are held against the model's largest value.
    largest_grad = max(v.abs().max().item() for v in want['grads'].values())
    zero = {k for k, w in want['grads'].items() if w.abs().max().item() < 1e-6 * largest_grad}
    for key in ('grads', 'mu', 'nu'):
        largest = max(v.abs().max().item() for v in want[key].values())
        worst[f'{key}_rel_to_tensor_max'] = max(
            (got[key][k] - w).abs().max().item() / (largest if k in zero else w.abs().max().item())
            for k, w in want[key].items())
    stats_excess = max(((got['stats'][k] - w).abs()
                        - rel_scale * (stats_atol + 1e-4 * w.abs())).max().item()
                       for k, w in want['stats'].items())
    moved = {k: (got['params'][k] - w).abs() for k, w in want['params'].items()}
    n_near = sum(int((d <= 1e-2 * lr).sum()) for d in moved.values())
    n_all = sum(d.numel() for d in moved.values())
    worst['params_max_over_lr'] = max(d.max().item() for d in moved.values()) / lr
    worst['params_near_share'] = n_near / n_all
    # The EMA blends (1 - momentum) of the updated parameters in (all of
    # them at momentum 1): it carries that share of their difference.
    carried = 1.0 if tcfg.ema_momentum >= 1.0 else 1.0 - tcfg.ema_momentum
    ema_excess = max(((got['ema'][k] - w).abs() - carried * moved[k]
                      - (1e-7 + 1e-4 * w.abs())).max().item() for k, w in want['ema'].items())
    worst['stats_excess'], worst['ema_excess'] = stats_excess, ema_excess
    limit = lambda rel: rel_scale * rel
    ok = (worst['loss_rel'] <= limit(1e-4) and worst['grads_rel_to_tensor_max'] <= limit(1e-4)
          and worst['mu_rel_to_tensor_max'] <= limit(1e-4)
          and worst['nu_rel_to_tensor_max'] <= limit(2e-4)
          and stats_excess <= 0 and ema_excess <= 0 and worst['params_max_over_lr'] <= 2
          and worst['params_near_share'] >= 0.999)
    return worst, ok


def profile_step(run):
    """One `run()` under torch.profiler: (wall ms, device busy ms, kernels,
    {kernel group: device ms})."""
    from torch.autograd import DeviceType

    events, wall_ms = profiled(run, 'train')
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    kernels = [e for e in device if not e.name.startswith(('Memcpy', 'Memset'))]
    groups = {}
    for e in device:
        name = e.name.lower()
        group = next((g for g, keys in TRAIN_KERNEL_GROUPS if any(k in name for k in keys)),
                     'other')
        groups[group] = groups.get(group, 0.0) + e.device_time_total / 1e3
    return wall_ms, sum(e.device_time_total for e in device) / 1e3, len(kernels), groups


def train_steps(state, step, tcfg, dev, name: str, n_warmup: int, n_timed: int,
                fall_window: int, bone_stats=None, first_example: int = 0) -> dict:
    """`n_warmup` + `n_timed` steps of `step` on the repeated synthetic batch
    (`synthetic_batches` from `first_example`, updating `bone_stats`), then
    one more under torch.profiler, with the drop-connect masks (and the
    Metrabs step's mix) from a generator on `dev`. Fails unless every loss is finite, the mean
    loss of the last `fall_window` steps is below that of the first, every
    backbone parameter got a nonzero gradient in the last step and no step
    launched K1 or K2. Returns the median step time, the busy share of the
    profiled step, the peak memory since the caller's
    `reset_peak_memory_stats`, the last batch (host tensors) and a `summary`
    line."""
    from metrabs_tpu_torch.ops import mbconv_cuda, warp_cuda

    gen = torch.Generator(device=dev).manual_seed(tcfg.seed)
    batches, loaders = synthetic_batches(tcfg, n_warmup + n_timed + 1, dev, bone_stats,
                                         first_example)
    warp_cuda.warp_pyramid.launches = mbconv_cuda.fused_mbconv_inner.launches = 0
    losses, times = [], []
    try:
        for _ in range(n_warmup + n_timed):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            b3, b2 = split_streams(next(batches))
            losses.append(step(state, b3, b2, generator=gen))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        b3, b2 = split_streams(next(batches))
        wall_ms, busy_ms, n_kernels, groups = profile_step(
            lambda: losses.append(step(state, b3, b2, generator=gen)))
    finally:
        for loader in loaders:
            loader.close()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    if warp_cuda.warp_pyramid.launches or mbconv_cuda.fused_mbconv_inner.launches:
        fail(name, 'a train step launched K1 or K2')
    loss = torch.stack([l['loss'] for l in losses]).float().cpu()
    if not all(bool(torch.isfinite(v).all()) for l in losses for v in l.values()):
        fail(name, f'non-finite losses: {loss.tolist()}')
    if not loss[-fall_window:].mean() < loss[:fall_window].mean():
        fail(name, f'the loss on the repeated batch does not fall: {loss.tolist()}')
    silent = [n for n, p in state.model.backbone.named_parameters()
              if p.grad is None or not p.grad.abs().max() > 0]
    if silent:
        fail(name, f'{len(silent)} backbone parameters got no gradient, e.g. {silent[:4]}')
    step_s = statistics.median(times[n_warmup:])
    n_images = tcfg.batch_size + tcfg.batch_size_2d
    summary = (
        f'{n_timed} timed steps after {n_warmup}: median {step_s * 1e3:.1f} ms/step '
        f'(CUDA-synchronised), {n_images / step_s:.1f} images/s; all: '
        + ', '.join(f'{t * 1e3:.1f}' for t in times)
        + f'; one step under torch.profiler: wall {wall_ms:.1f} ms, device busy '
          f'{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%), {n_kernels} kernels; peak '
          f'memory {peak_gb:.2f} GiB (max_memory_allocated); device time: '
        + ', '.join(f'{g} {ms:.2f} ms ({100 * ms / busy_ms:.1f}%)'
                    for g, ms in sorted(groups.items(), key=lambda x: -x[1]))
        + f'; loss first {loss[0]:.4f}, last {loss[-1]:.4f} (repeated batch; all: '
        + ', '.join(f'{v:.4f}' for v in loss.tolist()) + '); every backbone parameter got a '
          'nonzero gradient; K1 and K2 launches in training: 0')
    host = lambda batch: {k: v.cpu() for k, v in batch.items()}
    return dict(step_s=step_s, busy_share=busy_ms / wall_ms, peak_gb=peak_gb,
                batch=(host(b3), host(b2)), summary=summary)


def train_phase(root: Path, dev, frames, boxes, box_valid) -> dict:
    """The [train] phase (module docstring). Returns the K1 and K2 launches
    of the serving run after training and the median step time. The trained
    package stays at
    TRAINED_PACKAGE under `root` for [train_families]; the caller deletes
    it."""
    from metrabs_tpu_torch.config import AugConfig, ModelConfig, TrainConfig
    from metrabs_tpu_torch.io.packaging import save_pose_estimator_package
    from metrabs_tpu_torch.io.weights import flax_variables_from_state_dict
    from metrabs_tpu_torch.pipeline.skeletons import H36M_17

    cfg = ModelConfig(**manifest_for('bfloat16')['model_config'])
    tcfg = TrainConfig()
    variables = mint_crop_variables(cfg, torch.Generator().manual_seed(tcfg.seed))
    torch.cuda.reset_peak_memory_stats()
    state, step = make_trainer(cfg, tcfg, variables, dev, fuse='on')
    if sum(getattr(b, 'fusable', False) and b.fuse == 'on'
           for b in state.model.backbone.blocks) != K2_BLOCKS:
        fail('train', f'expected {K2_BLOCKS} blocks built with fuse_mbconv on')
    run = train_steps(state, step, tcfg, dev, 'train', TRAIN_WARMUP, TRAIN_STEPS, fall_window=5)
    phase('train', f'EffNetV2-S@{PROC_SIDE} Metrabs, bf16 compute, f32 master weights, '
                   f'fuse_mbconv on, batch {tcfg.batch_size}+{tcfg.batch_size_2d}: '
                   + run['summary'])
    worst = train_parity(cfg, tcfg, variables, dev)
    phase('train', 'float32 step, GPU (TF32 off) vs CPU from the same state and mix: '
                   + ', '.join(f'{k} {v:.3g}' for k, v in worst.items()))

    # Serve the EMA weights through a package, kept for [train_families].
    package = root / TRAINED_PACKAGE
    save_pose_estimator_package(
        str(package), cfg=cfg, aug_cfg=AugConfig(), joint_info=H36M_17,
        crop_model_variables=flax_variables_from_state_dict(state.ema_state_dict()))
    del state
    chunks = math.ceil(int(box_valid.sum()) / (INTERNAL_BATCH // NUM_AUG))
    k1_folded = serve_folded(package, dev, frames, boxes, box_valid, 'train')[1]
    k1_fused, k2, err_v, n_blocks = serve_fused(package, dev, frames, boxes, box_valid,
                                                'train')[1:]
    phase('train', f'trained EMA weights packaged and served ({int(box_valid.sum())} valid '
                   f'boxes, {chunks} chunks): folded K1 launches {k1_folded}; unfused with '
                   f'fuse_mbconv on K1 {k1_fused}, K2 {k2}, K2 v vs plain on the trained '
                   f'weights {err_v:.3g} on the first chunk\'s input to each of the '
                   f'{n_blocks} blocks; poses finite')
    return dict(k1=k1_fused, k2=k2, step_s=run['step_s'])


def serve_folded(package: Path, dev, frames, boxes, box_valid, name: str):
    """`load_pose_estimator(package)` (bf16, BN folded) on the main frames and
    boxes, warmed up, then counted: K1 must run once per non-empty chunk and
    K2 never, the poses of valid boxes be finite. Returns (output, K1
    launches)."""
    from metrabs_tpu_torch.io.packaging import load_pose_estimator
    from metrabs_tpu_torch.ops import mbconv_cuda, warp_cuda

    chunks = math.ceil(int(box_valid.sum()) / (INTERNAL_BATCH // NUM_AUG))
    est = load_pose_estimator(str(package), device=dev)
    run = lambda: est.estimate_poses_batched(frames, boxes, box_valid, num_aug=NUM_AUG,
                                             internal_batch_size=INTERNAL_BATCH)
    run()  # warm-up
    torch.cuda.synchronize()
    warp_cuda.warp_pyramid.launches = mbconv_cuda.fused_mbconv_inner.launches = 0
    out = run()
    torch.cuda.synchronize()
    k1, k2 = warp_cuda.warp_pyramid.launches, mbconv_cuda.fused_mbconv_inner.launches
    if not est.cfg.bn_fold or k1 != chunks or k2 != 0:
        fail(name, f'folded serving: bn_fold {est.cfg.bn_fold}, K1 launched {k1} times and K2 '
                   f'{k2}, expected {chunks} and 0')
    check_served_poses(out, dev, box_valid, name)
    return out, k1


def serve_fused(package: Path, dev, frames, boxes, box_valid, name: str):
    """`load_pose_estimator(package)` unfolded with `fuse_mbconv='on'` on the
    main frames and boxes: K1 must run once and K2 K2_BLOCKS times per
    non-empty chunk, and K2's v on the first chunk's input to each fused
    block equal the plain chain's on the package's weights. Returns (output,
    K1 launches, K2 launches, max |kernel - plain| of v, blocks checked)."""
    from metrabs_tpu_torch.io.packaging import load_pose_estimator
    from metrabs_tpu_torch.models.backbones.builder import build_backbone

    chunks = math.ceil(int(box_valid.sum()) / (INTERNAL_BATCH // NUM_AUG))
    fused = load_pose_estimator(str(package), device=dev, cfg_overrides={'bn_fold': False},
                                backbone_builder=functools.partial(build_backbone,
                                                                   fuse_mbconv='on'))
    out, k1, k2, err_v, n_blocks = k2_v_error(fused, lambda: fused.estimate_poses_batched(
        frames, boxes, box_valid, num_aug=NUM_AUG, internal_batch_size=INTERNAL_BATCH))
    if k1 != chunks or k2 != K2_BLOCKS * chunks:
        fail(name, f'fused serving: K1 launched {k1} times and K2 {k2}, expected {chunks} and '
                   f'{K2_BLOCKS * chunks}')
    if n_blocks != K2_BLOCKS or err_v != 0.0:
        fail(name, f'K2 on the trained weights: max |kernel - plain| v {err_v:.3g} over '
                   f'{n_blocks} blocks (must be 0)')
    check_served_poses(out, dev, box_valid, name)
    return out, k1, k2, err_v, n_blocks


def keep_first_input(inputs: dict, block, module, args, output) -> None:
    """A forward hook on a fused block's expand conv: keeps the output of its
    first call (the chain's input) in `inputs[block]`. It returns None, so
    the forward goes on with its own output."""
    if block not in inputs:
        inputs[block] = output.contiguous()


def k2_v_error(est, run):
    """`run()` once with K1's and K2's counts set to 0 and a hook on each
    fused block of `est`'s backbone keeping the first input to its chain;
    then K2 on each kept input against the plain chain on the block's
    constants (made from the loaded weights at the first call). Returns
    (run's output, K1 launches, K2 launches, max |kernel - plain| of v,
    blocks checked)."""
    from metrabs_tpu_torch.ops import mbconv, mbconv_cuda, warp_cuda

    fused_blocks = [b for b in est.crop_model.backbone.blocks if getattr(b, 'fusable', False)]
    inputs = {}
    hooks = [b.expand_conv.register_forward_hook(
        functools.partial(keep_first_input, inputs, b)) for b in fused_blocks]
    torch.cuda.synchronize()
    warp_cuda.warp_pyramid.launches = mbconv_cuda.fused_mbconv_inner.launches = 0
    try:
        out = run()
        torch.cuda.synchronize()
    finally:
        for hook in hooks:
            hook.remove()
    k1, k2 = warp_cuda.warp_pyramid.launches, mbconv_cuda.fused_mbconv_inner.launches
    err_v = max((mbconv_cuda.fused_mbconv_inner(u, *b._inner_constants())[0].float()
                 - mbconv.fused_mbconv_inner(u, *b._inner_constants())[0].float()
                 ).abs().max().item() for b, u in inputs.items()) if inputs else math.inf
    return out, k1, k2, err_v, len(inputs)


def native_warp_error(flat, params, geom, output_shape, got) -> tuple:
    """(max |crops - native.bilinear_warp|, crops compared, crops skipped):
    each crop of a warp launch against the C++ warp on its level image cut
    from `flat`, with its own level-adjusted intrinsics (`utils/native.py::
    warp_params_oracle`). Crops whose parameters are not finite (the
    padding of degenerate boxes, whose output is discarded) are skipped."""
    from metrabs_tpu_torch.utils import native

    finite = torch.isfinite(params).all(1).cpu().numpy()
    crops = np.flatnonzero(finite)
    if not len(crops):
        return 0.0, 0, len(finite)
    want = native.warp_params_oracle(flat, params, geom, output_shape, crops=crops)
    err = float(np.abs(got[torch.as_tensor(crops, device=got.device)].float().cpu().numpy()
                       - want).max())
    return err, len(crops), int((~finite).sum())


def checked_warps(run, native_errors=None):
    """`run()` with `warp_cuda.warp_pyramid` wrapped: each launch's crops are
    held against the plain `ops.warp.warp_pyramid` on the same tensors (and,
    given a list `native_errors`, against the C++ warp: `native_warp_error`
    of each launch is appended). Returns (run's output, max |kernel - plain|
    of each launch). The kernel's wrapper counts on the module's name, the
    wrapper here while it stands there: its count starts from the kernel's
    and goes back to it."""
    from metrabs_tpu_torch.ops import warp as warp_ops
    from metrabs_tpu_torch.ops import warp_cuda

    kernel, errors = warp_cuda.warp_pyramid, []

    def compared(flat, params, geom, output_shape, **kwargs):
        launches = compared.launches
        got = kernel(flat, params, geom, output_shape, **kwargs)
        if compared.launches != launches:
            want = warp_ops.warp_pyramid(flat, params, geom, output_shape)
            errors.append((got - want).abs().max().item())
            if native_errors is not None:
                native_errors.append(native_warp_error(flat, params, geom, output_shape, got))
        return got

    compared.launches = kernel.launches
    warp_cuda.warp_pyramid = compared
    try:
        return run(), errors
    finally:
        warp_cuda.warp_pyramid = kernel
        kernel.launches = compared.launches


def checked_mbconv(run):
    """`run()` with `mbconv_cuda.fused_mbconv_inner` wrapped as
    `checked_warps` wraps the warp: each launch's v and SE mean are held
    against the plain `ops.mbconv.fused_mbconv_inner` on the same tensors.
    Returns (run's output, max |kernel - plain| of v per launch, of the
    mean per launch)."""
    from metrabs_tpu_torch.ops import mbconv, mbconv_cuda

    kernel, errors_v, errors_mean = mbconv_cuda.fused_mbconv_inner, [], []

    def compared(u, taps, sb):
        launches = compared.launches
        v, mean = kernel(u, taps, sb)
        if compared.launches != launches:
            want_v, want_mean = mbconv.fused_mbconv_inner(u, taps, sb)
            errors_v.append((v.float() - want_v.float()).abs().max().item())
            errors_mean.append((mean - want_mean).abs().max().item())
        return v, mean

    compared.launches = kernel.launches
    compared.launches_by_shape = kernel.launches_by_shape
    mbconv_cuda.fused_mbconv_inner = compared
    try:
        return run(), errors_v, errors_mean
    finally:
        mbconv_cuda.fused_mbconv_inner = kernel
        kernel.launches = compared.launches


def check_served_poses(out, dev, box_valid, name: str) -> None:
    valid_t = torch.as_tensor(box_valid, device=dev)
    if not torch.equal(out['valid'], valid_t) or not all(
            bool(torch.isfinite(out[k][valid_t]).all()) for k in ('poses3d', 'poses2d')):
        fail(name, 'non-finite poses or a wrong valid mask from a trained package')


# The [families] phase: (label, backbone, extra model config, build_crop_model
# arguments) of part (c), each in float32 on the GPU against the CPU.
FAMILY_CASES = (
    ('MobileNetV3-S-mini', 'mobilenetv3-small-mini', {}, {}),
    ('ResNet-18', 'resnet18', {}, {}),
    ('ResNet-50 V1.5-GroupNorm (unfolded)', 'resnet50v1-5-groupnorm', {}, {}),
    ('ResNet-50 V2 (unfolded)', 'resnet50v2', {}, {}),
    ('ResNet-50-stride16, stride_test 8', 'resnet50-stride16',
     dict(stride_train=16, stride_test=8), {}),
    ('Model25D on MobileNetV3-S-mini', 'mobilenetv3-small-mini', {},
     dict(model_class='model25d')),
    ('latent transform_coords on MobileNetV3-S-mini', 'mobilenetv3-small-mini', {},
     dict(latent_mode='transform_coords', n_latents=32)),
    ('latent predict_all_and_latents on MobileNetV3-S-mini', 'mobilenetv3-small-mini', {},
     dict(latent_mode='predict_all_and_latents', n_latents=32)))
FAMILY_DETECTOR = 'yolov8m'
RESIDUAL_GAIN = 0.3  # `family_variables`
FAMILY_DETECTOR_SIZE = 640


def family_manifest(backbone: str, dtype: str, model_config=None, detector: str = '',
                    **crop_model_kwargs) -> dict:
    """A package manifest of the minted crop model on `backbone` (plus
    `model_config` fields), of the class and latent mode of
    `crop_model_kwargs` (Model25D with the H36M bones at 300 mm), with a
    `detector` at FAMILY_DETECTOR_SIZE if one is named."""
    manifest = manifest_for(dtype)
    manifest['model_config'] = dict(manifest['model_config'], backbone=backbone,
                                    **(model_config or {}))
    manifest.update(model_class=crop_model_kwargs.get('model_class', 'metrabs'),
                    latent_mode=crop_model_kwargs.get('latent_mode', ''),
                    n_latents=crop_model_kwargs.get('n_latents', 0))
    if manifest['model_class'] == 'model25d':
        manifest.update(bones_25d=JOINT_EDGES, bone_lengths_ideal=[300.0] * len(JOINT_EDGES))
    if detector:
        manifest.update(has_detector=True, detector_type=detector, detector_dtype=dtype,
                        detector_input_size=FAMILY_DETECTOR_SIZE, detector_scan_repeats=True)
    return manifest


def family_variables(manifest: dict, gen: torch.Generator, dev):
    """Minted variables (`mint_crop_variables`) of the manifest's crop model,
    made to behave as a trained net's: the BatchNorm running statistics set
    to the batch statistics of 16 uniform random crops (one train-mode
    forward on `dev` in float32), then the last layer of each ResNet
    residual branch scaled by RESIDUAL_GAIN (trained ResNets keep their
    branches small). Without either, a random ResNet-50 is chaotic: its
    activations reach the thousands (ResNet V1's caffe input), some joints
    fall behind the camera, and a relative input change of 1e-6 moves its
    poses by ~3 mm on the CPU (0.006 mm with both)."""
    from metrabs_tpu_torch.config import ModelConfig
    from metrabs_tpu_torch.io.packaging import crop_model_kwargs
    from metrabs_tpu_torch.io.weights import (crop_model_state_dict_from_flax,
                                              flax_variables_from_state_dict)
    from metrabs_tpu_torch.models.backbones import resnet
    from metrabs_tpu_torch.models.backbones.common import GhostBatchNorm
    from metrabs_tpu_torch.models.metrabs import build_crop_model

    cfg = ModelConfig(**dict(manifest['model_config'], dtype='float32'))
    kwargs = crop_model_kwargs(manifest)
    variables = mint_crop_variables(cfg, gen, **kwargs)
    model = build_crop_model(cfg, **kwargs)
    model.load_state_dict(crop_model_state_dict_from_flax(variables, cfg, **kwargs))
    model.to(dev).train()
    for m in model.modules():
        if isinstance(m, GhostBatchNorm):
            m.momentum = 0.0
    crops = torch.rand((16, cfg.proc_side, cfg.proc_side, 3), generator=gen).to(dev)
    last_layers = {resnet.BottleneckBlock: 'bn3', resnet.BasicBlock: 'bn2',
                   resnet.PreactBlock: 'conv3'}
    with torch.no_grad():
        model.backbone(crops)
        for m in model.modules():
            if type(m) in last_layers:
                for p in getattr(m, last_layers[type(m)]).parameters():
                    p.mul_(RESIDUAL_GAIN)
    return flax_variables_from_state_dict(model.state_dict())


def timed_calls(run, n: int = 5):
    """Wall seconds of `n` CUDA-synchronised calls."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


TOOLS_TRACE_DIR = 'runs/chip_smoke_tools_trace'  # the profile's trace (deleted after)
TOOLS_BUSY_TOL = 0.005  # |sum of the categories - busy time| / busy time


def tools_phase(root: Path, est, frames, dev, chunks: int) -> dict:
    """The [tools] phase (module docstring) on the detect cell's estimator
    `est` and `frames`, whose run has `chunks` non-empty chunks. Returns
    {'tools': (K1 launches, K2 launches)} of the profiled call."""
    import types

    from scripts import _flops_torch, _tracelib_torch
    from scripts import profile_trace_torch as trace_tool

    run, modules, _ = trace_tool.build_detect(types.SimpleNamespace(k2='on'), dev, est, frames)
    try:
        s = trace_tool.profile(run, 1, str(root / TOOLS_TRACE_DIR), dev, modules)
    finally:
        shutil.rmtree(root / TOOLS_TRACE_DIR, ignore_errors=True)
    k1, k2 = _tracelib_torch.K1, _tracelib_torch.K2
    want = {k1: chunks, k2: K2_BLOCKS * chunks}
    seen = {k: s['category_launches'][k] for k in want}
    counted = {k: s['wrapper_launches'][k] for k in want}
    if seen != want or counted != want:
        fail('tools', f'K1/K2 launches in the trace {seen}, counted by the wrappers {counted}, '
                      f'expected {want}')
    gap = abs(sum(s['categories_ms'].values()) - s['busy_ms']) / s['busy_ms']
    if not gap <= TOOLS_BUSY_TOL:
        fail('tools', f'the categories sum to {sum(s["categories_ms"].values()):.3f} ms against '
                      f'{s["busy_ms"]:.3f} ms busy ({100 * gap:.2f}% > {100 * TOOLS_BUSY_TOL}%)')
    gflop = _flops_torch.gflop_per_crop('efficientnetv2-s', PROC_SIDE)
    phase('tools', f'profile_trace_torch detect (K2 on): device {s["device_ms"]:.3f} ms, busy '
                   f'{s["busy_ms"]:.3f} ms over {s["device_events"]} device events, categories '
                   f'within {100 * gap:.4f}% of busy; wall {s["wall_ms"]:.1f} ms, '
                   f'{s["profiled_wall_ms"]:.1f} ms profiled ({100 * s["busy_share"]:.1f}% busy '
                   f'unprofiled); '
                   f'K1 {seen[k1]} and K2 {seen[k2]} launches in the trace and the wrappers '
                   f'({s["attempts"]} profile(s))')
    for cat, ms in sorted(s['categories_ms'].items(), key=lambda kv: -kv[1]):
        phase('tools', f'  {cat}: {ms:.3f} ms ({100 * ms / s["device_ms"]:.1f}%), '
                       f'{s["category_launches"][cat]} launches')
    for k in s['top_kernels'][:5]:
        phase('tools', f'  top: {k["ms"]:.3f} ms, {k["launches"]:.0f}x [{k["category"]}] '
                       f'{k["name"][:90]}')
    phase('tools', 'convolution inputs by memory format: ' + ', '.join(
        f'{k} {v}' for k, v in sorted(s['conv_input_formats'].items())))
    phase('tools', f'_flops_torch: EffNetV2-S@{PROC_SIDE} forward {gflop:.4f} GFLOP per crop '
                   f'(convolutions and matrix products, 2 x multiply-adds)')
    return {'tools': (seen[k1], seen[k2])}


def families_phase(root: Path, dev, frames, boxes, box_valid) -> dict:
    """The [families] phase: (a) `detect_poses_batched` of ResNet-50@256
    (metrabs_rn50_y4's crop model) bf16 with BN folded, plus a YOLOv8-m@640
    bf16, on the main frames; (b) `estimate_poses_batched` of
    MobileNetV3-L@256 (metrabs_mob3l_y4t's) bf16 folded on the main frames
    and boxes; (c) every other family of FAMILY_CASES in float32 on the GPU
    against the CPU on a small frame, Metro built by `load_crop_model` and
    refused by `load_pose_estimator`, and a float32 YOLOv8-n's GPU and CPU
    detections. Returns the K1 and K2 launches of each path."""
    from metrabs_tpu_torch.config import AugConfig, ModelConfig
    from metrabs_tpu_torch.io.packaging import (detector_from_variables, load_crop_model,
                                                load_pose_estimator,
                                                pose_estimator_from_variables,
                                                save_pose_estimator_package)
    from metrabs_tpu_torch.models.metro import Metro
    from metrabs_tpu_torch.ops import mbconv_cuda, warp_cuda
    from metrabs_tpu_torch.pipeline.skeletons import H36M_17

    gen = torch.Generator().manual_seed(SEED + 5)
    launches = {}

    def count(run):
        torch.cuda.synchronize()
        warp_cuda.warp_pyramid.launches = mbconv_cuda.fused_mbconv_inner.launches = 0
        out = run()
        torch.cuda.synchronize()
        return out, warp_cuda.warp_pyramid.launches, mbconv_cuda.fused_mbconv_inner.launches

    # (a) ResNet-50@256 + YOLOv8-m@640, detect path.
    manifest = family_manifest('resnet50', 'bfloat16', detector=FAMILY_DETECTOR)
    variables = family_variables(manifest, gen, dev)
    det_variables = mint_detector_variables(gen, FAMILY_DETECTOR)
    est = pose_estimator_from_variables(variables, manifest, device=dev,
                                        detector_variables=det_variables)
    if (not est.cfg.bn_fold or type(est.detector.model).__name__ != 'YOLOv8'
            or est.detector.input_size != FAMILY_DETECTOR_SIZE):
        fail('families', f'expected folded ResNet-50 and YOLOv8-m@{FAMILY_DETECTOR_SIZE}')
    detect = lambda: est.detect_poses_batched(
        frames, num_aug=NUM_AUG, max_detections=MAX_DETECTIONS,
        internal_batch_size=INTERNAL_BATCH, detector_threshold=0.0,
        suppress_implausible_poses=True)
    detect()  # warm-up (cuDNN algorithm selection)
    with torch.inference_mode():
        _, det_valid = est.detector.detect_batched(frames, threshold=0.0,
                                                   max_detections=MAX_DETECTIONS)
    n_detected = int(det_valid.sum())
    out, k1, k2 = count(detect)
    chunks = math.ceil(n_detected / (INTERNAL_BATCH // NUM_AUG))
    want_shapes = dict(boxes=(8, MAX_DETECTIONS, 5), poses3d=(8, MAX_DETECTIONS, 17, 3),
                       poses2d=(8, MAX_DETECTIONS, 17, 2), valid=(8, MAX_DETECTIONS))
    if {k: tuple(v.shape) for k, v in out.items()} != want_shapes:
        fail('families', f'detect output shapes {[tuple(v.shape) for v in out.values()]}')
    if n_detected == 0 or (out['valid'] & ~det_valid).any():
        fail('families', f'{n_detected} detections; the filter must only drop detections')
    for k in ('boxes', 'poses3d', 'poses2d'):
        if not torch.isfinite(out[k][det_valid]).all():
            fail('families', f'non-finite {k} on detected rows')
    if k1 != chunks or k2 != 0:
        fail('families', f'detect: K1 launched {k1} times and K2 {k2}, expected {chunks} and 0')
    launches['families_detect'] = (k1, k2)

    # The float32 pair on the GPU (TF32 off) against the CPU, small frame.
    manifest32 = family_manifest('resnet50', 'float32', detector=FAMILY_DETECTOR)
    ests32 = [pose_estimator_from_variables(variables, manifest32, device=d,
                                            detector_variables=det_variables)
              for d in (dev, 'cpu')]
    small = frames[:1, 300:660, 500:980].contiguous()
    small_kwargs = dict(num_aug=NUM_AUG, max_detections=4, detector_threshold=0.0,
                        suppress_implausible_poses=False)
    with torch.inference_mode():
        (b_got, v_got), (b_want, v_want) = [
            e.detector.detect_batched(x, threshold=0.0, max_detections=4)
            for e, x in zip(ests32, (small, small.cpu()))]
    box_err = (b_got.cpu() - b_want).abs().max().item()
    if not torch.equal(v_got.cpu(), v_want) or not box_err <= BOX_TOL_PX:
        fail('families', f'float32 GPU YOLOv8-m detections differ from the CPU: masks '
                         f'{v_got.tolist()} vs {v_want.tolist()}, boxes by {box_err:.3g} px')
    got32, want32 = [e.detect_poses_batched(x, **small_kwargs)
                     for e, x in zip(ests32, (small, small.cpu()))]
    v32 = want32['valid']
    det_pose_err = (got32['poses3d'].cpu()[v32] - want32['poses3d'][v32]).abs().max().item()
    if not torch.equal(got32['valid'].cpu(), v32) or not torch.allclose(
            got32['poses3d'].cpu()[v32], want32['poses3d'][v32], atol=POSE_ATOL_MM,
            rtol=POSE_RTOL):
        fail('families', f'float32 GPU ResNet-50 + YOLOv8-m poses differ from the CPU by '
                         f'{det_pose_err:.3g} mm')
    del ests32
    times = timed_calls(detect)
    wall_ms, device_ms, host_ms, busy_ms, n_kernels, counts = profile_detect(est, detect)
    phase('families', f'(a) detect_poses_batched YOLOv8-m@{FAMILY_DETECTOR_SIZE} bf16 + '
                      f'ResNet-50@{PROC_SIDE} bf16 folded, {N_FRAMES}x{FRAME_H}p, '
                      f'max_detections {MAX_DETECTIONS}, num_aug {NUM_AUG}, threshold 0: '
                      f'{n_detected} detections, {int(out["valid"].sum())} after the filter; '
                      f'K1 {k1}, K2 {k2} ({chunks} chunks); f32 GPU vs CPU: masks equal, max '
                      f'|dbox| {box_err:.3g} px, max |dpose| {det_pose_err:.3g} mm; '
                      f'{statistics.median(times) * 1e3:.1f} ms/call (median of {len(times)}; '
                      f'all: {", ".join(f"{t * 1e3:.1f}" for t in times)})')
    phase('families', f'(a) one call under torch.profiler: wall {wall_ms:.1f} ms, device busy '
                      f'{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%), {n_kernels} kernels; '
                      + ', '.join(f'{name} {device_ms[name]:.3f} ms'
                                  + (f' (host {host_ms[name]:.1f} ms)' if name in host_ms else '')
                                  for name in sorted(device_ms, key=device_ms.get, reverse=True)))
    if counts['K1 (warp kernel)'] != k1:
        fail('families', f'the profiler saw {counts["K1 (warp kernel)"]} warp kernels, the '
                         f'wrapper counted {k1}')
    del est

    # (b) MobileNetV3-L@256, estimate path.
    manifest = family_manifest('mobilenetv3-large', 'bfloat16')
    est = pose_estimator_from_variables(family_variables(manifest, gen, dev), manifest,
                                        device=dev)
    if not est.cfg.bn_fold:
        fail('families', 'expected the folded MobileNetV3-L')
    run = lambda: est.estimate_poses_batched(frames, boxes, box_valid, num_aug=NUM_AUG,
                                             internal_batch_size=INTERNAL_BATCH)
    run()  # warm-up
    out, k1, k2 = count(run)
    chunks = math.ceil(int(box_valid.sum()) / (INTERNAL_BATCH // NUM_AUG))
    valid_t = torch.as_tensor(box_valid, device=dev)
    if not torch.equal(out['valid'], valid_t) or not all(
            bool(torch.isfinite(out[k][valid_t]).all()) for k in ('poses3d', 'poses2d')):
        fail('families', 'MobileNetV3-L: non-finite poses or a wrong valid mask')
    if k1 != chunks or k2 != 0:
        fail('families', f'estimate: K1 launched {k1} times and K2 {k2}, expected {chunks} '
                         f'and 0')
    launches['families_estimate'] = (k1, k2)
    times = timed_calls(run)
    wall_ms, device_ms, host_ms, busy_ms, n_kernels, counts = profile_detect(est, run)
    phase('families', f'(b) estimate_poses_batched MobileNetV3-L@{PROC_SIDE} bf16 folded, '
                      f'{N_FRAMES}x{FRAME_H}p, {int(box_valid.sum())} valid boxes, num_aug '
                      f'{NUM_AUG}: K1 {k1}, K2 {k2} ({chunks} chunks); '
                      f'{statistics.median(times) * 1e3:.1f} ms/call (median of {len(times)}; '
                      f'all: {", ".join(f"{t * 1e3:.1f}" for t in times)}); one call under '
                      f'torch.profiler: wall {wall_ms:.1f} ms, device busy {busy_ms:.2f} ms '
                      f'({100 * busy_ms / wall_ms:.1f}%), {n_kernels} kernels; '
                      + ', '.join(f'{name} {device_ms[name]:.3f} ms' for name in
                                  sorted(device_ms, key=device_ms.get, reverse=True)))
    del est

    # (c) Every other family, float32, GPU against CPU on a small frame.
    small = frames[:1, 400:700, 600:1000].contiguous()
    small_boxes = np.array([[[60, 20, 110, 250], [200, 40, 120, 240]]], np.float32)
    other = frames[1:2, 400:700, 600:1000].contiguous()
    k1_total = k2_total = 0
    results = []
    for label, backbone, model_config, kwargs in FAMILY_CASES:
        manifest = family_manifest(backbone, 'float32', model_config, **kwargs)
        variables = family_variables(manifest, gen, dev)
        pair = [pose_estimator_from_variables(variables, manifest, device=d)
                for d in (dev, 'cpu')]
        (got, k1, k2) = count(lambda: pair[0].estimate_poses_batched(small, small_boxes,
                                                                     num_aug=NUM_AUG))
        want = pair[1].estimate_poses_batched(small.cpu(), small_boxes, num_aug=NUM_AUG)
        moved = (pair[0].estimate_poses_batched(other, small_boxes, num_aug=NUM_AUG)['poses3d']
                 - got['poses3d']).abs().max().item()
        p_got, p_want = got['poses3d'].cpu(), want['poses3d']
        err = (p_got - p_want).abs().max().item()
        if not (torch.isfinite(p_got).all() and torch.allclose(p_got, p_want, atol=POSE_ATOL_MM,
                                                                  rtol=POSE_RTOL)):
            fail('families', f'{label}: float32 GPU poses differ from the CPU by {err:.3g} mm')
        if not moved > max(10 * err, POSE_ATOL_MM):
            fail('families', f'{label}: another frame moves the poses by {moved:.3g} mm only')
        if k1 != 1 or k2 != 0:
            fail('families', f'{label}: K1 launched {k1} times and K2 {k2}, expected 1 and 0')
        k1_total, k2_total = k1_total + k1, k2_total + k2
        results.append(f'{label} bn_fold={pair[0].cfg.bn_fold}: {err:.3g} mm (another frame '
                       f'moves them {moved:.1f} mm)')
        del pair
    launches['families_f32'] = (k1_total, k2_total)
    phase('families', '(c) float32 GPU (TF32 off) vs CPU, max |dpose|: ' + '; '.join(results))

    # Metro: a bare crop model, refused by the estimator loader.
    package = root / 'runs' / 'chip_smoke_metro_package'
    shutil.rmtree(package, ignore_errors=True)
    try:
        manifest = family_manifest('mobilenetv3-small-mini', 'float32', model_class='metro')
        save_pose_estimator_package(
            str(package), cfg=ModelConfig(**manifest['model_config']), aug_cfg=AugConfig(),
            joint_info=H36M_17, crop_model_variables=family_variables(manifest, gen, dev),
            model_class='metro')
        metro, _, _, _ = load_crop_model(str(package), device=dev)
        with torch.inference_mode():
            rel = metro(torch.rand((2, PROC_SIDE, PROC_SIDE, 3), device=dev))
        if not isinstance(metro, Metro) or rel.shape != (2, 17, 3) or not rel.isfinite().all():
            fail('families', f'load_crop_model gave {type(metro).__name__} {tuple(rel.shape)}')
        try:
            load_pose_estimator(str(package), device=dev)
            fail('families', 'load_pose_estimator accepted a Metro package')
        except ValueError as e:
            refusal = str(e).split(' (')[0]
    finally:
        shutil.rmtree(package, ignore_errors=True)

    # YOLOv8-n in float32: GPU and CPU detections.
    nano = mint_detector_variables(gen, 'yolov8n')
    manifest = family_manifest('mobilenetv3-small-mini', 'float32', detector='yolov8n')
    dets = [detector_from_variables(nano, manifest, bn_fold=False, device=d) for d in (dev, 'cpu')]
    small = frames[:1, 300:660, 500:980].contiguous()
    with torch.inference_mode():
        (b_got, v_got), (b_want, v_want) = [d.detect_batched(x, threshold=0.0, max_detections=4)
                                            for d, x in zip(dets, (small, small.cpu()))]
    box_err = (b_got.cpu() - b_want).abs().max().item()
    if not torch.equal(v_got.cpu(), v_want) or not box_err <= BOX_TOL_PX:
        fail('families', f'YOLOv8-n GPU detections differ from the CPU: masks {v_got.tolist()} '
                         f'vs {v_want.tolist()}, boxes by {box_err:.3g} px')
    phase('families', f'Metro: load_crop_model built {type(metro).__name__}, '
                      f'load_pose_estimator refused it ("{refusal}"); YOLOv8-n float32 GPU vs '
                      f'CPU: masks equal ({int(v_want.sum())} of {v_want.numel()}), max |dbox| '
                      f'{box_err:.3g} px')
    return launches


# The [train_families] phase: (label, build_crop_model arguments, TrainConfig
# fields) of each mode trained at EffNetV2-S@256, in this order; the last is
# warm-started from the [train] phase's package.
FAMILY_TRAIN_MODES = (
    ('Metro', dict(model_class='metro'), {}),
    ('Model25D', dict(model_class='model25d'), {}),
    ('transform_coords', dict(latent_mode='transform_coords'), dict(transform_coords=True)),
    ('predict_all_and_latents', dict(latent_mode='predict_all_and_latents'),
     dict(predict_all_and_latents=True)),
    ('regularize_to_manifold', {}, dict(regularize_to_manifold=True)))
FAMILY_N_LATENTS = 32  # latent points of the minted autoencoder
FAMILY_TRAIN_WARMUP, FAMILY_TRAIN_STEPS = 3, 5
FAMILY_FUSED_SERVE = 'transform_coords'  # the mode also served unfolded through K2
# The families train on examples of their own: the last mode warm-starts
# from a package trained on [train]'s batch, and fine-tuning on that same
# batch again has nothing left to fit.
FAMILY_FIRST_EXAMPLE = 1000
METRIC_RTOL = 1e-4  # GPU vs CPU eval metrics of the same predictions


def score_trained(package: Path, batch3d: dict, dev, label: str):
    """The package's crop model (bf16, eval mode) on its training batch
    `batch3d`, scored by `compute_pose3d_metrics` on the GPU and on the CPU
    from the same predictions, and `rigid_align` on both. Fails where a
    metric, or an aligned pose relative to the largest true coordinate,
    differs by more than METRIC_RTOL. Returns (GPU metrics, worst relative
    metric difference, max |aligned GPU - CPU| mm, the source lines of the
    host syncs in the GPU metrics call)."""
    import warnings

    from metrabs_tpu_torch.eval.metrics import compute_pose3d_metrics
    from metrabs_tpu_torch.io.packaging import load_crop_model
    from metrabs_tpu_torch.ops.procrustes import rigid_align
    from metrabs_tpu_torch.pipeline.skeletons import H36M_17

    model, cfg, _, manifest = load_crop_model(str(package), device=dev)
    is_metro = manifest['model_class'] == 'metro'
    images = batch3d['image'].to(dev, getattr(torch, cfg.dtype))
    with torch.inference_mode():
        pred = (model(images) if is_metro
                else model(images, batch3d['intrinsics'].to(dev))).float()
    true, valid = batch3d['coords3d_true'], batch3d['joint_validity_mask']
    true_dev, valid_dev = true.to(dev), valid.to(dev)
    kwargs = dict(coords3d_pred_is_abs=not is_metro, joint_info=H36M_17)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            got = compute_pose3d_metrics(pred, true_dev, valid_dev, device=dev, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode('default')
    syncs = [f'{Path(w.filename).name}:{w.lineno}' for w in caught
             if 'synchroniz' in str(w.message)]
    want = compute_pose3d_metrics(pred.cpu(), true, valid, device='cpu', **kwargs)
    rel = {k: abs(got[k].item() - w.item()) / max(abs(w.item()), 1e-30) for k, w in want.items()}
    if got.keys() != want.keys() or not all(
            torch.isfinite(v).all() for v in got.values()) or max(rel.values()) > METRIC_RTOL:
        fail('train_families', f'{label}: GPU metrics differ from the CPU\'s: {rel}')
    aligned = [rigid_align(p, t.to(p.device), joint_validity_mask=v.to(p.device),
                           scale_align=True).cpu() for p, t, v in
               ((pred, true, valid), (pred.cpu(), true, valid))]
    align_err = (aligned[0] - aligned[1]).abs().max().item()
    if not align_err <= METRIC_RTOL * true.abs().max().item():
        fail('train_families', f'{label}: rigid_align on the GPU differs from the CPU by '
                               f'{align_err:.3g} mm')
    return {k: v.item() for k, v in got.items()}, max(rel.values()), align_err, syncs


def train_families_phase(root: Path, dev, frames, boxes, box_valid, source_package: Path) -> dict:
    """The [train_families] phase: each of FAMILY_TRAIN_MODES trained at
    EffNetV2-S@256 as the [train] phase trains plain Metrabs (bf16 compute, f32
    master weights, TrainConfig defaults, 32 + 32 synthetic examples, one
    batch repeated), its step held in float32 against the CPU, packaged with
    the bone lengths of its 3D batches, scored on that batch and served.
    Returns the K1 and K2 launches of each path."""
    from metrabs_tpu_torch.apps.train import warm_start_backbone
    from metrabs_tpu_torch.config import AugConfig, ModelConfig, TrainConfig
    from metrabs_tpu_torch.io.checkpoints import load_model_msgpack
    from metrabs_tpu_torch.io.packaging import load_pose_estimator, save_pose_estimator_package
    from metrabs_tpu_torch.io.weights import (flax_variables_from_state_dict,
                                              torch_state_dict_from_flax)
    from metrabs_tpu_torch.pipeline.plausibility import BoneLengthStats
    from metrabs_tpu_torch.pipeline.skeletons import H36M_17
    from metrabs_tpu_torch.train.loop import load_affine_weights

    name = 'train_families'
    cfg = ModelConfig(**manifest_for('bfloat16')['model_config'])
    work = root / 'runs' / 'chip_smoke_train_families'
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    gen = torch.Generator().manual_seed(SEED + 7)
    # The autoencoder, affine (each point's weights sum to 1), through its npz.
    w1 = torch.rand((17, FAMILY_N_LATENTS), generator=gen)
    w2 = torch.rand((FAMILY_N_LATENTS, 17), generator=gen)
    np.savez(work / 'affine.npz', w1=(w1 / w1.sum(0)).numpy(), w2=(w2 / w2.sum(0)).numpy())
    affine = load_affine_weights(str(work / 'affine.npz'))
    bones = [tuple(e) for e in H36M_17.edges]
    lengths = (torch.rand(len(bones), generator=gen) * 300 + 150).tolist()
    chunks = math.ceil(int(box_valid.sum()) / (INTERNAL_BATCH // NUM_AUG))
    launches = {'train_families': (0, 0), 'serve_trained_families': (0, 0)}
    table = []
    try:
        for label, model_kwargs, tcfg_fields in FAMILY_TRAIN_MODES:
            tcfg = TrainConfig(**tcfg_fields)
            kwargs = dict(model_kwargs)
            model_class = kwargs.get('model_class', 'metrabs')
            if kwargs.get('latent_mode'):
                kwargs['n_latents'] = FAMILY_N_LATENTS
            if model_class == 'model25d':
                kwargs.update(bones=bones, bone_lengths_ideal=lengths)
            ae = affine if kwargs.get('latent_mode') or tcfg.regularize_to_manifold else None
            variables = mint_crop_variables(cfg, gen, **kwargs)
            if kwargs.get('latent_mode'):
                variables['constants'] = dict(affine)
            torch.cuda.reset_peak_memory_stats()
            state, step = make_trainer(cfg, tcfg, variables, dev, model_kwargs=kwargs,
                                       affine_weights=ae)
            notes = []
            if tcfg.regularize_to_manifold:
                warm_start_backbone(state, str(source_package), cfg, apply_head_surgery=True)
                source = torch_state_dict_from_flax(load_model_msgpack(
                    str(source_package / 'crop_model.msgpack'))['variables'])
                own = state.model.state_dict()
                backbone = [k for k in source if k.startswith('backbone.')]
                head = [k for k in source if k.startswith('heatmap_heads.')]
                unequal = [k for k in backbone + head if not torch.equal(own[k].cpu(), source[k])]
                ema_reset = all(torch.equal(state.ema_params[k], p)
                                for k, p in state.model.named_parameters())
                if unequal or not backbone or not head or not ema_reset:
                    fail(name, f'warm start: {len(unequal)} of {len(backbone)} backbone and '
                               f'{len(head)} head tensors differ from the source (e.g. '
                               f'{unequal[:3]}); EMA reset {ema_reset}')
                notes.append(f'warm-started from the [train] package: {len(backbone)} backbone '
                             f'tensors and the head\'s last {cfg.n_joints} slots equal to the '
                             f'source bit for bit, EMA reset')
                variables = flax_variables_from_state_dict(state.model.state_dict())
            bone_stats = BoneLengthStats(H36M_17.edges)
            run = train_steps(state, step, tcfg, dev, name, FAMILY_TRAIN_WARMUP,
                              FAMILY_TRAIN_STEPS, fall_window=3, bone_stats=bone_stats,
                              first_example=FAMILY_FIRST_EXAMPLE)
            phase(name, f'{label}: ' + run['summary'])
            if tcfg.predict_all_and_latents:
                state.step = tcfg.teacher_start_step + 1
                l = {k: v.item() for k, v in step(state, *run['batch'],
                                                  generator=torch.Generator(device=dev)).items()}
                teacher = l['loss_3dbatch'] - (
                    l['loss_allhead_vs_gt'] + l['loss_latentheadreconstruction_vs_gt']
                    + tcfg.allhead_aegt_loss_factor * l['loss_allhead_ae_vs_gt']
                    + tcfg.loss_manif_factor * l['loss_allhead_vs_reconstr'])
                want = tcfg.teacher_loss_factor * l['loss_latenthead_vs_latents_from_allhead']
                if not (want > 0 and math.isfinite(l['loss'])
                        and abs(teacher - want) <= 1e-3 * want):
                    fail(name, f'{label}: the teacher term is not live past teacher_start_step: '
                               f'{teacher} vs {want}')
                notes.append(f'one step at step {tcfg.teacher_start_step + 1}: teacher term '
                             f'{teacher:.5f} (loss_latenthead_vs_latents_from_allhead '
                             f'{want:.5f}), loss {l["loss"]:.4f}')
            worst = train_parity(cfg, tcfg, variables, dev, name, kwargs, ae)
            notes.append('float32 step, GPU (TF32 off) vs CPU: '
                         + ', '.join(f'{k} {v:.3g}' for k, v in worst.items()))
            package = work / label
            save_pose_estimator_package(
                str(package), cfg=cfg, aug_cfg=AugConfig(), joint_info=H36M_17,
                crop_model_variables=flax_variables_from_state_dict(state.ema_state_dict()),
                bone_mean_lengths=bone_stats.mean_lengths(), model_class=model_class,
                latent_mode=kwargs.get('latent_mode', ''), n_latents=kwargs.get('n_latents', 0),
                bones_25d=kwargs.get('bones'), bone_lengths_ideal=kwargs.get('bone_lengths_ideal'))
            del state, step
            torch.cuda.empty_cache()
            metrics, rel, align_err, syncs = score_trained(package, run['batch'][0], dev, label)
            means = bone_stats.mean_lengths()
            notes.append(f'packaged with {len(means)} bone means from {bone_stats.n_samples}+ '
                         f'samples each ({means.min():.1f}-{means.max():.1f} mm); scored on its '
                         f'training batch, GPU vs CPU metrics within {rel:.3g} relative, '
                         f'rigid_align within {align_err:.3g} mm, {len(syncs)} host syncs in the '
                         f'GPU metrics call ({", ".join(syncs)}): '
                         + ', '.join(f'{k} {v:.4g}' for k, v in metrics.items()))
            if model_class == 'metro':
                try:
                    load_pose_estimator(str(package), device=dev)
                    fail(name, 'load_pose_estimator accepted a trained Metro package')
                except ValueError as e:
                    notes.append(f'load_pose_estimator refused it ("{str(e).split(" (")[0]}")')
            else:
                k1 = serve_folded(package, dev, frames, boxes, box_valid, name)[1]
                launches['serve_trained_families'] = (
                    launches['serve_trained_families'][0] + k1, 0)
                notes.append(f'served folded bf16: K1 {k1} ({chunks} chunks), K2 0, poses finite')
            if label == FAMILY_FUSED_SERVE:
                k1, k2, err_v, n_blocks = serve_fused(package, dev, frames, boxes, box_valid,
                                                      name)[1:]
                launches['serve_trained_family_fused'] = (k1, k2)
                notes.append(f'served unfolded with fuse_mbconv on: K1 {k1}, K2 {k2}, K2 v vs '
                             f'plain {err_v:.3g} over {n_blocks} blocks')
            phase(name, f'{label}: ' + '; '.join(notes))
            table.append(f'{label} {run["step_s"] * 1e3:.1f} ms/step, '
                         f'{(tcfg.batch_size + tcfg.batch_size_2d) / run["step_s"]:.1f} images/s, '
                         f'busy {100 * run["busy_share"]:.1f}%, peak {run["peak_gb"]:.2f} GiB')
    finally:
        shutil.rmtree(work, ignore_errors=True)
    phase(name, 'summary: ' + '; '.join(table))
    return launches


# The [train_app] phase: `apps.train.main` on a dataset minted under runs/.
TRAIN_APP_DIR = 'runs/chip_smoke_train_app'
TRAIN_APP_EXAMPLES = (64, 64, 32)  # 3D, 2D and held-out 3D examples
TRAIN_APP_FRAMES = 16  # distinct 1000x1000 PNG frames the examples are cut from
TRAIN_APP_FRAME_SIDE = 1000  # Human3.6M's frames are 1000x1000 (1002 rows for some cameras)
TRAIN_APP_STEPS, TRAIN_APP_RESUMED_STEPS = 24, 28
TRAIN_APP_PERIODS = dict(log=4, checkpoint=8, validate=12)
TRAIN_APP_LOADER_BATCHES = 3  # batches of 32 per stream in the loader-alone measurement


def mint_train_app_dataset(work: Path) -> dict:
    """Example pickles of the port's own classes over PNG frames written by
    the port's PNG writer (smooth random content, 1000x1000): 64
    `Example3D` (cameras of Human3.6M's intrinsics, every other one with its
    lens distortion, every other one with a foreground mask, so that the
    background augmentation runs), 64 `Example2D` (every fourth without a
    camera) and 32 held-out `Example3D`; people of 17 joints 3-6 m from
    the camera, their boxes from the projected joints. Returns the paths."""
    import pickle

    from metrabs_tpu_torch.data import cvfree
    from metrabs_tpu_torch.data.camera import Camera
    from metrabs_tpu_torch.data.loading import Example2D, Example3D

    rng = np.random.default_rng(SEED + 11)
    side = TRAIN_APP_FRAME_SIDE
    frame_paths = []
    (work / 'frames').mkdir(parents=True)
    for i in range(TRAIN_APP_FRAMES):
        coarse = rng.integers(0, 256, (12, 12, 3), dtype=np.uint8)
        frame = cvfree.resize(coarse, (side, side), cvfree.INTER_LINEAR)
        frame = np.clip(frame + rng.integers(-6, 7, frame.shape), 0, 255).astype(np.uint8)
        frame_paths.append(str(work / 'frames' / f'{i}.png'))
        cvfree.write_png(frame_paths[-1], frame)
    # A camera looking along the world's +y axis, z up, tilted down a little.
    tilt = np.deg2rad(10)
    rot = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32) @ np.array(
        [[1, 0, 0], [0, np.cos(tilt), -np.sin(tilt)], [0, np.sin(tilt), np.cos(tilt)]],
        np.float32)
    intrinsics = np.array([[1145.0, 0, 512.5], [0, 1143.8, 515.5], [0, 0, 1]], np.float32)
    distortion = np.array([-0.207, 0.248, -0.0009, -0.0014, -0.0031], np.float32)

    def camera(i):
        return Camera(optical_center=np.array([0, -4500, 1600], np.float32),
                      rot_world_to_cam=rot, intrinsic_matrix=intrinsics,
                      distortion_coeffs=distortion if i % 2 else None, world_up=(0, 0, 1))

    def person(i, cam):
        root = np.array([rng.uniform(-600, 600), rng.uniform(-400, 400),
                         rng.uniform(3000, 6000)], np.float32)
        in_cam = (root + rng.normal(0, 250, (17, 3))).astype(np.float32)
        world = cam.camera_to_world(in_cam).astype(np.float32)
        image_points = cam.world_to_image(world)
        (x0, y0), (x1, y1) = image_points.min(0) - 40, image_points.max(0) + 40
        return world, image_points, np.array([x0, y0, x1 - x0, y1 - y0], np.float32)

    def example3d(i):
        cam = camera(i)
        world, _, box = person(i, cam)
        mask = None
        if i % 4 < 2:
            mask = np.zeros((side, side), bool)
            x, y, w, h = np.clip(np.round(box), 0, side).astype(int)
            mask[y:y + h, x + w // 4:x + 3 * w // 4] = True
        return Example3D(image_path=frame_paths[i % TRAIN_APP_FRAMES], camera=cam, bbox=box,
                         world_coords=world, mask=mask)

    def example2d(i):
        cam = camera(i)
        _, image_points, box = person(i, cam)
        return Example2D(image_path=frame_paths[i % TRAIN_APP_FRAMES], bbox=box,
                         coords=image_points[:14].astype(np.float32),
                         camera=cam if i % 4 else None)

    n3, n2, n_val = TRAIN_APP_EXAMPLES
    paths = {}
    for name, examples in (('ds3d', [example3d(i) for i in range(n3)]),
                           ('ds2d', [example2d(i) for i in range(n2)]),
                           ('val', [example3d(n3 + i) for i in range(n_val)])):
        paths[name] = str(work / f'{name}.pkl')
        with open(paths[name], 'wb') as f:
            pickle.dump(examples, f)
    return paths


def loader_examples_per_s(paths: dict, workers: int) -> dict:
    """Examples per second of `ParallelBatchLoader` alone (the app's load
    functions, EffNetV2-S@256's config, every augmentation, `workers`
    threads), for the 3D and the 2D stream: TRAIN_APP_LOADER_BATCHES batches
    of 32 after one."""
    import itertools

    from metrabs_tpu_torch.config import ModelConfig
    from metrabs_tpu_torch.data.loading import (LoadConfig, load_and_transform2d,
                                                load_and_transform3d, load_examples)
    from metrabs_tpu_torch.data.pipeline import ParallelBatchLoader
    from metrabs_tpu_torch.pipeline.skeletons import H36M_17, LSP_14

    cfg = ModelConfig(proc_side=PROC_SIDE)
    out = {}
    for name, load, joints in (('3d', load_and_transform3d, H36M_17),
                               ('2d', load_and_transform2d, LSP_14)):
        examples = load_examples(paths[f'ds{name}'])
        loader = ParallelBatchLoader(lambda ex, r: load(ex, joints, True, r, cfg, LoadConfig()),
                                     itertools.cycle(examples), 32, n_workers=workers, seed=SEED)
        try:
            next(loader)
            start = time.perf_counter()
            for _ in range(TRAIN_APP_LOADER_BATCHES):
                batch = next(loader)
            out[name] = 32 * TRAIN_APP_LOADER_BATCHES / (time.perf_counter() - start)
        finally:
            loader.close()
        if batch['image'].shape != (32, PROC_SIDE, PROC_SIDE, 3) or not np.isfinite(
                batch['image']).all():
            fail('train_app', f'the {name} loader gave {batch["image"].shape} images')
    return out


def train_app_phase(root: Path, dev, frames, boxes, box_valid, repeated_step_s: float) -> dict:
    """The [train_app] phase (module docstring). Returns the K1 and K2
    launches of the app's run and of serving its package."""
    import contextlib
    import io

    from metrabs_tpu_torch.apps import train as train_app
    from metrabs_tpu_torch.ops import mbconv_cuda, warp_cuda

    name = 'train_app'
    work = root / TRAIN_APP_DIR
    shutil.rmtree(work, ignore_errors=True)
    try:
        start = time.perf_counter()
        paths = mint_train_app_dataset(work)
        mint_s = time.perf_counter() - start
        workers = train_app.parse_args(['--ds3d', '', '--ds2d', '', '--checkpoint-dir', '']).workers
        loader_rate = loader_examples_per_s(paths, workers)
        ckpt, package = work / 'checkpoints', work / 'package'
        argv = ['--ds3d', paths['ds3d'], '--ds2d', paths['ds2d'], '--ds3d-val', paths['val'],
                '--checkpoint-dir', str(ckpt), '--export-dir', str(package),
                '--backbone', 'efficientnetv2-s', '--proc-side', str(PROC_SIDE),
                '--dtype', 'bfloat16', '--batch-size', '32', '--batch-size-2d', '32',
                '--log-period', str(TRAIN_APP_PERIODS['log']),
                '--checkpoint-period', str(TRAIN_APP_PERIODS['checkpoint']),
                '--validate-period', str(TRAIN_APP_PERIODS['validate']),
                '--absloss-start-step', str(TRAIN_APP_PERIODS['validate'])]
        runs = []
        torch.cuda.reset_peak_memory_stats()
        for steps in (TRAIN_APP_STEPS, TRAIN_APP_RESUMED_STEPS):
            out = io.StringIO()
            warp_cuda.warp_pyramid.launches = mbconv_cuda.fused_mbconv_inner.launches = 0
            start = time.perf_counter()
            with contextlib.redirect_stdout(out):
                train_app.main(argv + ['--training-steps', str(steps)])
            torch.cuda.synchronize()
            runs.append(dict(seconds=time.perf_counter() - start, stdout=out.getvalue(),
                             checkpoints=sorted(int(p.stem) for p in ckpt.glob('*.pt')),
                             launches=(warp_cuda.warp_pyramid.launches,
                                       mbconv_cuda.fused_mbconv_inner.launches)))
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        log = [json.loads(line) for line in (ckpt / 'train_log.jsonl').read_text().splitlines()]
        losses = [r for r in log if 'loss' in r]
        vals = [r for r in log if 'val_mean_error' in r]
        period = TRAIN_APP_PERIODS['log']
        want_steps = list(range(period, TRAIN_APP_RESUMED_STEPS + 1, period))
        if [r['step'] for r in losses] != want_steps or not all(
                math.isfinite(r['loss']) for r in losses):
            fail(name, f'loss records {losses}, expected finite ones at steps {want_steps}')
        if [r['step'] for r in vals] != [12, 24] or not all(
                math.isfinite(v) for r in vals for k, v in r.items() if k.startswith('val_')):
            fail(name, f'validation records {vals}, expected finite ones at steps 12 and 24')
        if runs[0]['checkpoints'] != [16, 24] or runs[1]['checkpoints'] != [24, 28]:
            fail(name, f'checkpoints {runs[0]["checkpoints"]} after the first run and '
                       f'{runs[1]["checkpoints"]} after the second, expected [16, 24], [24, 28]')
        resumed = torch.load(ckpt / '28.pt', map_location='cpu', weights_only=True)['step']
        if (f'restored checkpoint at step {TRAIN_APP_STEPS}' not in runs[1]['stdout']
                or resumed != TRAIN_APP_RESUMED_STEPS
                or [r['step'] for r in losses if r['step'] > TRAIN_APP_STEPS] != [28]):
            fail(name, f'the second run did not restore step {TRAIN_APP_STEPS} and take '
                       f'{TRAIN_APP_RESUMED_STEPS - TRAIN_APP_STEPS} steps (checkpoint step '
                       f'{resumed})')
        if any(r['launches'] != (0, 0) for r in runs):
            fail(name, f'the app launched K1 and K2 {[r["launches"] for r in runs]} times')
        manifest = json.loads((package / 'manifest.json').read_text())
        means = np.asarray(manifest.get('bone_mean_lengths') or [np.nan], np.float64)
        if means.shape != (16,) or not (np.isfinite(means).all() and (means > 0).all()):
            fail(name, f'bone means {means} in the exported manifest')
        # Windows of log_period steps after the first (which holds the
        # warm-up), the feed included, validation and checkpoints not.
        window_s = [period / r['steps_per_sec'] for r in losses[1:]
                    if r['step'] <= TRAIN_APP_STEPS]
        step_s = statistics.median(window_s) / period
        k1_folded = serve_folded(package, dev, frames, boxes, box_valid, name)[1]
        k1_fused, k2, err_v, n_blocks = serve_fused(package, dev, frames, boxes, box_valid,
                                                    name)[1:]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    n_images = 64
    phase(name, f'dataset minted in {mint_s:.1f} s: {TRAIN_APP_EXAMPLES[0]} Example3D, '
                f'{TRAIN_APP_EXAMPLES[1]} Example2D, {TRAIN_APP_EXAMPLES[2]} held out, over '
                f'{TRAIN_APP_FRAMES} {TRAIN_APP_FRAME_SIDE}x{TRAIN_APP_FRAME_SIDE} PNG frames')
    phase(name, f'loader alone ({workers} threads, every augmentation, {PROC_SIDE} px): '
                f'3D {loader_rate["3d"]:.1f} examples/s, 2D {loader_rate["2d"]:.1f} examples/s')
    phase(name, f'apps.train.main EffNetV2-S@{PROC_SIDE} bf16 32+32 through the real loader: '
                f'{TRAIN_APP_STEPS} steps in {runs[0]["seconds"]:.1f} s, then resumed at step '
                f'{TRAIN_APP_STEPS} to {TRAIN_APP_RESUMED_STEPS} in {runs[1]["seconds"]:.1f} s; '
                f'median step {step_s * 1e3:.1f} ms ({n_images / step_s:.1f} images/s) over '
                f'{len(window_s)} windows of {period} steps (all: '
                + ', '.join(f'{1e3 * w / period:.1f}' for w in window_s)
                + f'); [train] repeated batch in this run {repeated_step_s * 1e3:.1f} ms '
                  f'({n_images / repeated_step_s:.1f} images/s); peak {peak_gb:.2f} GiB; losses '
                + ', '.join(f'{r["step"]}: {r["loss"]:.4f}' for r in losses)
                + '; validation ' + '; '.join(
                    f'step {r["step"]}: MPJPE {r["val_mean_error"]:.1f} mm, PCK '
                    f'{r["val_mean_pck"]:.3f} in {r["seconds"]:.1f} s' for r in vals))
    phase(name, f'checkpoints {runs[0]["checkpoints"]} then {runs[1]["checkpoints"]}, the second '
                f'run restored step {TRAIN_APP_STEPS} and took '
                f'{TRAIN_APP_RESUMED_STEPS - TRAIN_APP_STEPS} steps; K1 and K2 launches in the '
                f'app: 0; package bone means {means.min():.1f}-{means.max():.1f} mm; served '
                f'folded K1 {k1_folded}, unfolded with fuse_mbconv on K1 {k1_fused}, K2 {k2}, '
                f'K2 v vs plain {err_v:.3g} over {n_blocks} blocks')
    return {'train_app': (0, 0), 'serve_train_app': (k1_folded + k1_fused, k2)}


IMPORT_MODEL = 'metrabs_eff2s_y4'  # EffNetV2-S@256 crop model + YOLOv4-416, both bf16
IMPORT_K = 2  # frame batches per stream call
IMPORT_PIPELINED = 3  # frame batches through detect_poses_pipelined
# Stream, pipelined and batched calls run the same kernels in the same order
# on the same inputs, so they are expected to agree exactly; the tolerance
# only admits a cuDNN algorithm that sums in another order between calls.
STREAM_TOL = dict(boxes_px=BOX_TOL_PX, poses_mm=POSE_ATOL_MM)


def zeros_template(module) -> dict:
    """The JAX-layout variable tree of `module` (built on the meta device),
    zero-filled: an importer's template that holds no value of its own."""
    from metrabs_tpu_torch.io.weights import flax_variables_from_state_dict
    return flax_variables_from_state_dict(
        {k: torch.zeros(v.shape) for k, v in module.state_dict().items()})


def trees_equal(got: dict, want: dict) -> bool:
    """Same paths, dtypes, shapes and bits."""
    from metrabs_tpu_torch.io.weights import flatten_dict
    got, want = flatten_dict(got), flatten_dict(want)
    return got.keys() == want.keys() and all(
        got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]) for k in want)


def max_diff(got: dict, want: dict, rows) -> tuple:
    """(valid masks equal, max |dbox| px, max |dpose3d| mm) on `rows`."""
    same_valid = torch.equal(torch.as_tensor(got['valid']).to(rows.device), want['valid'])
    diff = lambda k: (torch.as_tensor(got[k]).to(rows.device)[rows] - want[k][rows]).abs().max()
    return same_valid, diff('boxes').item(), diff('poses3d').item()


def import_phase(root: Path, dev, frames, boxes, box_valid) -> dict:
    """The [import] phase: the released metrabs_eff2s_y4 (EffNetV2-S@256 and
    YOLOv4-416, bf16) with weights minted from a seed, written in the
    released formats (a TF TensorBundle under the reference fork's names, a
    darknet yolov4.weights) and read back bit for bit by the port's
    importers, packaged with its detector by the port's writer, loaded
    unfolded with `fuse_mbconv='on'`, then `detect_poses_stream` (K=2),
    `detect_poses_pipelined` (3 batches) and `estimate_poses_stream` (K=2)
    against the batched calls, F3 and F2 on the card, the K1 and K2 launches
    of one profiled stream call and the stream and batched times. Returns
    the K1 and K2 launches of the counted stream call."""
    from metrabs_tpu_torch.detect.yolov4 import (build_detector_model, load_darknet_weights,
                                                 write_darknet_weights)
    from metrabs_tpu_torch.io import tf_checkpoint, weights_import
    from metrabs_tpu_torch.io.packaging import load_pose_estimator, save_pose_estimator_package
    from metrabs_tpu_torch.io.weights import flatten_dict
    from metrabs_tpu_torch.models.backbones.builder import build_backbone
    from metrabs_tpu_torch.models.metrabs import build_crop_model
    from metrabs_tpu_torch.models.registry import get_named_model
    from metrabs_tpu_torch.ops import mbconv_cuda, warp_cuda
    from metrabs_tpu_torch.pipeline.skeletons import H36M_17

    named = get_named_model(IMPORT_MODEL)
    cfg = named.model_config(dtype='bfloat16', n_joints=17, backbone_scan_blocks=False)
    gen = torch.Generator().manual_seed(SEED + 6)
    t0 = time.perf_counter()
    minted = mint_crop_variables(cfg, gen)
    minted_det = mint_detector_variables(gen, named.detector)
    work = root / 'runs' / f'chip_smoke_import_{os.getpid()}'
    try:
        # The released formats, written by the port's own code.
        prefix = str(work / 'saved_model' / 'variables' / 'variables')
        pairs = (weights_import.import_backbone_from_tf(None, minted, cfg.backbone)
                 + weights_import.import_metrabs_head_from_tf(None, minted))
        flat = {'/'.join(k): v for k, v in flatten_dict(minted).items()}
        if sorted(p for p, _, _ in pairs) != sorted(flat):
            fail('import', 'the TF mapping does not cover the crop model exactly')
        # `_dw`, the one transform, swaps two axes: it is its own inverse.
        tf_checkpoint.write_tf_checkpoint(prefix, {name: (t or np.asarray)(flat[path])
                                                   for path, name, t in pairs})
        darknet = str(work / 'yolov4.weights')
        write_darknet_weights(minted_det, darknet)
        sizes = [os.path.getsize(prefix + '.data-00000-of-00001'), os.path.getsize(darknet)]

        # Read back into zero templates of the port's modules.
        with torch.device('meta'):
            crop_module = build_crop_model(cfg)
            det_module = build_detector_model(named.detector)
        tf_vars = tf_checkpoint.load_tf_checkpoint(prefix)
        imported = weights_import.import_metrabs_head_from_tf(
            tf_vars, weights_import.import_backbone_from_tf(tf_vars, zeros_template(crop_module),
                                                            cfg.backbone))
        imported_det = load_darknet_weights(zeros_template(det_module), darknet)
        if not trees_equal(imported, minted) or not trees_equal(imported_det, minted_det):
            fail('import', 'an imported leaf differs from the minted one')
        n_leaves = (len(flatten_dict(imported)), len(flatten_dict(imported_det)))
        pkg = str(work / 'package')
        save_pose_estimator_package(
            pkg, cfg=cfg, aug_cfg=named.aug_config(), crop_model_variables=imported,
            joint_info=H36M_17, detector_variables=imported_det, detector_type=named.detector,
            detector_dtype='bfloat16', detector_input_size=DETECTOR_SIZE)
        est = load_pose_estimator(
            pkg, device=dev, cfg_overrides={'bn_fold': False},
            backbone_builder=functools.partial(build_backbone, fuse_mbconv='on'))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    io_s = time.perf_counter() - t0
    fused_blocks = sum(getattr(b, 'fusable', False) and b.fuse == 'on'
                       for b in est.crop_model.backbone.blocks)
    if est.cfg.bn_fold or est.cfg.dtype != 'bfloat16' or fused_blocks != K2_BLOCKS:
        fail('import', f'expected the unfolded bf16 model with {K2_BLOCKS} fused blocks')
    phase('import', f'{IMPORT_MODEL}: minted, written as a TF TensorBundle ({len(pairs)} '
                    f'variables, {sizes[0] / 1e6:.1f} MB) and a darknet yolov4.weights '
                    f'({sizes[1] / 1e6:.1f} MB), read back: all {n_leaves[0]} crop-model and '
                    f'{n_leaves[1]} detector leaves equal the minted ones bit for bit; packaged '
                    f'with the detector and loaded unfolded, fuse_mbconv on, in {io_s:.1f} s')

    frames_k = torch.stack([frames, torch.flip(frames, dims=[2])])
    kwargs = dict(num_aug=NUM_AUG, max_detections=MAX_DETECTIONS,
                  internal_batch_size=INTERNAL_BATCH, detector_threshold=0.0,
                  suppress_implausible_poses=True)
    est.detect_poses_batched(frames, **kwargs)  # warm-up (cuDNN algorithm selection)
    with torch.inference_mode():
        det_valid = [est.detector.detect_batched(f, threshold=0.0,
                                                 max_detections=MAX_DETECTIONS)[1]
                     for f in frames_k]
    if not all(bool(v.all()) for v in det_valid):
        fail('import', f'threshold 0 left detection slots empty: '
                       f'{[int(v.sum()) for v in det_valid]} of {N_FRAMES * MAX_DETECTIONS}')
    chunks = sum(math.ceil(int(v.sum()) / (INTERNAL_BATCH // NUM_AUG)) for v in det_valid)
    stream = lambda: est.detect_poses_stream(frames_k, **kwargs)
    torch.cuda.synchronize()
    warp_cuda.warp_pyramid.launches = mbconv_cuda.fused_mbconv_inner.launches = 0
    out = stream()
    torch.cuda.synchronize()
    k1, k2 = warp_cuda.warp_pyramid.launches, mbconv_cuda.fused_mbconv_inner.launches
    want_shapes = dict(boxes=(IMPORT_K, N_FRAMES, MAX_DETECTIONS, 5),
                       poses3d=(IMPORT_K, N_FRAMES, MAX_DETECTIONS, 17, 3),
                       poses2d=(IMPORT_K, N_FRAMES, MAX_DETECTIONS, 17, 2),
                       valid=(IMPORT_K, N_FRAMES, MAX_DETECTIONS))
    if {k: tuple(v.shape) for k, v in out.items()} != want_shapes:
        fail('import', f'stream output shapes {[tuple(v.shape) for v in out.values()]}')
    if k1 != chunks or k2 != K2_BLOCKS * chunks:
        fail('import', f'detect_poses_stream launched K1 {k1} and K2 {k2} times, expected '
                       f'{chunks} and {K2_BLOCKS * chunks} ({chunks} non-empty chunks)')

    # Stream and pipelined against batched calls, on the detector's rows.
    batches = [frames_k[0], frames_k[1], torch.flip(frames, dims=[1])]
    batched = [est.detect_poses_batched(b, **kwargs) for b in batches]
    with torch.inference_mode():
        det_valid.append(est.detector.detect_batched(batches[2], threshold=0.0,
                                                     max_detections=MAX_DETECTIONS)[1])
    checks = [('stream', k, {key: v[k] for key, v in out.items()}) for k in range(IMPORT_K)]
    pipelined = list(est.detect_poses_pipelined(iter(batches), in_flight=2, **kwargs))
    if len(pipelined) != IMPORT_PIPELINED:
        fail('import', f'detect_poses_pipelined gave {len(pipelined)} results')
    checks += [('pipelined', k, r) for k, r in enumerate(pipelined)]
    worst = {}
    for name, k, got in checks:
        same_valid, box_err, pose_err = max_diff(got, batched[k], det_valid[k])
        if not (torch.isfinite(batched[k]['poses3d'][det_valid[k]]).all() and same_valid
                and box_err <= STREAM_TOL['boxes_px'] and pose_err <= STREAM_TOL['poses_mm']):
            fail('import', f'{name} batch {k} differs from detect_poses_batched: masks equal '
                           f'{same_valid}, boxes by {box_err:.3g} px, poses by {pose_err:.3g} mm')
        prev = worst.get(name, (0.0, 0.0))
        worst[name] = (max(prev[0], box_err), max(prev[1], pose_err))

    # estimate_poses_stream with the main phase's boxes.
    est_kwargs = dict(num_aug=NUM_AUG, internal_batch_size=INTERNAL_BATCH)
    est_stream = est.estimate_poses_stream(frames_k, np.stack([boxes] * IMPORT_K),
                                           np.stack([box_valid] * IMPORT_K), **est_kwargs)
    valid_t = torch.as_tensor(box_valid, device=dev)
    est_err = 0.0
    for k in range(IMPORT_K):
        want = est.estimate_poses_batched(frames_k[k], boxes, box_valid, **est_kwargs)
        same_valid, _, err = max_diff({key: v[k] for key, v in est_stream.items()}, want, valid_t)
        if not same_valid or not err <= STREAM_TOL['poses_mm']:
            fail('import', f'estimate_poses_stream batch {k} differs by {err:.3g} mm')
        est_err = max(est_err, err)

    # F3: the detect output's CUDA boxes go back in; F2: zero boxes.
    f3 = est.estimate_poses_batched(frames, batched[0]['boxes'][..., :4], det_valid[0],
                                    **est_kwargs)
    f3_err = (f3['poses3d'] - batched[0]['poses3d'])[det_valid[0]].abs().max().item()
    if not torch.equal(f3['valid'], det_valid[0]) or not f3_err <= STREAM_TOL['poses_mm']:
        fail('import', f'F3: poses from the CUDA boxes differ by {f3_err:.3g} mm')
    for average_aug, aug in ((True, ()), (False, (NUM_AUG,))):
        f2 = est.estimate_poses_batched(frames, np.zeros((N_FRAMES, 0, 4)), num_aug=NUM_AUG,
                                        average_aug=average_aug)
        if {k: tuple(v.shape) for k, v in f2.items()} != dict(
                boxes=(N_FRAMES, 0, 5), poses3d=(N_FRAMES, 0, *aug, 17, 3),
                poses2d=(N_FRAMES, 0, *aug, 17, 2), valid=(N_FRAMES, 0)):
            fail('import', f'F2: zero boxes gave {[tuple(v.shape) for v in f2.values()]}')
    phase('import', f'detect_poses_stream K={IMPORT_K} x {N_FRAMES}x{FRAME_H}p: K1 {k1}, K2 '
                    f'{k2} ({chunks} chunks); stream vs batched: masks equal, max |dbox| '
                    f'{worst["stream"][0]:.3g} px, max |dpose| {worst["stream"][1]:.3g} mm; '
                    f'pipelined (in_flight 2, {IMPORT_PIPELINED} batches) vs batched: max |dbox| '
                    f'{worst["pipelined"][0]:.3g} px, max |dpose| {worst["pipelined"][1]:.3g} '
                    f'mm; estimate_poses_stream vs batched: max |dpose| {est_err:.3g} mm '
                    f'(tolerances {STREAM_TOL}); F3: CUDA boxes back in, max |dpose| '
                    f'{f3_err:.3g} mm; F2: zero boxes give empty shapes')

    # K1 and K2 under the profiler (again where it lost records), then times
    # per frame batch.
    for _ in range(TIMING_TRIES):
        wall_ms, device_ms, _, busy_ms, n_kernels, counts = profile_detect(est, stream)
        seen = (counts['K1 (warp kernel)'], counts['K2 (mbconv kernel)'])
        if seen == (k1, k2):
            break
        phase('import', f'the profiler saw K1 and K2 {seen} times in one stream call, the '
                        f'wrappers counted {(k1, k2)}: profiling again')
    else:
        fail('import', f'the profiler never saw the {k1} K1 and {k2} K2 launches the wrappers '
                       f'counted in one stream call')
    b_wall_ms, _, _, b_busy_ms, b_kernels, _ = profile_detect(
        est, lambda: est.detect_poses_batched(frames, **kwargs))
    stream_times = [t / IMPORT_K for t in timed_calls(stream)]
    batched_times = timed_calls(lambda: est.detect_poses_batched(frames, **kwargs))
    fmt = lambda ts: ', '.join(f'{t * 1e3:.1f}' for t in ts)
    phase('import', f'per frame batch: stream {statistics.median(stream_times) * 1e3:.1f} ms, '
                    f'batched {statistics.median(batched_times) * 1e3:.1f} ms (medians of 5; '
                    f'all: stream {fmt(stream_times)}; batched {fmt(batched_times)})')
    phase('import', f'one stream call under torch.profiler: wall {wall_ms:.1f} ms, device busy '
                    f'{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%), {n_kernels} kernels, K1 '
                    f'{counts["K1 (warp kernel)"]} ({device_ms["K1 (warp kernel)"]:.3f} ms), K2 '
                    f'{counts["K2 (mbconv kernel)"]} ({device_ms["K2 (mbconv kernel)"]:.3f} ms); '
                    f'one batched call: wall {b_wall_ms:.1f} ms, busy {b_busy_ms:.2f} ms '
                    f'({100 * b_busy_ms / b_wall_ms:.1f}%), {b_kernels} kernels')
    return {'import_stream': (k1, k2)}


# The [bench_apps] phase: the benchmark drivers on JPEG layouts minted under
# runs/ from the committed fixtures (the card's machine has no JPEG encoder).
BENCH_DIR = 'runs/chip_smoke_bench_apps'
JPEG_FIXTURES = 'tests/torch_fixtures/jpeg'
FRAME_3DPW, FRAME_H36M = 'frame_3dpw_1080x1920.jpg', 'frame_h36m_1000x1002.jpg'
DECODE_REPEATS = 20  # single-thread decodes of the 1080x1920 frame, median taken
DECODE_THREADS = 8  # predict_*'s default --io-threads
BENCH_3DPW = dict(sequences=2, frames=24, tracks=2)
BENCH_H36M = dict(frames=64, frame_step=8)  # S9, one activity, 4 cameras: 32 examples
# 3DPW's published intrinsics (portrait 1080x1920) and Human3.6M's (camera 54138969).
K_3DPW = np.array([[1961.9, 0, 540.0], [0, 1969.2, 960.0], [0, 0, 1]])
K_H36M = np.array([[1145.05, 0, 512.54], [0, 1143.78, 515.45], [0, 0, 1]])


def union_seconds(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def check_decoder(root: Path) -> dict:
    """Every fixture decoded and held to its manifest hash (cv2's decode on
    the machine that wrote them); the 1080x1920 frame's decode time on one
    thread and frames/s on DECODE_THREADS."""
    import hashlib

    from metrabs_tpu_torch.data import improc, jpeg

    manifest = json.loads((root / JPEG_FIXTURES / 'manifest.json').read_text())
    wrong = [name for name, entry in sorted(manifest.items())
             if hashlib.sha256(improc.imread(str(root / JPEG_FIXTURES / name)).tobytes())
             .hexdigest() != entry['sha256_rgb']]
    if wrong:
        fail('bench_apps', f'{len(wrong)} of {len(manifest)} fixtures decode differently from '
                           f'cv2: {wrong}')
    data = (root / JPEG_FIXTURES / FRAME_3DPW).read_bytes()
    times = []
    for _ in range(DECODE_REPEATS):
        t0 = time.perf_counter()
        jpeg.decode(data)
        times.append(time.perf_counter() - t0)
    n = 8 * DECODE_THREADS
    with concurrent.futures.ThreadPoolExecutor(DECODE_THREADS) as pool:
        list(pool.map(jpeg.decode, [data] * DECODE_THREADS))
        t0 = time.perf_counter()
        list(pool.map(jpeg.decode, [data] * n))
        fps = n / (time.perf_counter() - t0)
    return dict(n=len(manifest), ms=statistics.median(times) * 1e3,
                all_ms=[t * 1e3 for t in times], fps=fps, kib=len(data) / 1024)


def mint_3dpw_layout(root: Path, rng, frame: Path, dims: dict = BENCH_3DPW) -> None:
    """sequenceFiles/test/*.pkl (latin1-readable pickles: SMPL-24 world
    joints in metres, cam_poses, campose_valid, poses2d) and the frames,
    copies of the portrait fixture."""
    import pickle

    from metrabs_tpu_torch.data.camera import Camera

    n, n_tracks = dims['frames'], dims['tracks']
    cam = Camera(intrinsic_matrix=K_3DPW, world_up=(0, -1, 0))
    for i_seq in range(dims['sequences']):
        name = f'bench_{i_seq:02d}'
        joints, poses2d = [], []
        for t in range(n_tracks):
            centre = np.array([(t - 0.5) * 900, 200, 4500.0])
            world = centre + rng.normal(0, 200, (n, 24, 3)) + np.arange(n)[:, None, None] * [8, 0, 0]
            joints.append((world / 1000).reshape(n, 72))
            image = cam.world_to_image(world.reshape(-1, 3)).reshape(n, 24, 2)
            coco = np.concatenate([image[:, :18], np.full((n, 18, 1), 0.9)], -1)
            poses2d.append(np.transpose(coco, (0, 2, 1)))
        seq = dict(sequence=name, cam_intrinsics=K_3DPW, jointPositions=joints,
                   cam_poses=np.tile(np.eye(4), (n, 1, 1)),
                   campose_valid=np.ones((n_tracks, n), bool), poses2d=poses2d)
        (root / 'sequenceFiles' / 'test').mkdir(parents=True, exist_ok=True)
        (root / 'sequenceFiles' / 'test' / f'{name}.pkl').write_bytes(pickle.dumps(seq, 2))
        (root / 'imageFiles' / name).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            shutil.copyfile(frame, root / 'imageFiles' / name / f'image_{i:05d}.jpg')


def mint_h36m_layout(root: Path, rng, frame: Path) -> str:
    """S9 with one activity: D3_Positions/Walking.cdf (the port's CDF writer),
    BBoxes/Walking.<camera>.npy and every frame_step-th frame per camera (copies
    of the 1000x1002 fixture), cameras.json around a person at the origin.
    Returns the cameras JSON's path."""
    from metrabs_tpu_torch.data import datasets
    from metrabs_tpu_torch.data.camera import Camera
    from metrabs_tpu_torch.utils.cdf import write_cdf

    n, step = BENCH_H36M['frames'], BENCH_H36M['frame_step']
    base = root / 'S9'
    (base / 'MyPoseFeatures' / 'D3_Positions').mkdir(parents=True)
    (base / 'BBoxes').mkdir()
    world = rng.normal(0, 200, (n, 32, 3)) + [0, 0, 1000.0]
    write_cdf(str(base / 'MyPoseFeatures' / 'D3_Positions' / 'Walking.cdf'),
              {'Pose': world.reshape(1, n, 96)})
    cameras = dict(intrinsics={}, extrinsics={'S9': {}})
    for i_cam, cam_id in enumerate(datasets.H36M_CAMERA_IDS):
        yaw = np.pi / 4 + i_cam * np.pi / 2
        forward = -np.array([np.cos(yaw), np.sin(yaw), 0.0])
        right = np.cross(forward, [0, 0, 1.0])
        rot = np.stack([right, [0, 0, -1.0], forward])
        centre = -4500 * forward + [0, 0, 1000.0]
        cameras['intrinsics'][cam_id] = dict(calibration_matrix=K_H36M.tolist(),
                                             distortion=[-0.207, 0.248, -0.0009, -0.0014, -0.0031])
        cameras['extrinsics']['S9'][cam_id] = dict(R=rot.tolist(), t=(-rot @ centre).tolist())
        cam = Camera(optical_center=centre, rot_world_to_cam=rot, intrinsic_matrix=K_H36M)
        joints = world[:, list(datasets.H36M_RELEVANT_JOINTS)]
        boxes = np.stack([datasets.boxes_from_joints(cam.world_to_image(j)) for j in joints])
        np.save(base / 'BBoxes' / f'Walking.{cam_id}.npy', boxes)
        (base / 'Images' / f'Walking.{cam_id}').mkdir(parents=True)
        for k in range(0, n, step):
            shutil.copyfile(frame, base / 'Images' / f'Walking.{cam_id}' / f'frame_{k:06d}.jpg')
    (root / 'cameras.json').write_text(json.dumps(cameras))
    return str(root / 'cameras.json')


def bench_package(path: Path, gen, joint_info, with_detector: bool) -> None:
    """metrabs_eff2s_y4 (EffNetV2-S@256, bf16) minted as [import] mints it,
    on `joint_info`'s joints, with a YOLOv4-416 whose heads fire."""
    from metrabs_tpu_torch.io.packaging import save_pose_estimator_package
    from metrabs_tpu_torch.models.registry import get_named_model

    named = get_named_model(IMPORT_MODEL)
    cfg = named.model_config(dtype='bfloat16', n_joints=joint_info.n_joints,
                             backbone_scan_blocks=False)
    det = {}
    if with_detector:
        det = dict(detector_variables=firing_detector_variables(gen, named.detector),
                   detector_type=named.detector, detector_dtype='bfloat16',
                   detector_input_size=DETECTOR_SIZE)
    save_pose_estimator_package(str(path), cfg=cfg, aug_cfg=named.aug_config(),
                                crop_model_variables=mint_crop_variables(cfg, gen),
                                joint_info=joint_info, **det)


def run_app(main, argv) -> tuple:
    """(seconds, the last line it printed) of a driver's `main(argv)`, its
    output kept off this script's."""
    import contextlib
    import io

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        result = main(argv)
    seconds = time.perf_counter() - t0
    lines = out.getvalue().strip().splitlines()
    return seconds, result, out.getvalue(), lines[-1] if lines else ''


class DriverRuns:
    """Runs a benchmark driver's `main` with its package loaded through
    `loader(method, **overrides)`, which keeps the estimator, times the
    loading and records the arguments of each call of `method`, and with
    `jpeg.decode`, and `mpeg4.Decoder`, `h264.Decoder` and `hevc.Decoder`
    `.decode` and `.flush` (what `improc.imread` and the
    video reader call) and `jpeg.encode` and `mpeg4.Encoder.encode` (what
    `improc.imwrite` and the video writer call) timed; K1's and K2's counts
    are set to 0 just before the driver runs and read just after, and the
    mp4v, H.264 and HEVC frames decoded in the run are counted."""

    def __init__(self):
        import metrabs_tpu_torch.io.packaging as packaging
        from metrabs_tpu_torch.data import h264, hevc, jpeg, mpeg4

        self.packaging, self.jpeg, self.mpeg4, self.h264 = packaging, jpeg, mpeg4, h264
        self.hevc = hevc
        self.original_h264 = h264.Decoder.decode, h264.Decoder.flush
        self.original_hevc = hevc.Decoder.decode, hevc.Decoder.flush
        self.original_load, self.original_decode = packaging.load_pose_estimator, jpeg.decode
        self.original_encode = jpeg.encode
        self.original_mp4v = mpeg4.Decoder.decode, mpeg4.Decoder.flush, mpeg4.Encoder.encode
        self.loaded, self.calls, self.decode_spans, self.load_s = [], [], [], []
        self.encode_spans = []
        self.call_s = []  # seconds of each recorded call, CUDA-synchronised

    def loader(self, method: str, call_kwargs=None, **overrides):
        """`call_kwargs` are set on every call of `method`."""
        def load(path, device='cuda'):
            t = time.perf_counter()
            est = self.original_load(path, device=device, **overrides)
            self.load_s.append(time.perf_counter() - t)
            call = getattr(est, method)

            def recorded(images, *args, **kwargs):
                kwargs.update(call_kwargs or {})
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = call(images, *args, **kwargs)
                self.calls.append((images, args, kwargs, int(out['valid'].sum())))
                self.call_s.append(time.perf_counter() - t)
                return out
            setattr(est, method, recorded)
            self.loaded.append(est)
            return est
        return load

    def timed_decode(self, data, *args, **kwargs):
        t = time.perf_counter()
        im = self.original_decode(data, *args, **kwargs)
        self.decode_spans.append((t, time.perf_counter()))
        return im

    def timed_encode(self, image, *args, **kwargs):
        t = time.perf_counter()
        data = self.original_encode(image, *args, **kwargs)
        self.encode_spans.append((t, time.perf_counter()))
        return data

    @staticmethod
    def timed_method(f, spans):
        def timed(*args, **kwargs):
            t = time.perf_counter()
            try:
                return f(*args, **kwargs)
            finally:
                spans.append((t, time.perf_counter()))
        return timed

    def restore(self) -> None:
        self.packaging.load_pose_estimator = self.original_load
        self.jpeg.decode, self.jpeg.encode = self.original_decode, self.original_encode
        (self.mpeg4.Decoder.decode, self.mpeg4.Decoder.flush,
         self.mpeg4.Encoder.encode) = self.original_mp4v
        self.h264.Decoder.decode, self.h264.Decoder.flush = self.original_h264
        self.hevc.Decoder.decode, self.hevc.Decoder.flush = self.original_hevc

    def run(self, load, main, argv) -> dict:
        from metrabs_tpu_torch.ops import mbconv_cuda, warp_cuda

        for kept in (self.loaded, self.calls, self.decode_spans, self.load_s, self.call_s,
                     self.encode_spans):
            kept.clear()
        self.packaging.load_pose_estimator, self.jpeg.decode = load, self.timed_decode
        self.jpeg.encode = self.timed_encode
        self.mpeg4.Decoder.decode = self.timed_method(self.original_mp4v[0], self.decode_spans)
        self.mpeg4.Decoder.flush = self.timed_method(self.original_mp4v[1], self.decode_spans)
        self.mpeg4.Encoder.encode = self.timed_method(self.original_mp4v[2], self.encode_spans)
        self.h264.Decoder.decode = self.timed_method(self.original_h264[0], self.decode_spans)
        self.h264.Decoder.flush = self.timed_method(self.original_h264[1], self.decode_spans)
        self.hevc.Decoder.decode = self.timed_method(self.original_hevc[0], self.decode_spans)
        self.hevc.Decoder.flush = self.timed_method(self.original_hevc[1], self.decode_spans)
        decoded, decoded_h264 = self.mpeg4.frames_decoded(), self.h264.frames_decoded()
        decoded_hevc = self.hevc.frames_decoded()
        torch.cuda.synchronize()
        warp_cuda.warp_pyramid.launches = mbconv_cuda.fused_mbconv_inner.launches = 0
        try:
            seconds, _, printed, last = run_app(main, argv)
            torch.cuda.synchronize()
        finally:
            self.restore()
        k1, k2 = warp_cuda.warp_pyramid.launches, mbconv_cuda.fused_mbconv_inner.launches
        # Frames/s and the decoding share without the package's loading,
        # which a whole benchmark run spreads over all its frames.
        run_s = seconds - self.load_s[0]
        return dict(seconds=seconds, run_s=run_s, load_s=self.load_s[0],
                    decode_s=union_seconds(self.decode_spans),
                    encode_s=union_seconds(self.encode_spans), k1=k1, k2=k2, last=last,
                    printed=printed, mp4v_decodes=self.mpeg4.frames_decoded() - decoded,
                    h264_decodes=self.h264.frames_decoded() - decoded_h264,
                    hevc_decodes=self.hevc.frames_decoded() - decoded_hevc,
                    est=self.loaded[0], calls=list(self.calls), call_s=list(self.call_s))


def driver_timing(r: dict, n: int) -> str:
    return (f'{n} frames in {r["seconds"]:.2f} s = {n / r["seconds"]:.2f} frames/s, '
            f'{r["run_s"]:.2f} s = {n / r["run_s"]:.2f} frames/s without loading the '
            f'package ({r["load_s"]:.2f} s); decoding {r["decode_s"]:.2f} s '
            f'({100 * r["decode_s"] / r["seconds"]:.1f}% of the wall, '
            f'{100 * r["decode_s"] / r["run_s"]:.1f}% without the loading)')


def bench_apps_phase(root: Path, dev) -> dict:
    """The [bench_apps] phase (module docstring). Returns the K1 and K2
    launches of the predict_3dpw and predict_h36m runs."""
    import pickle

    from metrabs_tpu_torch.apps import (eval_3dpw, eval_benchmark, predict_3dpw,
                                        predict_h36m)
    from metrabs_tpu_torch.data.datasets import load_h36m_examples
    from metrabs_tpu_torch.models.backbones.builder import build_backbone
    from metrabs_tpu_torch.ops import warp_cuda
    from metrabs_tpu_torch.pipeline.skeletons import H36M_17, SMPL_24

    name = 'bench_apps'
    dec = check_decoder(root)
    phase(name, f'JPEG decoder (host C++): all {dec["n"]} '
                f'fixtures equal their cv2 manifest hashes; {FRAME_3DPW} ({dec["kib"]:.0f} KiB): '
                f'{dec["ms"]:.2f} ms median of {DECODE_REPEATS} on one thread (all: '
                + ', '.join(f'{t:.1f}' for t in dec['all_ms'])
                + f'), {dec["fps"]:.1f} frames/s on {DECODE_THREADS} threads')

    work = root / BENCH_DIR
    shutil.rmtree(work, ignore_errors=True)
    rng = np.random.default_rng(SEED + 13)
    gen = torch.Generator().manual_seed(SEED + 13)
    drivers = DriverRuns()
    try:
        t0 = time.perf_counter()
        mint_3dpw_layout(work / '3dpw', rng, root / JPEG_FIXTURES / FRAME_3DPW)
        cameras_json = mint_h36m_layout(work / 'h36m', rng, root / JPEG_FIXTURES / FRAME_H36M)
        bench_package(work / 'pkg_smpl', gen, SMPL_24, with_detector=True)
        bench_package(work / 'pkg_h36m', gen, H36M_17, with_detector=False)
        phase(name, f'layouts and packages minted in {time.perf_counter() - t0:.1f} s: 3DPW '
                    f'{BENCH_3DPW["sequences"]} sequences x {BENCH_3DPW["frames"]} frames '
                    f'1080x1920 with {BENCH_3DPW["tracks"]} tracks, Human3.6M S9 4 cameras x '
                    f'{BENCH_H36M["frames"] // BENCH_H36M["frame_step"]} frames 1000x1002; '
                    f'{IMPORT_MODEL} on SMPL-24 with a firing YOLOv4-{DETECTOR_SIZE} and on '
                    f'H36M-17')

        # predict_3dpw through K1 and K2: the package loaded unfolded, fuse_mbconv on.
        r = drivers.run(drivers.loader('detect_poses_batched', cfg_overrides={'bn_fold': False},
                                       backbone_builder=functools.partial(build_backbone,
                                                                          fuse_mbconv='on')),
                        predict_3dpw.main, [
                           '--package', str(work / 'pkg_smpl'), '--root', str(work / '3dpw'),
                           '--output-path', str(work / 'pred_3dpw'), '--gtassoc'])
        est = r['est']
        n_frames = BENCH_3DPW['sequences'] * BENCH_3DPW['frames']
        per_chunk = INTERNAL_BATCH // 5  # boxes per chunk at predict_3dpw's num_aug 5
        chunks = sum(math.ceil(v / per_chunk) for *_, v in r['calls'])
        boxes_per_frame = [v / len(images) for images, *_, v in r['calls']]
        if (r['k1'] != chunks or r['k2'] != K2_BLOCKS * chunks or chunks == 0
                or est.cfg.bn_fold):
            fail(name, f'predict_3dpw launched K1 {r["k1"]} and K2 {r["k2"]} times, expected '
                       f'{chunks} and {K2_BLOCKS * chunks} ({chunks} non-empty chunks; '
                       f'bn_fold {est.cfg.bn_fold})')
        preds = [pickle.loads(p.read_bytes())['jointPositions']
                 for p in sorted((work / 'pred_3dpw' / 'test').glob('*.pkl'))]
        want_shape = (BENCH_3DPW['tracks'], BENCH_3DPW['frames'], 24, 3)
        if len(preds) != BENCH_3DPW['sequences'] or any(
                p.shape != want_shape or not np.isfinite(p).all() for p in preds):
            fail(name, f'predict_3dpw wrote {[p.shape for p in preds]}, expected '
                       f'{BENCH_3DPW["sequences"]} x {want_shape}, finite')
        eval_s, metrics_3dpw, _, _ = run_app(eval_3dpw.main, [
            '--pred-path', str(work / 'pred_3dpw'), '--root', str(work / '3dpw')])
        if not all(np.isfinite(v) for v in metrics_3dpw.values()):
            fail(name, f'eval_3dpw metrics {metrics_3dpw}')
        phase(name, f'predict_3dpw --gtassoc (num_aug 5, batch 16, internal batch 64, '
                    f'max_detections 16, threshold 0.2), unfolded, fuse_mbconv on: '
                    + driver_timing(r, n_frames) + f'; valid boxes per frame '
                    f'{min(boxes_per_frame):.2f}-{max(boxes_per_frame):.2f} (mean '
                    f'{statistics.mean(boxes_per_frame):.2f}) over {len(r["calls"])} calls; K1 '
                    f'{r["k1"]}, K2 {r["k2"]} ({chunks} chunks); {r["last"]}')
        phase(name, f'eval_3dpw in {eval_s:.2f} s: ' + json.dumps(metrics_3dpw))

        # The driver's first detect_poses_batched batch again: K1 and K2
        # counted, each K1 launch (portrait 1080x1920 pyramids) and K2's v
        # against their plain versions on the batch's inputs, then profiled.
        frames, args, kwargs, _ = r['calls'][0]
        (out, warp_errs), k1_batch, k2_batch, err_v, n_blocks = k2_v_error(
            est, lambda: checked_warps(lambda: est.detect_poses_batched(frames, *args,
                                                                        **kwargs)))
        warp_err = max(warp_errs, default=math.inf)
        if (n_blocks != K2_BLOCKS or err_v != 0.0 or k1_batch == 0
                or len(warp_errs) != k1_batch or not warp_err <= WARP_TOL):
            fail(name, f'one predict_3dpw batch: K1 {k1_batch} ({len(warp_errs)} compared, max '
                       f'|kernel - plain| {warp_err:.3g}, tol {WARP_TOL}), K2 {k2_batch}; K2 v '
                       f'max |kernel - plain| {err_v:.3g} over {n_blocks} blocks (must be 0)')
        for _ in range(TIMING_TRIES):
            wall_ms, device_ms, _, busy_ms, n_kernels, counts = profile_detect(
                est, lambda: est.detect_poses_batched(frames, *args, **kwargs))
            seen = (counts['K1 (warp kernel)'], counts['K2 (mbconv kernel)'])
            if seen == (k1_batch, k2_batch):
                break
        else:
            fail(name, f'the profiler never saw the {k1_batch} K1 and {k2_batch} K2 launches '
                       f'the wrappers counted in one batch')
        phase(name, f'one predict_3dpw batch ({len(frames)} frames, {int(out["valid"].sum())} '
                    f'valid boxes): K1 {k1_batch}, each against the plain warp (max |kernel - '
                    f'plain| {warp_err:.3g}, tol {WARP_TOL}); K2 {k2_batch}, v exact (max |kernel '
                    f'- plain| {err_v:.3g} over {n_blocks} blocks); under torch.profiler: wall '
                    f'{wall_ms:.1f} ms, device busy {busy_ms:.2f} ms '
                    f'({100 * busy_ms / wall_ms:.1f}%), {n_kernels} kernels, K1 '
                    f'{device_ms["K1 (warp kernel)"]:.3f} ms, K2 '
                    f'{device_ms["K2 (mbconv kernel)"]:.3f} ms, crop model '
                    f'{device_ms["crop_model"]:.2f} ms, detector {device_ms["detector"]:.2f} ms')
        k1_3dpw, k2_3dpw = r['k1'], r['k2']
        del est, r, out, frames
        torch.cuda.empty_cache()

        # predict_h36m (folded: K1 only), then eval_benchmark on the same examples.
        r = drivers.run(drivers.loader('estimate_poses_batched'), predict_h36m.main, [
            '--package', str(work / 'pkg_h36m'), '--h36m-root', str(work / 'h36m'),
            '--cameras-json', cameras_json, '--output-path', str(work / 'pred_h36m.npz'),
            '--frame-step', str(BENCH_H36M['frame_step'])])
        examples = load_h36m_examples(str(work / 'h36m'), cameras_json, subjects=(9,),
                                      frame_step=BENCH_H36M['frame_step'])
        n_ex = len(examples)
        with np.load(work / 'pred_h36m.npz') as f:
            poses = f['coords3d_pred_world']
        batches = math.ceil(n_ex / 16)
        if r['k1'] != batches or r['k2'] != 0 or poses.shape != (n_ex, 17, 3) or not np.isfinite(
                poses).all():
            fail(name, f'predict_h36m: K1 {r["k1"]} (expected {batches}), K2 {r["k2"]} '
                       f'(expected 0), poses {poses.shape} finite {np.isfinite(poses).all()}')
        # Its first batch again, each K1 launch (1000x1002 pyramids with odd
        # level sizes, the cameras' lens distortion, 2x antialiasing) against
        # the plain warp.
        est = r['est']
        images, args, kwargs, _ = r['calls'][0]
        warp_cuda.warp_pyramid.launches = 0
        _, warp_errs = checked_warps(lambda: est.estimate_poses_batched(images, *args, **kwargs))
        torch.cuda.synchronize()
        k1_batch = warp_cuda.warp_pyramid.launches
        warp_err = max(warp_errs, default=math.inf)
        distorted = bool(np.any(kwargs['distortion_coeffs'] != 0))
        if not distorted or k1_batch == 0 or len(warp_errs) != k1_batch or not (
                warp_err <= WARP_TOL):
            fail(name, f'one predict_h36m batch: K1 {k1_batch} ({len(warp_errs)} compared, max '
                       f'|kernel - plain| {warp_err:.3g}, tol {WARP_TOL}); distortion {distorted}')
        phase(name, f'predict_h36m (num_aug 1, batch 16), folded: ' + driver_timing(r, n_ex)
                    + f'; K1 {r["k1"]}, K2 {r["k2"]}; its first batch ({len(images)} frames, '
                      f'distorted cameras): K1 {k1_batch}, each against the plain warp (max '
                      f'|kernel - plain| {warp_err:.3g}, tol {WARP_TOL}); {r["last"]}')
        k1_h36m, k2_h36m = r['k1'], r['k2']
        del est, r, images
        (work / 'examples.pkl').write_bytes(pickle.dumps(examples))
        seconds, _, printed, _ = run_app(eval_benchmark.main, [
            '--package', str(work / 'pkg_h36m'), '--examples', str(work / 'examples.pkl'),
            '--benchmark', 'h36m', '--pred-out', str(work / 'preds.npz')])
        metrics = json.loads(printed[printed.index('{'):])
        if not all(np.isfinite(v) for k, v in metrics.items() if k != 'benchmark'):
            fail(name, f'eval_benchmark metrics {metrics}')
        phase(name, f'eval_benchmark --benchmark h36m ({n_ex} examples, crops on the host, '
                    f'no K1): {seconds:.2f} s, ' + json.dumps(metrics))
    finally:
        drivers.restore()
        shutil.rmtree(work, ignore_errors=True)
    return {'bench_3dpw': (k1_3dpw, k2_3dpw), 'bench_h36m': (k1_h36m, k2_h36m)}


TDHP_DIR = 'runs/chip_smoke_tdhp'
HDF5_FIXTURES = 'tests/torch_fixtures/hdf5'
# MPI-INF-3DHP test sequences driven in [tdhp]: (sequence number, its
# MATLAB-layout annotation fixture, the JPEG fixture its frames copy). TS1-4
# are 2048x2048, TS5-6 1920x1080 with lens distortion. The fixtures of TS1
# and TS5 have superblock v0 (h5py's default bound), TS2's v2 (v108) and
# TS6's v3 (latest).
TDHP_SEQUENCES = ((1, 'TS1_annot_data.mat', 'frame_3dhp_2048x2048.jpg'),
                  (2, 'TS2_annot_data.mat', 'frame_3dhp_2048x2048.jpg'),
                  (5, 'TS5_annot_data.mat', 'frame_3dhp_1920x1080.jpg'),
                  (6, 'TS6_annot_data.mat', 'frame_3dhp_1920x1080.jpg'))
# Cameras close to 3DHP's test cameras (subj1_4 without distortion; subj5_6
# with 12 coefficients, as `load_3dhp_test_frames` reads them).
TDHP_CAMERAS = {
    'subj1_4': dict(intrinsic_matrix=[[1497.7, 0, 1024.1], [0, 1497.6, 1051.1], [0, 0, 1]]),
    'subj5_6': dict(intrinsic_matrix=[[1684.0, 0, 939.9], [0, 1672.6, 560.4], [0, 0, 1]],
                    extrinsic_matrix=np.eye(4)[:3].tolist(),
                    distortion=[-0.12, 0.05, 0.001, -0.0005, -0.01, 0.002, 0.0, 0.0, 0.0005,
                                0.0, -0.0003, 0.0])}
TDHP_LARGE_FRAMES = 6151  # frames of TS1 in the published test set: the file timed on the card
# The fixture of TDHP_LARGE_FRAMES frames that h5py wrote under libver='latest'.
TDHP_LARGE_FIXTURE = 'large_annot_data.mat'


def hdf5_digest(value) -> dict:
    """SHA-256, dtype and shape of an array as the HDF5 manifest records them
    (tests/_torch_hdf5_fixtures.py::digest: strings of object arrays as
    their UTF-8 bytes, each ended by a NUL)."""
    import hashlib
    value = np.asarray(value)
    if value.dtype.kind == 'O':
        data = b''.join((s.encode('utf-8') if isinstance(s, str) else s) + b'\0'
                        for s in value.reshape(-1).tolist())
    else:
        value = np.ascontiguousarray(value)
        data = value.tobytes()
    return dict(sha256=hashlib.sha256(data).hexdigest(), dtype=value.dtype.str,
                shape=list(value.shape))


def check_hdf5_fixtures(root: Path) -> dict:
    """Every HDF5 fixture read by the port's reader as its manifest says
    (h5py's read, on the machine that wrote them: the card's machine has no
    h5py): each group's members in order, each dataset and alias (a path to
    a dataset read before, through hard, soft or external links), each
    attribute in order. Returns the counts and each file's superblock
    version."""
    from metrabs_tpu_torch.utils import hdf5

    manifest = json.loads((root / HDF5_FIXTURES / 'manifest.json').read_text())
    counts = dict(files=0, groups=0, datasets=0, aliases=0, attributes=0, versions={})
    for name, want in sorted(manifest.items()):
        with hdf5.File(root / HDF5_FIXTURES / name) as f:
            counts['versions'][name] = f._reader.version
            for group, members in want['groups'].items():
                if list(f[group]) != members:
                    fail('tdhp', f'{name}:{group} lists {list(f[group])[:8]}..., not its '
                                 f'manifest\'s {members[:8]}...')
            for key, digest in want['datasets'].items():
                if hdf5_digest(f[key][()]) != digest:
                    fail('tdhp', f'{name}:{key} reads as {hdf5_digest(f[key][()])}, not as its '
                                 f'manifest says: {digest}')
            for key, target in want['aliases'].items():
                if hdf5_digest(f[key][()]) != want['datasets'][target]:
                    fail('tdhp', f'{name}:{key} does not read as {target}, which it links to')
            for key, attrs in want['attrs'].items():
                got = f[key].attrs
                if (list(got) != [a for a, _ in attrs]
                        or any(hdf5_digest(got[a]) != d for a, d in attrs)):
                    fail('tdhp', f'{name}:{key}\'s attributes {list(got)} differ from their '
                                 f'manifest\'s')
        counts['files'] += 1
        for kind in ('groups', 'datasets', 'aliases'):
            counts[kind] += len(want[kind])
        counts['attributes'] += sum(len(a) for a in want['attrs'].values())
    return counts


def mint_tdhp_layout(work: Path, root: Path) -> tuple:
    """TS{n}/annot_data.mat (the fixtures) and TS{n}/imageSequence/img_%06d.jpg
    (copies of the JPEG fixture) for every frame of TDHP_SEQUENCES, and the
    cameras JSON. Returns (its path, frames per sequence)."""
    from metrabs_tpu_torch.utils import hdf5

    frames = {}
    for subj, annotations, jpeg_name in TDHP_SEQUENCES:
        seq = work / f'TS{subj}'
        (seq / 'imageSequence').mkdir(parents=True)
        shutil.copyfile(root / HDF5_FIXTURES / annotations, seq / 'annot_data.mat')
        with hdf5.File(seq / 'annot_data.mat') as m:
            frames[subj] = len(m['valid_frame'])
        for i in range(frames[subj]):
            shutil.copyfile(root / JPEG_FIXTURES / jpeg_name,
                            seq / 'imageSequence' / f'img_{i + 1:06d}.jpg')
    (work / 'cameras.json').write_text(json.dumps(TDHP_CAMERAS))
    return str(work / 'cameras.json'), frames


def time_large_annotations(path: Path, root: Path) -> dict:
    """A MATLAB-layout annot_data.mat of TDHP_LARGE_FRAMES frames written by
    the port's writer (user block, MATLAB_class attributes, doubles, chunked
    and deflated: superblock v0), then read as eval_3dhp reads it: seconds
    of each, equal values. Then the fixture of as many frames h5py wrote
    under libver='latest' (superblock v3, fixed-array chunk indexes), read
    the same way, its values equal to their manifest. Each file is read
    twice: the seconds of both reads."""
    from metrabs_tpu_torch.utils import hdf5

    n = TDHP_LARGE_FRAMES
    rng = np.random.default_rng(SEED + 17)
    annot3 = rng.normal(0, 200, (n, 1, 17, 3)) + [0, 0, 4000.0]
    valid = np.ones((n, 1))
    valid[::97] = 0
    arrays = dict(valid_frame=valid, annot3=annot3, univ_annot3=annot3 * 0.95)
    t0 = time.perf_counter()
    hdf5.write_hdf5(path, arrays, userblock_size=512,
                    attrs={k: {'MATLAB_class': 'double'} for k in arrays})
    write_s = time.perf_counter() - t0
    def timed_read(path):
        t0 = time.perf_counter()
        with hdf5.File(path, 'r') as m:
            read = {k: np.asarray(m[k]) for k in arrays}
            version = m._reader.version
        return read, version, time.perf_counter() - t0

    read, _, read_s = timed_read(path)
    read_again_s = timed_read(path)[2]
    if not all(np.array_equal(read[k], v) for k, v in arrays.items()):
        fail('tdhp', 'the large annotation file reads back differently from what was written')
    v3 = root / HDF5_FIXTURES / TDHP_LARGE_FIXTURE
    want = json.loads((root / HDF5_FIXTURES / 'manifest.json').read_text())[TDHP_LARGE_FIXTURE]
    read, version, v3_read_s = timed_read(v3)
    v3_read_again_s = timed_read(v3)[2]
    if (version != 3 or len(read['valid_frame']) != n
            or any(hdf5_digest(v) != want['datasets']['/' + k] for k, v in read.items())):
        fail('tdhp', f'{TDHP_LARGE_FIXTURE} (superblock v{version}) does not read as its '
                     f'manifest says')
    return dict(frames=n, write_s=write_s, read_s=read_s, read_again_s=read_again_s,
                mib=path.stat().st_size / 2**20, v3_read_s=v3_read_s,
                v3_read_again_s=v3_read_again_s, v3_mib=v3.stat().st_size / 2**20)


def tdhp_phase(root: Path, dev) -> dict:
    """The [tdhp] phase (module docstring). Returns predict_3dhp's K1 and K2
    launches."""
    from metrabs_tpu_torch.apps import eval_3dhp, predict_3dhp
    from metrabs_tpu_torch.eval.harness import save_predictions
    from metrabs_tpu_torch.models.backbones.builder import build_backbone
    from metrabs_tpu_torch.pipeline.skeletons import H36M_17
    from metrabs_tpu_torch.utils import hdf5

    name = 'tdhp'
    t0 = time.perf_counter()
    read = check_hdf5_fixtures(root)
    phase(name, f'HDF5 reader (pure Python): {read["files"]} fixtures (superblock versions '
                f'{json.dumps(read["versions"], sort_keys=True)}) read as their manifest says in '
                f'{time.perf_counter() - t0:.2f} s: {read["groups"]} groups\' members in order, '
                f'{read["datasets"]} datasets and {read["aliases"]} links to them, '
                f'{read["attributes"]} attributes in order (SHA-256, dtype, shape as h5py '
                f'read them)')
    work = root / TDHP_DIR
    shutil.rmtree(work, ignore_errors=True)
    gen = torch.Generator().manual_seed(SEED + 19)
    drivers = DriverRuns()
    try:
        t0 = time.perf_counter()
        cameras_json, frames = mint_tdhp_layout(work / '3dhp', root)
        bench_package(work / 'pkg', gen, H36M_17, with_detector=True)
        phase(name, f'layout and package minted in {time.perf_counter() - t0:.1f} s: '
                    + ', '.join(f'TS{s} {frames[s]} frames of {j[11:-4]} (annotations of '
                                f'superblock v{read["versions"][a]})'
                                for s, a, j in TDHP_SEQUENCES)
                    + f'; {IMPORT_MODEL} on H36M-17 joints (mpi_inf_3dhp_17 in its registry) '
                      f'with YOLOv4-{DETECTOR_SIZE}')

        # predict_3dhp through K1 and K2: the package loaded unfolded, fuse_mbconv on.
        r = drivers.run(drivers.loader('detect_poses_batched', cfg_overrides={'bn_fold': False},
                                       backbone_builder=functools.partial(build_backbone,
                                                                          fuse_mbconv='on')),
                        predict_3dhp.main, [
                            '--package', str(work / 'pkg'), '--root', str(work / '3dhp'),
                            '--cameras-json', cameras_json,
                            '--output-path', str(work / 'pred.npz')])
        est = r['est']
        chunks = sum(math.ceil(v / INTERNAL_BATCH) for *_, v in r['calls'])  # num_aug 1
        n_pred = sum(len(images) for images, *_ in r['calls'])
        if (r['k1'] != chunks or r['k2'] != K2_BLOCKS * chunks or chunks == 0
                or est.cfg.bn_fold):
            fail(name, f'predict_3dhp launched K1 {r["k1"]} and K2 {r["k2"]} times, expected '
                       f'{chunks} and {K2_BLOCKS * chunks} ({chunks} non-empty chunks; bn_fold '
                       f'{est.cfg.bn_fold})')
        with np.load(work / 'pred.npz') as f:
            paths, poses = f['image_path'], f['coords3d_pred_world']
        if poses.shape != (n_pred, 17, 3) or not np.isfinite(poses).all() or len(paths) != n_pred:
            fail(name, f'predict_3dhp wrote {poses.shape} poses for {len(paths)} paths, '
                       f'expected ({n_pred}, 17, 3), finite')
        eval_s, metrics, _, _ = run_app(eval_3dhp.main, [
            '--pred-path', str(work / 'pred.npz'), '--root', str(work / '3dhp')])
        if not (all(np.isfinite(metrics[k]) for k in ('pck', 'auc', 'mpjpe'))
                and metrics['n_frames'] == n_pred
                and sorted(metrics['per_seq_pck']) == [f'TS{s}' for s, *_ in TDHP_SEQUENCES]):
            fail(name, f'eval_3dhp metrics {metrics}: not every sequence of {TDHP_SEQUENCES} '
                       f'scored')
        phase(name, f'predict_3dhp (num_aug 1, batch 16, internal batch 64, max_detections 1, '
                    f'threshold 0, flip aug, antialias 2), unfolded, fuse_mbconv on: '
                    + driver_timing(r, n_pred) + f'; K1 {r["k1"]}, K2 {r["k2"]} ({chunks} '
                    f'chunks over {len(r["calls"])} calls); {r["last"]}')
        phase(name, f'eval_3dhp in {eval_s:.2f} s: ' + json.dumps(metrics, sort_keys=True))
        for size in sorted({tuple(c[0].shape[1:3]) for c in r['calls']}, reverse=True):
            mine = [(len(c[0]), t) for c, t in zip(r['calls'], r['call_s'])
                    if tuple(c[0].shape[1:3]) == size]
            n, t = sum(m[0] for m in mine), sum(m[1] for m in mine)
            phase(name, f'{size[1]}x{size[0]}: {n} frames in {len(mine)} detect_poses_batched '
                        f'calls, {t:.2f} s = {n / t:.2f} frames/s in the calls (decoding and '
                        f'file I/O excluded; the first call of each size includes cuDNN\'s '
                        f'algorithm search); per call: '
                        + ', '.join(f'{m[1] * 1e3:.0f} ms' for m in mine))

        # The first batch of each frame size again: each K1 launch against
        # the plain warp, K2's v against the plain chain.
        for size in sorted({tuple(images.shape[1:3]) for images, *_ in r['calls']}):
            images, args, kwargs, _ = next(c for c in r['calls']
                                           if tuple(c[0].shape[1:3]) == size)
            (out, warp_errs), k1_batch, k2_batch, err_v, n_blocks = k2_v_error(
                est, lambda: checked_warps(lambda: est.detect_poses_batched(images, *args,
                                                                            **kwargs)))
            warp_err = max(warp_errs, default=math.inf)
            distorted = bool(np.any(np.asarray(kwargs['distortion_coeffs']) != 0))
            if (n_blocks != K2_BLOCKS or err_v != 0.0 or k1_batch == 0
                    or len(warp_errs) != k1_batch or not warp_err <= WARP_TOL):
                fail(name, f'one predict_3dhp batch of {size[1]}x{size[0]}: K1 {k1_batch} '
                           f'({len(warp_errs)} compared, max |kernel - plain| {warp_err:.3g}, '
                           f'tol {WARP_TOL}), K2 {k2_batch}; K2 v max |kernel - plain| '
                           f'{err_v:.3g} over {n_blocks} blocks (must be 0)')
            phase(name, f'one predict_3dhp batch of {len(images)} {size[1]}x{size[0]} frames '
                        f'(distortion {distorted}, {int(out["valid"].sum())} valid boxes): K1 '
                        f'{k1_batch}, each against the plain warp (max |kernel - plain| '
                        f'{warp_err:.3g}, tol {WARP_TOL}); K2 {k2_batch}, v exact (max |kernel - '
                        f'plain| {err_v:.3g} over {n_blocks} blocks)')
        k1_tdhp, k2_tdhp = r['k1'], r['k2']
        del est, r, out, images

        # The same predictions as NPZ and as HDF5 through save_predictions.
        dump = dict(image_path=paths, coords3d_pred_world=poses)
        save_predictions(str(work / 'dump.npz'), dump)
        save_predictions(str(work / 'dump.h5'), dump)
        with np.load(work / 'dump.npz') as f, hdf5.File(work / 'dump.h5') as h:
            same = (np.array_equal(f['coords3d_pred_world'], poses)
                    and np.array_equal(h['coords3d_pred_world'][()], poses)
                    and f['image_path'].tolist() == paths.tolist()
                    and [s.decode() for s in h['image_path'][()]] == paths.tolist())
        if not same:
            fail(name, 'the predictions read back from .npz and .h5 differ from those written')
        large = time_large_annotations(work / 'large_annot_data.mat', root)
        phase(name, f'predictions written through save_predictions as .npz and .h5 and read '
                    f'back equal; a MATLAB-layout annot_data.mat of {large["frames"]} frames '
                    f'({large["mib"]:.1f} MiB, superblock v0, written by the port in '
                    f'{large["write_s"]:.2f} s) read in {large["read_s"]:.3f} s (again: '
                    f'{large["read_again_s"]:.3f} s); h5py\'s of as many frames under '
                    f'libver=\'latest\' ({large["v3_mib"]:.2f} MiB, superblock v3) read in '
                    f'{large["v3_read_s"]:.3f} s (again: {large["v3_read_again_s"]:.3f} s), equal '
                    f'to its manifest (on the card machine\'s host, beside {card_name()})')
    finally:
        drivers.restore()
        shutil.rmtree(work, ignore_errors=True)
    return {'tdhp': (k1_tdhp, k2_tdhp)}


DETECTOR_TRAIN_DIR = 'runs/chip_smoke_detector_train'  # the served package (deleted after)
DET_TRAIN_SIZE = 416  # scripts/train_to_serve_e2e.py's SCENE_SIDE
DET_TRAIN_BATCH = 8  # its --det-batch
# (warm-up steps, timed steps, peak LR of the cosine schedule) per detector.
# YOLOv4-tiny at scripts/train_to_serve_e2e.py's 1e-3; full YOLOv4 at 1e-4:
# from this random start, Adam's first steps at 1e-3 (about lr * sign(g) on
# every weight) make its 110 layers' activations and the loss overflow
# (1e7-1e15 within a few steps in float32 CPU runs at batch 2), as BN is
# frozen.
DET_RUNS = {'yolov4-tiny': (3, 30, 1e-3), 'yolov4': (2, 5, 1e-4)}
DET_SCENES = 32  # minted scenes the batches are drawn from
DET_MAX_BOXES = 3  # ground-truth boxes per scene (and the padding of gt_boxes)
DET_PARITY_BATCH = 2
# The float32 GPU step against the same step on the CPU in float64 from one
# state (an initial YOLOv4-tiny): the loss within DET_LOSS_RTOL; every
# gradient within DET_GRAD_TOL of the model's largest gradient; the updated
# parameters within DET_PARAM_ATOL where the reference gradient is at least
# DET_GRAD_NOISE of the model's largest, else within 2 lr (Adam's first step
# is about lr * sign(g), so this holds the sign of every gradient above the
# noise). The scale is the model's largest gradient, not each tensor's: a
# weight gradient sums thousands of products that largely cancel, and
# float32 on an H100 (cuDNN's algorithms or native convolutions,
# deterministic or not) left up to 1.1e-3 of some tensor's own largest
# gradient of a trained YOLOv4-tiny but 1.8e-5 of the model's; TF32 left
# 1.8e-3 of the model's.
DET_LOSS_RTOL, DET_GRAD_TOL = 1e-4, 1e-4
DET_GRAD_NOISE, DET_PARAM_ATOL = 1e-3, 1e-6


def detector_scenes(rng, n: int, size: int = DET_TRAIN_SIZE) -> tuple:
    """`n` uint8 scenes [n, size, size, 3]: smooth backgrounds with 1 to
    DET_MAX_BOXES upright 'people' (a body rectangle and a head disc in a
    flat colour), and their tight top-left (x, y, w, h) boxes."""
    y, x = np.mgrid[:size, :size].astype(np.float32)
    images, boxes = [], []
    for _ in range(n):
        im = np.stack([110 + 60 * np.sin(x / rng.uniform(20, 60) + k)
                       * np.cos(y / rng.uniform(20, 60) - k) for k in range(3)], -1)
        scene = []
        for _ in range(rng.integers(1, DET_MAX_BOXES + 1)):
            h = rng.uniform(0.25, 0.7) * size
            w = h * rng.uniform(0.3, 0.45)
            x0, y0 = rng.uniform(0, size - w), rng.uniform(0, size - h)
            colour = rng.uniform(0, 255, 3)
            head = w / 2
            body = (x >= x0) & (x < x0 + w) & (y >= y0 + head) & (y < y0 + h)
            disc = (x - x0 - w / 2) ** 2 + (y - y0 - head / 2) ** 2 < (head / 2) ** 2
            im[body | disc] = colour
            scene.append([x0, y0, w, h])
        images.append(np.clip(im + rng.normal(0, 4, im.shape), 0, 255).astype(np.uint8))
        boxes.append(np.float32(scene))
    return np.stack(images), boxes


def detector_batch(images, boxes, idx, model) -> tuple:
    """(images [B, S, S, 3] float32 in [0, 1], targets, obj_masks, gt_boxes,
    gt_valid) of scenes `idx`, the boxes padded to DET_MAX_BOXES (fixed
    shapes, as scripts/train_to_serve_e2e.py pads them)."""
    from metrabs_tpu_torch.detect.train import build_targets

    anchors, strides, _ = model.decode_tables
    targets, masks, gtb, gtv = build_targets([boxes[i] for i in idx], DET_TRAIN_SIZE,
                                             anchors=anchors, strides=strides)
    pad = DET_MAX_BOXES - gtb.shape[1]
    gtb = np.pad(gtb, ((0, 0), (0, pad), (0, 0)))
    gtv = np.pad(gtv, ((0, 0), (0, pad)))
    return images[idx].astype(np.float32) / 255.0, targets, masks, gtb, gtv


def initial_detector(kind: str, gen: torch.Generator):
    """A float32 detector module of `kind` at JAX's training start
    (`create_detector_train_state` initialises with flax's defaults): conv
    kernels from a normal of variance 1 / fan-in drawn from `gen`, zero
    biases, BN scale 1, shift 0 and running statistics 0 and 1 (the
    module's own)."""
    from metrabs_tpu_torch.detect.yolov4 import build_detector_model

    model = build_detector_model(kind)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, torch.nn.Conv2d):
                fan_in = module.weight[0].numel()
                module.weight.normal_(0.0, fan_in ** -0.5, generator=gen)
                if module.bias is not None:
                    module.bias.zero_()
    return model


def train_detector(model, dev, scenes, rng, n_warmup: int, n_timed: int, lr: float,
                   must_fall: bool, name: str) -> dict:
    """`n_warmup` + `n_timed` steps at DET_TRAIN_BATCH of random scenes with
    Adam on the cosine schedule from `lr` (scripts/train_to_serve_e2e.py's
    form), then one under torch.profiler. Fails unless every loss is finite,
    no step launched K1 or K2 and, if `must_fall`, the last steps' mean loss
    is below the first steps'."""
    from metrabs_tpu_torch.detect import train as det_train
    from metrabs_tpu_torch.ops import mbconv_cuda, warp_cuda
    from metrabs_tpu_torch.train import optim

    images, boxes = scenes
    n_steps = n_warmup + n_timed + 1
    tx = optim.Adam(optim.cosine_decay_schedule(lr, n_steps, alpha=0.05))
    state = det_train.create_detector_train_state(model, tx, device=dev)
    step = det_train.make_detector_train_step(model, tx, input_size=DET_TRAIN_SIZE)
    batches = [detector_batch(images, boxes, rng.integers(0, len(images), DET_TRAIN_BATCH), model)
               for _ in range(n_steps)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    warp_cuda.warp_pyramid.launches = mbconv_cuda.fused_mbconv_inner.launches = 0
    losses, times = [], []
    for batch in batches[:-1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step(state, *batch)[1])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    wall_ms, busy_ms, n_kernels, _ = profile_step(
        lambda: losses.append(step(state, *batches[-1])[1]))
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    if warp_cuda.warp_pyramid.launches or mbconv_cuda.fused_mbconv_inner.launches:
        fail(name, 'a detector train step launched K1 or K2')
    loss = torch.stack(losses).cpu()
    window = max(2, len(loss) // 6)
    falls = bool(loss[-window:].mean() < loss[:window].mean())
    if not bool(torch.isfinite(loss).all()) or (must_fall and not falls):
        fail(name, f'detector losses not finite or not falling: {loss.tolist()}')
    step_s = statistics.median(times[n_warmup:])
    return dict(step_s=step_s, images_s=DET_TRAIN_BATCH / step_s, wall_ms=wall_ms,
                busy_ms=busy_ms, kernels=n_kernels, peak_gb=peak_gb, losses=loss.tolist(),
                falls=falls, times=times, state=state)


def detector_step_parity(model, dev, scenes) -> dict:
    """One step (Adam, lr 1e-3) of copies of `model` on the GPU in float32
    and on the CPU in float64 from the same state and batch
    (DET_PARITY_BATCH scenes)."""
    import copy

    from metrabs_tpu_torch.detect import train as det_train
    from metrabs_tpu_torch.train import optim

    images, boxes = scenes
    batch = detector_batch(images, boxes, np.arange(DET_PARITY_BATCH), model)
    results = []
    for where, dtype in ((dev, torch.float32), ('cpu', torch.float64)):
        copied = copy.deepcopy(model).to(where, dtype)
        tx = optim.Adam(1e-3)
        grads = {}
        apply = tx.step
        tx.step = lambda params, g, st: (grads.update({n: v.double().cpu()
                                                       for n, v in g.items()}),
                                         apply(params, g, st))
        state = det_train.create_detector_train_state(copied, tx, device=where)
        _, loss = det_train.make_detector_train_step(copied, tx, input_size=DET_TRAIN_SIZE)(
            state, *batch)
        results.append((float(loss), grads, {n: p.detach().double().cpu()
                                             for n, p in copied.named_parameters()}))
    (gpu_loss, gpu_grads, gpu_params), (cpu_loss, cpu_grads, cpu_params) = results
    largest = max(g.abs().max().item() for g in cpu_grads.values())
    worst = (0.0, '', 0.0, 0.0)  # (error, tensor, its largest |g|, error over that)
    param_err = 0.0
    flipped = held = 0
    for n, want in cpu_grads.items():
        scale = want.abs().max().item()
        err = (gpu_grads[n] - want).abs().max().item()
        worst = max(worst, (err, n, scale, err / max(scale, 1e-30)))
        diff = (gpu_params[n] - cpu_params[n]).abs()
        noise = want.abs() < DET_GRAD_NOISE * largest
        param_err = max(param_err, diff[~noise].max().item() if (~noise).any() else 0.0)
        held += int((~noise).sum())
        flipped += int((diff > DET_PARAM_ATOL).sum())
        if diff.max().item() > 2e-3 + DET_PARAM_ATOL:
            fail('detector_train', f'{n}: GPU and CPU parameters differ by '
                                   f'{diff.max().item():.3g} after one step')
    loss_err = abs(gpu_loss - cpu_loss) / abs(cpu_loss)
    grad_err = worst[0] / largest
    if not (loss_err <= DET_LOSS_RTOL and grad_err <= DET_GRAD_TOL
            and param_err <= DET_PARAM_ATOL):
        fail('detector_train', f'float32 GPU step vs float64 CPU: loss {gpu_loss} vs {cpu_loss} '
                               f'(rel {loss_err:.3g}), worst gradient {worst[1]} off by '
                               f'{grad_err:.3g} of the model\'s largest |g| {largest:.3g} '
                               f'({worst[3]:.3g} of its own {worst[2]:.3g}), max parameter error '
                               f'{param_err:.3g} where the gradient is above noise')
    return dict(loss_err=loss_err, grad_err=grad_err, worst=worst[1], worst_scale=worst[2],
                worst_own=worst[3], largest=largest, param_err=param_err, flipped=flipped,
                held=held, n_params=sum(p.numel() for p in cpu_params.values()))


def detector_recall(est, images, boxes, threshold: float = 0.3) -> tuple:
    """(ground-truth boxes found at IoU > 0.5, their count) by `est`'s
    detector at `threshold` (scripts/train_to_serve_e2e.py's measure)."""
    from metrabs_tpu_torch.eval.harness import box_recall

    with torch.inference_mode():
        boxes5, valid = est.detector.detect_batched(
            torch.as_tensor(images, device=est.device), threshold=threshold, max_detections=8)
    total = sum(len(gt) for gt in boxes)
    recall, _ = box_recall(boxes5.cpu().numpy(), valid.cpu().numpy(), boxes)
    return round(recall * total), total


def detector_train_phase(root: Path, dev) -> dict:
    """The [detector_train] phase (module docstring). Returns the K1 and K2
    launches of the training runs and of serving the trained detector."""
    from metrabs_tpu_torch.io.packaging import add_detector_to_package, load_pose_estimator
    from metrabs_tpu_torch.io.weights import flax_variables_from_state_dict
    from metrabs_tpu_torch.ops import mbconv_cuda, warp_cuda
    from metrabs_tpu_torch.pipeline.skeletons import H36M_17

    name = 'detector_train'
    rng = np.random.default_rng(SEED + 23)
    gen = torch.Generator().manual_seed(SEED + 23)
    t0 = time.perf_counter()
    scenes = detector_scenes(rng, DET_SCENES)
    held_out = detector_scenes(rng, DET_TRAIN_BATCH)
    phase(name, f'{DET_SCENES} training and {DET_TRAIN_BATCH} held-out scenes of '
                f'{DET_TRAIN_SIZE}x{DET_TRAIN_SIZE} minted in {time.perf_counter() - t0:.1f} s '
                f'({sum(map(len, scenes[1]))} ground-truth person boxes)')
    runs = {}
    for kind, (n_warm, n_timed, lr) in DET_RUNS.items():
        model = initial_detector(kind, gen)
        r = train_detector(model, dev, scenes, rng, n_warm, n_timed, lr,
                           must_fall=kind == 'yolov4-tiny', name=name)
        runs[kind] = r
        phase(name, f'{kind}@{DET_TRAIN_SIZE} float32 batch {DET_TRAIN_BATCH}, Adam on the cosine '
                    f'schedule ({lr:g}, alpha 0.05), BN frozen: {n_timed} timed steps after '
                    f'{n_warm}: median {r["step_s"] * 1e3:.1f} ms/step (CUDA-synchronised), '
                    f'{r["images_s"]:.1f} images/s; all: '
                    + ', '.join(f'{t * 1e3:.1f}' for t in r['times'])
                    + f'; one step under torch.profiler: wall {r["wall_ms"]:.1f} ms, device busy '
                      f'{r["busy_ms"]:.2f} ms ({100 * r["busy_ms"] / r["wall_ms"]:.1f}%), '
                      f'{r["kernels"]} kernels; peak memory {r["peak_gb"]:.2f} GiB; loss first '
                      f'{r["losses"][0]:.4f}, last {r["losses"][-1]:.4f} (all: '
                    + ', '.join(f'{v:.3f}' for v in r['losses'])
                    + f'; falling: {r["falls"]}); K1 and K2 launches: 0')
        if kind == 'yolov4':
            del model, r
            runs[kind].pop('state')
            torch.cuda.empty_cache()
    tiny = runs['yolov4-tiny'].pop('state').model
    # From a state drawn on the host, so that it is the same in every run
    # (the GPU's training runs differ at ~1e-4, and with them how far float32
    # rounding moves a gradient that cancels).
    parity = detector_step_parity(initial_detector('yolov4-tiny',
                                                   torch.Generator().manual_seed(SEED + 29)),
                                  dev, scenes)
    phase(name, f'initial YOLOv4-tiny step, GPU float32 (TF32 off) vs CPU float64, batch '
                f'{DET_PARITY_BATCH}: loss rel {parity["loss_err"]:.3g} (tol {DET_LOSS_RTOL}), '
                f'gradients within {parity["grad_err"]:.3g} of the model\'s largest |g| '
                f'{parity["largest"]:.3g} (tol {DET_GRAD_TOL}; the worst, {parity["worst"]}, '
                f'{parity["worst_own"]:.3g} of its own largest {parity["worst_scale"]:.3g}), '
                f'parameters within {parity["param_err"]:.3g} where the gradient is above '
                f'{DET_GRAD_NOISE} of the model\'s largest ({parity["held"]} of '
                f'{parity["n_params"]}; tol {DET_PARAM_ATOL}); {parity["flipped"]} parameters '
                f'differ by more')

    # The trained tiny detector joins a crop-model package and serves.
    work = root / DETECTOR_TRAIN_DIR
    shutil.rmtree(work, ignore_errors=True)
    try:
        bench_package(work / 'pkg', gen, H36M_17, with_detector=False)
        trained = {k: v.detach().cpu() for k, v in tiny.state_dict().items()}
        add_detector_to_package(str(work / 'pkg'), flax_variables_from_state_dict(trained),
                                detector_type='yolov4-tiny', detector_dtype='float32',
                                detector_input_size=DET_TRAIN_SIZE)
        del tiny
        est = load_pose_estimator(str(work / 'pkg'), device=dev)
        hits, total = detector_recall(est, *held_out)
        frames = torch.as_tensor(held_out[0], device=dev)
        run = lambda: est.detect_poses_batched(frames, num_aug=NUM_AUG, max_detections=4,
                                               detector_threshold=0.0,
                                               internal_batch_size=INTERNAL_BATCH)
        run()  # warm-up (cuDNN algorithm selection)
        torch.cuda.synchronize()
        warp_cuda.warp_pyramid.launches = mbconv_cuda.fused_mbconv_inner.launches = 0
        out, warp_errs = checked_warps(run)
        torch.cuda.synchronize()
        k1, k2 = warp_cuda.warp_pyramid.launches, mbconv_cuda.fused_mbconv_inner.launches
        warp_err = max(warp_errs, default=math.inf)
        detected = out['boxes'][..., 4] > 0
        if (k1 == 0 or k2 != 0 or len(warp_errs) != k1 or not warp_err <= WARP_TOL
                or not bool(torch.isfinite(out['poses3d'][detected]).all())):
            fail(name, f'serving the trained detector: K1 {k1} ({len(warp_errs)} compared, max '
                       f'|kernel - plain| {warp_err:.3g}), K2 {k2}; finite poses '
                       f'{bool(torch.isfinite(out["poses3d"][detected]).all())}')
        phase(name, f'the trained YOLOv4-tiny added to a {IMPORT_MODEL} crop-model package '
                    f'(add_detector_to_package) and served folded by detect_poses_batched on '
                    f'the {DET_TRAIN_BATCH} held-out scenes (threshold 0, max_detections 4, '
                    f'num_aug {NUM_AUG}): {int(detected.sum())} detections, finite poses; K1 '
                    f'{k1}, each against the plain warp (max |kernel - plain| {warp_err:.3g}, '
                    f'tol {WARP_TOL}), K2 {k2}; recall at IoU 0.5 and threshold 0.3 on the '
                    f'held-out scenes: {hits} of {total}')
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {'detector_train': (0, 0), 'serve_trained_detector': (k1, k2)}


TRAIN2SERVE_DIR = 'runs/chip_smoke_train2serve'  # the run's files (deleted after)
# scripts/train_to_serve_e2e_torch.py at full width (EffNetV2-S@256 bf16 at
# 16 + 16, YOLOv4-tiny@416 at batch 8), cut: 24 training and 8 held-out
# scenes (the script's first scenes of its seeds), 40 crop steps (validation
# every 8, the script's steps // 5), 40 detector steps, the smoke gates.
TRAIN2SERVE_ARGS = ('--steps', '40', '--det-steps', '40', '--scenes', '24', '--val-scenes', '8',
                    '--smoke')
TRAIN2SERVE_PROFILED_STEP = 30  # the crop step taken under torch.profiler


def train2serve_phase(root: Path, dev) -> dict:
    """The [train2serve] phase (module docstring). Returns the K1 and K2
    launches of the script's run and of the fused serve."""
    import importlib.util

    from metrabs_tpu_torch.io.packaging import load_pose_estimator
    from metrabs_tpu_torch.models.backbones.builder import build_backbone
    from metrabs_tpu_torch.ops import mbconv_cuda, warp_cuda
    from metrabs_tpu_torch.train import loop

    name = 'train2serve'
    spec = importlib.util.spec_from_file_location(
        'train_to_serve_e2e_torch', root / 'scripts' / 'train_to_serve_e2e_torch.py')
    t2s = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(t2s)
    work = root / TRAIN2SERVE_DIR
    shutil.rmtree(work, ignore_errors=True)

    # The app's train step, timed (CUDA-synchronised before and after each
    # step: the step alone, and from one step's start to the next's, the
    # feed, logging and validation included), with one step
    # (TRAIN2SERVE_PROFILED_STEP) taken under torch.profiler and the peak
    # memory of that step. A profile that recorded no GPU kernel is taken
    # again (`profiled`): one more step on the same batch.
    make_train_step, profile, starts, ends = loop.make_train_step, {}, [], []

    def make_profiled_step(*args, **kwargs):
        step = make_train_step(*args, **kwargs)

        def profiled_step(state, b3, b2, **step_kwargs):
            torch.cuda.synchronize()
            starts.append(time.perf_counter())
            if len(starts) != TRAIN2SERVE_PROFILED_STEP:
                losses = step(state, b3, b2, **step_kwargs)
            else:
                out = []
                torch.cuda.reset_peak_memory_stats()
                wall_ms, busy_ms, n_kernels, _ = profile_step(
                    lambda: out.append(step(state, b3, b2, **step_kwargs)))
                profile.update(wall_ms=wall_ms, busy_ms=busy_ms, kernels=n_kernels,
                               peak_gb=torch.cuda.max_memory_allocated() / 2**30)
                losses = out[-1]
            torch.cuda.synchronize()
            ends.append(time.perf_counter())
            return losses
        return profiled_step

    argv = [*TRAIN2SERVE_ARGS, '--out', str(work), '--record', str(work / 'record.json')]
    try:
        loop.make_train_step = make_profiled_step
        torch.cuda.synchronize()
        warp_cuda.warp_pyramid.launches = mbconv_cuda.fused_mbconv_inner.launches = 0
        try:
            record, warp_errs = checked_warps(lambda: t2s.main(argv))
        finally:
            loop.make_train_step = make_train_step
        torch.cuda.synchronize()
        k1, k2 = warp_cuda.warp_pyramid.launches, mbconv_cuda.fused_mbconv_inner.launches
        warp_err = max(warp_errs, default=math.inf)
        if k1 == 0 or k2 != 0 or len(warp_errs) != k1 or not warp_err <= WARP_TOL:
            fail(name, f'the script\'s serve: K1 {k1} ({len(warp_errs)} compared, max |kernel - '
                       f'plain| {warp_err:.3g}), K2 {k2}')
        if not profile:
            fail(name, f'crop step {TRAIN2SERVE_PROFILED_STEP} was not profiled')
        # Medians after TRAIN_WARMUP steps, without the profiled one.
        timed = [i for i in range(TRAIN_WARMUP, len(starts))
                 if i != TRAIN2SERVE_PROFILED_STEP - 1]
        step_s = statistics.median(ends[i] - starts[i] for i in timed)
        iteration_s = statistics.median(starts[i + 1] - starts[i] for i in timed
                                        if i + 1 < len(starts))
        cut = t2s.parse_args(argv)
        n_images = 2 * cut.batch_size
        matched = record['detect_poses_matched']
        if not all(math.isfinite(v) for v in (*matched.values(), record['mpjpe_served_gt_boxes'],
                                                 record['det_step_median_s'])):
            fail(name, f'non-finite numbers in the record: {record}')
        phase(name, f'scripts/train_to_serve_e2e_torch.py in-process, EffNetV2-S@{PROC_SIDE} bf16 '
                    f'{cut.batch_size}+{cut.batch_size} and YOLOv4-tiny@416 float32 batch '
                    f'{cut.det_batch}, cut to {" ".join(TRAIN2SERVE_ARGS)} (full run: 96 + 16 '
                    f'scenes, 6000 + 800 steps): '
                    f'{record["n_train_people"]} training and {record["n_val_people"]} held-out '
                    f'people; crop step median {step_s * 1e3:.1f} ms (CUDA-synchronised, '
                    f'{n_images / step_s:.1f} images/s), {iteration_s * 1e3:.1f} ms from one '
                    f'step to the next with the feed ({n_images / iteration_s:.1f} images/s), over '
                    f'{len(timed)} steps after {TRAIN_WARMUP}; '
                    f'step {TRAIN2SERVE_PROFILED_STEP} under torch.profiler: wall '
                    f'{profile["wall_ms"]:.1f} ms, device busy {profile["busy_ms"]:.2f} ms '
                    f'({100 * profile["busy_ms"] / profile["wall_ms"]:.1f}%), {profile["kernels"]} '
                    f'kernels, peak memory {profile["peak_gb"]:.2f} GiB; detector step median '
                    f'{record["det_step_median_s"] * 1e3:.1f} ms; val MPJPE '
                    f'{record["val_mpjpe_curve"][0][1]:.1f} -> '
                    f'{record["val_mpjpe_curve"][-1][1]:.1f} mm (absolute '
                    f'{record["val_abs_mpjpe_curve"][-1][1]:.1f} mm); detector recall '
                    f'{record["detector_recall"]:.3f}; served folded: matched '
                    f'{json.dumps(matched)}, GT-box MPJPE '
                    f'{record["mpjpe_served_gt_boxes"]:.1f} mm; '
                    f'K1 {k1}, each against the plain warp (max |kernel - plain| '
                    f'{warp_err:.3g}, tol {WARP_TOL}), K2 {k2}; {record["wall_s"]:.1f} s')

        # The trained package served again, unfolded with fuse_mbconv='on',
        # on the held-out scenes' ground-truth boxes (the script's second
        # serving call): K2's v on the first chunk's input to each fused
        # block and every K1 launch against the plain versions.
        val_scenes, _, _, cam = t2s.build_split(1007, cut.val_scenes)
        images = np.stack([img for img, _ in val_scenes])
        gt_boxes = t2s.scene_boxes(val_scenes, cam)
        intrinsics = np.tile(cam.intrinsic_matrix[None], (len(images), 1, 1))
        fused = load_pose_estimator(str(work / 'package'), device=dev,
                                    cfg_overrides={'bn_fold': False},
                                    backbone_builder=functools.partial(build_backbone,
                                                                       fuse_mbconv='on'))
        run = lambda: fused.estimate_poses_batched(images, gt_boxes, intrinsic_matrix=intrinsics,
                                                   num_aug=NUM_AUG)
        run()  # warm-up (cuDNN algorithm selection)
        (out, warp_errs), k1_fused, k2_fused, err_v, n_blocks = k2_v_error(
            fused, lambda: checked_warps(run))
        chunks = math.ceil(gt_boxes.shape[0] * gt_boxes.shape[1] / (INTERNAL_BATCH // NUM_AUG))
        warp_err = max(warp_errs, default=math.inf)
        if (k1_fused != chunks or k2_fused != K2_BLOCKS * chunks or n_blocks != K2_BLOCKS
                or err_v != 0.0 or len(warp_errs) != k1_fused or not warp_err <= WARP_TOL):
            fail(name, f'fused serve: K1 {k1_fused} and K2 {k2_fused} (expected {chunks} and '
                       f'{K2_BLOCKS * chunks}); K2 v error {err_v:.3g} over {n_blocks} blocks; '
                       f'K1 error {warp_err:.3g} over {len(warp_errs)} launches')
        poses = out['poses3d'].cpu().numpy()
        errs = [np.linalg.norm((poses[i, j] - poses[i, j, :1]) - (p - p[:1]), axis=-1).mean()
                for i, (_, ps) in enumerate(val_scenes) for j, p in enumerate(ps)]
        if not np.isfinite(poses).all():
            fail(name, 'non-finite poses from the fused serve')
        phase(name, f'the trained package unfolded with fuse_mbconv on, estimate_poses_batched on '
                    f'the {len(images)} held-out scenes\' ground-truth boxes (num_aug {NUM_AUG}, '
                    f'{chunks} chunk(s)): GT-box MPJPE {float(np.mean(errs)):.1f} mm (folded '
                    f'{record["mpjpe_served_gt_boxes"]:.1f}); K1 {k1_fused}, each against the '
                    f'plain warp (max |kernel - plain| {warp_err:.3g}), K2 {k2_fused}, v against '
                    f'the plain chain on the first chunk\'s input to each of the {n_blocks} blocks '
                    f'{err_v:.3g}')
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {'train2serve': (k1, k2), 'serve_train2serve_fused': (k1_fused, k2_fused)}


DEMOS_DIR = 'runs/chip_smoke_demos'
ENCODE_FIXTURES = 'tests/torch_fixtures/jpeg_encode'
VIDEO_FIXTURES = 'tests/torch_fixtures/video'
MP4V_FIXTURES = 'tests/torch_fixtures/mp4v'
H264_FIXTURES = 'tests/torch_fixtures/h264'
H264_SOURCE = 'h264_1080x1920.mp4'  # the fixture whose packets make the H.264 demo inputs
# Packet orders of the H.264 demo inputs: each starts at an IDR picture (0, 12).
H264_DEMO_PACKETS = list(range(14)) + list(range(10))  # demo_video's 24 frames
H264_ASPSET_PACKETS = {'left': list(range(14)) + [0, 1], 'mid': [12, 13] + list(range(14))}
# B slices: the fixtures with their ctts/elst and seek tables, and the clip
# whose closed GOPs (each from an IDR picture) make the B-frame demo inputs,
# repeated whole: demo_video's 24 frames and 16 per ASPset view.
H264_B_FIXTURES = 'tests/torch_fixtures/h264_b'
H264_B_SOURCE = 'h264b_1080x1920.mp4'
H264_B_DEMO_GOPS = (0, 0)
H264_B_ASPSET_GOPS = {'left': (0, 1, 1), 'mid': (1, 0, 1)}
# HEVC: the libx265 fixtures, and the clip whose packets make the HEVC demo
# inputs in the H.264 demo's orders (each starts at an IRAP picture: the IDR
# at 0 or the CRA at 12).
HEVC_FIXTURES = 'tests/torch_fixtures/hevc'
HEVC_SOURCE = 'hevc_1080x1920.mp4'
# HEVC B slices: the fixtures, and the clip whose closed GOPs make the HEVC
# B demo inputs, repeated whole: the IDR picture's (GOP 0, 12 frames) and the
# CRA picture's, which has no leading pictures (GOP 1, 2 frames). A CRA
# picture follows no GOP but an IDR picture's: after another CRA picture's
# its picture order counts would repeat.
HEVC_B_FIXTURES = 'tests/torch_fixtures/hevc_b'
HEVC_B_SOURCE = 'hevcb_1080x1920.mp4'
HEVC_B_DEMO_GOPS = (0, 0)
HEVC_B_ASPSET_GOPS = {'left': (1, 0, 1), 'mid': (1, 0, 1)}
# libde265's chroma is no oracle on this clip's slices (its luma is; cv2's
# RGB holds the chroma).
HEVC_B_DE265_CHROMA_DIFFERS = ('hevcb_tool_slices4.mp4',)
HEVC10_FIXTURES = 'tests/torch_fixtures/hevc10'
# The phone's clip: 1920x1080 Main 10 stored, turned by 90 degrees (demo_video_hevc10).
HEVC10_PHONE = 'hevc10_phone_1920x1080.mov'
HEVC10_STORED = (1920, 1080)  # (width, height) of the phone's frames as coded
# F11 (ROADMAP.md §3): cv2 maps BT.2020 primaries and HLG to other colours,
# the port does not; its RGB is not held to the manifest there.
HEVC10_CV2_MAPS_COLOURS = ('hevc10_tool_bt2020_hlg.mp4',)
ORIENTATION_FIXTURES = 'tests/torch_fixtures/orientation'
# MPEG-4 Advanced Simple: libxvidcore's clips and FFmpeg's encoder's
# interlaced ones; Xvid's usual stream at 1080x1920 as demo_video's AVI
# input, and its Matroska copy as each view of an ASPset layout.
MP4V_ASP_FIXTURES = 'tests/torch_fixtures/mp4v_asp'
MP4V_ASP_DEMO = 'xvid_asp_usual_1080x1920.avi'
MP4V_ASP_VIEW = 'xvid_asp_usual_1080x1920.mkv'
# The B-frame clips whose GOPs make demo inputs: fixtures, clip, codec, and
# the GOPs of demo_video's input and of each ASPset view.
B_SOURCES = {'h264_b': (H264_B_FIXTURES, H264_B_SOURCE, 'h264', H264_B_DEMO_GOPS,
                        H264_B_ASPSET_GOPS),
             'hevc_b': (HEVC_B_FIXTURES, HEVC_B_SOURCE, 'hevc', HEVC_B_DEMO_GOPS,
                        HEVC_B_ASPSET_GOPS)}
# The decoder and the two ways each stream format muxes its fixture's packets
MUXED = {'h264': (H264_FIXTURES, H264_SOURCE, 'avc1', b'V_MPEG4/ISO/AVC'),
         'hevc': (HEVC_FIXTURES, HEVC_SOURCE, 'hvc1', b'V_MPEGH/ISO/HEVC')}
ENCODE_REPEATS = 20  # single-thread encodes of the 1080x1920 frame, median taken
MP4V_FRAMES = 24  # shifted 1080x1920 frames through the mp4v encoder: demo_video's .mp4
MP4V_SHIFT = (3, 4)  # (down, right) pixels per frame, as tests/_torch_mp4v_fixtures.py shifts


def encode_case_image(root: Path, case: dict) -> np.ndarray:
    """The image of an encoder fixture case: uniform noise ('noise', RGB;
    'gray', one channel) or smooth colour waves with noise ('waves') from
    the case's numpy seed, or a JPEG fixture decoded ('fixture')."""
    h, w, source = case['height'], case['width'], case['source']
    if case['kind'] == 'fixture':
        from metrabs_tpu_torch.data import improc
        return improc.imread(str(root / JPEG_FIXTURES / source))
    rng = np.random.default_rng(source)
    if case['kind'] == 'noise':
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if case['kind'] == 'gray':
        return rng.integers(0, 256, (h, w), dtype=np.uint8)
    y, x = np.mgrid[:h, :w].astype(np.float64)
    waves = np.stack([128 + 100 * np.sin(x / 23 + k) * np.cos(y / 17 - k) for k in range(3)], -1)
    return np.clip(waves + rng.normal(0, 8, waves.shape), 0, 255).astype(np.uint8)


DEMO_VIDEO_FRAMES = 24  # 1080x1920 MJPEG .avi frames through demo_video
DEMO_FRAME_BATCH = 8
DEMO_STREAM = 2
ASPSET_VIEWS = ('left', 'mid')
ASPSET_FRAMES = 16  # per view: 1080x1920 mp4v .mkv
ASPSET_BATCH = 8  # predict_aspset's default --batch-size
FRAME_3DPW_SIZE = (1920, 1080)  # rows, columns of the portrait fixture
# A 1080x1920 portrait camera for the minted ASPset views.
K_ASPSET = [[1500.0, 0, 540.0, 0], [0, 1500.0, 960.0, 0], [0, 0, 1, 0]]


# A 3DPW layout for --viz-dir: one sequence, a figure every VIZ_STEP frames.
VIZ_3DPW = dict(sequences=1, frames=8, tracks=2)
VIZ_STEP = 4
# The random weights' poses fail the plausibility filter: the demos' detector
# calls keep them, so that they are drawn.
KEEP_POSES = dict(suppress_implausible_poses=False)


class TimedCalls:
    """Wraps the functions named as (module, name) so that the span of each
    call is kept, until `restore`."""

    def __init__(self, *targets):
        self.originals = [(module, name, getattr(module, name)) for module, name in targets]
        self.spans = {name: [] for _, name in targets}
        for module, name, f in self.originals:
            setattr(module, name, self._timed(f, self.spans[name]))

    @staticmethod
    def _timed(f, spans):
        def timed(*args, **kwargs):
            t = time.perf_counter()
            try:
                return f(*args, **kwargs)
            finally:
                spans.append((t, time.perf_counter()))
        return timed

    def seconds(self, name: str) -> float:
        return union_seconds(self.spans[name])

    def restore(self) -> None:
        for module, name, f in self.originals:
            setattr(module, name, f)


def undrawn(rgb: np.ndarray) -> np.ndarray:
    """A frame as an overlay file would hold it with nothing drawn on it."""
    from metrabs_tpu_torch.data import jpeg
    return jpeg.decode(jpeg.encode(rgb))


def shifted_frames(root: Path, n: int):
    """n RGB frames: the portrait JPEG fixture decoded, shifted 24 px right
    per frame with wraparound, so that every frame differs."""
    from metrabs_tpu_torch.data import improc
    base = improc.imread(str(root / JPEG_FIXTURES / FRAME_3DPW))
    return [np.ascontiguousarray(np.roll(base, 24 * k, axis=1)) for k in range(n)]


def check_encoder(root: Path) -> dict:
    """Every case of the encoder's manifest held to cv2's SHA-256; the
    1080x1920 fixture's encode time on one thread."""
    import hashlib

    from metrabs_tpu_torch.data import improc, jpeg

    cases = json.loads((root / ENCODE_FIXTURES / 'manifest.json').read_text())['cases']
    wrong = [case for case in cases
             if hashlib.sha256(jpeg.encode(encode_case_image(root, case), case['quality']))
             .hexdigest() != case['sha256']]
    if wrong:
        fail('demos', f'{len(wrong)} of {len(cases)} encoder cases differ from cv2.imencode: '
                      + ', '.join(f'{c["kind"]} {c["height"]}x{c["width"]}' for c in wrong))
    rgb = improc.imread(str(root / JPEG_FIXTURES / FRAME_3DPW))
    times = []
    for _ in range(ENCODE_REPEATS):
        t0 = time.perf_counter()
        data = jpeg.encode(rgb)
        times.append(time.perf_counter() - t0)
    return dict(n=len(cases), ms=statistics.median(times) * 1e3,
                all_ms=[t * 1e3 for t in times], kib=len(data) / 1024)


def check_video_fixtures(root: Path) -> dict:
    """Every packet of the cv2-written MJPG fixtures decoded and held to the
    SHA-256 of cv2.imdecode in the manifest; size, frame count and rate to
    cv2's (the NTSC Matroska's rate: cv2 reports FFmpeg's 29.97, the track
    says 1e9 / 33366700 ns)."""
    import hashlib

    from metrabs_tpu_torch.data import improc, video

    manifest = json.loads((root / VIDEO_FIXTURES / 'manifest.json').read_text())
    n_packets = 0
    for name, entry in sorted(manifest.items()):
        path = str(root / VIDEO_FIXTURES / name)
        idx = video.index(path)
        digests = [hashlib.sha256(f.tobytes()).hexdigest() for f in video.iter_frames(path)]
        n_packets += len(digests)
        cv = entry['cv2']
        meta = (improc.video_extents(path).tolist(), improc.num_frames_of_video(path))
        if digests != entry['packet_sha256_rgb'] or meta != ([cv['width'], cv['height']],
                                                           cv['frame_count']):
            fail('demos', f'{name}: frames or metadata differ from cv2 ({idx.n_frames} frames, '
                          f'{meta})')
        if not math.isclose(improc.video_fps(path), cv['fps'], rel_tol=1e-6):
            fail('demos', f'{name}: {improc.video_fps(path)} frames/s, cv2 {cv["fps"]}')
    return dict(files=len(manifest), packets=n_packets)


def mp4v_frames(root: Path, n: int):
    """n RGB frames: the portrait JPEG fixture decoded, shifted MP4V_SHIFT
    pixels per frame with wraparound (the frames of the mp4v fixtures)."""
    from metrabs_tpu_torch.data import improc
    base = improc.imread(str(root / JPEG_FIXTURES / FRAME_3DPW))
    return [np.ascontiguousarray(np.roll(base, (MP4V_SHIFT[0] * k, MP4V_SHIFT[1] * k),
                                         axis=(0, 1))) for k in range(n)]


def check_mp4v_fixtures(root: Path) -> dict:
    """Every cv2-written mp4v fixture through the port's demuxer and
    decoder: each packet, luma plane and RGB frame held to the SHA-256 of
    cv2's in the manifest, size and frame count to cv2's, the rate within
    1e-4 (cv2 reports 30000/1001 as 29.97); the 1080x1920 frames' decode
    (to RGB) timed on one thread."""
    import hashlib

    from metrabs_tpu_torch.data import improc, mpeg4, video

    def sha(data: bytes) -> str:
        return hashlib.sha256(data).hexdigest()

    manifest = json.loads((root / MP4V_FIXTURES / 'manifest.json').read_text())
    n_frames, times = 0, []
    for name, entry in sorted(manifest.items()):
        path = str(root / MP4V_FIXTURES / name)
        idx = video.index(path)
        packets = [idx.packet(i) for i in range(idx.n_frames)]
        decoder = mpeg4.Decoder(idx.config, path)
        lumas, rgbs = [], []
        for packet in packets:
            t = time.perf_counter()
            (rgb, y), = decoder.decode(packet, luma=True)  # no B-VOPs: a frame per packet
            if idx.height == FRAME_3DPW_SIZE[0]:
                times.append(time.perf_counter() - t)
            lumas.append(sha(y.tobytes()))
            rgbs.append(sha(rgb.tobytes()))
        cv = entry['cv2']
        meta = (improc.video_extents(path).tolist(), improc.num_frames_of_video(path))
        wrong = [what for what, got, want in (
            ('packets', [sha(p) for p in packets], entry['packet_sha256']),
            ('luma', lumas, entry['luma_sha256']), ('RGB', rgbs, entry['rgb_sha256']),
            ('metadata', meta, ([cv['width'], cv['height']], cv['frame_count']))) if got != want]
        if wrong or not math.isclose(improc.video_fps(path), cv['fps'], rel_tol=1e-4):
            fail('demos', f'{name}: {", ".join(wrong) or "rate"} differ from cv2\'s '
                          f'({idx.n_frames} frames, {meta}, {improc.video_fps(path)} frames/s)')
        n_frames += len(packets)
    return dict(files=len(manifest), frames=n_frames, ms=statistics.median(times) * 1e3,
                n_timed=len(times))


def check_mp4v_asp_fixtures(root: Path) -> dict:
    """Every MPEG-4 Advanced Simple fixture through the port's demuxer and
    decoder: each packet, key flag, Y/U/V plane (FFmpeg's decoder's) and
    luma plane held to the manifest, the RGB frames to cv2's and every
    imread('#frame=N') to cv2's seek table (on the interlaced clips, which
    cv2 has no picture of, F14: to FFmpeg's decoder's frames through
    libswscale, in its order), size and frame count to cv2's; the 1080x1920
    packets' decode timed on one thread, those that decode a B-VOP
    apart."""
    import hashlib

    from metrabs_tpu_torch.data import improc, video

    def sha(data) -> str:
        return hashlib.sha256(data if isinstance(data, bytes) else data.tobytes()).hexdigest()

    manifest = json.loads((root / MP4V_ASP_FIXTURES / 'manifest.json').read_text())
    n_frames = n_seeks = n_interlaced = 0
    times, b_times = [], []
    for name, entry in sorted(manifest.items()):
        path = str(root / MP4V_ASP_FIXTURES / name)
        idx = video.index(path)
        packets = [idx.packet(i) for i in range(idx.n_frames)]
        decoder = idx.decoder()
        out = []
        for packet in packets:
            b_vops = decoder.stats()['b_vops']
            t = time.perf_counter()
            out += decoder.decode(packet, planes=True)
            dt = time.perf_counter() - t
            if idx.height == FRAME_3DPW_SIZE[0]:
                times.append(dt)
                if decoder.stats()['b_vops'] > b_vops:
                    b_times.append(dt)
        out += decoder.flush(planes=True)
        decoder.close()
        planes = [[sha(p) for p in yuv] for _, yuv in out]
        n_interlaced += not entry['cv2_is_ffmpeg']
        # cv2 has no picture of an interlaced clip (F14): its N-th frame is
        # FFmpeg's decoder's N-th, through swscale (the manifest's rgb_from).
        seek = entry['seek'] or list(range(len(entry['rgb_sha256']))) + [-1]
        seeks_wrong = 0
        for n, want in enumerate(seek):
            n_seeks += 1
            try:
                got = sha(improc.imread(f'{path}#frame={n}'))
                seeks_wrong += want < 0 or got != entry['rgb_sha256'][want]
            except FileNotFoundError:
                seeks_wrong += want >= 0
        cv = entry['cv2']
        meta = (improc.video_extents(path).tolist(), improc.num_frames_of_video(path))
        wrong = [what for what, got, want in (
            ('packets', [sha(p) for p in packets], entry['packet_sha256']),
            ('key flags', idx.keyframes.tolist(), entry['key_frames']),
            ('Y/U/V planes', planes, entry['lavc_sha256']),
            ('luma', [p[0] for p in planes], entry['luma_sha256']),
            ('RGB', [sha(rgb) for rgb, _ in out], entry['rgb_sha256']),
            ('seeks', seeks_wrong, 0),
            ('metadata', meta, ([cv['width'], cv['height']], cv['frame_count']))) if got != want]
        if wrong:
            fail('demos', f'{name}: {", ".join(wrong)} differ from the manifest\'s '
                          f'({idx.n_frames} packets, {len(out)} frames, {meta})')
        n_frames += len(out)
    return dict(files=len(manifest), frames=n_frames, seeks=n_seeks, interlaced=n_interlaced,
                ms=statistics.median(times) * 1e3, n_timed=len(times),
                b_ms=statistics.median(b_times) * 1e3, n_b=len(b_times),
                all_ms=[t * 1e3 for t in times])


def check_h264_fixtures(root: Path) -> dict:
    """Every libx264 fixture through the port's demuxer and H.264 decoder:
    each packet (as FFmpeg's mp4toannexb hands it to cv2), key flag, Y/U/V
    plane (x264's reconstruction), luma plane and RGB frame held to the
    SHA-256 in the manifest, size and frame count to cv2's, the rate within
    1e-4; the 1080x1920 frames' decode (to RGB and planes) timed on one
    thread."""
    import hashlib

    from metrabs_tpu_torch.data import h264, improc, video

    def sha(data: bytes) -> str:
        return hashlib.sha256(data).hexdigest()

    manifest = json.loads((root / H264_FIXTURES / 'manifest.json').read_text())
    n_frames, times = 0, []
    for name, entry in sorted(manifest.items()):
        path = str(root / H264_FIXTURES / name)
        idx = video.index(path)
        packets = [idx.packet(i) for i in range(idx.n_frames)]
        decoder = idx.decoder(0)
        out = []
        for packet in packets:
            t = time.perf_counter()
            out += decoder.decode(packet, planes=True)
            if idx.height == FRAME_3DPW_SIZE[0]:
                times.append(time.perf_counter() - t)
        out += decoder.flush(planes=True)
        decoder.close()
        planes = [[sha(p.tobytes()) for p in yuv] for _, yuv in out]
        lumas = [p[0] for p in planes]
        rgbs = [sha(rgb.tobytes()) for rgb, _ in out]
        cv = entry['cv2']
        meta = (improc.video_extents(path).tolist(), improc.num_frames_of_video(path))
        wrong = [what for what, got, want in (
            ('packets', [sha(h264.annexb(p, idx.config)) for p in packets],
             entry['packet_sha256']),
            ('key frames', idx.keyframes.tolist(), entry['key_frames']),
            ('planes', planes, entry['recon_sha256']), ('luma', lumas, entry['luma_sha256']),
            ('RGB', rgbs, entry['rgb_sha256']),
            ('metadata', meta, ([cv['width'], cv['height']], cv['frame_count']))) if got != want]
        if wrong or not math.isclose(improc.video_fps(path), cv['fps'], rel_tol=1e-4):
            fail('demos', f'{name}: {", ".join(wrong) or "rate"} differ from the manifest\'s '
                          f'({idx.n_frames} frames, {meta}, {improc.video_fps(path)} frames/s)')
        n_frames += len(packets)
    return dict(files=len(manifest), frames=n_frames, ms=statistics.median(times) * 1e3,
                all_ms=[t * 1e3 for t in times], n_timed=len(times))


def check_h264_b_fixtures(root: Path) -> dict:
    """Every libx264 B-frame fixture (tests/torch_fixtures/h264_b: x264's
    medium clips at three sizes, a clip per B-frame option, three edited
    streams) through the port's demuxer and decoder: each packet, key
    flag, luma plane and RGB frame (in output order) held to cv2's SHA-256
    in the manifest, Y/U/V to x264's reconstruction where its luma is
    FFmpeg's, imread('#frame=N') for every N to cv2's seek table, size,
    frame count and rate to cv2's; each packet of the 1080x1920 clip's
    decode (to RGB and planes of what it outputs) timed on one thread."""
    import hashlib

    from metrabs_tpu_torch.data import h264, improc, video

    def sha(data: bytes) -> str:
        return hashlib.sha256(data).hexdigest()

    manifest = json.loads((root / H264_B_FIXTURES / 'manifest.json').read_text())
    n_frames, n_seeks, times = 0, 0, []
    for name, entry in sorted(manifest.items()):
        path = str(root / H264_B_FIXTURES / name)
        idx = video.index(path)
        packets = [idx.packet(i) for i in range(idx.n_frames)]
        decoder = idx.decoder(0)
        out = []
        for packet in packets:
            t = time.perf_counter()
            out += decoder.decode(packet, planes=True)
            if idx.height == FRAME_3DPW_SIZE[0]:
                times.append(time.perf_counter() - t)
        out += decoder.flush(planes=True)
        decoder.close()
        planes = [[sha(p.tobytes()) for p in yuv] for _, yuv in out]
        recon = [want if agree else got  # x264 leaves non-reference B pictures unfiltered
                 for got, want, agree in zip(planes, entry.get('recon_sha256', planes),
                                             entry.get('recon_equals_ffmpeg', [True] * len(out)))]
        seeks = []
        video._STREAMS.clear()
        for n, want in enumerate(entry['seek']):
            try:
                seeks.append(entry['rgb_sha256'].index(
                    sha(improc.imread(f'{path}#frame={n}').tobytes())))
            except FileNotFoundError:
                seeks.append(-1)
            except ValueError:
                seeks.append(-2)
        cv = entry['cv2']
        meta = (improc.video_extents(path).tolist(), improc.num_frames_of_video(path))
        wrong = [what for what, got, want in (
            ('packets', [sha(h264.annexb(p, idx.config)) for p in packets],
             entry['packet_sha256']),
            ('key frames', idx.keyframes.tolist(), entry['key_frames']),
            ('luma', [p[0] for p in planes], entry['luma_sha256']),
            ('planes', planes, recon),
            ('RGB', [sha(rgb.tobytes()) for rgb, _ in out], entry['rgb_sha256']),
            ('seeks', seeks, entry['seek']),
            ('metadata', meta, ([cv['width'], cv['height']], cv['frame_count']))) if got != want]
        if wrong or not math.isclose(improc.video_fps(path), cv['fps'], rel_tol=1e-4):
            fail('demos', f'{name}: {", ".join(wrong) or "rate"} differ from the manifest\'s '
                          f'({idx.n_frames} frames, {meta}, {improc.video_fps(path)} frames/s)')
        n_frames += len(out)
        n_seeks += len(seeks)
    return dict(files=len(manifest), frames=n_frames, seeks=n_seeks,
                ms=statistics.median(times) * 1e3, all_ms=[t * 1e3 for t in times],
                n_timed=len(times))


def check_hevc_fixtures(root: Path, fixtures: str = HEVC_FIXTURES,
                        timed: tuple = (FRAME_3DPW_SIZE[1], FRAME_3DPW_SIZE[0])) -> dict:
    """Every libx265 fixture of `fixtures` (tests/torch_fixtures/hevc: I and
    P slices; hevc_b: B slices, in MP4 with FFmpeg's ctts and elst; hevc10:
    Main 10, I/P and B, with the phone's turned .mov) through the port's
    demuxer and HEVC decoder: each packet (as FFmpeg's hevc_mp4toannexb
    hands it to cv2), key flag, luma plane (8 bits) and RGB frame (in output
    order, turned as displayed; not on HEVC10_CV2_MAPS_COLOURS, F11) held to
    cv2's SHA-256 in the manifest, Y/U/V to libde265's where its luma is
    FFmpeg's (Y only on HEVC_B_DE265_CHROMA_DIFFERS; at 10 bits, where its
    planes are not known wrong, else to the picture's MD5 SEI),
    imread('#frame=N') for every N to cv2's seek table, displayed size and
    frame count to cv2's, the rate within 1e-4, and every decoded-picture
    hash SEI checked: MD5 and checksum on every plane, x265's CRC on luma
    (its chroma CRC covers the last CTU row only); the decode (to RGB and
    planes of what each packet outputs) of the clip stored at `timed`
    (width, height) timed per packet on one thread."""
    import hashlib

    from metrabs_tpu_torch.data import hevc, improc, video

    def sha(data: bytes) -> str:
        return hashlib.sha256(data).hexdigest()

    manifest = json.loads((root / fixtures / 'manifest.json').read_text())
    n_frames, n_seeks, n_hashes, times = 0, 0, 0, []
    for name, entry in sorted(manifest.items()):
        path = str(root / fixtures / name)
        idx = video.index(path)
        packets = [idx.packet(i) for i in range(idx.n_frames)]
        decoder = idx.decoder(0)
        out = []
        for packet in packets:
            t = time.perf_counter()
            out += decoder.decode(packet, planes=True)
            if (idx.width, idx.height) == timed:
                times.append(time.perf_counter() - t)
        out += decoder.flush(planes=True)
        checked, failed = decoder.hashes
        decoder.close()
        n = len(out)
        hash_type = entry['written']['hash_type']
        want_hashes = ((0, 0, 0), (0, 0, 0)) if hash_type is None else (
            (n, n, n), (0, n, n) if hash_type == 1 else (0, 0, 0))
        planes = [[sha(p.tobytes()) for p in yuv] for _, yuv in out]
        chroma = name not in HEVC_B_DE265_CHROMA_DIFFERS
        de265 = [want if agree and chroma else want[:1] + got[1:] if agree else got
                 for got, want, agree in zip(planes, entry['de265_sha256'],
                                             entry.get('de265_equals_ffmpeg', [True] * n))]
        for k, verified in enumerate(entry.get('de265_verified', [])):
            if verified is False:  # libde265 wrong (10 bits): the MD5 SEI judges
                planes[k] = [hashlib.md5(p.tobytes()).hexdigest() for p in out[k][1]]
                de265[k] = entry['sei_md5'][k]
        mapped = name in HEVC10_CV2_MAPS_COLOURS  # F11: no RGB to hold it to
        seeks = []
        video._STREAMS.clear()
        for k in range(len(entry['seek'])):
            try:
                seeks.append(entry['rgb_sha256'].index(
                    sha(improc.imread(f'{path}#frame={k}').tobytes())))
            except FileNotFoundError:
                seeks.append(-1)
            except ValueError:
                seeks.append(-2)
        cv = entry['cv2']
        meta = (improc.video_extents(path).tolist(), improc.num_frames_of_video(path))
        wrong = [what for what, got, want in (
            ('packets', [sha(hevc.annexb(p, idx.config)) for p in packets],
             entry['packet_sha256']),
            ('key frames', idx.keyframes.tolist(), entry['key_frames']),
            ('planes', planes, de265),
            ('luma', [p[0] for p in planes], entry.get('luma_sha256')),  # 8 bits only
            ('RGB', [sha(idx.display(rgb).tobytes()) for rgb, _ in out],
             None if mapped else entry['rgb_sha256']),
            ('seeks', seeks, None if mapped else entry['seek']),
            ('hash SEIs', (checked, failed), want_hashes),
            ('metadata', meta, ([cv['width'], cv['height']], cv['frame_count'])))
            if want is not None and got != want]
        if wrong or not math.isclose(improc.video_fps(path), cv['fps'], rel_tol=1e-4):
            fail('demos', f'{name}: {", ".join(wrong) or "rate"} differ from the manifest\'s '
                          f'({idx.n_frames} frames, {meta}, {improc.video_fps(path)} frames/s, '
                          f'hashes checked {checked} failed {failed})')
        n_frames += n
        n_seeks += len(seeks)
        n_hashes += sum(checked)
    return dict(files=len(manifest), frames=n_frames, seeks=n_seeks, hashes=n_hashes,
                ms=statistics.median(times) * 1e3, all_ms=[t * 1e3 for t in times],
                n_timed=len(times))


def check_orientation_fixtures(root: Path) -> dict:
    """Every turned clip of tests/torch_fixtures/orientation (mp4v, H.264,
    HEVC 8- and 10-bit in MP4 and a phone's QuickTime .mov, each matrix of
    cv2's table in the track header; the movie header's; a Matroska roll):
    the turn, the frames read in order and imread('#frame=N') for every N
    held to cv2's SHA-256 and seek table in the manifest, the displayed size
    (video_extents) to cv2's CAP_PROP_FRAME_WIDTH and HEIGHT."""
    import hashlib

    from metrabs_tpu_torch.data import improc, video

    def sha(a) -> str:
        return hashlib.sha256(a.tobytes()).hexdigest()

    manifest = json.loads((root / ORIENTATION_FIXTURES / 'manifest.json').read_text())
    turns = collections.Counter()
    n_frames = 0
    for name, entry in sorted(manifest.items()):
        path = str(root / ORIENTATION_FIXTURES / name)
        idx = video.index(path)
        frames = [sha(f) for f in video.iter_frames(path)]
        video._STREAMS.clear()
        seeks = []
        for k in range(len(entry['seek'])):
            try:
                seeks.append(entry['rgb_sha256'].index(sha(improc.imread(f'{path}#frame={k}'))))
            except FileNotFoundError:
                seeks.append(-1)
            except ValueError:
                seeks.append(-2)
        extents = improc.video_extents(path).tolist()
        cv = entry['cv2']
        if (idx.rotation != entry['turn'] or frames != entry['rgb_sha256']
                or seeks != entry['seek'] or extents != [cv['width'], cv['height']]):
            fail('demos', f'{name}: turn {idx.rotation} (cv2 {entry["turn"]}), '
                          f'{sum(a != b for a, b in zip(frames, entry["rgb_sha256"]))} frames '
                          f'unlike cv2\'s, seeks {seeks} (cv2 {entry["seek"]}), extents {extents} '
                          f'(cv2 {[cv["width"], cv["height"]]})')
        turns[idx.rotation] += 1
        n_frames += len(frames)
    return dict(files=len(manifest), frames=n_frames, turns=dict(sorted(turns.items())))


def mux_packets(root: Path, path: Path, order, codec: str = 'h264') -> list:
    """The 1080x1920 H.264 or HEVC fixture's packets (MUXED[codec]) in
    `order` muxed by the port into `path` (.mp4 or .mkv, 25 frames/s);
    returns the manifest's RGB SHA-256 of each frame."""
    from metrabs_tpu_torch.data import mp4, video

    fixtures, source, entry, codec_id = MUXED[codec]
    src = video.index(str(root / fixtures / source))
    want = json.loads((root / fixtures / 'manifest.json').read_text())[source]
    with open(path, 'wb') as f:
        if path.suffix == '.mkv':
            mux = video._MatroskaMuxer(f, src.width, src.height, 25.0, codec_id, src.config)
        else:
            mux = mp4.Mp4Muxer(f, src.width, src.height, 25, 1, src.config, codec=entry)
        for i in order:
            mux.write(src.packet(i), bool(src.keyframes[i]))
        mux.close()
    return [want['rgb_sha256'][i] for i in order]


def mux_b_gops(root: Path, path: Path, gops, source: str = 'h264_b') -> list:
    """The closed GOPs (numbered from 0, each from a key frame) of a
    1080x1920 B-frame fixture (B_SOURCES[source]), whole and in the order
    `gops`, muxed into `path` as tests/_torch_h264_fixtures.py writes its
    clips: .mp4 with FFmpeg's ctts and elst, .mkv with presentation
    timestamps. Returns the manifest's RGB SHA-256 of each frame in output
    order."""
    from metrabs_tpu_torch.data import h264, hevc, video

    if str(root / 'tests') not in sys.path:
        sys.path.insert(0, str(root / 'tests'))
    from _torch_h264_fixtures import write_container

    fixtures, clip, codec = B_SOURCES[source][:3]
    module = {'h264': h264, 'hevc': hevc}[codec]
    src = video.index(str(root / fixtures / clip))
    entry = json.loads((root / fixtures / 'manifest.json').read_text())[clip]
    starts = [int(k) for k in np.flatnonzero(src.keyframes)] + [src.n_frames]
    packets, keys, times, want = [], [], [], []
    for g in gops:
        first, end = starts[g], starts[g + 1]
        shift = len(packets) - first  # frames before this GOP in the output, less its own start
        for i in range(first, end):
            packets.append(module.annexb(src.packet(i), src.config))
            keys.append(bool(src.keyframes[i]))
            pts, dts = entry['written']['times'][i]
            times.append((pts + shift, dts + shift))
        want += entry['rgb_sha256'][first:end]
    write_container(path, packets, keys, (src.width, src.height), entry['written']['fps'],
                    codec, times=times)
    return want


def check_mp4v_encoder(root: Path, path: Path) -> dict:
    """The mp4v encoder on MP4V_FRAMES shifted 1080x1920 frames into an MP4
    file (each `write` timed on one thread), then read back: every luma
    plane equal to the encoder's reconstruction (each decode timed), PSNR
    over RGB against the frames, bytes per frame."""
    from metrabs_tpu_torch.data import mpeg4, video

    frames = mp4v_frames(root, MP4V_FRAMES)
    recon, enc_times = [], []
    with video.VideoWriter(str(path), 25.0, (FRAME_3DPW_SIZE[1], FRAME_3DPW_SIZE[0]),
                           'mp4v') as writer:
        for frame in frames:
            t = time.perf_counter()
            writer.write(frame)
            enc_times.append(time.perf_counter() - t)
            recon.append(writer.encoder.reconstruction()[0])
    idx = video.index(str(path))
    decoder = mpeg4.Decoder(idx.config, str(path))
    dec_times, mse, exact = [], [], 0
    with open(path, 'rb') as f:
        for i in range(idx.n_frames):
            packet = idx.packet(i, f)
            t = time.perf_counter()
            (rgb, y), = decoder.decode(packet, luma=True)  # no B-VOPs: a frame per packet
            dec_times.append(time.perf_counter() - t)
            exact += int(np.array_equal(y, recon[i]))
            mse.append(np.mean((rgb.astype(np.float64) - frames[i]) ** 2))
    if idx.n_frames != MP4V_FRAMES or exact != MP4V_FRAMES or list(
            np.flatnonzero(idx.keyframes)) != [0, 12]:
        fail('demos', f'mp4v round trip: {idx.n_frames} frames, {exact} luma planes equal to '
                      f'the reconstruction, key frames {np.flatnonzero(idx.keyframes)}')
    return dict(enc_ms=statistics.median(enc_times) * 1e3,
                dec_ms=statistics.median(dec_times) * 1e3,
                kib=float(np.sum(idx.sizes)) / idx.n_frames / 1024,
                psnr=float(np.mean([10 * np.log10(255.0 ** 2 / m) for m in mse])))


def mint_aspset_layout(root: Path, work: Path, codec: str = 'mp4v') -> dict:
    """ASPset-510's layout with one subject and ASPSET_VIEWS: splits.csv, a
    box CSV per clip (a person box moving with the frame's shift), a camera
    JSON per view and 1080x1920 .mkv clips of ASPSET_FRAMES frames: mp4v (as
    JAX's test writes them) written by the port's own writer, or H.264 or
    HEVC muxed from the fixture's packets ('h264', 'hevc':
    H264_ASPSET_PACKETS; 'h264_b', 'hevc_b': the B-frame fixture's GOPs,
    B_SOURCES), or copies of MP4V_ASP_VIEW, all its frames ('mp4v_asp').
    Returns the manifest's RGB SHA-256 of each frame by clip path (H.264,
    HEVC, mp4v_asp)."""
    from metrabs_tpu_torch.data import video

    subj, vid = '01', '0001'
    work.mkdir(parents=True, exist_ok=True)
    (work / 'splits.csv').write_text('subject,video,view,split\n' + ''.join(
        f'{subj},{vid},{view},test\n' for view in ASPSET_VIEWS))
    frames = shifted_frames(root, ASPSET_FRAMES) if codec == 'mp4v' else []
    n_frames, asp_want = ASPSET_FRAMES, None
    if codec == 'mp4v_asp':
        asp_want = json.loads((root / MP4V_ASP_FIXTURES / 'manifest.json').read_text())[
            MP4V_ASP_VIEW]['rgb_sha256']
        n_frames = len(asp_want)
    want = {}
    for i_view, view in enumerate(ASPSET_VIEWS):
        for d in ('boxes', 'cameras', 'videos'):
            (work / 'test' / d / subj).mkdir(parents=True, exist_ok=True)
        lines = ['x1,y1,x2,y2'] + [f'{300 + 10 * k + 40 * i_view},400,{700 + 10 * k},1500'
                                   for k in range(n_frames)]
        (work / 'test' / 'boxes' / subj / f'{subj}-{vid}-{view}.csv').write_text(
            '\n'.join(lines) + '\n')
        (work / 'test' / 'cameras' / subj / f'{subj}-{view}.json').write_text(
            json.dumps(dict(intrinsic_matrix=K_ASPSET)))
        clip = work / 'test' / 'videos' / subj / f'{subj}-{vid}-{view}.mkv'
        if codec in MUXED:
            want[str(clip)] = mux_packets(root, clip, H264_ASPSET_PACKETS[view], codec)
            continue
        if codec in B_SOURCES:
            want[str(clip)] = mux_b_gops(root, clip, B_SOURCES[codec][4][view], codec)
            continue
        if codec == 'mp4v_asp':
            shutil.copy(root / MP4V_ASP_FIXTURES / MP4V_ASP_VIEW, clip)
            want[str(clip)] = asp_want
            continue
        with video.VideoWriter(str(clip), 50.0, (FRAME_3DPW_SIZE[1], FRAME_3DPW_SIZE[0]),
                               'mp4v') as writer:
            for frame in frames[i_view:] + frames[:i_view]:
                writer.write(frame)
    return want



def demo_timing(r: dict, n: int) -> str:
    return (f'{n} frames in {r["seconds"]:.2f} s = {n / r["seconds"]:.2f} frames/s end to end, '
            f'{n / r["run_s"]:.2f} frames/s without loading the package ({r["load_s"]:.2f} s); '
            f'decoding {r["decode_s"]:.2f} s ({100 * r["decode_s"] / r["seconds"]:.1f}% of the '
            f'wall), drawing {r["draw_s"]:.2f} s ({100 * r["draw_s"] / r["seconds"]:.1f}%), '
            f'encoding {r["encode_s"]:.2f} s ({100 * r["encode_s"] / r["seconds"]:.1f}%)')


def demos_phase(root: Path, dev) -> dict:
    """The [demos] phase (module docstring). Returns the K1 and K2 launches
    of the demo_image, demo_video (as is and with --stream) and
    predict_aspset runs."""
    import hashlib

    from metrabs_tpu_torch.apps import demo_image, demo_video, predict_3dpw, predict_aspset
    from metrabs_tpu_torch.data import improc, mpeg4, video
    from metrabs_tpu_torch.models.backbones.builder import build_backbone
    from metrabs_tpu_torch.pipeline.skeletons import H36M_17, SMPL_24
    from metrabs_tpu_torch.utils import viz

    name = 'demos'
    enc = check_encoder(root)
    phase(name, f'JPEG encoder (host C++): all {enc["n"]} cases equal their cv2.imencode '
                f'hashes; {FRAME_3DPW} ({enc["kib"]:.0f} KiB at quality 95): '
                f'{enc["ms"]:.2f} ms median of {ENCODE_REPEATS} on one thread (all: '
                + ', '.join(f'{t:.1f}' for t in enc['all_ms']) + ')')
    vid = check_video_fixtures(root)
    phase(name, f'video reader: {vid["files"]} cv2-written MJPG files (AVI and Matroska), all '
                f'{vid["packets"]} packets equal their cv2.imdecode hashes, sizes, counts and '
                f'rates equal cv2\'s')
    mp4v = check_mp4v_fixtures(root)
    phase(name, f'mp4v decoder (host C++): {mp4v["files"]} cv2-written files (MP4, AVI and '
                f'Matroska), all {mp4v["frames"]} frames\' packets, luma planes and RGB frames '
                f'equal their cv2 hashes, sizes, counts and rates cv2\'s; 1080x1920 decode to '
                f'RGB {mp4v["ms"]:.2f} ms per frame on one thread (median of {mp4v["n_timed"]})')

    avc = check_h264_fixtures(root)
    phase(name, f'H.264 decoder (host C++): {avc["files"]} libx264 files (MP4, Matroska and AVI; '
                f'the per-tool and VUI clips), all {avc["frames"]} frames\' packets, key flags, '
                f'Y/U/V planes, luma planes and RGB frames equal their manifest hashes, sizes, '
                f'counts and rates cv2\'s; 1080x1920 decode to RGB and planes '
                f'{avc["ms"]:.2f} ms per frame on one thread (median of {avc["n_timed"]}; all: '
                + ', '.join(f'{t:.1f}' for t in avc['all_ms']) + f') on {card_name()}')
    avc_b = check_h264_b_fixtures(root)
    phase(name, f'H.264 decoder, B slices: {avc_b["files"]} libx264 files (x264\'s medium '
                f'B-frame defaults in MP4 with ctts and elst, Matroska and AVI; a clip per '
                f'B-frame option; explicit bi-weights, direct_8x8_inference 0 and no '
                f'bitstream_restriction edited in), all {avc_b["frames"]} frames\' packets, key '
                f'flags, luma planes and RGB frames (output order) equal their cv2 hashes, Y/U/V '
                f'x264\'s where its luma is FFmpeg\'s, all {avc_b["seeks"]} imread(#frame=N) '
                f'equal cv2\'s seek table, sizes, counts and rates cv2\'s; 1080x1920 B-stream '
                f'decode {avc_b["ms"]:.2f} ms per packet on one thread (median of '
                f'{avc_b["n_timed"]}; all: ' + ', '.join(f'{t:.1f}' for t in avc_b['all_ms'])
                + f') on {card_name()}')
    hevc_fx = check_hevc_fixtures(root)
    phase(name, f'HEVC decoder (host C++): {hevc_fx["files"]} libx265 files (MP4 hvc1 and hev1, '
                f'Matroska and AVI; a clip per coding tool), all {hevc_fx["frames"]} frames\' '
                f'packets, key flags, Y/U/V planes (libde265\'s), luma planes and RGB frames '
                f'equal their manifest hashes, all {hevc_fx["seeks"]} imread(#frame=N) equal '
                f'cv2\'s seek table, sizes, counts and rates cv2\'s, {hevc_fx["hashes"]} plane '
                f'hashes of the decoded-picture hash SEIs checked; 1080x1920 decode to RGB and '
                f'planes {hevc_fx["ms"]:.2f} ms per frame on one thread (median of '
                f'{hevc_fx["n_timed"]}; all: ' + ', '.join(f'{t:.1f}' for t in hevc_fx['all_ms'])
                + f') on {card_name()}')
    hevc_b_fx = check_hevc_fixtures(root, HEVC_B_FIXTURES)
    phase(name, f'HEVC decoder, B slices: {hevc_b_fx["files"]} libx265 files (x265\'s medium '
                f'B-frame defaults in MP4 with ctts and elst, Matroska and AVI; a clip per '
                f'B-frame option; collocated_from_l0_flag 1 edited in), all '
                f'{hevc_b_fx["frames"]} frames\' packets, key flags, luma planes and RGB frames '
                f'(output order) equal their cv2 hashes, Y/U/V libde265\'s where its luma is '
                f'FFmpeg\'s, all {hevc_b_fx["seeks"]} imread(#frame=N) equal cv2\'s seek table, '
                f'sizes, counts and rates cv2\'s, {hevc_b_fx["hashes"]} plane hashes of the '
                f'decoded-picture hash SEIs checked; 1080x1920 B-stream decode '
                f'{hevc_b_fx["ms"]:.2f} ms per packet on one thread (median of '
                f'{hevc_b_fx["n_timed"]}; all: '
                + ', '.join(f'{t:.1f}' for t in hevc_b_fx['all_ms'])
                + f'), I/P {hevc_fx["ms"]:.2f} ms in this run, on {card_name()}')
    hevc10_fx = check_hevc_fixtures(root, HEVC10_FIXTURES, HEVC10_STORED)
    phase(name, f'HEVC decoder, Main 10: {hevc10_fx["files"]} files of x265\'s 10-bit API (96x66 '
                f'and 320x568 with and without B slices in MP4, a phone\'s QuickTime .mov, '
                f'Matroska and AVI; a clip per tool; {HEVC10_PHONE}, turned by 90 degrees), all '
                f'{hevc10_fx["frames"]} frames\' packets, key flags and 16-bit Y/U/V planes equal '
                f'their manifest hashes (libde265\'s, or the picture\'s MD5 SEI where libde265\'s '
                f'are wrong), RGB frames as displayed cv2\'s (but on '
                f'{", ".join(HEVC10_CV2_MAPS_COLOURS)}, fault F11), all {hevc10_fx["seeks"]} '
                f'imread(#frame=N) cv2\'s seek table, displayed sizes, counts and rates cv2\'s, '
                f'{hevc10_fx["hashes"]} plane hashes of the decoded-picture hash SEIs checked over '
                f'two bytes per sample; 1920x1080 Main 10 decode to RGB and planes '
                f'{hevc10_fx["ms"]:.2f} ms per packet on one thread (median of '
                f'{hevc10_fx["n_timed"]}; all: ' + ', '.join(f'{t:.1f}' for t in hevc10_fx['all_ms'])
                + f'), 8-bit I/P {hevc_fx["ms"]:.2f} ms in this run, on {card_name()}')
    turned = check_orientation_fixtures(root)
    phase(name, f'display rotation (F10): {turned["files"]} turned clips (mp4v, H.264, HEVC 8- '
                f'and 10-bit in MP4 and QuickTime .mov; movie-header and Matroska-roll cases), '
                f'turns {turned["turns"]} equal cv2\'s, all {turned["frames"]} frames, every '
                f'imread(#frame=N) and the displayed sizes cv2\'s')
    asp = check_mp4v_asp_fixtures(root)
    phase(name, f'mp4v decoder, Advanced Simple: {asp["files"]} files (libxvidcore\'s B-VOPs in '
                f'open and closed GOPs, packed, MPEG quantisation with default and custom '
                f'matrices, quarter-pel with 4MV, GMC, interlaced; FFmpeg\'s encoder\'s field '
                f'vectors; Xvid\'s usual stream of them all at 96x66, 320x568 and 1080x1920 in '
                f'AVI and Matroska; B-VOPs in MP4 with ctts), all {asp["frames"]} frames\' '
                f'packets, key flags, Y/U/V planes (FFmpeg\'s decoder\'s) and luma planes equal '
                f'their manifest hashes, RGB frames and all {asp["seeks"]} imread(#frame=N) '
                f'cv2\'s (on the {asp["interlaced"]} interlaced clips, which cv2 has no picture of, '
                f'F14: FFmpeg\'s decoder\'s through libswscale), sizes and counts cv2\'s; 1080x1920 '
                f'decode of Xvid\'s usual stream {asp["ms"]:.2f} ms per packet on one thread '
                f'(median of {asp["n_timed"]}), {asp["b_ms"]:.2f} ms per packet that decodes a '
                f'B-VOP (median of {asp["n_b"]}; all: '
                + ', '.join(f'{t:.1f}' for t in asp['all_ms']) + f') on {card_name()}')

    work = root / DEMOS_DIR
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    mp4v_src = work / 'in.mp4'
    enc = check_mp4v_encoder(root, mp4v_src)
    phase(name, f'mp4v encoder (host C++, GOP 12, qscale 3): {MP4V_FRAMES} shifted 1080x1920 '
                f'frames into {mp4v_src.name}: encode {enc["enc_ms"]:.2f} ms per frame, decode '
                f'{enc["dec_ms"]:.2f} ms (medians, one thread), {enc["kib"]:.1f} KiB per frame, '
                f'{enc["psnr"]:.2f} dB PSNR over RGB; every luma plane read back equal to the '
                f'encoder\'s reconstruction')
    gen = torch.Generator().manual_seed(SEED + 17)
    drivers = DriverRuns()
    try:
        t0 = time.perf_counter()
        bench_package(work / 'pkg', gen, H36M_17, with_detector=True)
        src = work / 'in.avi'
        with video.VideoWriter(str(src), 25.0, (FRAME_3DPW_SIZE[1], FRAME_3DPW_SIZE[0])) as w:
            for frame in shifted_frames(root, DEMO_VIDEO_FRAMES):
                w.write(frame)
        mint_aspset_layout(root, work / 'aspset')
        h264_src = work / 'in_h264.mp4'
        h264_want = mux_packets(root, h264_src, H264_DEMO_PACKETS)
        mint_aspset_layout(root, work / 'aspset_h264', 'h264')
        h264b_src = work / 'in_h264_b.mp4'
        h264b_want = mux_b_gops(root, h264b_src, H264_B_DEMO_GOPS)
        aspset_b_want = mint_aspset_layout(root, work / 'aspset_h264_b', 'h264_b')
        hevc_src = work / 'in_hevc.mp4'
        hevc_want = mux_packets(root, hevc_src, H264_DEMO_PACKETS, 'hevc')
        aspset_hevc_want = mint_aspset_layout(root, work / 'aspset_hevc', 'hevc')
        hevcb_src = work / 'in_hevc_b.mp4'
        hevcb_want = mux_b_gops(root, hevcb_src, HEVC_B_DEMO_GOPS, 'hevc_b')
        aspset_hevc_b_want = mint_aspset_layout(root, work / 'aspset_hevc_b', 'hevc_b')
        aspset_asp_want = mint_aspset_layout(root, work / 'aspset_mp4v_asp', 'mp4v_asp')
        phase(name, f'minted in {time.perf_counter() - t0:.1f} s: {IMPORT_MODEL} on H36M-17 '
                    f'with a firing YOLOv4-{DETECTOR_SIZE}; a {DEMO_VIDEO_FRAMES}-frame '
                    f'1080x1920 MJPEG .avi and an ASPset layout of {len(ASPSET_VIEWS)} views x '
                    f'{ASPSET_FRAMES} frames of 1080x1920 mp4v .mkv, written by the port; a '
                    f'{len(H264_DEMO_PACKETS)}-frame 1080x1920 H.264 .mp4 and an ASPset layout '
                    f'of {len(ASPSET_VIEWS)} views x {ASPSET_FRAMES} frames of H.264 .mkv, '
                    f'muxed by the port from {H264_SOURCE}\'s packets; a {len(h264b_want)}-frame '
                    f'1080x1920 B-frame H.264 .mp4 (ctts, elst) and an ASPset layout of B-frame '
                    f'.mkv views, whole closed GOPs of {H264_B_SOURCE}; a {len(hevc_want)}-frame '
                    f'1080x1920 HEVC .mp4 (hvc1) and an ASPset layout of HEVC .mkv views, muxed '
                    f'by the port from {HEVC_SOURCE}\'s packets; a {len(hevcb_want)}-frame '
                    f'1080x1920 B-frame HEVC .mp4 (ctts, elst) and an ASPset layout of B-frame '
                    f'HEVC .mkv views, whole closed GOPs of {HEVC_B_SOURCE}; an ASPset layout '
                    f'whose views are {MP4V_ASP_VIEW}')

        # demo_image on the 1080x1920 JPEG fixture: every K1 launch against
        # the plain warp; the overlay JPEG and the 3D scene PNG read back, the
        # overlay unlike the frame written with nothing drawn.
        image_path = str(root / JPEG_FIXTURES / FRAME_3DPW)
        drawing = TimedCalls((demo_image, 'draw_poses'), (viz, 'plot_poses_3d'))
        try:
            r, warp_errs = checked_warps(lambda: drivers.run(
                drivers.loader('detect_poses_batched', call_kwargs=KEEP_POSES), demo_image.main, [
                    '--image', image_path, '--package', str(work / 'pkg'),
                    '--out', str(work / 'overlay.jpg'), '--out-3d', str(work / 'scene.png')]))
        finally:
            drawing.restore()
        line = json.loads([t for t in r['printed'].splitlines() if t.startswith('{')][-1])
        overlay, scene = improc.imread(str(work / 'overlay.jpg')), improc.imread(
            str(work / 'scene.png'))
        warp_err = max(warp_errs, default=math.inf)
        if (r['k1'] == 0 or r['k2'] != 0 or len(warp_errs) != r['k1'] or not warp_err <= WARP_TOL
                or overlay.shape != (*FRAME_3DPW_SIZE, 3) or scene.ndim != 3
                or line['poses3d_shape'][1:] != [17, 3] or line['n_poses'] == 0
                or np.array_equal(overlay, undrawn(improc.imread(image_path)))):
            fail(name, f'demo_image: K1 {r["k1"]} ({len(warp_errs)} compared, max |kernel - '
                       f'plain| {warp_err:.3g}), K2 {r["k2"]}, overlay {overlay.shape} (unlike '
                       f'the undrawn frame: poses must be drawn), scene {scene.shape}, {line}')
        phase(name, f'demo_image (num_aug 5, folded): {line["n_poses"]} poses in '
                    f'{r["seconds"]:.2f} s ({r["run_s"]:.2f} s without loading the package); K1 '
                    f'{r["k1"]}, each against the plain warp (max |kernel - plain| '
                    f'{warp_err:.3g}, tol {WARP_TOL}), K2 {r["k2"]}; overlay {overlay.shape} with '
                    f'the poses drawn ({drawing.seconds("draw_poses") * 1e3:.1f} ms), 3D scene '
                    f'{scene.shape} ({drawing.seconds("plot_poses_3d") * 1e3:.1f} ms); encoding '
                    f'{r["encode_s"] * 1e3:.1f} ms, decoding {r["decode_s"] * 1e3:.1f} ms')
        launches = {'demo_image': (r['k1'], r['k2'])}
        del r

        # demo_video on the MJPEG .avi as is and with --stream, writing .mkv,
        # and on the mp4v .mp4, writing .mp4; each overlay video read back.
        for key, source, out, extra in (
                ('demo_video', src, work / 'demo_video.mkv', []),
                ('demo_video_stream', src, work / 'demo_video_stream.mkv',
                 ['--stream', str(DEMO_STREAM)]),
                ('demo_video_mp4v', mp4v_src, work / 'demo_video_mp4v.mp4', []),
                ('demo_video_h264', h264_src, work / 'demo_video_h264.mp4', [])):
            drawing = TimedCalls((demo_image, 'draw_poses'))
            try:
                r = drivers.run(drivers.loader('detect_poses_batched', call_kwargs=KEEP_POSES),
                                demo_video.main, [
                    '--video', str(source), '--package', str(work / 'pkg'), '--out', str(out),
                    '--frame-batch', str(DEMO_FRAME_BATCH)] + extra)
            finally:
                drawing.restore()
            r['draw_s'] = drawing.seconds('draw_poses')
            result = json.loads(r['last'])
            n_batches = DEMO_VIDEO_FRAMES // DEMO_FRAME_BATCH
            if extra:  # the last stream call is padded to DEMO_STREAM batches
                n_batches = math.ceil(n_batches / DEMO_STREAM) * DEMO_STREAM
            back = video.index(str(out))
            first = improc.imread(f'{out}#frame=0')
            # The overlay (mp4v, as JAX's demo writes) has poses drawn: its
            # first frame, an I-VOP, is unlike the same frame encoded undrawn.
            mp4v_run, h264_run = key == 'demo_video_mp4v', key == 'demo_video_h264'
            encoder = mpeg4.Encoder(back.width, back.height, back.fps)
            packet, _ = encoder.encode(video.read_frame(str(source), 0))
            drawn = None if np.array_equal(
                first, mpeg4.Decoder(encoder.config).decode(packet)[0]) else 0
            if (result['frames'] != DEMO_VIDEO_FRAMES or back.n_frames != DEMO_VIDEO_FRAMES
                    or result['total_poses'] == 0 or drawn is None
                    or (back.width, back.height) != (FRAME_3DPW_SIZE[1], FRAME_3DPW_SIZE[0])
                    or first.shape != (*FRAME_3DPW_SIZE, 3) or len(r['calls']) != n_batches
                    or r['k1'] < n_batches or r['k2'] != 0 or back.kind != 'mp4v'
                    or r['mp4v_decodes'] != (DEMO_VIDEO_FRAMES if mp4v_run else 0)
                    or r['h264_decodes'] != (DEMO_VIDEO_FRAMES if h264_run else 0)):
                fail(name, f'{key}: {result}, {back.n_frames} {back.codec} frames of {back.width}x'
                           f'{back.height} read back (first with a pose drawn: {drawn}), '
                           f'{len(r["calls"])} batched calls, K1 {r["k1"]}, K2 {r["k2"]}, '
                           f'{r["mp4v_decodes"]} mp4v and {r["h264_decodes"]} H.264 frames '
                           f'decoded')
            checked_line = ''
            if h264_run:
                # The input's frames, as the demo read them, are the manifest's;
                # the run again with every K1 launch against the plain warp.
                got = [hashlib.sha256(f.tobytes()).hexdigest()
                       for f in video.iter_frames(str(source))]
                if got != h264_want:
                    fail(name, f'{key}: {sum(a != b for a, b in zip(got, h264_want))} of '
                               f'{len(h264_want)} input frames differ from the manifest')
                checked, warp_errs = checked_warps(lambda: drivers.run(
                    drivers.loader('detect_poses_batched', call_kwargs=KEEP_POSES),
                    demo_video.main, ['--video', str(source), '--package', str(work / 'pkg'),
                                      '--frame-batch', str(DEMO_FRAME_BATCH)]))
                warp_err = max(warp_errs, default=math.inf)
                if (len(warp_errs) != checked['k1'] or checked['k1'] != r['k1']
                        or not warp_err <= WARP_TOL or checked['k2'] != 0):
                    fail(name, f'{key} checked: {len(warp_errs)} of {checked["k1"]} K1 launches '
                               f'compared (max |kernel - plain| {warp_err:.3g}), K2 '
                               f'{checked["k2"]}')
                checked_line = (f'; run again with every launch checked: K1 {len(warp_errs)} '
                                f'against the plain warp (max |kernel - plain| {warp_err:.3g})')
                del checked
            phase(name, f'{key} {" ".join(extra)} ({source.name}, frame batch '
                        f'{DEMO_FRAME_BATCH}, num_aug 2, folded; {result["total_poses"]} poses): '
                        + demo_timing(r, DEMO_VIDEO_FRAMES) + f'; K1 {r["k1"]}, K2 {r["k2"]}; '
                        f'{r["mp4v_decodes"]} mp4v and {r["h264_decodes"]} H.264 frames decoded '
                        f'({(r["mp4v_decodes"] + r["h264_decodes"]) / DEMO_VIDEO_FRAMES:g} per '
                        f'frame read); the overlay {out.suffix} read back: {back.n_frames} '
                        f'{back.codec} frames of {back.width}x{back.height}, poses drawn from '
                        f'frame {drawn} on' + checked_line)
            launches[key] = (r['k1'], r['k2'])
            if key == 'demo_video':
                # One batch again: each K1 launch against the plain warp, then profiled.
                est = r['est']
                frames, args, kwargs, _ = r['calls'][0]
                _, warp_errs = checked_warps(lambda: est.detect_poses_batched(
                    frames, *args, **kwargs))
                warp_err = max(warp_errs, default=math.inf)
                if not warp_errs or not warp_err <= WARP_TOL:
                    fail(name, f'one demo_video batch: {len(warp_errs)} K1 launches compared, '
                               f'max |kernel - plain| {warp_err:.3g} (tol {WARP_TOL})')
                wall_ms, device_ms, _, busy_ms, n_kernels, _ = profile_detect(
                    est, lambda: est.detect_poses_batched(frames, *args, **kwargs))
                phase(name, f'one demo_video batch ({len(frames)} frames): K1 '
                            f'{len(warp_errs)}, each against the plain warp (max |kernel - '
                            f'plain| {warp_err:.3g}); under torch.profiler: wall {wall_ms:.1f} '
                            f'ms, device busy {busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%), '
                            f'{n_kernels} kernels, K1 {device_ms["K1 (warp kernel)"]:.3f} ms, '
                            f'crop model {device_ms["crop_model"]:.2f} ms, detector '
                            f'{device_ms["detector"]:.2f} ms')
                del est, frames
            del r

        # demo_video on the B-frame .mp4 (ctts and elst): every K1 launch
        # against the plain warp, every input frame the manifest's, each
        # picture decoded once.
        key = 'demo_video_h264_b'
        r, warp_errs = checked_warps(lambda: drivers.run(
            drivers.loader('detect_poses_batched', call_kwargs=KEEP_POSES), demo_video.main, [
                '--video', str(h264b_src), '--package', str(work / 'pkg'),
                '--out', str(work / f'{key}.mp4'), '--frame-batch', str(DEMO_FRAME_BATCH)]))
        result = json.loads(r['last'])
        back = video.index(str(work / f'{key}.mp4'))
        got = [hashlib.sha256(f.tobytes()).hexdigest() for f in video.iter_frames(str(h264b_src))]
        n_b = len(h264b_want)
        warp_err = max(warp_errs, default=math.inf)
        if (result['frames'] != n_b or back.n_frames != n_b or got != h264b_want
                or result['total_poses'] == 0 or len(r['calls']) != n_b // DEMO_FRAME_BATCH
                or r['k1'] < n_b // DEMO_FRAME_BATCH or len(warp_errs) != r['k1']
                or not warp_err <= WARP_TOL or r['k2'] != 0 or r['h264_decodes'] != n_b
                or r['mp4v_decodes'] != 0):
            fail(name, f'{key}: {result}, {back.n_frames} frames read back, '
                       f'{sum(a != b for a, b in zip(got, h264b_want))} of {n_b} input frames '
                       f'unlike the manifest, {len(r["calls"])} batched calls, K1 {r["k1"]} '
                       f'({len(warp_errs)} compared, max |kernel - plain| {warp_err:.3g}), K2 '
                       f'{r["k2"]}, {r["h264_decodes"]} H.264 pictures decoded')
        phase(name, f'{key} ({h264b_src.name}, {n_b} frames of B-frame H.264 with ctts and elst, '
                    f'frame batch {DEMO_FRAME_BATCH}, num_aug 2, folded; {result["total_poses"]} '
                    f'poses): every input frame equal to the manifest (cv2\'s), '
                    f'{r["h264_decodes"]} pictures decoded ({r["h264_decodes"] / n_b:g} per frame '
                    f'read); K1 {r["k1"]}, each against the plain warp (max |kernel - plain| '
                    f'{warp_err:.3g}), K2 {r["k2"]}; with the checks: {r["seconds"]:.2f} s, '
                    f'decoding {r["decode_s"]:.2f} s')
        launches[key] = (r['k1'], r['k2'])
        del r

        # demo_video on the HEVC .mp4 (I and P slices) and on the HEVC B-frame
        # .mp4 (ctts, elst): every K1 launch against the plain warp, every
        # input frame the manifest's, each picture decoded once.
        for key, hevc_in, hevc_in_want, what in (
                ('demo_video_hevc', hevc_src, hevc_want, 'HEVC'),
                ('demo_video_hevc_b', hevcb_src, hevcb_want, 'B-frame HEVC with ctts and elst')):
            r, warp_errs = checked_warps(lambda: drivers.run(
                drivers.loader('detect_poses_batched', call_kwargs=KEEP_POSES), demo_video.main, [
                    '--video', str(hevc_in), '--package', str(work / 'pkg'),
                    '--out', str(work / f'{key}.mp4'), '--frame-batch', str(DEMO_FRAME_BATCH)]))
            result = json.loads(r['last'])
            back = video.index(str(work / f'{key}.mp4'))
            got = [hashlib.sha256(f.tobytes()).hexdigest() for f in video.iter_frames(str(hevc_in))]
            n_h = len(hevc_in_want)
            warp_err = max(warp_errs, default=math.inf)
            if (result['frames'] != n_h or back.n_frames != n_h or got != hevc_in_want
                    or result['total_poses'] == 0 or len(r['calls']) != n_h // DEMO_FRAME_BATCH
                    or r['k1'] < n_h // DEMO_FRAME_BATCH or len(warp_errs) != r['k1']
                    or not warp_err <= WARP_TOL or r['k2'] != 0 or r['hevc_decodes'] != n_h
                    or r['h264_decodes'] != 0 or r['mp4v_decodes'] != 0):
                fail(name, f'{key}: {result}, {back.n_frames} frames read back, '
                           f'{sum(a != b for a, b in zip(got, hevc_in_want))} of {n_h} input '
                           f'frames unlike the manifest, {len(r["calls"])} batched calls, K1 '
                           f'{r["k1"]} ({len(warp_errs)} compared, max |kernel - plain| '
                           f'{warp_err:.3g}), K2 {r["k2"]}, {r["hevc_decodes"]} HEVC pictures '
                           f'decoded')
            phase(name, f'{key} ({hevc_in.name}, {n_h} frames of {what}, frame batch '
                        f'{DEMO_FRAME_BATCH}, num_aug 2, folded; {result["total_poses"]} poses): '
                        f'every input frame equal to the manifest (cv2\'s), {r["hevc_decodes"]} '
                        f'pictures decoded ({r["hevc_decodes"] / n_h:g} per frame read); K1 '
                        f'{r["k1"]}, each against the plain warp (max |kernel - plain| '
                        f'{warp_err:.3g}), K2 {r["k2"]}; with the checks: {r["seconds"]:.2f} s, '
                        f'decoding {r["decode_s"]:.2f} s')
            launches[key] = (r['k1'], r['k2'])
            del r

        # demo_video on the phone's clip (HEVC Main 10 in QuickTime, 1920x1080
        # stored, turned by 90 degrees): every input frame as displayed the
        # manifest's (cv2's), the overlay 1080 wide, every K1 launch against
        # the plain warp, each picture decoded once; timed without the checks.
        key = 'demo_video_hevc10'
        phone = root / HEVC10_FIXTURES / HEVC10_PHONE
        phone_want = json.loads((root / HEVC10_FIXTURES / 'manifest.json').read_text())[
            HEVC10_PHONE]['rgb_sha256']
        demo_args = ['--video', str(phone), '--package', str(work / 'pkg'),
                     '--out', str(work / f'{key}.mp4'), '--frame-batch', str(DEMO_FRAME_BATCH)]
        drawing = TimedCalls((demo_image, 'draw_poses'))
        try:
            timed = drivers.run(drivers.loader('detect_poses_batched', call_kwargs=KEEP_POSES),
                                demo_video.main, demo_args)
        finally:
            drawing.restore()
        timed['draw_s'] = drawing.seconds('draw_poses')
        r, warp_errs = checked_warps(lambda: drivers.run(
            drivers.loader('detect_poses_batched', call_kwargs=KEEP_POSES), demo_video.main,
            demo_args))
        result = json.loads(r['last'])
        back = video.index(str(work / f'{key}.mp4'))
        got = [hashlib.sha256(f.tobytes()).hexdigest() for f in video.iter_frames(str(phone))]
        n_p = len(phone_want)
        warp_err = max(warp_errs, default=math.inf)
        if (result['frames'] != n_p or back.n_frames != n_p or got != phone_want
                or (back.width, back.height) != (HEVC10_STORED[1], HEVC10_STORED[0])
                or result['total_poses'] == 0 or len(r['calls']) != n_p // DEMO_FRAME_BATCH
                or r['k1'] < n_p // DEMO_FRAME_BATCH or len(warp_errs) != r['k1']
                or not warp_err <= WARP_TOL or r['k2'] != 0 or r['hevc_decodes'] != n_p
                or timed['hevc_decodes'] != n_p or timed['k1'] != r['k1']):
            fail(name, f'{key}: {result}, {back.n_frames} frames of {back.width}x{back.height} '
                       f'read back, {sum(a != b for a, b in zip(got, phone_want))} of {n_p} input '
                       f'frames unlike the manifest, {len(r["calls"])} batched calls, K1 '
                       f'{r["k1"]} ({len(warp_errs)} compared, max |kernel - plain| '
                       f'{warp_err:.3g}), K2 {r["k2"]}, {r["hevc_decodes"]} HEVC pictures decoded')
        phase(name, f'{key} ({phone.name}: {n_p} frames of HEVC Main 10 with B slices, '
                    f'{HEVC10_STORED[0]}x{HEVC10_STORED[1]} stored and turned by 90 degrees, frame '
                    f'batch {DEMO_FRAME_BATCH}, num_aug 2, folded; {result["total_poses"]} poses): '
                    + demo_timing(timed, n_p) + f'; every input frame as displayed equal to the '
                    f'manifest (cv2\'s), {r["hevc_decodes"]} pictures decoded '
                    f'({r["hevc_decodes"] / n_p:g} per frame read); the overlay read back: '
                    f'{back.n_frames} {back.codec} frames of {back.width}x{back.height}; run again '
                    f'with every launch checked: K1 {r["k1"]}, each against the plain warp (max '
                    f'|kernel - plain| {warp_err:.3g}), K2 {r["k2"]}')
        launches[key] = (r['k1'], r['k2'])
        del r, timed

        # demo_video on Xvid's usual Advanced Simple AVI (packed B-VOPs,
        # quarter-pel, MPEG quantisation, GMC): timed, then again with every
        # K1 launch against the plain warp, every input frame the manifest's,
        # each VOP decoded once.
        key = 'demo_video_mp4v_asp'
        asp_in = root / MP4V_ASP_FIXTURES / MP4V_ASP_DEMO
        asp_in_want = json.loads((root / MP4V_ASP_FIXTURES / 'manifest.json').read_text())[
            MP4V_ASP_DEMO]['rgb_sha256']
        demo_args = ['--video', str(asp_in), '--package', str(work / 'pkg'),
                     '--out', str(work / f'{key}.mp4'), '--frame-batch', str(DEMO_FRAME_BATCH)]
        drawing = TimedCalls((demo_image, 'draw_poses'))
        try:
            timed = drivers.run(drivers.loader('detect_poses_batched', call_kwargs=KEEP_POSES),
                                demo_video.main, demo_args)
        finally:
            drawing.restore()
        timed['draw_s'] = drawing.seconds('draw_poses')
        r, warp_errs = checked_warps(lambda: drivers.run(
            drivers.loader('detect_poses_batched', call_kwargs=KEEP_POSES), demo_video.main,
            demo_args))
        result = json.loads(r['last'])
        back = video.index(str(work / f'{key}.mp4'))
        got = [hashlib.sha256(f.tobytes()).hexdigest() for f in video.iter_frames(str(asp_in))]
        n_a = len(asp_in_want)
        n_calls = math.ceil(n_a / DEMO_FRAME_BATCH)
        warp_err = max(warp_errs, default=math.inf)
        if (result['frames'] != n_a or back.n_frames != n_a or got != asp_in_want
                or result['total_poses'] == 0 or len(r['calls']) != n_calls
                or r['k1'] < n_calls or len(warp_errs) != r['k1'] or not warp_err <= WARP_TOL
                or r['k2'] != 0 or r['mp4v_decodes'] != n_a or timed['mp4v_decodes'] != n_a
                or timed['k1'] != r['k1'] or r['h264_decodes'] or r['hevc_decodes']):
            fail(name, f'{key}: {result}, {back.n_frames} frames read back, '
                       f'{sum(a != b for a, b in zip(got, asp_in_want))} of {n_a} input frames '
                       f'unlike the manifest, {len(r["calls"])} batched calls, K1 {r["k1"]} '
                       f'({len(warp_errs)} compared, max |kernel - plain| {warp_err:.3g}), K2 '
                       f'{r["k2"]}, {r["mp4v_decodes"]} and {timed["mp4v_decodes"]} VOPs decoded')
        phase(name, f'{key} ({asp_in.name}: {n_a} frames of Xvid\'s usual Advanced Simple stream, '
                    f'frame batch {DEMO_FRAME_BATCH}, num_aug 2, folded; '
                    f'{result["total_poses"]} poses): ' + demo_timing(timed, n_a) + f'; every '
                    f'input frame equal to the manifest (cv2\'s), {r["mp4v_decodes"]} VOPs '
                    f'decoded ({r["mp4v_decodes"] / n_a:g} per frame read); run again with every '
                    f'launch checked: K1 {r["k1"]}, each against the plain warp (max |kernel - '
                    f'plain| {warp_err:.3g}), K2 {r["k2"]}')
        launches[key] = (r['k1'], r['k2'])
        del r, timed

        # predict_3dpw --viz-dir (folded) on VIZ_3DPW: JAX's figure names, every
        # VIZ_STEP frames, read back.
        t0 = time.perf_counter()
        mint_3dpw_layout(work / '3dpw', np.random.default_rng(SEED + 17),
                         root / JPEG_FIXTURES / FRAME_3DPW, dims=VIZ_3DPW)
        bench_package(work / 'pkg_smpl', gen, SMPL_24, with_detector=True)
        mint_s = time.perf_counter() - t0
        drawing = TimedCalls((viz, 'plot_poses_3d'))
        try:
            r = drivers.run(drivers.loader('detect_poses_batched'), predict_3dpw.main, [
                '--package', str(work / 'pkg_smpl'), '--root', str(work / '3dpw'),
                '--output-path', str(work / 'pred_3dpw'), '--gtassoc',
                '--viz-dir', str(work / 'viz'), '--viz-step', str(VIZ_STEP)])
        finally:
            drawing.restore()
        names = sorted(os.listdir(work / 'viz'))
        want = [f'bench_00_{i:05d}.jpg' for i in range(0, VIZ_3DPW['frames'], VIZ_STEP)]
        figures = [improc.imread(str(work / 'viz' / n)) for n in names]
        if (names != want or r['k1'] == 0 or r['k2'] != 0 or min(v for *_, v in r['calls']) == 0
                or any(f.ndim != 3 or f.std() == 0 for f in figures)):
            fail(name, f'predict_3dpw --viz-dir wrote {names} (expected {want}) of '
                       f'{[f.shape for f in figures]}; K1 {r["k1"]}, K2 {r["k2"]}, valid poses '
                       f'per call {[v for *_, v in r["calls"]]}')
        phase(name, f'predict_3dpw --gtassoc --viz-dir --viz-step {VIZ_STEP} (folded, SMPL-24 '
                    f'package and layout minted in {mint_s:.1f} s): '
                    + driver_timing(r, VIZ_3DPW['frames']) + f'; {len(names)} figures '
                    f'{[f.shape for f in figures]} under JAX\'s names in '
                    f'{drawing.seconds("plot_poses_3d"):.2f} s with their JPEG encoding; K1 '
                    f'{r["k1"]}, K2 {r["k2"]}')
        launches['viz_dir'] = (r['k1'], r['k2'])
        del r

        # predict_aspset on the mp4v .mkv clips, unfolded with fuse_mbconv on:
        # K1 and K2, each frame decoded once; then again with every launch of
        # either kernel against its plain version.
        def aspset_run(out_dir: str, layout: str = 'aspset'):
            return drivers.run(
                drivers.loader('estimate_poses_batched', cfg_overrides={'bn_fold': False},
                               backbone_builder=functools.partial(build_backbone,
                                                                  fuse_mbconv='on')),
                predict_aspset.main, ['--package', str(work / 'pkg'), '--root',
                                      str(work / layout), '--output-dir', str(work / out_dir)])

        r = aspset_run('pred_aspset')
        n_frames = len(ASPSET_VIEWS) * ASPSET_FRAMES
        calls = len(ASPSET_VIEWS) * math.ceil(ASPSET_FRAMES / ASPSET_BATCH)
        preds = [np.load(work / 'pred_aspset' / f'01-0001-{view}.npz')['coords3d_pred_world']
                 for view in ASPSET_VIEWS]
        if (r['k1'] != calls or r['k2'] != K2_BLOCKS * calls or len(r['calls']) != calls
                or r['mp4v_decodes'] != n_frames
                or any(p.shape != (ASPSET_FRAMES, 17, 3) or not np.isfinite(p).all()
                       for p in preds)):
            fail(name, f'predict_aspset: K1 {r["k1"]}, K2 {r["k2"]} (expected {calls} and '
                       f'{K2_BLOCKS * calls}), {len(r["calls"])} calls, {r["mp4v_decodes"]} '
                       f'mp4v frames decoded (expected {n_frames}), predictions '
                       f'{[p.shape for p in preds]}')
        (((checked, warp_errs), v_errs, mean_errs)) = checked_mbconv(
            lambda: checked_warps(lambda: aspset_run('pred_aspset_checked')))
        again = [np.load(work / 'pred_aspset_checked' / f'01-0001-{view}.npz')
                 ['coords3d_pred_world'] for view in ASPSET_VIEWS]
        warp_err, err_v = max(warp_errs, default=math.inf), max(v_errs, default=math.inf)
        if (len(warp_errs) != calls or len(v_errs) != K2_BLOCKS * calls or warp_err != 0.0
                or err_v != 0.0 or checked['k1'] != calls or checked['k2'] != K2_BLOCKS * calls
                or any(p.shape != (ASPSET_FRAMES, 17, 3) or not np.isfinite(p).all()
                       for p in again)):
            fail(name, f'predict_aspset checked: {len(warp_errs)} K1 launches compared (max '
                       f'|kernel - plain| {warp_err:.3g}, must be 0), {len(v_errs)} K2 launches '
                       f'(v max {err_v:.3g}, must be 0), predictions {[p.shape for p in again]}')
        phase(name, f'predict_aspset (mp4v .mkv, num_aug 1, batch {ASPSET_BATCH}, antialias 2), '
                    f'unfolded, fuse_mbconv on: ' + driver_timing(r, n_frames) + f'; '
                    f'{r["mp4v_decodes"]} mp4v frames decoded for {n_frames}; K1 {r["k1"]}, K2 '
                    f'{r["k2"]}; run again with every launch checked: K1 {len(warp_errs)} against '
                    f'the plain warp (max |kernel - plain| {warp_err:.3g}), K2 {len(v_errs)} '
                    f'against the plain chain (v max {err_v:.3g}, SE mean max '
                    f'{max(mean_errs, default=math.inf):.3g})')
        launches['predict_aspset'] = (r['k1'], r['k2'])
        del r, checked

        # predict_aspset on the H.264 .mkv clips, the same way.
        r = aspset_run('pred_aspset_h264', 'aspset_h264')
        preds = [np.load(work / 'pred_aspset_h264' / f'01-0001-{view}.npz')['coords3d_pred_world']
                 for view in ASPSET_VIEWS]
        if (r['k1'] != calls or r['k2'] != K2_BLOCKS * calls or len(r['calls']) != calls
                or r['h264_decodes'] != n_frames or r['mp4v_decodes'] != 0
                or any(p.shape != (ASPSET_FRAMES, 17, 3) or not np.isfinite(p).all()
                       for p in preds)):
            fail(name, f'predict_aspset (H.264): K1 {r["k1"]}, K2 {r["k2"]} (expected {calls} '
                       f'and {K2_BLOCKS * calls}), {len(r["calls"])} calls, {r["h264_decodes"]} '
                       f'H.264 frames decoded (expected {n_frames}), predictions '
                       f'{[p.shape for p in preds]}')
        (((checked, warp_errs), v_errs, mean_errs)) = checked_mbconv(
            lambda: checked_warps(lambda: aspset_run('pred_aspset_h264_checked', 'aspset_h264')))
        again = [np.load(work / 'pred_aspset_h264_checked' / f'01-0001-{view}.npz')
                 ['coords3d_pred_world'] for view in ASPSET_VIEWS]
        warp_err, err_v = max(warp_errs, default=math.inf), max(v_errs, default=math.inf)
        if (len(warp_errs) != calls or len(v_errs) != K2_BLOCKS * calls or warp_err != 0.0
                or err_v != 0.0 or checked['k1'] != calls or checked['k2'] != K2_BLOCKS * calls
                or any(p.shape != (ASPSET_FRAMES, 17, 3) or not np.isfinite(p).all()
                       for p in again)):
            fail(name, f'predict_aspset (H.264) checked: {len(warp_errs)} K1 launches compared '
                       f'(max |kernel - plain| {warp_err:.3g}, must be 0), {len(v_errs)} K2 '
                       f'launches (v max {err_v:.3g}, must be 0), predictions '
                       f'{[p.shape for p in again]}')
        phase(name, f'predict_aspset (H.264 .mkv, num_aug 1, batch {ASPSET_BATCH}, antialias 2), '
                    f'unfolded, fuse_mbconv on: ' + driver_timing(r, n_frames) + f'; '
                    f'{r["h264_decodes"]} H.264 frames decoded for {n_frames} '
                    f'({r["h264_decodes"] / n_frames:g} per frame read); K1 {r["k1"]}, K2 '
                    f'{r["k2"]}; run again with every launch checked: K1 {len(warp_errs)} against '
                    f'the plain warp (max |kernel - plain| {warp_err:.3g}), K2 {len(v_errs)} '
                    f'against the plain chain (v max {err_v:.3g}, SE mean max '
                    f'{max(mean_errs, default=math.inf):.3g})')
        launches['predict_aspset_h264'] = (r['k1'], r['k2'])
        del r, checked

        # predict_aspset on the B-frame H.264 .mkv views: one run with every
        # launch of either kernel against its plain version, every input
        # frame against the manifest, each picture decoded once by the 8 I/O
        # threads asking in any order.
        key = 'predict_aspset_h264_b'
        (((r, warp_errs), v_errs, mean_errs)) = checked_mbconv(
            lambda: checked_warps(lambda: aspset_run(f'pred_{key}', 'aspset_h264_b')))
        preds = [np.load(work / f'pred_{key}' / f'01-0001-{view}.npz')['coords3d_pred_world']
                 for view in ASPSET_VIEWS]
        unlike = sum(a != b for clip, want in aspset_b_want.items() for a, b in zip(
            [hashlib.sha256(f.tobytes()).hexdigest() for f in video.iter_frames(clip)], want))
        warp_err, err_v = max(warp_errs, default=math.inf), max(v_errs, default=math.inf)
        if (r['k1'] != calls or r['k2'] != K2_BLOCKS * calls or len(r['calls']) != calls
                or len(warp_errs) != calls or len(v_errs) != K2_BLOCKS * calls or warp_err != 0.0
                or err_v != 0.0 or r['h264_decodes'] != n_frames or r['mp4v_decodes'] != 0
                or unlike or sum(map(len, aspset_b_want.values())) != n_frames
                or any(p.shape != (ASPSET_FRAMES, 17, 3) or not np.isfinite(p).all()
                       for p in preds)):
            fail(name, f'{key}: K1 {r["k1"]}, K2 {r["k2"]} (expected {calls} and '
                       f'{K2_BLOCKS * calls}), {len(r["calls"])} calls, {len(warp_errs)} K1 '
                       f'launches compared (max |kernel - plain| {warp_err:.3g}, must be 0), '
                       f'{len(v_errs)} K2 (v max {err_v:.3g}, must be 0), {r["h264_decodes"]} '
                       f'pictures decoded (expected {n_frames}), {unlike} input frames unlike the '
                       f'manifest, predictions {[p.shape for p in preds]}')
        phase(name, f'{key} (B-frame H.264 .mkv, num_aug 1, batch {ASPSET_BATCH}, antialias 2), '
                    f'unfolded, fuse_mbconv on: every input frame equal to the manifest; '
                    f'{r["h264_decodes"]} pictures decoded for {n_frames} frames read by 8 I/O '
                    f'threads; K1 {r["k1"]}, each against the plain warp (max |kernel - plain| '
                    f'{warp_err:.3g}), K2 {r["k2"]}, each against the plain chain (v max '
                    f'{err_v:.3g}, SE mean max {max(mean_errs, default=math.inf):.3g}); with the '
                    f'checks: {r["seconds"]:.2f} s, decoding {r["decode_s"]:.2f} s')
        launches[key] = (r['k1'], r['k2'])
        del r

        # predict_aspset on the HEVC .mkv views (I and P slices) and on the
        # HEVC B-frame .mkv views, the same way.
        for key, layout, layout_want, what in (
                ('predict_aspset_hevc', 'aspset_hevc', aspset_hevc_want, 'HEVC'),
                ('predict_aspset_hevc_b', 'aspset_hevc_b', aspset_hevc_b_want, 'B-frame HEVC')):
            (((r, warp_errs), v_errs, mean_errs)) = checked_mbconv(
                lambda: checked_warps(lambda: aspset_run(f'pred_{key}', layout)))
            preds = [np.load(work / f'pred_{key}' / f'01-0001-{view}.npz')['coords3d_pred_world']
                     for view in ASPSET_VIEWS]
            unlike = sum(a != b for clip, want in layout_want.items() for a, b in zip(
                [hashlib.sha256(f.tobytes()).hexdigest() for f in video.iter_frames(clip)], want))
            warp_err, err_v = max(warp_errs, default=math.inf), max(v_errs, default=math.inf)
            if (r['k1'] != calls or r['k2'] != K2_BLOCKS * calls or len(r['calls']) != calls
                    or len(warp_errs) != calls or len(v_errs) != K2_BLOCKS * calls
                    or warp_err != 0.0 or err_v != 0.0 or r['hevc_decodes'] != n_frames
                    or r['h264_decodes'] != 0 or r['mp4v_decodes'] != 0 or unlike
                    or sum(map(len, layout_want.values())) != n_frames
                    or any(p.shape != (ASPSET_FRAMES, 17, 3) or not np.isfinite(p).all()
                           for p in preds)):
                fail(name, f'{key}: K1 {r["k1"]}, K2 {r["k2"]} (expected {calls} and '
                           f'{K2_BLOCKS * calls}), {len(r["calls"])} calls, {len(warp_errs)} K1 '
                           f'launches compared (max |kernel - plain| {warp_err:.3g}, must be 0), '
                           f'{len(v_errs)} K2 (v max {err_v:.3g}, must be 0), '
                           f'{r["hevc_decodes"]} pictures decoded (expected {n_frames}), {unlike} '
                           f'input frames unlike the manifest, predictions '
                           f'{[p.shape for p in preds]}')
            phase(name, f'{key} ({what} .mkv, num_aug 1, batch {ASPSET_BATCH}, antialias 2), '
                        f'unfolded, fuse_mbconv on: every input frame equal to the manifest; '
                        f'{r["hevc_decodes"]} pictures decoded for {n_frames} frames read by 8 I/O '
                        f'threads; K1 {r["k1"]}, each against the plain warp (max |kernel - '
                        f'plain| {warp_err:.3g}), K2 {r["k2"]}, each against the plain chain (v '
                        f'max {err_v:.3g}, SE mean max {max(mean_errs, default=math.inf):.3g}); '
                        f'with the checks: {r["seconds"]:.2f} s, decoding {r["decode_s"]:.2f} s')
            launches[key] = (r['k1'], r['k2'])
            del r

        # predict_aspset on the Advanced Simple .mkv views (Xvid's usual
        # packed stream, all its frames), the same way.
        key = 'predict_aspset_mp4v_asp'
        (((r, warp_errs), v_errs, mean_errs)) = checked_mbconv(
            lambda: checked_warps(lambda: aspset_run(f'pred_{key}', 'aspset_mp4v_asp')))
        n_view = len(next(iter(aspset_asp_want.values())))
        n_asp, asp_calls = len(ASPSET_VIEWS) * n_view, len(ASPSET_VIEWS) * math.ceil(
            n_view / ASPSET_BATCH)
        preds = [np.load(work / f'pred_{key}' / f'01-0001-{view}.npz')['coords3d_pred_world']
                 for view in ASPSET_VIEWS]
        unlike = sum(a != b for clip, want in aspset_asp_want.items() for a, b in zip(
            [hashlib.sha256(f.tobytes()).hexdigest() for f in video.iter_frames(clip)], want))
        warp_err, err_v = max(warp_errs, default=math.inf), max(v_errs, default=math.inf)
        if (r['k1'] != asp_calls or r['k2'] != K2_BLOCKS * asp_calls
                or len(r['calls']) != asp_calls or len(warp_errs) != asp_calls
                or len(v_errs) != K2_BLOCKS * asp_calls or warp_err != 0.0 or err_v != 0.0
                or r['mp4v_decodes'] != n_asp or r['h264_decodes'] or r['hevc_decodes'] or unlike
                or any(p.shape != (n_view, 17, 3) or not np.isfinite(p).all() for p in preds)):
            fail(name, f'{key}: K1 {r["k1"]}, K2 {r["k2"]} (expected {asp_calls} and '
                       f'{K2_BLOCKS * asp_calls}), {len(r["calls"])} calls, {len(warp_errs)} K1 '
                       f'launches compared (max |kernel - plain| {warp_err:.3g}, must be 0), '
                       f'{len(v_errs)} K2 (v max {err_v:.3g}, must be 0), {r["mp4v_decodes"]} '
                       f'VOPs decoded (expected {n_asp}), {unlike} input frames unlike the '
                       f'manifest, predictions {[p.shape for p in preds]}')
        phase(name, f'{key} (Xvid\'s usual Advanced Simple .mkv, {len(ASPSET_VIEWS)} views x '
                    f'{n_view} frames, num_aug 1, batch {ASPSET_BATCH}, antialias 2), unfolded, '
                    f'fuse_mbconv on: every input frame equal to the manifest; '
                    f'{r["mp4v_decodes"]} VOPs decoded for {n_asp} frames read by 8 I/O threads; '
                    f'K1 {r["k1"]}, each against the plain warp (max |kernel - plain| '
                    f'{warp_err:.3g}), K2 {r["k2"]}, each against the plain chain (v max '
                    f'{err_v:.3g}, SE mean max {max(mean_errs, default=math.inf):.3g}); with the '
                    f'checks: {r["seconds"]:.2f} s, decoding {r["decode_s"]:.2f} s')
        launches[key] = (r['k1'], r['k2'])
        del r
    finally:
        drivers.restore()
        shutil.rmtree(work, ignore_errors=True)
    return launches


# The [images] phase.
IMAGE_FIXTURES = 'tests/torch_fixtures/images'
IMAGES_DIR = 'runs/chip_smoke_images'  # demo_image's overlays (deleted after)
IMAGE_TIMED = ('png_large_paeth.png', 'webp_large_o6.webp')  # 4032x3024
# Minted in IMAGES_DIR by tests/_torch_image_fixtures.py, 4032x3024 each.
IMAGE_MINTED = ('large_rgb16_lzw_pred2_tiles.tif', 'large_rgb24.bmp')
IMAGE_DECODE_REPEATS = 3
IMAGE_DEMOS = (('demo_image_webp', 'webp_large_o6.webp'),
               ('demo_image_png_palette', 'png_palette16_640x480.png'),
               ('demo_image_tiff', IMAGE_MINTED[0]), ('demo_image_bmp', IMAGE_MINTED[1]))
IMAGE_CALIB_COPIES = (('calibrate_tiff', 'tif'), ('calibrate_bmp', 'bmp'))
PIL_RAISES = 'PIL raises'  # the manifest's size where PIL does not identify a file


def image_fixture_helpers(root: Path):
    """tests/_torch_image_fixtures.py (numpy only at import): the writers
    of the minted TIFF and BMP files."""
    if str(root / 'tests') not in sys.path:
        sys.path.insert(0, str(root / 'tests'))
    import _torch_image_fixtures
    return _torch_image_fixtures


def check_image_fixtures(root: Path) -> dict:
    """Every still-image fixture in colour and in gray against the
    manifest's hashes of cv2's reads (a ValueError where cv2 returns None),
    and image_extents against PIL's sizes (a ValueError where PIL raises)."""
    import hashlib

    from metrabs_tpu_torch.data import improc

    fixtures = root / IMAGE_FIXTURES
    manifest = json.loads((fixtures / 'manifest.json').read_text())
    kinds, refused = collections.Counter(), 0
    for name, entry in sorted(manifest.items()):
        path = str(fixtures / name)
        for key, gray in (('rgb', False), ('gray', True)):
            if entry[f'sha256_{key}'] is None:
                try:
                    improc.imread(path, gray=gray)
                except ValueError:
                    refused += 1
                    continue
                fail('images', f'{name} ({key}): read, where cv2.imread returns None')
            im = improc.imread(path, gray=gray)
            if (list(im.shape) != entry[f'shape_{key}']
                    or hashlib.sha256(im.tobytes()).hexdigest() != entry[f'sha256_{key}']):
                fail('images', f'{name} ({key}): {im.shape} differs from cv2\'s read '
                               f'{entry[f"shape_{key}"]} or its hash')
        if entry['pil_size'] == PIL_RAISES:
            try:
                improc.image_extents(path)
            except ValueError:
                refused += 1
            else:
                fail('images', f'{name}: image_extents answers where PIL raises')
        elif list(improc.image_extents(path)) != entry['pil_size']:
            fail('images', f'{name}: image_extents {improc.image_extents(path)} != PIL\'s '
                           f'{entry["pil_size"]}')
        kinds[name.split('_')[0]] += 1
    return dict(files=len(manifest), kinds=dict(kinds), refused=refused)


def mint_large_images(root: Path, work: Path) -> None:
    """IMAGE_MINTED in `work`: the phone-sized 16-bit TIFF and 24-bit BMP."""
    fx = image_fixture_helpers(root)
    (work / IMAGE_MINTED[0]).write_bytes(fx.large_tiff())
    (work / IMAGE_MINTED[1]).write_bytes(fx.large_bmp())


def time_image_decodes(root: Path, work: Path) -> dict:
    """Median ms (and all) of IMAGE_DECODE_REPEATS decodes to RGB on this
    thread of each phone-sized fixture and each minted image. Every decode
    of a minted image must equal the array it was written from: the BMP
    holds large_scene(), the 16-bit TIFF large_rgb16(), which cv2 reads as
    (v + 128) // 257."""
    from metrabs_tpu_torch.data import bmp, png, tiff, webp

    decoders = {'.png': png.decode, '.webp': webp.decode, '.tif': tiff.decode, '.bmp': bmp.decode}
    fx = image_fixture_helpers(root)
    written = {IMAGE_MINTED[0]: lambda: ((fx.large_rgb16().astype(np.uint32) + 128)
                                         // 257).astype(np.uint8),
               IMAGE_MINTED[1]: fx.large_scene}
    out = {}
    for name, path in ([(n, root / IMAGE_FIXTURES / n) for n in IMAGE_TIMED]
                       + [(n, work / n) for n in IMAGE_MINTED]):
        data = path.read_bytes()
        decode = decoders[Path(name).suffix]
        want = written[name]() if name in written else None
        times = []
        for _ in range(IMAGE_DECODE_REPEATS):
            t = time.perf_counter()
            im = decode(data, name)
            times.append(1e3 * (time.perf_counter() - t))
            if want is not None and (im.dtype != want.dtype or not np.array_equal(im, want)):
                fail('images', f'{name} decodes to {im.shape} {im.dtype}, not to the '
                               f'{want.shape} {want.dtype} pixels it was written from')
        out[name] = dict(ms=statistics.median(times), all_ms=times, shape=im.shape,
                         kib=len(data) / 1024)
    return out


def calibrate_copies(root: Path, work: Path, dev) -> dict:
    """apps.calibrate_camera on calibration set (a) as PNGs and on its
    views' gray reads written as 8-bit gray TIFF and BMP (the same pixels):
    the JSON of each copy must equal the PNGs'. Returns the (K1, K2)
    launches counted in each copy's run, which must be (0, 0): the app
    launches no kernel."""
    import contextlib
    import io

    from metrabs_tpu_torch.apps import calibrate_camera
    from metrabs_tpu_torch.data import improc
    from metrabs_tpu_torch.ops import mbconv_cuda, warp_cuda

    fx = image_fixture_helpers(root)
    manifest = json.loads((root / CALIB_FIXTURES / 'manifest.json').read_text())
    cols, rows = manifest['pattern_size']
    run = manifest['calibrations']['a']
    pngs = sorted((root / CALIB_FIXTURES / 'a').glob('*.png'))

    def app(pattern: str, out: Path) -> tuple:
        warp_cuda.warp_pyramid.launches = mbconv_cuda.fused_mbconv_inner.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            calibrate_camera.main(['--images', pattern, '--rows', str(rows), '--cols', str(cols),
                                   '--square-mm', str(run['square_mm']), '--out', str(out),
                                   '--device', str(dev)])
        seconds = time.perf_counter() - t0
        counts = (warp_cuda.warp_pyramid.launches, mbconv_cuda.fused_mbconv_inner.launches)
        if counts != (0, 0):
            fail('images', f'calibrate_camera on {pattern} launched K1/K2 {counts}')
        return json.loads(out.read_text()), seconds, counts

    want, png_s, _ = app(str(root / CALIB_FIXTURES / 'a' / '*.png'), work / 'a_png.json')
    launches = {}
    for key, ext in IMAGE_CALIB_COPIES:
        copies = work / key
        copies.mkdir()
        write = fx.gray_tiff if ext == 'tif' else fx.gray_bmp
        for png in pngs:
            (copies / f'{png.stem}.{ext}').write_bytes(write(improc.imread(str(png), gray=True)))
        got, seconds, counts = app(str(copies / f'*.{ext}'), work / f'{key}.json')
        if got != want:
            fail('images', f'calibrate_camera on the {ext} copies of (a) differs from its answer '
                           f'on the PNGs: {got} != {want}')
        phase('images', f'calibrate_camera on (a)\'s {len(pngs)} views as 8-bit gray {ext}: '
                        f'{seconds:.2f} s (PNGs: {png_s:.2f} s); JSON equal to the PNGs\' '
                        f'(rms {got["rms_reprojection_error"]:.6f} px, fx '
                        f'{got["intrinsic_matrix"][0][0]:.3f}); K1/K2 launches {counts}')
        launches[key] = counts
    return launches


def images_phase(root: Path, dev) -> dict:
    """The [images] phase (module docstring). Returns the K1 and K2
    launches of the demo_image runs and the calibrations."""
    from metrabs_tpu_torch.apps import demo_image
    from metrabs_tpu_torch.data import bmp, improc, png, tiff, webp
    from metrabs_tpu_torch.pipeline.skeletons import H36M_17

    name = 'images'
    fx = check_image_fixtures(root)
    phase(name, f'all {fx["files"]} still-image fixtures ({fx["kinds"]}) decoded in colour and '
                f'in gray equal to their manifest hashes of cv2.imread, image_extents equal to '
                f'PIL\'s sizes; {fx["refused"]} reads and sizes raise where cv2 or PIL refuse')
    work = root / IMAGES_DIR
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    start = time.perf_counter()
    mint_large_images(root, work)
    phase(name, f'{", ".join(IMAGE_MINTED)} minted in {time.perf_counter() - start:.1f} s')
    timed = time_image_decodes(root, work)
    for fixture, t in timed.items():
        phase(name, f'{fixture} ({t["kib"]:.0f} KiB) to RGB {t["shape"]}: {t["ms"]:.1f} ms '
                    f'(median of {IMAGE_DECODE_REPEATS} on one host thread; all: '
                    + ', '.join(f'{v:.1f}' for v in t['all_ms']) + f') on {card_name()}')
    drivers = DriverRuns()
    launches = {}
    modules = (png, webp, tiff, bmp)
    original = tuple(m.decode for m in modules)
    spans = []

    def timed_decode(decode):
        def run(*args, **kwargs):
            t = time.perf_counter()
            try:
                return decode(*args, **kwargs)
            finally:
                spans.append(time.perf_counter() - t)
        return run

    try:
        bench_package(work / 'pkg', torch.Generator().manual_seed(SEED + 23), H36M_17,
                      with_detector=True)
        for key, fixture in IMAGE_DEMOS:
            image_path = str((work if fixture in IMAGE_MINTED else root / IMAGE_FIXTURES)
                             / fixture)
            out_path = work / f'{key}.jpg'
            spans.clear()
            for m, decode in zip(modules, original):
                m.decode = timed_decode(decode)
            try:
                r, warp_errs = checked_warps(lambda: drivers.run(
                    drivers.loader('detect_poses_batched', call_kwargs=KEEP_POSES),
                    demo_image.main, ['--image', image_path, '--package', str(work / 'pkg'),
                                      '--out', str(out_path)]))
            finally:
                for m, decode in zip(modules, original):
                    m.decode = decode
            line = json.loads([t for t in r['printed'].splitlines() if t.startswith('{')][-1])
            shown = improc.imread(image_path)
            overlay = improc.imread(str(out_path))
            warp_err = max(warp_errs, default=math.inf)
            if (r['k1'] == 0 or len(warp_errs) != r['k1'] or warp_err != 0.0 or r['k2'] != 0
                    or overlay.shape != shown.shape or line['n_poses'] == 0
                    or np.array_equal(overlay, undrawn(shown))):
                fail(name, f'demo_image on {fixture}: K1 {r["k1"]} ({len(warp_errs)} compared, '
                           f'max |kernel - plain| {warp_err:.3g}), K2 {r["k2"]}, overlay '
                           f'{overlay.shape} for the displayed {shown.shape} (poses must be '
                           f'drawn), {line}')
            phase(name, f'demo_image (folded) on {fixture}, displayed {shown.shape}: '
                        f'{line["n_poses"]} poses in {r["seconds"]:.2f} s ({r["run_s"]:.2f} s '
                        f'without loading the package); decoding {1e3 * sum(spans):.1f} ms; K1 '
                        f'{r["k1"]}, each against the plain warp (max |kernel - plain| '
                        f'{warp_err:.3g}), K2 {r["k2"]}; overlay {overlay.shape} with the poses '
                        f'drawn')
            launches[key] = (r['k1'], r['k2'])
            del r
        launches.update(calibrate_copies(root, work, dev))
    finally:
        for m, decode in zip(modules, original):
            m.decode = decode
        drivers.restore()
        shutil.rmtree(work, ignore_errors=True)
    return launches, timed


# The [calibrate] phase.
CALIB_FIXTURES = 'tests/torch_fixtures/calib'
CALIB_DIR = 'runs/chip_smoke_calibrate'  # the apps' JSON output (deleted after)
CALIB_RENDERED = 'b/view_3.jpg'  # re-rendered here and held to its hashes
# The view where cv2's image normalisation loses the board and the port finds
# it (utils/calibration.py::find_chessboard_corners): the port must find it.
CALIB_CV2_MISSES = ('a/calib_4.png',)
CALIB_TOL = dict(refined_px=0.02, subpix_px=1e-3, k_rtol=1e-4, rms_rtol=1e-6,
                 displacement_px=0.01, app_f_rtol=1e-3, app_pp_px=0.5, app_rms_px=1e-3,
                 truth_f_rtol=0.01, truth_displacement_px=0.5)
NATIVE_WARP_TOL = 5e-4  # tests/test_native.py's tolerance of the C++ warp


def lens_displacement(k, dist, shape, step: int = 20) -> np.ndarray:
    """A lens's displacement in pixels [h, w, 2] on a grid of the image: an
    undistorted pixel p goes to K distort(K^-1 p)."""
    from metrabs_tpu_torch.ops.distortion import distort_points

    k = np.asarray(k, np.float64)
    v, u = np.mgrid[0:shape[0]:step, 0:shape[1]:step].astype(np.float64)
    xu = np.stack([(u - k[0, 2]) / k[0, 0], (v - k[1, 2]) / k[1, 1]], -1)
    xd = distort_points(torch.from_numpy(xu),
                        torch.tensor(np.ravel(dist), dtype=torch.float64)).numpy()
    return np.stack([xd[..., 0] * k[0, 0] + k[0, 2] - u, xd[..., 1] * k[1, 1] + k[1, 2] - v], -1)


def calibration_gap(got: dict, want: dict) -> dict:
    """fx and fy relative, principal point px, rms px and the lens's
    displacement px between two calibrate_camera JSON results."""
    kg, kw = np.asarray(got['intrinsic_matrix']), np.asarray(want['intrinsic_matrix'])
    d = (lens_displacement(kg, got['distortion_coeffs'], want['image_shape'])
         - lens_displacement(kw, want['distortion_coeffs'], want['image_shape']))
    return dict(f_rel=float(np.abs(kg[[0, 1], [0, 1]] / kw[[0, 1], [0, 1]] - 1).max()),
                pp_px=float(np.abs(kg[:2, 2] - kw[:2, 2]).max()),
                rms_px=abs(got['rms_reprojection_error'] - want['rms_reprojection_error']),
                displacement_px=float(np.linalg.norm(d, axis=-1).max()))


def calibrate_phase(root: Path, dev, frames, boxes, box_valid) -> dict:
    """The [calibrate] phase (module docstring). Returns the K1 and K2
    launches of the serve with the calibrated camera."""
    import contextlib
    import hashlib
    import io

    from metrabs_tpu_torch.apps import calibrate_camera
    from metrabs_tpu_torch.data import improc, jpeg
    from metrabs_tpu_torch.io.packaging import pose_estimator_from_variables
    from metrabs_tpu_torch.models.metrabs import ModelConfig
    from metrabs_tpu_torch.ops import mbconv_cuda, warp_cuda
    from metrabs_tpu_torch.utils import calibration

    name, tol = 'calibrate', CALIB_TOL
    fixtures = root / CALIB_FIXTURES
    manifest = json.loads((fixtures / 'manifest.json').read_text())
    cols, rows = manifest['pattern_size']
    sha = lambda b: hashlib.sha256(b).hexdigest()

    # Every view: the gray read, the board found as cv2 finds it, the app's
    # refinement, and cornerSubPix from cv2's own detection.
    seconds, worst_refined, worst_subpix = {}, 0.0, 0.0
    criteria = (calibration.TERM_CRITERIA_EPS + calibration.TERM_CRITERIA_MAX_ITER, 30, 1e-3)
    calibration.find_chessboard_corners(np.zeros((64, 64), np.uint8), (cols, rows), device=dev)
    for view, rec in sorted(manifest['views'].items()):
        gray = improc.imread(str(fixtures / view), gray=True)
        if sha(gray.tobytes()) != rec['gray_sha256']:
            fail(name, f'{view}: the gray read differs from cv2.imread(IMREAD_GRAYSCALE)')
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refined = calibrate_camera.find_corners(gray, rows, cols, dev)
        torch.cuda.synchronize()
        seconds[view] = time.perf_counter() - t0
        found = refined is not None
        if view in CALIB_CV2_MISSES:
            if rec['found'] or not found:
                fail(name, f'{view}: cv2 found {rec["found"]}, the port {found}; expected '
                           f'False and True')
            continue
        if found != rec['found']:
            fail(name, f'{view}: found {found}, cv2 {rec["found"]}')
        if not found:
            continue
        err = float(np.abs(refined.reshape(-1, 2) - np.asarray(rec['refined'])).max())
        half = rec['half_window']
        sub = calibration.corner_subpix(gray, np.asarray(rec['corners'], np.float32),
                                        (half, half), (-1, -1), criteria, device=dev)
        sub_err = float(np.abs(sub.reshape(-1, 2) - np.asarray(rec['refined'])).max())
        if not err <= tol['refined_px'] or not sub_err <= tol['subpix_px']:
            fail(name, f'{view}: corners {err:.3g} px from cv2 after the refinement (tol '
                       f'{tol["refined_px"]}), cornerSubPix from cv2\'s {sub_err:.3g} px (tol '
                       f'{tol["subpix_px"]})')
        worst_refined, worst_subpix = max(worst_refined, err), max(worst_subpix, sub_err)
    for size in ('640x480', '1920x1080'):
        per = [t for v, t in seconds.items() if manifest['views'][v]['shape'][1] == int(
            size.split('x')[0])]
        phase(name, f'{len(per)} views of {size}: find_corners (detection and the app\'s '
                    f'refinement) {statistics.median(per):.3f} s per view (median; all: '
                    + ', '.join(f'{t:.3f}' for t in per) + ')')
    n_found = sum(r['found'] for r in manifest['views'].values())
    phase(name, f'{len(seconds)} views: gray reads equal cv2\'s, found as cv2 on all but '
                f'{list(CALIB_CV2_MISSES)} (cv2 misses it, the port finds it), {n_found} boards: '
                f'refined corners max {worst_refined:.3g} px from cv2 (tol '
                f'{tol["refined_px"]}), cornerSubPix from cv2\'s detections max '
                f'{worst_subpix:.3g} px from cv2 (tol {tol["subpix_px"]})')

    # calibrateCamera on cv2's corners, then the app on each directory.
    work = root / CALIB_DIR
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    results = {}
    try:
        for sub, run in sorted(manifest['calibrations'].items()):
            want = run['result']
            objp = np.zeros((rows * cols, 3), np.float32)
            objp[:, :2] = np.mgrid[0:cols, 0:rows].T.reshape(-1, 2) * run['square_mm']
            imgs = [np.asarray(manifest['views'][v]['refined'], np.float32) for v in run['views']]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rms, k, dist, _, _ = calibration.calibrate_camera(
                [objp] * len(imgs), imgs, want['image_shape'][::-1], device=dev)
            solve_s = time.perf_counter() - t0
            gap = calibration_gap(dict(rms_reprojection_error=rms, intrinsic_matrix=k,
                                       distortion_coeffs=dist), want)
            k_rel = float(np.abs(k - np.asarray(want['intrinsic_matrix'])).max() / k[0, 0])
            if (k_rel > tol['k_rtol'] or gap['rms_px'] > tol['rms_rtol'] * rms
                    or gap['displacement_px'] > tol['displacement_px']):
                fail(name, f'{sub}: calibrate_camera on cv2\'s corners against cv2: K '
                           f'{k_rel:.3g} relative, rms {gap["rms_px"]:.3g} px, displacement '
                           f'{gap["displacement_px"]:.3g} px')
            t0 = time.perf_counter()
            out = work / f'{sub}.json'
            with contextlib.redirect_stdout(io.StringIO()):  # main prints its JSON
                calibrate_camera.main(['--images', str(fixtures / run['images']), '--rows',
                                       str(rows), '--cols', str(cols), '--square-mm',
                                       str(run['square_mm']), '--out', str(out), '--device',
                                       str(dev)])
            app_s = time.perf_counter() - t0
            got = json.loads(out.read_text())
            results[sub] = got
            app_gap = calibration_gap(got, want)
            misses = [v for v in CALIB_CV2_MISSES if v.startswith(sub + '/')]
            if not misses and (app_gap['f_rel'] > tol['app_f_rtol']
                               or app_gap['pp_px'] > tol['app_pp_px']
                               or app_gap['rms_px'] > tol['app_rms_px']):
                fail(name, f'{sub}: the app against the JAX app\'s cv2 result: {app_gap}')
            phase(name, f'{sub}: calibrate_camera on cv2\'s corners of {len(imgs)} views in '
                        f'{solve_s:.3f} s: K {k_rel:.3g} relative, rms {gap["rms_px"]:.3g} px, '
                        f'displacement {gap["displacement_px"]:.3g} px from cv2; apps.'
                        f'calibrate_camera.main on {run["images"]} in {app_s:.2f} s: rms '
                        f'{got["rms_reprojection_error"]:.6f} px, fx fy '
                        f'{got["intrinsic_matrix"][0][0]:.3f} {got["intrinsic_matrix"][1][1]:.3f}, '
                        f'against the JAX app: fx/fy {app_gap["f_rel"]:.3g} relative, principal '
                        f'point {app_gap["pp_px"]:.3g} px, rms {app_gap["rms_px"]:.3g} px'
                        + (f' (the port also uses {misses})' if misses else ''))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    truth = dict(intrinsic_matrix=manifest['k_true'], distortion_coeffs=manifest['dist_true'],
                 image_shape=results['b']['image_shape'], rms_reprojection_error=0.0)
    truth_gap = calibration_gap(results['b'], truth)
    if (truth_gap['f_rel'] > tol['truth_f_rtol']
            or truth_gap['displacement_px'] > tol['truth_displacement_px']):
        fail(name, f'b: the calibrated camera against the true one: {truth_gap}')
    phase(name, f'b against the true camera: fx/fy {truth_gap["f_rel"]:.3g} relative, '
                f'principal point {truth_gap["pp_px"]:.3g} px, lens displacement '
                f'{truth_gap["displacement_px"]:.3g} px over the image')

    # One view of (b) rendered again where this script runs, held to its hashes.
    rec = manifest['views'][CALIB_RENDERED]
    t0 = time.perf_counter()
    rgb = calibration.render_checkerboard(**rec['render'])
    render_s = time.perf_counter() - t0
    if sha(rgb.tobytes()) != rec['sha256_rgb'] or sha(jpeg.encode(rgb)) != rec['file_sha256']:
        fail(name, f'{CALIB_RENDERED} renders to other pixels or bytes here')
    phase(name, f'{CALIB_RENDERED} rendered again in {render_s:.1f} s: RGB and JPEG equal the '
                f'fixture\'s hashes')

    # Serve with the camera calibrated from (b): K1 exact against its plain
    # version and within NATIVE_WARP_TOL of the C++ warp, crop by crop.
    cfg = ModelConfig(**manifest_for('bfloat16')['model_config'])
    variables = mint_crop_variables(cfg, torch.Generator().manual_seed(SEED))
    est = pose_estimator_from_variables(variables, manifest_for('bfloat16'), device=dev)
    k_cal = np.tile(np.asarray(results['b']['intrinsic_matrix'], np.float32)[None],
                    (N_FRAMES, 1, 1))
    d_cal = np.tile(np.asarray(results['b']['distortion_coeffs'], np.float32)[None],
                    (N_FRAMES, 1))
    run = lambda: est.estimate_poses_batched(
        frames, boxes, box_valid, intrinsic_matrix=k_cal, distortion_coeffs=d_cal,
        num_aug=NUM_AUG, internal_batch_size=INTERNAL_BATCH)
    run()  # warm-up
    torch.cuda.synchronize()
    warp_cuda.warp_pyramid.launches = mbconv_cuda.fused_mbconv_inner.launches = 0
    out = run()
    torch.cuda.synchronize()
    k1, k2 = warp_cuda.warp_pyramid.launches, mbconv_cuda.fused_mbconv_inner.launches
    chunks = math.ceil(int(box_valid.sum()) / (INTERNAL_BATCH // NUM_AUG))
    if k1 != chunks or k2 != 0:
        fail(name, f'K1 launched {k1} times and K2 {k2}, expected {chunks} and 0')
    check_served_poses(out, dev, box_valid, name)
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    natives = []
    again, errors = checked_warps(run, native_errors=natives)
    native_err = max((e for e, _, _ in natives), default=math.inf)
    n_native = sum(n for _, n, _ in natives)
    n_skipped = sum(s for _, _, s in natives)
    check_served_poses(again, dev, box_valid, name)
    if len(errors) != chunks or max(errors) != 0.0 or not native_err <= NATIVE_WARP_TOL:
        fail(name, f'{len(errors)} K1 launches checked: max |kernel - plain| '
                   f'{max(errors, default=math.inf):.3g} (must be 0), max |kernel - native| '
                   f'{native_err:.3g} (tol {NATIVE_WARP_TOL}) over {n_native} crops')
    phase(name, f'estimate_poses_batched EffNetV2-S@{PROC_SIDE} bf16 folded with the camera '
                f'calibrated from b (k1 {results["b"]["distortion_coeffs"][0]:.4f}), '
                f'{N_FRAMES}x{FRAME_H}p, {BOXES_PER_FRAME} boxes per frame, num_aug {NUM_AUG}: '
                f'K1 {k1}, K2 {k2}; {statistics.median(times) * 1e3:.1f} ms per call (median '
                f'of 5); every K1 launch against the plain warp: max |kernel - plain| '
                f'{max(errors):.3g}; against the C++ warp: {n_native} crops, max |kernel - '
                f'native| {native_err:.3g} (tol {NATIVE_WARP_TOL}; {n_skipped} padding crops '
                f'of degenerate boxes skipped)')
    return {'calibrate': (k1, k2)}


# The [parallel] phase: (a) in this process on NCCL, (b) and (c) on
# PARALLEL_RANKS processes sharing cuda:0 over gloo.
PARALLEL_RANKS = 2
# Shards the weights of at least 4096 elements over 'model' in (c): every
# fused block's depthwise weight among them (E >= 456), so that K2 runs on
# channel slices.
PARALLEL_TP_MIN_SIZE = 2 ** 12
PARALLEL_STEP_BATCH = 32  # per stream, global: 16 + 16 per rank in (b)
# The running statistics of (b)'s and (c)'s steps: each is a mean over up to
# 64 x 128 x 128 float32 values per channel, which the data-parallel step
# sums in another order (each rank's rows, then the all-reduce) than the
# one-rank mean; a running mean near 0 then differs by ~1.2e-7 absolute on
# an H100, above tests/_torch_train.py's 1e-7 for 4-crop batches.
PARALLEL_STATS_ATOL = 1e-6
PARALLEL_DEADLINE_S = 480
PARALLEL_PG_TIMEOUT = 300  # seconds a rank waits in a collective before it fails
PARALLEL_DETECT = dict(num_aug=NUM_AUG, max_detections=MAX_DETECTIONS,
                       internal_batch_size=INTERNAL_BATCH, detector_threshold=0.0,
                       suppress_implausible_poses=True)
# (c)'s float32 serve: 4 detections per frame, one chunk (its sharded
# convolutions' activations, ~4 GB a chunk, go through host copies).
PARALLEL_TP_DETECT = dict(PARALLEL_DETECT, max_detections=4)
# (c)'s step shards at JAX's default size (94 of the 170 convolutions).
PARALLEL_TP_STEP_MIN_SIZE = 2 ** 16


class BlockwiseDetector:
    """`detector` run on each of `n` equal blocks of the frame batch in
    turn, as `n` 'data' ranks run it. A serve held against a data-parallel
    one detects in the same blocks: cuDNN picks its algorithms by batch
    size, and at threshold 0 scores that tie within their rounding change
    places, which puts other boxes in a slot."""

    def __init__(self, detector, n: int):
        self.detector, self.n = detector, n

    def detect_batched(self, images, **kwargs):
        parts = [self.detector.detect_batched(block, **kwargs) for block in images.chunk(self.n)]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


class CollectiveMeter:
    """While entered: the calls, bytes and seconds of `parallel.mesh`'s
    collectives, which all go through `all_reduce_tensor` (bytes: the
    tensor's) and `all_gather_tensors` (bytes: the gathered tensors'), each
    timed on the host between device synchronisations."""

    def __init__(self):
        self.calls, self.bytes, self.seconds = 0, 0, 0.0

    def __enter__(self):
        from metrabs_tpu_torch.parallel import mesh as mesh_mod

        def timed(fn, n_bytes):
            def wrapped(x, group, *args):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(x, group, *args)
                torch.cuda.synchronize()
                self.seconds += time.perf_counter() - t0
                self.calls += 1
                self.bytes += n_bytes(x, *args)
                return out
            return wrapped

        self._saved = (mesh_mod.all_reduce_tensor, mesh_mod.all_gather_tensors)
        mesh_mod.all_reduce_tensor = timed(self._saved[0],
                                           lambda x: x.numel() * x.element_size())
        mesh_mod.all_gather_tensors = timed(self._saved[1],
                                            lambda x, n: n * x.numel() * x.element_size())
        return self

    def __exit__(self, *exc):
        from metrabs_tpu_torch.parallel import mesh as mesh_mod
        mesh_mod.all_reduce_tensor, mesh_mod.all_gather_tensors = self._saved
        return False

    def summary(self) -> dict:
        return dict(calls=self.calls, mb=self.bytes / 1e6, ms=self.seconds * 1e3)


def describe(c: dict) -> str:
    return f'{c["calls"]} collectives, {c["mb"]:.1f} MB, {c["ms"]:.1f} ms'


def global_train_batch(dev):
    """The (3D, 2D) global batches of PARALLEL_STEP_BATCH synthetic examples
    each, on `dev`."""
    return [{k: torch.as_tensor(np.stack([synthetic_example(i, s)[k] for i in ids])).to(dev)
             for k in synthetic_example(0, s)}
            for s, ids in (('3d', range(PARALLEL_STEP_BATCH)),
                           ('2d', range(100, 100 + PARALLEL_STEP_BATCH)))]


def timed_step(state, step, b3, b2, dev):
    """One step with the drop-connect masks and the mix drawn from a seeded
    generator on `dev` (every rank alike), under a `CollectiveMeter`:
    (step_record, host ms, collectives)."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    with CollectiveMeter() as meter:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = step(state, b3, b2, generator=gen)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    return step_record(state, losses), ms, meter.summary()


def parallel_nccl(dev) -> dict:
    """(a): `make_sharded_train_step` on a one-rank NCCL group at
    EffNetV2-S@256 bf16, 32 + 32, against the plain step from the same
    state, batch and generator."""
    import datetime

    import torch.distributed as dist

    from metrabs_tpu_torch.config import ModelConfig, TrainConfig
    from metrabs_tpu_torch.parallel import mesh as mesh_mod
    from metrabs_tpu_torch.train import loop

    name = 'parallel'
    cfg = ModelConfig(**manifest_for('bfloat16')['model_config'])
    tcfg = TrainConfig()
    variables = mint_crop_variables(cfg, torch.Generator().manual_seed(tcfg.seed))
    b3, b2 = global_train_batch(dev)
    mesh_mod.init_process_group('nccl', f'tcp://localhost:{free_port()}', 0, 1, device=dev,
                                timeout=datetime.timedelta(seconds=PARALLEL_PG_TIMEOUT))
    # Deterministic cuDNN algorithms: the two steps then differ only where
    # the sharded one does (bf16 rounding would show run-to-run atomics).
    torch.backends.cudnn.deterministic = True
    try:
        mesh = mesh_mod.make_mesh(1, 1)
        state, step = make_trainer(cfg, tcfg, variables, dev)
        sharded = loop.make_sharded_train_step(step, mesh)
        timed_step(state, sharded, b3, b2, dev)  # warm-up (cuDNN algorithm selection)
        state, step = make_trainer(cfg, tcfg, variables, dev)
        got, ms, collectives = timed_step(state, loop.make_sharded_train_step(step, mesh),
                                          b3, b2, dev)
        del state
        state, step = make_trainer(cfg, tcfg, variables, dev)
        want, plain_ms, _ = timed_step(state, step, b3, b2, dev)
        del state
    finally:
        torch.backends.cudnn.deterministic = False
        dist.destroy_process_group()
    worst, ok = step_deviations(got, want, tcfg)
    if not ok or collectives['calls'] != 1:
        fail(name, f'(a) the NCCL one-rank sharded step against the plain step: {worst}, '
                   f'{describe(collectives)} (one gradient all-reduce expected)')
    phase(name, f'(a) NCCL, world 1: make_sharded_train_step EffNetV2-S@{PROC_SIDE} bf16 '
                f'{PARALLEL_STEP_BATCH}+{PARALLEL_STEP_BATCH} against the plain step: '
                + ', '.join(f'{k} {v:.3g}' for k, v in worst.items())
                + f'; step {ms:.1f} ms (plain {plain_ms:.1f} ms); gradient all-reduce: '
                + describe(collectives))
    return dict(step_ms=ms, plain_ms=plain_ms, collectives=collectives)


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def parallel_rank(rank: int, port: int, payload: bytes, results) -> None:
    """A rank of parts (b) and (c): its results, or its traceback, on
    `results`."""
    import pickle
    import traceback

    import torch.distributed as dist
    try:
        results.put((rank, 'ok', parallel_rank_work(rank, port, pickle.loads(payload))))
    except BaseException:
        results.put((rank, 'error', traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def detect_checked(detect):
    """One `detect()` with every K1 and K2 launch held against its plain
    version: (output, K1 launches, K2 launches, max K1 error, max K2 v
    error, max K2 mean error)."""
    (out, warp_errs), v_errs, mean_errs = checked_mbconv(lambda: checked_warps(detect))
    return (out, len(warp_errs), len(v_errs), max(warp_errs, default=math.inf),
            max(v_errs, default=math.inf), max(mean_errs, default=math.inf))


def poses_within(got: dict, want: dict) -> tuple:
    """(valid masks equal, max |dpose| mm, poses within POSE_ATOL_MM + POSE_RTOL
    on the rows the detector found)."""
    rows = want['boxes'][..., 4] > 0
    g, w = got['poses3d'][rows].float().cpu(), want['poses3d'][rows].float().cpu()
    return (torch.equal(got['valid'].cpu(), want['valid'].cpu()),
            (g - w).abs().max().item(),
            bool(torch.allclose(g, w, atol=POSE_ATOL_MM, rtol=POSE_RTOL)))


def parallel_rank_work(rank: int, port: int, payload: dict) -> dict:
    import datetime

    from metrabs_tpu_torch.config import ModelConfig, TrainConfig
    from metrabs_tpu_torch.io.packaging import pose_estimator_from_variables
    from metrabs_tpu_torch.models.backbones.builder import build_backbone
    from metrabs_tpu_torch.ops import cuda_build, mbconv_cuda, warp_cuda
    from metrabs_tpu_torch.parallel import mesh as mesh_mod
    from metrabs_tpu_torch.train import loop

    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    for source in ('warp', 'mbconv'):
        cuda_build.build_library(source)  # built by the parent: found by its hash
    mesh_mod.init_process_group('gloo', f'tcp://localhost:{port}', rank, PARALLEL_RANKS,
                                timeout=datetime.timedelta(seconds=PARALLEL_PG_TIMEOUT))
    out = {}
    counts = lambda: (warp_cuda.warp_pyramid.launches, mbconv_cuda.fused_mbconv_inner.launches)

    def reset():
        torch.cuda.synchronize()
        warp_cuda.warp_pyramid.launches = mbconv_cuda.fused_mbconv_inner.launches = 0

    # The main phase's frames and minted weights, made as main() makes them.
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    frames = synthetic_frames(gen, dev)
    cpu_gen = torch.Generator().manual_seed(SEED)
    cfg = ModelConfig(**manifest_for('bfloat16')['model_config'])
    variables = mint_crop_variables(cfg, cpu_gen)
    det_variables = mint_detector_variables(cpu_gen)

    def estimator(dtype, mesh, tp_min_size=None):
        return pose_estimator_from_variables(
            variables, detect_manifest_for(dtype), device=dev, cfg_overrides={'bn_fold': False},
            detector_variables=det_variables,
            backbone_builder=functools.partial(build_backbone, fuse_mbconv='on'), mesh=mesh,
            tp_min_size=tp_min_size)

    def serve(key, est, kwargs, want, profile=False):
        detect = lambda: est.detect_poses_batched(frames, **kwargs)
        detect()  # warm-up (cuDNN algorithm selection)
        reset()
        with CollectiveMeter() as meter:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = detect()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        k1, k2 = counts()
        _, n1, n2, err1, err_v, err_mean = detect_checked(detect)
        wall_ms = busy_ms = None
        if profile:
            from torch.autograd import DeviceType
            events, wall_ms = profiled(detect, 'parallel')
            busy_ms = sum(e.device_time_total for e in events
                          if e.device_type == DeviceType.CUDA) / 1e3
        equal, err, within = poses_within(got, want)
        out[f'{key}_detect'] = dict(
            k1=k1, k2=k2, checked=(n1, n2), errors=(err1, err_v, err_mean), ms=ms,
            wall_ms=wall_ms, busy_ms=busy_ms, valid_equal=equal, pose_err=err,
            within=within, collectives=meter.summary(),
            n_detected=int((got['boxes'][..., 4] > 0).sum()),
            n_sharded=sum(mesh_mod.is_sharded(p) for p in est.crop_model.parameters()),
            n_sharded_dw=sum(mesh_mod.is_sharded(p) for n, p in
                             est.crop_model.named_parameters() if 'depthwise' in n))

    # (b) Data-parallel detect over a (2, 1) mesh, against the one-rank serve.
    mesh_dp = mesh_mod.make_mesh(PARALLEL_RANKS, 1)
    serve('dp', estimator('bfloat16', mesh_dp), PARALLEL_DETECT,
          {k: v.to(dev) for k, v in payload['one_rank'].items()}, profile=True)
    torch.cuda.empty_cache()

    # (c) The tensor-parallel fused serve over a (1, 2) mesh, in float32
    # (TF32 off), against (b)'s data-parallel serve in float32: each of
    # its convolutions computes on a slice of the out-channels, which bf16
    # would round apart from the whole convolution.
    mesh_tp = mesh_mod.make_mesh(1, PARALLEL_RANKS)
    with torch.inference_mode():
        want = estimator('float32', mesh_dp).detect_poses_batched(frames, **PARALLEL_TP_DETECT)
    torch.cuda.empty_cache()
    est = estimator('float32', mesh_tp, PARALLEL_TP_MIN_SIZE)
    est.detector = BlockwiseDetector(est.detector, PARALLEL_RANKS)
    serve('tp', est, PARALLEL_TP_DETECT, want)
    del est, want
    torch.cuda.empty_cache()

    # The steps in float32 (TF32 off), where the parity tolerance holds:
    # the one-rank step on the global batch, (b) data-parallel, (c)
    # tensor-parallel, each from the same state, batch and generator.
    cfg32 = dataclasses.replace(cfg, dtype='float32')
    tcfg = TrainConfig()
    train_vars = mint_crop_variables(cfg, torch.Generator().manual_seed(tcfg.seed))
    b3, b2 = global_train_batch(dev)
    records = {}
    for key, mesh, min_size in (('one', None, None), ('dp', mesh_dp, None),
                                ('tp', mesh_tp, PARALLEL_TP_STEP_MIN_SIZE)):
        state, step = make_trainer(cfg32, tcfg, train_vars, dev)
        if mesh is not None:
            shardings = (None if min_size is None
                         else mesh_mod.tp_shardings(mesh, state, min_size=min_size))
            step = loop.make_sharded_train_step(step, mesh, state_shardings=shardings)
        reset()
        records[key], ms, collectives = timed_step(state, step, b3, b2, dev)
        out[f'{key}_train'] = dict(ms=ms, collectives=collectives, launches=counts(),
                                   n_sharded=len(state.sharded))
        del state, step
        torch.cuda.empty_cache()
    out['dp_train']['worst'], out['dp_train']['ok'] = step_deviations(
        records['dp'], records['one'], tcfg, PARALLEL_STATS_ATOL)
    # (c) against the one-rank step within the parity tolerance, and against
    # (b)'s step within twice it: each holds the one-rank step within it.
    worst_one, ok_one = step_deviations(records['tp'], records['one'], tcfg, PARALLEL_STATS_ATOL)
    out['tp_train']['worst'], ok_dp = step_deviations(records['tp'], records['dp'], tcfg,
                                                      PARALLEL_STATS_ATOL, rel_scale=2.0)
    out['tp_train']['ok'] = ok_one and ok_dp
    out['tp_train']['worst_one'] = worst_one
    out['checksum'] = float(sum(v.double().sum() for v in records['dp']['params'].values()))
    return out


def parallel_phase(dev, frames) -> dict:
    """The [parallel] phase (module docstring). Returns the K1 and K2
    launches of its paths, summed over the ranks."""
    import multiprocessing
    import pickle
    import queue

    from metrabs_tpu_torch.io.packaging import pose_estimator_from_variables
    from metrabs_tpu_torch.models.backbones.builder import build_backbone
    from metrabs_tpu_torch.models.metrabs import ModelConfig

    name = 'parallel'
    start = time.perf_counter()
    nccl = parallel_nccl(dev)
    torch.cuda.empty_cache()

    # The one-rank serve of (b), made here as the detect phase makes it, its
    # detector run on each rank's frames in turn (`BlockwiseDetector`).
    cpu_gen = torch.Generator().manual_seed(SEED)
    cfg = ModelConfig(**manifest_for('bfloat16')['model_config'])
    variables = mint_crop_variables(cfg, cpu_gen)
    est = pose_estimator_from_variables(
        variables, detect_manifest_for('bfloat16'), device=dev, cfg_overrides={'bn_fold': False},
        detector_variables=mint_detector_variables(cpu_gen),
        backbone_builder=functools.partial(build_backbone, fuse_mbconv='on'))
    est.detector = BlockwiseDetector(est.detector, PARALLEL_RANKS)
    torch.backends.cudnn.deterministic = True  # as in the ranks
    try:
        one_rank = {k: v.cpu()
                    for k, v in est.detect_poses_batched(frames, **PARALLEL_DETECT).items()}
    finally:
        torch.backends.cudnn.deterministic = False
    del est
    torch.cuda.empty_cache()

    ctx = multiprocessing.get_context('spawn')
    results, port = ctx.Queue(), free_port()
    payload = pickle.dumps(dict(one_rank=one_rank))
    procs = [ctx.Process(target=parallel_rank, args=(rank, port, payload, results), daemon=True)
             for rank in range(PARALLEL_RANKS)]
    t_spawn = time.perf_counter()
    for p in procs:
        p.start()
    ranks, errors = {}, []
    try:
        while len(ranks) + len(errors) < PARALLEL_RANKS:
            left = PARALLEL_DEADLINE_S - (time.perf_counter() - t_spawn)
            try:
                rank, status, value = results.get(timeout=max(left, 1.0))
            except queue.Empty:
                fail(name, f'ranks {sorted(set(range(PARALLEL_RANKS)) - set(ranks))} did not '
                           f'finish within {PARALLEL_DEADLINE_S} s')
            if status != 'ok':
                fail(name, f'rank {rank} failed:\n{value}')
            ranks[rank] = value
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    r = [ranks[i] for i in range(PARALLEL_RANKS)]
    if len({x['checksum'] for x in r}) != 1:
        fail(name, f'the data-parallel step left the ranks with different parameters: '
                   f'{[x["checksum"] for x in r]}')
    per_chunk = INTERNAL_BATCH // NUM_AUG
    n_detected = int((one_rank['boxes'][..., 4] > 0).sum())
    chunks = math.ceil(n_detected / per_chunk)
    shares = [len(range(i, chunks, PARALLEL_RANKS)) for i in range(PARALLEL_RANKS)]
    tp_chunks = math.ceil(r[0]['tp_detect']['n_detected'] / per_chunk)
    by_path, launches = {}, {}
    for key, against, per_rank in (('dp', 'the one-rank serve', shares),
                                   ('tp', '(b) in float32', [tp_chunks] * PARALLEL_RANKS)):
        d = [x[f'{key}_detect'] for x in r]
        launches[key] = [(x['k1'], x['k2']) for x in d]
        want = [(c, K2_BLOCKS * c) for c in per_rank]
        if launches[key] != want or [x['checked'] for x in d] != want:
            fail(name, f'{key} detect: K1 and K2 launches per rank {launches[key]} (checked '
                       f'{[x["checked"] for x in d]}), expected {want}')
        if any(x['errors'][0] != 0.0 or x['errors'][1] != 0.0
               or not x['errors'][2] <= K2_MEAN_TOL['atol'] for x in d):
            fail(name, f'{key} detect: max |kernel - plain| (K1, K2 v, K2 mean) per rank '
                       f'{[x["errors"] for x in d]}')
        if not all(x['valid_equal'] and x['within'] for x in d):
            fail(name, f'{key} detect against {against}: valid equal '
                       f'{[x["valid_equal"] for x in d]}, max |dpose| '
                       f'{[x["pose_err"] for x in d]} mm')
        by_path[f'parallel_{key}_detect'] = tuple(map(sum, zip(*launches[key])))
    if r[0]['tp_detect']['n_sharded_dw'] == 0:
        fail(name, '(c) no depthwise weight was sharded: K2 never ran on a channel slice')
    d0, c0 = r[0]['dp_detect'], r[0]['tp_detect']
    t_one, t_dp, t_tp = (r[0][f'{k}_train'] for k in ('one', 'dp', 'tp'))
    worst = lambda t: ', '.join(f'{k} {v:.3g}' for k, v in t['worst'].items())
    max_of = lambda key, field, i=None: max(
        x[key][field] if i is None else x[key][field][i] for x in r)
    per_rank = PARALLEL_STEP_BATCH // PARALLEL_RANKS
    phase(name, f'(b) {PARALLEL_RANKS} ranks sharing cuda:0 over gloo, (2, 1) mesh: '
                f'detect_poses_batched YOLOv4-{DETECTOR_SIZE} + EffNetV2-S@{PROC_SIDE} bf16 '
                f'fused, {N_FRAMES}x{FRAME_H}p, {n_detected} detections, {chunks} chunks dealt '
                f'{shares}: K1/K2 per rank {launches["dp"]}, every launch exact against the '
                f'plain versions (K2 mean max {max_of("dp_detect", "errors", 2):.3g}); valid '
                f'equal to the one-rank serve, max |dpose| {max_of("dp_detect", "pose_err"):.3g} '
                f'mm; call {d0["ms"]:.1f} ms on rank 0, {describe(d0["collectives"])}; under '
                f'torch.profiler wall {d0["wall_ms"]:.1f} ms, device busy {d0["busy_ms"]:.2f} '
                f'ms ({100 * d0["busy_ms"] / d0["wall_ms"]:.1f}%, the card shared by both ranks)')
    phase(name, f'(b) float32 step, {per_rank}+{per_rank} per rank against the one-rank step on '
                f'{PARALLEL_STEP_BATCH}+{PARALLEL_STEP_BATCH}: {worst(t_dp)}; ranks equal; step '
                f'{t_dp["ms"]:.1f} ms (one rank {t_one["ms"]:.1f} ms, the process\'s first '
                f'float32 step), {describe(t_dp["collectives"])}')
    phase(name, f'(c) (1, 2) mesh, tp_min_size {PARALLEL_TP_MIN_SIZE}: {c0["n_sharded"]} '
                f'crop-model weights sharded ({c0["n_sharded_dw"]} depthwise: K2 on channel '
                f'slices); the fused detect in float32, max_detections '
                f'{PARALLEL_TP_DETECT["max_detections"]} (chunks: {tp_chunks}), K1/K2 per rank '
                f'{launches["tp"]}, every launch exact; valid equal to (b)\'s float32 serve, max '
                f'|dpose| {max_of("tp_detect", "pose_err"):.3g} mm; call '
                f'{c0["ms"]:.1f} ms, {describe(c0["collectives"])}; float32 step, tp_min_size '
                f'{PARALLEL_TP_STEP_MIN_SIZE} ({t_tp["n_sharded"]} parameters sharded), against '
                f'the one-rank step: '
                + ', '.join(f'{k} {v:.3g}' for k, v in t_tp['worst_one'].items())
                + f'; against (b) (twice the relative limits): {worst(t_tp)}; step '
                f'{t_tp["ms"]:.1f} ms, {describe(t_tp["collectives"])}')
    for key, against in (('dp', 'the one-rank step'), ('tp', '(b)')):
        t = [x[f'{key}_train'] for x in r]
        if not all(x['ok'] for x in t) or any(x['launches'] != (0, 0) for x in t):
            fail(name, f'{key} step against {against}: {[x["worst"] for x in t]}, K1/K2 '
                       f'launches {[x["launches"] for x in t]}')
        by_path[f'parallel_{key}_train'] = (0, 0)
    phase(name, f'{time.perf_counter() - start:.1f} s ((a) and the one-rank serve '
                f'{t_spawn - start:.1f} s)')
    return by_path, dict(nccl=nccl, ranks=r)


def main() -> None:
    root = Path(__file__).resolve().parent
    if not (root / 'metrabs_tpu_torch' / 'csrc' / 'warp.cu').exists():
        fail('device', f'{root} is not a checkout of the repository')
    sys.path.insert(0, str(root))

    # 1. Device.
    if not torch.cuda.is_available():
        fail('device', 'torch.cuda.is_available() is False; this smoke run needs a GPU')
    dev = torch.device('cuda', 0)
    card = card_name()
    if card == CARD_UNKNOWN:
        fail('device', 'nvidia-smi failed')
    phase('device', f'{torch.cuda.get_device_name(0)}; torch {torch.__version__}, '
                    f'CUDA {torch.version.cuda}')
    print(card, flush=True)
    # Every float32 check below runs without TF32 (cuDNN would use it for
    # float32 convolutions by default).
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # 2. Build: one nvcc per kernel source and the host compiler for the JPEG
    # decoder and encoder, the mp4v codec, the H.264 and HEVC decoders, the
    # native image ops and the PNG, WebP, TIFF and raster decoders, started
    # together.
    from metrabs_tpu_torch.ops import cuda_build, mbconv_cuda
    from metrabs_tpu_torch.ops import warp as warp_ops
    from metrabs_tpu_torch.ops import warp_cuda
    sources = ('warp', 'mbconv')
    start = time.perf_counter()
    host_sources = ('jpeg_decode', 'jpeg_encode', 'mpeg4_video', 'h264_decode', 'hevc_decode',
                    'improc', 'png_decode', 'webp_decode', 'tiff_decode', 'raster_decode')
    with concurrent.futures.ThreadPoolExecutor(len(sources) + len(host_sources)) as pool:
        host_builds = [pool.submit(cuda_build.build_host_library, h) for h in host_sources]
        built = list(pool.map(cuda_build.build_library, sources))
        host_built = [b.result() for b in host_builds]
    for name, (lib_path, build_s) in zip(sources, built):
        phase('build', f'nvcc {" ".join(cuda_build.NVCC_FLAGS)} '
                       f'{cuda_build.source_path(name).name} -> {lib_path.name} in {build_s:.2f} s')
    for name, (host_lib, host_s) in zip(host_sources, host_built):
        phase('build', f'{os.environ.get("CXX") or "c++"} {" ".join(cuda_build.CXX_FLAGS)} '
                       f'{name}.cpp -> {host_lib.name} in {host_s:.2f} s')
    phase('build', f'all {len(sources) + len(host_sources)} in '
                   f'{time.perf_counter() - start:.2f} s')

    # 3. The warp kernel against its plain version at the serving shape.
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    frames = synthetic_frames(gen, dev)
    flat, level_info, per_image_len = warp_ops.build_flat_pyramid(
        (frames.float() / 255.0) ** 2.2, 3)
    case = warp_case(dev)
    params, geom = warp_ops.pyramid_warp_params(
        level_info=level_info, per_image_len=per_image_len, **case)
    levels = sorted({int(i) for i in warp_ops.select_pyramid_level(
        case['crop_scales'], case['intrinsic_matrix'], 3)[0].tolist()})
    if levels != [0, 1, 2]:
        fail('kernel', f'the check must cover levels 0-2, got {levels}')
    side = (PROC_SIDE, PROC_SIDE)
    got = warp_cuda.warp_pyramid(flat, params, geom, side)
    want = warp_ops.warp_pyramid(flat, params, geom, side)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        fail('kernel', 'non-finite kernel output')
    if got[-1].abs().max().item() != 0.0:
        fail('kernel', 'the crop outside its frame must sample only the zero border')
    max_err = (got - want).abs().max().item()
    if not max_err <= WARP_TOL:
        fail('kernel', f'max |kernel - plain| = {max_err:.3g} > {WARP_TOL}')
    native_err, native_n, _ = native_warp_error(flat, params, geom, side, got)
    if not native_err <= NATIVE_WARP_TOL or native_n != len(got):
        fail('kernel', f'{native_n} of {len(got)} crops against native.bilinear_warp: max '
                       f'|kernel - native| = {native_err:.3g} > {NATIVE_WARP_TOL}')
    phase('kernel', f'warp_pyramid against the C++ warp (utils/native.py, level images of '
                    f'build_flat_pyramid, level-adjusted K): all {native_n} crops, max '
                    f'|kernel - native| = {native_err:.3g} (tol {NATIVE_WARP_TOL})')
    k1 = lambda: warp_cuda.warp_pyramid(flat, params, geom, side)
    k1_bytes, k1_bound_ms, k1_bound_by = k1_bound(flat, params, geom, side)
    kernel_ms = timed_against_bound('warp_pyramid', k1, k1_bound_ms)
    k1_event_ms = cuda_time_ms(k1)
    plain_ms = device_time_ms(lambda: warp_ops.warp_pyramid(flat, params, geom, side))
    phase('kernel', f'warp_pyramid {tuple(got.shape)}: max |kernel - plain| = {max_err:.3g} '
                    f'(tol {WARP_TOL}); kernel {kernel_ms:.4f} ms, {k1_bytes / 1e6:.1f} MB '
                    f'(output and distinct pyramid pixels), bound {k1_bound_ms:.4f} ms '
                    f'({k1_bound_by}), {100 * k1_bound_ms / kernel_ms:.1f}% of bound; plain '
                    f'torch {plain_ms:.4f} ms (device time, mean of 25); kernel '
                    f'{k1_event_ms:.4f} ms between CUDA events (median of 25 single calls)')
    del flat, got, want
    k2_results = check_k2(gen, dev)

    # 4. The main path.
    from metrabs_tpu_torch.io.packaging import pose_estimator_from_variables
    from metrabs_tpu_torch.models.metrabs import ModelConfig
    cpu_gen = torch.Generator().manual_seed(SEED)
    cfg = ModelConfig(**manifest_for('bfloat16')['model_config'])
    variables = mint_crop_variables(cfg, cpu_gen)
    est = pose_estimator_from_variables(variables, manifest_for('bfloat16'), device=dev)
    if not est.cfg.bn_fold or est.cfg.dtype != 'bfloat16':
        fail('main', f'expected the folded bf16 serving model, got {est.cfg}')

    crops = torch.rand((2, 4, PROC_SIDE, PROC_SIDE, 3), generator=gen, device=dev)
    k_crop = torch.tensor([[[300.0, 0, 128], [0, 300.0, 128], [0, 0, 1]]], device=dev)
    with torch.inference_mode():
        sens = [est.crop_model(c.bfloat16(), k_crop.expand(4, 3, 3)) for c in crops]
    sensitivity = (sens[0] - sens[1]).abs().max().item()
    if not sensitivity > 100 * POSE_ATOL_MM:
        fail('main', f'random crop model ignores its input ({sensitivity:.3g} mm)')

    boxes, box_valid = synthetic_boxes()
    run = lambda: est.estimate_poses_batched(
        frames, boxes, box_valid, num_aug=NUM_AUG, internal_batch_size=INTERNAL_BATCH)
    run()  # warm-up (cuDNN algorithm selection)
    torch.cuda.synchronize()
    warp_cuda.warp_pyramid.launches = mbconv_cuda.fused_mbconv_inner.launches = 0
    out = run()
    torch.cuda.synchronize()
    launches = warp_cuda.warp_pyramid.launches
    main_k2_launches = mbconv_cuda.fused_mbconv_inner.launches
    n_valid = int(box_valid.sum())
    expected_launches = math.ceil(n_valid / (INTERNAL_BATCH // NUM_AUG))
    shapes = {k: tuple(v.shape) for k, v in out.items()}
    want_shapes = dict(boxes=(8, 16, 5), poses3d=(8, 16, 17, 3), poses2d=(8, 16, 17, 2),
                       valid=(8, 16))
    if shapes != want_shapes:
        fail('main', f'output shapes {shapes} != {want_shapes}')
    valid_t = torch.as_tensor(box_valid, device=dev)
    if not torch.equal(out['valid'], valid_t):
        fail('main', 'valid mask differs from box_valid')
    for k in ('poses3d', 'poses2d'):
        if not torch.isfinite(out[k][valid_t]).all():
            fail('main', f'non-finite {k} on valid boxes')
    if launches != expected_launches:
        fail('main', f'warp kernel launched {launches} times, expected {expected_launches} '
                     f'(one per non-empty chunk)')

    # The float32 estimator on the GPU against the same one on the CPU.
    est32 = pose_estimator_from_variables(variables, manifest_for('float32'), device=dev)
    ref32 = pose_estimator_from_variables(variables, manifest_for('float32'), device='cpu')
    small = frames[:1, 400:700, 600:1000].contiguous()
    small_boxes = np.array([[[60, 20, 110, 250], [200, 40, 120, 240]]], np.float32)
    got32 = est32.estimate_poses_batched(small, small_boxes, num_aug=NUM_AUG)
    want32 = ref32.estimate_poses_batched(small.cpu(), small_boxes, num_aug=NUM_AUG)
    p_got, p_want = got32['poses3d'].cpu(), want32['poses3d']
    pose_err = (p_got - p_want).abs().max().item()
    if not torch.allclose(p_got, p_want, atol=POSE_ATOL_MM, rtol=POSE_RTOL):
        fail('main', f'float32 GPU poses differ from the CPU reference by {pose_err:.3g} mm')

    n_calls = 5
    times = []
    for _ in range(n_calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    call_s = statistics.median(times)
    phase('main', f'estimate_poses_batched EffNetV2-S@{PROC_SIDE} bf16 folded, '
                  f'{N_FRAMES}x{FRAME_H}p, {BOXES_PER_FRAME} boxes/frame ({n_valid} valid), '
                  f'num_aug {NUM_AUG}: warp launches {launches}; input sensitivity '
                  f'{sensitivity:.1f} mm; f32 GPU vs CPU max |dpose| {pose_err:.3g} mm; '
                  f'{call_s * 1e3:.1f} ms/call (median of {n_calls}), '
                  f'{n_valid * NUM_AUG / call_s:.1f} valid crops/s')

    if main_k2_launches != 0:
        fail('main', f'the folded model launched the MBConv kernel {main_k2_launches} times')

    # 5. The detect path: YOLOv4, the fused MBConv crop model, the filter.
    from metrabs_tpu_torch.models.backbones.builder import build_backbone
    fused_builder = functools.partial(build_backbone, fuse_mbconv='on')
    det_variables = mint_detector_variables(cpu_gen)
    unfolded = {'bn_fold': False}
    est_d = pose_estimator_from_variables(
        variables, detect_manifest_for('bfloat16'), device=dev, cfg_overrides=unfolded,
        detector_variables=det_variables, backbone_builder=fused_builder)
    fused_blocks = sum(getattr(b, 'fusable', False) and b.fuse == 'on'
                       for b in est_d.crop_model.backbone.blocks)
    if est_d.cfg.bn_fold or fused_blocks != K2_BLOCKS:
        fail('detect', f'expected the unfolded model with {K2_BLOCKS} fused blocks, got '
                       f'bn_fold={est_d.cfg.bn_fold} and {fused_blocks}')
    detect = lambda: est_d.detect_poses_batched(
        frames, num_aug=NUM_AUG, max_detections=MAX_DETECTIONS,
        internal_batch_size=INTERNAL_BATCH, detector_threshold=0.0,
        suppress_implausible_poses=True)
    detect()  # warm-up (cuDNN algorithm selection)
    with torch.inference_mode():
        _, det_valid = est_d.detector.detect_batched(frames, threshold=0.0,
                                                     max_detections=MAX_DETECTIONS)
    n_detected = int(det_valid.sum())
    torch.cuda.synchronize()
    warp_cuda.warp_pyramid.launches = mbconv_cuda.fused_mbconv_inner.launches = 0
    mbconv_cuda.fused_mbconv_inner.launches_by_shape.clear()
    out = detect()
    torch.cuda.synchronize()
    det_warp_launches = warp_cuda.warp_pyramid.launches
    det_k2_launches = mbconv_cuda.fused_mbconv_inner.launches
    det_k2_by_shape = dict(mbconv_cuda.fused_mbconv_inner.launches_by_shape)
    chunks = math.ceil(n_detected / (INTERNAL_BATCH // NUM_AUG))
    shapes = {k: tuple(v.shape) for k, v in out.items()}
    want_shapes = dict(boxes=(8, MAX_DETECTIONS, 5), poses3d=(8, MAX_DETECTIONS, 17, 3),
                       poses2d=(8, MAX_DETECTIONS, 17, 2), valid=(8, MAX_DETECTIONS))
    if shapes != want_shapes:
        fail('detect', f'output shapes {shapes} != {want_shapes}')
    if n_detected == 0 or (out['valid'] & ~det_valid).any():
        fail('detect', f'{n_detected} detections; the filter must only drop detections')
    for k in ('boxes', 'poses3d', 'poses2d'):
        if not torch.isfinite(out[k][det_valid]).all():
            fail('detect', f'non-finite {k} on detected rows')
    if det_warp_launches != chunks or det_k2_launches != K2_BLOCKS * chunks:
        fail('detect', f'warp kernel launched {det_warp_launches} times and MBConv kernel '
                       f'{det_k2_launches}, expected {chunks} and {K2_BLOCKS * chunks} '
                       f'({chunks} non-empty chunks)')
    # K2's launches per [E, H, W] and dtype in this run, against K2_CASES.
    by_case = {}
    for (n, e, h, w, dtype), count in det_k2_by_shape.items():
        by_case[(e, h, w, dtype)] = by_case.get((e, h, w, dtype), 0) + count
    want_by_case = {(*shape[1:], str(dtype)[6:]): per_chunk * chunks
                    for _, shape, dtype, per_chunk in K2_CASES if per_chunk}
    if by_case != want_by_case:
        fail('detect', f'MBConv launches per [E, H, W, dtype] {by_case}, expected '
                       f'{want_by_case}')
    for r in k2_results:
        r['detect_launches'] = by_case.get((*r['shape'][1:], r['dtype']), 0)
    k2_bound_call = sum(count * k2_bound((n, e, h, w), getattr(torch, dtype).itemsize)[1]
                        for (n, e, h, w, dtype), count in det_k2_by_shape.items())
    n_kept = int(out['valid'].sum())

    # The float32 detect estimator on the GPU against the same one on the CPU.
    ests32 = [pose_estimator_from_variables(
        variables, detect_manifest_for('float32'), device=d, cfg_overrides=unfolded,
        detector_variables=det_variables, backbone_builder=fused_builder)
        for d in (dev, 'cpu')]
    small = frames[:1, 300:660, 500:980].contiguous()
    small_kwargs = dict(num_aug=NUM_AUG, max_detections=4, detector_threshold=0.0,
                        suppress_implausible_poses=False)
    with torch.inference_mode():
        (b_got, v_got), (b_want, v_want) = [
            e.detector.detect_batched(x, threshold=0.0, max_detections=4)
            for e, x in zip(ests32, (small, small.cpu()))]
    box_err = (b_got.cpu() - b_want).abs().max().item()
    if not torch.equal(v_got.cpu(), v_want) or not box_err <= BOX_TOL_PX:
        fail('detect', f'float32 GPU detections differ from the CPU reference: masks '
                       f'{v_got.tolist()} vs {v_want.tolist()}, boxes by {box_err:.3g} px')
    got32, want32 = [e.detect_poses_batched(x, **small_kwargs)
                     for e, x in zip(ests32, (small, small.cpu()))]
    v32 = want32['valid']
    p_got, p_want = got32['poses3d'].cpu()[v32], want32['poses3d'][v32]
    det_pose_err = (p_got - p_want).abs().max().item()
    if not torch.equal(got32['valid'].cpu(), v32) or not torch.allclose(
            p_got, p_want, atol=POSE_ATOL_MM, rtol=POSE_RTOL):
        fail('detect', f'float32 GPU detect poses differ from the CPU reference by '
                       f'{det_pose_err:.3g} mm')
    del ests32

    times = []
    for _ in range(n_calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        detect()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    detect_s = statistics.median(times)
    phase('detect', f'detect_poses_batched YOLOv4-{DETECTOR_SIZE} bf16 + EffNetV2-S@{PROC_SIDE} '
                    f'bf16 unfolded, fuse_mbconv on, {N_FRAMES}x{FRAME_H}p, max_detections '
                    f'{MAX_DETECTIONS}, num_aug {NUM_AUG}, threshold 0: {n_detected} detections, '
                    f'{n_kept} after the plausibility filter; warp launches '
                    f'{det_warp_launches}, MBConv launches {det_k2_launches} ({chunks} chunks); '
                    f'f32 GPU vs CPU: masks equal, max |dbox| {box_err:.3g} px, max |dpose| '
                    f'{det_pose_err:.3g} mm; {detect_s * 1e3:.1f} ms/call (median of {n_calls}; '
                    f'all: {", ".join(f"{t * 1e3:.1f}" for t in times)})')
    wall_ms, device_ms, host_ms, busy_ms, n_kernels, counts = profile_detect(est_d, detect)
    phase('detect', f'one call under torch.profiler: wall {wall_ms:.1f} ms, device busy '
                    f'{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%), {n_kernels} kernels')
    for name in sorted(device_ms, key=device_ms.get, reverse=True):
        host = f', host {host_ms[name]:.2f} ms' if name in host_ms else ''
        launched = f', {counts[name]} launches' if name in counts else ''
        phase('detect', f'  {name}: device {device_ms[name]:.3f} ms '
                        f'({100 * device_ms[name] / busy_ms:.1f}% of busy){launched}{host}')
    if counts['K2 (mbconv kernel)'] != det_k2_launches:
        fail('detect', f'the profiler saw {counts["K2 (mbconv kernel)"]} MBConv kernels, the '
                       f'wrapper counted {det_k2_launches}')
    phase('detect', f'K2 per call: {det_k2_launches} launches ('
                    + ', '.join(f'{list(k[:4])} {k[4]}: {c}' for k, c in det_k2_by_shape.items())
                    + f'), device {device_ms["K2 (mbconv kernel)"]:.3f} ms against a bound of '
                      f'{k2_bound_call:.3f} ms for these launches')

    # 5b. The measuring tools on the detect cell.
    start = time.perf_counter()
    tools_by_path = tools_phase(root, est_d, frames, dev, chunks)
    phase('tools', f'{time.perf_counter() - start:.1f} s')

    # 6. The trainer, then the trained weights served through K1 and K2.
    del est, est32, ref32, est_d
    torch.cuda.empty_cache()
    shutil.rmtree(root / TRAINED_PACKAGE, ignore_errors=True)
    try:
        start = time.perf_counter()
        serve = train_phase(root, dev, frames, boxes, box_valid)
        phase('train', f'{time.perf_counter() - start:.1f} s')

        # 6b. Every other crop-model family trained, scored and served.
        torch.cuda.empty_cache()
        start = time.perf_counter()
        by_path = train_families_phase(root, dev, frames, boxes, box_valid,
                                       root / TRAINED_PACKAGE)
        by_path.update(tools_by_path)
        phase('train_families', f'{time.perf_counter() - start:.1f} s')
    finally:
        shutil.rmtree(root / TRAINED_PACKAGE, ignore_errors=True)

    # 6c. The training app on dataset files, then its package served.
    torch.cuda.empty_cache()
    start = time.perf_counter()
    by_path.update(train_app_phase(root, dev, frames, boxes, box_valid, serve['step_s']))
    phase('train_app', f'{time.perf_counter() - start:.1f} s')

    # 7. The other model families.
    torch.cuda.empty_cache()
    by_path.update(families_phase(root, dev, frames, boxes, box_valid))

    # 8. The released weight formats and the streaming entry points.
    torch.cuda.empty_cache()
    by_path.update(import_phase(root, dev, frames, boxes, box_valid))

    # 9. The benchmark drivers on JPEG frames.
    torch.cuda.empty_cache()
    start = time.perf_counter()
    by_path.update(bench_apps_phase(root, dev))
    phase('bench_apps', f'{time.perf_counter() - start:.1f} s')

    # 10. MPI-INF-3DHP's scoring path on 2048x2048 and 1920x1080 frames.
    torch.cuda.empty_cache()
    start = time.perf_counter()
    by_path.update(tdhp_phase(root, dev))
    phase('tdhp', f'{time.perf_counter() - start:.1f} s')

    # 11. The detector trainer, then the trained detector served.
    torch.cuda.empty_cache()
    start = time.perf_counter()
    by_path.update(detector_train_phase(root, dev))
    phase('detector_train', f'{time.perf_counter() - start:.1f} s')

    # 12. The train-to-serve run, cut, then its package served fused.
    torch.cuda.empty_cache()
    start = time.perf_counter()
    by_path.update(train2serve_phase(root, dev))
    phase('train2serve', f'{time.perf_counter() - start:.1f} s')

    # 13. The demos and the video path: encoder, video reader, demo_image,
    # demo_video (as is and streamed) and predict_aspset.
    torch.cuda.empty_cache()
    start = time.perf_counter()
    by_path.update(demos_phase(root, dev))
    phase('demos', f'{time.perf_counter() - start:.1f} s')

    # 13b. Still images: every fixture to cv2's hashes, phone-sized decodes,
    # demo_image on a turned WebP and a palette PNG.
    torch.cuda.empty_cache()
    start = time.perf_counter()
    images_by_path, _ = images_phase(root, dev)
    by_path.update(images_by_path)
    phase('images', f'{time.perf_counter() - start:.1f} s')

    # 14. Calibrate a camera from the checkerboard fixtures, then serve with it.
    torch.cuda.empty_cache()
    start = time.perf_counter()
    by_path.update(calibrate_phase(root, dev, frames, boxes, box_valid))
    phase('calibrate', f'{time.perf_counter() - start:.1f} s')

    # 15. Several ranks: NCCL in this process, then two ranks sharing the card.
    torch.cuda.empty_cache()
    parallel_by_path, _ = parallel_phase(dev, frames)
    by_path.update(parallel_by_path)

    # The card's name and power limit again, where a tail of the output keeps
    # them beside the numbers.
    print(card, flush=True)
    # No single PyTorch call computes either kernel's function: library_ms is
    # null (the unfused cuDNN chain's time stands beside K2 as unfused_ms).
    k2_main = k2_results[K2_MAIN_CASE]
    print(json.dumps({'kernels': [
        dict(name='warp_pyramid', route='cuda', source='metrabs_tpu_torch/csrc/warp.cu',
             replaces='metrabs_tpu/ops/warp_pallas.py:68', launches=det_warp_launches,
             launches_by_path=dict(main=launches, detect=det_warp_launches, train=0,
                                   serve_after_train=serve['k1'],
                                   **{k: v[0] for k, v in by_path.items()}),
             max_abs_err=max_err, ms=kernel_ms, event_ms=k1_event_ms, plain_ms=plain_ms,
             bytes=k1_bytes,
             bound_ms=k1_bound_ms, bound_by=k1_bound_by, bound_share=k1_bound_ms / kernel_ms,
             library_ms=None),
        dict(name='fused_mbconv_inner', route='cuda', source='metrabs_tpu_torch/csrc/mbconv.cu',
             replaces='metrabs_tpu/ops/mbconv_pallas.py:77', launches=det_k2_launches,
             launches_by_path=dict(main=main_k2_launches, detect=det_k2_launches, train=0,
                                   serve_after_train=serve['k2'],
                                   **{k: v[1] for k, v in by_path.items()}),
             max_abs_err=max(r['max_abs_err'] for r in k2_results), ms=k2_main['ms'],
             event_ms=k2_main['event_ms'], plain_ms=k2_main['plain_ms'],
             bytes=k2_main['bytes'],
             bound_ms=k2_main['bound_ms'], bound_by=k2_main['bound_by'],
             bound_share=k2_main['bound_share'], library_ms=None,
             unfused_ms=k2_main['unfused_ms'],
             detect_call_device_ms=device_ms['K2 (mbconv kernel)'],
             detect_call_bound_ms=k2_bound_call, cases=k2_results)]}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
