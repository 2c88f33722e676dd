"""CPU image helpers of the data pipeline (`metrabs_tpu/data/improc.py`)
without OpenCV: images are read from JPEG (through `data.jpeg`), PNG
(`data.png`), WebP (`data.webp`), TIFF (`data.tiff`), BMP (`data.bmp`),
PNM/PAM/PFM (`data.pnm`), GIF (`data.gif`), Sun raster (`data.sunras`) and
Radiance HDR (`data.hdr`) files, each equal to cv2's decode, and from
`.npy` files, and written as
JPEG (equal to cv2's encode) or PNG, video frames are read as Motion JPEG,
MPEG-4 Part 2 (mp4v) or H.264 and written as Motion JPEG or mp4v in AVI,
Matroska and MP4 files (through `data.video`), and the colour and resize
helpers give OpenCV's numbers.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from metrabs_tpu_torch.data import (bmp, cvfree, gif, hdr, jpeg, png, pnm, sunras, tiff, video,
                                    webp)
_JPEG_SIGNATURE = b'\xff\xd8\xff'
# The formats besides JPEG, PNG and WebP, each with the test of its
# signature, as cv2.imread picks its decoder.
_RASTERS = ((tiff.is_tiff, tiff), (bmp.is_bmp, bmp), (pnm.is_pnm, pnm), (gif.is_gif, gif),
            (sunras.is_sunras, sunras), (hdr.is_hdr, hdr))
_READ = 'JPEG, PNG, WebP, TIFF, BMP, PNM/PAM/PFM, GIF, Sun raster or Radiance HDR'


def imread(path: str, gray: bool = False) -> np.ndarray:
    """RGB uint8 [H, W, 3] image, equal to `cv2.imread(path, IMREAD_COLOR)`
    (in RGB order) bit for bit, EXIF orientation applied. The format is the
    file's signature, as cv2 reads it: JPEG (`FF D8 FF`; gray, YCbCr, RGB,
    CMYK and YCCK), PNG (`89 50 4E 47`; every colour type and depth, Adam7;
    16 bits keep their high byte, gray is repeated over the three channels
    and alpha dropped), WebP (`RIFF....WEBP`; lossless and lossy, the first
    frame of an animation), TIFF (`II*\\0`, `MM\\0*` and BigTIFF's
    `II+\\0`, `MM\\0+`; the first page, data.tiff), BMP (`BM`, data.bmp),
    PNM, PAM and PFM (`P1`-`P7`, `PF`, `Pf`; data.pnm), GIF (`GIF87a`,
    `GIF89a`; the first frame on its screen, data.gif), Sun raster
    (`59 A6 6A 95`, data.sunras) or Radiance HDR (`#?RADIANCE`, `#?RGBE`,
    data.hdr), each with cv2's own conversion to 8 bits; a `.npy` file holds
    such an array. Raises FileNotFoundError for a missing file, ValueError
    where cv2 returns None (a corrupt or truncated file, or a kind cv2's
    reader refuses), and NotImplementedError for any other format (AVIF,
    JPEG 2000) or a tool a decoder does not read.

    `video.ext#frame=N` is frame N (from 0) of a Motion JPEG, mp4v or H.264
    video in AVI, Matroska or MP4 (the ASPset adapter's convention for its
    .mkv files), numbered as cv2 numbers the frames it decodes (past them
    FileNotFoundError, as JAX's read raises): the file's index is parsed once
    and kept. A Motion JPEG frame is one seek and one decode (equal to
    `cv2.imdecode` of its packet); an mp4v or H.264 frame is decoded from the
    entry point before it (a key frame; for H.264 an IDR picture or a
    recovery point), through the file's decoder, which frames read in order
    continue (equal to `cv2.VideoCapture`'s frame; H.264 with B slices in
    its output order, as cv2's CAP_PROP_POS_FRAMES seek gives it). Other codecs raise
    NotImplementedError naming the codec.

    With `gray`, uint8 [H, W], equal to `cv2.imread(path,
    cv2.IMREAD_GRAYSCALE)` bit for bit: a JPEG's luma plane (libjpeg's
    grayscale output; RGB and CMYK files converted as libjpeg and OpenCV
    convert them), a PNG through libpng's `png_set_rgb_to_gray` as OpenCV
    sets it up (data/png.py), a WebP through OpenCV's BGR2GRAY, the other
    formats as their OpenCV readers convert them. `.npy` files and video
    frames, which cv2 does not read, raise NotImplementedError in gray."""
    path = str(path)
    if gray and ('#frame=' in path or os.path.splitext(path)[1].lower() == '.npy'):
        raise NotImplementedError(f'{path}: gray reads are of still-image files only')
    if '#frame=' in path:
        video_path, frame_spec = path.split('#frame=')
        return video.read_frame(video_path, int(frame_spec))
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    if os.path.splitext(path)[1].lower() == '.npy':
        im = np.load(path)
        if im.dtype != np.uint8 or im.ndim != 3 or im.shape[2] != 3:
            raise ValueError(f'{path}: expected a uint8 [H, W, 3] array, got {im.dtype} '
                             f'{im.shape}')
        return im
    with open(path, 'rb') as f:
        data = f.read()
    if data.startswith(_JPEG_SIGNATURE):
        return jpeg.decode(data, path, gray=gray)
    if data.startswith(png.SIGNATURE):
        return png.decode(data, path, gray=gray)
    if webp.is_webp(data):
        return webp.decode(data, path, gray=gray)
    for is_format, module in _RASTERS:
        if is_format(data):
            return module.decode(data, path, gray=gray)
    raise NotImplementedError(f'{path}: not {_READ} (the formats imread decodes)')


def normalize01(im: np.ndarray) -> np.ndarray:
    """uint8-range values -> [0, 1] float32: /255 and clip for every input
    dtype."""
    return np.clip(im.astype(np.float32) / np.float32(255), 0.0, 1.0)


def adjust_gamma(im: np.ndarray, gamma: float, inplace: bool = False) -> np.ndarray:
    """LUT-based gamma adjustment."""
    if np.issubdtype(im.dtype, np.integer):
        lut = (np.clip(np.linspace(0, 1, 256) ** gamma, 0, 1) * 255).astype(im.dtype)
        out = lut[im]
    else:
        out = np.clip(im, 0, 1) ** gamma
    if inplace:
        im[:] = out
        return im
    return out


def white_balance(im: np.ndarray, a: Optional[float] = None,
                  b: Optional[float] = None) -> np.ndarray:
    """LAB-space, luminance-weighted white balance: shifts the a/b chroma
    channels toward neutral (128) in proportion to each pixel's luminance,
    with gain 1.1. `a`/`b` override the measured channel means (the 3DHP fix
    passes 110/145, Panoptic 120/138). Input must be RGB uint8; the chroma
    update is written back into the uint8 LAB array by numpy's truncating
    cast, as in the JAX package."""
    if im.dtype != np.uint8:
        raise ValueError(f'white_balance expects uint8 RGB, got {im.dtype}')
    lab = cvfree.rgb_to_lab(im)
    avg_a = np.mean(lab[..., 1]) if a is None else a
    avg_b = np.mean(lab[..., 2]) if b is None else b
    lum = lab[..., 0] / 255.0
    lab[..., 1] = lab[..., 1] - (avg_a - 128) * lum * 1.1
    lab[..., 2] = lab[..., 2] - (avg_b - 128) * lum * 1.1
    return cvfree.lab_to_rgb(lab)


def resize_by_factor(im: np.ndarray, factor: float) -> np.ndarray:
    new_size = (max(1, int(round(im.shape[1] * factor))),
                max(1, int(round(im.shape[0] * factor))))
    interp = cvfree.INTER_LINEAR if factor > 1 else cvfree.INTER_AREA
    return cvfree.resize(im, new_size, interpolation=interp)


def blend_image(im1: np.ndarray, im2: np.ndarray,
                im2_weight: np.ndarray) -> np.ndarray:
    """Per-pixel lerp `im1*(1-w) + im2*w` with a broadcastable weight map,
    returned in im1's dtype."""
    w = np.asarray(im2_weight, np.float32)
    if w.ndim == im1.ndim - 1:
        w = w[..., np.newaxis]
    out = im1.astype(np.float32) * (1 - w) + im2.astype(np.float32) * w
    if np.issubdtype(im1.dtype, np.integer):
        out = np.clip(np.round(out), 0, 255)
    return out.astype(im1.dtype)


def is_image_readable(path: str) -> bool:
    """True iff `imread` succeeds."""
    try:
        imread(path)
        return True
    except Exception:
        return False


def rounded_int_tuple(p) -> tuple:
    """Rounded int tuple of a float point, for drawing calls."""
    return tuple(np.round(np.asarray(p)).astype(int))


def image_extents(filepath: str) -> np.ndarray:
    """Image (width, height) without decoding pixel data, before any EXIF
    or TIFF orientation, as the JAX package reads it from PIL: from a `.npy`
    file's header, a JPEG's frame header, a PNG's IHDR, a WebP's canvas
    (VP8X) or bitstream header, a TIFF's first directory, a BMP, PNM or Sun
    raster header, or a GIF's logical screen. PIL identifies neither PAM,
    cv2's PFM nor Radiance HDR: those raise ValueError, where the JAX
    package's PIL raises. Other formats raise NotImplementedError."""
    filepath = str(filepath)
    if os.path.splitext(filepath)[1].lower() == '.npy':
        shape = np.load(filepath, mmap_mode='r').shape
        return np.asarray([shape[1], shape[0]])
    with open(filepath, 'rb') as f:
        data = f.read(64)
        if data.startswith(_JPEG_SIGNATURE):
            # The frame header follows segments of any length (EXIF, tables).
            height, width, _ = jpeg.header(data + f.read(), filepath)
            return np.asarray([width, height])
        if data.startswith(png.SIGNATURE):
            return np.asarray(png.header(data, filepath))
        if webp.is_webp(data):
            return np.asarray(webp.header(data + f.read(), filepath))
        for is_format, module in _RASTERS:
            if is_format(data):
                # A TIFF's directory, and a PNM's comments, may lie anywhere.
                return np.asarray(module.header(data + f.read(), filepath))
    raise NotImplementedError(f'{filepath}: not {_READ}')


def imwrite(path: str, image: np.ndarray) -> None:
    """Writes an RGB uint8 [H, W, 3] (or gray [H, W]) image as `cv2.imwrite`
    writes its BGR counterpart at OpenCV's defaults: `.jpg`/`.jpeg` through
    `jpeg.encode` (the same bytes as cv2), `.png` through `cvfree.write_png`.
    Other extensions raise NotImplementedError."""
    path = str(path)
    ext = os.path.splitext(path)[1].lower()
    if ext in ('.jpg', '.jpeg'):
        data = jpeg.encode(image)
        with open(path, 'wb') as f:
            f.write(data)
    elif ext == '.png':
        cvfree.write_png(path, np.ascontiguousarray(image))
    else:
        raise NotImplementedError(f'{path}: imwrite writes .jpg, .jpeg and .png')


def video_extents(filepath: str) -> np.ndarray:
    """Video (width, height) from the container's header, without decoding
    frames (AVI, Matroska and MP4), as displayed: swapped where the display
    matrix or projection turns the frames by 90 or 270 degrees, as cv2's
    CAP_PROP_FRAME_WIDTH and HEIGHT swap them."""
    return np.asarray(video.index(str(filepath)).displayed_size)


def video_fps(filepath: str) -> float:
    """Frame rate from the container's header: an AVI stream's rate / scale,
    a Matroska track's DefaultDuration, an MP4 track's timescale over its
    sample durations."""
    return float(video.index(str(filepath)).fps)


def num_frames_of_video(path: str) -> int:
    """Frame count: the packets the container's index lists (cv2's
    CAP_PROP_FRAME_COUNT, which counts an mp4v VOP that is not coded)."""
    return int(video.index(str(path)).n_frames)


def transform_video(inp_path: str, out_path: str, process_frame_fn,
                    fourcc: str = 'mp4v') -> None:
    """Reads a video (Motion JPEG, mp4v, H.264 or HEVC, B-frame streams in
    their output order, turned as displayed), maps `process_frame_fn` over
    its RGB frames and writes the results at the source's frame rate,
    in the container the output's extension names (`.mp4`, `.avi` or
    `.mkv`), as mp4v (JAX's default) or MJPG. The frame function must keep
    the frame size. Another codec raises NotImplementedError naming it."""
    idx = video.index(str(inp_path))
    parent = os.path.dirname(os.path.abspath(out_path))
    os.makedirs(parent, exist_ok=True)
    writer = None
    try:
        for frame in video.iter_frames(str(inp_path)):
            out = process_frame_fn(frame)
            if writer is None:
                writer = video.VideoWriter(str(out_path), idx.fps or 30.0,
                                           (out.shape[1], out.shape[0]), fourcc)
            writer.write(out)
    finally:
        if writer is not None:
            writer.close()


def video_audio_mux(vidpath_audiosource: str, vidpath_imagesource: str,
                    out_video_path: str) -> None:
    """Copies the audio track of one video onto the frames of another. Stream
    copy needs the ffmpeg binary; raises RuntimeError when it is not
    installed."""
    import shutil
    import subprocess
    ffmpeg = shutil.which('ffmpeg')
    if ffmpeg is None:
        raise RuntimeError('video_audio_mux needs the ffmpeg binary on PATH (audio stream '
                           'copy is not done in-process)')
    subprocess.run(
        [ffmpeg, '-y', '-i', str(vidpath_imagesource), '-i', str(vidpath_audiosource),
         '-map', '0:v', '-map', '1:a', '-c', 'copy', str(out_video_path)],
        check=True, capture_output=True)
