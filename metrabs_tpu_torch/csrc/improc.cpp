// Native host image ops of metrabs_tpu_torch (`metrabs_tpu_torch/utils/
// native.py`), the port's own copy of the JAX package's `native/improc.cc`:
//  - gamma_decode_u8: uint8 -> linear float32 through a 256-entry table;
//  - gamma_encode_f32: float32 linear -> gamma with any exponent;
//  - paste_over: alpha composite of an occluder patch;
//  - box_downsample_2x2: the antialiasing pyramid's box filter;
//  - bilinear_warp: dense homography + distortion resample with a zero
//    border, the CPU mirror of the crop warp and an independent oracle for
//    the warp kernel and its plain torch version.
//
// Built at first use by `ops/cuda_build.py::build_host_library` and called
// through ctypes. Every function is single-threaded.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

void gamma_decode_u8(const uint8_t* src, float* dst, int64_t n, float gamma) {
  float lut[256];
  for (int i = 0; i < 256; ++i) {
    lut[i] = std::pow(static_cast<float>(i) / 255.0f, gamma);
  }
  for (int64_t i = 0; i < n; ++i) {
    dst[i] = lut[src[i]];
  }
}

void gamma_encode_f32(const float* src, float* dst, int64_t n, float gamma) {
  for (int64_t i = 0; i < n; ++i) {
    float v = src[i] < 0.0f ? 0.0f : src[i];
    dst[i] = std::pow(v, gamma);
  }
}

// Alpha-composites src (hs x ws x c) onto dst (hd x wd x c) centered at
// (cx, cy), clipping at the borders; alpha is (hs x ws) in [0, 1].
void paste_over(const float* src, const float* alpha, float* dst,
                int hs, int ws, int hd, int wd, int c,
                float cx, float cy) {
  const int start_x_raw = static_cast<int>(std::lround(cx)) - ws / 2;
  const int start_y_raw = static_cast<int>(std::lround(cy)) - hs / 2;
  const int sx0 = std::max(0, -start_x_raw);
  const int sy0 = std::max(0, -start_y_raw);
  const int dx0 = std::max(0, start_x_raw);
  const int dy0 = std::max(0, start_y_raw);
  const int w = std::min(ws - sx0, wd - dx0);
  const int h = std::min(hs - sy0, hd - dy0);
  for (int y = 0; y < h; ++y) {
    const float* a_row = alpha + (sy0 + y) * ws + sx0;
    const float* s_row = src + ((sy0 + y) * ws + sx0) * c;
    float* d_row = dst + ((dy0 + y) * wd + dx0) * c;
    for (int x = 0; x < w; ++x) {
      const float a = a_row[x];
      for (int k = 0; k < c; ++k) {
        d_row[x * c + k] = s_row[x * c + k] * a + d_row[x * c + k] * (1.0f - a);
      }
    }
  }
}

void box_downsample_2x2(const float* src, float* dst, int h, int w, int c) {
  const int h2 = h / 2, w2 = w / 2;
  for (int y = 0; y < h2; ++y) {
    for (int x = 0; x < w2; ++x) {
      for (int k = 0; k < c; ++k) {
        const float v00 = src[((2 * y) * w + 2 * x) * c + k];
        const float v01 = src[((2 * y) * w + 2 * x + 1) * c + k];
        const float v10 = src[((2 * y + 1) * w + 2 * x) * c + k];
        const float v11 = src[((2 * y + 1) * w + 2 * x + 1) * c + k];
        dst[(y * w2 + x) * c + k] = 0.25f * (v00 + v01 + v10 + v11);
      }
    }
  }
}

namespace {

// OpenCV 12-coefficient forward distortion, matching
// metrabs_tpu_torch/ops/distortion.py.
inline void distort_point(const double* d, double x, double y,
                          double* xd, double* yd) {
  const double r2 = x * x + y * y;
  const double a =
      ((((d[4] * r2 + d[1]) * r2 + d[0]) * r2 + 1.0) /
       (((d[7] * r2 + d[6]) * r2 + d[5]) * r2 + 1.0));
  const double b = 2.0 * (x * d[3] + y * d[2]);
  const double cx = (d[9] * r2 + d[3] + d[8]) * r2;
  const double cy = (d[11] * r2 + d[2] + d[10]) * r2;
  *xd = x * (a + b) + cx;
  *yd = y * (a + b) + cy;
}

inline float sample_bilinear_zero_border(const float* img, int h, int w, int c,
                                         float x, float y, int k) {
  // 1px-zero-border semantics via virtual padding (see ops/warp.py).
  const float xf = std::min(std::max(x + 1.0f, 0.0f), static_cast<float>(w + 1));
  const float yf = std::min(std::max(y + 1.0f, 0.0f), static_cast<float>(h + 1));
  const int x0 = std::min(static_cast<int>(xf), w);
  const int y0 = std::min(static_cast<int>(yf), h);
  const float fx = xf - static_cast<float>(x0);
  const float fy = yf - static_cast<float>(y0);
  auto at = [&](int yy, int xx) -> float {
    const int ry = yy - 1, rx = xx - 1;  // unpad
    if (ry < 0 || ry >= h || rx < 0 || rx >= w) return 0.0f;
    return img[(ry * w + rx) * c + k];
  };
  const float top = at(y0, x0) * (1 - fx) + at(y0, x0 + 1) * fx;
  const float bot = at(y0 + 1, x0) * (1 - fx) + at(y0 + 1, x0 + 1) * fx;
  return top * (1 - fy) + bot * fy;
}

}  // namespace

// Dense warp: for each output pixel p, src = K @ homog(distort(proj(M @ p))).
// M (new_invprojmat) and K are row-major 3x3; dist has 12 coefficients.
void bilinear_warp(const float* img, int h, int w, int c,
                   const double* invprojmat, const double* intrinsics,
                   const double* dist, float* out, int oh, int ow) {
  for (int oy = 0; oy < oh; ++oy) {
    for (int ox = 0; ox < ow; ++ox) {
      const double px = static_cast<double>(ox), py = static_cast<double>(oy);
      const double rx = invprojmat[0] * px + invprojmat[1] * py + invprojmat[2];
      const double ry = invprojmat[3] * px + invprojmat[4] * py + invprojmat[5];
      const double rz = invprojmat[6] * px + invprojmat[7] * py + invprojmat[8];
      const double nx = rx / rz, ny = ry / rz;
      double dx, dy;
      distort_point(dist, nx, ny, &dx, &dy);
      const double sx = intrinsics[0] * dx + intrinsics[1] * dy + intrinsics[2];
      const double sy = intrinsics[3] * dx + intrinsics[4] * dy + intrinsics[5];
      for (int k = 0; k < c; ++k) {
        out[(oy * ow + ox) * c + k] = sample_bilinear_zero_border(
            img, h, w, c, static_cast<float>(sx), static_cast<float>(sy), k);
      }
    }
  }
}

}  // extern "C"
