// YUV 4:2:0 (8-bit, or 9 and 10 bits in 16-bit samples) to RGB as
// cv2.VideoCapture converts decoded frames: FFmpeg's swscale, asked for
// bgr24 at the frame's own size with SWS_BICUBIC, and with the coefficients
// sws_setColorspaceDetails derives from the stream's matrix_coefficients
// and full-range flag. Shared by the mp4v, H.264 and HEVC decoders
// (`mpeg4_video.cpp`, `h264_decode.cpp`, `hevc_decode.cpp`).
//
// swscale takes one of three paths, and each is followed here to the bit:
//
// - 8 bits, even height: the unscaled converter (its x86 SIMD yuv2rgb),
//   each chroma sample serving its 2x2 luma samples, each term a 16-bit
//   fixed-point product rounded down (pmulhw).
// - Odd height (or above 8 bits, at any height: swscale has no unscaled
//   converter from 16-bit planes to bgr24), even width: the scaler. Luma
//   and chroma are read into 15-bit samples (hScale8To15, or hScale16To15,
//   whose shift is the bit depth less one), luma unscaled and chroma filtered
//   horizontally at the same size (bicubic, the source's chroma sited left
//   of its two luma columns, the output's between them: a quarter-sample
//   shift), then chroma vertically from (h + 1) / 2 rows to h rows (bicubic,
//   12-bit taps; FFmpeg's initFilter, with its reduction of near-zero taps
//   and its border handling). Rows 0 to h - 3 go through the MMX vertical
//   filter and yuv2bgr24_X (pmulhw per tap, a rounder of 4); the last two
//   rows through the C yuv2rgb_X and its lookup tables, as swscale switches
//   there.
// - Odd height, odd width: swscale forces full horizontal chroma
//   interpolation (chroma filtered from (w + 1) / 2 to w columns) and the C
//   yuv2rgb_full_X.
//
// Heights where the vertical chroma filter has at most two taps and
// swscale takes its yuv2bgr24_1 shortcut are not emulated: `supported` is
// false for them (odd heights of 3 to 7 rows; above 8 bits, heights below
// 10).

#pragma once

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <vector>

namespace yuv_rgb {

inline uint8_t clip_u8(int64_t v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

inline int round_to_int16(int64_t f) {
  int64_t r = (f + (1 << 15)) >> 16;
  return (int)(r < -0x7FFF ? -0x8000 : r > 0x7FFF ? 0x7FFF : r);
}

// (crv, cbu, cgu, cgv) of swscale's colour spaces (sws_getCoefficients),
// with contrast and saturation 1 and brightness 0.
struct Coeffs {
  bool full_range;
  int64_t cy, oy, crv, cbu, cgu, cgv;
  int y_coeff, y_offset, v2r, v2g, u2g, u2b;  // SIMD (13-bit)
  int y_offset9;                              // yuv2rgb_y_offset (full path)
};

inline Coeffs coeffs(int full_range, int matrix) {
  static const int kTable[11][4] = {
      {117489, 138438, 13975, 34925}, {117489, 138438, 13975, 34925},
      {104597, 132201, 25675, 53279}, {104597, 132201, 25675, 53279},
      {104448, 132798, 24759, 53109}, {104597, 132201, 25675, 53279},
      {104597, 132201, 25675, 53279}, {117579, 136230, 16907, 35559},
      {0, 0, 0, 0},                   {110013, 140363, 12277, 42626},
      {110013, 140363, 12277, 42626}};
  if (matrix < 0 || matrix > 10 || matrix == 8) matrix = 5;
  const int* t = kTable[matrix];
  Coeffs c;
  c.full_range = full_range != 0;
  c.crv = t[0];
  c.cbu = t[1];
  c.cgu = -t[2];
  c.cgv = -t[3];
  c.cy = 1 << 16;
  c.oy = 0;
  if (!c.full_range) {
    c.cy = (c.cy * 255) / 219;
    c.oy = 16 << 16;
  } else {
    c.crv = (c.crv * 224) / 255;
    c.cbu = (c.cbu * 224) / 255;
    c.cgu = (c.cgu * 224) / 255;
    c.cgv = (c.cgv * 224) / 255;
  }
  c.y_coeff = round_to_int16(c.cy * (1 << 13));
  c.y_offset = round_to_int16(c.oy * (1 << 3));
  c.y_offset9 = round_to_int16(c.oy * (1 << 9));
  c.v2r = round_to_int16(c.crv * (1 << 13));
  c.v2g = round_to_int16(c.cgv * (1 << 13));
  c.u2g = round_to_int16(c.cgu * (1 << 13));
  c.u2b = round_to_int16(c.cbu * (1 << 13));
  return c;
}

inline int mulhi(int a, int c) { return (a * c) >> 16; }

// One SIMD conversion: y8 = 8Y (+ rounder), du/dv = 8 (U - 128) and
// 8 (V - 128) in the scaler's 16-bit fixed point.
inline void simd_pixel(int y8, int du, int dv, const Coeffs& k, uint8_t* out) {
  int yy = mulhi(y8 - k.y_offset, k.y_coeff);
  out[0] = clip_u8(yy + mulhi(dv, k.v2r));
  out[1] = clip_u8(yy + (mulhi(du, k.u2g) + mulhi(dv, k.v2g)));
  out[2] = clip_u8(yy + mulhi(du, k.u2b));
}

// A bicubic filter of swscale's initFilter (B 0, C 0.6): for each output,
// its first source sample and `size` taps summing to `one`.
struct Filter {
  int size = 0;
  std::vector<int> pos;
  std::vector<int> taps;  // [dst][size]
};

inline Filter bicubic_filter(int x_inc, int src_w, int dst_w, int one, int src_pos, int dst_pos,
                             int filter_align) {
  int log2_ratio = 0;
  for (int r = src_w / dst_w; r > 1; r >>= 1) log2_ratio++;
  const int64_t fone = (int64_t)1 << (54 - std::min(log2_ratio, 8));
  int size = x_inc <= 1 << 16 ? 1 + 4 : 1 + (4 * src_w + dst_w - 1) / dst_w;
  size = std::max(std::min(size, src_w - 2), 1);
  const int64_t B = 0, C = (int64_t)(0.6 * (1 << 24));
  std::vector<int64_t> f((size_t)dst_w * size);
  std::vector<int> pos(dst_w);
  int64_t x_dst_in_src = (((int64_t)dst_pos * x_inc) >> 7) - (((int64_t)src_pos * 0x10000) >> 7);
  for (int i = 0; i < dst_w; i++) {
    int xx = (int)((x_dst_in_src - (int64_t)(size - 2) * (1 << 16)) / (1 << 17));
    pos[i] = xx;
    for (int j = 0; j < size; j++) {
      int64_t d = std::llabs((int64_t)xx * (1 << 17) - x_dst_in_src) << 13;
      if (x_inc > 1 << 16) d = d * dst_w / src_w;
      int64_t coeff;
      if (d >= (int64_t)1 << 31) {
        coeff = 0;
      } else {
        int64_t dd = (d * d) >> 30, ddd = (dd * d) >> 30;
        if (d < (int64_t)1 << 30)
          coeff = (12 * (1 << 24) - 9 * B - 6 * C) * ddd + (-18 * (1 << 24) + 12 * B + 6 * C) * dd +
                  (6 * (1 << 24) - 2 * B) * ((int64_t)1 << 30);
        else
          coeff = (-B - 6 * C) * ddd + (6 * B + 30 * C) * dd + (-12 * B - 48 * C) * d +
                  (8 * B + 24 * C) * ((int64_t)1 << 30);
      }
      coeff /= ((int64_t)1 << 54) / fone;  // C's truncating division, as swscale's
      f[(size_t)i * size + j] = coeff;
      xx++;
    }
    x_dst_in_src += 2LL * x_inc;
  }
  // Reduce: drop near-zero taps on the left (keeping the positions rising)
  // and count those on the right.
  const double cutoff = 0.002 * (double)fone;
  int min_size = 0;
  for (int i = dst_w - 1; i >= 0; i--) {
    int64_t* row = &f[(size_t)i * size];
    int mn = size;
    double cut = 0;
    for (int j = 0; j < size; j++) {
      cut += (double)std::llabs(row[0]);
      if (cut > cutoff) break;
      if (i < dst_w - 1 && pos[i] >= pos[i + 1]) break;
      for (int k = 1; k < size; k++) row[k - 1] = row[k];
      row[size - 1] = 0;
      pos[i]++;
    }
    cut = 0;
    for (int j = size - 1; j > 0; j--) {
      cut += (double)std::llabs(row[j]);
      if (cut > cutoff) break;
      mn--;
    }
    min_size = std::max(min_size, mn);
  }
  if (min_size == 1 && filter_align == 2) filter_align = 1;
  const int out_size = (min_size + filter_align - 1) & ~(filter_align - 1);
  std::vector<int64_t> g((size_t)dst_w * out_size, 0);
  for (int i = 0; i < dst_w; i++)
    for (int j = 0; j < out_size && j < size; j++) g[(size_t)i * out_size + j] = f[(size_t)i * size + j];
  for (int i = 0; i < dst_w; i++) {  // borders
    int64_t* row = &g[(size_t)i * out_size];
    if (pos[i] < 0) {
      for (int j = 1; j < out_size; j++) {
        int left = std::max(j + pos[i], 0);
        row[left] += row[j];
        row[j] = 0;
      }
      pos[i] = 0;
    }
    if (pos[i] + out_size > src_w) {
      int shift = pos[i] + std::min(out_size - src_w, 0);
      int64_t acc = 0;
      for (int j = out_size - 1; j >= 0; j--)
        if (pos[i] + j >= src_w) {
          acc += row[j];
          row[j] = 0;
        }
      for (int j = out_size - 1; j >= 0; j--) row[j] = j < shift ? 0 : row[j - shift];
      pos[i] -= shift;
      row[src_w - 1 - pos[i]] += acc;
    }
  }
  Filter out;
  out.size = out_size;
  out.pos = pos;
  out.taps.resize((size_t)dst_w * out_size);
  for (int i = 0; i < dst_w; i++) {  // normalise with error diffusion
    const int64_t* row = &g[(size_t)i * out_size];
    int64_t sum = 0, error = 0;
    for (int j = 0; j < out_size; j++) sum += row[j];
    sum = (sum + one / 2) / one;
    if (!sum) sum = 1;
    for (int j = 0; j < out_size; j++) {
      int64_t v = row[j] + error;
      int64_t iv = v >= 0 ? (v + sum / 2) / sum : -((-v + sum / 2) / sum);
      out.taps[(size_t)i * out_size + j] = (int)iv;
      error = v - iv * sum;
    }
  }
  return out;
}

// Horizontal chroma scaling into 15-bit samples (hScale8To15, and
// hScale16To15 of `depth`-bit samples: a shift of depth - 1).
template <class P>
inline void hscale(const P* src, int src_w, const Filter& f, int dst_w, int depth, int32_t* dst) {
  const int shift = sizeof(P) == 1 ? 7 : depth - 1;
  for (int i = 0; i < dst_w; i++) {
    int64_t acc = 0;
    for (int j = 0; j < f.size; j++) {
      int s = std::min(f.pos[i] + j, src_w - 1);
      acc += (int64_t)src[s] * f.taps[(size_t)i * f.size + j];
    }
    dst[i] = (int32_t)std::min<int64_t>(acc >> shift, (1 << 15) - 1);
  }
}

// swscale's C table conversion (ff_yuv2rgb_c_init_tables, 24 bpp).
struct Tables {
  int64_t cy, yb0, crv, cbu, cgu, cgv;
  int yoffs;
  explicit Tables(const Coeffs& k) {
    cy = k.cy;
    auto scale = [&](int64_t c) { return (c * (1 << 16) + 0x8000) / std::max<int64_t>(cy, 1); };
    crv = scale(k.crv);
    cbu = scale(k.cbu);
    cgu = scale(k.cgu);
    cgv = scale(k.cgv);
    yb0 = -((int64_t)384 << 16) - 512 * cy - k.oy;
    yoffs = (k.full_range ? 384 : 326) + 512;
  }
  uint8_t y(int64_t idx) const { return clip_u8((yb0 + idx * cy + 0x8000) >> 16); }
  static int64_t off(int64_t inc, int v) { return ((v * inc) >> 16) - (inc >> 9); }
  void pixel(int Y, int U, int V, uint8_t* out) const {
    int64_t base = yoffs + Y;
    out[0] = y(base + off(crv, V));
    out[1] = y(base + off(cgu, U) + off(cgv, V));
    out[2] = y(base + off(cbu, U));
  }
};

// Whether to_rgb gives cv2's numbers for a frame of this height and bit depth.
inline bool supported(int h, int depth = 8) {
  if (depth > 8) return h >= 10;
  return !(h & 1) || h == 1 || h >= 9;
}

// RGB [h][w][3] of `depth`-bit planes y (stride ys samples) and u, v
// ((w + 1) / 2 by (h + 1) / 2, stride cs): 8-bit samples in uint8_t, 9 and
// 10 in uint16_t.
template <class P>
inline void to_rgb(const P* y, int ys, const P* u, const P* v, int cs, int w, int h, int full_range,
                   int matrix, int depth, uint8_t* rgb) {
  const Coeffs k = coeffs(full_range, matrix);
  // The 15-bit luma sample of the scaler (unscaled hScale: Y << (15 - depth)).
  const int luma_shift = 15 - (sizeof(P) == 1 ? 8 : depth);
  if constexpr (sizeof(P) == 1) {
    if (!(h & 1)) {
      for (int r = 0; r < h; r++) {
        const uint8_t* yr = y + (size_t)r * ys;
        const uint8_t* ur = u + (size_t)(r >> 1) * cs;
        const uint8_t* vr = v + (size_t)(r >> 1) * cs;
        uint8_t* out = rgb + (size_t)r * w * 3;
        for (int c = 0; c < w; c++)
          simd_pixel(yr[c] * 8, (ur[c >> 1] - 128) * 8, (vr[c >> 1] - 128) * 8, k, out + 3 * c);
      }
      return;
    }
  }
  const int cw = (w + 1) / 2, ch = (h + 1) / 2;
  const bool full_chroma = w & 1;  // swscale forces it for odd widths
  const int dst_cw = full_chroma ? w : cw;
  // The source's chroma sits left of its luma pair (local position 64 of
  // 256); the output's at 128, half a luma sample right in a 2-pixel pair.
  const Filter hf = bicubic_filter((int)((((int64_t)cw << 16) + (dst_cw >> 1)) / dst_cw), cw,
                                   dst_cw, 1 << 14, 64, 128, 4);
  const Filter vf = bicubic_filter((int)((((int64_t)ch << 16) + (h >> 1)) / h), ch, h, 1 << 12,
                                   128, 128, 2);
  std::vector<int32_t> uh((size_t)ch * dst_cw), vh((size_t)ch * dst_cw);
  for (int r = 0; r < ch; r++) {
    hscale(u + (size_t)r * cs, cw, hf, dst_cw, depth, &uh[(size_t)r * dst_cw]);
    hscale(v + (size_t)r * cs, cw, hf, dst_cw, depth, &vh[(size_t)r * dst_cw]);
  }
  const Tables tables(k);
  std::vector<int64_t> us(dst_cw), vs(dst_cw);
  for (int r = 0; r < h; r++) {
    const P* yr = y + (size_t)r * ys;
    uint8_t* out = rgb + (size_t)r * w * 3;
    const int* taps = &vf.taps[(size_t)r * vf.size];
    auto src_row = [&](int j) { return std::min(vf.pos[r] + j, ch - 1); };
    if (full_chroma) {  // yuv2rgb_full_X_c
      for (int c = 0; c < w; c++) {
        int64_t U = (1 << 9) - ((int64_t)128 << 19), V = U;
        for (int j = 0; j < vf.size; j++) {
          U += (int64_t)uh[(size_t)src_row(j) * dst_cw + c] * taps[j];
          V += (int64_t)vh[(size_t)src_row(j) * dst_cw + c] * taps[j];
        }
        U >>= 10;
        V >>= 10;
        int64_t Y = ((int64_t)yr[c] << (luma_shift + 2)) - k.y_offset9;
        Y = Y * k.y_coeff + (1 << 21);
        int64_t R = Y + V * k.v2r, G = Y + V * k.v2g + U * k.u2g, B = Y + U * k.u2b;
        auto clip30 = [](int64_t x) { return x < 0 ? 0 : x > (1 << 30) - 1 ? (1 << 30) - 1 : x; };
        out[3 * c + 0] = (uint8_t)(clip30(R) >> 22);
        out[3 * c + 1] = (uint8_t)(clip30(G) >> 22);
        out[3 * c + 2] = (uint8_t)(clip30(B) >> 22);
      }
    } else if (r < h - 2) {  // MMX vertical filter and yuv2bgr24_X
      for (int c = 0; c < cw; c++) {
        int su = 4, sv = 4;
        for (int j = 0; j < vf.size; j++) {
          su += mulhi(uh[(size_t)src_row(j) * cw + c], taps[j]);
          sv += mulhi(vh[(size_t)src_row(j) * cw + c], taps[j]);
        }
        for (int p = 2 * c; p < std::min(2 * c + 2, w); p++)
          simd_pixel(((yr[p] << luma_shift) >> 4) + 4, su - 1024, sv - 1024, k, out + 3 * p);
      }
    } else {  // the last two rows: C yuv2rgb_X and its tables
      for (int c = 0; c < cw; c++) {
        int64_t U = 1 << 18, V = 1 << 18;
        for (int j = 0; j < vf.size; j++) {
          U += (int64_t)uh[(size_t)src_row(j) * cw + c] * taps[j];
          V += (int64_t)vh[(size_t)src_row(j) * cw + c] * taps[j];
        }
        int Ui = (int)clip_u8(U >> 19), Vi = (int)clip_u8(V >> 19);
        for (int p = 2 * c; p < std::min(2 * c + 2, w); p++)
          tables.pixel(clip_u8(((yr[p] << luma_shift) + 64) >> 7), Ui, Vi, out + 3 * p);
      }
    }
  }
}

}  // namespace yuv_rgb
