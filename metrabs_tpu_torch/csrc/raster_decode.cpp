// Host decoders for the simple raster formats cv2.imread reads with its own
// code (OpenCV 5.0's grfmt_bmp.cpp, grfmt_pxm.cpp, grfmt_gif.cpp and the
// Radiance reader rgbe.cpp), with their numbers and their quirks. The
// callers (data/bmp.py, pnm.py, gif.py, hdr.py) parse the headers; this file
// does the per-pixel work:
//   metrabs_bmp_decode: a BMP's pixel data from its offset, as
//     BmpDecoder::readData: 1, 4 and 8 bits through the palette, 16 bits as
//     555 or 565 (each channel's bits shifted to the top), 24 and 32 bits
//     (B, G, R[, A]), RLE8 and RLE4 with their escapes (end of line, end of
//     bitmap and delta fill what they skip with palette entry 0; RLE4's
//     ignore the rows, as OpenCV 5.0's do), bottom-up or top-down; gray
//     through raster_common.h's gray14 (a palette converted entry by entry);
//   metrabs_pnm_numbers: ASCII numbers as PxMDecoder's ReadNumber reads
//     them (whitespace and '#' comments between them);
//   metrabs_gif_lzw: a GIF frame's LZW code stream (its sub-blocks joined)
//     to colour indices, through raster_common.h's lzw_decode;
//   metrabs_hdr_scanlines: Radiance RGBE pixels, new-style run-length
//     scanlines or flat (RGBE_ReadPixels_RLE), to float RGB as rgbe2float
//     gives them.
// Each returns 0, or 1 where cv2.imread returns None (the reason in err).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <string>
#include <vector>

#include "raster_common.h"

namespace {

struct DecodeError {
  std::string message;
};

[[noreturn]] void fail(const std::string& message) { throw DecodeError{message}; }

int report(const std::string& message, char* err, int err_len) {
  if (err && err_len > 0) std::snprintf(err, static_cast<size_t>(err_len), "%s", message.c_str());
  return 1;
}

// A byte stream that fails at its end, as OpenCV's RLByteStream throws.
struct Stream {
  const uint8_t* data;
  size_t size, pos;
  int byte() {
    if (pos >= size) fail("unexpected end of file");
    return data[pos++];
  }
  int word() {  // little-endian
    int lo = byte();
    return lo | byte() << 8;
  }
  void bytes(uint8_t* out, size_t n) {
    if (n > size - pos || pos > size) fail("unexpected end of file");
    std::memcpy(out, data + pos, n);
    pos += n;
  }
};

// The output image, addressed as OpenCV's readData addresses it: `data` and
// `line_end` are offsets into the image, `step` is negative for bottom-up
// rows. A colour pixel is written as R, G, B (the caller wants RGB).
struct Bmp {
  uint8_t* img;
  int width, height, nch;
  const uint8_t* palette;  // 256 entries of B, G, R, A
  uint8_t gray_palette[256];
  long step;

  void pix(long at, int index) {
    const uint8_t* e = palette + 4 * index;
    if (nch == 3) {
      img[at] = e[2];
      img[at + 1] = e[1];
      img[at + 2] = e[0];
    } else {
      img[at] = gray_palette[index];
    }
  }

  // FillUniColor / FillUniGray.
  long fill(long data, long& line_end, int& y, long count, int index) {
    const long width3 = static_cast<long>(width) * nch;
    do {
      long end = data + count;
      if (end > line_end) end = line_end;
      count -= end - data;
      for (; data < end; data += nch) pix(data, index);
      if (data >= line_end) {
        line_end += step;
        data = line_end - width3;
        if (++y >= height) break;
      }
    } while (count > 0);
    return data;
  }

  // FillColorRow1/4/8 and FillGrayRow1/4/8 over `n` pixels.
  long row(long data, const uint8_t* src, int n, int bits) {
    for (int x = 0; x < n; x++, data += nch) {
      int index;
      if (bits == 8) index = src[x];
      else if (bits == 4) index = (src[x >> 1] >> (x & 1 ? 0 : 4)) & 15;
      else index = (src[x >> 3] >> (7 - (x & 7))) & 1;
      pix(data, index);
    }
    return data;
  }
};

void bmp_decode(Stream& s, Bmp& b, int bpp, int rle) {
  const long width3 = static_cast<long>(b.width) * b.nch;
  const int src_pitch = ((b.width * (bpp != 15 ? bpp : 16) + 7) / 8 + 3) & -4;
  std::vector<uint8_t> src(static_cast<size_t>(src_pitch) + 32);
  for (int i = 0; i < 256; i++) {
    const uint8_t* e = b.palette + 4 * i;
    b.gray_palette[i] = gray14(e[2], e[1], e[0]);
  }
  long data = 0;
  if (b.step < 0) data = (static_cast<long>(b.height) - 1) * -b.step;
  if (rle == 0) {
    for (int y = 0; y < b.height; y++, data += b.step) {
      s.bytes(src.data(), static_cast<size_t>(src_pitch));
      uint8_t* o = b.img + data;
      if (bpp <= 8) {
        b.row(data, src.data(), b.width, bpp);
        continue;
      }
      for (int x = 0; x < b.width; x++) {
        int bl, g, r;
        if (bpp == 15 || bpp == 16) {
          int t = src[2 * x] | src[2 * x + 1] << 8;
          bl = (t << 3) & 0xf8;
          g = bpp == 15 ? (t >> 2) & 0xf8 : (t >> 3) & 0xfc;
          r = bpp == 15 ? (t >> 7) & 0xf8 : (t >> 8) & 0xf8;
        } else {
          const uint8_t* p = src.data() + x * (bpp / 8);
          bl = p[0];
          g = p[1];
          r = p[2];
        }
        if (b.nch == 3) {
          o[3 * x] = static_cast<uint8_t>(r);
          o[3 * x + 1] = static_cast<uint8_t>(g);
          o[3 * x + 2] = static_cast<uint8_t>(bl);
        } else {
          o[x] = gray14(r, g, bl);
        }
      }
    }
    return;
  }
  long line_end = data + width3;
  int y = 0;
  if (rle == 1) {  // RLE8
    int line_end_flag = 0;
    for (;;) {
      int code = s.word();
      int len = code & 255;
      code >>= 8;
      if (len != 0) {  // encoded mode
        int prev_y = y;
        long n = static_cast<long>(len) * b.nch;
        if (data + n > line_end) fail("RLE8 run past the end of a row");
        data = b.fill(data, line_end, y, n, code);
        line_end_flag = y - prev_y;
        if (y >= b.height) break;
      } else if (code > 2) {  // absolute mode
        int prev_y = y;
        if (data + static_cast<long>(code) * b.nch > line_end) fail("RLE8 literal past a row");
        s.bytes(src.data(), static_cast<size_t>((code + 1) & ~1));
        data = b.row(data, src.data(), code, 8);
        line_end_flag = y - prev_y;
      } else {
        long x_shift3 = line_end - data;
        long y_shift = b.height - y;
        if (code || !line_end_flag || x_shift3 < width3) {
          if (code == 2) {
            x_shift3 = static_cast<long>(s.byte()) * b.nch;
            y_shift = s.byte();
          }
          if (code != 0) x_shift3 += y_shift * width3;
          if (y >= b.height) break;
          data = b.fill(data, line_end, y, x_shift3, 0);
          if (y >= b.height) break;
        }
        line_end_flag = 0;
        if (y >= b.height) break;
      }
    }
    return;
  }
  for (;;) {  // RLE4
    int code = s.word();
    int len = code & 255;
    code >>= 8;
    if (len != 0) {
      int t = 0;
      const int index[2] = {code >> 4, code & 15};
      long end = data + static_cast<long>(len) * b.nch;
      if (end > line_end) fail("RLE4 run past the end of a row");
      do {
        b.pix(data, index[t]);
        t ^= 1;
      } while ((data += b.nch) < end);
    } else if (code > 2) {
      if (data + static_cast<long>(code) * b.nch > line_end) fail("RLE4 literal past a row");
      s.bytes(src.data(), static_cast<size_t>((((code + 1) >> 1) + 1) & ~1));
      data = b.row(data, src.data(), code, 4);
    } else {
      // OpenCV 5.0's RLE4 masks the rows out of every escape: end of
      // bitmap acts as end of line, and a delta moves dx pixels on.
      long x_shift3 = line_end - data;
      if (code == 2) {
        x_shift3 = static_cast<long>(s.byte()) * b.nch;
        s.byte();
      }
      data = b.fill(data, line_end, y, x_shift3, 0);
      if (y >= b.height) break;
    }
  }
}

}  // namespace

extern "C" {

int metrabs_bmp_decode(const uint8_t* file, size_t size, size_t offset, int width, int height,
                       int top_down, int bpp, int rle, const uint8_t* palette, uint8_t* out,
                       int channels, char* err, int err_len) {
  try {
    Stream s{file, size, offset};
    Bmp b{out, width, height, channels, palette, {0}, 0};
    const long row = static_cast<long>(width) * channels;
    b.step = top_down ? row : -row;
    bmp_decode(s, b, bpp, rle);
    return 0;
  } catch (const DecodeError& e) {
    return report(e.message, err, err_len);
  } catch (const std::bad_alloc&) {
    return report("out of memory", err, err_len);
  }
}

// `count` numbers from data[*pos] into out, each ended by the first
// character after it that is not a digit (consumed), or after `max_digits`
// digits (0: any); *pos is left after the last one.
int metrabs_pnm_numbers(const uint8_t* data, size_t size, size_t* pos, long count,
                        int max_digits, int32_t* out, char* err, int err_len) {
  try {
    Stream s{data, size, *pos};
    for (long i = 0; i < count; i++) {
      int c = s.byte();
      while (!(c >= '0' && c <= '9')) {
        if (c == '#') {
          do c = s.byte();
          while (c != '\n' && c != '\r');
          c = s.byte();
        } else if (c == ' ' || (c >= '\t' && c <= '\r')) {
          while (c == ' ' || (c >= '\t' && c <= '\r')) c = s.byte();
        } else {
          fail("unexpected character " + std::to_string(c) + " in a number");
        }
      }
      int64_t v = 0;
      int digits = 0;
      do {
        v = v * 10 + (c - '0');
        if (v > 2147483647) fail("number too large");
        if (++digits == max_digits) break;  // PBM's digits need no separator
        c = s.byte();
      } while (c >= '0' && c <= '9');
      out[i] = static_cast<int32_t>(v);
    }
    *pos = s.pos;
    return 0;
  } catch (const DecodeError& e) {
    return report(e.message, err, err_len);
  }
}

// GIF LZW (least significant bit first, the code width growing when the
// table reaches the width's limit) into exactly `n` indices; fewer or more
// fail, as cv2.imread then returns None.
int metrabs_gif_lzw(const uint8_t* data, size_t size, int min_code_size, uint8_t* out, long n,
                    char* err, int err_len) {
  if (min_code_size < 2 || min_code_size > 11) return report("bad LZW minimum code size", err, err_len);
  try {
    size_t written;
    const char* e = lzw_decode({min_code_size, false, false, false, true}, data, size, out,
                               static_cast<size_t>(n), &written);
    return e ? report(e, err, err_len) : 0;
  } catch (const std::bad_alloc&) {
    return report("out of memory", err, err_len);
  }
}

// rgbe2float: a zero exponent is black, else each mantissa times
// 2^(exponent - 136) in float.
static void rgbe(const uint8_t* p, float* o) {
  if (p[3]) {
    const float f = static_cast<float>(std::ldexp(1.0, p[3] - 136));
    o[0] = p[0] * f;
    o[1] = p[1] * f;
    o[2] = p[2] * f;
  } else {
    o[0] = o[1] = o[2] = 0.0f;
  }
}

int metrabs_hdr_scanlines(const uint8_t* data, size_t size, int width, int height, float* out,
                          char* err, int err_len) {
  try {
    Stream s{data, size, 0};
    const long total = static_cast<long>(width) * height;
    uint8_t px[4];
    long done = 0;
    bool flat = width < 8 || width > 0x7fff;
    std::vector<uint8_t> line(static_cast<size_t>(width) * 4);
    for (int y = 0; y < height && !flat; y++) {
      s.bytes(px, 4);
      if (px[0] != 2 || px[1] != 2 || (px[2] & 0x80)) {  // not run-length encoded: the rest is flat
        rgbe(px, out + 3 * done);
        done++;
        flat = true;
        break;
      }
      if ((px[2] << 8 | px[3]) != width) fail("wrong scanline width");
      for (int c = 0; c < 4; c++) {
        uint8_t* p = line.data() + static_cast<size_t>(c) * width;
        uint8_t* end = p + width;
        while (p < end) {
          int count = s.byte();
          int value = s.byte();
          if (count > 128) {
            count -= 128;
            if (count == 0 || count > end - p) fail("bad scanline data");
            std::memset(p, value, static_cast<size_t>(count));
            p += count;
          } else {
            if (count == 0 || count > end - p) fail("bad scanline data");
            *p++ = static_cast<uint8_t>(value);
            if (--count > 0) {
              s.bytes(p, static_cast<size_t>(count));
              p += count;
            }
          }
        }
      }
      for (int x = 0; x < width; x++) {
        const uint8_t q[4] = {line[x], line[width + x], line[2 * width + x], line[3 * width + x]};
        rgbe(q, out + 3 * done);
        done++;
      }
    }
    for (; flat && done < total; done++) {
      s.bytes(px, 4);
      rgbe(px, out + 3 * done);
    }
    return 0;
  } catch (const DecodeError& e) {
    return report(e.message, err, err_len);
  }
}

}  // extern "C"
