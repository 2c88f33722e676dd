// Host TIFF sample decoder with the numbers cv2.imread gives through its
// bundled libtiff (4.7): OpenCV reads every 8-bit output through libtiff's
// TIFFRGBAImage interface (TIFFReadRGBAStrip / TIFFReadRGBATile) and then
// drops alpha (icvCvt_BGRA2BGR_8u_C4C3R) or converts to gray
// (icvCvt_BGRA2Gray_8u_C4C1R).
//
// The caller (data/tiff.py) parses the IFD, cuts out each strip or tile,
// inflates Deflate with zlib and decodes JPEG through data/jpeg.py; this file
// does the rest:
//   metrabs_tiff_decompress: LZW (raster_common.h's lzw_decode as libtiff's
//     LZWDecode, MSB-first with the early change, or LZWDecodeCompat, the old
//     LSB-first form, chosen per chunk by its first two bytes as LZWPreDecode
//     chooses), PackBits
//     (PackBitsDecode) or a copy, into exactly `need` bytes;
//   metrabs_tiff_predict: horizontal differencing undone (horAcc8 and
//     horAcc16, 16-bit samples in the file's byte order);
//   metrabs_tiff_convert: the samples of the whole image to RGB or gray as
//     tif_getimage.c's put routines give them: gray and bilevel through its
//     BW map (16 bits by the high byte), a palette (scaled to 8 bits by the
//     caller), RGB (16 bits as (v + 128) / 257, unassociated alpha
//     premultiplied as (v * a + 127) / 255), and CMYK (r = k * (255 - c) /
//     255 with k = 255 - K); gray through raster_common.h's gray14.
//
// Each function returns 0, or 1 for data it cannot use, with the reason in
// err. metrabs_tiff_decompress returns 2 where libtiff's codec fails part
// way (a corrupt or short stream): `dst` then holds what was decoded before
// the failure, as TIFFReadRGBAStrip and TIFFReadRGBATile, which do not stop
// on errors, use it (the caller zeroes `dst` first).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <string>

#include "raster_common.h"

namespace {

struct DecodeError {
  std::string message;
};

[[noreturn]] void corrupt(const std::string& message) { throw DecodeError{message}; }

int report(const std::string& message, char* err, int err_len) {
  if (err && err_len > 0) std::snprintf(err, static_cast<size_t>(err_len), "%s", message.c_str());
  return 1;
}

void packbits(const uint8_t* src, size_t n, uint8_t* dst, size_t need) {
  size_t in = 0, out = 0;
  while (in < n && out < need) {
    int c = static_cast<int8_t>(src[in++]);
    if (c < 0) {
      if (c == -128) continue;
      size_t run = static_cast<size_t>(1 - c);
      if (run > need - out) run = need - out;
      if (in >= n) break;
      uint8_t b = src[in++];
      std::memset(dst + out, b, run);
      out += run;
    } else {
      size_t run = static_cast<size_t>(c) + 1;
      if (run > need - out) run = need - out;
      if (n - in < run) break;
      std::memcpy(dst + out, src + in, run);
      in += run;
      out += run;
    }
  }
  if (out < need) corrupt("not enough data (PackBits)");
}

struct Image {
  const uint8_t* samples;
  size_t plane_stride, row_stride;
  int planar, width, height, bits, spp, photometric, alpha, big_endian;
  const uint8_t* palette;

  unsigned at(int plane, int y, size_t index) const {
    const uint8_t* row = samples + static_cast<size_t>(plane) * plane_stride +
                         static_cast<size_t>(y) * row_stride;
    switch (bits) {
      case 16: {
        const uint8_t* p = row + 2 * index;
        return big_endian ? (p[0] << 8 | p[1]) : (p[1] << 8 | p[0]);
      }
      case 8:
        return row[index];
      default: {  // 1 and 4 bits, from the high bit
        size_t bit = index * static_cast<size_t>(bits);
        return (row[bit >> 3] >> (8 - bits - (bit & 7))) & ((1u << bits) - 1);
      }
    }
  }

  // Sample s of pixel x in row y.
  unsigned sample(int y, int x, int s) const {
    if (planar == 2) return at(s, y, static_cast<size_t>(x));
    return at(0, y, static_cast<size_t>(x) * spp + s);
  }

  static unsigned to8(unsigned v) { return (v + 128) / 257; }  // BuildMapBitdepth16To8

  void rgb(int y, int x, unsigned& r, unsigned& g, unsigned& b) const {
    switch (photometric) {
      case 0:
      case 1: {
        unsigned v = sample(y, x, 0);
        unsigned range = 255;
        if (bits == 16) v >>= 8;
        else if (bits < 8) range = (1u << bits) - 1;
        unsigned m = photometric == 0 ? (range - v) * 255 / range : v * 255 / range;
        r = g = b = m;
        return;
      }
      case 3: {
        const uint8_t* e = palette + 3 * sample(y, x, 0);
        r = e[0];
        g = e[1];
        b = e[2];
        return;
      }
      case 5: {
        unsigned k = 255 - sample(y, x, 3);
        r = k * (255 - sample(y, x, 0)) / 255;
        g = k * (255 - sample(y, x, 1)) / 255;
        b = k * (255 - sample(y, x, 2)) / 255;
        return;
      }
      default: {  // RGB
        r = sample(y, x, 0);
        g = sample(y, x, 1);
        b = sample(y, x, 2);
        if (bits == 16) {
          r = to8(r);
          g = to8(g);
          b = to8(b);
        }
        if (alpha == 2) {  // unassociated: premultiplied as BuildMapUaToAa
          unsigned a = sample(y, x, 3);
          if (bits == 16) a = to8(a);
          r = (r * a + 127) / 255;
          g = (g * a + 127) / 255;
          b = (b * a + 127) / 255;
        }
      }
    }
  }
};

}  // namespace

extern "C" {

int metrabs_tiff_decompress(const uint8_t* src, size_t n, int compression, uint8_t* dst,
                            size_t need, char* err, int err_len) {
  try {
    switch (compression) {
      case 1:
        if (n < need) corrupt("not enough data (uncompressed)");
        std::memcpy(dst, src, need);
        break;
      case 5:
      {
        // LZWPreDecode: a first byte 0 and the low bit of the second set mark the old style.
        const bool compat = n >= 2 && src[0] == 0 && (src[1] & 1);
        size_t written;
        if (const char* e = lzw_decode({8, !compat, !compat, true, false}, src, n, dst, need,
                                       &written))
          corrupt(e);
        break;
      }
      case 32773:
        packbits(src, n, dst, need);
        break;
      default:
        corrupt("compression " + std::to_string(compression) + " is not decoded here");
    }
    return 0;
  } catch (const DecodeError& e) {
    report(e.message, err, err_len);
    return 2;
  } catch (const std::bad_alloc&) {
    return report("out of memory", err, err_len);
  }
}

int metrabs_tiff_predict(uint8_t* buf, size_t rows, size_t row_bytes, int bits, int stride,
                         int big_endian, char* err, int err_len) {
  if (bits == 8) {
    for (size_t y = 0; y < rows; y++) {
      uint8_t* row = buf + y * row_bytes;
      for (size_t i = static_cast<size_t>(stride); i < row_bytes; i++) {
        row[i] = static_cast<uint8_t>(row[i] + row[i - stride]);
      }
    }
    return 0;
  }
  if (bits == 16) {
    const size_t n = row_bytes / 2;
    for (size_t y = 0; y < rows; y++) {
      uint8_t* row = buf + y * row_bytes;
      auto get = [&](size_t i) -> unsigned {
        return big_endian ? (row[2 * i] << 8 | row[2 * i + 1]) : (row[2 * i + 1] << 8 | row[2 * i]);
      };
      for (size_t i = static_cast<size_t>(stride); i < n; i++) {
        unsigned v = (get(i) + get(i - stride)) & 0xFFFF;
        if (big_endian) {
          row[2 * i] = static_cast<uint8_t>(v >> 8);
          row[2 * i + 1] = static_cast<uint8_t>(v);
        } else {
          row[2 * i] = static_cast<uint8_t>(v);
          row[2 * i + 1] = static_cast<uint8_t>(v >> 8);
        }
      }
    }
    return 0;
  }
  return report("horizontal differencing of " + std::to_string(bits) + "-bit samples", err,
                err_len);
}

int metrabs_tiff_convert(const uint8_t* samples, size_t plane_stride, size_t row_stride,
                         int planar, int width, int height, int bits, int spp, int photometric,
                         int alpha, int big_endian, const uint8_t* palette, uint8_t* out,
                         int channels) {
  Image im{samples, plane_stride, row_stride, planar, width, height, bits, spp, photometric,
           alpha, big_endian, palette};
  for (int y = 0; y < height; y++) {
    uint8_t* o = out + static_cast<size_t>(y) * width * channels;
    for (int x = 0; x < width; x++) {
      unsigned r, g, b;
      im.rgb(y, x, r, g, b);
      if (channels == 1) {
        o[x] = gray14(r, g, b);
      } else {
        o[3 * x] = static_cast<uint8_t>(r);
        o[3 * x + 1] = static_cast<uint8_t>(g);
        o[3 * x + 2] = static_cast<uint8_t>(b);
      }
    }
  }
  return 0;
}

}  // extern "C"
