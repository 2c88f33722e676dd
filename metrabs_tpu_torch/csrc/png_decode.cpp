// Host PNG pixel decoder with the numbers cv2.imread gives through libpng:
// the five row filters undone, Adam7 passes put in place, and every colour
// type and depth turned into what OpenCV's reader asks libpng for.
//
// The caller (data/png.py) parses the chunks and inflates the IDAT stream
// with zlib; this file sees the inflated scanlines only.
//
// IMREAD_COLOR (3 output channels, RGB order): 16-bit samples keep their high
// byte (png_set_strip_16), gray at 1, 2 and 4 bits is scaled to 8 (x255, x85,
// x17), gray is repeated over three channels, a palette index looks up PLTE
// (entries past its end are black, as libpng's zeroed 256-entry palette
// gives), and alpha, tRNS included, is dropped without compositing.
// IMREAD_GRAYSCALE (1 channel): gray types as above; colour through libpng's
// png_set_rgb_to_gray with OpenCV's coefficients 9797, 19234 and 3737
// (0.299 and 0.587 in 15-bit fixed point, blue the rest): truncated at 8
// bits, (sum + 16384) >> 15 at 16 bits before the high byte is kept, and a
// palette converted from its 8-bit entries.
//
// Plain C interface for ctypes:
//   metrabs_png_decode(raw, raw_size, width, height, depth, colour_type,
//                      interlace, palette, out, channels, err, err_len)
// returns 0, or 1 for corrupt data (the reason in err). `palette` holds 256
// RGB entries; `out` is height x width x channels. `channels` is 3 (colour)
// or 1 (gray), or for an 8-bit file without a palette its own samples per
// pixel, which copies the stored samples (alpha included).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct DecodeError {
  std::string message;
};

[[noreturn]] void corrupt(const std::string& message) { throw DecodeError{message}; }

inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = p > a ? p - a : a - p;
  int pb = p > b ? p - b : b - p;
  int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// Undoes one row's filter in place; `prior` is the unfiltered row above (zeros
// for a pass's first row), `bpp` the bytes per complete pixel (at least 1).
void unfilter(int filter, uint8_t* row, const uint8_t* prior, size_t n, size_t bpp) {
  switch (filter) {
    case 0:
      break;
    case 1:
      for (size_t i = bpp; i < n; i++) row[i] = static_cast<uint8_t>(row[i] + row[i - bpp]);
      break;
    case 2:
      for (size_t i = 0; i < n; i++) row[i] = static_cast<uint8_t>(row[i] + prior[i]);
      break;
    case 3:
      for (size_t i = 0; i < bpp && i < n; i++) row[i] = static_cast<uint8_t>(row[i] + (prior[i] >> 1));
      for (size_t i = bpp; i < n; i++) {
        row[i] = static_cast<uint8_t>(row[i] + ((row[i - bpp] + prior[i]) >> 1));
      }
      break;
    case 4:
      for (size_t i = 0; i < bpp && i < n; i++) row[i] = static_cast<uint8_t>(row[i] + prior[i]);
      for (size_t i = bpp; i < n; i++) {
        row[i] = static_cast<uint8_t>(row[i] + paeth(row[i - bpp], prior[i], prior[i - bpp]));
      }
      break;
    default:
      corrupt("bad adaptive filter value " + std::to_string(filter));
  }
}

struct Image {
  int width, height, depth, colour_type, samples;
  const uint8_t* palette;
  uint8_t* out;
  int channels;

  // Sample `s` of pixel `x` in an unfiltered row, at the file's depth.
  unsigned sample(const uint8_t* row, int x, int s) const {
    if (depth == 16) {
      const uint8_t* p = row + (static_cast<size_t>(x) * samples + s) * 2;
      return (static_cast<unsigned>(p[0]) << 8) | p[1];
    }
    if (depth == 8) return row[static_cast<size_t>(x) * samples + s];
    // Depths 1, 2 and 4 hold one sample per pixel, packed from the high bit.
    size_t bit = static_cast<size_t>(x) * depth;
    unsigned byte = row[bit >> 3];
    return (byte >> (8 - depth - (bit & 7))) & ((1u << depth) - 1);
  }

  // A gray sample at 8 bits: the high byte, or the low depths scaled up.
  unsigned gray8(unsigned v) const {
    switch (depth) {
      case 16: return v >> 8;
      case 1: return v * 255;
      case 2: return v * 85;
      case 4: return v * 17;
      default: return v;
    }
  }

  static uint8_t rgb_to_gray8(unsigned r, unsigned g, unsigned b) {
    return static_cast<uint8_t>((9797 * r + 19234 * g + 3737 * b) >> 15);
  }

  void put(const uint8_t* row, int x, uint8_t* o) const {
    if (channels == samples && depth == 8 && colour_type != 3) {  // the stored samples
      std::memcpy(o, row + static_cast<size_t>(x) * samples, samples);
      return;
    }
    if (channels == 3) {
      switch (colour_type) {
        case 0:
        case 4:
          o[0] = o[1] = o[2] = static_cast<uint8_t>(gray8(sample(row, x, 0)));
          return;
        case 3: {
          const uint8_t* e = palette + 3 * sample(row, x, 0);
          o[0] = e[0];
          o[1] = e[1];
          o[2] = e[2];
          return;
        }
        default:
          for (int c = 0; c < 3; c++) o[c] = static_cast<uint8_t>(gray8(sample(row, x, c)));
          return;
      }
    }
    switch (colour_type) {
      case 0:
      case 4:
        o[0] = static_cast<uint8_t>(gray8(sample(row, x, 0)));
        return;
      case 3: {
        const uint8_t* e = palette + 3 * sample(row, x, 0);
        o[0] = rgb_to_gray8(e[0], e[1], e[2]);
        return;
      }
      default: {
        unsigned r = sample(row, x, 0), g = sample(row, x, 1), b = sample(row, x, 2);
        if (depth == 16) {
          o[0] = static_cast<uint8_t>(((9797 * r + 19234 * g + 3737 * b + 16384) >> 15) >> 8);
        } else {
          o[0] = rgb_to_gray8(r, g, b);
        }
        return;
      }
    }
  }
};

// Adam7: the first column and row of each pass, and their steps.
const int kPassX0[7] = {0, 4, 0, 2, 0, 1, 0};
const int kPassY0[7] = {0, 0, 4, 0, 2, 0, 1};
const int kPassDx[7] = {8, 8, 4, 4, 2, 2, 1};
const int kPassDy[7] = {8, 8, 8, 4, 4, 2, 2};

void decode(const uint8_t* raw, size_t raw_size, const Image& im, int interlace) {
  const size_t bits_per_pixel = static_cast<size_t>(im.samples) * im.depth;
  const size_t bpp = bits_per_pixel < 8 ? 1 : bits_per_pixel / 8;
  const int n_passes = interlace ? 7 : 1;
  size_t pos = 0;
  std::vector<uint8_t> prior, row;
  for (int pass = 0; pass < n_passes; pass++) {
    int x0 = 0, y0 = 0, dx = 1, dy = 1;
    if (interlace) {
      x0 = kPassX0[pass];
      y0 = kPassY0[pass];
      dx = kPassDx[pass];
      dy = kPassDy[pass];
    }
    const int pw = im.width > x0 ? (im.width - x0 + dx - 1) / dx : 0;
    const int ph = im.height > y0 ? (im.height - y0 + dy - 1) / dy : 0;
    if (pw == 0 || ph == 0) continue;  // an empty pass has no filter bytes
    const size_t n = (static_cast<size_t>(pw) * bits_per_pixel + 7) / 8;
    prior.assign(n, 0);
    row.resize(n);
    for (int py = 0; py < ph; py++) {
      if (pos + 1 + n > raw_size) corrupt("not enough image data");
      int filter = raw[pos];
      std::memcpy(row.data(), raw + pos + 1, n);
      pos += 1 + n;
      unfilter(filter, row.data(), prior.data(), n, bpp);
      const size_t y = static_cast<size_t>(y0) + static_cast<size_t>(py) * dy;
      uint8_t* line = im.out + y * im.width * im.channels;
      for (int px = 0; px < pw; px++) {
        im.put(row.data(), px, line + (static_cast<size_t>(x0) + static_cast<size_t>(px) * dx) * im.channels);
      }
      prior.swap(row);
    }
  }
}

}  // namespace

extern "C" {

int metrabs_png_decode(const uint8_t* raw, size_t raw_size, int width, int height, int depth,
                       int colour_type, int interlace, const uint8_t* palette, uint8_t* out,
                       int channels, char* err, int err_len) {
  static const int kSamples[7] = {1, 0, 3, 1, 2, 0, 4};
  try {
    if (colour_type < 0 || colour_type > 6 || kSamples[colour_type] == 0) corrupt("bad colour type");
    Image im{width, height, depth, colour_type, kSamples[colour_type], palette, out, channels};
    decode(raw, raw_size, im, interlace);
    return 0;
  } catch (const DecodeError& e) {
    if (err && err_len > 0) std::snprintf(err, static_cast<size_t>(err_len), "%s", e.message.c_str());
    return 1;
  } catch (const std::bad_alloc&) {
    if (err && err_len > 0) std::snprintf(err, static_cast<size_t>(err_len), "out of memory");
    return 1;
  }
}

}  // extern "C"
