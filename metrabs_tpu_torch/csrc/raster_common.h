// What the host still-image decoders share (jpeg_decode.cpp,
// tiff_decode.cpp, raster_decode.cpp): OpenCV's 14-bit gray conversion and
// LZW as libtiff and OpenCV's GIF reader decode it.

#pragma once

#include <cstddef>
#include <cstdint>
#include <vector>

// OpenCV's icvCvt_BGR2Gray_8u_C3C1R (and its BGRA and CMYK forms): 0.299,
// 0.587 and 0.114 in 14-bit fixed point, rounded. data/raster_native.py's
// gray14 is the same on arrays.
inline uint8_t gray14(unsigned r, unsigned g, unsigned b) {
  return static_cast<uint8_t>((r * 4899 + g * 9617 + b * 1868 + 8192) >> 14);
}

// An LZW code stream: literal codes below 2^min_code_size, then clear and
// end of information, codes growing to 12 bits.
struct LzwFormat {
  int min_code_size;
  bool msb_first;     // codes packed from the top of each byte (TIFF's LZW), else from the bottom
  bool early_change;  // the width grows one code early (TIFF's LZW; not its old style, not GIF)
  bool clear_first;   // the stream must begin with a clear code (TIFF)
  bool strict_end;    // data beyond `need` bytes fails (GIF), else it is cut off (TIFF)
};

// Decodes into dst[0, need) as libtiff's LZWDecode / LZWDecodeCompat and
// OpenCV's GIF reader do. Returns null, or what is wrong with the stream;
// `*written` bytes of dst were decoded either way.
inline const char* lzw_decode(const LzwFormat& f, const uint8_t* src, size_t n, uint8_t* dst,
                              size_t need, size_t* written) {
  constexpr int kTable = 4096 + 1024;  // libtiff's CSIZE
  const int clear = 1 << f.min_code_size, eoi = clear + 1;
  std::vector<int> prefix(kTable, -1), length(kTable, 1);
  std::vector<uint8_t> value(kTable, 0), first(kTable, 0);
  for (int i = 0; i < clear; i++) value[i] = first[i] = static_cast<uint8_t>(i);
  size_t in = 0, out = 0;
  uint64_t window = 0;  // unread bits: the oldest at the top (MSB-first) or the bottom
  int have = 0, width = f.min_code_size + 1, next = eoi + 1, old = -1;
  bool cleared = !f.clear_first;
  const char* error = nullptr;
  while (out < need || f.strict_end) {
    while (have < width && in < n) {
      if (f.msb_first) window = (window << 8) | src[in++];
      else window |= static_cast<uint64_t>(src[in++]) << have;
      have += 8;
    }
    if (have < width) break;  // no end of information: what was decoded counts
    const uint64_t mask = (uint64_t{1} << width) - 1;
    int code;
    if (f.msb_first) {
      code = static_cast<int>((window >> (have - width)) & mask);
    } else {
      code = static_cast<int>(window & mask);
      window >>= width;
    }
    have -= width;
    if (code == eoi) break;
    if (code == clear) {
      width = f.min_code_size + 1;
      next = eoi + 1;
      old = -1;
      cleared = true;
      continue;
    }
    if (!cleared) {
      error = "LZW data does not start with a clear code";
      break;
    }
    if (code > next || (code == next && old < 0)) {
      error = "corrupt LZW code";
      break;
    }
    if (old >= 0 && next < kTable) {
      prefix[next] = old;
      first[next] = first[old];
      length[next] = length[old] + 1;
      value[next] = code < next ? first[code] : first[old];
      next++;
      if (next >= (1 << width) - (f.early_change ? 1 : 0) && width < 12) width++;
    }
    const size_t end = out + static_cast<size_t>(length[code]);
    if (end > need && f.strict_end) {
      error = "more LZW data than the image holds";
      break;
    }
    int c = code;
    for (size_t pos = end; pos-- > out;) {  // the string of `code`, as much of it as fits
      if (pos < need) dst[pos] = value[c];
      c = prefix[c];
    }
    out = end < need ? end : need;
    old = code;
  }
  *written = out;
  if (!error && out < need) error = "not enough LZW data";
  return error;
}
