// Host JPEG decoder with the numbers of libjpeg-turbo 3.1's default decode,
// which is what cv2.imread(path, IMREAD_COLOR) returns: the ISLOW integer IDCT
// (jidctint.c), fancy upsampling (jdsample.c) and the fixed-point YCbCr tables
// (jdcolor.c). Integer arithmetic throughout, so the output equals cv2's bit
// for bit.
//
// Scope: baseline and extended sequential and progressive Huffman JPEG, 8-bit
// samples, 1 (gray), 3 (YCbCr or RGB) or 4 (CMYK or YCCK) components, any
// integral sampling factors, restart intervals, any image size, the standard
// Huffman tables where a file defines none (Motion JPEG frames). The colour
// space is libjpeg's guess (jdapimin.c): three components are RGB under an
// Adobe APP14 with transform 0, or without JFIF and Adobe markers when their
// IDs are 'R', 'G', 'B'; four are CMYK under transform 0 or without an Adobe
// marker, else YCCK (converted to CMYK as jdcolor.c does). OpenCV asks
// libjpeg for CMYK and converts it itself (icvCvt_CMYK2BGR_8u_C4C3R and
// icvCvt_CMYK2Gray_8u_C4C1R), as Adobe's inverted CMYK; an RGB file's gray
// output is libjpeg's rgb_gray_convert. Arithmetic coding, 12-bit, lossless
// and hierarchical files are refused as unsupported; a corrupt or truncated
// file as corrupt (libjpeg would warn and fill; this decoder never returns a
// partial image).
//
// Plain C interface for ctypes:
//   metrabs_jpeg_header(data, size, &height, &width, &orientation, err, n)
//   metrabs_jpeg_decode(data, size, out, out_size, channels, err, n)
//   metrabs_jpeg_decode_tiff(data, size, out, out_size, ycbcr, err, n)
// return 0 on success, 1 for a corrupt file, 2 for an unsupported one (the
// reason is written to err). `orientation` is the EXIF Orientation tag of the
// first APP1 segment (1 when absent), read as OpenCV reads it; the caller
// applies it. The output is height x width x channels, row-major: RGB for 3
// channels; for 1 what cv2.imread(path, IMREAD_GRAYSCALE) returns: for gray
// and YCbCr files the luma plane at full resolution, which is what libjpeg
// gives for JCS_GRAYSCALE output (no colour conversion and no chroma
// upsampling), for RGB, CMYK and YCCK files a conversion of every component.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include "raster_common.h"

namespace {

struct DecodeError {
  int code;  // 1 corrupt, 2 unsupported
  std::string message;
};

[[noreturn]] void corrupt(const std::string& message) { throw DecodeError{1, message}; }
[[noreturn]] void unsupported(const std::string& message) { throw DecodeError{2, message}; }

// Zigzag position -> natural (row-major) position, with libjpeg's 16 extra
// entries so that a corrupt run past the block's end lands on entry 63.
const int kNaturalOrder[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// The standard's Huffman tables (Annex K.3): code counts per length 1-16
// (index 0 unused), then the symbols. libjpeg-turbo's decoder loads them
// into slots 0 and 1 wherever a file defines no table of its own, as Motion
// JPEG frames (AVI1) leave them out.
const uint8_t kDcLumaBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcLumaVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
    0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
    0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
    0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
    0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kDcChromaBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcChromaVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcChromaBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
    0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
    0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
    0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
    0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
    0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

constexpr int kLookBits = 9;

struct HuffTable {
  bool defined = false;
  int maxcode[18];
  int valoffset[18];
  uint8_t vals[256];
  uint8_t look_nbits[1 << kLookBits];
  uint8_t look_sym[1 << kLookBits];
};

// jdhuff.c jpeg_make_d_derived_tbl, with its checks.
void build_huff_table(HuffTable& t, const uint8_t bits[17], const uint8_t* vals, int count,
                      bool is_dc) {
  int huffsize[257];
  unsigned huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; l++) {
    for (int i = 0; i < bits[l]; i++) huffsize[p++] = l;
  }
  huffsize[p] = 0;
  unsigned code = 0;
  int si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) {
      huffcode[p++] = code;
      code++;
    }
    if (static_cast<int64_t>(code) >= (int64_t{1} << si)) corrupt("bad Huffman table");
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (bits[l]) {
      t.valoffset[l] = p - static_cast<int>(huffcode[p]);
      p += bits[l];
      t.maxcode[l] = static_cast<int>(huffcode[p - 1]);
    } else {
      t.maxcode[l] = -1;
    }
  }
  t.maxcode[17] = 0x7fffffff;
  std::memset(t.vals, 0, sizeof(t.vals));
  std::memcpy(t.vals, vals, count);
  std::memset(t.look_nbits, 0, sizeof(t.look_nbits));
  p = 0;
  for (int l = 1; l <= kLookBits; l++) {
    for (int i = 1; i <= bits[l]; i++, p++) {
      int lookbits = static_cast<int>(huffcode[p]) << (kLookBits - l);
      for (int ctr = 1 << (kLookBits - l); ctr > 0; ctr--, lookbits++) {
        t.look_nbits[lookbits] = static_cast<uint8_t>(l);
        t.look_sym[lookbits] = vals[p];
      }
    }
  }
  if (is_dc) {
    for (int i = 0; i < count; i++) {
      if (vals[i] > 15) corrupt("bad Huffman table");
    }
  }
  t.defined = true;
}

// Reads entropy-coded bytes: FF 00 is a data FF, any other marker ends the
// segment. Past its end the buffer is filled with zeros, as libjpeg fills
// it; consuming any of those bits marks the segment truncated.
struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t pos;
  uint64_t buf = 0;
  int count = 0;
  int padded = 0;  // zero bits at the tail of buf that are not data
  bool at_marker = false;
  bool overrun = false;

  BitReader(const uint8_t* d, size_t n, size_t p) : data(d), size(n), pos(p) {}

  void fill() {
    while (count <= 56) {
      uint64_t byte = 0;
      if (!at_marker && pos < size) {
        byte = data[pos];
        if (byte == 0xFF) {
          size_t q = pos + 1;
          while (q < size && data[q] == 0xFF) q++;
          if (q < size && data[q] == 0) {
            pos = q + 1;
          } else {
            at_marker = true;  // pos stays on the marker's first FF
            byte = 0;
            padded += 8;
          }
        } else {
          pos++;
        }
      } else {
        padded += 8;
      }
      buf |= byte << (56 - count);
      count += 8;
    }
  }

  inline unsigned peek(int n) {
    if (count < n) fill();
    return static_cast<unsigned>(buf >> (64 - n));
  }

  inline void skip(int n) {
    buf <<= n;
    count -= n;
    if (count < padded) overrun = true;
  }

  inline int bits(int n) {
    if (n == 0) return 0;
    unsigned v = peek(n);
    skip(n);
    return static_cast<int>(v);
  }

  inline int decode(const HuffTable& t) {
    unsigned look = peek(16);
    int n = t.look_nbits[look >> (16 - kLookBits)];
    if (n) {
      skip(n);
      return t.look_sym[look >> (16 - kLookBits)];
    }
    for (int l = kLookBits + 1; l <= 16; l++) {
      int code = static_cast<int>(look >> (16 - l));
      if (code <= t.maxcode[l]) {
        skip(l);
        return t.vals[(code + t.valoffset[l]) & 0xFF];
      }
    }
    corrupt("bad Huffman code");
  }

  void reset() {
    buf = 0;
    count = 0;
    padded = 0;
    at_marker = false;
  }
};

inline int extend(int x, int s) { return x < (1 << (s - 1)) ? x + static_cast<int>((~0u << s) + 1) : x; }

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int blocks_w = 0, blocks_h = 0;        // allocated (MCU-padded) blocks
  int width_in_blocks = 0, height_in_blocks = 0;
  int down_w = 0, down_h = 0;            // downsampled_width / downsampled_height
  bool latched = false;
  int16_t quant[64] = {0};               // natural order, as ISLOW_MULT_TYPE
  std::vector<int16_t> coef;
  std::vector<uint8_t> plane;            // blocks_w*8 x blocks_h*8 samples
  int dc_table = 0, ac_table = 0, last_dc = 0;
};

uint8_t g_idct_limit[1024];   // jdmaster.c prepare_range_limit_table, post-IDCT part
uint8_t g_clamp[1024 + 512];  // its simple part: x -> clamp(x, 0, 255) for x in [-512, 1023]
int g_cr_r[256], g_cb_b[256];
int64_t g_cr_g[256], g_cb_g[256];

struct Tables {
  Tables() {
    for (int i = 0; i < 1024; i++) {
      g_idct_limit[i] = static_cast<uint8_t>(i < 128 ? i + 128 : i < 512 ? 255 : i < 896 ? 0 : i - 896);
    }
    for (int i = 0; i < 1024 + 512; i++) {
      int x = i - 512;
      g_clamp[i] = static_cast<uint8_t>(x < 0 ? 0 : x > 255 ? 255 : x);
    }
    // jdcolor.c build_ycc_rgb_table.
    const int scalebits = 16;
    const int64_t one_half = int64_t{1} << (scalebits - 1);
    auto fix = [](double x) { return static_cast<int64_t>(x * (1L << 16) + 0.5); };
    for (int i = 0, x = -128; i < 256; i++, x++) {
      g_cr_r[i] = static_cast<int>((fix(1.40200) * x + one_half) >> scalebits);
      g_cb_b[i] = static_cast<int>((fix(1.77200) * x + one_half) >> scalebits);
      g_cr_g[i] = -fix(0.71414) * x;
      g_cb_g[i] = -fix(0.34414) * x + one_half;
    }
  }
};
const Tables g_tables;

// jidctint.c jpeg_idct_islow.
void idct_islow(const int16_t* in, const int16_t* quant, uint8_t* out, int stride) {
  constexpr int kConstBits = 13, kPass1Bits = 2;
  constexpr int64_t F_0_298 = 2446, F_0_390 = 3196, F_0_541 = 4433, F_0_765 = 6270,
                    F_0_899 = 7373, F_1_175 = 9633, F_1_501 = 12299, F_1_847 = 15137,
                    F_1_961 = 16069, F_2_053 = 16819, F_2_562 = 20995, F_3_072 = 25172;
  auto descale = [](int64_t x, int n) { return (x + (int64_t{1} << (n - 1))) >> n; };
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* ip = in + c;
    const int16_t* qp = quant + c;
    int* wp = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 && ip[40] == 0 && ip[48] == 0 &&
        ip[56] == 0) {
      int dc = static_cast<int>(static_cast<uint32_t>(ip[0] * qp[0]) << kPass1Bits);
      for (int k = 0; k < 8; k++) wp[8 * k] = dc;
      continue;
    }
    int64_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * F_0_541;
    int64_t tmp2 = z1 + z3 * -F_1_847;
    int64_t tmp3 = z1 + z2 * F_0_765;
    z2 = ip[0] * qp[0];
    z3 = ip[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (int64_t{1} << kConstBits);
    int64_t tmp1 = (z2 - z3) * (int64_t{1} << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = ip[56] * qp[56];
    tmp1 = ip[40] * qp[40];
    tmp2 = ip[24] * qp[24];
    tmp3 = ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F_1_175;
    tmp0 *= F_0_298;
    tmp1 *= F_2_053;
    tmp2 *= F_3_072;
    tmp3 *= F_1_501;
    z1 *= -F_0_899;
    z2 *= -F_2_562;
    z3 *= -F_1_961;
    z4 *= -F_0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int s1 = kConstBits - kPass1Bits;
    wp[0] = static_cast<int>(descale(tmp10 + tmp3, s1));
    wp[56] = static_cast<int>(descale(tmp10 - tmp3, s1));
    wp[8] = static_cast<int>(descale(tmp11 + tmp2, s1));
    wp[48] = static_cast<int>(descale(tmp11 - tmp2, s1));
    wp[16] = static_cast<int>(descale(tmp12 + tmp1, s1));
    wp[40] = static_cast<int>(descale(tmp12 - tmp1, s1));
    wp[24] = static_cast<int>(descale(tmp13 + tmp0, s1));
    wp[32] = static_cast<int>(descale(tmp13 - tmp0, s1));
  }
  for (int r = 0; r < 8; r++) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + r * stride;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 && wp[6] == 0 &&
        wp[7] == 0) {
      uint8_t v = g_idct_limit[static_cast<int>(descale(wp[0], kPass1Bits + 3)) & 1023];
      std::memset(op, v, 8);
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * F_0_541;
    int64_t tmp2 = z1 + z3 * -F_1_847;
    int64_t tmp3 = z1 + z2 * F_0_765;
    int64_t tmp0 = (int64_t{wp[0]} + wp[4]) * (int64_t{1} << kConstBits);
    int64_t tmp1 = (int64_t{wp[0]} - wp[4]) * (int64_t{1} << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F_1_175;
    tmp0 *= F_0_298;
    tmp1 *= F_2_053;
    tmp2 *= F_3_072;
    tmp3 *= F_1_501;
    z1 *= -F_0_899;
    z2 *= -F_2_562;
    z3 *= -F_1_961;
    z4 *= -F_0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int s2 = kConstBits + kPass1Bits + 3;
    op[0] = g_idct_limit[static_cast<int>(descale(tmp10 + tmp3, s2)) & 1023];
    op[7] = g_idct_limit[static_cast<int>(descale(tmp10 - tmp3, s2)) & 1023];
    op[1] = g_idct_limit[static_cast<int>(descale(tmp11 + tmp2, s2)) & 1023];
    op[6] = g_idct_limit[static_cast<int>(descale(tmp11 - tmp2, s2)) & 1023];
    op[2] = g_idct_limit[static_cast<int>(descale(tmp12 + tmp1, s2)) & 1023];
    op[5] = g_idct_limit[static_cast<int>(descale(tmp12 - tmp1, s2)) & 1023];
    op[3] = g_idct_limit[static_cast<int>(descale(tmp13 + tmp0, s2)) & 1023];
    op[4] = g_idct_limit[static_cast<int>(descale(tmp13 - tmp0, s2)) & 1023];
  }
}

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t size) : data_(data), size_(size) {}

  // Reads the markers up to the first scan: the frame and the EXIF orientation.
  void read_header() { parse(false); }

  void decode(uint8_t* out, size_t out_size, int channels) {
    parse(true);
    if ((channels != 1 && channels != 3) ||
        out_size != static_cast<size_t>(height) * width * channels) {
      corrupt("output buffer of the wrong size");
    }
    reconstruct(out, channels);
  }

  // A strip or tile of a JPEG-compressed TIFF as libtiff's JPEG codec gives
  // it: with `ycbcr` (Photometric YCbCr, JPEGCOLORMODE_RGB) three components
  // converted to RGB whatever the markers say; otherwise every component as
  // coded, without colour conversion, all of them unsubsampled.
  void decode_tiff(uint8_t* out, size_t out_size, bool ycbcr) {
    parse(true);
    const int nc = static_cast<int>(comps_.size());
    if (ycbcr) {
      if (nc != 3) corrupt("YCbCr data without three components");
      space_ = kYcc;
    } else {
      for (const Component& c : comps_) {
        if (c.h != 1 || c.v != 1) corrupt("improper JPEG sampling factors");
      }
      raw_ = true;
    }
    const int channels = ycbcr ? 3 : nc;
    if (out_size != static_cast<size_t>(height) * width * channels) {
      corrupt("output buffer of the wrong size");
    }
    reconstruct(out, channels);
  }

  int height = 0, width = 0, orientation = 1;

 private:
  const uint8_t* data_;
  size_t size_;
  size_t pos_ = 0;
  bool progressive_ = false, have_frame_ = false, saw_jfif_ = false, saw_adobe_ = false;
  bool saw_app1_ = false, raw_ = false;
  int adobe_transform_ = -1;
  enum Space { kGray, kYcc, kRgb, kCmyk, kYcck } space_ = kGray;
  int restart_interval_ = 0;
  int max_h_ = 1, max_v_ = 1, mcus_x_ = 0, mcus_y_ = 0;
  std::vector<Component> comps_;
  uint16_t quant_[4][64] = {{0}};
  bool quant_defined_[4] = {false, false, false, false};
  HuffTable dc_tables_[4], ac_tables_[4];
  bool standard_tables_checked_ = false;

  unsigned u8(size_t at) const {
    if (at >= size_) corrupt("truncated file (no end-of-image marker)");
    return data_[at];
  }
  unsigned u16(size_t at) const { return (u8(at) << 8) | u8(at + 1); }

  // libjpeg's next_marker: skips anything up to FF, fill FFs and FF 00.
  int next_marker() {
    for (;;) {
      while (u8(pos_) != 0xFF) pos_++;
      while (u8(pos_) == 0xFF) pos_++;
      int m = static_cast<int>(u8(pos_));
      pos_++;
      if (m != 0) return m;
    }
  }

  void parse(bool decode_scans) {
    if (size_ < 3 || data_[0] != 0xFF || data_[1] != 0xD8) corrupt("not a JPEG file (no SOI marker)");
    pos_ = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) {  // EOI
        if (!have_frame_) corrupt("no frame before end of image");
        return;
      }
      if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;  // stray RSTn, TEM
      size_t seg = pos_;
      size_t len = u16(seg);
      if (len < 2) corrupt("bad marker length");
      u8(seg + len - 1);  // the whole segment lies within the file
      size_t body = seg + 2, end = seg + len;
      switch (m) {
        case 0xC0: case 0xC1: case 0xC2:
          read_frame(body, end, m == 0xC2);
          break;
        case 0xC3: unsupported("lossless JPEG");
        case 0xC5: case 0xC6: case 0xC7:
        case 0xCD: case 0xCE: case 0xCF: unsupported("hierarchical (differential) JPEG");
        case 0xC9: case 0xCA: case 0xCB: case 0xCC: unsupported("arithmetic-coded JPEG");
        case 0xC4: read_dht(body, end); break;
        case 0xDB: read_dqt(body, end); break;
        case 0xDD:
          if (len != 4) corrupt("bad DRI length");
          restart_interval_ = static_cast<int>(u16(body));
          break;
        case 0xDA: {
          if (!have_frame_) corrupt("scan before frame");
          if (!decode_scans) return;
          pos_ = end;
          read_scan(body, end);
          continue;
        }
        case 0xE0: read_app0(body, end); break;
        case 0xE1: read_app1(body, end); break;
        case 0xEE: read_app14(body, end); break;
        case 0xDC: case 0xFE: break;  // DNL (ignored, as libjpeg does), COM
        default:
          if (m >= 0xE0 && m <= 0xEF) break;
          corrupt("unknown marker");
      }
      pos_ = end;
    }
  }

  void read_app0(size_t body, size_t end) {
    if (end - body >= 14 && std::memcmp(data_ + body, "JFIF\0", 5) == 0) saw_jfif_ = true;
  }

  void read_app14(size_t body, size_t end) {
    if (end - body >= 12 && std::memcmp(data_ + body, "Adobe", 5) == 0) {
      saw_adobe_ = true;
      adobe_transform_ = data_[body + 11];
    }
  }

  // OpenCV reads the first APP1 segment, whatever it holds, as Exif: a TIFF
  // header 6 bytes in, then IFD0's entries; Orientation is a SHORT read from
  // its value field.
  void read_app1(size_t body, size_t end) {
    if (saw_app1_) return;
    saw_app1_ = true;
    if (end - body <= 6) return;
    const uint8_t* t = data_ + body + 6;
    size_t n = end - body - 6;
    bool little;
    if (n >= 2 && t[0] == 'I' && t[1] == 'I') little = true;
    else if (n >= 2 && t[0] == 'M' && t[1] == 'M') little = false;
    else return;
    auto get16 = [&](size_t at, bool& ok) -> unsigned {
      if (at + 1 >= n) { ok = false; return 0; }
      return little ? t[at] | (t[at + 1] << 8) : (t[at] << 8) | t[at + 1];
    };
    auto get32 = [&](size_t at, bool& ok) -> uint32_t {
      if (at + 3 >= n) { ok = false; return 0; }
      return little ? t[at] | (t[at + 1] << 8) | (t[at + 2] << 16) | (uint32_t{t[at + 3]} << 24)
                    : (uint32_t{t[at]} << 24) | (t[at + 1] << 16) | (t[at + 2] << 8) | t[at + 3];
    };
    bool ok = true;
    if (get16(2, ok) != 0x2A || !ok) return;
    size_t offset = get32(4, ok);
    unsigned n_entries = get16(offset, ok);
    if (!ok) return;
    offset += 2;
    for (unsigned i = 0; i < n_entries; i++, offset += 12) {
      unsigned tag = get16(offset, ok);
      if (!ok) return;
      if (tag == 0x0112) {
        unsigned value = get16(offset + 8, ok);
        if (!ok) return;
        orientation = static_cast<int>(value);
      }
    }
  }

  void read_dqt(size_t body, size_t end) {
    size_t p = body;
    while (p < end) {
      unsigned pq_tq = u8(p++);
      unsigned pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3) corrupt("bad quantization table index");
      if (pq > 1) corrupt("bad quantization table precision");
      for (int i = 0; i < 64; i++) {
        unsigned q;
        if (pq) { q = u16(p); p += 2; }
        else q = u8(p++);
        if (p > end) corrupt("bad DQT length");
        quant_[tq][kNaturalOrder[i]] = static_cast<uint16_t>(q);
      }
      quant_defined_[tq] = true;
    }
    if (p != end) corrupt("bad DQT length");
  }

  // jdhuff.c std_huff_tables: DC and AC slots 0 and 1 that no DHT segment
  // filled by the first scan get the standard's tables.
  void load_standard_huff_tables() {
    if (standard_tables_checked_) return;
    standard_tables_checked_ = true;
    const uint8_t* dc_bits[2] = {kDcLumaBits, kDcChromaBits};
    const uint8_t* dc_vals[2] = {kDcLumaVals, kDcChromaVals};
    const uint8_t* ac_bits[2] = {kAcLumaBits, kAcChromaBits};
    const uint8_t* ac_vals[2] = {kAcLumaVals, kAcChromaVals};
    for (int t = 0; t < 2; t++) {
      if (!dc_tables_[t].defined) build_huff_table(dc_tables_[t], dc_bits[t], dc_vals[t], 12, true);
      if (!ac_tables_[t].defined) build_huff_table(ac_tables_[t], ac_bits[t], ac_vals[t], 162, false);
    }
  }

  void read_dht(size_t body, size_t end) {
    size_t p = body;
    while (p + 17 <= end) {
      unsigned tc_th = u8(p++);
      uint8_t bits[17];
      bits[0] = 0;
      int count = 0;
      for (int i = 1; i <= 16; i++) {
        bits[i] = static_cast<uint8_t>(u8(p++));
        count += bits[i];
      }
      if (count > 256 || p + count > end) corrupt("bad Huffman table");
      uint8_t vals[256];
      std::memset(vals, 0, sizeof(vals));
      for (int i = 0; i < count; i++) vals[i] = static_cast<uint8_t>(u8(p++));
      unsigned tc = tc_th >> 4, th = tc_th & 15;
      if (th > 3 || tc > 1) corrupt("bad Huffman table index");
      build_huff_table(tc ? ac_tables_[th] : dc_tables_[th], bits, vals, count, tc == 0);
    }
    if (p != end) corrupt("bad DHT length");
  }

  void read_frame(size_t body, size_t end, bool progressive) {
    if (have_frame_) corrupt("more than one frame");
    if (end - body < 6) corrupt("bad SOF length");
    int precision = static_cast<int>(u8(body));
    height = static_cast<int>(u16(body + 1));
    width = static_cast<int>(u16(body + 3));
    int nf = static_cast<int>(u8(body + 5));
    if (precision != 8) unsupported(std::to_string(precision) + "-bit samples");
    if (height <= 0 || width <= 0) corrupt("empty image");
    if (nf != 1 && nf != 3 && nf != 4) unsupported(std::to_string(nf) + "-component JPEG");
    if (end - body != static_cast<size_t>(6 + 3 * nf)) corrupt("bad SOF length");
    comps_.resize(nf);
    for (int i = 0; i < nf; i++) {
      Component& c = comps_[i];
      c.id = static_cast<int>(u8(body + 6 + 3 * i));
      unsigned hv = u8(body + 7 + 3 * i);
      c.h = static_cast<int>(hv >> 4);
      c.v = static_cast<int>(hv & 15);
      c.tq = static_cast<int>(u8(body + 8 + 3 * i));
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) corrupt("bad sampling factors");
      if (c.tq > 3) corrupt("bad quantization table index");
      max_h_ = std::max(max_h_, c.h);
      max_v_ = std::max(max_v_, c.v);
    }
    for (Component& c : comps_) {
      if (max_h_ % c.h || max_v_ % c.v) unsupported("fractional sampling factors");
    }
    progressive_ = progressive;
    have_frame_ = true;
    if (nf == 3) {
      bool rgb = false;
      if (saw_jfif_) rgb = false;
      else if (saw_adobe_) rgb = adobe_transform_ == 0;
      else rgb = comps_[0].id == 'R' && comps_[1].id == 'G' && comps_[2].id == 'B';
      space_ = rgb ? kRgb : kYcc;
    } else if (nf == 4) {
      space_ = saw_adobe_ && adobe_transform_ != 0 ? kYcck : kCmyk;
    }
    mcus_x_ = (width + 8 * max_h_ - 1) / (8 * max_h_);
    mcus_y_ = (height + 8 * max_v_ - 1) / (8 * max_v_);
    for (Component& c : comps_) {
      c.down_w = static_cast<int>((int64_t{width} * c.h + max_h_ - 1) / max_h_);
      c.down_h = static_cast<int>((int64_t{height} * c.v + max_v_ - 1) / max_v_);
      c.width_in_blocks = (c.down_w + 7) / 8;
      c.height_in_blocks = (c.down_h + 7) / 8;
      c.blocks_w = mcus_x_ * c.h;
      c.blocks_h = mcus_y_ * c.v;
    }
  }

  void allocate() {
    for (Component& c : comps_) {
      if (c.coef.empty()) c.coef.assign(static_cast<size_t>(c.blocks_w) * c.blocks_h * 64, 0);
    }
  }

  void read_scan(size_t body, size_t end) {
    allocate();
    size_t p = body;
    int ns = static_cast<int>(u8(p++));
    if (ns < 1 || ns > 4 || end - body != static_cast<size_t>(4 + 2 * ns)) corrupt("bad SOS length");
    std::vector<int> scan;
    for (int i = 0; i < ns; i++) {
      int cs = static_cast<int>(u8(p++));
      unsigned tables = u8(p++);
      int ci = -1;
      for (int k = 0; k < static_cast<int>(comps_.size()); k++) {
        if (comps_[k].id == cs) ci = k;
      }
      if (ci < 0) corrupt("scan names an unknown component");
      for (int k : scan) {
        if (k == ci) corrupt("component repeated in a scan");
      }
      comps_[ci].dc_table = static_cast<int>(tables >> 4);
      comps_[ci].ac_table = static_cast<int>(tables & 15);
      if (comps_[ci].dc_table > 3 || comps_[ci].ac_table > 3) corrupt("bad Huffman table index");
      scan.push_back(ci);
    }
    int ss = static_cast<int>(u8(p)), se = static_cast<int>(u8(p + 1));
    int ah = static_cast<int>(u8(p + 2) >> 4), al = static_cast<int>(u8(p + 2) & 15);
    if (progressive_) {
      bool bad = ss == 0 ? se != 0 : (se < ss || se > 63 || ns != 1);
      if (bad || ah > 13 || al > 13) corrupt("bad progression parameters");
    } else {
      ss = 0;
      se = 63;
      ah = al = 0;
    }
    int blocks_in_mcu = 0;
    for (int ci : scan) blocks_in_mcu += ns == 1 ? 1 : comps_[ci].h * comps_[ci].v;
    if (blocks_in_mcu > 10) corrupt("too many blocks in an MCU");
    load_standard_huff_tables();
    // libjpeg latches each component's quantization table at its first scan.
    for (int ci : scan) {
      Component& c = comps_[ci];
      if (!c.latched) {
        if (!quant_defined_[c.tq]) corrupt("quantization table not defined");
        for (int k = 0; k < 64; k++) c.quant[k] = static_cast<int16_t>(quant_[c.tq][k]);
        c.latched = true;
      }
      bool need_dc = ss == 0 && ah == 0, need_ac = ss > 0 || !progressive_;
      if (need_dc && !dc_tables_[c.dc_table].defined) corrupt("Huffman table not defined");
      if (need_ac && !ac_tables_[c.ac_table].defined) corrupt("Huffman table not defined");
    }
    decode_scan(scan, ss, se, ah, al);
  }

  void decode_scan(const std::vector<int>& scan, int ss, int se, int ah, int al) {
    BitReader br(data_, size_, pos_);
    for (int ci : scan) comps_[ci].last_dc = 0;
    int eobrun = 0, next_rst = 0, restarts_to_go = restart_interval_;
    int ns = static_cast<int>(scan.size());
    int mx_n = ns == 1 ? comps_[scan[0]].width_in_blocks : mcus_x_;
    int my_n = ns == 1 ? comps_[scan[0]].height_in_blocks : mcus_y_;
    enum { kSequential, kDcFirst, kDcRefine, kAcFirst, kAcRefine } kind;
    if (!progressive_) kind = kSequential;
    else if (ss == 0) kind = ah == 0 ? kDcFirst : kDcRefine;
    else kind = ah == 0 ? kAcFirst : kAcRefine;

    auto block = [&](Component& c, int bx, int by) {
      int16_t* b = &c.coef[(static_cast<size_t>(by) * c.blocks_w + bx) * 64];
      switch (kind) {
        case kSequential: {
          int s = br.decode(dc_tables_[c.dc_table]);
          if (s) s = extend(br.bits(s), s);
          c.last_dc = static_cast<int>(static_cast<unsigned>(c.last_dc) + static_cast<unsigned>(s));
          b[0] = static_cast<int16_t>(c.last_dc);
          const HuffTable& ac = ac_tables_[c.ac_table];
          for (int k = 1; k < 64; k++) {
            int rs = br.decode(ac);
            int r = rs >> 4;
            s = rs & 15;
            if (s) {
              k += r;
              b[kNaturalOrder[k]] = static_cast<int16_t>(extend(br.bits(s), s));
            } else {
              if (r != 15) break;
              k += 15;
            }
          }
          break;
        }
        case kDcFirst: {
          int s = br.decode(dc_tables_[c.dc_table]);
          if (s) s = extend(br.bits(s), s);
          c.last_dc = static_cast<int>(static_cast<unsigned>(c.last_dc) + static_cast<unsigned>(s));
          b[0] = static_cast<int16_t>(static_cast<unsigned>(c.last_dc) << al);
          break;
        }
        case kDcRefine:
          if (br.bits(1)) b[0] = static_cast<int16_t>(b[0] | (1 << al));
          break;
        case kAcFirst: {
          if (eobrun > 0) {
            eobrun--;
            break;
          }
          const HuffTable& ac = ac_tables_[c.ac_table];
          for (int k = ss; k <= se; k++) {
            int rs = br.decode(ac);
            int r = rs >> 4, s = rs & 15;
            if (s) {
              k += r;
              int v = extend(br.bits(s), s);
              b[kNaturalOrder[k]] = static_cast<int16_t>(static_cast<unsigned>(v) << al);
            } else if (r == 15) {
              k += 15;
            } else {
              eobrun = 1 << r;
              if (r) eobrun += br.bits(r);
              eobrun--;
              break;
            }
          }
          break;
        }
        case kAcRefine: {
          int p1 = 1 << al, m1 = static_cast<int>(~0u << al);
          int k = ss;
          const HuffTable& ac = ac_tables_[c.ac_table];
          if (eobrun == 0) {
            for (; k <= se; k++) {
              int rs = br.decode(ac);
              int r = rs >> 4, s = rs & 15;
              if (s) {
                s = br.bits(1) ? p1 : m1;
              } else if (r != 15) {
                eobrun = 1 << r;
                if (r) eobrun += br.bits(r);
                break;
              }
              do {
                int16_t* coef = b + kNaturalOrder[k];
                if (*coef != 0) {
                  if (br.bits(1) && (*coef & p1) == 0) {
                    *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
                  }
                } else if (--r < 0) {
                  break;
                }
                k++;
              } while (k <= se);
              if (s) b[kNaturalOrder[k]] = static_cast<int16_t>(s);
            }
          }
          if (eobrun > 0) {
            for (; k <= se; k++) {
              int16_t* coef = b + kNaturalOrder[k];
              if (*coef != 0 && br.bits(1) && (*coef & p1) == 0) {
                *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
              }
            }
            eobrun--;
          }
          break;
        }
      }
    };

    for (int my = 0; my < my_n; my++) {
      for (int mx = 0; mx < mx_n; mx++) {
        if (restart_interval_) {
          if (restarts_to_go == 0) {
            restart(br, next_rst);
            next_rst = (next_rst + 1) & 7;
            for (int ci : scan) comps_[ci].last_dc = 0;
            eobrun = 0;
            restarts_to_go = restart_interval_;
          }
          restarts_to_go--;
        }
        if (ns == 1) {
          block(comps_[scan[0]], mx, my);
        } else {
          for (int ci : scan) {
            Component& c = comps_[ci];
            for (int v = 0; v < c.v; v++) {
              for (int h = 0; h < c.h; h++) block(c, mx * c.h + h, my * c.v + v);
            }
          }
        }
      }
    }
    if (br.overrun) corrupt("truncated or corrupt entropy-coded data");
    pos_ = br.pos;
  }

  void restart(BitReader& br, int expected) {
    if (br.overrun) corrupt("truncated or corrupt entropy-coded data");
    pos_ = br.pos;
    int m = next_marker();
    if (m != 0xD0 + expected) corrupt("bad restart marker");
    br.reset();
    br.pos = pos_;
  }

  // Dequantization and the IDCT of every block within the image, then
  // upsampling and colour conversion row by row (for one output channel,
  // the luma component alone).
  void reconstruct(uint8_t* out, int channels) {
    allocate();
    for (Component& c : comps_) {
      const int stride = c.blocks_w * 8;
      c.plane.assign(static_cast<size_t>(stride) * c.blocks_h * 8, 0);
      for (int by = 0; by < c.height_in_blocks; by++) {
        for (int bx = 0; bx < c.width_in_blocks; bx++) {
          idct_islow(&c.coef[(static_cast<size_t>(by) * c.blocks_w + bx) * 64], c.quant,
                     &c.plane[static_cast<size_t>(by) * 8 * stride + bx * 8], stride);
        }
      }
      std::vector<int16_t>().swap(c.coef);
    }
    const bool luma_only = !raw_ && (space_ == kGray || (channels == 1 && space_ == kYcc));
    const int nc = luma_only ? 1 : static_cast<int>(comps_.size());
    std::vector<std::vector<uint8_t>> rows(nc, std::vector<uint8_t>(width + 8));
    std::vector<int> colsum(width + 8);
    const uint8_t* clamp = g_clamp + 512;
    for (int y = 0; y < height; y++) {
      for (int ci = 0; ci < nc; ci++) upsample_row(comps_[ci], y, rows[ci].data(), colsum.data());
      uint8_t* o = out + static_cast<size_t>(y) * width * channels;
      if (raw_) {
        for (int x = 0; x < width; x++) {
          for (int ci = 0; ci < nc; ci++) o[static_cast<size_t>(x) * nc + ci] = rows[ci][x];
        }
        continue;
      }
      if (nc == 1) {
        const uint8_t* g = rows[0].data();
        if (channels == 1) std::memcpy(o, g, width);
        else for (int x = 0; x < width; x++) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = g[x];
        continue;
      }
      const uint8_t *c0 = rows[0].data(), *c1 = rows[1].data(), *c2 = rows[2].data();
      for (int x = 0; x < width; x++) {
        int r, g, b;
        if (space_ == kRgb) {
          r = c0[x];
          g = c1[x];
          b = c2[x];
          if (channels == 1) {  // jdcolor.c rgb_gray_convert
            o[x] = static_cast<uint8_t>((19595 * r + 38470 * g + 7471 * b + 32768) >> 16);
            continue;
          }
        } else {
          int l = c0[x];
          r = clamp[l + g_cr_r[c2[x]]];
          g = clamp[l + static_cast<int>((g_cb_g[c1[x]] + g_cr_g[c2[x]]) >> 16)];
          b = clamp[l + g_cb_b[c1[x]]];
          if (space_ != kYcc) {
            int k = rows[3][x], cyan, magenta, yellow;
            if (space_ == kCmyk) {
              cyan = c0[x];
              magenta = c1[x];
              yellow = c2[x];
            } else {  // jdcolor.c ycck_cmyk_convert
              cyan = clamp[255 - (l + g_cr_r[c2[x]])];
              magenta = clamp[255 - (l + static_cast<int>((g_cb_g[c1[x]] + g_cr_g[c2[x]]) >> 16))];
              yellow = clamp[255 - (l + g_cb_b[c1[x]])];
            }
            // OpenCV's icvCvt_CMYK2BGR_8u_C4C3R (inverted CMYK).
            r = k - ((255 - cyan) * k >> 8);
            g = k - ((255 - magenta) * k >> 8);
            b = k - ((255 - yellow) * k >> 8);
            if (channels == 1) {  // icvCvt_CMYK2Gray_8u_C4C1R
              o[x] = gray14(r, g, b);
              continue;
            }
          }
        }
        o[3 * x] = static_cast<uint8_t>(r);
        o[3 * x + 1] = static_cast<uint8_t>(g);
        o[3 * x + 2] = static_cast<uint8_t>(b);
      }
    }
  }

  // One output row of a component at full resolution (jdsample.c).
  void upsample_row(const Component& c, int y, uint8_t* out, int* colsum) {
    const int hr = max_h_ / c.h, vr = max_v_ / c.v, stride = c.blocks_w * 8, dw = c.down_w;
    auto row = [&](int r) {
      r = r < 0 ? 0 : (r >= c.down_h ? c.down_h - 1 : r);
      return &c.plane[static_cast<size_t>(r) * stride];
    };
    if (hr == 1 && vr == 1) {
      std::memcpy(out, row(y), width);
    } else if (hr == 2 && vr == 1 && dw > 2) {  // h2v1_fancy_upsample
      const uint8_t* in = row(y);
      out[0] = in[0];
      out[1] = static_cast<uint8_t>((in[0] * 3 + in[1] + 2) >> 2);
      for (int x = 1; x < dw - 1; x++) {
        int v = in[x] * 3;
        out[2 * x] = static_cast<uint8_t>((v + in[x - 1] + 1) >> 2);
        out[2 * x + 1] = static_cast<uint8_t>((v + in[x + 1] + 2) >> 2);
      }
      int last = dw - 1;
      out[2 * last] = static_cast<uint8_t>((in[last] * 3 + in[last - 1] + 1) >> 2);
      out[2 * last + 1] = in[last];
    } else if (hr == 2 && vr == 2 && dw > 2) {  // h2v2_fancy_upsample
      const int r = y >> 1;
      const uint8_t* in0 = row(r);
      const uint8_t* in1 = row((y & 1) ? r + 1 : r - 1);
      for (int x = 0; x < dw; x++) colsum[x] = in0[x] * 3 + in1[x];
      out[0] = static_cast<uint8_t>((colsum[0] * 4 + 8) >> 4);
      out[1] = static_cast<uint8_t>((colsum[0] * 3 + colsum[1] + 7) >> 4);
      for (int x = 1; x < dw - 1; x++) {
        out[2 * x] = static_cast<uint8_t>((colsum[x] * 3 + colsum[x - 1] + 8) >> 4);
        out[2 * x + 1] = static_cast<uint8_t>((colsum[x] * 3 + colsum[x + 1] + 7) >> 4);
      }
      int last = dw - 1;
      out[2 * last] = static_cast<uint8_t>((colsum[last] * 3 + colsum[last - 1] + 8) >> 4);
      out[2 * last + 1] = static_cast<uint8_t>((colsum[last] * 4 + 7) >> 4);
    } else if (hr == 1 && vr == 2) {  // h1v2_fancy_upsample
      const int r = y >> 1;
      const uint8_t* in0 = row(r);
      const uint8_t* in1 = row((y & 1) ? r + 1 : r - 1);
      const int bias = (y & 1) ? 2 : 1;
      for (int x = 0; x < width; x++) out[x] = static_cast<uint8_t>((in0[x] * 3 + in1[x] + bias) >> 2);
    } else {  // h2v1_upsample, h2v2_upsample, int_upsample: replication
      const uint8_t* in = row(y / vr);
      for (int x = 0; x < width; x++) out[x] = in[x / hr];
    }
  }
};

int report(const DecodeError& e, char* err, int err_len) {
  if (err && err_len > 0) std::snprintf(err, static_cast<size_t>(err_len), "%s", e.message.c_str());
  return e.code;
}

}  // namespace

extern "C" {

int metrabs_jpeg_header(const uint8_t* data, size_t size, int* height, int* width,
                        int* orientation, char* err, int err_len) {
  try {
    Decoder d(data, size);
    d.read_header();
    *height = d.height;
    *width = d.width;
    *orientation = d.orientation;
    return 0;
  } catch (const DecodeError& e) {
    return report(e, err, err_len);
  } catch (const std::bad_alloc&) {
    return report(DecodeError{1, "out of memory"}, err, err_len);
  }
}

int metrabs_jpeg_decode(const uint8_t* data, size_t size, uint8_t* out, size_t out_size,
                        int channels, char* err, int err_len) {
  try {
    Decoder(data, size).decode(out, out_size, channels);
    return 0;
  } catch (const DecodeError& e) {
    return report(e, err, err_len);
  } catch (const std::bad_alloc&) {
    return report(DecodeError{1, "out of memory"}, err, err_len);
  }
}

int metrabs_jpeg_decode_tiff(const uint8_t* data, size_t size, uint8_t* out, size_t out_size,
                             int ycbcr, char* err, int err_len) {
  try {
    Decoder(data, size).decode_tiff(out, out_size, ycbcr != 0);
    return 0;
  } catch (const DecodeError& e) {
    return report(e, err, err_len);
  } catch (const std::bad_alloc&) {
    return report(DecodeError{1, "out of memory"}, err, err_len);
  }
}

}  // extern "C"
