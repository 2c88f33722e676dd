// Host JPEG encoder with the bytes of libjpeg-turbo 3.1's default compression,
// which is what cv2.imencode('.jpg', image) writes at OpenCV's defaults:
// baseline Huffman coding with the standard tables (no optimisation), the
// quality-scaled standard quantisation tables (jcparam.c, forced baseline),
// 4:2:0 sampling for colour (h2v2_downsample's alternating 1/2 bias), the
// fixed-point RGB->YCbCr tables (jccolor.c), the ISLOW integer FDCT
// (jfdctint.c), the reciprocal quantiser of jcdctmgr.c with 16-bit DCT
// elements (libjpeg-turbo's SIMD build), edge pixels replicated and dummy
// blocks as jccoefct.c makes them, no restart interval, and the JFIF APP0
// header. Integer arithmetic throughout, so the output equals cv2's byte for
// byte.
//
// Plain C interface for ctypes:
//   metrabs_jpeg_encode(pixels, height, width, channels, quality, &size, err, n)
// takes height x width x channels uint8 pixels, row-major, RGB for 3
// channels and gray for 1, and returns a buffer of `size` bytes allocated
// with malloc (free it with metrabs_jpeg_free), or null with the reason
// written to err.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct EncodeError {
  std::string message;
};

// Zigzag position -> natural (row-major) position.
const int kNaturalOrder[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33, 40, 48,
    41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23,
    30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// The JPEG standard's example quantisation tables (Annex K.1), natural order.
const uint16_t kLumaQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint16_t kChromaQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// The standard's Huffman tables (Annex K.3): code counts per length 1-16
// (index 0 unused), then the symbols.
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

struct HuffSpec {
  const uint8_t* bits;
  const uint8_t* vals;
  int count;
};
const HuffSpec kDcSpecs[2] = {{kDcLumaBits, kDcLumaVals, 12}, {kDcChromaBits, kDcChromaVals, 12}};
const HuffSpec kAcSpecs[2] = {{kAcLumaBits, kAcLumaVals, 162},
                              {kAcChromaBits, kAcChromaVals, 162}};

// jchuff.c jpeg_make_c_derived_tbl: canonical codes by symbol.
struct HuffCodes {
  unsigned code[256];
  int size[256];
};

HuffCodes derive_codes(const HuffSpec& spec) {
  HuffCodes t;
  std::memset(t.size, 0, sizeof(t.size));
  std::memset(t.code, 0, sizeof(t.code));
  unsigned code = 0;
  int k = 0;
  for (int len = 1; len <= 16; len++) {
    for (int i = 0; i < spec.bits[len]; i++, k++) {
      t.code[spec.vals[k]] = code++;
      t.size[spec.vals[k]] = len;
    }
    code <<= 1;
  }
  return t;
}

// jcparam.c jpeg_quality_scaling and jpeg_add_quant_table with force_baseline.
void scaled_table(const uint16_t* basic, int quality, uint16_t* out) {
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  const long scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; i++) {
    long q = (basic[i] * scale + 50L) / 100L;
    if (q <= 0) q = 1;
    if (q > 255) q = 255;
    out[i] = static_cast<uint16_t>(q);
  }
}

// jcdctmgr.c compute_reciprocal for 16-bit DCT elements: the quantiser
// divides by multiplying with a rounded reciprocal, not by dividing.
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

int floor_log2(unsigned v) {
  int b = -1;
  while (v) {
    v >>= 1;
    b++;
  }
  return b;
}

Divisor reciprocal(unsigned divisor) {
  int r = 16 + floor_log2(divisor);
  uint32_t fq = (uint32_t{1} << r) / divisor;
  const uint32_t fr = (uint32_t{1} << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {  // a power of two: fq would not fit in 16 bits
    fq >>= 1;
    r--;
  } else if (fr <= divisor / 2U) {
    c++;
  } else {
    fq++;
  }
  return Divisor{fq, c, r};
}

// jfdctint.c jpeg_fdct_islow: output scaled up by 8.
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;

inline int32_t descale(int32_t x, int n) { return (x + (int32_t{1} << (n - 1))) >> n; }

void fdct_islow(int32_t* data) {
  for (int pass = 0; pass < 2; pass++) {
    const int step = pass == 0 ? 1 : 8;    // element step within a row (pass 1) or column
    const int advance = pass == 0 ? 8 : 1;  // to the next row or column
    const int even_shift = pass == 0 ? 0 : kPass1Bits;
    const int odd_shift = pass == 0 ? kConstBits - kPass1Bits : kConstBits + kPass1Bits;
    int32_t* d = data;
    for (int ctr = 0; ctr < 8; ctr++, d += advance) {
      const int32_t tmp0 = d[0] + d[7 * step], tmp7 = d[0] - d[7 * step];
      const int32_t tmp1 = d[step] + d[6 * step], tmp6 = d[step] - d[6 * step];
      const int32_t tmp2 = d[2 * step] + d[5 * step], tmp5 = d[2 * step] - d[5 * step];
      const int32_t tmp3 = d[3 * step] + d[4 * step], tmp4 = d[3 * step] - d[4 * step];
      const int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      const int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      if (pass == 0) {
        d[0] = (tmp10 + tmp11) * (1 << kPass1Bits);
        d[4 * step] = (tmp10 - tmp11) * (1 << kPass1Bits);
      } else {
        d[0] = descale(tmp10 + tmp11, even_shift);
        d[4 * step] = descale(tmp10 - tmp11, even_shift);
      }
      int32_t z1 = (tmp12 + tmp13) * 4433;
      d[2 * step] = descale(z1 + tmp13 * 6270, odd_shift);
      d[6 * step] = descale(z1 + tmp12 * -15137, odd_shift);

      z1 = tmp4 + tmp7;
      int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      const int32_t z5 = (z3 + z4) * 9633;
      const int32_t t4 = tmp4 * 2446, t5 = tmp5 * 16819, t6 = tmp6 * 25172, t7 = tmp7 * 12299;
      z1 *= -7373;
      z2 *= -20995;
      z3 = z3 * -16069 + z5;
      z4 = z4 * -3196 + z5;
      d[7 * step] = descale(t4 + z1 + z3, odd_shift);
      d[5 * step] = descale(t5 + z2 + z4, odd_shift);
      d[3 * step] = descale(t6 + z2 + z3, odd_shift);
      d[step] = descale(t7 + z1 + z4, odd_shift);
    }
  }
}

class BitWriter {
 public:
  explicit BitWriter(std::vector<uint8_t>& out) : out_(out) {}

  void put(unsigned code, int size) {
    acc_ = (acc_ << size) | (code & ((1u << size) - 1));
    bits_ += size;
    while (bits_ >= 8) {
      const uint8_t byte = static_cast<uint8_t>(acc_ >> (bits_ - 8));
      out_.push_back(byte);
      if (byte == 0xFF) out_.push_back(0);  // byte stuffing
      bits_ -= 8;
    }
    acc_ &= (uint64_t{1} << bits_) - 1;
  }

  // jchuff.c flush_bits: pad the last byte with 1 bits.
  void flush() {
    put(0x7F, 7);
    acc_ = 0;
    bits_ = 0;
  }

 private:
  std::vector<uint8_t>& out_;
  uint64_t acc_ = 0;
  int bits_ = 0;
};

struct Component {
  int id, h, v, table;  // sampling factors; quant and Huffman table number
  int width_in_blocks, height_in_blocks;
  std::vector<uint8_t> plane;  // width_in_blocks * 8 columns, edges replicated
  int stride, rows;
  int last_dc = 0;
};

class Encoder {
 public:
  Encoder(const uint8_t* pixels, int height, int width, int channels, int quality)
      : pixels_(pixels), height_(height), width_(width), channels_(channels) {
    if (height < 1 || width < 1 || height > 65535 || width > 65535)
      throw EncodeError{"image size must be 1-65535 on each side"};
    if (channels != 1 && channels != 3) throw EncodeError{"1 (gray) or 3 (RGB) channels"};
    scaled_table(kLumaQuant, quality, quant_[0]);
    scaled_table(kChromaQuant, quality, quant_[1]);
    for (int t = 0; t < 2; t++)
      for (int i = 0; i < 64; i++) divisors_[t][i] = reciprocal(quant_[t][i] << 3);
    for (int t = 0; t < 2; t++) {
      dc_codes_[t] = derive_codes(kDcSpecs[t]);
      ac_codes_[t] = derive_codes(kAcSpecs[t]);
    }
  }

  std::vector<uint8_t> encode() {
    prepare_components();
    out_.reserve(static_cast<size_t>(height_) * width_ / 4 + 1024);
    write_headers();
    BitWriter bw(out_);
    if (comps_.size() == 1) {
      // One component, a non-interleaved scan: an MCU is one real block.
      Component& c = comps_[0];
      for (int by = 0; by < c.height_in_blocks; by++)
        for (int bx = 0; bx < c.width_in_blocks; bx++) {
          int16_t block[64];
          transform(c, bx, by, block);
          encode_block(bw, c, block);
        }
    } else {
      const int mcus_x = (width_ + 15) / 16, mcus_y = (height_ + 15) / 16;
      for (int my = 0; my < mcus_y; my++)
        for (int mx = 0; mx < mcus_x; mx++)
          for (Component& c : comps_) encode_mcu(bw, c, mx, my);
    }
    bw.flush();
    marker(0xD9);
    return std::move(out_);
  }

 private:
  const uint8_t* pixels_;
  int height_, width_, channels_;
  uint16_t quant_[2][64];
  Divisor divisors_[2][64];
  HuffCodes dc_codes_[2], ac_codes_[2];
  std::vector<Component> comps_;
  std::vector<uint8_t> out_;

  // Colour conversion (jccolor.c rgb_ycc_convert), downsampling (jcsample.c)
  // and edge padding (jcprepct.c): each plane holds its component's blocks,
  // the columns and rows past the image filled with the last ones.
  void prepare_components() {
    const int max_s = channels_ == 3 ? 2 : 1;
    const int n = channels_ == 3 ? 3 : 1;
    for (int ci = 0; ci < n; ci++) {
      Component c;
      c.id = ci + 1;
      c.h = c.v = ci == 0 ? max_s : 1;
      c.table = ci == 0 ? 0 : 1;
      c.width_in_blocks = (width_ * c.h + max_s * 8 - 1) / (max_s * 8);
      c.height_in_blocks = (height_ * c.v + max_s * 8 - 1) / (max_s * 8);
      c.stride = c.width_in_blocks * 8;
      c.rows = c.height_in_blocks * 8;
      c.plane.assign(static_cast<size_t>(c.stride) * c.rows, 0);
      comps_.push_back(std::move(c));
    }
    const int w = width_, h = height_;
    if (channels_ == 1) {
      Component& y = comps_[0];
      for (int r = 0; r < y.rows; r++) {
        const uint8_t* src = pixels_ + static_cast<size_t>(std::min(r, h - 1)) * w;
        uint8_t* dst = &y.plane[static_cast<size_t>(r) * y.stride];
        std::memcpy(dst, src, w);
        std::memset(dst + w, src[w - 1], y.stride - w);
      }
      return;
    }
    // Full-resolution Y, Cb, Cr of the image's own rows.
    std::vector<uint8_t> ycc[3];
    for (auto& p : ycc) p.resize(static_cast<size_t>(w) * h);
    const int32_t kHalf = 1 << 15, kOffset = 128 << 16;
    for (size_t i = 0, n_px = static_cast<size_t>(w) * h; i < n_px; i++) {
      const int32_t r = pixels_[3 * i], g = pixels_[3 * i + 1], b = pixels_[3 * i + 2];
      ycc[0][i] = static_cast<uint8_t>((19595 * r + 38470 * g + 7471 * b + kHalf) >> 16);
      ycc[1][i] = static_cast<uint8_t>((-11059 * r - 21709 * g + 32768 * b + kOffset + kHalf - 1) >> 16);
      ycc[2][i] = static_cast<uint8_t>((32768 * r - 27439 * g - 5329 * b + kOffset + kHalf - 1) >> 16);
    }
    Component& y = comps_[0];
    for (int r = 0; r < y.rows; r++) {
      const uint8_t* src = &ycc[0][static_cast<size_t>(std::min(r, h - 1)) * w];
      uint8_t* dst = &y.plane[static_cast<size_t>(r) * y.stride];
      std::memcpy(dst, src, w);
      std::memset(dst + w, src[w - 1], y.stride - w);
    }
    // h2v2_downsample on rows and columns replicated past the image, then the
    // downsampled rows replicated down to the plane's height.
    const int chroma_rows = (h + 1) / 2;
    for (int ci = 1; ci < 3; ci++) {
      Component& c = comps_[ci];
      for (int r = 0; r < c.rows; r++) {
        const int rr = std::min(r, chroma_rows - 1);
        const uint8_t* s0 = &ycc[ci][static_cast<size_t>(std::min(2 * rr, h - 1)) * w];
        const uint8_t* s1 = &ycc[ci][static_cast<size_t>(std::min(2 * rr + 1, h - 1)) * w];
        uint8_t* dst = &c.plane[static_cast<size_t>(r) * c.stride];
        for (int x = 0; x < c.stride; x++) {
          const int x0 = std::min(2 * x, w - 1), x1 = std::min(2 * x + 1, w - 1);
          const int bias = (x & 1) ? 2 : 1;
          dst[x] = static_cast<uint8_t>((s0[x0] + s0[x1] + s1[x0] + s1[x1] + bias) >> 2);
        }
      }
    }
  }

  // FDCT and quantisation of the block at block column bx, block row by.
  void transform(const Component& c, int bx, int by, int16_t* out) const {
    int32_t work[64];
    for (int r = 0; r < 8; r++) {
      const uint8_t* row = &c.plane[static_cast<size_t>(by * 8 + r) * c.stride + bx * 8];
      for (int x = 0; x < 8; x++) work[r * 8 + x] = static_cast<int32_t>(row[x]) - 128;
    }
    fdct_islow(work);
    // The DCT elements are 16-bit in libjpeg-turbo's SIMD build.
    for (int i = 0; i < 64; i++) {
      const Divisor& d = divisors_[c.table][i];
      int32_t v = static_cast<int16_t>(work[i]);
      const bool neg = v < 0;
      if (neg) v = -v;
      const uint32_t product = (static_cast<uint32_t>(v) + d.corr) * d.recip;
      int32_t q = static_cast<int16_t>(static_cast<uint16_t>(product >> d.shift));
      out[i] = static_cast<int16_t>(neg ? -q : q);
    }
  }

  // jccoefct.c compress_data for one component of one MCU: blocks past the
  // component's width or height are dummies, zero but for the DC, which
  // repeats the DC of the block before them.
  void encode_mcu(BitWriter& bw, Component& c, int mx, int my) {
    int16_t blocks[4][64];
    int k = 0;
    for (int yi = 0; yi < c.v; yi++) {
      const int by = my * c.v + yi;
      for (int xi = 0; xi < c.h; xi++, k++) {
        const int bx = mx * c.h + xi;
        if (by < c.height_in_blocks && bx < c.width_in_blocks) {
          transform(c, bx, by, blocks[k]);
        } else {
          std::memset(blocks[k], 0, sizeof(blocks[k]));
          const int prev = (by < c.height_in_blocks) ? k - 1 : yi * c.h - 1;
          blocks[k][0] = blocks[prev][0];
        }
      }
    }
    for (int i = 0; i < k; i++) encode_block(bw, c, blocks[i]);
  }

  // jchuff.c encode_one_block.
  void encode_block(BitWriter& bw, Component& c, const int16_t* block) {
    const HuffCodes& dc = dc_codes_[c.table];
    const HuffCodes& ac = ac_codes_[c.table];
    int temp = block[0] - c.last_dc;
    c.last_dc = block[0];
    emit_value(bw, dc, temp, 0);
    int run = 0;
    for (int k = 1; k < 64; k++) {
      temp = block[kNaturalOrder[k]];
      if (temp == 0) {
        run++;
        continue;
      }
      while (run > 15) {
        bw.put(ac.code[0xF0], ac.size[0xF0]);
        run -= 16;
      }
      emit_value(bw, ac, temp, run);
      run = 0;
    }
    if (run > 0) bw.put(ac.code[0], ac.size[0]);
  }

  static void emit_value(BitWriter& bw, const HuffCodes& codes, int value, int run) {
    int magnitude = value < 0 ? -value : value;
    const int bits = value < 0 ? value - 1 : value;
    int nbits = 0;
    while (magnitude) {
      nbits++;
      magnitude >>= 1;
    }
    const int symbol = (run << 4) + nbits;
    bw.put(codes.code[symbol], codes.size[symbol]);
    if (nbits) bw.put(static_cast<unsigned>(bits), nbits);
  }

  void marker(int code) {
    out_.push_back(0xFF);
    out_.push_back(static_cast<uint8_t>(code));
  }
  void u16(int v) {
    out_.push_back(static_cast<uint8_t>(v >> 8));
    out_.push_back(static_cast<uint8_t>(v));
  }

  // jcmarker.c: SOI, JFIF APP0, one DQT per table, SOF0, one DHT per table
  // (DC then AC, luma then chroma), SOS.
  void write_headers() {
    const int n_tables = comps_.size() == 1 ? 1 : 2;
    marker(0xD8);
    marker(0xE0);
    u16(16);
    const uint8_t jfif[] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
    out_.insert(out_.end(), jfif, jfif + sizeof(jfif));
    for (int t = 0; t < n_tables; t++) {
      marker(0xDB);
      u16(67);
      out_.push_back(static_cast<uint8_t>(t));
      for (int i = 0; i < 64; i++) out_.push_back(static_cast<uint8_t>(quant_[t][kNaturalOrder[i]]));
    }
    marker(0xC0);
    u16(8 + 3 * static_cast<int>(comps_.size()));
    out_.push_back(8);
    u16(height_);
    u16(width_);
    out_.push_back(static_cast<uint8_t>(comps_.size()));
    for (const Component& c : comps_) {
      out_.push_back(static_cast<uint8_t>(c.id));
      out_.push_back(static_cast<uint8_t>((c.h << 4) | c.v));
      out_.push_back(static_cast<uint8_t>(c.table));
    }
    for (int t = 0; t < n_tables; t++) {
      for (int is_ac = 0; is_ac < 2; is_ac++) {
        const HuffSpec& s = is_ac ? kAcSpecs[t] : kDcSpecs[t];
        marker(0xC4);
        u16(2 + 1 + 16 + s.count);
        out_.push_back(static_cast<uint8_t>((is_ac << 4) | t));
        out_.insert(out_.end(), s.bits + 1, s.bits + 17);
        out_.insert(out_.end(), s.vals, s.vals + s.count);
      }
    }
    marker(0xDA);
    u16(6 + 2 * static_cast<int>(comps_.size()));
    out_.push_back(static_cast<uint8_t>(comps_.size()));
    for (const Component& c : comps_) {
      out_.push_back(static_cast<uint8_t>(c.id));
      out_.push_back(static_cast<uint8_t>((c.table << 4) | c.table));
    }
    out_.push_back(0);
    out_.push_back(63);
    out_.push_back(0);
  }
};

}  // namespace

extern "C" {

uint8_t* metrabs_jpeg_encode(const uint8_t* pixels, int height, int width, int channels,
                             int quality, size_t* size, char* err, int err_len) {
  try {
    std::vector<uint8_t> out = Encoder(pixels, height, width, channels, quality).encode();
    uint8_t* buf = static_cast<uint8_t*>(std::malloc(out.size()));
    if (!buf) throw std::bad_alloc();
    std::memcpy(buf, out.data(), out.size());
    *size = out.size();
    return buf;
  } catch (const EncodeError& e) {
    std::snprintf(err, err_len, "%s", e.message.c_str());
  } catch (const std::bad_alloc&) {
    std::snprintf(err, err_len, "out of memory");
  }
  return nullptr;
}

void metrabs_jpeg_free(uint8_t* buf) { std::free(buf); }

}  // extern "C"
