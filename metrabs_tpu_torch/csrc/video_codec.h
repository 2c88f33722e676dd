// What the host video decoders (`h264_decode.cpp`, `hevc_decode.cpp`)
// share: their error codes, the reader of an RBSP's bits, the CABAC
// arithmetic decoding engine (H.264 9.3.3.2 and H.265 9.3.4.3 are the same
// engine over different contexts), and the copy of a decoded picture's
// cropped planes and RGB into the caller's buffers (`yuv_rgb.h`).
//
// Each decoder includes it once; its definitions live in an unnamed
// namespace, as the decoder's own do.

#pragma once

#include <cstdarg>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include "yuv_rgb.h"

namespace {

// A C interface call returns one of these.
enum { kOk = 0, kCorrupt = 1, kUnsupported = 2, kNoFrame = 3 };

struct Failure {
  int code;
  std::string message;
};

[[noreturn]] inline void corrupt(const char* fmt, ...) {
  char buf[200];
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(buf, sizeof buf, fmt, ap);
  va_end(ap);
  throw Failure{kCorrupt, buf};
}

// A tool the decoder does not decode, named in the error text.
[[noreturn]] inline void unsupported(const char* fmt, ...) {
  char buf[200];
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(buf, sizeof buf, fmt, ap);
  va_end(ap);
  throw Failure{kUnsupported, buf};
}

inline int fail(const Failure& f, char* err, int err_len) {
  if (err && err_len > 0) snprintf(err, (size_t)err_len, "%s", f.message.c_str());
  return f.code;
}

inline int clip3(int lo, int hi, int v) { return v < lo ? lo : v > hi ? hi : v; }
inline uint8_t clip1(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

// ---------------------------------------------------------------------------
// Bits of an RBSP (emulation prevention bytes removed).

struct Bits {
  const uint8_t* d = nullptr;
  size_t size = 0;  // bytes
  size_t pos = 0;   // bits

  Bits() = default;
  Bits(const uint8_t* data, size_t n) : d(data), size(n) {}

  uint32_t peek32() const {
    size_t byte = pos >> 3;
    uint64_t v = 0;
    for (int i = 0; i < 5; i++) v = (v << 8) | (byte + i < size ? d[byte + i] : 0);
    return (uint32_t)(v >> (8 - (pos & 7)));
  }
  uint32_t u(int n) {
    if (n == 0) return 0;
    if (pos + n > size * 8) corrupt("the bitstream ends inside a syntax element");
    uint32_t v = peek32() >> (32 - n);
    pos += n;
    return v;
  }
  int u1() {
    if (pos >= size * 8) corrupt("the bitstream ends inside a syntax element");
    int v = (d[pos >> 3] >> (7 - (pos & 7))) & 1;
    pos++;
    return v;
  }
  uint32_t ue() {
    int zeros = 0;
    while (!u1()) {
      if (++zeros > 31) corrupt("an Exp-Golomb code longer than 32 bits");
    }
    if (zeros == 0) return 0;
    return (uint32_t)(((uint64_t)1 << zeros) - 1 + u(zeros));
  }
  int se() {
    uint32_t k = ue();
    return (k & 1) ? (int)((k + 1) >> 1) : -(int)(k >> 1);
  }
  bool byte_aligned() const { return (pos & 7) == 0; }
  // True while syntax precedes the rbsp_stop_one_bit.
  // ue() no larger than `max`, else the stream is corrupt.
  int ue_max(uint32_t max, const char* what) {
    uint32_t v = ue();
    if (v > max) corrupt("%s of %u (at most %u)", what, v, max);
    return (int)v;
  }
  bool more_rbsp_data() const {
    size_t n = size;
    while (n > 0 && d[n - 1] == 0) n--;
    if (n == 0) return false;
    int last = 0;  // bit position of the stop bit
    uint8_t b = d[n - 1];
    while (!((b >> last) & 1)) last++;
    size_t stop = (n - 1) * 8 + (7 - last);
    return pos < stop;
  }
};

// The RBSP of a NAL unit's payload: emulation_prevention_three_byte removed.
inline void unescape(const uint8_t* p, size_t n, std::vector<uint8_t>& out) {
  out.clear();
  out.reserve(n);
  int zeros = 0;
  for (size_t i = 0; i < n; i++) {
    uint8_t b = p[i];
    if (zeros >= 2 && b == 3) {
      zeros = 0;
      continue;
    }
    out.push_back(b);
    zeros = b == 0 ? zeros + 1 : 0;
  }
}

// ---------------------------------------------------------------------------
// The CABAC arithmetic decoding engine over a slice's data, with N context
// variables; each decoder initialises them from its own tables.

// rangeTabLPS (Table 9-44) by [pStateIdx][qCodIRangeIdx], and transIdxLPS.
const uint8_t kRangeLps[64][4] = {
    {128, 176, 208, 240}, {128, 167, 197, 227}, {128, 158, 187, 216}, {123, 150, 178, 205},
    {116, 142, 169, 195}, {111, 135, 160, 185}, {105, 128, 152, 175}, {100, 122, 144, 166},
    {95, 116, 137, 158},  {90, 110, 130, 150},  {85, 104, 123, 142},  {81, 99, 117, 135},
    {77, 94, 111, 128},   {73, 89, 105, 122},   {69, 85, 100, 116},   {66, 80, 95, 110},
    {62, 76, 90, 104},    {59, 72, 86, 99},     {56, 69, 81, 94},     {53, 65, 77, 89},
    {51, 62, 73, 85},     {48, 59, 69, 80},     {46, 56, 66, 76},     {43, 53, 63, 72},
    {41, 50, 59, 69},     {39, 48, 56, 65},     {37, 45, 54, 62},     {35, 43, 51, 59},
    {33, 41, 48, 56},     {32, 39, 46, 53},     {30, 37, 43, 50},     {29, 35, 41, 48},
    {27, 33, 39, 45},     {26, 31, 37, 43},     {24, 30, 35, 41},     {23, 28, 33, 39},
    {22, 27, 32, 37},     {21, 26, 30, 35},     {20, 24, 29, 33},     {19, 23, 27, 31},
    {18, 22, 26, 30},     {17, 21, 25, 28},     {16, 20, 23, 27},     {15, 19, 22, 25},
    {14, 18, 21, 24},     {14, 17, 20, 23},     {13, 16, 19, 22},     {12, 15, 18, 21},
    {12, 14, 17, 20},     {11, 14, 16, 19},     {11, 13, 15, 18},     {10, 12, 15, 17},
    {10, 12, 14, 16},     {9, 11, 13, 15},      {9, 11, 12, 14},      {8, 10, 12, 14},
    {8, 9, 11, 13},       {7, 9, 11, 12},       {7, 9, 10, 12},       {7, 8, 10, 11},
    {6, 8, 9, 11},        {6, 7, 9, 10},        {6, 7, 8, 9},         {2, 2, 2, 2}};
const uint8_t kTransLps[64] = {0,  0,  1,  2,  2,  4,  4,  5,  6,  7,  8,  9,  9,  11, 11, 12,
                               13, 13, 15, 15, 16, 16, 18, 18, 19, 19, 21, 21, 22, 22, 23, 24,
                               24, 25, 26, 26, 27, 27, 28, 29, 29, 30, 30, 30, 31, 32, 32, 33,
                               33, 33, 34, 34, 35, 35, 35, 36, 36, 36, 37, 37, 37, 38, 38, 63};

template <int N>
struct CabacEngine {
  uint8_t state[N];  // (pStateIdx << 1) | valMPS
  Bits* br = nullptr;
  uint32_t range = 0, offset = 0;

  // Initialises a context from the standard's (m, n) pair at SliceQPY.
  static uint8_t context(int m, int n, int qp) {
    int pre = clip3(1, 126, ((m * clip3(0, 51, qp)) >> 4) + n);
    return pre <= 63 ? (uint8_t)((63 - pre) << 1) : (uint8_t)(((pre - 64) << 1) | 1);
  }
  void init_engine(Bits* b) {
    br = b;
    range = 510;
    offset = br->u(9);
    if (offset >= 510) corrupt("a CABAC offset of %u", offset);
  }
  int bit() {
    if (br->pos >= br->size * 8) {  // past the data: zeros, as a decoder reads padding
      br->pos++;
      return 0;
    }
    return br->u1();
  }
  int decision(int ctx) {
    uint8_t& s = state[ctx];
    int p = s >> 1, mps = s & 1;
    uint32_t lps = kRangeLps[p][(range >> 6) & 3];
    range -= lps;
    int bin;
    if (offset >= range) {
      bin = !mps;
      offset -= range;
      range = lps;
      if (p == 0) mps = !mps;
      s = (uint8_t)((kTransLps[p] << 1) | mps);
    } else {
      bin = mps;
      s = (uint8_t)((std::min(p + 1, 62) << 1) | mps);
    }
    while (range < 256) {
      range <<= 1;
      offset = (offset << 1) | (uint32_t)bit();
    }
    return bin;
  }
  int bypass() {
    offset = (offset << 1) | (uint32_t)bit();
    if (offset >= range) {
      offset -= range;
      return 1;
    }
    return 0;
  }
  int terminate() {
    range -= 2;
    if (offset >= range) return 1;
    while (range < 256) {
      range <<= 1;
      offset = (offset << 1) | (uint32_t)bit();
    }
    return 0;
  }
  uint32_t bypass_bits(int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; i++) v = (v << 1) | (uint32_t)bypass();
    return v;
  }
};

// ---------------------------------------------------------------------------
// Handing out a decoded picture: RGB [h][w][3] and the planes (y [h][w], u
// and v [(h+1)/2][(w+1)/2]) of its conformance window, each skipped when
// null; samples of `depth` bits, one byte each at 8 and two above. Its
// planes' bytes are p->y, p->u and p->v. kUnsupported when RGB is asked of
// a size or colour matrix whose conversion is not ported.

template <class P, class Picture>
void copy_out(const Picture* p, uint8_t* rgb, P* y, P* u, P* v, int depth) {
  const int w = p->out_w, h = p->out_h, cw = (w + 1) / 2, ch = (h + 1) / 2, cs = p->w / 2;
  const int cl = p->crop_left, ct = p->crop_top;
  const P* py = reinterpret_cast<const P*>(p->y.data()) + (size_t)ct * p->w + cl;
  const P* pu = reinterpret_cast<const P*>(p->u.data()) + (size_t)(ct / 2) * cs + cl / 2;
  const P* pv = reinterpret_cast<const P*>(p->v.data()) + (size_t)(ct / 2) * cs + cl / 2;
  if (y)
    for (int r = 0; r < h; r++) memcpy(y + (size_t)r * w, py + (size_t)r * p->w, w * sizeof(P));
  if (u)
    for (int r = 0; r < ch; r++) memcpy(u + (size_t)r * cw, pu + (size_t)r * cs, cw * sizeof(P));
  if (v)
    for (int r = 0; r < ch; r++) memcpy(v + (size_t)r * cw, pv + (size_t)r * cs, cw * sizeof(P));
  if (rgb) yuv_rgb::to_rgb(py, p->w, pu, pv, cs, w, h, p->full_range, p->matrix, depth, rgb);
}

template <class Picture>
int hand_out(const Picture* p, uint8_t* rgb, void* y, void* u, void* v, char* err, int err_len,
             int depth = 8) {
  if (rgb && !yuv_rgb::supported(p->out_h, depth)) {
    if (depth == 8) return fail(Failure{kUnsupported, "RGB frames of an odd height below 9 rows"}, err, err_len);
    char what[96];
    snprintf(what, sizeof what, "RGB frames of %d-bit video below 10 rows", depth);
    return fail(Failure{kUnsupported, what}, err, err_len);
  }
  if (rgb && (p->matrix == 0 || p->matrix == 8 || p->matrix > 10)) {
    char what[96];
    snprintf(what, sizeof what, "RGB of matrix_coefficients %d (GBR, YCgCo and above 10)", p->matrix);
    return fail(Failure{kUnsupported, what}, err, err_len);
  }
  if (!(rgb || y || u || v)) return kOk;
  if (p->y.empty()) return fail(Failure{kUnsupported, "samples of a header-only decoder"}, err, err_len);
  if (depth > 8)
    copy_out(p, rgb, (uint16_t*)y, (uint16_t*)u, (uint16_t*)v, depth);
  else
    copy_out(p, rgb, (uint8_t*)y, (uint8_t*)u, (uint8_t*)v, depth);
  return kOk;
}

}  // namespace
