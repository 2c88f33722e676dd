// HEVC / H.265 video (ITU-T H.265) on the host: a decoder for progressive
// 4:2:0 Main and Main 10 streams (8 bits, or 9 and 10 with luma and chroma
// of one depth) of I, P and B slices whose planes equal FFmpeg's
// (libavcodec's hevc decoder) bit for bit, as the standard's decoding
// process is exact.
//
// One source serves both depths: the sample-processing stages (residual,
// intra and inter prediction, deblocking, SAO) are templates on the sample
// type, uint8_t at 8 bits (where the bit depth is a constant, so that this
// code stays as it was) and uint16_t above, chosen per picture. What the
// bit depth changes: QpBdOffset (6 per bit above 8) in the QP derivation
// and dequantisation, the transform's second shift (20 - depth),
// intra substitution and strong smoothing's threshold, the interpolation's
// shifts (14 - depth, depth - 8) and the weighted prediction's shifts and
// offsets, deblocking's beta and tC, SAO's band shift and offset range,
// the clipping, and the hash SEI (two bytes per sample).
//
// Tools: the coding quadtree from 8x8 to 64x64 CTBs; CABAC with its three
// context initialisation types (cabac_init_flag) and wavefront parallel
// processing (entropy_coding_sync: context storage after the second CTB of
// the row above, a substream per CTB row); several slices per picture;
// intra prediction (35 modes, reference substitution with
// constrained_intra_pred, the [1 2 1] filter and strong intra smoothing,
// the DC and angular boundary filters, MPM derivation, chroma mode 4);
// residual coding with the diagonal, horizontal and vertical scans, sign
// data hiding, transform skip and transquant bypass (lossless CUs);
// dequantisation with flat, default and SPS/PPS scaling lists, cu_qp_delta
// and the chroma QP offsets; the 4x4 DST and the DCT from 4x4 to 32x32; the
// inter partitions (AMP included) with uni- and bi-prediction (inter_pred_idc),
// merge (spatial, temporal from the collocated picture of either list,
// combined bi-predictive, zero; 8x4 and 4x8 blocks from list 0) and AMVP
// candidates of both lists, 8-tap luma and 4-tap chroma interpolation, the
// default average and explicit weighted prediction of P and B slices; the
// short-term reference picture sets (inter RPS prediction included),
// RefPicList0 and RefPicList1 with list modification; deblocking with slice and PPS offsets and SAO (band and
// edge offsets, merge left/up); the conformance window; the VUI's matrix
// and range; the decoded-picture hash SEI (MD5, CRC and checksum), checked
// on every picture that carries one.
//
// Refused, naming the tool ("unsupported"): bit depths above 10, unequal
// luma and chroma depths, chroma formats other than 4:2:0, separate colour
// planes, field coding (field_seq_flag), tiles, dependent slice segments, PCM coding units,
// long-term reference pictures, mvd_l1_zero_flag (which x265 never sets),
// and the range, multilayer, 3D and screen content extension flags. NAL
// units of layers above 0 are skipped, as FFmpeg skips them; so are the
// RASL pictures of a CRA picture that starts the stream or follows an end of
// sequence (FFmpeg's max_ra). NAL units of the unspecified types 48 to 63
// (a Dolby Vision stream's RPU, 62) are skipped.
//
// Pictures are output as FFmpeg's decoder outputs them (its output FIFO):
// by picture order count once more pictures wait than
// sps_max_num_reorder_pics (or the DPB holds more than
// sps_max_dec_pic_buffering) of the highest temporal layer allows, all of
// them at an IRAP picture with NoRaslOutputFlag, and the rest at a flush.
// The colour conversion to RGB follows the VUI (matrix_coeffs and
// video_full_range_flag) as swscale does for cv2 (`yuv_rgb.h`).
//
// C interface for ctypes; a call returns 0, 1 (corrupt stream), 2
// (unsupported tool, named in the error text) or 3 (no picture waiting).

#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdarg>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <string>
#include <utility>
#include <vector>

#include "video_codec.h"
#include "yuv_rgb.h"

namespace {

inline int sign(int v) { return (v > 0) - (v < 0); }
inline int ceil_log2(int v) {
  int n = 0;
  while ((1 << n) < v) n++;
  return n;
}

// NAL unit types (Table 7-1)
enum {
  TRAIL_N = 0, TRAIL_R = 1, RASL_N = 8, RASL_R = 9, BLA_W_LP = 16, BLA_W_RADL = 17, BLA_N_LP = 18,
  IDR_W_RADL = 19, IDR_N_LP = 20, CRA_NUT = 21, VPS_NUT = 32, SPS_NUT = 33, PPS_NUT = 34,
  AUD_NUT = 35, EOS_NUT = 36, EOB_NUT = 37, FD_NUT = 38, SEI_PREFIX = 39, SEI_SUFFIX = 40
};
inline bool is_irap(int t) { return t >= 16 && t <= 23; }
inline bool is_idr(int t) { return t == IDR_W_RADL || t == IDR_N_LP; }
inline bool is_bla(int t) { return t >= BLA_W_LP && t <= BLA_N_LP; }

enum { SLICE_B = 0, SLICE_P = 1, SLICE_I = 2 };

// The NAL units of a packet: length-prefixed (length_size bytes) or, with
// length_size 0, Annex B (start codes).
std::vector<std::pair<const uint8_t*, size_t>> split_nals(const uint8_t* data, size_t n,
                                                         int length_size) {
  std::vector<std::pair<const uint8_t*, size_t>> nals;
  if (length_size > 0) {
    size_t pos = 0;
    while (pos + length_size <= n) {
      size_t len = 0;
      for (int i = 0; i < length_size; i++) len = (len << 8) | data[pos + i];
      pos += length_size;
      if (len > n - pos) corrupt("a NAL unit of %zu bytes runs past its packet", len);
      if (len) nals.push_back({data + pos, len});
      pos += len;
    }
    return nals;
  }
  size_t i = 0, start = SIZE_MAX;
  while (i + 3 <= n) {
    if (data[i] == 0 && data[i + 1] == 0 && data[i + 2] == 1) {
      if (start != SIZE_MAX) {
        size_t end = i;
        while (end > start && data[end - 1] == 0) end--;  // trailing_zero_8bits
        if (end > start) nals.push_back({data + start, end - start});
      }
      i += 3;
      start = i;
    } else {
      i++;
    }
  }
  if (start != SIZE_MAX && start < n) {
    size_t end = n;
    while (end > start && data[end - 1] == 0) end--;
    if (end > start) nals.push_back({data + start, end - start});
  }
  return nals;
}

// ---------------------------------------------------------------------------
// Tables

// Context variables, each syntax element's first (Tables 9-5 to 9-37).
enum Ctx {
  kSAO_MERGE = 0, kSAO_TYPE = 1, kSPLIT_CU = 2, kTQ_BYPASS = 5, kSKIP = 6, kPRED_MODE = 9,
  kPART_MODE = 10, kPREV_INTRA = 14, kCHROMA_MODE = 15, kRQT_ROOT_CBF = 16, kMERGE_FLAG = 17,
  kMERGE_IDX = 18, kINTER_PRED = 19, kREF_IDX = 24, kMVP = 26, kSPLIT_TF = 27, kCBF_LUMA = 30,
  kCBF_CHROMA = 32, kMVD_G0 = 36, kMVD_G1 = 37, kQP_DELTA = 38, kTSKIP = 40, kLAST_X = 42,
  kLAST_Y = 60, kCSBF = 78, kSIG = 82, kGT1 = 124, kGT2 = 148, kNumCtx = 154
};

// initValue of each context by initType (0: I; 1 and 2: P and B, swapped
// by cabac_init_flag).
const uint8_t kInitValue[3][kNumCtx] = {
    {153, 200, 139, 141, 157, 154, 154, 154, 154, 154, 184, 154, 154, 154, 184, 63, 154, 154, 154, 154,
     154, 154, 154, 154, 154, 154, 154, 153, 138, 138, 111, 141, 94, 138, 182, 154, 154, 154, 154, 154,
     139, 139, 110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127, 111, 79, 108, 123, 63,
     110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127, 111, 79, 108, 123, 63, 91, 171,
     134, 141, 111, 111, 125, 110, 110, 94, 124, 108, 124, 107, 125, 141, 179, 153, 125, 107, 125, 141,
     179, 153, 125, 107, 125, 141, 179, 153, 125, 140, 139, 182, 182, 152, 136, 152, 136, 153, 136, 139,
     111, 136, 139, 111, 140, 92, 137, 138, 140, 152, 138, 139, 153, 74, 149, 92, 139, 107, 122, 152,
     140, 179, 166, 182, 140, 227, 122, 197, 138, 153, 136, 167, 152, 152},
    {153, 185, 107, 139, 126, 154, 197, 185, 201, 149, 154, 139, 154, 154, 154, 152, 79, 110, 122, 95,
     79, 63, 31, 31, 153, 153, 168, 124, 138, 94, 153, 111, 149, 107, 167, 154, 140, 198, 154, 154,
     139, 139, 125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111, 111, 95, 94, 108, 123, 108,
     125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111, 111, 95, 94, 108, 123, 108, 121, 140,
     61, 154, 155, 154, 139, 153, 139, 123, 123, 63, 153, 166, 183, 140, 136, 153, 154, 166, 183, 140,
     136, 153, 154, 166, 183, 140, 136, 153, 154, 170, 153, 123, 123, 107, 121, 107, 121, 167, 151, 183,
     140, 151, 183, 140, 154, 196, 196, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153, 121, 136, 137,
     169, 194, 166, 167, 154, 167, 137, 182, 107, 167, 91, 122, 107, 167},
    {153, 160, 107, 139, 126, 154, 197, 185, 201, 134, 154, 139, 154, 154, 183, 152, 79, 154, 137, 95,
     79, 63, 31, 31, 153, 153, 168, 224, 167, 122, 153, 111, 149, 92, 167, 154, 169, 198, 154, 154,
     139, 139, 125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126, 111, 111, 79, 108, 123, 93,
     125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126, 111, 111, 79, 108, 123, 93, 121, 140,
     61, 154, 170, 154, 139, 153, 139, 123, 123, 63, 124, 166, 183, 140, 136, 153, 154, 166, 183, 140,
     136, 153, 154, 166, 183, 140, 136, 153, 154, 170, 153, 138, 138, 122, 121, 122, 121, 167, 151, 183,
     140, 151, 183, 140, 154, 196, 167, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153, 121, 136, 122,
     169, 208, 166, 167, 154, 152, 167, 182, 107, 167, 91, 107, 107, 167},
};

// intraPredAngle by mode (Table 8-4) and invAngle for modes 11 to 25 (Table 8-5).
const int kIntraAngle[35] = {0,   0,   32,  26,  21,  17,  13,  9,  5,  2,  0,  -2, -5, -9, -13, -17, -21, -26,
                             -32, -26, -21, -17, -13, -9,  -5, -2, 0,  2,  5,  9,  13, 17,  21,  26,  32};
int inv_angle(int mode) {
  static const int kInv[15] = {-4096, -1638, -910, -630, -482, -390, -315, -256,
                               -315,  -390,  -482, -630, -910, -1638, -4096};
  return kInv[mode - 11];
}

// Luma (8-tap, quarter-sample) and chroma (4-tap, eighth-sample) filters.
const int kLumaFilter[4][8] = {{0, 0, 0, 64, 0, 0, 0, 0},
                               {-1, 4, -10, 58, 17, -5, 1, 0},
                               {-1, 4, -11, 40, 40, -11, 4, -1},
                               {0, 1, -5, 17, 58, -10, 4, -1}};
const int kChromaFilter[8][4] = {{0, 64, 0, 0},     {-2, 58, 10, -2}, {-4, 54, 16, -2},
                                 {-6, 46, 28, -4},  {-4, 36, 36, -4}, {-4, 28, 46, -6},
                                 {-2, 16, 54, -4},  {-2, 10, 58, -2}};

// Deblocking: beta' by Q (Table 8-12, 0..51) and tc' by Q (0..53).
const uint8_t kBeta[52] = {0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  6,  7,
                           8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24, 26, 28, 30, 32,
                           34, 36, 38, 40, 42, 44, 46, 48, 50, 52, 54, 56, 58, 60, 62, 64};
const uint8_t kTc[54] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                         2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 22, 24};

// QpC by qPi for 4:2:0 (Table 8-10).
int chroma_qp(int qpi) {
  static const int kQpc[14] = {29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37};
  if (qpi < 30) return qpi;
  if (qpi > 43) return qpi - 6;
  return kQpc[qpi - 30];
}

const int kLevelScale[6] = {40, 45, 51, 57, 64, 72};

// Default 8x8 scaling lists (Table 7-6), in up-right diagonal order.
const uint8_t kDefaultIntra8[64] = {16, 16, 16, 16, 16, 16, 16, 16, 16, 16, 17, 16, 17, 16, 17, 18,
                                    17, 18, 18, 17, 18, 21, 19, 20, 21, 20, 19, 21, 24, 22, 22, 24,
                                    24, 22, 22, 24, 25, 25, 27, 30, 27, 25, 25, 29, 31, 35, 35, 31,
                                    29, 36, 41, 44, 41, 36, 47, 54, 54, 47, 65, 70, 65, 88, 88, 115};
const uint8_t kDefaultInter8[64] = {16, 16, 16, 16, 16, 16, 16, 16, 16, 16, 17, 17, 17, 17, 17, 18,
                                    18, 18, 18, 18, 18, 20, 20, 20, 20, 20, 20, 20, 24, 24, 24, 24,
                                    24, 24, 24, 24, 25, 25, 25, 25, 25, 25, 25, 28, 28, 28, 28, 28,
                                    28, 33, 33, 33, 33, 33, 41, 41, 41, 41, 54, 54, 54, 71, 71, 91};

// Scan orders (6.5.3-6.5.5): [log2 size 0..3 (1x1 to 8x8)][scanIdx][pos] =
// (x, y), for sub-block positions and positions inside a 4x4 sub-block.
struct ScanTables {
  uint8_t pos[4][3][64][2];
  // transMatrix of the 32-point DCT; the smaller ones are its rows
  // 0, 2, 4, ... (every 32/n-th).
  int dct[32][32];
  ScanTables() {
    for (int l = 0; l < 4; l++) {
      const int n = 1 << l;
      int i = 0, x = 0, y = 0;
      bool stop = false;
      while (!stop) {  // up-right diagonal
        while (y >= 0) {
          if (x < n && y < n) {
            pos[l][0][i][0] = (uint8_t)x;
            pos[l][0][i][1] = (uint8_t)y;
            i++;
          }
          y--;
          x++;
        }
        y = x;
        x = 0;
        if (i >= n * n) stop = true;
      }
      i = 0;
      for (y = 0; y < n; y++)
        for (x = 0; x < n; x++, i++) {  // horizontal
          pos[l][1][i][0] = (uint8_t)x;
          pos[l][1][i][1] = (uint8_t)y;
        }
      i = 0;
      for (x = 0; x < n; x++)
        for (y = 0; y < n; y++, i++) {  // vertical
          pos[l][2][i][0] = (uint8_t)x;
          pos[l][2][i][1] = (uint8_t)y;
        }
    }
    // c[m] = the coefficient of cos(m * pi / 64) (m = 1..32), from the
    // first column of rows 1, 2, 4, 8 and 16 of the 32-point matrix.
    int c[33] = {0};
    const int odd[16] = {90, 90, 88, 85, 82, 78, 73, 67, 61, 54, 46, 38, 31, 22, 13, 4};
    const int r2[8] = {90, 87, 80, 70, 57, 43, 25, 9};
    const int r4[4] = {89, 75, 50, 18};
    for (int k = 0; k < 16; k++) c[2 * k + 1] = odd[k];
    for (int k = 0; k < 8; k++) c[4 * k + 2] = r2[k];
    for (int k = 0; k < 4; k++) c[8 * k + 4] = r4[k];
    c[8] = 83;
    c[24] = 36;
    c[16] = 64;
    c[32] = 0;
    for (int k = 0; k < 32; k++)
      for (int n = 0; n < 32; n++) {
        if (k == 0) {
          dct[k][n] = 64;
          continue;
        }
        int m = ((2 * n + 1) * k) % 128;  // cos(m * pi / 64)
        int v;
        if (m <= 32) v = c[m];
        else if (m <= 64) v = -c[64 - m];
        else if (m <= 96) v = -c[m - 64];
        else v = c[128 - m];
        dct[k][n] = v;
      }
  }
};
const ScanTables& tables() {
  static const ScanTables t;
  return t;
}

const int kDst[4][4] = {{29, 55, 74, 84}, {74, 74, 0, -74}, {84, -29, -74, 55}, {55, -84, 74, -29}};

// ---------------------------------------------------------------------------
// Decoded picture hashes (D.3.19): MD5 (RFC 1321), CRC and checksum.

struct Md5 {
  uint32_t h[4] = {0x67452301, 0xefcdab89, 0x98badcfe, 0x10325476};
  uint8_t buf[64];
  uint64_t len = 0;
  static uint32_t rotl(uint32_t x, int c) { return (x << c) | (x >> (32 - c)); }
  void block(const uint8_t* p) {
    static const int s[64] = {7, 12, 17, 22, 7, 12, 17, 22, 7, 12, 17, 22, 7, 12, 17, 22,
                              5, 9,  14, 20, 5, 9,  14, 20, 5, 9,  14, 20, 5, 9,  14, 20,
                              4, 11, 16, 23, 4, 11, 16, 23, 4, 11, 16, 23, 4, 11, 16, 23,
                              6, 10, 15, 21, 6, 10, 15, 21, 6, 10, 15, 21, 6, 10, 15, 21};
    static const struct K {
      uint32_t v[64];
      K() {
        for (int i = 0; i < 64; i++) v[i] = (uint32_t)(std::floor(std::fabs(std::sin(i + 1.0)) * 4294967296.0));
      }
    } kk;
    const uint32_t* k = kk.v;
    uint32_t m[16];
    for (int i = 0; i < 16; i++)
      m[i] = p[4 * i] | (p[4 * i + 1] << 8) | (p[4 * i + 2] << 16) | ((uint32_t)p[4 * i + 3] << 24);
    uint32_t a = h[0], b = h[1], c = h[2], d = h[3];
    auto step = [&](uint32_t f, int i, int g) {
      const uint32_t t = d;
      d = c;
      c = b;
      b = b + rotl(a + f + k[i] + m[g], s[i]);
      a = t;
    };
    for (int i = 0; i < 16; i++) step((b & c) | (~b & d), i, i);
    for (int i = 16; i < 32; i++) step((d & b) | (~d & c), i, (5 * i + 1) & 15);
    for (int i = 32; i < 48; i++) step(b ^ c ^ d, i, (3 * i + 5) & 15);
    for (int i = 48; i < 64; i++) step(c ^ (b | ~d), i, (7 * i) & 15);
    h[0] += a;
    h[1] += b;
    h[2] += c;
    h[3] += d;
  }
  void update(const uint8_t* p, size_t n) {
    size_t i = 0;
    while (i < n && (len & 63)) {
      buf[len++ & 63] = p[i++];
      if ((len & 63) == 0) block(buf);
    }
    for (; i + 64 <= n; i += 64, len += 64) block(p + i);
    for (; i < n; i++) buf[len++ & 63] = p[i];
  }
  void digest(uint8_t out[16]) {
    uint64_t bits = len * 8;
    uint8_t pad = 0x80;
    update(&pad, 1);
    pad = 0;
    while ((len & 63) != 56) update(&pad, 1);
    for (int i = 0; i < 8; i++) {
      uint8_t b = (uint8_t)(bits >> (8 * i));
      update(&b, 1);
    }
    for (int i = 0; i < 4; i++)
      for (int j = 0; j < 4; j++) out[4 * i + j] = (uint8_t)(h[i] >> (8 * j));
  }
};

// ---------------------------------------------------------------------------
// The arithmetic decoding engine over a slice segment's data (9.3.4.3), its
// contexts initialised from an initValue (9.3.2.2). After a terminating bin
// of 1 the last bit read is the one the encoder's flush wrote last (the
// stop or alignment bit).

struct Cabac : CabacEngine<kNumCtx> {
  void init_contexts(int init_type, int qp) {
    for (int i = 0; i < kNumCtx; i++) {
      const int v = kInitValue[init_type][i];
      state[i] = context((v >> 4) * 5 - 45, ((v & 15) << 3) - 16, qp);
    }
  }
};

// ---------------------------------------------------------------------------
// Parameter sets

struct ScalingList {
  uint8_t list[4][6][64];  // [sizeId][matrixId][coefficient in diagonal order]
  uint8_t dc[4][6];        // sizeId 2 and 3
  void set_default() {
    for (int size = 0; size < 4; size++)
      for (int m = 0; m < 6; m++) {
        for (int i = 0; i < 64; i++)
          list[size][m][i] = size == 0 ? 16 : (m < 3 ? kDefaultIntra8[i] : kDefaultInter8[i]);
        dc[size][m] = 16;
      }
  }
};

// scaling_list_data() (7.3.4)
void parse_scaling_list(Bits& br, ScalingList& sl) {
  sl.set_default();
  for (int size = 0; size < 4; size++)
    for (int m = 0; m < 6; m += size == 3 ? 3 : 1) {
      const int coefs = std::min(64, 1 << (4 + (size << 1)));
      if (!br.u1()) {  // scaling_list_pred_mode_flag 0: a default or an earlier list
        int delta = br.ue_max(size == 3 ? m / 3 : m, "scaling_list_pred_matrix_id_delta");
        if (delta) {
          int ref = m - delta * (size == 3 ? 3 : 1);
          memcpy(sl.list[size][m], sl.list[size][ref], 64);
          sl.dc[size][m] = sl.dc[size][ref];
        }
        // delta 0: the default list, already in place
      } else {
        int next = 8;
        if (size > 1) {
          int dc = br.se() + 8;
          if (dc < 1 || dc > 255) corrupt("scaling_list_dc_coef of %d", dc);
          next = dc;
          sl.dc[size][m] = (uint8_t)dc;
        }
        for (int i = 0; i < coefs; i++) {
          int d = br.se();
          if (d < -128 || d > 127) corrupt("scaling_list_delta_coef of %d", d);
          next = (next + d + 256) % 256;
          if (next == 0) corrupt("a scaling list coefficient of 0");
          sl.list[size][m][i] = (uint8_t)next;
        }
        if (size <= 1) sl.dc[size][m] = sl.list[size][m][0];
      }
    }
  // 32x32 chroma (4:4:4 only) copies the 16x16 lists
  for (int m : {1, 2, 4, 5}) {
    memcpy(sl.list[3][m], sl.list[2][m], 64);
    sl.dc[3][m] = sl.dc[2][m];
  }
}

// A short-term reference picture set: deltas of POC, negative ones first.
struct StRps {
  int num_neg = 0, num_pos = 0;
  int delta[32];
  bool used[32];
  int count() const { return num_neg + num_pos; }
};

// st_ref_pic_set(idx) (7.3.7) into `sets[idx]`; `num` is
// num_short_term_ref_pic_sets (idx == num: in a slice header).
void parse_st_rps(Bits& br, StRps* sets, int idx, int num, StRps& out) {
  bool inter = idx != 0 && br.u1();
  if (inter) {
    int delta_idx = idx == num ? br.ue_max(idx - 1, "delta_idx_minus1") + 1 : 1;
    const StRps& ref = sets[idx - delta_idx];
    int sgn = br.u1();
    int abs_delta = br.ue_max(32767, "abs_delta_rps_minus1") + 1;
    int delta_rps = sgn ? -abs_delta : abs_delta;
    bool used[33], use_delta[33];
    for (int j = 0; j <= ref.count(); j++) {
      used[j] = br.u1();
      use_delta[j] = used[j] ? true : br.u1();
    }
    // (7-61) and (7-62); the reference's entries: S0 at 0..num_neg-1, S1 after
    StRps r;
    int i = 0;
    for (int j = ref.num_pos - 1; j >= 0; j--) {
      int d = ref.delta[ref.num_neg + j] + delta_rps;
      if (d < 0 && use_delta[ref.num_neg + j]) {
        r.delta[i] = d;
        r.used[i++] = used[ref.num_neg + j];
      }
    }
    if (delta_rps < 0 && use_delta[ref.count()]) {
      r.delta[i] = delta_rps;
      r.used[i++] = used[ref.count()];
    }
    for (int j = 0; j < ref.num_neg; j++) {
      int d = ref.delta[j] + delta_rps;
      if (d < 0 && use_delta[j]) {
        r.delta[i] = d;
        r.used[i++] = used[j];
      }
    }
    r.num_neg = i;
    for (int j = ref.num_neg - 1; j >= 0; j--) {
      int d = ref.delta[j] + delta_rps;
      if (d > 0 && use_delta[j]) {
        if (i >= 16) corrupt("a reference picture set of more than 16 pictures");
        r.delta[i] = d;
        r.used[i++] = used[j];
      }
    }
    if (delta_rps > 0 && use_delta[ref.count()]) {
      if (i >= 16) corrupt("a reference picture set of more than 16 pictures");
      r.delta[i] = delta_rps;
      r.used[i++] = used[ref.count()];
    }
    for (int j = 0; j < ref.num_pos; j++) {
      int d = ref.delta[ref.num_neg + j] + delta_rps;
      if (d > 0 && use_delta[ref.num_neg + j]) {
        if (i >= 16) corrupt("a reference picture set of more than 16 pictures");
        r.delta[i] = d;
        r.used[i++] = used[ref.num_neg + j];
      }
    }
    r.num_pos = i - r.num_neg;
    out = r;
    return;
  }
  StRps r;
  r.num_neg = br.ue_max(16, "num_negative_pics");
  r.num_pos = br.ue_max(16 - r.num_neg, "num_positive_pics");
  int poc = 0;
  for (int i = 0; i < r.num_neg; i++) {
    poc -= br.ue_max(32767, "delta_poc_s0_minus1") + 1;
    r.delta[i] = poc;
    r.used[i] = br.u1();
  }
  poc = 0;
  for (int i = 0; i < r.num_pos; i++) {
    poc += br.ue_max(32767, "delta_poc_s1_minus1") + 1;
    r.delta[r.num_neg + i] = poc;
    r.used[r.num_neg + i] = br.u1();
  }
  out = r;
}

void skip_sub_layer_hrd(Bits& br, int cpb_cnt, bool sub_pic) {
  for (int i = 0; i < cpb_cnt; i++) {
    br.ue();
    br.ue();
    if (sub_pic) {
      br.ue();
      br.ue();
    }
    br.u1();
  }
}

// hrd_parameters() (E.2.2), skipped.
void skip_hrd(Bits& br, bool common, int max_sub_layers_minus1) {
  bool nal = false, vcl = false, sub_pic = false;
  if (common) {
    nal = br.u1();
    vcl = br.u1();
    if (nal || vcl) {
      sub_pic = br.u1();
      if (sub_pic) br.u(8 + 5 + 1 + 5);
      br.u(4 + 4);
      if (sub_pic) br.u(4);
      br.u(5 + 5 + 5);
    }
  }
  for (int i = 0; i <= max_sub_layers_minus1; i++) {
    bool fixed_general = br.u1();
    bool fixed_within = fixed_general ? true : br.u1();
    bool low_delay = false;
    if (fixed_within) br.ue();
    else low_delay = br.u1();
    int cpb_cnt = 1;
    if (!low_delay) cpb_cnt = br.ue_max(31, "cpb_cnt_minus1") + 1;
    if (nal) skip_sub_layer_hrd(br, cpb_cnt, sub_pic);
    if (vcl) skip_sub_layer_hrd(br, cpb_cnt, sub_pic);
  }
}

// profile_tier_level(1, max_sub_layers_minus1) (7.3.3), skipped: the tools
// a stream uses are refused by the flags that switch them on.
void skip_ptl(Bits& br, int max_sub_layers_minus1) {
  br.u(8);   // general_profile_space, general_tier_flag, general_profile_idc
  br.u(32);  // compatibility flags
  br.u(4);   // progressive, interlaced, non-packed, frame-only
  br.u(32);  // 43 reserved / constraint bits, then general_inbld_flag
  br.u(12);
  br.u(8);  // general_level_idc
  bool profile_present[8], level_present[8];
  for (int i = 0; i < max_sub_layers_minus1; i++) {
    profile_present[i] = br.u1();
    level_present[i] = br.u1();
  }
  if (max_sub_layers_minus1 > 0)
    for (int i = max_sub_layers_minus1; i < 8; i++) br.u(2);
  for (int i = 0; i < max_sub_layers_minus1; i++) {
    if (profile_present[i]) {
      br.u(8);   // profile space, tier, idc
      br.u(32);  // compatibility flags
      br.u(32);  // 4 source flags and 44 constraint bits
      br.u(16);
    }
    if (level_present[i]) br.u(8);
  }
}

struct Sps {
  bool valid = false;
  int width = 0, height = 0;  // pic_width/height_in_luma_samples
  int conf_left = 0, conf_right = 0, conf_top = 0, conf_bottom = 0;  // luma samples
  int log2_max_poc_lsb = 4;
  int max_dec_pic_buffering = 1, max_num_reorder = 0;  // of the highest sub-layer
  int log2_min_cb = 3, log2_ctb = 4, log2_min_tb = 2, log2_max_tb = 5;
  int max_th_depth_inter = 0, max_th_depth_intra = 0;
  bool scaling_list_enabled = false;
  ScalingList scaling;
  bool amp = false, sao = false;
  int num_st_rps = 0;
  StRps st_rps[65];
  bool temporal_mvp = false, strong_intra_smoothing = false;
  int matrix = 2, full_range = 0;
  int bit_depth = 8;  // of luma and chroma, which must agree
  // derived
  int ctb = 16, w_ctb = 0, h_ctb = 0;
};

Sps parse_sps(Bits& br) {
  Sps s;
  br.u(4);  // sps_video_parameter_set_id
  int msl = br.u(3);
  if (msl > 6) corrupt("sps_max_sub_layers_minus1 of %d", msl);
  br.u1();  // temporal_id_nesting
  skip_ptl(br, msl);
  br.ue_max(15, "sps_seq_parameter_set_id");
  int chroma = br.ue_max(3, "chroma_format_idc");
  if (chroma == 3 && br.u1()) unsupported("separate colour planes");
  if (chroma != 1) unsupported("chroma format %s", chroma == 0 ? "4:0:0" : chroma == 2 ? "4:2:2" : "4:4:4");
  s.width = br.ue_max(16888, "pic_width_in_luma_samples");
  s.height = br.ue_max(16888, "pic_height_in_luma_samples");
  if (br.u1()) {  // conformance_window_flag: offsets in chroma samples
    s.conf_left = 2 * br.ue_max(8192, "conf_win_left_offset");
    s.conf_right = 2 * br.ue_max(8192, "conf_win_right_offset");
    s.conf_top = 2 * br.ue_max(8192, "conf_win_top_offset");
    s.conf_bottom = 2 * br.ue_max(8192, "conf_win_bottom_offset");
  }
  int depth = br.ue_max(8, "bit_depth_luma_minus8") + 8, depth_c = br.ue_max(8, "bit_depth_chroma_minus8") + 8;
  if (depth != depth_c) unsupported("unequal luma and chroma bit depths (%d and %d)", depth, depth_c);
  if (depth > 10) unsupported("bit depth %d, above 10 (Main 12 and beyond)", depth);
  s.bit_depth = depth;
  s.log2_max_poc_lsb = br.ue_max(12, "log2_max_pic_order_cnt_lsb_minus4") + 4;
  bool ordering_all = br.u1();
  for (int i = ordering_all ? 0 : msl; i <= msl; i++) {
    s.max_dec_pic_buffering = br.ue_max(15, "sps_max_dec_pic_buffering_minus1") + 1;
    s.max_num_reorder = br.ue_max(15, "sps_max_num_reorder_pics");
    br.ue();  // sps_max_latency_increase_plus1
  }
  s.log2_min_cb = br.ue_max(3, "log2_min_luma_coding_block_size_minus3") + 3;
  s.log2_ctb = s.log2_min_cb + br.ue_max(3, "log2_diff_max_min_luma_coding_block_size");
  s.log2_min_tb = br.ue_max(3, "log2_min_luma_transform_block_size_minus2") + 2;
  s.log2_max_tb = s.log2_min_tb + br.ue_max(3, "log2_diff_max_min_luma_transform_block_size");
  if (s.log2_ctb < 4 || s.log2_ctb > 6 || s.log2_max_tb > 5 || s.log2_max_tb > s.log2_ctb ||
      s.log2_min_tb >= s.log2_min_cb)
    corrupt("CTB, CB and TB sizes 2^%d, 2^%d, 2^%d..2^%d", s.log2_ctb, s.log2_min_cb, s.log2_min_tb,
            s.log2_max_tb);
  if (s.width % (1 << s.log2_min_cb) || s.height % (1 << s.log2_min_cb) || !s.width || !s.height)
    corrupt("a picture of %dx%d in coding blocks of %d", s.width, s.height, 1 << s.log2_min_cb);
  s.max_th_depth_inter = br.ue_max(4, "max_transform_hierarchy_depth_inter");
  s.max_th_depth_intra = br.ue_max(4, "max_transform_hierarchy_depth_intra");
  s.scaling_list_enabled = br.u1();
  s.scaling.set_default();
  if (s.scaling_list_enabled && br.u1()) parse_scaling_list(br, s.scaling);
  s.amp = br.u1();
  s.sao = br.u1();
  if (br.u1()) unsupported("PCM coding units (pcm_enabled_flag)");
  s.num_st_rps = br.ue_max(64, "num_short_term_ref_pic_sets");
  for (int i = 0; i < s.num_st_rps; i++) parse_st_rps(br, s.st_rps, i, s.num_st_rps, s.st_rps[i]);
  if (br.u1()) unsupported("long-term reference pictures (long_term_ref_pics_present_flag)");
  s.temporal_mvp = br.u1();
  s.strong_intra_smoothing = br.u1();
  if (br.u1()) {  // vui_parameters() (E.2.1)
    if (br.u1() && br.u(8) == 255) br.u(32);  // aspect ratio, sar
    if (br.u1()) br.u1();                      // overscan
    if (br.u1()) {                             // video_signal_type_present_flag
      br.u(3);
      s.full_range = br.u1();
      if (br.u1()) {
        br.u(8);
        br.u(8);
        s.matrix = br.u(8);
      }
    }
    if (br.u1()) {  // chroma_loc_info_present_flag
      br.ue();
      br.ue();
    }
    br.u1();  // neutral_chroma_indication_flag
    if (br.u1()) unsupported("field coding (field_seq_flag)");
    br.u1();  // frame_field_info_present_flag
    if (br.u1()) {  // default_display_window_flag
      br.ue();
      br.ue();
      br.ue();
      br.ue();
    }
    if (br.u1()) {  // vui_timing_info_present_flag
      br.u(32);
      br.u(32);
      if (br.u1()) br.ue();
      if (br.u1()) skip_hrd(br, true, msl);
    }
    if (br.u1()) {  // bitstream_restriction_flag
      br.u(3);
      br.ue();
      br.ue();
      br.ue();
      br.ue();
      br.ue();
    }
  }
  if (br.u1()) {  // sps_extension_present_flag
    bool range = br.u1(), multilayer = br.u1(), ext3d = br.u1(), scc = br.u1();
    br.u(4);
    if (range) {
      static const char* kNames[9] = {"transform_skip_rotation", "transform_skip_context",
                                      "implicit_rdpcm", "explicit_rdpcm",
                                      "extended_precision_processing", "intra_smoothing_disabled",
                                      "high_precision_offsets", "persistent_rice_adaptation",
                                      "cabac_bypass_alignment"};
      for (int i = 0; i < 9; i++)
        if (br.u1()) unsupported("the range extension's %s", kNames[i]);
    }
    if (multilayer) unsupported("the multilayer extension");
    if (ext3d) unsupported("the 3D extension");
    if (scc) unsupported("the screen content coding extension");
  }
  s.ctb = 1 << s.log2_ctb;
  s.w_ctb = (s.width + s.ctb - 1) >> s.log2_ctb;
  s.h_ctb = (s.height + s.ctb - 1) >> s.log2_ctb;
  if (s.conf_left + s.conf_right >= s.width || s.conf_top + s.conf_bottom >= s.height)
    corrupt("a conformance window outside the picture");
  s.valid = true;
  return s;
}

struct Pps {
  bool valid = false;
  int sps_id = 0;
  bool output_flag_present = false;
  int num_extra_bits = 0;
  bool sign_hiding = false, cabac_init_present = false;
  int num_ref_idx_default[2] = {1, 1};
  int init_qp = 26;
  bool constrained_intra = false, transform_skip = false, cu_qp_delta = false;
  int diff_cu_qp_delta_depth = 0;
  int cb_qp_offset = 0, cr_qp_offset = 0;
  bool slice_chroma_qp_offsets = false, weighted_pred = false, weighted_bipred = false;
  bool transquant_bypass = false, wpp = false;
  bool loop_filter_across_slices = false, deblocking_override = false, deblocking_disabled = false;
  int beta_offset = 0, tc_offset = 0;  // the div2 values times 2
  bool scaling_list_present = false;
  ScalingList scaling;
  bool lists_modification = false;
  int log2_par_mrg_level = 2;
  bool slice_header_extension = false;
};

Pps parse_pps(Bits& br, int* id) {
  Pps p;
  *id = br.ue_max(63, "pps_pic_parameter_set_id");
  p.sps_id = br.ue_max(15, "pps_seq_parameter_set_id");
  if (br.u1()) unsupported("dependent slice segments (dependent_slice_segments_enabled_flag)");
  p.output_flag_present = br.u1();
  p.num_extra_bits = br.u(3);
  p.sign_hiding = br.u1();
  p.cabac_init_present = br.u1();
  p.num_ref_idx_default[0] = br.ue_max(14, "num_ref_idx_l0_default_active_minus1") + 1;
  p.num_ref_idx_default[1] = br.ue_max(14, "num_ref_idx_l1_default_active_minus1") + 1;
  p.init_qp = 26 + br.se();
  p.constrained_intra = br.u1();
  p.transform_skip = br.u1();
  p.cu_qp_delta = br.u1();
  if (p.cu_qp_delta) p.diff_cu_qp_delta_depth = br.ue_max(3, "diff_cu_qp_delta_depth");
  p.cb_qp_offset = br.se();
  p.cr_qp_offset = br.se();
  if (p.cb_qp_offset < -12 || p.cb_qp_offset > 12 || p.cr_qp_offset < -12 || p.cr_qp_offset > 12)
    corrupt("PPS chroma QP offsets %d and %d", p.cb_qp_offset, p.cr_qp_offset);
  p.slice_chroma_qp_offsets = br.u1();
  p.weighted_pred = br.u1();
  p.weighted_bipred = br.u1();
  p.transquant_bypass = br.u1();
  if (br.u1()) unsupported("tiles");
  p.wpp = br.u1();
  p.loop_filter_across_slices = br.u1();
  if (br.u1()) {  // deblocking_filter_control_present_flag
    p.deblocking_override = br.u1();
    p.deblocking_disabled = br.u1();
    if (!p.deblocking_disabled) {
      p.beta_offset = 2 * br.se();
      p.tc_offset = 2 * br.se();
    }
  }
  p.scaling_list_present = br.u1();
  if (p.scaling_list_present) parse_scaling_list(br, p.scaling);
  p.lists_modification = br.u1();
  p.log2_par_mrg_level = br.ue_max(4, "log2_parallel_merge_level_minus2") + 2;
  p.slice_header_extension = br.u1();
  if (br.u1()) {  // pps_extension_present_flag
    bool range = br.u1(), multilayer = br.u1(), ext3d = br.u1(), scc = br.u1();
    br.u(4);
    if (range) {
      if (p.transform_skip && br.ue()) unsupported("transform skip above 4x4 (the range extension)");
      if (br.u1()) unsupported("cross-component prediction (the range extension)");
      if (br.u1()) unsupported("chroma QP offset lists (the range extension)");
      if (br.ue() || br.ue()) unsupported("SAO offset scaling (the range extension)");
    }
    if (multilayer) unsupported("the multilayer extension");
    if (ext3d) unsupported("the 3D extension");
    if (scc) unsupported("the screen content coding extension");
  }
  p.valid = true;
  return p;
}

// ---------------------------------------------------------------------------
// Pictures

// The motion of a 4x4 block: pred bit 0 (list 0) and bit 1 (list 1); 0 for
// an intra block.
struct MvField {
  int16_t mv[2][2];
  int8_t ref[2];
  uint8_t pred;
};

// What the reference lists of one slice of a picture held: for the
// collocated motion of later pictures and for deblocking.
struct SliceRefs {
  int poc[2][16];
  bool lt[2][16];
  int id[2][16];  // Picture::id
};

enum { kOutput = 1, kShortRef = 2, kLongRef = 4 };

struct Picture {
  int w = 0, h = 0;  // coded luma size
  int depth = 8;     // bit depth: samples of 8 bits in one byte, of 9 and 10 in two
  std::vector<uint8_t> y, u, v;  // the planes' bytes
  int id = 0;
  int poc = 0;
  int decode_index = 0;
  int flags = 0;
  // Output: the cropped size and colour conversion of its SPS.
  int out_w = 0, out_h = 0, crop_left = 0, crop_top = 0, full_range = 0, matrix = 2;
  // Motion per 4x4 block, the slice of each CTB and each slice's lists.
  int w4 = 0, w_ctb = 0, log2_ctb = 4;
  std::vector<MvField> mvf;
  std::vector<uint16_t> ctb_slice;
  std::vector<SliceRefs> slices;
  // The decoded-picture hash SEI: type (-1: none) and per plane its bytes.
  int hash_type = -1;
  uint8_t hash[3][16];

  void alloc(int w_, int h_, int log2_ctb_, int depth_, bool samples) {
    w = w_;
    h = h_;
    depth = depth_;
    log2_ctb = log2_ctb_;
    w4 = w >> 2;
    w_ctb = (w + (1 << log2_ctb) - 1) >> log2_ctb;
    int h_ctb = (h + (1 << log2_ctb) - 1) >> log2_ctb;
    ctb_slice.assign((size_t)w_ctb * h_ctb, 0);
    slices.assign(1, SliceRefs());
    if (samples) {  // mid-grey, as a missing reference is generated (8.3.3.2)
      const size_t bytes = depth > 8 ? 2 : 1, n = (size_t)w * h, nc = (size_t)(w / 2) * (h / 2);
      y.resize(n * bytes);
      u.resize(nc * bytes);
      v.resize(nc * bytes);
      for (int c = 0; c < 3; c++) {
        if (depth > 8) std::fill_n(samples_of<uint16_t>(c), c ? nc : n, (uint16_t)(1 << (depth - 1)));
        else std::fill_n(samples_of<uint8_t>(c), c ? nc : n, (uint8_t)128);
      }
      MvField intra{};
      mvf.assign((size_t)w4 * (h >> 2), intra);
    }
  }
  uint8_t* plane(int c) { return c == 0 ? y.data() : c == 1 ? u.data() : v.data(); }
  const uint8_t* plane(int c) const { return c == 0 ? y.data() : c == 1 ? u.data() : v.data(); }
  // The samples of plane c: P is uint8_t at 8 bits, uint16_t above.
  template <class P>
  P* samples_of(int c) { return reinterpret_cast<P*>(plane(c)); }
  template <class P>
  const P* samples_of(int c) const { return reinterpret_cast<const P*>(plane(c)); }
  int stride(int c) const { return c == 0 ? w : w / 2; }
  const MvField& motion(int x, int y_) const { return mvf[(size_t)(y_ >> 2) * w4 + (x >> 2)]; }
  const SliceRefs& slice_at(int x, int y_) const {
    return slices[ctb_slice[(size_t)(y_ >> log2_ctb) * w_ctb + (x >> log2_ctb)]];
  }
};
using PicturePtr = std::shared_ptr<Picture>;

struct SliceHeader {
  int nal_type = 0, temporal_id = 0;
  bool first_slice = false, no_output_of_prior_pics = false;
  int pps_id = 0, address = 0, type = SLICE_I;
  bool pic_output = true;
  int poc_lsb = 0;
  StRps rps;
  bool temporal_mvp = false, sao_luma = false, sao_chroma = false;
  int num_ref_idx[2] = {0, 0};
  bool list_mod[2] = {false, false};
  int list_entry[2][16];
  bool mvd_l1_zero = false, cabac_init = false, collocated_from_l0 = true;
  int collocated_ref_idx = 0;
  int luma_log2_wd = 0, chroma_log2_wd = 0;
  int luma_w[2][16], luma_o[2][16], chroma_w[2][16][2], chroma_o[2][16][2];
  int max_merge = 5;
  int qp = 26, cb_qp_offset = 0, cr_qp_offset = 0;
  bool deblocking_disabled = false;
  int beta_offset = 0, tc_offset = 0;
  bool lf_across = false;
  size_t data_byte = 0;  // the slice data's first byte in the RBSP
};

// Deblocking and SAO parameters of one slice of the picture being decoded.
struct SliceParams {
  int addr = 0;  // SliceAddrRs
  bool deblocking_disabled = false, lf_across = false;
  int beta_offset = 0, tc_offset = 0;
};

struct Sao {
  uint8_t type[3];   // 0 none, 1 band, 2 edge
  uint8_t band[3];   // sao_band_position
  uint8_t eo[3];     // sao_eo_class
  int8_t offset[3][5];  // SaoOffsetVal
};

// Per-4x4 flags of the picture being decoded.
enum {
  kIntra = 1, kSkip = 2, kBypass = 4, kNonZero = 8,  // cu
  kEdgeVT = 1, kEdgeVP = 2, kEdgeHT = 4, kEdgeHP = 8  // edges: left/top, transform/prediction
};
enum { PART_2Nx2N, PART_2NxN, PART_Nx2N, PART_NxN, PART_2NxnU, PART_2NxnD, PART_nLx2N, PART_nRx2N };

const uint8_t kCtxIdxMap[16] = {0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8};

class Decoder {
 public:
  bool headers_only = false;
  int length_size = 0;  // of the packets' NAL unit lengths; 0: Annex B
  int hashes_checked[3] = {0, 0, 0}, hashes_failed[3] = {0, 0, 0};  // per plane

  // An hvcC (MP4, Matroska) or Annex B parameter sets.
  void configure(const uint8_t* data, size_t n) {
    if (n >= 23 && data[0] == 1) {
      length_size = (data[21] & 3) + 1;
      size_t pos = 23;
      int arrays = data[22];
      for (int a = 0; a < arrays; a++) {
        if (pos + 3 > n) corrupt("an hvcC that ends inside its arrays");
        int count = (data[pos + 1] << 8) | data[pos + 2];
        pos += 3;
        for (int k = 0; k < count; k++) {
          if (pos + 2 > n) corrupt("an hvcC that ends inside its arrays");
          size_t len = (data[pos] << 8) | data[pos + 1];
          pos += 2;
          if (pos + len > n) corrupt("an hvcC NAL unit that runs past it");
          nal(data + pos, len);
          pos += len;
        }
      }
      return;
    }
    for (auto& p : split_nals(data, n, 0)) nal(p.first, p.second);
  }

  void decode(const uint8_t* data, size_t n) {
    for (auto& p : split_nals(data, n, length_size)) nal(p.first, p.second);
    finish_picture();
  }

  // The end of the stream: every picture still waiting is output.
  void flush() {
    finish_picture();
    bump(0, 0, false);
  }

  int pictures() const { return pictures_; }
  const Picture* ready() const { return out_.empty() ? nullptr : out_.front().get(); }
  void pop() { out_.erase(out_.begin()); }

 private:
  std::unique_ptr<Sps> sps_[16];
  std::unique_ptr<Pps> pps_[64];
  Sps sps;  // active
  Pps pps;
  SliceHeader sh;
  std::vector<uint8_t> rbsp_;
  std::vector<PicturePtr> dpb_, out_;
  PicturePtr cur_;
  int pictures_ = 0, next_id_ = 1;
  bool first_picture_ = true, eos_ = false;
  int prev_tid0_poc_ = 0, max_ra_ = INT_MAX;
  bool skipping_ = false;  // the current picture is a RASL picture that is not decoded
  // The current slice's reference lists.
  Picture* refs_[2][16];
  bool refs_lt_[2][16];
  int num_refs_[2] = {0, 0};
  bool no_backward_pred_ = true;
  Picture* col_ = nullptr;
  // Per-picture state of the one being decoded.
  int w4_ = 0, h4_ = 0;
  std::vector<uint8_t> cu_, depth_, mode_, edge_;
  std::vector<int8_t> qp_;
  std::vector<int> ctb_addr_;  // SliceAddrRs of each CTB (-1: not decoded)
  std::vector<Sao> sao_;
  std::vector<SliceParams> slice_params_;
  std::vector<int> zscan_;  // MinTbAddrZs
  int zscan_w_ = 0;
  // Scaling factors m[sizeId][matrixId] (n*n, row-major), from the active lists.
  std::vector<uint8_t> factor_[4][6];
  bool scaling_ = false;

  // ---- NAL units

  void nal(const uint8_t* p, size_t n) {
    if (n < 2) corrupt("a NAL unit of %zu bytes", n);
    if (p[0] & 0x80) corrupt("forbidden_zero_bit set");
    int type = (p[0] >> 1) & 63, layer = ((p[0] & 1) << 5) | (p[1] >> 3), tid = (p[1] & 7) - 1;
    if (tid < 0) corrupt("nuh_temporal_id_plus1 of 0");
    if (layer > 0) return;  // other layers: skipped, as FFmpeg's default
    unescape(p + 2, n - 2, rbsp_);
    Bits br(rbsp_.data(), rbsp_.size());
    if (type == SPS_NUT) {
      Bits probe = br;
      probe.u(4);
      int msl = probe.u(3);
      probe.u1();
      skip_ptl(probe, msl);
      int id = probe.ue_max(15, "sps_seq_parameter_set_id");
      sps_[id].reset(new Sps(parse_sps(br)));
    } else if (type == PPS_NUT) {
      int id;
      Pps p2 = parse_pps(br, &id);
      pps_[id].reset(new Pps(p2));
    } else if (type == SEI_SUFFIX || type == SEI_PREFIX) {
      sei(br, type);
    } else if (type == EOS_NUT || type == EOB_NUT) {
      finish_picture();
      eos_ = true;
    } else if (type <= 21 && (type <= 9 || type >= 16)) {
      slice(br, type, tid);
    }
    // VPS, AUD, filler data and reserved types: nothing to do
  }

  void sei(Bits& br, int type) {
    while (br.more_rbsp_data()) {
      int payload_type = 0, size = 0, b;
      do {
        b = br.u(8);
        payload_type += b;
      } while (b == 255);
      do {
        b = br.u(8);
        size += b;
      } while (b == 255);
      size_t end = br.pos + 8 * (size_t)size;
      if (end > br.size * 8) corrupt("an SEI message that runs past its NAL unit");
      if (type == SEI_SUFFIX && payload_type == 132 && cur_) {  // decoded_picture_hash
        int hash = br.u(8);
        if (hash <= 2) {
          cur_->hash_type = hash;
          const int bytes = hash == 0 ? 16 : hash == 1 ? 2 : 4;
          for (int c = 0; c < 3; c++)
            for (int i = 0; i < bytes; i++) cur_->hash[c][i] = (uint8_t)br.u(8);
        }
      }
      br.pos = end;
    }
  }

  // ---- Slice segment header (7.3.6.1)

  void parse_slice_header(Bits& br, int type, int tid) {
    SliceHeader& s = sh;
    s.nal_type = type;
    s.temporal_id = tid;
    s.first_slice = br.u1();
    s.no_output_of_prior_pics = is_irap(type) ? br.u1() : false;
    s.pps_id = br.ue_max(63, "slice_pic_parameter_set_id");
    if (!pps_[s.pps_id]) corrupt("a slice of PPS %d, which the stream has not sent", s.pps_id);
    const Pps& p = *pps_[s.pps_id];
    if (!sps_[p.sps_id]) corrupt("PPS %d of SPS %d, which the stream has not sent", s.pps_id, p.sps_id);
    if (s.first_slice) {  // a picture activates its parameter sets
      pps = p;
      sps = *sps_[p.sps_id];
    } else if (s.pps_id != sh_pps_id_) {
      corrupt("slices of one picture with PPS %d and %d", sh_pps_id_, s.pps_id);
    }
    sh_pps_id_ = s.pps_id;
    s.address = 0;
    if (!s.first_slice) {
      int ctbs = sps.w_ctb * sps.h_ctb;
      s.address = br.u(ceil_log2(ctbs));
      if (s.address >= ctbs) corrupt("slice_segment_address %d of %d CTBs", s.address, ctbs);
    }
    br.u(pps.num_extra_bits);
    s.type = br.ue_max(2, "slice_type");
    s.pic_output = pps.output_flag_present ? br.u1() : true;
    s.poc_lsb = 0;
    s.rps = StRps();
    s.temporal_mvp = false;
    if (!is_idr(type)) {
      s.poc_lsb = br.u(sps.log2_max_poc_lsb);
      bool from_sps = br.u1();
      if (!from_sps) {
        parse_st_rps(br, sps.st_rps, sps.num_st_rps, sps.num_st_rps, s.rps);
      } else {
        if (!sps.num_st_rps) corrupt("a slice that takes an RPS of an SPS that has none");
        int idx = sps.num_st_rps > 1 ? br.u(ceil_log2(sps.num_st_rps)) : 0;
        if (idx >= sps.num_st_rps) corrupt("short_term_ref_pic_set_idx %d", idx);
        s.rps = sps.st_rps[idx];
      }
      if (sps.temporal_mvp) s.temporal_mvp = br.u1();
    }
    s.sao_luma = s.sao_chroma = false;
    if (sps.sao) {
      s.sao_luma = br.u1();
      s.sao_chroma = br.u1();
    }
    s.num_ref_idx[0] = s.num_ref_idx[1] = 0;
    s.list_mod[0] = s.list_mod[1] = false;
    s.mvd_l1_zero = false;
    s.cabac_init = false;
    s.collocated_from_l0 = true;
    s.collocated_ref_idx = 0;
    s.max_merge = 5;
    if (s.type != SLICE_I) {
      const int lists = s.type == SLICE_B ? 2 : 1;
      s.num_ref_idx[0] = pps.num_ref_idx_default[0];
      if (lists == 2) s.num_ref_idx[1] = pps.num_ref_idx_default[1];
      if (br.u1()) {  // num_ref_idx_active_override_flag
        s.num_ref_idx[0] = br.ue_max(14, "num_ref_idx_l0_active_minus1") + 1;
        if (lists == 2) s.num_ref_idx[1] = br.ue_max(14, "num_ref_idx_l1_active_minus1") + 1;
      }
      int total = 0;
      for (int i = 0; i < s.rps.count(); i++) total += s.rps.used[i];
      if (total == 0) corrupt("an inter slice without references");
      if (pps.lists_modification && total > 1)
        for (int l = 0; l < lists; l++) {
          s.list_mod[l] = br.u1();
          if (s.list_mod[l])
            for (int i = 0; i < s.num_ref_idx[l]; i++) {
              s.list_entry[l][i] = br.u(ceil_log2(total));
              if (s.list_entry[l][i] >= total) corrupt("list_entry_l%d %d of %d", l, s.list_entry[l][i], total);
            }
        }
      if (lists == 2) {
        s.mvd_l1_zero = br.u1();
        // x265 writes 0 in every B slice: no fixture holds the other to check
        // the inferred zero differences against FFmpeg.
        if (s.mvd_l1_zero) unsupported("mvd_l1_zero_flag (list 1 motion vector differences inferred as zero)");
      }
      if (pps.cabac_init_present) s.cabac_init = br.u1();
      if (s.temporal_mvp) {
        if (lists == 2) s.collocated_from_l0 = br.u1();
        const int n = s.num_ref_idx[s.collocated_from_l0 ? 0 : 1];
        if (n > 1) s.collocated_ref_idx = br.ue_max(n - 1, "collocated_ref_idx");
      }
      if ((pps.weighted_pred && s.type == SLICE_P) || (pps.weighted_bipred && s.type == SLICE_B))
        parse_weights(br, lists);
      s.max_merge = 5 - br.ue_max(4, "five_minus_max_num_merge_cand");
    }
    s.qp = pps.init_qp + br.se();
    if (s.qp < -6 * (sps.bit_depth - 8) || s.qp > 51) corrupt("SliceQpY of %d", s.qp);
    s.cb_qp_offset = s.cr_qp_offset = 0;
    if (pps.slice_chroma_qp_offsets) {
      s.cb_qp_offset = br.se();
      s.cr_qp_offset = br.se();
    }
    s.deblocking_disabled = pps.deblocking_disabled;
    s.beta_offset = pps.beta_offset;
    s.tc_offset = pps.tc_offset;
    if (pps.deblocking_override && br.u1()) {
      s.deblocking_disabled = br.u1();
      if (!s.deblocking_disabled) {
        s.beta_offset = 2 * br.se();
        s.tc_offset = 2 * br.se();
      }
    }
    s.lf_across = pps.loop_filter_across_slices;
    if (pps.loop_filter_across_slices && (s.sao_luma || s.sao_chroma || !s.deblocking_disabled))
      s.lf_across = br.u1();
    if (pps.wpp) {
      int n = br.ue_max(sps.h_ctb - 1, "num_entry_point_offsets");
      if (n > 0) {
        int len = br.ue_max(31, "offset_len_minus1") + 1;
        for (int i = 0; i < n; i++) br.u(len);
      }
    }
    if (pps.slice_header_extension) {
      int len = br.ue_max(256, "slice_segment_header_extension_length");
      br.u(0);
      for (int i = 0; i < len; i++) br.u(8);
    }
    // byte_alignment(): a one, then zeros
    if (!br.u1()) corrupt("a slice header without its alignment bit");
    while (br.pos & 7) br.u1();
    s.data_byte = br.pos >> 3;
  }
  int sh_pps_id_ = -1;

  // pred_weight_table() (7.3.6.3) of a P (lists 1) or B (lists 2) slice
  void parse_weights(Bits& br, int lists) {
    SliceHeader& s = sh;
    s.luma_log2_wd = br.ue_max(7, "luma_log2_weight_denom");
    s.chroma_log2_wd = s.luma_log2_wd + br.se();
    if (s.chroma_log2_wd < 0 || s.chroma_log2_wd > 7) corrupt("ChromaLog2WeightDenom of %d", s.chroma_log2_wd);
    for (int l = 0; l < lists; l++) {
      const int n = s.num_ref_idx[l];
      bool luma[16], chroma[16];
      for (int i = 0; i < n; i++) luma[i] = br.u1();
      for (int i = 0; i < n; i++) chroma[i] = br.u1();
      for (int i = 0; i < n; i++) {
        s.luma_w[l][i] = 1 << s.luma_log2_wd;
        s.luma_o[l][i] = 0;
        if (luma[i]) {
          s.luma_w[l][i] += br.se();
          s.luma_o[l][i] = br.se();
        }
        for (int j = 0; j < 2; j++) {
          s.chroma_w[l][i][j] = 1 << s.chroma_log2_wd;
          s.chroma_o[l][i][j] = 0;
        }
        if (chroma[i])
          for (int j = 0; j < 2; j++) {
            int w = (1 << s.chroma_log2_wd) + br.se();
            int delta = br.se();
            s.chroma_w[l][i][j] = w;
            s.chroma_o[l][i][j] = clip3(-128, 127, (128 - ((128 * w) >> s.chroma_log2_wd)) + delta);
          }
      }
    }
  }

  // ---- Pictures, POC, RPS and the DPB

  void slice(Bits& br, int type, int tid) {
    parse_slice_header(br, type, tid);
    if (sh.first_slice) {
      finish_picture();
      start_picture();
    } else if (!cur_ && !skipping_) {
      corrupt("a slice segment without the first of its picture");
    }
    if (skipping_) return;
    build_ref_lists();
    if (headers_only) return;
    decode_slice_data();
  }

  void start_picture() {
    const int type = sh.nal_type;
    pictures_++;
    bool no_rasl_output = is_idr(type) || is_bla(type) || (type == CRA_NUT && (first_picture_ || eos_));
    // 8.3.1: the picture order count
    const int max_lsb = 1 << sps.log2_max_poc_lsb;
    int msb = 0;
    if (!(is_irap(type) && no_rasl_output)) {
      int prev_lsb = prev_tid0_poc_ & (max_lsb - 1), prev_msb = prev_tid0_poc_ - prev_lsb;
      if (sh.poc_lsb < prev_lsb && prev_lsb - sh.poc_lsb >= max_lsb / 2) msb = prev_msb + max_lsb;
      else if (sh.poc_lsb > prev_lsb && sh.poc_lsb - prev_lsb > max_lsb / 2) msb = prev_msb - max_lsb;
      else msb = prev_msb;
    }
    const int poc = msb + sh.poc_lsb;
    const bool sub_layer_non_ref = type <= 14 && !(type & 1);
    if (sh.temporal_id == 0 && !(type >= 6 && type <= 9) && !sub_layer_non_ref) prev_tid0_poc_ = poc;
    // RASL pictures of an IRAP with NoRaslOutputFlag are not decoded (FFmpeg's max_ra).
    if (type == CRA_NUT && (first_picture_ || eos_)) max_ra_ = poc;
    else if (is_idr(type) || is_bla(type)) max_ra_ = INT_MIN;
    skipping_ = (type == RASL_N || type == RASL_R) && poc <= max_ra_;
    if (type == RASL_R && poc > max_ra_) max_ra_ = INT_MIN;
    first_picture_ = false;
    eos_ = false;
    if (skipping_) return;
    if (is_irap(type) && no_rasl_output) bump(0, 0, sh.no_output_of_prior_pics);
    // 8.3.2: reference marking by the RPS; missing references are generated
    for (auto& p : dpb_) p->flags &= ~(kShortRef | kLongRef);
    rps_pics_.clear();
    for (int i = 0; i < sh.rps.count(); i++) {
      int want = poc + sh.rps.delta[i];
      Picture* found = nullptr;
      for (auto& p : dpb_)
        if (p->poc == want) found = p.get();
      if (!found) found = generate_missing(want);
      found->flags |= kShortRef;
      rps_pics_.push_back(found);
    }
    dpb_.erase(std::remove_if(dpb_.begin(), dpb_.end(), [](const PicturePtr& p) { return !p->flags; }),
               dpb_.end());
    // The new picture
    cur_ = std::make_shared<Picture>();
    Picture& P = *cur_;
    bd_ = sps.bit_depth;
    qp_bd_ = 6 * (bd_ - 8);
    P.alloc(sps.width, sps.height, sps.log2_ctb, bd_, !headers_only);
    P.id = next_id_++;
    P.poc = poc;
    P.decode_index = pictures_ - 1;
    P.flags = kShortRef | (sh.pic_output ? kOutput : 0);
    P.crop_left = sps.conf_left;
    P.crop_top = sps.conf_top;
    P.out_w = sps.width - sps.conf_left - sps.conf_right;
    P.out_h = sps.height - sps.conf_top - sps.conf_bottom;
    P.full_range = sps.full_range;
    P.matrix = sps.matrix;
    P.slices.clear();
    dpb_.push_back(cur_);
    bump(sps.max_num_reorder, sps.max_dec_pic_buffering, false);
    if (!headers_only) begin_samples();
  }
  std::vector<Picture*> rps_pics_;  // the current picture's RPS, in the RPS's order

  Picture* generate_missing(int poc) {
    auto p = std::make_shared<Picture>();
    p->alloc(sps.width, sps.height, sps.log2_ctb, sps.bit_depth, !headers_only);
    p->id = next_id_++;
    p->poc = poc;
    p->slices.assign(1, SliceRefs());
    dpb_.push_back(p);
    return p.get();
  }

  // FFmpeg's output: the waiting picture of least POC while more than
  // `max_output` wait or the DPB holds more than `max_dpb` (0, 0: all);
  // `discard`: dropped instead (no_output_of_prior_pics_flag).
  void bump(int max_output, int max_dpb, bool discard) {
    while (true) {
      int n_output = 0, n_dpb = 0;
      Picture* best = nullptr;
      for (auto& p : dpb_) {
        if (p->flags & kOutput) {
          n_output++;
          if (!best || p->poc < best->poc) best = p.get();
        }
        n_dpb += p->flags != 0;
      }
      if (!(n_output > max_output || (n_output && n_dpb > max_dpb))) break;
      for (auto& p : dpb_)
        if (p.get() == best) {
          if (!discard) out_.push_back(p);
          break;
        }
      best->flags &= ~kOutput;
    }
    dpb_.erase(std::remove_if(dpb_.begin(), dpb_.end(), [](const PicturePtr& p) { return !p->flags; }),
               dpb_.end());
  }

  // RefPicList0 and, in a B slice, RefPicList1 of the current slice (8.3.4).
  void build_ref_lists() {
    num_refs_[0] = num_refs_[1] = 0;
    no_backward_pred_ = true;
    col_ = nullptr;
    SliceRefs refs;
    if (sh.type != SLICE_I) {
      std::vector<Picture*> before, after;
      for (int i = 0; i < sh.rps.count(); i++)
        if (sh.rps.used[i]) (i < sh.rps.num_neg ? before : after).push_back(rps_pics_[i]);
      const int total = (int)(before.size() + after.size());
      for (int l = 0; l < (sh.type == SLICE_B ? 2 : 1); l++) {
        // RefPicListTemp0: before, then after; RefPicListTemp1: after, then before
        const std::vector<Picture*>& first = l ? after : before;
        const std::vector<Picture*>& second = l ? before : after;
        std::vector<Picture*> temp;
        const int n = std::max(sh.num_ref_idx[l], total);
        while ((int)temp.size() < n) {
          for (Picture* p : first)
            if ((int)temp.size() < n) temp.push_back(p);
          for (Picture* p : second)
            if ((int)temp.size() < n) temp.push_back(p);
        }
        num_refs_[l] = sh.num_ref_idx[l];
        for (int i = 0; i < num_refs_[l]; i++) {
          Picture* p = temp[sh.list_mod[l] ? sh.list_entry[l][i] : i];
          if (p->depth != cur_->depth) corrupt("a reference picture of bit depth %d in a picture of %d", p->depth, cur_->depth);
          refs_[l][i] = p;
          refs_lt_[l][i] = false;
          if (p->poc > cur_->poc) no_backward_pred_ = false;
          refs.poc[l][i] = p->poc;
          refs.lt[l][i] = false;
          refs.id[l][i] = p->id;
        }
      }
      if (sh.temporal_mvp) col_ = refs_[sh.collocated_from_l0 ? 0 : 1][sh.collocated_ref_idx];
    }
    cur_->slices.push_back(refs);
  }

  void finish_picture() {
    if (!cur_) return;
    if (!headers_only) {
      deblock();
      apply_sao();
      check_hash();
    }
    cur_.reset();
  }

  // ---- Slice data (7.3.8)

  Cabac cc_;
  Bits bits_;
  int slice_idx_ = 0;
  int log2_qg_ = 6;
  int qp_y_ = 26, qp_prev_ = 26, qpy_pred_ = 26, cu_qp_delta_ = 0;
  int bd_ = 8, qp_bd_ = 0;  // the current picture's bit depth and QpBdOffset (6 per bit above 8)
  bool qp_delta_coded_ = false, first_qg_ = true;
  int qg_x_ = -1, qg_y_ = -1;
  // The coding unit being decoded.
  bool cu_intra_ = false, cu_bypass_ = false, intra_split_ = false;
  int cu_part_ = PART_2Nx2N, chroma_mode_ = 0, max_trafo_depth_ = 0, cu_depth_ = 0;

  size_t i4(int x, int y) const { return (size_t)(y >> 2) * w4_ + (x >> 2); }

  void begin_samples() {
    const Picture& P = *cur_;
    w4_ = P.w >> 2;
    h4_ = P.h >> 2;
    const size_t n4 = (size_t)w4_ * h4_;
    cu_.assign(n4, 0);
    depth_.assign(n4, 0);
    mode_.assign(n4, 1);
    edge_.assign(n4, 0);
    qp_.assign(n4, 0);
    const int ctbs = sps.w_ctb * sps.h_ctb;
    ctb_addr_.assign(ctbs, -1);
    sao_.assign(ctbs, Sao{});
    slice_params_.clear();
    // MinTbAddrZs (6-10), in raster CTB order (no tiles)
    const int shift = sps.log2_ctb - sps.log2_min_tb;
    zscan_w_ = sps.w_ctb << shift;
    const int zh = sps.h_ctb << shift;
    zscan_.assign((size_t)zscan_w_ * zh, 0);
    for (int y = 0; y < zh; y++)
      for (int x = 0; x < zscan_w_; x++) {
        int ctb = (y >> shift) * sps.w_ctb + (x >> shift);
        int v = ctb << (2 * shift);
        for (int i = 0; i < shift; i++) {
          int m = 1 << i;
          v += (m & x ? m * m : 0) + (m & y ? 2 * m * m : 0);
        }
        zscan_[(size_t)y * zscan_w_ + x] = v;
      }
    // Scaling factors (7.4.5) of the active lists
    scaling_ = sps.scaling_list_enabled;
    if (scaling_) {
      const ScalingList& sl = pps.scaling_list_present ? pps.scaling : sps.scaling;
      const ScanTables& T = tables();
      for (int size = 0; size < 4; size++)
        for (int m = 0; m < 6; m++) {
          const int n = 4 << size;
          std::vector<uint8_t>& f = factor_[size][m];
          f.assign((size_t)n * n, 16);
          if (size == 0) {
            for (int i = 0; i < 16; i++) f[T.pos[2][0][i][1] * 4 + T.pos[2][0][i][0]] = sl.list[0][m][i];
            continue;
          }
          const int rep = n / 8;
          for (int i = 0; i < 64; i++) {
            int x = T.pos[3][0][i][0], y = T.pos[3][0][i][1];
            for (int j = 0; j < rep; j++)
              for (int k = 0; k < rep; k++) f[(size_t)(y * rep + j) * n + x * rep + k] = sl.list[size][m][i];
          }
          if (size >= 2) f[0] = sl.dc[size][m];
        }
    }
  }

  // 6.4.1: whether (xn, yn) is decoded and in the slice of (xc, yc).
  bool avail(int xc, int yc, int xn, int yn) const {
    if (xn < 0 || yn < 0 || xn >= sps.width || yn >= sps.height) return false;
    const int s = sps.log2_min_tb;
    if (zscan_[(size_t)(yn >> s) * zscan_w_ + (xn >> s)] > zscan_[(size_t)(yc >> s) * zscan_w_ + (xc >> s)])
      return false;
    const int cn = (yn >> sps.log2_ctb) * sps.w_ctb + (xn >> sps.log2_ctb);
    const int cc = (yc >> sps.log2_ctb) * sps.w_ctb + (xc >> sps.log2_ctb);
    return ctb_addr_[cn] == ctb_addr_[cc];
  }

  void decode_slice_data() {
    bits_ = Bits(rbsp_.data() + sh.data_byte, rbsp_.size() - sh.data_byte);
    slice_idx_ = (int)cur_->slices.size() - 1;
    SliceParams sp;
    sp.addr = sh.address;
    sp.deblocking_disabled = sh.deblocking_disabled;
    sp.lf_across = sh.lf_across;
    sp.beta_offset = sh.beta_offset;
    sp.tc_offset = sh.tc_offset;
    slice_params_.push_back(sp);
    log2_qg_ = sps.log2_ctb - (pps.cu_qp_delta ? pps.diff_cu_qp_delta_depth : 0);
    // 9.3.2.2: initType 1 for P and 2 for B slices, swapped by cabac_init_flag
    const int init_type = sh.type == SLICE_I ? 0 : (sh.type == SLICE_P) != sh.cabac_init ? 1 : 2;
    const int ctbs = sps.w_ctb * sps.h_ctb;
    uint8_t wpp_state[kNumCtx];
    cc_.init_contexts(init_type, sh.qp);
    cc_.init_engine(&bits_);
    qp_y_ = qp_prev_ = sh.qp;
    first_qg_ = true;
    qg_x_ = qg_y_ = -1;
    int addr = sh.address;
    while (true) {
      const int rx = addr % sps.w_ctb, ry = addr / sps.w_ctb;
      const int x0 = rx << sps.log2_ctb, y0 = ry << sps.log2_ctb;
      if (ctb_addr_[addr] != -1) corrupt("CTB %d decoded twice", addr);
      ctb_addr_[addr] = sh.address;
      cur_->ctb_slice[addr] = (uint16_t)slice_idx_;
      if (pps.wpp && rx == 0) {  // 9.3.1: a row's contexts come from the CTB above right
        if (avail(x0, y0, x0 + sps.ctb, y0 - sps.ctb)) memcpy(cc_.state, wpp_state, kNumCtx);
        else cc_.init_contexts(init_type, sh.qp);
        first_qg_ = true;
      }
      if (sh.sao_luma || sh.sao_chroma) parse_sao(rx, ry, addr);
      coding_quadtree(x0, y0, sps.log2_ctb, 0);
      const bool end = cc_.terminate();
      if (pps.wpp && rx == 1) memcpy(wpp_state, cc_.state, kNumCtx);
      addr++;
      if (end) break;
      if (addr >= ctbs) corrupt("a slice that runs past the last CTB");
      if (pps.wpp && addr % sps.w_ctb == 0) {
        if (!cc_.terminate()) corrupt("a CTB row without its end_of_subset_one_bit");
        bits_.pos = (bits_.pos + 7) & ~(size_t)7;
        cc_.init_engine(&bits_);
      }
    }
  }

  void parse_sao(int rx, int ry, int addr) {
    Sao s{};
    const int slice_addr = sh.address;
    bool merge_left = false, merge_up = false;
    if (rx > 0 && addr - 1 >= slice_addr) merge_left = cc_.decision(kSAO_MERGE);
    if (ry > 0 && !merge_left && addr - sps.w_ctb >= slice_addr) merge_up = cc_.decision(kSAO_MERGE);
    if (merge_left) {
      s = sao_[addr - 1];
    } else if (merge_up) {
      s = sao_[addr - sps.w_ctb];
    } else {
      for (int c = 0; c < 3; c++) {
        if (!((sh.sao_luma && c == 0) || (sh.sao_chroma && c > 0))) continue;
        if (c < 2) s.type[c] = cc_.decision(kSAO_TYPE) ? (cc_.bypass() ? 2 : 1) : 0;
        else s.type[2] = s.type[1];
        if (!s.type[c]) continue;
        int abs[4];
        const int cmax = (1 << (std::min(bd_, 10) - 5)) - 1;  // SaoOffsetVal is not scaled up to 10 bits
        for (int i = 0; i < 4; i++) {
          abs[i] = 0;
          while (abs[i] < cmax && cc_.bypass()) abs[i]++;
        }
        if (s.type[c] == 1) {
          for (int i = 0; i < 4; i++)
            if (abs[i] && cc_.bypass()) abs[i] = -abs[i];
          s.band[c] = (uint8_t)cc_.bypass_bits(5);
          for (int i = 0; i < 4; i++) s.offset[c][i + 1] = (int8_t)abs[i];
        } else {
          s.offset[c][1] = (int8_t)abs[0];
          s.offset[c][2] = (int8_t)abs[1];
          s.offset[c][3] = (int8_t)-abs[2];
          s.offset[c][4] = (int8_t)-abs[3];
          if (c == 0) s.eo[0] = (uint8_t)cc_.bypass_bits(2);
          if (c == 1) s.eo[1] = (uint8_t)cc_.bypass_bits(2);
          if (c == 2) s.eo[2] = s.eo[1];
        }
      }
    }
    sao_[addr] = s;
  }

  // 8.6.1: the QP prediction of the quantisation group at (xq, yq).
  void start_qg(int xq, int yq) {
    qp_delta_coded_ = false;
    cu_qp_delta_ = 0;
    const int prev = first_qg_ ? sh.qp : qp_prev_;
    first_qg_ = false;
    const int ctb_mask = ~((1 << sps.log2_ctb) - 1);
    auto same_ctb = [&](int x, int y) { return (x & ctb_mask) == (xq & ctb_mask) && (y & ctb_mask) == (yq & ctb_mask); };
    const int a = avail(xq, yq, xq - 1, yq) && same_ctb(xq - 1, yq) ? qp_[i4(xq - 1, yq)] : prev;
    const int b = avail(xq, yq, xq, yq - 1) && same_ctb(xq, yq - 1) ? qp_[i4(xq, yq - 1)] : prev;
    qpy_pred_ = (a + b + 1) >> 1;
  }

  void coding_quadtree(int x0, int y0, int log2, int depth) {
    const int size = 1 << log2;
    bool split;
    if (x0 + size <= sps.width && y0 + size <= sps.height && log2 > sps.log2_min_cb) {
      int ctx = 0;
      if (avail(x0, y0, x0 - 1, y0) && depth_[i4(x0 - 1, y0)] > depth) ctx++;
      if (avail(x0, y0, x0, y0 - 1) && depth_[i4(x0, y0 - 1)] > depth) ctx++;
      split = cc_.decision(kSPLIT_CU + ctx);
    } else {
      split = log2 > sps.log2_min_cb;
    }
    if (!split) {
      coding_unit(x0, y0, log2, depth);
      return;
    }
    const int h = size >> 1;
    coding_quadtree(x0, y0, log2 - 1, depth + 1);
    if (x0 + h < sps.width) coding_quadtree(x0 + h, y0, log2 - 1, depth + 1);
    if (y0 + h < sps.height) coding_quadtree(x0, y0 + h, log2 - 1, depth + 1);
    if (x0 + h < sps.width && y0 + h < sps.height) coding_quadtree(x0 + h, y0 + h, log2 - 1, depth + 1);
  }

  // Fills a per-4x4 array over a block.
  template <typename T>
  void fill(std::vector<T>& a, int x0, int y0, int w, int h, T v) {
    for (int y = y0; y < y0 + h; y += 4)
      for (int x = x0; x < x0 + w; x += 4) a[i4(x, y)] = v;
  }
  // Marks the left and top edges of a block (transform or prediction).
  void mark_edges(int x0, int y0, int w, int h, bool transform) {
    const uint8_t v = transform ? kEdgeVT : kEdgeVP, hz = transform ? kEdgeHT : kEdgeHP;
    for (int y = y0; y < y0 + h && y < sps.height; y += 4) edge_[i4(x0, y)] |= v;
    for (int x = x0; x < x0 + w && x < sps.width; x += 4) edge_[i4(x, y0)] |= hz;
  }

  int parse_part_mode(bool intra, int log2) {
    if (intra) return cc_.decision(kPART_MODE) ? PART_2Nx2N : PART_NxN;
    if (cc_.decision(kPART_MODE)) return PART_2Nx2N;
    if (log2 == sps.log2_min_cb) {
      if (cc_.decision(kPART_MODE + 1)) return PART_2NxN;
      if (log2 == 3) return PART_Nx2N;
      return cc_.decision(kPART_MODE + 2) ? PART_Nx2N : PART_NxN;
    }
    if (!sps.amp) return cc_.decision(kPART_MODE + 1) ? PART_2NxN : PART_Nx2N;
    if (cc_.decision(kPART_MODE + 1)) {
      if (cc_.decision(kPART_MODE + 3)) return PART_2NxN;
      return cc_.bypass() ? PART_2NxnD : PART_2NxnU;
    }
    if (cc_.decision(kPART_MODE + 3)) return PART_Nx2N;
    return cc_.bypass() ? PART_nRx2N : PART_nLx2N;
  }

  void coding_unit(int x0, int y0, int log2, int depth) {
    const int n = 1 << log2;
    const int w = std::min(n, sps.width - x0), h = std::min(n, sps.height - y0);
    cu_bypass_ = pps.transquant_bypass && cc_.decision(kTQ_BYPASS);
    bool skip = false;
    if (sh.type != SLICE_I) {
      int ctx = (avail(x0, y0, x0 - 1, y0) && (cu_[i4(x0 - 1, y0)] & kSkip)) +
                (avail(x0, y0, x0, y0 - 1) && (cu_[i4(x0, y0 - 1)] & kSkip));
      skip = cc_.decision(kSKIP + ctx);
    }
    const int qg_mask = ~((1 << log2_qg_) - 1);
    if ((x0 & qg_mask) != qg_x_ || (y0 & qg_mask) != qg_y_) {  // a new quantisation group
      qg_x_ = x0 & qg_mask;
      qg_y_ = y0 & qg_mask;
      start_qg(qg_x_, qg_y_);
    }
    qp_y_ = (qpy_pred_ + cu_qp_delta_ + 52 + 2 * qp_bd_) % (52 + qp_bd_) - qp_bd_;
    fill(depth_, x0, y0, w, h, (uint8_t)depth);
    fill(mode_, x0, y0, w, h, (uint8_t)1);
    mark_edges(x0, y0, w, h, true);
    cu_part_ = PART_2Nx2N;
    cu_depth_ = depth;
    intra_split_ = false;
    const uint8_t bypass = cu_bypass_ ? kBypass : 0;
    if (skip) {
      cu_intra_ = false;
      fill(cu_, x0, y0, w, h, (uint8_t)(kSkip | bypass));
      prediction_unit(x0, y0, n, x0, y0, n, n, 0, true);
    } else {
      cu_intra_ = sh.type == SLICE_I || cc_.decision(kPRED_MODE);
      fill(cu_, x0, y0, w, h, (uint8_t)((cu_intra_ ? kIntra : 0) | bypass));
      if (!cu_intra_ || log2 == sps.log2_min_cb) cu_part_ = parse_part_mode(cu_intra_, log2);
      bool merge0 = false;
      if (cu_intra_) {
        intra_modes(x0, y0, n);
        MvField intra{};
        for (int y = y0; y < y0 + h; y += 4)
          for (int x = x0; x < x0 + w; x += 4) cur_->mvf[i4(x, y)] = intra;
      } else {
        const int q = n / 4, hf = n / 2;
        switch (cu_part_) {
          case PART_2Nx2N: merge0 = prediction_unit(x0, y0, n, x0, y0, n, n, 0, false); break;
          case PART_2NxN:
            prediction_unit(x0, y0, n, x0, y0, n, hf, 0, false);
            prediction_unit(x0, y0, n, x0, y0 + hf, n, hf, 1, false);
            break;
          case PART_Nx2N:
            prediction_unit(x0, y0, n, x0, y0, hf, n, 0, false);
            prediction_unit(x0, y0, n, x0 + hf, y0, hf, n, 1, false);
            break;
          case PART_2NxnU:
            prediction_unit(x0, y0, n, x0, y0, n, q, 0, false);
            prediction_unit(x0, y0, n, x0, y0 + q, n, n - q, 1, false);
            break;
          case PART_2NxnD:
            prediction_unit(x0, y0, n, x0, y0, n, n - q, 0, false);
            prediction_unit(x0, y0, n, x0, y0 + n - q, n, q, 1, false);
            break;
          case PART_nLx2N:
            prediction_unit(x0, y0, n, x0, y0, q, n, 0, false);
            prediction_unit(x0, y0, n, x0 + q, y0, n - q, n, 1, false);
            break;
          case PART_nRx2N:
            prediction_unit(x0, y0, n, x0, y0, n - q, n, 0, false);
            prediction_unit(x0, y0, n, x0 + n - q, y0, q, n, 1, false);
            break;
          default:  // PART_NxN
            prediction_unit(x0, y0, n, x0, y0, hf, hf, 0, false);
            prediction_unit(x0, y0, n, x0 + hf, y0, hf, hf, 1, false);
            prediction_unit(x0, y0, n, x0, y0 + hf, hf, hf, 2, false);
            prediction_unit(x0, y0, n, x0 + hf, y0 + hf, hf, hf, 3, false);
        }
      }
      bool root_cbf = true;
      if (!cu_intra_ && !(cu_part_ == PART_2Nx2N && merge0)) root_cbf = cc_.decision(kRQT_ROOT_CBF);
      if (root_cbf) {
        intra_split_ = cu_intra_ && cu_part_ == PART_NxN;
        max_trafo_depth_ = cu_intra_ ? sps.max_th_depth_intra + intra_split_ : sps.max_th_depth_inter;
        transform_tree(x0, y0, x0, y0, log2, 0, 0, false, false);
      }
    }
    fill(qp_, x0, y0, w, h, (int8_t)qp_y_);
    qp_prev_ = qp_y_;
  }

  // The luma intra modes of a CU's prediction blocks (8.4.2) and its chroma mode (8.4.3).
  void intra_modes(int x0, int y0, int n) {
    const int parts = cu_part_ == PART_NxN ? 4 : 1, pb = cu_part_ == PART_NxN ? n / 2 : n;
    bool prev[4];
    for (int j = 0; j < parts; j++) prev[j] = cc_.decision(kPREV_INTRA);
    for (int j = 0; j < parts; j++) {
      const int xp = x0 + (j & 1) * pb, yp = y0 + (j >> 1) * pb;
      int mpm = -1, rem = 0;
      if (prev[j]) mpm = cc_.bypass() ? (cc_.bypass() ? 2 : 1) : 0;
      else rem = (int)cc_.bypass_bits(5);
      const int a = avail(xp, yp, xp - 1, yp) && (cu_[i4(xp - 1, yp)] & kIntra) ? mode_[i4(xp - 1, yp)] : 1;
      const int b = avail(xp, yp, xp, yp - 1) && (cu_[i4(xp, yp - 1)] & kIntra) &&
                            yp - 1 >= ((yp >> sps.log2_ctb) << sps.log2_ctb)
                        ? mode_[i4(xp, yp - 1)]
                        : 1;
      int cand[3];
      if (a == b) {
        if (a < 2) {
          cand[0] = 0;
          cand[1] = 1;
          cand[2] = 26;
        } else {
          cand[0] = a;
          cand[1] = 2 + ((a + 29) % 32);
          cand[2] = 2 + ((a - 2 + 1) % 32);
        }
      } else {
        cand[0] = a;
        cand[1] = b;
        cand[2] = a != 0 && b != 0 ? 0 : a != 1 && b != 1 ? 1 : 26;
      }
      int mode;
      if (mpm >= 0) {
        mode = cand[mpm];
      } else {
        std::sort(cand, cand + 3);
        mode = rem;
        for (int i = 0; i < 3; i++)
          if (mode >= cand[i]) mode++;
      }
      fill(mode_, xp, yp, std::min(pb, sps.width - xp), std::min(pb, sps.height - yp), (uint8_t)mode);
    }
    const int c = cc_.decision(kCHROMA_MODE) ? (int)cc_.bypass_bits(2) : 4;
    const int luma = mode_[i4(x0, y0)];
    if (c == 4) {
      chroma_mode_ = luma;
    } else {
      static const int kModes[4] = {0, 26, 10, 1};
      chroma_mode_ = kModes[c] == luma ? 34 : kModes[c];
    }
  }

  // ---- Transform tree and residuals (7.3.8.8 to 7.3.8.12)

  void transform_tree(int x0, int y0, int xb, int yb, int log2, int depth, int blk, bool parent_cb,
                      bool parent_cr) {
    bool split;
    if (log2 <= sps.log2_max_tb && log2 > sps.log2_min_tb && depth < max_trafo_depth_ &&
        !(intra_split_ && depth == 0)) {
      split = cc_.decision(kSPLIT_TF + 5 - log2);
    } else {
      const bool inter_split =
          sps.max_th_depth_inter == 0 && !cu_intra_ && cu_part_ != PART_2Nx2N && depth == 0;
      split = log2 > sps.log2_max_tb || (intra_split_ && depth == 0) || inter_split;
    }
    bool cbf_cb = parent_cb, cbf_cr = parent_cr;
    if (log2 > 2) {
      cbf_cb = (depth == 0 || parent_cb) && cc_.decision(kCBF_CHROMA + depth);
      cbf_cr = (depth == 0 || parent_cr) && cc_.decision(kCBF_CHROMA + depth);
    }
    if (split) {
      const int h = 1 << (log2 - 1);
      transform_tree(x0, y0, x0, y0, log2 - 1, depth + 1, 0, cbf_cb, cbf_cr);
      transform_tree(x0 + h, y0, x0, y0, log2 - 1, depth + 1, 1, cbf_cb, cbf_cr);
      transform_tree(x0, y0 + h, x0, y0, log2 - 1, depth + 1, 2, cbf_cb, cbf_cr);
      transform_tree(x0 + h, y0 + h, x0, y0, log2 - 1, depth + 1, 3, cbf_cb, cbf_cr);
      return;
    }
    bool cbf_luma = true;
    if (cu_intra_ || depth != 0 || cbf_cb || cbf_cr) cbf_luma = cc_.decision(kCBF_LUMA + (depth == 0));
    transform_unit(x0, y0, xb, yb, log2, blk, cbf_luma, cbf_cb, cbf_cr);
  }

  int exp_golomb(int k) {
    int v = 0;
    while (cc_.bypass()) {
      v += 1 << k;
      if (++k > 31) corrupt("an Exp-Golomb bypass code longer than 32 bits");
    }
    return v + (int)cc_.bypass_bits(k);
  }

  void transform_unit(int x0, int y0, int xb, int yb, int log2, int blk, bool cbf_luma, bool cbf_cb,
                      bool cbf_cr) {
    const int n = 1 << log2;
    mark_edges(x0, y0, n, n, true);
    if (cbf_luma)
      for (int y = y0; y < y0 + n; y += 4)
        for (int x = x0; x < x0 + n; x += 4) cu_[i4(x, y)] |= kNonZero;
    if ((cbf_luma || cbf_cb || cbf_cr) && pps.cu_qp_delta && !qp_delta_coded_) {
      int v = 0;
      while (v < 5 && cc_.decision(kQP_DELTA + (v > 0))) v++;
      if (v == 5) v += exp_golomb(0);
      if (v && cc_.bypass()) v = -v;
      if (v < -(26 + qp_bd_ / 2) || v > 25 + qp_bd_ / 2) corrupt("CuQpDeltaVal of %d", v);
      qp_delta_coded_ = true;
      cu_qp_delta_ = v;
      qp_y_ = (qpy_pred_ + v + 52 + 2 * qp_bd_) % (52 + qp_bd_) - qp_bd_;
    }
    if (cu_intra_) intra_pred(0, x0, y0, log2, mode_[i4(x0, y0)]);
    if (cbf_luma) residual(0, x0, y0, log2);
    int xc = x0 / 2, yc = y0 / 2, log2c = log2 - 1;
    if (log2 == 2) {
      if (blk != 3) return;
      xc = xb / 2;
      yc = yb / 2;
      log2c = 2;
    }
    if (cu_intra_) intra_pred(1, xc, yc, log2c, chroma_mode_);
    if (cbf_cb) residual(1, xc, yc, log2c);
    if (cu_intra_) intra_pred(2, xc, yc, log2c, chroma_mode_);
    if (cbf_cr) residual(2, xc, yc, log2c);
  }

  // residual_coding() (7.3.8.11) into coeff (row-major n x n); returns
  // transform_skip_flag.
  bool residual_coding(int log2, int c, int scan, int* coeff) {
    const int n = 1 << log2;
    memset(coeff, 0, sizeof(int) * n * n);
    bool tskip = false;
    if (pps.transform_skip && !cu_bypass_ && log2 == 2) tskip = cc_.decision(kTSKIP + (c > 0));
    int off, shift;
    if (c == 0) {
      off = 3 * (log2 - 2) + ((log2 - 1) >> 2);
      shift = (log2 + 1) >> 2;
    } else {
      off = 15;
      shift = log2 - 2;
    }
    const int cmax = (log2 << 1) - 1;
    int px = 0, py = 0;
    while (px < cmax && cc_.decision(kLAST_X + off + (px >> shift))) px++;
    while (py < cmax && cc_.decision(kLAST_Y + off + (py >> shift))) py++;
    int lx = px, ly = py;
    if (px > 3) {
      int b = (px >> 1) - 1;
      lx = (1 << b) * (2 + (px & 1)) + (int)cc_.bypass_bits(b);
    }
    if (py > 3) {
      int b = (py >> 1) - 1;
      ly = (1 << b) * (2 + (py & 1)) + (int)cc_.bypass_bits(b);
    }
    if (scan == 2) std::swap(lx, ly);
    if (lx >= n || ly >= n) corrupt("a last coefficient outside its block");
    const ScanTables& T = tables();
    const int log2sb = log2 - 2, nsb = 1 << log2sb;
    const uint8_t(*sb_scan)[2] = T.pos[log2sb][scan];
    const uint8_t(*scan4)[2] = T.pos[2][scan];
    int last_sb = 0, last_pos = 0;
    for (int i = 0; i < nsb * nsb; i++)
      if (sb_scan[i][0] == (lx >> 2) && sb_scan[i][1] == (ly >> 2)) last_sb = i;
    for (int i = 0; i < 16; i++)
      if (scan4[i][0] == (lx & 3) && scan4[i][1] == (ly & 3)) last_pos = i;
    uint8_t csbf[8][8] = {{0}};
    int c1 = 1;
    for (int i = last_sb; i >= 0; i--) {
      const int xs = sb_scan[i][0], ys = sb_scan[i][1];
      bool infer_dc = false;
      int coded = 1;
      if (i < last_sb && i > 0) {
        int ctx = 0;
        if (xs < nsb - 1) ctx += csbf[xs + 1][ys];
        if (ys < nsb - 1) ctx += csbf[xs][ys + 1];
        coded = cc_.decision(kCSBF + std::min(ctx, 1) + (c ? 2 : 0));
        infer_dc = true;
      }
      csbf[xs][ys] = (uint8_t)coded;
      int sig[16], nsig = 0;
      if (i == last_sb) sig[nsig++] = last_pos;
      if (coded) {
        int prev = 0;
        if (xs < nsb - 1) prev |= csbf[xs + 1][ys];
        if (ys < nsb - 1) prev |= csbf[xs][ys + 1] << 1;
        for (int k = i == last_sb ? last_pos - 1 : 15; k >= 0; k--) {
          const int xp = scan4[k][0], yp = scan4[k][1];
          const int xc = (xs << 2) + xp, yc = (ys << 2) + yp;
          if (k == 0 && infer_dc) {
            sig[nsig++] = 0;
            break;
          }
          int ctx;
          if (log2 == 2) {
            ctx = kCtxIdxMap[(yc << 2) + xc];
          } else if (xc + yc == 0) {
            ctx = 0;
          } else {
            if (prev == 0) ctx = xp + yp == 0 ? 2 : xp + yp < 3 ? 1 : 0;
            else if (prev == 1) ctx = yp == 0 ? 2 : yp == 1 ? 1 : 0;
            else if (prev == 2) ctx = xp == 0 ? 2 : xp == 1 ? 1 : 0;
            else ctx = 2;
            if (c == 0) {
              if (xs > 0 || ys > 0) ctx += 3;
              ctx += log2 == 3 ? (scan == 0 ? 9 : 15) : 21;
            } else {
              ctx += log2 == 3 ? 9 : 12;
            }
          }
          if (cc_.decision(kSIG + (c ? 27 + ctx : ctx))) {
            sig[nsig++] = k;
            infer_dc = false;
          }
        }
      }
      if (!nsig) continue;
      int ctx_set = (i == 0 || c > 0) ? 0 : 2;
      if (c1 == 0) ctx_set++;
      c1 = 1;
      int gt1[8], first_gt1 = -1;
      const int ngt1 = std::min(nsig, 8);
      for (int k = 0; k < ngt1; k++) {
        gt1[k] = cc_.decision(kGT1 + ctx_set * 4 + c1 + (c ? 16 : 0));
        if (gt1[k]) {
          c1 = 0;
          if (first_gt1 < 0) first_gt1 = k;
        } else if (c1 > 0 && c1 < 3) {
          c1++;
        }
      }
      int gt2 = 0;
      if (first_gt1 >= 0) gt2 = cc_.decision(kGT2 + ctx_set + (c ? 4 : 0));
      const bool hidden = pps.sign_hiding && !cu_bypass_ && sig[0] - sig[nsig - 1] > 3;
      const int nsigns = hidden ? nsig - 1 : nsig;
      uint32_t signs = cc_.bypass_bits(nsigns);
      int rice = 0, sum = 0;
      for (int k = 0; k < nsig; k++) {
        const int base = 1 + (k < 8 ? gt1[k] : 0) + (k == first_gt1 ? gt2 : 0);
        int level = base;
        if (base == (k < 8 ? (k == first_gt1 ? 3 : 2) : 1)) {
          int prefix = 0;
          while (prefix < 32 && cc_.bypass()) prefix++;
          if (prefix >= 32) corrupt("a coeff_abs_level_remaining prefix of 32 bits");
          int rem;
          if (prefix <= 3) {
            rem = (prefix << rice) + (int)cc_.bypass_bits(rice);
          } else {
            const int e = prefix - 3;
            if (e + rice > 30) corrupt("a coefficient level out of range");
            rem = (((1 << e) + 2) << rice) + (int)cc_.bypass_bits(e + rice);
          }
          level = base + rem;
          if (level > 3 * (1 << rice)) rice = std::min(rice + 1, 4);
        }
        sum += level;
        bool neg;
        if (hidden && k == nsig - 1) neg = sum & 1;
        else neg = (signs >> (nsigns - 1 - k)) & 1;
        const int pos = sig[k];
        const int xc = (xs << 2) + scan4[pos][0], yc = (ys << 2) + scan4[pos][1];
        coeff[yc * n + xc] = neg ? -level : level;
      }
    }
    return tskip;
  }

  void residual(int c, int x0, int y0, int log2) {
    int scan = 0;
    if (cu_intra_ && (log2 == 2 || (log2 == 3 && c == 0))) {
      const int m = c ? chroma_mode_ : mode_[i4(x0, y0)];
      if (m >= 6 && m <= 14) scan = 2;
      else if (m >= 22 && m <= 30) scan = 1;
    }
    int coeff[32 * 32], res[32 * 32];
    const bool tskip = residual_coding(log2, c, scan, coeff);
    const int n = 1 << log2, nn = n * n;
    if (cu_bypass_) {
      memcpy(res, coeff, sizeof(int) * nn);
    } else {
      // Qp'Y and Qp'C: QpY and the chroma table's QP, offset by QpBdOffset
      int qp = qp_y_ + qp_bd_;
      if (c) qp = chroma_qp(clip3(-qp_bd_, 57, qp_y_ + (c == 1 ? pps.cb_qp_offset + sh.cb_qp_offset
                                                               : pps.cr_qp_offset + sh.cr_qp_offset))) + qp_bd_;
      const int bdshift = log2 + bd_ - 5;
      const int64_t scale = (int64_t)kLevelScale[qp % 6] << (qp / 6);
      const uint8_t* m = nullptr;
      if (scaling_ && !(tskip && n > 4)) m = factor_[log2 - 2][(cu_intra_ ? 0 : 3) + c].data();
      for (int i = 0; i < nn; i++) {
        if (!coeff[i]) continue;
        const int64_t v = ((int64_t)coeff[i] * (m ? m[i] : 16) * scale + (1 << (bdshift - 1))) >> bdshift;
        coeff[i] = (int)std::max<int64_t>(-32768, std::min<int64_t>(32767, v));
      }
      const int shift = 20 - bd_;  // the second stage's bdShift
      if (tskip) {
        for (int i = 0; i < nn; i++) res[i] = ((coeff[i] << 7) + (1 << (shift - 1))) >> shift;
      } else {
        const bool dst = cu_intra_ && c == 0 && n == 4;
        if (bd_ == 8) inverse_transform<12>(coeff, res, log2, dst);
        else if (bd_ == 9) inverse_transform<11>(coeff, res, log2, dst);
        else inverse_transform<10>(coeff, res, log2, dst);
      }
    }
    if (bd_ > 8) add_residual<uint16_t>(c, x0, y0, n, res);
    else add_residual<uint8_t>(c, x0, y0, n, res);
  }

  template <class P>
  void add_residual(int c, int x0, int y0, int n, const int* res) {
    P* pl = cur_->samples_of<P>(c);
    const int stride = cur_->stride(c), max = sizeof(P) == 1 ? 255 : (1 << bd_) - 1;
    for (int y = 0; y < n; y++) {
      P* row = pl + (size_t)(y0 + y) * stride + x0;
      for (int x = 0; x < n; x++) row[x] = (P)clip3(0, max, row[x] + res[y * n + x]);
    }
  }

  // 8.6.4.2: columns, the intermediate clip, then rows (SHIFT: 20 less the
  // bit depth).
  template <int SHIFT>
  static void inverse_transform(const int* d, int* r, int log2, bool dst) {
    const int n = 1 << log2;
    const ScanTables& T = tables();
    int m[32 * 32];  // m[k * n + i]: basis function k at sample i
    for (int k = 0; k < n; k++)
      for (int i = 0; i < n; i++) m[k * n + i] = dst ? kDst[k][i] : T.dct[k << (5 - log2)][i];
    // Only the rows and columns of d up to its last non-zero coefficient add anything.
    int rows = 0, cols = 0;
    for (int k = 0; k < n; k++)
      for (int x = 0; x < n; x++)
        if (d[k * n + x]) {
          rows = k + 1;
          cols = std::max(cols, x + 1);
        }
    int tmp[32 * 32];  // the columns' output: only its first `cols` columns are non-zero
    for (int i = 0; i < n; i++)
      for (int x = 0; x < cols; x++) {
        int s = 0;  // |s| < 2^31: coefficients within 16 bits, 32 basis values below 2^7
        for (int k = 0; k < rows; k++) s += m[k * n + i] * d[k * n + x];
        tmp[i * n + x] = clip3(-32768, 32767, (s + 64) >> 7);
      }
    for (int y = 0; y < n; y++) {
      const int* g = tmp + y * n;
      int* out = r + y * n;
      for (int j = 0; j < n; j++) out[j] = 0;
      for (int k = 0; k < cols; k++) {
        const int gk = g[k];
        if (!gk) continue;
        const int* mk = m + k * n;
        for (int j = 0; j < n; j++) out[j] += mk[j] * gk;
      }
      for (int j = 0; j < n; j++) out[j] = (out[j] + (1 << (SHIFT - 1))) >> SHIFT;
    }
  }

  // ---- Inter prediction (8.5.3)

  static bool same_motion(const MvField& a, const MvField& b) {
    if (a.pred != b.pred) return false;
    for (int l = 0; l < 2; l++)
      if ((a.pred >> l) & 1)
        if (a.ref[l] != b.ref[l] || a.mv[l][0] != b.mv[l][0] || a.mv[l][1] != b.mv[l][1]) return false;
    return true;
  }

  // 6.4.2: whether the prediction block neighbour (xn, yn) is available.
  bool avail_pb(int xcb, int ycb, int ncb, int xpb, int ypb, int w, int h, int part, int xn, int yn) const {
    const bool same_cb = xcb <= xn && ycb <= yn && xcb + ncb > xn && ycb + ncb > yn;
    bool a;
    if (!same_cb) a = avail(xpb, ypb, xn, yn);
    else a = !((w << 1) == ncb && (h << 1) == ncb && part == 1 && ycb + h <= yn && xcb + w > xn);
    return a && !(cu_[i4(xn, yn)] & kIntra);
  }

  static int16_t scale_mv(int mv, int td, int tb) {
    td = clip3(-128, 127, td);
    tb = clip3(-128, 127, tb);
    const int tx = (16384 + (std::abs(td) >> 1)) / td;
    const int f = clip3(-4096, 4095, (tb * tx + 32) >> 6);
    const int p = f * mv;
    return (int16_t)clip3(-32768, 32767, sign(p) * ((std::abs(p) + 127) >> 8));
  }

  // 8.5.3.2.8 and 8.5.3.2.9: the temporal motion vector of list x and reference ref_idx.
  bool temporal(int xpb, int ypb, int w, int h, int ref_idx, int x, int16_t mv[2]) const {
    if (!sh.temporal_mvp || !col_ || col_->mvf.empty()) return false;
    const int xbr = xpb + w, ybr = ypb + h;
    if ((ypb >> sps.log2_ctb) == (ybr >> sps.log2_ctb) && ybr < sps.height && xbr < sps.width &&
        collocated(xbr & ~15, ybr & ~15, ref_idx, x, mv))
      return true;
    return collocated((xpb + (w >> 1)) & ~15, (ypb + (h >> 1)) & ~15, ref_idx, x, mv);
  }

  bool collocated(int x, int y, int ref_idx, int lx, int16_t mv[2]) const {
    const MvField& f = col_->motion(x, y);
    if (!f.pred) return false;
    int list;
    if (!(f.pred & 1)) list = 1;
    else if (f.pred == 1) list = 0;
    else list = no_backward_pred_ ? lx : (sh.collocated_from_l0 ? 1 : 0);
    const SliceRefs& sr = col_->slice_at(x, y);
    const int r = f.ref[list];
    if (sr.lt[list][r] != refs_lt_[lx][ref_idx]) return false;
    const int col_diff = col_->poc - sr.poc[list][r];
    const int cur_diff = cur_->poc - refs_[lx][ref_idx]->poc;
    if (refs_lt_[lx][ref_idx] || col_diff == cur_diff || col_diff == 0) {
      mv[0] = f.mv[list][0];
      mv[1] = f.mv[list][1];
    } else {
      mv[0] = scale_mv(f.mv[list][0], col_diff, cur_diff);
      mv[1] = scale_mv(f.mv[list][1], col_diff, cur_diff);
    }
    return true;
  }

  // 8.5.3.2.2 to 8.5.3.2.5: the merge candidate merge_idx.
  MvField merge(int xcb, int ycb, int ncb, int xpb, int ypb, int w, int h, int part, int merge_idx) const {
    if (pps.log2_par_mrg_level > 2 && ncb == 8) {
      xpb = xcb;
      ypb = ycb;
      w = h = ncb;
      part = 0;
    }
    const int L = pps.log2_par_mrg_level;
    auto par = [&](int xn, int yn) { return (xpb >> L) == (xn >> L) && (ypb >> L) == (yn >> L); };
    auto av = [&](int xn, int yn) { return !par(xn, yn) && avail_pb(xcb, ycb, ncb, xpb, ypb, w, h, part, xn, yn); };
    MvField cand[5];
    int n = 0;
    const int xa1 = xpb - 1, ya1 = ypb + h - 1;
    const bool vertical2 = cu_part_ == PART_Nx2N || cu_part_ == PART_nLx2N || cu_part_ == PART_nRx2N;
    const bool horizontal2 = cu_part_ == PART_2NxN || cu_part_ == PART_2NxnU || cu_part_ == PART_2NxnD;
    const bool a1 = !(part == 1 && vertical2) && av(xa1, ya1);
    const MvField* A1 = a1 ? &cur_->motion(xa1, ya1) : nullptr;
    if (a1) cand[n++] = *A1;
    const int xb1 = xpb + w - 1, yb1 = ypb - 1;
    bool b1 = !(part == 1 && horizontal2) && av(xb1, yb1);
    const MvField* B1 = b1 ? &cur_->motion(xb1, yb1) : nullptr;
    if (b1 && a1 && same_motion(*A1, *B1)) b1 = false;
    if (b1) cand[n++] = *B1;
    const int xb0 = xpb + w, yb0 = ypb - 1;
    bool b0 = av(xb0, yb0);
    if (b0 && B1 && same_motion(*B1, cur_->motion(xb0, yb0))) b0 = false;
    if (b0) cand[n++] = cur_->motion(xb0, yb0);
    const int xa0 = xpb - 1, ya0 = ypb + h;
    bool a0 = av(xa0, ya0);
    if (a0 && a1 && same_motion(*A1, cur_->motion(xa0, ya0))) a0 = false;
    if (a0) cand[n++] = cur_->motion(xa0, ya0);
    const int xb2 = xpb - 1, yb2 = ypb - 1;
    bool b2 = n < 4 && av(xb2, yb2);
    if (b2 && a1 && same_motion(*A1, cur_->motion(xb2, yb2))) b2 = false;
    if (b2 && B1 && same_motion(*B1, cur_->motion(xb2, yb2))) b2 = false;
    if (b2) cand[n++] = cur_->motion(xb2, yb2);
    if (n > merge_idx) return cand[merge_idx];
    const bool b_slice = sh.type == SLICE_B;
    MvField col{};
    col.ref[0] = col.ref[1] = -1;
    if (temporal(xpb, ypb, w, h, 0, 0, col.mv[0])) {
      col.pred = 1;
      col.ref[0] = 0;
    }
    if (b_slice && temporal(xpb, ypb, w, h, 0, 1, col.mv[1])) {
      col.pred |= 2;
      col.ref[1] = 0;
    }
    if (col.pred) {
      cand[n++] = col;
      if (n > merge_idx) return cand[merge_idx];
    }
    if (b_slice && n > 1 && n < sh.max_merge) {  // 8.5.3.2.4: combined bi-predictive candidates
      static const int kL0[12] = {0, 1, 0, 2, 1, 2, 0, 3, 1, 3, 2, 3};
      static const int kL1[12] = {1, 0, 2, 0, 2, 1, 3, 0, 3, 1, 3, 2};
      const int orig = n;
      for (int k = 0; k < orig * (orig - 1) && n < sh.max_merge; k++) {
        const MvField &a = cand[kL0[k]], &b = cand[kL1[k]];
        if (!(a.pred & 1) || !(b.pred & 2)) continue;
        if (refs_[0][a.ref[0]]->poc == refs_[1][b.ref[1]]->poc && a.mv[0][0] == b.mv[1][0] &&
            a.mv[0][1] == b.mv[1][1])
          continue;
        MvField& c = cand[n++];
        c.pred = 3;
        c.ref[0] = a.ref[0];
        c.ref[1] = b.ref[1];
        c.mv[0][0] = a.mv[0][0];
        c.mv[0][1] = a.mv[0][1];
        c.mv[1][0] = b.mv[1][0];
        c.mv[1][1] = b.mv[1][1];
        if (n > merge_idx) return cand[merge_idx];
      }
    }
    // 8.5.3.2.5: zero candidates, over both lists in a B slice
    const int zero = merge_idx - n;
    const int num_ref = b_slice ? std::min(num_refs_[0], num_refs_[1]) : num_refs_[0];
    const int8_t r = (int8_t)(zero < num_ref ? zero : 0);
    MvField z{};
    z.pred = b_slice ? 3 : 1;
    z.ref[0] = r;
    z.ref[1] = b_slice ? r : -1;
    return z;
  }

  // 8.5.3.2.6 and 8.5.3.2.7: the motion vector predictor mvp_flag of list x.
  void amvp(int xcb, int ycb, int ncb, int xpb, int ypb, int w, int h, int part, int ref_idx, int x,
            int mvp_flag, int16_t out[2]) const {
    const Picture* target = refs_[x][ref_idx];
    const bool target_lt = refs_lt_[x][ref_idx];
    const int y = 1 - x;
    auto av = [&](int xn, int yn) { return avail_pb(xcb, ycb, ncb, xpb, ypb, w, h, part, xn, yn); };
    auto ref_pic = [&](int list, int r) -> const Picture* { return refs_[list][r]; };
    // Without scaling: the same picture through list x, then list y.
    auto same_pic = [&](const MvField& f, int16_t mv[2]) {
      for (int l : {x, y})
        if (((f.pred >> l) & 1) && l < 2 && f.ref[l] < num_refs_[l] && ref_pic(l, f.ref[l]) == target) {
          mv[0] = f.mv[l][0];
          mv[1] = f.mv[l][1];
          return true;
        }
      return false;
    };
    // With scaling: any picture of the same kind (short or long-term).
    auto scaled = [&](const MvField& f, int16_t mv[2]) {
      for (int l : {x, y})
        if (((f.pred >> l) & 1) && f.ref[l] < num_refs_[l] && refs_lt_[l][f.ref[l]] == target_lt) {
          mv[0] = f.mv[l][0];
          mv[1] = f.mv[l][1];
          if (!refs_lt_[l][f.ref[l]] && !target_lt) {
            const int td = cur_->poc - ref_pic(l, f.ref[l])->poc, tb = cur_->poc - target->poc;
            if (td) {
              mv[0] = scale_mv(mv[0], td, tb);
              mv[1] = scale_mv(mv[1], td, tb);
            }
          }
          return true;
        }
      return false;
    };
    const int xa[2] = {xpb - 1, xpb - 1}, ya[2] = {ypb + h, ypb + h - 1};
    bool ava[2] = {av(xa[0], ya[0]), av(xa[1], ya[1])};
    const bool is_scaled = ava[0] || ava[1];
    int16_t mva[2] = {0, 0}, mvb[2] = {0, 0};
    bool a = false;
    for (int k = 0; k < 2 && !a; k++)
      if (ava[k]) a = same_pic(cur_->motion(xa[k], ya[k]), mva);
    for (int k = 0; k < 2 && !a; k++)
      if (ava[k]) a = scaled(cur_->motion(xa[k], ya[k]), mva);
    const int xbn[3] = {xpb + w, xpb + w - 1, xpb - 1}, ybn = ypb - 1;
    bool avb[3];
    for (int k = 0; k < 3; k++) avb[k] = av(xbn[k], ybn);
    bool b = false;
    for (int k = 0; k < 3 && !b; k++)
      if (avb[k]) b = same_pic(cur_->motion(xbn[k], ybn), mvb);
    if (!is_scaled && b) {
      a = true;
      mva[0] = mvb[0];
      mva[1] = mvb[1];
    }
    if (!is_scaled) {
      b = false;
      for (int k = 0; k < 3 && !b; k++)
        if (avb[k]) b = scaled(cur_->motion(xbn[k], ybn), mvb);
    }
    int16_t list[3][2];
    int n = 0;
    if (a) {
      list[n][0] = mva[0];
      list[n++][1] = mva[1];
    }
    if (b && !(a && mva[0] == mvb[0] && mva[1] == mvb[1])) {
      list[n][0] = mvb[0];
      list[n++][1] = mvb[1];
    }
    if (n < 2 && mvp_flag >= n) {
      int16_t mvc[2];
      if (temporal(xpb, ypb, w, h, ref_idx, x, mvc)) {
        list[n][0] = mvc[0];
        list[n++][1] = mvc[1];
      }
    }
    while (n < 2) {
      list[n][0] = list[n][1] = 0;
      n++;
    }
    out[0] = list[mvp_flag][0];
    out[1] = list[mvp_flag][1];
  }

  // mvd_coding() (7.3.8.9)
  void mvd_coding(int mvd[2]) {
    const int g0x = cc_.decision(kMVD_G0), g0y = cc_.decision(kMVD_G0);
    const int g1x = g0x ? cc_.decision(kMVD_G1) : 0, g1y = g0y ? cc_.decision(kMVD_G1) : 0;
    mvd[0] = mvd[1] = 0;
    if (g0x) {
      int v = g1x ? 2 + exp_golomb(1) : 1;
      mvd[0] = cc_.bypass() ? -v : v;
    }
    if (g0y) {
      int v = g1y ? 2 + exp_golomb(1) : 1;
      mvd[1] = cc_.bypass() ? -v : v;
    }
  }

  // prediction_unit() (7.3.8.6): parses, derives and predicts; returns merge_flag.
  bool prediction_unit(int xcb, int ycb, int ncb, int xpb, int ypb, int w, int h, int part, bool skip) {
    MvField f{};
    f.ref[0] = f.ref[1] = -1;
    const bool merge_flag = skip || cc_.decision(kMERGE_FLAG);
    if (merge_flag) {
      int idx = 0;
      if (sh.max_merge > 1 && cc_.decision(kMERGE_IDX)) {
        idx = 1;
        while (idx < sh.max_merge - 1 && cc_.bypass()) idx++;
      }
      f = merge(xcb, ycb, ncb, xpb, ypb, w, h, part, idx);
      if (f.pred == 3 && w + h == 12) {  // 8x4 and 4x8 blocks: list 0 only
        f.pred = 1;
        f.ref[1] = -1;
      }
    } else {
      // inter_pred_idc: 1 list 0, 2 list 1, 3 both
      int lists = 1;
      if (sh.type == SLICE_B) {
        if (w + h != 12 && cc_.decision(kINTER_PRED + cu_depth_)) lists = 3;
        else lists = cc_.decision(kINTER_PRED + 4) ? 2 : 1;
      }
      int r[2] = {0, 0}, mvd[2][2], flag[2] = {0, 0};
      for (int l = 0; l < 2; l++) {
        if (!((lists >> l) & 1)) continue;
        while (r[l] < num_refs_[l] - 1 && (r[l] < 2 ? cc_.decision(kREF_IDX + r[l]) : cc_.bypass())) r[l]++;
        mvd_coding(mvd[l]);
        flag[l] = cc_.decision(kMVP);
      }
      f.pred = (uint8_t)lists;
      for (int l = 0; l < 2; l++) {
        if (!((lists >> l) & 1)) continue;
        int16_t mvp[2];
        amvp(xcb, ycb, ncb, xpb, ypb, w, h, part, r[l], l, flag[l], mvp);
        f.ref[l] = (int8_t)r[l];
        f.mv[l][0] = (int16_t)(uint16_t)(mvp[0] + mvd[l][0]);
        f.mv[l][1] = (int16_t)(uint16_t)(mvp[1] + mvd[l][1]);
      }
    }
    for (int y = ypb; y < ypb + h && y < sps.height; y += 4)
      for (int x = xpb; x < xpb + w && x < sps.width; x += 4) cur_->mvf[i4(x, y)] = f;
    mark_edges(xpb, ypb, w, h, false);
    predict_inter(xpb, ypb, w, h, f);
    return merge_flag;
  }

  // Fractional sample interpolation (8.5.3.3.3) of one list into pred
  // (14-bit intermediate samples) for a w x h block of component c.
  template <class P>
  void interpolate(const Picture& ref, int c, int xb, int yb, int w, int h, const int16_t mv[2],
                   int16_t* pred) const {
    if (c) filter<P, 4>(ref, c, xb + (mv[0] >> 3), yb + (mv[1] >> 3), w, h, kChromaFilter[mv[0] & 7],
                        kChromaFilter[mv[1] & 7], (mv[0] & 7) != 0, (mv[1] & 7) != 0, pred);
    else filter<P, 8>(ref, c, xb + (mv[0] >> 2), yb + (mv[1] >> 2), w, h, kLumaFilter[mv[0] & 3],
                      kLumaFilter[mv[1] & 3], (mv[0] & 3) != 0, (mv[1] & 3) != 0, pred);
  }

  // The TAPS-tap filters hx (across) and hy (down) over the reference block
  // at (xi, yi), its margins clamped at the picture's edges. A full sample
  // is shifted up by 14 less the bit depth (shift3), a first filter's sum
  // down by the bit depth less 8 (shift1), a second's by 6 (shift2).
  template <class P, int TAPS>
  static void filter(const Picture& ref, int c, int xi, int yi, int w, int h, const int* hx,
                     const int* hy, bool fx, bool fy, int16_t* pred) {
    constexpr int before = TAPS / 2 - 1;
    const int depth = sizeof(P) == 1 ? 8 : ref.depth, shift1 = depth - 8, shift3 = 14 - depth;
    const int pw = c ? ref.w / 2 : ref.w, ph = c ? ref.h / 2 : ref.h;
    const int bw = w + TAPS - 1, bh = h + TAPS - 1;
    const P* src;
    int stride;
    static thread_local std::vector<P> block;
    static thread_local std::vector<int> tmp;
    if (xi - before >= 0 && yi - before >= 0 && xi - before + bw <= pw && yi - before + bh <= ph) {
      stride = ref.stride(c);
      src = ref.samples_of<P>(c) + (size_t)(yi - before) * stride + xi - before;
    } else {
      block.resize((size_t)bw * bh);
      const P* plane = ref.samples_of<P>(c);
      for (int r = 0; r < bh; r++) {
        const P* row = plane + (size_t)clip3(0, ph - 1, yi + r - before) * ref.stride(c);
        for (int k = 0; k < bw; k++) block[(size_t)r * bw + k] = row[clip3(0, pw - 1, xi + k - before)];
      }
      src = block.data();
      stride = bw;
    }
    if (!fx && !fy) {
      for (int r = 0; r < h; r++) {
        const P* b = src + (size_t)(r + before) * stride + before;
        for (int k = 0; k < w; k++) pred[r * w + k] = (int16_t)(b[k] << shift3);
      }
      return;
    }
    if (!fy) {
      for (int r = 0; r < h; r++) {
        const P* b = src + (size_t)(r + before) * stride;
        for (int k = 0; k < w; k++) {
          int v = 0;
          for (int t = 0; t < TAPS; t++) v += hx[t] * b[k + t];
          pred[r * w + k] = (int16_t)(v >> shift1);
        }
      }
      return;
    }
    if (!fx) {
      for (int r = 0; r < h; r++)
        for (int k = 0; k < w; k++) {
          const P* b = src + (size_t)r * stride + k + before;
          int v = 0;
          for (int t = 0; t < TAPS; t++) v += hy[t] * b[(size_t)t * stride];
          pred[r * w + k] = (int16_t)(v >> shift1);
        }
      return;
    }
    tmp.resize((size_t)w * bh);
    for (int r = 0; r < bh; r++) {
      const P* b = src + (size_t)r * stride;
      for (int k = 0; k < w; k++) {
        int v = 0;
        for (int t = 0; t < TAPS; t++) v += hx[t] * b[k + t];
        tmp[(size_t)r * w + k] = v >> shift1;
      }
    }
    for (int r = 0; r < h; r++)
      for (int k = 0; k < w; k++) {
        int v = 0;
        for (int t = 0; t < TAPS; t++) v += hy[t] * tmp[(size_t)(r + t) * w + k];
        pred[r * w + k] = (int16_t)(v >> 6);
      }
  }

  // Motion compensation with the default or explicit weights (8.5.3.3.4).
  void predict_inter(int xpb, int ypb, int w, int h, const MvField& f) {
    for (int l = 0; l < 2; l++)
      if (((f.pred >> l) & 1) && (f.ref[l] < 0 || f.ref[l] >= num_refs_[l]))
        corrupt("ref_idx_l%d %d of %d", l, f.ref[l], num_refs_[l]);
    if (bd_ > 8) predict_inter_samples<uint16_t>(xpb, ypb, w, h, f);
    else predict_inter_samples<uint8_t>(xpb, ypb, w, h, f);
  }

  // The weighted sample prediction (8.5.3.3.4.2-3): shift1 = 14 - bit
  // depth, shift2 = 15 - bit depth, and the explicit offsets scaled up by the
  // bit depth less 8.
  template <class P>
  void predict_inter_samples(int xpb, int ypb, int w, int h, const MvField& f) {
    const bool weighted = sh.type == SLICE_P ? pps.weighted_pred : pps.weighted_bipred;
    const int depth = sizeof(P) == 1 ? 8 : bd_, max = (1 << depth) - 1;
    const int shift1 = 14 - depth, shift2 = 15 - depth, up = depth - 8;
    auto clip = [max](int v) { return (P)(v < 0 ? 0 : v > max ? max : v); };
    static thread_local std::vector<int16_t> pred, pred1;
    for (int c = 0; c < 3; c++) {
      const int cw = c ? w / 2 : w, ch = c ? h / 2 : h, xb = c ? xpb / 2 : xpb, yb = c ? ypb / 2 : ypb;
      P* pl = cur_->samples_of<P>(c);
      const int stride = cur_->stride(c);
      pred.resize((size_t)cw * ch);
      if (f.pred == 3) {  // bi-prediction
        pred1.resize((size_t)cw * ch);
        interpolate<P>(*refs_[0][f.ref[0]], c, xb, yb, cw, ch, f.mv[0], pred.data());
        interpolate<P>(*refs_[1][f.ref[1]], c, xb, yb, cw, ch, f.mv[1], pred1.data());
        if (!weighted) {
          for (int y = 0; y < ch; y++) {
            P* row = pl + (size_t)(yb + y) * stride + xb;
            const int16_t *p0 = pred.data() + y * cw, *p1 = pred1.data() + y * cw;
            for (int x = 0; x < cw; x++) row[x] = clip((p0[x] + p1[x] + (1 << (shift2 - 1))) >> shift2);
          }
          continue;
        }
        const int log2wd = (c ? sh.chroma_log2_wd : sh.luma_log2_wd) + shift1;
        const int r0 = f.ref[0], r1 = f.ref[1];
        const int w0 = c ? sh.chroma_w[0][r0][c - 1] : sh.luma_w[0][r0];
        const int w1 = c ? sh.chroma_w[1][r1][c - 1] : sh.luma_w[1][r1];
        const int o = (((c ? sh.chroma_o[0][r0][c - 1] + sh.chroma_o[1][r1][c - 1]
                           : sh.luma_o[0][r0] + sh.luma_o[1][r1]) << up) + 1) << log2wd;
        for (int y = 0; y < ch; y++) {
          P* row = pl + (size_t)(yb + y) * stride + xb;
          const int16_t *p0 = pred.data() + y * cw, *p1 = pred1.data() + y * cw;
          for (int x = 0; x < cw; x++) row[x] = clip((p0[x] * w0 + p1[x] * w1 + o) >> (log2wd + 1));
        }
        continue;
      }
      const int l = f.pred == 1 ? 0 : 1, r = f.ref[l];
      interpolate<P>(*refs_[l][r], c, xb, yb, cw, ch, f.mv[l], pred.data());
      if (!weighted) {
        for (int y = 0; y < ch; y++) {
          P* row = pl + (size_t)(yb + y) * stride + xb;
          for (int x = 0; x < cw; x++) row[x] = clip((pred[y * cw + x] + (1 << (shift1 - 1))) >> shift1);
        }
        continue;
      }
      const int log2wd = (c ? sh.chroma_log2_wd : sh.luma_log2_wd) + shift1;
      const int wt = c ? sh.chroma_w[l][r][c - 1] : sh.luma_w[l][r];
      const int o = (c ? sh.chroma_o[l][r][c - 1] : sh.luma_o[l][r]) * (1 << up);
      for (int y = 0; y < ch; y++) {
        P* row = pl + (size_t)(yb + y) * stride + xb;
        for (int x = 0; x < cw; x++)
          row[x] = clip(((pred[y * cw + x] * wt + (1 << (log2wd - 1))) >> log2wd) + o);
      }
    }
  }

  // ---- Intra prediction (8.4.4.2)

  void intra_pred(int c, int x0, int y0, int log2, int mode) {
    if (bd_ > 8) intra_samples<uint16_t>(c, x0, y0, log2, mode);
    else intra_samples<uint8_t>(c, x0, y0, log2, mode);
  }

  // Substitution with 1 << (bit depth - 1), strong intra smoothing's
  // threshold of 1 << (bit depth - 5), the edge filters clipped to the bit
  // depth.
  template <class P>
  void intra_samples(int c, int x0, int y0, int log2, int mode) {
    const int n = 1 << log2, s = c ? 1 : 0;
    const int depth = sizeof(P) == 1 ? 8 : bd_, max = (1 << depth) - 1;
    auto clip = [max](int v) { return (P)(v < 0 ? 0 : v > max ? max : v); };
    P* pl = cur_->samples_of<P>(c);
    const int stride = cur_->stride(c);
    // p[0] = p[-1][2n-1] up to p[2n-1] = p[-1][0], p[2n] = p[-1][-1],
    // p[2n+1] = p[0][-1] up to p[4n] = p[2n-1][-1]
    int p[4 * 32 + 1];
    bool av[4 * 32 + 1];
    const int xc = x0 << s, yc = y0 << s;
    const int unit = c ? 2 : 4;  // samples per 4x4 luma block
    auto avail_at = [&](int xn, int yn) {
      const int xl = xn << s, yl = yn << s;
      return avail(xc, yc, xl, yl) && !(pps.constrained_intra && !(cu_[i4(xl, yl)] & kIntra));
    };
    bool any = false;
    for (int k = 0; k < 2 * n; k += unit) {  // left column, bottom up
      const int yy = y0 + 2 * n - 1 - k;
      const bool a = avail_at(x0 - 1, yy);
      for (int j = 0; j < unit; j++) {
        av[k + j] = a;
        if (a) p[k + j] = pl[(size_t)(yy - j) * stride + x0 - 1];
      }
      any |= a;
    }
    av[2 * n] = avail_at(x0 - 1, y0 - 1);
    if (av[2 * n]) p[2 * n] = pl[(size_t)(y0 - 1) * stride + x0 - 1];
    any |= av[2 * n];
    for (int k = 0; k < 2 * n; k += unit) {  // top row, left to right
      const bool a = avail_at(x0 + k, y0 - 1);
      for (int j = 0; j < unit; j++) {
        av[2 * n + 1 + k + j] = a;
        if (a) p[2 * n + 1 + k + j] = pl[(size_t)(y0 - 1) * stride + x0 + k + j];
      }
      any |= a;
    }
    const int total = 4 * n + 1;
    if (!any) {
      for (int k = 0; k < total; k++) p[k] = 1 << (depth - 1);
    } else {
      if (!av[0]) {
        int k = 1;
        while (!av[k]) k++;
        p[0] = p[k];
      }
      for (int k = 1; k < total; k++)
        if (!av[k]) p[k] = p[k - 1];
    }
    // Filtering of the neighbouring samples (8.4.4.2.3)
    if (c == 0 && mode != 1 && n != 4) {
      const int dist = std::min(std::abs(mode - 26), std::abs(mode - 10));
      const int thres = n == 8 ? 7 : n == 16 ? 1 : 0;
      if (dist > thres) {
        int f[4 * 32 + 1];
        const int corner = p[2 * n], bottom = p[0], right = p[4 * n];
        const int strong = 1 << (depth - 5);
        if (sps.strong_intra_smoothing && n == 32 && std::abs(corner + right - 2 * p[2 * n + n]) < strong &&
            std::abs(corner + bottom - 2 * p[2 * n - n]) < strong) {
          // p[-1][y] = p[2n-1-y], p[x][-1] = p[2n+1+x]
          for (int y = 0; y < 63; y++) f[63 - y] = ((63 - y) * corner + (y + 1) * bottom + 32) >> 6;
          f[0] = bottom;
          for (int x = 0; x < 63; x++) f[65 + x] = ((63 - x) * corner + (x + 1) * right + 32) >> 6;
          f[128] = right;
          f[64] = corner;
        } else {
          f[0] = p[0];
          f[total - 1] = p[total - 1];
          for (int k = 1; k < total - 1; k++) f[k] = (p[k - 1] + 2 * p[k] + p[k + 1] + 2) >> 2;
        }
        memcpy(p, f, sizeof(int) * total);
      }
    }
    auto left = [&](int y) { return p[2 * n - 1 - y]; };  // p[-1][y], y >= -1
    auto top = [&](int x) { return p[2 * n + 1 + x]; };   // p[x][-1], x >= -1
    P* out = pl + (size_t)y0 * stride + x0;
    if (mode == 0) {  // planar
      for (int y = 0; y < n; y++)
        for (int x = 0; x < n; x++)
          out[(size_t)y * stride + x] = (P)(((n - 1 - x) * left(y) + (x + 1) * top(n) +
                                             (n - 1 - y) * top(x) + (y + 1) * left(n) + n) >>
                                            (log2 + 1));
      return;
    }
    if (mode == 1) {  // DC
      int sum = n;
      for (int k = 0; k < n; k++) sum += top(k) + left(k);
      const int dc = sum >> (log2 + 1);
      for (int y = 0; y < n; y++)
        for (int x = 0; x < n; x++) out[(size_t)y * stride + x] = (P)dc;
      if (c == 0 && n < 32) {
        out[0] = (P)((left(0) + 2 * dc + top(0) + 2) >> 2);
        for (int x = 1; x < n; x++) out[x] = (P)((top(x) + 3 * dc + 2) >> 2);
        for (int y = 1; y < n; y++) out[(size_t)y * stride] = (P)((left(y) + 3 * dc + 2) >> 2);
      }
      return;
    }
    const int angle = kIntraAngle[mode];
    int refbuf[3 * 32 + 1];
    int* ref = refbuf + n;  // ref[-n .. 2n]
    const bool vertical = mode >= 18;
    auto main = [&](int k) { return vertical ? top(k) : left(k); };
    auto side = [&](int k) { return vertical ? left(k) : top(k); };
    for (int k = 0; k <= n; k++) ref[k] = main(k - 1);
    if (angle < 0) {
      const int last = (n * angle) >> 5;
      if (last < -1) {
        const int inv = inv_angle(mode);
        for (int k = last; k <= -1; k++) ref[k] = side(-1 + ((k * inv + 128) >> 8));
      }
    } else {
      for (int k = n + 1; k <= 2 * n; k++) ref[k] = main(k - 1);
    }
    for (int j = 0; j < n; j++) {  // j: y for vertical modes, x for horizontal ones
      const int idx = ((j + 1) * angle) >> 5, fact = ((j + 1) * angle) & 31;
      for (int i = 0; i < n; i++) {
        const int v = fact ? ((32 - fact) * ref[i + idx + 1] + fact * ref[i + idx + 2] + 16) >> 5
                           : ref[i + idx + 1];
        if (vertical) out[(size_t)j * stride + i] = (P)v;
        else out[(size_t)i * stride + j] = (P)v;
      }
    }
    if (c == 0 && n < 32) {
      if (mode == 26)
        for (int y = 0; y < n; y++) out[(size_t)y * stride] = clip(top(0) + ((left(y) - left(-1)) >> 1));
      else if (mode == 10)
        for (int x = 0; x < n; x++) out[x] = clip(left(0) + ((top(x) - top(-1)) >> 1));
    }
  }

  // ---- Deblocking (8.7.2)

  const Picture* ref_of(const MvField& f, int list, int x, int y) const {
    const SliceRefs& sr = cur_->slice_at(x, y);
    return (const Picture*)(intptr_t)sr.id[list][f.ref[list]];  // an id, compared only
  }

  static bool mv_far(const int16_t a[2], const int16_t b[2]) {
    return std::abs(a[0] - b[0]) >= 4 || std::abs(a[1] - b[1]) >= 4;
  }

  // The boundary strength between the 4x4 blocks p and q (luma positions).
  int strength(int xp, int yp, int xq, int yq, bool transform_edge) const {
    const uint8_t cp = cu_[i4(xp, yp)], cq = cu_[i4(xq, yq)];
    if ((cp | cq) & kIntra) return 2;
    if (transform_edge && ((cp | cq) & kNonZero)) return 1;
    const MvField& P = cur_->motion(xp, yp);
    const MvField& Q = cur_->motion(xq, yq);
    const int np = (P.pred & 1) + (P.pred >> 1), nq = (Q.pred & 1) + (Q.pred >> 1);
    if (np != nq) return 1;
    if (np == 1) {
      const int lp = P.pred == 1 ? 0 : 1, lq = Q.pred == 1 ? 0 : 1;
      if (ref_of(P, lp, xp, yp) != ref_of(Q, lq, xq, yq)) return 1;
      return mv_far(P.mv[lp], Q.mv[lq]);
    }
    const Picture *p0 = ref_of(P, 0, xp, yp), *p1 = ref_of(P, 1, xp, yp);
    const Picture *q0 = ref_of(Q, 0, xq, yq), *q1 = ref_of(Q, 1, xq, yq);
    if (!((p0 == q0 && p1 == q1) || (p0 == q1 && p1 == q0))) return 1;
    if (p0 != p1) {
      if (p0 == q0) return mv_far(P.mv[0], Q.mv[0]) || mv_far(P.mv[1], Q.mv[1]);
      return mv_far(P.mv[0], Q.mv[1]) || mv_far(P.mv[1], Q.mv[0]);
    }
    return (mv_far(P.mv[0], Q.mv[0]) || mv_far(P.mv[1], Q.mv[1])) &&
           (mv_far(P.mv[0], Q.mv[1]) || mv_far(P.mv[1], Q.mv[0]));
  }

  const SliceParams& params_at(int x, int y) const {
    return slice_params_[cur_->ctb_slice[(size_t)(y >> sps.log2_ctb) * sps.w_ctb + (x >> sps.log2_ctb)]];
  }
  bool exempt(int x, int y) const {  // transquant bypass: samples the loop filters leave
    return cu_[i4(x, y)] & kBypass;
  }

  // One 4-sample luma edge segment: pix at q0 of its first line; step
  // across the edge, stride along it.
  // beta and tC scale by 1 << (bit depth - 8), the samples clip to it.
  template <class S>
  static void filter_luma(S* pix, int step, int stride, int bs, int qp, int beta_off, int tc_off,
                          bool no_p, bool no_q, int depth) {
    const int beta = kBeta[clip3(0, 51, qp + beta_off)] << (depth - 8);
    const int tc = kTc[clip3(0, 53, qp + 2 * (bs - 1) + tc_off)] << (depth - 8);
    const int max = (1 << depth) - 1;
    auto clip1 = [max](int v) { return (S)(v < 0 ? 0 : v > max ? max : v); };
    auto P = [&](int i, int k) -> S& { return pix[k * stride - (i + 1) * step]; };
    auto Q = [&](int i, int k) -> S& { return pix[k * stride + i * step]; };
    const int dp0 = std::abs(P(2, 0) - 2 * P(1, 0) + P(0, 0)), dp3 = std::abs(P(2, 3) - 2 * P(1, 3) + P(0, 3));
    const int dq0 = std::abs(Q(2, 0) - 2 * Q(1, 0) + Q(0, 0)), dq3 = std::abs(Q(2, 3) - 2 * Q(1, 3) + Q(0, 3));
    const int d = dp0 + dq0 + dp3 + dq3;
    if (d >= beta) return;
    auto strong_line = [&](int k, int dpq) {
      return 2 * dpq < (beta >> 2) && std::abs(P(3, k) - P(0, k)) + std::abs(Q(0, k) - Q(3, k)) < (beta >> 3) &&
             std::abs(P(0, k) - Q(0, k)) < ((5 * tc + 1) >> 1);
    };
    const bool strong = strong_line(0, dp0 + dq0) && strong_line(3, dp3 + dq3);
    const bool dep = dp0 + dp3 < ((beta + (beta >> 1)) >> 3), deq = dq0 + dq3 < ((beta + (beta >> 1)) >> 3);
    for (int k = 0; k < 4; k++) {
      const int p0 = P(0, k), p1 = P(1, k), p2 = P(2, k), p3 = P(3, k);
      const int q0 = Q(0, k), q1 = Q(1, k), q2 = Q(2, k), q3 = Q(3, k);
      if (strong) {
        if (!no_p) {
          P(0, k) = (S)clip3(p0 - 2 * tc, p0 + 2 * tc, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3);
          P(1, k) = (S)clip3(p1 - 2 * tc, p1 + 2 * tc, (p2 + p1 + p0 + q0 + 2) >> 2);
          P(2, k) = (S)clip3(p2 - 2 * tc, p2 + 2 * tc, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3);
        }
        if (!no_q) {
          Q(0, k) = (S)clip3(q0 - 2 * tc, q0 + 2 * tc, (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3);
          Q(1, k) = (S)clip3(q1 - 2 * tc, q1 + 2 * tc, (p0 + q0 + q1 + q2 + 2) >> 2);
          Q(2, k) = (S)clip3(q2 - 2 * tc, q2 + 2 * tc, (p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3);
        }
        continue;
      }
      int delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4;
      if (std::abs(delta) >= tc * 10) continue;
      delta = clip3(-tc, tc, delta);
      if (!no_p) P(0, k) = clip1(p0 + delta);
      if (!no_q) Q(0, k) = clip1(q0 - delta);
      if (dep && !no_p) P(1, k) = clip1(p1 + clip3(-(tc >> 1), tc >> 1, (((p2 + p0 + 1) >> 1) - p1 + delta) >> 1));
      if (deq && !no_q) Q(1, k) = clip1(q1 + clip3(-(tc >> 1), tc >> 1, (((q2 + q0 + 1) >> 1) - q1 - delta) >> 1));
    }
  }

  template <class S>
  static void filter_chroma(S* pix, int step, int stride, int n, int tc, bool no_p, bool no_q, int depth) {
    const int max = (1 << depth) - 1;
    auto clip1 = [max](int v) { return (S)(v < 0 ? 0 : v > max ? max : v); };
    tc <<= depth - 8;
    for (int k = 0; k < n; k++) {
      S* s = pix + k * stride;
      const int p0 = s[-step], p1 = s[-2 * step], q0 = s[0], q1 = s[step];
      const int delta = clip3(-tc, tc, ((((q0 - p0) << 2) + p1 - q1 + 4) >> 3));
      if (!no_p) s[-step] = clip1(p0 + delta);
      if (!no_q) s[0] = clip1(q0 - delta);
    }
  }

  // The edges of one direction over the whole picture: vertical ones
  // (dir 0) first, then horizontal ones on their output.
  void deblock() {
    if (bd_ > 8) deblock_samples<uint16_t>();
    else deblock_samples<uint8_t>();
  }

  template <class S>
  void deblock_samples() {
    Picture& P = *cur_;
    const int depth = sizeof(S) == 1 ? 8 : bd_;
    std::vector<uint8_t> bs((size_t)w4_ * h4_);
    for (int dir = 0; dir < 2; dir++) {
      const uint8_t tflag = dir ? kEdgeHT : kEdgeVT, pflag = dir ? kEdgeHP : kEdgeVP;
      bool any = false;
      for (int y = 0; y < sps.height; y += 4)
        for (int x = 0; x < sps.width; x += 4) {
          uint8_t& b = bs[i4(x, y)];
          b = 0;
          const int e = dir ? y : x;
          const uint8_t f = edge_[i4(x, y)];
          if (e == 0 || (e & 7) || !(f & (tflag | pflag))) continue;
          const SliceParams& sq = params_at(x, y);
          if (sq.deblocking_disabled) continue;
          const int xp = dir ? x : x - 1, yp = dir ? y - 1 : y;
          const SliceParams& spp = params_at(xp, yp);
          if (&spp != &sq && !sq.lf_across && spp.addr != sq.addr) continue;
          b = (uint8_t)strength(xp, yp, x, y, f & tflag);
          any |= b != 0;
        }
      if (!any) continue;
      for (int y = 0; y < sps.height; y += 4)
        for (int x = 0; x < sps.width; x += 4) {
          const int b = bs[i4(x, y)];
          if (!b) continue;
          const int xp = dir ? x : x - 1, yp = dir ? y - 1 : y;
          const SliceParams& sq = params_at(x, y);
          const int qp = (qp_[i4(xp, yp)] + qp_[i4(x, y)] + 1) >> 1;
          const bool no_p = exempt(xp, yp), no_q = exempt(x, y);
          S* pix = P.samples_of<S>(0) + (size_t)y * P.w + x;
          if (dir == 0) filter_luma(pix, 1, P.w, b, qp, sq.beta_offset, sq.tc_offset, no_p, no_q, depth);
          else filter_luma(pix, P.w, 1, b, qp, sq.beta_offset, sq.tc_offset, no_p, no_q, depth);
          if (b != 2 || ((dir ? y : x) & 15)) continue;
          for (int c = 1; c < 3; c++) {
            const int offset = c == 1 ? pps.cb_qp_offset : pps.cr_qp_offset;
            const int qpc = chroma_qp(((qp_[i4(xp, yp)] + qp_[i4(x, y)] + 1) >> 1) + offset);
            const int tc = kTc[clip3(0, 53, qpc + 2 + sq.tc_offset)];
            const int cs = P.w / 2;
            S* cp = P.samples_of<S>(c) + (size_t)(y / 2) * cs + x / 2;
            if (dir == 0) filter_chroma(cp, 1, cs, 2, tc, no_p, no_q, depth);
            else filter_chroma(cp, cs, 1, 2, tc, no_p, no_q, depth);
          }
        }
    }
  }

  // ---- SAO (8.7.3), on a copy of the deblocked picture

  void apply_sao() {
    bool any = false;
    for (const Sao& s : sao_) any |= s.type[0] || s.type[1] || s.type[2];
    if (!any) return;
    if (bd_ > 8) sao_samples<uint16_t>();
    else sao_samples<uint8_t>();
  }

  // The band index is a sample's top 5 bits; the samples clip to the bit depth.
  template <class S>
  void sao_samples() {
    Picture& P = *cur_;
    const int depth = sizeof(S) == 1 ? 8 : bd_, max = (1 << depth) - 1, band_shift = depth - 5;
    auto clip1 = [max](int v) { return (S)(v < 0 ? 0 : v > max ? max : v); };
    const bool any_bypass = pps.transquant_bypass;  // the only samples SAO leaves
    for (int c = 0; c < 3; c++) {
      const int pw = c ? P.w / 2 : P.w, ph = c ? P.h / 2 : P.h, s = c ? 1 : 0;
      const int ctb = sps.ctb >> s;
      std::vector<S> src(P.samples_of<S>(c), P.samples_of<S>(c) + (size_t)pw * ph);
      S* dst = P.samples_of<S>(c);
      for (int addr = 0; addr < sps.w_ctb * sps.h_ctb; addr++) {
        const Sao& sao = sao_[addr];
        if (!sao.type[c] || ctb_addr_[addr] < 0) continue;
        const int rx = addr % sps.w_ctb, ry = addr / sps.w_ctb;
        const int x0 = rx * ctb, y0 = ry * ctb;
        const int x1 = std::min(x0 + ctb, pw), y1 = std::min(y0 + ctb, ph);
        const SliceParams& cur_slice = slice_params_[cur_->ctb_slice[addr]];
        // Whether the neighbouring CTB (dx, dy) may be read (8.7.3.2).
        bool usable[3][3];
        for (int dy = -1; dy <= 1; dy++)
          for (int dx = -1; dx <= 1; dx++) {
            const int nx = rx + dx, ny = ry + dy;
            bool u = nx >= 0 && ny >= 0 && nx < sps.w_ctb && ny < sps.h_ctb;
            if (u) {
              const int naddr = ny * sps.w_ctb + nx;
              const SliceParams& ns = slice_params_[cur_->ctb_slice[naddr]];
              if (ns.addr != cur_slice.addr)
                u = naddr < addr ? cur_slice.lf_across : ns.lf_across;
            }
            usable[dy + 1][dx + 1] = u;
          }
        if (sao.type[c] == 1) {
          int table[32] = {0};
          for (int k = 0; k < 4; k++) table[(k + sao.band[c]) & 31] = k + 1;
          for (int y = y0; y < y1; y++)
            for (int x = x0; x < x1; x++) {
              if (any_bypass && exempt(x << s, y << s)) continue;
              const int v = src[(size_t)y * pw + x];
              dst[(size_t)y * pw + x] = clip1(v + sao.offset[c][table[v >> band_shift]]);
            }
          continue;
        }
        static const int kHPos[4][2] = {{-1, 1}, {0, 0}, {-1, 1}, {1, -1}};
        static const int kVPos[4][2] = {{0, 0}, {-1, 1}, {-1, 1}, {-1, 1}};
        static const int kEdge[5] = {1, 2, 0, 3, 4};  // edgeIdx 0, 1, 2 become 1, 2, 0
        const int eo = sao.eo[c];
        const int o0 = kVPos[eo][0] * pw + kHPos[eo][0], o1 = kVPos[eo][1] * pw + kHPos[eo][1];
        for (int y = y0; y < y1; y++) {
          // Inside the CTB's border both neighbours lie in the CTB: no check.
          const bool inner_row = y > y0 && y < y1 - 1;
          for (int x = x0; x < x1; x++) {
            if (any_bypass && exempt(x << s, y << s)) continue;
            const size_t at = (size_t)y * pw + x;
            if (!(inner_row && x > x0 && x < x1 - 1)) {
              bool skip = false;
              for (int k = 0; k < 2 && !skip; k++) {
                const int nx = x + kHPos[eo][k], ny = y + kVPos[eo][k];
                skip = nx < 0 || ny < 0 || nx >= pw || ny >= ph ||
                       !usable[(ny < y0 ? 0 : ny >= y0 + ctb ? 2 : 1)][(nx < x0 ? 0 : nx >= x0 + ctb ? 2 : 1)];
              }
              if (skip) continue;
            }
            const int v = src[at];
            const int edge = kEdge[2 + sign(v - src[at + o0]) + sign(v - src[at + o1])];
            dst[at] = clip1(v + sao.offset[c][edge]);
          }
        }
      }
    }
  }

  // ---- The decoded-picture hash (D.3.19): MD5 and CRC over the picture's
  // bytes, of samples above 8 bits two each, the low byte first (as the
  // planes lie in memory); the checksum adds the two bytes of such a sample.

  void check_hash() {
    Picture& P = *cur_;
    if (P.hash_type < 0) return;
    const int bytes = P.depth > 8 ? 2 : 1;
    for (int c = 0; c < 3; c++) {
      bool ok;
      const int pw = c ? P.w / 2 : P.w, ph = c ? P.h / 2 : P.h;
      const uint8_t* pl = P.plane(c);
      if (P.hash_type == 0) {
        Md5 md5;
        md5.update(pl, (size_t)pw * ph * bytes);
        uint8_t out[16];
        md5.digest(out);
        ok = memcmp(out, P.hash[c], 16) == 0;
      } else if (P.hash_type == 1) {
        uint32_t crc = 0xffff;
        for (int i = 0; i < pw * ph * bytes; i++)
          for (int b = 0; b < 8; b++) {
            const uint32_t msb = (crc >> 15) & 1, bit = (pl[i] >> (7 - b)) & 1;
            crc = (((crc << 1) + bit) & 0xffff) ^ (msb * 0x1021);
          }
        for (int b = 0; b < 16; b++) {
          const uint32_t msb = (crc >> 15) & 1;
          crc = ((crc << 1) & 0xffff) ^ (msb * 0x1021);
        }
        ok = crc == (uint32_t)((P.hash[c][0] << 8) | P.hash[c][1]);
      } else {
        uint32_t sum = 0;
        for (int y = 0; y < ph; y++)
          for (int x = 0; x < pw; x++) {
            const uint32_t mask = (x & 0xff) ^ (y & 0xff) ^ (x >> 8) ^ (y >> 8);
            for (int b = 0; b < bytes; b++) sum += pl[((size_t)y * pw + x) * bytes + b] ^ mask;
          }
        ok = sum == ((uint32_t)P.hash[c][0] << 24 | P.hash[c][1] << 16 | P.hash[c][2] << 8 | P.hash[c][3]);
      }
      hashes_checked[c]++;
      hashes_failed[c] += !ok;
    }
  }
};

}  // namespace

extern "C" {

void* metrabs_hevc_decoder_new() { return new Decoder(); }

void metrabs_hevc_decoder_free(void* d) { delete static_cast<Decoder*>(d); }

// Reads a decoder configuration: an hvcC (MP4, Matroska) or Annex B
// parameter sets.
int metrabs_hevc_decoder_config(void* d, const uint8_t* data, size_t n, char* err, int err_len) {
  try {
    static_cast<Decoder*>(d)->configure(data, n);
  } catch (const Failure& f) {
    return fail(f, err, err_len);
  }
  return kOk;
}

// Parse headers only: pictures are output (in order, as metrabs_hevc_next
// tells) without samples. For indexing a stream.
void metrabs_hevc_decoder_headers_only(void* d) { static_cast<Decoder*>(d)->headers_only = true; }

// Decodes one packet (an access unit, Annex B or length-prefixed as the
// configuration says). The pictures it outputs wait for metrabs_hevc_frame.
int metrabs_hevc_decode(void* d, const uint8_t* data, size_t n, char* err, int err_len) {
  try {
    static_cast<Decoder*>(d)->decode(data, n);
  } catch (const Failure& f) {
    return fail(f, err, err_len);
  }
  return kOk;
}

// The end of the stream: every picture still waiting is output.
int metrabs_hevc_flush(void* d, char* err, int err_len) {
  try {
    static_cast<Decoder*>(d)->flush();
  } catch (const Failure& f) {
    return fail(f, err, err_len);
  }
  return kOk;
}

// How many pictures the decoder has decoded (or parsed).
int metrabs_hevc_pictures(void* d) { return static_cast<Decoder*>(d)->pictures(); }

// Per plane (Y, U, V): the decoded-picture hashes checked and those that
// disagreed with the picture.
void metrabs_hevc_hashes(void* d, int* checked, int* failed) {
  for (int c = 0; c < 3; c++) {
    checked[c] = static_cast<Decoder*>(d)->hashes_checked[c];
    failed[c] = static_cast<Decoder*>(d)->hashes_failed[c];
  }
}

// The next output picture: 1 with its cropped size and its index in
// decoding order, 0 when none waits.
int metrabs_hevc_next(void* d, int* width, int* height, int* decode_index) {
  const Picture* p = static_cast<Decoder*>(d)->ready();
  if (!p) return 0;
  *width = p->out_w;
  *height = p->out_h;
  *decode_index = p->decode_index;
  return 1;
}

// The bit depth of the next output picture's samples (8, 9 or 10), 0 when
// none waits.
int metrabs_hevc_bit_depth(void* d) {
  const Picture* p = static_cast<Decoder*>(d)->ready();
  return p ? p->depth : 0;
}

// Hands out the next output picture: RGB [h][w][3] and the planes (y [h][w],
// u and v [(h+1)/2][(w+1)/2], uint16_t samples above 8 bits), each skipped
// when null; 3 when none waits.
// 2 when RGB is asked of a size or colour matrix whose conversion is not
// ported (the picture stays).
int metrabs_hevc_frame(void* d, uint8_t* rgb, void* y, void* u, void* v, char* err, int err_len) {
  Decoder* dec = static_cast<Decoder*>(d);
  const Picture* p = dec->ready();
  if (!p) return kNoFrame;
  const int rc = hand_out(p, rgb, y, u, v, err, err_len, p->depth);
  if (rc == kOk) dec->pop();
  return rc;
}

// The NAL unit type of a packet's first slice (IRAP pictures, 16 to 23:
// BLA, IDR and CRA, offer random access; RASL pictures, 8 and 9, are skipped
// by a decoder that starts at their CRA), -1 without a slice.
// length_size 0: Annex B.
int metrabs_hevc_packet_info(const uint8_t* data, size_t n, int length_size, int* nal_type) {
  *nal_type = -1;
  try {
    for (auto& nal : split_nals(data, n, length_size)) {
      if (nal.second < 2) continue;
      const int type = (nal.first[0] >> 1) & 63, layer = ((nal.first[0] & 1) << 5) | (nal.first[1] >> 3);
      if (layer || type >= 32) continue;
      *nal_type = type;
      break;
    }
  } catch (const Failure&) {
    return kCorrupt;
  }
  return kOk;
}

}  // extern "C"
